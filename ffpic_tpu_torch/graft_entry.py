"""Entry points, the port's copy of ``__graft_entry__.py``.

``entry(device=None)``: the flagship device step, the batched 4:2:0
JPEG decode (dequant + 8x8 integer IDCT + chroma upsample + YUV->RGBA:
K2 + K3 on CUDA, their plain versions on the CPU) on the reference's
random coefficient planes, as ``(fn, args)``.

``dryrun_multichip(n_devices)``: the whole pipeline over an n-device
mesh inside a process group that already exists, one rank a device: the
batched decode sharded over ``data`` feeding a tensor-parallel ViT train
step (``data`` x ``model``), then one MoE step on a ``(data, seq,
expert, model)`` mesh, on tiny shapes.  Every rank calls it.  Weights
come from ``torch.Generator`` seeds 0 and 1 (the reference's
``PRNGKey(0)`` and ``PRNGKey(1)``; the numbers differ).
"""

from __future__ import annotations

import numpy as np
import torch

from ffpic_tpu_torch.utils.device import resolve_device


def entry(device=None):
    """``(fn, args)`` with ``fn(*args)`` the (2, 128, 128, 4) uint8
    decode of two 128x128 4:2:0 images, from the reference's draws
    (``__graft_entry__.py:19-40``), on ``device`` (None: CUDA)."""
    from ffpic_tpu_torch.ops.jpeg_kernels import decode_batch_420_planes
    dev = resolve_device(device, "entry")
    rng = np.random.default_rng(0)
    n, nby, nbx = 2, 16, 16
    ycoef = rng.integers(-512, 512, (n, nby, nbx, 8, 8),
                         dtype=np.int64).astype(np.int16)
    ucoef = rng.integers(-128, 128, (n, nby // 2, nbx // 2, 8, 8),
                         dtype=np.int64).astype(np.int16)
    vcoef = rng.integers(-128, 128, (n, nby // 2, nbx // 2, 8, 8),
                         dtype=np.int64).astype(np.int16)
    yq = rng.integers(1, 64, (8, 8), dtype=np.int64).astype(np.int32)
    cq = rng.integers(1, 64, (8, 8), dtype=np.int64).astype(np.int32)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (ycoef, ucoef, vcoef, yq, cq))

    def fn(ycoef, ucoef, vcoef, yq, cq):
        return decode_batch_420_planes(ycoef, ucoef, vcoef, yq, cq)

    return fn, args


def moe_factors(n_devices: int) -> tuple[int, int, int, int]:
    """The reference's ``(data, seq, expert, model)`` factorisation of
    n devices (``__graft_entry__.py:125-132``): 2 on each of the first
    three axes while n has a factor 2 left, the rest on ``model``."""
    facs, rem = [], n_devices
    for _ in range(3):
        f = 2 if rem % 2 == 0 and rem >= 2 else 1
        facs.append(f)
        rem //= f
    return (*facs, rem)


def check_moe_mesh(cfg, factors) -> None:
    """``ValueError`` where an axis of the MoE mesh does not divide a
    width it splits: ``seq`` the sequence, ``expert`` the experts,
    ``model`` ``d_model`` and ``d_ff``.  The reference's factorisation
    leaves such a ``model`` axis for n that are not powers of two (n = 6:
    ``model`` 3 against ``d_model`` 32)."""
    _dp, sp, ep, tp = factors
    for axis, extent, name, width in (
            ("seq", sp, "seq_len", cfg.seq_len),
            ("expert", ep, "n_experts", cfg.n_experts),
            ("model", tp, "d_model", cfg.d_model),
            ("model", tp, "d_ff", cfg.d_ff)):
        if width % extent:
            raise ValueError(f"mesh axis {axis} of extent {extent} does not "
                             f"divide {name}={width}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """``__graft_entry__.dryrun_multichip`` (``:63-157``) on the process
    group's ``n_devices`` ranks (CUDA unless ``device="cpu"``, then
    gloo's CPU ranks).  Every rank runs it; rank 0 prints the
    reference's two lines.  Returns the meshes' shapes and the two
    losses (replicated, so each rank returns the same)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ffpic_tpu_torch.models import moe, vit
    from ffpic_tpu_torch.ops.resize import normalize_for_model
    from ffpic_tpu_torch.parallel import mesh as pm

    dev_type = "cuda" if device is None else torch.device(device).type
    if dev_type == "cuda":
        resolve_device(None, "dryrun_multichip")
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = pm.make_mesh(n_devices, model_parallel=tp, device_type=dev_type)

    # --- tiny decode batch: n_devices images of 64x64 4:2:0 ------------
    rng = np.random.default_rng(0)
    n, nby, nbx = max(n_devices, 2), 8, 8
    ycoef = rng.integers(-256, 256, (n, nby, nbx, 8, 8)).astype(np.int16)
    ucoef = rng.integers(-64, 64, (n, nby // 2, nbx // 2, 8, 8)) \
        .astype(np.int16)
    vcoef = rng.integers(-64, 64, (n, nby // 2, nbx // 2, 8, 8)) \
        .astype(np.int16)
    yq = np.full((8, 8), 8, np.int32)
    cq = np.full((8, 8), 8, np.int32)
    rgba = pm.sharded_decode_420(mesh, ycoef, ucoef, vcoef, yq, cq,
                                 order="rgba")
    assert tuple(rgba.shape) == (n, 64, 64, 4), rgba.shape

    # --- ViT train step, dp x tp sharded -------------------------------
    cfg = vit.VIT_TINY
    state = vit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shardings = vit.param_shardings(cfg, mesh)
    params = {k: pm.distribute(mesh, v, shardings[k])
              for k, v in state.items()}
    size = (cfg.image_size, cfg.image_size)
    imgs = pm.map_rows(lambda b: normalize_for_model(b, size=size), rgba)
    labels = pm.shard_batch(mesh, np.arange(n, dtype=np.int32)
                            % cfg.n_classes)
    params, loss = vit.make_train_step(cfg)(params, imgs, labels)
    loss = float(loss.to_local())
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if dist.get_rank() == 0:
        print(f"dryrun_multichip ok: mesh={shape} loss={loss:.3f}",
              flush=True)

    # --- MoE step over the ep/sp axes ----------------------------------
    cfg4 = moe.MOE_TINY
    factors = moe_factors(n_devices)
    check_moe_mesh(cfg4, factors)
    mesh4 = init_device_mesh(dev_type, factors, mesh_dim_names=(
        "data", "seq", "expert", "model"))
    msh = moe.param_shardings(cfg4, mesh4)
    mparams = {k: pm.distribute(mesh4, v, msh[k]) for k, v in
               moe.init_params(cfg4, torch.Generator().manual_seed(1),
                               "cpu").items()}
    b = max(factors[0], 2)
    x = pm.distribute(mesh4, torch.from_numpy(
        np.random.default_rng(2).normal(size=(b, cfg4.seq_len, cfg4.d_model))
        .astype(np.float32)), pm.placements(mesh4, moe.ACT_SPEC))
    lbl = pm.distribute(mesh4, torch.arange(b, dtype=torch.int32)
                        % cfg4.n_classes, pm.placements(mesh4, ("data",)))
    mparams, mloss = moe.make_train_step(cfg4)(mparams, x, lbl)
    mloss = float(mloss.to_local())
    shape4 = dict(zip(mesh4.mesh_dim_names, mesh4.shape))
    if dist.get_rank() == 0:
        print(f"dryrun_multichip moe ok: mesh={shape4} loss={mloss:.3f}",
              flush=True)
    return {"mesh": shape, "loss": loss, "moe_mesh": shape4,
            "moe_loss": mloss}
