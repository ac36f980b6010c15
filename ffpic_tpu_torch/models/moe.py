"""A mixture-of-experts transformer block with expert- and
sequence-parallel shardings: the PyTorch counterpart of
``ffpic_tpu/models/moe.py``, all of it.

Mesh axes (``forward``'s sharded form, a DeviceMesh named ``("data",
"seq", "expert", "model")``): ``data`` splits the batch, ``seq`` the
tokens of the activations between the sub-blocks (attention gathers the
whole sequence), ``expert`` the expert weights and the dense dispatch,
``model`` the FFN inside each expert (Megatron column/row split).  On
DTensors placed by ``param_shardings`` (``parallel.mesh.distribute``)
each ``with_sharding_constraint(x, P("data", "seq", None))`` of the
reference is a ``redistribute`` to those placements (``_constrain``),
and each rank runs the block on its own parts with explicit collectives
(``parallel.mesh.Axes``), the partition XLA's SPMD pass makes: DTensor's
own sharding propagation takes tens of seconds an op on a mesh of three
or more axes.  On plain tensors the same body runs with no collective.
Every product is f32, the expert einsums as the reference writes them
(``:96-101``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ffpic_tpu_torch.models.vit import _softmax, is_dtensor, sgd_step
from ffpic_tpu_torch.utils.device import resolve_device

F32 = torch.float32


@dataclass(frozen=True)
class MoECfg:
    d_model: int = 32
    n_heads: int = 4
    n_experts: int = 4
    d_ff: int = 64
    seq_len: int = 16
    n_classes: int = 8


MOE_TINY = MoECfg()

# each parameter's PartitionSpec in the reference (``:53-65``)
SPECS = {
    "qkv": (None, "model"),             # column-parallel attention
    "proj": ("model", None),            # row-parallel back
    "router": (None, None),
    "w1": ("expert", None, "model"),    # ep x tp expert FFN
    "w2": ("expert", "model", None),
    "ln1": (None,),
    "ln2": (None,),
    "head": (None, None),
}
# the activations between the sub-blocks (``:76``)
ACT_SPEC = ("data", "seq", None)


def shapes(cfg: MoECfg) -> dict[str, tuple]:
    """Name -> shape of every parameter, in ``moe.init_params``' order."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"qkv": (d, 3 * d), "proj": (d, d), "router": (d, e),
            "w1": (e, d, f), "w2": (e, f, d), "ln1": (d,), "ln2": (d,),
            "head": (d, cfg.n_classes)}


def init_params(cfg: MoECfg, generator: torch.Generator,
                device=None) -> dict[str, torch.Tensor]:
    """Random f32 parameters, distributed as ``moe.init_params``
    (``:37-50``) draws them (normal times 0.02, unit layer-norm gains),
    from ``generator`` on the host, then moved to ``device`` (None:
    CUDA).  The numbers are not JAX's."""
    dev = resolve_device(device, "moe.init_params")
    out = {}
    for name, shape in shapes(cfg).items():
        if name.startswith("ln"):
            t = torch.ones(shape, dtype=F32)
        else:
            t = torch.randn(shape, generator=generator, dtype=F32) * 0.02
        out[name] = t.to(dev)
    return out


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX package's parameter dict (``moe.init_params``' leaves as
    numpy arrays) -> the port's on the CPU, f32."""
    return {k: torch.tensor(tree[k], dtype=F32) for k in shapes(MOE_TINY)}


def param_shardings(cfg: MoECfg, mesh) -> dict:
    """``moe.param_shardings`` (``:53-65``) as DTensor placements (one a
    mesh dimension) for each parameter, on a ``(data, seq, expert,
    model)`` mesh: ``w1``/``w2`` split over ``expert`` x ``model``,
    ``qkv``/``proj`` by columns/rows over ``model``, the rest
    replicated."""
    from ffpic_tpu_torch.parallel.mesh import placements
    return {k: placements(mesh, SPECS[k]) for k in shapes(cfg)}


def _ln(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``moe._ln`` (``:68-71``): no bias, eps 1e-6 inside ``rsqrt``."""
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6) * g


def _constrain(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.with_sharding_constraint(x, P("data", "seq", None))``:
    a DTensor redistributed to those placements, a tensor as it is."""
    if not is_dtensor(x):
        return x
    from ffpic_tpu_torch.parallel.mesh import placements, redistribute
    mesh = x.device_mesh
    return redistribute(x, mesh, placements(mesh, ACT_SPEC))


def _forward(cfg: MoECfg, p: dict, x: torch.Tensor, ax) -> torch.Tensor:
    """``moe.forward``'s body on this rank's parts (``ax``: a
    ``parallel.mesh.Axes``; with no mesh, the reference's forward).  x
    holds this rank's tokens; attention gathers the sequence and the
    attention weights, the FFN runs this rank's experts on its columns of
    ``d_ff``, and the gated combine is the sum over ``expert`` and
    ``model``."""
    # attention over the whole sequence
    h = _ln(ax.gather(x, 1, "seq"), p["ln1"])
    qkv = h @ ax.gather(p["qkv"], 1, "model")
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    b, t, d = q.shape
    hd = d // cfg.n_heads

    def heads(a):
        return a.reshape(b, t, cfg.n_heads, hd).transpose(1, 2)
    q, k, v = heads(q), heads(k), heads(v)
    att = _softmax(q @ k.transpose(-1, -2) / math.sqrt(hd))
    o = (att @ v).transpose(1, 2).reshape(b, t, d)
    x = x + ax.part(o @ ax.gather(p["proj"], 0, "model"), 1, "seq")

    # the MoE FFN: a dense dispatch over the experts, the gated combine
    # the reduction over the expert axis
    h = _ln(x, p["ln2"])
    gates = _softmax(h @ p["router"])                          # (B, T, E)
    hidden = torch.relu(torch.einsum("btd,edf->ebtf", h, p["w1"]))
    out = torch.einsum("ebtf,efd->ebtd", hidden, p["w2"])
    y = torch.einsum("bte,ebtd->btd", ax.part(gates, 2, "expert"), out)
    return x + ax.sum(ax.sum(y, "expert"), "model")


def _loss(cfg: MoECfg, p: dict, x: torch.Tensor, labels: torch.Tensor, ax,
          batch: int) -> torch.Tensor:
    """This rank's share of the loss of ``moe.make_train_step``
    (``:107-112``): the mean over tokens into ``head``, ``log_softmax``,
    the mean negative log-likelihood of ``labels`` over the ``batch``
    examples; each of the ranks that hold the same examples takes an
    equal share."""
    h = _forward(cfg, p, x, ax)
    logits = ax.sum(h.sum(dim=1), "seq") / cfg.seq_len @ p["head"]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None]).sum()
    replicas = ax.size("seq") * ax.size("expert") * ax.size("model")
    return nll / (batch * replicas)


def forward(cfg: MoECfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    """``moe.forward`` (``:74-103``): x (B, T, D) f32 activations ->
    (B, T, D).  On DTensors (a ``(data, seq, expert, model)`` mesh,
    ``param_shardings``' placements) each rank runs ``_forward`` on its
    parts through ``parallel.mesh.Axes`` and the result is split as the
    reference's ``P("data", "seq", None)``."""
    from ffpic_tpu_torch.parallel import mesh as pm
    if not is_dtensor(x):
        return _forward(cfg, params, x, pm.Axes())
    from torch.distributed.tensor import DTensor
    x = _constrain(x)
    mesh = x.device_mesh
    out = _forward(cfg, {k: v.to_local() for k, v in params.items()},
                   x.to_local(), pm.Axes(mesh))
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def loss_fn(cfg: MoECfg, params: dict, x: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The loss of ``moe.make_train_step`` (``:107-112``).  On DTensors
    (``labels`` split over ``data``) each rank computes its share on its
    parts, and the loss is the DTensor of their sum; the parameters'
    gradients come back partial over the axes that replicate them
    (``parallel.mesh.local_parts``)."""
    from ffpic_tpu_torch.parallel import mesh as pm
    if not is_dtensor(x):
        return _loss(cfg, params, x, labels, pm.Axes(), x.shape[0])
    x = _constrain(x)
    mesh = x.device_mesh
    share = _loss(cfg, pm.local_parts(params), x.to_local(),
                  labels.to_local(), pm.Axes(mesh), x.shape[0])
    return pm.partial_sum(share, mesh)


def make_train_step(cfg: MoECfg, lr: float = 1e-2):
    """``moe.make_train_step`` (``:106-119``): ``step(params, x, labels)
    -> (new_params, loss)``, one SGD step ``p - lr * g`` through
    ``torch.autograd``; DTensor gradients go back to their parameters'
    placements and the loss comes back replicated."""
    return sgd_step(lambda params, x, labels: loss_fn(cfg, params, x,
                                                      labels), lr)
