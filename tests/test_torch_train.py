"""The training half of the port's models on the CPU, one process, against
the JAX package on the same parameters (the JAX trees through
``params_from_jax``) and the same inputs (numpy, from seeds):
``vit.loss_fn`` / ``make_train_step``, ``moe.forward`` / ``loss_fn`` /
``make_train_step``, the graft entry, and the shardings' placements.

Tolerances.  ViT: both packages round the same values to bf16 at the
same places in the forward and, through the VJPs of the casts, in the
backward (a cast to bf16 and back rounds the incoming gradient once,
as XLA's transpose of ``astype`` does), so they differ only where an
f32 sum taken in another order lands on the other side of a bf16
rounding boundary.  Such a flip moves an element by one bf16 step, at
most 2**-7 of itself, and the layers after carry it on.  Observed on
``VIT_TINY`` over 8 parameter seeds (batch 8): the loss within 7.3e-4
of itself, each parameter's gradient within 8.9e-3 of its largest
element (about one bf16 step); JAX's own step partitioned over ``data 4
x model 2`` differs from its single-device step by up to 7.7e-4 and
1.7e-2 on the same seeds.  Held here: ``LOSS_REL`` 2e-3 and ``GRAD_REL``
2**-6 (two bf16 steps of the largest gradient).  The step's new
parameters ``p - lr * g`` are held to ``lr`` times that plus two f32
steps of the largest |p| (the rounding of the subtraction).  MoE: all
f32, so the port and JAX differ by f32 rounding in sums taken in
another order: ``F32_REL`` 1e-5 of the largest element (observed 7.3e-8
on the forward, 0 on the loss).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffpic_tpu.models import moe as jmoe
from ffpic_tpu.models import vit as jvit
from ffpic_tpu_torch import graft_entry
from ffpic_tpu_torch.models import moe, vit
import reference_native  # noqa: F401  (readies ffpic_tpu first)
from torch_shared import shared, vit_leaves

LOSS_REL = 2e-3
GRAD_REL = 2.0 ** -6
F32_REL = 1e-5
F32_STEP = 2.0 ** -22           # two f32 steps, relative
CFG = vit.VIT_TINY
BATCH = 8


def _vit_inputs(seed=0):
    tree = jvit.init_params(jvit.ViTConfig(*CFG), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((BATCH, CFG.image_size, CFG.image_size, 3)) \
        .astype(np.float32)
    labels = (np.arange(BATCH) % CFG.n_classes).astype(np.int32)
    return tree, x, labels


@shared
def _vit_runs():
    """JAX's and the port's loss, gradients and one step on VIT_TINY."""
    tree, x, labels = _vit_inputs()
    jcfg = jvit.ViTConfig(*CFG)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jvit.loss_fn, jcfg)))(tree, x, labels)
    jnew, jloss2 = jax.jit(jvit.make_train_step(jcfg))(tree, x, labels)
    state = vit.params_from_jax(jax.tree.map(np.array, tree))
    xt, yt = torch.from_numpy(x), torch.from_numpy(labels)
    leaves = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    loss = vit.loss_fn(CFG, leaves, xt, yt)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    new, loss2 = vit.make_train_step(CFG)(state, xt, yt)
    return {"state": state, "loss": float(loss.detach()),
            "loss2": float(loss2),
            "jloss": float(jloss), "jloss2": float(jloss2),
            "grads": grads,
            "jgrads": vit.params_from_jax(jax.tree.map(np.array, jgrads)),
            "new": new,
            "jnew": vit.params_from_jax(jax.tree.map(np.array, jnew))}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_vit_loss_matches_jax():
    r = _vit_runs()
    assert abs(r["loss"] - r["jloss"]) <= LOSS_REL * abs(r["jloss"])
    # the step reports the loss of the parameters it was given
    assert r["loss2"] == r["loss"] and r["jloss2"] == r["jloss"]


@pytest.mark.parametrize("name", list(vit.shapes(CFG)))
def test_vit_gradient_and_step_match_jax(name):
    r = _vit_runs()
    g, jg = r["grads"][name].numpy(), r["jgrads"][name].numpy()
    assert g.dtype == np.float32 and g.shape == jg.shape
    assert _rel(g, jg) <= GRAD_REL, _rel(g, jg)
    p = r["state"][name].numpy().astype(np.float64)
    new = r["new"][name]
    assert new.dtype == torch.float32 and not new.requires_grad
    err = np.abs(new.numpy().astype(np.float64) - r["jnew"][name].numpy())
    lr = 1e-3
    assert err.max() <= lr * GRAD_REL * np.abs(jg).max() \
        + F32_STEP * np.abs(p).max(), err.max()


def test_vit_step_leaves_its_inputs_alone():
    tree, x, labels = _vit_inputs(seed=3)
    state = vit.params_from_jax(jax.tree.map(np.array, tree))
    before = {k: v.clone() for k, v in state.items()}
    new, loss = vit.make_train_step(CFG, lr=0.5)(
        state, torch.from_numpy(x), torch.from_numpy(labels))
    assert all(torch.equal(state[k], before[k]) for k in state)
    assert not any(v.requires_grad for v in state.values())
    assert set(new) == set(state) and loss.shape == ()
    assert any(not torch.equal(new[k], state[k]) for k in state)


def test_serving_is_the_functional_forward_bit_for_bit():
    """``ViT.forward`` (its cached bf16 weights, no_grad) gives the
    logits of ``vit.forward``, which rounds the weights itself: the
    serving path the refactor moved, unchanged."""
    tree, x, _labels = _vit_inputs(seed=5)
    state = vit.params_from_jax(jax.tree.map(np.array, tree))
    model = vit.ViT(CFG, state, device="cpu")
    xt = torch.from_numpy(x)
    got = model(xt)
    assert not got.requires_grad
    assert torch.equal(got, vit.forward(CFG, state, xt))
    assert torch.equal(got, vit.forward(CFG, model.state(), xt,
                                        vit.rounded_weights(state)))


# --- MoE ----------------------------------------------------------------

def _jax_moe_loss(cfg, params, x, labels):
    """The loss of ``moe.make_train_step``, ffpic_tpu/models/moe.py:
    107-112 (nested there)."""
    h = jmoe.forward(cfg, params, x)
    logits = h.mean(axis=1) @ params["head"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.take_along_axis(logp, labels[:, None], axis=1).mean()


def _one_device_mesh():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1),
                ("data", "seq", "expert", "model"))


@shared
def _moe_runs(seed=1):
    tree = jmoe.init_params(jmoe.MOE_TINY, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(4, 16, 32)).astype(np.float32)
    labels = (np.arange(4) % 8).astype(np.int32)
    cfg = jmoe.MOE_TINY
    with _one_device_mesh():
        jy = jax.jit(lambda p, a: jmoe.forward(cfg, p, a))(tree, x)
        jloss, jgrads = jax.jit(jax.value_and_grad(
            functools.partial(_jax_moe_loss, cfg)))(tree, x, labels)
        jnew, jloss2 = jax.jit(jmoe.make_train_step(cfg))(tree, x, labels)
    state = moe.params_from_jax(jax.tree.map(np.array, tree))
    xt, yt = torch.from_numpy(x), torch.from_numpy(labels)
    leaves = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    loss = moe.loss_fn(moe.MOE_TINY, leaves, xt, yt)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    new, loss2 = moe.make_train_step(moe.MOE_TINY)(state, xt, yt)
    return {"y": moe.forward(moe.MOE_TINY, state, xt).numpy(),
            "jy": np.array(jy), "loss": float(loss.detach()),
            "loss2": float(loss2),
            "jloss": float(jloss), "jloss2": float(jloss2), "grads": grads,
            "jgrads": moe.params_from_jax(jax.tree.map(np.array, jgrads)),
            "state": state, "new": new,
            "jnew": moe.params_from_jax(jax.tree.map(np.array, jnew))}


def test_moe_config_and_init_match_the_reference():
    assert moe.MOE_TINY == moe.MoECfg(*(getattr(jmoe.MOE_TINY, f) for f in (
        "d_model", "n_heads", "n_experts", "d_ff", "seq_len", "n_classes")))
    tree = jmoe.init_params(jmoe.MOE_TINY, jax.random.PRNGKey(1))
    state = moe.params_from_jax(jax.tree.map(np.array, tree))
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        moe.shapes(moe.MOE_TINY) == {k: tuple(v.shape)
                                     for k, v in tree.items()}
    ours = moe.init_params(moe.MOE_TINY, torch.Generator().manual_seed(1),
                           "cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        moe.shapes(moe.MOE_TINY)
    assert torch.equal(ours["ln1"], torch.ones(32))
    assert abs(float(ours["w1"].std()) / 0.02 - 1) < 0.1


def test_moe_loss_copy_is_the_references():
    tree = jmoe.init_params(jmoe.MOE_TINY, jax.random.PRNGKey(4))
    x = np.random.default_rng(5).normal(size=(2, 16, 32)).astype(np.float32)
    labels = np.array([3, 5], np.int32)
    with _one_device_mesh():
        _new, want = jax.jit(jmoe.make_train_step(jmoe.MOE_TINY))(
            tree, x, labels)
        got = jax.jit(functools.partial(_jax_moe_loss, jmoe.MOE_TINY))(
            tree, x, labels)
    assert float(got) == float(want)


def test_moe_forward_and_loss_match_jax():
    r = _moe_runs()
    assert r["y"].shape == (4, 16, 32) and r["y"].dtype == np.float32
    assert _rel(r["y"], r["jy"]) <= F32_REL
    assert abs(r["loss"] - r["jloss"]) <= F32_REL * abs(r["jloss"])
    assert r["loss2"] == r["loss"] and r["jloss2"] == r["jloss"]


@pytest.mark.parametrize("name", list(moe.shapes(moe.MOE_TINY)))
def test_moe_gradient_and_step_match_jax(name):
    r = _moe_runs()
    g, jg = r["grads"][name].numpy(), r["jgrads"][name].numpy()
    scale = np.abs(jg).max()
    assert np.abs(g.astype(np.float64) - jg).max() <= F32_REL * scale
    p = r["state"][name].numpy().astype(np.float64)
    err = np.abs(r["new"][name].numpy().astype(np.float64)
                 - r["jnew"][name].numpy())
    assert err.max() <= 1e-2 * F32_REL * scale + F32_STEP * np.abs(p).max()


# --- the graft entry and the shardings ------------------------------------

def test_entry_is_the_references_bit_for_bit():
    import importlib
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ge = importlib.import_module("__graft_entry__")
    jfn, jargs = ge.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    for a, ja in zip(args, jargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    got = fn(*args)
    assert tuple(got.shape) == (2, 128, 128, 4) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()


@pytest.mark.parametrize("n, factors", [(8, (2, 2, 2, 1)), (4, (2, 2, 1, 1)),
                                        (1, (1, 1, 1, 1)), (16, (2, 2, 2, 2)),
                                        (6, (2, 1, 1, 3))])
def test_moe_factors_are_the_references(n, factors):
    """``__graft_entry__.py:125-132``'s loop; at 6 devices it leaves a
    model axis of 3, which divides neither d_model 32 nor d_ff 64."""
    assert graft_entry.moe_factors(n) == factors
    if n == 6:
        with pytest.raises(ValueError, match="model of extent 3 .*d_model=32"):
            graft_entry.check_moe_mesh(moe.MOE_TINY, factors)
    else:
        graft_entry.check_moe_mesh(moe.MOE_TINY, factors)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo process group of one rank in this process (a DeviceMesh
    needs one), taken down after the module."""
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("one_rank") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _placements_of(spec, names) -> list[str]:
    """A JAX PartitionSpec -> the DTensor placements it names, as str."""
    out = ["R"] * len(names)
    for d, axis in enumerate(spec):
        if axis is not None:
            out[names.index(axis)] = f"S({d})"
    return out


def test_param_shardings_name_the_references_partition_specs(one_rank):
    from jax.sharding import Mesh
    from torch.distributed.device_mesh import init_device_mesh
    from ffpic_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and mesh.shape == (1, 1)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jsh = jvit.param_shardings(jvit.ViTConfig(*CFG), jmesh)
    want = {k: _placements_of(s.spec, ("data", "model"))
            for k, s in zip(vit.shapes(CFG), vit_leaves(jsh))}
    got = {k: [str(p) for p in v]
           for k, v in vit.param_shardings(CFG, mesh).items()}
    assert got == want
    assert got["blocks.1.qkv_w"] == ["R", "S(1)"]
    assert got["blocks.0.fc2_w"] == ["R", "S(0)"]
    names4 = ("data", "seq", "expert", "model")
    mesh4 = init_device_mesh("cpu", (1, 1, 1, 1), mesh_dim_names=names4)
    jmesh4 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1), names4)
    jmsh = jmoe.param_shardings(jmoe.MOE_TINY, jmesh4)
    got4 = {k: [str(p) for p in v]
            for k, v in moe.param_shardings(moe.MOE_TINY, mesh4).items()}
    assert got4 == {k: _placements_of(jmsh[k].spec, names4) for k in jmsh}
    assert got4["w1"] == ["R", "R", "S(0)", "S(2)"]
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        make_mesh(model_parallel=2, device_type="cpu")
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(n_devices=8, device_type="cpu")
