"""The port's multi-device layer on the CPU: one gloo world of 8 ranks
(``tests/torch_mesh_ranks.py``, one process a rank, torch only) against
the JAX package on 8 CPU devices (``tests/conftest.py``) and against the
port in one process, on the same inputs (the JAX trees through
``params_from_jax``, numpy from seeds, files the port's ``testing``
writes).  The meshes are those of ``MULTICHIP_r05.json``: the ViT step
on ``data 4 x model 2``, the MoE step on ``data 2 x seq 2 x expert 2 x
model 1``, the decode on ``data 8``.

The first worker of the run that needs the world starts it, under a
lock in a directory of the run's own (``tests/torch_shared.py``); the
others wait for its reports there.  Every rank leaves at its deadline
whatever happens (``faulthandler``), its collectives wait at most
``COLLECTIVE_S``, and a rank that raises fails the tests at once.  The
JAX references are computed once a run the same way and shared through
that directory.

Tolerances.  Each rank's initial shards are the JAX arrays'
``addressable_shards`` at the same mesh coordinate, bit for bit.  The
ViT step partitioned over ``data 4 x model 2`` rounds partial products
to bf16 in other places than one process does (JAX's own partitioned
step differs from its single-device step by up to 1.7e-2 of a
gradient's largest element over 8 seeds; ``tests/test_torch_train.py``),
so its updates are held to ``GRAD_REL_MESH`` = 2**-5 (four bf16 steps) of
the largest gradient, and its loss to ``LOSS_REL`` of itself.  The MoE is
f32: 1e-5 of the largest element.  The decode is integer up to the
colour's FMA contraction, which JAX's jit may or may not make: each
element equals the port's fused or unfused result
(``testing.assert_equal_up_to_contraction``'s rule), and the sharded
decode equals the single-process decode bit for bit.
"""

from __future__ import annotations

import fcntl
import functools
import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import ffpic_tpu
from ffpic_tpu.models import moe as jmoe
from ffpic_tpu.models import vit as jvit
from ffpic_tpu.parallel import make_mesh as jax_make_mesh
from ffpic_tpu.parallel import sharded_decode_420 as jax_sharded_decode_420
import ffpic_tpu_torch
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.models import moe, vit
from ffpic_tpu_torch.ops.jpeg_kernels import decode_batch_420_planes
import reference_native  # noqa: F401  (readies ffpic_tpu first)
from torch_shared import run_dir as _run_dir, shared, vit_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 8
DEADLINE_S = 300        # a rank's whole life
COLLECTIVE_S = 240      # a collective's wait
LOSS_REL = 2e-3
GRAD_REL_MESH = 2.0 ** -5
F32_REL = 1e-5
F32_STEP = 2.0 ** -22
VIT_CFG = vit.VIT_TINY
MOE_FACTORS = (2, 2, 2, 1)
MOE_NAMES = ("data", "seq", "expert", "model")


# --- inputs -----------------------------------------------------------------

def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _files(specs) -> list[bytes]:
    out = []
    for kind, h, w, seed in specs:
        rgb = testing.synth_rgb(h, w, seed)
        if kind == "jpeg420":
            out.append(testing.encode_jpeg(rgb, 60 + 5 * seed))
        elif kind == "jpeg444":
            out.append(testing.encode_jpeg(rgb, 90, sampling=((1, 1),) * 3))
        elif kind == "png_rgba":
            a = np.full((h, w, 1), 200, np.uint8)
            out.append(testing.encode_png(np.concatenate([rgb, a], -1), 6))
        else:
            out.append(testing.encode_png(rgb, 2))
    return out


@shared
def _spec() -> dict:
    rng = np.random.default_rng(100)
    vit_tree = jvit.init_params(jvit.ViTConfig(*VIT_CFG),
                                jax.random.PRNGKey(0))
    moe_tree = jmoe.init_params(jmoe.MOE_TINY, jax.random.PRNGKey(1))

    def planes(n, q):
        return {"planes": tuple(
            rng.integers(-lim, lim, (n, g, g, 8, 8)).astype(np.int16)
            for lim, g in ((128, 4), (64, 2), (64, 2))), "quant": q}
    per_image = tuple(rng.integers(1, 64, (9, 1, 1, 8, 8)).astype(np.int32)
                      for _ in range(2))
    one_table = tuple(rng.integers(1, 64, (8, 8)).astype(np.int32)
                      for _ in range(2))
    flat = (np.full((8, 8), 8, np.int32),) * 2
    return {
        "jobs": ["vit", "moe", "decode", "pipeline", "dryrun"],
        "timeout": COLLECTIVE_S, "deadline": DEADLINE_S,
        "vit": {"cfg": tuple(VIT_CFG), "tp": 2,
                "params": {k: v.numpy() for k, v in vit.params_from_jax(
                    _np_tree(vit_tree)).items()},
                "images": rng.standard_normal((8, 64, 64, 3))
                .astype(np.float32),
                "labels": (np.arange(8) % VIT_CFG.n_classes)
                .astype(np.int32)},
        "moe": {"factors": MOE_FACTORS,
                "params": {k: v.numpy() for k, v in moe.params_from_jax(
                    _np_tree(moe_tree)).items()},
                "x": np.random.default_rng(2).normal(size=(4, 16, 32))
                .astype(np.float32),
                "labels": (np.arange(4) % 8).astype(np.int32)},
        "decode": {"cases": {
            "even_n8": dict(planes(8, flat), mode="reference"),
            "ragged_n9_per_image_tables": dict(planes(9, per_image),
                                               mode="bt601"),
            "ragged_n9_shared_tables": dict(planes(9, one_table),
                                            mode="reference")}},
        "pipeline": {"cases": {
            # one size: four 4:2:0 JPEGs (one geometry), a 4:4:4 JPEG and
            # two PNGs; 7 members over 8 ranks
            "mixed": {"size": None, "files": _files(
                [("jpeg420", 64, 64, 1), ("png_rgba", 64, 64, 2),
                 ("jpeg420", 64, 64, 3), ("jpeg444", 64, 64, 4),
                 ("png_rgb", 64, 64, 5), ("jpeg420", 64, 64, 6),
                 ("jpeg420", 64, 64, 7)])},
            # two 4:2:0 geometries, PNGs, resized; 9 members over 8 ranks
            "sized": {"size": (40, 56), "files": _files(
                [("jpeg420", 64, 48, 1), ("jpeg420", 80, 96, 2),
                 ("png_rgb", 50, 70, 3), ("jpeg420", 64, 48, 4),
                 ("jpeg444", 32, 40, 5), ("png_rgba", 64, 64, 6),
                 ("jpeg420", 80, 96, 7), ("jpeg420", 64, 48, 8),
                 ("png_rgb", 17, 29, 9)])}}},
        "dryrun": {"n": WORLD},
    }


def _remove_old_runs(d: str, age_s: float = 3600) -> None:
    """The directories of this module's runs that started over an hour
    ago (their ranks are long gone)."""
    import glob
    import shutil
    for old in glob.glob(os.path.join(os.path.dirname(d),
                                      "ffpic_torch_mesh_*")):
        mark = os.path.join(old, "started")
        if old != d and os.path.exists(mark) and \
                time.time() - os.path.getmtime(mark) > age_s:
            shutil.rmtree(old, ignore_errors=True)


def _start_world() -> None:
    """Spawn the world's ranks, unless another worker of this run did."""
    d = _run_dir()
    started = os.path.join(d, "started")
    with open(os.path.join(d, "world.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(started):
            return
        _remove_old_runs(d)
        spec_path = os.path.join(d, "world_spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(_spec(), f)
        env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
        for r in range(WORLD):
            with open(os.path.join(d, f"log{r}.txt"), "w") as log:
                subprocess.Popen(
                    [sys.executable, os.path.join(HERE, "torch_mesh_ranks.py"),
                     spec_path, str(r), str(WORLD), d],
                    stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT, env=env, start_new_session=True)
        with open(started, "w") as f:
            f.write(str(time.time()))


def _world_results() -> list[dict]:
    """Every rank's report, once all are written; a rank's error, or
    the ranks' deadline passing, fails at once with its log."""
    d = _run_dir()
    with open(os.path.join(d, "started")) as f:
        t0 = float(f.read())
    while True:
        done = [os.path.exists(os.path.join(d, f"rank{r}.pkl"))
                for r in range(WORLD)]
        if all(done):
            break
        failed = [r for r in range(WORLD) if os.path.exists(
            os.path.join(d, f"rank{r}.err"))]
        late = time.time() - t0 > DEADLINE_S + 30
        if failed or late:
            r = failed[0] if failed else done.index(False)
            with open(os.path.join(d, f"log{r}.txt")) as f:
                pytest.fail(f"rank {r} of the gloo world "
                            f"{'failed' if failed else 'never finished'}:"
                            f"\n{f.read()[-4000:]}")
        time.sleep(0.2)
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def world():
    """The world's reports: the first xdist worker of the run to get here
    starts it, every worker waits for it and reads it."""
    _start_world()
    return _world_results()


# --- the JAX references and the port in one process ------------------------

def _rank_of(jmesh, device) -> int:
    """The row-major rank of ``device``'s place in the JAX mesh."""
    where = np.argwhere(jmesh.devices == device)[0]
    return int(np.ravel_multi_index(tuple(where), jmesh.devices.shape))


def _shards(jmesh, arr) -> dict[int, np.ndarray]:
    return {_rank_of(jmesh, s.device): np.array(s.data)
            for s in arr.addressable_shards}


@shared
def _vit_jax():
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = _spec()["vit"]
    jcfg = jvit.ViTConfig(*VIT_CFG)
    tree = jvit.init_params(jcfg, jax.random.PRNGKey(0))
    jmesh = jax_make_mesh(model_parallel=2)
    sh = jvit.param_shardings(jcfg, jmesh)
    placed = jax.tree.map(lambda a, s: jax.device_put(a, s), tree, sh,
                          is_leaf=lambda a: isinstance(a, jax.Array))
    dsh = NamedSharding(jmesh, P("data"))
    step = jax.jit(jvit.make_train_step(jcfg), in_shardings=(sh, dsh, dsh),
                   out_shardings=(sh, NamedSharding(jmesh, P())))
    new, loss = step(placed, spec["images"], spec["labels"])
    _loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jvit.loss_fn, jcfg)))(tree, spec["images"], spec["labels"])
    names = list(vit.shapes(VIT_CFG))
    return {"init": dict(zip(names, (_shards(jmesh, a)
                                     for a in vit_leaves(placed)))),
            "new": dict(zip(names, (_shards(jmesh, a)
                                    for a in vit_leaves(new)))),
            "loss": float(loss),
            "grad_max": dict(zip(names, (float(np.abs(np.array(g)).max())
                                         for g in vit_leaves(grads))))}



@shared
def _moe_jax():
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    spec = _spec()["moe"]
    cfg = jmoe.MOE_TINY
    jmesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(MOE_FACTORS),
                 MOE_NAMES)
    with jmesh:
        tree = jmoe.init_params(cfg, jax.random.PRNGKey(1))
        sh = jmoe.param_shardings(cfg, jmesh)
        placed = jax.tree.map(lambda a, s: jax.device_put(a, s), tree, sh)
        xsh = NamedSharding(jmesh, P("data", "seq", None))
        lsh = NamedSharding(jmesh, P("data"))
        x = jax.device_put(spec["x"], xsh)
        y = jax.device_put(spec["labels"], lsh)
        step = jax.jit(jmoe.make_train_step(cfg), in_shardings=(sh, xsh, lsh),
                       out_shardings=(sh, NamedSharding(jmesh, P())))
        new, loss = step(placed, x, y)
        fwd = jax.jit(lambda p, a: jmoe.forward(cfg, p, a))(placed, x)
    return {"init": {k: _shards(jmesh, v) for k, v in placed.items()},
            "new": {k: _shards(jmesh, v) for k, v in new.items()},
            "loss": float(loss), "forward": np.array(fwd),
            "new_full": {k: np.array(v) for k, v in new.items()}}


@shared
def _decode_jax():
    spec = _spec()
    jmesh = jax_make_mesh(model_parallel=1)
    out = {}
    for name, c in spec["decode"]["cases"].items():
        arr = jax_sharded_decode_420(jmesh, *c["planes"], *c["quant"],
                                     order="rgba", mode=c["mode"])
        out[name] = {"full": np.array(arr), "shards": _shards(jmesh, arr)
                     if c["planes"][0].shape[0] == WORLD else None}
    for name, c in spec["pipeline"]["cases"].items():
        out["pipeline_" + name] = np.array(ffpic_tpu.decode_batch(
            c["files"], size=c["size"], mesh=jmesh))
    return out


@shared
def _vit_single():
    spec = _spec()["vit"]
    state = {k: torch.from_numpy(v) for k, v in spec["params"].items()}
    new, loss = vit.make_train_step(VIT_CFG)(
        state, torch.from_numpy(spec["images"]),
        torch.from_numpy(spec["labels"]))
    return {k: v.numpy() for k, v in new.items()}, float(loss)


@shared
def _moe_single():
    spec = _spec()["moe"]
    state = {k: torch.from_numpy(v) for k, v in spec["params"].items()}
    x, y = torch.from_numpy(spec["x"]), torch.from_numpy(spec["labels"])
    new, loss = moe.make_train_step(moe.MOE_TINY)(state, x, y)
    return ({k: v.numpy() for k, v in new.items()}, float(loss),
            moe.forward(moe.MOE_TINY, state, x).numpy())


def _update_close(got, want, p, grad_max: float, lr: float, rel: float):
    """New parameters ``p - lr * g`` within ``rel`` of the largest
    gradient times ``lr``, plus two f32 steps of the largest |p|."""
    err = np.abs(np.asarray(got, np.float64) - want).max() if got.size else 0
    assert err <= lr * rel * grad_max + F32_STEP * np.abs(p).max(), err


def _either_colour(got: dict, want: np.ndarray) -> None:
    """Each element of JAX's decode equals the port's fused or unfused
    colour (``testing.assert_equal_up_to_contraction``'s rule)."""
    fused, unfused = got["full"], got["unfused"]
    assert fused.shape == want.shape and unfused.shape == want.shape
    bad = (want != fused) & (want != unfused)
    assert not bad.any(), f"{int(bad.sum())} elements equal neither rounding"


# --- the ViT step on data 4 x model 2 ---------------------------------------

VIT_NAMES = list(vit.shapes(VIT_CFG))


@pytest.mark.parametrize("name", VIT_NAMES)
def test_vit_shards_match_jax_at_each_coordinate(world, name):
    ref = _vit_jax()
    p = _spec()["vit"]["params"][name]
    for r, rep in enumerate(world):
        v = rep["vit"]
        assert v["coord"] == [r // 2, r % 2]
        np.testing.assert_array_equal(v["init"][name], ref["init"][name][r])
        assert v["placements"][name] == v["want"][name]
        _update_close(v["new"][name], ref["new"][name][r], p,
                      ref["grad_max"][name], 1e-3, GRAD_REL_MESH)


@pytest.mark.parametrize("name", VIT_NAMES)
def test_vit_sharded_step_matches_one_process(world, name):
    single, _loss = _vit_single()
    ref = _vit_jax()
    _update_close(world[0]["vit"]["new_full"][name], single[name],
                  _spec()["vit"]["params"][name],
                  ref["grad_max"][name], 1e-3, GRAD_REL_MESH)


def test_vit_sharded_loss(world):
    _single, loss = _vit_single()
    losses = {rep["vit"]["loss"] for rep in world}
    assert len(losses) == 1
    got = losses.pop()
    assert world[0]["vit"]["loss_placements"] == ["R", "R"]
    assert abs(got - loss) <= LOSS_REL * abs(loss)
    ref = _vit_jax()["loss"]
    assert abs(got - ref) <= LOSS_REL * abs(ref)


# --- the MoE step on data 2 x seq 2 x expert 2 x model 1 --------------------

MOE_PARAMS = list(moe.shapes(moe.MOE_TINY))


def _f32_close(got, want) -> None:
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(np.asarray(got, np.float64) - want).max() <= F32_REL * scale


@pytest.mark.parametrize("name", MOE_PARAMS)
def test_moe_shards_match_jax_at_each_coordinate(world, name):
    ref = _moe_jax()
    for r, rep in enumerate(world):
        m = rep["moe"]
        assert m["coord"] == list(np.unravel_index(r, MOE_FACTORS))
        np.testing.assert_array_equal(m["init"][name], ref["init"][name][r])
        assert m["placements"][name] == m["want"][name]
        _f32_close(m["new"][name], ref["new"][name][r])


@pytest.mark.parametrize("name", MOE_PARAMS)
def test_moe_sharded_step_matches_one_process(world, name):
    single, _loss, _y = _moe_single()
    _f32_close(world[0]["moe"]["new_full"][name], single[name])
    _f32_close(world[0]["moe"]["new_full"][name],
               _moe_jax()["new_full"][name])


def test_moe_sharded_loss_and_forward(world):
    _single, loss, y = _moe_single()
    ref = _moe_jax()
    m = world[0]["moe"]
    assert {rep["moe"]["loss"] for rep in world} == {m["loss"]}
    assert m["loss_placements"] == ["R"] * 4
    assert abs(m["loss"] - loss) <= F32_REL * abs(loss)
    assert abs(m["loss"] - ref["loss"]) <= F32_REL * abs(ref["loss"])
    assert m["forward_placements"] == ["S(0)", "S(1)", "R", "R"]
    _f32_close(m["forward"], y)
    _f32_close(m["forward"], ref["forward"])


# --- the decode on data 8 ---------------------------------------------------

@pytest.mark.parametrize("case", ["even_n8", "ragged_n9_per_image_tables",
                                  "ragged_n9_shared_tables"])
def test_sharded_decode_420(world, case):
    c = _spec()["decode"]["cases"][case]
    n = c["planes"][0].shape[0]
    got = world[0]["decode"][case]
    assert got["shape"] == (n, 32, 32, 4) and got["placements"] == ["S(0)",
                                                                    "R"]
    # the reference's padded layout cut at n: 2, 2, 2, 2, 1, 0, 0, 0 for 9
    m = -(-n // WORLD)
    sizes = [rep["decode"][case]["local"].shape[0] for rep in world]
    assert sizes == [max(0, min(m, n - r * m)) for r in range(WORLD)]
    single = decode_batch_420_planes(
        *(torch.from_numpy(a) for a in c["planes"]),
        *(torch.from_numpy(q) for q in c["quant"]), mode=c["mode"])
    np.testing.assert_array_equal(got["full"], single.numpy())
    np.testing.assert_array_equal(
        np.concatenate([rep["decode"][case]["local"] for rep in world]),
        got["full"])
    ref = _decode_jax()[case]
    _either_colour(got, ref["full"])
    if ref["shards"] is not None:
        for r, rep in enumerate(world):
            local = rep["decode"][case]["local"]
            want = ref["shards"][r]
            rows = slice(r * m, (r + 1) * m)
            assert ((want == local)
                    | (want == got["unfused"][rows])).all()


# --- decode_batch(mesh=) ----------------------------------------------------

@pytest.mark.parametrize("case", ["mixed", "sized"])
def test_decode_batch_on_a_mesh(world, case):
    c = _spec()["pipeline"]["cases"][case]
    got = world[0]["pipeline"][case]
    n = len(c["files"])
    assert got["placements"] == ["S(0)", "R"] and got["shape"][0] == n
    np.testing.assert_array_equal(
        np.concatenate([rep["pipeline"][case]["local"] for rep in world]),
        got["full"])
    one = ffpic_tpu_torch.decode_batch(c["files"], size=c["size"],
                                       device="cpu").numpy()
    want = _decode_jax()["pipeline_" + case]
    if c["size"] is None:
        # no resize: the reference's bytes, up to its colour's contraction
        np.testing.assert_array_equal(got["full"], one)
        _either_colour(got, want)
    else:
        # the resize's sums run in another order than XLA's: 1 LSB
        # (tests/test_torch_resize.py); the one-process port exactly
        np.testing.assert_array_equal(got["full"], one)
        assert np.abs(got["full"].astype(int) - want).max() <= 1


def test_decode_batch_mesh_refuses_another_device(world):
    assert "not the mesh's 'cpu'" in world[0]["pipeline"]["device_mismatch"]


# --- the graft entry --------------------------------------------------------

def test_dryrun_multichip_runs_on_8_ranks(world):
    """``__graft_entry__.dryrun_multichip(8)``'s meshes
    (``MULTICHIP_r05.json``), one loss on every rank, each finite."""
    res = {repr(rep["dryrun"]) for rep in world}
    assert len(res) == 1
    r = world[0]["dryrun"]
    assert r["mesh"] == {"data": 4, "model": 2}
    assert r["moe_mesh"] == {"data": 2, "seq": 2, "expert": 2, "model": 1}
    assert np.isfinite(r["loss"]) and np.isfinite(r["moe_loss"])
    # near ln(10) and ln(8): an untrained classifier
    assert abs(r["loss"] - np.log(10)) < 1 and abs(r["moe_loss"]
                                                   - np.log(8)) < 1
    with open(os.path.join(_run_dir(), "log0.txt")) as f:
        log = f.read()
    assert "dryrun_multichip ok: mesh={'data': 4, 'model': 2}" in log
    assert "dryrun_multichip moe ok: mesh={'data': 2, 'seq': 2, " in log
