"""One rank of the gloo worlds that ``tests/test_torch_mesh.py`` starts.

    python tests/torch_mesh_ranks.py SPEC RANK WORLD OUT

``SPEC`` is a pickle the test writes: the jobs to run, in order, with
their inputs (numpy arrays made by the test from seeds, file bytes) and
the seconds any collective may wait.  Every rank joins one gloo process
group through a ``FileStore`` beside the spec, runs every job (each job's
collectives on every rank), and writes what it saw to ``OUT/rank<R>.pkl``:
its mesh coordinates, its local shards, the placements, and (rank 0
only) the gathered tensors.  This process imports torch, numpy and
``ffpic_tpu_torch`` only; the JAX side stays in the test's process.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ffpic_tpu_torch.parallel import mesh as pm  # noqa: E402


def _local(t) -> np.ndarray:
    return t.to_local().detach().cpu().numpy()


def _gathered(t, rank: int):
    """The whole tensor on rank 0 (every rank takes part in the gather)."""
    full = t.full_tensor().detach().cpu().numpy()
    return full if rank == 0 else None


def _step_world(mesh, params, shardings, step, inputs, rank: int) -> dict:
    """Place ``params`` by ``shardings``, run ``step`` once, report."""
    placed = {k: pm.distribute(mesh, torch.from_numpy(v), shardings[k])
              for k, v in params.items()}
    new, loss = step(placed, *inputs)
    return {"coord": list(mesh.get_coordinate()),
            "init": {k: _local(v) for k, v in placed.items()},
            "new": {k: _local(v) for k, v in new.items()},
            "new_full": {k: _gathered(v, rank) for k, v in new.items()},
            "placements": {k: [str(p) for p in v.placements]
                           for k, v in new.items()},
            "want": {k: [str(p) for p in shardings[k]] for k in new},
            "loss": float(loss.to_local()),
            "loss_placements": [str(p) for p in loss.placements]}


def vit_job(spec: dict, rank: int) -> dict:
    from ffpic_tpu_torch.models import vit
    cfg = vit.ViTConfig(*spec["cfg"])
    mesh = pm.make_mesh(model_parallel=spec["tp"], device_type="cpu")
    x = pm.shard_batch(mesh, spec["images"])
    y = pm.shard_batch(mesh, spec["labels"])
    return _step_world(mesh, spec["params"], vit.param_shardings(cfg, mesh),
                       vit.make_train_step(cfg), (x, y), rank)


def moe_job(spec: dict, rank: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    from ffpic_tpu_torch.models import moe
    cfg = moe.MOE_TINY
    mesh = init_device_mesh("cpu", spec["factors"], mesh_dim_names=(
        "data", "seq", "expert", "model"))
    x = pm.distribute(mesh, torch.from_numpy(spec["x"]),
                      pm.placements(mesh, moe.ACT_SPEC))
    y = pm.distribute(mesh, torch.from_numpy(spec["labels"]),
                      pm.placements(mesh, ("data",)))
    out = _step_world(mesh, spec["params"], moe.param_shardings(cfg, mesh),
                      moe.make_train_step(cfg), (x, y), rank)
    fwd = moe.forward(cfg, {k: pm.distribute(
        mesh, torch.from_numpy(v), moe.param_shardings(cfg, mesh)[k])
        for k, v in spec["params"].items()}, x)
    out["forward"] = _gathered(fwd, rank)
    out["forward_placements"] = [str(p) for p in fwd.placements]
    return out


def _both_colours(run) -> dict:
    """``run()`` as it is and under ``testing.unfused_colour()``: the two
    roundings the JAX colour may take (``testing.
    assert_equal_up_to_contraction``)."""
    from ffpic_tpu_torch import testing
    out = run()
    with testing.unfused_colour():
        out["unfused"] = run()["full"]
    return out


def decode_job(spec: dict, rank: int) -> dict:
    mesh = pm.make_mesh(device_type="cpu")
    out = {}
    for name, case in spec["cases"].items():
        def run(case=case):
            d = pm.sharded_decode_420(mesh, *case["planes"], *case["quant"],
                                      order="rgba", mode=case["mode"])
            return {"coord": list(mesh.get_coordinate()),
                    "local": _local(d), "full": _gathered(d, rank),
                    "shape": tuple(d.shape),
                    "placements": [str(p) for p in d.placements]}
        out[name] = _both_colours(run)
    return out


def pipeline_job(spec: dict, rank: int) -> dict:
    from ffpic_tpu_torch import decode_batch
    mesh = pm.make_mesh(device_type="cpu")
    out = {}
    for name, case in spec["cases"].items():
        def run(case=case):
            d = decode_batch(case["files"], size=case["size"], mesh=mesh)
            return {"local": _local(d), "full": _gathered(d, rank),
                    "shape": tuple(d.shape),
                    "placements": [str(p) for p in d.placements]}
        out[name] = _both_colours(run)
    try:
        decode_batch(spec["cases"]["mixed"]["files"][:1], mesh=mesh,
                     device="cuda")
        out["device_mismatch"] = "no error"
    except ValueError as e:
        out["device_mismatch"] = str(e)
    return out


def dryrun_job(spec: dict, rank: int) -> dict:
    from ffpic_tpu_torch import graft_entry
    return graft_entry.dryrun_multichip(spec["n"], device="cpu")


JOBS = {"vit": vit_job, "moe": moe_job, "decode": decode_job,
        "pipeline": pipeline_job, "dryrun": dryrun_job}


def main() -> int:
    spec_path, rank, world, out = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4])
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    # a rank still here at the deadline prints where it waits, and exits
    faulthandler.dump_traceback_later(spec["deadline"], exit=True)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{spec_path}.store", rank=rank,
        world_size=world, timeout=datetime.timedelta(
            seconds=spec["timeout"]))
    try:
        res = {}
        for name in spec["jobs"]:
            t0 = time.perf_counter()
            res[name] = JOBS[name](spec[name], rank)
            res.setdefault("seconds", {})[name] = time.perf_counter() - t0
    except BaseException as e:
        # the test stops waiting at once, and shows why
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.tmp"), "wb") as f:
        pickle.dump(res, f)
    os.replace(os.path.join(out, f"rank{rank}.tmp"),
               os.path.join(out, f"rank{rank}.pkl"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
