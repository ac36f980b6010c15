"""What the test modules of the port's training and mesh layers share:
values computed once a test run and shared between pytest-xdist's
workers (``shared``: the first worker that asks computes a value under a
lock and pickles it into a directory of the run's own, named by xdist's
run id, which every worker of a run shares; the others read it back),
and the order of a JAX ViT tree's leaves (``vit_leaves``)."""

from __future__ import annotations

import fcntl
import functools
import os
import pickle
import tempfile
import uuid

_LOCAL_RUN = uuid.uuid4().hex


def run_dir() -> str:
    """A directory of this test run's own, the same in every xdist
    worker of the run."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID") or _LOCAL_RUN
    d = os.path.join(tempfile.gettempdir(), f"ffpic_torch_mesh_{run}")
    os.makedirs(d, exist_ok=True)
    return d


def shared(make):
    """Decorate a function of no arguments: its value is computed once a
    run, by the first worker that asks, and read back by the others."""
    @functools.lru_cache(maxsize=None)
    def get():
        path = os.path.join(run_dir(), f"{make.__module__}.{make.__name__}"
                            ".pkl")
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(path):
                value = make()
                with open(path + ".tmp", "wb") as f:
                    pickle.dump(value, f)
                os.replace(path + ".tmp", path)
        with open(path, "rb") as f:
            return pickle.load(f)
    return get


def vit_leaves(tree) -> list:
    """A JAX ViT tree's leaves (``vit.init_params``' layout) in the
    port's ``vit.shapes`` order."""
    out = [tree[k] for k in ("patch_w", "patch_b", "pos", "cls", "head_w",
                             "head_b")] + list(tree["ln_f"])
    for blk in tree["blocks"]:
        out += [blk["ln1"][0], blk["ln1"][1], blk["qkv_w"], blk["qkv_b"],
                blk["proj_w"], blk["proj_b"], blk["ln2"][0], blk["ln2"][1],
                blk["fc1_w"], blk["fc1_b"], blk["fc2_w"], blk["fc2_b"]]
    return out
