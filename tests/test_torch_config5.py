"""BASELINE config 5 on the CPU: a mixed batch of JPEG, PNG and WebP
members through ``decode_batch(size=)``, ``normalize_for_model`` and a
ViT forward, the port against the JAX package's chain as
``tests/test_pipeline.py:39-53`` runs it, on the same bytes and the same
parameters (the JAX tree through ``params_from_jax``).

Tolerances.  The decoded, resized batch: 1 LSB (``test_torch_resize.py``:
the resize's sums run in another order than XLA's).  The port's
normalise and ViT on JAX's batch: within 1e-2 of the largest logit, the
ViT's bf16-level tolerance (``test_torch_vit.py``; normalise adds f32
rounding only).  The chain end to end: within 5e-2 of the largest logit,
because a pixel off by 1 moves its normalised value by 2/255, a
quarter of a bf16 step near 1, and the ViT carries such steps on
(observed: 4.7e-3 of it on these members, argmaxes all equal).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import ffpic_tpu
from ffpic_tpu.models import vit as jvit
from ffpic_tpu.ops.resize import normalize_for_model as jax_normalize
import ffpic_tpu_torch
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.models import vit
from ffpic_tpu_torch.ops.resize import normalize_for_model
import reference_native  # noqa: F401  (readies ffpic_tpu first)

CFG = vit.VIT_TINY
SIZE = (CFG.image_size, CFG.image_size)


@functools.lru_cache(maxsize=None)
def _members():
    return tuple(testing.config5_members(96, 128, ("lossy_512.webp",
                                                   "odd_333x199.webp")))


@functools.lru_cache(maxsize=None)
def _jax_chain():
    """JAX's batch, normalised input and logits, and its parameters."""
    params = jvit.init_params(jvit.ViTConfig(*CFG), jax.random.PRNGKey(0))
    batch = ffpic_tpu.decode_batch(list(_members()), size=SIZE)
    x = jax_normalize(batch)
    logits = jax.jit(lambda p, im: jvit.forward(jvit.ViTConfig(*CFG), p,
                                                im))(params, x)
    return (np.array(batch), np.array(x), np.array(logits),
            jax.tree.map(np.array, params))


@pytest.fixture(scope="module")
def model():
    return vit.ViT(CFG, vit.params_from_jax(_jax_chain()[3]), device="cpu")


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def test_members_are_the_config5_mix():
    kinds = [ffpic_tpu_torch.probe(m).name for m in _members()]
    assert kinds == ["JPG", "WEBP", "JPG", "PNG", "JPG", "WEBP", "PNG",
                     "JPG"]


def test_chain_matches_jax(model):
    want_batch, _x, want_logits, _p = _jax_chain()
    batch = ffpic_tpu_torch.decode_batch(list(_members()), size=SIZE,
                                         device="cpu")
    assert batch.shape == (8, *SIZE, 4) and batch.dtype == torch.uint8
    assert np.abs(batch.numpy().astype(int) - want_batch).max() <= 1
    x = normalize_for_model(batch)
    assert x.shape == (8, *SIZE, 3) and x.dtype == torch.float32
    logits = model(x)
    assert logits.shape == (8, CFG.n_classes)
    assert bool(logits.isfinite().all())
    assert _rel(logits.numpy(), want_logits) <= 5e-2


def test_normalize_and_vit_on_jax_batch(model):
    """On JAX's own decoded batch the port's normalise and forward hold
    JAX's to the ViT's tolerance, and pick the same classes."""
    want_batch, want_x, want_logits, _p = _jax_chain()
    x = normalize_for_model(torch.from_numpy(want_batch))
    assert np.abs(x.numpy() - want_x).max() <= 2 * 2.0 ** -22 / 0.5
    logits = model(x).numpy()
    assert _rel(logits, want_logits) <= 1e-2
    assert np.array_equal(logits.argmax(1), want_logits.argmax(1))


def test_normalize_resize_in_one_call_matches_jax(model):
    """The chain's other form: the unresized batch resized by
    ``normalize_for_model(size=)`` (K17 with its resize on the card)."""
    batch = ffpic_tpu_torch.decode_batch(list(_members())[:1] * 2
                                         + list(_members())[2:3] * 2,
                                         device="cpu")
    want = np.asarray(jax_normalize(batch.numpy(), SIZE))
    x = normalize_for_model(batch, SIZE)
    err_x = np.abs(x.numpy().astype(np.float64) - want).max() * 0.5
    assert err_x <= float(np.spacing(np.float32(128)))
    assert model(x).shape == (4, CFG.n_classes)
