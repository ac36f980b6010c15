"""ffpic_tpu_torch.models.vit against ffpic_tpu.models.vit on the CPU, on
the same parameters (the JAX tree through ``params_from_jax``) and the
same inputs (numpy, from a seed).

The embedding and block of ``vit.forward`` are copied here
(``_jax_embed``, ``_jax_block``) to compare layer by layer; composed with
the reference's head they give ``vit.forward``'s logits bit for bit.

Tolerances.  ``params_from_jax`` is exact, and so is ``_bf16_mm``
against JAX's bf16 x bf16 -> bf16 product.  ``_ln`` agrees to 2e-6
(observed 4.8e-7: mean and variance are sums in another order).  The
patch embedding, a block and the whole forward agree to within 1e-2 of
the reference's largest magnitude (``BF16_REL``).  Both round the same
values to bf16 at the same places, so they differ only where an f32 sum
taken in another order lands on the other side of a bf16 rounding
boundary, which moves that element by 2**-8 (3.9e-3) of itself, and the
layers after carry that on.  Observed over 8 parameter seeds each, on
``VIT_TINY`` and a 2-layer ViT of width 64: either no such flip (up to
8.3e-7 of the largest logit) or up to 2.3e-3 of it; the argmax agreed
every time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffpic_tpu.models import vit as jvit
from ffpic_tpu_torch.models import vit
import reference_native  # noqa: F401  (readies ffpic_tpu first)

NARROW = vit.ViTConfig(image_size=32, patch=8, dim=64, depth=2, heads=2,
                       mlp_dim=128, n_classes=7)
BF16_REL = 1e-2


def _close(got, want) -> None:
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


def _jax_params(cfg, seed=0):
    tree = jvit.init_params(jvit.ViTConfig(*cfg), jax.random.PRNGKey(seed))
    return tree, jax.tree.map(np.array, tree)


def _model(cfg, seed=0):
    tree, np_tree = _jax_params(cfg, seed)
    return tree, vit.ViT(cfg, vit.params_from_jax(np_tree), device="cpu")


def _images(cfg, n=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.image_size, cfg.image_size, 3)) \
        .astype(np.float32)


def test_configs_match_the_reference():
    for ours, theirs in ((vit.VIT_B16, jvit.VIT_B16),
                         (vit.VIT_TINY, jvit.VIT_TINY)):
        assert tuple(ours) == tuple(theirs)
        assert ours.n_patches == theirs.n_patches
    assert (vit.VIT_B16.dim, vit.VIT_B16.depth, vit.VIT_B16.heads,
            vit.VIT_B16.mlp_dim, vit.VIT_B16.image_size,
            vit.VIT_B16.patch) == (768, 12, 12, 3072, 224, 16)


def test_params_from_jax_is_exact():
    _tree, np_tree = _jax_params(vit.VIT_TINY)
    state = vit.params_from_jax(np_tree)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        vit.shapes(vit.VIT_TINY)
    assert torch.equal(state["patch_w"], torch.from_numpy(np_tree["patch_w"]))
    assert torch.equal(state["ln_f_g"], torch.from_numpy(np_tree["ln_f"][0]))
    for i, blk in enumerate(np_tree["blocks"]):
        for k in ("qkv_w", "qkv_b", "proj_w", "fc1_w", "fc2_w", "fc2_b"):
            assert torch.equal(state[f"blocks.{i}.{k}"],
                               torch.from_numpy(blk[k]))
        assert torch.equal(state[f"blocks.{i}.ln2_b"],
                           torch.from_numpy(blk["ln2"][1]))
    model = vit.ViT(vit.VIT_TINY, state, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_ln_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 17, 128)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    want = np.asarray(jvit._ln(jnp.asarray(x), (g, b)))
    got = vit._ln(*map(torch.from_numpy, (x, g, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_bf16_product_rounds_once():
    """The f32 product of bf16-rounded values, rounded once, is JAX's
    bf16 x bf16 -> bf16 product."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((37, 96)).astype(np.float32)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    want = np.asarray((jnp.asarray(a).astype(jnp.bfloat16)
                       @ jnp.asarray(w).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    got = vit._bf16_mm(torch.from_numpy(a), vit._bf16(torch.from_numpy(w)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def _jax_embed(cfg, p, images):
    """``vit.forward``'s embedding, ffpic_tpu/models/vit.py:101-108."""
    n, ps = images.shape[0], cfg.patch
    x = images.reshape(n, cfg.image_size // ps, ps, cfg.image_size // ps,
                       ps, 3)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(n, cfg.n_patches, -1)
    x = x.astype(jnp.bfloat16) @ p["patch_w"].astype(jnp.bfloat16)
    x = x + p["patch_b"]
    cls = jnp.broadcast_to(p["cls"], (n, 1, cfg.dim)).astype(x.dtype)
    return jnp.concatenate([cls, x], axis=1) + p["pos"].astype(x.dtype)


def _jax_block(cfg, blk, x):
    """One iteration of ``vit.forward``'s loop, ffpic_tpu/models/vit.py:
    111-131."""
    n, t = x.shape[0], x.shape[1]
    hd = cfg.dim // cfg.heads
    h = jvit._ln(x.astype(jnp.float32), blk["ln1"]).astype(jnp.bfloat16)
    qkv = h @ blk["qkv_w"].astype(jnp.bfloat16) + blk["qkv_b"]
    q, k, v = jnp.split(qkv, 3, axis=-1)

    def heads_split(a):
        return a.reshape(n, t, cfg.heads, hd).transpose(0, 2, 1, 3)
    q, k, v = map(heads_split, (q, k, v))
    att = jnp.einsum("nhqd,nhkd->nhqk", q, k,
                     preferred_element_type=jnp.float32) * (hd ** -0.5)
    att = jax.nn.softmax(att, axis=-1).astype(jnp.bfloat16)
    out = jnp.einsum("nhqk,nhkd->nhqd", att, v,
                     preferred_element_type=jnp.float32)
    out = out.transpose(0, 2, 1, 3).reshape(n, t, cfg.dim)
    out = out.astype(jnp.bfloat16) @ blk["proj_w"].astype(jnp.bfloat16)
    x = x + out + blk["proj_b"]
    h = jvit._ln(x.astype(jnp.float32), blk["ln2"]).astype(jnp.bfloat16)
    h = jax.nn.gelu(h @ blk["fc1_w"].astype(jnp.bfloat16) + blk["fc1_b"])
    h = h @ blk["fc2_w"].astype(jnp.bfloat16) + blk["fc2_b"]
    return x + h


@pytest.mark.parametrize("cfg", [vit.VIT_TINY, NARROW],
                         ids=["vit_tiny", "narrow_2_layers"])
def test_reference_copies_are_vit_forward(cfg):
    """``_jax_embed`` and ``_jax_block`` are ``vit.forward`` itself: the
    embedding, the blocks in turn and the reference's own head give its
    logits bit for bit, so the copies the tests below compare with
    cannot drift from the reference."""
    tree, _model_ = _model(cfg, seed=9)
    x = _images(cfg, n=2, seed=10)
    jcfg = jvit.ViTConfig(*cfg)

    def composed(p, im):
        h = _jax_embed(cfg, p, im)
        for blk in p["blocks"]:
            h = _jax_block(cfg, blk, h)
        h = jvit._ln(h[:, 0].astype(jnp.float32), p["ln_f"])
        return h @ p["head_w"] + p["head_b"]

    want = np.asarray(jax.jit(lambda p, im: jvit.forward(jcfg, p, im))(
        tree, x))
    got = np.asarray(jax.jit(composed)(tree, x))
    np.testing.assert_array_equal(got, want)


def test_patch_embedding_matches_jax():
    tree, model = _model(vit.VIT_TINY)
    x = _images(vit.VIT_TINY)
    want = np.asarray(jax.jit(lambda p, im: _jax_embed(vit.VIT_TINY, p, im))(
        tree, x))
    got = model.embed(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("i", [0, 1])
def test_block_matches_jax(i):
    tree, model = _model(vit.VIT_TINY)
    rng = np.random.default_rng(4 + i)
    x = rng.standard_normal((3, vit.VIT_TINY.n_patches + 1,
                             vit.VIT_TINY.dim)).astype(np.float32)
    want = np.asarray(jax.jit(lambda b, a: _jax_block(vit.VIT_TINY, b, a))(
        tree["blocks"][i], x))
    got = model.block(torch.from_numpy(x), i)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("cfg", [vit.VIT_TINY, NARROW],
                         ids=["vit_tiny", "narrow_2_layers"])
def test_forward_matches_jax(cfg):
    tree, model = _model(cfg, seed=7)
    x = _images(cfg, n=4, seed=8)
    jcfg = jvit.ViTConfig(*cfg)
    want = np.asarray(jax.jit(lambda p, im: jvit.forward(jcfg, p, im))(
        tree, x))
    got = model(torch.from_numpy(x))
    assert got.shape == (4, cfg.n_classes) and got.dtype == torch.float32
    _close(got.numpy(), want)
    assert np.array_equal(got.numpy().argmax(1), want.argmax(1))


def test_bf16_product_ignores_the_callers_matmul_precision():
    """At "medium" float32 matmul precision (bf16 or TF32 products where
    the backend has them) ``_bf16_mm`` gives the same bf16 result, since
    products of bf16 values are exact at any of them, and a forward
    leaves the caller's setting as it was."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((33, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((128, 96)).astype(np.float32))
    _tree, model = _model(vit.VIT_TINY)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = vit._bf16_mm(a, vit._bf16(w))
        torch.set_float32_matmul_precision("medium")
        got = vit._bf16_mm(a, vit._bf16(w))
        model(torch.from_numpy(_images(vit.VIT_TINY)))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


def test_init_params_is_seeded_and_shaped():
    a = vit.init_params(vit.VIT_TINY, torch.Generator().manual_seed(3), "cpu")
    b = vit.init_params(vit.VIT_TINY, torch.Generator().manual_seed(3), "cpu")
    c = vit.init_params(vit.VIT_TINY, torch.Generator().manual_seed(4), "cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        vit.shapes(vit.VIT_TINY)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.qkv_w"], c["blocks.0.qkv_w"])
    # vit.init_params' scales: weights N(0, 1/dim), positions N(0, 0.02^2)
    w = a["blocks.0.fc1_w"]
    assert abs(float(w.std()) * vit.VIT_TINY.dim ** 0.5 - 1) < 0.05
    assert abs(float(a["pos"].std()) / 0.02 - 1) < 0.1
    assert torch.equal(a["blocks.1.ln1_g"], torch.ones(vit.VIT_TINY.dim))
    assert not a["cls"].any() and not a["head_b"].any()


def test_vit_checks_state_and_device():
    state = vit.init_params(NARROW, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="missing"):
        vit.ViT(NARROW, {k: v for k, v in state.items() if k != "pos"},
                device="cpu")
    bad = dict(state, pos=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="pos"):
        vit.ViT(NARROW, bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            vit.ViT(NARROW, state)


def test_forward_flops_counts_the_products():
    cfg, t = vit.VIT_B16, vit.VIT_B16.n_patches + 1
    per_block = 2 * t * 768 * (3 * 768 + 768 + 2 * 3072) + 4 * t * t * 768
    assert vit.forward_flops(cfg, 8) == 8 * (2 * 196 * 768 * 768
                                             + 12 * per_block
                                             + 2 * 768 * 1000)
