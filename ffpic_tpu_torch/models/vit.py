"""A compact ViT, the model behind the batched decode (BASELINE config 5:
decoded tensors batch straight into a model, replacing a PIL
dataloader): the PyTorch counterpart of ``ffpic_tpu/models/vit.py``'s
serving half (``ViTConfig``, ``init_params``, ``forward``).

``ViT(cfg, state=None, *, generator=None, device=None)`` holds the
parameters under the JAX tree's names (``init_params`` draws them from
an explicit ``torch.Generator``; ``params_from_jax`` takes them from the
JAX package's tree as numpy arrays) and ``forward(images)`` is
``vit.forward`` (``:99-136``) with its dtype flow mirrored op for op:

* ``bf16 @ bf16`` gives bf16: the patch embedding, ``qkv``, ``proj`` and
  ``fc1``.  XLA accumulates such a product in f32 and rounds once to
  bf16; the port multiplies the bf16-rounded values as f32 tensors and
  rounds the f32 result once (``_bf16_mm``).  A product of two bf16
  values is exact in f32, and in TF32 too, so the result does not depend
  on the caller's float32 matmul precision; no global setting is read
  or changed.
* ``bf16 + f32 bias`` promotes to f32: ``q``, ``k`` and ``v`` are f32,
  the attention scores an f32 product, and ``att.astype(bf16)`` times
  the f32 ``v`` an f32 product of the bf16-rounded weights; after
  ``fc1`` (GELU) the hidden state is f32, so ``h @ fc2_w.astype(bf16)``
  is an f32 x bf16 -> f32 product.  These f32 products, and the head's,
  run at the caller's float32 matmul precision ("highest" unless the
  caller changed it: full f32, as XLA's default on the CPU).
* ``jax.nn.gelu``'s default, the tanh approximation, written as JAX
  writes it; ``_ln`` with eps 1e-6 and ``rsqrt``; the softmax as
  ``jax.nn.softmax`` computes it (``exp(x - max) / sum``).  Attention is
  the two products and that softmax.

Training (``loss_fn``, ``make_train_step``), the MoE block and the mesh
shardings are not ported (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ffpic_tpu_torch.utils.device import resolve_device

F32, BF16 = torch.float32, torch.bfloat16


class ViTConfig(NamedTuple):
    image_size: int = 224
    patch: int = 16
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    n_classes: int = 1000

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


VIT_B16 = ViTConfig()
VIT_TINY = ViTConfig(image_size=64, patch=16, dim=128, depth=2, heads=4,
                     mlp_dim=256, n_classes=10)

def shapes(cfg: ViTConfig) -> dict[str, tuple]:
    """Name -> shape of every parameter, the port's state: the JAX tree's
    leaves, a block's under ``blocks.<i>.``, each layer norm's pair as
    ``_g`` and ``_b``."""
    d, m = cfg.dim, cfg.mlp_dim
    out = {"patch_w": (cfg.patch * cfg.patch * 3, d), "patch_b": (d,),
           "pos": (cfg.n_patches + 1, d), "cls": (d,),
           "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,),
           "ln_f_g": (d,), "ln_f_b": (d,)}
    blk = {"ln1_g": (d,), "ln1_b": (d,), "qkv_w": (d, 3 * d),
           "qkv_b": (3 * d,), "proj_w": (d, d), "proj_b": (d,),
           "ln2_g": (d,), "ln2_b": (d,), "fc1_w": (d, m), "fc1_b": (m,),
           "fc2_w": (m, d), "fc2_b": (d,)}
    for i in range(cfg.depth):
        out.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    return out


def init_params(cfg: ViTConfig, generator: torch.Generator,
                device=None) -> dict[str, torch.Tensor]:
    """Random f32 parameters, distributed as ``vit.init_params`` draws
    them (normal weights times dim**-0.5, positions times 0.02, zero
    biases and class token, unit layer-norm gains), from ``generator``
    on the host, then moved to ``device`` (None: CUDA).  The numbers are
    not JAX's: a ``jax.random`` key and a torch generator differ."""
    dev = resolve_device(device, "init_params")
    scale = cfg.dim ** -0.5
    state = {}
    for name, shape in shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("_w"):
            t = torch.randn(shape, generator=generator, dtype=F32) * scale
        elif leaf == "pos":
            t = torch.randn(shape, generator=generator, dtype=F32) * 0.02
        elif leaf.endswith("_g"):
            t = torch.ones(shape, dtype=F32)
        else:
            t = torch.zeros(shape, dtype=F32)
        state[name] = t.to(dev)
    return state


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree (``vit.init_params``' layout,
    leaves as numpy arrays) -> the port's state on the CPU, f32."""
    def t(a):
        return torch.tensor(a, dtype=F32)
    state = {k: t(tree[k]) for k in ("patch_w", "patch_b", "pos", "cls",
                                     "head_w", "head_b")}
    state["ln_f_g"], state["ln_f_b"] = map(t, tree["ln_f"])
    for i, blk in enumerate(tree["blocks"]):
        for k in ("qkv_w", "qkv_b", "proj_w", "proj_b", "fc1_w", "fc1_b",
                  "fc2_w", "fc2_b"):
            state[f"blocks.{i}.{k}"] = t(blk[k])
        for ln in ("ln1", "ln2"):
            g, b = blk[ln]
            state[f"blocks.{i}.{ln}_g"] = t(g)
            state[f"blocks.{i}.{ln}_b"] = t(b)
    return state


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, held in f32."""
    return t.to(BF16).to(F32)


def _bf16_mm(a: torch.Tensor, w16: torch.Tensor) -> torch.Tensor:
    """XLA's ``a.astype(bf16) @ w.astype(bf16)``, ``w16`` the weight
    already rounded to bf16 (``_bf16``): exact products of the
    bf16-rounded values, summed in f32, one rounding to bf16."""
    return torch.matmul(_bf16(a), w16).to(BF16)


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``vit._ln`` (``:92-96``): eps 1e-6 inside ``rsqrt``."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, op for op."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi)
                                  * (x + 0.044715 * (x ** 3))))
    return x * cdf


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


class ViT(nn.Module):
    """ViT-B/16 (or any ``ViTConfig``) for inference on ``device`` (None:
    CUDA, which must be available; "cpu" runs on the host).  ``state`` is
    a dict of ``shapes(cfg)``'s names (from ``init_params`` or
    ``params_from_jax``); without one, ``init_params(cfg, generator)``
    draws it (a generator seeded with 0 unless given)."""

    def __init__(self, cfg: ViTConfig, state: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device, "ViT")
        if state is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state = init_params(cfg, generator, dev)
        want = shapes(cfg)
        if set(state) != set(want):
            raise ValueError(f"state: missing {sorted(set(want) - set(state))}"
                             f", unexpected {sorted(set(state) - set(want))}")
        self.params = nn.ParameterDict()
        for name, shape in want.items():
            t = torch.as_tensor(state[name])
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{shape}")
            self.params[name.replace(".", "_")] = nn.Parameter(
                t.to(device=dev, dtype=F32), requires_grad=False)
        # the weights of the bf16 products, rounded once here and not
        # in every forward
        for name in want:
            if name.endswith(("patch_w", "qkv_w", "proj_w", "fc1_w",
                              "fc2_w")):
                self.register_buffer(name.replace(".", "_") + "_bf16",
                                     _bf16(self._p(name)), persistent=False)

    def _p(self, name: str) -> torch.Tensor:
        return self.params[name.replace(".", "_")]

    def _w16(self, name: str) -> torch.Tensor:
        return getattr(self, name.replace(".", "_") + "_bf16")

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) f32 -> (N, T, dim) f32 tokens: the patches'
        bf16 product, the class token and the positions (``:101-108``)."""
        cfg, p = self.cfg, self._p
        n, ps, g = images.shape[0], cfg.patch, cfg.image_size // cfg.patch
        x = images.reshape(n, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5) \
            .reshape(n, cfg.n_patches, -1)
        x = _bf16_mm(x, self._w16("patch_w")) + p("patch_b")            # f32
        cls = p("cls").expand(n, 1, cfg.dim)
        return torch.cat([cls, x], dim=1) + p("pos")

    def block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Block ``i`` on (N, T, dim) f32 tokens (``:111-131``)."""
        cfg, p, b = self.cfg, self._p, f"blocks.{i}."
        n, t, hd = x.shape[0], x.shape[1], cfg.dim // cfg.heads
        h = _ln(x, p(b + "ln1_g"), p(b + "ln1_b"))
        qkv = _bf16_mm(h, self._w16(b + "qkv_w")) + p(b + "qkv_b")      # f32
        q, k, v = (s.reshape(n, t, cfg.heads, hd).transpose(1, 2)
                   for s in qkv.split(cfg.dim, dim=-1))
        att = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
        att = _bf16(_softmax(att))
        out = torch.matmul(att, v).transpose(1, 2).reshape(n, t, cfg.dim)
        x = x + _bf16_mm(out, self._w16(b + "proj_w")) + p(b + "proj_b")
        h = _ln(x, p(b + "ln2_g"), p(b + "ln2_b"))
        h = _gelu_tanh(_bf16_mm(h, self._w16(b + "fc1_w")) + p(b + "fc1_b"))
        h = torch.matmul(h, self._w16(b + "fc2_w")) + p(b + "fc2_b")
        return x + h

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The class token's layer norm and the f32 head (``:133-134``)."""
        x = _ln(x[:, 0], self._p("ln_f_g"), self._p("ln_f_b"))
        return torch.matmul(x, self._p("head_w")) + self._p("head_b")

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (N, H, W, 3) float32, normalised
        (``ops.resize.normalize_for_model``).  Returns (N, n_classes)
        f32 logits."""
        x = self.embed(images)
        for i in range(self.cfg.depth):
            x = self.block(x, i)
        return self.head(x)


def forward_flops(cfg: ViTConfig, n: int) -> int:
    """Operations of one forward of ``n`` images, a multiply-add as 2:
    the matrix products only (patch embedding, per block qkv, the two
    attention products, proj, fc1, fc2, and the head)."""
    t, d, m = cfg.n_patches + 1, cfg.dim, cfg.mlp_dim
    per_block = 2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d \
        + 2 * 2 * t * d * m
    return n * (2 * cfg.n_patches * cfg.patch ** 2 * 3 * d
                + cfg.depth * per_block + 2 * d * cfg.n_classes)
