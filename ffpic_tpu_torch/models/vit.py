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

The forward is one function, ``forward(cfg, params, images)`` over a
dict of ``shapes(cfg)``'s names; ``ViT`` serves it under ``no_grad``
with the bf16 weights rounded once.  The training half mirrors
``vit.py:139-155``: ``loss_fn`` (an f32 ``log_softmax``, the labels'
entries, the mean) and ``make_train_step`` (plain SGD through
``torch.autograd``; the bf16 weights are rounded in each forward, since
they change each step).  Each cast to bf16 and back rounds the incoming
gradient once, as XLA's VJP of ``astype`` does, so the gradients flow
through the same roundings as JAX's.  ``param_shardings`` gives the
reference's Megatron split (``:72-89``) as DTensor placements on a
``parallel.make_mesh`` DeviceMesh; the same ``forward`` and step run on
DTensors placed so (``parallel.mesh.distribute``), DTensor inserting
the collectives XLA inserts.
"""

from __future__ import annotations

import functools
import math
import sys
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


# the weights of the bf16 products
BF16_WEIGHTS = ("patch_w", "qkv_w", "proj_w", "fc1_w", "fc2_w")


def rounded_weights(params: dict) -> dict:
    """The weights of the bf16 products, rounded to bf16 (held in f32)."""
    return {k: _bf16(v) for k, v in params.items()
            if k.endswith(BF16_WEIGHTS)}


def embed(cfg: ViTConfig, params: dict, w16: dict,
          images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) f32 -> (N, T, dim) f32 tokens: the patches'
    bf16 product, the class token and the positions (``:101-108``)."""
    p = params
    n, ps, g = images.shape[0], cfg.patch, cfg.image_size // cfg.patch
    x = images.reshape(n, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, cfg.n_patches, -1)
    x = _bf16_mm(x, w16["patch_w"]) + p["patch_b"]                     # f32
    cls = p["cls"].expand(n, 1, cfg.dim)
    return torch.cat([cls, x], dim=1) + p["pos"]


def block(cfg: ViTConfig, params: dict, w16: dict, x: torch.Tensor,
          i: int) -> torch.Tensor:
    """Block ``i`` on (N, T, dim) f32 tokens (``:111-131``)."""
    p, b = params, f"blocks.{i}."
    n, t, hd = x.shape[0], x.shape[1], cfg.dim // cfg.heads
    h = _ln(x, p[b + "ln1_g"], p[b + "ln1_b"])
    qkv = _bf16_mm(h, w16[b + "qkv_w"]) + p[b + "qkv_b"]                # f32
    q, k, v = (s.reshape(n, t, cfg.heads, hd).transpose(1, 2)
               for s in qkv.split(cfg.dim, dim=-1))
    att = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
    att = _bf16(_softmax(att))
    out = torch.matmul(att, v).transpose(1, 2).reshape(n, t, cfg.dim)
    x = x + _bf16_mm(out, w16[b + "proj_w"]) + p[b + "proj_b"]
    h = _ln(x, p[b + "ln2_g"], p[b + "ln2_b"])
    h = _gelu_tanh(_bf16_mm(h, w16[b + "fc1_w"]) + p[b + "fc1_b"])
    h = torch.matmul(h, w16[b + "fc2_w"]) + p[b + "fc2_b"]
    return x + h


def head(cfg: ViTConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The class token's layer norm and the f32 head (``:133-134``)."""
    x = _ln(x[:, 0], params["ln_f_g"], params["ln_f_b"])
    return torch.matmul(x, params["head_w"]) + params["head_b"]


def forward(cfg: ViTConfig, params: dict, images: torch.Tensor,
            w16: dict | None = None) -> torch.Tensor:
    """``vit.forward`` (``:99-136``): images (N, H, W, 3) float32,
    normalised (``ops.resize.normalize_for_model``), -> (N, n_classes)
    f32 logits.  ``params``: a dict of ``shapes(cfg)``'s names, tensors
    or DTensors.  ``w16``: ``rounded_weights(params)``, when the caller
    keeps them; None rounds them here."""
    if w16 is None:
        w16 = rounded_weights(params)
    x = embed(cfg, params, w16, images)
    for i in range(cfg.depth):
        x = block(cfg, params, w16, x, i)
    return head(cfg, params, x)


def loss_fn(cfg: ViTConfig, params: dict, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """``vit.loss_fn`` (``:139-142``): the mean negative log-likelihood
    of ``labels`` (N,) integers under the f32 ``log_softmax`` of the
    logits."""
    logp = torch.log_softmax(forward(cfg, params, images).to(F32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def make_train_step(cfg: ViTConfig, lr: float = 1e-3):
    """``vit.make_train_step`` (``:145-155``): ``step(params, images,
    labels) -> (new_params, loss)``, one plain SGD step ``p - lr * g``
    on new tensors through ``torch.autograd``.  With DTensor parameters
    each gradient is redistributed to its parameter's placements before
    the update, so ``new_params`` keeps ``param_shardings``' placements
    (the reference's ``out_shardings``), and the loss comes back
    replicated."""
    return sgd_step(functools.partial(loss_fn, cfg), lr)


def sgd_step(loss, lr: float):
    """``step(params, *inputs) -> (new_params, loss)``: the value and
    gradient of ``loss(params, *inputs)`` by ``torch.autograd``, then
    ``p - lr * g`` for each parameter (``jax.value_and_grad`` and a
    ``tree.map``).  Shared by the ViT's and the MoE's steps."""

    def step(params: dict, *inputs):
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            value = loss(dict(zip(names, leaves)), *inputs)
            grads = torch.autograd.grad(value, leaves)
        new = {}
        for k, p, g in zip(names, leaves, grads):
            p = p.detach()
            if is_dtensor(p):
                from ffpic_tpu_torch.parallel.mesh import redistribute
                g = redistribute(g, p.device_mesh, p.placements)
            new[k] = p - lr * g
        value = value.detach()
        if is_dtensor(value):
            from ffpic_tpu_torch.parallel.mesh import replicate
            value = replicate(value)
        return new, value

    return step


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (without importing DTensor, which a
    process that made none has no need of)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def param_shardings(cfg: ViTConfig, mesh) -> dict:
    """``vit.param_shardings`` (``:72-89``) as DTensor placements (one a
    mesh dimension) for each of ``shapes(cfg)``'s names, on a ``(data,
    model)`` mesh (``parallel.make_mesh``): ``qkv_w`` and ``fc1_w``
    split by columns over ``model`` and their biases with them,
    ``proj_w`` and ``fc2_w`` by rows, everything else replicated.  The
    fused ``(dim, 3 dim)`` ``qkv_w`` is split as one matrix, as the
    reference's ``P(None, "model")`` splits it."""
    from ffpic_tpu_torch.parallel.mesh import placements
    specs = {"qkv_w": (None, "model"), "qkv_b": ("model",),
             "proj_w": ("model", None), "fc1_w": (None, "model"),
             "fc1_b": ("model",), "fc2_w": ("model", None)}
    return {name: placements(mesh, specs.get(name.rsplit(".", 1)[-1], ()))
            for name in shapes(cfg)}


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
        for name, w in rounded_weights(self.state()).items():
            self.register_buffer(name.replace(".", "_") + "_bf16", w,
                                 persistent=False)

    def state(self) -> dict:
        """The parameters under ``shapes(cfg)``'s names."""
        return {name: self.params[name.replace(".", "_")]
                for name in shapes(self.cfg)}

    def _w16(self) -> dict:
        return {name: getattr(self, name.replace(".", "_") + "_bf16")
                for name in shapes(self.cfg) if name.endswith(BF16_WEIGHTS)}

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        return embed(self.cfg, self.state(), self._w16(), images)

    def block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return block(self.cfg, self.state(), self._w16(), x, i)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return head(self.cfg, self.state(), x)

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (N, H, W, 3) float32, normalised
        (``ops.resize.normalize_for_model``).  Returns (N, n_classes)
        f32 logits."""
        return forward(self.cfg, self.state(), images, self._w16())


def forward_flops(cfg: ViTConfig, n: int) -> int:
    """Operations of one forward of ``n`` images, a multiply-add as 2:
    the matrix products only (patch embedding, per block qkv, the two
    attention products, proj, fc1, fc2, and the head)."""
    t, d, m = cfg.n_patches + 1, cfg.dim, cfg.mlp_dim
    per_block = 2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d \
        + 2 * 2 * t * d * m
    return n * (2 * cfg.n_patches * cfg.patch ** 2 * 3 * d
                + cfg.depth * per_block + 2 * d * cfg.n_classes)
