"""Multi-device decode and the model's shardings on a
``torch.distributed`` DeviceMesh: the counterpart of
``ffpic_tpu/parallel/mesh.py``.

The reference shards the image batch over the ``data`` axis of a
``(data, model)`` JAX mesh and leaves the ``model`` axis to the
tensor-parallel ViT (``models.vit.param_shardings``).  Here the mesh is
a DeviceMesh over the ranks of a process group that already exists, one
rank a device (NCCL on CUDA, gloo on the CPU), and a sharded array is a
DTensor.  Decode needs no collective: each rank decodes its own rows of
the batch (K2 + K3 on CUDA, their plain versions on the CPU).

A JAX ``PartitionSpec`` names, for each dimension of an array, the mesh
axis that splits it; ``placements`` turns one into DTensor placements,
one a mesh dimension, and ``distribute`` places a tensor that every rank
holds whole by slicing out each rank's part, with no communication.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)

from ffpic_tpu_torch.utils.device import to_device

__all__ = ["make_mesh", "shard_batch", "sharded_decode_420"]


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device_type: str | None = None) -> DeviceMesh:
    """A ``(data, model)`` mesh of shape ``(n // model_parallel,
    model_parallel)`` over the process group's ranks, row-major as the
    reference's ``np.array(devices).reshape`` (``:27-38``): rank r sits
    at ``(r // tp, r % tp)``.  ``n_devices`` is the world size (None
    takes it); ``device_type`` "cuda" (None) or "cpu".  Raises
    ``ValueError`` when ``model_parallel`` does not divide n, as the
    reference does."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: {n} devices, but the process group "
                         f"has {world} ranks (one a device)")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by tp={model_parallel}")
    return init_device_mesh(device_type or "cuda",
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's part of a ``mesh`` DTensor lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def placements(mesh: DeviceMesh, spec) -> list[Placement]:
    """A ``PartitionSpec``'s entries (an axis name or None for each
    leading dimension of the array, the rest unsplit) -> DTensor
    placements, one a mesh dimension: ``Shard(d)`` where the spec names
    that mesh axis at dimension d, ``Replicate()`` elsewhere."""
    names = mesh.mesh_dim_names
    out: list[Placement] = [Replicate()] * mesh.ndim
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in names:
            raise ValueError(f"axis {axis!r} is not one of the mesh's "
                             f"{names}")
        out[names.index(axis)] = Shard(d)
    return out


def distribute(mesh: DeviceMesh, t: torch.Tensor,
               places) -> DTensor:
    """A tensor that every rank holds whole -> a DTensor with
    ``places``, each rank keeping its own part (no communication).
    Raises ``ValueError`` where a mesh axis's extent does not divide the
    dimension it splits: the reference's even split is the only one."""
    for m, p in enumerate(places):
        if isinstance(p, Shard) and t.shape[p.dim] % mesh.size(m):
            raise ValueError(
                f"mesh axis {mesh.mesh_dim_names[m]!r} of extent "
                f"{mesh.size(m)} does not divide dimension {p.dim} of a "
                f"{tuple(t.shape)} tensor")
    return distribute_tensor(t.to(mesh_device(mesh)), mesh, places,
                             src_data_rank=None)


def redistribute(t: DTensor, mesh: DeviceMesh, places) -> DTensor:
    """``t.redistribute(mesh, places)``, a partial sum reduced in full
    first: gloo has no reduce-scatter."""
    places = list(places)
    if any(isinstance(p, Partial) for p in t.placements):
        t = t.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                  else p for p in t.placements])
    return t if list(t.placements) == places else t.redistribute(mesh,
                                                                 places)


def replicate(t: DTensor) -> DTensor:
    """``t`` replicated on every rank of its mesh."""
    return redistribute(t, t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _data(mesh: DeviceMesh) -> tuple[int, int]:
    """(extent of the ``data`` axis, this rank's coordinate on it)."""
    return mesh["data"].size(), mesh.get_local_rank("data")


def _pad_to(x, n: int):
    """Pad the leading dimension up to ``n`` with zeros (``:41-46``)."""
    if x.shape[0] == n:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((n - x.shape[0], *x.shape[1:]))])
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad)


def _rows(mesh: DeviceMesh, x):
    """This rank's rows of ``x`` (leading dimension N) padded with zeros
    up to a multiple of the data axis, as the reference lays them out
    over ``P("data")``: (rows, N padded)."""
    dp, c = _data(mesh)
    m = -(-x.shape[0] // dp)
    return _pad_to(x[c * m:(c + 1) * m], m), m * dp


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _wrap(local: torch.Tensor, mesh: DeviceMesh, places,
          shape) -> DTensor:
    """``local`` as this rank's part of a DTensor of global ``shape``
    (contiguous), with no communication and no check."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def _from_rows(mesh: DeviceMesh, local: torch.Tensor, n: int) -> DTensor:
    """This rank's rows of a padded batch -> the DTensor of its first
    ``n`` rows, ``Shard(0)`` over ``data``: each rank keeps the rows
    below n (the slice ``[:n]`` of the reference, ``:58``, ``:91``),
    torch.chunk's uneven layout, with no communication."""
    _dp, c = _data(mesh)
    m = local.shape[0]
    keep = max(0, min(m, n - c * m))
    return _wrap(local[:keep], mesh, placements(mesh, ("data",)),
                 (n, *local.shape[1:]))


def first_rows(t: DTensor, n: int) -> DTensor:
    """``t[:n]`` of a ``shard_batch`` result (its padded, even layout),
    still split over ``data``, with no communication."""
    return _from_rows(t.device_mesh, t.to_local(), n)


def map_rows(fn, t: DTensor) -> DTensor:
    """``fn`` applied to each rank's rows of a batch split over ``data``
    (a function of each row alone, such as ``normalize_for_model``), as
    a DTensor of the same placements, with no communication."""
    local = fn(t.to_local())
    return _wrap(local, t.device_mesh, t.placements,
                 (t.shape[0], *local.shape[1:]))


def shard_batch(mesh: DeviceMesh, x) -> DTensor:
    """A batch (leading dimension N; numpy or a tensor, on the host or
    the mesh's device) that every rank holds -> a DTensor split over
    ``data`` and replicated over the other axes (``:49-58``).  A ragged
    N (N % data != 0) is zero-padded up to the next multiple of the data
    axis, as the reference pads it; callers that want exactly N slice
    the result (``sharded_decode_420`` does)."""
    local, npad = _rows(mesh, x)
    dev = mesh_device(mesh)
    if isinstance(local, torch.Tensor):
        local = local.to(dev)
    else:
        local = to_device(np.ascontiguousarray(local), dev)
    return _from_rows(mesh, local, npad)


def sharded_decode_420(mesh: DeviceMesh, ycoef, ucoef, vcoef, yquant, cquant,
                       order: str = "rgba", mode: str = "reference") -> DTensor:
    """The batched 4:2:0 decode sharded over the data axis
    (``:61-91``): (N, nby, nbx, 8, 8) int16 luma and (N, nby/2, nbx/2,
    8, 8) chroma coefficients (numpy, or tensors every rank holds) ->
    (N, 8 nby, 8 nbx, 4) uint8, a DTensor split over ``data``.  Quant
    tables are shared (8, 8), given to every image, or per image (N, 1,
    1, 8, 8), split with the batch.  A ragged N is zero-padded for the
    decode and sliced back.  Each rank stages and decodes its own rows
    through ``ops.jpeg_kernels.decode_batch_420_planes`` (K2 + K3 on
    CUDA, the plain versions on the CPU)."""
    from ffpic_tpu_torch.ops.jpeg_kernels import decode_batch_420_planes
    n = ycoef.shape[0]
    dev = mesh_device(mesh)

    def rows(x):
        return to_device(np.ascontiguousarray(_rows(mesh, _host(x))[0]), dev)

    def tables(q):
        return rows(q) if np.ndim(q) > 2 else to_device(
            np.ascontiguousarray(_host(q)), dev)

    out = decode_batch_420_planes(rows(ycoef), rows(ucoef), rows(vcoef),
                                  tables(yquant), tables(cquant),
                                  order=order, mode=mode)
    return _from_rows(mesh, out, n)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over a group; the adjoint sums the
    incoming gradients over the group and keeps this rank's slice (a
    reduce-scatter, as an all-reduce: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, dim, group, size, rank):
        ctx.dim, ctx.group, ctx.rank = dim, group, rank
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return g.narrow(ctx.dim, ctx.rank * n, n), None, None, None, None


class _Sum(torch.autograd.Function):
    """All-reduce (sum) over a group; its adjoint is the same."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class Axes:
    """The collectives of an SPMD program over the named axes of
    ``mesh``, each differentiable with its exact adjoint; with no mesh
    (one process) each is the identity.  A program whose every rank
    adds to the loss a share that sums to the whole (the replicas of a
    value each taking ``1 / replicas``, ``replicas``) gets from autograd
    each rank's part of the gradient: its local parameters' gradients
    are partial sums over the axes that replicate them."""

    def __init__(self, mesh: DeviceMesh | None = None):
        self.mesh = mesh

    def _axis(self, axis: str):
        """(group, extent, coordinate) of ``axis``, or None where it has
        extent 1 or there is no mesh."""
        if self.mesh is None or self.mesh[axis].size() == 1:
            return None
        return (self.mesh.get_group(axis), self.mesh[axis].size(),
                self.mesh.get_local_rank(axis))

    def size(self, axis: str) -> int:
        return 1 if self.mesh is None else self.mesh[axis].size()

    def gather(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """The whole of ``t`` along ``dim``, split over ``axis``."""
        a = self._axis(axis)
        return t if a is None else _Gather.apply(t, dim, *a)

    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t``'s partial values over ``axis``."""
        a = self._axis(axis)
        return t if a is None else _Sum.apply(t, a[0])

    def part(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim``, split over
        ``axis``."""
        a = self._axis(axis)
        if a is None:
            return t
        n = t.shape[dim] // a[1]
        return t.narrow(dim, a[2] * n, n)


def local_parts(params: dict) -> dict:
    """Each DTensor parameter's local part, for an ``Axes`` program:
    its gradient comes back as a DTensor partial over the axes that
    replicate it (each rank summed only its own share of the work)."""
    return {k: v.to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) else p for p in v.placements])
        for k, v in params.items()}


def partial_sum(t: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """Each rank's share of a value, as the DTensor of their sum."""
    return DTensor.from_local(t, mesh, [Partial()] * mesh.ndim,
                              run_check=False)
