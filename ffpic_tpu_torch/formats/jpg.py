"""JPEG geometry for the packed host emission.

Marker parsing and Huffman decoding are host code without a framework
and are used as they are from ``ffpic_tpu.formats.jpg``
(``parse_and_decode``, ``JpegFile``, ``PackedIneligible``).  Only the
block map is here: ``ffpic_tpu.formats.jpg.packed_block_map`` builds it
through a module that imports jax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def mcu_block_map(samplings, mcus_x: int, mcus_y: int,
                  actual=None) -> np.ndarray:
    """The g-th block in MCU decode order (components in frame order,
    v*h blocks raster within the MCU) -> flat index into the
    concatenated per-component coefficient space, as int32.

    Single-component scans are non-interleaved (ITU-T81 A.2.2): pass
    ``actual=(nby_actual, nbx_actual)`` and the map is a raster walk of
    the actual block grid with the padded plane stride."""
    if len(samplings) == 1 and actual is not None:
        _v, h = samplings[0]
        nbya, nbxa = actual
        by, bx = np.mgrid[0:nbya, 0:nbxa]
        g = (by * (mcus_x * h) + bx).reshape(-1)
    else:
        maps = []
        base = 0
        my, mx = np.mgrid[0:mcus_y, 0:mcus_x]
        for (v, h) in samplings:
            nbx = mcus_x * h
            vi, hi = np.mgrid[0:v, 0:h]
            by = my[:, :, None, None] * v + vi[None, None]
            bx = mx[:, :, None, None] * h + hi[None, None]
            maps.append((base + by * nbx + bx).reshape(mcus_y, mcus_x, v * h))
            base += mcus_y * v * nbx
        # interleave per MCU: component-major within each MCU
        g = np.concatenate(maps, axis=2).reshape(-1)
    return g.astype(np.int32)


@functools.lru_cache(maxsize=32)
def _block_map_tensor(samplings, mcus_x, mcus_y, actual, device):
    return torch.from_numpy(
        mcu_block_map(samplings, mcus_x, mcus_y, actual)).to(device)


def packed_block_map(j, device) -> torch.Tensor:
    """int32 block map for ``j.packed`` on ``device``, made once per
    geometry and device; single-component files use the
    non-interleaved raster layout the packed scan emits."""
    samps = tuple((c.v, c.h) for c in j.comps)
    actual = None
    if len(j.comps) == 1:
        actual = (j.comps[0].nby_actual, j.comps[0].nbx_actual)
    return _block_map_tensor(samps, j.mcus_x, j.mcus_y, actual,
                             torch.device(device))
