"""Exp-Golomb codes (H.26x) — parity with coding/golomb.c:13-46
including kth-order support.

Copied from ``ffpic_tpu/coding/golomb.py`` for the PyTorch port, with
its imports rewritten to the port's modules.
"""

from __future__ import annotations

from ffpic_tpu_torch.utils.bitstream import BitReader


def read_ue(r: BitReader, k: int = 0) -> int:
    """ue(v): unsigned exp-golomb, k-th order."""
    leading = 0
    while r.read_bit() == 0:
        leading += 1
        if leading > 31:
            raise ValueError("invalid exp-golomb code")
    value = (1 << leading) - 1 + (r.read_bits(leading) if leading else 0)
    if k:
        value = (value << k) + r.read_bits(k)
    return value


def read_se(r: BitReader) -> int:
    """se(v): signed exp-golomb (ITU-T H.265 9.2)."""
    v = read_ue(r)
    return (v + 1) >> 1 if (v & 1) else -(v >> 1)
