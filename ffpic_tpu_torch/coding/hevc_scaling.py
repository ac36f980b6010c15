"""HEVC scaling lists (7.3.4 / 7.4.5 / 8.6.3).

The reference parses scaling_list_data and applies per-coefficient
scaling factors in its dequant (hevc.c:171-297, 3743-3999); this
module is the spec-exact equivalent: parse (or default) the lists,
derive the ScalingFactor arrays, and hand (n, n) matrices to the
dequant path (coding/hevc_consts.dequant already takes `scaling`).

Copied from ``ffpic_tpu/coding/hevc_scaling.py`` for the PyTorch port,
with its imports rewritten to the port's modules.
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch.coding.golomb import read_se, read_ue

# Table 7-5: default for sizeId 0 (all 16); Table 7-6: 8x8 defaults
_DEF_INTRA_8 = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], np.int32).reshape(8, 8)
_DEF_INTER_8 = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], np.int32).reshape(8, 8)

# NOTE: Table 7-6 lists are specified in raster order of the 8x8
# matrix (the values above are the standard raster layout).


def _diag_scan_order(n: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan (6.5.3) as (x, y) pairs."""
    out = []
    x = y = 0
    while len(out) < n * n:
        while y >= 0:
            if x < n and y < n:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return out


def default_list(size_id: int, matrix_id: int) -> tuple[np.ndarray, int]:
    """(coef list in diagonal-scan order, dc) per Table 7-5/7-6."""
    if size_id == 0:
        return np.full(16, 16, np.int32), 16
    base = _DEF_INTRA_8 if (matrix_id < 3 if size_id < 3
                            else matrix_id == 0) else _DEF_INTER_8
    scan = _diag_scan_order(8)
    lst = np.array([base[y, x] for (x, y) in scan], np.int32)
    return lst, 16


def matrix_ids(size_id: int) -> tuple:
    """7.3.4 loop: matrixId += (sizeId == 3) ? 3 : 1 — the two 32x32
    matrices are numbered 0 (intra) and 3 (inter)."""
    return (0, 3) if size_id == 3 else (0, 1, 2, 3, 4, 5)


def parse_scaling_list_data(r) -> dict:
    """7.3.4: returns {(size_id, matrix_id): (coef_list, dc)} with
    copy/default prediction resolved."""
    lists: dict = {}
    for size_id in range(4):
        for matrix_id in matrix_ids(size_id):
            pred_mode = r.read_bit()
            if not pred_mode:
                delta = read_ue(r)
                if delta == 0:
                    lists[(size_id, matrix_id)] = default_list(
                        size_id, matrix_id)
                else:
                    step = 3 if size_id == 3 else 1
                    ref = matrix_id - delta * step
                    lists[(size_id, matrix_id)] = (
                        lists[(size_id, ref)] if ref >= 0
                        else default_list(size_id, matrix_id))
            else:
                coefs = min(64, 1 << (4 + (size_id << 1)))
                dc = 16
                nxt = 8
                if size_id > 1:
                    dc = read_se(r) + 8
                    nxt = dc            # 7.3.4: nextCoef starts at DC
                vals = np.empty(coefs, np.int32)
                for i in range(coefs):
                    nxt = (nxt + read_se(r) + 256) % 256
                    vals[i] = nxt
                lists[(size_id, matrix_id)] = (vals, dc)
    return lists


def write_scaling_list_data(w, lists: dict | None = None) -> None:
    """Encoder side of 7.3.4.  lists=None writes all-default
    (pred_mode 0, delta 0); otherwise explicit lists for the given
    (size_id, matrix_id) keys and defaults elsewhere."""
    from ffpic_tpu_torch.coding.hevc_enc import write_se as wse, \
        write_ue as wue
    for size_id in range(4):
        for matrix_id in matrix_ids(size_id):
            ent = (lists or {}).get((size_id, matrix_id))
            if ent is None:
                w.write_bit(0)           # pred_mode: copy
                wue(w, 0)                # delta 0 -> default
                continue
            vals, dc = ent
            w.write_bit(1)               # explicit
            prev = 8
            if size_id > 1:
                wse(w, int(dc) - 8)
                prev = int(dc)           # 7.3.4: nextCoef starts at DC
            for v in np.asarray(vals).ravel():
                d = (int(v) - prev + 256) % 256
                if d > 127:
                    d -= 256
                wse(w, d)
                prev = int(v)
    return None


def scaling_factors(lists: dict | None) -> dict:
    """Derive ScalingFactor matrices (7.4.5): {(size_id, matrix_id):
    (n, n) int32 [y][x]}.  lists=None -> defaults for everything."""
    out = {}
    for size_id, n in ((0, 4), (1, 8), (2, 16), (3, 32)):
        base = 8 if size_id else 4
        scan = _diag_scan_order(base)
        for matrix_id in matrix_ids(size_id):
            if lists is not None and (size_id, matrix_id) in lists:
                vals, dc = lists[(size_id, matrix_id)]
            else:
                vals, dc = default_list(size_id, matrix_id)
            m8 = np.zeros((base, base), np.int32)
            for i, (x, y) in enumerate(scan):
                m8[y, x] = vals[i]
            if size_id <= 1:
                sf = m8
            else:
                rep = n // 8
                sf = np.repeat(np.repeat(m8, rep, 0), rep, 1)
                sf = sf.copy()
                sf[0, 0] = dc
            out[(size_id, matrix_id)] = sf
    return out


def factor_for(sf: dict, n: int, c_idx: int, intra: bool = True):
    """Pick the ScalingFactor matrix for an (n x n, component) TB."""
    size_id = n.bit_length() - 3   # 4->0, 8->1, 16->2, 32->3
    if size_id == 3:
        matrix_id = 0 if intra else 3
    else:
        matrix_id = c_idx + (0 if intra else 3)
    return sf[(size_id, matrix_id)]
