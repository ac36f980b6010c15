"""AV1 multi-symbol arithmetic decoder (msac) + adaptive CDF state.

Spec 8.2 "Symbol decoding process" implemented in the inverted-CDF
formulation the default tables are stored in (stored[i] = 32768 -
cum_prob(<=i), descending).  The reference decoder (junka/ffpic) has
no AV1 support at all (format/avif.c:382-405 is a frame stub); this
module is validated end-to-end against dav1d via byte-exact plane
comparisons (tests/test_av1.py).

Design: pure-Python oracle, per-symbol loop, exactness first -- the
native C port mirrors it 1:1 (native/host_av1.c) the same way the
HEVC CABAC oracle/production split works in this repo.

Copied from ``ffpic_tpu/coding/av1_msac.py`` for the PyTorch port whole,
with its imports rewritten to the port's modules.
"""

from __future__ import annotations

from ffpic_tpu_torch.coding.av1_cdf_tables import TABLES

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4


class Msac:
    """Arithmetic decoder over one tile's bitstream."""

    __slots__ = ("data", "pos", "end", "dif", "rng", "cnt",
                 "allow_update", "bitpos")

    def __init__(self, data: bytes, allow_update: bool = True):
        self.data = data
        self.pos = 0
        self.end = len(data)
        self.allow_update = allow_update
        # init_symbol: 15 bits into the window, ones-complemented
        buf = 0
        nbits = 0
        while nbits < 15:
            byte = data[self.pos] if self.pos < self.end else 0
            buf = (buf << 8) | byte
            self.pos += 1
            nbits += 8
        buf >>= (nbits - 15)
        self.dif = ((1 << 15) - 1) ^ buf
        self.rng = 1 << 15
        # bits still available to read (may go negative: spec pads)
        self.cnt = 8 * len(data) - 15
        # sub-byte phase: we consumed 15 of the first 16 bits
        self._rewind_bit()

    def _rewind_bit(self):
        # consumed 16 bits above but only 15 belong to the window;
        # track a bit-level cursor instead of byte cursor
        self.bitpos = 15

    def _read_bits(self, n: int) -> int:
        """f(n): MSB-first bit read past the 15-bit init point,
        zero-padded past the end of the buffer."""
        v = 0
        bp = self.bitpos
        data = self.data
        end8 = self.end * 8
        for _ in range(n):
            if bp < end8:
                bit = (data[bp >> 3] >> (7 - (bp & 7))) & 1
            else:
                bit = 0
            v = (v << 1) | bit
            bp += 1
        self.bitpos = bp
        return v

    def _renorm(self, dif: int, rng: int):
        # bring rng back into [2^15, 2^16)
        bits = 15 - (rng.bit_length() - 1)
        if bits > 0:
            rng <<= bits
            avail = self.cnt
            nb = bits if bits < avail else (avail if avail > 0 else 0)
            new = self._read_bits(nb) if nb else 0
            padded = new << (bits - nb)
            dif = padded ^ (((dif + 1) << bits) - 1)
            self.cnt = avail - bits
        self.dif = dif
        self.rng = rng

    def decode_symbol(self, cdf) -> int:
        """cdf: mutable sequence, n-1 descending inverted probs then a
        zero slot then the adaptation counter (list layout [p0..pn-2,
        0, count])."""
        n = len(cdf) - 1  # number of symbols (last slot = counter)
        rng = self.rng
        dif = self.dif
        r8 = rng >> 8
        cur = rng
        sym = -1
        while True:
            sym += 1
            prev = cur
            if sym < n - 1:
                f = int(cdf[sym])   # plain int: rows may be numpy
                cur = ((r8 * (f >> EC_PROB_SHIFT)) >> 1) + \
                    EC_MIN_PROB * (n - 1 - sym)
            else:
                cur = 0
            if dif >= cur:
                break
        rng = prev - cur
        dif -= cur
        self._renorm(dif, rng)
        if self.allow_update:
            count = cdf[n]
            rate = 3 + (count > 15) + (count > 31) + \
                (1 if n < 4 else 2)
            for i in range(n - 1):
                if i < sym:
                    cdf[i] += (32768 - cdf[i]) >> rate
                else:
                    cdf[i] -= cdf[i] >> rate
            cdf[n] = count + (count < 32)
        return sym

    def decode_bool(self, f: int) -> int:
        """Non-adapting boolean with 15-bit probability f of ZERO
        (inverted-cdf single entry). Returns 0/1."""
        rng = self.rng
        dif = self.dif
        cur = (((rng >> 8) * (f >> EC_PROB_SHIFT)) >> 1) + EC_MIN_PROB
        if dif >= cur:
            bit = 0
            self._renorm(dif - cur, rng - cur)
        else:
            bit = 1
            self._renorm(dif, cur)
        return bit

    def decode_bool_adapt(self, cdf) -> int:
        """Adapting 2-symbol decode; returns 0/1 (cdf layout
        [p, 0, count])."""
        return self.decode_symbol(cdf)

    def decode_literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bool(1 << 14)
        return v

    def decode_subexp(self, num_syms: int, k: int = 3) -> int:
        """read_subexp / decode_subexp_bool (spec 9.2.x) over literal
        bits, used for loop-restoration etc. (not golomb)."""
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if num_syms <= mk + 3 * a:
                return self.decode_ns(num_syms - mk) + mk
            if self.decode_bool(1 << 14):
                i += 1
                mk += a
            else:
                return self.decode_literal(b2) + mk

    def decode_ns(self, n: int) -> int:
        """Non-symmetric literal ns(n) (spec 4.10.7) via bool-equi
        bits."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.decode_literal(w - 1) if w > 1 else 0
        if v < m:
            return v
        extra = self.decode_bool(1 << 14)
        return (v << 1) - m + extra

    def decode_golomb(self) -> int:
        """Exp-Golomb suffix for coefficient level tails
        (read_golomb, spec coeffs syntax)."""
        length = 0
        while not self.decode_bool(1 << 14):
            length += 1
            if length > 62:
                break
        x = 1
        for _ in range(length):
            x = (x << 1) | self.decode_bool(1 << 14)
        return x - 1


class CdfContext:
    """Per-tile adaptive CDF state: mutable list copies of the default
    tables, laid out [p0..pn-2, 0, counter]."""

    # Coefficient-decode families live in contiguous int32 numpy
    # arenas instead of nested lists: the stored default width is
    # already [p0..p_{n-2}, 0(zero slot), 0(counter)], so the arrays
    # are decode-ready as-is.  Python's decode_symbol works on the
    # rows unchanged (len/index/in-place add), and the native hot
    # path (native/host_av1.c) adapts the SAME memory so Python and C
    # symbols interleave within a tile.
    _NUMPY_FAMILIES = ("txb_skip", "eob_pt_16", "eob_pt_32",
                       "eob_pt_64", "eob_pt_128", "eob_pt_256",
                       "eob_pt_512", "eob_pt_1024", "eob_extra",
                       "coeff_base_eob", "coeff_base", "coeff_br",
                       "dc_sign")

    def __init__(self, qctx: int):
        import numpy as np
        self.qctx = qctx
        t = TABLES
        self.tables = {}
        for name, arr in t.items():
            if name.startswith("q_"):
                continue
            a = arr
            if name.startswith(("txb_skip", "eob_", "coeff_",
                                "dc_sign")):
                a = arr[qctx]
            if name in self._NUMPY_FAMILIES:
                self.tables[name] = np.ascontiguousarray(
                    a.astype(np.int32))
            else:
                self.tables[name] = _to_lists(a)
        # intra_ext_tx for the native path: fixed-width (2,4,13,8)
        # arena where set2 rows have nsyms=5 (explicit n passed to C;
        # the list copy above keeps serving the Python oracle, each
        # path adapting its own copy)
        self.intra_ext_tx_np = np.ascontiguousarray(
            TABLES["intra_ext_tx"].astype(np.int32))
        # mode-info families for native/host_av1.c:av1_block_mode —
        # same dual-copy scheme; widths pad to n_max+1 so the counter
        # slot exists (n is passed explicitly in C)
        widths = {"skip": 3, "spatial_seg": 9, "kf_y_mode": 14,
                  "angle_delta": 8, "uv_mode": 15, "cfl_sign": 9,
                  "cfl_alpha": 17, "palette_y_mode": 3,
                  "palette_uv_mode": 3, "use_filter_intra": 3,
                  "filter_intra_mode": 6, "intrabc": 3,
                  "delta_q": 5, "tx_depth": 4, "partition": 12,
                  "palette_y_size": 8, "palette_uv_size": 8,
                  "palette_y_color": 9, "palette_uv_color": 9}
        self.mode_np = {}
        for name, wdt in widths.items():
            a = TABLES[name].astype(np.int32)
            if a.shape[-1] < wdt:
                pad = [(0, 0)] * (a.ndim - 1) +                     [(0, wdt - a.shape[-1])]
                a = np.pad(a, pad)
            self.mode_np[name] = np.ascontiguousarray(a)
        # NMV contexts (inter mv + intrabc dmv): carried here so the
        # adapted state participates in frame-end CDF save /
        # primary-ref load for frame sequences
        from ffpic_tpu_torch.coding.av1_mv import MvCdfs
        self.mv = MvCdfs(self.tables)
        self.dmv = MvCdfs(self.tables)

    def __getitem__(self, name):
        return self.tables[name]

    def _clone(self) -> "CdfContext":
        """Fresh mutable copy of this context (adaptive CDFs mutate
        in place during decode, so every tile needs its own)."""
        import numpy as np
        c = CdfContext.__new__(CdfContext)
        c.qctx = self.qctx
        c.tables = {k: (v.copy() if isinstance(v, np.ndarray)
                        else _copy_nested(v))
                    for k, v in self.tables.items()}
        c.intra_ext_tx_np = self.intra_ext_tx_np.copy()
        c.mode_np = {k: v.copy() for k, v in self.mode_np.items()}
        c.mv = self.mv.clone()
        c.dmv = self.dmv.clone()
        dls = getattr(self, "delta_lf_single", None)
        c.delta_lf_single = [list(x) for x in dls] if dls else None
        dlm = getattr(self, "delta_lf_multi", None)
        c.delta_lf_multi = [list(x) for x in dlm] if dlm else None
        return c

    def reset_counters(self) -> None:
        """Zero every family's adaptation counter — the spec's saved
        CDFs carry probabilities only (the per-row count slot is the
        last element in both the list and arena layouts used here)."""
        import numpy as np

        def walk(node):
            if isinstance(node, np.ndarray):
                node[..., -1] = 0
                return
            if node and isinstance(node[0], list):
                for sub in node:
                    walk(sub)
            elif node:
                node[-1] = 0

        for v in self.tables.values():
            walk(v)
        self.mv.reset_counters()
        self.dmv.reset_counters()
        for rows in (getattr(self, "delta_lf_single", None),
                     getattr(self, "delta_lf_multi", None)):
            if rows:
                for rw in rows:
                    rw[-1] = 0


_CDF_TEMPLATES: dict[int, CdfContext] = {}


def fresh_cdf(qctx: int) -> CdfContext:
    """Per-tile CDF context from a memoized per-qctx template:
    building the default tables costs ~12 ms/frame (int() per slot
    over 3789 tables) while cloning is pure list/array copies.  The
    template is immutable after construction (only cloned), so the
    cache is safe to share across pipeline worker threads."""
    tpl = _CDF_TEMPLATES.get(qctx)
    if tpl is None:
        tpl = _CDF_TEMPLATES[qctx] = CdfContext(qctx)
    return tpl._clone()


def _copy_nested(o):
    if not o or not isinstance(o[0], list):
        return list(o)
    return [_copy_nested(s) for s in o]


def _to_lists(arr):
    """uint16 ndarray (..., slots) -> nested lists with a trailing
    counter slot appended; trailing stored zeros beyond nsyms-1 are
    kept (they are the zero slot + padding, harmless: decode stops at
    the first slot where cur hits the min-prob floor)."""
    if arr.ndim == 1:
        probs = [int(x) for x in arr]
        # strip trailing zeros to recover nsyms-1, keep one zero slot
        while probs and probs[-1] == 0:
            probs.pop()
        return probs + [0, 0]
    return [_to_lists(sub) for sub in arr]
