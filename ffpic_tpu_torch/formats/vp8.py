"""VP8 key-frame decoder (RFC 6386) of the port: the lossy-WebP pixel
path.

Copied from ``ffpic_tpu/formats/vp8.py`` (``FrameHeader``,
``VP8Decoder``) with its native routes: the frame tag and control
partition on the Python boolean decoder, then ``native/host_vp8.c`` for
the coefficient probabilities, the macroblock headers, the token
partitions (raw levels ``(mbh, mbw, 25, 16)``), the residual transform
and intra reconstruction, and the loop filter (``formats.vp8_filter``).
Changes:

* ``VP8Decoder`` takes ``device``, where the ``FFPIC_VP8_DEVICE``
  route runs: None means CUDA and raises without it, "cpu" runs the
  plain version.  That route stages the levels, the per-macroblock
  dequant factors and ``has_y2``, runs ``ops.vp8_kernels.vp8_residuals``
  (dequant, Y2 IWHT, DC scatter, 4x4 IDCT over the whole frame: the
  ``vp8_residuals`` CUDA kernel, or its plain version on the CPU) and
  copies the int16 residuals back for ``native.vp8_recon``.  By default
  the residual transform and reconstruction run fused on the host
  (``native.vp8_recon_fused``), as in the original.
* The original's ``FFPIC_NO_NATIVE`` fallbacks (Python token, header,
  probability, residual and reconstruction paths) are left out: the
  port's native build raises on failure, so nothing would run them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ffpic_tpu_torch import native
from ffpic_tpu_torch.coding.booldec import BoolDecoder
from ffpic_tpu_torch.formats import vp8_tables as T
from ffpic_tpu_torch.formats.vp8_filter import loop_filter_frame
from ffpic_tpu_torch.utils import trace
from ffpic_tpu_torch.utils.device import resolve_device, to_device
from ffpic_tpu_torch.utils.vlog import get_logger

log = get_logger("vp8")

DC, V_PRED, H_PRED, TM, B_PRED = 0, 1, 2, 3, 4


@dataclass
class FrameHeader:
    width: int = 0
    height: int = 0
    xscale: int = 0
    yscale: int = 0
    version: int = 0
    seg_enabled: bool = False
    seg_update_map: bool = False
    seg_abs: bool = False
    seg_quant: list = field(default_factory=lambda: [0, 0, 0, 0])
    seg_lf: list = field(default_factory=lambda: [0, 0, 0, 0])
    seg_tree_probs: list = field(default_factory=lambda: [255, 255, 255])
    filter_type: int = 0
    filter_level: int = 0
    sharpness: int = 0
    lf_delta_enabled: bool = False
    ref_lf_deltas: list = field(default_factory=lambda: [0, 0, 0, 0])
    mode_lf_deltas: list = field(default_factory=lambda: [0, 0, 0, 0])
    n_partitions: int = 1
    q_yac: int = 0
    q_ydc_delta: int = 0
    q_y2dc_delta: int = 0
    q_y2ac_delta: int = 0
    q_uvdc_delta: int = 0
    q_uvac_delta: int = 0
    mb_no_skip: bool = False
    prob_skip: int = 0


class VP8Decoder:
    def __init__(self, data: bytes, device=None):
        self.data = data
        self.device = device
        self._parse_frame_tag()

    # ------------------------------------------------------------------
    def _parse_frame_tag(self):
        d = self.data
        tag = d[0] | (d[1] << 8) | (d[2] << 16)
        self.keyframe = not (tag & 1)
        self.version = (tag >> 1) & 7
        self.show = (tag >> 4) & 1
        first_size = tag >> 5
        if not self.keyframe:
            raise ValueError("only key frames occur in WebP stills")
        if d[3:6] != b"\x9d\x01\x2a":
            raise ValueError("bad VP8 start code")
        if 10 + first_size > len(d):
            raise ValueError("truncated VP8: first partition size "
                             f"{first_size} exceeds available data")
        w = d[6] | (d[7] << 8)
        h = d[8] | (d[9] << 8)
        self.hdr = FrameHeader(width=w & 0x3FFF, height=h & 0x3FFF,
                               xscale=w >> 14, yscale=h >> 14,
                               version=self.version)
        self.part0 = d[10:10 + first_size]
        self.rest = d[10 + first_size:]

    # ------------------------------------------------------------------
    def _parse_control_partition(self):
        h = self.hdr
        br = BoolDecoder(self.part0)
        self.color_space = br.get_bit()
        self.clamp_type = br.get_bit()

        h.seg_enabled = bool(br.get_bit())
        if h.seg_enabled:
            h.seg_update_map = bool(br.get_bit())
            update_data = br.get_bit()
            if update_data:
                h.seg_abs = bool(br.get_bit())
                for i in range(4):
                    h.seg_quant[i] = br.maybe_get_signed(7)
                for i in range(4):
                    h.seg_lf[i] = br.maybe_get_signed(6)
            if h.seg_update_map:
                for i in range(3):
                    h.seg_tree_probs[i] = (br.get_literal(8)
                                           if br.get_bit() else 255)

        h.filter_type = br.get_bit()
        h.filter_level = br.get_literal(6)
        h.sharpness = br.get_literal(3)
        h.lf_delta_enabled = bool(br.get_bit())
        if h.lf_delta_enabled:
            if br.get_bit():  # mode_ref_lf_delta_update
                for i in range(4):
                    if br.get_bit():
                        h.ref_lf_deltas[i] = br.get_signed(6)
                for i in range(4):
                    if br.get_bit():
                        h.mode_lf_deltas[i] = br.get_signed(6)

        h.n_partitions = 1 << br.get_literal(2)

        h.q_yac = br.get_literal(7)
        h.q_ydc_delta = br.maybe_get_signed(4)
        h.q_y2dc_delta = br.maybe_get_signed(4)
        h.q_y2ac_delta = br.maybe_get_signed(4)
        h.q_uvdc_delta = br.maybe_get_signed(4)
        h.q_uvac_delta = br.maybe_get_signed(4)

        br.get_bit()  # refresh_entropy_probs (ignored for stills)

        self.coeff_probs = np.ascontiguousarray(
            T.DEFAULT_COEFF_PROBS.copy(), np.uint8)
        native.vp8_coeff_probs(bytes(br.data), br,
                               np.ascontiguousarray(T.COEFF_UPDATE_PROBS,
                                                    np.uint8),
                               self.coeff_probs)

        h.mb_no_skip = bool(br.get_bit())
        if h.mb_no_skip:
            h.prob_skip = br.get_literal(8)
        self.br0 = br

    # ------------------------------------------------------------------
    def _dequant_tables(self):
        """Per-segment dequant factors (RFC 6386 9.6/14.1; libwebp's
        uv_dc index clamp to 117)."""
        h = self.hdr
        dcq, acq = T.DC_QLOOKUP, T.AC_QLOOKUP

        def clip_q(x, m=127):
            return min(max(x, 0), m)

        self.dq = []
        for s in range(4):
            if h.seg_enabled:
                base = (h.seg_quant[s] if h.seg_abs
                        else h.q_yac + h.seg_quant[s])
            else:
                base = h.q_yac
            q = clip_q(base)
            y1dc = dcq[clip_q(q + h.q_ydc_delta)]
            y1ac = acq[q]
            y2dc = dcq[clip_q(q + h.q_y2dc_delta)] * 2
            y2ac = acq[clip_q(q + h.q_y2ac_delta)] * 155 // 100
            y2ac = max(y2ac, 8)
            uvdc = dcq[clip_q(q + h.q_uvdc_delta, 117)]
            uvac = acq[clip_q(q + h.q_uvac_delta)]
            self.dq.append((y1dc, y1ac, y2dc, y2ac, uvdc, uvac))

    # ------------------------------------------------------------------
    def _parse_mb_headers(self):
        h = self.hdr
        br = self.br0
        mbw = (h.width + 15) // 16
        mbh = (h.height + 15) // 16
        self.mbw, self.mbh = mbw, mbh
        state = (br.pos, br.value, br.range, br.bit_count)
        (self.seg, self.skip, self.ymode, self.uvmode,
         self.bmodes) = native.vp8_mb_headers(
            bytes(br.data), state, mbh, mbw,
            h.seg_enabled and h.seg_update_map,
            np.asarray(h.seg_tree_probs, np.uint8),
            h.mb_no_skip, h.prob_skip,
            np.asarray(T.KF_BMODE_PROBS, np.uint8))

    # ------------------------------------------------------------------
    def _parse_tokens(self):
        """Decode coefficient levels for every MB into
        (mbh, mbw, 25, 16) int32: blocks 0-15 Y (raster), 16-19 U,
        20-23 V, 24 Y2. Levels are raw (pre-dequant), zigzag order
        undone (natural 4x4 raster)."""
        h = self.hdr
        nparts = h.n_partitions
        # (nparts-1) 3-byte little-endian sizes precede the partitions;
        # the last partition runs to the end of the stream (RFC 9.5)
        sizes = []
        pos = 0
        for i in range(nparts - 1):
            sizes.append(self.rest[pos] | (self.rest[pos + 1] << 8) |
                         (self.rest[pos + 2] << 16))
            pos += 3
        offs, lens = [], []
        p = pos
        for i in range(nparts):
            end = p + sizes[i] if i < nparts - 1 else len(self.rest)
            if end > len(self.rest) or p > len(self.rest):
                raise ValueError("truncated VP8: token partition "
                                 f"{i} claims bytes past end of data")
            offs.append(p)
            lens.append(end - p)
            p = end

        self.has_y2 = (self.ymode != B_PRED)
        self.levels, self.nnz_total = native.vp8_tokens(
            self.rest, offs, lens, self.coeff_probs,
            self.skip.astype(np.uint8), self.has_y2.astype(np.uint8),
            self.mbh, self.mbw)
        self.mb_has_coeffs = self.nnz_total.sum(axis=2) > 0

    # ------------------------------------------------------------------
    def _residuals(self):
        """Whole-image dequant -> Y2 IWHT -> DC scatter -> 4x4 IDCT
        (prediction-independent).  ``FFPIC_VP8_DEVICE=1`` runs it on
        ``device`` as one launch (``ops.vp8_kernels.vp8_residuals``);
        otherwise the native host transform."""
        mbh, mbw = self.mbh, self.mbw
        if os.environ.get("FFPIC_VP8_DEVICE"):
            from ffpic_tpu_torch.ops import vp8_kernels as vk
            dev = resolve_device(self.device, "VP8Decoder")
            seg = (self.seg if self.hdr.seg_enabled
                   else np.zeros((mbh, mbw), np.int32))
            dq_mb = np.array(self.dq, np.int32)[seg]
            with trace.stage("webp.vp8_residuals"):
                res = vk.vp8_residuals(to_device(self.levels, dev),
                                       to_device(dq_mb, dev),
                                       to_device(self.has_y2, dev))
                self.residual = res.cpu().numpy()
            return
        self.residual = native.vp8_residuals(
            self.levels, self.nnz_total, np.array(self.dq, np.int32),
            self.seg if self.hdr.seg_enabled else None,
            self.has_y2.astype(np.uint8), mbh, mbw)

    # ------------------------------------------------------------------
    def _reconstruct(self):
        """Serial intra prediction + residual add (host wavefront)."""
        mbh, mbw = self.mbh, self.mbw
        Y = np.zeros((mbh * 16, mbw * 16), np.uint8)
        U = np.zeros((mbh * 8, mbw * 8), np.uint8)
        Vp = np.zeros((mbh * 8, mbw * 8), np.uint8)
        native.vp8_recon(Y, U, Vp, self.residual, self.ymode, self.bmodes,
                         self.uvmode, mbh, mbw)
        self.Y, self.U, self.V = Y, U, Vp

    # ------------------------------------------------------------------
    def decode(self):
        """The MB-padded Y, U and V planes, loop-filtered."""
        self._parse_control_partition()
        self._dequant_tables()
        self._parse_mb_headers()
        self._parse_tokens()
        if os.environ.get("FFPIC_VP8_DEVICE"):
            self._residuals()
            self._reconstruct()
        else:
            # single MB walk: dequant+IWHT+IDCT into a stack buffer,
            # then prediction + residual add (no whole-image residual
            # intermediate)
            mbh, mbw = self.mbh, self.mbw
            Y = np.zeros((mbh * 16, mbw * 16), np.uint8)
            U = np.zeros((mbh * 8, mbw * 8), np.uint8)
            Vp = np.zeros((mbh * 8, mbw * 8), np.uint8)
            native.vp8_recon_fused(
                Y, U, Vp, self.levels, self.nnz_total,
                np.array(self.dq, np.int32),
                self.seg if self.hdr.seg_enabled else None,
                self.has_y2.astype(np.uint8),
                self.ymode, self.bmodes, self.uvmode, mbh, mbw)
            self.Y, self.U, self.V = Y, U, Vp
        loop_filter_frame(self)
        return self.Y, self.U, self.V
