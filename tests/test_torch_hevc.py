"""The HEVC host layer of ffpic_tpu_torch held against ffpic_tpu's on the
same inputs, exactly: Exp-Golomb codes and ``BitReader``/``BitWriter``
on random bit strings, SPS/PPS fields and slice headers of streams the
port's encoder writes (``testing.HEVC_STREAMS``), the CABAC decoder and
encoder on random bin schedules, ``predict_intra`` for all 35 modes and
sizes 4 to 32 on random neighbours, ``deblock`` and ``apply_sao`` on
random picture state (the 12 MP fixture has neither), and
``decode_picture``'s planes for every stream kind (single and
multi-slice, tiles, WPP, dependent segments, PCM, default and custom
scaling lists, transform skip, bypass, 10-bit, deblocking on) under the
default route, ``FFPIC_NO_NATIVE_RECON`` and ``FFPIC_HEVC_DEVICE`` (the
plain version of the ``hevc_residuals`` kernel on the CPU).  The
streams are 64x64, a tenth of a second each to write.
"""

import dataclasses
import random

import numpy as np
import pytest

from ffpic_tpu import native as jax_native
from ffpic_tpu.coding import cabac as jax_cabac
from ffpic_tpu.coding import cabac_enc as jax_cabac_enc
from ffpic_tpu.coding import golomb as jax_golomb
from ffpic_tpu.coding import hevc_scaling as jax_scaling
from ffpic_tpu.coding import hevc_slice as jax_slice
from ffpic_tpu.formats import hevc as jax_hevc
from ffpic_tpu.formats import hevc_recon as jax_recon
from ffpic_tpu.utils import bitstream as jax_bits
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.coding import cabac, cabac_enc, golomb, hevc_scaling
from ffpic_tpu_torch.coding import hevc_slice
from ffpic_tpu_torch.coding.hevc_enc import make_nalu
from ffpic_tpu_torch.formats import hevc, hevc_recon
from ffpic_tpu_torch.utils import bitstream
import reference_native  # noqa: F401  (readies ffpic_tpu first)

KINDS = list(testing.HEVC_STREAMS)
ROUTES = {"native": {}, "python_recon": {"FFPIC_NO_NATIVE_RECON": "1"},
          "device": {"FFPIC_HEVC_DEVICE": "1"}}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    jax_native.available()
    for k in ("FFPIC_HEVC_DEVICE", "FFPIC_NO_NATIVE_RECON",
              "FFPIC_NO_NATIVE", "FFPIC_HEIF_DEVICE_COLOR"):
        monkeypatch.delenv(k, raising=False)


def _fields(obj) -> dict:
    """A parsed object's fields, nested, arrays as lists."""
    if dataclasses.is_dataclass(obj):
        obj = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    elif hasattr(obj, "__dict__"):
        obj = dict(vars(obj))
    if isinstance(obj, dict):
        return {str(k): _fields(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_fields(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


@pytest.mark.parametrize("seed", [0, 1])
def test_golomb_and_bitstream_match_jax(seed):
    rng = random.Random(seed)
    ops = []
    for _ in range(300):
        t = rng.random()
        if t < 0.3:
            ops.append(("ue", rng.randrange(1 << rng.randrange(1, 20)),
                        rng.randrange(3)))
        elif t < 0.5:
            ops.append(("se", rng.randrange(-5000, 5000)))
        else:
            n = rng.randrange(1, 25)
            ops.append(("bits", rng.randrange(1 << n), n))

    def write(mod_bits, write_ue, write_se):
        w = mod_bits.BitWriter()
        for op in ops:
            if op[0] == "ue":
                v, k = op[1], op[2]
                write_ue(w, v >> k)
                if k:
                    w.write_bits(v & ((1 << k) - 1), k)
            elif op[0] == "se":
                write_se(w, op[1])
            else:
                w.write_bits(op[1], op[2])
        w.align_byte(0)
        return w.getvalue()

    from ffpic_tpu.coding.hevc_enc import write_se as jse, write_ue as jue
    from ffpic_tpu_torch.coding.hevc_enc import write_se, write_ue
    data = write(bitstream, write_ue, write_se)
    assert data == write(jax_bits, jue, jse)

    def read(mod_bits, mod_golomb):
        r = mod_bits.BitReader(data)
        values, where = [], []
        for i, op in enumerate(ops):
            if op[0] == "ue":
                values.append(mod_golomb.read_ue(r, op[2]))
            elif op[0] == "se":
                values.append(mod_golomb.read_se(r))
            else:
                values.append(r.read_bits(op[2]))
            where.append((r.bitpos, r.byte_aligned(), r.bits_left()))
            if i == 10:
                r.step_back(5)
                where.append((r.peek_bits(9), r.bitpos))
                r.skip_bits(5)
        return values, where
    got = read(bitstream, golomb)
    assert got == read(jax_bits, jax_golomb)
    assert got[0] == [op[1] for op in ops]


@pytest.mark.parametrize("kind", KINDS)
def test_parameter_sets_and_slice_header_match_jax(kind):
    enc, nalus = testing.hevc_stream(kind, 64, 64)
    sps_n, pps_n = make_nalu(33, enc.sps_rbsp), make_nalu(34, enc.pps_rbsp)
    sps, jsps = hevc.parse_sps(sps_n), jax_hevc.parse_sps(sps_n)
    pps, jpps = hevc.parse_pps(pps_n), jax_hevc.parse_pps(pps_n)
    assert _fields(sps) == _fields(jsps)
    assert _fields(pps) == _fields(jpps)
    assert hevc.nal_type(nalus[0]) == jax_hevc.nal_type(nalus[0])
    prev = jprev = None
    for nalu in nalus:
        assert hevc.unescape(nalu) == jax_hevc.unescape(nalu)
        rbsp = hevc.unescape(nalu)
        r, jr = bitstream.BitReader(rbsp), jax_bits.BitReader(rbsp)
        r.skip_bits(16)
        jr.skip_bits(16)
        nut = (rbsp[0] >> 1) & 0x3F
        hdr = hevc_slice.parse_slice_header(r, nut, sps, pps, prev=prev)
        jhdr = jax_slice.parse_slice_header(jr, nut, jsps, jpps, prev=jprev)
        assert _fields(hdr) == _fields(jhdr)
        if not hdr.dependent:
            prev, jprev = hdr, jhdr
    blob = b"".join(len(n).to_bytes(4, "big") + n for n in nalus)
    assert list(hevc.split_nalus_length_prefixed(blob, 4)) == \
        list(jax_hevc.split_nalus_length_prefixed(blob, 4))


@pytest.mark.parametrize("kind", ["scaling_default", "scaling_custom"])
def test_scaling_lists_match_jax(kind):
    enc, _ = testing.hevc_stream(kind, 64, 64)
    sps_n = make_nalu(33, enc.sps_rbsp)
    lists = hevc.parse_sps(sps_n).scaling_lists
    jlists = jax_hevc.parse_sps(sps_n).scaling_lists
    assert _fields(lists) == _fields(jlists)
    if True:
        a = hevc_scaling.scaling_factors(lists)
        b = jax_scaling.scaling_factors(jlists)
        assert _fields(a) == _fields(b)
        for n in (4, 8, 16, 32):
            for c in range(3):
                np.testing.assert_array_equal(
                    hevc_scaling.factor_for(a, n, c),
                    jax_scaling.factor_for(b, n, c))


@pytest.mark.parametrize("seed,qp", [(1, 0), (2, 26), (3, 51)])
def test_cabac_matches_jax(seed, qp):
    """A random schedule of context-coded, bypass, truncated-Rice and
    Exp-Golomb bins: the port's encoder writes the reference's bytes,
    and both decoders read the schedule back, context states and all."""
    ivs = (153, 200, 139, 141, 157, 154, 63, 79, 111, 141, 94, 138)
    rng = random.Random(seed)
    ops = []
    for _ in range(800):
        t = rng.random()
        if t < 0.5:
            ops.append(("d", rng.randrange(len(ivs)), rng.randrange(2)))
        elif t < 0.7:
            ops.append(("b", rng.randrange(2)))
        elif t < 0.8:
            n = rng.randrange(1, 17)
            ops.append(("bn", rng.randrange(1 << n), n))
        elif t < 0.9:
            rice = rng.randrange(4)
            cmax = rng.randrange(1, 7) << rice
            ops.append(("tr", rng.randrange(cmax + 1), cmax, rice))
        else:
            ops.append(("eg", rng.randrange(1000), rng.randrange(5)))

    def encode(cab, enc_mod):
        enc = enc_mod.CabacEncoder()
        ctx = [cab.ContextModel(iv, qp) for iv in ivs]
        for op in ops:
            if op[0] == "d":
                enc.decision(ctx[op[1]], op[2])
            elif op[0] == "b":
                enc.bypass(op[1])
            elif op[0] == "bn":
                enc.bypass_n(op[1], op[2])
            elif op[0] == "tr":
                enc.truncated_rice(op[1], op[2], op[3], bypass_prefix=True)
            else:
                enc.egk(op[1], op[2])
        enc.terminate(1)
        enc.sink.byte_align()
        return enc.sink.bytes()

    data = encode(cabac, cabac_enc)
    assert data == encode(jax_cabac, jax_cabac_enc)

    def decode(cab, bits):
        dec = cab.CabacDecoder(bits.BitReader(data))
        ctx = [cab.ContextModel(iv, qp) for iv in ivs]
        out = []
        for op in ops:
            if op[0] == "d":
                out.append(dec.decision(ctx[op[1]]))
            elif op[0] == "b":
                out.append(dec.bypass())
            elif op[0] == "bn":
                out.append(dec.bypass_n(op[2]))
            elif op[0] == "tr":
                out.append(dec.truncated_rice(op[2], op[3],
                                              bypass_prefix=True))
            else:
                out.append(dec.exp_golomb_k(op[2]))
        out.append(dec.terminate())
        return out, [(c.state, c.mps) for c in ctx]
    got = decode(cabac, bitstream)
    assert got == decode(jax_cabac, jax_bits)
    assert got[0][:-1] == [op[1] if op[0] != "d" else op[2] for op in ops]


class _SPS:
    def __init__(self, w, h, bd=8, chroma=1, strong=False, ctb_log2=5):
        self.width, self.height = w, h
        self.bit_depth_luma = bd
        self.chroma_format = chroma
        self.strong_intra_smoothing = strong
        self.ctb_log2 = ctb_log2
        self.pic_width_cropped, self.pic_height_cropped = w, h


def _random_pictures(seed, w=96, h=96, bd=8, strong=False):
    """The same random planes and availability in a port and a JAX
    Picture."""
    rng = np.random.default_rng(seed)
    pics = [mod.Picture(_SPS(w, h, bd, strong=strong))
            for mod in (hevc_recon, jax_recon)]
    for k in range(3):
        plane = rng.integers(0, 1 << bd, pics[0].planes[k].shape)
        mask = rng.random(pics[0].masks[k].shape) < 0.8
        for p in pics:
            p.planes[k][:] = plane
            p.masks[k][:] = mask
    return pics, rng


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("bd,strong", [(8, False), (10, True)])
def test_predict_intra_matches_jax(n, bd, strong):
    (pic, jpic), rng = _random_pictures(n + bd, bd=bd, strong=strong)
    for mode in range(35):
        for plane in (0, 1) if n < 32 else (0,):
            lim = pic.planes[plane].shape[0] - n
            x, y = (int(v) // n * n for v in rng.integers(0, lim + 1, 2))
            got = hevc_recon.predict_intra(pic, plane, x, y, n, mode)
            want = jax_recon.predict_intra(jpic, plane, x, y, n, mode)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"mode {mode} at {x},{y}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deblock_and_sao_match_jax(seed):
    """Random edges, QPs, bypass cells, loop-filter barriers and SAO
    parameters (band and edge offsets of every class)."""
    (pic, jpic), rng = _random_pictures(10 + seed, bd=8 + 2 * (seed == 2))
    v = rng.random(pic.v_edges.shape) < 0.5
    hz = rng.random(pic.h_edges.shape) < 0.5
    qp = rng.integers(10, 52, pic.qp_map.shape)
    byp = rng.random(pic.bypass_map.shape) < 0.05
    barriers = seed == 1
    sao = {}
    for cx in range(3):
        for cy in range(3):
            if rng.random() < 0.2:
                continue
            sao[(cx, cy)] = dict(
                type_idx=tuple(int(t) for t in rng.integers(0, 3, 3)),
                offsets=tuple(tuple(int(o) for o in rng.integers(-7, 8, 4))
                              for _ in range(3)),
                band_pos=tuple(int(b) for b in rng.integers(0, 32, 3)),
                eo_class=tuple(int(e) for e in rng.integers(0, 4, 3)))
    lfv = rng.random(pic.qp_map.shape) < 0.1
    lfh = rng.random(pic.qp_map.shape) < 0.1
    for p, mod in ((pic, hevc_recon), (jpic, jax_recon)):
        p.v_edges[:] = v
        p.h_edges[:] = hz
        p.qp_map[:] = qp
        p.bypass_map[:] = byp
        if barriers:
            p.lf_block_v, p.lf_block_h = lfv.copy(), lfh.copy()
        p.sao_params = {k: mod.SaoParam(**prm) for k, prm in sao.items()}
        mod.deblock(p, 2 - seed, seed - 1, cb_qp_off=seed - 1,
                    cr_qp_off=1 - seed)
    for a, b in zip(pic.planes, jpic.planes):
        np.testing.assert_array_equal(a, b)
    hevc_recon.apply_sao(pic)
    jax_recon.apply_sao(jpic)
    for a, b in zip(pic.planes, jpic.planes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", KINDS)
def test_decode_picture_matches_jax(kind, route, monkeypatch):
    enc, nalus = testing.hevc_stream(kind, 64, 64)
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    sps = hevc.parse_sps(make_nalu(33, enc.sps_rbsp))
    pps = hevc.parse_pps(make_nalu(34, enc.pps_rbsp))
    got = hevc.decode_picture(sps, pps, nalus, device="cpu")
    want = jax_hevc.decode_picture(enc.sps, enc.pps, nalus)
    assert len(got.planes) == len(want.planes)
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(a, b)
    if kind != "deblock" and not (route == "device"
                                  and kind.startswith("scaling")):
        for a, b in zip(got.planes, enc.pic.planes):
            np.testing.assert_array_equal(a, b)


def test_scaling_lists_under_the_device_route_mirror_jax(monkeypatch):
    """Recorded reference fault (ROADMAP Queue 3): the device residuals
    ignore the scaling lists, in both packages; the host route applies
    them.  The port gives JAX's pixels on both routes."""
    enc, nalus = testing.hevc_stream("scaling_default", 64, 64)
    host = jax_hevc.decode_picture(enc.sps, enc.pps, nalus)
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    want = jax_hevc.decode_picture(enc.sps, enc.pps, nalus)
    got = hevc.decode_picture(enc.sps, enc.pps, nalus, device="cpu")
    for a, b, c in zip(got.planes, want.planes, host.planes):
        np.testing.assert_array_equal(a, b)
    assert sum(int((b != c).sum()) for b, c in zip(want.planes,
                                                   host.planes)) > 100


def test_inter_pictures_match_jax():
    """P/B pictures of an x265 stream: with a sequence decoder's state,
    decoded as JAX decodes them; a P picture without it parsed and
    skipped with the same raise and parse statistics in both packages;
    ``split_annexb`` on the stream."""
    from ffpic_tpu_torch import make_hevc_fixtures as fx
    stream = fx.x265_encode(fx.frames(3, 64, 64), gop=8, bframes=0, qp=32,
                            extra=fx.BASE)
    assert hevc.split_annexb(stream) == jax_hevc.split_annexb(stream)
    got = hevc.SequenceDecoder("cpu").decode_annexb(stream)
    want = jax_hevc.SequenceDecoder().decode_annexb(stream)
    assert [p.poc for p in got] == [p.poc for p in want] == [0, 1, 2]
    for g, w in zip(got, want):
        for a, b in zip(g.planes, w.planes):
            np.testing.assert_array_equal(a, b)
    params, aus = fx.access_units(stream)
    raised = []
    for mod in (hevc, jax_hevc):
        sps, pps = mod.parse_sps(params[33]), mod.parse_pps(params[34])
        with pytest.raises(NotImplementedError) as e:
            mod.decode_picture(sps, pps, aus[1])
        raised.append((type(e.value).__name__, str(e.value),
                       e.value.parse_stats))
    assert raised[0] == raised[1]
    assert raised[0][0] == "InterSliceUnsupported"
    assert raised[0][2]["inter_cus"] > 0


def test_native_hevc_wrappers_refuse_bad_arguments():
    """The port's HEVC wrappers raise ValueError where the reference's
    assert or pass a bad buffer on to the C code."""
    from ffpic_tpu_torch import native
    enc, nalus = testing.hevc_stream("single", 64, 64)
    hdr, data = _native_slice(enc, nalus[0])
    params = hevc._params_for_native(enc.sps, enc.pps, hdr)
    states, mps = hevc._ctx_init_arrays(hdr.qp)
    ops, tu, lv, *_ = native.hevc_decode_slice(data, params, states, mps)
    pic = hevc_recon.Picture(enc.sps)
    need = int((tu[:, 2].astype(np.int64) ** 2).sum())
    with pytest.raises(ValueError, match="int32 plane"):
        native.hevc_recon([p.astype(np.int64) for p in pic.planes], 8, False,
                          ops, tu, lv)
    with pytest.raises(ValueError, match="int32 plane"):
        native.hevc_recon([pic.planes[0][:, ::2], *pic.planes[1:]], 8,
                          False, ops, tu, lv)
    with pytest.raises(ValueError, match=r"\(m, 8\)"):
        native.hevc_recon(pic.planes, 8, False, ops, tu[:, :7], lv)
    with pytest.raises(ValueError, match=r"\(n, 6\)"):
        native.hevc_recon(pic.planes, 8, False, ops[:, :5], tu, lv)
    with pytest.raises(ValueError, match="residuals"):
        native.hevc_recon(pic.planes, 8, False, ops, tu, lv,
                          residuals=np.zeros(need - 1, np.int16))
    with pytest.raises(ValueError, match="levels"):
        native.hevc_recon(pic.planes, 8, False, ops, tu, lv[:need - 1])
    with pytest.raises(ValueError, match="slice parameters"):
        native.hevc_decode_slice(data, params[:-1], states, mps)
    with pytest.raises(ValueError, match="chroma planes"):
        native.hevc_color([pic.planes[0], pic.planes[1][:5], pic.planes[2]],
                          8, (1.402, -0.344136, -0.714136, 1.772), False,
                          False)
    state = native.hevc_picture_state(64, 64, 5, None)
    state["zone"] = state["zone"][:-1]
    with pytest.raises(ValueError, match="picture state 'zone'"):
        native.hevc_decode_segment(data, params, [0, 0, 0, 1],
                                   [0, len(data)], state, states,
                                   np.zeros(137, np.uint8))
    # the same arguments, right, decode as the reference's wrappers do
    native.hevc_recon(pic.planes, 8, False, ops, tu, lv)
    jpic = jax_recon.Picture(enc.sps)
    _jops, jtu, jlv, *_ = jax_native.hevc_decode_slice(data, params, states,
                                                       mps)
    jax_native.hevc_recon(jpic.planes, 8, False, _jops, jtu, jlv)
    for a, b in zip(pic.planes, jpic.planes):
        np.testing.assert_array_equal(a, b)


def _native_slice(enc, nalu):
    rbsp = hevc.unescape(nalu)
    r = bitstream.BitReader(rbsp)
    r.skip_bits(16)
    hdr = hevc_slice.parse_slice_header(r, (rbsp[0] >> 1) & 0x3F, enc.sps,
                                        enc.pps)
    return hdr, rbsp[hdr.data_bit_offset // 8:]
