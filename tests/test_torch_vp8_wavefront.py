"""B12, VP8 luma intra reconstruction: ffpic_tpu_torch.ops.vp8_wavefront
(CPU, the plain version ``vp8_wavefront_plain``, K18's function) held
against ffpic_tpu.ops.vp8_wavefront's ``make_wavefront`` and against the
port's host reconstruction ``native.vp8_recon`` on the same inputs.

Inputs: the committed WebP fixtures' VP8 frames, decoded up to their
residuals by the port's ``VP8Decoder`` (``testing.wavefront_inputs``),
and ``testing.wavefront_cases``' random grids (every ymode and B-mode,
residuals in +-300).  Everything is integer: the tolerance is zero.

JAX compiles ``make_wavefront`` for 15-20 s a geometry on the CPU, so
three geometries are compiled here, each by one test.  The CUDA kernel
K18 runs only on a GPU (``chip_smoke.py``'s ``[check K18]``); here its
wrapper is checked to refuse CPU tensors, other dtypes and shapes, and
the entry to take the plain version for CPU tensors.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ffpic_tpu.ops.vp8_wavefront import make_wavefront as jax_make_wavefront
from ffpic_tpu_torch import native, testing
from ffpic_tpu_torch.ops import cuda_vp8
from ffpic_tpu_torch.ops import vp8_wavefront as wf
import reference_native  # noqa: F401  (readies ffpic_tpu first)

FRAMES = [(name, k) for name in testing.WAVEFRONT_FIXTURES
          for k in range(len(testing.vp8_bitstreams(
              testing.webp_fixture(name))))]


def _plain(res, ymode, bmodes) -> np.ndarray:
    return wf.vp8_wavefront_plain(torch.from_numpy(res),
                                  torch.from_numpy(ymode),
                                  torch.from_numpy(bmodes)).numpy()


def _jax(res, ymode, bmodes) -> np.ndarray:
    run = jax_make_wavefront(*ymode.shape)
    return np.asarray(run(res, ymode, bmodes))


@pytest.mark.parametrize("name", ["lossy_512.webp", "odd_333x199.webp"])
def test_plain_matches_jax_on_fixtures(name):
    inp = testing.wavefront_inputs(name)
    want = _jax(inp["residual"], inp["ymode"], inp["bmodes"])
    got = _plain(inp["residual"], inp["ymode"], inp["bmodes"])
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_plain_matches_jax_on_a_random_grid():
    res, ymode, bmodes = testing.wavefront_cases()["mb3x4_bpred"]
    assert np.array_equal(_plain(res, ymode, bmodes),
                          _jax(res, ymode, bmodes))


@pytest.mark.parametrize("name,frame", FRAMES)
def test_plain_matches_host_recon_on_fixtures(name, frame):
    inp = testing.wavefront_inputs(name, frame)
    got = _plain(inp["residual"], inp["ymode"], inp["bmodes"])
    assert got.shape == (16 * inp["mb"][0], 16 * inp["mb"][1])
    assert np.array_equal(got, inp["Y"])


def _host_luma(res, ymode, bmodes) -> np.ndarray:
    mbh, mbw = ymode.shape
    r24 = np.zeros((mbh, mbw, 24, 4, 4), np.int16)
    r24[:, :, :16] = res
    y = np.zeros((16 * mbh, 16 * mbw), np.uint8)
    u = np.zeros((8 * mbh, 8 * mbw), np.uint8)
    v = np.zeros((8 * mbh, 8 * mbw), np.uint8)
    native.vp8_recon(y, u, v, r24, ymode, bmodes,
                     np.zeros((mbh, mbw), np.int32), mbh, mbw)
    return y


@pytest.mark.parametrize("name", list(testing.wavefront_cases()))
def test_plain_matches_host_recon_on_cases(name):
    res, ymode, bmodes = testing.wavefront_cases()[name]
    assert np.array_equal(_plain(res, ymode, bmodes),
                          _host_luma(res, ymode, bmodes))


def test_virtual_edges_and_dc_fallbacks():
    """Zero residuals: DC with neither edge is 128; V under the virtual
    row 127; H beside the virtual column 129, or beside the MB to its
    left; TM from 127 above, 129 left and the corner (127 on the top
    row, 129 below it)."""
    z = np.zeros((2, 3, 16, 4, 4), np.int32)
    ymode = np.array([[0, 1, 2], [2, 3, 0]], np.int32)
    y = _plain(z, ymode, np.zeros((2, 3, 16), np.int32))
    assert (y[:16, :16] == 128).all()
    assert (y[:16, 16:32] == 127).all()          # V: the virtual row
    assert (y[:16, 32:] == 127).all()            # H: V's right column
    assert (y[16:, :16] == 129).all()            # H: the virtual column
    # TM at (1, 1): left 129, above 128 | 127, corner 128
    left, corner = 129, int(y[15, 15])
    assert (y[16:, 16:32] == np.clip(left + y[15, 16:32].astype(int)
                                     - corner, 0, 255)).all()
    # DC at (1, 2): the 16 above and the 16 left
    s = int(y[15, 32:].sum()) + int(y[16:, 31].sum())
    assert (y[16:, 32:] == (s + 16) >> 5).all()


def test_b_modes_index_as_jax():
    m = torch.tensor([-11, -10, -1, 0, 9, 10, 12])
    assert wf.b_modes(m).tolist() == [0, 0, 9, 0, 9, 9, 9]


def test_kernel_tap_table_is_the_plain_versions():
    """K18's table of edge indices (``kB4Taps`` in ``csrc/vp8_decode.cu``)
    holds the plain version's ``B4_TAPS`` for B-modes 2..9, a byte an
    index, low byte first."""
    src = (Path(wf.__file__).parent.parent / "csrc" / "vp8_decode.cu") \
        .read_text()
    body = re.search(r"kB4Taps\[8\]\[16\] = \{(.*?)\n\};", src, re.S).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})", body)]
    got = np.array([[(w >> (8 * k)) & 255 for k in range(4)]
                    for w in words]).reshape(8, 16, 4)
    assert np.array_equal(got, wf.B4_TAPS[2:].numpy())


def test_make_wavefront_takes_the_plain_version_on_cpu_tensors():
    res, ymode, bmodes = testing.wavefront_cases()["mb3x4_bpred"]
    run = wf.make_wavefront(3, 4)
    t = [torch.from_numpy(a).to("cpu") for a in (res, ymode, bmodes)]
    assert torch.equal(run(*t), wf.vp8_wavefront_plain(*t))
    assert cuda_vp8.launches["vp8_wavefront"] == 0
    with pytest.raises(ValueError, match="shape"):
        wf.make_wavefront(3, 5)(*t)
    with pytest.raises(ValueError):
        wf.make_wavefront(0, 4)


def test_make_wavefront_numpy_inputs_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res, ymode, bmodes = testing.wavefront_cases()["mb1x7"]
    with pytest.raises(RuntimeError, match="CUDA"):
        wf.make_wavefront(1, 7)(res, ymode, bmodes)


def test_k18_wrapper_refuses_what_the_kernel_does_not_take():
    res, ymode, bmodes = (torch.from_numpy(a) for a in
                          testing.wavefront_cases()["mb1x7"])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_vp8.vp8_wavefront(res, ymode, bmodes)
    with pytest.raises(ValueError, match="int32"):
        cuda_vp8.vp8_wavefront(res.to(torch.int16), ymode, bmodes)
    with pytest.raises(ValueError, match="int32"):
        cuda_vp8.vp8_wavefront(res, ymode, bmodes.to(torch.int64))
    with pytest.raises(ValueError, match="bmodes"):
        cuda_vp8.vp8_wavefront(res, ymode, bmodes[:, :, :8])
    with pytest.raises(ValueError, match="ymode"):
        cuda_vp8.vp8_wavefront(res, ymode[None], bmodes)
    assert cuda_vp8.launches["vp8_wavefront"] == 0
