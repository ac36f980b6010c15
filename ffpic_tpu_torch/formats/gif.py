"""GIF codec of the port.

Copied from ``ffpic_tpu/formats/gif.py``: 87a/89a, global and local
colour tables, interlacing, LZW through the port's native decoder
(``coding/lzw.py``), animation frames composited on the logical screen
with graphic-control disposal and transparency, comment and NETSCAPE
extensions (``load`` ``:48-152``), and the encoder (``encode`` ``:298``,
``_median_cut`` ``:177``, ``_quantize`` ``:207``, ``_lzw_encode_gif``
``:232``). The host decode is ``decode``; the registry's ``load`` stages
each frame's pixels to the device.  A screen or frame of more than
``staging.MAX_PIXELS`` pixels raises ``ValueError`` before anything is
allocated (the original allocates it).
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu_torch.coding.lzw import lzw_decode_gif
from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.formats.staging import check_size


def probe(data: bytes) -> bool:
    return data[:6] in (b"GIF87a", b"GIF89a")


def _read_color_table(data: bytes, pos: int, size: int):
    tbl = np.zeros((256, 4), np.uint8)
    tbl[:, 3] = 255
    tbl[:size, :3] = np.frombuffer(data, np.uint8, size * 3, pos) \
        .reshape(size, 3)
    return tbl, pos + size * 3


def _deinterlace(idx: np.ndarray) -> np.ndarray:
    h = idx.shape[0]
    out = np.empty_like(idx)
    rows = list(range(0, h, 8)) + list(range(4, h, 8)) + \
        list(range(2, h, 4)) + list(range(1, h, 2))
    out[rows] = idx
    return out


def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """Every frame composited on the logical screen, pixels on the
    host (``device`` is not used: no nested decode)."""
    version = data[3:6].decode("latin1")
    w, h = struct.unpack_from("<HH", data, 6)
    flags, bg_idx, aspect = data[10], data[11], data[12]
    pos = 13
    gct = None
    if flags & 0x80:
        gct, pos = _read_color_table(data, pos, 2 << (flags & 7))

    meta = dict(width=w, height=h, version=version,
                global_colors=(2 << (flags & 7)) if flags & 0x80 else 0,
                background=bg_idx, aspect=aspect, comments=[], loops=None)
    if skip_decode:
        return [Pic(width=w, height=h, depth=32, pitch=w * 4, codec="GIF",
                    meta=meta)]

    check_size(w, h, "GIF")
    pics: list[Pic] = []
    screen = np.zeros((h, w, 4), np.uint8)
    gce = None  # (delay, transparent_idx, disposal)
    prev_screen = None

    def read_subblocks(p):
        chunks = []
        while p < len(data) and data[p]:
            n = data[p]
            chunks.append(data[p + 1:p + 1 + n])
            p += 1 + n
        return b"".join(chunks), p + 1

    while pos < len(data):
        b = data[pos]
        if b == 0x3B:  # trailer
            break
        if b == 0x21:  # extension
            label = data[pos + 1]
            if label == 0xF9:  # graphic control
                n = data[pos + 2]
                gflags, delay, tidx = struct.unpack_from("<BHB", data, pos + 3)
                gce = dict(delay_ms=delay * 10,
                           transparent=tidx if gflags & 1 else -1,
                           disposal=(gflags >> 2) & 7)
                pos += 3 + n + 1
            elif label == 0xFE:  # comment
                blob, pos2 = read_subblocks(pos + 2)
                meta["comments"].append(blob.decode("latin1", "replace"))
                pos = pos2
            elif label == 0xFF:  # application (NETSCAPE looping)
                blob, pos2 = read_subblocks(pos + 2)
                if blob[:11] == b"NETSCAPE2.0" and len(blob) >= 14:
                    meta["loops"] = struct.unpack_from("<H", blob, 12)[0]
                pos = pos2
            else:
                _, pos = read_subblocks(pos + 2)
        elif b == 0x2C:  # image descriptor
            ix, iy, iw, ih = struct.unpack_from("<HHHH", data, pos + 1)
            lflags = data[pos + 9]
            pos += 10
            table = gct
            if lflags & 0x80:
                table, pos = _read_color_table(data, pos, 2 << (lflags & 7))
            if table is None:
                table = np.zeros((256, 4), np.uint8)
                table[:, 3] = 255
            check_size(iw, ih, "GIF")
            min_code = data[pos]
            pos += 1
            blob, pos = read_subblocks(pos)
            idx = np.frombuffer(
                lzw_decode_gif(blob, min_code, iw * ih), np.uint8,
            )
            if idx.size < iw * ih:
                idx = np.pad(idx, (0, iw * ih - idx.size))
            idx = idx[:iw * ih].reshape(ih, iw)
            if lflags & 0x40:
                idx = _deinterlace(idx)

            rgba = table[idx]
            transparent = gce["transparent"] if gce else -1
            disposal = gce["disposal"] if gce else 0
            delay = gce["delay_ms"] if gce else 0

            if disposal == 3:
                prev_screen = screen.copy()
            region = screen[iy:iy + ih, ix:ix + iw]
            if transparent >= 0:
                mask = (idx != transparent)[..., None]
                region[:] = np.where(mask, rgba, region)
            else:
                region[:] = rgba

            frame = screen.copy()
            pics.append(Pic(pixels=frame, width=w, height=h, depth=32,
                            pitch=w * 4, format=PixelFormat.RGBA32,
                            codec="GIF", delay_ms=delay, meta=meta))

            if disposal == 2:       # restore to background
                screen[iy:iy + ih, ix:ix + iw] = 0
            elif disposal == 3 and prev_screen is not None:
                screen = prev_screen
            gce = None
        else:
            pos += 1  # tolerate junk like the reference's skip loop

    meta["frames"] = len(pics)
    return pics


def info(pic: Pic) -> str:
    m = pic.meta
    lines = [f"GIF{m['version']} file format",
             f"\twidth {m['width']}, height {m['height']}",
             f"\tglobal color table {m['global_colors']} entries, "
             f"background {m['background']}",
             f"\tframes {m.get('frames', 1)}"]
    if m.get("loops") is not None:
        lines.append(f"\tNETSCAPE loops {m['loops']}")
    for c in m.get("comments", []):
        lines.append(f"\tcomment: {c[:60]}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Encoder (the reference format/gif.c is decode-only): median-cut
# palette quantization + GIF-variant LZW (LSB packing, late change —
# the exact inverse of the native decoder, native/host_lzw.c:15-89),
# single images and animations (pic.frames + delay_ms, NETSCAPE loop).


def _median_cut(colors: np.ndarray, counts: np.ndarray,
                budget: int) -> np.ndarray:
    """Weighted median-cut over unique colors -> palette index per
    unique color.  Returns (palette (K,3) uint8, assign (n,) int)."""
    boxes = [np.arange(len(colors))]
    while len(boxes) < budget:
        # split the most populous box along its widest channel
        weights = [counts[b].sum() if len(b) > 1 else -1 for b in boxes]
        k = int(np.argmax(weights))
        if weights[k] <= 0:
            break
        b = boxes[k]
        spans = colors[b].max(0) - colors[b].min(0)
        ch = int(np.argmax(spans))
        order = b[np.argsort(colors[b, ch], kind="stable")]
        csum = np.cumsum(counts[order])
        cut = int(np.searchsorted(csum, csum[-1] / 2)) + 1
        cut = min(max(cut, 1), len(order) - 1)
        boxes[k] = order[:cut]
        boxes.append(order[cut:])
    palette = np.zeros((len(boxes), 3), np.uint8)
    assign = np.zeros(len(colors), np.int32)
    for i, b in enumerate(boxes):
        wsum = counts[b].astype(np.float64)
        palette[i] = np.round((colors[b] * wsum[:, None]).sum(0)
                              / wsum.sum()).astype(np.uint8)
        assign[b] = i
    return palette, assign


def _quantize(rgba: np.ndarray) -> tuple:
    """RGBA -> (palette (<=256,3), index map (H,W), transparent_idx)."""
    h, w = rgba.shape[:2]
    rgb = rgba[..., :3].reshape(-1, 3).astype(np.uint32)
    transparent = rgba[..., 3].reshape(-1) < 128
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    uniq, inv, counts = np.unique(packed, return_inverse=True,
                                  return_counts=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255],
                      -1).astype(np.int64)
    budget = 255 if transparent.any() else 256
    if len(uniq) <= budget:
        palette = colors.astype(np.uint8)
        assign = np.arange(len(uniq), dtype=np.int32)
    else:
        palette, assign = _median_cut(colors, counts, budget)
    idx = assign[inv]
    tidx = -1
    if transparent.any():
        tidx = len(palette)
        palette = np.vstack([palette, np.zeros((1, 3), np.uint8)])
        idx = np.where(transparent, tidx, idx)
    return palette, idx.reshape(h, w).astype(np.int32), tidx


def _lzw_encode_gif(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF LZW: LSB bit packing, late code-size change — state machine
    mirrors the decoder (host_lzw.c:27-87) exactly."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    bitbuf = 0
    bits = 0

    def emit(code, size):
        nonlocal bitbuf, bits
        bitbuf |= code << bits
        bits += size
        while bits >= 8:
            out.append(bitbuf & 255)
            bitbuf >>= 8
            bits -= 8

    code_size = min_code_size + 1
    table = {}
    next_code = eoi + 1
    emit(clear, code_size)
    seq = indices.ravel().tolist()
    prev = seq[0]
    for k in seq[1:]:
        key = (prev, k)
        got = table.get(key)
        if got is not None:
            prev = got
            continue
        emit(prev, code_size)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            # late change, seen from the encoder: the decoder adds its
            # copy of each entry one code LATER than we do, so the
            # size bump lands one emission after ours would
            if next_code == (1 << code_size) + 1 and code_size < 12:
                code_size += 1
        else:
            emit(clear, code_size)
            table.clear()
            code_size = min_code_size + 1
            next_code = eoi + 1
        prev = k
    emit(prev, code_size)
    # the decoder adds one more entry after reading that final code,
    # which can bump the size it reads EOI with
    if next_code == (1 << code_size) and code_size < 12:
        code_size += 1
    emit(eoi, code_size)
    if bits:
        out.append(bitbuf & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def encode(pic: Pic, *, device=None, loops: int = 0,
           **options) -> bytes:
    """On the host whatever ``device`` is."""
    frames = [pic] + list(pic.frames or [])
    w, h = pic.width, pic.height
    out = bytearray(b"GIF89a")

    encoded = []
    for fr in frames:
        rgba = fr.to_rgba32()
        palette, idx, tidx = _quantize(rgba)
        nbits = max(2, int(np.ceil(np.log2(max(len(palette), 2)))))
        pal = np.zeros((1 << nbits, 3), np.uint8)
        pal[:len(palette)] = palette
        encoded.append((pal, nbits, idx, tidx,
                        getattr(fr, "delay_ms", 0) or 0))

    # first frame's palette doubles as the (mandatory-for-us) GCT
    pal0, nbits0 = encoded[0][0], encoded[0][1]
    out += struct.pack("<HHBBB", w, h, 0x80 | (nbits0 - 1), 0, 0)
    out += pal0.tobytes()

    if len(frames) > 1:
        out += b"\x21\xff\x0bNETSCAPE2.0"
        out += _sub_blocks(struct.pack("<BH", 1, loops))

    for fi, (pal, nbits, idx, tidx, delay) in enumerate(encoded):
        if tidx >= 0 or len(frames) > 1:
            flags = (0x01 if tidx >= 0 else 0) | (2 << 2)  # restore-bg
            out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4, flags,
                               delay // 10, max(tidx, 0), 0)
        lct = fi > 0 and not np.array_equal(pal, pal0)
        fh, fw = idx.shape
        out += struct.pack("<BHHHHB", 0x2C, 0, 0, fw, fh,
                           (0x80 | (nbits - 1)) if lct else 0)
        if lct:
            out += pal.tobytes()
        mcs = nbits
        out.append(mcs)
        out += _sub_blocks(_lzw_encode_gif(idx, mcs))
    out.append(0x3B)
    return bytes(out)


register(Codec(name="GIF", probe=probe, decode=decode, info=info,
               encode=encode))
