"""LZW decoders: the GIF variant (LSB-packed, variable 3-12 bit codes,
clear/EOI, late change) and the TIFF variant (MSB-packed, early
change), and the LZ77 decoder that has no caller.

Copied from ``ffpic_tpu/coding/lzw.py`` (``lzw_decode_gif`` ``:14``,
``lzw_decode_tiff`` ``:92``, ``lz77_decode`` ``:167``), with two
changes.  ``lzw_decode_gif`` and ``lzw_decode_tiff`` always call the
native library (``native.lzw_gif``, ``native.lzw_tiff``, from
``native/host_lzw.c``); the original's Python loops are kept as the
plain versions ``lzw_decode_gif_py`` and ``lzw_decode_tiff_py`` that the
tests hold the native code against.  There is no ``FFPIC_NO_NATIVE``
fallback: the port builds its library or raises.  And both the native
code and the plain loops raise ``ValueError`` on a corrupt stream that
the originals take: a code past the table, or a first code after a
clear (or at the start) that is not a literal.  On the latter the
originals make an entry whose prefix is itself, and the next use of
that code walks it forever: the Python loops grow their stack until
memory runs out, the native ones write past theirs.
"""

from __future__ import annotations

from ffpic_tpu_torch import native


def lzw_decode_gif(data: bytes, min_code_size: int, max_out: int) -> bytearray:
    """GIF LZW through the native decoder: at most ``max_out`` bytes."""
    return native.lzw_gif(bytes(data), min_code_size, max_out)


def lzw_decode_tiff(data: bytes, max_out: int) -> bytearray:
    """TIFF LZW through the native decoder: at most ``max_out`` bytes."""
    return native.lzw_tiff(bytes(data), max_out)


def lzw_decode_gif_py(data: bytes, min_code_size: int, max_out: int) -> bytearray:
    """GIF LZW: codes packed LSB-first; code size grows 'late'
    (after the table fills 2^n)."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()

    prefix = [-1] * 4096
    suffix = [0] * 4096
    first = [0] * 4096
    for i in range(clear):
        suffix[i] = first[i] = i

    code_size = min_code_size + 1
    next_code = eoi + 1
    prev = -1

    bitbuf = 0
    bits = 0
    pos = 0
    n = len(data)
    stack = bytearray()

    while pos < n or bits >= code_size:
        while bits < code_size and pos < n:
            bitbuf |= data[pos] << bits
            bits += 8
            pos += 1
        if bits < code_size:
            break
        code = bitbuf & ((1 << code_size) - 1)
        bitbuf >>= code_size
        bits -= code_size

        if code == clear:
            code_size = min_code_size + 1
            next_code = eoi + 1
            prev = -1
            continue
        if code == eoi:
            break

        if code > next_code or code >= 4096:
            raise ValueError("corrupt LZW stream")
        if prev < 0:
            if code >= clear:
                raise ValueError("corrupt LZW stream")
            out.append(first[code])
            prev = code
            continue

        # emit string for code (or prev+first(prev) for the KwKwK case)
        c = code
        if code >= next_code:
            stack.append(first[prev])
            c = prev
        while c >= clear:
            stack.append(suffix[c])
            c = prefix[c]
        stack.append(suffix[c])
        fb = suffix[c]
        out += stack[::-1]
        stack.clear()

        if next_code < 4096:
            prefix[next_code] = prev
            suffix[next_code] = fb
            first[next_code] = first[prev]
            next_code += 1
            if next_code == (1 << code_size) and code_size < 12:
                code_size += 1
        prev = code
        if len(out) >= max_out:
            break
    return out


def lzw_decode_tiff_py(data: bytes, max_out: int) -> bytearray:
    """TIFF LZW: 8-bit symbols, codes packed MSB-first, with
    early-change (code size grows one code earlier than GIF)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    prefix = [-1] * 4096
    suffix = [0] * 4096
    first = [0] * 4096
    for i in range(256):
        suffix[i] = first[i] = i

    code_size = 9
    next_code = 258
    prev = -1
    bitbuf = 0
    bits = 0
    pos = 0
    n = len(data)
    stack = bytearray()

    while True:
        while bits < code_size and pos < n:
            bitbuf = (bitbuf << 8) | data[pos]
            bits += 8
            pos += 1
        if bits < code_size:
            break
        code = (bitbuf >> (bits - code_size)) & ((1 << code_size) - 1)
        bits -= code_size

        if code == CLEAR:
            code_size = 9
            next_code = 258
            prev = -1
            continue
        if code == EOI:
            break
        if code > next_code or code >= 4096:
            raise ValueError("corrupt LZW stream")
        if prev < 0:
            if code >= 256:
                raise ValueError("corrupt LZW stream")
            out.append(first[code])
            prev = code
            if next_code == (1 << code_size) - 1 and code_size < 12:
                pass
            continue

        c = code
        if code >= next_code:
            stack.append(first[prev])
            c = prev
        while c >= 256:
            stack.append(suffix[c])
            c = prefix[c]
        stack.append(suffix[c])
        fb = suffix[c]
        out += stack[::-1]
        stack.clear()

        if next_code < 4096:
            prefix[next_code] = prev
            suffix[next_code] = fb
            first[next_code] = first[prev]
            next_code += 1
            # early change: grow when one short of full
            if next_code == (1 << code_size) - 1 and code_size < 12:
                code_size += 1
        prev = code
        if len(out) >= max_out:
            break
    return out


def lz77_decode(data: bytes, max_out: int = 1 << 28) -> bytearray:
    """Byte-oriented LZ77 (Microsoft compress-style flag-byte format,
    component parity with coding/lz77.c:1-46): each flag byte selects
    literal (bit=1) or a 16-bit (offset, len) pair window copy."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n and len(out) < max_out:
        flags = data[pos]
        pos += 1
        for bit in range(8):
            if pos >= n:
                break
            if flags & (1 << bit):
                out.append(data[pos])
                pos += 1
            else:
                if pos + 1 >= n:
                    break
                word = data[pos] | (data[pos + 1] << 8)
                pos += 2
                length = (word & 0xF) + 3
                offset = (word >> 4) + 1
                for _ in range(length):
                    out.append(out[-offset])
    return out
