/* host_lzw.c — native LZW decoders: GIF variant (LSB-packed, late
 * change) and TIFF variant (MSB-packed, early change).
 *
 * Copied from ffpic_tpu/native/host_lzw.c (ffpic_lzw_gif, ffpic_lzw_tiff):
 * exact ports of the plain Python loops of coding/lzw.py, with two
 * refusals those loops share: a code past the table, and a first code
 * after a clear (or at the start) that is not a literal.  The original
 * takes the latter, and the entry made after it points at itself, so
 * the next use of that code walks the chain forever and overruns the
 * stack.  The walk is also bounded by the stack's size.
 * Returns bytes produced, or -1 on malformed input.
 */

#include <stdint.h>
#include <stdlib.h>

#define FFPIC_API __attribute__((visibility("default")))

FFPIC_API long ffpic_lzw_gif(const uint8_t *data, long n,
                             int min_code_size, uint8_t *out,
                             long max_out) {
    int clear = 1 << min_code_size;
    int eoi = clear + 1;
    static _Thread_local int16_t prefix[4096];
    static _Thread_local uint8_t suffix[4096], first[4096];
    uint8_t stack[4096];
    for (int i = 0; i < clear; i++) {
        prefix[i] = -1;
        suffix[i] = first[i] = (uint8_t)i;
    }
    int code_size = min_code_size + 1;
    int next_code = eoi + 1;
    int prev = -1;
    uint32_t bitbuf = 0;
    int bits = 0;
    long pos = 0, w = 0;

    while (pos < n || bits >= code_size) {
        while (bits < code_size && pos < n) {
            bitbuf |= (uint32_t)data[pos++] << bits;
            bits += 8;
        }
        if (bits < code_size)
            break;
        int code = bitbuf & ((1 << code_size) - 1);
        bitbuf >>= code_size;
        bits -= code_size;

        if (code == clear) {
            code_size = min_code_size + 1;
            next_code = eoi + 1;
            prev = -1;
            continue;
        }
        if (code == eoi)
            break;
        if (code > next_code || code >= 4096)
            return -1;
        if (prev < 0) {
            if (code >= clear)
                return -1;
            if (w < max_out)
                out[w++] = first[code];
            prev = code;
            continue;
        }
        int sp = 0;
        int c = code;
        if (code >= next_code) {
            stack[sp++] = first[prev];
            c = prev;
        }
        while (c >= clear) {
            if (sp >= 4095)
                return -1;
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        stack[sp++] = suffix[c];
        uint8_t fb = suffix[c];
        while (sp > 0 && w < max_out)
            out[w++] = stack[--sp];

        if (next_code < 4096) {
            prefix[next_code] = (int16_t)prev;
            suffix[next_code] = fb;
            first[next_code] = first[prev];
            next_code++;
            if (next_code == (1 << code_size) && code_size < 12)
                code_size++;
        }
        prev = code;
        if (w >= max_out)
            break;
    }
    return w;
}

FFPIC_API long ffpic_lzw_tiff(const uint8_t *data, long n,
                              uint8_t *out, long max_out) {
    enum { CLEAR = 256, EOI = 257 };
    static _Thread_local int16_t prefix[4096];
    static _Thread_local uint8_t suffix[4096], first[4096];
    uint8_t stack[4096];
    for (int i = 0; i < 256; i++) {
        prefix[i] = -1;
        suffix[i] = first[i] = (uint8_t)i;
    }
    int code_size = 9;
    int next_code = 258;
    int prev = -1;
    uint32_t bitbuf = 0;
    int bits = 0;
    long pos = 0, w = 0;

    for (;;) {
        while (bits < code_size && pos < n) {
            bitbuf = (bitbuf << 8) | data[pos++];
            bits += 8;
        }
        if (bits < code_size)
            break;
        int code = (bitbuf >> (bits - code_size))
            & ((1 << code_size) - 1);
        bits -= code_size;

        if (code == CLEAR) {
            code_size = 9;
            next_code = 258;
            prev = -1;
            continue;
        }
        if (code == EOI)
            break;
        if (code > next_code || code >= 4096)
            return -1;
        if (prev < 0) {
            if (code >= 256)
                return -1;
            if (w < max_out)
                out[w++] = first[code];
            prev = code;
            continue;
        }
        int sp = 0;
        int c = code;
        if (code >= next_code) {
            stack[sp++] = first[prev];
            c = prev;
        }
        while (c >= 256) {
            if (sp >= 4095)
                return -1;
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        stack[sp++] = suffix[c];
        uint8_t fb = suffix[c];
        while (sp > 0 && w < max_out)
            out[w++] = stack[--sp];

        if (next_code < 4096) {
            prefix[next_code] = (int16_t)prev;
            suffix[next_code] = fb;
            first[next_code] = first[prev];
            next_code++;
            /* early change: grow when one short of full */
            if (next_code == (1 << code_size) - 1 && code_size < 12)
                code_size++;
        }
        prev = code;
        if (w >= max_out)
            break;
    }
    return w;
}
