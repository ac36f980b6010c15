/* Copied from ffpic_tpu/native/host_png.c (the comment below reworded
 * for the port): the host PNG scanline unfilter of ffpic_tpu_torch,
 * built beside host_jpeg.c by ffpic_tpu_torch/native/__init__.py. */

/* host_png.c — PNG scanline filter reconstruction (host stage).
 *
 * The five filters (None/Sub/Up/Average/Paeth, reference
 * format/png.c:106-168) form byte-serial recurrences: Sub/Average/
 * Paeth depend on the reconstructed left neighbor through nonlinear
 * (floor-average / predictor-select) functions, so they belong on the
 * host next to inflate, not on the device — the device handles the
 * dense per-pixel work (palette gather, bit expansion, format
 * conversion) in ffpic_tpu_torch/ops/png_kernels.py, and rows that use
 * only None/Sub/Up. Single pass, in place.
 *
 * in/out: raw = H rows of (1 filter byte + stride bytes); recon = H x
 * stride output. bpp = filter delta distance in bytes (ceil semantics
 * per the PNG spec).
 */

#include <stdint.h>
#include <stdlib.h>

#define FFPIC_API __attribute__((visibility("default")))

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc)
        return a;
    if (pb <= pc)
        return b;
    return c;
}

FFPIC_API int ffpic_png_unfilter(const uint8_t *raw, uint8_t *recon,
                                 long height, long stride, int bpp) {
    const uint8_t *prev = NULL;
    for (long y = 0; y < height; y++) {
        int ft = raw[y * (stride + 1)];
        const uint8_t *src = raw + y * (stride + 1) + 1;
        uint8_t *dst = recon + y * stride;
        switch (ft) {
        case 0: /* None */
            for (long i = 0; i < stride; i++)
                dst[i] = src[i];
            break;
        case 1: /* Sub */
            for (long i = 0; i < bpp && i < stride; i++)
                dst[i] = src[i];
            for (long i = bpp; i < stride; i++)
                dst[i] = (uint8_t)(src[i] + dst[i - bpp]);
            break;
        case 2: /* Up */
            if (prev) {
                for (long i = 0; i < stride; i++)
                    dst[i] = (uint8_t)(src[i] + prev[i]);
            } else {
                for (long i = 0; i < stride; i++)
                    dst[i] = src[i];
            }
            break;
        case 3: /* Average */
            for (long i = 0; i < stride; i++) {
                int a = (i >= bpp) ? dst[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4: /* Paeth */
            for (long i = 0; i < stride; i++) {
                int a = (i >= bpp) ? dst[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
            }
            break;
        default:
            return -1;
        }
        prev = dst;
    }
    return 0;
}
