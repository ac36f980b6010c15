/* Copied from ffpic_tpu/native/host_vp8.c (the comments above the loop
 * filter, the residual stage and the colour conversion reworded for the
 * port): the host VP8 stages of ffpic_tpu_torch, built beside
 * host_jpeg.c by ffpic_tpu_torch/native/__init__.py.
 *
 * host_vp8.c — native VP8 in-loop deblocking filter (RFC 6386 §15),
 * token partitions, macroblock headers, coefficient probabilities,
 * residual transform, intra reconstruction and colour conversion.
 *
 * The loop filter has a strict raster serial dependency (each MB's
 * edges read pixels written by the previous MB's filtering), so it
 * stays on the host.  Its semantics are an exact port of the filter
 * loop of ffpic_tpu/formats/vp8_filter.py (itself pixel-exact vs
 * libwebp).
 *
 * Reference scope anchor: format/webp.c:1685-1803.
 */

#include <stdint.h>
#include <stdlib.h>

#define FFPIC_API __attribute__((visibility("default")))

static void mb_residual(const int32_t *lv, const int32_t *nz,
                        const int32_t *d, int hy2, int16_t res[24 * 16]);


static inline int c8(int x) { return x < -128 ? -128 : (x > 127 ? 127 : x); }
static inline int iabs(int x) { return x < 0 ? -x : x; }

/* lane accessor: edge at `base`, lanes advance by ls, across-edge
 * offset k advances by ks (k = 0 is q0, k = -1 is p0) */
#define PIX(l, k) ((int)base[(l) * ls + (k) * ks] - 128)
#define PUT(l, k, v) (base[(l) * ls + (k) * ks] = (uint8_t)(c8(v) + 128))

static void simple_edge(uint8_t *base, long ls, long ks, int lanes,
                        int flimit) {
    for (int l = 0; l < lanes; l++) {
        int p1 = PIX(l, -2), p0 = PIX(l, -1);
        int q0 = PIX(l, 0), q1 = PIX(l, 1);
        if (iabs(p0 - q0) * 2 + (iabs(p1 - q1) >> 1) > flimit)
            continue;
        int a = c8(c8(p1 - q1) + 3 * (q0 - p0));
        int f1 = c8(a + 4) >> 3;
        int f2 = c8(a + 3) >> 3;
        PUT(l, 0, q0 - f1);
        PUT(l, -1, p0 + f2);
    }
}

static void normal_edge(uint8_t *base, long ls, long ks, int lanes,
                        int lim, int ilim, int hev_t, int is_mb) {
    for (int l = 0; l < lanes; l++) {
        int p3 = PIX(l, -4), p2 = PIX(l, -3), p1 = PIX(l, -2),
            p0 = PIX(l, -1);
        int q0 = PIX(l, 0), q1 = PIX(l, 1), q2 = PIX(l, 2),
            q3 = PIX(l, 3);
        int mask = (iabs(p0 - q0) * 2 + (iabs(p1 - q1) >> 1)) <= lim
            && iabs(p3 - p2) <= ilim && iabs(p2 - p1) <= ilim
            && iabs(p1 - p0) <= ilim && iabs(q1 - q0) <= ilim
            && iabs(q2 - q1) <= ilim && iabs(q3 - q2) <= ilim;
        if (!mask)
            continue;
        int hev = iabs(p1 - p0) > hev_t || iabs(q1 - q0) > hev_t;
        if (hev) {
            /* common_adjust(use_outer=1): filter p0/q0 only */
            int a = c8(c8(p1 - q1) + 3 * (q0 - p0));
            int f1 = c8(a + 4) >> 3;
            int f2 = c8(a + 3) >> 3;
            PUT(l, 0, q0 - f1);
            PUT(l, -1, p0 + f2);
        } else if (is_mb) {
            int w = c8(c8(p1 - q1) + 3 * (q0 - p0));
            int a = c8((27 * w + 63) >> 7);
            PUT(l, -1, p0 + a);
            PUT(l, 0, q0 - a);
            a = c8((18 * w + 63) >> 7);
            PUT(l, -2, p1 + a);
            PUT(l, 1, q1 - a);
            a = c8((9 * w + 63) >> 7);
            PUT(l, -3, p2 + a);
            PUT(l, 2, q2 - a);
        } else {
            /* common_adjust(use_outer=0) + p1/q1 nudge */
            int a = c8(3 * (q0 - p0));
            int f1 = c8(a + 4) >> 3;
            int f2 = c8(a + 3) >> 3;
            int a3 = (f1 + 1) >> 1;
            PUT(l, 0, q0 - f1);
            PUT(l, -1, p0 + f2);
            PUT(l, -2, p1 + a3);
            PUT(l, 1, q1 - a3);
        }
    }
}

/* Filter one whole frame.  levels/inner are (mbh*mbw) row-major. */
FFPIC_API void ffpic_vp8_loop_filter(
    uint8_t *Y, uint8_t *U, uint8_t *V, int mbh, int mbw,
    const int32_t *levels, const uint8_t *inner_flags,
    int simple, int sharpness) {
    long ys = (long)mbw * 16;     /* luma stride */
    long cs = (long)mbw * 8;      /* chroma stride */
    for (int my = 0; my < mbh; my++) {
        for (int mx = 0; mx < mbw; mx++) {
            int level = levels[my * mbw + mx];
            if (level == 0)
                continue;
            int ilevel = level;
            if (sharpness > 0) {
                ilevel >>= (sharpness > 4) ? 2 : 1;
                if (ilevel > 9 - sharpness)
                    ilevel = 9 - sharpness;
            }
            if (ilevel < 1)
                ilevel = 1;
            int mb_lim = (level + 2) * 2 + ilevel;
            int sub_lim = level * 2 + ilevel;
            int hev_t = level >= 40 ? 2 : (level >= 15 ? 1 : 0);
            int inner = inner_flags[my * mbw + mx];
            long y0 = (long)my * 16, x0 = (long)mx * 16;

            if (simple) {
                /* vertical edges (lanes along y), then horizontal */
                if (mx > 0)
                    simple_edge(Y + y0 * ys + x0, ys, 1, 16, mb_lim);
                if (inner)
                    for (int d = 4; d <= 12; d += 4)
                        simple_edge(Y + y0 * ys + x0 + d, ys, 1, 16,
                                    sub_lim);
                if (my > 0)
                    simple_edge(Y + y0 * ys + x0, 1, ys, 16, mb_lim);
                if (inner)
                    for (int d = 4; d <= 12; d += 4)
                        simple_edge(Y + (y0 + d) * ys + x0, 1, ys, 16,
                                    sub_lim);
                continue;
            }

            /* normal: luma */
            if (mx > 0)
                normal_edge(Y + y0 * ys + x0, ys, 1, 16, mb_lim,
                            ilevel, hev_t, 1);
            if (inner)
                for (int d = 4; d <= 12; d += 4)
                    normal_edge(Y + y0 * ys + x0 + d, ys, 1, 16,
                                sub_lim, ilevel, hev_t, 0);
            if (my > 0)
                normal_edge(Y + y0 * ys + x0, 1, ys, 16, mb_lim,
                            ilevel, hev_t, 1);
            if (inner)
                for (int d = 4; d <= 12; d += 4)
                    normal_edge(Y + (y0 + d) * ys + x0, 1, ys, 16,
                                sub_lim, ilevel, hev_t, 0);

            /* chroma */
            long cy = (long)my * 8, cx = (long)mx * 8;
            uint8_t *planes[2] = {U, V};
            for (int pi = 0; pi < 2; pi++) {
                uint8_t *P = planes[pi];
                if (mx > 0)
                    normal_edge(P + cy * cs + cx, cs, 1, 8, mb_lim,
                                ilevel, hev_t, 1);
                if (inner)
                    normal_edge(P + cy * cs + cx + 4, cs, 1, 8,
                                sub_lim, ilevel, hev_t, 0);
                if (my > 0)
                    normal_edge(P + cy * cs + cx, 1, cs, 8, mb_lim,
                                ilevel, hev_t, 1);
                if (inner)
                    normal_edge(P + (cy + 4) * cs + cx, 1, cs, 8,
                                sub_lim, ilevel, hev_t, 0);
            }
        }
    }
}

/* ---------------- token-partition decoder ---------------------------
 *
 * RFC 6386 §13: the serial entropy hot path for lossy WebP.  Mirrors
 * formats/vp8.py _parse_tokens exactly (differential-tested); the
 * tables below are RFC 6386 protocol constants, identical to
 * formats/vp8_tables.py.
 */

typedef struct {
    const uint8_t *data;
    long len;
    long pos;
    uint32_t value;
    uint32_t range;
    int bit_count;
} VP8Bool;

static void bd_init(VP8Bool *b, const uint8_t *data, long len) {
    b->data = data;
    b->len = len;
    b->value = ((len > 0 ? data[0] : 0) << 8) | (len > 1 ? data[1] : 0);
    b->pos = 2;
    b->range = 255;
    b->bit_count = 0;
}

static inline int bd_bool(VP8Bool *b, int prob) {
    uint32_t split = 1 + (((b->range - 1) * (uint32_t)prob) >> 8);
    uint32_t big = split << 8;
    int ret;
    if (b->value >= big) {
        ret = 1;
        b->range -= split;
        b->value -= big;
    } else {
        ret = 0;
        b->range = split;
    }
    if (b->range < 128) {
        /* batched renorm: range in [1,127] -> shift in [1,7]; at most
         * one byte boundary can be crossed, insert it at the right
         * position (equivalent to the bit-at-a-time loop) */
        int shift = __builtin_clz(b->range) - 24;
        b->range <<= shift;
        int k = 8 - b->bit_count;      /* steps until the byte insert */
        if (shift < k) {
            b->value <<= shift;
            b->bit_count += shift;
        } else {
            uint32_t byte = (b->pos < b->len) ? b->data[b->pos] : 0;
            b->pos++;
            b->value = ((b->value << k) | byte) << (shift - k);
            b->bit_count = shift - k;
        }
    }
    return ret;
}

/* Fast bool decoder for the token hot path: 64-bit left-justified
 * value cache with clz renormalization (the libvpx/dboolhuff
 * formulation; the reference's booldec.c:95-119 uses the same
 * `7 ^ log2floor(range)` renorm idea).  Arithmetic is identical to
 * the RFC window decoder above — used only where the state starts
 * fresh (token partitions), so no state conversion is ever needed. */
typedef struct {
    const uint8_t *data;
    long len;
    long pos;        /* next byte to load */
    uint64_t value;  /* left-justified: top (count+8) bits valid */
    int count;
    uint32_t range;
} VP8BoolF;

static void bdf_fill(VP8BoolF *b) {
    int c = b->count;
    if (b->pos + 8 <= b->len && c <= 48) {
        /* bulk refill: one 64-bit big-endian load per ~7 bools.
         * Partial low bits of the last byte may be ORed in below
         * the accounted count — harmless: the same byte is ORed
         * again at the same (stream-absolute) position later. */
        uint64_t v;
        memcpy(&v, b->data + b->pos, 8);
        v = __builtin_bswap64(v);
        b->value |= v >> (8 + c);
        int k = ((48 - c) >> 3) + 1;
        b->pos += k;
        b->count = c + 8 * k;
        return;
    }
    int shift = 64 - 8 - (c + 8);
    while (shift >= 0) {
        if (b->pos >= b->len) {
            /* past EOF the stream reads as zeros: just account bits */
            b->count += 8;
            shift -= 8;
            continue;
        }
        b->value |= (uint64_t)b->data[b->pos++] << shift;
        b->count += 8;
        shift -= 8;
    }
}

static void bdf_init(VP8BoolF *b, const uint8_t *data, long len) {
    b->data = data;
    b->len = len;
    b->pos = 0;
    b->value = 0;
    b->count = -8;
    b->range = 255;
    bdf_fill(b);
}

static inline int bdf_bool(VP8BoolF *b, int prob) {
    uint32_t split = 1 + (((b->range - 1) * (uint32_t)prob) >> 8);
    if (b->count < 0)
        bdf_fill(b);
    uint64_t bigsplit = (uint64_t)split << 56;
    uint32_t range = split;
    int bit = 0;
    if (b->value >= bigsplit) {
        range = b->range - split;
        b->value -= bigsplit;
        bit = 1;
    }
    int shift = __builtin_clz(range) - 24;   /* range in [1,255] */
    b->range = range << shift;
    b->value <<= shift;
    b->count -= shift;
    return bit;
}

static const int8_t TOK_TREE[22] = {
    -11, 2, 0, 4, -1, 6, 8, 12, -2, 10, -3, -4, 14, 16, -5, -6, 18,
    20, -7, -8, -9, -10};
static const uint8_t BANDS[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6,
                                  6, 6, 6, 7};
static const uint8_t ZZ4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10,
                                7, 11, 14, 15};
static const int CAT_BASE[6] = {5, 7, 11, 19, 35, 67};
static const uint8_t CAT_PROBS[6][11] = {
    {159}, {165, 145}, {173, 148, 140}, {176, 155, 140, 135},
    {180, 157, 141, 134, 130},
    {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129}};
static const int CAT_LEN[6] = {1, 2, 3, 4, 5, 11};
#define DCT_EOB 11

/* decode one 4x4 block's tokens; returns nz (last nonzero pos + 1).
 * The RFC 6386 token tree is unrolled libwebp-GetCoeffs-style: the
 * common paths (EOB check, zero run, |v|=1) take 1-3 predictable
 * branches instead of a data-dependent table walk. */
static inline int vp8_block_tokens(VP8BoolF *b, const uint8_t *probs,
                                   int btype, int first, int ctx,
                                   int32_t *blk) {
    int nz = 0;
    int c = ctx;
    const uint8_t *pr = probs + ((btype * 8 + BANDS[first]) * 3 + c) * 11;
    for (int n = first; n < 16; ) {
        if (!bdf_bool(b, pr[0]))        /* EOB */
            break;
        while (!bdf_bool(b, pr[1])) {   /* DCT_0: zero run */
            if (++n == 16)
                return nz;
            /* after a zero, ctx = 0 and the EOB branch is skipped */
            pr = probs + ((btype * 8 + BANDS[n]) * 3 + 0) * 11;
        }
        int val;
        if (!bdf_bool(b, pr[2])) {      /* DCT_1 */
            val = 1;
            c = 1;
        } else {
            c = 2;
            if (!bdf_bool(b, pr[3])) {
                /* DCT_2 / DCT_3 / DCT_4 */
                if (!bdf_bool(b, pr[4]))
                    val = 2;
                else
                    val = 3 + bdf_bool(b, pr[5]);
            } else if (!bdf_bool(b, pr[6])) {
                /* cat1 / cat2 */
                if (!bdf_bool(b, pr[7])) {
                    val = 5 + bdf_bool(b, 159);
                } else {
                    val = 7 + 2 * bdf_bool(b, 165);
                    val += bdf_bool(b, 145);
                }
            } else {
                /* cat3..cat6 */
                int cat;
                if (!bdf_bool(b, pr[8]))
                    cat = 2 + bdf_bool(b, pr[9]);
                else
                    cat = 4 + bdf_bool(b, pr[10]);
                int extra = 0;
                for (int k = 0; k < CAT_LEN[cat]; k++)
                    extra = (extra << 1) | bdf_bool(b, CAT_PROBS[cat][k]);
                val = CAT_BASE[cat] + extra;
            }
        }
        if (bdf_bool(b, 128))
            val = -val;
        blk[ZZ4[n]] = val;
        nz = ++n;
        if (n == 16)
            break;
        pr = probs + ((btype * 8 + BANDS[n]) * 3 + c) * 11;
    }
    return nz;
}

FFPIC_API int ffpic_vp8_tokens(
    const uint8_t *rest, long rest_len,
    const long *part_off, const long *part_len, int nparts,
    const uint8_t *probs,           /* (4,8,3,11) */
    const uint8_t *skip,            /* (mbh,mbw) */
    const uint8_t *has_y2,          /* (mbh,mbw) */
    int mbh, int mbw,
    int32_t *levels,                /* (mbh,mbw,25,16) */
    int32_t *nnz_total) {           /* (mbh,mbw,25) */
    VP8BoolF *parts = malloc(sizeof(VP8BoolF) * nparts);
    if (!parts)
        return -1;
    for (int i = 0; i < nparts; i++) {
        if (part_off[i] + part_len[i] > rest_len) {
            free(parts);
            return -2;
        }
        bdf_init(&parts[i], rest + part_off[i], part_len[i]);
    }
    int *above_nz = calloc((size_t)mbw * 9, sizeof(int));
    int left_nz[9];
    if (!above_nz) {
        free(parts);
        return -1;
    }
    for (int my = 0; my < mbh; my++) {
        for (int k = 0; k < 9; k++)
            left_nz[k] = 0;
        VP8BoolF *b = &parts[my % nparts];
        for (int mx = 0; mx < mbw; mx++) {
            long mb = (long)my * mbw + mx;
            int hy2 = has_y2[mb];
            int *anz = above_nz + (long)mx * 9;
            if (skip[mb]) {
                int lim = hy2 ? 9 : 8;
                for (int k = 0; k < lim; k++) {
                    anz[k] = 0;
                    left_nz[k] = 0;
                }
                continue;
            }
            int32_t *lv = levels + mb * 25 * 16;
            int32_t *nnz = nnz_total + mb * 25;
            int ytype, yfirst;
            if (hy2) {
                int nz = vp8_block_tokens(b, probs, 1, 0,
                                          anz[8] + left_nz[8],
                                          lv + 24 * 16);
                anz[8] = left_nz[8] = nz > 0;
                nnz[24] = nz;
                ytype = 0;
                yfirst = 1;
            } else {
                ytype = 3;
                yfirst = 0;
            }
            int nzy[4][4];
            for (int sy = 0; sy < 4; sy++) {
                for (int sx = 0; sx < 4; sx++) {
                    int bi = sy * 4 + sx;
                    int a = sy == 0 ? anz[sx] : nzy[sy - 1][sx];
                    int l = sx == 0 ? left_nz[sy] : nzy[sy][sx - 1];
                    int nz = vp8_block_tokens(b, probs, ytype, yfirst,
                                              a + l, lv + bi * 16);
                    nzy[sy][sx] = nz > 0;
                    nnz[bi] = nz;
                }
            }
            for (int sx = 0; sx < 4; sx++)
                anz[sx] = nzy[3][sx];
            for (int sy = 0; sy < 4; sy++)
                left_nz[sy] = nzy[sy][3];
            for (int ci = 0; ci < 2; ci++) {
                int base = 16 + 4 * ci;
                int nzc[2][2];
                for (int sy = 0; sy < 2; sy++) {
                    for (int sx = 0; sx < 2; sx++) {
                        int bi = base + sy * 2 + sx;
                        int a = sy == 0 ? anz[4 + 2 * ci + sx]
                                        : nzc[sy - 1][sx];
                        int l = sx == 0 ? left_nz[4 + 2 * ci + sy]
                                        : nzc[sy][sx - 1];
                        int nz = vp8_block_tokens(b, probs, 2, 0, a + l,
                                                  lv + bi * 16);
                        nzc[sy][sx] = nz > 0;
                        nnz[bi] = nz;
                    }
                }
                for (int sx = 0; sx < 2; sx++)
                    anz[4 + 2 * ci + sx] = nzc[1][sx];
                for (int sy = 0; sy < 2; sy++)
                    left_nz[4 + 2 * ci + sy] = nzc[sy][1];
            }
        }
    }
    free(above_nz);
    free(parts);
    return 0;
}

/* ---------------- intra prediction + reconstruction -----------------
 *
 * RFC 6386 §12 (10 B-modes, DC/V/H/TM whole-block modes, 127/129 edge
 * defaults incl. the interior-right-column top-right quirk) with
 * residual add — mirror of formats/vp8.py _reconstruct/_pred_b4
 * (pixel-exact vs libwebp), the serial left/top wavefront stage.
 */

static inline int cl255(int x) { return x < 0 ? 0 : (x > 255 ? 255 : x); }
static inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
static inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }

enum { M_DC = 0, M_V, M_H, M_TM, M_BPRED };
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

static void pred_whole(const uint8_t *plane, long stride, long y0,
                       long x0, int size, int mode, int pred[16][16]) {
    int has_top = y0 > 0, has_left = x0 > 0;
    int top[17], left[16];
    for (int i = 0; i < size + 1; i++)
        top[i] = 127;
    if (has_top) {
        for (int i = 0; i < size; i++)
            top[1 + i] = plane[(y0 - 1) * stride + x0 + i];
        top[0] = has_left ? plane[(y0 - 1) * stride + x0 - 1] : 129;
    }
    for (int i = 0; i < size; i++)
        left[i] = has_left ? plane[(y0 + i) * stride + x0 - 1] : 129;

    if (mode == M_DC) {
        int dc = 128;
        if (has_top && has_left) {
            int s = size;
            for (int i = 0; i < size; i++)
                s += top[1 + i] + left[i];
            dc = s >> (size == 8 ? 4 : 5);
        } else if (has_top) {
            int s = size / 2;
            for (int i = 0; i < size; i++)
                s += top[1 + i];
            dc = s >> (size == 8 ? 3 : 4);
        } else if (has_left) {
            int s = size / 2;
            for (int i = 0; i < size; i++)
                s += left[i];
            dc = s >> (size == 8 ? 3 : 4);
        }
        for (int r = 0; r < size; r++)
            for (int c = 0; c < size; c++)
                pred[r][c] = dc;
    } else if (mode == M_V) {
        for (int r = 0; r < size; r++)
            for (int c = 0; c < size; c++)
                pred[r][c] = top[1 + c];
    } else if (mode == M_H) {
        for (int r = 0; r < size; r++)
            for (int c = 0; c < size; c++)
                pred[r][c] = left[r];
    } else {  /* TM */
        for (int r = 0; r < size; r++)
            for (int c = 0; c < size; c++)
                pred[r][c] = cl255(left[r] + top[1 + c] - top[0]);
    }
}

static void pred_b4(const uint8_t *Y, long stride, long W, long by,
                    long bx, int my, int mx, int sy, int sx, int mode,
                    int o[4][4]) {
    int has_top = by > 0, has_left = bx > 0;
    int t[9], left[4];
    for (int i = 0; i < 9; i++)
        t[i] = 127;
    if (has_top) {
        for (int i = 0; i < 4; i++)
            t[1 + i] = Y[(by - 1) * stride + bx + i];
        t[0] = has_left ? Y[(by - 1) * stride + bx - 1] : 129;
        if (sy == 0 || sx < 3) {
            if (bx + 4 < W)
                for (int i = 0; i < 4; i++)
                    t[5 + i] = Y[(by - 1) * stride + bx + 4 + i];
            else if (sy == 0)
                for (int i = 0; i < 4; i++)
                    t[5 + i] = Y[(by - 1) * stride + W - 1];
            else
                for (int i = 0; i < 4; i++)
                    t[5 + i] = Y[(by - 1) * stride + bx + 4 + i];
        } else {
            long ty = (long)my * 16 - 1;
            if (ty >= 0) {
                long txe = (long)mx * 16 + 16;
                if (txe + 4 <= W)
                    for (int i = 0; i < 4; i++)
                        t[5 + i] = Y[ty * stride + txe + i];
                else
                    for (int i = 0; i < 4; i++)
                        t[5 + i] = Y[ty * stride + W - 1];
            }
        }
    }
    for (int i = 0; i < 4; i++)
        left[i] = has_left ? Y[(by + i) * stride + bx - 1] : 129;

    int X = t[0], A = t[1], B = t[2], C = t[3], D = t[4];
    int E = t[5], F = t[6], G = t[7], Hh = t[8];
    int I = left[0], J = left[1], K = left[2], L = left[3];

    switch (mode) {
    case B_DC: {
        int dc = (A + B + C + D + I + J + K + L + 4) >> 3;
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                o[r][c] = dc;
        break;
    }
    case B_TM:
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                o[r][c] = cl255(left[r] + t[1 + c] - X);
        break;
    case B_VE: {
        int row[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                      avg3(C, D, E)};
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                o[r][c] = row[c];
        break;
    }
    case B_HE: {
        int col[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                      avg3(K, L, L)};
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                o[r][c] = col[r];
        break;
    }
    case B_LD: {
        int s[7] = {avg3(A, B, C), avg3(B, C, D), avg3(C, D, E),
                    avg3(D, E, F), avg3(E, F, G), avg3(F, G, Hh),
                    avg3(G, Hh, Hh)};
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                o[r][c] = s[r + c];
        break;
    }
    case B_RD:
        o[3][0] = avg3(J, K, L);
        o[3][1] = o[2][0] = avg3(I, J, K);
        o[3][2] = o[2][1] = o[1][0] = avg3(X, I, J);
        o[3][3] = o[2][2] = o[1][1] = o[0][0] = avg3(A, X, I);
        o[2][3] = o[1][2] = o[0][1] = avg3(B, A, X);
        o[1][3] = o[0][2] = avg3(C, B, A);
        o[0][3] = avg3(D, C, B);
        break;
    case B_VR:
        o[0][0] = o[2][1] = avg2(X, A);
        o[0][1] = o[2][2] = avg2(A, B);
        o[0][2] = o[2][3] = avg2(B, C);
        o[0][3] = avg2(C, D);
        o[3][0] = avg3(K, J, I);
        o[2][0] = avg3(J, I, X);
        o[1][0] = o[3][1] = avg3(I, X, A);
        o[1][1] = o[3][2] = avg3(X, A, B);
        o[1][2] = o[3][3] = avg3(A, B, C);
        o[1][3] = avg3(B, C, D);
        break;
    case B_VL:
        o[0][0] = avg2(A, B);
        o[0][1] = o[2][0] = avg2(B, C);
        o[0][2] = o[2][1] = avg2(C, D);
        o[0][3] = o[2][2] = avg2(D, E);
        o[1][0] = avg3(A, B, C);
        o[1][1] = o[3][0] = avg3(B, C, D);
        o[1][2] = o[3][1] = avg3(C, D, E);
        o[1][3] = o[3][2] = avg3(D, E, F);
        o[2][3] = avg3(E, F, G);
        o[3][3] = avg3(F, G, Hh);
        break;
    case B_HD:
        o[0][0] = o[1][2] = avg2(I, X);
        o[1][0] = o[2][2] = avg2(J, I);
        o[2][0] = o[3][2] = avg2(K, J);
        o[3][0] = avg2(L, K);
        o[0][3] = avg3(A, B, C);
        o[0][2] = avg3(X, A, B);
        o[0][1] = o[1][3] = avg3(I, X, A);
        o[1][1] = o[2][3] = avg3(X, I, J);
        o[2][1] = o[3][3] = avg3(I, J, K);
        o[3][1] = avg3(J, K, L);
        break;
    default:  /* B_HU */
        o[0][0] = avg2(I, J);
        o[0][1] = avg3(I, J, K);
        o[0][2] = o[1][0] = avg2(J, K);
        o[0][3] = o[1][1] = avg3(J, K, L);
        o[1][2] = o[2][0] = avg2(K, L);
        o[1][3] = o[2][1] = avg3(K, L, L);
        o[2][2] = o[2][3] = L;
        o[3][0] = o[3][1] = o[3][2] = o[3][3] = L;
        break;
    }
}

static void recon_mb(uint8_t *Y, uint8_t *U, uint8_t *V,
                     long ys, long cs, int my, int mx,
                     const int16_t *res, int ym,
                     const int32_t *bm, int uvm) {
    {
        {
            long y0 = (long)my * 16, x0 = (long)mx * 16;
            if (ym != M_BPRED) {
                int pred[16][16];
                pred_whole(Y, ys, y0, x0, 16, ym, pred);
                for (int b = 0; b < 16; b++) {
                    const int16_t *r = res + b * 16;
                    int by = (b >> 2) * 4, bx = (b & 3) * 4;
                    for (int i = 0; i < 4; i++)
                        for (int j = 0; j < 4; j++)
                            Y[(y0 + by + i) * ys + x0 + bx + j] =
                                (uint8_t)cl255(pred[by + i][bx + j]
                                               + r[i * 4 + j]);
                }
            } else {
                for (int b = 0; b < 16; b++) {
                    int sy = b >> 2, sx = b & 3;
                    long by = y0 + sy * 4, bx = x0 + sx * 4;
                    int o[4][4];
                    pred_b4(Y, ys, ys, by, bx, my, mx, sy, sx,
                            bm[b], o);
                    const int16_t *r = res + b * 16;
                    for (int i = 0; i < 4; i++)
                        for (int j = 0; j < 4; j++)
                            Y[(by + i) * ys + bx + j] =
                                (uint8_t)cl255(o[i][j] + r[i * 4 + j]);
                }
            }
            /* chroma */
            long cy0 = (long)my * 8, cx0 = (long)mx * 8;
            uint8_t *planes[2] = {U, V};
            for (int pi = 0; pi < 2; pi++) {
                int pred[16][16];
                pred_whole(planes[pi], cs, cy0, cx0, 8, uvm, pred);
                const int16_t *cres = res + (16 + 4 * pi) * 16;
                for (int b = 0; b < 4; b++) {
                    const int16_t *r = cres + b * 16;
                    int by = (b >> 1) * 4, bx = (b & 1) * 4;
                    for (int i = 0; i < 4; i++)
                        for (int j = 0; j < 4; j++)
                            planes[pi][(cy0 + by + i) * cs + cx0 + bx + j]
                                = (uint8_t)cl255(pred[by + i][bx + j]
                                                 + r[i * 4 + j]);
                }
            }
        }
    }
}

FFPIC_API void ffpic_vp8_recon(
    uint8_t *Y, uint8_t *U, uint8_t *V,
    const int16_t *residual,      /* (mbh,mbw,24,4,4) */
    const int32_t *ymode, const int32_t *bmodes,  /* (mbh,mbw,16) */
    const int32_t *uvmode, int mbh, int mbw) {
    long ys = (long)mbw * 16, cs = (long)mbw * 8;
    for (int my = 0; my < mbh; my++)
        for (int mx = 0; mx < mbw; mx++) {
            long mb = (long)my * mbw + mx;
            recon_mb(Y, U, V, ys, cs, my, mx, residual + mb * 24 * 16,
                     ymode[mb], bmodes + mb * 16, uvmode[mb]);
        }
}

/* Fused residual-transform + reconstruction: one MB walk, residuals
 * in a stack buffer, no whole-image int16 intermediate. */
FFPIC_API void ffpic_vp8_recon_fused(
    uint8_t *Y, uint8_t *U, uint8_t *V,
    const int32_t *levels,        /* (mbh,mbw,25,16) raw levels */
    const int32_t *nnz,           /* (mbh,mbw,25) */
    const int32_t *dq,            /* (4,6) */
    const int32_t *seg,           /* (mbh,mbw) or NULL */
    const uint8_t *has_y2,
    const int32_t *ymode, const int32_t *bmodes,
    const int32_t *uvmode, int mbh, int mbw) {
    long ys = (long)mbw * 16, cs = (long)mbw * 8;
    for (int my = 0; my < mbh; my++)
        for (int mx = 0; mx < mbw; mx++) {
            long mb = (long)my * mbw + mx;
            int16_t res[24 * 16];
            mb_residual(levels + mb * 25 * 16, nnz + mb * 25,
                        dq + (seg ? seg[mb] : 0) * 6, has_y2[mb], res);
            recon_mb(Y, U, V, ys, cs, my, mx, res,
                     ymode[mb], bmodes + mb * 16, uvmode[mb]);
        }
}

/* ---------------- residual stage: dequant + IWHT + 4x4 IDCT ----------
 *
 * Exact mirror of ops/golden.py vp8_idct4x4 / vp8_iwht4x4 (themselves
 * ports of utils/idct.c:121-150 and format/webp.c:1067-1096) with the
 * zero-block and DC-only fast paths libwebp uses: blocks with no
 * coded coefficients skip the transform entirely, DC-only blocks
 * flat-fill (dc+4)>>3.  This is the default host path; the
 * FFPIC_VP8_DEVICE route runs the same function over the whole frame on
 * the GPU (ffpic_tpu_torch/csrc/vp8_decode.cu, vp8_residuals).
 */

static inline int16_t w16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }

static void vp8_idct4x4_c(const int32_t in[16], int16_t out[16]) {
    int32_t tmp[16];
    const int32_t c1 = 20091, c2 = 35468;
    for (int x = 0; x < 4; x++) {
        int32_t i0 = in[x], i1 = in[4 + x], i2 = in[8 + x], i3 = in[12 + x];
        int32_t a0 = i0 + i2;
        int32_t a1 = i0 - i2;
        int32_t a2 = ((i1 * c2) >> 16) - i3 - ((i3 * c1) >> 16);
        int32_t a3 = i1 + ((i1 * c1) >> 16) + ((i3 * c2) >> 16);
        tmp[x] = w16(a0 + a3);
        tmp[12 + x] = w16(a0 - a3);
        tmp[4 + x] = w16(a1 + a2);
        tmp[8 + x] = w16(a1 - a2);
    }
    for (int r = 0; r < 4; r++) {
        int32_t j0 = tmp[r * 4], j1 = tmp[r * 4 + 1], j2 = tmp[r * 4 + 2],
                j3 = tmp[r * 4 + 3];
        int32_t a0 = j0 + j2;
        int32_t a1 = j0 - j2;
        int32_t a2 = ((j1 * c2) >> 16) - j3 - ((j3 * c1) >> 16);
        int32_t a3 = j1 + ((j1 * c1) >> 16) + ((j3 * c2) >> 16);
        out[r * 4] = w16((a0 + a3 + 4) >> 3);
        out[r * 4 + 3] = w16((a0 - a3 + 4) >> 3);
        out[r * 4 + 1] = w16((a1 + a2 + 4) >> 3);
        out[r * 4 + 2] = w16((a1 - a2 + 4) >> 3);
    }
}

static void vp8_iwht4x4_c(const int32_t in[16], int32_t out[16]) {
    int32_t tmp[16];
    for (int x = 0; x < 4; x++) {
        int32_t a1 = in[x] + in[12 + x];
        int32_t b1 = in[4 + x] + in[8 + x];
        int32_t c1 = in[4 + x] - in[8 + x];
        int32_t d1 = in[x] - in[12 + x];
        tmp[x] = a1 + b1;
        tmp[4 + x] = c1 + d1;
        tmp[8 + x] = a1 - b1;
        tmp[12 + x] = d1 - c1;
    }
    for (int r = 0; r < 4; r++) {
        int32_t j0 = tmp[r * 4], j1 = tmp[r * 4 + 1], j2 = tmp[r * 4 + 2],
                j3 = tmp[r * 4 + 3];
        int32_t a1 = j0 + j3;
        int32_t b1 = j1 + j2;
        int32_t c1 = j1 - j2;
        int32_t d1 = j0 - j3;
        out[r * 4] = w16((a1 + b1 + 3) >> 3);
        out[r * 4 + 1] = w16((c1 + d1 + 3) >> 3);
        out[r * 4 + 2] = w16((a1 - b1 + 3) >> 3);
        out[r * 4 + 3] = w16((d1 - c1 + 3) >> 3);
    }
}

FFPIC_API void ffpic_vp8_residuals(
    const int32_t *levels,        /* (mbh,mbw,25,16) raw levels */
    const int32_t *nnz,           /* (mbh,mbw,25) */
    const int32_t *dq,            /* (4,6) y1dc,y1ac,y2dc,y2ac,uvdc,uvac */
    const int32_t *seg,           /* (mbh,mbw) or NULL when !seg_enabled */
    const uint8_t *has_y2,        /* (mbh,mbw) */
    int mbh, int mbw,
    int16_t *out) {               /* (mbh,mbw,24,4,4) */
    for (long mb = 0; mb < (long)mbh * mbw; mb++)
        mb_residual(levels + mb * 25 * 16, nnz + mb * 25,
                    dq + (seg ? seg[mb] : 0) * 6, has_y2[mb],
                    out + mb * 24 * 16);
}

/* ---------------- coefficient-probability update parse ---------------
 *
 * RFC 6386 §13.4: 4*8*3*11 conditional 8-bit updates at the start of
 * the first partition — ~1000 bool reads that dominate the Python
 * control-partition parse.  Resumes/returns the bool-decoder state
 * like ffpic_vp8_mb_headers.
 */
FFPIC_API void ffpic_vp8_coeff_probs(
    const uint8_t *part0, long len,
    long *pos, uint32_t *value, uint32_t *range, int *bit_count,
    const uint8_t *update_probs,   /* (4,8,3,11) */
    uint8_t *probs) {              /* (4,8,3,11) in/out */
    VP8Bool b;
    b.data = part0;
    b.len = len;
    b.pos = *pos;
    b.value = *value;
    b.range = *range;
    b.bit_count = *bit_count;
    for (int i = 0; i < 4 * 8 * 3 * 11; i++) {
        if (bd_bool(&b, update_probs[i])) {
            int v = 0;
            for (int k = 0; k < 8; k++)
                v = (v << 1) | bd_bool(&b, 128);
            probs[i] = (uint8_t)v;
        }
    }
    *pos = b.pos;
    *value = b.value;
    *range = b.range;
    *bit_count = b.bit_count;
}

/* Per-MB residual transform into a stack buffer (same math as
 * ffpic_vp8_residuals, fused into the recon walk below to skip the
 * whole-image int16 intermediate). */
static void mb_residual(const int32_t *lv, const int32_t *nz,
                        const int32_t *d, int hy2, int16_t res[24 * 16]) {
    int32_t dc16[16];
    if (hy2) {
        int32_t y2[16];
        y2[0] = lv[24 * 16] * d[2];
        for (int i = 1; i < 16; i++)
            y2[i] = lv[24 * 16 + i] * d[3];
        if (nz[24] > 0 || y2[0] != 0) {
            vp8_iwht4x4_c(y2, dc16);
        } else {
            for (int i = 0; i < 16; i++)
                dc16[i] = 0;
        }
    }
    for (int b = 0; b < 24; b++) {
        const int32_t *l = lv + b * 16;
        int16_t *r = res + b * 16;
        int is_y = b < 16;
        int32_t dcq = is_y ? d[0] : d[4];
        int32_t acq = is_y ? d[1] : d[5];
        int32_t blk[16];
        int32_t dc = (is_y && hy2) ? dc16[b] : l[0] * dcq;
        if (nz[b] <= 1) {
            if (dc == 0) {
                for (int i = 0; i < 16; i++)
                    r[i] = 0;
            } else {
                int16_t v = w16(((int32_t)w16(dc) + 4) >> 3);
                for (int i = 0; i < 16; i++)
                    r[i] = v;
            }
            continue;
        }
        blk[0] = dc;
        for (int i = 1; i < 16; i++)
            blk[i] = l[i] * acq;
        vp8_idct4x4_c(blk, r);
    }
}

/* ---------------- MB-header parse (RFC 6386 §11) ---------------------
 *
 * Continues the first-partition bool decoder from the state Python's
 * control parse left it in; mirrors formats/vp8.py _parse_mb_headers
 * (segment ids, skip flags, kf y/uv modes, B_PRED sub-modes with
 * above/left context).
 */

static inline int bd_tree(VP8Bool *b, const int8_t *tree,
                          const uint8_t *probs) {
    int i = 0;
    for (;;) {
        i = tree[i + bd_bool(b, probs[i >> 1])];
        if (i <= 0)
            return -i;
    }
}

static const int8_t KF_YMODE_TREE[8] = {-4, 2, 4, 6, 0, -1, -2, -3};
static const uint8_t KF_YMODE_PROBS[4] = {145, 156, 163, 128};
static const int8_t BMODE_TREE[18] = {0, 2, -1, 4, -2, 6, 8, 12, -3,
                                      10, -4, -5, -6, 14, -7, 16, -8,
                                      -9};
static const int8_t UV_MODE_TREE[6] = {0, 2, -1, 4, -2, -3};
static const uint8_t KF_UV_MODE_PROBS[3] = {142, 114, 183};
static const int8_t SEGMENT_TREE[6] = {2, 4, 0, -1, -2, -3};
static const int8_t MODE2B[4] = {0, 2, 3, 1};   /* DC,V,H,TM -> B_* */
#define VP8_B_PRED 4

FFPIC_API void ffpic_vp8_mb_headers(
    const uint8_t *part0, long len,
    long pos, uint32_t value, uint32_t range, int bit_count,
    int mbh, int mbw,
    int seg_update, const uint8_t *seg_probs,
    int mb_no_skip, int prob_skip,
    const uint8_t *kf_bmode_probs,       /* (10,10,9) */
    int32_t *seg, int32_t *skip, int32_t *ymode, int32_t *uvmode,
    int32_t *bmodes) {                   /* (mbh,mbw,16) */
    VP8Bool b;
    b.data = part0;
    b.len = len;
    b.pos = pos;
    b.value = value;
    b.range = range;
    b.bit_count = bit_count;

    int32_t *above_b = malloc(sizeof(int32_t) * mbw * 4);
    int32_t left_b[4];
    for (int i = 0; i < mbw * 4; i++)
        above_b[i] = 0;                  /* B_DC */
    for (int my = 0; my < mbh; my++) {
        for (int i = 0; i < 4; i++)
            left_b[i] = 0;
        for (int mx = 0; mx < mbw; mx++) {
            long mb = (long)my * mbw + mx;
            if (seg_update)
                seg[mb] = bd_tree(&b, SEGMENT_TREE, seg_probs);
            if (mb_no_skip)
                skip[mb] = bd_bool(&b, prob_skip);
            int ym = bd_tree(&b, KF_YMODE_TREE, KF_YMODE_PROBS);
            ymode[mb] = ym;
            int32_t *bm = bmodes + mb * 16;
            if (ym == VP8_B_PRED) {
                for (int sy = 0; sy < 4; sy++) {
                    for (int sx = 0; sx < 4; sx++) {
                        int a = sy == 0 ? above_b[mx * 4 + sx]
                                        : bm[(sy - 1) * 4 + sx];
                        int l = sx == 0 ? left_b[sy]
                                        : bm[sy * 4 + sx - 1];
                        bm[sy * 4 + sx] = bd_tree(
                            &b, BMODE_TREE,
                            kf_bmode_probs + (a * 10 + l) * 9);
                    }
                }
            } else {
                for (int i = 0; i < 16; i++)
                    bm[i] = MODE2B[ym];
            }
            for (int sx = 0; sx < 4; sx++)
                above_b[mx * 4 + sx] = bm[12 + sx];
            for (int sy = 0; sy < 4; sy++)
                left_b[sy] = bm[sy * 4 + 3];
            uvmode[mb] = bd_tree(&b, UV_MODE_TREE, KF_UV_MODE_PROBS);
        }
    }
    free(above_b);
}

/* libwebp-exact YUV420 -> RGBA on the host (upsampling.c 'fancy'
 * diamond blend + yuv.h fixed-point matrix, bit-identical to the
 * numpy oracle in formats/webp.py).  The default colour of a load;
 * FFPIC_VP8_DEVICE_COLOR runs the same function on the GPU
 * (ffpic_tpu_torch/csrc/vp8_decode.cu, vp8_yuv_to_rgba). */
__attribute__((visibility("default")))
void vp8_color_libwebp(const unsigned char *Y, long y_stride,
                       const unsigned char *U,
                       const unsigned char *V, long c_stride,
                       int H, int W, const unsigned char *A,
                       unsigned char *rgba)
{
    int ch = (H + 1) >> 1, cw = (W + 1) >> 1;
    for (int y = 0; y < H; y++) {
        int cy = y >> 1;
        int oy = (y & 1) ? (cy + 1 < ch ? cy + 1 : ch - 1)
                         : (cy > 0 ? cy - 1 : 0);
        const unsigned char *u0 = U + (long)cy * c_stride;
        const unsigned char *u1 = U + (long)oy * c_stride;
        const unsigned char *v0 = V + (long)cy * c_stride;
        const unsigned char *v1 = V + (long)oy * c_stride;
        const unsigned char *yr = Y + (long)y * y_stride;
        unsigned char *out = rgba + (long)y * W * 4;
        for (int x = 0; x < W; x++) {
            int cx = x >> 1;
            int ox = (x & 1) ? (cx + 1 < cw ? cx + 1 : cw - 1)
                             : (cx > 0 ? cx - 1 : 0);
            int u = (9 * u0[cx] + 3 * (u1[cx] + u0[ox]) + u1[ox] + 8)
                    >> 4;
            int v = (9 * v0[cx] + 3 * (v1[cx] + v0[ox]) + v1[ox] + 8)
                    >> 4;
            int yv = (yr[x] * 19077) >> 8;
            int r = (yv + ((v * 26149) >> 8) - 14234) >> 6;
            int g = (yv - ((u * 6419) >> 8) - ((v * 13320) >> 8)
                     + 8708) >> 6;
            int b = (yv + ((u * 33050) >> 8) - 17685) >> 6;
            out[x * 4 + 0] = r < 0 ? 0 : (r > 255 ? 255 : r);
            out[x * 4 + 1] = g < 0 ? 0 : (g > 255 ? 255 : g);
            out[x * 4 + 2] = b < 0 ? 0 : (b > 255 ? 255 : b);
            out[x * 4 + 3] = A ? A[(long)y * W + x] : 255;
        }
    }
}
