/* Lane-major batched AV1 inverse transforms (spec 7.13.3).
 *
 * 1:1 port of the numpy int32 lane path in coding/av1_itx.py
 * (inverse_transform_batch): lane = one row/column of one TU of a
 * same-(tx_size, tx_type, lossless) group, data is POSITION-major
 * (position i of every lane is contiguous) so every butterfly /
 * rotation is a long unit-stride loop the compiler vectorizes.
 *
 * Bit-exactness contract: the numpy path computes in int32 with
 * two's-complement wraparound; the build has no -fwrapv, so every
 * add/sub/mul here goes through uint32 helpers (defined wrap) and
 * shifts stay on int32 (arithmetic).  Intermediates never overflow
 * for conforming <=10-bit streams (dav1d's int32 production parity,
 * see av1_itx.py), but fuzzed streams must match the numpy oracle
 * too, hence the explicit wrap semantics.
 *
 * The C reference (junka/ffpic) has no AV1 decode layer
 * (avif.c:382-405 stub); networks were validated against dav1d YUV
 * output via the Python oracle this file mirrors
 * (tests/test_av1_itx.py differential suite).
 *
 * Copied from ffpic_tpu/native/host_av1_itx.c (av1_itx_batch,
 * av1_wht_batch) unchanged.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

static inline int32_t m32(int32_t a, int32_t b)
{
    return (int32_t)((uint32_t)a * (uint32_t)b);
}
static inline int32_t a32(int32_t a, int32_t b)
{
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
static inline int32_t s32(int32_t a, int32_t b)
{
    return (int32_t)((uint32_t)a - (uint32_t)b);
}
static inline int32_t r2v(int32_t v)
{
    return a32(v, 2048) >> 12;
}
static inline int32_t clipv(int32_t v, int32_t lo, int32_t hi)
{
    return v < lo ? lo : (v > hi ? hi : v);
}

/* cos128/sin128 from the 65-entry quarter-wave table passed in from
 * the Python single source of truth (av1_consts.COS128_TABLE). */
static inline int32_t c128(const int32_t *T, int ang)
{
    ang &= 255;
    if (ang <= 64) return T[ang];
    if (ang <= 128) return -T[128 - ang];
    if (ang <= 192) return -T[ang - 128];
    return T[256 - ang];
}
static inline int32_t s128(const int32_t *T, int ang)
{
    return c128(T, ang - 64);
}

static int brevi(int x, int bits)
{
    int out = 0;
    for (int i = 0; i < bits; i++) {
        out = (out << 1) | (x & 1);
        x >>= 1;
    }
    return out;
}

static int bitlen(int v)
{
    int n = 0;
    while (v) { n++; v >>= 1; }
    return n;
}

/* ---------------------------------------------------------- DCT odd */
/* Odd half-network of the inverse DCT (av1_itx.py _idct_odd):
 * xin = M positions x L lanes (the odd-index inputs), o = output. */
static void idct_odd_lanes(const int32_t *T, const int32_t *xin,
                           int32_t *o, int M, long L,
                           int32_t lo, int32_t hi)
{
    int cnt = M >> 1;
    int bits = bitlen(cnt) - 1;
    if (bits < 0) bits = 0;
    int N = 2 * M;
    for (int j = 0; j < cnt; j++) {
        int m = 1 + 4 * brevi(j, bits);
        int ang = 64 - m * (128 / (2 * N));
        const int32_t *a = xin + (long)((m - 1) >> 1) * L;
        const int32_t *b = xin + (long)((N - m - 1) >> 1) * L;
        int32_t c = c128(T, ang), s = s128(T, ang);
        int32_t *oj = o + (long)j * L;
        int32_t *om = o + (long)(M - 1 - j) * L;
        for (long k = 0; k < L; k++) {
            int32_t va = a[k], vb = b[k];
            oj[k] = r2v(s32(m32(va, c), m32(vb, s)));
            om[k] = r2v(a32(m32(va, s), m32(vb, c)));
        }
    }
    int levels = bitlen(M) - 1;          /* log2(M) */
    for (int Lv = 1; Lv < levels; Lv++) {
        int g_sz = 1 << Lv;
        for (int g = 0; g < (M >> Lv); g++) {
            int base = g * g_sz;
            for (int i = 0; i < (g_sz >> 1); i++) {
                int32_t *pa = o + (long)(base + i) * L;
                int32_t *pb = o + (long)(base + g_sz - 1 - i) * L;
                if (g & 1)
                    for (long k = 0; k < L; k++) {
                        int32_t va = pa[k], vb = pb[k];
                        pa[k] = clipv(s32(vb, va), lo, hi);
                        pb[k] = clipv(a32(vb, va), lo, hi);
                    }
                else
                    for (long k = 0; k < L; k++) {
                        int32_t va = pa[k], vb = pb[k];
                        pa[k] = clipv(a32(va, vb), lo, hi);
                        pb[k] = clipv(s32(va, vb), lo, hi);
                    }
            }
        }
        if (Lv < levels - 1) {
            /* rotation round (av1_itx.py _odd_rot_rounds[Lv-1]) */
            int run = 1 << (Lv - 1);
            int span = 1 << (Lv + 1);
            int Mb = M >> (Lv + 1);      /* _initial_angles arg */
            int bcnt = Mb >> 1;
            int bbits = bitlen(bcnt) - 1;
            if (bbits < 0) bbits = 0;
            for (int q = 0; q < (M >> (Lv + 2)); q++) {
                int ang0 = 64 - (1 + 4 * brevi(q, bbits)) * (32 / Mb);
                int start = q * span + run;
                for (int half = 0; half < 2; half++) {
                    int ang = ang0 + 64 * half;
                    int32_t c = c128(T, ang), s = s128(T, ang);
                    for (int k2 = 0; k2 < run; k2++) {
                        int i = start + half * run + k2;
                        int j = M - 1 - i;
                        int32_t *pi = o + (long)i * L;
                        int32_t *pj = o + (long)j * L;
                        for (long k = 0; k < L; k++) {
                            int32_t va = pi[k], vb = pj[k];
                            pi[k] = r2v(s32(m32(vb, c), m32(va, s)));
                            pj[k] = r2v(a32(m32(vb, s), m32(va, c)));
                        }
                    }
                }
            }
        } else {
            for (int i = M >> 2; i < (M >> 1); i++) {
                int j = M - 1 - i;
                int32_t *pi = o + (long)i * L;
                int32_t *pj = o + (long)j * L;
                for (long k = 0; k < L; k++) {
                    int32_t va = pi[k], vb = pj[k];
                    pi[k] = r2v(m32(s32(vb, va), 2896));
                    pj[k] = r2v(m32(a32(vb, va), 2896));
                }
            }
        }
    }
}

/* --------------------------------------------------------------- DCT */
/* In-place inverse DCT over n positions x L lanes; scr needs
 * 3*(n/2)*L per level (< 3*n*L total). */
static void idct_lanes(const int32_t *T, int32_t *x, int n, long L,
                       int32_t lo, int32_t hi, int32_t *scr)
{
    if (n == 4) {
        int32_t *p0 = x, *p1 = x + L, *p2 = x + 2 * L, *p3 = x + 3 * L;
        for (long k = 0; k < L; k++) {
            int32_t in0 = p0[k], in1 = p1[k], in2 = p2[k], in3 = p3[k];
            int32_t t0 = r2v(m32(a32(in0, in2), 2896));
            int32_t t1 = r2v(m32(s32(in0, in2), 2896));
            int32_t t2 = r2v(s32(m32(in1, 1567), m32(in3, 3784)));
            int32_t t3 = r2v(a32(m32(in1, 3784), m32(in3, 1567)));
            p0[k] = clipv(a32(t0, t3), lo, hi);
            p1[k] = clipv(a32(t1, t2), lo, hi);
            p2[k] = clipv(s32(t1, t2), lo, hi);
            p3[k] = clipv(s32(t0, t3), lo, hi);
        }
        return;
    }
    int h = n >> 1;
    int32_t *e = scr;
    int32_t *oin = scr + (long)h * L;
    int32_t *o = scr + 2L * h * L;
    int32_t *scr2 = scr + 3L * h * L;
    for (int i = 0; i < h; i++) {
        memcpy(e + (long)i * L, x + (long)(2 * i) * L,
               (size_t)L * 4);
        memcpy(oin + (long)i * L, x + (long)(2 * i + 1) * L,
               (size_t)L * 4);
    }
    idct_lanes(T, e, h, L, lo, hi, scr2);
    idct_odd_lanes(T, oin, o, h, L, lo, hi);
    for (int i = 0; i < h; i++) {
        const int32_t *pe = e + (long)i * L;
        const int32_t *po = o + (long)(h - 1 - i) * L;
        int32_t *xa = x + (long)i * L;
        int32_t *xb = x + (long)(n - 1 - i) * L;
        for (long k = 0; k < L; k++) {
            int32_t ve = pe[k], vo = po[k];
            xa[k] = clipv(a32(ve, vo), lo, hi);
            xb[k] = clipv(s32(ve, vo), lo, hi);
        }
    }
}

/* -------------------------------------------------------------- ADST */
static void adst4_lanes(int32_t *x, long L)
{
    int32_t *p0 = x, *p1 = x + L, *p2 = x + 2 * L, *p3 = x + 3 * L;
    for (long k = 0; k < L; k++) {
        int32_t x0 = p0[k], x1 = p1[k], x2 = p2[k], x3 = p3[k];
        int32_t s0 = m32(1321, x0), s1 = m32(2482, x0);
        int32_t s2 = m32(3344, x1), s3 = m32(3803, x2);
        int32_t s4 = m32(1321, x2), s5 = m32(2482, x3);
        int32_t s6 = m32(3803, x3);
        int32_t b7 = a32(s32(x0, x2), x3);
        s0 = a32(s0, s3);
        s1 = s32(s1, s4);
        int32_t ns3 = s2;
        s2 = m32(3344, b7);
        s0 = a32(s0, s5);
        s1 = s32(s1, s6);
        p0[k] = r2v(a32(s0, ns3));
        p1[k] = r2v(a32(s1, ns3));
        p2[k] = r2v(s2);
        p3[k] = r2v(s32(a32(s0, s1), ns3));
    }
}

static void adst8_lanes(const int32_t *T, int32_t *x, long L,
                        int32_t lo, int32_t hi)
{
    int32_t c4 = c128(T, 4), n4 = s128(T, 4);
    int32_t c20 = c128(T, 20), n20 = s128(T, 20);
    int32_t c36 = c128(T, 36), n36 = s128(T, 36);
    int32_t c52 = c128(T, 52), n52 = s128(T, 52);
    int32_t c16 = c128(T, 16), s16 = s128(T, 16);
    for (long k = 0; k < L; k++) {
        /* stage 1 reorder */
        int32_t x0 = x[7 * L + k], x1 = x[0 * L + k];
        int32_t x2 = x[5 * L + k], x3 = x[2 * L + k];
        int32_t x4 = x[3 * L + k], x5 = x[4 * L + k];
        int32_t x6 = x[1 * L + k], x7 = x[6 * L + k];
        /* stage 2 rotations */
        int32_t s0 = r2v(a32(m32(x0, c4), m32(x1, n4)));
        int32_t s1 = r2v(s32(m32(x0, n4), m32(x1, c4)));
        int32_t s2 = r2v(a32(m32(x2, c20), m32(x3, n20)));
        int32_t s3 = r2v(s32(m32(x2, n20), m32(x3, c20)));
        int32_t s4 = r2v(a32(m32(x4, c36), m32(x5, n36)));
        int32_t s5 = r2v(s32(m32(x4, n36), m32(x5, c36)));
        int32_t s6 = r2v(a32(m32(x6, c52), m32(x7, n52)));
        int32_t s7 = r2v(s32(m32(x6, n52), m32(x7, c52)));
        /* stage 3 butterflies span 4 */
        int32_t t0 = clipv(a32(s0, s4), lo, hi);
        int32_t t1 = clipv(a32(s1, s5), lo, hi);
        int32_t t2 = clipv(a32(s2, s6), lo, hi);
        int32_t t3 = clipv(a32(s3, s7), lo, hi);
        int32_t t4 = clipv(s32(s0, s4), lo, hi);
        int32_t t5 = clipv(s32(s1, s5), lo, hi);
        int32_t t6 = clipv(s32(s2, s6), lo, hi);
        int32_t t7 = clipv(s32(s3, s7), lo, hi);
        /* stage 4 rotations on 4..7 */
        int32_t u4 = r2v(a32(m32(t4, c16), m32(t5, s16)));
        int32_t u5 = r2v(s32(m32(t4, s16), m32(t5, c16)));
        int32_t u6 = r2v(s32(m32(t7, c16), m32(t6, s16)));
        int32_t u7 = r2v(a32(m32(t6, c16), m32(t7, s16)));
        /* stage 5 butterflies span 2 */
        int32_t v0 = clipv(a32(t0, t2), lo, hi);
        int32_t v1 = clipv(a32(t1, t3), lo, hi);
        int32_t v2 = clipv(s32(t0, t2), lo, hi);
        int32_t v3 = clipv(s32(t1, t3), lo, hi);
        int32_t v4 = clipv(a32(u4, u6), lo, hi);
        int32_t v5 = clipv(a32(u5, u7), lo, hi);
        int32_t v6 = clipv(s32(u4, u6), lo, hi);
        int32_t v7 = clipv(s32(u5, u7), lo, hi);
        /* stage 6 cos32 rotations */
        int32_t w2 = r2v(m32(a32(v2, v3), 2896));
        int32_t w3 = r2v(m32(s32(v2, v3), 2896));
        int32_t w6 = r2v(m32(a32(v6, v7), 2896));
        int32_t w7 = r2v(m32(s32(v6, v7), 2896));
        /* stage 7 output permutation with alternating negation */
        x[0 * L + k] = v0;
        x[1 * L + k] = s32(0, v4);
        x[2 * L + k] = w6;
        x[3 * L + k] = s32(0, w2);
        x[4 * L + k] = w3;
        x[5 * L + k] = s32(0, w7);
        x[6 * L + k] = v5;
        x[7 * L + k] = s32(0, v1);
    }
}

static void adst16_lanes(const int32_t *T, int32_t *x, long L,
                         int32_t lo, int32_t hi)
{
    static const int REORD[16] = {15, 0, 13, 2, 11, 4, 9, 6,
                                  7, 8, 5, 10, 3, 12, 1, 14};
    int32_t cc[8], ss[8];
    for (int k2 = 0; k2 < 8; k2++) {
        cc[k2] = c128(T, 2 + 8 * k2);
        ss[k2] = s128(T, 2 + 8 * k2);
    }
    int32_t c8 = c128(T, 8), s8 = s128(T, 8);
    int32_t c40 = c128(T, 40), s40 = s128(T, 40);
    int32_t c16 = c128(T, 16), s16 = s128(T, 16);
    for (long k = 0; k < L; k++) {
        int32_t y[16], s[16], t[16], u[16], v[16], w[16], q[16], r[16];
        for (int i = 0; i < 16; i++)
            y[i] = x[(long)REORD[i] * L + k];
        for (int k2 = 0; k2 < 8; k2++) {
            int32_t a = y[2 * k2], b = y[2 * k2 + 1];
            s[2 * k2] = r2v(a32(m32(a, cc[k2]), m32(b, ss[k2])));
            s[2 * k2 + 1] = r2v(s32(m32(a, ss[k2]), m32(b, cc[k2])));
        }
        for (int i = 0; i < 8; i++) {
            t[i] = clipv(a32(s[i], s[i + 8]), lo, hi);
            t[i + 8] = clipv(s32(s[i], s[i + 8]), lo, hi);
        }
        for (int i = 0; i < 16; i++) u[i] = t[i];
        u[8] = r2v(a32(m32(t[8], c8), m32(t[9], s8)));
        u[9] = r2v(s32(m32(t[8], s8), m32(t[9], c8)));
        u[10] = r2v(a32(m32(t[10], c40), m32(t[11], s40)));
        u[11] = r2v(s32(m32(t[10], s40), m32(t[11], c40)));
        u[12] = r2v(s32(m32(t[13], c8), m32(t[12], s8)));
        u[13] = r2v(a32(m32(t[12], c8), m32(t[13], s8)));
        u[14] = r2v(s32(m32(t[15], c40), m32(t[14], s40)));
        u[15] = r2v(a32(m32(t[14], c40), m32(t[15], s40)));
        for (int base = 0; base < 16; base += 8)
            for (int i = 0; i < 4; i++) {
                v[base + i] = clipv(a32(u[base + i], u[base + i + 4]),
                                    lo, hi);
                v[base + i + 4] = clipv(
                    s32(u[base + i], u[base + i + 4]), lo, hi);
            }
        for (int i = 0; i < 16; i++) w[i] = v[i];
        for (int base = 4; base < 16; base += 8) {
            w[base] = r2v(a32(m32(v[base], c16), m32(v[base + 1], s16)));
            w[base + 1] = r2v(s32(m32(v[base], s16),
                                  m32(v[base + 1], c16)));
            w[base + 2] = r2v(s32(m32(v[base + 3], c16),
                                  m32(v[base + 2], s16)));
            w[base + 3] = r2v(a32(m32(v[base + 2], c16),
                                  m32(v[base + 3], s16)));
        }
        for (int base = 0; base < 16; base += 4)
            for (int i = 0; i < 2; i++) {
                q[base + i] = clipv(a32(w[base + i], w[base + i + 2]),
                                    lo, hi);
                q[base + i + 2] = clipv(
                    s32(w[base + i], w[base + i + 2]), lo, hi);
            }
        for (int i = 0; i < 16; i++) r[i] = q[i];
        for (int base = 2; base < 16; base += 4) {
            r[base] = r2v(m32(a32(q[base], q[base + 1]), 2896));
            r[base + 1] = r2v(m32(s32(q[base], q[base + 1]), 2896));
        }
        x[0 * L + k] = r[0];
        x[1 * L + k] = s32(0, r[8]);
        x[2 * L + k] = r[12];
        x[3 * L + k] = s32(0, r[4]);
        x[4 * L + k] = r[6];
        x[5 * L + k] = s32(0, r[14]);
        x[6 * L + k] = r[10];
        x[7 * L + k] = s32(0, r[2]);
        x[8 * L + k] = r[3];
        x[9 * L + k] = s32(0, r[11]);
        x[10 * L + k] = r[15];
        x[11 * L + k] = s32(0, r[7]);
        x[12 * L + k] = r[5];
        x[13 * L + k] = s32(0, r[13]);
        x[14 * L + k] = r[9];
        x[15 * L + k] = s32(0, r[1]);
    }
}

/* ---------------------------------------------------------- identity */
static void identity_lanes(int32_t *x, int n, long L)
{
    long total = (long)n * L;
    if (n == 4)
        for (long k = 0; k < total; k++) x[k] = r2v(m32(x[k], 5793));
    else if (n == 8)
        for (long k = 0; k < total; k++) x[k] = m32(x[k], 2);
    else if (n == 16)
        for (long k = 0; k < total; k++)
            x[k] = r2v(m32(m32(x[k], 2), 5793));
    else
        for (long k = 0; k < total; k++) x[k] = m32(x[k], 4);
}

/* kind codes match av1_itx.py: 0=DCT 1=ADST 2=FLIPADST 3=IDENTITY */
static void apply_1d(const int32_t *T, int kind, int32_t *x, int n,
                     long L, int32_t lo, int32_t hi, int32_t *scr)
{
    if (kind == 0) idct_lanes(T, x, n, L, lo, hi, scr);
    else if (kind == 3) identity_lanes(x, n, L);
    else if (n == 4) adst4_lanes(x, L);
    else if (n == 8) adst8_lanes(T, x, L, lo, hi);
    else adst16_lanes(T, x, L, lo, hi);
}

/* ----------------------------------------------------------- driver */
/* coeffs: (B, ah, aw) int32 C-contiguous; out: (B, h, w) int32.
 * Returns 0 on success, -1 on allocation failure. */
EXPORT int av1_itx_batch(const int32_t *coeffs, long B,
                         int aw, int ah, int w, int h,
                         int hk, int vk, int rect2, int row_shift,
                         int32_t rlo, int32_t rhi,
                         int32_t clo, int32_t chi,
                         const int32_t *cos_tab, int32_t *out)
{
    long Lr = B * ah, Lc = B * w;
    long row_sz = (long)w * Lr, col_sz = (long)h * Lc;
    long scr_sz = 3L * (row_sz > col_sz ? row_sz : col_sz);
    int32_t *mem = malloc((size_t)(row_sz + col_sz + scr_sz) * 4);
    if (!mem) return -1;
    int32_t *rowbuf = mem;
    int32_t *colbuf = mem + row_sz;
    int32_t *scr = colbuf + col_sz;

    /* transpose-load to position-major; positions >= aw are zero */
    for (long ldx = 0; ldx < Lr; ldx++) {
        const int32_t *src = coeffs + ldx * aw;
        for (int c = 0; c < aw; c++)
            rowbuf[(long)c * Lr + ldx] = src[c];
    }
    if (w > aw)
        memset(rowbuf + (long)aw * Lr, 0,
               (size_t)(w - aw) * Lr * 4);
    /* rect-2 scaling + row clamp (zero positions map to zero) */
    long live = (long)aw * Lr;
    if (rect2)
        for (long k = 0; k < live; k++)
            rowbuf[k] = r2v(m32(rowbuf[k], 2896));
    for (long k = 0; k < live; k++)
        rowbuf[k] = clipv(rowbuf[k], rlo, rhi);
    apply_1d(cos_tab, hk, rowbuf, w, Lr, rlo, rhi, scr);
    if (row_shift) {
        int32_t add = 1 << (row_shift - 1);
        for (long k = 0; k < row_sz; k++)
            rowbuf[k] = a32(rowbuf[k], add) >> row_shift;
    }

    /* re-lane: column pass lanes are (b, c); rows >= ah are zero */
    memset(colbuf, 0, (size_t)col_sz * 4);
    for (long b = 0; b < B; b++)
        for (int c = 0; c < w; c++) {
            const int32_t *src = rowbuf + (long)c * Lr + b * ah;
            int32_t *dst = colbuf + b * w + c;
            for (int r = 0; r < ah; r++)
                dst[(long)r * Lc] = clipv(src[r], clo, chi);
        }
    apply_1d(cos_tab, vk, colbuf, h, Lc, clo, chi, scr);

    /* final shift + flips into (B, h, w) */
    int hflip = (hk == 2), vflip = (vk == 2);
    for (long b = 0; b < B; b++)
        for (int r = 0; r < h; r++) {
            const int32_t *src = colbuf + (long)r * Lc + b * w;
            int rr = vflip ? h - 1 - r : r;
            int32_t *dst = out + (b * (long)h + rr) * w;
            if (hflip)
                for (int c = 0; c < w; c++)
                    dst[w - 1 - c] = a32(src[c], 8) >> 4;
            else
                for (int c = 0; c < w; c++)
                    dst[c] = a32(src[c], 8) >> 4;
        }
    free(mem);
    return 0;
}

/* Lossless 4x4 inverse Walsh-Hadamard batch (av1_itx.py inv_wht4x4):
 * python-int arithmetic (no wrap) -> int64 locals are exact. */
EXPORT void av1_wht_batch(const int32_t *coeffs, long B, int32_t *out)
{
    for (long b = 0; b < B; b++) {
        const int32_t *src = coeffs + b * 16;
        int32_t *dst = out + b * 16;
        int64_t tmp[16];
        for (int r = 0; r < 4; r++) {
            int64_t a = src[r * 4 + 0] >> 2, c = src[r * 4 + 1] >> 2;
            int64_t d = src[r * 4 + 2] >> 2, e2 = src[r * 4 + 3] >> 2;
            int64_t bb = e2;
            a += c;
            d -= bb;
            int64_t e = (a - d) >> 1;
            bb = e - bb;
            c = e - c;
            a -= bb;
            d += c;
            tmp[r * 4 + 0] = a;
            tmp[r * 4 + 1] = bb;
            tmp[r * 4 + 2] = c;
            tmp[r * 4 + 3] = d;
        }
        for (int cix = 0; cix < 4; cix++) {
            int64_t a = tmp[0 * 4 + cix], c = tmp[1 * 4 + cix];
            int64_t d = tmp[2 * 4 + cix], bb = tmp[3 * 4 + cix];
            a += c;
            d -= bb;
            int64_t e = (a - d) >> 1;
            bb = e - bb;
            c = e - c;
            a -= bb;
            d += c;
            dst[0 * 4 + cix] = (int32_t)a;
            dst[1 * 4 + cix] = (int32_t)bb;
            dst[2 * 4 + cix] = (int32_t)c;
            dst[3 * 4 + cix] = (int32_t)d;
        }
    }
}
