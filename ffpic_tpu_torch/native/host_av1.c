/* AV1 coefficient decode hot path (spec 5.11.39 coeffs syntax from
 * the EOB symbol onward) — a 1:1 port of the Python oracle in
 * coding/av1_tile.py:_coeffs / coding/av1_msac.py, operating on the
 * SAME adaptive CDF memory (int32 numpy arenas owned by CdfContext,
 * layout [p0..p_{n-2}, 0, counter]) so Python and C symbols can
 * interleave within one tile.  The msac state round-trips through a
 * 5-slot int64 buffer per call.
 *
 * The split point: Python decodes all_zero + tx_type (one symbol
 * each, mode-dependent CDF selection), C decodes eob/base/br/sign/
 * golomb (the ~95% symbol volume) and dequantizes.
 *
 * The C reference (junka/ffpic) has no AV1 support at all
 * (format/avif.c:382-405 is a frame stub).
 *
 * Copied from ffpic_tpu/native/host_av1.c (av1_recon, av1_block_parse,
 * av1_block_mode, av1_color_cicp, av1_sb_parse, av1_deblock_pass,
 * av1_prof_read) unchanged.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

#define EXPORT __attribute__((visibility("default")))

#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4
#define NUM_BASE_LEVELS 2
#define COEFF_BASE_RANGE 12
#define BR_CDF_SIZE 4
#define TX_CLASS_2D 0
#define TX_CLASS_HORIZ 1
#define TX_CLASS_VERT 2

typedef struct {
    const uint8_t *data;
    int64_t end8;        /* bits in the buffer */
    int64_t bitpos;
    uint32_t dif, rng;
    int32_t cnt;
    int allow_update;
    /* cached big-endian 8-byte window at byte win_b0 (load cache
     * only — no arithmetic state lives here; boundary (de)serialize
     * ignores it and constructors set win_b0 = -16 to force a
     * refill) */
    uint64_t win;
    int64_t win_b0;
} Msac;

/* lightweight always-on profile counters (av1_prof_read) */
static unsigned long long _prof[8];
static inline unsigned long long _rdtsc(void)
{
#if defined(__x86_64__) || defined(__i386__)
    unsigned lo, hi;
    __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
    return ((unsigned long long)hi << 32) | lo;
#else
    return 0;
#endif
}
EXPORT void av1_prof_read(unsigned long long *out, int reset)
{
    for (int i = 0; i < 8; i++) out[i] = _prof[i];
    if (reset) memset(_prof, 0, sizeof(_prof));
}

static inline int msac_read_bits(Msac *m, int n)
{
    /* bulk MSB-first window read (n <= 15): gather 4 bytes at the
     * bit cursor and shift out n bits; bytes past the buffer end
     * read as zero (spec msac padding).  Semantics identical to the
     * former bit-at-a-time loop — the (bitpos, dif, rng, cnt) state
     * still round-trips with the Python oracle unchanged. */
    if (!n)
        return 0;
    int64_t bp = m->bitpos;
    m->bitpos = bp + n;
    int64_t b0 = bp >> 3;
    if (b0 < m->win_b0 || b0 + 4 > m->win_b0 + 8) {
        int64_t nbytes = (m->end8 + 7) >> 3;
        const uint8_t *d = m->data;
        uint64_t t;
        if (b0 + 8 <= nbytes) {
            __builtin_memcpy(&t, d + b0, 8);
            t = __builtin_bswap64(t);
        } else {
            t = 0;
            for (int i = 0; i < 8; i++)
                t = (t << 8) |
                    (b0 + i < nbytes ? (uint64_t)d[b0 + i] : 0u);
        }
        m->win = t;
        m->win_b0 = b0;
    }
    uint64_t w = m->win << (((b0 - m->win_b0) << 3) + (bp & 7));
    return (int)(w >> (64 - n));
}

static inline void msac_renorm(Msac *m, uint32_t dif, uint32_t rng)
{
    int bits = 15 - (31 - __builtin_clz(rng));
    if (bits > 0) {
        rng <<= bits;
        int avail = m->cnt;
        int nb = bits < avail ? bits : (avail > 0 ? avail : 0);
        uint32_t nw = nb ? (uint32_t)msac_read_bits(m, nb) : 0;
        uint32_t padded = nw << (bits - nb);
        dif = padded ^ (((dif + 1) << bits) - 1);
        m->cnt = avail - bits;
    }
    m->dif = dif;
    m->rng = rng;
}

static int msac_symbol(Msac *m, int32_t *cdf, int n)
{
    _prof[3]++;
    uint32_t rng = m->rng, dif = m->dif;
    uint32_t r8 = rng >> 8;
    if (n == 2) {
        /* boolean with adaptive cdf (txb_skip/dc_sign/eob_extra) */
        uint32_t c0 = ((r8 * ((uint32_t)cdf[0] >> EC_PROB_SHIFT))
                       >> 1) + EC_MIN_PROB;
        int sym = dif < c0;
        if (sym)
            msac_renorm(m, dif, c0);
        else
            msac_renorm(m, dif - c0, rng - c0);
        if (m->allow_update) {
            int count = cdf[2];
            int rate = 4 + (count > 15) + (count > 31);
            cdf[0] += sym ? ((32768 - cdf[0]) >> rate)
                          : -(cdf[0] >> rate);
            cdf[2] = count + (count < 32);
        }
        return sym;
    }
    if (n == 4) {
        /* coeff_base / coeff_br: early-exit search (symbols are
         * heavily skewed toward 0) + unrolled branch-light adapt */
        uint32_t c0 = ((r8 * ((uint32_t)cdf[0] >> EC_PROB_SHIFT))
                       >> 1) + EC_MIN_PROB * 3;
        int sym;
        uint32_t lo, hi;
        if (dif >= c0) {
            sym = 0; lo = c0; hi = rng;
        } else {
            uint32_t c1 = ((r8 * ((uint32_t)cdf[1]
                                  >> EC_PROB_SHIFT)) >> 1)
                          + EC_MIN_PROB * 2;
            if (dif >= c1) {
                sym = 1; lo = c1; hi = c0;
            } else {
                uint32_t c2 = ((r8 * ((uint32_t)cdf[2]
                                      >> EC_PROB_SHIFT)) >> 1)
                              + EC_MIN_PROB;
                if (dif >= c2) {
                    sym = 2; lo = c2; hi = c1;
                } else {
                    sym = 3; lo = 0; hi = c2;
                }
            }
        }
        msac_renorm(m, dif - lo, hi - lo);
        if (m->allow_update) {
            int count = cdf[4];
            int rate = 5 + (count > 15) + (count > 31);
            cdf[0] += (sym > 0) ? ((32768 - cdf[0]) >> rate)
                                : -(cdf[0] >> rate);
            cdf[1] += (sym > 1) ? ((32768 - cdf[1]) >> rate)
                                : -(cdf[1] >> rate);
            cdf[2] += (sym > 2) ? ((32768 - cdf[2]) >> rate)
                                : -(cdf[2] >> rate);
            cdf[4] = count + (count < 32);
        }
        return sym;
    }
    uint32_t cur = rng, prev;
    int sym = -1;
    do {
        sym++;
        prev = cur;
        if (sym < n - 1)
            cur = ((r8 * ((uint32_t)cdf[sym] >> EC_PROB_SHIFT)) >> 1)
                  + EC_MIN_PROB * (uint32_t)(n - 1 - sym);
        else
            cur = 0;
    } while (dif < cur);
    msac_renorm(m, dif - cur, prev - cur);
    if (m->allow_update) {
        int count = cdf[n];
        int rate = 3 + (count > 15) + (count > 31) + (n < 4 ? 1 : 2);
        for (int i = 0; i < n - 1; i++) {
            if (i < sym)
                cdf[i] += (32768 - cdf[i]) >> rate;
            else
                cdf[i] -= cdf[i] >> rate;
        }
        cdf[n] = count + (count < 32);
    }
    return sym;
}

static inline int msac_bool_equi(Msac *m)
{
    uint32_t rng = m->rng, dif = m->dif;
    uint32_t cur = (((rng >> 8) * (16384u >> EC_PROB_SHIFT)) >> 1)
                   + EC_MIN_PROB;
    if (dif >= cur) {
        msac_renorm(m, dif - cur, rng - cur);
        return 0;
    }
    msac_renorm(m, dif, cur);
    return 1;
}

/* read_golomb, the av1_tile.py:_golomb formulation (31-run cap) */
static int64_t golomb(Msac *m)
{
    int length = 0;
    while (!msac_bool_equi(m)) {
        length++;
        if (length > 31)
            break;
    }
    int64_t x = 1;
    for (int i = 0; i < length; i++)
        x = (x << 1) | msac_bool_equi(m);
    return x - 1;
}

static inline int imin(int a, int b) { return a < b ? a : b; }

/* ------------------------------------------------------------------ *
 * Shared tables for the block parse + recon executors below.  The
 * Python oracle (av1_tile._coeffs / av1_recon._recon_block) remains
 * the fallback (FFPIC_AV1_NO_NATIVE).
 * ------------------------------------------------------------------ */

/* static blob offsets (int32 units; layout built in av1_tile.py) */
#define S_TXW 0
#define S_TXH 19
#define S_AW 38
#define S_AH 57
#define S_TXSCTX 76
#define S_EMUL 95
#define S_SCANOFF 114   /* 19*3 */
#define S_OFFTABS 171   /* 3*25: square, wide, tall */
#define S_SKIPCTX 246   /* 5*5 */
#define S_TTCLASS 271   /* 16 */
#define S_INV 287       /* 2*8 */

enum { P_A0, P_A1, P_A2, P_L0, P_L1, P_L2,
       P_EOB16, P_EOB32, P_EOB64, P_EOB128, P_EOB256, P_EOB512,
       P_EOB1024, P_TXBSKIP, P_EOBEXTRA, P_BASEEOB, P_BASE, P_BR,
       P_DCSIGN, P_IETX, P_SCANS, P_STATIC, P_NPTRS };

/* ------------------------------------------------------------------ *
 * Intra reconstruction executor: Python builds a flat per-TB op list
 * (all control decisions — availability, angles, edge-filter params,
 * CfL geometry — precompute before any pixel math since no AV1 parse
 * step depends on reconstructed samples), C replays it sequentially
 * over the int32 plane buffers.  1:1 port of formats/av1_intra.py /
 * av1_recon.py:_recon_block; prediction tables (dr derivative,
 * smooth weights, filter-intra taps) are passed in from the Python
 * single source of truth.
 * ------------------------------------------------------------------ */

enum {
    OP_PLANE, OP_X, OP_Y, OP_W, OP_H, OP_KIND, OP_P1,
    OP_HL, OP_HA, OP_HAR, OP_HBL, OP_MAXX, OP_MAXY,
    OP_CFL_ALPHA, OP_FT, OP_EEF, OP_RES,
    OP_MLW, OP_MLH, OP_SUBX, OP_SUBY,
    OP_NF
};

enum { K_DC, K_DIR, K_SMOOTH, K_SMOOTH_V, K_SMOOTH_H, K_PAETH,
       K_FILTER, K_PALPRED, K_IBC };

/* palette payload record (int32, written into the pal arena by
 * block_mode_core; one per palette block).  Map offsets are relative
 * to the record base so only the op's P1 needs frame-global
 * rebasing.  av1_recon consumes it for K_PALPRED ops. */
enum { PALH_NY, PALH_NU, PALH_BWY, PALH_BHY, PALH_BWUV, PALH_BHUV,
       PALH_PXY, PALH_PYY, PALH_PXUV, PALH_PYUV,
       PALH_MAPY, PALH_MAPUV,
       PALH_COLY = 12, PALH_COLU = 20, PALH_COLV = 28,
       PALH_NF = 36 };

/* mode pointer table */
enum { M_SKIPCDF, M_SPATSEG, M_KFY, M_ANGLE, M_UV0, M_UV1,
       M_CFLSIGN, M_CFLALPHA, M_PALY, M_PALUV, M_USEFI, M_FIMODE,
       M_INTRABC, M_DELTAQ, M_DELTALF, M_TXDEPTH,
       M_GSKIP, M_GSEG, M_GYMODE, M_GPAL, M_GCDEF, M_GTXW4,
       M_GTXH4, M_ATXW, M_LTXH, M_STATIC2,
       /* palette (spec 5.11.45/46, 5.11.49/50): size/color CDF
        * arenas + the above/left neighbor palette line buffers
        * (counts u8 [cols|rows][2] y/u, colors u16 [.][16] 8y+8u) */
       M_PALYSZ, M_PALUVSZ, M_PALYCOL, M_PALUVCOL,
       M_PALAN, M_PALAC, M_PALLN, M_PALLC,
       /* intrabc: dmv CDF arenas (joint + per-component rows),
        * var-tx split CDFs, inter ext-tx arenas, and the MV /
        * is-intrabc / inter-tx-leaf / luma-tx-type / bsize grids */
       M_DVJOINT, M_DVSIGN, M_DVCLASS, M_DVCLASS0, M_DVBITS,
       M_TXSPLIT, M_IETX1, M_IETX2, M_IETX3,
       M_GMV, M_GIBC, M_GINTERTX, M_GTXTYPE, M_GBSIZE,
       M_NPTRS };

/* static blob 2 layout (int32) */
#define S2_IMC 0        /* INTRA_MODE_CONTEXT[13] */
#define S2_MAXRECT 13   /* max_tx_size_rect[22] */
#define S2_SPLITTX 35   /* SPLIT_TX_SIZE[19] (identity where n/a) */
#define S2_SQRUP 54     /* TX_SIZE_SQR_UP[19] */
#define S2_MAXDEPTH 73  /* MAX_TX_DEPTH[22] */
#define S2_TXW 95       /* TX_W[19] */
#define S2_TXH 114      /* TX_H[19] */
#define S2_BW4 133      /* BLOCK_W4[22] */
#define S2_BH4 155      /* BLOCK_H4[22] */

/* static blob 3 layout (int32) */
#define S3_MAXUV 0      /* max_uv_tx_size[22*4] (bsize*4 + sx*2+sy) */
#define S3_SUBSIZE 88   /* Partition_Subsize[10*22] */
#define S3_ANGLE 308    /* Mode_To_Angle[13] (0 where n/a) */
#define S3_FIM2DIR 321  /* Fimode_To_Intra_Dir[5] */
#define S3_IM2TT 326    /* Intra_Mode_To_Tx_Type[14] */
#define S3_TTINSET 340  /* tx-type bitmask per tx set [3] */
#define S3_TXSQR 343    /* Tx_Size_Sqr[19] */
#define S3_KIND 362     /* recon op kind per intra mode [13] */
#define S3_B8 375       /* BLOCK_8X8 index */
#define S3_B128 376     /* BLOCK_128X128 index */
#define S3_IINV1 377    /* Tx_Type_Inter_Inv_Set1 [16] */
#define S3_IINV2 393    /* Tx_Type_Inter_Inv_Set2 [12] */
#define S3_IINV3 405    /* Tx_Type_Inter_Inv_Set3 [2] */
#define S3_ITTMASK 407  /* inter tx-type in-set bitmask [4] */
#define S3_TX2BS 411    /* square-tx -> square BLOCK enum [5] */
#define S3_NF 441

static inline int clip1(int v, int pixmax)
{
    return v < 0 ? 0 : (v > pixmax ? pixmax : v);
}

static inline int r2n(int v, int n) { return (v + (1 << (n - 1))) >> n; }
static inline int r2sn(int v, int n)
{
    return v >= 0 ? r2n(v, n) : -r2n(-v, n);
}

typedef struct {
    int32_t buf[2 * 132 + 4];
    int off;
} Edge;

#define EG(e, i) ((e)->buf[(e)->off + (i)])

static const int EDGE_KERNEL[3][5] = {
    {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}
};

static void edge_smooth(Edge *e, int num_px, int strength)
{
    if (!strength)
        return;
    const int *k = EDGE_KERNEL[strength - 1];
    int32_t orig[140];
    for (int i = 0; i < num_px; i++)
        orig[i] = EG(e, -1 + i);
    for (int i = 1; i < num_px; i++) {
        int s = 0;
        for (int j = 0; j < 5; j++) {
            int idx = i - 2 + j;
            if (idx < 0) idx = 0;
            if (idx > num_px - 1) idx = num_px - 1;
            s += orig[idx] * k[j];
        }
        EG(e, -1 + i) = (s + 8) >> 4;
    }
}

static void edge_upsample(Edge *e, int num_px, int pixmax)
{
    int32_t dup[140];
    dup[0] = EG(e, -1);
    dup[1] = EG(e, -1);
    for (int i = 0; i < num_px; i++)
        dup[2 + i] = EG(e, i);
    dup[2 + num_px] = dup[1 + num_px];
    int32_t out[270];
    out[0] = dup[0];
    for (int i = 0; i < num_px; i++) {
        int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2]
              - dup[i + 3];
        out[2 * i + 1] = clip1((s + 8) >> 4, pixmax);
        out[2 * i + 2] = dup[i + 2];
    }
    for (int i = 0; i < 2 * num_px + 1; i++)
        e->buf[e->off - 2 + i] = out[i];
}

static int edge_filter_strength_c(int wh, int d, int ft)
{
    if (d < 0) d = -d;
    int s = 0;
    if (ft == 0) {
        if (wh <= 8)       { if (d >= 56) s = 1; }
        else if (wh <= 12) { if (d >= 40) s = 1; }
        else if (wh <= 16) { if (d >= 40) s = 1; }
        else if (wh <= 24) {
            if (d >= 8) s = 1;
            if (d >= 16) s = 2;
            if (d >= 32) s = 3;
        } else if (wh <= 32) {
            s = 1;
            if (d >= 4) s = 2;
            if (d >= 32) s = 3;
        } else s = 3;
    } else {
        if (wh <= 8) {
            if (d >= 40) s = 1;
            if (d >= 64) s = 2;
        } else if (wh <= 16) {
            if (d >= 20) s = 1;
            if (d >= 48) s = 2;
        } else if (wh <= 24) {
            if (d >= 4) s = 3;
        } else s = 3;
    }
    return s;
}

static int use_upsample_c(int wh, int d, int ft)
{
    if (d < 0) d = -d;
    if (d <= 0 || d >= 40)
        return 0;
    return ft ? (wh <= 8) : (wh <= 16);
}

static inline int sm_off(int s)
{
    return s == 4 ? 0 : s == 8 ? 4 : s == 16 ? 12 : s == 32 ? 28 : 60;
}

EXPORT void av1_recon(
    const int32_t *ops, long long n_ops,
    int32_t *p0, int32_t *p1, int32_t *p2,
    const int32_t *pw, const int32_t *ph,
    const int32_t *residuals,
    const int32_t *dr_deriv,    /* [91] */
    const int32_t *smw,         /* flat smooth weights */
    const int32_t *fi_taps,     /* 5*8*7 */
    const int32_t *pal,         /* palette payload arena */
    int bd)
{
    int32_t *planes[3] = { p0, p1, p2 };
    int pixmax = (1 << bd) - 1;
    int32_t pred[64 * 64];

    for (long long oi = 0; oi < n_ops; oi++) {
        const int32_t *op = ops + oi * OP_NF;
        int plane = op[OP_PLANE];
        int x = op[OP_X], y = op[OP_Y];
        int w = op[OP_W], h = op[OP_H];
        int kind = op[OP_KIND];
        int have_left = op[OP_HL], have_above = op[OP_HA];
        int har = op[OP_HAR], hbl = op[OP_HBL];
        int max_x = op[OP_MAXX], max_y = op[OP_MAXY];
        int32_t *arr = planes[plane];
        int stride = pw[plane];

        if (kind == K_IBC) {
            /* intrabc block copy: whole-pel luma; chroma may land
             * on half-pel -> spec two-stage BILINEAR convolve
             * (1:1 with formats/av1_recon._ibc_predict) */
            int mvr = op[OP_CFL_ALPHA], mvc = op[OP_P1];
            int sx_ = op[OP_SUBX], sy_ = op[OP_SUBY];
            int mvy16 = mvr << (1 - sy_);
            int mvx16 = mvc << (1 - sx_);
            int by = y + (mvy16 >> 4);
            int bx = x + (mvx16 >> 4);
            int fy = mvy16 & 15, fx = mvx16 & 15;
            /* corrupt streams can carry DVs outside the decoded
             * area (the spec's is_dv_valid is an encoder
             * guarantee): clamp source coords defensively —
             * conforming streams are unaffected (fuzz-found SEGV) */
            int ph_ = ph[plane];
            int max_by = ph_ - h - (fy ? 1 : 0);
            int max_bx = stride - w - (fx ? 1 : 0);
            if (by < 0) by = 0;
            if (by > max_by) by = max_by < 0 ? 0 : max_by;
            if (bx < 0) bx = 0;
            if (bx > max_bx) bx = max_bx < 0 ? 0 : max_bx;
            if (!fx && !fy) {
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++)
                        pred[i * w + j] =
                            arr[(long)(by + i) * stride + bx + j];
            } else {
                int r0 = bd == 12 ? 5 : 3;
                int r1 = 14 - r0;
                int gh = h + (fy ? 1 : 0);
                int32_t tmp[65 * 64];
                for (int i = 0; i < gh; i++)
                    for (int j = 0; j < w; j++) {
                        int s0 = arr[(long)(by + i) * stride
                                     + bx + j];
                        int v;
                        if (fx) {
                            int s1 = arr[(long)(by + i) * stride
                                         + bx + j + 1];
                            v = (128 - 8 * fx) * s0 + 8 * fx * s1;
                        } else {
                            v = 128 * s0;
                        }
                        tmp[i * w + j] = (v + (1 << (r0 - 1))) >> r0;
                    }
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++) {
                        int v;
                        if (fy)
                            v = (128 - 8 * fy) * tmp[i * w + j]
                                + 8 * fy * tmp[(i + 1) * w + j];
                        else
                            v = 128 * tmp[i * w + j];
                        pred[i * w + j] =
                            (v + (1 << (r1 - 1))) >> r1;
                    }
            }
            goto add_residual;
        }
        if (kind == K_PALPRED) {
            /* palette prediction: index map -> colors (the map
             * covers the whole block at plane resolution; this TB
             * reads its sub-rectangle) */
            const int32_t *P = pal + op[OP_P1];
            int isuv = plane > 0;
            const int32_t *cols =
                P + (plane == 0 ? PALH_COLY
                     : plane == 1 ? PALH_COLU : PALH_COLV);
            int bw = P[isuv ? PALH_BWUV : PALH_BWY];
            int px0 = P[isuv ? PALH_PXUV : PALH_PXY];
            int py0 = P[isuv ? PALH_PYUV : PALH_PYY];
            const int32_t *map =
                P + P[isuv ? PALH_MAPUV : PALH_MAPY];
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++)
                    pred[i * w + j] =
                        cols[map[(y - py0 + i) * bw
                                 + (x - px0 + j)]];
            goto add_residual;
        }

        /* ---- prepare_edges (spec 7.11.2 steps 2-8) */
        Edge above, left;
        above.off = 2;
        left.off = 2;
        int n = w + h;
        int base = 1 << (bd - 1);
        if (!have_above && have_left) {
            int v = arr[y * stride + x - 1];
            for (int i = -1; i < n; i++) EG(&above, i) = v;
        } else if (!have_above) {
            for (int i = -1; i < n; i++) EG(&above, i) = base - 1;
        } else {
            int limit = x + (har ? 2 * w : w) - 1;
            if (limit > max_x) limit = max_x;
            const int32_t *row = arr + (y - 1) * stride;
            for (int i = 0; i < n; i++) {
                int xi = x + i;
                EG(&above, i) = row[xi < limit ? xi : limit];
            }
        }
        if (!have_left && have_above) {
            int v = arr[(y - 1) * stride + x];
            for (int i = -1; i < n; i++) EG(&left, i) = v;
        } else if (!have_left) {
            for (int i = -1; i < n; i++) EG(&left, i) = base + 1;
        } else {
            int limit = y + (hbl ? 2 * h : h) - 1;
            if (limit > max_y) limit = max_y;
            for (int i = 0; i < n; i++) {
                int yi = y + i;
                EG(&left, i) =
                    arr[(yi < limit ? yi : limit) * stride + x - 1];
            }
        }
        int corner;
        if (have_above && have_left)
            corner = arr[(y - 1) * stride + x - 1];
        else if (have_above)
            corner = arr[(y - 1) * stride + x];
        else if (have_left)
            corner = arr[y * stride + x - 1];
        else
            corner = base;
        EG(&above, -1) = corner;
        EG(&left, -1) = corner;

        /* ---- predict */
        if (kind == K_FILTER) {
            int fmode = op[OP_P1];
            const int32_t *taps = fi_taps + fmode * 8 * 7;
            int32_t buf[65 * 65];
            int bs = w + 1;
            buf[0] = EG(&above, -1);
            for (int j = 0; j < w; j++) buf[j + 1] = EG(&above, j);
            for (int i = 0; i < h; i++) buf[(i + 1) * bs] = EG(&left, i);
            for (int r = 1; r < h + 1; r += 2) {
                for (int c = 1; c < w + 1; c += 4) {
                    int p[7] = {
                        buf[(r - 1) * bs + c - 1],
                        buf[(r - 1) * bs + c],
                        buf[(r - 1) * bs + c + 1],
                        buf[(r - 1) * bs + c + 2],
                        buf[(r - 1) * bs + c + 3],
                        buf[r * bs + c - 1],
                        buf[(r + 1) * bs + c - 1],
                    };
                    for (int k = 0; k < 8; k++) {
                        int ro = k >> 2, co = k & 3;
                        int s = 0;
                        for (int t = 0; t < 7; t++)
                            s += taps[k * 7 + t] * p[t];
                        buf[(r + ro) * bs + c + co] =
                            clip1(r2sn(s, 4), pixmax);
                    }
                }
            }
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++)
                    pred[i * w + j] = buf[(i + 1) * bs + j + 1];
        } else if (kind == K_DC) {
            int avg;
            if (have_above && have_left) {
                long long s = 0;
                for (int i = 0; i < w; i++) s += EG(&above, i);
                for (int i = 0; i < h; i++) s += EG(&left, i);
                avg = (int)((s + ((w + h) >> 1)) / (w + h));
            } else if (have_above) {
                long long s = 0;
                for (int i = 0; i < w; i++) s += EG(&above, i);
                avg = r2n((int)s, __builtin_ctz(w));
            } else if (have_left) {
                long long s = 0;
                for (int i = 0; i < h; i++) s += EG(&left, i);
                avg = r2n((int)s, __builtin_ctz(h));
            } else {
                avg = base;
            }
            for (int i = 0; i < h * w; i++) pred[i] = avg;
        } else if (kind == K_DIR) {
            int p_angle = op[OP_P1];
            int ft = op[OP_FT];
            int up_a = 0, up_l = 0;
            if (op[OP_EEF]) {
                if (p_angle != 90 && p_angle != 180) {
                    if (p_angle > 90 && p_angle < 180 && w + h >= 24) {
                        int v = r2n(EG(&left, 0) * 5
                                    + EG(&above, -1) * 6
                                    + EG(&above, 0) * 5, 4);
                        EG(&above, -1) = v;
                        EG(&left, -1) = v;
                    }
                    if (have_above) {
                        int st = edge_filter_strength_c(
                            w + h, p_angle - 90, ft);
                        int np_ = (w < max_x - x + 1 ? w
                                   : max_x - x + 1)
                                + (p_angle < 90 ? h : 0) + 1;
                        edge_smooth(&above, np_, st);
                    }
                    if (have_left) {
                        int st = edge_filter_strength_c(
                            w + h, p_angle - 180, ft);
                        int np_ = (h < max_y - y + 1 ? h
                                   : max_y - y + 1)
                                + (p_angle > 180 ? w : 0) + 1;
                        edge_smooth(&left, np_, st);
                    }
                }
                up_a = use_upsample_c(w + h, p_angle - 90, ft);
                up_l = use_upsample_c(w + h, p_angle - 180, ft);
                if (up_a)
                    edge_upsample(&above,
                                  w + (p_angle < 90 ? h : 0), pixmax);
                if (up_l)
                    edge_upsample(&left,
                                  h + (p_angle > 180 ? w : 0), pixmax);
            }
            if (p_angle == 90) {
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++)
                        pred[i * w + j] = EG(&above, j);
            } else if (p_angle == 180) {
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++)
                        pred[i * w + j] = EG(&left, i);
            } else if (p_angle < 90) {
                int dx = dr_deriv[p_angle];
                int max_base = (w + h - 1) << up_a;
                for (int i = 0; i < h; i++) {
                    int idx = (i + 1) * dx;
                    for (int j = 0; j < w; j++) {
                        int b = (idx >> (6 - up_a)) + (j << up_a);
                        if (b < max_base) {
                            int sh = ((idx << up_a) >> 1) & 0x1F;
                            pred[i * w + j] = r2n(
                                EG(&above, b) * (32 - sh)
                                + EG(&above, b + 1) * sh, 5);
                        } else {
                            pred[i * w + j] = EG(&above, max_base);
                        }
                    }
                }
            } else if (p_angle < 180) {
                int dx = dr_deriv[180 - p_angle];
                int dy = dr_deriv[p_angle - 90];
                for (int i = 0; i < h; i++) {
                    for (int j = 0; j < w; j++) {
                        int idx = (j << 6) - (i + 1) * dx;
                        int b = idx >> (6 - up_a);
                        if (b >= -(1 << up_a)) {
                            int sh = ((idx << up_a) >> 1) & 0x1F;
                            pred[i * w + j] = r2n(
                                EG(&above, b) * (32 - sh)
                                + EG(&above, b + 1) * sh, 5);
                        } else {
                            int idx2 = (i << 6) - (j + 1) * dy;
                            int b2 = idx2 >> (6 - up_l);
                            int sh = ((idx2 << up_l) >> 1) & 0x1F;
                            pred[i * w + j] = r2n(
                                EG(&left, b2) * (32 - sh)
                                + EG(&left, b2 + 1) * sh, 5);
                        }
                    }
                }
            } else {
                int dy = dr_deriv[270 - p_angle];
                int max_base = (w + h - 1) << up_l;
                for (int j = 0; j < w; j++) {
                    int idx = (j + 1) * dy;
                    for (int i = 0; i < h; i++) {
                        int b = (idx >> (6 - up_l)) + (i << up_l);
                        if (b < max_base) {
                            int sh = ((idx << up_l) >> 1) & 0x1F;
                            pred[i * w + j] = r2n(
                                EG(&left, b) * (32 - sh)
                                + EG(&left, b + 1) * sh, 5);
                        } else {
                            pred[i * w + j] = EG(&left, max_base);
                        }
                    }
                }
            }
        } else if (kind == K_SMOOTH) {
            const int32_t *wv = smw + sm_off(h);
            const int32_t *ww = smw + sm_off(w);
            int br = EG(&left, h - 1), ar = EG(&above, w - 1);
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++)
                    pred[i * w + j] = r2n(
                        wv[i] * EG(&above, j) + (256 - wv[i]) * br
                        + ww[j] * EG(&left, i) + (256 - ww[j]) * ar,
                        9);
        } else if (kind == K_SMOOTH_V) {
            const int32_t *wv = smw + sm_off(h);
            int br = EG(&left, h - 1);
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++)
                    pred[i * w + j] = r2n(
                        wv[i] * EG(&above, j) + (256 - wv[i]) * br,
                        8);
        } else if (kind == K_SMOOTH_H) {
            const int32_t *ww = smw + sm_off(w);
            int ar = EG(&above, w - 1);
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++)
                    pred[i * w + j] = r2n(
                        ww[j] * EG(&left, i) + (256 - ww[j]) * ar,
                        8);
        } else { /* K_PAETH */
            int tl = EG(&above, -1);
            for (int i = 0; i < h; i++) {
                int l = EG(&left, i);
                for (int j = 0; j < w; j++) {
                    int a = EG(&above, j);
                    int bse = a + l - tl;
                    int pa = bse - a; if (pa < 0) pa = -pa;
                    int pl = bse - l; if (pl < 0) pl = -pl;
                    int pt = bse - tl; if (pt < 0) pt = -pt;
                    pred[i * w + j] = (pa <= pl && pa <= pt) ? a
                                      : (pl <= pt ? l : tl);
                }
            }
        }

        /* ---- CfL (spec 7.11.5): dc pred + alpha-scaled luma AC */
        int alpha = op[OP_CFL_ALPHA];
        if (alpha) {
            const int32_t *luma = planes[0];
            int ls = pw[0];
            int sub_x = op[OP_SUBX], sub_y = op[OP_SUBY];
            int mlw = op[OP_MLW], mlh = op[OP_MLH];
            int lx0 = x << sub_x, ly0 = y << sub_y;
            int64_t L[32 * 32];
            int64_t tot = 0;
            for (int i = 0; i < h; i++) {
                int ly = ly0 + (i << sub_y);
                int lim = mlh - (1 << sub_y);
                if (ly > lim) ly = lim;
                for (int j = 0; j < w; j++) {
                    int lx = lx0 + (j << sub_x);
                    int lmx = mlw - (1 << sub_x);
                    if (lx > lmx) lx = lmx;
                    int64_t t;
                    if (sub_x && sub_y)
                        t = ((int64_t)luma[ly * ls + lx]
                             + luma[ly * ls + lx + 1]
                             + luma[(ly + 1) * ls + lx]
                             + luma[(ly + 1) * ls + lx + 1]) << 1;
                    else if (sub_x)
                        t = ((int64_t)luma[ly * ls + lx]
                             + luma[ly * ls + lx + 1]) << 2;
                    else
                        t = (int64_t)luma[ly * ls + lx] << 3;
                    L[i * w + j] = t;
                    tot += t;
                }
            }
            int log2sz = __builtin_ctz(w) + __builtin_ctz(h);
            int64_t avg = (tot + (1ll << (log2sz - 1))) >> log2sz;
            for (int i = 0; i < h * w; i++) {
                int ac = (int)(L[i] - avg);
                pred[i] = clip1(pred[i] + r2sn(alpha * ac, 6),
                                pixmax);
            }
        }

        /* ---- add residual, clip, clamped write */
add_residual:;
        int we = w, he = h;
        if (x + we > pw[plane]) we = pw[plane] - x;
        if (y + he > ph[plane]) he = ph[plane] - y;
        int res_off = op[OP_RES];
        if (res_off >= 0) {
            const int32_t *res = residuals + res_off;
            for (int i = 0; i < he; i++)
                for (int j = 0; j < we; j++)
                    arr[(y + i) * stride + x + j] = clip1(
                        pred[i * w + j] + res[i * w + j], pixmax);
        } else {
            for (int i = 0; i < he; i++)
                for (int j = 0; j < we; j++)
                    arr[(y + i) * stride + x + j] = clip1(
                        pred[i * w + j], pixmax);
        }
    }
}

/* ------------------------------------------------------------------ *
 * Whole-block residual parse: C iterates the spec residual() TB
 * geometry itself (one compact per-block + per-plane record from
 * Python), decoding coefficients AND emitting the recon op list,
 * maintaining the BlockDecoded bitmaps, a/l coefficient contexts,
 * chroma tx-dim grids and MaxLuma state.  Python's per-block glue
 * shrinks to ~25 scalars; mode-symbol decode stays in Python.
 * Mirrors av1_tile.py:_residual_native/iter_tx_geometry and
 * av1_recon.py:_SbDecoded 1:1.
 * ------------------------------------------------------------------ */

/* additional pointer-table entries (extends the P_* enum) */
enum { Q_DEC0 = P_NPTRS, Q_DEC1, Q_DEC2, Q_TXW4C, Q_TXH4C,
       Q_NPTRS };

/* per-block record */
enum { B_R, B_C, B_WCH, B_HCH, B_SKIP, B_NEWSB, B_SBR, B_SBC,
       B_SBROW, B_MIROWS, B_MICOLS, B_R1T, B_C1T, B_EEF,
       B_NPALL,   /* seq.num_planes: the BlockDecoded reset covers
                   * every frame plane even when the current block is
                   * a chroma-less sub-8x8 partner (nplanes == 1) —
                   * otherwise a new superblock entered via such a
                   * block keeps the previous SB's chroma marks */
       B_INTERTX,  /* intrabc block: luma TBs follow the var-tx leaf
                    * grid (transform_tree), tx types use the inter
                    * sets, chroma takes the co-located luma type */
       B_QIDX, B_REDUCEDTX,
       B_NF };

/* per-plane record (3 rows) */
enum { PPF_TX, PPF_NUM4W, PPF_NUM4H, PPF_SX, PPF_SY, PPF_AVAILU,
       PPF_AVAILL, PPF_ETTSET, PPF_ETTDIR, PPF_ETTSQR, PPF_FIXEDTT,
       PPF_DCQ, PPF_ACQ, PPF_SHIFT, PPF_KIND, PPF_P1, PPF_ALPHA,
       PPF_FT, PPF_PBW, PPF_PBH, PPF_DMH, PPF_DMW, PPF_NF };

/* tb meta out columns (TBM_LOSSLESS is filled by the superblock
 * driver av1_sb_parse; the per-block av1_block_parse leaves it to
 * its Python caller, which knows the segment) */
enum { TBM_PLANE, TBM_X, TBM_Y, TBM_TX, TBM_OFF, TBM_EOB, TBM_TT,
       TBM_OPROW, TBM_LOSSLESS, TBM_NF };

static int decode_tb_coeffs(Msac *m, const long long *ptrs,
                            const int32_t *S, const int32_t *scans,
                            int plane, int x4, int y4, int tx,
                            int cw4, int ch4, int l_base, int az,
                            int ett_set, int ett_dir, int ett_sqr,
                            int fixed_tt,
                            long long dc_q, long long ac_q,
                            int shift, long long clip,
                            int32_t *dst, int32_t *tt_out,
                            int32_t *ett_row, const int32_t *ett_inv,
                            int ett_n)
{
    int ptype = plane ? 1 : 0;
    uint8_t *a = (uint8_t *)ptrs[P_A0 + plane];
    uint8_t *l = (uint8_t *)ptrs[P_L0 + plane];
    int txs = S[S_TXSCTX + tx];

    int ctx;
    if (az == 0) {
        ctx = 0;
    } else if (az == 1) {
        int top = 0, lft = 0;
        for (int k = 0; k < cw4; k++) top |= a[x4 + k];
        for (int k = 0; k < ch4; k++) lft |= l[l_base + k];
        top &= 63;
        lft &= 63;
        int mx = top | lft; if (mx > 4) mx = 4;
        int mn = top < lft ? top : lft; if (mn > 4) mn = 4;
        ctx = S[S_SKIPCTX + mn * 5 + mx];
    } else {
        int anz = 0, lnz = 0;
        for (int k = 0; k < cw4 && !anz; k++)
            anz = (a[x4 + k] & 63) != 0;
        for (int k = 0; k < ch4 && !lnz; k++)
            lnz = (l[l_base + k] & 63) != 0;
        ctx = anz + lnz + (az == 3 ? 10 : 7);
    }
    int32_t *skip_cdf = (int32_t *)ptrs[P_TXBSKIP]
                      + (txs * 13 + ctx) * 3;
    if (msac_symbol(m, skip_cdf, 2)) {
        for (int k = 0; k < cw4; k++) a[x4 + k] = 0;
        for (int k = 0; k < ch4; k++) l[l_base + k] = 0;
        *tt_out = 0;
        return 0;
    }

    int tt;
    if (ett_row) {
        /* inter (intrabc) tx-type family */
        tt = ett_inv[msac_symbol(m, ett_row, ett_n)];
    } else if (ett_set < 0) {
        tt = fixed_tt;
    } else {
        int32_t *row = (int32_t *)ptrs[P_IETX]
            + (((ett_set * 4) + ett_sqr) * 13 + ett_dir) * 8;
        int n = ett_set == 0 ? 7 : 5;
        int sym = msac_symbol(m, row, n);
        tt = S[S_INV + ett_set * 8 + sym];
    }
    *tt_out = tt;
    int cls = S[S_TTCLASS + tt];
    int kind = cls == TX_CLASS_VERT ? 1
             : cls == TX_CLASS_HORIZ ? 2 : 0;
    const int32_t *scan = scans + S[S_SCANOFF + tx * 3 + kind];
    int w = S[S_AW + tx], h = S[S_AH + tx];
    int area = w * h;
    /* square/wide/tall classification uses the TRUE tx shape, not
     * the adjusted <=32x32 coded area — TX_32X64/TX_64X32 adjust to
     * square 32x32 but take the tall/wide tables (dav1d
     * lo_ctx_offsets index 1 + (tx & 1) over its rect enum) */
    int tw_t = S[S_TXW + tx], th_t = S[S_TXH + tx];
    const int32_t *offtab = S + S_OFFTABS
        + (tw_t == th_t ? 0 : (tw_t > th_t ? 25 : 50));

    int emul = S[S_EMUL + tx];
    int eob_n = 5 + emul;
    int32_t *eob_cdf = (int32_t *)ptrs[P_EOB16 + emul]
        + (ptype * 2 + (cls == TX_CLASS_2D ? 0 : 1)) * (eob_n + 1);
    int eob_pt = msac_symbol(m, eob_cdf, eob_n) + 1;
    int eob;
    if (eob_pt < 2) {
        eob = eob_pt;
    } else {
        eob = (1 << (eob_pt - 2)) + 1;
        if (eob_pt >= 3) {
            int32_t *xr = (int32_t *)ptrs[P_EOBEXTRA]
                + ((txs * 2 + ptype) * 9 + (eob_pt - 3)) * 3;
            if (msac_symbol(m, xr, 2))
                eob += 1 << (eob_pt - 3);
            for (int i = 1; i < eob_pt - 2; i++) {
                int sh = eob_pt - 2 - 1 - i;
                if (msac_bool_equi(m))
                    eob += 1 << sh;
            }
        }
    }

    /* clamped-level neighborhood (values <= 127): uint8 keeps the
     * 32x32 case in ~1.4KB of L1 for the 5-gather ctx derivations */
    uint8_t lv[37 * 37];
    memset(lv, 0, (size_t)(h + 5) * (w + 5));
    int stride = w + 5;
    /* quant/signs need no zeroing: every cell read below is written
     * first (the scan loops cover exactly positions scan[0..eob)) */
    int64_t quant[1024];
    int8_t signs[1024];
    int log2w = __builtin_ctz(w);
    int32_t *base_eob = (int32_t *)ptrs[P_BASEEOB]
                      + (txs * 2 + ptype) * 4 * 4;
    int32_t *base = (int32_t *)ptrs[P_BASE]
                  + (txs * 2 + ptype) * 42 * 5;
    int mt = txs < 3 ? txs : 3;
    int32_t *br = (int32_t *)ptrs[P_BR] + (mt * 2 + ptype) * 21 * 5;

    for (int ci = eob - 1; ci >= 0; ci--) {
        int pos = scan[ci];
        int row = pos >> log2w;
        int col = pos - (row << log2w);
        uint8_t *L = lv + row * stride + col;
        int64_t level;
        if (ci == eob - 1) {
            int bctx;
            if (ci == 0) bctx = 0;
            else if (ci <= area / 8) bctx = 1;
            else if (ci <= area / 4) bctx = 2;
            else bctx = 3;
            level = msac_symbol(m, base_eob + bctx * 4, 3) + 1;
        } else {
            int bctx;
            if (cls == TX_CLASS_2D) {
                if (pos == 0) {
                    bctx = 0;
                } else {
                    int mag = imin(L[1], 3) + imin(L[stride], 3)
                            + imin(L[stride + 1], 3) + imin(L[2], 3)
                            + imin(L[2 * stride], 3);
                    bctx = imin((mag + 1) >> 1, 4)
                         + offtab[imin(row, 4) * 5 + imin(col, 4)];
                }
            } else {
                int mag = imin(L[1], 3) + imin(L[stride], 3);
                int idx;
                if (cls == TX_CLASS_HORIZ) {
                    mag += imin(L[2], 3) + imin(L[3], 3)
                         + imin(L[4], 3);
                    idx = col;
                } else {
                    mag += imin(L[2 * stride], 3)
                         + imin(L[3 * stride], 3)
                         + imin(L[4 * stride], 3);
                    idx = row;
                }
                bctx = imin((mag + 1) >> 1, 4) + 26
                     + 5 * imin(idx, 2);
            }
            level = msac_symbol(m, base + bctx * 5, 4);
        }
        if (level > NUM_BASE_LEVELS) {
            int mag;
            if (cls == TX_CLASS_2D)
                mag = L[1] + L[stride] + L[stride + 1];
            else if (cls == TX_CLASS_HORIZ)
                mag = L[1] + L[stride] + L[2];
            else
                mag = L[1] + L[stride] + L[2 * stride];
            int bmag = imin((mag + 1) >> 1, 6);
            int brctx;
            if (pos == 0)
                brctx = bmag;
            else if (cls == TX_CLASS_2D)
                brctx = bmag + ((row < 2 && col < 2) ? 7 : 14);
            else if (cls == TX_CLASS_HORIZ)
                brctx = bmag + (col == 0 ? 7 : 14);
            else
                brctx = bmag + (row == 0 ? 7 : 14);
            for (int k = 0;
                 k < COEFF_BASE_RANGE / (BR_CDF_SIZE - 1); k++) {
                int v = msac_symbol(m, br + brctx * 5, 4);
                level += v;
                if (v < BR_CDF_SIZE - 1)
                    break;
            }
        }
        quant[pos] = level;
        L[0] = (uint8_t)(level < 127 ? level : 127);
    }

    int64_t cul = 0;
    int dc_cat = 0;
    for (int ci = 0; ci < eob; ci++) {
        int pos = scan[ci];
        int64_t level = quant[pos];
        int sign = 0;
        if (level) {
            if (ci == 0) {
                int dcs = 0;
                for (int k = 0; k < cw4; k++) {
                    int v = a[x4 + k] >> 6;
                    dcs += v == 2 ? 1 : (v == 1 ? -1 : 0);
                }
                for (int k = 0; k < ch4; k++) {
                    int v = l[l_base + k] >> 6;
                    dcs += v == 2 ? 1 : (v == 1 ? -1 : 0);
                }
                int sctx = dcs == 0 ? 0 : (dcs < 0 ? 1 : 2);
                int32_t *ds = (int32_t *)ptrs[P_DCSIGN]
                            + (ptype * 3 + sctx) * 3;
                sign = msac_symbol(m, ds, 2);
            } else {
                sign = msac_bool_equi(m);
            }
        }
        if (level > NUM_BASE_LEVELS + COEFF_BASE_RANGE) {
            level += golomb(m);
            quant[pos] = level;
        }
        if (ci == 0)
            dc_cat = level == 0 ? 0 : (sign ? 1 : 2);
        cul += level;
        signs[pos] = (int8_t)sign;
    }
    if (cul > 63)
        cul = 63;
    uint8_t av = (uint8_t)(cul | (dc_cat << 6));
    for (int k = 0; k < cw4; k++) a[x4 + k] = av;
    for (int k = 0; k < ch4; k++) l[l_base + k] = av;

    for (int ci = 0; ci < eob; ci++) {
        int pos = scan[ci];
        int64_t level = quant[pos];
        if (!level)
            continue;
        int64_t dq = (level * (pos == 0 ? dc_q : ac_q)) & 0xFFFFFF;
        dq >>= shift;
        if (signs[pos])
            dq = -dq;
        if (dq < -clip) dq = -clip;
        if (dq > clip - 1) dq = clip - 1;
        dst[pos] = (int32_t)dq;
    }
    return eob;
}

/* per-TB parse state shared between the uniform (intra) walk and
 * the inter transform_tree walk */
typedef struct {
    Msac *m;
    const long long *ptrs, *mp;     /* mp nullable (per-block path) */
    const int32_t *S, *S3, *scans, *blk, *P;
    int32_t *ops, *coef_out, *tbmeta, *inout;
    long long clip;
    int n_ops, n_tbs, coef_total;
    int plane, sx, sy, mi_rows, mi_cols, sb_r, sb_c, sbrow, eef;
    int blk_px, blk_py, max_px, max_py, skip;
} TbCtx;

static int c_tx_set_inter(const int32_t *S2, const int32_t *S3,
                          int tx, int reduced)
{
    if (S2[S2_SQRUP + tx] > 3)
        return 0;               /* > TX_32X32: DCT only */
    if (S2[S2_SQRUP + tx] == 3)
        return 3;               /* TX_32X32: DCT_IDTX */
    if (reduced)
        return 3;
    if (S3[S3_TXSQR + tx] == 2)
        return 2;               /* 16x16: DTT9_IDTX_1DDCT */
    return 1;                   /* ALL16 */
}

static void parse_tb(TbCtx *tc, int x, int y, int tx)
{
    const int32_t *P = tc->P, *S = tc->S, *blk = tc->blk;
    const long long *ptrs = tc->ptrs;
    Msac *m = tc->m;
    int plane = tc->plane, sx = tc->sx, sy = tc->sy;
    int mi_rows = tc->mi_rows, mi_cols = tc->mi_cols;
    if (x >= tc->max_px || y >= tc->max_py)
        return;
    int tw = S[S_TXW + tx], th = S[S_TXH + tx];
    int x4 = x >> 2, y4 = y >> 2;
    int w4 = tw >> 2, h4 = th >> 2;
    int l_base = y4 - (tc->sbrow >> sy);
    uint8_t *dmap = (uint8_t *)ptrs[Q_DEC0 + plane];
    uint8_t *a = (uint8_t *)ptrs[P_A0 + plane];
    uint8_t *l = (uint8_t *)ptrs[P_L0 + plane];
    int dmw = P[PPF_DMW];
    if (plane > 0) {
        int r0 = y4 << sy, c0 = x4 << sx;
        int re_ = r0 + (h4 << sy);
        if (re_ > mi_rows) re_ = mi_rows;
        int ce = c0 + (w4 << sx);
        if (ce > mi_cols) ce = mi_cols;
        uint8_t *txw = (uint8_t *)ptrs[Q_TXW4C];
        uint8_t *txh = (uint8_t *)ptrs[Q_TXH4C];
        for (int rr = r0; rr < re_; rr++)
            for (int cc = c0; cc < ce; cc++) {
                txw[rr * mi_cols + cc] = (uint8_t)w4;
                txh[rr * mi_cols + cc] = (uint8_t)h4;
            }
    }
    /* recon op */
    int avail_u = P[PPF_AVAILU], avail_l = P[PPF_AVAILL];
    int have_above = avail_u || y > tc->blk_py;
    int have_left = avail_l || x > tc->blk_px;
    int rel_x4 = x4 - (sx ? (tc->sb_c >> sx) : tc->sb_c);
    int rel_y4 = y4 - (sy ? (tc->sb_r >> sy) : tc->sb_r);
    int har = 0, hbl = 0;
    {
        int gy = rel_y4 - 1 + 1, gx = rel_x4 + w4 + 1;
        int dmh = P[PPF_DMH];
        if (gy >= 0 && gx >= 0 && gy < dmh && gx < dmw)
            har = dmap[gy * dmw + gx];
        gy = rel_y4 + h4 + 1;
        gx = rel_x4 - 1 + 1;
        if (gy >= 0 && gx >= 0 && gy < dmh && gx < dmw)
            hbl = dmap[gy * dmw + gx];
    }
    int32_t *op = tc->ops + (long long)tc->n_ops * OP_NF;
    op[OP_PLANE] = plane;
    op[OP_X] = x;
    op[OP_Y] = y;
    op[OP_W] = tw;
    op[OP_H] = th;
    op[OP_KIND] = P[PPF_KIND];
    op[OP_P1] = P[PPF_P1];
    op[OP_HL] = have_left;
    op[OP_HA] = have_above;
    op[OP_HAR] = har;
    op[OP_HBL] = hbl;
    op[OP_MAXX] = ((blk[B_C1T] * 4) >> sx) - 1;
    op[OP_MAXY] = ((blk[B_R1T] * 4) >> sy) - 1;
    op[OP_CFL_ALPHA] = P[PPF_ALPHA];
    op[OP_FT] = P[PPF_FT];
    op[OP_EEF] = tc->eef;
    op[OP_RES] = -1;
    op[OP_MLW] = tc->inout[0];
    op[OP_MLH] = tc->inout[1];
    op[OP_SUBX] = sx;
    op[OP_SUBY] = sy;
    tc->n_ops++;
    /* dec.mark */
    for (int rr = 0; rr < h4; rr++)
        for (int cc = 0; cc < w4; cc++)
            dmap[(rel_y4 + 1 + rr) * dmw + (rel_x4 + 1 + cc)] = 1;
    if (plane == 0) {
        tc->inout[0] = x + tw;
        tc->inout[1] = y + th;
    }
    if (tc->skip) {
        for (int k = 0; k < w4; k++) a[x4 + k] = 0;
        for (int k = 0; k < h4; k++) l[l_base + k] = 0;
        return;
    }
    /* coefficient decode */
    int cw4 = w4, ch4 = h4;
    if ((mi_cols >> sx) - x4 < cw4)
        cw4 = (mi_cols >> sx) - x4;
    if ((mi_rows >> sy) - y4 < ch4)
        ch4 = (mi_rows >> sy) - y4;
    int az;
    if (plane == 0)
        az = (P[PPF_PBW] == tw && P[PPF_PBH] == th) ? 0 : 1;
    else
        az = P[PPF_PBW] * P[PPF_PBH] > tw * th ? 3 : 2;
    int ett_set = P[PPF_ETTSET], ett_dir = P[PPF_ETTDIR];
    int ett_sqr = P[PPF_ETTSQR], fixed_tt = P[PPF_FIXEDTT];
    int shift = P[PPF_SHIFT];
    int32_t *ett_row = 0;
    const int32_t *ett_inv = 0;
    int ett_n = 0;
    if (blk[B_INTERTX]) {
        const int32_t *S2 = (const int32_t *)tc->mp[M_STATIC2];
        const int32_t *S3 = tc->S3;
        int pels = tw * th;
        shift = (pels > 256) + (pels > 1024);
        int tset = c_tx_set_inter(S2, S3, tx, blk[B_REDUCEDTX]);
        if (plane == 0) {
            ett_set = -1;
            fixed_tt = 0;
            if (!(tset == 0 || blk[B_QIDX] <= 0)) {
                ett_row = (int32_t *)tc->mp[M_IETX1 + tset - 1]
                    + S3[S3_TXSQR + tx] * 17;
                ett_inv = S3 + (tset == 1 ? S3_IINV1
                                : tset == 2 ? S3_IINV2 : S3_IINV3);
                ett_n = tset == 1 ? 16 : (tset == 2 ? 12 : 2);
            }
        } else {
            ett_set = -1;
            /* co-located luma tx type, masked by the inter set of
             * THIS tx (spec compute_tx_type for inter chroma) */
            if (S2[S2_SQRUP + tx] > 3) {
                fixed_tt = 0;
            } else {
                const uint8_t *gtt =
                    (const uint8_t *)tc->mp[M_GTXTYPE];
                int ly = blk[B_R]
                    + ((y4 - (blk[B_R] >> sy)) << sy);
                int lx = blk[B_C]
                    + ((x4 - (blk[B_C] >> sx)) << sx);
                if (ly > mi_rows - 1) ly = mi_rows - 1;
                if (lx > mi_cols - 1) lx = mi_cols - 1;
                int tt0 = gtt[(long)ly * mi_cols + lx];
                fixed_tt = ((S3[S3_ITTMASK + tset] >> tt0) & 1)
                    ? tt0 : 0;
            }
        }
    }
    int aw = S[S_AW + tx], ah = S[S_AH + tx];
    int tt = 0;
    unsigned long long _tc0 = _rdtsc();
    int eob = decode_tb_coeffs(
        m, ptrs, S, tc->scans, plane, x4, y4, tx, cw4, ch4,
        l_base, az, ett_set, ett_dir, ett_sqr, fixed_tt,
        P[PPF_DCQ], P[PPF_ACQ], shift, tc->clip,
        tc->coef_out + tc->coef_total, &tt, ett_row, ett_inv,
        ett_n);
    _prof[4] += _rdtsc() - _tc0; _prof[5]++;
    if (blk[B_INTERTX] && plane == 0 && eob > 0) {
        uint8_t *gtt = (uint8_t *)tc->mp[M_GTXTYPE];
        int re_ = y4 + h4 < mi_rows ? y4 + h4 : mi_rows;
        int ce_ = x4 + w4 < mi_cols ? x4 + w4 : mi_cols;
        for (int rr = y4; rr < re_; rr++)
            for (int cc = x4; cc < ce_; cc++)
                gtt[(long)rr * mi_cols + cc] = (uint8_t)tt;
    }
    if (eob > 0) {
        int32_t *tm = tc->tbmeta + (long long)tc->n_tbs * TBM_NF;
        tm[TBM_PLANE] = plane;
        tm[TBM_X] = x;
        tm[TBM_Y] = y;
        tm[TBM_TX] = tx;
        tm[TBM_OFF] = tc->coef_total;
        tm[TBM_EOB] = eob;
        tm[TBM_TT] = tt;
        tm[TBM_OPROW] = tc->n_ops - 1;
        tc->n_tbs++;
        tc->coef_total += aw * ah;
    }
}

static int c_find_tx(const int32_t *S, int w, int h)
{
    for (int t = 0; t < 19; t++)
        if (S[S_TXW + t] == w && S[S_TXH + t] == h)
            return t;
    return 0;
}

static void parse_inter_tree(TbCtx *tc, int x, int y, int w, int h)
{
    /* spec transform_tree over the var-tx leaf grid */
    if (x >= tc->max_px || y >= tc->max_py)
        return;
    const uint8_t *git = (const uint8_t *)tc->mp[M_GINTERTX];
    int ltx = git[(long)(y >> 2) * tc->mi_cols + (x >> 2)];
    int lw = tc->S[S_TXW + ltx], lh = tc->S[S_TXH + ltx];
    if (w <= lw && h <= lh) {
        parse_tb(tc, x, y, c_find_tx(tc->S, w, h));
    } else if (w > h) {
        parse_inter_tree(tc, x, y, w / 2, h);
        parse_inter_tree(tc, x + w / 2, y, w / 2, h);
    } else if (w < h) {
        parse_inter_tree(tc, x, y, w, h / 2);
        parse_inter_tree(tc, x, y + h / 2, w, h / 2);
    } else {
        int hw = w / 2, hh = h / 2;
        parse_inter_tree(tc, x, y, hw, hh);
        parse_inter_tree(tc, x + hw, y, hw, hh);
        parse_inter_tree(tc, x, y + hh, hw, hh);
        parse_inter_tree(tc, x + hw, y + hh, hw, hh);
    }
}

static void block_parse_core(
    Msac *mm, const long long *ptrs, const int32_t *blk,
    const int32_t *pp, int nplanes, int32_t *ops, int32_t *coef_out,
    int32_t *tbmeta, long long clip, int32_t *inout,
    const long long *mp, const int32_t *S3)
{
    Msac m = *mm;

    const int32_t *S = (const int32_t *)ptrs[P_STATIC];
    const int32_t *scans = (const int32_t *)ptrs[P_SCANS];
    int r = blk[B_R], c = blk[B_C];
    int skip = blk[B_SKIP];
    int sb_r = blk[B_SBR], sb_c = blk[B_SBC];
    int sbrow = blk[B_SBROW];
    int mi_rows = blk[B_MIROWS], mi_cols = blk[B_MICOLS];
    int eef = blk[B_EEF];
    int n_ops = 0, n_tbs = 0;
    int coef_total = inout[4];

    /* BlockDecoded reset on superblock entry (spec 5.11.30 halos,
     * ported from av1_recon._SbDecoded.reset) */
    if (blk[B_NEWSB]) {
        for (int plane = 0; plane < blk[B_NPALL]; plane++) {
            const int32_t *P = pp + plane * PPF_NF;
            int dmh = P[PPF_DMH], dmw = P[PPF_DMW];
            int sx = P[PPF_SX], sy = P[PPF_SY];
            uint8_t *dmap = (uint8_t *)ptrs[Q_DEC0 + plane];
            memset(dmap, 0, (size_t)dmh * dmw);
            int sb_w4 = ((blk[B_C1T] - sb_c) + sx) >> sx;
            int sb_h4 = ((blk[B_R1T] - sb_r) + sy) >> sy;
            int w_lim = sb_w4 < dmw - 1 ? sb_w4 : dmw - 1;
            for (int k = 0; k < w_lim; k++)
                dmap[1 + k] = 1;
            dmap[0] = 1;
            int h_lim = sb_h4 < dmh - 1 ? sb_h4 : dmh - 1;
            for (int k = 0; k < h_lim; k++)
                dmap[(1 + k) * dmw] = 1;
            /* sb4>>sy derived: dec map height = (sb4>>sy)+3 */
            int bl = (dmh - 3) + 1;
            if (bl > dmh - 1) bl = dmh - 1;
            dmap[bl * dmw] = 0;
        }
    }

    int w_chunks = blk[B_WCH], h_chunks = blk[B_HCH];
    TbCtx tc;
    tc.m = &m;
    tc.ptrs = ptrs;
    tc.S = S;
    tc.scans = scans;
    tc.blk = blk;
    tc.ops = ops;
    tc.coef_out = coef_out;
    tc.tbmeta = tbmeta;
    tc.inout = inout;
    tc.clip = clip;
    tc.n_ops = 0;
    tc.n_tbs = 0;
    tc.coef_total = coef_total;
    tc.mi_rows = mi_rows;
    tc.mi_cols = mi_cols;
    tc.sb_r = sb_r;
    tc.sb_c = sb_c;
    tc.sbrow = sbrow;
    tc.eef = eef;
    tc.skip = skip;
    tc.mp = mp;
    tc.S3 = S3;
    for (int cy = 0; cy < h_chunks; cy++)
    for (int cx = 0; cx < w_chunks; cx++)
    for (int plane = 0; plane < nplanes; plane++) {
        const int32_t *P = pp + plane * PPF_NF;
        int sx = P[PPF_SX], sy = P[PPF_SY];
        int tx = P[PPF_TX];
        int num4w = P[PPF_NUM4W], num4h = P[PPF_NUM4H];
        int step_x = S[S_TXW + tx] >> 2, step_y = S[S_TXH + tx] >> 2;
        int base_x = ((c >> sx) + (cx << (4 - sx))) * 4;
        int base_y = ((r >> sy) + (cy << (4 - sy))) * 4;
        tc.P = P;
        tc.plane = plane;
        tc.sx = sx;
        tc.sy = sy;
        tc.max_px = (mi_cols * 4) >> sx;
        tc.max_py = (mi_rows * 4) >> sy;
        tc.blk_px = (c >> sx) << 2;
        tc.blk_py = (r >> sy) << 2;
        if (blk[B_INTERTX] && plane == 0) {
            /* luma TBs follow the var-tx leaf grid in the
             * transform_tree recursion order (spec 5.11.36) */
            parse_inter_tree(&tc, base_x, base_y, num4w * 4,
                             num4h * 4);
            continue;
        }
        for (int yy = 0; yy < num4h; yy += step_y)
        for (int xx = 0; xx < num4w; xx += step_x)
            parse_tb(&tc, base_x + 4 * xx, base_y + 4 * yy, tx);
    }
    n_ops = tc.n_ops;
    n_tbs = tc.n_tbs;
    coef_total = tc.coef_total;
    *mm = m;
    inout[2] = n_ops;
    inout[3] = n_tbs;
    inout[4] = coef_total;
}

EXPORT void av1_block_parse(
    const uint8_t *data, long long data_len, long long *st,
    const long long *ptrs, const int32_t *blk, const int32_t *pp,
    int nplanes, int32_t *ops, int32_t *coef_out, int32_t *tbmeta,
    long long clip, int32_t *inout)
{
    Msac m;
    m.data = data;
    m.end8 = data_len * 8;
    m.dif = (uint32_t)st[0];
    m.rng = (uint32_t)st[1];
    m.cnt = (int32_t)st[2];
    m.bitpos = st[3];
    m.allow_update = (int)st[4];
    m.win_b0 = -16;
    m.win = 0;
    block_parse_core(&m, ptrs, blk, pp, nplanes, ops, coef_out,
                     tbmeta, clip, inout, 0, 0);
    st[0] = m.dif;
    st[1] = m.rng;
    st[2] = m.cnt;
    st[3] = m.bitpos;
}

/* ------------------------------------------------------------------ *
 * Per-block MODE-INFO symbol decode (spec 5.11.6 subset for intra
 * frames): segment id (pre/post-skip), skip, cdef idx, delta q/lf,
 * intrabc gate, y mode + angle, uv mode + CfL + angle, palette
 * gates, filter-intra, tx-size depth — 1:1 port of
 * av1_tile.py:decode_block's symbol reads.  Grid writes
 * (bsize/modes/...) stay in Python; the a_txw/l_txh tx context rows,
 * cdef_idx grid and luma tx grids update here (they gate later
 * symbols).  Partition symbols stay in Python (few per superblock).
 * ------------------------------------------------------------------ */

/* (mode pointer table moved to the top of the file) */

/* (S2 layout moved to the top of the file) */

/* blk2 record */
enum { K_R, K_C, K_BSIZE, K_AVAILU, K_AVAILL, K_HASCHROMA,
       K_SEGEN, K_PRESKIP, K_LASTSEG, K_R0, K_C0, K_SBMASK,
       K_CDEFGATE, K_CDEFBITS, K_CDEFW,
       K_READDELTAS, K_DQPRES, K_DQRES, K_DLFPRES, K_DLFMULTI,
       K_DLFRES, K_NPLANES, K_SBBSIZE, K_ALLOWIBC, K_ALLOWSCT,
       K_ENFI, K_TXSELECT, K_LOSSLESS, K_MIROWS, K_MICOLS,
       K_SUBX, K_SUBY, K_BITDEPTH, K_R1, K_C1,
       K_NF };

/* out record */
enum { O_ERR, O_SEGID, O_SKIP, O_YMODE, O_ANGLEY, O_UVMODE,
       O_ANGLEUV, O_CFLU, O_CFLV, O_FIM, O_TXSIZE, O_QINDEX,
       O_DLF0, O_DLF1, O_DLF2, O_DLF3, O_READDELTAS,
       O_NPALY, O_NPALU, O_PALLEN, O_ISIBC, O_MVROW, O_MVCOL,
       O_NF };

static int neg_deinterleave(int diff, int ref, int mx)
{
    if (!ref)
        return diff;
    if (ref >= mx - 1)
        return mx - diff - 1;
    if (2 * ref < mx) {
        if (diff <= 2 * ref) {
            if (diff & 1)
                return ref + ((diff + 1) >> 1);
            return ref - (diff >> 1);
        }
        return diff;
    }
    if (diff <= 2 * (mx - ref - 1)) {
        if (diff & 1)
            return ref + ((diff + 1) >> 1);
        return ref - (diff >> 1);
    }
    return mx - (diff + 1);
}

static inline int msac_literal(Msac *m, int n)
{
    int v = 0;
    for (int i = 0; i < n; i++)
        v = (v << 1) | msac_bool_equi(m);
    return v;
}

/* ---- palette mode (spec 5.11.45/46 colors, 5.11.49/50 index maps;
 * 1:1 with the Python oracle in av1_tile.py:_read_palette_plane/
 * _read_palette_v/_read_palette_map/_palette_color_context, which
 * stays as the FFPIC_AV1_NO_NATIVE path).  The C reference has no
 * AV1 layer at all. */

static inline int bitlen(int v);

static inline int ceil_log2_c(int x)
{
    return x < 2 ? 0 : bitlen(x - 1);
}

/* ns(n), spec 4.10.7 (av1_msac.decode_ns) */
static int msac_ns(Msac *m, int n)
{
    int w = bitlen(n);
    int mv = (1 << w) - n;
    int v = w > 1 ? msac_literal(m, w - 1) : 0;
    if (v < mv)
        return v;
    return (v << 1) - mv + msac_bool_equi(m);
}

/* merged sorted dedup of the above/left neighbor palettes
 * (get_palette_cache); above/left are ascending.  Returns count. */
static int pal_cache_merge(const uint16_t *above, int na,
                           const uint16_t *left, int nl, int *out)
{
    int ai = 0, li = 0, n = 0;
    while (ai < na && li < nl) {
        int va = above[ai], vl = left[li];
        if (vl < va) {
            if (!n || out[n - 1] != vl) out[n++] = vl;
            li++;
        } else {
            if (!n || out[n - 1] != va) out[n++] = va;
            ai++;
            if (vl == va) li++;
        }
    }
    for (; ai < na; ai++)
        if (!n || out[n - 1] != above[ai]) out[n++] = above[ai];
    for (; li < nl; li++)
        if (!n || out[n - 1] != left[li]) out[n++] = left[li];
    return n;
}

/* Y/U palette colors: cache-reuse flags, then a literal plus
 * ascending deltas (Y +1, U +0) with shrinking bit widths; result is
 * the sorted merge of the cached and new runs (both ascending). */
static void pal_decode_plane(Msac *m, int plane, int sz, int bd,
                             const int *cache, int ncache,
                             int32_t *out)
{
    int mx = (1 << bd) - 1;
    int cached[8], ncached = 0;
    for (int i = 0; i < ncache && ncached < sz; i++)
        if (msac_bool_equi(m))
            cached[ncached++] = cache[i];
    int newc[8], nnew = 0;
    if (ncached < sz) {
        int prev = msac_literal(m, bd);
        newc[nnew++] = prev;
        if (ncached + nnew < sz) {
            int bits = bd - 3 + msac_literal(m, 2);
            int dplus = plane == 0 ? 1 : 0;
            while (ncached + nnew < sz) {
                int delta = msac_literal(m, bits) + dplus;
                prev = prev + delta;
                if (prev > mx) prev = mx;
                newc[nnew++] = prev;
                int rng = (1 << bd) - prev - dplus;
                int cl = ceil_log2_c(rng);
                if (cl < bits) bits = cl;
            }
        }
    }
    int ci = 0, ni = 0, n = 0;
    while (ci < ncached && ni < nnew)
        out[n++] = cached[ci] <= newc[ni] ? cached[ci++]
                                          : newc[ni++];
    while (ci < ncached) out[n++] = cached[ci++];
    while (ni < nnew) out[n++] = newc[ni++];
}

/* V palette: no cache; raw literals or signed deltas w/ wraparound */
static void pal_decode_v(Msac *m, int sz, int bd, int32_t *out)
{
    int mx = (1 << bd) - 1;
    if (msac_bool_equi(m)) {
        int bits = bd - 4 + msac_literal(m, 2);
        int prev = msac_literal(m, bd);
        out[0] = prev;
        for (int i = 1; i < sz; i++) {
            int delta = msac_literal(m, bits);
            if (delta && msac_bool_equi(m))
                delta = -delta;
            prev = (prev + delta) & mx;
            out[i] = prev;
        }
    } else {
        for (int i = 0; i < sz; i++)
            out[i] = msac_literal(m, bd);
    }
}

static const int PAL_CTX_LOOKUP[9] = { -1, -1, 0, -1, -1, 4, 3,
                                       2, 1 };

/* get_palette_color_context (spec 5.11.50): score the 3 decoded
 * neighbors, stable-sort the top 3 colors to the front of the order
 * permutation, hash the top scores into one of 5 contexts. */
static int pal_color_ctx(const uint8_t *mp, int stride, int y,
                         int x, int n, int *order)
{
    int scores[11] = { 0 };
    if (x > 0) {
        scores[mp[y * stride + x - 1]] += 2;
        if (y > 0)
            scores[mp[(y - 1) * stride + x - 1]] += 1;
    }
    if (y > 0)
        scores[mp[(y - 1) * stride + x]] += 2;
    int pad = n > 3 ? n : 3;
    for (int i = 0; i < pad; i++)
        order[i] = i;
    for (int i = 0; i < 3; i++) {
        int mx_s = scores[i], mx_i = i;
        for (int j = i + 1; j < n; j++)
            if (scores[j] > mx_s) { mx_s = scores[j]; mx_i = j; }
        if (mx_i != i) {
            int mc = order[mx_i];
            for (int k = mx_i; k > i; k--) {
                scores[k] = scores[k - 1];
                order[k] = order[k - 1];
            }
            scores[i] = mx_s;
            order[i] = mc;
        }
    }
    return PAL_CTX_LOOKUP[scores[0] + 2 * scores[1]
                          + 2 * scores[2]];
}

/* color-index map (palette_tokens): ns(n) first sample, then the
 * anti-diagonal wavefront with scored color reordering; offscreen
 * right/bottom padding replicates edges.  Writes int32 into the pal
 * arena (bh x bw row-major). */
static void pal_decode_map(Msac *m, int32_t *color_cdf /* family */,
                           int n, int bw, int bh, int w, int h,
                           int32_t *dst)
{
    uint8_t mp[64 * 64];
    mp[0] = (uint8_t)msac_ns(m, n);
    int order[11];
    for (int i = 1; i < w + h - 1; i++) {
        int first = i < w - 1 ? i : w - 1;
        int last = i - h + 1 > 0 ? i - h + 1 : 0;
        for (int j = first; j >= last; j--) {
            int y = i - j, x = j;
            int ctx = pal_color_ctx(mp, bw, y, x, n, order);
            int sym = msac_symbol(m, color_cdf + ctx * 9, n);
            mp[y * bw + x] = (uint8_t)order[sym];
        }
    }
    for (int y = 0; y < h; y++)
        for (int x = w; x < bw; x++)
            mp[y * bw + x] = mp[y * bw + w - 1];
    for (int y = h; y < bh; y++)
        for (int x = 0; x < bw; x++)
            mp[y * bw + x] = mp[(h - 1) * bw + x];
    for (int i = 0; i < bw * bh; i++)
        dst[i] = mp[i];
}

/* ---- intrabc DV machinery (1:1 with coding/av1_mv.py, the
 * FFPIC_AV1_NO_NATIVE oracle; spec 5.11.21/31/32 + the 7.10.2
 * adjacent scans restricted to INTRA_FRAME) */

static int dv_read_component(Msac *m, const long long *mp, int comp)
{
    int sign = msac_symbol(m, (int32_t *)mp[M_DVSIGN] + comp * 3,
                           2);
    int cls = msac_symbol(m, (int32_t *)mp[M_DVCLASS] + comp * 12,
                          11);
    int mag;
    if (cls == 0) {
        int d = msac_symbol(m, (int32_t *)mp[M_DVCLASS0] + comp * 3,
                            2);
        mag = ((d << 3) | (3 << 1) | 1) + 1;
    } else {
        int d = 0;
        for (int i = 0; i < cls; i++)
            d |= msac_symbol(m, (int32_t *)mp[M_DVBITS]
                             + (comp * 10 + i) * 3, 2) << i;
        mag = 2 << (cls + 2);
        mag += ((d << 3) | (3 << 1) | 1) + 1;
    }
    return sign ? -mag : mag;
}

typedef struct { int mv[2]; int weight; } DvCand;

static void dv_add(DvCand *stack, int *n, const uint8_t *gibc,
                   const int32_t *gmv, int mi_cols, int mr, int mc,
                   int weight)
{
    if (!gibc[(long)mr * mi_cols + mc])
        return;
    int r0 = gmv[((long)mr * mi_cols + mc) * 2];
    int c0 = gmv[((long)mr * mi_cols + mc) * 2 + 1];
    for (int i = 0; i < *n; i++)
        if (stack[i].mv[0] == r0 && stack[i].mv[1] == c0) {
            stack[i].weight += weight;
            return;
        }
    if (*n < 8) {
        stack[*n].mv[0] = r0;
        stack[*n].mv[1] = c0;
        stack[*n].weight = weight;
        (*n)++;
    }
}

static inline int dv_r2s8(int v)
{
    int a = v < 0 ? -v : v;
    a = ((a + 4) >> 3) * 8;
    return v < 0 ? -a : a;
}

static void dv_find_pred(const long long *mp, const int32_t *blk,
                         const int32_t *S2, int r, int c, int bsize,
                         int sb4, int pred[2])
{
    const uint8_t *gibc = (const uint8_t *)mp[M_GIBC];
    const uint8_t *gbs = (const uint8_t *)mp[M_GBSIZE];
    const int32_t *gmv = (const int32_t *)mp[M_GMV];
    int mi_rows = blk[K_MIROWS], mi_cols = blk[K_MICOLS];
    int r0t = blk[K_R0], c0t = blk[K_C0];
    int r1t = blk[K_R1], c1t = blk[K_C1];
    int bw4 = S2[S2_BW4 + bsize], bh4 = S2[S2_BH4 + bsize];
    DvCand stack[8];
    int n = 0;
    if (r > r0t) {                        /* scan_row_mbmi(-1) */
        int end4 = bw4 < mi_cols - c ? bw4 : mi_cols - c;
        if (end4 > 16) end4 = 16;
        int step16 = bw4 >= 16;
        int i = 0;
        while (i < end4) {
            int mc = c + i;
            if (mc < c0t || mc >= c1t)
                break;
            int ln = S2[S2_BW4 + gbs[(long)(r - 1) * mi_cols + mc]];
            if (ln > bw4) ln = bw4;
            if (step16 && ln < 4) ln = 4;
            dv_add(stack, &n, gibc, gmv, mi_cols, r - 1, mc,
                   ln * 2);
            i += ln;
        }
    }
    if (c > c0t) {                        /* scan_col_mbmi(-1) */
        int end4 = bh4 < mi_rows - r ? bh4 : mi_rows - r;
        if (end4 > 16) end4 = 16;
        int step16 = bh4 >= 16;
        int i = 0;
        while (i < end4) {
            int mr = r + i;
            if (mr < r0t || mr >= r1t)
                break;
            int ln = S2[S2_BH4 + gbs[(long)mr * mi_cols + c - 1]];
            if (ln > bh4) ln = bh4;
            if (step16 && ln < 4) ln = 4;
            dv_add(stack, &n, gibc, gmv, mi_cols, mr, c - 1,
                   ln * 2);
            i += ln;
        }
    }
    if ((bw4 > bh4 ? bw4 : bh4) <= 16 && r > r0t) {   /* top-right */
        int mc = c + bw4;
        if (mc >= c0t && mc < c1t && mc < mi_cols)
            dv_add(stack, &n, gibc, gmv, mi_cols, r - 1, mc, 4);
    }
    /* stable sort by weight desc (n <= 8) */
    for (int i = 1; i < n; i++) {
        DvCand t = stack[i];
        int j = i - 1;
        while (j >= 0 && stack[j].weight < t.weight) {
            stack[j + 1] = stack[j];
            j--;
        }
        stack[j + 1] = t;
    }
    int pr = 0, pc = 0;
    for (int i = 0; i < (n < 2 ? n : 2); i++)
        if (stack[i].mv[0] || stack[i].mv[1]) {
            pr = stack[i].mv[0];
            pc = stack[i].mv[1];
            break;
        }
    if (pr == 0 && pc == 0) {
        int sb_px = sb4 * 4;
        int sb_row = (r - r0t) / sb4;
        if (sb_row == 0) {
            pred[0] = 0;
            pred[1] = -((sb_px + 256) * 8);
        } else {
            pred[0] = -(sb_px * 8);
            pred[1] = 0;
        }
        return;
    }
    pr = dv_r2s8(pr);
    pc = dv_r2s8(pc);
    int border_r = 128 + bh4 * 4 * 8;
    int border_c = 128 + bw4 * 4 * 8;
    int mb_top = -(r * 32);
    int mb_bottom = (mi_rows - bh4 - r) * 32;
    int mb_left = -(c * 32);
    int mb_right = (mi_cols - bw4 - c) * 32;
    if (pr < mb_top - border_r) pr = mb_top - border_r;
    if (pr > mb_bottom + border_r) pr = mb_bottom + border_r;
    if (pc < mb_left - border_c) pc = mb_left - border_c;
    if (pc > mb_right + border_c) pc = mb_right + border_c;
    pred[0] = pr;
    pred[1] = pc;
}

static void block_mode_core(
    Msac *m_, const long long *mp, const int32_t *blk, int32_t *out,
    int32_t *pal)
{
    Msac m = *m_;

    const int32_t *S = (const int32_t *)mp[M_STATIC2];
    int r = blk[K_R], c = blk[K_C], bsize = blk[K_BSIZE];
    int mi_cols = blk[K_MICOLS], mi_rows = blk[K_MIROWS];
    int avail_u = blk[K_AVAILU], avail_l = blk[K_AVAILL];
    int bw4 = S[S2_BW4 + bsize], bh4 = S[S2_BH4 + bsize];
    int re = r + bh4 < mi_rows ? r + bh4 : mi_rows;
    int ce = c + bw4 < mi_cols ? c + bw4 : mi_cols;
    const uint8_t *gskip = (const uint8_t *)mp[M_GSKIP];
    const uint8_t *gseg = (const uint8_t *)mp[M_GSEG];
    const uint8_t *gymode = (const uint8_t *)mp[M_GYMODE];
    const uint8_t *gpal = (const uint8_t *)mp[M_GPAL];
    out[O_ERR] = 0;

    /* ---- segment id reader (spec 5.11.8/5.9.13) */
    int seg_id = 0;
    int r0t = blk[K_R0], c0t = blk[K_C0];
#define READ_SEG(skipv) do {                                        \
        int pu = r > r0t ? gseg[(r - 1) * mi_cols + c] : -1;        \
        int pl = c > c0t ? gseg[r * mi_cols + c - 1] : -1;          \
        int pul = (r > r0t && c > c0t)                              \
                  ? gseg[(r - 1) * mi_cols + c - 1] : -1;           \
        int pred;                                                    \
        if (pu == -1) pred = pl == -1 ? 0 : pl;                      \
        else if (pl == -1) pred = pu;                                \
        else pred = pul == pu ? pu : pl;                             \
        if (skipv) { seg_id = pred; break; }                         \
        int ctx;                                                     \
        if (pul >= 0 && pul == pu && pul == pl) ctx = 2;             \
        else if (pul >= 0 && (pul == pu || pul == pl || pu == pl))   \
            ctx = 1;                                                 \
        else ctx = 0;                                                \
        int diff = msac_symbol(&m, (int32_t *)mp[M_SPATSEG]          \
                               + ctx * 9, 8);                        \
        int sv = neg_deinterleave(diff, pred,                        \
                                  blk[K_LASTSEG] + 1);               \
        seg_id = sv < 0 ? 0 : (sv > blk[K_LASTSEG]                   \
                               ? blk[K_LASTSEG] : sv);               \
    } while (0)

    if (blk[K_SEGEN] && blk[K_PRESKIP])
        READ_SEG(0);

    /* ---- skip */
    int ctx = 0;
    if (avail_u && gskip[(r - 1) * mi_cols + c]) ctx++;
    if (avail_l && gskip[r * mi_cols + c - 1]) ctx++;
    int skip = msac_symbol(&m, (int32_t *)mp[M_SKIPCDF] + ctx * 3,
                           2);
    if (blk[K_SEGEN] && !blk[K_PRESKIP])
        READ_SEG(skip);
    out[O_SEGID] = seg_id;
    out[O_SKIP] = skip;

    /* ---- cdef (spec 5.11.56: ONE literal per block, 64-aligned) */
    if (blk[K_CDEFGATE] && !skip) {
        int32_t *gcdef = (int32_t *)mp[M_GCDEF];
        int cw = blk[K_CDEFW];
        int r1 = r >> 4, c1 = c >> 4;
        int ch = (mi_rows + 15) >> 4;
        int cwid = (mi_cols + 15) >> 4;
        if (gcdef[r1 * cwid + c1] < 0) {
            int v = msac_literal(&m, blk[K_CDEFBITS]);
            int rr_e = (((r & ~15) + bh4 + 15) >> 4);
            int cc_e = (((c & ~15) + bw4 + 15) >> 4);
            if (rr_e > ch) rr_e = ch;
            if (cc_e > cwid) cc_e = cwid;
            for (int rr = r1; rr < rr_e; rr++)
                for (int cc = c1; cc < cc_e; cc++)
                    gcdef[rr * cwid + cc] = v;
        }
        (void)cw;
    }

    /* ---- delta q / lf */
    int read_deltas = blk[K_READDELTAS];
    int qindex = out[O_QINDEX];     /* in: current_qindex */
    int dlf[4] = { out[O_DLF0], out[O_DLF1], out[O_DLF2],
                   out[O_DLF3] };
    if (read_deltas && !(bsize == blk[K_SBBSIZE] && skip)) {
        read_deltas = 0;
        if (blk[K_DQPRES]) {
            int dq = msac_symbol(&m, (int32_t *)mp[M_DELTAQ], 4);
            if (dq == 3) {
                int rb = msac_literal(&m, 3) + 1;
                dq = msac_literal(&m, rb) + (1 << rb) + 1;
            }
            if (dq) {
                if (msac_bool_equi(&m))
                    dq = -dq;
                qindex += dq << blk[K_DQRES];
                if (qindex < 1) qindex = 1;
                if (qindex > 255) qindex = 255;
            }
        }
        if (blk[K_DLFPRES]) {
            int n = blk[K_NPLANES] > 1 ? 4 : 2;
            int count = blk[K_DLFMULTI] ? n : 1;
            for (int i = 0; i < count; i++) {
                /* delta_lf_np rows: 0 = single, 1..4 = multi */
                int row = blk[K_DLFMULTI] ? 1 + i : 0;
                int la = msac_symbol(
                    &m, (int32_t *)mp[M_DELTALF] + row * 5, 4);
                if (la == 3) {
                    int rb = msac_literal(&m, 3) + 1;
                    la = msac_literal(&m, rb) + (1 << rb) + 1;
                }
                if (la) {
                    if (msac_bool_equi(&m))
                        la = -la;
                    int v = dlf[i] + (la << blk[K_DLFRES]);
                    if (v < -63) v = -63;
                    if (v > 63) v = 63;
                    dlf[i] = v;
                }
            }
        }
    }
    out[O_QINDEX] = qindex;
    out[O_DLF0] = dlf[0];
    out[O_DLF1] = dlf[1];
    out[O_DLF2] = dlf[2];
    out[O_DLF3] = dlf[3];
    out[O_READDELTAS] = read_deltas;

    /* ---- intrabc (spec 5.11.21): DC modes, predicted+residual DV;
     * tx coding continues inter-style in the superblock driver */
    out[O_ISIBC] = 0;
    if (blk[K_ALLOWIBC]) {
        if (msac_symbol(&m, (int32_t *)mp[M_INTRABC], 2)) {
            int pred[2];
            dv_find_pred(mp, blk, S, r, c, bsize,
                         blk[K_SBMASK] + 1, pred);
            int joint = msac_symbol(&m, (int32_t *)mp[M_DVJOINT],
                                    4);
            int dr = (joint == 2 || joint == 3)
                ? dv_read_component(&m, mp, 0) : 0;
            int dc = (joint == 1 || joint == 3)
                ? dv_read_component(&m, mp, 1) : 0;
            out[O_ISIBC] = 1;
            out[O_MVROW] = pred[0] + dr;
            out[O_MVCOL] = pred[1] + dc;
            out[O_YMODE] = 0;
            out[O_UVMODE] = 0;
            out[O_FIM] = -1;
            out[O_NPALY] = 0;
            out[O_NPALU] = 0;
            out[O_PALLEN] = 0;
            /* palette line buffers still record a no-palette
             * footprint for later neighbor ctx */
            if (blk[K_ALLOWSCT]) {
                uint8_t *an = (uint8_t *)mp[M_PALAN];
                uint8_t *ln = (uint8_t *)mp[M_PALLN];
                for (int cc = c; cc < ce; cc++)
                    an[cc * 2] = an[cc * 2 + 1] = 0;
                for (int rr = r; rr < re; rr++)
                    ln[rr * 2] = ln[rr * 2 + 1] = 0;
            }
            goto done;
        }
    }

    /* ---- y mode */
    {
        int am = avail_u ? gymode[(r - 1) * mi_cols + c] : 0;
        int lm = avail_l ? gymode[r * mi_cols + c - 1] : 0;
        int32_t *cdf = (int32_t *)mp[M_KFY]
            + (S[S2_IMC + am] * 5 + S[S2_IMC + lm]) * 14;
        int ym = msac_symbol(&m, cdf, 13);
        out[O_YMODE] = ym;
        out[O_ANGLEY] = 0;
        if (bsize >= 3 /* BLOCK_8X8 */ && ym >= 1 && ym <= 8)
            out[O_ANGLEY] = msac_symbol(
                &m, (int32_t *)mp[M_ANGLE] + (ym - 1) * 8, 7) - 3;
    }

    /* ---- uv mode */
    out[O_UVMODE] = 0;
    out[O_ANGLEUV] = 0;
    out[O_CFLU] = 0;
    out[O_CFLV] = 0;
    if (blk[K_HASCHROMA]) {
        /* CfL gate: lossless restricts CfL to blocks whose chroma
         * is a single forced-4x4 TB (4x4 luma at 444, 8x8 at 420;
         * dav1d cfl_allowed) */
        int cfl_ok = ((blk[K_LOSSLESS] >> seg_id) & 1)
            ? (bw4 <= (1 << blk[K_SUBX]) && bh4 <= (1 << blk[K_SUBY]))
            : (bw4 * 4 <= 32 && bh4 * 4 <= 32);
        int uv;
        if (cfl_ok)
            uv = msac_symbol(&m, (int32_t *)mp[M_UV1]
                             + out[O_YMODE] * 15, 14);
        else
            uv = msac_symbol(&m, (int32_t *)mp[M_UV0]
                             + out[O_YMODE] * 15, 13);
        out[O_UVMODE] = uv;
        if (uv == 13 /* UV_CFL_PRED */) {
            int joint = msac_symbol(&m, (int32_t *)mp[M_CFLSIGN],
                                    8);
            int su = (joint + 1) / 3;
            int sv = (joint + 1) % 3;
            if (su) {
                int idx = msac_symbol(
                    &m, (int32_t *)mp[M_CFLALPHA]
                    + (joint - 2) * 17, 16);
                out[O_CFLU] = (idx + 1) * (su == 2 ? 1 : -1);
            }
            if (sv) {
                int cx = sv * 3 + su - 3;
                int idx = msac_symbol(
                    &m, (int32_t *)mp[M_CFLALPHA] + cx * 17, 16);
                out[O_CFLV] = (idx + 1) * (sv == 2 ? 1 : -1);
            }
        }
        if (bsize >= 3 && uv >= 1 && uv <= 8)
            out[O_ANGLEUV] = msac_symbol(
                &m, (int32_t *)mp[M_ANGLE] + (uv - 1) * 8, 7) - 3;
    }

    /* ---- palette (spec 5.11.42/45/46: gates, sizes, colors) */
    int ny = 0, nu = 0;
    if (blk[K_ALLOWSCT] && bsize >= 3 && bw4 * 4 <= 64
        && bh4 * 4 <= 64) {
        int bd = blk[K_BITDEPTH];
        const uint8_t *an = (const uint8_t *)mp[M_PALAN];
        const uint16_t *ac = (const uint16_t *)mp[M_PALAC];
        const uint8_t *ln = (const uint8_t *)mp[M_PALLN];
        const uint16_t *lc = (const uint16_t *)mp[M_PALLC];
        int use_above = avail_u && (r & 15);
        int bctx = 0;
        for (int v = bw4 * 4; v > 1; v >>= 1) bctx++;
        for (int v = bh4 * 4; v > 1; v >>= 1) bctx++;
        bctx -= 6;              /* bit_length sums minus 8, +2 */
        /* (bw*4).bit_length() for pow2 v is log2(v)+1; two of them
         * minus 8 => log2(bw4*4)+log2(bh4*4)-6 */
        if (out[O_YMODE] == 0) {
            int pc = 0;
            if (avail_u && gpal[(r - 1) * mi_cols + c]) pc++;
            if (avail_l && gpal[r * mi_cols + c - 1]) pc++;
            if (msac_symbol(&m, (int32_t *)mp[M_PALY]
                            + (bctx * 3 + pc) * 3, 2)) {
                int sz = msac_symbol(&m, (int32_t *)mp[M_PALYSZ]
                                     + bctx * 8, 7) + 2;
                int cache[16];
                int nc = pal_cache_merge(
                    use_above ? ac + c * 16 : 0,
                    use_above ? an[c * 2] : 0,
                    avail_l ? lc + r * 16 : 0,
                    avail_l ? ln[r * 2] : 0, cache);
                pal_decode_plane(&m, 0, sz, bd, cache, nc,
                                 pal + PALH_COLY);
                ny = sz;
            }
        }
        if (blk[K_HASCHROMA] && out[O_UVMODE] == 0) {
            int uvc = ny ? 1 : 0;
            if (msac_symbol(&m, (int32_t *)mp[M_PALUV] + uvc * 3,
                            2)) {
                int sz = msac_symbol(&m, (int32_t *)mp[M_PALUVSZ]
                                     + bctx * 8, 7) + 2;
                int cache[16];
                int nc = pal_cache_merge(
                    use_above ? ac + c * 16 + 8 : 0,
                    use_above ? an[c * 2 + 1] : 0,
                    avail_l ? lc + r * 16 + 8 : 0,
                    avail_l ? ln[r * 2 + 1] : 0, cache);
                pal_decode_plane(&m, 1, sz, bd, cache, nc,
                                 pal + PALH_COLU);
                pal_decode_v(&m, sz, bd, pal + PALH_COLV);
                nu = sz;
            }
        }
    }

    /* ---- filter intra (palette-y excludes it, spec 5.11.42) */
    out[O_FIM] = -1;
    if (blk[K_ENFI] && out[O_YMODE] == 0 && !ny
        && (bw4 > bh4 ? bw4 : bh4) * 4 <= 32) {
        if (msac_symbol(&m, (int32_t *)mp[M_USEFI] + bsize * 3, 2))
            out[O_FIM] = msac_symbol(&m, (int32_t *)mp[M_FIMODE],
                                     5);
    }

    /* ---- palette index maps (palette_tokens: after full mode
     * info, before tx size) + the payload record for K_PALPRED
     * recon ops */
    int pallen = 0;
    if (ny || nu) {
        int sx = blk[K_SUBX], sy = blk[K_SUBY];
        for (int i = 0; i < PALH_COLY; i++)
            if (i != PALH_NY && i != PALH_NU)
                pal[i] = 0;
        pal[PALH_NY] = ny;
        pal[PALH_NU] = nu;
        int w4v = mi_cols - c < bw4 ? mi_cols - c : bw4;
        int h4v = mi_rows - r < bh4 ? mi_rows - r : bh4;
        int off = PALH_NF;
        if (ny) {
            int bw = bw4 * 4, bh = bh4 * 4;
            pal[PALH_BWY] = bw;
            pal[PALH_BHY] = bh;
            pal[PALH_PXY] = c * 4;
            pal[PALH_PYY] = r * 4;
            pal[PALH_MAPY] = off;
            pal_decode_map(&m, (int32_t *)mp[M_PALYCOL]
                           + (ny - 2) * 5 * 9, ny, bw, bh,
                           w4v * 4, h4v * 4, pal + off);
            off += bw * bh;
        }
        if (nu) {
            int bwc = ((bw4 + sx) >> sx) * 4;
            int bhc = ((bh4 + sy) >> sy) * 4;
            pal[PALH_BWUV] = bwc;
            pal[PALH_BHUV] = bhc;
            pal[PALH_PXUV] = (c >> sx) * 4;
            pal[PALH_PYUV] = (r >> sy) * 4;
            pal[PALH_MAPUV] = off;
            pal_decode_map(&m, (int32_t *)mp[M_PALUVCOL]
                           + (nu - 2) * 5 * 9, nu, bwc, bhc,
                           ((w4v + sx) >> sx) * 4,
                           ((h4v + sy) >> sy) * 4, pal + off);
            off += bwc * bhc;
        }
        pallen = off;
    }
    out[O_NPALY] = ny;
    out[O_NPALU] = nu;
    out[O_PALLEN] = pallen;

    /* ---- neighbor palette line buffers for later blocks (the
     * above row is only consulted within the same 64px superblock
     * row — the r & 15 gate above — so last-writer-wins per
     * column/row is exactly the (r-1,c)/(r,c-1) neighbor) */
    if (blk[K_ALLOWSCT]) {
        uint8_t *an = (uint8_t *)mp[M_PALAN];
        uint16_t *ac = (uint16_t *)mp[M_PALAC];
        uint8_t *ln = (uint8_t *)mp[M_PALLN];
        uint16_t *lc = (uint16_t *)mp[M_PALLC];
        for (int cc = c; cc < ce; cc++) {
            an[cc * 2] = (uint8_t)ny;
            an[cc * 2 + 1] = (uint8_t)nu;
            for (int k = 0; k < ny; k++)
                ac[cc * 16 + k] = (uint16_t)pal[PALH_COLY + k];
            for (int k = 0; k < nu; k++)
                ac[cc * 16 + 8 + k] = (uint16_t)pal[PALH_COLU + k];
        }
        for (int rr = r; rr < re; rr++) {
            ln[rr * 2] = (uint8_t)ny;
            ln[rr * 2 + 1] = (uint8_t)nu;
            for (int k = 0; k < ny; k++)
                lc[rr * 16 + k] = (uint16_t)pal[PALH_COLY + k];
            for (int k = 0; k < nu; k++)
                lc[rr * 16 + 8 + k] = (uint16_t)pal[PALH_COLU + k];
        }
    }

    /* ---- tx size (K_LOSSLESS is a per-segment bitmask: seg_id is
     * decoded above) */
    {
        int tx;
        if ((blk[K_LOSSLESS] >> seg_id) & 1) {
            tx = 0;             /* TX_4X4 */
        } else {
            int max_rect = S[S2_MAXRECT + bsize];
            tx = max_rect;
            if (blk[K_TXSELECT] && bsize > 0 && !skip) {
                int cat = S[S2_SQRUP + max_rect] - 1;
                int maxw = S[S2_TXW + max_rect];
                int maxh = S[S2_TXH + max_rect];
                int16_t *atxw = (int16_t *)mp[M_ATXW];
                int16_t *ltxh = (int16_t *)mp[M_LTXH];
                int above = atxw[c] >= maxw;
                int left = ltxh[r & blk[K_SBMASK]] >= maxh;
                /* libaom get_tx_size_context / dav1d tx_intra rows:
                 * an INTER-class neighbor (intrabc here — intra
                 * frames only on this path) contributes its BLOCK
                 * dimension, not its var-tx context */
                {
                    const uint8_t *gibc =
                        (const uint8_t *)mp[M_GIBC];
                    const uint8_t *gbs =
                        (const uint8_t *)mp[M_GBSIZE];
                    long mi_cols_l = blk[K_MICOLS];
                    if (r > r0t && gibc && gbs &&
                        gibc[(long)(r - 1) * mi_cols_l + c])
                        above = S[S2_BW4 +
                                  gbs[(long)(r - 1) * mi_cols_l + c]]
                                * 4 >= maxw;
                    if (c > c0t && gibc && gbs &&
                        gibc[(long)r * mi_cols_l + c - 1])
                        left = S[S2_BH4 +
                                 gbs[(long)r * mi_cols_l + c - 1]]
                               * 4 >= maxh;
                }
                int tctx;
                if (r > r0t && c > c0t) tctx = above + left;
                else if (r > r0t) tctx = above;
                else if (c > c0t) tctx = left;
                else tctx = 0;
                int n = cat == 0 ? 2 : 3;
                int depth = msac_symbol(
                    &m, (int32_t *)mp[M_TXDEPTH]
                    + (cat * 3 + tctx) * 4, n);
                for (int i = 0; i < depth; i++)
                    tx = S[S2_SPLITTX + tx];
            }
        }
        out[O_TXSIZE] = tx;
        int txw = S[S2_TXW + tx], txh = S[S2_TXH + tx];
        int16_t *atxw = (int16_t *)mp[M_ATXW];
        int16_t *ltxh = (int16_t *)mp[M_LTXH];
        for (int i = c; i < ce; i++) atxw[i] = (int16_t)txw;
        int lb = r & blk[K_SBMASK];
        for (int i = 0; i < re - r; i++)
            ltxh[lb + i] = (int16_t)txh;
        uint8_t *gtw = (uint8_t *)mp[M_GTXW4];
        uint8_t *gth = (uint8_t *)mp[M_GTXH4];
        for (int rr = r; rr < re; rr++)
            for (int cc = c; cc < ce; cc++) {
                gtw[rr * mi_cols + cc] = (uint8_t)(txw >> 2);
                gth[rr * mi_cols + cc] = (uint8_t)(txh >> 2);
            }
    }
done:
    *m_ = m;
}

EXPORT void av1_block_mode(
    const uint8_t *data, long long data_len, long long *st,
    const long long *mp, const int32_t *blk, int32_t *out,
    int32_t *pal)
{
    Msac m;
    m.data = data;
    m.end8 = data_len * 8;
    m.dif = (uint32_t)st[0];
    m.rng = (uint32_t)st[1];
    m.cnt = (int32_t)st[2];
    m.bitpos = st[3];
    m.allow_update = (int)st[4];
    m.win_b0 = -16;
    m.win = 0;
    block_mode_core(&m, mp, blk, out, pal);
    st[0] = m.dif;
    st[1] = m.rng;
    st[2] = m.cnt;
    st[3] = m.bitpos;
}

/* ---- CICP YUV -> RGBA color conversion (formats/avif.py oracle) ----
 *
 * Bit-identical to the numpy float32 path in formats/avif.py
 * (_yuv_to_rgba_np): integer 3/4-1/4 chroma upsample (vertical then
 * horizontal, edge-clamped, cropped after both axes), then per-sample
 * float32 normalization and CICP matrix with round-half-up
 * floorf(x + 0.5f).  fp-contract is disabled on this unit's hot loop
 * so GCC cannot fuse mul+add into FMAs — numpy evaluates each float32
 * op separately and the results must match bit-for-bit.
 *
 * modes: 0 = CICP matrix (kr/kb), 1 = identity (planes are G,B,R,
 * full resolution), 2 = monochrome (luma only).
 * Plane strides are in SAMPLES (elsize 1 or 2 bytes per sample).
 *
 * The C reference stubs AVIF at the frame level (format/avif.c) —
 * there is no corresponding reference color path.
 */

static void av1c_load_row(const uint8_t *p, long stride_el, int elsize,
                          int row, int n, int32_t *dst)
{
    if (elsize == 1) {
        const uint8_t *s = p + (long)row * stride_el;
        for (int i = 0; i < n; i++) dst[i] = s[i];
    } else {
        const uint16_t *s = (const uint16_t *)p + (long)row * stride_el;
        for (int i = 0; i < n; i++) dst[i] = s[i];
    }
}

/* vertically upsampled (or direct) chroma row j, width cw, into dst */
static void av1c_vrow(const uint8_t *p, long stride_el, int elsize,
                      int j, int ch, int cw, int sy,
                      int32_t *dst, int32_t *scratch)
{
    if (!sy) {
        av1c_load_row(p, stride_el, elsize, j < ch ? j : ch - 1, cw,
                      dst);
        return;
    }
    int i = j >> 1;
    int other = (j & 1) ? (i + 1 < ch ? i + 1 : ch - 1)
                        : (i > 0 ? i - 1 : 0);
    av1c_load_row(p, stride_el, elsize, i, cw, dst);
    av1c_load_row(p, stride_el, elsize, other, cw, scratch);
    for (int k = 0; k < cw; k++)
        dst[k] = (3 * dst[k] + scratch[k] + 2) >> 2;
}

/* horizontal upsample of src[cw] into dst[w] (w <= 2*cw), or crop */
static void av1c_hrow(const int32_t *src, int cw, int sx, int w,
                      int32_t *dst)
{
    if (!sx) {
        for (int k = 0; k < w; k++) dst[k] = src[k];
        return;
    }
    for (int k = 0; k * 2 < w; k++) {
        int prev = k > 0 ? src[k - 1] : src[0];
        int nxt = k + 1 < cw ? src[k + 1] : src[cw - 1];
        dst[2 * k] = (3 * src[k] + prev + 2) >> 2;
        if (2 * k + 1 < w)
            dst[2 * k + 1] = (3 * src[k] + nxt + 2) >> 2;
    }
}

__attribute__((optimize("fp-contract=off")))
EXPORT int av1_color_cicp(
    const uint8_t *Y, long ys, const uint8_t *U, long us,
    const uint8_t *V, long vs, int elsize,
    int h, int w, int ch, int cw, int sx, int sy,
    int bd, int limited, int mode, double kr, double kb,
    uint8_t *out)
{
    const float ysc = limited
        ? (float)(255.0 / (double)(219 << (bd - 8)))
        : (float)(255.0 / (double)((1 << bd) - 1));
    const float ylo = (float)(16 << (bd - 8));
    const float csc = limited
        ? (float)(255.0 / (double)(224 << (bd - 8)))
        : (float)(255.0 / (double)((1 << bd) - 1));
    const float mid = (float)(1 << (bd - 1));
    const float idsc = (float)(255.0 / (double)((1 << bd) - 1));
    const double kg = 1.0 - kr - kb;
    const float c_rv = (float)(2.0 * (1.0 - kr));
    const float c_bu = (float)(2.0 * (1.0 - kb));
    const float c_gu = (float)(2.0 * kb * (1.0 - kb) / kg);
    const float c_gv = (float)(2.0 * kr * (1.0 - kr) / kg);

    int32_t *buf = (int32_t *)malloc(
        (size_t)(3 * w + 3 * cw) * sizeof(int32_t));
    if (!buf) return -1;
    int32_t *ybuf = buf, *ubuf = buf + w, *vbuf = buf + 2 * w;
    int32_t *crow = buf + 3 * w, *scr = crow + cw, *crow2 = scr + cw;

    for (int y = 0; y < h; y++) {
        uint8_t *o = out + (long)y * w * 4;
        if (mode == 2) {                      /* monochrome */
            av1c_load_row(Y, ys, elsize, y, w, ybuf);
            for (int x = 0; x < w; x++) {
                float yy = limited ? ((float)ybuf[x] - ylo) * ysc
                                   : (float)ybuf[x] * ysc;
                float g = floorf(yy + 0.5f);
                uint8_t g8 = g < 0.0f ? 0
                    : (g > 255.0f ? 255 : (uint8_t)g);
                o[x * 4] = g8; o[x * 4 + 1] = g8; o[x * 4 + 2] = g8;
                o[x * 4 + 3] = 255;
            }
            continue;
        }
        if (mode == 1) {                      /* identity: G,B,R */
            av1c_load_row(Y, ys, elsize, y, w, ybuf);   /* G */
            av1c_load_row(U, us, elsize, y, w, ubuf);   /* B */
            av1c_load_row(V, vs, elsize, y, w, vbuf);   /* R */
            for (int x = 0; x < w; x++) {
                float g = floorf((float)ybuf[x] * idsc + 0.5f);
                float b = floorf((float)ubuf[x] * idsc + 0.5f);
                float r = floorf((float)vbuf[x] * idsc + 0.5f);
                o[x * 4] = r < 0.0f ? 0
                    : (r > 255.0f ? 255 : (uint8_t)r);
                o[x * 4 + 1] = g < 0.0f ? 0
                    : (g > 255.0f ? 255 : (uint8_t)g);
                o[x * 4 + 2] = b < 0.0f ? 0
                    : (b > 255.0f ? 255 : (uint8_t)b);
                o[x * 4 + 3] = 255;
            }
            continue;
        }
        av1c_load_row(Y, ys, elsize, y, w, ybuf);
        av1c_vrow(U, us, elsize, y, ch, cw, sy, crow, scr);
        av1c_hrow(crow, cw, sx, w, ubuf);
        av1c_vrow(V, vs, elsize, y, ch, cw, sy, crow2, scr);
        av1c_hrow(crow2, cw, sx, w, vbuf);
        for (int x = 0; x < w; x++) {
            float yy = limited ? ((float)ybuf[x] - ylo) * ysc
                               : (float)ybuf[x] * ysc;
            float uu = ((float)ubuf[x] - mid) * csc;
            float vv = ((float)vbuf[x] - mid) * csc;
            float r = floorf(yy + c_rv * vv + 0.5f);
            float b = floorf(yy + c_bu * uu + 0.5f);
            float g = floorf(yy - c_gu * uu - c_gv * vv + 0.5f);
            o[x * 4] = r < 0.0f ? 0 : (r > 255.0f ? 255 : (uint8_t)r);
            o[x * 4 + 1] = g < 0.0f ? 0
                : (g > 255.0f ? 255 : (uint8_t)g);
            o[x * 4 + 2] = b < 0.0f ? 0
                : (b > 255.0f ? 255 : (uint8_t)b);
            o[x * 4 + 3] = 255;
        }
    }
    free(buf);
    return 0;
}

/* ------------------------------------------------------------------ *
 * Whole-SUPERBLOCK parse driver (av1_sb_parse): the partition walk
 * (spec 5.11.4), per-block mode-info, grid record writes and the
 * residual TB walk all run in one C call per superblock — the fused
 * form of the per-block av1_block_mode + av1_block_parse pair (whose
 * EXPORTs remain as the tested per-block fallback path).  Python
 * keeps the per-superblock loop (loop-restoration syntax interleaves
 * there) and the per-tile CDF arena ownership.
 *
 * 1:1 port of av1_tile.py decode_partition/decode_block/
 * _residual_native glue; the C reference has no AV1 decoder at all
 * (format/avif.c:382-405 stub).
 * ------------------------------------------------------------------ */

/* extra pointer table */
enum { X_PART, X_GBSIZE, X_GUV, X_GBC0, X_GBR0, X_GQIDX, X_GDLF,
       X_QDC, X_QAC, X_SEGQ, X_S3, X_NPTRS };

/* (S3 layout moved to the top of the file) */

/* superblock/frame params */
enum { SBP_SBR, SBP_SBC, SBP_SB4, SBP_SBBSIZE,
       SBP_R0, SBP_R1, SBP_C0, SBP_C1, SBP_MIROWS, SBP_MICOLS,
       SBP_SEGEN, SBP_PRESKIP, SBP_LASTSEG,
       SBP_CDEFGATE, SBP_CDEFBITS,
       SBP_DQPRES, SBP_DQRES, SBP_DLFPRES, SBP_DLFMULTI, SBP_DLFRES,
       SBP_NPLANES, SBP_ALLOWIBC, SBP_ALLOWSCT, SBP_ENFI,
       SBP_TXSELECT, SBP_LOSSLESS, SBP_SUBX, SBP_SUBY,
       SBP_REDUCEDTX, SBP_DQYDC, SBP_DQUDC, SBP_DQUAC, SBP_DQVDC,
       SBP_DQVAC, SBP_EEF, SBP_BITDEPTH, SBP_NF };

/* io layout for av1_sb_parse (int32) */
enum { SIO_MLW, SIO_MLH, SIO_NOPS, SIO_NTBS, SIO_COEF,
       SIO_QINDEX, SIO_DLF0, SIO_DLF1, SIO_DLF2, SIO_DLF3,
       SIO_READDELTAS, SIO_ERR, SIO_NPAL, SIO_NF };

typedef struct {
    Msac m;
    const long long *ptrs, *mp, *xp;
    const int32_t *sbp, *S2, *S3;
    int32_t *ops, *coef, *tbmeta, *pal;
    long long clip;
    int32_t io[5];            /* block_parse_core in/out scratch */
    int n_ops, n_tbs, n_pal;
    int qindex, dlf[4], read_deltas;
    int sb_r, sb_c, new_sb;
    int err;
} SbCtx;

static inline int msac_bool_prob(Msac *m, int f)
{
    uint32_t rng = m->rng, dif = m->dif;
    uint32_t cur = (((rng >> 8) * ((uint32_t)f >> EC_PROB_SHIFT))
                    >> 1) + EC_MIN_PROB;
    if (dif >= cur) {
        msac_renorm(m, dif - cur, rng - cur);
        return 0;
    }
    msac_renorm(m, dif, cur);
    return 1;
}

static inline int bitlen(int v)
{
    int n = 0;
    while (v) { n++; v >>= 1; }
    return n;
}

static int gather_sum(const int32_t *cdf, int n, const int *syms,
                      int k)
{
    /* symbols past the family alphabet (extended partitions on an
     * 8x8 node) carry zero probability — odd-mi frames produce 8x8
     * frame-edge nodes where this matters */
    int total = 0;
    for (int i = 0; i < k; i++) {
        int s = syms[i];
        if (s >= n)
            continue;
        int hi = s == 0 ? 32768 : cdf[s - 1];
        int lo = s == n - 1 ? 0 : cdf[s];
        total += hi - lo;
    }
    return total;
}

static int c_get_qindex(const int32_t *segq, int seg, int q)
{
    int d = segq[seg];
    if (d > -(1 << 29))
        q += d;
    if (q < 0) q = 0;
    if (q > 255) q = 255;
    return q;
}

static inline int c_is_smooth(int mode)
{
    return mode >= 9 && mode <= 11;   /* SMOOTH / SMOOTH_V / _H */
}

static int c_tx_set_intra(const int32_t *S2, const int32_t *S3,
                          int tx, int reduced)
{
    if (S2[S2_SQRUP + tx] >= 3)    /* TX_32X32 */
        return 0;
    if (reduced)
        return 2;
    if (S3[S3_TXSQR + tx] == 2)    /* TX_16X16 */
        return 2;
    return 1;
}

static int c_chroma_tx_type(const int32_t *S2, const int32_t *S3,
                            int tx, int uv_mode, int reduced)
{
    if (S2[S2_SQRUP + tx] > 3)
        return 0;                  /* DCT_DCT */
    int tt = S3[S3_IM2TT + uv_mode];
    int tset = c_tx_set_intra(S2, S3, tx, reduced);
    if (!((S3[S3_TTINSET + tset] >> tt) & 1))
        return 0;
    return tt;
}

static int c_filter_type(SbCtx *t, int r, int c, int bsize,
                         int plane, int au, int al, int auc, int alc)
{
    const int32_t *sbp = t->sbp, *S2 = t->S2;
    int mi_cols = sbp[SBP_MICOLS];
    const uint8_t *modes;
    int a_ok, l_ok, rr = r, cc = c;
    if (plane == 0) {
        a_ok = au; l_ok = al;
        modes = (const uint8_t *)t->mp[M_GYMODE];
    } else {
        a_ok = auc; l_ok = alc;
        modes = (const uint8_t *)t->xp[X_GUV];
        if (sbp[SBP_SUBY] && S2[S2_BH4 + bsize] == 1)
            rr -= rr & 1;
        if (sbp[SBP_SUBX] && S2[S2_BW4 + bsize] == 1)
            cc -= cc & 1;
    }
    int above = 0, left = 0;
    if (a_ok)
        above = c_is_smooth(modes[(long)(rr - 1) * mi_cols + cc]);
    if (l_ok)
        left = c_is_smooth(modes[(long)rr * mi_cols + cc - 1]);
    return (above || left) ? 1 : 0;
}

/* read_var_tx_size (spec 5.11.35): recursive var-tx split for
 * intrabc blocks; leaves land in the inter_tx grid, the luma tx
 * dim grids and the tx ctx arrays (aom txfm_partition ctx) */
static void sb_read_var_tx(SbCtx *t, int r, int c, int tx,
                           int depth, int bsize)
{
    const int32_t *S2 = t->S2, *S3 = t->S3, *sbp = t->sbp;
    int mi_rows = sbp[SBP_MIROWS], mi_cols = sbp[SBP_MICOLS];
    if (r >= mi_rows || c >= mi_cols)
        return;
    int w4 = S2[S2_TXW + tx] >> 2, h4 = S2[S2_TXH + tx] >> 2;
    int split = 0;
    if (!(tx == 0 || depth == 2)) {
        int16_t *atxw = (int16_t *)t->mp[M_ATXW];
        int16_t *ltxh = (int16_t *)t->mp[M_LTXH];
        int above = atxw[c] < S2[S2_TXW + tx];
        int left = ltxh[r & (sbp[SBP_SB4] - 1)] < S2[S2_TXH + tx];
        int bw = S2[S2_BW4 + bsize] * 4, bh = S2[S2_BH4 + bsize] * 4;
        int size = bw > bh ? bw : bh;
        if (size > 64) size = 64;
        int max_tx = 0;
        for (int v = size >> 2; v > 1; v >>= 1) max_tx++;
        /* aom txfm_partition_context: term 1 marks recursive levels
         * (current tx no longer squares up to the block's max
         * square tx) — mirrored from av1_tile._txfm_split_ctx */
        int cat = ((S2[S2_SQRUP + tx] != max_tx && max_tx > 1)
                   ? 1 : 0) + (4 - max_tx) * 2;
        split = msac_symbol(&t->m, (int32_t *)t->mp[M_TXSPLIT]
                            + (cat * 3 + above + left) * 3, 2);
    }
    if (split) {
        int sub = S2[S2_SPLITTX + tx];
        int sw4 = S2[S2_TXW + sub] >> 2, sh4 = S2[S2_TXH + sub] >> 2;
        for (int rr = r; rr < r + h4; rr += sh4)
            for (int cc = c; cc < c + w4; cc += sw4)
                sb_read_var_tx(t, rr, cc, sub, depth + 1, bsize);
        return;
    }
    int re = r + h4 < mi_rows ? r + h4 : mi_rows;
    int ce = c + w4 < mi_cols ? c + w4 : mi_cols;
    uint8_t *git = (uint8_t *)t->mp[M_GINTERTX];
    uint8_t *gtw = (uint8_t *)t->mp[M_GTXW4];
    uint8_t *gth = (uint8_t *)t->mp[M_GTXH4];
    for (int rr = r; rr < re; rr++)
        for (int cc = c; cc < ce; cc++) {
            git[(long)rr * mi_cols + cc] = (uint8_t)tx;
            gtw[(long)rr * mi_cols + cc] = (uint8_t)w4;
            gth[(long)rr * mi_cols + cc] = (uint8_t)h4;
        }
    int16_t *atxw = (int16_t *)t->mp[M_ATXW];
    int16_t *ltxh = (int16_t *)t->mp[M_LTXH];
    for (int i = c; i < ce; i++)
        atxw[i] = (int16_t)S2[S2_TXW + tx];
    int lb = r & (sbp[SBP_SB4] - 1);
    for (int i = 0; i < re - r; i++)
        ltxh[lb + i] = (int16_t)S2[S2_TXH + tx];
}

static void sb_decode_block(SbCtx *t, int r, int c, int bsize)
{
    if (t->err)
        return;
    const int32_t *sbp = t->sbp, *S2 = t->S2, *S3 = t->S3;
    int mi_rows = sbp[SBP_MIROWS], mi_cols = sbp[SBP_MICOLS];
    int bw4 = S2[S2_BW4 + bsize], bh4 = S2[S2_BH4 + bsize];
    int r0 = sbp[SBP_R0], c0 = sbp[SBP_C0];
    int sx = sbp[SBP_SUBX], sy = sbp[SBP_SUBY];
    int nplanes_seq = sbp[SBP_NPLANES];
    int avail_u = r > r0, avail_l = c > c0;
    int has_chroma = nplanes_seq > 1
        && (bw4 != 1 || sx == 0 || (c & 1))
        && (bh4 != 1 || sy == 0 || (r & 1));
    int avail_uc = avail_u, avail_lc = avail_l;
    if (has_chroma) {
        if (sy && bh4 == 1) avail_uc = (r - 2) >= r0;
        if (sx && bw4 == 1) avail_lc = (c - 2) >= c0;
    }
    int re = r + bh4 < mi_rows ? r + bh4 : mi_rows;
    int ce = c + bw4 < mi_cols ? c + bw4 : mi_cols;

    /* ---- mode-info symbols */
    int32_t kblk[K_NF];
    kblk[K_R] = r; kblk[K_C] = c; kblk[K_BSIZE] = bsize;
    kblk[K_AVAILU] = avail_u; kblk[K_AVAILL] = avail_l;
    kblk[K_HASCHROMA] = has_chroma;
    kblk[K_SEGEN] = sbp[SBP_SEGEN];
    kblk[K_PRESKIP] = sbp[SBP_PRESKIP];
    kblk[K_LASTSEG] = sbp[SBP_LASTSEG];
    kblk[K_R0] = r0; kblk[K_C0] = c0;
    kblk[K_SBMASK] = sbp[SBP_SB4] - 1;
    kblk[K_CDEFGATE] = sbp[SBP_CDEFGATE];
    kblk[K_CDEFBITS] = sbp[SBP_CDEFBITS];
    kblk[K_CDEFW] = 0;
    kblk[K_READDELTAS] = t->read_deltas;
    kblk[K_DQPRES] = sbp[SBP_DQPRES];
    kblk[K_DQRES] = sbp[SBP_DQRES];
    kblk[K_DLFPRES] = sbp[SBP_DLFPRES];
    kblk[K_DLFMULTI] = sbp[SBP_DLFMULTI];
    kblk[K_DLFRES] = sbp[SBP_DLFRES];
    kblk[K_NPLANES] = nplanes_seq;
    kblk[K_SBBSIZE] = sbp[SBP_SBBSIZE];
    kblk[K_ALLOWIBC] = sbp[SBP_ALLOWIBC];
    kblk[K_ALLOWSCT] = sbp[SBP_ALLOWSCT];
    kblk[K_ENFI] = sbp[SBP_ENFI];
    kblk[K_TXSELECT] = sbp[SBP_TXSELECT];
    kblk[K_LOSSLESS] = sbp[SBP_LOSSLESS];
    kblk[K_MIROWS] = mi_rows; kblk[K_MICOLS] = mi_cols;
    kblk[K_SUBX] = sx; kblk[K_SUBY] = sy;
    kblk[K_BITDEPTH] = sbp[SBP_BITDEPTH];
    kblk[K_R1] = sbp[SBP_R1]; kblk[K_C1] = sbp[SBP_C1];

    int32_t out[O_NF];
    memset(out, 0, sizeof(out));
    out[O_QINDEX] = t->qindex;
    out[O_DLF0] = t->dlf[0]; out[O_DLF1] = t->dlf[1];
    out[O_DLF2] = t->dlf[2]; out[O_DLF3] = t->dlf[3];
    int pal_base = t->n_pal;
    unsigned long long _t0 = _rdtsc();
    block_mode_core(&t->m, t->mp, kblk, out, t->pal + pal_base);
    _prof[0] += _rdtsc() - _t0; _t0 = _rdtsc();
    if (out[O_ERR]) {
        t->err = out[O_ERR];
        return;
    }
    int ny = out[O_NPALY], nu = out[O_NPALU];
    t->n_pal += out[O_PALLEN];
    t->qindex = out[O_QINDEX];
    t->dlf[0] = out[O_DLF0]; t->dlf[1] = out[O_DLF1];
    t->dlf[2] = out[O_DLF2]; t->dlf[3] = out[O_DLF3];
    t->read_deltas = out[O_READDELTAS];

    int seg_id = out[O_SEGID], skip = out[O_SKIP];
    int y_mode = out[O_YMODE], angle_y = out[O_ANGLEY];
    int uv_mode = has_chroma ? out[O_UVMODE] : 0;
    int angle_uv = out[O_ANGLEUV];
    int cfl_u = out[O_CFLU], cfl_v = out[O_CFLV];
    int fim = out[O_FIM], tx_size = out[O_TXSIZE];
    int is_ibc = out[O_ISIBC];
    int mv_row = out[O_MVROW], mv_col = out[O_MVCOL];

    /* ---- record grids (av1_tile._record_block + delta_lf) */
    uint8_t *gbsize = (uint8_t *)t->xp[X_GBSIZE];
    uint16_t *gbc0 = (uint16_t *)t->xp[X_GBC0];
    uint16_t *gbr0 = (uint16_t *)t->xp[X_GBR0];
    uint8_t *gy = (uint8_t *)t->mp[M_GYMODE];
    uint8_t *guv = (uint8_t *)t->xp[X_GUV];
    uint8_t *gskip = (uint8_t *)t->mp[M_GSKIP];
    uint8_t *gseg = (uint8_t *)t->mp[M_GSEG];
    uint8_t *gqi = (uint8_t *)t->xp[X_GQIDX];
    int8_t *gdlf = (int8_t *)t->xp[X_GDLF];
    uint8_t *gpal = (uint8_t *)t->mp[M_GPAL];
    const int32_t *segq = (const int32_t *)t->xp[X_SEGQ];
    int qidx = c_get_qindex(segq, seg_id, t->qindex);
    for (int rr = r; rr < re; rr++)
        for (int cc = c; cc < ce; cc++) {
            long i = (long)rr * mi_cols + cc;
            gbsize[i] = (uint8_t)bsize;
            gbc0[i] = (uint16_t)c;
            gbr0[i] = (uint16_t)r;
            gy[i] = (uint8_t)y_mode;
            gskip[i] = (uint8_t)skip;
            gseg[i] = (uint8_t)seg_id;
            gqi[i] = (uint8_t)qidx;
            gpal[i] = (uint8_t)ny;
            if (is_ibc) {
                ((uint8_t *)t->mp[M_GIBC])[i] = 1;
                ((int32_t *)t->mp[M_GMV])[i * 2] = mv_row;
                ((int32_t *)t->mp[M_GMV])[i * 2 + 1] = mv_col;
            }
            gdlf[i * 4] = (int8_t)t->dlf[0];
            gdlf[i * 4 + 1] = (int8_t)t->dlf[1];
            gdlf[i * 4 + 2] = (int8_t)t->dlf[2];
            gdlf[i * 4 + 3] = (int8_t)t->dlf[3];
        }
    if (has_chroma) {
        int ru = r - ((sy && bh4 == 1) ? (r & 1) : 0);
        int cu = c - ((sx && bw4 == 1) ? (c & 1) : 0);
        for (int rr = ru; rr < re; rr++)
            for (int cc = cu; cc < ce; cc++)
                guv[(long)rr * mi_cols + cc] = (uint8_t)uv_mode;
    }

    /* ---- intrabc transform sizes (read_block_tx_size, inter
     * branch): var-tx tree under TX_MODE_SELECT, else the largest
     * rect with the skip-inter block-dim ctx rule */
    int lossless = (sbp[SBP_LOSSLESS] >> seg_id) & 1;
    if (is_ibc) {
        const int32_t *S2 = t->S2;
        int max_rect = S2[S2_MAXRECT + bsize];
        if (sbp[SBP_TXSELECT] && bsize > 0 && !skip && !lossless) {
            int txw4 = S2[S2_TXW + max_rect] >> 2;
            int txh4 = S2[S2_TXH + max_rect] >> 2;
            for (int rr = r; rr < r + bh4; rr += txh4)
                for (int cc = c; cc < c + bw4; cc += txw4)
                    sb_read_var_tx(t, rr, cc, max_rect, 0, bsize);
            tx_size = max_rect;
        } else {
            tx_size = lossless ? 0 : max_rect;
            uint8_t *git = (uint8_t *)t->mp[M_GINTERTX];
            uint8_t *gtw = (uint8_t *)t->mp[M_GTXW4];
            uint8_t *gth = (uint8_t *)t->mp[M_GTXH4];
            int w4v = S2[S2_TXW + tx_size] >> 2;
            int h4v = S2[S2_TXH + tx_size] >> 2;
            for (int rr = r; rr < re; rr++)
                for (int cc = c; cc < ce; cc++) {
                    git[(long)rr * mi_cols + cc] = (uint8_t)tx_size;
                    gtw[(long)rr * mi_cols + cc] = (uint8_t)w4v;
                    gth[(long)rr * mi_cols + cc] = (uint8_t)h4v;
                }
            int16_t *atxw = (int16_t *)t->mp[M_ATXW];
            int16_t *ltxh = (int16_t *)t->mp[M_LTXH];
            int aw_v = skip ? bw4 * 4 : S2[S2_TXW + tx_size];
            int lh_v = skip ? bh4 * 4 : S2[S2_TXH + tx_size];
            for (int i = c; i < ce; i++)
                atxw[i] = (int16_t)aw_v;
            int lb = r & (sbp[SBP_SB4] - 1);
            for (int i = 0; i < re - r; i++)
                ltxh[lb + i] = (int16_t)lh_v;
        }
    }

    /* ---- residual per-plane params (av1_tile._residual_native) */
    int nplanes = has_chroma ? nplanes_seq : 1;
    if (nplanes > 3) nplanes = 3;
    int w_chunks = bw4 > 16 ? bw4 >> 4 : 1;
    int h_chunks = bh4 > 16 ? bh4 >> 4 : 1;
    int cw4b = bw4 < 16 ? bw4 : 16;
    int ch4b = bh4 < 16 ? bh4 : 16;
    int sb4 = sbp[SBP_SB4];
    const int32_t *qdc = (const int32_t *)t->xp[X_QDC];
    const int32_t *qac = (const int32_t *)t->xp[X_QAC];
    int32_t pp[3 * PPF_NF];
    for (int plane = 0; plane < nplanes; plane++) {
        int psx = plane ? sx : 0, psy = plane ? sy : 0;
        int tx;
        if (lossless) tx = 0;
        else if (plane == 0) tx = tx_size;
        else tx = S3[S3_MAXUV + bsize * 4 + sx * 2 + sy];
        int num4w = cw4b >> psx; if (num4w < 1) num4w = 1;
        int num4h = ch4b >> psy; if (num4h < 1) num4h = 1;
        int mode, angle, pfim, alpha;
        if (plane == 0) {
            mode = y_mode; angle = angle_y; pfim = fim; alpha = 0;
        } else {
            mode = uv_mode; angle = angle_uv; pfim = -1;
            alpha = (mode == 13)
                ? (plane == 1 ? cfl_u : cfl_v) : 0;
        }
        int pred_mode = (plane > 0 && mode == 13) ? 0 : mode;
        int kind, p1;
        if (is_ibc) {
            /* intrabc: whole-pel block copy; DV col in P1, DV row
             * in the (otherwise unused) CFL_ALPHA op field */
            kind = K_IBC;
            p1 = mv_col;
        } else if (plane == 0 ? ny : nu) {
            /* palette prediction (index map -> colors) */
            kind = K_PALPRED; p1 = pal_base;
        } else if (pfim >= 0) {
            kind = K_FILTER; p1 = pfim;
        } else if (pred_mode == 0) {
            kind = K_DC; p1 = 0;
        } else if (pred_mode >= 1 && pred_mode <= 8) {
            kind = K_DIR;
            p1 = S3[S3_ANGLE + pred_mode] + angle * 3;
        } else {
            kind = S3[S3_KIND + pred_mode]; p1 = 0;
        }
        int ett_set = -1, ett_dir = 0, ett_sqr = 0, fixed_tt = 0;
        if (is_ibc) {
            /* tx types resolved per TB in parse_tb (inter sets) */
        } else if (plane > 0) {
            fixed_tt = lossless ? 0
                : c_chroma_tx_type(S2, S3, tx, uv_mode,
                                   sbp[SBP_REDUCEDTX]);
        } else if (!lossless) {
            int tset = c_tx_set_intra(S2, S3, tx,
                                      sbp[SBP_REDUCEDTX]);
            if (!(tset == 0 || qidx <= 0)) {
                ett_set = tset - 1;
                ett_dir = pfim >= 0 ? S3[S3_FIM2DIR + pfim]
                                    : y_mode;
                ett_sqr = S3[S3_TXSQR + tx];
            }
        }
        int dcd, acd;
        if (plane == 0) { dcd = sbp[SBP_DQYDC]; acd = 0; }
        else if (plane == 1) {
            dcd = sbp[SBP_DQUDC]; acd = sbp[SBP_DQUAC];
        } else {
            dcd = sbp[SBP_DQVDC]; acd = sbp[SBP_DQVAC];
        }
        int qi_dc = qidx + dcd;
        if (qi_dc < 0) qi_dc = 0; if (qi_dc > 255) qi_dc = 255;
        int qi_ac = qidx + acd;
        if (qi_ac < 0) qi_ac = 0; if (qi_ac > 255) qi_ac = 255;
        int pels = S2[S2_TXW + tx] * S2[S2_TXH + tx];
        int shift = (pels > 256 ? 1 : 0) + (pels > 1024 ? 1 : 0);
        int32_t *P = pp + plane * PPF_NF;
        P[PPF_TX] = tx;
        P[PPF_NUM4W] = num4w; P[PPF_NUM4H] = num4h;
        P[PPF_SX] = psx; P[PPF_SY] = psy;
        P[PPF_AVAILU] = plane ? avail_uc : avail_u;
        P[PPF_AVAILL] = plane ? avail_lc : avail_l;
        P[PPF_ETTSET] = ett_set; P[PPF_ETTDIR] = ett_dir;
        P[PPF_ETTSQR] = ett_sqr; P[PPF_FIXEDTT] = fixed_tt;
        P[PPF_DCQ] = qdc[qi_dc]; P[PPF_ACQ] = qac[qi_ac];
        P[PPF_SHIFT] = shift;
        P[PPF_KIND] = kind; P[PPF_P1] = p1;
        P[PPF_ALPHA] = is_ibc ? mv_row : alpha;
        P[PPF_FT] = c_filter_type(t, r, c, bsize, plane, avail_u,
                                  avail_l, avail_uc, avail_lc);
        /* all_zero-ctx plane dims: the FULL block's (get_txb_skip_ctx
         * compares block vs tx dims), not the 64x64 chunk's —
         * 128-wide blocks differ (num4w is chunk-clamped) */
        int pb4w = bw4 >> psx; if (pb4w < 1) pb4w = 1;
        int pb4h = bh4 >> psy; if (pb4h < 1) pb4h = 1;
        P[PPF_PBW] = pb4w * 4; P[PPF_PBH] = pb4h * 4;
        P[PPF_DMH] = (sb4 >> psy) + 3;
        P[PPF_DMW] = (sb4 >> psx) + 3;
    }
    /* reset rows for frame planes this block lacks */
    for (int plane = nplanes; plane < nplanes_seq; plane++) {
        int32_t *P = pp + plane * PPF_NF;
        memset(P, 0, PPF_NF * sizeof(int32_t));
        P[PPF_SX] = sx; P[PPF_SY] = sy;
        P[PPF_DMH] = (sb4 >> sy) + 3;
        P[PPF_DMW] = (sb4 >> sx) + 3;
    }

    /* ---- residual parse */
    int32_t bblk[B_NF];
    bblk[B_R] = r; bblk[B_C] = c;
    bblk[B_WCH] = w_chunks; bblk[B_HCH] = h_chunks;
    bblk[B_SKIP] = skip; bblk[B_NEWSB] = t->new_sb;
    bblk[B_SBR] = t->sb_r; bblk[B_SBC] = t->sb_c;
    bblk[B_SBROW] = t->sb_r;
    bblk[B_MIROWS] = mi_rows; bblk[B_MICOLS] = mi_cols;
    bblk[B_R1T] = sbp[SBP_R1]; bblk[B_C1T] = sbp[SBP_C1];
    bblk[B_EEF] = sbp[SBP_EEF]; bblk[B_NPALL] = nplanes_seq;
    bblk[B_INTERTX] = is_ibc && !lossless;
    bblk[B_QIDX] = qidx;
    bblk[B_REDUCEDTX] = sbp[SBP_REDUCEDTX];
    t->new_sb = 0;
    _prof[1] += _rdtsc() - _t0; _t0 = _rdtsc();
    block_parse_core(&t->m, t->ptrs, bblk, pp, nplanes,
                     t->ops + (long long)t->n_ops * OP_NF, t->coef,
                     t->tbmeta + (long long)t->n_tbs * TBM_NF,
                     t->clip, t->io, t->mp, t->S3);
    _prof[2] += _rdtsc() - _t0;
    int new_ops = t->io[2], new_tbs = t->io[3];
    for (int i = 0; i < new_tbs; i++) {
        int32_t *tm = t->tbmeta
            + (long long)(t->n_tbs + i) * TBM_NF;
        tm[TBM_OPROW] += t->n_ops;
        tm[TBM_LOSSLESS] = lossless;
    }
    t->n_ops += new_ops;
    t->n_tbs += new_tbs;
}

static void sb_decode_partition(SbCtx *t, int r, int c, int bsize)
{
    if (t->err)
        return;
    const int32_t *sbp = t->sbp, *S2 = t->S2, *S3 = t->S3;
    int mi_rows = sbp[SBP_MIROWS], mi_cols = sbp[SBP_MICOLS];
    if (r >= mi_rows || c >= mi_cols)
        return;
    int w4 = S2[S2_BW4 + bsize];
    int half = w4 >> 1, quarter = w4 >> 2;
    int has_rows = (r + half) < mi_rows;
    int has_cols = (c + half) < mi_cols;
    int B8 = S3[S3_B8], B128 = S3[S3_B128];
    int part;
    if (bsize < B8) {
        part = 0;
    } else {
        int wlog = bitlen(w4) - 1;
        int hlog = bitlen(S2[S2_BH4 + bsize]) - 1;
        const uint8_t *gb = (const uint8_t *)t->xp[X_GBSIZE];
        int above = 0, left = 0;
        if (r > sbp[SBP_R0]) {
            int nb = gb[(long)(r - 1) * mi_cols + c];
            if (nb != 255 && bitlen(S2[S2_BW4 + nb]) - 1 < wlog)
                above = 1;
        }
        if (c > sbp[SBP_C0]) {
            int nb = gb[(long)r * mi_cols + c - 1];
            if (nb != 255 && bitlen(S2[S2_BH4 + nb]) - 1 < hlog)
                left = 1;
        }
        int ctx = left * 2 + above;
        int n = bsize == B8 ? 4 : (bsize == B128 ? 8 : 10);
        int32_t *cdf = (int32_t *)t->xp[X_PART]
            + ((wlog - 1) * 4 + ctx) * 12;
        if (has_rows && has_cols) {
            part = msac_symbol(&t->m, cdf, n);
        } else if (has_cols) {
            static const int vsyms[6] = { 2, 3, 6, 7, 4, 9 };
            int k = bsize != B128 ? 6 : 5;
            int ps = gather_sum(cdf, n, vsyms, k);
            if (ps < 1) ps = 1;
            part = msac_bool_prob(&t->m, ps) ? 3 : 1;
        } else if (has_rows) {
            static const int hsyms[6] = { 1, 3, 4, 5, 6, 8 };
            int k = bsize != B128 ? 6 : 5;
            int ps = gather_sum(cdf, n, hsyms, k);
            if (ps < 1) ps = 1;
            part = msac_bool_prob(&t->m, ps) ? 3 : 2;
        } else {
            part = 3;
        }
    }
    if (part == 0) {
        sb_decode_block(t, r, c, bsize);
        return;
    }
    int sub = S3[S3_SUBSIZE + part * 22 + bsize];
    int split = S3[S3_SUBSIZE + 3 * 22 + bsize];
    switch (part) {
    case 1:                               /* HORZ */
        sb_decode_block(t, r, c, sub);
        if (has_rows) sb_decode_block(t, r + half, c, sub);
        break;
    case 2:                               /* VERT */
        sb_decode_block(t, r, c, sub);
        if (has_cols) sb_decode_block(t, r, c + half, sub);
        break;
    case 3:                               /* SPLIT */
        sb_decode_partition(t, r, c, sub);
        sb_decode_partition(t, r, c + half, sub);
        sb_decode_partition(t, r + half, c, sub);
        sb_decode_partition(t, r + half, c + half, sub);
        break;
    case 4:                               /* HORZ_A */
        sb_decode_block(t, r, c, split);
        sb_decode_block(t, r, c + half, split);
        sb_decode_block(t, r + half, c, sub);
        break;
    case 5:                               /* HORZ_B */
        sb_decode_block(t, r, c, sub);
        sb_decode_block(t, r + half, c, split);
        sb_decode_block(t, r + half, c + half, split);
        break;
    case 6:                               /* VERT_A */
        sb_decode_block(t, r, c, split);
        sb_decode_block(t, r + half, c, split);
        sb_decode_block(t, r, c + half, sub);
        break;
    case 7:                               /* VERT_B */
        sb_decode_block(t, r, c, sub);
        sb_decode_block(t, r, c + half, split);
        sb_decode_block(t, r + half, c + half, split);
        break;
    case 8:                               /* HORZ_4 */
        for (int i = 0; i < 4; i++) {
            int rr = r + i * quarter;
            if (i > 0 && rr >= mi_rows)
                break;
            sb_decode_block(t, rr, c, sub);
        }
        break;
    case 9:                               /* VERT_4 */
        for (int i = 0; i < 4; i++) {
            int cc = c + i * quarter;
            if (i > 0 && cc >= mi_cols)
                break;
            sb_decode_block(t, r, cc, sub);
        }
        break;
    }
}

EXPORT void av1_sb_parse(
    const uint8_t *data, long long data_len, long long *st,
    const long long *ptrs, const long long *mp,
    const long long *xp, const int32_t *sbp,
    int32_t *ops, int32_t *coef, int32_t *tbmeta, int32_t *pal,
    int32_t *io)
{
    SbCtx t;
    t.m.data = data;
    t.m.end8 = data_len * 8;
    t.m.dif = (uint32_t)st[0];
    t.m.rng = (uint32_t)st[1];
    t.m.cnt = (int32_t)st[2];
    t.m.bitpos = st[3];
    t.m.allow_update = (int)st[4];
    t.m.win_b0 = -16;
    t.m.win = 0;
    t.ptrs = ptrs; t.mp = mp; t.xp = xp; t.sbp = sbp;
    t.S2 = (const int32_t *)mp[M_STATIC2];
    t.S3 = (const int32_t *)xp[X_S3];
    t.ops = ops; t.coef = coef; t.tbmeta = tbmeta; t.pal = pal;
    t.clip = 1LL << (sbp[SBP_BITDEPTH] + 7);
    t.io[0] = io[SIO_MLW]; t.io[1] = io[SIO_MLH];
    t.io[2] = 0; t.io[3] = 0; t.io[4] = 0;
    t.n_ops = 0; t.n_tbs = 0; t.n_pal = 0;
    t.qindex = io[SIO_QINDEX];
    t.dlf[0] = io[SIO_DLF0]; t.dlf[1] = io[SIO_DLF1];
    t.dlf[2] = io[SIO_DLF2]; t.dlf[3] = io[SIO_DLF3];
    t.read_deltas = io[SIO_READDELTAS];
    t.sb_r = sbp[SBP_SBR]; t.sb_c = sbp[SBP_SBC];
    t.new_sb = 1;
    t.err = 0;

    sb_decode_partition(&t, t.sb_r, t.sb_c, sbp[SBP_SBBSIZE]);

    st[0] = t.m.dif;
    st[1] = t.m.rng;
    st[2] = t.m.cnt;
    st[3] = t.m.bitpos;
    io[SIO_MLW] = t.io[0]; io[SIO_MLH] = t.io[1];
    io[SIO_NOPS] = t.n_ops; io[SIO_NTBS] = t.n_tbs;
    io[SIO_COEF] = t.io[4];
    io[SIO_QINDEX] = t.qindex;
    io[SIO_DLF0] = t.dlf[0]; io[SIO_DLF1] = t.dlf[1];
    io[SIO_DLF2] = t.dlf[2]; io[SIO_DLF3] = t.dlf[3];
    io[SIO_READDELTAS] = t.read_deltas;
    io[SIO_ERR] = t.err;
    io[SIO_NPAL] = t.n_pal;
}

/* ------------------------------------------------------------------ *
 * Deblocking filter (spec 7.14), 1:1 port of the scalar oracle in
 * formats/av1_loopfilter.py (_deblock_pass_scalar / _filter_edge /
 * _filter_level): per-edge filter level from the delta-lf/segment
 * grids, tx/block edge masks, and the 4/6/8/14-tap normative filters.
 * One call per (plane, pass) on the int32 working plane.  The C
 * reference has no AV1 decode layer (format/avif.c:382-405 stub);
 * dav1d (inloop_filters mask) is the conformance oracle.
 *
 * prm layout (int32): [0] mi_rows [1] mi_cols [2] bd [3] sharpness
 * [4] subx [5] suby [6..9] loop_filter_level[4]
 * [10] delta_lf_present [11] delta_lf_multi [12] segmentation_enabled
 * [13] loop_filter_delta_enabled [14] ref_delta(INTRA_FRAME)
 * [15..78] seg feature table: (enabled, data) per (seg 0..7, level
 * class i 0..3 = SEG_LVL_ALT_LF_Y_V+i)
 * ------------------------------------------------------------------ */

typedef struct {
    const int32_t *prm;
    const uint8_t *seg;
    const int8_t *dlf;
    int mi_cols;
} DbkLvl;

static int dbk_level(const DbkLvl *d, int i, int r, int c)
{
    const int32_t *p = d->prm;
    int lvl = p[6 + i];
    if (p[10]) {
        int dl = d->dlf[((long)r * d->mi_cols + c) * 4
                        + (p[11] ? i : 0)];
        lvl = p[6 + i] + dl;
        if (lvl < 0) lvl = 0;
        if (lvl > 63) lvl = 63;
    }
    if (p[12]) {
        int s = d->seg[(long)r * d->mi_cols + c];
        if (p[15 + (s * 4 + i) * 2]) {
            lvl += p[15 + (s * 4 + i) * 2 + 1];
            if (lvl < 0) lvl = 0;
            if (lvl > 63) lvl = 63;
        }
    }
    if (p[13]) {
        lvl += p[14] << (lvl >> 5);
        if (lvl < 0) lvl = 0;
        if (lvl > 63) lvl = 63;
    }
    return lvl;
}

#define DP(k) q[-(long)((k) + 1) * st]
#define DQ(k) q[(long)(k) * st]

static inline int dbk_clip1(int v, int pixmax)
{
    return v < 0 ? 0 : (v > pixmax ? pixmax : v);
}

static void dbk_edge(int32_t *q, long st, int wd, int limit,
                     int blimit, int thresh, int bd)
{
    int p0 = DP(0), p1 = DP(1), q0 = DQ(0), q1 = DQ(1);
    int fm = abs(p1 - p0) <= limit && abs(q1 - q0) <= limit &&
        abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= blimit;
    if (wd > 4) {
        fm = fm && abs(DP(2) - p1) <= limit
                && abs(DQ(2) - q1) <= limit;
        if (wd > 6)
            fm = fm && abs(DP(3) - DP(2)) <= limit
                    && abs(DQ(3) - DQ(2)) <= limit;
    }
    if (!fm)
        return;
    int F = 1 << (bd - 8);
    int flat_in = 0;
    if (wd >= 6) {
        flat_in = abs(p1 - p0) <= F && abs(q1 - q0) <= F &&
            abs(DP(2) - p0) <= F && abs(DQ(2) - q0) <= F;
        if (wd >= 8)
            flat_in = flat_in && abs(DP(3) - p0) <= F &&
                abs(DQ(3) - q0) <= F;
    }
    if (wd >= 16 && flat_in) {
        int flat_out = 1;
        for (int j = 4; j < 7 && flat_out; j++)
            flat_out = abs(DP(j) - p0) <= F && abs(DQ(j) - q0) <= F;
        if (flat_out) {
            int p6 = DP(6), p5 = DP(5), p4 = DP(4), p3 = DP(3),
                p2 = DP(2);
            int q2 = DQ(2), q3 = DQ(3), q4 = DQ(4), q5 = DQ(5),
                q6 = DQ(6);
            DP(5) = (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0
                     + q0 + 8) >> 4;
            DP(4) = (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1
                     + p0 + q0 + q1 + 8) >> 4;
            DP(3) = (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1
                     + p0 + q0 + q1 + q2 + 8) >> 4;
            DP(2) = (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2
                     + p0 + q0 + q1 + q2 + q3 + 8) >> 4;
            DP(1) = (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2
                     + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4;
            DP(0) = (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2
                     + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4;
            DQ(0) = (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2
                     + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4;
            DQ(1) = (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2
                     + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4;
            DQ(2) = (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2
                     + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4;
            DQ(3) = (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2
                     + q4 * 2 + q5 + q6 * 4 + 8) >> 4;
            DQ(4) = (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2
                     + q5 * 2 + q6 * 5 + 8) >> 4;
            DQ(5) = (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2
                     + q6 * 7 + 8) >> 4;
            return;
        }
    }
    if (wd >= 8 && flat_in) {
        int p3 = DP(3), p2 = DP(2), q2 = DQ(2), q3 = DQ(3);
        DP(2) = (p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4) >> 3;
        DP(1) = (p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1 + 4) >> 3;
        DP(0) = (p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + 4) >> 3;
        DQ(0) = (p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + 4) >> 3;
        DQ(1) = (p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2 + 4) >> 3;
        DQ(2) = (p0 + q0 + q1 + q2 * 2 + q3 * 3 + 4) >> 3;
        return;
    }
    if (wd == 6 && flat_in) {
        int p2 = DP(2), q2 = DQ(2);
        DP(1) = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3;
        DP(0) = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3;
        DQ(0) = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3;
        DQ(1) = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3;
        return;
    }
    /* narrow filter (filter4) with high-edge-variance check */
    int hev = abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
    int lo = -128 * F, hi = 128 * F - 1;
    int pixmax = (1 << bd) - 1;
#define DCD(x) ((x) < lo ? lo : ((x) > hi ? hi : (x)))
    int f, f1, f2;
    if (hev) {
        f = DCD(p1 - q1);
        f = DCD(f + 3 * (q0 - p0));
        f1 = DCD(f + 4) >> 3;
        f2 = DCD(f + 3) >> 3;
        DP(0) = dbk_clip1(p0 + f2, pixmax);
        DQ(0) = dbk_clip1(q0 - f1, pixmax);
    } else {
        f = DCD(3 * (q0 - p0));
        f1 = DCD(f + 4) >> 3;
        f2 = DCD(f + 3) >> 3;
        DP(0) = dbk_clip1(p0 + f2, pixmax);
        DQ(0) = dbk_clip1(q0 - f1, pixmax);
        int f3 = (f1 + 1) >> 1;
        DP(1) = dbk_clip1(p1 + f3, pixmax);
        DQ(1) = dbk_clip1(q1 - f3, pixmax);
    }
#undef DCD
}

#undef DP
#undef DQ

EXPORT void av1_deblock_pass(
    int32_t *arr, int h, int w, int plane, int pass,
    const int32_t *prm, const uint8_t *txw, const uint8_t *txh,
    const uint16_t *bc0, const uint16_t *br0, const uint8_t *skip,
    const uint8_t *seg8, const int8_t *dlf)
{
    int mi_rows = prm[0], mi_cols = prm[1];
    int bd = prm[2], sharp = prm[3];
    int sx = plane ? prm[4] : 0, sy = plane ? prm[5] : 0;
    /* edges at x/y >= the FRAME extent are not filtered: the mi
     * grid is 8px-aligned, so a fully-padding mi column would
     * otherwise yield a phantom tx edge whose p-taps reach real
     * pixels (dav1d-divergent at e.g. 75px-wide frames) */
    int pfw = (prm[79] + sx) >> sx, pfh = (prm[80] + sy) >> sy;
    int n4c = w >> 2, n4r = h >> 2;
    if (((pfw + 3) >> 2) < n4c) n4c = (pfw + 3) >> 2;
    if (((pfh + 3) >> 2) < n4r) n4r = (pfh + 3) >> 2;
    int i = plane == 0 ? pass : plane + 1;
    int sc = 1 << (bd - 8);
    DbkLvl dl = { prm, seg8, dlf, mi_cols };
    for (int r4 = 0; r4 < n4r; r4++) {
        for (int c4 = 0; c4 < n4c; c4++) {
            if ((pass == 0 && c4 == 0) || (pass == 1 && r4 == 0))
                continue;
            int mr = (r4 << sy) | sy;
            if (mr > mi_rows - 1) mr = mi_rows - 1;
            int mc = (c4 << sx) | sx;
            if (mc > mi_cols - 1) mc = mi_cols - 1;
            int tcur, tprev, is_be, pmr, pmc;
            if (pass == 0) {
                pmr = mr;
                pmc = ((c4 - 1) << sx) | sx;
                if (pmc > mi_cols - 1) pmc = mi_cols - 1;
                tcur = txw[(long)mr * mi_cols + mc];
                tprev = txw[(long)pmr * mi_cols + pmc];
                if (tcur && (c4 % tcur))
                    continue;
                is_be = (bc0[(long)mr * mi_cols + mc] >> sx) == c4;
            } else {
                pmr = ((r4 - 1) << sy) | sy;
                if (pmr > mi_rows - 1) pmr = mi_rows - 1;
                pmc = mc;
                tcur = txh[(long)mr * mi_cols + mc];
                tprev = txh[(long)pmr * mi_cols + pmc];
                if (tcur && (r4 % tcur))
                    continue;
                is_be = (br0[(long)mr * mi_cols + mc] >> sy) == r4;
            }
            if (!(is_be || !skip[(long)mr * mi_cols + mc]
                  || !skip[(long)pmr * mi_cols + pmc]))
                continue;
            int lvl = dbk_level(&dl, i, mr, mc);
            if (!lvl)
                lvl = dbk_level(&dl, i, pmr, pmc);
            if (!lvl)
                continue;
            int m = tcur < tprev ? tcur : tprev;
            int wd = plane == 0 ? (m >= 4 ? 16 : (m >= 2 ? 8 : 4))
                                : (m >= 2 ? 6 : 4);
            int shift = sharp > 4 ? 2 : (sharp > 0 ? 1 : 0);
            int limit;
            if (sharp > 0) {
                limit = lvl >> shift;
                if (limit > 9 - sharp) limit = 9 - sharp;
                if (limit < 1) limit = 1;
            } else {
                limit = lvl > 1 ? lvl : 1;
            }
            int blimit = 2 * (lvl + 2) + limit;
            int thresh = lvl >> 4;
            limit *= sc; blimit *= sc; thresh *= sc;
            if (pass == 0) {
                int x = c4 * 4;
                for (int y = r4 * 4; y < r4 * 4 + 4; y++)
                    dbk_edge(arr + (long)y * w + x, 1, wd, limit,
                             blimit, thresh, bd);
            } else {
                int y = r4 * 4;
                for (int x = c4 * 4; x < c4 * 4 + 4; x++)
                    dbk_edge(arr + (long)y * w + x, (long)w, wd,
                             limit, blimit, thresh, bd);
            }
        }
    }
}
