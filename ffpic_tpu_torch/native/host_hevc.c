/* Copied from ffpic_tpu/native/host_hevc.c unchanged but for this
 * paragraph: the host HEVC stages of ffpic_tpu_torch (the CABAC slice
 * syntax pass, the intra reconstruction with its residual transform, and
 * the YUV to RGBA colour), built beside host_jpeg.c by
 * ffpic_tpu_torch/native/__init__.py.  Under FFPIC_HEVC_DEVICE the
 * residual transform runs on the GPU instead
 * (ffpic_tpu_torch/csrc/hevc_decode.cu, hevc_residuals) and
 * ffpic_hevc_recon2 adds the residuals it is given.
 *
 * host_hevc.c — native HEVC I-slice CABAC syntax decoder.
 *
 * Exact port of coding/hevc_slice.py SliceDecoder (the Python oracle,
 * which is dual-validated: encoder-roundtrip sample-exact and byte-
 * exact against the compiled C reference decoder).  Python keeps the
 * slice-header parse and the reconstruction pass; this covers the
 * per-bin hot path: CTU loop, SAO syntax, quadtree, intra CUs + MPM,
 * transform tree, residual coding, QP prediction.
 *
 * The CABAC engine is the spec 9-bit formulation (same as
 * coding/cabac.py, itself torture-tested bin-exact vs the reference's
 * engine); state tables are H.265 Table 9-52/9-53 constants.
 *
 * Outputs are flat arrays the Python side turns into PredOps/TUs.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef __AVX2__
#include <immintrin.h>
#endif

#define FFPIC_API __attribute__((visibility("default")))

/* table initializers run once at library load (constructor below) so
 * concurrent tile decodes (heif.py grid thread pool) never race the
 * lazy-init flags */
static void scan_init(void);
static void mt_init(void);
__attribute__((constructor)) static void ffpic_hevc_tables_init(void) {
    scan_init();
    mt_init();
}

/* ---------------- CABAC engine (9.3.4.3) ---------------------------- */

static const uint8_t LPS[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216},
    {123, 150, 178, 205}, {116, 142, 169, 195}, {111, 135, 160, 185},
    {105, 128, 152, 175}, {100, 122, 144, 166}, {95, 116, 137, 158},
    {90, 110, 130, 150}, {85, 104, 123, 142}, {81, 99, 117, 135},
    {77, 94, 111, 128}, {73, 89, 105, 122}, {69, 85, 100, 116},
    {66, 80, 95, 110}, {62, 76, 90, 104}, {59, 72, 86, 99},
    {56, 69, 81, 94}, {53, 65, 77, 89}, {51, 62, 73, 85},
    {48, 59, 69, 80}, {46, 56, 66, 76}, {43, 53, 63, 72},
    {41, 50, 59, 69}, {39, 48, 56, 65}, {37, 45, 54, 62},
    {35, 43, 51, 59}, {33, 41, 48, 56}, {32, 39, 46, 53},
    {30, 37, 43, 50}, {29, 35, 41, 48}, {27, 33, 39, 45},
    {26, 31, 37, 43}, {24, 30, 35, 41}, {23, 28, 33, 39},
    {22, 27, 32, 37}, {21, 26, 30, 35}, {20, 24, 29, 33},
    {19, 23, 27, 31}, {18, 22, 26, 30}, {17, 21, 25, 28},
    {16, 20, 23, 27}, {15, 19, 22, 25}, {14, 18, 21, 24},
    {14, 17, 20, 23}, {13, 16, 19, 22}, {12, 15, 18, 21},
    {12, 14, 17, 20}, {11, 14, 16, 19}, {11, 13, 15, 18},
    {10, 12, 15, 17}, {10, 12, 14, 16}, {9, 11, 13, 15},
    {9, 11, 12, 14}, {8, 10, 12, 14}, {8, 9, 11, 13},
    {7, 9, 11, 12}, {7, 9, 10, 12}, {7, 8, 10, 11},
    {6, 8, 9, 11}, {6, 7, 9, 10}, {6, 7, 8, 9}, {2, 2, 2, 2}};
static const uint8_t NMPS[64] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
    37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53,
    54, 55, 56, 57, 58, 59, 60, 61, 62, 62, 63};
static const uint8_t NLPS[64] = {
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15,
    16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27,
    27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35,
    35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

#define NCTX 137
/* flat context layout (must match coding/hevc_slice.py _CTX_SET) */
enum {
    C_SAO_MERGE = 0, C_SAO_TYPE = 1, C_SPLIT_CU = 2, C_TQ_BYPASS = 5,
    C_PART_MODE = 6, C_PREV_INTRA = 7, C_CHROMA_MODE = 8,
    C_SPLIT_TT = 9, C_CBF_LUMA = 12, C_CBF_C = 14, C_TSKIP = 19,
    C_LASTX = 21, C_LASTY = 39, C_CSBF = 57, C_SIG = 61, C_GT1 = 105,
    C_GT2 = 129, C_QPD = 135,
};

typedef struct {
    const uint8_t *data;
    long len;
    long bytepos;
    uint64_t cache;      /* next bits in the low `nbits` bits, MSB-first */
    int nbits;
    uint32_t range, offset;
    uint8_t sm[NCTX];    /* packed context: state<<1 | mps */
    int err;
} Cabac;

/* packed-state transition tables: sm = state<<1 | mps */
static uint8_t SM_NMPS[128], SM_NLPS[128];
__attribute__((constructor)) static void sm_tables_init(void) {
    for (int st = 0; st < 64; st++)
        for (int mps = 0; mps < 2; mps++) {
            int sm = (st << 1) | mps;
            SM_NMPS[sm] = (NMPS[st] << 1) | mps;
            SM_NLPS[sm] = (NLPS[st] << 1)
                | (st == 0 ? (mps ^ 1) : mps);
        }
}

static inline void refill(Cabac *c) {
    while (c->nbits <= 56) {
        uint64_t b = c->bytepos < c->len ? c->data[c->bytepos] : 0;
        c->bytepos++;
        c->cache = (c->cache << 8) | b;
        c->nbits += 8;
    }
}

static inline uint32_t rd_bits(Cabac *c, int n) {   /* 0 <= n <= 24 */
    if (c->nbits < n)
        refill(c);
    c->nbits -= n;
    return (uint32_t)((c->cache >> c->nbits) & ((1ULL << n) - 1));
}

static void cb_init_sm(Cabac *c, const uint8_t *data, long len,
                       const uint8_t *sm) {
    c->data = data;
    c->len = len;
    c->bytepos = 0;
    c->cache = 0;
    c->nbits = 0;
    c->range = 510;
    c->err = 0;
    c->offset = rd_bits(c, 9);
    if (sm)
        memcpy(c->sm, sm, NCTX);
}

static void cb_init(Cabac *c, const uint8_t *data, long len,
                    const uint8_t *st, const uint8_t *mp) {
    cb_init_sm(c, data, len, NULL);
    for (int i = 0; i < NCTX; i++)
        c->sm[i] = (uint8_t)((st[i] << 1) | (mp[i] & 1));
}

static inline void renorm(Cabac *c) {
    if (c->range >= 256)
        return;
    /* smallest s with range << s >= 256 (range in [2, 255]) */
    int s = __builtin_clz(c->range) - 23;
    c->range <<= s;
    c->offset = (c->offset << s) | rd_bits(c, s);
}

static inline int dec_bin(Cabac *c, int id) {
    int sm = c->sm[id];
    uint32_t lps = LPS[sm >> 1][(c->range >> 6) & 3];
    uint32_t rmps = c->range - lps;
    /* branchless: the LPS/MPS choice is data-dependent on noisy
     * residual bins (~40% LPS), so a predicted branch mispredicts
     * constantly; masked selects are ~8% faster end-to-end
     * (a fused lps|nextstate u32 table was tried and measured ~15%
     * WORSE — the 2KB footprint loses to these hot 256B tables) */
    uint32_t mask = -(uint32_t)(c->offset >= rmps);
    int bin = (sm & 1) ^ (int)(mask & 1);
    c->offset -= rmps & mask;
    c->range = (lps & mask) | (rmps & ~mask);
    c->sm[id] = (mask ? SM_NLPS : SM_NMPS)[sm];
    /* inline renorm, also branchless: s = 0 when range >= 256 */
    int s = __builtin_clz(c->range) - 23;
    s &= ~(s >> 31);
    c->range <<= s;
    c->offset = (c->offset << s) | rd_bits(c, s);
    return bin;
}

static inline int dec_bypass(Cabac *c) {
    c->offset = (c->offset << 1) | rd_bits(c, 1);
    if (c->offset >= c->range) {
        c->offset -= c->range;
        return 1;
    }
    return 0;
}

/* exact divide-by-range via reciprocal multiply: range is always
 * renormalized to [256, 510] wherever bypass bins are decoded, and
 * the numerators are < 2^25 (offset:16 extra bits), so
 * floor(ext/range) == (ext * (floor(2^39/range)+1)) >> 39 exactly
 * (round-up magic, error bound 2^25 * 510 < 2^39) — a 64-bit udiv
 * here costs 30-90 cycles, the mul ~4 */
static uint32_t MAGIC_R[512];
__attribute__((constructor)) static void magic_r_init(void) {
    for (int r = 2; r < 512; r++)
        MAGIC_R[r] = (uint32_t)(((1ULL << 39) / r) + 1);
}
static inline uint32_t div_range(uint32_t range, uint64_t ext) {
    return (uint32_t)((ext * MAGIC_R[range]) >> 39);
}

/* n bypass bins at once: the bit-serial recurrence
 * (off = 2*off + b; out_i = off >= range; off -= out_i*range) is long
 * division of (off << n | bits) by range, since off < range */
static inline uint32_t dec_bypass_chunk(Cabac *c, int n) { /* n <= 16 */
    uint64_t ext = ((uint64_t)c->offset << n) | rd_bits(c, n);
    uint32_t q = div_range(c->range, ext);
    c->offset = (uint32_t)(ext - (uint64_t)q * c->range);
    return q;
}

static inline uint32_t dec_bypass_n(Cabac *c, int n) {
    uint32_t v = 0;
    while (n > 16) {
        v = (v << 16) | dec_bypass_chunk(c, 16);
        n -= 16;
    }
    if (n)
        v = (v << n) | dec_bypass_chunk(c, n);
    return v;
}

/* coeff_abs_level_remaining (9.3.3.13): TR prefix + EGk suffix, all
 * bypass bins — decoded via ONE 16-bin bypass peek.  n bypass bins
 * are the top-n quotient bits of (offset:bits16)/range (long
 * division, see dec_bypass_chunk), and a k-bin consume is exact with
 * q_k = q >> (16-k), so the unconsumed tail just rewinds nbits.
 * Replaces a ~50%-mispredicting unary loop + a second division for
 * the suffix.  Returns -1 when the value needs > 16 bins (long EGk
 * tail, rare) — caller falls back to the serial path. */
static inline int dec_calr16(Cabac *c, int rice) {
    if (c->nbits < 16)
        refill(c);
    uint32_t bits16 = (uint32_t)((c->cache >> (c->nbits - 16))
                                 & 0xFFFF);
    uint64_t ext = ((uint64_t)c->offset << 16) | bits16;
    uint32_t q = div_range(c->range, ext);
    uint32_t inv = (~q) & 0xFFFF;
    int pre = inv ? (__builtin_clz(inv) - 16) : 16;
    int m, rem;
    if (pre < 3) {
        m = pre + 1 + rice;
        rem = (pre << rice)
            + (int)((q >> (16 - m)) & ((1u << rice) - 1u));
    } else {
        int nb = pre - 3 + rice;
        m = pre + 1 + nb;
        if (m > 16)
            return -1;
        rem = (((1 << (pre - 3)) + 2) << rice)
            + (int)((q >> (16 - m)) & ((1u << nb) - 1u));
    }
    c->nbits -= m;
    uint32_t qm = q >> (16 - m);
    uint64_t extm = ((uint64_t)c->offset << m) | (bits16 >> (16 - m));
    c->offset = (uint32_t)(extm - (uint64_t)qm * c->range);
    return rem;
}

static inline int dec_term(Cabac *c) {
    c->range -= 2;
    if (c->offset >= c->range)
        return 1;
    renorm(c);
    return 0;
}

static inline int dec_egk(Cabac *c, int k) {
    int pre = 0;
    while (pre < 32 && dec_bypass(c))
        pre++;
    int len = pre + k;
    int v = ((1 << pre) - 1) << k;
    if (len)
        v += dec_bypass_n(c, len);
    return v;
}

/* ---------------- scan orders + sig ctx map -------------------------- */

static const uint8_t SIG4[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8,
                                 7, 7, 8, 8};

/* up-right diagonal scan for n x n (n <= 8): (x, y) pairs */
static void diag_scan(int n, uint8_t *sx, uint8_t *sy) {
    int i = 0, x = 0, y = 0;
    while (i < n * n) {
        while (y >= 0) {
            if (x < n && y < n) {
                sx[i] = x;
                sy[i] = y;
                i++;
            }
            y--;
            x++;
        }
        y = x;
        x = 0;
    }
}

static void make_scan(int n, int idx, uint8_t *sx, uint8_t *sy) {
    if (idx == 0) {
        diag_scan(n, sx, sy);
    } else if (idx == 1) {
        int i = 0;
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) {
                sx[i] = x;
                sy[i] = y;
                i++;
            }
    } else {
        int i = 0;
        for (int x = 0; x < n; x++)
            for (int y = 0; y < n; y++) {
                sx[i] = x;
                sy[i] = y;
                i++;
            }
    }
}

/* precomputed scan tables: [log2(n)][scan_idx] for n = 1,2,4,8, plus
 * inverse (y*n+x -> scan position) and per-scan sig-ctx lookups so the
 * residual loop is table-driven */
static uint8_t SCAN_SX[4][3][64], SCAN_SY[4][3][64], SCAN_INV[4][3][64];
static uint8_t SIG4_SCAN[3][16];      /* log2==2: SIG4 in scan order */
static uint8_t SCTX_SCAN[3][4][16];   /* [scan][prev_csbf][scan pos] */
static int scan_ready = 0;

static void scan_init(void) {
    if (scan_ready)
        return;
    for (int ln = 0; ln < 4; ln++) {
        int n = 1 << ln;
        for (int idx = 0; idx < 3; idx++) {
            make_scan(n, idx, SCAN_SX[ln][idx], SCAN_SY[ln][idx]);
            for (int i = 0; i < n * n; i++)
                SCAN_INV[ln][idx][SCAN_SY[ln][idx][i] * n
                                  + SCAN_SX[ln][idx][i]] = (uint8_t)i;
        }
    }
    for (int idx = 0; idx < 3; idx++)
        for (int i = 0; i < 16; i++) {
            int xp = SCAN_SX[2][idx][i], yp = SCAN_SY[2][idx][i];
            SIG4_SCAN[idx][i] = SIG4[(yp << 2) + xp];
            SCTX_SCAN[idx][0][i] = xp + yp == 0 ? 2
                : (xp + yp < 3 ? 1 : 0);
            SCTX_SCAN[idx][1][i] = yp == 0 ? 2 : (yp == 1 ? 1 : 0);
            SCTX_SCAN[idx][2][i] = xp == 0 ? 2 : (xp == 1 ? 1 : 0);
            SCTX_SCAN[idx][3][i] = 2;
        }
    scan_ready = 1;
}

static const uint8_t CHROMA_QP[14] = {29, 30, 31, 32, 33, 33, 34, 34,
                                      35, 35, 36, 36, 37, 37};
static int chroma_qp(int q) {
    if (q < 30)
        return q;
    if (q > 43)
        return q - 6;
    return CHROMA_QP[q - 30];
}

/* ---------------- decoder state -------------------------------------- */

typedef struct {
    /* params (from Python) */
    int w, h, ctb_log2, min_cb, min_tb, max_tb, max_td_intra;
    int chroma_format, tq_bypass_en, tskip_en, sdh_en;
    int cuqp_en, cuqp_depth, cb_off, cr_off, slice_qp;
    int sao_luma, sao_chroma;
    int slice_cb_off, slice_cr_off;
    int qp_bd_off;                /* 6 * (bit_depth - 8) */
    /* derived */
    int mw, mh;                   /* 4x4 map dims */
    int ctbs_x, ctbs_y;
    Cabac cb;
    /* maps */
    int8_t *ct_depth, *luma_mode, *qp_map;
    uint8_t *bypass_map;
    /* availability zones (6.4.1): (slice_idx << 12) | tile_idx per
     * 4x4 cell; -1 = not yet decoded */
    int32_t *zone;
    int cur_zone;
    /* outputs */
    int32_t *ops;       /* (cap,6): plane,x,y,n,mode,tu */
    long n_ops, ops_cap;
    int32_t *tu_meta;   /* (cap,8): x,y,n,cidx,skip,bypass,qp,dst */
    long n_tus, tu_cap;
    int16_t *levels;    /* packed */
    long lv_pos, lv_cap;
    int32_t *sao;       /* (n_ctbs, 21) */
    /* CU/QG state */
    int cu_bypass, cu_part_nxn, cu_max_td, cu_chroma_mode;
    int cu_x0, cu_y0, cu_log2;
    int cu_modes[2][2];
    long cu_first_tu;
    int qp_coded, cu_qp_delta, qg_x, qg_y, qg_qp_prev, qp_prev;
    int log2_qg;
} Dec;

static void emit_op(Dec *d, int plane, int x, int y, int n, int mode,
                    long tu) {
    if (d->n_ops >= d->ops_cap) {
        d->cb.err = -10;
        return;
    }
    int32_t *o = d->ops + d->n_ops * 6;
    o[0] = plane;
    o[1] = x;
    o[2] = y;
    o[3] = n;
    o[4] = mode;
    o[5] = (int32_t)tu;
    d->n_ops++;
}

static inline int avail_n(Dec *d, int nx, int ny) {
    if (nx < 0 || ny < 0 || nx >= d->w || ny >= d->h)
        return 0;
    return d->zone[(ny / 4) * d->mw + nx / 4] == d->cur_zone;
}

/* ---------------- residual coding (7.3.8.11) ------------------------- */

static long residual(Dec *d, int x0, int y0, int log2, int c_idx,
                     int pred_mode) {
    Cabac *c = &d->cb;
    int n = 1 << log2;
    if (d->n_tus >= d->tu_cap || d->lv_pos + n * n > d->lv_cap) {
        c->err = -11;
        return -1;
    }
    long tu = d->n_tus++;
    int16_t *lv = d->levels + d->lv_pos;
    memset(lv, 0, sizeof(int16_t) * n * n);
    d->lv_pos += n * n;

    int skip = 0;
    if (d->tskip_en && !d->cu_bypass && log2 == 2)
        skip = dec_bin(c, C_TSKIP + (c_idx ? 1 : 0));

    int scan_idx = 0;
    if (log2 == 2 || (log2 == 3 && c_idx == 0)) {
        if (pred_mode >= 6 && pred_mode <= 14)
            scan_idx = 2;
        else if (pred_mode >= 22 && pred_mode <= 30)
            scan_idx = 1;
    }

    /* last significant coefficient (9.3.4.2.3) */
    int off, shift;
    if (c_idx == 0) {
        off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
        shift = (log2 + 1) >> 2;
    } else {
        off = 15;
        shift = log2 - 2;
    }
    int c_max = (log2 << 1) - 1;
    int px = 0, py = 0;
    while (px < c_max && dec_bin(c, C_LASTX + (px >> shift) + off))
        px++;
    while (py < c_max && dec_bin(c, C_LASTY + (py >> shift) + off))
        py++;
    int last_x, last_y;
    if (px <= 3)
        last_x = px;
    else {
        int nb = (px >> 1) - 1;
        last_x = (2 + (px & 1)) * (1 << nb) + dec_bypass_n(c, nb);
    }
    if (py <= 3)
        last_y = py;
    else {
        int nb = (py >> 1) - 1;
        last_y = (2 + (py & 1)) * (1 << nb) + dec_bypass_n(c, nb);
    }
    if (scan_idx == 2) {
        int t = last_x;
        last_x = last_y;
        last_y = t;
    }

    scan_init();
    int lns = log2 - 2;
    int n_sub = 1 << lns;
    const uint8_t *ssx = SCAN_SX[lns][scan_idx];
    const uint8_t *ssy = SCAN_SY[lns][scan_idx];
    const uint8_t *csx = SCAN_SX[2][scan_idx];
    const uint8_t *csy = SCAN_SY[2][scan_idx];

    if (last_x >= n || last_y >= n) {
        c->err = -12;
        return tu;
    }
    int sxt = last_x >> 2, syt = last_y >> 2;
    int last_sb = SCAN_INV[lns][scan_idx][syt * n_sub + sxt];
    int last_pos = SCAN_INV[2][scan_idx][(last_y & 3) * 4
                                         + (last_x & 3)];

    int8_t csbf[8][8];
    memset(csbf, 0, sizeof(csbf));
    int gt1_cont = 1;

    for (int i = last_sb; i >= 0; i--) {
        int sxx = ssx[i], syy = ssy[i];
        int infer_dc = 0;
        if (i < last_sb && i > 0) {
            int right = sxx + 1 < n_sub ? csbf[syy][sxx + 1] : 0;
            int below = syy + 1 < n_sub ? csbf[syy + 1][sxx] : 0;
            int inc = (right + below > 0 ? 1 : 0) + (c_idx ? 2 : 0);
            csbf[syy][sxx] = dec_bin(c, C_CSBF + inc);
            infer_dc = 1;
        } else {
            csbf[syy][sxx] = 1;
        }
        if (!csbf[syy][sxx])
            continue;

        int start_n = (i == last_sb) ? last_pos - 1 : 15;
        int sig_pos[16], n_sig = 0;
        if (i == last_sb)
            sig_pos[n_sig++] = last_pos;
        /* subblock-invariant sig-ctx pieces, hoisted out of the
         * per-coefficient loop */
        int cbase = C_SIG + (c_idx ? 27 : 0);
        const uint8_t *sct = NULL;
        int sadd = 0, dc_special = 0;
        if (log2 == 2) {
            sct = SIG4_SCAN[scan_idx];
        } else {
            int right = sxx + 1 < n_sub ? csbf[syy][sxx + 1] : 0;
            int below = syy + 1 < n_sub ? csbf[syy + 1][sxx] : 0;
            sct = SCTX_SCAN[scan_idx][right + 2 * below];
            if (c_idx == 0)
                sadd = (sxx || syy ? 3 : 0)
                    + (log2 == 3 ? (scan_idx == 0 ? 9 : 15) : 21);
            else
                sadd = log2 == 3 ? 9 : 12;
            dc_special = (sxx == 0 && syy == 0);   /* (0,0) -> ctx 0 */
        }
        for (int nn = start_n; nn >= 0; nn--) {
            if (nn > 0 || !infer_dc) {
                int sc = (dc_special && nn == 0) ? 0 : sct[nn] + sadd;
                if (dec_bin(c, cbase + sc)) {
                    sig_pos[n_sig++] = nn;
                    infer_dc = 0;
                }
            } else {
                sig_pos[n_sig++] = nn;
            }
        }
        if (!n_sig)
            continue;

        int ctx_set = (i == 0 || c_idx > 0) ? 0 : 2;
        if (gt1_cont == 0)
            ctx_set++;
        int c1 = 1;
        int8_t gt1[16];
        memset(gt1, 0, 16);
        int ngt1 = n_sig < 8 ? n_sig : 8;
        for (int k = 0; k < ngt1; k++) {
            int inc = ctx_set * 4 + (c1 < 3 ? c1 : 3)
                + (c_idx ? 16 : 0);
            int f = dec_bin(c, C_GT1 + inc);
            gt1[sig_pos[k]] = f;
            if (f)
                c1 = 0;
            else if (c1 > 0 && c1 < 3)
                c1++;
        }
        gt1_cont = c1;
        int first_gt1 = -1;
        for (int k = 0; k < ngt1; k++)
            if (gt1[sig_pos[k]]) {
                first_gt1 = sig_pos[k];
                break;
            }
        int gt2v = 0;
        if (first_gt1 >= 0)
            gt2v = dec_bin(c, C_GT2 + ctx_set + (c_idx ? 4 : 0));

        int sign_hidden = d->sdh_en && !d->cu_bypass
            && (sig_pos[0] - sig_pos[n_sig - 1]) > 3;
        int8_t signs[16];
        memset(signs, 0, 16);
        int nsb = n_sig - (sign_hidden ? 1 : 0);
        uint32_t sbits = nsb ? dec_bypass_n(c, nsb) : 0;
        for (int k = 0; k < nsb; k++)
            signs[sig_pos[k]] = (sbits >> (nsb - 1 - k)) & 1;

        int rice = 0;
        long total = 0;
        int vals[16];
        for (int k = 0; k < n_sig; k++) {
            int nn = sig_pos[k];
            int base = 1;
            if (k < 8) {
                base += gt1[nn];
                if (nn == first_gt1)
                    base += gt2v;
            }
            int threshold = (k < 8 && nn == first_gt1) ? 3
                : (k < 8 ? 2 : 1);
            int lvl = base;
            if (base == threshold) {
                int rem = dec_calr16(c, rice);
                if (rem < 0) {
                    /* > 16-bin remainder: serial fallback */
                    int prefix = 0;
                    while (prefix < 32 && dec_bypass(c))
                        prefix++;
                    if (prefix < 3) {
                        rem = (prefix << rice)
                            + (rice ? (int)dec_bypass_n(c, rice) : 0);
                    } else {
                        int nb = prefix - 3 + rice;
                        rem = (((1 << (prefix - 3)) + 2) << rice)
                            + (nb ? (int)dec_bypass_n(c, nb) : 0);
                    }
                }
                lvl = base + rem;
                if (lvl > (3 << rice) && rice < 4)
                    rice++;
            }
            vals[k] = lvl;
            total += lvl;
        }
        for (int k = 0; k < n_sig; k++) {
            int nn = sig_pos[k];
            int lvl = vals[k];
            int s = (sign_hidden && k == n_sig - 1) ? (int)(total & 1)
                                                    : signs[nn];
            if (s)
                lvl = -lvl;
            int xp = csx[nn], yp = csy[nn];
            lv[((syy << 2) + yp) * n + (sxx << 2) + xp] = (int16_t)lvl;
        }
    }

    int32_t *m = d->tu_meta + tu * 8;
    m[0] = c_idx ? (x0 >> 1) : x0;
    m[1] = c_idx ? (y0 >> 1) : y0;
    m[2] = n;
    m[3] = c_idx;
    m[4] = skip;
    m[5] = d->cu_bypass;
    m[6] = 0; /* qp stamped at CU end */
    m[7] = (c_idx == 0 && log2 == 2);
    return tu;
}

/* ---------------- cu_qp_delta (7.3.8.10) ------------------------------ */

static void parse_cu_qp_delta(Dec *d) {
    Cabac *c = &d->cb;
    int prefix = 0;
    if (dec_bin(c, C_QPD)) {
        prefix = 1;
        while (prefix < 5 && dec_bin(c, C_QPD + 1))
            prefix++;
    }
    int val = prefix;
    if (prefix == 5)
        val = 5 + dec_egk(c, 0);
    if (val && dec_bypass(c))
        val = -val;
    d->cu_qp_delta = val;
    d->qp_coded = 1;
}

/* ---------------- transform tree / unit ------------------------------- */

static void transform_unit(Dec *d, int x0, int y0, int xb, int yb,
                           int log2, int depth, int blk_idx,
                           int cbf_luma, int cbf_cb, int cbf_cr) {
    int has_chroma = d->chroma_format && (log2 > 2 || blk_idx == 3);
    int cx, cy, clog2;
    if (log2 > 2) {
        cx = x0;
        cy = y0;
        clog2 = log2 - 1;
    } else {
        cx = xb;
        cy = yb;
        clog2 = 2;
    }
    int cbf_chroma = has_chroma && (cbf_cb || cbf_cr);
    if ((cbf_luma || cbf_chroma) && d->cuqp_en && !d->qp_coded)
        parse_cu_qp_delta(d);
    int size = 1 << log2;
    int mode = d->luma_mode[(y0 / 4) * d->mw + x0 / 4];
    long tu = -1;
    if (cbf_luma)
        tu = residual(d, x0, y0, log2, 0, mode);
    emit_op(d, 0, x0, y0, size, mode, tu);
    if (has_chroma) {
        int csize = 1 << clog2;
        int cmode = d->cu_chroma_mode;
        long tu_cb = -1, tu_cr = -1;
        if (cbf_cb)
            tu_cb = residual(d, cx, cy, clog2, 1, cmode);
        if (cbf_cr)
            tu_cr = residual(d, cx, cy, clog2, 2, cmode);
        emit_op(d, 1, cx >> 1, cy >> 1, csize, cmode, tu_cb);
        emit_op(d, 2, cx >> 1, cy >> 1, csize, cmode, tu_cr);
    }
}

static void transform_tree(Dec *d, int x0, int y0, int xb, int yb,
                           int log2, int depth, int blk_idx,
                           int cbf_cb_par, int cbf_cr_par) {
    Cabac *c = &d->cb;
    if (c->err)
        return;
    int intra_split = d->cu_part_nxn;
    int split;
    if (log2 <= d->max_tb && log2 > d->min_tb
        && depth < d->cu_max_td && !(intra_split && depth == 0)) {
        split = dec_bin(c, C_SPLIT_TT + 5 - log2);
    } else {
        split = (log2 > d->max_tb)
            || (intra_split && depth == 0 && log2 > d->min_tb);
    }
    int cbf_cb = cbf_cb_par, cbf_cr = cbf_cr_par;
    if (d->chroma_format && log2 > 2) {
        cbf_cb = (depth == 0 || cbf_cb_par)
            ? dec_bin(c, C_CBF_C + depth) : 0;
        cbf_cr = (depth == 0 || cbf_cr_par)
            ? dec_bin(c, C_CBF_C + depth) : 0;
    }
    if (split) {
        int half = 1 << (log2 - 1);
        transform_tree(d, x0, y0, x0, y0, log2 - 1, depth + 1, 0,
                       cbf_cb, cbf_cr);
        transform_tree(d, x0 + half, y0, x0, y0, log2 - 1, depth + 1,
                       1, cbf_cb, cbf_cr);
        transform_tree(d, x0, y0 + half, x0, y0, log2 - 1, depth + 1,
                       2, cbf_cb, cbf_cr);
        transform_tree(d, x0 + half, y0 + half, x0, y0, log2 - 1,
                       depth + 1, 3, cbf_cb, cbf_cr);
        return;
    }
    int cbf_luma = dec_bin(c, C_CBF_LUMA + (depth == 0 ? 1 : 0));
    transform_unit(d, x0, y0, xb, yb, log2, depth, blk_idx, cbf_luma,
                   cbf_cb, cbf_cr);
}

/* ---------------- intra modes (8.4.2) --------------------------------- */

static int cand_mode(Dec *d, int nx, int ny, int yp, int above) {
    if (!avail_n(d, nx, ny))
        return 1;
    if (above && (ny >> d->ctb_log2) != (yp >> d->ctb_log2))
        return 1;
    int m = d->luma_mode[(ny / 4) * d->mw + nx / 4];
    return m < 0 ? 1 : m;
}

static int derive_luma_mode(Dec *d, int xp, int yp, int prev, int val) {
    int a = cand_mode(d, xp - 1, yp, yp, 0);
    int b = cand_mode(d, xp, yp - 1, yp, 1);
    int mpm[3];
    if (a == b) {
        if (a < 2) {
            mpm[0] = 0;
            mpm[1] = 1;
            mpm[2] = 26;
        } else {
            mpm[0] = a;
            mpm[1] = 2 + ((a + 29) % 32);
            mpm[2] = 2 + ((a - 2 + 1) % 32);
        }
    } else {
        mpm[0] = a;
        mpm[1] = b;
        if (a != 0 && b != 0)
            mpm[2] = 0;
        else if (a != 1 && b != 1)
            mpm[2] = 1;
        else
            mpm[2] = 26;
    }
    if (prev)
        return mpm[val];
    /* sort ascending */
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 2 - i; j++)
            if (mpm[j] > mpm[j + 1]) {
                int t = mpm[j];
                mpm[j] = mpm[j + 1];
                mpm[j + 1] = t;
            }
    int mode = val;
    for (int i = 0; i < 3; i++)
        if (mode >= mpm[i])
            mode++;
    return mode;
}

/* ---------------- QP prediction (8.6.1) -------------------------------- */

static int derive_qp(Dec *d) {
    int xqg = d->qg_x, yqg = d->qg_y;
    int ctb_mask = ~((1 << d->ctb_log2) - 1);
    int qa = d->qg_qp_prev, qb = d->qg_qp_prev;
    if (xqg > 0 && ((xqg - 1) & ctb_mask) == (xqg & ctb_mask)
        && d->ct_depth[(yqg / 4) * d->mw + (xqg - 1) / 4] >= 0)
        qa = d->qp_map[(yqg / 4) * d->mw + (xqg - 1) / 4];
    if (yqg > 0 && ((yqg - 1) & ctb_mask) == (yqg & ctb_mask)
        && d->ct_depth[((yqg - 1) / 4) * d->mw + xqg / 4] >= 0)
        qb = d->qp_map[((yqg - 1) / 4) * d->mw + xqg / 4];
    int pred = (qa + qb + 1) >> 1;
    /* 8.6.1 with QpBdOffsetY: QpY in [-QpBdOffsetY, 51] */
    int off = d->qp_bd_off;
    return ((pred + d->cu_qp_delta + 52 + 2 * off) % (52 + off)) - off;
}

/* ---------------- coding unit (7.3.8.5) -------------------------------- */

static void coding_unit(Dec *d, int x0, int y0, int log2, int depth) {
    Cabac *c = &d->cb;
    int size = 1 << log2;
    d->cu_bypass = 0;
    if (d->tq_bypass_en)
        d->cu_bypass = dec_bin(c, C_TQ_BYPASS);
    int part_nxn = 0;
    if (log2 == d->min_cb)
        part_nxn = !dec_bin(c, C_PART_MODE);
    int n_pu = part_nxn ? 2 : 1;
    int pb = size >> (part_nxn ? 1 : 0);
    int prev[4], mval[4];
    for (int k = 0; k < n_pu * n_pu; k++)
        prev[k] = dec_bin(c, C_PREV_INTRA);
    for (int k = 0; k < n_pu * n_pu; k++) {
        if (prev[k]) {
            int v = 0;
            if (dec_bypass(c))
                v = dec_bypass(c) ? 2 : 1;
            mval[k] = v;
        } else {
            mval[k] = dec_bypass_n(c, 5);
        }
    }
    for (int j = 0; j < n_pu; j++)
        for (int i = 0; i < n_pu; i++) {
            int k = j * n_pu + i;
            int xp = x0 + i * pb, yp = y0 + j * pb;
            int mode = derive_luma_mode(d, xp, yp, prev[k], mval[k]);
            d->cu_modes[j][i] = mode;
            for (int yy = yp / 4; yy < (yp + pb) / 4 && yy < d->mh;
                 yy++)
                for (int xx = xp / 4; xx < (xp + pb) / 4 && xx < d->mw;
                     xx++)
                    d->luma_mode[yy * d->mw + xx] = (int8_t)mode;
        }
    d->cu_chroma_mode = 0;
    if (d->chroma_format) {
        if (dec_bin(c, C_CHROMA_MODE)) {
            static const int CAND[4] = {0, 26, 10, 1};
            int idx = dec_bypass_n(c, 2);
            int cd = CAND[idx];
            d->cu_chroma_mode = (cd == d->cu_modes[0][0]) ? 34 : cd;
        } else {
            d->cu_chroma_mode = d->cu_modes[0][0];
        }
    }
    for (int yy = y0 / 4; yy < (y0 + size) / 4 && yy < d->mh; yy++)
        for (int xx = x0 / 4; xx < (x0 + size) / 4 && xx < d->mw; xx++)
            d->ct_depth[yy * d->mw + xx] = (int8_t)depth;

    d->cu_part_nxn = part_nxn;
    d->cu_max_td = d->max_td_intra + (part_nxn ? 1 : 0);
    d->cu_first_tu = d->n_tus;
    transform_tree(d, x0, y0, x0, y0, log2, 0, 0, 1, 1);

    int qp_y = d->cuqp_en ? derive_qp(d) : d->slice_qp;
    if (qp_y < -d->qp_bd_off)
        qp_y = -d->qp_bd_off;
    if (qp_y > 51)
        qp_y = 51;
    d->qp_prev = qp_y;
    for (int yy = y0 / 4; yy < (y0 + size) / 4 && yy < d->mh; yy++)
        for (int xx = x0 / 4; xx < (x0 + size) / 4 && xx < d->mw;
             xx++) {
            d->qp_map[yy * d->mw + xx] = (int8_t)qp_y;
            if (d->cu_bypass)
                d->bypass_map[yy * d->mw + xx] = 1;
        }
    /* dequant uses Qp' = QpY/QpC + QpBdOffset (8.6.3); the maps above
     * keep QpY for deblocking */
    for (long t = d->cu_first_tu; t < d->n_tus; t++) {
        int32_t *m = d->tu_meta + t * 8;
        if (m[3] == 0) {
            m[6] = qp_y + d->qp_bd_off;
        } else {
            int offt = (m[3] == 1) ? d->cb_off + d->slice_cb_off
                                   : d->cr_off + d->slice_cr_off;
            int q = qp_y + offt;
            if (q < -d->qp_bd_off)
                q = -d->qp_bd_off;
            if (q > 57)
                q = 57;
            m[6] = chroma_qp(q) + d->qp_bd_off;
        }
    }
}

/* ---------------- quadtree (7.3.8.4) ----------------------------------- */

static void quadtree(Dec *d, int x0, int y0, int log2, int depth) {
    Cabac *c = &d->cb;
    if (c->err)
        return;
    int size = 1 << log2;
    int inside = (x0 + size <= d->w) && (y0 + size <= d->h);
    int split;
    if (inside && log2 > d->min_cb) {
        int inc = 0;
        if (avail_n(d, x0 - 1, y0)
            && d->ct_depth[(y0 / 4) * d->mw + (x0 - 1) / 4] > depth)
            inc++;
        if (avail_n(d, x0, y0 - 1)
            && d->ct_depth[((y0 - 1) / 4) * d->mw + x0 / 4] > depth)
            inc++;
        split = dec_bin(c, C_SPLIT_CU + inc);
    } else {
        split = log2 > d->min_cb;
    }
    if (d->cuqp_en && log2 >= d->log2_qg) {
        d->qp_coded = 0;
        d->cu_qp_delta = 0;
        d->qg_x = x0;
        d->qg_y = y0;
        d->qg_qp_prev = d->qp_prev;
    }
    if (split) {
        int half = size >> 1;
        static const int DX[4] = {0, 1, 0, 1}, DY[4] = {0, 0, 1, 1};
        for (int k = 0; k < 4; k++) {
            int x1 = x0 + DX[k] * half, y1 = y0 + DY[k] * half;
            if (x1 < d->w && y1 < d->h)
                quadtree(d, x1, y1, log2 - 1, depth + 1);
        }
    } else {
        coding_unit(d, x0, y0, log2, depth);
    }
}

/* ---------------- SAO syntax (7.3.8.3) ---------------------------------- */

static void parse_sao(Dec *d, int cx, int cy) {
    Cabac *c = &d->cb;
    int32_t *out = d->sao + ((long)cy * d->ctbs_x + cx) * 21;
    int merge_left = 0, merge_up = 0;
    int cs = 1 << d->ctb_log2;
    if (cx > 0 && avail_n(d, cx * cs - 1, cy * cs))
        merge_left = dec_bin(c, C_SAO_MERGE);
    if (cy > 0 && !merge_left && avail_n(d, cx * cs, cy * cs - 1))
        merge_up = dec_bin(c, C_SAO_MERGE);
    if (merge_left) {
        memcpy(out, out - 21, 21 * sizeof(int32_t));
        return;
    }
    if (merge_up) {
        memcpy(out, out - (long)d->ctbs_x * 21, 21 * sizeof(int32_t));
        return;
    }
    memset(out, 0, 21 * sizeof(int32_t));
    int n_comp = d->chroma_format ? 3 : 1;
    for (int comp = 0; comp < n_comp; comp++) {
        if (comp == 0 && !d->sao_luma)
            continue;
        if (comp == 1 && !d->sao_chroma)
            break;
        if (comp <= 1) {
            int t = 0;
            if (dec_bin(c, C_SAO_TYPE))
                t = dec_bypass(c) ? 2 : 1;
            out[comp] = t;
            if (comp == 1)
                out[2] = t;
        }
        if (out[comp] == 0)
            continue;
        int offs[4];
        for (int k = 0; k < 4; k++) {
            /* TR cMax=7 bypass */
            int v = 0;
            while (v < 7 && dec_bypass(c))
                v++;
            offs[k] = v;
        }
        if (out[comp] == 1) {
            for (int k = 0; k < 4; k++)
                if (offs[k] && dec_bypass(c))
                    offs[k] = -offs[k];
            out[15 + comp] = dec_bypass_n(c, 5);   /* band pos */
        } else {
            offs[2] = -offs[2];
            offs[3] = -offs[3];
            if (comp <= 1) {
                int eo = dec_bypass_n(c, 2);
                out[18 + comp] = eo;
                if (comp == 1)
                    out[20] = eo;
            }
        }
        for (int k = 0; k < 4; k++)
            out[3 + comp * 4 + k] = offs[k];
    }
}

FFPIC_API int ffpic_hevc_recon2(
    int32_t *Y, int32_t *U, int32_t *V,
    int w, int h, int cw, int ch, int n_planes, int bd, int strong,
    const int32_t *ops, long n_ops,
    const int32_t *tu_meta, long n_tus,
    const int16_t *levels, const int16_t *resid);

static void stamp_zone(Dec *d, int cx, int cy) {
    int s4 = 1 << (d->ctb_log2 - 2);
    int y0 = cy * s4, x0 = cx * s4;
    int y1 = y0 + s4 < d->mh ? y0 + s4 : d->mh;
    int x1 = x0 + s4 < d->mw ? x0 + s4 : d->mw;
    for (int yy = y0; yy < y1; yy++)
        for (int xx = x0; xx < x1; xx++)
            d->zone[yy * d->mw + xx] = d->cur_zone;
}

/* Core slice-segment CTU loop in tile-scan order with entry-point
 * substream switching, per-tile CABAC reset, WPP row context sync
 * (9.3.1) and availability-zone stamping.  ts_to_rs/rs_to_ts/
 * tile_of_rs may be NULL for the identity (no-tiles) layout. */
static long decode_segment_core(
    Dec *d, const uint8_t *data,
    const int32_t *sub_bounds, int n_subs,
    const int32_t *ts_to_rs, const int32_t *rs_to_ts,
    const int32_t *tile_of_rs, int32_t *slice_of_ctb,
    long start_rs, int slice_idx, int wpp,
    const uint8_t *sm_fresh, uint8_t *sm_io,
    uint8_t *wpp_sm, int32_t *wpp_meta,
    long *n_tus_out) {
    long n_ctbs = (long)d->ctbs_x * d->ctbs_y;
    long ts = rs_to_ts ? rs_to_ts[start_rs] : start_rs;
    int sub = 0;
    cb_init_sm(&d->cb, data + sub_bounds[0],
               sub_bounds[1] - sub_bounds[0], sm_io);
    int first = 1;
    int prev_tile = -1;
    for (;;) {
        long rs = ts_to_rs ? ts_to_rs[ts] : ts;
        int cx = (int)(rs % d->ctbs_x), cy = (int)(rs / d->ctbs_x);
        int tile = tile_of_rs ? tile_of_rs[rs] : 0;
        int new_tile = !first && tile != prev_tile;
        int new_row = wpp && cx == 0 && !first;
        if (new_tile || new_row) {
            sub++;
            if (sub >= n_subs)
                return -21;            /* missing entry point */
            cb_init_sm(&d->cb, data + sub_bounds[sub],
                       sub_bounds[sub + 1] - sub_bounds[sub], NULL);
            if (new_row) {
                long ur = rs - d->ctbs_x + 1;
                if (wpp_meta && wpp_meta[0] && wpp_meta[1] == cy - 1
                    && ur >= 0 && slice_of_ctb
                    && slice_of_ctb[ur] == slice_idx)
                    memcpy(d->cb.sm, wpp_sm, NCTX);
                else
                    memcpy(d->cb.sm, sm_fresh, NCTX);
            } else {
                memcpy(d->cb.sm, sm_fresh, NCTX);
            }
            d->qp_prev = d->slice_qp;
            d->qg_qp_prev = d->slice_qp;
        }
        first = 0;
        prev_tile = tile;
        d->cur_zone = (slice_idx << 12) | tile;
        if (slice_of_ctb)
            slice_of_ctb[rs] = slice_idx;
        stamp_zone(d, cx, cy);
        if (d->sao_luma || d->sao_chroma)
            parse_sao(d, cx, cy);
        quadtree(d, (long)cx << d->ctb_log2, (long)cy << d->ctb_log2,
                 d->ctb_log2, 0);
        if (d->cb.err)
            return d->cb.err;
        if (wpp && cx == 1 && wpp_sm) {
            memcpy(wpp_sm, d->cb.sm, NCTX);
            wpp_meta[0] = 1;
            wpp_meta[1] = cy;
        }
        int end = dec_term(&d->cb);
        if (end) {
            if (sm_io)
                memcpy(sm_io, d->cb.sm, NCTX);
            *n_tus_out = d->n_tus;
            return d->n_ops;
        }
        if (ts == n_ctbs - 1)
            return -20;                /* flag 0 at last CTB */
        ts++;
    }
}

/* ---------------- entry ------------------------------------------------- */

FFPIC_API long ffpic_hevc_decode_slice(
    const uint8_t *data, long len,
    const int32_t *params,          /* see Dec field order below */
    const uint8_t *init_state, const uint8_t *init_mps,
    int32_t *ops, long ops_cap,
    int32_t *tu_meta, long tu_cap,
    int16_t *levels, long lv_cap,
    int32_t *sao_out,
    int8_t *ct_depth, int8_t *luma_mode, int8_t *qp_map,
    uint8_t *bypass_map,
    long *n_tus_out) {
    Dec d;
    memset(&d, 0, sizeof(d));
    const int32_t *p = params;
    d.w = p[0];
    d.h = p[1];
    d.ctb_log2 = p[2];
    d.min_cb = p[3];
    d.min_tb = p[4];
    d.max_tb = p[5];
    d.max_td_intra = p[6];
    d.chroma_format = p[7];
    d.tq_bypass_en = p[8];
    d.tskip_en = p[9];
    d.sdh_en = p[10];
    d.cuqp_en = p[11];
    d.cuqp_depth = p[12];
    d.cb_off = p[13];
    d.cr_off = p[14];
    d.slice_qp = p[15];
    d.sao_luma = p[16];
    d.sao_chroma = p[17];
    d.slice_cb_off = p[18];
    d.slice_cr_off = p[19];
    d.qp_bd_off = p[20];

    d.mw = (d.w + 3) / 4;
    d.mh = (d.h + 3) / 4;
    d.ctbs_x = (d.w + (1 << d.ctb_log2) - 1) >> d.ctb_log2;
    d.ctbs_y = (d.h + (1 << d.ctb_log2) - 1) >> d.ctb_log2;
    d.log2_qg = d.ctb_log2 - d.cuqp_depth;
    d.qp_prev = d.slice_qp;
    d.qg_qp_prev = d.slice_qp;

    d.ops = ops;
    d.ops_cap = ops_cap;
    d.tu_meta = tu_meta;
    d.tu_cap = tu_cap;
    d.levels = levels;
    d.lv_cap = lv_cap;
    d.sao = sao_out;
    d.ct_depth = ct_depth;
    d.luma_mode = luma_mode;
    d.qp_map = qp_map;
    d.bypass_map = bypass_map;
    memset(ct_depth, -1, (size_t)d.mw * d.mh);
    memset(luma_mode, -1, (size_t)d.mw * d.mh);
    memset(bypass_map, 0, (size_t)d.mw * d.mh);

    d.zone = malloc((size_t)d.mw * d.mh * sizeof(int32_t));
    if (!d.zone)
        return -1;
    memset(d.zone, 0xFF, (size_t)d.mw * d.mh * sizeof(int32_t));

    uint8_t sm[NCTX];
    for (int i = 0; i < NCTX; i++)
        sm[i] = (uint8_t)((init_state[i] << 1) | (init_mps[i] & 1));
    int32_t bounds[2] = {0, (int32_t)len};
    long rc = decode_segment_core(&d, data, bounds, 1, NULL, NULL,
                                  NULL, NULL, 0, 0, 0, sm, sm, NULL,
                                  NULL, n_tus_out);
    free(d.zone);
    return rc;
}

/* Multi-feature slice segment entry: tiles / WPP / multi-slice /
 * dependent segments.  All maps (ct_depth/luma_mode/qp_map/
 * bypass_map/zone/slice_of_ctb) persist across segments of one
 * picture — the caller initializes them once (-1 fills for
 * ct_depth/luma_mode/zone, 0 elsewhere) and passes them to every
 * segment call.  sm_io carries the CABAC contexts in (fresh for
 * independent segments, the previous segment's out-state for
 * dependent ones) and out (the 9.3.1 storage).  segp =
 * [start_rs, slice_idx, wpp, n_subs]. */
FFPIC_API long ffpic_hevc_decode_segment(
    const uint8_t *data, long len,
    const int32_t *params, const int32_t *segp,
    const int32_t *sub_bounds,
    const int32_t *ts_to_rs, const int32_t *rs_to_ts,
    const int32_t *tile_of_rs, int32_t *slice_of_ctb,
    const uint8_t *sm_fresh, uint8_t *sm_io,
    uint8_t *wpp_sm, int32_t *wpp_meta, int32_t *zone,
    int32_t *ops, long ops_cap,
    int32_t *tu_meta, long tu_cap,
    int16_t *levels, long lv_cap,
    int32_t *sao_out,
    int8_t *ct_depth, int8_t *luma_mode, int8_t *qp_map,
    uint8_t *bypass_map,
    long *n_tus_out) {
    (void)len;
    Dec d;
    memset(&d, 0, sizeof(d));
    const int32_t *p = params;
    d.w = p[0];
    d.h = p[1];
    d.ctb_log2 = p[2];
    d.min_cb = p[3];
    d.min_tb = p[4];
    d.max_tb = p[5];
    d.max_td_intra = p[6];
    d.chroma_format = p[7];
    d.tq_bypass_en = p[8];
    d.tskip_en = p[9];
    d.sdh_en = p[10];
    d.cuqp_en = p[11];
    d.cuqp_depth = p[12];
    d.cb_off = p[13];
    d.cr_off = p[14];
    d.slice_qp = p[15];
    d.sao_luma = p[16];
    d.sao_chroma = p[17];
    d.slice_cb_off = p[18];
    d.slice_cr_off = p[19];
    d.qp_bd_off = p[20];
    d.mw = (d.w + 3) / 4;
    d.mh = (d.h + 3) / 4;
    d.ctbs_x = (d.w + (1 << d.ctb_log2) - 1) >> d.ctb_log2;
    d.ctbs_y = (d.h + (1 << d.ctb_log2) - 1) >> d.ctb_log2;
    d.log2_qg = d.ctb_log2 - d.cuqp_depth;
    d.qp_prev = d.slice_qp;
    d.qg_qp_prev = d.slice_qp;
    d.ops = ops;
    d.ops_cap = ops_cap;
    d.tu_meta = tu_meta;
    d.tu_cap = tu_cap;
    d.levels = levels;
    d.lv_cap = lv_cap;
    d.sao = sao_out;
    d.ct_depth = ct_depth;
    d.luma_mode = luma_mode;
    d.qp_map = qp_map;
    d.bypass_map = bypass_map;
    d.zone = zone;
    return decode_segment_core(&d, data, sub_bounds, segp[3],
                               ts_to_rs, rs_to_ts, tile_of_rs,
                               slice_of_ctb, segp[0], segp[1],
                               segp[2], sm_fresh, sm_io, wpp_sm,
                               wpp_meta, n_tus_out);
}

/* ---------------- reconstruction (8.4.4.2 + 8.6) ---------------------
 *
 * Native mirror of formats/hevc_recon.py: per-TB intra prediction
 * (reference gather + substitution + smoothing + planar/DC/35-angular
 * with boundary filters), dequant + 4/8/16/32-pt inverse transforms /
 * 4-pt DST / transform-skip / bypass, residual add.  Deblock + SAO
 * stay in numpy (whole-plane vectorized).  8-bit path.
 */

static const int16_t DCT_BASE[33] = {
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0};
static const int16_t DST4M[4][4] = {{29, 55, 74, 84},
                                    {74, 74, 0, -74},
                                    {84, -29, -74, 55},
                                    {55, -84, 74, -29}};
static const int LEVEL_SCALE[6] = {40, 45, 51, 57, 64, 72};
static const int8_t ANGLE_T[33] = {
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
    -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26,
    32};
static const int16_t INV_ANGLE_T[15] = {
    -4096, -1638, -910, -630, -482, -390, -315, -256, -315, -390,
    -482, -630, -910, -1638, -4096};

static int dct_m(int row, int col, int n) {
    int step = 32 / n;
    int k = row * step;
    if (k == 0)
        return 64;
    int a = (k * (2 * col + 1)) % 128;
    if (a > 64)
        a = 128 - a;
    return a > 32 ? -DCT_BASE[64 - a] : DCT_BASE[a];
}

typedef struct {
    int32_t *pl[3];
    uint8_t *mask[3];     /* 4x4 availability, per plane */
    int pw[3], ph[3], mw[3];
    int bd, strong;
} Recon;

static void r_gather(Recon *rc, int plane, int x, int y, int n,
                     int32_t *vals /* 4n+1 */) {
    int32_t *pl = rc->pl[plane];
    uint8_t *mask = rc->mask[plane];
    int pw = rc->pw[plane], ph = rc->ph[plane], mw = rc->mw[plane];
    int total = 4 * n + 1;

    /* fast path: fully-interior TB with every reference cell decoded
     * — check the 4x4 mask cells once per span, then bulk-copy with
     * no per-sample tests (the common case away from edges) */
    if (x > 0 && y > 0 && y + 2 * n <= ph && x + 2 * n <= pw) {
        int lc = (x - 1) / 4;
        int ok_all = mask[((y - 1) / 4) * mw + lc];
        for (int cy = y / 4; ok_all && cy <= (y + 2 * n - 1) / 4; cy++)
            ok_all = mask[cy * mw + lc];
        int tr = (y - 1) / 4;
        for (int cx = x / 4; ok_all && cx <= (x + 2 * n - 1) / 4; cx++)
            ok_all = mask[tr * mw + cx];
        if (ok_all) {
            for (int i = 0; i < 2 * n; i++)
                vals[i] = pl[(long)(y + 2 * n - 1 - i) * pw + x - 1];
            vals[2 * n] = pl[(long)(y - 1) * pw + x - 1];
            const int32_t *top = pl + (long)(y - 1) * pw + x;
            for (int i = 0; i < 2 * n; i++)
                vals[2 * n + 1 + i] = top[i];
            return;
        }
    }

    uint8_t ok[129];
    memset(ok, 0, total);
    if (x > 0) {
        for (int i = 0; i < 2 * n; i++) {
            int sy = y + 2 * n - 1 - i;
            if (sy < ph && mask[(sy / 4) * mw + (x - 1) / 4]) {
                vals[i] = pl[(long)sy * pw + x - 1];
                ok[i] = 1;
            }
        }
    }
    if (x > 0 && y > 0 && mask[((y - 1) / 4) * mw + (x - 1) / 4]) {
        vals[2 * n] = pl[(long)(y - 1) * pw + x - 1];
        ok[2 * n] = 1;
    }
    if (y > 0) {
        for (int i = 0; i < 2 * n; i++) {
            int sx = x + i;
            if (sx < pw && mask[((y - 1) / 4) * mw + sx / 4]) {
                vals[2 * n + 1 + i] = pl[(long)(y - 1) * pw + sx];
                ok[2 * n + 1 + i] = 1;
            }
        }
    }
    int any = 0;
    for (int i = 0; i < total; i++)
        if (ok[i]) {
            any = 1;
            break;
        }
    if (!any) {
        int32_t mid = 1 << (rc->bd - 1);
        for (int i = 0; i < total; i++)
            vals[i] = mid;
        return;
    }
    if (!ok[0]) {
        int f = 0;
        while (!ok[f])
            f++;
        vals[0] = vals[f];
        ok[0] = 1;
    }
    for (int i = 1; i < total; i++)
        if (!ok[i])
            vals[i] = vals[i - 1];
}

/* predict one nxn TB into pred[n*n] */
static void r_predict(Recon *rc, int plane, int x, int y, int n,
                      int mode, int32_t *pred) {
    int32_t vals[129];
    r_gather(rc, plane, x, y, n, vals);
    /* left[i] = vals[2n-1-i], corner = vals[2n], top[i] = vals[2n+1+i] */
    int32_t top[65], left[65];
    for (int i = 0; i < 2 * n; i++) {
        left[i] = vals[2 * n - 1 - i];
        top[i] = vals[2 * n + 1 + i];
    }
    int32_t corner = vals[2 * n];
    int bd = rc->bd, maxv = (1 << bd) - 1;

    if (plane == 0 && mode != 1 && n != 4) {
        int md = mode - 26;
        if (md < 0)
            md = -md;
        int md2 = mode - 10;
        if (md2 < 0)
            md2 = -md2;
        int mind = md < md2 ? md : md2;
        int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
        if (mode == 0 || mind > thres) {
            int32_t ft[65], fl[65];
            if (n == 32 && rc->strong) {
                int32_t dt = corner + top[2 * n - 1] - 2 * top[n - 1];
                int32_t dl = corner + left[2 * n - 1] - 2 * left[n - 1];
                if (dt < 0)
                    dt = -dt;
                if (dl < 0)
                    dl = -dl;
                if (dt < (1 << (bd - 5)) && dl < (1 << (bd - 5))) {
                    for (int i = 0; i < 2 * n - 1; i++) {
                        ft[i] = ((63 - i) * corner
                                 + (i + 1) * top[2 * n - 1] + 32) >> 6;
                        fl[i] = ((63 - i) * corner
                                 + (i + 1) * left[2 * n - 1] + 32) >> 6;
                    }
                    ft[2 * n - 1] = top[2 * n - 1];
                    fl[2 * n - 1] = left[2 * n - 1];
                    memcpy(top, ft, sizeof(int32_t) * 2 * n);
                    memcpy(left, fl, sizeof(int32_t) * 2 * n);
                    goto predict;
                }
            }
            ft[0] = (corner + 2 * top[0] + top[1] + 2) >> 2;
            fl[0] = (corner + 2 * left[0] + left[1] + 2) >> 2;
            for (int i = 1; i < 2 * n - 1; i++) {
                ft[i] = (top[i - 1] + 2 * top[i] + top[i + 1] + 2) >> 2;
                fl[i] = (left[i - 1] + 2 * left[i] + left[i + 1] + 2)
                    >> 2;
            }
            ft[2 * n - 1] = top[2 * n - 1];
            fl[2 * n - 1] = left[2 * n - 1];
            int32_t fc = (left[0] + 2 * corner + top[0] + 2) >> 2;
            memcpy(top, ft, sizeof(int32_t) * 2 * n);
            memcpy(left, fl, sizeof(int32_t) * 2 * n);
            corner = fc;
        }
    }
predict:;
    int log2n = 2;
    while ((1 << log2n) < n)
        log2n++;
    if (mode == 0) {                          /* planar */
        for (int r = 0; r < n; r++)
            for (int c = 0; c < n; c++)
                pred[r * n + c] = (int32_t)(
                    ((n - 1 - c) * left[r] + (c + 1) * top[n]
                     + (n - 1 - r) * top[c] + (r + 1) * left[n] + n)
                    >> (log2n + 1));
        return;
    }
    if (mode == 1) {                          /* DC */
        int32_t s = n;
        for (int i = 0; i < n; i++)
            s += top[i] + left[i];
        int dc = (int)(s >> (log2n + 1));
        for (int i = 0; i < n * n; i++)
            pred[i] = dc;
        if (plane == 0 && n < 32) {
            pred[0] = (int32_t)((left[0] + 2 * dc + top[0] + 2) >> 2);
            for (int c = 1; c < n; c++)
                pred[c] = (int32_t)((top[c] + 3 * dc + 2) >> 2);
            for (int r = 1; r < n; r++)
                pred[r * n] = (int32_t)((left[r] + 3 * dc + 2) >> 2);
        }
        return;
    }
    /* angular */
    int angle = ANGLE_T[mode - 2];
    int32_t *main_a = mode >= 18 ? top : left;
    int32_t *side_a = mode >= 18 ? left : top;
    int32_t ref[129];                         /* index offset n */
    for (int i = 0; i < 3 * n + 1; i++)
        ref[i] = 0;
    ref[n] = corner;
    for (int i = 0; i < 2 * n; i++)
        ref[n + 1 + i] = main_a[i];
    if (angle < 0) {
        int last = (n * angle) >> 5;
        if (last < -1) {
            int inv = INV_ANGLE_T[mode - 11];
            for (int i = -1; i >= last; i--) {
                int idx = ((i * inv + 128) >> 8) - 1;
                ref[n + i] = idx >= 0 ? side_a[idx] : corner;
            }
        }
    }
    for (int d = 0; d < n; d++) {             /* distance from edge */
        int pos = (d + 1) * angle;
        int ii = pos >> 5, ff = pos & 31;
        for (int c = 0; c < n; c++) {
            int base = n + 1 + ii + c;
            int32_t a = ref[base];
            int32_t b = ff ? ref[base + 1] : a;
            int v = (int)(((32 - ff) * a + ff * b + 16) >> 5);
            if (mode >= 18)
                pred[d * n + c] = v;          /* rows = y */
            else
                pred[c * n + d] = v;          /* transpose */
        }
    }
    if (plane == 0 && n < 32) {
        if (mode == 26) {
            for (int r = 0; r < n; r++) {
                int v = (int)(top[0] + ((left[r] - corner) >> 1));
                pred[r * n] = v < 0 ? 0 : (v > maxv ? maxv : v);
            }
        } else if (mode == 10) {
            for (int c = 0; c < n; c++) {
                int v = (int)(left[0] + ((top[c] - corner) >> 1));
                pred[c] = v < 0 ? 0 : (v > maxv ? maxv : v);
            }
        }
    }
}

/* transposed transform matrices MT[i][j] = M[j][i], precomputed once
 * per size so the N^3 stages are table-driven (dct_m has a modulo per
 * element; it was the recon hot spot) */
static int16_t DCT_MT4[4][4], DCT_MT8[8][8], DCT_MT16[16][16],
    DCT_MT32[32][32], DST_MT4[4][4];
/* freq-deinterleaved rows for the stage-2 butterfly:
 * MTD[i][k] = M[2k][i] (k < n/2), MTD[i][n/2 + k] = M[2k+1][i] */
static int16_t DCT_MTD4[4][4], DCT_MTD8[8][8], DCT_MTD16[16][16],
    DCT_MTD32[32][32];
/* paired-row tables for the _mm256_madd_epi16 stage 2: PE_n[t] holds,
 * interleaved per output i, the i-th coefficients of even-freq rows
 * (4t, 4t+2); PO_n[t] the odd-freq rows (4t+1, 4t+3) */
static int16_t PE32[8][32], PO32[8][32], PE16[4][16], PO16[4][16],
    PE8[2][8], PO8[2][8];
static int mt_ready = 0;

static void mt_init(void) {
    if (mt_ready)
        return;
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) {
            DCT_MT4[i][j] = (int16_t)dct_m(j, i, 4);
            DST_MT4[i][j] = DST4M[j][i];
        }
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            DCT_MT8[i][j] = (int16_t)dct_m(j, i, 8);
    for (int i = 0; i < 16; i++)
        for (int j = 0; j < 16; j++)
            DCT_MT16[i][j] = (int16_t)dct_m(j, i, 16);
    for (int i = 0; i < 32; i++)
        for (int j = 0; j < 32; j++)
            DCT_MT32[i][j] = (int16_t)dct_m(j, i, 32);
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++)
            DCT_MTD4[i][(j & 1) ? 2 + (j >> 1) : (j >> 1)] =
                DCT_MT4[i][j];
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            DCT_MTD8[i][(j & 1) ? 4 + (j >> 1) : (j >> 1)] =
                DCT_MT8[i][j];
    for (int i = 0; i < 16; i++)
        for (int j = 0; j < 16; j++)
            DCT_MTD16[i][(j & 1) ? 8 + (j >> 1) : (j >> 1)] =
                DCT_MT16[i][j];
    for (int i = 0; i < 32; i++)
        for (int j = 0; j < 32; j++)
            DCT_MTD32[i][(j & 1) ? 16 + (j >> 1) : (j >> 1)] =
                DCT_MT32[i][j];
    for (int t = 0; t < 8; t++)
        for (int i = 0; i < 16; i++) {
            PE32[t][2 * i] = (int16_t)dct_m(4 * t, i, 32);
            PE32[t][2 * i + 1] = (int16_t)dct_m(4 * t + 2, i, 32);
            PO32[t][2 * i] = (int16_t)dct_m(4 * t + 1, i, 32);
            PO32[t][2 * i + 1] = (int16_t)dct_m(4 * t + 3, i, 32);
        }
    for (int t = 0; t < 4; t++)
        for (int i = 0; i < 8; i++) {
            PE16[t][2 * i] = (int16_t)dct_m(4 * t, i, 16);
            PE16[t][2 * i + 1] = (int16_t)dct_m(4 * t + 2, i, 16);
            PO16[t][2 * i] = (int16_t)dct_m(4 * t + 1, i, 16);
            PO16[t][2 * i + 1] = (int16_t)dct_m(4 * t + 3, i, 16);
        }
    for (int t = 0; t < 2; t++)
        for (int i = 0; i < 4; i++) {
            PE8[t][2 * i] = (int16_t)dct_m(4 * t, i, 8);
            PE8[t][2 * i + 1] = (int16_t)dct_m(4 * t + 2, i, 8);
            PO8[t][2 * i] = (int16_t)dct_m(4 * t + 1, i, 8);
            PO8[t][2 * i + 1] = (int16_t)dct_m(4 * t + 3, i, 8);
        }
    mt_ready = 1;
}

static const int16_t *mt_for(int n, int dst) {
    if (dst)
        return &DST_MT4[0][0];
    switch (n) {
    case 4: return &DCT_MT4[0][0];
    case 8: return &DCT_MT8[0][0];
    case 16: return &DCT_MT16[0][0];
    default: return &DCT_MT32[0][0];
    }
}

static const int16_t *mtd_for(int n) {
    switch (n) {
    case 4: return &DCT_MTD4[0][0];
    case 8: return &DCT_MTD8[0][0];
    case 16: return &DCT_MTD16[0][0];
    default: return &DCT_MTD32[0][0];
    }
}

/* dequant + inverse transform into res[n*n] ([y][x]).
 *
 * int32 accumulators throughout (|M| <= 91, operands clipped to
 * 16-bit, <= 32 terms -> |sum| <= 95M < 2^31), with both stages
 * bounded by the nonzero coefficient extent: rows/cols of d beyond
 * the last significant coefficient contribute nothing (typical TUs
 * are corner-sparse, so this cuts the N^3 work 2-10x). */
static inline __attribute__((always_inline)) void r_residual_impl(
    const int16_t *lv, int n, int qp, int skip,
    int bypass, int dst, int bd, int32_t *res) {
    if (bypass) {
        for (int i = 0; i < n * n; i++)
            res[i] = lv[i];
        return;
    }
    int log2n = 2;
    while ((1 << log2n) < n)
        log2n++;
    int bd_shift = bd + log2n - 5;
    int32_t scale = (int32_t)(16 * LEVEL_SCALE[qp % 6]) << (qp / 6);
    /* occupancy pre-scan on the raw int16 levels (2 OR ops/element,
     * 16 lanes) so the int32 dequant below only touches nonzero rows
     * and the column extent — typical TUs are corner-sparse, so most
     * elements never get the full clip|mul|shift|clamp treatment */
    int16_t colacc[32];
    memset(colacc, 0, sizeof(int16_t) * n);
    uint32_t row_nz = 0;
    for (int r = 0; r < n; r++) {
        const int16_t *lrow = lv + r * n;
        int16_t any = 0;
        for (int c = 0; c < n; c++) {
            any |= lrow[c];
            colacc[c] |= lrow[c];
        }
        row_nz |= (uint32_t)(any != 0) << r;
    }
    int shift2 = 20 - bd;
    if (!row_nz) {
        memset(res, 0, sizeof(int32_t) * n * n);
        return;
    }
    int last_col = n - 1;
    while (last_col >= 0 && !colacc[last_col])
        last_col--;
    /* branchless, vectorizable dequant: pre-clip levels so the
     * product fits int32 without changing the saturated result
     * (the scaling is monotone in the level) */
    int32_t bound = (int32_t)((((int64_t)32768 << bd_shift) / scale)
                              + 1);
    int32_t half1 = 1 << (bd_shift - 1);
    /* dequant output is clamped to int16 — store it as int16 so the
     * madd stage-1 can pair-load it directly */
    int16_t d[1024];
    if (skip || dst) {
        /* these paths read every element of d */
        for (int r = 0; r < n; r++) {
            const int16_t *lrow = lv + r * n;
            int16_t *drow = d + r * n;
            for (int c = 0; c < n; c++) {
                int32_t l = lrow[c];
                int32_t lc = l < -bound ? -bound
                    : (l > bound ? bound : l);
                int32_t v = (lc * scale + half1) >> bd_shift;
                drow[c] = (int16_t)(v < -32768 ? -32768
                                    : (v > 32767 ? 32767 : v));
            }
        }
    } else {
        uint32_t bits = row_nz;
        int ncq = last_col + 1;
        while (bits) {
            int r = __builtin_ctz(bits);
            bits &= bits - 1;
            const int16_t *lrow = lv + r * n;
            int16_t *drow = d + r * n;
            for (int c = 0; c < ncq; c++) {
                int32_t l = lrow[c];
                int32_t lc = l < -bound ? -bound
                    : (l > bound ? bound : l);
                int32_t v = (lc * scale + half1) >> bd_shift;
                drow[c] = (int16_t)(v < -32768 ? -32768
                                    : (v > 32767 ? 32767 : v));
            }
        }
    }
    if (skip) {
        for (int i = 0; i < n * n; i++) {
            int32_t v = ((d[i] << 7) + (1 << (shift2 - 1))) >> shift2;
            res[i] = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
        }
        return;
    }
    /* DC-only fast path: both stages collapse to one constant */
    if (row_nz == 1 && last_col == 0 && !dst) {
        int32_t s = (64 * d[0] + 64) >> 7;
        if (s < -32768) s = -32768;
        if (s > 32767) s = 32767;
        int32_t v = (64 * s + (1 << (shift2 - 1))) >> shift2;
        int32_t r0 = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
        for (int i = 0; i < n * n; i++)
            res[i] = r0;
        return;
    }
    int ncols = last_col + 1;
    int32_t half2 = 1 << (shift2 - 1);
    if (dst) {
        /* DST-VII has no even/odd symmetry: direct 4x4 path */
        const int16_t *MT = mt_for(n, dst);
        int32_t e[16];
        for (int i = 0; i < 4; i++)
            for (int xx = 0; xx < 4; xx++) {
                int32_t s = 0;
                for (int j = 0; j < 4; j++)
                    s += MT[i * 4 + j] * d[j * 4 + xx];
                s = (s + 64) >> 7;
                e[i * 4 + xx] = s < -32768 ? -32768
                    : (s > 32767 ? 32767 : s);
            }
        for (int yy = 0; yy < 4; yy++)
            for (int i = 0; i < 4; i++) {
                int32_t s = 0;
                for (int j = 0; j < 4; j++)
                    s += MT[i * 4 + j] * e[yy * 4 + j];
                s = (s + half2) >> shift2;
                res[yy * 4 + i] = s < -32768 ? -32768
                    : (s > 32767 ? 32767 : s);
            }
        return;
    }
    /* DCT even/odd butterfly: M[j][n-1-i] = (-1)^j M[j][i], so each
     * 1-D transform needs only the even-freq (E) and odd-freq (O)
     * partial sums for outputs i < n/2: out[i] = E+O,
     * out[n-1-i] = E-O — exactly half the multiplies. */
    const int16_t *MT = mt_for(n, 0);
    int half = n >> 1;
    /* stage 1: accE/accO[i][x] over nonzero freq rows j.  Row stride
     * is padded to a vector multiple so the madd path needs no tail */
    int astr = ncols;
#ifdef __AVX2__
    if (n > 4)
        astr = (ncols + 7) & ~7;
#endif
    int32_t accE[512], accO[512];
    memset(accE, 0, sizeof(int32_t) * half * astr);
    memset(accO, 0, sizeof(int32_t) * half * astr);
#ifdef __AVX2__
    if (n > 4) {
        /* pair nonzero rows within each parity class: one madd
         * covers two rows x 8 columns (int16 products, int32 acc) */
        int8_t lists[2][32];
        int cnt[2] = {0, 0};
        uint32_t bits = row_nz;
        while (bits) {
            int j = __builtin_ctz(bits);
            bits &= bits - 1;
            lists[j & 1][cnt[j & 1]++] = (int8_t)j;
        }
        int16_t din[64];
        for (int par = 0; par < 2; par++) {
            int32_t *tgt = par ? accO : accE;
            for (int p = 0; p < cnt[par]; p += 2) {
                int ja = lists[par][p];
                int jb = p + 1 < cnt[par] ? lists[par][p + 1] : -1;
                const int16_t *da = d + ja * n;
                const int16_t *db = jb >= 0 ? d + jb * n : NULL;
                for (int xx = 0; xx < ncols; xx++) {
                    din[2 * xx] = da[xx];
                    din[2 * xx + 1] = db ? db[xx] : 0;
                }
                for (int xx = ncols; xx < astr; xx++) {
                    din[2 * xx] = 0;
                    din[2 * xx + 1] = 0;
                }
                for (int i = 0; i < half; i++) {
                    int32_t ma = MT[i * n + ja];
                    int32_t mb = jb >= 0 ? MT[i * n + jb] : 0;
                    if (!(ma | mb))
                        continue;
                    __m256i bm = _mm256_set1_epi32(
                        (int32_t)((uint16_t)ma
                                  | ((uint32_t)(uint16_t)mb << 16)));
                    int32_t *arow = tgt + i * astr;
                    for (int xx = 0; xx < astr; xx += 8) {
                        __m256i dv = _mm256_loadu_si256(
                            (const __m256i *)(din + 2 * xx));
                        __m256i av = _mm256_loadu_si256(
                            (__m256i *)(arow + xx));
                        av = _mm256_add_epi32(
                            av, _mm256_madd_epi16(dv, bm));
                        _mm256_storeu_si256((__m256i *)(arow + xx),
                                            av);
                    }
                }
            }
        }
    } else
#endif
    {
        uint32_t bits = row_nz;
        while (bits) {
            int j = __builtin_ctz(bits);
            bits &= bits - 1;
            const int16_t *drow = d + j * n;
            int32_t *tgt = (j & 1) ? accO : accE;
            for (int i = 0; i < half; i++) {
                int32_t m = MT[i * n + j];
                if (!m)
                    continue;
                int32_t *arow = tgt + i * astr;
                for (int xx = 0; xx < ncols; xx++)
                    arow[xx] += m * drow[xx];
            }
        }
    }
    /* e stored int16, x-deinterleaved per row: even cols at [0, nce),
     * odd cols at [half, half + nco), gaps zeroed — stage 2 reads
     * fixed half-offset lanes (clipping to int16 here is exact: the
     * scalar path always clamped e to [-32768, 32767]) */
    int nce = (ncols + 1) >> 1, nco = ncols >> 1;
    int16_t e16[1024];
#ifdef __AVX2__
    memset(e16, 0, sizeof(int16_t) * n * n);
#endif
    for (int i = 0; i < half; i++) {
        int16_t *etop = e16 + i * n;
        int16_t *ebot = e16 + (n - 1 - i) * n;
        const int32_t *aE = accE + i * astr;
        const int32_t *aO = accO + i * astr;
        for (int xx = 0; xx < ncols; xx++) {
            int pos = (xx & 1) ? half + (xx >> 1) : (xx >> 1);
            int32_t s = (aE[xx] + aO[xx] + 64) >> 7;
            etop[pos] = (int16_t)(s < -32768 ? -32768
                                  : (s > 32767 ? 32767 : s));
            s = (aE[xx] - aO[xx] + 64) >> 7;
            ebot[pos] = (int16_t)(s < -32768 ? -32768
                                  : (s > 32767 ? 32767 : s));
        }
    }
#ifdef __AVX2__
    /* stage 2 as broadcast-pair madds: for each output row, ev[i] =
     * sum_k M[2k][i] * e_even[k] accumulates with one madd per
     * (e-pair, 8 outputs); butterfly combine + clamp vectorized.
     * |ev|,|od| <= (n/2)*91*32767 < 2^31. */
    if (n == 32) {
        const __m128i vsh = _mm_cvtsi32_si128(shift2);
        const __m256i rev = _mm256_setr_epi32(7, 6, 5, 4, 3, 2, 1, 0);
        const __m256i vh2 = _mm256_set1_epi32(half2);
        const __m256i vmin = _mm256_set1_epi32(-32768);
        const __m256i vmax = _mm256_set1_epi32(32767);
        for (int yy = 0; yy < 32; yy++) {
            const int16_t *erow = e16 + yy * 32;
            __m256i ev0 = _mm256_setzero_si256(), ev1 = ev0,
                    od0 = ev0, od1 = ev0;
            for (int t = 0; t < 8; t++) {
                int32_t be_p; memcpy(&be_p, erow + 2 * t, 4);
                __m256i be = _mm256_set1_epi32(be_p);
                int32_t bo_p; memcpy(&bo_p, erow + 16 + 2 * t, 4);
                __m256i bo = _mm256_set1_epi32(bo_p);
                ev0 = _mm256_add_epi32(ev0, _mm256_madd_epi16(
                    be, _mm256_loadu_si256((const __m256i *)PE32[t])));
                ev1 = _mm256_add_epi32(ev1, _mm256_madd_epi16(
                    be, _mm256_loadu_si256(
                        (const __m256i *)(PE32[t] + 16))));
                od0 = _mm256_add_epi32(od0, _mm256_madd_epi16(
                    bo, _mm256_loadu_si256((const __m256i *)PO32[t])));
                od1 = _mm256_add_epi32(od1, _mm256_madd_epi16(
                    bo, _mm256_loadu_si256(
                        (const __m256i *)(PO32[t] + 16))));
            }
            int32_t *rrow = res + yy * 32;
            __m256i s;
            s = _mm256_sra_epi32(_mm256_add_epi32(
                _mm256_add_epi32(ev0, od0), vh2), vsh);
            s = _mm256_min_epi32(_mm256_max_epi32(s, vmin), vmax);
            _mm256_storeu_si256((__m256i *)rrow, s);
            s = _mm256_sra_epi32(_mm256_add_epi32(
                _mm256_add_epi32(ev1, od1), vh2), vsh);
            s = _mm256_min_epi32(_mm256_max_epi32(s, vmin), vmax);
            _mm256_storeu_si256((__m256i *)(rrow + 8), s);
            s = _mm256_sra_epi32(_mm256_add_epi32(
                _mm256_sub_epi32(ev0, od0), vh2), vsh);
            s = _mm256_min_epi32(_mm256_max_epi32(s, vmin), vmax);
            _mm256_storeu_si256((__m256i *)(rrow + 24),
                                _mm256_permutevar8x32_epi32(s, rev));
            s = _mm256_sra_epi32(_mm256_add_epi32(
                _mm256_sub_epi32(ev1, od1), vh2), vsh);
            s = _mm256_min_epi32(_mm256_max_epi32(s, vmin), vmax);
            _mm256_storeu_si256((__m256i *)(rrow + 16),
                                _mm256_permutevar8x32_epi32(s, rev));
        }
        return;
    }
    if (n == 16) {
        const __m128i vsh = _mm_cvtsi32_si128(shift2);
        const __m256i rev = _mm256_setr_epi32(7, 6, 5, 4, 3, 2, 1, 0);
        const __m256i vh2 = _mm256_set1_epi32(half2);
        const __m256i vmin = _mm256_set1_epi32(-32768);
        const __m256i vmax = _mm256_set1_epi32(32767);
        for (int yy = 0; yy < 16; yy++) {
            const int16_t *erow = e16 + yy * 16;
            __m256i ev = _mm256_setzero_si256(), od = ev;
            for (int t = 0; t < 4; t++) {
                int32_t be_p; memcpy(&be_p, erow + 2 * t, 4);
                __m256i be = _mm256_set1_epi32(be_p);
                int32_t bo_p; memcpy(&bo_p, erow + 8 + 2 * t, 4);
                __m256i bo = _mm256_set1_epi32(bo_p);
                ev = _mm256_add_epi32(ev, _mm256_madd_epi16(
                    be, _mm256_loadu_si256((const __m256i *)PE16[t])));
                od = _mm256_add_epi32(od, _mm256_madd_epi16(
                    bo, _mm256_loadu_si256((const __m256i *)PO16[t])));
            }
            int32_t *rrow = res + yy * 16;
            __m256i s;
            s = _mm256_sra_epi32(_mm256_add_epi32(
                _mm256_add_epi32(ev, od), vh2), vsh);
            s = _mm256_min_epi32(_mm256_max_epi32(s, vmin), vmax);
            _mm256_storeu_si256((__m256i *)rrow, s);
            s = _mm256_sra_epi32(_mm256_add_epi32(
                _mm256_sub_epi32(ev, od), vh2), vsh);
            s = _mm256_min_epi32(_mm256_max_epi32(s, vmin), vmax);
            _mm256_storeu_si256((__m256i *)(rrow + 8),
                                _mm256_permutevar8x32_epi32(s, rev));
        }
        return;
    }
    if (n == 8) {
        const __m128i vsh = _mm_cvtsi32_si128(shift2);
        const __m128i vh2 = _mm_set1_epi32(half2);
        const __m128i vmin = _mm_set1_epi32(-32768);
        const __m128i vmax = _mm_set1_epi32(32767);
        for (int yy = 0; yy < 8; yy++) {
            const int16_t *erow = e16 + yy * 8;
            __m128i ev = _mm_setzero_si128(), od = ev;
            for (int t = 0; t < 2; t++) {
                int32_t be_p; memcpy(&be_p, erow + 2 * t, 4);
                __m128i be = _mm_set1_epi32(be_p);
                int32_t bo_p; memcpy(&bo_p, erow + 4 + 2 * t, 4);
                __m128i bo = _mm_set1_epi32(bo_p);
                ev = _mm_add_epi32(ev, _mm_madd_epi16(
                    be, _mm_loadu_si128((const __m128i *)PE8[t])));
                od = _mm_add_epi32(od, _mm_madd_epi16(
                    bo, _mm_loadu_si128((const __m128i *)PO8[t])));
            }
            int32_t *rrow = res + yy * 8;
            __m128i s;
            s = _mm_sra_epi32(_mm_add_epi32(
                _mm_add_epi32(ev, od), vh2), vsh);
            s = _mm_min_epi32(_mm_max_epi32(s, vmin), vmax);
            _mm_storeu_si128((__m128i *)rrow, s);
            s = _mm_sra_epi32(_mm_add_epi32(
                _mm_sub_epi32(ev, od), vh2), vsh);
            s = _mm_min_epi32(_mm_max_epi32(s, vmin), vmax);
            _mm_storeu_si128((__m128i *)(rrow + 4),
                             _mm_shuffle_epi32(s, 0x1B));
        }
        return;
    }
#endif
    /* stage 2 with the deinterleaved matrix rows (MTD): even-freq
     * coefficients first (at 0), odd at the half offset — matching
     * e16's layout */
    const int16_t *MTD = mtd_for(n);
    for (int yy = 0; yy < n; yy++) {
        const int16_t *erow = e16 + yy * n;
        const int16_t *erow_o = erow + half;
        for (int i = 0; i < half; i++) {
            const int16_t *mrow = MTD + i * n;
            const int16_t *mrow_o = mrow + half;
            int32_t ev = 0, od = 0;
            for (int j = 0; j < nce; j++)
                ev += mrow[j] * (int32_t)erow[j];
            for (int j = 0; j < nco; j++)
                od += mrow_o[j] * (int32_t)erow_o[j];
            int32_t s = (ev + od + half2) >> shift2;
            res[yy * n + i] = s < -32768 ? -32768
                : (s > 32767 ? 32767 : s);
            s = (ev - od + half2) >> shift2;
            res[yy * n + (n - 1 - i)] = s < -32768 ? -32768
                : (s > 32767 ? 32767 : s);
        }
    }
}

/* constant-N instantiations: fixed trip counts let gcc fully unroll
 * and vectorize the dequant and butterfly loops per TU size */
static void r_residual(const int16_t *lv, int n, int qp, int skip,
                       int bypass, int dst, int bd, int32_t *res) {
    switch (n) {
    case 4:
        r_residual_impl(lv, 4, qp, skip, bypass, dst, bd, res);
        break;
    case 8:
        r_residual_impl(lv, 8, qp, skip, bypass, dst, bd, res);
        break;
    case 16:
        r_residual_impl(lv, 16, qp, skip, bypass, dst, bd, res);
        break;
    default:
        r_residual_impl(lv, 32, qp, skip, bypass, dst, bd, res);
        break;
    }
}

FFPIC_API int ffpic_hevc_recon(
    int32_t *Y, int32_t *U, int32_t *V,
    int w, int h, int cw, int ch, int n_planes, int bd, int strong,
    const int32_t *ops, long n_ops,
    const int32_t *tu_meta, long n_tus,
    const int16_t *levels) {
    return ffpic_hevc_recon2(Y, U, V, w, h, cw, ch, n_planes, bd,
                             strong, ops, n_ops, tu_meta, n_tus,
                             levels, (const int16_t *)0);
}

/* recon with optional PRECOMPUTED residuals (int16, packed per TU in
 * the same layout as `levels`) — the device TU-bucket path
 * (ops/hevc_kernels) computes them in batched MXU launches and this
 * entry just adds them to the prediction. */
FFPIC_API int ffpic_hevc_recon2(
    int32_t *Y, int32_t *U, int32_t *V,
    int w, int h, int cw, int ch, int n_planes, int bd, int strong,
    const int32_t *ops, long n_ops,
    const int32_t *tu_meta, long n_tus,
    const int16_t *levels, const int16_t *resid) {
    Recon rc;
    rc.pl[0] = Y;
    rc.pl[1] = U;
    rc.pl[2] = V;
    rc.pw[0] = w;
    rc.ph[0] = h;
    rc.pw[1] = rc.pw[2] = cw;
    rc.ph[1] = rc.ph[2] = ch;
    rc.bd = bd;
    rc.strong = strong;
    long msz[3];
    for (int p = 0; p < n_planes; p++) {
        rc.mw[p] = (rc.pw[p] + 3) / 4;
        msz[p] = (long)rc.mw[p] * ((rc.ph[p] + 3) / 4);
        rc.mask[p] = calloc(msz[p], 1);
        if (!rc.mask[p])
            return -1;
    }
    /* per-TU level offsets */
    long *tu_off = malloc(sizeof(long) * (n_tus + 1));
    if (!tu_off)
        return -1;
    tu_off[0] = 0;
    for (long t = 0; t < n_tus; t++) {
        int n = tu_meta[t * 8 + 2];
        tu_off[t + 1] = tu_off[t] + (long)n * n;
    }
    int32_t pred[1024], res[1024];
    int maxv = (1 << bd) - 1;
    for (long o = 0; o < n_ops; o++) {
        const int32_t *op = ops + o * 6;
        int plane = op[0], x = op[1], y = op[2], n = op[3],
            mode = op[4];
        long tu = op[5];
        if (plane >= n_planes)
            continue;
        r_predict(&rc, plane, x, y, n, mode, pred);
        if (tu >= 0) {
            const int32_t *m = tu_meta + tu * 8;
            if (resid) {
                const int16_t *rr = resid + tu_off[tu];
                for (int i = 0; i < n * n; i++) {
                    int v = pred[i] + rr[i];
                    pred[i] = v < 0 ? 0 : (v > maxv ? maxv : v);
                }
            } else {
                r_residual(levels + tu_off[tu], n, m[6], m[4], m[5],
                           m[7], bd, res);
                for (int i = 0; i < n * n; i++) {
                    int v = pred[i] + res[i];
                    pred[i] = v < 0 ? 0 : (v > maxv ? maxv : v);
                }
            }
        }
        int32_t *pl = rc.pl[plane];
        int pw = rc.pw[plane], phh = rc.ph[plane];
        int rmax = n < phh - y ? n : phh - y;
        int cmax = n < pw - x ? n : pw - x;
        for (int r = 0; r < rmax; r++)
            memcpy(pl + (long)(y + r) * pw + x, pred + r * n,
                   sizeof(int32_t) * cmax);
        /* mark decoded */
        int mw = rc.mw[plane];
        int mhh = (phh + 3) / 4;
        for (int r = y / 4; r < (y + n + 3) / 4 && r < mhh; r++)
            for (int c = x / 4; c < (x + n + 3) / 4 && c < mw; c++)
                rc.mask[plane][(long)r * mw + c] = 1;
    }
    free(tu_off);
    for (int p = 0; p < n_planes; p++)
        free(rc.mask[p]);
    return 0;
}

/* ---------------- YUV420/400 -> RGBA color convert -------------------
 * Matches formats/heif.py _yuv_pic_to_rgba's numpy-float32 path
 * op-for-op (same float order, same constants) so host C and numpy
 * outputs are bit-identical; ~10x faster than the multi-pass numpy.
 * rnd_trunc=1 reproduces the reference's trunc quirk (colorspace.c
 * float LUT path); otherwise round-half-up via floor(x + .5). */
#include <math.h>

#if defined(__AVX2__) && defined(__FMA__)
#include <immintrin.h>
/* 4:2:0 vector path: 16 pixels/iter, same float op order as the
 * scalar loop below (fmadd matches gcc's -ffp-contract on it), so
 * output bytes are identical — verified across the full
 * limited x rnd_trunc matrix and odd sizes. */
static void yuv_rgba_avx2(const int32_t *Y, const int32_t *U,
    const int32_t *V, int w, int h, int cw, int bd,
    float a_rv, float a_gu, float a_gv, float a_bu,
    int limited, int rnd_trunc, uint8_t *out) {
    float sc = 255.0f / (float)((1 << bd) - 1);
    float mid = (float)(1 << (bd - 1));
    const float yl = 255.0f / 219.0f, cl = 255.0f / 224.0f;
    __m256 vsc = _mm256_set1_ps(sc), vmid = _mm256_set1_ps(mid);
    __m256 vyl = _mm256_set1_ps(yl), vcl = _mm256_set1_ps(cl);
    __m256 v16 = _mm256_set1_ps(16.0f);
    __m256 vhalf = _mm256_set1_ps(0.5f);
    __m256 vrv = _mm256_set1_ps(a_rv), vgu = _mm256_set1_ps(a_gu);
    __m256 vgv = _mm256_set1_ps(a_gv), vbu = _mm256_set1_ps(a_bu);
    __m256 vzero = _mm256_setzero_ps();
    __m256 v255 = _mm256_set1_ps(255.0f);
    __m256i valpha = _mm256_set1_epi32((int)0xFF000000u);
    __m256i dup_lo = _mm256_setr_epi32(0, 0, 1, 1, 2, 2, 3, 3);
    __m256i dup_hi = _mm256_setr_epi32(4, 4, 5, 5, 6, 6, 7, 7);
    int wv = w & ~15;
    for (int y = 0; y < h; y++) {
        const int32_t *yrow = Y + (long)y * w;
        const int32_t *urow = U + (long)(y >> 1) * cw;
        const int32_t *vrow = V + (long)(y >> 1) * cw;
        uint8_t *o = out + (long)y * w * 4;
        int x = 0;
        for (; x < wv; x += 16) {
            /* 8 chroma samples cover these 16 pixels; max index
             * (wv-16)/2 + 7 < cw, so the unaligned load stays
             * in-bounds */
            __m256 u8f = _mm256_cvtepi32_ps(_mm256_loadu_si256(
                (const __m256i *)(urow + (x >> 1))));
            __m256 v8f = _mm256_cvtepi32_ps(_mm256_loadu_si256(
                (const __m256i *)(vrow + (x >> 1))));
            u8f = _mm256_mul_ps(_mm256_sub_ps(u8f, vmid), vsc);
            v8f = _mm256_mul_ps(_mm256_sub_ps(v8f, vmid), vsc);
            if (limited) {
                u8f = _mm256_mul_ps(u8f, vcl);
                v8f = _mm256_mul_ps(v8f, vcl);
            }
            for (int hf = 0; hf < 2; hf++) {
                __m256i dup = hf ? dup_hi : dup_lo;
                __m256 uu = _mm256_permutevar8x32_ps(u8f, dup);
                __m256 vv = _mm256_permutevar8x32_ps(v8f, dup);
                __m256 yy = _mm256_mul_ps(_mm256_cvtepi32_ps(
                    _mm256_loadu_si256(
                        (const __m256i *)(yrow + x + 8 * hf))), vsc);
                if (limited)
                    yy = _mm256_mul_ps(_mm256_sub_ps(yy, v16), vyl);
                __m256 r = _mm256_fmadd_ps(vrv, vv, yy);
                __m256 g = _mm256_fmadd_ps(
                    vgv, vv, _mm256_fmadd_ps(vgu, uu, yy));
                __m256 b = _mm256_fmadd_ps(vbu, uu, yy);
                if (rnd_trunc) {
                    r = _mm256_round_ps(r,
                        _MM_FROUND_TO_ZERO | _MM_FROUND_NO_EXC);
                    g = _mm256_round_ps(g,
                        _MM_FROUND_TO_ZERO | _MM_FROUND_NO_EXC);
                    b = _mm256_round_ps(b,
                        _MM_FROUND_TO_ZERO | _MM_FROUND_NO_EXC);
                } else {
                    r = _mm256_floor_ps(_mm256_add_ps(r, vhalf));
                    g = _mm256_floor_ps(_mm256_add_ps(g, vhalf));
                    b = _mm256_floor_ps(_mm256_add_ps(b, vhalf));
                }
                r = _mm256_min_ps(_mm256_max_ps(r, vzero), v255);
                g = _mm256_min_ps(_mm256_max_ps(g, vzero), v255);
                b = _mm256_min_ps(_mm256_max_ps(b, vzero), v255);
                __m256i ri = _mm256_cvttps_epi32(r);
                __m256i gi = _mm256_slli_epi32(
                    _mm256_cvttps_epi32(g), 8);
                __m256i bi = _mm256_slli_epi32(
                    _mm256_cvttps_epi32(b), 16);
                __m256i px = _mm256_or_si256(
                    _mm256_or_si256(ri, gi),
                    _mm256_or_si256(bi, valpha));
                _mm256_storeu_si256(
                    (__m256i *)(o + (long)(x + 8 * hf) * 4), px);
            }
        }
        for (; x < w; x++) {
            int cx = x >> 1;
            if (cx >= cw)
                cx = cw - 1;
            float yy = (float)yrow[x] * sc;
            float uu = ((float)urow[cx] - mid) * sc;
            float vv = ((float)vrow[cx] - mid) * sc;
            if (limited) {
                yy = (yy - 16.0f) * yl;
                uu *= cl;
                vv *= cl;
            }
            float r, g, b;
            if (rnd_trunc) {
                r = truncf(yy + a_rv * vv);
                g = truncf(yy + a_gu * uu + a_gv * vv);
                b = truncf(yy + a_bu * uu);
            } else {
                r = floorf(yy + a_rv * vv + 0.5f);
                g = floorf(yy + a_gu * uu + a_gv * vv + 0.5f);
                b = floorf(yy + a_bu * uu + 0.5f);
            }
            o[x * 4] = r < 0.0f ? 0 : (r > 255.0f ? 255 : (uint8_t)r);
            o[x * 4 + 1] = g < 0.0f ? 0
                : (g > 255.0f ? 255 : (uint8_t)g);
            o[x * 4 + 2] = b < 0.0f ? 0
                : (b > 255.0f ? 255 : (uint8_t)b);
            o[x * 4 + 3] = 255;
        }
    }
}
#endif

FFPIC_API void ffpic_yuv_to_rgba(
    const int32_t *Y, const int32_t *U, const int32_t *V,
    int w, int h, int cw, int ch, int mono, int bd,
    float a_rv, float a_gu, float a_gv, float a_bu,
    int limited, int rnd_trunc, uint8_t *out) {
#if defined(__AVX2__) && defined(__FMA__)
    if (!mono) {
        yuv_rgba_avx2(Y, U, V, w, h, cw, bd, a_rv, a_gu, a_gv, a_bu,
                      limited, rnd_trunc, out);
        return;
    }
#endif
    float sc = 255.0f / (float)((1 << bd) - 1);
    float mid = (float)(1 << (bd - 1));
    const float yl = 255.0f / 219.0f, cl = 255.0f / 224.0f;
    for (int y = 0; y < h; y++) {
        const int32_t *yrow = Y + (long)y * w;
        const int32_t *urow = mono ? NULL : U + (long)(y >> 1) * cw;
        const int32_t *vrow = mono ? NULL : V + (long)(y >> 1) * cw;
        uint8_t *o = out + (long)y * w * 4;
        for (int x = 0; x < w; x++) {
            float yy = (float)yrow[x] * sc;
            float uu = 0.0f, vv = 0.0f;
            if (!mono) {
                int cx = x >> 1;
                uu = ((float)urow[cx < cw ? cx : cw - 1] - mid) * sc;
                vv = ((float)vrow[cx < cw ? cx : cw - 1] - mid) * sc;
            }
            if (limited) {
                yy = (yy - 16.0f) * yl;
                uu = uu * cl;
                vv = vv * cl;
            }
            float r, g, b;
            if (rnd_trunc) {
                r = truncf(yy + a_rv * vv);
                g = truncf(yy + a_gu * uu + a_gv * vv);
                b = truncf(yy + a_bu * uu);
            } else {
                r = floorf(yy + a_rv * vv + 0.5f);
                g = floorf(yy + a_gu * uu + a_gv * vv + 0.5f);
                b = floorf(yy + a_bu * uu + 0.5f);
            }
            o[x * 4] = r < 0.0f ? 0 : (r > 255.0f ? 255 : (uint8_t)r);
            o[x * 4 + 1] = g < 0.0f ? 0
                : (g > 255.0f ? 255 : (uint8_t)g);
            o[x * 4 + 2] = b < 0.0f ? 0
                : (b > 255.0f ? 255 : (uint8_t)b);
            o[x * 4 + 3] = 255;
        }
    }
}
