/* host_jp2.c — JPEG 2000 EBCOT tier-1 code-block decoder (the hot
 * ~95% of JP2 decode; tier-2 packet parsing and the wavelets stay in
 * numpy).  Exact C mirror of coding/jpeg2000.py's MQDecoder +
 * BlockDecoder, which are differentially validated against openjpeg.
 *
 * Copied from ffpic_tpu/native/host_jp2.c (ffpic_jp2_block) unchanged.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define FFPIC_API __attribute__((visibility("default")))

/* ---------------- MQ decoder (ISO 15444-1 Annex C) ------------------- */

typedef struct {
    uint16_t qe;
    uint8_t nmps, nlps, sw;
} Qe;

static const Qe QE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

#define N_CTX 19
#define CTX_UNI 18
#define CTX_RL 17

typedef struct {
    const uint8_t *data;
    long len, bp;
    uint32_t c, a;
    int ct;
    uint8_t idx[N_CTX], mps[N_CTX];
} MQ;

static void mq_bytein(MQ *m) {
    uint8_t b = m->bp < m->len ? m->data[m->bp] : 0xFF;
    if (b == 0xFF) {
        uint8_t b1 = m->bp + 1 < m->len ? m->data[m->bp + 1] : 0xFF;
        if (b1 > 0x8F) {
            m->c += 0xFF00;
            m->ct = 8;
        } else {
            m->bp++;
            m->c += (uint32_t)b1 << 9;
            m->ct = 7;
        }
    } else {
        m->bp++;
        uint8_t b1 = m->bp < m->len ? m->data[m->bp] : 0xFF;
        m->c += (uint32_t)b1 << 8;
        m->ct = 8;
    }
}

static void mq_init(MQ *m, const uint8_t *data, long len) {
    m->data = data;
    m->len = len;
    m->bp = 0;
    uint8_t b0 = len ? data[0] : 0xFF;
    m->c = (uint32_t)b0 << 16;
    m->ct = 0;
    mq_bytein(m);
    m->c <<= 7;
    m->ct -= 7;
    m->a = 0x8000;
    memset(m->idx, 0, N_CTX);
    memset(m->mps, 0, N_CTX);
    m->idx[CTX_UNI] = 46;
    m->idx[CTX_RL] = 3;
    m->idx[0] = 4;
}

static int mq_decode(MQ *m, int cx) {
    const Qe *q = &QE[m->idx[cx]];
    int d;
    m->a -= q->qe;
    if (((m->c >> 16) & 0xFFFF) < q->qe) {
        if (m->a < q->qe) {
            d = m->mps[cx];
            m->idx[cx] = q->nmps;
        } else {
            d = 1 - m->mps[cx];
            if (q->sw)
                m->mps[cx] ^= 1;
            m->idx[cx] = q->nlps;
        }
        m->a = q->qe;
    } else {
        m->c -= (uint32_t)q->qe << 16;
        if (m->a & 0x8000)
            return m->mps[cx];
        if (m->a < q->qe) {
            d = 1 - m->mps[cx];
            if (q->sw)
                m->mps[cx] ^= 1;
            m->idx[cx] = q->nlps;
        } else {
            d = m->mps[cx];
            m->idx[cx] = q->nmps;
        }
    }
    do {
        if (m->ct == 0)
            mq_bytein(m);
        m->a <<= 1;
        m->c <<= 1;
        m->ct--;
    } while (!(m->a & 0x8000));
    m->a &= 0xFFFF;
    return d;
}

/* ---------------- tier-1 block decoder (Annex D) ---------------------- */

/* zero-coding ctx tables [kind][h][v][d], built at load */
static uint8_t ZC[3][3][3][5];
__attribute__((constructor)) static void zc_init(void) {
    for (int h = 0; h < 3; h++)
        for (int v = 0; v < 3; v++)
            for (int d = 0; d < 5; d++) {
                int c;
                if (h == 2)
                    c = 8;
                else if (h == 1)
                    c = v >= 1 ? 7 : (d >= 1 ? 6 : 5);
                else if (v == 2)
                    c = 4;
                else if (v == 1)
                    c = 3;
                else if (d >= 2)
                    c = 2;
                else
                    c = d;
                ZC[0][h][v][d] = (uint8_t)c;
                ZC[1][v][h][d] = (uint8_t)c;
                int hv = h + v, c2;
                if (d >= 3)
                    c2 = 8;
                else if (d == 2)
                    c2 = hv >= 1 ? 7 : 6;
                else if (d == 1)
                    c2 = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
                else
                    c2 = hv >= 2 ? 2 : hv;
                ZC[2][h][v][d] = (uint8_t)c2;
            }
}

/* sign coding: index (hc+1)*3 + (vc+1) -> ctx, xorbit */
static const uint8_t SC_CTX[9] = {13, 12, 11, 10, 9, 10, 11, 12, 13};
static const uint8_t SC_XOR[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};

typedef struct {
    int w, h, orient;
    uint8_t *sig, *sgn, *vis, *ref;  /* padded (h+2, w+2) */
    int32_t *mag;                    /* (h, w) */
    int stride;
} Blk;

static inline void hvd(Blk *b, int y, int x, int *hn, int *vn,
                       int *dn) {
    uint8_t *s = b->sig;
    int st = b->stride;
    *hn = s[y * st + x - 1] + s[y * st + x + 1];
    *vn = s[(y - 1) * st + x] + s[(y + 1) * st + x];
    *dn = s[(y - 1) * st + x - 1] + s[(y - 1) * st + x + 1]
        + s[(y + 1) * st + x - 1] + s[(y + 1) * st + x + 1];
}

static inline int zc_ctx(Blk *b, int y, int x) {
    int hn, vn, dn;
    hvd(b, y, x, &hn, &vn, &dn);
    if (hn > 2)
        hn = 2;
    if (vn > 2)
        vn = 2;
    if (dn > 4)
        dn = 4;
    return ZC[b->orient][hn][vn][dn];
}

static inline int contrib(int sa, int ga, int sb, int gb) {
    int c = 0;
    if (sa)
        c += ga ? -1 : 1;
    if (sb)
        c += gb ? -1 : 1;
    return c < -1 ? -1 : (c > 1 ? 1 : c);
}

static int dec_sign(Blk *b, MQ *m, int y, int x) {
    uint8_t *s = b->sig, *g = b->sgn;
    int st = b->stride;
    int hc = contrib(s[y * st + x - 1], g[y * st + x - 1],
                     s[y * st + x + 1], g[y * st + x + 1]);
    int vc = contrib(s[(y - 1) * st + x], g[(y - 1) * st + x],
                     s[(y + 1) * st + x], g[(y + 1) * st + x]);
    int k = (hc + 1) * 3 + (vc + 1);
    return mq_decode(m, SC_CTX[k]) ^ SC_XOR[k];
}

static void spp(Blk *b, MQ *m, int bit) {
    int st = b->stride;
    for (int y0 = 1; y0 <= b->h; y0 += 4)
        for (int x = 1; x <= b->w; x++)
            for (int y = y0; y < y0 + 4 && y <= b->h; y++) {
                if (b->sig[y * st + x])
                    continue;
                int hn, vn, dn;
                hvd(b, y, x, &hn, &vn, &dn);
                if (hn + vn + dn == 0)
                    continue;
                b->vis[y * st + x] = 1;
                if (hn > 2)
                    hn = 2;
                if (vn > 2)
                    vn = 2;
                if (dn > 4)
                    dn = 4;
                if (mq_decode(m, ZC[b->orient][hn][vn][dn])) {
                    b->sgn[y * st + x] =
                        (uint8_t)dec_sign(b, m, y, x);
                    b->sig[y * st + x] = 1;
                    b->mag[(y - 1) * b->w + (x - 1)] = bit;
                }
            }
}

static void mrp(Blk *b, MQ *m, int bit) {
    int st = b->stride;
    for (int y0 = 1; y0 <= b->h; y0 += 4)
        for (int x = 1; x <= b->w; x++)
            for (int y = y0; y < y0 + 4 && y <= b->h; y++) {
                if (!b->sig[y * st + x] || b->vis[y * st + x])
                    continue;
                int ctx;
                if (b->ref[y * st + x]) {
                    ctx = 16;
                } else {
                    int hn, vn, dn;
                    hvd(b, y, x, &hn, &vn, &dn);
                    ctx = (hn + vn + dn) ? 15 : 14;
                    b->ref[y * st + x] = 1;
                }
                if (mq_decode(m, ctx))
                    b->mag[(y - 1) * b->w + (x - 1)] |= bit;
                b->vis[y * st + x] = 1;
            }
}

static void cup(Blk *b, MQ *m, int bit) {
    int st = b->stride;
    for (int y0 = 1; y0 <= b->h; y0 += 4) {
        int full = (y0 + 3 <= b->h);
        for (int x = 1; x <= b->w; x++) {
            int y = y0;
            if (full) {
                int any = 0;
                for (int yy = y0; yy < y0 + 4; yy++)
                    any |= b->vis[yy * st + x] | b->sig[yy * st + x];
                if (!any) {
                    int clean = 1;
                    for (int yy = y0; yy < y0 + 4 && clean; yy++) {
                        int hn, vn, dn;
                        hvd(b, yy, x, &hn, &vn, &dn);
                        if (hn + vn + dn)
                            clean = 0;
                    }
                    if (clean) {
                        if (!mq_decode(m, CTX_RL))
                            continue;
                        int r = (mq_decode(m, CTX_UNI) << 1)
                            | mq_decode(m, CTX_UNI);
                        y = y0 + r;
                        b->sgn[y * st + x] =
                            (uint8_t)dec_sign(b, m, y, x);
                        b->sig[y * st + x] = 1;
                        b->mag[(y - 1) * b->w + (x - 1)] = bit;
                        y++;
                    }
                }
            }
            for (; y < y0 + 4 && y <= b->h; y++) {
                if (!b->sig[y * st + x] && !b->vis[y * st + x]) {
                    if (mq_decode(m, zc_ctx(b, y, x))) {
                        b->sgn[y * st + x] =
                            (uint8_t)dec_sign(b, m, y, x);
                        b->sig[y * st + x] = 1;
                        b->mag[(y - 1) * b->w + (x - 1)] = bit;
                    }
                }
            }
        }
    }
}

FFPIC_API int ffpic_jp2_block(const uint8_t *data, long len,
                              int n_passes, int mb, int zbp,
                              int w, int h, int orient,
                              int32_t *out /* (h, w), signed */) {
    if (n_passes <= 0 || len <= 0) {
        memset(out, 0, sizeof(int32_t) * (size_t)w * h);
        return 0;
    }
    Blk b;
    b.w = w;
    b.h = h;
    b.orient = orient;
    b.stride = w + 2;
    size_t pad = (size_t)(h + 2) * (w + 2);
    uint8_t *mem = calloc(pad * 4, 1);
    if (!mem)
        return -1;
    b.sig = mem;
    b.sgn = mem + pad;
    b.vis = mem + 2 * pad;
    b.ref = mem + 3 * pad;
    b.mag = out;
    memset(out, 0, sizeof(int32_t) * (size_t)w * h);

    MQ m;
    mq_init(&m, data, len);
    if (mb > 31)
        mb = 31;                       /* corrupt QCD exponents */
    int plane = mb - 1 - zbp;
    int kind = 2;                      /* first plane: cleanup */
    for (int p = 0; p < n_passes && plane >= 0; p++) {
        int bit = 1 << plane;
        if (kind == 0)
            spp(&b, &m, bit);
        else if (kind == 1)
            mrp(&b, &m, bit);
        else {
            cup(&b, &m, bit);
            memset(b.vis, 0, pad);
            plane--;
        }
        kind = (kind + 1) % 3;
    }
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            if (b.sgn[(y + 1) * b.stride + (x + 1)])
                out[y * w + x] = -out[y * w + x];
    free(mem);
    return 0;
}
