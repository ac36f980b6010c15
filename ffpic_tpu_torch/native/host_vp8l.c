/* Copied from ffpic_tpu/native/host_vp8l.c: the host VP8L entropy
 * decoder of ffpic_tpu_torch, built beside host_jpeg.c by
 * ffpic_tpu_torch/native/__init__.py. */

/* host_vp8l.c — native VP8L (lossless WebP) entropy decoder.
 *
 * Port of formats/vp8l.py _decode_entropy_image (the Python oracle,
 * pixel-exact vs libwebp): canonical LSB-first prefix codes, simple
 * and code-length-coded trees, meta-huffman groups, color cache and
 * LZ77 backward copies.  The reference's VP8L is an empty stub
 * (format/webp.c:1928-1999), so this whole path is beyond parity; the
 * C port exists because the per-pixel Python loop was the last
 * Python-hot format stage.
 *
 * Spec tables (CLCL order, distance map) are passed in from Python to
 * keep one source of truth.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define FFPIC_API __attribute__((visibility("default")))

typedef struct {
    const uint8_t *data;
    long n;
    long pos;
    int bit;
} LsbR;

static inline uint32_t lsb_read(LsbR *r, int nbits) {
    uint32_t v = 0;
    int got = 0;
    while (got < nbits) {
        int byte = r->pos < r->n ? r->data[r->pos] : 0;
        int take = 8 - r->bit;
        if (take > nbits - got)
            take = nbits - got;
        v |= (uint32_t)((byte >> r->bit) & ((1 << take) - 1)) << got;
        got += take;
        r->bit += take;
        if (r->bit == 8) {
            r->bit = 0;
            r->pos++;
        }
    }
    return v;
}

#define MAXLEN 15

typedef struct {
    int maxlen;          /* 0 = single-symbol code */
    int single;
    int32_t *sym;        /* [1 << maxlen] */
    uint8_t *len;
} Tree;

static void tree_free(Tree *t) {
    free(t->sym);
    free(t->len);
    t->sym = NULL;
    t->len = NULL;
}

static int tree_build(Tree *t, const uint8_t *lengths, int nsym) {
    t->sym = NULL;
    t->len = NULL;
    int maxlen = 0, nz = 0, last = -1;
    int counts[MAXLEN + 1];
    memset(counts, 0, sizeof(counts));
    for (int i = 0; i < nsym; i++) {
        if (lengths[i]) {
            nz++;
            last = i;
            if (lengths[i] > maxlen)
                maxlen = lengths[i];
            if (lengths[i] <= MAXLEN)
                counts[lengths[i]]++;
        }
    }
    if (nz == 0 || maxlen > MAXLEN)
        return -1;
    if (nz == 1) {
        t->single = last;
        t->maxlen = 0;
        return 0;
    }
    t->single = -1;
    t->maxlen = maxlen;
    long lut = 1L << maxlen;
    t->sym = malloc(lut * sizeof(int32_t));
    t->len = calloc(lut, 1);
    if (!t->sym || !t->len)
        return -1;
    for (long i = 0; i < lut; i++)
        t->sym[i] = -1;
    int next_code[MAXLEN + 1];
    int code = 0;
    next_code[0] = 0;
    for (int l = 1; l <= maxlen; l++) {
        code = (code + counts[l - 1]) << 1;
        next_code[l] = code;
    }
    for (int s = 0; s < nsym; s++) {
        int l = lengths[s];
        if (!l)
            continue;
        int c = next_code[l]++;
        if (c >= (1 << l))
            return -1;            /* over-subscribed code */
        /* reverse l bits for LSB-first matching */
        int rev = 0;
        for (int b = 0; b < l; b++)
            rev |= ((c >> b) & 1) << (l - 1 - b);
        for (long w = rev; w < lut; w += 1L << l) {
            t->sym[w] = s;
            t->len[w] = (uint8_t)l;
        }
    }
    return 0;
}

static inline int tree_decode(Tree *t, LsbR *r) {
    if (t->single >= 0)
        return t->single;
    long save_pos = r->pos;
    int save_bit = r->bit;
    uint32_t window = lsb_read(r, t->maxlen);
    int s = t->sym[window];
    if (s < 0)
        return -1;
    long total = save_pos * 8 + save_bit + t->len[window];
    r->pos = total >> 3;
    r->bit = (int)(total & 7);
    return s;
}

static int read_code_lengths(LsbR *r, int nsym, Tree *t,
                             const uint8_t *clcl_order) {
    if (lsb_read(r, 1)) {        /* simple */
        int n = lsb_read(r, 1) + 1;
        int first8 = lsb_read(r, 1);
        int s0 = lsb_read(r, first8 ? 8 : 1);
        if (n == 1) {
            t->single = s0;
            t->maxlen = 0;
            t->sym = NULL;
            t->len = NULL;
            return 0;
        }
        int s1 = lsb_read(r, 8);
        t->single = -1;
        t->maxlen = 1;
        t->sym = malloc(2 * sizeof(int32_t));
        t->len = malloc(2);
        if (!t->sym || !t->len)
            return -1;
        t->sym[0] = s0;
        t->sym[1] = s1;
        t->len[0] = t->len[1] = 1;
        return 0;
    }
    int num_clcl = lsb_read(r, 4) + 4;
    uint8_t cl_lengths[19];
    memset(cl_lengths, 0, 19);
    for (int i = 0; i < num_clcl; i++)
        cl_lengths[clcl_order[i]] = (uint8_t)lsb_read(r, 3);
    Tree cl;
    if (tree_build(&cl, cl_lengths, 19) != 0)
        return -1;
    long max_symbol;
    if (lsb_read(r, 1)) {
        int nbits = 2 + 2 * lsb_read(r, 3);
        max_symbol = 2 + lsb_read(r, nbits);
    } else {
        max_symbol = nsym;
    }
    uint8_t *lengths = calloc(nsym, 1);
    if (!lengths) {
        tree_free(&cl);
        return -1;
    }
    int prev_len = 8;
    long i = 0;
    while (i < nsym) {
        if (max_symbol <= 0)
            break;
        max_symbol--;
        int s = tree_decode(&cl, r);
        if (s < 0) {
            tree_free(&cl);
            free(lengths);
            return -1;
        }
        if (s < 16) {
            lengths[i++] = (uint8_t)s;
            if (s)
                prev_len = s;
        } else if (s == 16) {
            int rep = 3 + lsb_read(r, 2);
            for (int k = 0; k < rep && i < nsym; k++)
                lengths[i++] = (uint8_t)prev_len;
        } else if (s == 17) {
            i += 3 + lsb_read(r, 3);
        } else {
            i += 11 + lsb_read(r, 7);
        }
    }
    tree_free(&cl);
    int rc = tree_build(t, lengths, nsym);
    free(lengths);
    return rc;
}

static inline int lz77_val(LsbR *r, int code) {
    if (code < 4)
        return code + 1;
    int extra = (code - 2) >> 1;
    int offset = (2 + (code & 1)) << extra;
    return offset + lsb_read(r, extra) + 1;
}

typedef struct {
    Tree green, red, blue, alpha, dist;
} Group;

static void group_free(Group *g) {
    tree_free(&g->green);
    tree_free(&g->red);
    tree_free(&g->blue);
    tree_free(&g->alpha);
    tree_free(&g->dist);
}

static int entropy_image(LsbR *r, int w, int h, int allow_meta,
                         const uint8_t *clcl, const int16_t *dist_map,
                         uint8_t *out /* h*w*4 ARGB */);

FFPIC_API int ffpic_vp8l_entropy(
    const uint8_t *data, long n, long *pos_io, int *bit_io,
    int w, int h, int allow_meta,
    const uint8_t *clcl_order, const int16_t *dist_map,
    uint8_t *out) {
    LsbR r = {data, n, *pos_io, *bit_io};
    int rc = entropy_image(&r, w, h, allow_meta, clcl_order, dist_map,
                           out);
    *pos_io = r.pos;
    *bit_io = r.bit;
    return rc;
}

static int entropy_image(LsbR *r, int w, int h, int allow_meta,
                         const uint8_t *clcl, const int16_t *dist_map,
                         uint8_t *out) {
    int cache_bits = 0;
    if (lsb_read(r, 1))
        cache_bits = lsb_read(r, 4);
    if (cache_bits > 11)
        return -1;
    uint8_t (*cache)[4] = NULL;
    if (cache_bits) {
        cache = calloc((size_t)1 << cache_bits, 4);
        if (!cache)
            return -1;
    }
    int cache_shift = 32 - cache_bits;

    int32_t *meta = NULL;
    int meta_bits = 0;
    long n_groups = 1;
    int mw = 0;
    if (allow_meta && lsb_read(r, 1)) {
        meta_bits = lsb_read(r, 3) + 2;
        mw = (w + (1 << meta_bits) - 1) >> meta_bits;
        int mh = (h + (1 << meta_bits) - 1) >> meta_bits;
        uint8_t *mimg = malloc((size_t)mw * mh * 4);
        if (!mimg) {
            free(cache);
            return -1;
        }
        int rc = entropy_image(r, mw, mh, 0, clcl, dist_map, mimg);
        if (rc != 0) {
            free(mimg);
            free(cache);
            return rc;
        }
        meta = malloc((size_t)mw * mh * sizeof(int32_t));
        if (!meta) {
            free(mimg);
            free(cache);
            return -1;
        }
        n_groups = 0;
        for (long i = 0; i < (long)mw * mh; i++) {
            meta[i] = ((int32_t)mimg[i * 4 + 1] << 8) | mimg[i * 4 + 2];
            if (meta[i] + 1 > n_groups)
                n_groups = meta[i] + 1;
        }
        free(mimg);
    }

    int green_syms = 256 + 24 + (cache_bits ? (1 << cache_bits) : 0);
    Group *groups = calloc(n_groups, sizeof(Group));
    if (!groups) {
        free(meta);
        free(cache);
        return -1;
    }
    int rc = 0;
    for (long g = 0; g < n_groups && rc == 0; g++) {
        if (read_code_lengths(r, green_syms, &groups[g].green, clcl)
            || read_code_lengths(r, 256, &groups[g].red, clcl)
            || read_code_lengths(r, 256, &groups[g].blue, clcl)
            || read_code_lengths(r, 256, &groups[g].alpha, clcl)
            || read_code_lengths(r, 40, &groups[g].dist, clcl))
            rc = -2;
    }

    long total = (long)w * h;
    long pos = 0;
    while (rc == 0 && pos < total) {
        Group *g = groups;
        if (meta) {
            long x = pos % w, y = pos / w;
            g = &groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]];
        }
        int code = tree_decode(&g->green, r);
        if (code < 0 || code >= green_syms) {
            rc = -3;
            break;
        }
        uint8_t *px = out + pos * 4;
        if (code < 256) {
            int red = tree_decode(&g->red, r);
            int blue = tree_decode(&g->blue, r);
            int alpha = tree_decode(&g->alpha, r);
            if ((red | blue | alpha) < 0) {
                rc = -3;
                break;
            }
            px[0] = (uint8_t)alpha;
            px[1] = (uint8_t)red;
            px[2] = (uint8_t)code;
            px[3] = (uint8_t)blue;
            if (cache) {
                uint32_t argb = ((uint32_t)px[0] << 24)
                    | ((uint32_t)px[1] << 16) | ((uint32_t)px[2] << 8)
                    | px[3];
                uint32_t key = (uint32_t)(0x1E35A7BDu * argb)
                    >> cache_shift;
                cache[key][0] = px[0];
                cache[key][1] = px[1];
                cache[key][2] = px[2];
                cache[key][3] = px[3];
            }
            pos++;
        } else if (code < 256 + 24) {
            int length = lz77_val(r, code - 256);
            int dcode = tree_decode(&g->dist, r);
            if (dcode < 0 || dcode >= 40) {
                rc = -3;
                break;
            }
            int dist_code = lz77_val(r, dcode);
            long dist;
            if (dist_code > 120) {
                dist = dist_code - 120;
            } else {
                int dx = dist_map[(dist_code - 1) * 2];
                int dy = dist_map[(dist_code - 1) * 2 + 1];
                dist = (long)dy * w + dx;
                if (dist < 1)
                    dist = 1;
            }
            long src = pos - dist;
            if (src < 0) {
                rc = -4;
                break;
            }
            for (int k = 0; k < length && pos < total; k++) {
                uint8_t *dp = out + pos * 4;
                const uint8_t *sp = out + src * 4;
                dp[0] = sp[0];
                dp[1] = sp[1];
                dp[2] = sp[2];
                dp[3] = sp[3];
                if (cache) {
                    uint32_t argb = ((uint32_t)dp[0] << 24)
                        | ((uint32_t)dp[1] << 16)
                        | ((uint32_t)dp[2] << 8) | dp[3];
                    uint32_t key = (uint32_t)(0x1E35A7BDu * argb)
                        >> cache_shift;
                    cache[key][0] = dp[0];
                    cache[key][1] = dp[1];
                    cache[key][2] = dp[2];
                    cache[key][3] = dp[3];
                }
                pos++;
                src++;
            }
        } else {
            if (!cache) {
                rc = -5;
                break;
            }
            const uint8_t *cp = cache[code - 256 - 24];
            px[0] = cp[0];
            px[1] = cp[1];
            px[2] = cp[2];
            px[3] = cp[3];
            pos++;
        }
    }

    for (long g = 0; g < n_groups; g++)
        group_free(&groups[g]);
    free(groups);
    free(meta);
    free(cache);
    return rc;
}
