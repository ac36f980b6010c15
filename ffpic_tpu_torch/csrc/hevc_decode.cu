// HEVC (HEIF) decode kernels for Hopper (sm_90a): the device stages of
// ffpic_tpu_torch.formats.hevc and formats.heif.
//
//   K14 hevc_residuals    every TU of a picture, or of a grid's tiles, in
//                         the native flat layout (int16 levels packed per
//                         TU, described by the host's plan) -> int16
//                         residuals in the same layout: 8.6.3 dequant,
//                         then the 2-D inverse DCT (4 to 32 points) or the
//                         4-point DST, or the transform-skip scaling, or
//                         the bypass copy
//   K15 hevc_yuv_to_rgba  every tile of a picture (int16 Y and 4:2:0 U, V
//                         planes, or Y alone, 4:0:0) -> the RGBA uint8
//                         canvas, each pixel written once: nearest 2x
//                         chroma, crop, colour as K3/K4, the paste
//
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError(). K14 is
// integer and bit-exact with the JAX reference; K15's float colour is
// color.cuh's, the FMA form K3 and K4 use.

#include <cstdint>
#include <cuda_runtime.h>

#include "color.cuh"

namespace {

// levelScale[qP % 6] of 8.6.3
__constant__ int kLevelScale[6] = {40, 45, 51, 57, 64, 72};

__device__ __forceinline__ int clip16(long long v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : (int)v);
}

// transMatrix of 8.6.4.2, row k (frequency), column i (sample) of the
// 32-point DCT; the N-point matrix is rows k * 32 / N, columns 0..N-1.
// Every entry is +-a[u] for the angle u = (2i + 1) k mod 128 (in pi / 64)
// folded into 0..32, as the cosines it rounds. Called with constants
// only (every loop below is unrolled), so each entry is an immediate.
__host__ __device__ constexpr int trans_coef(int k, int i) {
  const int a[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80,
                     78, 75, 73, 70, 67, 64, 61, 57, 54, 50, 46,
                     43, 38, 36, 31, 25, 22, 18, 13, 9,  4,  0};
  int u = ((2 * i + 1) * k) & 127;
  if (u > 64) u = 128 - u;
  return u > 32 ? -a[64 - u] : a[u];
}

// out[i] = sum_k T_N[k][i] c[k * S], i < N: the N-point inverse DCT as
// the even/odd butterfly of HM's partialButterflyInverse. The even
// coefficients are the N/2-point transform (T_N[2k][i] = T_{N/2}[k][i]),
// the odd ones are antisymmetric (T_N[k][N-1-i] = -T_N[k][i] for odd k),
// so out[i] = E[i] + O[i] and out[N-1-i] = E[i] - O[i]: (N/2)^2
// multiply-adds at each level, 342 for N = 32 against 1,024. Sums are
// int32 and exact (at most 32768 * 90 * 32 < 2^31), so any order of
// summation gives the direct product's bits.
template <int N, int S>
__device__ __forceinline__ void inv_dct(const int* c, int* out) {
  if constexpr (N == 1) {
    out[0] = 64 * c[0];
  } else {
    int e[N / 2];
    inv_dct<N / 2, 2 * S>(c, e);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      int o = 0;
#pragma unroll
      for (int k = 1; k < N; k += 2) o += trans_coef(k * (32 / N), i) * c[k * S];
      out[i] = e[i] + o;
      out[N - 1 - i] = e[i] - o;
    }
  }
}

// the 4-point DST-VII of 4x4 intra luma (8.6.4.2, eq. 8-303), direct:
// out[i] = sum_k D[k][i] c[k]
__device__ __forceinline__ void inv_dst(const int* c, int* out) {
  constexpr int D[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74},
                           {84, -29, -74, 55}, {55, -84, 74, -29}};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = D[0][i] * c[0] + D[1][i] * c[1] + D[2][i] * c[2] + D[3][i] * c[3];
}

// K14. Replaces ffpic_tpu/ops/hevc_kernels.py:dequant_itransform_batch
// (:80, with _dequant_dev :65 and _exact_matmul_i16 :46) and
// dequant_skip_batch (:104), as their callers residuals_packed (:143) and
// residuals_for_ops (:113) run them: one launch per (n, dst, skip) bucket
// there; one launch for all TUs of a picture, or of every tile of a HEIF
// grid, here. The TPU needed a hi/lo f32 split because its matrix unit
// has no integer path; here the sums are int32.
// Bound: it reads 2 bytes a level and writes 2 a residual, with 8 bytes
// a TU of descriptor (73 MB for the 12 MP fixture's 48 tiles); the
// butterflies' int32 work (about 0.5 G operations there) takes less time
// at the card's int32 rate, so it is bound by bytes.
//
// The host orders the TUs largest first and cuts them into CTAs of 128
// threads of one TU size (desc rows: level offset, QP | skip << 8 |
// bypass << 9 | dst << 10; ctas rows: first desc row, TU count, log2 n,
// 0), so the long 32x32 CTAs start first and the 4x4 ones fill the tail.
// A TU takes n neighbouring lanes of one warp (a warp holds 32 / n TUs),
// so a TU's steps need only __syncwarp, never a CTA barrier:
//   1. its lanes copy its n^2 levels (32-byte aligned) into the warp's
//      shared memory with 16-byte loads;
//   2. lane x takes column x: dequant (level * scale + 2^(bs-1)) >> bs in
//      int64, bs = bd + log2 n - 5, clipped to int16 (equal to the
//      reference's pre-clipped int32), then the column transform in
//      registers, clip((e + 64) >> 7), into the transpose buffer
//      e[y][x] (rows padded to n + 1 words: no bank conflict either
//      way); skip and bypass TUs store the dequantised values or the
//      levels as they are;
//   3. lane y takes row y from the buffer: the row transform,
//      clip((r + 2^(19-bd)) >> (20-bd)); skip TUs take
//      clip((d * 128 + 2^(19-bd)) >> (20-bd)), bypass TUs the levels;
//      the row goes out as one 8- or 16-byte store per 4 or 8 values.
// The coefficients are immediates (trans_coef), so no multiply-add
// loads a matrix entry. >> of a negative int is arithmetic, as the
// reference's floor shift. QPs are 0..87 (the route checks), where C's
// / and % on them are the reference's floor // and %.
constexpr int kResThreads = 128;
constexpr int kResMaxLv = 4 * (32 * 32 + 2 * 32);   // int16, 32x32 CTAs
constexpr int kResMaxE = 4 * 32 * 33;                // int32, 32x32 CTAs

template <int L2>
__device__ __forceinline__ void residual_tus(
    const int2* __restrict__ desc, int first, int cnt,
    const int16_t* __restrict__ levels, int16_t* __restrict__ out, int bd,
    int16_t* s_lv, int* s_e) {
  constexpr int N = 1 << L2, PER_WARP = 32 / N;
  // a TU's levels at a stride of n^2 + 2n int16 (16-byte multiples that
  // spread the TUs of a warp over the banks), its transpose at n (n + 1)
  constexpr int LV = N * N + 2 * N, E = N * (N + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp * PER_WARP >= cnt) return;          // the whole warp idles
  const int slot = warp * PER_WARP + lane / N;  // this lane's TU in the CTA
  const int x = lane % N;                       // its column, then its row
  const bool live = slot < cnt;
  const int2 dsc = live ? __ldg(desc + first + slot) : make_int2(0, 0);
  const int off = dsc.x, qp = dsc.y & 255;
  const bool skip = (dsc.y >> 8) & 1, bypass = (dsc.y >> 9) & 1,
             dst = (dsc.y >> 10) & 1;
  int16_t* lv = s_lv + slot * LV;
  int* e = s_e + slot * E;
  if (live) {
    const uint4* src = reinterpret_cast<const uint4*>(levels + off);
#pragma unroll
    for (int i = x; i < N * N / 8; i += N)
      reinterpret_cast<uint4*>(lv)[i] = __ldg(src + i);
  }
  __syncwarp();
  if (live) {
    const int bs = bd + L2 - 5;
    const long long scale = (long long)(16 * kLevelScale[qp % 6]) << (qp / 6);
    int d[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int l = lv[j * N + x];
      d[j] = bypass ? l : clip16(((long long)l * scale + (1LL << (bs - 1))) >> bs);
    }
    if (skip || bypass) {
#pragma unroll
      for (int j = 0; j < N; ++j) e[j * (N + 1) + x] = d[j];
    } else {
      int r[N];
      if constexpr (N == 4) {
        if (dst) inv_dst(d, r);
        else inv_dct<4, 1>(d, r);
      } else {
        inv_dct<N, 1>(d, r);
      }
#pragma unroll
      for (int y = 0; y < N; ++y) e[y * (N + 1) + x] = clip16((r[y] + 64) >> 7);
    }
  }
  __syncwarp();
  if (!live) return;
  int g[N], r[N];
#pragma unroll
  for (int j = 0; j < N; ++j) g[j] = e[x * (N + 1) + j];
  const int shift2 = 20 - bd, rnd2 = 1 << (shift2 - 1);
  if (bypass) {
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = g[j];
  } else if (skip) {
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = clip16((g[j] * 128 + rnd2) >> shift2);
  } else {
    int t[N];
    if constexpr (N == 4) {
      if (dst) inv_dst(g, t);
      else inv_dct<4, 1>(g, t);
    } else {
      inv_dct<N, 1>(g, t);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = clip16((t[j] + rnd2) >> shift2);
  }
  uint32_t wds[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j)
    wds[j] = ((uint32_t)r[2 * j] & 0xffffu) | ((uint32_t)r[2 * j + 1] << 16);
  int16_t* dst_row = out + off + x * N;
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(dst_row) = make_uint2(wds[0], wds[1]);
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      reinterpret_cast<uint4*>(dst_row)[j] =
          make_uint4(wds[4 * j], wds[4 * j + 1], wds[4 * j + 2], wds[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kResThreads)
    hevc_residuals_kernel(const int2* __restrict__ desc,
                          const int4* __restrict__ ctas,
                          const int16_t* __restrict__ levels,
                          int16_t* __restrict__ out, int bd) {
  __shared__ __align__(16) int16_t s_lv[kResMaxLv];
  __shared__ int s_e[kResMaxE];
  const int4 c = __ldg(ctas + blockIdx.x);
  switch (c.z) {
    case 5:
      residual_tus<5>(desc, c.x, c.y, levels, out, bd, s_lv, s_e);
      break;
    case 4:
      residual_tus<4>(desc, c.x, c.y, levels, out, bd, s_lv, s_e);
      break;
    case 3:
      residual_tus<3>(desc, c.x, c.y, levels, out, bd, s_lv, s_e);
      break;
    default:
      residual_tus<2>(desc, c.x, c.y, levels, out, bd, s_lv, s_e);
      break;
  }
}

// K15. Replaces the device branch of ffpic_tpu/formats/heif.py:
// _yuv_pic_to_rgba (:356-371): jnp.repeat of U and V by 2 on both axes,
// the crop, and ffpic_tpu/ops/jpeg_kernels.py:color_convert (:144); and
// the canvas of a grid with the paste of each tile into it
// (heif.py:_decode_grid, :459-487), which the reference does on the host
// after reading each tile back.
// Bound: it reads 2 bytes of luma and 1 of chroma a pixel and writes 4:
// 7 bytes a pixel, 85.3 MB for the 12 MP grid; the float colour's 13
// operations a pixel are nothing beside that, so it is bound by bytes.
//
// One launch a picture writes every canvas pixel once: a pixel that a
// tile covers gets that tile's colour (the last tile in paste order where
// tiles overlap), a pixel that none covers (0, 0, 0, 255); so the canvas
// needs no fill before it. The host (ops.hevc_kernels.stage_tiles) cuts
// the canvas at every tile edge into cells: row_cell[y] and col_cell[x]
// name a pixel's cell, cell_map[r * cells_x + c] the tile that covers it
// last (-1 for none), and desc[t] the tile's planes (TileDesc). A grid of
// one tile size has a cell a tile; a single item is one tile.
//
// A thread takes four pixels of a row, a CTA 4 rows of 64 threads. Where
// the four lie in one cell, at an even column of the tile, with the
// planes' rows aligned, it loads 8 bytes of luma and 4 of each chroma
// plane and stores 16 bytes of RGBA; else (a tile or canvas edge that
// is not a multiple of 4) it takes the pixels one by one. Chroma is the
// nearest sample (y >> 1, x >> 1) of the planes as staged, 128 for 4:0:0;
// the colour is color.cuh's pixel(), alpha 255.
constexpr int kColGroups = 64, kColRows = 4;
constexpr uint32_t kUncovered = 0xFF000000u;   // (0, 0, 0, 255)

// A tile's planes as ops.hevc_kernels.stage_tiles lays out its 8 int32:
// the offsets of Y, U and V in the staged planes (int16 elements, U = V
// = -1 for 4:0:0), the luma and chroma row pitches, and its place.
struct TileDesc {
  const int16_t* y;
  const int16_t* u;
  const int16_t* v;
  int ys, cs, y0, x0;
};

__device__ __forceinline__ TileDesc tile_desc(const int16_t* planes,
                                              const int4* desc, int t) {
  const int4 a = __ldg(desc + 2 * t), b = __ldg(desc + 2 * t + 1);
  TileDesc d;
  d.y = planes + a.x;
  d.u = a.y < 0 ? nullptr : planes + a.y;
  d.v = a.z < 0 ? nullptr : planes + a.z;
  d.ys = a.w;
  d.cs = b.x;
  d.y0 = b.y;
  d.x0 = b.z;
  return d;
}

template <int kMode>
__device__ __forceinline__ uint32_t one_pixel(const int16_t* planes,
                                              const int4* desc,
                                              const int* cell_map, int rc,
                                              const int* col_cell, int y,
                                              int x) {
  const int t = __ldg(cell_map + rc + __ldg(col_cell + x));
  if (t < 0) return kUncovered;
  const TileDesc d = tile_desc(planes, desc, t);
  const int yl = y - d.y0, xl = x - d.x0;
  const int yv = __ldg(d.y + (long long)yl * d.ys + xl);
  int u = 128, v = 128;
  if (d.u) {
    const long long o = (long long)(yl >> 1) * d.cs + (xl >> 1);
    u = __ldg(d.u + o);
    v = __ldg(d.v + o);
  }
  return pixel<kMode, 0>(yv, u, v);
}

template <int kMode>
__global__ void __launch_bounds__(kColGroups * kColRows)
    hevc_yuv_to_rgba_kernel(const int16_t* __restrict__ planes,
                            const int4* __restrict__ desc,
                            const int* __restrict__ row_cell,
                            const int* __restrict__ col_cell,
                            const int* __restrict__ cell_map, int cells_x,
                            uint32_t* __restrict__ out, int H, int W) {
  const int y = blockIdx.y * kColRows + threadIdx.y;
  const int x = (blockIdx.x * kColGroups + threadIdx.x) * 4;
  if (y >= H || x >= W) return;
  const int rc = __ldg(row_cell + y) * cells_x;
  uint32_t* o = out + (long long)y * W + x;
  if (x + 4 <= W) {
    const int c = __ldg(col_cell + x);
    if (c == __ldg(col_cell + x + 3)) {
      const int t = __ldg(cell_map + rc + c);
      uint4 px = make_uint4(kUncovered, kUncovered, kUncovered, kUncovered);
      bool whole = t < 0;
      if (!whole) {
        const TileDesc d = tile_desc(planes, desc, t);
        const int yl = y - d.y0, xl = x - d.x0;
        const int16_t* py = d.y + (long long)yl * d.ys + xl;
        const long long co = (long long)(yl >> 1) * d.cs + (xl >> 1);
        whole = (xl & 1) == 0 && ((uintptr_t)py & 7) == 0 &&
                (!d.u || (((uintptr_t)(d.u + co) & 3) == 0 &&
                          ((uintptr_t)(d.v + co) & 3) == 0));
        if (whole) {
          const uint2 yy = __ldg(reinterpret_cast<const uint2*>(py));
          uint32_t uu = 0x00800080u, vv = 0x00800080u;
          if (d.u) {
            uu = __ldg(reinterpret_cast<const uint32_t*>(d.u + co));
            vv = __ldg(reinterpret_cast<const uint32_t*>(d.v + co));
          }
          px = make_uint4(pixel<kMode, 0>(lo16(yy.x), lo16(uu), lo16(vv)),
                          pixel<kMode, 0>(hi16(yy.x), lo16(uu), lo16(vv)),
                          pixel<kMode, 0>(lo16(yy.y), hi16(uu), hi16(vv)),
                          pixel<kMode, 0>(hi16(yy.y), hi16(uu), hi16(vv)));
        }
      }
      if (whole) {
        if (((uintptr_t)o & 15) == 0) {
          *reinterpret_cast<uint4*>(o) = px;
        } else {
          o[0] = px.x;
          o[1] = px.y;
          o[2] = px.z;
          o[3] = px.w;
        }
        return;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (x + k < W)
      o[k] = one_pixel<kMode>(planes, desc, cell_map, rc, col_cell, y, x + k);
}

}  // namespace

extern "C" {

// desc: m x 2 int32 and ctas: k x 4 int32 (hevc_kernels.plan_residuals),
// both 16-byte aligned; each ctas row (first desc row, TU count <= 128 >>
// log2 n, log2 n in 2..5, 0); levels, out: int16 at the desc offsets
// (multiples of 16), 16-byte aligned; bd 8..14
int ffpic_hevc_residuals(const void* desc, const void* ctas,
                         const void* levels, void* out, int k, int bd,
                         void* stream) {
  if (k <= 0 || bd < 8 || bd > 14 || ((uintptr_t)desc & 15) ||
      ((uintptr_t)ctas & 15) || ((uintptr_t)levels & 15) ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  hevc_residuals_kernel<<<k, kResThreads, 0, (cudaStream_t)stream>>>(
      (const int2*)desc, (const int4*)ctas, (const int16_t*)levels,
      (int16_t*)out, bd);
  return (int)cudaGetLastError();
}

// planes: the staged int16 planes; desc: 8 int32 a tile (TileDesc),
// 16-byte aligned; row_cell: H int32, col_cell: W int32, cell_map:
// cells_x int32 a row of cells (every entry -1 or a tile of desc); out:
// H x W pixels of 4 bytes, 16-byte aligned, every one written; mode 0
// reference, 1 bt601, 2 rgb
int ffpic_hevc_yuv_to_rgba(const void* planes, const void* desc,
                           const void* row_cell, const void* col_cell,
                           const void* cell_map, int cells_x, void* out,
                           int H, int W, int mode, void* stream) {
  if (H <= 0 || W <= 0 || cells_x <= 0 || ((uintptr_t)out & 15) ||
      ((uintptr_t)desc & 15) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kColGroups, kColRows);
  const dim3 grid((W + 4 * kColGroups - 1) / (4 * kColGroups),
                  (H + kColRows - 1) / kColRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int16_t* p = (const int16_t*)planes;
  const int4* d = (const int4*)desc;
  const int *rc = (const int*)row_cell, *cc = (const int*)col_cell,
            *cm = (const int*)cell_map;
  uint32_t* o = (uint32_t*)out;
  if (mode == 0)
    hevc_yuv_to_rgba_kernel<0><<<grid, block, 0, s>>>(p, d, rc, cc, cm,
                                                      cells_x, o, H, W);
  else if (mode == 1)
    hevc_yuv_to_rgba_kernel<1><<<grid, block, 0, s>>>(p, d, rc, cc, cm,
                                                      cells_x, o, H, W);
  else
    hevc_yuv_to_rgba_kernel<2><<<grid, block, 0, s>>>(p, d, rc, cc, cm,
                                                      cells_x, o, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
