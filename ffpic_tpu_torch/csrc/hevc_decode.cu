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
//   K15 hevc_yuv_to_rgba  int16 Y and 4:2:0 U, V planes (or Y alone, 4:0:0)
//                         -> RGBA uint8 written at an offset of a canvas:
//                         nearest 2x chroma, crop, colour as K3/K4
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
// the paste of each grid tile into the canvas (heif.py:_decode_grid,
// :459-487), which the reference does on the host after reading each
// tile back.
// Bound: it reads 2 bytes of luma and 1 of chroma a pixel and writes 4:
// 7 bytes a pixel, 84.7 MB for the 12 MP grid; the float colour's 10
// operations a pixel are nothing beside that, so it is bound by bytes.
//
// A thread per output pixel, 32 x 8 a CTA, neighbouring threads on
// neighbouring pixels of a row: a warp reads 64 bytes of Y and 32 of U
// and of V (pairs of threads share a chroma sample) and writes 128 of
// RGBA. Chroma is the nearest sample (y >> 1, x >> 1) of the planes as
// staged, 128 for 4:0:0; the colour is color.cuh's pixel(), alpha 255.
constexpr int kColX = 32, kColY = 8;

template <int kMode>
__global__ void __launch_bounds__(kColX * kColY)
    hevc_yuv_to_rgba_kernel(const int16_t* __restrict__ Y, long long ys,
                            const int16_t* __restrict__ U, long long us,
                            const int16_t* __restrict__ V, long long vs,
                            uint32_t* __restrict__ out, long long os, int h,
                            int w) {
  const int x = blockIdx.x * kColX + threadIdx.x;
  const int y = blockIdx.y * kColY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int yv = __ldg(Y + y * ys + x);
  int u = 128, v = 128;
  if (U) {
    u = __ldg(U + (y >> 1) * us + (x >> 1));
    v = __ldg(V + (y >> 1) * vs + (x >> 1));
  }
  out[y * os + x] = pixel<kMode, 0>(yv, u, v);
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

// Y: h rows of at least w int16 at pitch ys (elements); U, V: (h + 1) / 2
// rows of at least (w + 1) / 2 at pitches us, vs, or both null (4:0:0);
// out: h rows of w pixels (4 bytes each, 4-byte aligned) at pitch os
// pixels; mode 0 reference, 1 bt601, 2 rgb
int ffpic_hevc_yuv_to_rgba(const void* Y, long long ys, const void* U,
                           long long us, const void* V, long long vs,
                           void* out, long long os, int h, int w, int mode,
                           void* stream) {
  if (h <= 0 || w <= 0 || ((uintptr_t)out & 3) || mode < 0 || mode > 2 ||
      (U == nullptr) != (V == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kColX, kColY);
  const dim3 grid((w + kColX - 1) / kColX, (h + kColY - 1) / kColY);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int16_t *y = (const int16_t*)Y, *u = (const int16_t*)U,
                *v = (const int16_t*)V;
  uint32_t* o = (uint32_t*)out;
  if (mode == 0)
    hevc_yuv_to_rgba_kernel<0><<<grid, block, 0, s>>>(y, ys, u, us, v, vs, o,
                                                      os, h, w);
  else if (mode == 1)
    hevc_yuv_to_rgba_kernel<1><<<grid, block, 0, s>>>(y, ys, u, us, v, vs, o,
                                                      os, h, w);
  else
    hevc_yuv_to_rgba_kernel<2><<<grid, block, 0, s>>>(y, ys, u, us, v, vs, o,
                                                      os, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
