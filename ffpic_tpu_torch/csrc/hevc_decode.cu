// HEVC (HEIF) decode kernels for Hopper (sm_90a): the device stages of
// ffpic_tpu_torch.formats.hevc and formats.heif.
//
//   K14 hevc_residuals    every TU of a picture in the native flat layout
//                         (tu_meta rows x, y, n, cidx, skip, bypass, qp,
//                         dst; int16 levels packed per TU) -> int16
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

// transMatrix of 8.6.4.2: row k (frequency), column i (sample) of the
// 32-point DCT; the N-point matrix is rows k * 32 / N, columns 0..N-1.
__constant__ int8_t kT32[32 * 32] = {
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
    90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4,
    -4, -13, -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90,
    90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90,
    -90, -87, -80, -70, -57, -43, -25, -9, 9, 25, 43, 57, 70, 80, 87, 90,
    90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13,
    13, 38, 61, 78, 88, 90, 85, 73, 54, 31, 4, -22, -46, -67, -82, -90,
    89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89,
    89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89,
    88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22,
    -22, -61, -85, -90, -73, -38, 4, 46, 78, 90, 82, 54, 13, -31, -67, -88,
    87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87,
    -87, -57, -9, 43, 80, 90, 70, 25, -25, -70, -90, -80, -43, 9, 57, 87,
    85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31,
    31, 78, 90, 61, 4, -54, -88, -82, -38, 22, 73, 90, 67, 13, -46, -85,
    83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83,
    83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83,
    82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38,
    -38, -88, -73, -4, 67, 90, 46, -31, -85, -78, -13, 61, 90, 54, -22, -82,
    80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80,
    -80, -9, 70, 87, 25, -57, -90, -43, 43, 90, 57, -25, -87, -70, 9, 80,
    78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46,
    46, 90, 38, -54, -90, -31, 61, 88, 22, -67, -85, -13, 73, 82, 4, -78,
    75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75,
    75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75,
    73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54,
    -54, -85, 4, 88, 46, -61, -82, 13, 90, 38, -67, -78, 22, 90, 31, -73,
    70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70,
    -70, 43, 87, -9, -90, -25, 80, 57, -57, -80, 25, 90, 9, -87, -43, 70,
    67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61,
    61, 73, -46, -82, 31, 88, -13, -90, -4, 90, 22, -85, -38, 78, 54, -67,
    64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64,
    64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64,
    61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67,
    -67, -54, 78, 38, -85, -22, 90, 4, -90, 13, 88, -31, -82, 46, 73, -61,
    57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57,
    -57, 80, 25, -90, 9, 87, -43, -70, 70, 43, -87, -9, 90, -25, -80, 57,
    54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73,
    73, 31, -90, 22, 78, -67, -38, 90, -13, -82, 61, 46, -88, 4, 85, -54,
    50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50,
    50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50,
    46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78,
    -78, -4, 82, -73, -13, 85, -67, -22, 88, -61, -31, 90, -54, -38, 90, -46,
    43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43,
    -43, 90, -57, -25, 87, -70, -9, 80, -80, 9, 70, -87, 25, 57, -90, 43,
    38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82,
    82, -22, -54, 90, -61, -13, 78, -85, 31, 46, -90, 67, 4, -73, 88, -38,
    36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36,
    36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36,
    31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85,
    -85, 46, 13, -67, 90, -73, 22, 38, -82, 88, -54, -4, 61, -90, 78, -31,
    25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25,
    -25, 70, -90, 80, -43, -9, 57, -87, 87, -57, 9, 43, -80, 90, -70, 25,
    22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88,
    88, -67, 31, 13, -54, 82, -90, 78, -46, 4, 38, -73, 90, -85, 61, -22,
    18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18,
    18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18,
    13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90,
    -90, 82, -67, 46, -22, -4, 31, -54, 73, -85, 90, -88, 78, -61, 38, -13,
    9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9,
    -9, 25, -43, 57, -70, 80, -87, 90, -90, 87, -80, 70, -57, 43, -25, 9,
    4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90,
    90, -90, 88, -85, 82, -78, 73, -67, 61, -54, 46, -38, 31, -22, 13, -4,
};

// the 4-point DST-VII of 4x4 intra luma (8.6.4.2, eq. 8-303), [k][i]
__constant__ int8_t kDst4[16] = {29, 55,  74,  84, 74,  74, 0, -74,
                                 84, -29, -74, 55, 55, -84, 74, -29};

// levelScale[qP % 6] of 8.6.3
__constant__ int kLevelScale[6] = {40, 45, 51, 57, 64, 72};

__device__ __forceinline__ int clip16(long long v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : (int)v);
}

// K14. Replaces ffpic_tpu/ops/hevc_kernels.py:dequant_itransform_batch
// (:80, with _dequant_dev :65 and _exact_matmul_i16 :46) and
// dequant_skip_batch (:104), as their callers residuals_packed (:143) and
// residuals_for_ops (:113) run them: one launch per (n, dst, skip) bucket
// there, one launch for all of a picture's TUs here.
// Bound: a TU of n points takes 4 n^3 integer operations (two passes of
// n^2 sums of n multiply-adds) against 4 n^2 bytes of levels and
// residuals, so a picture's mix of 4x4 to 32x32 TUs is bound by
// operations (about 1.3 G for the 12 MP fixture's 48 tiles, against 78 MB).
// The TPU needed a hi/lo f32 split because its matrix unit has no integer
// path; here the sums are int32 (at most 32768 * 90 * 32).
//
// The host sorts the TUs by size (perm) and cuts them into CTAs of 1024
// samples: 64 TUs of 4x4, 16 of 8x8, 4 of 16x16 or one 32x32 (ctas rows:
// first perm entry, TU count, log2 n). A CTA of 256 threads stages its
// N-point matrix from __constant__ into shared memory (constant memory
// serialises the different addresses of a warp), and each TU's offset,
// QP and flags. Then, four samples a thread:
//   1. dequant into shared memory: (level * scale + 2^(s-1)) >> s in
//      int64, s = bd + log2 n - 5, clipped to int16 (equal to the
//      reference's pre-clipped int32); bypass TUs copy their levels out;
//   2. barrier, column pass e[y][x] = sum_j M[j][y] d[j][x],
//      clip((e + 64) >> 7);
//   3. barrier, row pass r[y][x] = sum_j M[j][x] e[y][j],
//      clip((r + 2^(19-bd)) >> (20-bd)); skip TUs take
//      clip(((d << 7) + 2^(19-bd)) >> (20-bd)) instead.
// A warp covers one row of a 32x32 TU (or several rows, or several
// TUs): in the column pass M[j][y] is one broadcast and d[j][x] 32
// neighbouring words, in the row pass the other way round, so neither
// has a bank conflict. >> of a negative int32 is arithmetic, as the
// reference's floor shift. QPs are 0..87 (the route checks), where C's
// / and % on them are the reference's floor // and %.
constexpr int kResThreads = 256;
constexpr int kResSamples = 1024;
constexpr int kResMaxTus = 64;

template <int L2>
__device__ __forceinline__ void residuals_cta(
    const int16_t* __restrict__ levels, int16_t* __restrict__ out, int cnt,
    int bd, int* s_d, int* s_e, const int16_t* s_m, const int16_t* s_dst,
    const int* s_off, const int* s_qp, const int* s_flags) {
  constexpr int N = 1 << L2, NN = N * N;
  const int total = cnt * NN;
  const int bs = bd + L2 - 5;
  for (int i = threadIdx.x; i < total; i += kResThreads) {
    const int t = i / NN, p = i % NN;
    const int lv = levels[s_off[t] + p];
    if (s_flags[t] & 2) {                    // bypass: the levels
      out[s_off[t] + p] = (int16_t)lv;
      continue;
    }
    const int qp = s_qp[t];
    const long long scale = (long long)(16 * kLevelScale[qp % 6])
                            << (qp / 6);
    s_d[i] = clip16(((long long)lv * scale + (1LL << (bs - 1))) >> bs);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += kResThreads) {
    const int t = i / NN, p = i % NN;
    if (s_flags[t] & 3) continue;            // skip or bypass
    const int y = p / N, x = p % N;
    const int16_t* m = (N == 4 && (s_flags[t] & 4)) ? s_dst : s_m;
    const int* d = s_d + t * NN;
    int acc = 0;
#pragma unroll
    for (int j = 0; j < N; j++) acc += m[j * N + y] * d[j * N + x];
    s_e[i] = clip16((acc + 64) >> 7);
  }
  __syncthreads();
  const int shift2 = 20 - bd, rnd2 = 1 << (shift2 - 1);
  for (int i = threadIdx.x; i < total; i += kResThreads) {
    const int t = i / NN, p = i % NN;
    const int f = s_flags[t];
    if (f & 2) continue;
    int r;
    if (f & 1) {
      r = (s_d[i] * 128 + rnd2) >> shift2;
    } else {
      const int y = p / N, x = p % N;
      const int16_t* m = (N == 4 && (f & 4)) ? s_dst : s_m;
      const int* e = s_e + t * NN + y * N;
      int acc = 0;
#pragma unroll
      for (int j = 0; j < N; j++) acc += m[j * N + x] * e[j];
      r = (acc + rnd2) >> shift2;
    }
    out[s_off[t] + p] = (int16_t)clip16(r);
  }
}

__global__ void __launch_bounds__(kResThreads)
    hevc_residuals_kernel(const int* __restrict__ meta,
                          const int* __restrict__ offs,
                          const int* __restrict__ perm,
                          const int4* __restrict__ ctas,
                          const int16_t* __restrict__ levels,
                          int16_t* __restrict__ out, int bd) {
  __shared__ int s_d[kResSamples];
  __shared__ int s_e[kResSamples];
  __shared__ int16_t s_m[kResSamples];
  __shared__ int16_t s_dst[16];
  __shared__ int s_off[kResMaxTus], s_qp[kResMaxTus], s_flags[kResMaxTus];
  const int4 c = ctas[blockIdx.x];
  const int start = c.x, cnt = c.y, l2 = c.z, n = 1 << l2;
  for (int i = threadIdx.x; i < n * n; i += kResThreads)
    s_m[i] = kT32[((i >> l2) << (5 - l2)) * 32 + (i & (n - 1))];
  if (threadIdx.x < 16) s_dst[threadIdx.x] = kDst4[threadIdx.x];
  if (threadIdx.x < cnt) {
    const int t = perm[start + threadIdx.x];
    const int* r = meta + 8LL * t;
    s_off[threadIdx.x] = offs[t];
    s_qp[threadIdx.x] = r[6];
    s_flags[threadIdx.x] = (r[4] ? 1 : 0) | (r[5] ? 2 : 0) | (r[7] ? 4 : 0);
  }
  __syncthreads();
  switch (l2) {
    case 2:
      residuals_cta<2>(levels, out, cnt, bd, s_d, s_e, s_m, s_dst, s_off,
                       s_qp, s_flags);
      break;
    case 3:
      residuals_cta<3>(levels, out, cnt, bd, s_d, s_e, s_m, s_dst, s_off,
                       s_qp, s_flags);
      break;
    case 4:
      residuals_cta<4>(levels, out, cnt, bd, s_d, s_e, s_m, s_dst, s_off,
                       s_qp, s_flags);
      break;
    default:
      residuals_cta<5>(levels, out, cnt, bd, s_d, s_e, s_m, s_dst, s_off,
                       s_qp, s_flags);
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

// meta: m x 8 int32; offs, perm: m int32; ctas: k x 4 int32, 16-byte
// aligned, each row (first perm entry, TU count <= 1024 >> 2 log2 n,
// log2 n in 2..5, 0); levels, out: int16 at the offsets; bd 8..14
int ffpic_hevc_residuals(const void* meta, const void* offs, const void* perm,
                         const void* ctas, const void* levels, void* out,
                         int k, int bd, void* stream) {
  if (k <= 0 || bd < 8 || bd > 14 || ((uintptr_t)ctas & 15))
    return (int)cudaErrorInvalidValue;
  hevc_residuals_kernel<<<k, kResThreads, 0, (cudaStream_t)stream>>>(
      (const int*)meta, (const int*)offs, (const int*)perm,
      (const int4*)ctas, (const int16_t*)levels, (int16_t*)out, bd);
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
