// Probes of the FP64 and conversion pipes of an NVIDIA GPU, of the FP64
// tensor cores' rate, and of whether their mma rounds as a chain of FMAs.
// Not part of the kernel library: ffpic_tpu_torch.compare_kernels (group
// fp64) builds this file alone and reads its numbers, the ones K16's band
// design rests on (csrc/resize.cu); chip_smoke.py runs the chain check.
//
//   rates_kernel     one CTA an SM (its dynamic shared memory keeps a second
//                    out), each thread a loop of independent chains; thread
//                    0 writes the CTA's clock64() cycles, so instructions a
//                    clock an SM = threads x iters x instructions an
//                    iteration over cycles. Modes:
//                      0  DFMA, normal operands (8 chains)
//                      1  DFMA, a subnormal multiplicand: a byte as
//                         v x 2^-1074, times a weight scaled by 2^946
//                      2  f32 -> f64 conversions (8 a step, each f32 moved
//                         by an FMUL, each result folded into an XOR)
//                      3  f64 -> f32 conversions (8 a step, each double
//                         moved by a DMUL, each result folded into an XOR)
//   mma16_kernel     a warp a tile: D = A B + C by mma.m16n8k16 .f64, and
//                    each element again by __fma_rn over k = 0..15 and
//                    k = 15..0.
//   mma_rate_kernel  mma.m16n8k16 .f64 throughput.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

__global__ void __launch_bounds__(1024, 1)
    rates_kernel(int mode, int iters, double a, double b, float fa,
                 long long* cycles, double* sink) {
  double acc[16];
  float f[kChains];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = a * (k + 1) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kChains; ++k) f[k] = fa * (k + 1) + threadIdx.x;
  unsigned x = threadIdx.x;
  __syncthreads();
  const long long t0 = clock64();
  if (mode == 0) {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int k = 0; k < kChains; ++k) acc[k] = __fma_rn(acc[k], b, a);
  } else if (mode == 1) {
    const double sub = __hiloint2double(0, 200);
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int k = 0; k < kChains; ++k) acc[k] = __fma_rn(b, sub, acc[k]);
  } else if (mode == 2) {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        f[k] = __fmul_rn(f[k], fa);
        x ^= (unsigned)__double2hiint((double)f[k]);
      }
  } else if (mode == 3) {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        acc[k] = __dmul_rn(acc[k], b);
        x ^= __float_as_uint(__double2float_rn(acc[k]));
      }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  double s = x;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += acc[k];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// The m16n8k16 .f64 form (sm_90): tile t holds A (16 x 16, row major,
// a[t * 256 + i * 16 + k]), B (16 x 8, b[t * 128 + j * 16 + k]: column j
// contiguous), C and D (16 x 8, row major). Lane l, g = l / 4, q = l % 4:
// A(g + 8 (i % 2), q + 4 (i / 2)) for a_i, i < 8; B(q + 4 i, g) for b_i,
// i < 4; D(g + 8 (i / 2), 2 q + i % 2) for d_i, i < 4.
__global__ void mma16_kernel(const double* a, const double* b,
                             const double* c, double* d_mma, double* d_fwd,
                             double* d_rev, int tiles) {
  const int lane = threadIdx.x & 31;
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (t >= tiles) return;
  const int g = lane >> 2, q = lane & 3;
  const double* at = a + t * 256;
  const double* bt = b + t * 128;
  const double* ct = c + t * 128;
  double av[8], bv[4], dv[4];
  for (int i = 0; i < 8; ++i)
    av[i] = at[(g + 8 * (i % 2)) * 16 + q + 4 * (i / 2)];
  for (int i = 0; i < 4; ++i) bv[i] = bt[g * 16 + q + 4 * i];
  for (int i = 0; i < 4; ++i)
    dv[i] = ct[(g + 8 * (i / 2)) * 8 + 2 * q + i % 2];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(dv[0]), "+d"(dv[1]), "+d"(dv[2]), "+d"(dv[3])
      : "d"(av[0]), "d"(av[1]), "d"(av[2]), "d"(av[3]), "d"(av[4]),
        "d"(av[5]), "d"(av[6]), "d"(av[7]), "d"(bv[0]), "d"(bv[1]),
        "d"(bv[2]), "d"(bv[3]));
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), j = 2 * q + i % 2;
    d_mma[t * 128 + r * 8 + j] = dv[i];
    double fwd = ct[r * 8 + j], rev = fwd;
    for (int k = 0; k < 16; ++k)
      fwd = __fma_rn(at[r * 16 + k], bt[j * 16 + k], fwd);
    for (int k = 15; k >= 0; --k)
      rev = __fma_rn(at[r * 16 + k], bt[j * 16 + k], rev);
    d_fwd[t * 128 + r * 8 + j] = fwd;
    d_rev[t * 128 + r * 8 + j] = rev;
  }
}

// Throughput of mma.m16n8k16 .f64: a warp `iters` steps of 8 independent
// products of 2048 FMA each, clock64 cycles a CTA.
__global__ void __launch_bounds__(256, 1)
    mma_rate_kernel(int iters, double x, long long* cycles, double* sink) {
  double acc[8][4] = {};
  double av[8], bv[4];
  for (int i = 0; i < 8; ++i) av[i] = x + threadIdx.x + i;
  for (int i = 0; i < 4; ++i) bv[i] = x - i;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int p = 0; p < 8; ++p)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, "
          "%3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
          "{%0, %1, %2, %3};\n"
          : "+d"(acc[p][0]), "+d"(acc[p][1]), "+d"(acc[p][2]),
            "+d"(acc[p][3])
          : "d"(av[0]), "d"(av[1]), "d"(av[2]), "d"(av[3]), "d"(av[4]),
            "d"(av[5]), "d"(av[6]), "d"(av[7]), "d"(bv[0]), "d"(bv[1]),
            "d"(bv[2]), "d"(bv[3]));
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  double s = 0;
  for (int p = 0; p < 8; ++p)
    for (int i = 0; i < 4; ++i) s += acc[p][i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

int ffpic_probe_mma16(const double* a, const double* b, const double* c,
                      double* d_mma, double* d_fwd, double* d_rev, int tiles,
                      void* stream) {
  const int threads = 128, blocks = (tiles * 32 + threads - 1) / threads;
  mma16_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, b, c, d_mma, d_fwd, d_rev, tiles);
  return (int)cudaGetLastError();
}

// blocks CTAs of 256 threads, one an SM (120 KB of dynamic shared memory
// each); cycles: blocks int64; sink: blocks x 256 doubles.
int ffpic_probe_mma_rate(int iters, int blocks, long long* cycles,
                         double* sink, void* stream) {
  const int smem = 120 * 1024;
  cudaError_t e = cudaFuncSetAttribute(
      mma_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  mma_rate_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
      iters, 1.0, cycles, sink);
  return (int)cudaGetLastError();
}

// mode as above; blocks CTAs of `threads` threads, each with 120 KB of
// dynamic shared memory, so one fits an SM; cycles: blocks int64; sink:
// blocks x threads doubles.
int ffpic_probe_rates(int mode, int iters, int blocks, int threads, double a,
                      double b, float fa, long long* cycles, double* sink,
                      void* stream) {
  const int smem = 120 * 1024;
  cudaError_t e = cudaFuncSetAttribute(
      rates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  rates_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      mode, iters, a, b, fa, cycles, sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
