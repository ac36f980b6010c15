// Resize kernels for Hopper (sm_90a): the device half of
// ffpic_tpu_torch.ops.resize (BASELINE config 5, the model's input).
//
//   K16 resize_rgba       (N, H, W, C) uint8 -> (N, h, w, C) uint8:
//                         bilinear with antialiasing, rounded half to
//                         even and clipped
//   K17 normalize_resize  (N, H, W, Cin >= 3) uint8 RGBA -> (N, h, w, 3)
//                         f32: rgb * f32(1/255), the same resize in f32
//                         with no uint8 rounding, then (x - mean) / std;
//                         without a resize fma(rgb, f32(1/255), -mean) /
//                         std
//
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().
//
// Both replace B4, ffpic_tpu/ops/resize.py: K16 resize_rgba (:13), K17
// normalize_for_model (:27), each a jax.image.resize, which XLA runs as
// two dense products over (in, out) weight matrices. Here each output
// index reads only its taps: a run of inputs from `start`, `count` long,
// with its f32 weights (host tables from ops.resize.taps, the nonzero run
// of each column of JAX's weight matrix).
//
// Arithmetic, bit for bit with ops.resize's plain versions: an axis whose
// size changes is summed in double, over its taps in ascending input
// order, each product and each sum rounded to double (__dmul_rn and
// __dadd_rn: nvcc would otherwise contract them into FMAs, which the
// plain version does not do), then rounded to float; H first, then W; an
// axis whose size does not change is skipped, as JAX skips it. On H the
// products of K16 (uint8 x f32) and their sums are exact in double; on W
// the products (f32 x f32, 48 bits) are exact and the sums are not, which
// is why both versions keep one order. K16 then rounds half to even
// (rintf) and clips. K17 follows what XLA's CPU backend compiles the
// jitted original to: / 255 is a product by f32(1/255), rounded before
// the resize, and (x - mean) / std after it, an f32 subtract and an f32
// divide (__fdiv_rn, never a product by the reciprocal); when neither
// axis changes, the product and the subtraction are one FMA
// (__fmaf_rn), as XLA contracts them there.
//
// Bound, at config 5 (8 x 1080p RGBA to 224 x 224): each input byte read
// once and each output written once, 66.4 + 1.6 MB for K16, 0.020 ms at
// 3.35 TB/s. The double work is a multiply and an add a tap, about 10
// taps a row element and 18 a column element, 0.32 G f64 ops, 0.010 ms
// at the card's 33.45 T f64 op/s (an FMA counted as 2). So it is bound
// by bytes.
//
// Design (simple first): one CTA per (output row, image). Pass 1
// computes the output row over all W input columns from its vertical
// taps (or takes the input row when H does not change), a thread a
// pixel's group of up to four channels, and keeps it in shared memory as
// f32, W x C x 4 bytes (30 KB at 1920 x 4). Pass 2 computes the row's
// w x C outputs from their horizontal taps there. What sets the time is
// each thread's chain of round trips to memory in pass 1, not the f64
// work, so a thread loads kBatch taps' inputs before it sums them, and
// an RGBA pixel is one 32-bit load a tap (chip_smoke.py times the byte
// loads on the same pixels beside it). The f32 weights come widened
// to double, and K16's bytes are made doubles from their bits, since
// every conversion to or from a 64-bit type issues at a quarter of the
// f64 rate on sm_90. Neighbouring output rows share about half their
// input rows when shrinking by 4.8, so a byte comes from device memory
// about once and from L2 about twice.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInv255 = 1.0f / 255.0f;   // XLA's f32(1/255)

struct Taps {
  const int* start;    // (out,) first input index
  const int* count;    // (out,) length of the run
  const double* w;     // (out, k) its f32 weights, widened on the host
  int k;
};

struct Norm {
  float mean[3];
  float std[3];
};

// An input byte as the value the sums take. K16: the byte, built as a
// double from its bits (2^52 + v, less 2^52: exact, one f64 add), since
// a conversion to or from a 64-bit type issues at a quarter of the f64
// rate on sm_90. K17: rgb * f32(1/255) rounded to f32, read from a
// table of the 256 products in shared memory.
template <bool NORM>
__device__ __forceinline__ double widen(unsigned v, const float* lut) {
  if (NORM) return (double)lut[v];
  return __dadd_rn(__hiloint2double(0x43300000, (int)v),
                   -4503599627370496.0);
}

// A thread takes a pixel's group of up to four channels, `nc` bytes
// from p: one 32-bit load when the launcher found every pixel 4-byte
// aligned with four channels (RGBA: WORD), else a byte load a channel.
// WORD is a template argument, so the batch of loads below holds no
// branch that would keep nvcc from issuing it together.
template <bool WORD>
__device__ __forceinline__ unsigned load_group(const uint8_t* p, int nc) {
  if (WORD) return __ldg(reinterpret_cast<const unsigned*>(p));
  unsigned v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < nc) v |= (unsigned)__ldg(p + c) << (8 * c);
  return v;
}

// The vertical taps of one group, each channel summed in ascending order.
// A chain of dependent loads would leave each thread waiting on one round
// trip to memory a tap; the inputs of kBatch taps are loaded first, so
// their round trips overlap, and then summed in order.
constexpr int kBatch = 16;

template <bool NORM, bool WORD>
__device__ __forceinline__ void group_taps(const uint8_t* px,
                                           long long pitch, const Taps& t,
                                           int o, int nc, const float* lut,
                                           float* f) {
  const int s = t.start[o], n = t.count[o];
  const double* w = t.w + (long long)o * t.k;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    unsigned v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = i0 + u < n
                 ? load_group<WORD>(px + (long long)(s + i0 + u) * pitch,
                                    nc)
                 : 0u;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u < n) {
        const double wt = __ldg(w + i0 + u);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < nc)
            acc[c] = __dadd_rn(acc[c], __dmul_rn(
                wt, widen<NORM>((v[u] >> (8 * c)) & 255u, lut)));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) f[c] = __double2float_rn(acc[c]);
}

template <bool NORM>
__device__ __forceinline__ void store(void* out, long long at, int c,
                                      float v, const Norm& nm) {
  if (NORM) {
    static_cast<float*>(out)[at] =
        __fdiv_rn(__fsub_rn(v, nm.mean[c]), nm.std[c]);
  } else {
    static_cast<uint8_t*>(out)[at] =
        (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  }
}

// in: image n, row y, column x, channel c at in + n * img + y * row +
// x * cin + c; out: contiguous (N, h, w, ch); ch = cin for K16, 3 for
// K17. Grid (h, N). Dynamic shared memory: W * ch floats when W != w.
template <bool NORM, bool WORD>
__global__ void __launch_bounds__(kThreads)
    resize_kernel(const uint8_t* __restrict__ in, long long img,
                  long long row, int cin, void* __restrict__ out, int H,
                  int W, int h, int w, int ch, Taps vt, Taps ht, Norm nm) {
  extern __shared__ float4 line4[];          // 16-byte aligned
  float* line = reinterpret_cast<float*>(line4);
  __shared__ float lut[NORM ? 256 : 1];
  if (NORM) {
    for (int v = threadIdx.x; v < 256; v += kThreads)
      lut[v] = __fmul_rn((float)v, kInv255);
    __syncthreads();
  }
  const int y = blockIdx.x;
  const long long n = blockIdx.y;
  const uint8_t* src = in + n * img;
  const bool vert = H != h, horiz = W != w;
  const long long out_row = (n * h + y) * (long long)w * ch;
  // pass 1: output row y over the W input columns, a thread a pixel, a
  // group of up to four of its channels at a time
  for (int x = threadIdx.x; x < W; x += kThreads) {
    for (int c0 = 0; c0 < ch; c0 += 4) {
      const int nc = min(4, ch - c0);
      const uint8_t* px = src + (long long)x * cin + c0;
      float f[4];
      if (vert) {
        group_taps<NORM, WORD>(px, row, vt, y, nc, lut, f);
      } else {
        const unsigned v = load_group<WORD>(px + (long long)y * row, nc);
        if (NORM && !horiz) {                // no resize: one FMA
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < nc)
              static_cast<float*>(out)[out_row + x * ch + c0 + c] =
                  __fdiv_rn(__fmaf_rn((float)((v >> (8 * c)) & 255u),
                                      kInv255, -nm.mean[c0 + c]),
                            nm.std[c0 + c]);
          continue;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          f[c] = (float)widen<NORM>((v >> (8 * c)) & 255u, lut);
      }
      if (horiz && ch == 4) {                // one 16-byte store
        line4[x] = make_float4(f[0], f[1], f[2], f[3]);
        continue;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nc) continue;
        const int at = x * ch + c0 + c;
        if (horiz)
          line[at] = f[c];
        else
          store<NORM>(out, out_row + at, c0 + c, f[c], nm);
      }
    }
  }
  if (!horiz) return;
  __syncthreads();
  // pass 2: the row's w outputs from their horizontal taps
  const int oc = w * ch;
  for (int e = threadIdx.x; e < oc; e += kThreads) {
    const int j = e / ch, c = e - j * ch;
    const int s = ht.start[j], cnt = ht.count[j];
    const double* wp = ht.w + (long long)j * ht.k;
    double acc = 0.0;
    for (int i = 0; i < cnt; ++i)
      acc = __dadd_rn(acc, __dmul_rn(__ldg(wp + i),
                                     (double)line[(s + i) * ch + c]));
    store<NORM>(out, out_row + e, c, __double2float_rn(acc), nm);
  }
}

constexpr size_t kMaxSmem = 232448;   // a CTA's most on sm_90, all dynamic

template <bool NORM>
int launch(const uint8_t* in, long long img, long long row, int cin,
           void* out, int n, int H, int W, int h, int w, int ch, Taps vt,
           Taps ht, Norm nm, cudaStream_t st) {
  if (n <= 0 || n > 65535 || H <= 0 || W <= 0 || h <= 0 || w <= 0 ||
      ch <= 0 || ch > cin || (H != h && (!vt.start || vt.k <= 0)) ||
      (W != w && (!ht.start || ht.k <= 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = W != w ? (size_t)W * ch * sizeof(float) : 0;
  if (smem + 1024 > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool word = cin == 4 && (uintptr_t)in % 4 == 0 && row % 4 == 0 &&
                    img % 4 == 0;
  auto kernel = word ? resize_kernel<NORM, true> : resize_kernel<NORM, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((unsigned)h, (unsigned)n), kThreads, smem, st>>>(
      in, img, row, cin, out, H, W, h, w, ch, vt, ht, nm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: (n, H, W, c) uint8, images `img` bytes apart, rows `row` bytes
// apart, pixels c bytes apart; out: contiguous (n, h, w, c) uint8; the
// taps' weights as doubles. The taps of an axis whose size does not
// change may be null.
int ffpic_resize_rgba(const void* in, long long img, long long row, int c,
                      void* out, int n, int H, int W, int h, int w,
                      const void* vs, const void* vc, const void* vw, int vk,
                      const void* hs, const void* hc, const void* hw, int hk,
                      void* stream) {
  const Taps vt{(const int*)vs, (const int*)vc, (const double*)vw, vk};
  const Taps ht{(const int*)hs, (const int*)hc, (const double*)hw, hk};
  return launch<false>((const uint8_t*)in, img, row, c, out, n, H, W, h, w,
                       c, vt, ht, Norm{}, (cudaStream_t)stream);
}

// in: (n, H, W, cin >= 3) uint8 as above; out: contiguous (n, h, w, 3)
// f32; mean, std: 3 floats each on the host.
int ffpic_normalize_resize(const void* in, long long img, long long row,
                           int cin, void* out, int n, int H, int W, int h,
                           int w, const void* vs, const void* vc,
                           const void* vw, int vk, const void* hs,
                           const void* hc, const void* hw, int hk,
                           const float* mean, const float* std,
                           void* stream) {
  const Taps vt{(const int*)vs, (const int*)vc, (const double*)vw, vk};
  const Taps ht{(const int*)hs, (const int*)hc, (const double*)hw, hk};
  Norm nm;
  for (int c = 0; c < 3; ++c) {
    nm.mean[c] = mean[c];
    nm.std[c] = std[c];
  }
  return launch<true>((const uint8_t*)in, img, row, cin, out, n, H, W, h, w,
                      3, vt, ht, nm, (cudaStream_t)stream);
}

}  // extern "C"
