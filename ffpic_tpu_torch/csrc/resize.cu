// Resize kernels for Hopper (sm_90a): the device half of
// ffpic_tpu_torch.ops.resize (BASELINE config 5, the model's input).
//
//   K16 resize_rgba       N slots, each (H_n, W_n, C) uint8 of its own size
//                         and pitch -> (N, h, w, C) uint8 in one launch:
//                         any of jax.image.resize's methods (bilinear,
//                         cubic, lanczos3, lanczos5, nearest; the host's
//                         tap tables tell them apart), antialiased when
//                         shrinking, rounded half to even and clipped
//   K17 normalize_resize  N images (H_n, W_n, Cin >= 3) uint8 RGBA -> (N, h,
//                         w, 3) f32: rgb * f32(1/255), the same resize in
//                         f32 with no uint8 rounding, then (x - mean) / std;
//                         without a resize fma(rgb, f32(1/255), -mean) /
//                         std
//
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().
//
// Both replace B4, ffpic_tpu/ops/resize.py: K16 resize_rgba (:13), which
// ffpic_tpu/pipeline.py:309-311 calls once a slot, K17
// normalize_for_model (:27), each a jax.image.resize, which XLA runs as
// two dense products over (in, out) weight matrices. Here each output
// index reads only its taps: a run of inputs from `start`, `count` long,
// with its f32 weights (host tables from ops.resize.taps, the nonzero run
// of each column of JAX's weight matrix for the method: about 10 taps a
// row element for bilinear at 1080 -> 224, 20 for cubic, 29 for lanczos3,
// 49 for lanczos5, one of weight 1 for nearest). One launch covers a batch:
// each slot has a descriptor (Slot: its pixels, row pitch and the taps of
// each axis), so slots of other sizes and pitches share the launch and
// the output is written in place of a stack of per-slot results (64
// slots a launch, by value).
//
// Arithmetic, bit for bit with ops.resize's plain versions: an axis whose
// size changes is summed in double, over its taps in ascending input
// order, each sum rounded to double, then rounded to float; H first, then
// W; an axis whose size does not change is skipped, as JAX skips it. The
// plain versions round each product to double and then each sum. Every
// product here is exact in double: a uint8 (8 bits), a K17 input (an f32,
// 24) or a pass-1 result (an f32, 24) times an f32 weight (24) needs at
// most 48 of the 53 bits. So the product's rounding does nothing, and one
// fused multiply-add (__fma_rn) rounds exactly as the plain version's
// product-then-sum (tests/test_torch_resize.py checks the products of
// every weight with Fractions). The sums are not exact in general, which
// is why both versions keep one order. K16 then rounds half to even
// (rintf) and clips. K17 follows what XLA's CPU backend compiles the
// jitted original to: / 255 is a product by
// f32(1/255), rounded before the resize, and (x - mean) / std after it,
// an f32 subtract and an f32 divide (__fdiv_rn, never a product by the
// reciprocal); when neither axis changes, the product and the subtraction
// are one FMA (__fmaf_rn), as XLA contracts them there.
//
// Bound, at config 5 (8 x 1080p RGBA to 224 x 224): each input byte read
// once and each output written once, 66.4 + 1.6 MB for K16, 0.020 ms at
// 3.35 TB/s. The double work is an FMA a tap, about 10 taps a row element
// and 18 a column element, 0.32 G f64 ops, 0.010 ms at the card's 33.45 T
// f64 op/s (an FMA counted as 2). So it is bound by bytes. What sets the
// time instead is pass 1's instructions a tap and channel and the round
// trips each thread waits on (PERF.md, section 6). The wider kernels
// scale the f64 work with their taps (lanczos5 about 5x), which makes
// lanczos3 and lanczos5 bound by operations (PERF.md has each method's
// bound).
//
// Design. One CTA per kRows output rows of a slot. Pass 1 computes the rows
// over all W input columns from their vertical taps (or takes the input rows
// when H does not change), a thread a pixel's group of up to four channels,
// and keeps them in shared memory as f32, kRows x W x C x 4 bytes (60 KB at
// 1920 x 4). A launch whose widest slot's kRows lines do not fit shared memory
// (RGBA wider than about 7,200 pixels) takes one output row a CTA instead, so
// the widest slot is what one row's line allows, about 14,400 RGBA pixels.
// Neighbouring output rows share about half their input rows when shrinking by
// 4.8, so the CTA stages, once, each row's weight for every input row of the
// band its runs span (0 outside a row's run, which adds nothing), and a thread
// then loads each input row of the band once (kBatch rows in flight), widens
// it once and adds it to every row, with no branch in the loop: the zero FMAs
// cost less than a branch a tap did. A K16 byte becomes a double by one f64
// add (2^52 + v less 2^52), which takes fewer instructions than integer
// operations would; a K17 input is an f32 product (f32 add and multiply) moved
// into a double by integer operations (f32_as_f64); each sum is rounded to f32
// once an element. Pass 2 computes the rows' w pixels from their horizontal
// taps there, a thread a pixel's group of channels in every row: its weights
// kBatch2 at a time into registers ahead of the FMAs (no load waits inside the
// chain of taps), each weight used for every row, each f32 widened to a double
// (line_f64: K17's by integer operations, K16's, which may be negative, by a
// conversion). An
// RGBA pixel is one 32-bit load where the slot is 4-byte aligned (byte loads
// otherwise). The channel count is a compile-time constant for K16 on RGBA and
// for K17, and a CTA keeps to 85 registers so that 3 fit an SM (PERF.md holds
// the sweep of rows a CTA, loads in flight and registers these constants come
// from). Bilinear K16 and K17 take this kernel; cubic and Lanczos take it only
// where two rows' lines of the band kernel below do not fit.
//
// Cubic and Lanczos (resize_band_kernel). Their taps are 2 to 5 times
// bilinear's (20, 29 and 49 a row element at 1080 -> 224, 35, 52 and 86 a
// column element): 0.64, 0.96 and 1.58 G f64 operations at config 5, 0.019,
// 0.029 and 0.047 ms on the FP64 pipe (33.45 T op/s), 0.010, 0.014 and 0.024
// ms on the FP64 tensor cores this kernel runs them on (66.9 T), beside 0.020
// ms of bytes: bytes bound cubic and lanczos3 there, operations lanczos5.
// The banded kernel spent about twice the instructions the sums need on
// them (a band rounded to 16 rows widened and FMA'd whole into both rows, a
// conversion a tap and pixel in pass 2). This kernel runs both passes on the
// FP64 tensor cores: mma.m16n8k16 does 128 FMAs a clock an SM, twice the FP64
// pipe, with no instruction a multiply-add (python3 -m
// ffpic_tpu_torch.compare_kernels --kernels fp64). On Hopper each element of
// a product is the chain of FMAs over k in ascending order, one rounding a
// step: the probe holds it bit for bit against __fma_rn chains on integer,
// random, tie-breaking, byte-times-weight and subnormal tiles, and
// chip_smoke.py fails on a card or driver where it does not. So, with the
// weights 0 outside each output's run (those FMAs cost tensor-core time, not
// instructions), each sum is the plain version's.
// - Pass 1: a CTA takes up to kBandRows output rows (a product's 8 columns; 7
//   fit shared memory at 1920 RGBA), its band in steps of kStep = 16 input
//   rows (a product's k), a warp 64 bytes of a row (A's rows, every channel
//   alike). Each input byte is loaded once a CTA and widened once, to a
//   subnormal by its bits (byte_subnormal: no f64 instruction).
// - Each row's line holds the full width in shared memory as f32 (no column
//   is computed twice): 215 KB for 7 rows at 1920 RGBA, one CTA an SM, 256
//   CTAs at config 5 (1.94 waves of 132). Fewer rows a CTA where the launch
//   is small, so that its CTAs spread over the SMs, and where the lines are
//   wider; where two rows do not fit (RGBA about 7,200 pixels wide or wider)
//   the launch takes resize<0,1> (launch_band).
// - Pass 2: a warp a group of kGroup output columns (a product's 8 columns)
//   for all the CTA's (row, channel) pairs (A's rows), the group's window in
//   steps of 16 (k): each line value loaded and converted to double once a
//   group, each f32 weight (a per-group table in the products' order,
//   cuda_resize.group_taps) loaded and converted once a warp.
// PERF.md, section 6, has the sweep of rows and threads a CTA
// (python3 -m ffpic_tpu_torch.tune_resize) and what bounds each pass.
//
// Nearest (resize_gather_kernel): every changed axis has one tap of weight 1
// at start[j], so output (y, x) of a slot is its input pixel (start_v[y],
// start_h[x]) byte for byte (the f64 sum of one product by 1 is the byte, and
// rounding keeps it). A thread writes 16 bytes of the (N, h, w, C) output
// with one store: four 32-bit pixel loads where every slot is 4-byte aligned
// with four channels, else a byte load a channel. It reads only the kept
// pixels (1.6 MB at config 5, in about 13 MB of 32-byte sectors, since kept
// pixels sit about 34 bytes apart); no shared memory, no f64.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;                   // output rows a CTA, or 1
constexpr int kBatch = 16;                 // pass 1: input rows in flight
constexpr int kBatch2 = 8;                 // pass 2: weights read ahead
constexpr float kInv255 = 1.0f / 255.0f;   // XLA's f32(1/255)

// One axis of one slot: the run of each output index (start, count) and
// its f32 weights widened to double, k a row; `start` null when the axis
// keeps its size. n: the slot's input size on the axis.
struct Axis {
  const int* start;
  const int* count;
  const double* w;
  int k;
  int n;
};

// One slot: its pixel (y, x, c) at src + y * row + x * cin + c.
// 80 bytes, as ops.cuda_resize lays it out: ten 64-bit words.
struct Slot {
  const uint8_t* src;
  long long row;
  Axis v, h;
};

// A launch's slots, passed by value (5 KB of kernel parameters, which
// sm_90 takes up to 32 KB): no copy to the device before the launch,
// and each CTA reads its slot from the constant bank.
constexpr int kMaxSlots = 64;
struct Slots {
  Slot s[kMaxSlots];
};

struct Norm {
  float mean[3];
  float std[3];
};

// A value the sums take, 0 or a positive normal f32, as a double by
// integer operations: the exponent rebased by 1023 - 127 = 896 and the
// mantissa moved up 29 bits, no conversion. The values here are K17's
// inputs (bytes times f32(1/255)) and its pass-1 results, whose weights
// are bilinear: sums of products of those (at least 2^-8 when not 0) and
// f32 weights that are 0 or at least 2^-108, so never negative,
// subnormal, infinite or NaN.
__device__ __forceinline__ double f32_as_f64(float f) {
  const unsigned b = __float_as_uint(f);
  return __hiloint2double(b ? (int)((b >> 3) + 0x38000000u) : 0,
                          (int)(b << 29));
}

// A pass-1 result as a double for pass 2. K16's vertical weights may have
// negative lobes (cubic, Lanczos), so its results may be negative or, in
// principle, subnormal: the conversion (exact, no flush to zero in this
// build) takes them whole. K17's are never negative: f32_as_f64.
template <bool NORM>
__device__ __forceinline__ double line_f64(float f) {
  return NORM ? f32_as_f64(f) : (double)f;
}

// Byte c of the word v as the f32 value the sums take: K16 the byte, K17
// its product by f32(1/255), rounded to f32 as XLA rounds it. The byte
// becomes a float from its bits (2^23 + v, less 2^23: an exact f32 add).
template <bool NORM>
__device__ __forceinline__ float byte_value(unsigned v, int c) {
  const float f = __fsub_rn(
      __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + c)), 8388608.0f);
  return NORM ? __fmul_rn(f, kInv255) : f;
}

// The same as a double, for pass 1's sums. K16: the byte as a double
// from its bits (2^52 + v, less 2^52: exact, one f64 add, fewer
// instructions than any other way); K17: its f32 value moved into a
// double (f32_as_f64).
template <bool NORM>
__device__ __forceinline__ double widen(unsigned v, int c) {
  if (NORM) return f32_as_f64(byte_value<true>(v, c));
  return __dadd_rn(__hiloint2double(0x43300000, (int)((v >> (8 * c)) & 255u)),
                   -4503599627370496.0);
}

// A thread takes a pixel's group of up to four channels, `nc` bytes
// from p: one 32-bit load when the slot's pixels are 4-byte aligned with
// four channels (WORD), else a byte load a channel. WORD is a template
// argument, so the batch of loads below holds no branch that would keep
// nvcc from issuing it together.
template <bool WORD>
__device__ __forceinline__ unsigned load_group(const uint8_t* p, int nc) {
  if (WORD) return __ldg(reinterpret_cast<const unsigned*>(p));
  unsigned v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < nc) v |= (unsigned)__ldg(p + c) << (8 * c);
  return v;
}

// The vertical taps of one group of channels for the CTA's rows: the
// span input rows from lo (a multiple of kBatch; rows past the image's
// last read as it), each loaded and widened once and added to every
// output row r with its weight wt[r * span + i - lo] (shared memory; 0
// where the row's run does not hold input row i, which adds nothing); each
// sum in ascending input order. No branch: the inputs of kBatch rows are
// loaded first, so their round trips to memory overlap, then summed.
template <bool NORM, bool WORD, int ROWS>
__device__ __forceinline__ void group_taps(const uint8_t* px, long long pitch,
                                           int lo, int span, int last,
                                           const double* wt, int nc,
                                           float (*f)[4]) {
  double acc[ROWS][4] = {};
  for (int k0 = 0; k0 < span; k0 += kBatch) {
    unsigned v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = load_group<WORD>(px + (long long)min(lo + k0 + u, last) * pitch,
                              nc);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      double x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = c < nc ? widen<NORM>(v[u], c) : 0.0;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const double w = wt[r * span + k0 + u];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < nc) acc[r][c] = __fma_rn(w, x[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) f[r][c] = __double2float_rn(acc[r][c]);
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

// Output rows y0..y0+rows-1 of slot s into out, contiguous (N, h, w, ch),
// the first at out_row. vw: the rows' vertical weights over the span
// input rows from lo, zero-padded, in shared memory (staged by the
// caller); line: rows x W x ch floats of shared memory. CH: the channels
// as a compile-time constant (K16 on RGBA 4, K17 3; 0 for any other K16
// input, then ch_any), so no channel's work is predicated where it is
// known.
template <bool NORM, bool WORD, int CH, int ROWS>
__device__ __forceinline__ void resize_rows(const Slot& s, int cin,
                                            void* out, long long out_row,
                                            int y0, int rows, int w,
                                            int ch_any, const Norm& nm,
                                            const double* vw, int lo,
                                            int span, float* line) {
  const int ch = CH ? CH : ch_any;
  const bool vert = s.v.start != nullptr, horiz = s.h.start != nullptr;
  const int W = s.h.n;
  const long long out_pitch = (long long)w * ch;
  const int line_pitch = W * ch;
  // pass 1: the output rows over the W input columns, a thread a pixel, a
  // group of up to four of its channels at a time
  for (int x = threadIdx.x; x < W; x += kThreads) {
    for (int c0 = 0; c0 < ch; c0 += 4) {
      const int nc = min(4, ch - c0);
      const uint8_t* px = s.src + (long long)x * cin + c0;
      float f[ROWS][4];
      if (vert) {
        group_taps<NORM, WORD, ROWS>(px, s.row, lo, span, s.v.n - 1, vw, nc,
                                     f);
      } else {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r >= rows) break;
          const unsigned v = load_group<WORD>(px + (y0 + r) * s.row, nc);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (NORM && !horiz && c < nc)    // no resize: one FMA
              static_cast<float*>(out)[out_row + r * out_pitch + x * ch +
                                       c0 + c] =
                  __fdiv_rn(__fmaf_rn((float)((v >> (8 * c)) & 255u),
                                      kInv255, -nm.mean[c0 + c]),
                            nm.std[c0 + c]);
            f[r][c] = byte_value<NORM>(v, c);
          }
        }
        if (NORM && !horiz) continue;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rows) break;
        float* ln = line + r * line_pitch;
        if (horiz && ch == 4) {              // one 16-byte store
          reinterpret_cast<float4*>(ln)[x] =
              make_float4(f[r][0], f[r][1], f[r][2], f[r][3]);
          continue;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= nc) continue;
          const int at = x * ch + c0 + c;
          if (horiz)
            ln[at] = f[r][c];
          else
            store<NORM>(out, out_row + r * out_pitch + at, c0 + c, f[r][c],
                        nm);
        }
      }
    }
  }
  if (!horiz) return;
  __syncthreads();
  // pass 2: the rows' w pixels from their horizontal taps, a thread a
  // pixel's group of up to four channels in every row; its weights
  // kBatch2 at a time into registers ahead of the FMAs, each for all rows
  const int groups = (ch + 3) / 4;
  for (int e = threadIdx.x; e < w * groups; e += kThreads) {
    const int j = e / groups, c0 = (e - j * groups) * 4;
    const int nc = min(4, ch - c0);
    const int s0 = __ldg(s.h.start + j), cnt = __ldg(s.h.count + j);
    const double* wp = s.h.w + (long long)j * s.h.k;
    double acc[ROWS][4] = {};
    for (int i0 = 0; i0 < cnt; i0 += kBatch2) {
      double wt[kBatch2];
#pragma unroll
      for (int u = 0; u < kBatch2; ++u)
        wt[u] = i0 + u < cnt ? __ldg(wp + i0 + u) : 0.0;
#pragma unroll
      for (int u = 0; u < kBatch2; ++u) {
        if (i0 + u >= cnt) break;
        const int at = (s0 + i0 + u) * ch + c0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r >= rows) break;
          const float* ln = line + r * line_pitch + at;
          float4 q;
          if (ch == 4) {
            q = *reinterpret_cast<const float4*>(ln);
          } else {
            q.x = ln[0];
            q.y = nc > 1 ? ln[1] : 0.0f;
            q.z = nc > 2 ? ln[2] : 0.0f;
            q.w = nc > 3 ? ln[3] : 0.0f;
          }
          acc[r][0] = __fma_rn(wt[u], line_f64<NORM>(q.x), acc[r][0]);
          acc[r][1] = __fma_rn(wt[u], line_f64<NORM>(q.y), acc[r][1]);
          acc[r][2] = __fma_rn(wt[u], line_f64<NORM>(q.z), acc[r][2]);
          acc[r][3] = __fma_rn(wt[u], line_f64<NORM>(q.w), acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      const long long at = out_row + r * out_pitch + (long long)j * ch + c0;
      if (!NORM && ch == 4) {                // one 32-bit store a pixel
        unsigned px = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          px |= (unsigned)fminf(
                    fmaxf(rintf(__double2float_rn(acc[r][c])), 0.0f), 255.0f)
                << (8 * c);
        *reinterpret_cast<unsigned*>(static_cast<uint8_t*>(out) + at) = px;
        continue;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < nc)
          store<NORM>(out, at + c, c0 + c, __double2float_rn(acc[r][c]), nm);
    }
  }
}

// Grid (ceil(h / ROWS), N): output rows ROWS * blockIdx.x on of slot
// blockIdx.y, ROWS kRows or 1 (launch). Dynamic shared memory: ROWS x vk
// doubles (vk, a multiple of kBatch, the most input rows the runs of
// kRows output rows of a slot span, rounded up) for the rows' weights,
// then the rows' lines, ROWS x the most W x ch floats of a slot whose W
// changes. A slot's pixels take 32-bit loads when it has four channels
// and every pixel is 4-byte aligned. At most 85 registers, so that 3 CTAs
// fit an SM.
template <bool NORM, int ROWS>
__global__ void __launch_bounds__(kThreads, 3)
    resize_kernel(const __grid_constant__ Slots slots, int cin,
                  void* __restrict__ out, int h, int w, int ch, int vk,
                  Norm nm) {
  extern __shared__ float4 smem4[];              // 16-byte aligned
  double* vw = reinterpret_cast<double*>(smem4);
  const Slot& s = slots.s[blockIdx.y];
  const int y0 = blockIdx.x * ROWS, rows = min(ROWS, h - y0);
  int lo = 0, span = 0;
  if (s.v.start) {
    // the rows' runs, the input rows they span, and each row's weight for
    // each of them (0 outside its run)
    int st[ROWS], ct[ROWS], hi = 0;
    lo = INT_MAX;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      st[r] = r < rows ? __ldg(s.v.start + y0 + r) : 0;
      ct[r] = r < rows ? __ldg(s.v.count + y0 + r) : 0;
      if (ct[r]) {
        lo = min(lo, st[r]);
        hi = max(hi, st[r] + ct[r]);
      }
    }
    lo = min(lo, hi);
    span = (hi - lo + kBatch - 1) / kBatch * kBatch;
    for (int k = threadIdx.x; k < ROWS * span; k += kThreads) {
      const int r = k / span;
      int sr = st[0], cr = ct[0];
#pragma unroll
      for (int q = 1; q < ROWS; ++q)
        if (r == q) {
          sr = st[q];
          cr = ct[q];
        }
      const int i = lo + k - r * span - sr;
      vw[k] = (unsigned)i < (unsigned)cr
                  ? __ldg(s.v.w + (long long)(y0 + r) * s.v.k + i)
                  : 0.0;
    }
  }
  __syncthreads();
  float* line = reinterpret_cast<float*>(vw + ROWS * vk);
  const long long out_row = ((long long)blockIdx.y * h + y0) * w * ch;
  const bool word = cin == 4 && ((uintptr_t)s.src & 3) == 0 &&
                    (s.row & 3) == 0;
  constexpr int kCh = NORM ? 3 : 4;        // K17's 3, K16's RGBA
  if (NORM || ch == 4) {
    if (word)
      resize_rows<NORM, true, kCh, ROWS>(s, cin, out, out_row, y0, rows, w,
                                         ch, nm, vw, lo, span, line);
    else
      resize_rows<NORM, false, kCh, ROWS>(s, cin, out, out_row, y0, rows, w,
                                          ch, nm, vw, lo, span, line);
  } else if (word) {
    resize_rows<NORM, true, 0, ROWS>(s, cin, out, out_row, y0, rows, w, ch,
                                     nm, vw, lo, span, line);
  } else {
    resize_rows<NORM, false, 0, ROWS>(s, cin, out, out_row, y0, rows, w, ch,
                                      nm, vw, lo, span, line);
  }
}

// K16 by cubic and Lanczos (resize_band_kernel; the header says why).
// (python3 -m ffpic_tpu_torch.tune_resize sweeps these constants)
constexpr int kBandThreads = 512;     // 16 warps, 128 registers
constexpr int kBandRows = 7;          // the most output rows a CTA
constexpr int kBandSpans = 16;        // entries of the host's band table
constexpr int kStep = 16;             // pass 1: input rows a product (its k)
constexpr int kPrefetch = 2;          // pass 1: steps ahead into L2
constexpr int kGroup = 8;             // pass 2: output columns a product
static_assert(kBandRows <= 8, "a CTA's rows are a product's 8 columns");

// d += a b on a warp's fragments of mma.m16n8k16 with f64 (lane l, g = l /
// 4, q = l % 4): a_v = A(g + 8 (v % 2), q + 4 (v / 2)) of A (16 x 16), b_v =
// B(q + 4 v, g) of B (16 x 8), d_v = D(g + 8 (v / 2), 2 q + v % 2) of D (16 x
// 8). On Hopper each element of D is the chain of FMAs d + a_0 b_0 + ... +
// a_15 b_15 over k ascending, each step rounded: compare_kernels' fp64 probe
// holds it against __fma_rn chains on integer, random, tie-breaking and
// byte-times-weight tiles.
__device__ __forceinline__ void mma16(double (&d)[4], const double (&a)[8],
                                      const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Byte c of the word v as the subnormal double v x 2^-1074, from its bits:
// no f64 instruction. Pass 1's weights are staged times kWideScale = 2^946,
// so each product is the byte's product by its weight times 2^-128, exactly
// (8 + 24 bits), and every partial sum is the plain version's times 2^-128:
// a nonzero one is a multiple of 2^-149 (an f32 weight's least bit) before
// scaling, so it stays far above the subnormal range, where rounding commutes
// with a power of two; the sum times kUnscale is the plain version's sum.
// The products take subnormal operands whole (compare_kernels' fp64 probe,
// the subnormal tiles).
constexpr double kWideScale = 0x1p946;
constexpr double kUnscale = 0x1p128;

__device__ __forceinline__ double byte_subnormal(unsigned v, int c) {
  return __hiloint2double(0, (int)__byte_perm(v, 0, 0x4440 + c));
}

// The 8 bytes from byte b of an input row p of nb bytes: one 8-byte load
// where the slot's rows start 8-byte aligned and nb is a multiple of 8
// (WIDE), else a byte load a byte; bytes past nb read 0.
template <bool WIDE>
__device__ __forceinline__ uint2 load8(const uint8_t* p, int b, int nb) {
  if (WIDE)
    return b < nb ? __ldg(reinterpret_cast<const uint2*>(p + b))
                  : make_uint2(0u, 0u);
  unsigned v[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (b + i < nb) v[i >> 2] |= (unsigned)__ldg(p + b + i) << (8 * (i & 3));
  return make_uint2(v[0], v[1]);
}

// Pass 1 of a band CTA whose slot changes its height, on the tensor cores:
// its output rows over the nb = W x C bytes of an input row (every channel
// alike), a warp 64 bytes at a time, as kTiles = 4 products of 16 bytes (A's
// rows) by 16 input rows (k) by 8 output rows (B's columns). Lane (g, q)
// loads its 8 bytes at 8 g of input rows q + 4 i of each step of kStep band
// rows once (a step ahead of the products, kPrefetch steps ahead into L2),
// widens each byte once (byte_subnormal), and takes output row g's staged
// weights (times kWideScale) of those input rows (0 outside the row's run,
// and for rows past the CTA's). Each output's sum runs over its band's
// inputs in ascending order from 0, one rounding a step, as the plain
// version's does (the zero weights add nothing), and is rounded to f32 once.
// Byte 8 g + 2 t + h of a warp's 64 is row g + 8 h of product t. Rows go to
// the line (pitch floats a row, byte i of the input row at float i) where W
// changes, else to the output as bytes.
template <bool WIDE>
__device__ __forceinline__ void band_pass1(const Slot& s, uint8_t* out,
                                           long long out_row,
                                           long long out_pitch, int rows,
                                           int nb, const double* wt, int lo,
                                           int span, float* line, int pitch) {
  constexpr int kTiles = 4, kBytes = 16 * kTiles;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int last = s.v.n - 1, steps = span / kStep;
  const bool horiz = s.h.start != nullptr;
  for (int tile = threadIdx.x >> 5; tile < (nb + kBytes - 1) / kBytes;
       tile += kBandThreads / 32) {
    const int b = tile * kBytes + g * 2 * kTiles;
    double d[kTiles][4] = {};
    uint2 nxt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      nxt[i] = load8<WIDE>(
          s.src + (long long)min(lo + q + 4 * i, last) * s.row, b, nb);
    for (int st = 0; st < steps; ++st) {
      // rows kPrefetch steps ahead into L2 (a 64-byte piece each, a lane a
      // row), so that the loads a step ahead find them there
      if (lane < kStep && st + kPrefetch < steps)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            s.src + (long long)min(lo + (st + kPrefetch) * kStep + lane,
                                   last) * s.row + tile * kBytes));
      uint2 cur[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
      if (st + 1 < steps) {
        const int i0 = lo + (st + 1) * kStep + q;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          nxt[i] = load8<WIDE>(
              s.src + (long long)min(i0 + 4 * i, last) * s.row, b, nb);
      }
      // the step's weights are staged so that lane q's four, of input rows
      // q + 4 i, are contiguous
      double bw[4] = {0.0, 0.0, 0.0, 0.0};
      if (g < rows) {
        const double2* wp = reinterpret_cast<const double2*>(
            wt + g * span + st * kStep + q * 4);
        const double2 x = wp[0], y = wp[1];
        bw[0] = x.x;
        bw[1] = x.y;
        bw[2] = y.x;
        bw[3] = y.y;
      }
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        double av[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int byte = 2 * t + (v & 1);
          av[v] = byte_subnormal(byte < 4 ? cur[v >> 1].x : cur[v >> 1].y,
                                 byte & 3);
        }
        mma16(d[t], av, bw);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * q + e;
      if (r >= rows) continue;
      float f[2 * kTiles];
#pragma unroll
      for (int j = 0; j < 2 * kTiles; ++j)
        f[j] = __double2float_rn(
            __dmul_rn(d[j >> 1][2 * (j & 1) + e], kUnscale));
      if (horiz && b + 2 * kTiles <= nb) {
        float4* lp = reinterpret_cast<float4*>(line + r * pitch + b);
        lp[0] = make_float4(f[0], f[1], f[2], f[3]);
        lp[1] = make_float4(f[4], f[5], f[6], f[7]);
        continue;
      }
#pragma unroll
      for (int j = 0; j < 2 * kTiles; ++j) {
        if (b + j >= nb) break;
        if (horiz)
          line[r * pitch + b + j] = f[j];
        else
          store<false>(out, out_row + r * out_pitch + b + j, 0, f[j], Norm{});
      }
    }
  }
}

// Pass 1 of a band CTA whose slot keeps its height: its rows' bytes, to the
// line as floats where W changes, else to the output as they are.
__device__ __forceinline__ void band_copy(const Slot& s, uint8_t* out,
                                          long long out_row,
                                          long long out_pitch, int y0,
                                          int rows, int nb, float* line,
                                          int pitch) {
  for (int i = threadIdx.x; i < rows * nb; i += kBandThreads) {
    const int r = i / nb, b = i - r * nb;
    const uint8_t v = __ldg(s.src + (long long)(y0 + r) * s.row + b);
    if (s.h.start)
      line[r * pitch + b] = (float)v;
    else
      out[out_row + r * out_pitch + b] = v;
  }
}

// Pass 2's table for one slot: output columns in groups of kGroup (a
// product's n), group g reading 16 steps input columns from start[g] (the
// union of its columns' runs, moved left where it would pass the image's
// last column, read clamped to it where the image is narrower than that),
// its f32 weights in the order a product's B takes them: w[((g * steps + s)
// * 32 + l) * 4 + v] is the weight of column g * kGroup + l / 4 for input
// start[g] + 16 s + l % 4 + 4 v, 0 outside that column's run. 24 bytes, as
// ops.cuda_resize lays it out.
struct Group {
  const int* start;
  const float* w;
  long long steps;
};

struct Groups {
  Group g[kMaxSlots];
};

// Pass 2 of a band CTA, on the tensor cores: a warp a group of kGroup output
// columns for every (row, channel) pair of the CTA, as products of 16 pairs
// (A's rows, two products an item) by 16 steps of the group's window (k) by
// the group's columns (B's). Lane (g, q) loads line values of its pairs g +
// 8 h at window steps q + 4 i and converts each to double once, and its four
// f32 weights of each step (B, one step ahead) once; each output's sum runs
// over the window in ascending order from 0, one rounding a step (the zero
// weights add nothing), then to f32, rounded half to even and clipped.
__device__ __forceinline__ void band_pass2(const Group& g, uint8_t* out,
                                           long long out_row, int w, int rows,
                                           int ch, int W, const float* line,
                                           int pitch) {
  const int lane = threadIdx.x & 31, gl = lane >> 2, q = lane & 3;
  const int steps = (int)g.steps, pairs = rows * ch;
  const int halves = (pairs + 31) / 32;          // items a group
  const long long out_pitch = (long long)w * ch;
  const int items = (w + kGroup - 1) / kGroup * halves;
  for (int item = threadIdx.x >> 5; item < items; item += kBandThreads / 32) {
    const int gi = item / halves, m0 = (item - gi * halves) * 32;
    const int first = __ldg(g.start + gi);
    const bool two = m0 + 16 < pairs;            // the item's second product
    int off[2][2];                               // line offsets of A's rows
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(m0 + 16 * t + gl + 8 * h, pairs - 1);
        const int r = m / ch;
        off[t][h] = r * pitch + m - r * ch;
      }
    const float4* wp = reinterpret_cast<const float4*>(g.w) +
                       (long long)gi * steps * 32 + lane;
    double d[2][4] = {};
    float4 nxt = __ldg(wp);
    for (int s = 0; s < steps; ++s) {
      const float4 bf = nxt;
      if (s + 1 < steps) nxt = __ldg(wp + (s + 1) * 32);
      const double b[4] = {(double)bf.x, (double)bf.y, (double)bf.z,
                           (double)bf.w};
      int at[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        at[i] = min(first + s * kStep + q + 4 * i, W - 1) * ch;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t && !two) break;
        double a[8];
#pragma unroll
        for (int v = 0; v < 8; ++v)
          a[v] = (double)line[off[t][v & 1] + at[v >> 1]];
        mma16(d[t], a, b);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + 16 * t + gl + 8 * (v >> 1);
        const int j = gi * kGroup + 2 * q + (v & 1);
        if (m >= pairs || j >= w) continue;
        const int r = m / ch;
        store<false>(out, out_row + r * out_pitch + (long long)j * ch + m -
                              r * ch,
                     0, __double2float_rn(d[t][v]), Norm{});
      }
  }
}

// Grid (ceil(h / rows_cta), N): output rows rows_cta * blockIdx.x on of slot
// blockIdx.y, rows_cta <= kBandRows (launch_band). Dynamic shared memory:
// rows_cta x vk doubles (vk, a multiple of kStep, the most input rows the
// runs of rows_cta output rows of a slot span, rounded up) for the rows'
// weights, then rows_cta lines of pitch floats (a multiple of 4 past the
// widest changing W x ch, so rows start 16 bytes apart round the banks).
__global__ void __launch_bounds__(kBandThreads, 1)
    resize_band_kernel(const __grid_constant__ Slots slots,
                       const __grid_constant__ Groups groups,
                       uint8_t* __restrict__ out, int h, int w, int ch,
                       int rows_cta, int vk, int pitch) {
  extern __shared__ float4 smem4[];              // 16-byte aligned
  double* wt = reinterpret_cast<double*>(smem4);
  float* line = reinterpret_cast<float*>(wt + rows_cta * vk);
  const Slot& s = slots.s[blockIdx.y];
  const int y0 = blockIdx.x * rows_cta, rows = min(rows_cta, h - y0);
  const int nb = s.h.n * ch;
  const long long out_pitch = (long long)w * ch;
  const long long out_row = ((long long)blockIdx.y * h + y0) * out_pitch;
  if (s.v.start) {
    // the rows' runs, the input rows they span, and each row's weight for
    // each of them (0 outside its run), input row lo + 16 j + i % 4 * 4 + i
    // / 4 at place 16 j + i, so that band_pass1's lane q reads its four of a
    // step together
    int st[kBandRows], ct[kBandRows], hi = 0, lo = INT_MAX;
#pragma unroll
    for (int r = 0; r < kBandRows; ++r) {
      st[r] = r < rows ? __ldg(s.v.start + y0 + r) : 0;
      ct[r] = r < rows ? __ldg(s.v.count + y0 + r) : 0;
      if (ct[r]) {
        lo = min(lo, st[r]);
        hi = max(hi, st[r] + ct[r]);
      }
    }
    lo = min(lo, hi);
    const int span = (hi - lo + kStep - 1) / kStep * kStep;
    for (int i = threadIdx.x; i < rows * span; i += kBandThreads) {
      const int r = i / span, j = i - r * span;
      int sr = 0, cr = 0;
#pragma unroll
      for (int q = 0; q < kBandRows; ++q)
        if (r == q) {
          sr = st[q];
          cr = ct[q];
        }
      const int at = lo + (j & ~15) + (j & 3) * 4 + ((j >> 2) & 3) - sr;
      wt[i] = (unsigned)at < (unsigned)cr
                  ? __dmul_rn(__ldg(s.v.w + (long long)(y0 + r) * s.v.k + at),
                              kWideScale)
                  : 0.0;
    }
    __syncthreads();
    if (((uintptr_t)s.src & 7) == 0 && (s.row & 7) == 0 && (nb & 7) == 0)
      band_pass1<true>(s, out, out_row, out_pitch, rows, nb, wt, lo, span,
                       line, pitch);
    else
      band_pass1<false>(s, out, out_row, out_pitch, rows, nb, wt, lo, span,
                        line, pitch);
  } else {
    band_copy(s, out, out_row, out_pitch, y0, rows, nb, line, pitch);
  }
  if (!s.h.start) return;
  __syncthreads();
  band_pass2(groups.g[blockIdx.y], out, out_row, w, rows, ch, s.h.n, line,
             pitch);
}

// K16 by nearest: a thread writes the 16 output bytes from byte 16 x its
// index of the (N, h, w, ch) output, each the byte of its slot's input pixel
// (start_v[y], start_h[x]) (y or x itself where the axis keeps its size).
// WORD: every slot has four channels and 4-byte aligned pixels, so the 16
// bytes are four whole pixels, each one 32-bit load; else a byte load a
// channel. The output is 16-byte aligned (launch), so the bytes are one store
// but at the end of the output.
__device__ __forceinline__ const uint8_t* kept_pixel(const Slots& slots,
                                                     int k, int y, int x,
                                                     int ch) {
  const Slot& s = slots.s[k];
  const int sy = s.v.start ? __ldg(s.v.start + y) : y;
  const int sx = s.h.start ? __ldg(s.h.start + x) : x;
  return s.src + (long long)sy * s.row + (long long)sx * ch;
}

template <bool WORD>
__global__ void __launch_bounds__(kThreads)
    resize_gather_kernel(const __grid_constant__ Slots slots, int n, int ch,
                         uint8_t* __restrict__ out, int h, int w) {
  const long long hw = (long long)h * w, total = hw * n * ch;
  const long long o = ((long long)blockIdx.x * kThreads + threadIdx.x) * 16;
  if (o >= total) return;
  const int nb = (int)min(16LL, total - o);
  int c, k, y, x;                                // the first byte's place
  if (total <= 0xFFFFFFFFLL) {                   // 32-bit divisions
    const unsigned o32 = (unsigned)o, p = o32 / ch, hw32 = (unsigned)hw;
    c = (int)(o32 - p * ch);
    k = (int)(p / hw32);
    const unsigned rem = p - k * hw32;
    y = (int)(rem / w);
    x = (int)(rem - y * w);
  } else {
    const long long p = o / ch;
    c = (int)(o - p * ch);
    k = (int)(p / hw);
    const long long rem = p - k * hw;
    y = (int)(rem / w);
    x = (int)(rem - (long long)y * w);
  }
  unsigned word[4] = {0u, 0u, 0u, 0u};
  if (WORD) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (4 * i < nb)
        word[i] = __ldg(reinterpret_cast<const unsigned*>(
            kept_pixel(slots, k, y, x, 4)));
      if (++x == w) {
        x = 0;
        if (++y == h) {
          y = 0;
          ++k;
        }
      }
    }
  } else {
    const uint8_t* px = kept_pixel(slots, k, y, x, ch);
    for (int i = 0; i < nb; ++i) {
      word[i >> 2] |= (unsigned)__ldg(px + c) << (8 * (i & 3));
      if (++c == ch) {
        c = 0;
        if (++x == w) {
          x = 0;
          if (++y == h) {
            y = 0;
            ++k;
          }
        }
        if (i + 1 < nb) px = kept_pixel(slots, k, y, x, ch);
      }
    }
  }
  if (nb == 16) {
    *reinterpret_cast<uint4*>(out + o) =
        make_uint4(word[0], word[1], word[2], word[3]);
  } else {
    for (int i = 0; i < nb; ++i)
      out[o + i] = (uint8_t)(word[i >> 2] >> (8 * (i & 3)));
  }
}

constexpr size_t kMaxSmem = 232448;   // a CTA's most on sm_90, all dynamic

// A CTA's dynamic shared memory at `rows` output rows: their weights over
// vk input rows, then their lines.
size_t smem_bytes(int rows, int vk, int line_w, int ch) {
  return (size_t)rows * vk * sizeof(double) +
         (size_t)rows * line_w * ch * sizeof(float);
}

template <bool NORM, int ROWS>
int launch_rows(const Slots& p, int n, int cin, void* out, int h, int w,
                int ch, int vk, size_t smem, Norm nm, cudaStream_t st) {
  auto kernel = resize_kernel<NORM, ROWS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((unsigned)((h + ROWS - 1) / ROWS), (unsigned)n), kThreads,
           smem, st>>>(p, cin, out, h, w, ch, vk, nm);
  return (int)cudaGetLastError();
}

// slots: n <= kMaxSlots Slot descriptors in host memory; line_w: the
// most W of a slot whose W changes (0 if none); vk: the most input rows
// the runs of kRows output rows of a slot span (at least those of one).
// kRows output rows a CTA where their lines fit shared memory, else one,
// so a slot as wide as one row's line allows (about 14,400 RGBA pixels)
// still takes a launch. The weights take ROWS x vk doubles beside the
// lines: 1,024 bytes at lanczos5's widest band from 1080 to 224 (53 input
// rows, 64 once rounded to kBatch), against 61,440 bytes of lines at 1920
// RGBA. *picked (where given): the rows a CTA that the launch took.
template <bool NORM>
int launch(const void* slots, int n, int cin, void* out, int h, int w,
           int ch, int line_w, int vk, Norm nm, int* picked,
           cudaStream_t st) {
  if (n <= 0 || n > kMaxSlots || h <= 0 || w <= 0 || ch <= 0 || ch > cin ||
      line_w < 0 || vk < 0)
    return (int)cudaErrorInvalidValue;
  vk = (vk + kBatch - 1) / kBatch * kBatch;
  Slots p;
  memcpy(p.s, slots, (size_t)n * sizeof(Slot));
  size_t smem = smem_bytes(kRows, vk, line_w, ch);
  const bool two = smem + 1024 <= kMaxSmem;
  if (picked) *picked = two ? kRows : 1;
  if (two)
    return launch_rows<NORM, kRows>(p, n, cin, out, h, w, ch, vk, smem, nm,
                                    st);
  smem = smem_bytes(1, vk, line_w, ch);
  if (smem + 1024 > kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch_rows<NORM, 1>(p, n, cin, out, h, w, ch, vk, smem, nm, st);
}

// A band CTA's dynamic shared memory at `rows` output rows: their weights
// over vk input rows, then their lines of pitch floats.
size_t band_smem(int rows, int vk, int pitch) {
  return (size_t)rows * vk * sizeof(double) +
         (size_t)rows * pitch * sizeof(float);
}

int launch_band_rows(const Slots& p, const Groups& g, int n, void* out,
                     int h, int w, int ch, int rows, int vk, int pitch,
                     cudaStream_t st) {
  const size_t smem = band_smem(rows, vk, pitch);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        resize_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  resize_band_kernel<<<dim3((unsigned)((h + rows - 1) / rows), (unsigned)n),
                       kBandThreads, smem, st>>>(
      p, g, static_cast<uint8_t*>(out), h, w, ch, rows, vk, pitch);
  return (int)cudaGetLastError();
}

// spans[r - 1]: the most input rows the runs of r output rows of a slot span
// (r = 1 .. kBandSpans; a CTA's rows start at multiples of r). The rows a CTA
// are the most, up to kBandRows, whose weights and lines fit shared memory,
// cut to about h x n over the SMs where the launch is small, so that its CTAs
// spread over the card, and never under 2. Where 2 rows do not fit (RGBA
// about 7,200 pixels wide or wider), the launch takes the banded kernel's
// resize<0,1> instead, as every method did before. *rows: the rows a CTA of
// resize_band, or 0 where the launch took resize<0,1>.
int launch_band(const void* slots, const void* groups, int n, int cin,
                void* out, int h, int w, int ch, int line_w,
                const int* spans, int* rows, cudaStream_t st) {
  if (n <= 0 || n > kMaxSlots || h <= 0 || w <= 0 || ch <= 0 || ch != cin ||
      line_w < 0 || !spans)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < kBandRows; ++r)
    if (spans[r] < 0) return (int)cudaErrorInvalidValue;
  Slots p;
  memcpy(p.s, slots, (size_t)n * sizeof(Slot));
  const int pitch = line_w ? (line_w * ch + 3) / 4 * 4 + 4 : 0;
  auto vk_of = [&](int r) { return (spans[r - 1] + kStep - 1) / kStep *
                                   kStep; };
  int fit = 0;
  while (fit < kBandRows &&
         band_smem(fit + 1, vk_of(fit + 1), pitch) + 1024 <= kMaxSmem)
    ++fit;
  if (fit < 2) {
    if (rows) *rows = 0;
    const int vk = (spans[0] + kBatch - 1) / kBatch * kBatch;
    const size_t smem = smem_bytes(1, vk, line_w, ch);
    if (smem + 1024 > kMaxSmem) return (int)cudaErrorInvalidValue;
    return launch_rows<false, 1>(p, n, cin, out, h, w, ch, vk, smem, Norm{},
                                 st);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long spread = ((long long)h * n + sms - 1) / sms;
  const int r = spread >= fit ? fit : spread <= 2 ? 2 : (int)spread;
  if (rows) *rows = r;
  Groups g;
  memcpy(g.g, groups, (size_t)n * sizeof(Group));
  return launch_band_rows(p, g, n, out, h, w, ch, r, vk_of(r), pitch, st);
}

// Four channels and every slot's pixels 4-byte aligned: 32-bit loads.
bool word_slots(const Slots& p, int n, int cin) {
  bool word = cin == 4;
  for (int k = 0; word && k < n; ++k)
    word = ((uintptr_t)p.s[k].src & 3) == 0 && (p.s[k].row & 3) == 0;
  return word;
}

// *picked (where given): 1 where the launch took 32-bit loads, else 0.
int launch_gather(const void* slots, int n, int ch, void* out, int h, int w,
                  int* picked, cudaStream_t st) {
  if (n <= 0 || n > kMaxSlots || h <= 0 || w <= 0 || ch <= 0 ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Slots p;
  memcpy(p.s, slots, (size_t)n * sizeof(Slot));
  const long long total = (long long)n * h * w * ch;
  const long long blocks = (total + 16LL * kThreads - 1) / (16LL * kThreads);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool word = word_slots(p, n, ch);
  if (picked) *picked = word;
  if (word)
    resize_gather_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        p, n, ch, static_cast<uint8_t*>(out), h, w);
  else
    resize_gather_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        p, n, ch, static_cast<uint8_t*>(out), h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// slots: n <= 64 Slot descriptors (ops.cuda_resize) in host memory,
// pixels of c uint8 channels; out: contiguous (n, h, w, c) uint8; rows:
// set to the output rows a CTA that the launch took (resize<0,rows>).
int ffpic_resize_rgba(const void* slots, int n, int c, void* out, int h,
                      int w, int line_w, int vk, int* rows, void* stream) {
  return launch<false>(slots, n, c, out, h, w, c, line_w, vk, Norm{}, rows,
                       (cudaStream_t)stream);
}

// K16 by cubic and Lanczos: slots as above; groups: n Group entries (pass 2's
// tables of the slots, of kGroup columns a group, null where W does not
// change) in host memory; spans: kBandSpans ints (launch_band); rows: set to
// the output rows a CTA of resize_band, or 0 where the launch took
// resize<0,1>.
int ffpic_resize_band(const void* slots, const void* groups, int n, int c,
                      void* out, int h, int w, int line_w, const int* spans,
                      int* rows, void* stream) {
  return launch_band(slots, groups, n, c, out, h, w, c, line_w, spans, rows,
                     (cudaStream_t)stream);
}

// K16 by nearest: slots as above (their weights unread), pixels of c
// uint8 channels; out: contiguous (n, h, w, c) uint8, 16-byte aligned;
// word: set to 1 where the launch took 32-bit loads (resize_gather<word>).
int ffpic_resize_nearest(const void* slots, int n, int c, void* out, int h,
                         int w, int* word, void* stream) {
  return launch_gather(slots, n, c, out, h, w, word, (cudaStream_t)stream);
}

// slots as above, pixels of cin >= 3 uint8 channels; out: contiguous
// (n, h, w, 3) f32; mean, std: 3 floats each on the host.
int ffpic_normalize_resize(const void* slots, int n, int cin, void* out,
                           int h, int w, int line_w, int vk,
                           const float* mean, const float* std,
                           void* stream) {
  Norm nm;
  for (int c = 0; c < 3; ++c) {
    nm.mean[c] = mean[c];
    nm.std[c] = std[c];
  }
  return launch<true>(slots, n, cin, out, h, w, 3, line_w, vk, nm, nullptr,
                      (cudaStream_t)stream);
}

}  // extern "C"
