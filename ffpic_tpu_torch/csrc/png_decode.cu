// PNG decode kernels for Hopper (sm_90a): the device half of
// ffpic_tpu_torch.formats.png.to_pic.
//
//   K6 unfilter_subup  rows whose filters are all None/Sub/Up -> the
//                      reconstructed scanlines, (H, stride) uint8 at a
//                      16-byte-aligned row pitch; two launches, a row
//                      pass (Sub) and a column pass (Up)
//   K7 assemble_rgba   reconstructed scanlines -> (H, W, 4) uint8 RGBA:
//                      sample unpack (1/2/4/8/16 bits), palette, tRNS,
//                      scaling to 8 bits
//
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError(). All
// arithmetic is integer and follows the JAX reference exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// K6. Replaces ffpic_tpu/ops/png_kernels.py:unfilter_device_subup (:89).
// Bound: it reads the filtered bytes once and writes the reconstructed
// ones once (16.6 MB for a 1920x1080 RGBA image), so it is memory-bound;
// the adds are nothing. Both passes are scans, which is what keeps it
// far from that bound.
//
// Both passes read the rows as the file has them, each row's filter type
// in its first byte, so the tags need no array of their own.
//
// Row pass: a warp per row. A row that is not Sub is copied (32 bytes a
// warp step). A Sub row is a cumulative sum mod 256 over its BPP lanes:
// each lane takes a run of C bytes (C a multiple of BPP, 32 C >= the
// row), sums each lane class of its run, the warp scans those sums
// (BPP bytes packed in two words, added byte by byte with __vadd4, which
// wraps each byte mod 256 as the reference's & 255 does), and each lane
// then rescans its run from its carry, in uint8 arithmetic.
//
// Column pass: a thread per 32-bit word of the output row pitch walks
// the rows with the running value in a register: an Up row adds the
// row above (four bytes at once, __vadd4), any other row restarts the
// chain with its row-pass bytes. kColRows rows (words and tags) are
// loaded ahead so that each thread keeps that many loads in flight: the
// walk is a chain of ceil(H / kColRows) round trips to memory. Only
// 1,920 threads at 1080p RGBA: latency-bound, far from the byte bound; a
// row-chunked carry pass would raise the parallelism.
constexpr int kRowWarps = 4;
constexpr int kColThreads = 128;
constexpr int kColRows = 32;

template <int BPP>
__global__ void __launch_bounds__(32 * kRowWarps)
    unfilter_rows_kernel(const uint8_t* __restrict__ src, long long src_pitch,
                         uint8_t* __restrict__ dst, long long dst_pitch,
                         int h, int stride) {
  const int lane = threadIdx.x & 31;
  const long long y = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (y >= h) return;
  const uint8_t* s = src + y * src_pitch + 1;   // past the filter tag
  uint8_t* d = dst + y * dst_pitch;
  if (__ldg(s - 1) != 1) {
    for (int i = lane; i < stride; i += 32) d[i] = __ldg(s + i);
    return;
  }
  const int per = (stride + 31) / 32;
  const int run = (per + BPP - 1) / BPP * BPP;
  const int lo = min(lane * run, stride);
  const int hi = min(lo + run, stride);
  unsigned tot[BPP];
#pragma unroll
  for (int k = 0; k < BPP; ++k) tot[k] = 0;
  for (int i = lo; i < hi; i += BPP) {
#pragma unroll
    for (int k = 0; k < BPP; ++k)
      if (i + k < hi) tot[k] += __ldg(s + i + k);
  }
  unsigned w[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < BPP; ++k) w[k >> 2] |= (tot[k] & 255u) << (8 * (k & 3));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned a0 = __shfl_up_sync(0xffffffffu, w[0], o);
    const unsigned a1 = __shfl_up_sync(0xffffffffu, w[1], o);
    if (lane >= o) {
      w[0] = __vadd4(w[0], a0);
      w[1] = __vadd4(w[1], a1);
    }
  }
  // exclusive: the lanes below this one
  unsigned c0 = __shfl_up_sync(0xffffffffu, w[0], 1);
  unsigned c1 = __shfl_up_sync(0xffffffffu, w[1], 1);
  if (lane == 0) c0 = c1 = 0;
  uint8_t acc[BPP];
#pragma unroll
  for (int k = 0; k < BPP; ++k)
    acc[k] = (uint8_t)(((k < 4 ? c0 : c1) >> (8 * (k & 3))) & 255u);
  for (int i = lo; i < hi; i += BPP) {
#pragma unroll
    for (int k = 0; k < BPP; ++k) {
      if (i + k < hi) {
        acc[k] = (uint8_t)(acc[k] + __ldg(s + i + k));
        d[i + k] = acc[k];
      }
    }
  }
}

__global__ void __launch_bounds__(kColThreads)
    unfilter_cols_kernel(const uint8_t* __restrict__ src, long long src_pitch,
                         uint8_t* dst, long long pitch_words, int h,
                         int words) {
  const int t = blockIdx.x * kColThreads + threadIdx.x;
  if (t >= words) return;
  unsigned* col = reinterpret_cast<unsigned*>(dst) + t;
  unsigned v = 0;
  for (int y0 = 0; y0 < h; y0 += kColRows) {
    unsigned w[kColRows];
    int f[kColRows];
#pragma unroll
    for (int r = 0; r < kColRows; ++r) {
      const int y = y0 + r;
      f[r] = y < h ? __ldg(src + (long long)y * src_pitch) : 0;
      w[r] = y < h ? col[(long long)y * pitch_words] : 0u;
    }
#pragma unroll
    for (int r = 0; r < kColRows; ++r) {
      if (f[r] == 2) {
        v = __vadd4(v, w[r]);
        col[(long long)(y0 + r) * pitch_words] = v;
      } else {
        v = w[r];
      }
    }
  }
}

template <int BPP>
void launch_unfilter_rows(const uint8_t* src, long long src_pitch,
                          uint8_t* dst, long long dst_pitch, int h,
                          int stride, cudaStream_t st) {
  unfilter_rows_kernel<BPP>
      <<<(unsigned)((h + kRowWarps - 1) / kRowWarps), 32 * kRowWarps, 0, st>>>(
          src, src_pitch, dst, dst_pitch, h, stride);
}

// K7. Replaces ffpic_tpu/ops/png_kernels.py:assemble_rgba (:40) with the
// unpack_samples (:21) it calls. Bound: it reads the reconstructed bytes
// once and writes 4 bytes a pixel (8.3 + 8.3 MB for 1920x1080 RGBA), so
// it is memory-bound; the ops are a few integer ones a sample. On 8-bit
// RGBA the function is a copy, which a device copy runs with 16-byte
// accesses; the design below makes K7 one too.
//
// A thread takes a group of four output pixels (16 bytes), kRgbaUnroll
// groups at a time (all their loads issued before any store), in a
// grid-stride loop over a grid of at most kRgbaCtasPerSm CTAs an SM
// (on the H100, 2-16 CTAs an SM and 1-4 groups a thread time alike at
// 1080p; PERF.md). When the rows are contiguous (the pitch is the row's bytes, no padding bits)
// the launcher views the image as one row of h * w pixels: no group
// crosses a row and no division finds one; otherwise a group is (row,
// four columns), the row found by a 32-bit division. A full group of
// byte-sized samples (BD 8 and 16) loads its 4 * BPP input bytes as
// words, as wide as the rows' alignment allows (the launcher passes it):
// uint4 for 4 and 8 bytes a pixel (8-bit RGBA, 16-bit gray + alpha and
// RGBA), uint2 for 2 and 6, 32-bit words for 1 and 3, and on a row at an
// odd address the 16-byte chunks around the group, shifted into place;
// for 8-bit RGBA the words are the pixels. A group cut by
// the row's end, and sub-byte samples (MSB first), read sample by
// sample. The four pixels go out as one uint4 store where the output is
// 16-byte aligned (every full group of a contiguous image), else as
// 32-bit stores. The palette (its RGBA words with the tRNS alpha folded
// in on the host) goes by value only to colour type 3, staged in shared
// memory for the gather; the colour key (the tRNS of gray and
// truecolour, compared on the samples before scaling, as the reference
// does) only to colour types 0 and 2; the other instances take no table.
constexpr int kRgbaThreads = 256;
constexpr int kRgbaCtasPerSm = 4;
constexpr int kRgbaUnroll = 2;       // groups a thread loads at once

template <int CT>
struct RgbaTables {};                // the instances that read no table
template <>
struct RgbaTables<3> {
  uint32_t pal[256];                 // RGBA words, little-endian, tRNS alpha
};
template <>
struct RgbaTables<0> {
  int key[3];                        // the colour key; key[0] < 0: none
};
template <>
struct RgbaTables<2> {
  int key[3];
};

template <int CT>
constexpr int kChannels = CT == 0 || CT == 3 ? 1 : CT == 4 ? 2 : CT == 2 ? 3 : 4;

template <int BD>
__device__ __forceinline__ unsigned sample(const uint8_t* row, long long s) {
  if (BD == 8) return __ldg(row + s);
  if (BD == 16)
    return ((unsigned)__ldg(row + 2 * s) << 8) | __ldg(row + 2 * s + 1);
  const long long bit = s * BD;
  return ((unsigned)__ldg(row + (bit >> 3)) >> (8 - BD - (int)(bit & 7))) &
         ((1u << BD) - 1u);
}

template <int BD>
__device__ __forceinline__ unsigned scale8(unsigned v) {
  if (BD == 16) return v >> 8;
  if (BD == 8) return v;
  return v * 255u / ((1u << BD) - 1u);
}

__device__ __forceinline__ unsigned rgba(unsigned r, unsigned g, unsigned b,
                                         unsigned a) {
  return r | (g << 8) | (b << 16) | (a << 24);
}

// one pixel from its samples s(0..channels-1), unscaled
template <int CT, int BD, class S>
__device__ __forceinline__ uint32_t to_rgba(S s, const uint32_t* pal,
                                            const RgbaTables<CT>& t) {
  if constexpr (CT == 3) {
    return pal[s(0)];
  } else if constexpr (CT == 0) {
    const unsigned v = s(0), g = scale8<BD>(v);
    return rgba(g, g, g, t.key[0] >= 0 && v == (unsigned)t.key[0] ? 0u : 255u);
  } else if constexpr (CT == 4) {
    const unsigned g = scale8<BD>(s(0));
    return rgba(g, g, g, scale8<BD>(s(1)));
  } else if constexpr (CT == 2) {
    const unsigned r = s(0), g = s(1), b = s(2);
    const bool hit = t.key[0] >= 0 && r == (unsigned)t.key[0] &&
                     g == (unsigned)t.key[1] && b == (unsigned)t.key[2];
    return rgba(scale8<BD>(r), scale8<BD>(g), scale8<BD>(b), hit ? 0u : 255u);
  } else {
    return rgba(scale8<BD>(s(0)), scale8<BD>(s(1)), scale8<BD>(s(2)),
                scale8<BD>(s(3)));
  }
}

// a full group's 4 * BPP input bytes at p as BPP little-endian words, in
// loads as wide as p's alignment al (16, 8, 4 or 1) allows
template <int BPP>
__device__ __forceinline__ void load_group(const uint8_t* p, int al,
                                           uint32_t (&w)[BPP]) {
  constexpr int kWide = (4 * BPP) % 16 == 0 ? 16 : (4 * BPP) % 8 == 0 ? 8 : 4;
  if (kWide == 16 && al >= 16) {
#pragma unroll
    for (int i = 0; i < BPP / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if (kWide >= 8 && al >= 8) {
#pragma unroll
    for (int i = 0; i < BPP / 2; ++i) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = v.x;
      w[2 * i + 1] = v.y;
    }
  } else if (al >= 4) {
#pragma unroll
    for (int i = 0; i < BPP; ++i)
      w[i] = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
  } else {
    // a row at any byte: the 16-byte-aligned chunks that hold the
    // group's bytes (no other is read), the words from the group's
    // start selected (no indexing by a variable, which would put the
    // words in local memory) and funnel-shifted pairwise
    constexpr int kChunks = (4 * BPP + 15) / 16 + 1;
    const int r = (int)((uintptr_t)p & 15), q = r >> 2, sh = (r & 3) * 8;
    const uint4* a = reinterpret_cast<const uint4*>(p - r);
    uint32_t W[4 * kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint4 v =
          16 * c < r + 4 * BPP ? __ldg(a + c) : make_uint4(0u, 0u, 0u, 0u);
      W[4 * c] = v.x;
      W[4 * c + 1] = v.y;
      W[4 * c + 2] = v.z;
      W[4 * c + 3] = v.w;
    }
    uint32_t V[BPP + 1];
#pragma unroll
    for (int j = 0; j <= BPP; ++j)
      V[j] = q == 0 ? W[j] : q == 1 ? W[j + 1] : q == 2 ? W[j + 2] : W[j + 3];
#pragma unroll
    for (int i = 0; i < BPP; ++i) w[i] = __funnelshift_r(V[i], V[i + 1], sh);
  }
}

// the group of n <= 4 pixels from x0 of a row: px[0..n-1]
template <int CT, int BD>
__device__ __forceinline__ void group_pixels(const uint8_t* row, long long x0,
                                             int n, int al,
                                             const uint32_t* pal,
                                             const RgbaTables<CT>& t,
                                             uint32_t (&px)[4]) {
  constexpr int C = kChannels<CT>;
  if constexpr (BD >= 8) {
    if (n == 4) {
      constexpr int BPP = C * BD / 8;
      uint32_t w[BPP];
      load_group<BPP>(row + x0 * BPP, al, w);
      if constexpr (CT == 6 && BD == 8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) px[j] = w[j];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          auto s = [&](int c) -> unsigned {
            const int k = j * C + c;
            if (BD == 8) return (w[k >> 2] >> (8 * (k & 3))) & 255u;
            const int b = 2 * k;   // big-endian: bytes b, b + 1
            return (((w[b >> 2] >> (8 * (b & 3))) & 255u) << 8) |
                   ((w[(b + 1) >> 2] >> (8 * ((b + 1) & 3))) & 255u);
          };
          px[j] = to_rgba<CT, BD>(s, pal, t);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n) {
      const long long x = x0 + j;
      px[j] = to_rgba<CT, BD>(
          [&](int c) { return sample<BD>(row, x * C + c); }, pal, t);
    }
  }
}

__device__ __forceinline__ void store_group(uint32_t* o, int n,
                                            const uint32_t (&px)[4]) {
  if (n == 4 && ((uintptr_t)o & 15) == 0) {
    *reinterpret_cast<uint4*>(o) = make_uint4(px[0], px[1], px[2], px[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) o[j] = px[j];
  }
}

// recon: rows of cols pixels at pitch (one row of h * w pixels when the
// image is contiguous); groups = ceil(cols / 4) a row; al: the alignment
// of every row's start (16, 8, 4 or 1). Every group's loads go out
// before any store, kRgbaUnroll groups a thread at a time.
template <int CT, int BD>
__global__ void __launch_bounds__(kRgbaThreads)
    assemble_rgba_kernel(const uint8_t* __restrict__ recon, long long pitch,
                         uint32_t* __restrict__ out, long long cols, int rows,
                         long long groups, int al,
                         const __grid_constant__ RgbaTables<CT> t) {
  __shared__ uint32_t pal[CT == 3 ? 256 : 1];
  if constexpr (CT == 3) {
    for (int i = threadIdx.x; i < 256; i += kRgbaThreads) pal[i] = t.pal[i];
    __syncthreads();
  }
  const long long total = groups * rows;
  const long long stride = (long long)gridDim.x * kRgbaThreads;
  for (long long base = (long long)blockIdx.x * kRgbaThreads + threadIdx.x;
       base < total; base += stride * kRgbaUnroll) {
    uint32_t px[kRgbaUnroll][4];
    uint32_t* o[kRgbaUnroll];
    int n[kRgbaUnroll];
#pragma unroll
    for (int u = 0; u < kRgbaUnroll; ++u) {
      const long long it = base + u * stride;
      n[u] = 0;
      if (it >= total) continue;
      long long y = 0, g = it;
      if (rows > 1) {
        y = it < 0xffffffffLL ? (long long)((unsigned)it / (unsigned)groups)
                              : it / groups;
        g = it - y * groups;
      }
      const long long x0 = 4 * g;
      n[u] = cols - x0 < 4 ? (int)(cols - x0) : 4;
      o[u] = out + y * cols + x0;
      group_pixels<CT, BD>(recon + y * pitch, x0, n[u], al, pal, t, px[u]);
    }
#pragma unroll
    for (int u = 0; u < kRgbaUnroll; ++u)
      if (n[u]) store_group(o[u], n[u], px[u]);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <int CT, int BD>
int launch_assemble_rgba(const uint8_t* recon, long long pitch, uint32_t* out,
                         int w, int h, const RgbaTables<CT>& t,
                         cudaStream_t st) {
  // contiguous rows: one row of h * w pixels
  const bool flat = h == 1 || pitch * 8 == (long long)w * kChannels<CT> * BD;
  const long long cols = flat ? (long long)w * h : w;
  const int rows = flat ? 1 : h;
  const long long groups = (cols + 3) / 4;
  int al = 16;
  while (al > 1 && (((uintptr_t)recon % al) || (!flat && pitch % al)))
    al = al == 16 ? 8 : al == 8 ? 4 : 1;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long per_cta = (long long)kRgbaThreads * kRgbaUnroll;
  const long long need = (groups * rows + per_cta - 1) / per_cta;
  const long long cap = (long long)sms * kRgbaCtasPerSm;
  assemble_rgba_kernel<CT, BD>
      <<<(unsigned)(need < cap ? need : cap), kRgbaThreads, 0, st>>>(
          recon, pitch, out, cols, rows, groups, al, t);
  return (int)cudaGetLastError();
}

template <int CT, int BD>
int assemble_with_tables(const uint8_t* recon, long long pitch,
                         const uint8_t* palette, const int32_t* trns,
                         uint32_t* out, int w, int h, cudaStream_t st) {
  RgbaTables<CT> t;
  if constexpr (CT == 3) {
    for (int i = 0; i < 256; ++i) {
      const uint32_t a = trns[i] >= 0 ? (uint32_t)trns[i] & 255u : 255u;
      t.pal[i] = (uint32_t)palette[4 * i] |
                 ((uint32_t)palette[4 * i + 1] << 8) |
                 ((uint32_t)palette[4 * i + 2] << 16) | (a << 24);
    }
  } else if constexpr (CT == 0 || CT == 2) {
    for (int i = 0; i < 3; ++i) t.key[i] = trns[i];
  }
  return launch_assemble_rgba<CT, BD>(recon, pitch, out, w, h, t, st);
}

}  // namespace

extern "C" {

// src: h rows at src_pitch, each its filter type (0, 1 or 2) and then
// stride filtered bytes; dst: h rows at dst_pitch, a multiple of 4
// bytes, dst 4-byte aligned
int ffpic_unfilter_subup(const void* src, long long src_pitch, void* dst,
                         long long dst_pitch, int h, int stride, int bpp,
                         void* stream) {
  if (h <= 0 || stride <= 0 || src_pitch <= stride || dst_pitch < stride ||
      dst_pitch % 4 || ((uintptr_t)dst & 3))
    return (int)cudaErrorInvalidValue;
  const uint8_t* s = (const uint8_t*)src;
  uint8_t* d = (uint8_t*)dst;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bpp) {
    case 1: launch_unfilter_rows<1>(s, src_pitch, d, dst_pitch, h, stride, st); break;
    case 2: launch_unfilter_rows<2>(s, src_pitch, d, dst_pitch, h, stride, st); break;
    case 3: launch_unfilter_rows<3>(s, src_pitch, d, dst_pitch, h, stride, st); break;
    case 4: launch_unfilter_rows<4>(s, src_pitch, d, dst_pitch, h, stride, st); break;
    case 6: launch_unfilter_rows<6>(s, src_pitch, d, dst_pitch, h, stride, st); break;
    case 8: launch_unfilter_rows<8>(s, src_pitch, d, dst_pitch, h, stride, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int words = (int)((stride + 3) / 4);
  unfilter_cols_kernel<<<(unsigned)((words + kColThreads - 1) / kColThreads),
                         kColThreads, 0, st>>>(s, src_pitch, d, dst_pitch / 4,
                                               h, words);
  return (int)cudaGetLastError();
}

// recon: h rows at pitch; palette: 256 x 4 bytes and trns: 256 int32 on
// the host (read only by the instances that use them), passed by value;
// out: (h, w, 4) uint8, 4-byte aligned
int ffpic_assemble_rgba(const void* recon, long long pitch,
                        const void* palette, const void* trns, void* out,
                        int w, int h, int color_type, int bitdepth,
                        void* stream) {
  if (w <= 0 || h <= 0 || ((uintptr_t)out & 3)) return (int)cudaErrorInvalidValue;
  const uint8_t* r = (const uint8_t*)recon;
  const uint8_t* p = (const uint8_t*)palette;
  const int32_t* k = (const int32_t*)trns;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (color_type * 100 + bitdepth) {
    case 1: return assemble_with_tables<0, 1>(r, pitch, p, k, o, w, h, st);
    case 2: return assemble_with_tables<0, 2>(r, pitch, p, k, o, w, h, st);
    case 4: return assemble_with_tables<0, 4>(r, pitch, p, k, o, w, h, st);
    case 8: return assemble_with_tables<0, 8>(r, pitch, p, k, o, w, h, st);
    case 16: return assemble_with_tables<0, 16>(r, pitch, p, k, o, w, h, st);
    case 208: return assemble_with_tables<2, 8>(r, pitch, p, k, o, w, h, st);
    case 216: return assemble_with_tables<2, 16>(r, pitch, p, k, o, w, h, st);
    case 301: return assemble_with_tables<3, 1>(r, pitch, p, k, o, w, h, st);
    case 302: return assemble_with_tables<3, 2>(r, pitch, p, k, o, w, h, st);
    case 304: return assemble_with_tables<3, 4>(r, pitch, p, k, o, w, h, st);
    case 308: return assemble_with_tables<3, 8>(r, pitch, p, k, o, w, h, st);
    case 408: return assemble_with_tables<4, 8>(r, pitch, p, k, o, w, h, st);
    case 416: return assemble_with_tables<4, 16>(r, pitch, p, k, o, w, h, st);
    case 608: return assemble_with_tables<6, 8>(r, pitch, p, k, o, w, h, st);
    case 616: return assemble_with_tables<6, 16>(r, pitch, p, k, o, w, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
