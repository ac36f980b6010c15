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
// it is memory-bound; the ops are a few integer ones a sample.
//
// A thread per pixel, templated on (colour type, bit depth): it reads
// its samples straight from the packed row (sub-byte samples MSB first,
// 16-bit big-endian; for 8-bit RGBA rows that are 4-byte aligned one
// 32-bit load) and writes the pixel as one 32-bit store, so a warp
// writes 128 contiguous bytes. The palette (256 x 4 bytes) and the tRNS
// table (256 int32) come by value with the launch (a __grid_constant__
// parameter, 2 KB) and are staged in shared memory for the palette's
// gather; the colour key of gray and
// truecolour is compared on the samples before scaling, as in the
// reference. blockIdx.y walks the rows, looping past 65535.
constexpr int kRgbaThreads = 256;

struct PngTables {
  uint32_t pal[256];   // RGBA bytes, little-endian
  int32_t trns[256];   // per-index alpha, or the colour key in 0..2; -1 none
};

template <int BD>
__device__ __forceinline__ unsigned sample(const uint8_t* row, int s) {
  if (BD == 8) return __ldg(row + s);
  if (BD == 16)
    return ((unsigned)__ldg(row + 2 * s) << 8) | __ldg(row + 2 * s + 1);
  const int bit = s * BD;
  return ((unsigned)__ldg(row + (bit >> 3)) >> (8 - BD - (bit & 7))) &
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

template <int CT, int BD>
__global__ void __launch_bounds__(kRgbaThreads)
    assemble_rgba_kernel(const uint8_t* __restrict__ recon, long long pitch,
                         uint32_t* __restrict__ out, int w, int h,
                         bool aligned,
                         const __grid_constant__ PngTables tables) {
  __shared__ uint32_t pal[256];
  __shared__ int32_t trns[256];
  if (CT == 3) {
    pal[threadIdx.x] = tables.pal[threadIdx.x];
    trns[threadIdx.x] = tables.trns[threadIdx.x];
    __syncthreads();
  }
  const int x = blockIdx.x * kRgbaThreads + threadIdx.x;
  if (x >= w) return;
  for (long long y = blockIdx.y; y < h; y += gridDim.y) {
    const uint8_t* row = recon + y * pitch;
    unsigned px;
    if (CT == 3) {
      const unsigned i = sample<BD>(row, x);
      const int a = trns[i];
      px = (pal[i] & 0x00FFFFFFu) | ((unsigned)(a >= 0 ? a : 255) << 24);
    } else if (CT == 0) {
      const unsigned v = sample<BD>(row, x), g = scale8<BD>(v);
      const int key = tables.trns[0];
      px = rgba(g, g, g, key >= 0 && v == (unsigned)key ? 0u : 255u);
    } else if (CT == 4) {
      const unsigned g = scale8<BD>(sample<BD>(row, 2 * x));
      px = rgba(g, g, g, scale8<BD>(sample<BD>(row, 2 * x + 1)));
    } else if (CT == 2) {
      const unsigned r = sample<BD>(row, 3 * x), g = sample<BD>(row, 3 * x + 1),
                     b = sample<BD>(row, 3 * x + 2);
      const int k0 = tables.trns[0];
      const bool hit = k0 >= 0 && r == (unsigned)k0 &&
                       g == (unsigned)tables.trns[1] &&
                       b == (unsigned)tables.trns[2];
      px = rgba(scale8<BD>(r), scale8<BD>(g), scale8<BD>(b), hit ? 0u : 255u);
    } else if (BD == 8 && aligned) {
      px = __ldg(reinterpret_cast<const uint32_t*>(row) + x);
    } else {
      px = rgba(scale8<BD>(sample<BD>(row, 4 * x)),
                scale8<BD>(sample<BD>(row, 4 * x + 1)),
                scale8<BD>(sample<BD>(row, 4 * x + 2)),
                scale8<BD>(sample<BD>(row, 4 * x + 3)));
    }
    out[y * (long long)w + x] = px;
  }
}

template <int CT, int BD>
void launch_assemble_rgba(const uint8_t* recon, long long pitch, uint32_t* out,
                          int w, int h, bool aligned, const PngTables& t,
                          cudaStream_t st) {
  dim3 grid((unsigned)((w + kRgbaThreads - 1) / kRgbaThreads),
            (unsigned)(h < 65535 ? h : 65535));
  assemble_rgba_kernel<CT, BD>
      <<<grid, kRgbaThreads, 0, st>>>(recon, pitch, out, w, h, aligned, t);
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
// the host, passed by value; out: (h, w, 4) uint8, 4-byte aligned
int ffpic_assemble_rgba(const void* recon, long long pitch,
                        const void* palette, const void* trns, void* out,
                        int w, int h, int color_type, int bitdepth,
                        void* stream) {
  if (w <= 0 || h <= 0 || ((uintptr_t)out & 3)) return (int)cudaErrorInvalidValue;
  PngTables t;
  const uint8_t* p = (const uint8_t*)palette;
  for (int i = 0; i < 256; ++i) {
    t.pal[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) |
               ((uint32_t)p[4 * i + 2] << 16) | ((uint32_t)p[4 * i + 3] << 24);
    t.trns[i] = ((const int32_t*)trns)[i];
  }
  const uint8_t* r = (const uint8_t*)recon;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const bool al = ((uintptr_t)r % 4 == 0) && pitch % 4 == 0;
  switch (color_type * 100 + bitdepth) {
    case 1: launch_assemble_rgba<0, 1>(r, pitch, o, w, h, al, t, st); break;
    case 2: launch_assemble_rgba<0, 2>(r, pitch, o, w, h, al, t, st); break;
    case 4: launch_assemble_rgba<0, 4>(r, pitch, o, w, h, al, t, st); break;
    case 8: launch_assemble_rgba<0, 8>(r, pitch, o, w, h, al, t, st); break;
    case 16: launch_assemble_rgba<0, 16>(r, pitch, o, w, h, al, t, st); break;
    case 208: launch_assemble_rgba<2, 8>(r, pitch, o, w, h, al, t, st); break;
    case 216: launch_assemble_rgba<2, 16>(r, pitch, o, w, h, al, t, st); break;
    case 301: launch_assemble_rgba<3, 1>(r, pitch, o, w, h, al, t, st); break;
    case 302: launch_assemble_rgba<3, 2>(r, pitch, o, w, h, al, t, st); break;
    case 304: launch_assemble_rgba<3, 4>(r, pitch, o, w, h, al, t, st); break;
    case 308: launch_assemble_rgba<3, 8>(r, pitch, o, w, h, al, t, st); break;
    case 408: launch_assemble_rgba<4, 8>(r, pitch, o, w, h, al, t, st); break;
    case 416: launch_assemble_rgba<4, 16>(r, pitch, o, w, h, al, t, st); break;
    case 608: launch_assemble_rgba<6, 8>(r, pitch, o, w, h, al, t, st); break;
    case 616: launch_assemble_rgba<6, 16>(r, pitch, o, w, h, al, t, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
