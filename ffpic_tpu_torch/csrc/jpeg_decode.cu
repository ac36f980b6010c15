// Batched baseline 4:2:0 JPEG decode kernels for Hopper (sm_90a).
//
// The device half of ffpic_tpu_torch.ops.jpeg_kernels
// .decode_batch_420_packed_fused: the host Huffman decoder emits, per
// image, a count of nonzero coefficients for each block in MCU order
// and a (zigzag position, value) pair for each nonzero; the host fuses
// the batch into one uint8 buffer
//
//   counts (N, G) u8 | ks (N, E) u8 | vals (N, E) int16 little-endian
//
// and these four kernels turn it into an (N, H, W, 4) uint8 image batch:
//
//   K1a count_scan      exclusive scan of counts       -> starts (N, G) i32
//   K1b unpack          dense de-zigzagged coefficients -> (N, B, 8, 8) i16
//   K2  dequant_idct    dequant + 13-bit integer IDCT   -> (N, B, 8, 8) i16
//   K3  assemble_color  block grid -> planes, 2x chroma, YCbCr -> RGBA
//
// B is the block count of one image over all three components, laid out
// [Y (nby*nbx) | Cb (nby/2*nbx/2) | Cr (nby/2*nbx/2)], each raster order.
//
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().
//
// Integer semantics follow the JAX reference exactly: int32 sums wrap
// (accumulated in uint32, converted to int32 before each arithmetic
// shift, because signed overflow is undefined in C++), int16 stores wrap
// (the [0, 65535] IDCT clamp stores 32768..65535 as negative int16,
// which colour conversion clips to 0), and the colour stage fuses each
// product with its sum into one explicit f32 FMA (__fmaf_rn), g as
// fma(-0.381, v, fma(-0.215, u, y)), which is how XLA compiles the
// reference's y - 0.215*u - 0.381*v; every other step is an explicit
// _rn intrinsic, so nvcc's own contraction cannot change the rounding.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// zigzag position k -> raster position within the 8x8 block
__constant__ uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// 13-bit IDCT basis with libjpeg's off-by-one quirks (golden.IDCT_P13).
// A local constexpr table: with the loops unrolled every entry folds
// into an immediate operand.
__device__ __forceinline__ int32_t idct_coef(int i, int u) {
  constexpr int32_t t[8][8] = {
      {8192, 11363, 10703, 9633, 8192, 6437, 4433, 2260},
      {8192, 9633, 4433, -2259, -8192, -11362, -10704, -6436},
      {8192, 6437, -4433, -11362, -8192, 2261, 10704, 9633},
      {8192, 2260, -10703, -6436, 8192, 9633, -4433, -11363},
      {8192, -2260, -10703, 6436, 8192, -9633, -4433, 11363},
      {8192, -6437, -4433, 11362, -8192, -2261, 10704, -9633},
      {8192, -9633, 4433, 2259, -8192, 11362, -10704, 6436},
      {8192, -11363, 10703, -9633, 8192, -6437, 4433, -2260},
  };
  return t[i][u];
}

constexpr int kScanThreads = 1024;

// K1a. Replaces `jnp.cumsum(counts) - counts` in
// ffpic_tpu/ops/jpeg_kernels.py:_unpack_coeffs. One block per image walks
// its G counts in chunks of kScanThreads, a shared-memory Hillis-Steele
// scan per chunk plus a running carry. Bound: N*G bytes in, 4*N*G out
// (under 2 MB for 8 x 1080p); it is launch- and latency-bound, with N
// blocks on 132 SMs, and small beside K1b-K3.
__global__ void count_scan_kernel(const uint8_t* __restrict__ buf,
                                  int32_t* __restrict__ starts, int g) {
  __shared__ int32_t tmp[kScanThreads];
  const uint8_t* counts = buf + (int64_t)blockIdx.x * g;
  int32_t* out = starts + (int64_t)blockIdx.x * g;
  int32_t carry = 0;
  for (int base = 0; base < g; base += kScanThreads) {
    int i = base + threadIdx.x;
    int32_t c = i < g ? (int32_t)counts[i] : 0;
    tmp[threadIdx.x] = c;
    __syncthreads();
    for (int off = 1; off < kScanThreads; off <<= 1) {
      int32_t add = threadIdx.x >= off ? tmp[threadIdx.x - off] : 0;
      __syncthreads();
      tmp[threadIdx.x] += add;
      __syncthreads();
    }
    if (i < g) out[i] = carry + tmp[threadIdx.x] - c;   // exclusive
    carry += tmp[kScanThreads - 1];
    __syncthreads();
  }
}

// K1b. Replaces the scatter-add of ffpic_tpu/ops/jpeg_kernels.py:
// _unpack_coeffs and the device byte split of
// decode_batch_420_packed_fused (:440-443). One thread per (image,
// packed block g): it owns dense block block_map[g] (the map is a
// permutation of the B blocks), builds it in local memory and writes it
// whole, so no atomics and no separate zero-fill are needed and the
// result is deterministic. Block g owns entries [start_g, start_g +
// count_g) clipped to [0, E). Entries past the counts' total are the
// host's zero padding and are not read (the reference adds them, zeros,
// to the last block; reading them here would put up to E serial reads
// on one thread). Bound: it writes the dense coefficients (N*B*128
// bytes, 50 MB for 8 x 1080p) and reads the packed entries once; the
// 128-byte block write is eight 16-byte stores.
__global__ void unpack_kernel(const uint8_t* __restrict__ buf,
                              const int32_t* __restrict__ starts,
                              const int32_t* __restrict__ block_map,
                              int16_t* __restrict__ out, int n, int g, int e,
                              int nblocks) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)n * g) return;
  int img = (int)(t / g);
  int gi = (int)(t - (int64_t)img * g);
  int32_t bm = block_map[gi];
  if (bm < 0 || bm >= nblocks) return;               // mode="drop"
  int64_t lo = starts[t];
  int64_t hi = lo + buf[t];
  if (hi > e) hi = e;
  const uint8_t* ks = buf + (int64_t)n * g + (int64_t)img * e;
  // the vals region starts at byte n*(g+e), which need not be even
  const uint8_t* vals = buf + (int64_t)n * (g + e) + 2 * (int64_t)img * e;
  uint16_t blk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) blk[i] = 0;
  for (int64_t j = lo; j < hi; ++j) {
    int k = ks[j];
    k = k > 63 ? 63 : k;                             // gather index clamp
    uint16_t v = (uint16_t)(vals[2 * j] | (vals[2 * j + 1] << 8));
    blk[kZigzag[k]] += v;                            // wrapping int16 add
  }
  uint4* dst = reinterpret_cast<uint4*>(
      out + ((int64_t)img * nblocks + bm) * 64);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint4 w;
    w.x = blk[8 * i + 0] | ((uint32_t)blk[8 * i + 1] << 16);
    w.y = blk[8 * i + 2] | ((uint32_t)blk[8 * i + 3] << 16);
    w.z = blk[8 * i + 4] | ((uint32_t)blk[8 * i + 5] << 16);
    w.w = blk[8 * i + 6] | ((uint32_t)blk[8 * i + 7] << 16);
    dst[i] = w;
  }
}

// K2. Replaces the Pallas kernel ffpic_tpu/ops/pallas_jpeg.py:_kernel
// (dequant_idct_pallas) and the XLA path of
// ffpic_tpu/ops/jpeg_kernels.py:dequant_idct_blocks. One thread per
// block, block-major: the 64 coefficients come in as eight 16-byte
// loads, both passes run on registers with the basis as immediates, and
// 128 bytes go out. The TPU kernel's lane-major (8, 8, N) layout and the
// transposes around it are not needed on this card. Bound: 256 bytes of
// traffic and ~1k integer multiply-adds per block, so memory-bound
// (100 MB moved for 8 x 1080p). Blocks below n_luma (within an image)
// use that image's luma table, the rest its chroma table.
__global__ void dequant_idct_kernel(const int16_t* __restrict__ coef,
                                    const int32_t* __restrict__ yquant,
                                    const int32_t* __restrict__ cquant,
                                    int16_t* __restrict__ out,
                                    int64_t total, int nblocks, int n_luma) {
  int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= total) return;
  int img = (int)(b / nblocks);
  int within = (int)(b - (int64_t)img * nblocks);
  const int32_t* q = (within < n_luma ? yquant : cquant) + (int64_t)img * 64;

  int32_t x[64];
  const uint4* src = reinterpret_cast<const uint4*>(coef + b * 64);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint4 w = src[i];
    uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      int p = 8 * i + 2 * h;
      // (c * q) wrapped to int16: only the product's low 16 bits matter
      x[p] = (int16_t)(uint16_t)((uint32_t)(int16_t)(words[h] & 0xFFFF) *
                                 (uint32_t)__ldg(q + p));
      x[p + 1] = (int16_t)(uint16_t)((uint32_t)(int16_t)(words[h] >> 16) *
                                     (uint32_t)__ldg(q + p + 1));
    }
  }
  // column pass: col[i][c] = sum_u T[i][u] * x[u][c], (+1<<10)>>11, int16
  int32_t col[64];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t s = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        s += (uint32_t)idct_coef(i, u) * (uint32_t)x[8 * u + c];
      col[8 * i + c] = (int16_t)(uint16_t)(uint32_t)((int32_t)(s + (1u << 10)) >> 11);
    }
  }
  // row pass: out[y][i] = sum_u T[i][u] * col[y][u], (+257<<17)>>18,
  // clamp [0, 65535], stored int16
  uint32_t res[32];
#pragma unroll
  for (int y = 0; y < 8; ++y) {
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      uint32_t pair = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t s = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          s += (uint32_t)idct_coef(i + h, u) * (uint32_t)col[8 * y + u];
        int32_t r = (int32_t)(s + (257u << 17)) >> 18;
        r = r < 0 ? 0 : (r > 65535 ? 65535 : r);
        pair |= (uint32_t)r << (16 * h);
      }
      res[4 * y + i / 2] = pair;
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(out + b * 64);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = make_uint4(res[4 * i], res[4 * i + 1], res[4 * i + 2],
                        res[4 * i + 3]);
}

__device__ __forceinline__ uint8_t clip_u8(float f) {
  return (uint8_t)fminf(fmaxf(f, 0.0f), 255.0f);
}

__device__ __forceinline__ uint8_t clip_u8i(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// K3. Replaces the post-IDCT part of ffpic_tpu/ops/jpeg_kernels.py:
// decode_batch_420 (block->plane assembly, 2x nearest chroma repeat)
// and color_convert. One thread per output pixel (n, y, x): luma from
// its block, chroma at (y/2, x/2), one 4-byte store, consecutive threads
// on consecutive pixels. Bound: 4 bytes written and ~3 int16 read per
// pixel (67 MB out for 8 x 1080p, chroma reads hit L1/L2).
// mode: 0 reference (trunc), 1 bt601 (floor(+0.5)), 2 rgb (clip only);
// order: 0 rgba, 1 bgra.
__global__ void assemble_color_kernel(const int16_t* __restrict__ s,
                                      uchar4* __restrict__ out, int n,
                                      int nby, int nbx, int mode,
                                      int order) {
  const int h = nby * 8, w = nbx * 8;
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)n * h * w) return;
  int img = (int)(t / ((int64_t)h * w));
  int rem = (int)(t - (int64_t)img * h * w);
  int y = rem / w, x = rem - (rem / w) * w;
  const int nbxc = nbx / 2;
  const int64_t nlum = (int64_t)nby * nbx, nchr = (int64_t)(nby / 2) * nbxc;
  const int16_t* base = s + (int64_t)img * (nlum + 2 * nchr) * 64;
  int ys = base[((int64_t)(y >> 3) * nbx + (x >> 3)) * 64 + (y & 7) * 8 + (x & 7)];
  int cy = y >> 1, cx = x >> 1;
  int64_t coff = ((int64_t)(cy >> 3) * nbxc + (cx >> 3)) * 64 + (cy & 7) * 8 + (cx & 7);
  int us = base[nlum * 64 + coff];
  int vs = base[(nlum + nchr) * 64 + coff];
  uint8_t r, g, b;
  if (mode == 2) {
    r = clip_u8i(ys);
    g = clip_u8i(us);
    b = clip_u8i(vs);
  } else {
    float yy = (float)ys, uu = (float)us - 128.0f, vv = (float)vs - 128.0f;
    if (mode == 0) {
      r = clip_u8(truncf(__fmaf_rn(1.280f, vv, yy)));
      g = clip_u8(truncf(__fmaf_rn(-0.381f, vv, __fmaf_rn(-0.215f, uu, yy))));
      b = clip_u8(truncf(__fmaf_rn(2.128f, uu, yy)));
    } else {
      r = clip_u8(floorf(__fadd_rn(__fmaf_rn(1.402f, vv, yy), 0.5f)));
      g = clip_u8(floorf(__fadd_rn(
          __fmaf_rn(-0.714136f, vv, __fmaf_rn(-0.344136f, uu, yy)), 0.5f)));
      b = clip_u8(floorf(__fadd_rn(__fmaf_rn(1.772f, uu, yy), 0.5f)));
    }
  }
  out[t] = order == 0 ? make_uchar4(r, g, b, 255) : make_uchar4(b, g, r, 255);
}

constexpr int kThreads = 256;

int64_t blocks_for(int64_t work) { return (work + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int ffpic_count_scan(const void* buf, void* starts, int n, int g,
                     void* stream) {
  count_scan_kernel<<<n, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (int32_t*)starts, g);
  return (int)cudaGetLastError();
}

int ffpic_unpack(const void* buf, const void* starts, const void* block_map,
                 void* out, int n, int g, int e, int nblocks, void* stream) {
  unpack_kernel<<<(unsigned)blocks_for((int64_t)n * g), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int32_t*)starts, (const int32_t*)block_map,
      (int16_t*)out, n, g, e, nblocks);
  return (int)cudaGetLastError();
}

int ffpic_dequant_idct(const void* coef, const void* yquant,
                       const void* cquant, void* out, int n, int nblocks,
                       int n_luma, void* stream) {
  int64_t total = (int64_t)n * nblocks;
  dequant_idct_kernel<<<(unsigned)blocks_for(total), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int16_t*)coef, (const int32_t*)yquant, (const int32_t*)cquant,
      (int16_t*)out, total, nblocks, n_luma);
  return (int)cudaGetLastError();
}

int ffpic_assemble_color(const void* samples, void* out, int n, int nby,
                         int nbx, int mode, int order, void* stream) {
  int64_t total = (int64_t)n * nby * 8 * nbx * 8;
  assemble_color_kernel<<<(unsigned)blocks_for(total), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int16_t*)samples, (uchar4*)out, n, nby, nbx, mode, order);
  return (int)cudaGetLastError();
}

}  // extern "C"
