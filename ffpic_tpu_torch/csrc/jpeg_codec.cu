// JPEG codec kernels for Hopper (sm_90a): the general single-image
// decode after the IDCT, and the encoder's forward DCT.
//
//   K4 assemble_mcu  int16 samples of 1 or 3 components, any sampling
//                    -> (H, W, 4) uint8, nearest or fancy upsampling
//   K5 fdct          13-bit forward 8x8 DCT, int16 -> int16
//
// The device half of ffpic_tpu_torch.ops.jpeg_kernels.decode_mcu_planes
// (K2 dequant_idct of jpeg_decode.cu, then K4) and .fdct_blocks (K5).
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().
// Integer semantics follow the JAX reference exactly: int32 sums wrap
// (accumulated in uint32, converted to int32 before each arithmetic
// shift), int16 stores wrap. Colour is color.cuh's, shared with K3.

#include <cstdint>
#include <cuda_runtime.h>

#include "color.cuh"

namespace {

// K4. Replaces the part of ffpic_tpu/ops/jpeg_kernels.py:decode_mcu_planes
// (:196) after the IDCT: blocks_to_plane, the crop to the valid sample
// grid, upsample_nearest (:108) or upsample_fancy (:118), the gray
// chroma fill and color_convert (:144). Bound: it reads each component's
// int16 samples under the image once and writes 4 bytes a pixel (48 MB
// in and 48 MB out for a 4000x3000 4:2:2 image), so it is memory-bound;
// the ops are about 30 f32 a pixel, a sixth of the byte time.
//
// No plane is materialised: a thread reads the samples straight from
// block layout and writes one 8-pixel run of an output row. Lanes
// 8b..8b+7 of a warp take rows 0..7 of the 8-pixel column bx0 + b, so a
// warp covers 4 luma-sized blocks, and a component that is not upsampled
// (factor 1x1, whatever its place in the frame) is read as one 16-byte
// load a thread, 512 contiguous bytes a warp. An upsampled component is
// read sample by sample from the few lines under the warp (L1 serves the
// repeats). The 8 pixels go out as two 16-byte stores: the output width
// is a multiple of 8, so every run is whole and aligned. A CTA is
// kMcuWarps warps along a row of blocks; blockIdx.y is the block row.
//
// Per component, (v, h) is its luma-relative factor and (ph, pw) =
// (ceil(H/v), ceil(W/h)) its cropped plane: nearest reads sample
// (y / v, x / h), any integer factor; fancy (v, h in {1, 2}) is
// libjpeg's triangle filter in integers, with its borders replicated at
// the cropped plane's last row and column (ph-1, pw-1), not at the
// padded block grid's:
//   vertical   V(col) = 3 S(r, col) + S(r', col), r = y/2, r' = r -+ 1
//              clamped to [0, ph-1] (v = 2), or 4 S(y, col) (v = 1);
//   horizontal (3 V(c) + V(c -+ 1 clamped to [0, pw-1]) + bias) >> 4,
//              bias 8/7 (v = 2) or 4/8 (v = 1), for even/odd x (h = 2),
//              or (V(x) + 2) >> 2 (h = 1).
// Every intermediate fits int32 and every result int16, as in the
// reference.
constexpr int kMcuWarps = 4;

struct McuComp {
  const int16_t* base;   // the component's samples, (nby, nbx, 8, 8) int16
  int nbx;               // its blocks across
  int v, h;              // luma-relative upsampling factors
  int ph, pw;            // its cropped plane
};

struct McuArgs {
  McuComp c[3];
  int ncomp;             // 1 (gray) or 3
  int gray;              // the chroma of a gray image
  int out_h, out_w;      // out_w a multiple of 8
};

__device__ __forceinline__ int sample(const McuComp& c, int py, int px) {
  return __ldg(c.base + ((int64_t)(py >> 3) * c.nbx + (px >> 3)) * 64 +
               ((py & 7) << 3) + (px & 7));
}

// the 8 samples of plane row py from column x0, a multiple of 8
__device__ __forceinline__ void row8(const McuComp& c, int py, int x0,
                                     int s[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(
      c.base + ((int64_t)(py >> 3) * c.nbx + (x0 >> 3)) * 64 +
      ((py & 7) << 3)));
  s[0] = lo16(q.x); s[1] = hi16(q.x); s[2] = lo16(q.y); s[3] = hi16(q.y);
  s[4] = lo16(q.z); s[5] = hi16(q.z); s[6] = lo16(q.w); s[7] = hi16(q.w);
}

// the component's value under pixels (y, x0..x0+7)
template <bool kFancy>
__device__ __forceinline__ void comp_row(const McuComp& c, int y, int x0,
                                         int s[8]) {
  if (c.v == 1 && c.h == 1) {
    row8(c, y, x0, s);
    return;
  }
  if (!kFancy) {
    const int py = y / c.v;
    if (c.h == 1) {
      row8(c, py, x0, s);
    } else {
#pragma unroll
      for (int p = 0; p < 8; ++p) s[p] = sample(c, py, (x0 + p) / c.h);
    }
    return;
  }
  int r0 = y, r1 = y, eb = 4, ob = 8;            // v == 1: V = 4 S(y)
  if (c.v == 2) {
    r0 = y >> 1;
    r1 = (y & 1) ? min(r0 + 1, c.ph - 1) : max(r0 - 1, 0);
    eb = 8;
    ob = 7;
  }
  if (c.h == 1) {
    int a[8], b[8];
    row8(c, r0, x0, a);
    row8(c, r1, x0, b);
#pragma unroll
    for (int p = 0; p < 8; ++p) s[p] = (3 * a[p] + b[p] + 2) >> 2;
    return;
  }
  // h == 2: plane columns x0/2 - 1 .. x0/2 + 4, clamped
  int vc[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int col = min(max((x0 >> 1) - 1 + k, 0), c.pw - 1);
    vc[k] = 3 * sample(c, r0, col) + sample(c, r1, col);
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int k = p >> 1;
    s[p] = (p & 1) ? (3 * vc[k + 1] + vc[k + 2] + ob) >> 4
                   : (3 * vc[k + 1] + vc[k] + eb) >> 4;
  }
}

template <int kMode, int kOrder, bool kFancy>
__global__ void __launch_bounds__(32 * kMcuWarps)
assemble_mcu_kernel(const McuArgs a, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int bx = (blockIdx.x * kMcuWarps + (threadIdx.x >> 5)) * 4 +
                 (lane >> 3);
  const int y = blockIdx.y * 8 + (lane & 7), x0 = bx * 8;
  if (x0 >= a.out_w || y >= a.out_h) return;
  int s[3][8];
  comp_row<kFancy>(a.c[0], y, x0, s[0]);
  if (a.ncomp == 3) {
    comp_row<kFancy>(a.c[1], y, x0, s[1]);
    comp_row<kFancy>(a.c[2], y, x0, s[2]);
  } else {
#pragma unroll
    for (int p = 0; p < 8; ++p) s[1][p] = s[2][p] = a.gray;
  }
  uint32_t px[8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
    px[p] = pixel<kMode, kOrder>(s[0][p], s[1][p], s[2][p]);
  uint4* d = reinterpret_cast<uint4*>(out + ((int64_t)y * a.out_w + x0) * 4);
  d[0] = make_uint4(px[0], px[1], px[2], px[3]);
  d[1] = make_uint4(px[4], px[5], px[6], px[7]);
}

template <int kMode, int kOrder>
void launch_assemble_mcu(const McuArgs& a, uint8_t* out, bool fancy,
                         cudaStream_t stream) {
  dim3 grid((unsigned)((a.out_w / 8 + 4 * kMcuWarps - 1) / (4 * kMcuWarps)),
            (unsigned)((a.out_h + 7) / 8));
  if (fancy)
    assemble_mcu_kernel<kMode, kOrder, true>
        <<<grid, 32 * kMcuWarps, 0, stream>>>(a, out);
  else
    assemble_mcu_kernel<kMode, kOrder, false>
        <<<grid, 32 * kMcuWarps, 0, stream>>>(a, out);
}

// K5. Replaces ffpic_tpu/ops/jpeg_kernels.py:fdct_blocks (:83), the
// encoder's 13-bit forward DCT: the row pass first, then the column
// pass, each ((sum >> 1) + (1 << 12)) >> 13 wrapped to int16 (the
// rounding between the passes makes their order observable). Bound: 128
// bytes in and 128 out a block (12.5 MB for a 1088x1920 4:2:0 image,
// 0.0037 ms at 3.35 TB/s), with 2,048 int32 ops a block charged for the
// direct 8x8 products (0.0030 ms at the int32 rate): bytes bound it,
// and at that size the launch itself (about 0.002 ms) is most of it.
//
// K2's layout: a CTA takes kFdctTile consecutive blocks, eight threads a
// block in one warp. Thread r loads row r (16 bytes; a warp reads 512
// contiguous bytes), runs the row pass on it and writes it to the
// block's padded slot in shared memory; after __syncwarp thread c runs
// the column pass on column c in place; after another, thread r stores
// row r as 16 bytes. Each 8-point pass is the even/odd split of
// FDCT_P13 (row i is symmetric for even i, antisymmetric for odd i):
// 32 multiplies instead of 64, exact because every sum wraps mod 2^32
// in uint32 and regrouping the same products changes no bit.
constexpr int kFdctTile = 32;
constexpr int kFdctThreads = 8 * kFdctTile;
constexpr int kFdctStride = 72;

// y[i] = sum_u FDCT_P13[i][u] * x[u], mod 2^32
__device__ __forceinline__ void fdct8(const uint32_t x[8], uint32_t y[8]) {
  const uint32_t s0 = x[0] + x[7], s1 = x[1] + x[6], s2 = x[2] + x[5],
                 s3 = x[3] + x[4];
  const uint32_t d0 = x[0] - x[7], d1 = x[1] - x[6], d2 = x[2] - x[5],
                 d3 = x[3] - x[4];
  const uint32_t e0 = s0 - s3, e1 = s1 - s2;
  y[0] = 5792u * (s0 + s1 + s2 + s3);
  y[4] = 5792u * (s0 - s1 - s2 + s3);
  y[2] = 7568u * e0 + 3134u * e1;
  y[6] = 3134u * e0 - 7568u * e1;
  y[1] = 8034u * d0 + 6811u * d1 + 4551u * d2 + 1598u * d3;
  y[3] = 6811u * d0 - 1598u * d1 - 8034u * d2 - 4551u * d3;
  y[5] = 4551u * d0 - 8034u * d1 + 1598u * d2 + 6811u * d3;
  y[7] = 1598u * d0 - 4551u * d1 + 6811u * d2 - 8034u * d3;
}

// ((s >> 1) + (1 << 12)) >> 13 of the int32 sum s, wrapped to int16
__device__ __forceinline__ int16_t fdct_round(uint32_t s) {
  return (int16_t)(uint16_t)(uint32_t)((((int32_t)s >> 1) + (1 << 12)) >> 13);
}

__global__ void __launch_bounds__(kFdctThreads)
fdct_kernel(const int16_t* __restrict__ in, int16_t* __restrict__ out,
            int64_t nblocks) {
  __shared__ __align__(16) int16_t s_x[kFdctTile * kFdctStride];

  const int tid = threadIdx.x, r = tid & 7;
  const int64_t blk = (int64_t)blockIdx.x * kFdctTile + (tid >> 3);
  const bool live = blk < nblocks;
  const int64_t off = blk * 64 + 8 * r;
  uint4 w = make_uint4(0, 0, 0, 0);
  if (live) w = __ldg(reinterpret_cast<const uint4*>(in + off));
  int16_t* slot = s_x + (tid >> 3) * kFdctStride;

  // 1. row pass on row r
  {
    const uint32_t x[8] = {(uint32_t)lo16(w.x), (uint32_t)hi16(w.x),
                           (uint32_t)lo16(w.y), (uint32_t)hi16(w.y),
                           (uint32_t)lo16(w.z), (uint32_t)hi16(w.z),
                           (uint32_t)lo16(w.w), (uint32_t)hi16(w.w)};
    uint32_t y[8];
    fdct8(x, y);
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = (uint32_t)(uint16_t)fdct_round(y[2 * k]) |
             ((uint32_t)(uint16_t)fdct_round(y[2 * k + 1]) << 16);
    reinterpret_cast<uint4*>(slot)[r] = make_uint4(o[0], o[1], o[2], o[3]);
  }
  __syncwarp();

  // 2. column pass on column r, in place
  {
    uint32_t x[8], y[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = (uint32_t)(int32_t)slot[8 * u + r];
    fdct8(x, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) slot[8 * i + r] = fdct_round(y[i]);
  }
  __syncwarp();

  // 3. row r out
  if (live)
    *reinterpret_cast<uint4*>(out + off) =
        reinterpret_cast<const uint4*>(slot)[r];
}

}  // namespace

extern "C" {

// comps: ncomp rows of 6 int64 (samples pointer, nbx, v, h, ph, pw)
int ffpic_assemble_mcu(const long long* comps, int ncomp, int gray, void* out,
                       int out_h, int out_w, int mode, int order, int fancy,
                       void* stream) {
  if ((ncomp != 1 && ncomp != 3) || out_h <= 0 || out_w <= 0 ||
      out_w % 8 || (out_h + 7) / 8 > 65535 || mode < 0 || mode > 2 ||
      order < 0 || order > 1)
    return (int)cudaErrorInvalidValue;
  McuArgs a{};
  for (int c = 0; c < ncomp; ++c) {
    const long long* p = comps + 6 * c;
    McuComp& m = a.c[c];
    m.base = (const int16_t*)(intptr_t)p[0];
    m.nbx = (int)p[1];
    m.v = (int)p[2];
    m.h = (int)p[3];
    m.ph = (int)p[4];
    m.pw = (int)p[5];
    if (m.nbx < 1 || m.v < 1 || m.h < 1 || m.ph < 1 || m.pw < 1 ||
        (fancy && (m.v > 2 || m.h > 2)))
      return (int)cudaErrorInvalidValue;
  }
  a.ncomp = ncomp;
  a.gray = gray;
  a.out_h = out_h;
  a.out_w = out_w;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const bool f = fancy != 0;
  switch (mode * 2 + order) {
    case 0: launch_assemble_mcu<0, 0>(a, o, f, st); break;
    case 1: launch_assemble_mcu<0, 1>(a, o, f, st); break;
    case 2: launch_assemble_mcu<1, 0>(a, o, f, st); break;
    case 3: launch_assemble_mcu<1, 1>(a, o, f, st); break;
    case 4: launch_assemble_mcu<2, 0>(a, o, f, st); break;
    default: launch_assemble_mcu<2, 1>(a, o, f, st); break;
  }
  return (int)cudaGetLastError();
}

int ffpic_fdct(const void* in, void* out, long long nblocks, int tile,
               void* stream) {
  // tile is the caller's kFdctTile (cuda_jpeg.FDCT_TILE)
  const long long grid = (nblocks + kFdctTile - 1) / kFdctTile;
  if (tile != kFdctTile || nblocks <= 0 || grid > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  fdct_kernel<<<(unsigned)grid, kFdctThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)in, (int16_t*)out, (int64_t)nblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
