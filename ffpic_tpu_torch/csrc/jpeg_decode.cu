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
//   K3  assemble_color  block grid -> planes, 2x chroma, YCbCr -> RGBA,
//                       cropped to the images' (H, W)
//
// B is the block count of one image over all three components, laid out
// [Y (nby*nbx) | Cb (nby/2*nbx/2) | Cr (nby/2*nbx/2)], each raster order.
//
// The sparse route of .decode_batch_420_sparse stages dense members'
// planes as (flat index, value) pairs instead, and
//
//   K8  scatter_planes  int16 scatter-add of the planes' pairs, each
//                       into its slot of the (N, B, 8, 8) buffer, every
//                       coefficient written once (one launch)
//
// rebuilds the coefficients that K2 and K3 then take.
//
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().
//
// Integer semantics follow the JAX reference exactly: int32 sums wrap
// (accumulated in uint32, converted to int32 before each arithmetic
// shift, because signed overflow is undefined in C++), int16 stores wrap
// (the [0, 65535] IDCT clamp stores 32768..65535 as negative int16,
// which colour conversion clips to 0), and the colour stage is the FMA
// sequence of color.cuh, which K4 assemble_mcu (jpeg_codec.cu) shares.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "color.cuh"

namespace cg = cooperative_groups;

namespace {

// zigzag position k -> raster position within the 8x8 block
__constant__ uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// K1a. Replaces `jnp.cumsum(counts) - counts` in
// ffpic_tpu/ops/jpeg_kernels.py:_unpack_coeffs. Bound: N*G bytes in,
// 4*N*G out (1.96 MB for 8 x 1080p, 0.6 us at 3.35 TB/s), far below
// the time of one launch, so the design aims at the launch floor: one
// launch, each image spread over a cluster of kScanCluster CTAs, and as
// few dependent round trips and barriers as the scan allows.
//
// Image blockIdx.y is the row [s, t) = [img*G, img*G + G) of the counts
// (and of the starts, which share their flat index). The 16-byte words
// that cover the row are cut into kScanCluster runs of equal length
// (cuda_jpeg.count_scan_ranges mirrors the cut); CTA rank r of the
// cluster takes run r, clipped to the row. A CTA
//   1. sums its counts (one 16-byte load a word, __dp4a) and publishes
//      the total in shared memory;
//   2. after a cluster barrier, reads the totals of the lower ranks over
//      distributed shared memory: their sum is its offset;
//   3. scans its run kScanThreads words a pass (the first pass reuses
//      the words of step 1 from registers): each thread scans its 16
//      counts serially, a warp scans the thread totals with shuffles,
//      the CTA its warp totals after one barrier; the 64 bytes of starts
//      a thread makes go through shared memory so that a warp stores
//      512 contiguous bytes per 16-byte store instruction. A longer run
//      loops with a running carry;
//   4. waits at a second cluster barrier before it exits, so that its
//      shared total outlives every rank that reads it.
// Sums are taken in uint32: the wrap is the int32 wrap of the reference.
// No global scratch, no second launch.
constexpr int kScanCluster = 8;
constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / 32;

// The 16-byte word w of buf, with every byte outside [s, t) zero. A word
// that is not wholly inside is read byte by byte, so nothing outside
// [s, t) is read.
__device__ __forceinline__ uint4 load_counts(const uint8_t* __restrict__ buf,
                                             int64_t w, int64_t s, int64_t t) {
  const int64_t off = 16 * w;
  if (off >= s && off + 16 <= t)
    return __ldg(reinterpret_cast<const uint4*>(buf + off));
  uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (off + k >= s && off + k < t)
      wd[k >> 2] |= (uint32_t)buf[off + k] << (8 * (k & 3));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

__device__ __forceinline__ uint32_t word_sum(uint4 v) {
  constexpr uint32_t ones = 0x01010101u;
  return __dp4a(v.x, ones, __dp4a(v.y, ones, __dp4a(v.z, ones,
                                                    __dp4a(v.w, ones, 0u))));
}

// Slot of chunk c (4 starts) of thread q's 16 in the staging buffer,
// rotated by q/2 so that the 8 threads of a quarter warp hit distinct
// banks when each writes its 4 chunks.
__device__ __forceinline__ int scan_slot(int q, int c) {
  return 4 * q + ((c + (q >> 1)) & 3);
}

__global__ void __cluster_dims__(kScanCluster, 1, 1)
    __launch_bounds__(kScanThreads)
count_scan_kernel(const uint8_t* __restrict__ buf,
                  int32_t* __restrict__ starts, int g) {
  __shared__ uint32_t s_total;
  __shared__ uint32_t s_offset;
  __shared__ uint32_t s_warp[kScanWarps];
  __shared__ __align__(16) uint32_t s_out[16 * kScanThreads];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t s = (int64_t)blockIdx.y * g, t = s + g;
  const int64_t w0 = s >> 4, w1 = (t + 15) >> 4;
  const int64_t run = (w1 - w0 + kScanCluster - 1) / kScanCluster;
  const int64_t wa = min64(w0 + rank * run, w1), wb = min64(wa + run, w1);
  const int64_t lo = 16 * wa > s ? 16 * wa : s, hi = min64(16 * wb, t);

  // 1. this CTA's total
  uint4 first = make_uint4(0, 0, 0, 0);
  uint32_t sum = 0;
  for (int64_t w = wa + tid; w < wb; w += kScanThreads) {
    const uint4 v = load_counts(buf, w, s, t);
    if (w == wa + tid) first = v;
    sum += word_sum(v);
  }
  sum = __reduce_add_sync(0xffffffffu, sum);
  if (lane == 0) s_warp[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int i = 0; i < kScanWarps; ++i) total += s_warp[i];
    s_total = total;
  }
  // 2. the lower ranks' totals
  cluster.sync();
  if (warp == 0) {
    uint32_t v = lane < rank ? *cluster.map_shared_rank(&s_total, lane) : 0u;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0) s_offset = v;
  }
  __syncthreads();

  // 3. the scan, kScanThreads words a pass
  uint32_t carry = s_offset;
  for (int64_t base = wa; base < wb; base += kScanThreads) {
    const int64_t w = base + tid;
    const uint4 v = w >= wb ? make_uint4(0, 0, 0, 0)
                    : base == wa ? first : load_counts(buf, w, s, t);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t ex[16];
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      ex[k] = mine;
      mine += (words[k >> 2] >> (8 * (k & 3))) & 0xFFu;
    }
    uint32_t inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += up;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    uint32_t before = 0, pass = 0;
#pragma unroll
    for (int i = 0; i < kScanWarps; ++i) {
      const uint32_t x = s_warp[i];
      before += i < warp ? x : 0u;
      pass += x;
    }
    const uint32_t head = carry + before + inc - mine;
    uint4* stage = reinterpret_cast<uint4*>(s_out);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      stage[scan_slot(tid, c)] =
          make_uint4(head + ex[4 * c], head + ex[4 * c + 1],
                     head + ex[4 * c + 2], head + ex[4 * c + 3]);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = tid + kScanThreads * m;        // chunk of this pass
      const int64_t f = 16 * base + 4 * (int64_t)j;
      if (f >= hi) continue;
      const uint4 o = stage[scan_slot(j >> 2, j & 3)];
      if (f >= lo && f + 4 <= hi) {
        *reinterpret_cast<uint4*>(starts + f) = o;
      } else {
        const uint32_t os[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (f + k >= lo && f + k < hi) starts[f + k] = (int32_t)os[k];
      }
    }
    carry += pass;
  }
  // 4. no rank leaves while another may still read its s_total
  cluster.sync();
}

// K1b. Replaces the scatter-add of ffpic_tpu/ops/jpeg_kernels.py:
// _unpack_coeffs and the device byte split of
// decode_batch_420_packed_fused (:440-443). Bound: it writes the dense
// coefficients (N*B*128 bytes, 50 MB for 8 x 1080p) and reads the
// counts, starts, block map and each packed entry (3 bytes) once, so
// it is memory-bound; the design keeps every global access 16 bytes
// wide and coalesced and nothing in local memory.
//
// One CTA takes a tile of kUnpackTile consecutive packed blocks of one
// image (blockIdx.x the tile, blockIdx.y the image). Block g owns the
// entries [start_g, start_g + count_g), so the tile's entries are one
// contiguous range of ks and vals: [start of its first block, end of
// its last), clipped to [0, E). Entries past the counts' total are the
// host's zero padding and belong to no tile (the reference adds them,
// zeros, to the last block). The tile
//   1. loads its starts and block map and zeroes an int32 coefficient
//      tile in shared memory;
//   2. stages its entries, kUnpackChunk at a time, into shared memory
//      as the 16-byte words that cover them (the ks and vals regions
//      start at any byte; the vals region of the fused buffer need not
//      even be 2-byte aligned);
//   3. gives each staged entry to one thread, which finds its block by
//      a binary search of the tile's starts (the last block whose
//      start is <= the entry: zero-count blocks share a start) and adds
//      its value at the de-zigzagged position with a 32-bit shared
//      atomic. Integer adds commute and the final wrap to int16 is the
//      reference's wrapping int16 sum, so the result does not depend on
//      their order. Zigzag positions past 63 clamp to 63, like a JAX
//      gather;
//   4. writes each block as 8 lanes x 16 bytes to dense block
//      block_map[g]: a warp stores 4 whole 128-byte blocks. A block
//      whose map entry is outside [0, B) is dropped (mode="drop"); the
//      map is a permutation, so every dense block has one writer.
constexpr int kUnpackTile = 64;
constexpr int kUnpackThreads = 256;
constexpr int kUnpackChunk = 2048;

// Copy bytes [from, to) of buf into dst as the 16-byte words that cover
// them and return the offset of byte `from` in dst. A word that runs
// past buf's nbytes is read byte by byte up to nbytes.
__device__ __forceinline__ int stage_words(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ buf,
                                           int64_t from, int64_t to,
                                           int64_t nbytes) {
  const int64_t w0 = from & ~int64_t(15);
  const int nw = (int)((to - w0 + 15) >> 4);
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int64_t off = w0 + 16 * (int64_t)i;
    uint4 v;
    if (off + 16 <= nbytes) {
      v = __ldg(reinterpret_cast<const uint4*>(buf + off));
    } else {
      uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (off + k < nbytes)
          wd[k >> 2] |= (uint32_t)buf[off + k] << (8 * (k & 3));
      v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    reinterpret_cast<uint4*>(dst)[i] = v;
  }
  return (int)(from - w0);
}

__global__ void __launch_bounds__(kUnpackThreads)
unpack_kernel(const uint8_t* __restrict__ buf,
              const int32_t* __restrict__ starts,
              const int32_t* __restrict__ block_map,
              int16_t* __restrict__ out, int n, int g, int e, int nblocks) {
  __shared__ __align__(16) int32_t s_coef[kUnpackTile * 64];
  __shared__ int32_t s_start[kUnpackTile];
  __shared__ int32_t s_map[kUnpackTile];
  __shared__ uint8_t s_zz[64];
  __shared__ __align__(16) uint8_t s_ks[kUnpackChunk + 32];
  __shared__ __align__(16) uint8_t s_vals[2 * kUnpackChunk + 32];

  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int g0 = blockIdx.x * kUnpackTile;
  const int nb = min(kUnpackTile, g - g0);
  const int64_t row = (int64_t)img * g + g0;
  if (tid < nb) {
    s_start[tid] = starts[row + tid];
    s_map[tid] = block_map[g0 + tid];
  }
  if (tid < 64) s_zz[tid] = kZigzag[tid];
  for (int i = tid; i < kUnpackTile * 16; i += kUnpackThreads)
    reinterpret_cast<uint4*>(s_coef)[i] = make_uint4(0, 0, 0, 0);

  // the tile's entries, from its first and last start read straight from
  // global memory, so that staging does not wait for the loads above
  const int64_t lo = min64(starts[row], e);
  const int64_t hi = min64((int64_t)starts[row + nb - 1] + buf[row + nb - 1],
                           e);
  const int64_t nbytes = (int64_t)n * (g + 3 * (int64_t)e);
  const int64_t ks_base = (int64_t)n * g + (int64_t)img * e;
  const int64_t v_base = (int64_t)n * (g + (int64_t)e) + 2 * (int64_t)img * e;
  for (int64_t c0 = lo; c0 < hi; c0 += kUnpackChunk) {
    if (c0 != lo) __syncthreads();      // the last chunk's readers are done
    const int cn = (int)min64(kUnpackChunk, hi - c0);
    const int ko = stage_words(s_ks, buf, ks_base + c0, ks_base + c0 + cn,
                               nbytes);
    const int vo = stage_words(s_vals, buf, v_base + 2 * c0,
                               v_base + 2 * (c0 + cn), nbytes);
    __syncthreads();
    for (int i = tid; i < cn; i += kUnpackThreads) {
      const int32_t j = (int32_t)(c0 + i);
      int b = 0;
#pragma unroll
      for (int step = kUnpackTile / 2; step > 0; step >>= 1)
        if (b + step < nb && s_start[b + step] <= j) b += step;
      const int k = min((int)s_ks[ko + i], 63);
      const int16_t v = (int16_t)(s_vals[vo + 2 * i] |
                                  (s_vals[vo + 2 * i + 1] << 8));
      atomicAdd(&s_coef[b * 64 + s_zz[k]], (int32_t)v);
    }
  }
  __syncthreads();

  for (int i = tid; i < nb * 8; i += kUnpackThreads) {
    const int b = i >> 3, r = i & 7;
    const int32_t bm = s_map[b];
    if (bm < 0 || bm >= nblocks) continue;          // mode="drop"
    const int4* src = reinterpret_cast<const int4*>(s_coef + b * 64 + r * 8);
    const int4 a = src[0], c = src[1];
    uint4 w;                                        // wrap to int16
    w.x = ((uint32_t)a.x & 0xFFFFu) | ((uint32_t)a.y << 16);
    w.y = ((uint32_t)a.z & 0xFFFFu) | ((uint32_t)a.w << 16);
    w.z = ((uint32_t)c.x & 0xFFFFu) | ((uint32_t)c.y << 16);
    w.w = ((uint32_t)c.z & 0xFFFFu) | ((uint32_t)c.w << 16);
    reinterpret_cast<uint4*>(out + ((int64_t)img * nblocks + bm) * 64)[r] = w;
  }
}

// K2. Replaces the Pallas kernel ffpic_tpu/ops/pallas_jpeg.py:_kernel
// (dequant_idct_pallas) and the XLA path of
// ffpic_tpu/ops/jpeg_kernels.py:dequant_idct_blocks. Bound: each block
// is 128 bytes in and 128 out (100.3 MB for 8 x 1080p, 0.0299 ms at
// 3.35 TB/s); the even/odd passes below take 384 integer multiplies a
// block where the direct 8x8 product takes 1088, which puts the integer
// pipe under a third of the byte bound, so the kernel is bounded by
// bytes and the design is about moving them in whole lines.
//
// One CTA takes a tile of kIdctTile consecutive blocks of one image
// (blockIdx.x the tile, blockIdx.y the image, so no thread divides),
// eight threads a block, all in one warp:
//   1. thread r of a block loads row r as one 16-byte load (a warp reads
//      4 blocks, 512 contiguous bytes); the image's luma and chroma
//      tables are staged into shared memory once per CTA, and a block
//      takes the luma table when it lies below n_luma (a tile can
//      straddle the boundary);
//   2. the thread dequantises its row (the product wrapped to int16) and
//      writes it to the block's slot in shared memory; __syncwarp;
//   3. thread c runs the column pass on column c, in place; __syncwarp;
//   4. thread r runs the row pass on row r, clamps, and stores its 16
//      bytes: a warp writes 4 whole blocks.
// A slot is kIdctStride int16 (64 + 8 padding), so that the column
// reads and writes of a warp's 4 blocks fall on distinct banks.
//
// Each 8-point pass is the even/odd split of IDCT_P13: row 7-i of the
// basis is row i with the odd-u entries negated, so out[i] = E_i + O_i
// and out[7-i] = E_i - O_i for i < 4, E from x0, x2, x4, x6 and O from
// x1, x3, x5, x7. All sums are mod 2^32 (uint32), so regrouping the
// same products changes no bit; the rounding shifts, the int16 wrap
// after the column pass and the [0, 65535] clamp stay where the
// reference has them. libjpeg's off-by-one entries (-2259, -11362,
// 2261, 10704) break the remaining symmetries, so a further
// factorisation would not compute the same products.
//
// Tensor cores are not used: Hopper's integer MMA takes int8 operands
// only, and an int16 coefficient times a 14-bit basis entry would take
// four byte-split products per term, for a kernel whose integer work
// is already under a third of its byte bound.
constexpr int kIdctTile = 32;
constexpr int kIdctThreads = 8 * kIdctTile;
constexpr int kIdctStride = 72;

// y[i] = sum_u IDCT_P13[i][u] * x[u], mod 2^32
__device__ __forceinline__ void idct8(const uint32_t x[8], uint32_t y[8]) {
  const uint32_t a = (x[0] + x[4]) << 13, b = (x[0] - x[4]) << 13;
  const uint32_t p = 10703u * x[2] + 4433u * x[6];
  const uint32_t q = 4433u * x[2] - 10704u * x[6];
  const uint32_t e0 = a + p, e1 = b + q, e2 = b - q, e3 = a - p;
  const uint32_t o0 = 11363u * x[1] + 9633u * x[3] + 6437u * x[5] +
                      2260u * x[7];
  const uint32_t o1 = 9633u * x[1] - 2259u * x[3] - 11362u * x[5] -
                      6436u * x[7];
  const uint32_t o2 = 6437u * x[1] - 11362u * x[3] + 2261u * x[5] +
                      9633u * x[7];
  const uint32_t o3 = 2260u * x[1] - 6436u * x[3] + 9633u * x[5] -
                      11363u * x[7];
  y[0] = e0 + o0; y[7] = e0 - o0;
  y[1] = e1 + o1; y[6] = e1 - o1;
  y[2] = e2 + o2; y[5] = e2 - o2;
  y[3] = e3 + o3; y[4] = e3 - o3;
}

// row pass result: (s + (257 << 17)) >> 18 clamped to [0, 65535]
__device__ __forceinline__ uint32_t idct_sample(uint32_t s) {
  const int32_t r = (int32_t)(s + (257u << 17)) >> 18;
  return (uint32_t)(r < 0 ? 0 : (r > 65535 ? 65535 : r));
}

__global__ void __launch_bounds__(kIdctThreads, 8)
dequant_idct_kernel(const int16_t* __restrict__ coef,
                    const int32_t* __restrict__ yquant,
                    const int32_t* __restrict__ cquant,
                    int16_t* __restrict__ out, int nblocks, int n_luma) {
  __shared__ __align__(16) int32_t s_q[2 * 64];
  __shared__ __align__(16) int16_t s_x[kIdctTile * kIdctStride];

  const int tid = threadIdx.x, r = tid & 7;
  const int blk = blockIdx.x * kIdctTile + (tid >> 3);
  const bool live = blk < nblocks;
  const int64_t off = ((int64_t)blockIdx.y * nblocks + blk) * 64 + 8 * r;
  uint4 w = make_uint4(0, 0, 0, 0);
  if (live) w = __ldg(reinterpret_cast<const uint4*>(coef + off));
  if (tid < 32) {
    const int32_t* q = (tid < 16 ? yquant : cquant) + (int64_t)blockIdx.y * 64;
    reinterpret_cast<uint4*>(s_q)[tid] =
        __ldg(reinterpret_cast<const uint4*>(q) + (tid & 15));
  }
  __syncthreads();

  // 2. dequantise row r: only the product's low 16 bits are kept
  const uint4* qrow = reinterpret_cast<const uint4*>(
      s_q + (blk < n_luma ? 0 : 64) + 8 * r);
  const uint4 qa = qrow[0], qb = qrow[1];
  const uint32_t cw[4] = {w.x, w.y, w.z, w.w};
  const uint32_t qs[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
  uint32_t dw[4];
#pragma unroll
  for (int h = 0; h < 4; ++h)
    dw[h] = (((uint32_t)lo16(cw[h]) * qs[2 * h]) & 0xFFFFu) |
            ((uint32_t)hi16(cw[h]) * qs[2 * h + 1] << 16);
  int16_t* slot = s_x + (tid >> 3) * kIdctStride;
  reinterpret_cast<uint4*>(slot)[r] = make_uint4(dw[0], dw[1], dw[2], dw[3]);
  __syncwarp();

  // 3. column pass on column r: (+1<<10)>>11, wrapped to int16
  {
    uint32_t x[8], y[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = (uint32_t)(int32_t)slot[8 * u + r];
    idct8(x, y);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      slot[8 * i + r] =
          (int16_t)(uint16_t)(uint32_t)((int32_t)(y[i] + (1u << 10)) >> 11);
  }
  __syncwarp();

  // 4. row pass on row r, clamped, stored as int16
  const uint4 c = reinterpret_cast<const uint4*>(slot)[r];
  const uint32_t x[8] = {(uint32_t)lo16(c.x), (uint32_t)hi16(c.x),
                         (uint32_t)lo16(c.y), (uint32_t)hi16(c.y),
                         (uint32_t)lo16(c.z), (uint32_t)hi16(c.z),
                         (uint32_t)lo16(c.w), (uint32_t)hi16(c.w)};
  uint32_t y[8];
  idct8(x, y);
  if (live)
    *reinterpret_cast<uint4*>(out + off) = make_uint4(
        idct_sample(y[0]) | idct_sample(y[1]) << 16,
        idct_sample(y[2]) | idct_sample(y[3]) << 16,
        idct_sample(y[4]) | idct_sample(y[5]) << 16,
        idct_sample(y[6]) | idct_sample(y[7]) << 16);
}

// K3. Replaces the post-IDCT part of ffpic_tpu/ops/jpeg_kernels.py:
// decode_batch_420 (block->plane assembly, 2x nearest chroma repeat,
// the crop to the image) and color_convert. Bound: it reads the int16
// samples under the image once and writes 4 bytes per output pixel
// (50 MB in, 66 MB out for 8 x 1080p), so it is memory-bound.
//
// One thread takes one 8-pixel row of one luma block; lanes 8b..8b+7
// of a warp take rows 0..7 of luma block bx0 + b, so a warp reads 4
// consecutive blocks, 512 contiguous bytes, as one 16-byte load a
// thread, and the 8 bytes of u and of v under its row (4 samples each,
// each used by 2 pixels) as one 8-byte load each. It writes its 8 RGBA
// pixels as two 16-byte stores, so the warp fills whole 128-byte lines
// of 8 output rows. A CTA is kColorWarps warps along a block row:
// blockIdx.x the group of 4*kColorWarps blocks, blockIdx.y the block
// row, blockIdx.z the image, so no thread divides. Rows and columns
// past the crop (h, w) are not written; a row whose 32 bytes are not
// all inside the image, or not 16-byte aligned (w % 4 != 0), is
// written pixel by pixel. mode and order are template parameters.
constexpr int kColorWarps = 4;

template <int kMode, int kOrder>
__global__ void __launch_bounds__(32 * kColorWarps)
assemble_color_kernel(const int16_t* __restrict__ s, uint8_t* __restrict__ out,
                      int nby, int nbx, int h, int w) {
  const int lane = threadIdx.x & 31;
  const int bx = (blockIdx.x * kColorWarps + (threadIdx.x >> 5)) * 4 +
                 (lane >> 3);
  const int by = blockIdx.y, r = lane & 7;
  const int y = by * 8 + r, x0 = bx * 8;
  if (bx >= nbx || y >= h) return;
  const int nbxc = nbx >> 1;
  const int64_t nlum = (int64_t)nby * nbx;
  const int64_t nchr = (int64_t)(nby >> 1) * nbxc;
  const int16_t* base = s + (int64_t)blockIdx.z * (nlum + 2 * nchr) * 64;
  const uint4 lq = __ldg(reinterpret_cast<const uint4*>(
      base + ((int64_t)by * nbx + bx) * 64 + r * 8));
  const int64_t coff = ((int64_t)(by >> 1) * nbxc + (bx >> 1)) * 64 +
                       ((by & 1) * 4 + (r >> 1)) * 8 + (bx & 1) * 4;
  const uint2 uq = __ldg(reinterpret_cast<const uint2*>(base + nlum * 64 + coff));
  const uint2 vq = __ldg(reinterpret_cast<const uint2*>(
      base + (nlum + nchr) * 64 + coff));
  uint32_t px[8];
  px[0] = pixel<kMode, kOrder>(lo16(lq.x), lo16(uq.x), lo16(vq.x));
  px[1] = pixel<kMode, kOrder>(hi16(lq.x), lo16(uq.x), lo16(vq.x));
  px[2] = pixel<kMode, kOrder>(lo16(lq.y), hi16(uq.x), hi16(vq.x));
  px[3] = pixel<kMode, kOrder>(hi16(lq.y), hi16(uq.x), hi16(vq.x));
  px[4] = pixel<kMode, kOrder>(lo16(lq.z), lo16(uq.y), lo16(vq.y));
  px[5] = pixel<kMode, kOrder>(hi16(lq.z), lo16(uq.y), lo16(vq.y));
  px[6] = pixel<kMode, kOrder>(lo16(lq.w), hi16(uq.y), hi16(vq.y));
  px[7] = pixel<kMode, kOrder>(hi16(lq.w), hi16(uq.y), hi16(vq.y));
  uint8_t* dst = out + (((int64_t)blockIdx.z * h + y) * w + x0) * 4;
  if (x0 + 8 <= w && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(px[0], px[1], px[2], px[3]);
    d[1] = make_uint4(px[4], px[5], px[6], px[7]);
  } else {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int p = 0; p < 8; ++p)
      if (x0 + p < w) d[p] = px[p];
  }
}

template <int kMode, int kOrder>
void launch_assemble_color(const int16_t* s, uint8_t* out, int n, int nby,
                           int nbx, int h, int w, cudaStream_t stream) {
  dim3 grid((unsigned)((nbx + 4 * kColorWarps - 1) / (4 * kColorWarps)),
            (unsigned)nby, (unsigned)n);
  assemble_color_kernel<kMode, kOrder><<<grid, 32 * kColorWarps, 0, stream>>>(
      s, out, nby, nbx, h, w);
}

// K8. Replaces ffpic_tpu/ops/jpeg_kernels.py:_scatter_plane (:463), the
// scatter-add of decode_batch_420_sparse's packed pairs into zeroed
// planes, for all of a batch's planes in one launch. Bound: it reads 6
// bytes a pair and writes each int16 of the slots once, so it is
// memory-bound; the adds are nothing.
//
// Each plane's pairs become keys: a value of 0 (the host's padding) or
// an index outside [-total, total) adds nothing and keys as `total`; an
// index in [-total, 0) is taken as idx + total (the reference's rules).
// The host packs pairs in key order with the padding at the tail, and
// the fast path rests on that order; any order stays exact:
//
//   * Each plane's coefficients are cut into units of kScatterUnit; the
//     planes get CTAs of the cooperative grid in proportion to their
//     pairs and coefficients, and a CTA owns an even run of its plane's
//     units. Three warps find at once, by a 32-ary search on the keys (5
//     dependent loads at 4 M pairs), the first pair of its first unit,
//     of the unit after its last, and of the plane's tail of keys equal
//     to `total`: its slice of pairs.
//   * It walks its slice in batches of kScatterBatch pairs (4 loads of
//     each array a thread, coalesced, the next batch's in flight while
//     one is added up) through shared memory, adding the
//     values of the unit at hand into int32 in shared memory (shared
//     atomics; int32 truncated to int16 is the int16 wrap of any order
//     of adds); when a batch passes a unit's end, it stores the unit
//     once, zeros included, with 16-byte stores: no memset, no read of
//     the output.
//   * It checks that every key of its slice lies in its run and that the
//     keys do not decrease from the pair before the slice to its end,
//     and, for a share of the plane's tail, that every key there is
//     `total`. The slices of a plane tile its pairs (the search is
//     monotone in its target for any keys), so all checks pass iff the
//     keys are sorted, and then every slice is exactly its run's.
//   * A grid barrier; if any CTA saw a key out of order, every CTA
//     zeroes its units, and after a second barrier the grid adds every
//     pair where it lands, by 32-bit atomicAdd on the word that holds
//     its int16 (the general path, decided on the device; never taken
//     by the host's pairs).
constexpr int kScatterThreads = 256;
constexpr int kScatterUnit = 4096;     // coefficients a unit (a multiple of 64)
constexpr int kScatterBatch = 1024;    // pairs read at a time, 4 a thread
constexpr int kScatterPlanes = 3;

struct ScatterPlanes {
  const int32_t* idx[kScatterPlanes];
  const int16_t* val[kScatterPlanes];
  long long count[kScatterPlanes];     // pairs
  long long plane[kScatterPlanes];     // int16 an image
  long long off[kScatterPlanes];       // the slot's first int16 in an image
  long long total[kScatterPlanes];     // n * plane
  long long first[kScatterPlanes + 1]; // the plane's first unit
  long long ctas[kScatterPlanes + 1];  // the plane's first CTA
  int planes;
  int16_t* out;
  long long pitch;                     // int16 an image
  int* flags;                          // a word a CTA
};

// one plane's pairs, read out of the launch's descriptor once
struct Pairs {
  const int32_t* idx;
  const int16_t* val;
  long long count, total;
};

__device__ __forceinline__ Pairs pairs_of(const ScatterPlanes& p, int c) {
  return Pairs{p.idx[c], p.val[c], p.count[c], p.total[c]};
}

__device__ __forceinline__ long long pair_key(const Pairs& q, long long e,
                                              int* v_out) {
  const int v = __ldg(q.val + e);
  long long i = __ldg(q.idx + e);
  *v_out = v;
  if (i < 0) i += q.total;
  return v == 0 || i < 0 || i >= q.total ? q.total : i;
}

// the first pair whose key is >= t (count if none), by a warp; for
// unsorted keys a fixed function, monotone in t
__device__ long long key_lower_bound(const Pairs& q, long long t, int lane) {
  long long lo = 0, hi = q.count;
  int v;
  while (hi - lo > 32) {
    const long long s = (hi - lo + 31) >> 5;
    const long long at = min(lo + s * (lane + 1), hi) - 1;
    const unsigned ge = __ballot_sync(~0u, pair_key(q, at, &v) >= t);
    if (!ge) return hi;
    const int j = __ffs(ge) - 1;
    hi = min(lo + s * (j + 1), hi) - 1;  // a key >= t: the answer at most
    lo += s * j;
  }
  const long long at = lo + lane;
  const unsigned ge = __ballot_sync(~0u, at < hi && pair_key(q, at, &v) >= t);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

struct Unit {
  int c;            // plane
  long long q0;     // first key
  int len;          // keys (a multiple of 64)
};

__device__ __forceinline__ Unit unit_at(const ScatterPlanes& p, long long u) {
  int c = 0;
  while (c + 1 < p.planes && u >= p.first[c + 1]) ++c;
  Unit r;
  r.c = c;
  r.q0 = (u - p.first[c]) * kScatterUnit;
  r.len = (int)min((long long)kScatterUnit, p.total[c] - r.q0);
  return r;
}

__device__ __forceinline__ long long div_ll(long long a, long long b) {
  return a <= 0xffffffffLL && b <= 0xffffffffLL
             ? (long long)((unsigned)a / (unsigned)b)
             : a / b;
}

// shared acc -> the unit's int16 in its slot, 8 a thread-step (16 bytes)
__device__ __forceinline__ void store_unit(const ScatterPlanes& p, Unit un,
                                           const int* acc) {
  const long long P = p.plane[un.c];
  for (int g = threadIdx.x; g < un.len / 8; g += kScatterThreads) {
    const long long q = un.q0 + 8 * g;
    const long long img = div_ll(q, P);
    const int4 a = reinterpret_cast<const int4*>(acc)[2 * g];
    const int4 b = reinterpret_cast<const int4*>(acc)[2 * g + 1];
    auto pk = [](int lo, int hi) {
      return (unsigned)(uint16_t)lo | ((unsigned)(uint16_t)hi << 16);
    };
    *reinterpret_cast<uint4*>(p.out + img * p.pitch + p.off[un.c] +
                              (q - img * P)) =
        make_uint4(pk(a.x, a.y), pk(a.z, a.w), pk(b.x, b.y), pk(b.z, b.w));
  }
}

__device__ __forceinline__ void zero_unit(int* acc, int len) {
  for (int i = threadIdx.x; i < len / 4; i += kScatterThreads)
    reinterpret_cast<int4*>(acc)[i] = make_int4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kScatterThreads, 4)
    scatter_planes_kernel(const __grid_constant__ ScatterPlanes p) {
  __shared__ __align__(16) int acc[kScatterUnit];
  __shared__ int s_key[kScatterBatch];   // key - q_lo, or -1 out of range
  __shared__ int s_val[kScatterBatch];
  __shared__ long long s_edge[3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the CTA's plane and its even share of the plane's units
  int c = 0;
  while (c + 1 < p.planes && blockIdx.x >= p.ctas[c + 1]) ++c;
  const long long uc = p.first[c + 1] - p.first[c];
  const long long gc = p.ctas[c + 1] - p.ctas[c], ic = blockIdx.x - p.ctas[c];
  const long long ua = p.first[c] + uc * ic / gc;
  const long long ub = p.first[c] + uc * (ic + 1) / gc;
  const long long q_lo = (ua - p.first[c]) * kScatterUnit;
  const long long q_hi = min((ub - p.first[c]) * kScatterUnit, p.total[c]);
  const Pairs pc = pairs_of(p, c);
  bool bad = false;

  // the first pair of the run (A), of the unit after it (B) and of the
  // plane's tail (T), a warp each
  if (warp < 3) {
    const long long e = key_lower_bound(
        pc, warp == 0 ? q_lo : warp == 1 ? q_hi : pc.total, lane);
    if (lane == 0) s_edge[warp] = e;
  }
  __syncthreads();
  const long long A = s_edge[0], B = s_edge[1], T = s_edge[2];
  const long long n = pc.count;
  int v, w;
  if (tid == 0 && A > 0 && A < n &&
      pair_key(pc, A - 1, &v) > pair_key(pc, A, &w))
    bad = true;
  // walk the slice [A, B) in batches, in key order, the next batch's
  // loads in flight while one is added up; a unit is stored once the
  // batch passes its end
  long long u = ua;
  int base = 0;                                  // the unit's first key - q_lo
  int len = (int)min((long long)kScatterUnit, q_hi - q_lo);
  int prev = -1;
  constexpr int kPer = kScatterBatch / kScatterThreads;
  // a batch in registers: each pair's raw key and value
  long long kr[kPer];
  int vr[kPer];
  long long e0 = A;
  int nb = (int)min((long long)kScatterBatch, B - A);
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (tid + i * kScatterThreads < nb)
      kr[i] = pair_key(pc, e0 + tid + i * kScatterThreads, &vr[i]);
  zero_unit(acc, len);
  while (e0 < B) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = tid + i * kScatterThreads;
      if (j < nb) {
        // key - q_lo, or -1 out of the run
        const bool in = kr[i] >= q_lo && kr[i] < q_hi;
        bad |= !in;
        s_key[j] = in ? (int)(kr[i] - q_lo) : -1;
        s_val[j] = vr[i];
      }
    }
    const long long e1 = e0 + nb;
    const int nb1 = (int)min((long long)kScatterBatch, B - e1);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (tid + i * kScatterThreads < nb1)
        kr[i] = pair_key(pc, e1 + tid + i * kScatterThreads, &vr[i]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = tid + i * kScatterThreads;
      if (j < nb && s_key[j] < (j ? s_key[j - 1] : prev)) bad = true;
    }
    const int last = s_key[nb - 1];
    for (;;) {
#pragma unroll
      for (int i = 0; i < kScatterBatch / kScatterThreads; ++i) {
        const int j = tid + i * kScatterThreads;
        if (j < nb && s_key[j] >= base && s_key[j] < base + len)
          atomicAdd(&acc[s_key[j] - base], s_val[j]);
      }
      if (last < base + len || u == ub - 1) break;
      __syncthreads();
      store_unit(p, unit_at(p, u), acc);
      __syncthreads();
      ++u;
      base += kScatterUnit;
      len = (int)min((long long)kScatterUnit, q_hi - q_lo - base);
      zero_unit(acc, len);
      __syncthreads();
    }
    prev = last;
    __syncthreads();   // s_key read before the next batch
    e0 = e1;
    nb = nb1;
  }
  // the unit the walk ended in, then the units past the last pair
  for (; u < ub; ++u) {
    __syncthreads();
    store_unit(p, unit_at(p, u), acc);
    __syncthreads();
    zero_unit(acc, kScatterUnit);
  }
  __syncthreads();
  // the CTA's share of the plane's tail (in proportion to its units):
  // every key there must be total
  const long long share = (n - T + uc - 1) / uc;
  const long long e1 = min(n, T + (ub - p.first[c]) * share);
  for (long long e = T + (ua - p.first[c]) * share + tid; e < e1;
       e += kScatterBatch) {
    long long k[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      k[i] = e + i * kScatterThreads < e1
                 ? pair_key(pc, e + i * kScatterThreads, &v)
                 : pc.total;
#pragma unroll
    for (int i = 0; i < kPer; ++i) bad |= k[i] < pc.total;
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) p.flags[blockIdx.x] = bad;
  cg::this_grid().sync();
  bool any = false;
  for (unsigned k = threadIdx.x; k < gridDim.x; k += kScatterThreads)
    any |= __ldcg(p.flags + k) != 0;
  if (!__syncthreads_or(any)) return;

  // the general path: zero the CTA's units, a barrier, then every pair
  // added where it lands by 32-bit atomicAdd on the word that holds its
  // int16 (a carry out of a low half taken back by a second add), a
  // pair a thread of the grid
  for (long long u = ua; u < ub; ++u) {
    const Unit un = unit_at(p, u);
    zero_unit(acc, un.len);
    __syncthreads();
    store_unit(p, un, acc);
    __syncthreads();
  }
  cg::this_grid().sync();
  const long long step = (long long)gridDim.x * kScatterThreads;
  for (int d = 0; d < p.planes; ++d) {
    const Pairs pd = pairs_of(p, d);
    for (long long e = (long long)blockIdx.x * kScatterThreads + threadIdx.x;
         e < pd.count; e += step) {
      int v;
      const long long k = pair_key(pd, e, &v);
      if (k >= pd.total) continue;
      const long long img = div_ll(k, p.plane[d]);
      int16_t* at = p.out + img * p.pitch + p.off[d] + (k - img * p.plane[d]);
      unsigned* word = reinterpret_cast<unsigned*>((uintptr_t)at & ~(uintptr_t)3);
      const unsigned h = (uint16_t)v;
      if ((uintptr_t)at & 2) {
        atomicAdd(word, h << 16);
      } else if ((atomicAdd(word, h) & 0xFFFFu) + h > 0xFFFFu) {
        atomicAdd(word, 0xFFFF0000u);
      }
    }
  }
}

}  // namespace

extern "C" {

// words: for each of `planes` (1..3) planes its pairs' idx (int32) and
// val (int16) addresses, their count, its blocks a image and its slot's
// first block, 5 words a plane; out: n images of `pitch` int16 (a
// multiple of 8, out 16-byte aligned), the planes' slots one block range
// each, inside the pitch; flags: `capacity` int32 of scratch, a word a
// CTA (no zeroing needed). Every int16 of the slots is written once.
int ffpic_scatter_planes(const long long* words, int planes, void* out,
                         int n, long long pitch, void* flags, int capacity,
                         void* stream) {
  if (planes < 1 || planes > kScatterPlanes || n <= 0 || pitch <= 0 ||
      pitch % 8 || ((uintptr_t)out & 15) || capacity <= 0)
    return (int)cudaErrorInvalidValue;
  ScatterPlanes p = {};
  p.planes = planes;
  p.out = (int16_t*)out;
  p.pitch = pitch;
  p.flags = (int*)flags;
  long long units = 0;
  for (int c = 0; c < planes; ++c) {
    const long long* w = words + 5 * c;
    const long long nb = w[3], first = w[4];
    if (w[2] < 0 || nb <= 0 || first < 0 || 64 * (first + nb) > pitch ||
        (w[2] > 0 && (!w[0] || !w[1])))
      return (int)cudaErrorInvalidValue;
    p.idx[c] = (const int32_t*)w[0];
    p.val[c] = (const int16_t*)w[1];
    p.count[c] = w[2];
    p.plane[c] = 64 * nb;
    p.off[c] = 64 * first;
    p.total[c] = (long long)n * p.plane[c];
    p.first[c] = units;
    units += (p.total[c] + kScatterUnit - 1) / kScatterUnit;
  }
  p.first[planes] = units;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_planes_kernel, kScatterThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long grid = (long long)sms * per_sm;
  if (grid > capacity) grid = capacity;
  // CTAs a plane in proportion to its work (3 a pair, its 6 bytes read,
  // to 1 a coefficient, its 2 bytes written), one at least, a unit each
  // at most
  long long work = 0, g[kScatterPlanes], sum = 0;
  for (int c = 0; c < planes; ++c) work += 3 * p.count[c] + p.total[c];
  for (int c = 0; c < planes; ++c) {
    const long long uc = p.first[c + 1] - p.first[c];
    g[c] = (long long)((double)grid * (3 * p.count[c] + p.total[c]) / work);
    g[c] = g[c] < 1 ? 1 : g[c] > uc ? uc : g[c];
    sum += g[c];
  }
  while (sum > grid) {            // at most one extra CTA a plane
    int big = 0;
    for (int c = 1; c < planes; ++c) big = g[c] > g[big] ? c : big;
    if (g[big] <= 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    --g[big];
    --sum;
  }
  p.ctas[0] = 0;
  for (int c = 0; c < planes; ++c) {
    p.ctas[c + 1] = p.ctas[c] + g[c];
    // a CTA's run of keys is indexed in int32 in shared memory
    const long long uc = p.first[c + 1] - p.first[c];
    if ((uc + g[c] - 1) / g[c] * kScatterUnit >= 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  }
  grid = sum;
  void* args[] = {(void*)&p};
  err = cudaLaunchCooperativeKernel((const void*)scatter_planes_kernel,
                                    dim3((unsigned)grid), dim3(kScatterThreads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int ffpic_count_scan(const void* buf, void* starts, int n, int g, int cluster,
                     void* stream) {
  // cluster is the caller's kScanCluster (cuda_jpeg.SCAN_CLUSTER, whose
  // count_scan_ranges mirrors the cut): refuse a caller that cuts
  // otherwise, and an image count the grid's y cannot hold
  if (cluster != kScanCluster || n <= 0 || g <= 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  count_scan_kernel<<<dim3(kScanCluster, (unsigned)n), kScanThreads, 0,
                      (cudaStream_t)stream>>>((const uint8_t*)buf,
                                              (int32_t*)starts, g);
  return (int)cudaGetLastError();
}

int ffpic_unpack(const void* buf, const void* starts, const void* block_map,
                 void* out, int n, int g, int e, int nblocks, int tile,
                 void* stream) {
  // tile is the caller's kUnpackTile (cuda_jpeg.UNPACK_TILE): refuse a
  // caller that tiles otherwise
  if (tile != kUnpackTile || n <= 0 || g <= 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((g + kUnpackTile - 1) / kUnpackTile), (unsigned)n);
  unpack_kernel<<<grid, kUnpackThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int32_t*)starts, (const int32_t*)block_map,
      (int16_t*)out, n, g, e, nblocks);
  return (int)cudaGetLastError();
}

int ffpic_dequant_idct(const void* coef, const void* yquant,
                       const void* cquant, void* out, int n, int nblocks,
                       int n_luma, int tile, void* stream) {
  // tile is the caller's kIdctTile (cuda_jpeg.IDCT_TILE)
  if (tile != kIdctTile || n <= 0 || n > 65535 || nblocks <= 0 ||
      n_luma < 0 || n_luma > nblocks)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((nblocks + kIdctTile - 1) / kIdctTile), (unsigned)n);
  dequant_idct_kernel<<<grid, kIdctThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coef, (const int32_t*)yquant, (const int32_t*)cquant,
      (int16_t*)out, nblocks, n_luma);
  return (int)cudaGetLastError();
}

int ffpic_assemble_color(const void* samples, void* out, int n, int nby,
                         int nbx, int h, int w, int mode, int order,
                         void* stream) {
  if (n <= 0 || n > 65535 || nby <= 0 || nby > 65535 || h <= 0 || w <= 0 ||
      h > 8 * nby || w > 8 * nbx || mode < 0 || mode > 2 || order < 0 ||
      order > 1)
    return (int)cudaErrorInvalidValue;
  const int16_t* s = (const int16_t*)samples;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode * 2 + order) {
    case 0: launch_assemble_color<0, 0>(s, o, n, nby, nbx, h, w, st); break;
    case 1: launch_assemble_color<0, 1>(s, o, n, nby, nbx, h, w, st); break;
    case 2: launch_assemble_color<1, 0>(s, o, n, nby, nbx, h, w, st); break;
    case 3: launch_assemble_color<1, 1>(s, o, n, nby, nbx, h, w, st); break;
    case 4: launch_assemble_color<2, 0>(s, o, n, nby, nbx, h, w, st); break;
    default: launch_assemble_color<2, 1>(s, o, n, nby, nbx, h, w, st); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
