// PNG decode kernels for Hopper (sm_90a): the device half of
// ffpic_tpu_torch.formats.png.to_pic.
//
//   K6 unfilter_subup  rows whose filters are all None/Sub/Up -> the
//                      reconstructed scanlines, (H, stride) uint8 at a
//                      16-byte-aligned row pitch; one launch, a banded
//                      segmented scan
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
// the adds are nothing. The design keeps it one pass over the image in
// one launch: a banded segmented scan.
//
// Reconstruction is two scans mod 256: a Sub row is a cumulative sum over
// its bpp lanes; then each column is a cumulative sum in segments that
// restart at every row that is not Up. Over a band of rows the column
// scan composes: a band with a restart ends on a value that needs nothing
// from above; one without ends on (carry + its sum).
//
// A CTA takes a band of `rows` rows from a ticket (atomicAdd; the CTA
// that takes the last ticket puts the counter back to 0 for the next
// launch), and walks it in column chunks of `chunk` bytes (a multiple of
// 768, 7,680 at most) left to right, each chunk a tile of rows x chunk
// bytes in shared memory (at most kUnfTile):
//   1. load: 16-byte loads of the aligned chunks around each row's bytes
//      (a row starts after its tag byte, at any address), funnel-shifted
//      into place;
//   2. Sub: a warp a row, each lane a run of chunk / 32 bytes (a
//      multiple of lcm(4, bpp)), in words: the lanes' per-class sums are
//      scanned across the warp (bpp bytes in two words, __vadd4), then
//      each lane rescans its run from its carry; the row's last bpp
//      bytes carry into its next chunk;
//   3. Up within the band: a thread a 32-bit word of the chunk walks the
//      band's rows in shared memory (__vadd4), with zero for the carry
//      from above;
//   4. publish the chunk's last row under the band's status word for the
//      chunk (the launch's epoch * 4 + state, so that no zeroing is
//      needed between launches): INC, the final row, stored into the
//      output, when the band has a restart or is the first band; else
//      AGG, its column sums, stored into `agg`;
//   5. look back, only when the band's first row is Up and it is not the
//      first band. Bands form blocks of kBlock. Warp 0 reads the status
//      of the bands above it in its block: the carry is the nearest INC
//      plus the AGGs below it, or, when all are AGG, their sum plus what
//      the blocks above give: block by block, the INC of the block's
//      last band, or the block's sum, which the last band of a block
//      without a restart publishes (its own AGG plus the 31 above it)
//      under a status word of the block. Each step waits (reads again)
//      until its rows are there, and adds them, read from L2, 4 rows x
//      the thread's 16-byte groups a time. A band waits only on bands
//      with earlier tickets, which are running or done. The carry is
//      added to the rows above the band's first restart; a band without
//      one then publishes INC;
//   6. store the tile's rows with 16-byte stores into the 16-byte-aligned
//      output pitch.
// For the usual file (restarts in every band) no band waits; under a run
// of Up rows a band adds at most kBlock - 1 AGGs and a row a block above.
constexpr int kUnfThreads = 128;            // a warp a row in the Sub pass
constexpr int kUnfWarps = kUnfThreads / 32;
constexpr int kUnfChunk = 7680;             // bytes of a row a chunk, at most
constexpr int kUnfTile = 30720;             // bytes of shared memory a tile
constexpr int kUnfMaxRows = 64;             // rows a band, at most
constexpr int kBlock = 32;                  // bands a block of the look-back
constexpr int kAgg = 1, kInc = 2;           // states of a status word

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// the 16 bytes at a (any address; only the first nv >= 1 are used), from
// the one or two aligned 16-byte chunks that hold them
__device__ __forceinline__ uint4 load16_at(const uint8_t* a, int nv) {
  const int r = (int)((uintptr_t)a & 15);
  const uint4* c = reinterpret_cast<const uint4*>(a - r);
  const uint4 c0 = __ldg(c);
  if (r == 0) return c0;
  const uint4 c1 = r + nv > 16 ? __ldg(c + 1) : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t W[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const int q = r >> 2, sh = (r & 3) * 8;
  uint32_t V[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    V[j] = q == 0 ? W[j] : q == 1 ? W[j + 1] : q == 2 ? W[j + 2] : W[j + 3];
  return make_uint4(__funnelshift_r(V[0], V[1], sh),
                    __funnelshift_r(V[1], V[2], sh),
                    __funnelshift_r(V[2], V[3], sh),
                    __funnelshift_r(V[3], V[4], sh));
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(__vadd4(a.x, b.x), __vadd4(a.y, b.y), __vadd4(a.z, b.z),
                    __vadd4(a.w, b.w));
}

// s_c[q] += the 16-byte group q at x0 of each of the n rows, for every
// group q of the chunk; the loads of 4 rows x the thread's groups go out
// at once (read from L2: other CTAs wrote them)
__device__ __forceinline__ void sum_rows(const uint8_t* const* rows, int n,
                                         long long x0, int n16, uint4* s_c,
                                         int tid) {
  constexpr int kG = kUnfChunk / 16 / kUnfThreads + 1;   // groups a thread
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  uint4 acc[kG];
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    const int q = tid + i * kUnfThreads;
    acc[i] = q < n16 ? s_c[q] : z;
  }
  for (int k = 0; k < n; k += 4) {
    uint4 x[4][kG];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const int q = tid + i * kUnfThreads;
        x[r][i] = k + r < n && q < n16
                      ? __ldcg(reinterpret_cast<const uint4*>(rows[k + r] +
                                                              x0) + q)
                      : z;
      }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < kG; ++i) acc[i] = add4(acc[i], x[r][i]);
  }
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    const int q = tid + i * kUnfThreads;
    if (q < n16) s_c[q] = acc[i];
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int m) {
  return (w[m >> 2] >> (8 * (m & 3))) & 255u;
}

// one Sub row of a chunk, in place, by one warp: `run` bytes a lane (a
// multiple of lcm(4, BPP)); carry: the row's last BPP bytes before the
// chunk, in two words, updated to the chunk's last BPP bytes
template <int BPP>
__device__ __forceinline__ void sub_row(uint32_t* row, int run, int lane,
                                        uint32_t* carry) {
  constexpr int G = BPP == 3 || BPP == 6 ? 12 : BPP == 8 ? 8 : 4;
  // read before the shuffles, which lane 31 passes only after every lane
  // has read: it rewrites the carry at the end
  const uint32_t in0 = carry[0], in1 = carry[1];
  uint32_t* w = row + lane * (run / 4);
  uint32_t tot[BPP];
#pragma unroll
  for (int k = 0; k < BPP; ++k) tot[k] = 0;
  for (int i = 0; i < run / 4; i += G / 4) {
    uint32_t g[G / 4];
#pragma unroll
    for (int t = 0; t < G / 4; ++t) g[t] = w[i + t];
#pragma unroll
    for (int m = 0; m < G; ++m) tot[m % BPP] += byte_of(g, m);
  }
  uint32_t s[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < BPP; ++k) s[k >> 2] |= (tot[k] & 255u) << (8 * (k & 3));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t a0 = __shfl_up_sync(~0u, s[0], o);
    const uint32_t a1 = __shfl_up_sync(~0u, s[1], o);
    if (lane >= o) {
      s[0] = __vadd4(s[0], a0);
      s[1] = __vadd4(s[1], a1);
    }
  }
  // exclusive: the lanes below, after the carry into the chunk
  uint32_t c0 = __shfl_up_sync(~0u, s[0], 1);
  uint32_t c1 = __shfl_up_sync(~0u, s[1], 1);
  if (lane == 0) c0 = c1 = 0u;
  c0 = __vadd4(c0, in0);
  c1 = __vadd4(c1, in1);
  uint32_t acc[BPP];
#pragma unroll
  for (int k = 0; k < BPP; ++k)
    acc[k] = ((k < 4 ? c0 : c1) >> (8 * (k & 3))) & 255u;
  for (int i = 0; i < run / 4; i += G / 4) {
    uint32_t g[G / 4], o[G / 4];
#pragma unroll
    for (int t = 0; t < G / 4; ++t) {
      g[t] = w[i + t];
      o[t] = 0u;
    }
#pragma unroll
    for (int m = 0; m < G; ++m) {
      acc[m % BPP] = (acc[m % BPP] + byte_of(g, m)) & 255u;
      o[m >> 2] |= acc[m % BPP] << (8 * (m & 3));
    }
#pragma unroll
    for (int t = 0; t < G / 4; ++t) w[i + t] = o[t];
  }
  if (lane == 31) {
    // the run ends on a class boundary: acc holds the last BPP bytes
    uint32_t n[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < BPP; ++k) n[k >> 2] |= acc[k] << (8 * (k & 3));
    carry[0] = n[0];
    carry[1] = n[1];
  }
}

template <int BPP>
__global__ void __launch_bounds__(kUnfThreads)
    unfilter_subup_kernel(const uint8_t* __restrict__ src, long long sp,
                          uint8_t* dst, long long dp, int h, int stride,
                          int rows, int chunk, int* status, uint8_t* agg,
                          int epoch) {
  __shared__ __align__(16) uint8_t tile[kUnfTile];
  __shared__ uint8_t s_tag[kUnfMaxRows];
  __shared__ uint32_t s_carry[kUnfMaxRows][2];
  __shared__ uint4 s_c[kUnfChunk / 16];     // the carry from above
  __shared__ const uint8_t* s_rows[32];      // rows to add into it
  __shared__ int s_band, s_first, s_n, s_done;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const int t = atomicAdd(status, 1);
    if (t == (int)gridDim.x - 1) atomicExch(status, 0);
    s_band = t;
  }
  __syncthreads();
  const int b = s_band;
  const long long y0 = (long long)b * rows;
  const int nr = (int)min((long long)rows, h - y0);
  const int nchunks = (stride + chunk - 1) / chunk;
  const long long bands = gridDim.x;
  int* flags = status + 1 + (long long)b * nchunks;
  uint32_t* t32 = reinterpret_cast<uint32_t*>(tile);
  for (int r = tid; r < nr; r += kUnfThreads) {
    s_tag[r] = __ldg(src + (y0 + r) * sp);
    s_carry[r][0] = s_carry[r][1] = 0u;
  }
  __syncthreads();
  if (tid == 0) {
    int f = 0;
    while (f < nr && s_tag[f] == 2) ++f;
    s_first = f;
  }
  __syncthreads();
  const int first = s_first;          // the band's first restart, or nr
  const bool look = b > 0 && first > 0;
  const bool inc_now = b == 0 || first < nr;
  const int cw4 = chunk / 4;
  for (int j = 0; j < nchunks; ++j) {
    const long long x0 = (long long)j * chunk;
    const int cw = (int)min((long long)chunk, stride - x0);
    const int n16 = (cw + 15) / 16;
    // 1. load
    for (int i = tid; i < nr * n16; i += kUnfThreads) {
      const int r = i / n16, q = i - r * n16;
      reinterpret_cast<uint4*>(tile + r * chunk)[q] =
          load16_at(src + (y0 + r) * sp + 1 + x0 + 16 * q,
                    min(16, cw - 16 * q));
    }
    __syncthreads();
    // 2. Sub
    for (int r = warp; r < nr; r += kUnfWarps)
      if (s_tag[r] == 1)
        sub_row<BPP>(t32 + r * cw4, chunk / 32, lane, s_carry[r]);
    __syncthreads();
    // 3. Up within the band
    for (int k = tid; k < 4 * n16; k += kUnfThreads) {
      uint32_t v = 0u;
      for (int r = 0; r < nr; ++r) {
        const uint32_t x = t32[r * cw4 + k];
        v = s_tag[r] == 2 ? __vadd4(v, x) : x;
        t32[r * cw4 + k] = v;
      }
    }
    __syncthreads();
    // 4. publish the last row
    {
      uint8_t* to = inc_now ? dst + (y0 + nr - 1) * dp + x0
                            : agg + (long long)b * dp + x0;
      for (int q = tid; q < n16; q += kUnfThreads)
        reinterpret_cast<uint4*>(to)[q] =
            reinterpret_cast<const uint4*>(tile + (nr - 1) * chunk)[q];
      __threadfence();
      __syncthreads();
      if (tid == 0) st_release(flags + j, 4 * epoch + (inc_now ? kInc : kAgg));
    }
    // 5. look back
    if (look) {
      for (int q = tid; q < n16; q += kUnfThreads)
        s_c[q] = make_uint4(0u, 0u, 0u, 0u);
      // within the band's block of kBlock bands: the nearest INC above,
      // with only AGGs below it, or all of them AGG
      const long long blk = b / kBlock, b0 = blk * kBlock;
      const int m = (int)(b - b0);                 // bands above in the block
      bool done = false;
      if (m > 0) {
        if (warp == 0) {
          const long long p = (long long)b - 1 - lane;
          const int* pf = status + 1 + p * nchunks + j;
          const unsigned valid = m >= 32 ? ~0u : (1u << m) - 1u;
          for (;;) {
            const int f = lane < m ? ld_acquire(pf) : 0;
            const unsigned inc = __ballot_sync(~0u, f == 4 * epoch + kInc);
            const unsigned ready = inc | __ballot_sync(~0u, f == 4 * epoch + kAgg);
            const unsigned hit = inc & valid;
            const unsigned below = hit ? (2u << (__ffs(hit) - 1)) - 1u : valid;
            if ((ready & below) == below) {
              const int n = __popc(below);
              if (lane < n)
                s_rows[lane] = lane + 1 == n && hit
                                   ? dst + (p * rows + rows - 1) * dp
                                   : agg + p * dp;
              if (lane == 0) {
                s_n = n;
                s_done = hit != 0;
              }
              break;
            }
            __nanosleep(64);
          }
        }
        __syncthreads();
        sum_rows(s_rows, s_n, x0, n16, s_c, tid);
        done = s_done;
        __syncthreads();
        if (!done && m == kBlock - 1 && !inc_now) {
          // the last band of an all-AGG block: the block's sum, its own
          // AGG included, for the blocks below to skip it by
          uint8_t* to = agg + (bands + blk) * dp + x0;
          for (int q = tid; q < n16; q += kUnfThreads)
            reinterpret_cast<uint4*>(to)[q] = add4(
                s_c[q],
                reinterpret_cast<const uint4*>(tile + (nr - 1) * chunk)[q]);
          __threadfence();
          __syncthreads();
          if (tid == 0)
            st_release(status + 1 + (bands + blk) * nchunks + j,
                       4 * epoch + kAgg);
        }
      }
      // the blocks above: each one's last band INC, or the block's sum
      for (long long top = blk; !done;) {
        if (warp == 0) {
          const long long B = top - 1 - lane;
          const long long e = B * kBlock + kBlock - 1;   // its last band
          for (;;) {
            const int f = B >= 0 ? ld_acquire(status + 1 + e * nchunks + j) : 0;
            const int g = B >= 0 ? ld_acquire(status + 1 +
                                              (bands + B) * nchunks + j)
                                 : 0;
            const unsigned valid = top >= 32 ? ~0u : (1u << top) - 1u;
            const unsigned inc = __ballot_sync(~0u, f == 4 * epoch + kInc) &
                                 valid;
            const unsigned sum = __ballot_sync(~0u, g == 4 * epoch + kAgg);
            const unsigned below = inc ? (2u << (__ffs(inc) - 1)) - 1u : valid;
            if (((sum | inc) & below) == below) {
              const int n = __popc(below);
              if (lane < n)
                s_rows[lane] = lane + 1 == n && inc
                                   ? dst + (e * rows + rows - 1) * dp
                                   : agg + (bands + B) * dp;
              if (lane == 0) {
                s_n = n;
                s_done = inc != 0;
              }
              break;
            }
            __nanosleep(64);
          }
        }
        __syncthreads();
        sum_rows(s_rows, s_n, x0, n16, s_c, tid);
        done = s_done;
        top -= s_n;
        __syncthreads();
      }
      const int fix = inc_now ? first : nr;
      for (int q = tid; q < n16; q += kUnfThreads) {
        const uint4 c = s_c[q];
        for (int r = 0; r < fix; ++r) {
          uint4* t = reinterpret_cast<uint4*>(tile + r * chunk) + q;
          *t = add4(*t, c);
        }
      }
      __syncthreads();
    }
    // 6. store (the last row is out already when INC went out above)
    const int out_rows = inc_now ? nr - 1 : nr;
    for (int i = tid; i < out_rows * n16; i += kUnfThreads) {
      const int r = i / n16, q = i - r * n16;
      reinterpret_cast<uint4*>(dst + (y0 + r) * dp + x0)[q] =
          reinterpret_cast<const uint4*>(tile + r * chunk)[q];
    }
    if (!inc_now) {
      __threadfence();
      __syncthreads();
      if (tid == 0) st_release(flags + j, 4 * epoch + kInc);
    }
    __syncthreads();   // the tile is read before the next chunk loads
  }
}

template <int BPP>
int launch_unfilter_subup(const uint8_t* src, long long sp, uint8_t* dst,
                          long long dp, int h, int stride, int rows, int chunk,
                          int* status, uint8_t* agg, int epoch,
                          cudaStream_t st) {
  const long long bands = (h + (long long)rows - 1) / rows;
  unfilter_subup_kernel<BPP><<<(unsigned)bands, kUnfThreads, 0, st>>>(
      src, sp, dst, dp, h, stride, rows, chunk, status, agg, epoch);
  return (int)cudaGetLastError();
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
// stride filtered bytes; dst: h rows at dst_pitch, a multiple of 16
// bytes, dst 16-byte aligned; bands of `rows` rows walked in chunks of
// `chunk` bytes (a multiple of 768, at most kUnfChunk, rows * chunk at
// most kUnfTile); with blocks = ceil(bands / kBlock), status: 1 +
// (bands + blocks) * chunks int32, word 0 zero and no other word written
// by a launch of this epoch (epoch in [1, 2**29)); agg: bands + blocks
// rows of dst_pitch bytes of scratch
int ffpic_unfilter_subup(const void* src, long long src_pitch, void* dst,
                         long long dst_pitch, int h, int stride, int bpp,
                         int rows, int chunk, void* status, void* agg,
                         int epoch, void* stream) {
  if (h <= 0 || stride <= 0 || src_pitch <= stride || dst_pitch < stride ||
      dst_pitch % 16 || ((uintptr_t)dst & 15) || rows < 1 ||
      rows > kUnfMaxRows || chunk < 768 || chunk % 768 || chunk > kUnfChunk ||
      (long long)rows * chunk > kUnfTile || epoch < 1 || epoch >= (1 << 29) ||
      !status || !agg)
    return (int)cudaErrorInvalidValue;
  const uint8_t* s = (const uint8_t*)src;
  uint8_t* d = (uint8_t*)dst;
  int* st = (int*)status;
  uint8_t* a = (uint8_t*)agg;
  cudaStream_t cs = (cudaStream_t)stream;
  switch (bpp) {
    case 1: return launch_unfilter_subup<1>(s, src_pitch, d, dst_pitch, h, stride, rows, chunk, st, a, epoch, cs);
    case 2: return launch_unfilter_subup<2>(s, src_pitch, d, dst_pitch, h, stride, rows, chunk, st, a, epoch, cs);
    case 3: return launch_unfilter_subup<3>(s, src_pitch, d, dst_pitch, h, stride, rows, chunk, st, a, epoch, cs);
    case 4: return launch_unfilter_subup<4>(s, src_pitch, d, dst_pitch, h, stride, rows, chunk, st, a, epoch, cs);
    case 6: return launch_unfilter_subup<6>(s, src_pitch, d, dst_pitch, h, stride, rows, chunk, st, a, epoch, cs);
    case 8: return launch_unfilter_subup<8>(s, src_pitch, d, dst_pitch, h, stride, rows, chunk, st, a, epoch, cs);
    default: return (int)cudaErrorInvalidValue;
  }
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
