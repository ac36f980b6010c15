// VP8 (lossy WebP) decode kernels for Hopper (sm_90a): the device stages
// of ffpic_tpu_torch.formats.vp8 and formats.webp.
//
//   K12 vp8_residuals    raw token levels (mbh, mbw, 25, 16) int32, the
//                        per-macroblock dequant factors (mbh, mbw, 6)
//                        int32 and has_y2 (mbh, mbw) -> the residuals
//                        (mbh, mbw, 24, 4, 4) int16: dequant, Y2 inverse
//                        WHT, DC scatter and the 4x4 inverse DCT
//   K13 vp8_yuv_to_rgba  a list of frames' Y, U, V planes (any row
//                        pitch) -> each frame's (h, w, 4) uint8 RGBA, in
//                        one launch: libwebp's fancy chroma upsampling
//                        and fixed-point colour matrix, alpha 255 or from
//                        an (h, w) plane
//   K18 vp8_wavefront    residuals (mbh, mbw, 16, 4, 4) int32, ymode
//                        (mbh, mbw) and bmodes (mbh, mbw, 16) int32 ->
//                        the luma plane (16 mbh, 16 mbw) uint8: the whole
//                        frame's intra prediction and reconstruction in
//                        one launch, rows of macroblocks advancing behind
//                        each other
//
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError(). All
// arithmetic is integer and follows the JAX reference exactly, wrap for
// wrap.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

// Two's-complement wraps: through uint32_t, as K2 does, so that no signed
// overflow is left to the compiler.
__device__ __forceinline__ int w16(int x) {
  return (int)(int16_t)(uint16_t)(uint32_t)x;
}
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// K12. Replaces ffpic_tpu/ops/vp8_kernels.py:vp8_residuals (:69), with
// vp8_iwht4x4 (:52) and vp8_idct4x4 (:28) inside.
// Bound: it reads each level once (1,600 bytes a macroblock) and writes
// each residual once (768 bytes), 19.5 MB at 1920x1080; about 60 integer
// operations a coefficient are nothing beside that, so it is bound by
// bytes.
//
// A thread per 4x4 block, 24 a macroblock (16 Y, 4 U, 4 V), in block
// order, so a warp reads and writes runs of neighbouring blocks. Each
// thread dequantises its 16 levels (index 0 the DC factor, 1-15 the AC
// factor; Y the y1 pair, U and V the uv pair, all int32 products that
// wrap as the reference's do). The Y threads of a macroblock with a Y2
// block each compute the one row of the Y2 inverse WHT that holds their
// DC: the Y2 levels dequantised (y2dc, y2ac) and wrapped to int16, a
// column pass for that row (4 x 4 adds) and the row's output at the
// thread's column, wrapped to int16. That costs 16 loads of one 64-byte
// row that the macroblock's 16 threads share in L1, cheaper than a
// shared-memory round trip and a barrier. Without a Y2 block the DC
// stays the unwrapped int32 product. Then the block is wrapped to int16
// and takes the 4x4 IDCT: the first pass combines rows for each column
// and wraps each result to int16, so (x * 35468) >> 16, an arithmetic
// shift of a signed int32, stays under 2^31; the second pass combines the
// columns of each row, (x + 4) >> 3, wrapped to int16. The 32 output
// bytes go out as two 16-byte stores.
constexpr int kResThreads = 256;

__global__ void __launch_bounds__(kResThreads)
    vp8_residuals_kernel(const int* __restrict__ levels,
                         const int* __restrict__ dq,
                         const uint8_t* __restrict__ has_y2,
                         int16_t* __restrict__ out, long long nblocks) {
  const long long t = (long long)blockIdx.x * kResThreads + threadIdx.x;
  if (t >= nblocks) return;
  const long long mb = t / 24;
  const int b = (int)(t - mb * 24);
  const int* lv = levels + mb * 400;
  const int* d = dq + mb * 6;
  const int dcf = __ldg(d + (b < 16 ? 0 : 4));
  const int acf = __ldg(d + (b < 16 ? 1 : 5));

  int in[16];
#pragma unroll
  for (int k = 0; k < 16; k++)
    in[k] = mul32(__ldg(lv + b * 16 + k), k ? acf : dcf);

  if (b < 16 && __ldg(has_y2 + mb)) {
    const int y2dc = __ldg(d + 2), y2ac = __ldg(d + 3);
    const int r = b >> 2, c = b & 3;
    int tr[4];    // row r of the first pass, one value a column q
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const int i0 = w16(mul32(__ldg(lv + 384 + q), q ? y2ac : y2dc));
      const int i1 = w16(mul32(__ldg(lv + 388 + q), y2ac));
      const int i2 = w16(mul32(__ldg(lv + 392 + q), y2ac));
      const int i3 = w16(mul32(__ldg(lv + 396 + q), y2ac));
      const int a1 = i0 + i3, b1 = i1 + i2, c1 = i1 - i2, d1 = i0 - i3;
      tr[q] = r == 0 ? a1 + b1 : r == 1 ? c1 + d1 : r == 2 ? a1 - b1
                                                           : d1 - c1;
    }
    const int a1 = tr[0] + tr[3], b1 = tr[1] + tr[2];
    const int c1 = tr[1] - tr[2], d1 = tr[0] - tr[3];
    const int v = c == 0 ? a1 + b1 : c == 1 ? c1 + d1 : c == 2 ? a1 - b1
                                                               : d1 - c1;
    in[0] = w16((v + 3) >> 3);
  }

  constexpr int C1 = 20091, C2 = 35468;
  int tmp[16];
#pragma unroll
  for (int x = 0; x < 4; x++) {     // first pass: rows, for each column
    const int i0 = w16(in[x]), i1 = w16(in[4 + x]);
    const int i2 = w16(in[8 + x]), i3 = w16(in[12 + x]);
    const int a0 = i0 + i2, a1 = i0 - i2;
    const int a2 = ((i1 * C2) >> 16) - i3 - ((i3 * C1) >> 16);
    const int a3 = i1 + ((i1 * C1) >> 16) + ((i3 * C2) >> 16);
    tmp[x] = w16(a0 + a3);
    tmp[4 + x] = w16(a1 + a2);
    tmp[8 + x] = w16(a1 - a2);
    tmp[12 + x] = w16(a0 - a3);
  }
  union {
    int16_t h[16];
    int4 v[2];
  } o;
#pragma unroll
  for (int y = 0; y < 4; y++) {     // second pass: columns, for each row
    const int j0 = tmp[4 * y], j1 = tmp[4 * y + 1];
    const int j2 = tmp[4 * y + 2], j3 = tmp[4 * y + 3];
    const int a0 = j0 + j2, a1 = j0 - j2;
    const int a2 = ((j1 * C2) >> 16) - j3 - ((j3 * C1) >> 16);
    const int a3 = j1 + ((j1 * C1) >> 16) + ((j3 * C2) >> 16);
    o.h[4 * y] = (int16_t)w16((a0 + a3 + 4) >> 3);
    o.h[4 * y + 1] = (int16_t)w16((a1 + a2 + 4) >> 3);
    o.h[4 * y + 2] = (int16_t)w16((a1 - a2 + 4) >> 3);
    o.h[4 * y + 3] = (int16_t)w16((a0 - a3 + 4) >> 3);
  }
  int4* dst = reinterpret_cast<int4*>(out + t * 16);
  dst[0] = o.v[0];
  dst[1] = o.v[1];
}

// K13. Replaces ffpic_tpu/ops/vp8_kernels.py:vp8_yuv_to_rgba (:107), and
// the alpha plane's write that follows it (ffpic_tpu/formats/webp.py:311).
// Bound: it reads Y once, U and V once (a quarter each) and the alpha
// plane where there is one, and writes 4 bytes a pixel: 11.4 MB at
// 1920x1080 without alpha. About 40 integer operations a pixel (83 M at
// 1080p, 0.0025 ms at the int32 rate) come close to that, so it is bound
// by bytes with little room to spare in instructions.
//
// One launch over a list of frames (a batch's WebP stills), each a
// ColorFrame passed by value (__grid_constant__: no copy before the
// launch; a CTA reads its frame from the constant bank). kMaxFrames
// descriptors of 88 bytes take 5.6 KB of parameters, past the 4 KB of
// older toolkits and inside the 32 KB that CUDA 12.1+ gives sm_90; a
// longer list takes a launch for each kMaxFrames frames. A CTA takes a
// tile of kTileRows x kTileCols output pixels of one frame, which it finds
// by a binary search over the frames' first tiles (a prefix the launcher
// fills in). It stages the tile's U and V samples, kTileRows / 2 rows of
// kTileCols / 2, with a halo of one row and one column on each side, in
// shared memory: 16-byte loads where the plane's rows are 16-byte aligned
// and the chunk lies inside the cropped chroma grid ((h + 1) / 2, (w + 1)
// / 2), bytes otherwise. Every row and column is clamped to that grid as
// it is staged, so the MB padding is never read and the frame's edges
// come out replicated; each chroma byte comes from device memory once
// (the halo rows again, from L2), where the quad-a-thread design fetched
// each about 9 times through L1.
//
// Each thread then writes runs of kRun = 8 pixels of a row: the run's Y
// (and alpha) in one 8-byte load where the plane's rows are 8-byte
// aligned, else bytes; its 4 chroma samples as one 32-bit word of shared
// memory and their two neighbours as bytes, in the samples' own row a
// and in the row b above (even output rows) or below (odd ones). The
// fancy upsampling (9 a + 3 (b + a') + b' + 8) >> 4 is separable: with
// s = 3 a + b a column's vertical mix, a pixel takes (3 s + s' + 8) >> 4,
// s' its left (even x) or right (odd x) neighbour's mix. Then each
// _mult_hi term is floored on its own and (sum >> 6) is clipped to
// 0..255 (yuv_pixel). A run goes out in the widest aligned stores its
// address allows (store_run): two 16-byte stores where the RGBA rows are
// 16-byte aligned (w % 4 == 0), 4-, 8- and 16-byte ones otherwise, and a
// run cut by the row's end pixel by pixel, only the pixels inside the
// frame. kMinCtas = 8 CTAs an SM (32 registers a thread, no spills) keep
// the most loads in flight; the sweep of tiles, CTAs an SM and of
// loading Y before the staging that set these constants is in PERF.md
// (python3 -m ffpic_tpu_torch.tune_vp8_color).
constexpr int kColorThreads = 256;
constexpr int kTileRows = 32;                    // output rows a CTA
constexpr int kTileCols = 128;                   // output pixels a row
constexpr int kRun = 8;                          // pixels a thread's run
constexpr int kChromaRows = kTileRows / 2 + 2;   // staged, with the halo
constexpr int kChromaCols = kTileCols / 2;       // staged, besides it
// a staged row: the left halo at 15, samples from 16, the right halo at
// 16 + kChromaCols
constexpr int kChromaPitch = kChromaCols + 32;
constexpr int kRunsRow = kTileCols / kRun;
constexpr int kRunsThread = kTileRows * kRunsRow / kColorThreads;
constexpr int kMinCtas = 8;                      // CTAs an SM, at least
constexpr int kMaxFrames = 64;
static_assert(kTileRows % 2 == 0 && kTileCols % 32 == 0,
              "a tile covers whole chroma rows and 16-byte chunks");
static_assert(kRunsThread * kColorThreads == kTileRows * kRunsRow,
              "whole runs a thread");

// One frame: its planes' rows at y + row * ys (and u, v, a alike; a null
// without alpha), its RGBA at out, h x w x 4 contiguous; tile0 and
// tiles_x filled in by the launcher. 88 bytes: the eleven 64-bit words of
// ops.cuda_vp8.frame_words.
struct ColorFrame {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  const uint8_t* a;
  uint8_t* out;
  long long ys, us, vs, as;
  int h, w;
  int tile0, tiles_x;
};
static_assert(sizeof(ColorFrame) == 88, "ops.cuda_vp8.FRAME_WORDS words");

struct ColorFrames {
  ColorFrame f[kMaxFrames];
};

__device__ __forceinline__ int clip8(int x) {
  x >>= 6;
  return x < 0 ? 0 : (x > 255 ? 255 : x);
}

__device__ __forceinline__ uint32_t yuv_pixel(int y, int u, int v,
                                              uint32_t a) {
  const int yv = (y * 19077) >> 8;
  const int r = yv + ((v * 26149) >> 8) - 14234;
  const int g = yv - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708;
  const int b = yv + ((u * 33050) >> 8) - 17685;
  return (uint32_t)clip8(r) | (uint32_t)clip8(g) << 8 |
         (uint32_t)clip8(b) << 16 | a << 24;
}

// The upsampled chroma of a run from its staged rows: a the samples' own
// row, b its vertical neighbour, k0 (a multiple of 4) the run's first
// sample.
__device__ __forceinline__ void chroma_run(const uint8_t* a, const uint8_t* b,
                                           int k0, int m[kRun]) {
  const uint32_t wa = *reinterpret_cast<const uint32_t*>(a + 16 + k0);
  const uint32_t wb = *reinterpret_cast<const uint32_t*>(b + 16 + k0);
  int s[6];
  s[0] = 3 * a[15 + k0] + b[15 + k0];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s[1 + i] = 3 * (int)((wa >> (8 * i)) & 255u) +
               (int)((wb >> (8 * i)) & 255u);
  s[5] = 3 * a[20 + k0] + b[20 + k0];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 3 * s[1 + i] + 8;
    m[2 * i] = (t + s[i]) >> 4;
    m[2 * i + 1] = (t + s[2 + i]) >> 4;
  }
}

// kRun bytes of a row from p as two words, byte k at bits 8 (k % 4) of
// word k / 4: one 8-byte load where the run is whole and p 8-byte
// aligned, else the first n bytes one by one (the rest zero).
__device__ __forceinline__ void load_run(const uint8_t* p, int n, bool wide,
                                         uint32_t w[2]) {
  if (n == kRun && wide) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
    return;
  }
  w[0] = w[1] = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k)
    if (k < n) w[k >> 2] |= (uint32_t)__ldg(p + k) << (8 * (k & 3));
}

// n pixels of a run at o (4-byte aligned): a whole run in the widest
// stores that o's alignment allows, a cut one a pixel at a time.
__device__ __forceinline__ void store_run(uint32_t* o, const uint32_t px[kRun],
                                          int n) {
  if (n < kRun) {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < n) o[k] = px[k];
    return;
  }
  uint2* o2 = reinterpret_cast<uint2*>(o);  // at 8 bytes a step
  uint4* o4 = reinterpret_cast<uint4*>(o);  // at 16
  switch (((uintptr_t)o >> 2) & 3) {
    case 0:
      o4[0] = make_uint4(px[0], px[1], px[2], px[3]);
      o4[1] = make_uint4(px[4], px[5], px[6], px[7]);
      break;
    case 1:
      o[0] = px[0];
      *reinterpret_cast<uint2*>(o + 1) = make_uint2(px[1], px[2]);
      *reinterpret_cast<uint4*>(o + 3) = make_uint4(px[3], px[4], px[5],
                                                    px[6]);
      o[7] = px[7];
      break;
    case 2:
      o2[0] = make_uint2(px[0], px[1]);
      *reinterpret_cast<uint4*>(o + 2) = make_uint4(px[2], px[3], px[4],
                                                    px[5]);
      o2[3] = make_uint2(px[6], px[7]);
      break;
    default:
      o[0] = px[0];
      *reinterpret_cast<uint4*>(o + 1) = make_uint4(px[1], px[2], px[3],
                                                    px[4]);
      *reinterpret_cast<uint2*>(o + 5) = make_uint2(px[5], px[6]);
      o[7] = px[7];
  }
}

__global__ void __launch_bounds__(kColorThreads, kMinCtas)
    vp8_yuv_to_rgba_kernel(const __grid_constant__ ColorFrames fs, int n) {
  __shared__ __align__(16) uint8_t sc[2][kChromaRows][kChromaPitch];
  int lo = 0, hi = n - 1;     // the last frame whose first tile <= this
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (fs.f[mid].tile0 <= (int)blockIdx.x)
      lo = mid;
    else
      hi = mid - 1;
  }
  const ColorFrame& f = fs.f[lo];
  const int h = f.h, w = f.w, ch = (h + 1) >> 1, cw = (w + 1) >> 1;
  const int t = (int)blockIdx.x - f.tile0, ty = t / f.tiles_x;
  const int y0 = ty * kTileRows, x0 = (t - ty * f.tiles_x) * kTileCols;
  const int cy0 = y0 >> 1, cx0 = x0 >> 1;

  // the chroma tile: staged row r holds chroma row cy0 - 1 + r, staged
  // column k column cx0 + k, each clamped to the cropped grid
  const bool wide = (((uintptr_t)f.u | (uintptr_t)f.v | (uintptr_t)f.us |
                      (uintptr_t)f.vs) & 15) == 0;
  constexpr int kChunks = kChromaCols / 16;
  for (int i = threadIdx.x; i < 2 * kChromaRows * kChunks;
       i += kColorThreads) {
    const int p = i / (kChromaRows * kChunks);
    const int r = i / kChunks - p * kChromaRows, c = i % kChunks;
    const long long row = min(max(cy0 - 1 + r, 0), ch - 1);
    const uint8_t* src = p ? f.v + row * f.vs : f.u + row * f.us;
    const int cc = cx0 + 16 * c;
    uint8_t* dst = &sc[p][r][16 + 16 * c];
    if (wide && cc + 16 <= cw) {
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(src + cc));
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) dst[k] = __ldg(src + min(cc + k, cw - 1));
    }
  }
  for (int i = threadIdx.x; i < 4 * kChromaRows; i += kColorThreads) {
    const int p = i / (2 * kChromaRows), side = i & 1;
    const int r = (i >> 1) - p * kChromaRows;
    const long long row = min(max(cy0 - 1 + r, 0), ch - 1);
    const uint8_t* src = p ? f.v + row * f.vs : f.u + row * f.us;
    sc[p][r][side ? 16 + kChromaCols : 15] =
        __ldg(src + (side ? min(cx0 + kChromaCols, cw - 1) : max(cx0 - 1, 0)));
  }
  __syncthreads();

  // this thread's runs: run i of the tile is row i / kRunsRow, column i %
  // kRunsRow
  const bool y8 = (((uintptr_t)f.y | (uintptr_t)f.ys) & 7) == 0;
  const bool a8 = (((uintptr_t)f.a | (uintptr_t)f.as) & 7) == 0;
#pragma unroll
  for (int j = 0; j < kRunsThread; ++j) {
    const int i = threadIdx.x + j * kColorThreads;
    const int r = i / kRunsRow, c = i - r * kRunsRow;
    const int y = y0 + r, x = x0 + kRun * c;
    const int n = y < h ? min(kRun, w - x) : 0;
    if (n <= 0) continue;
    uint32_t yw[2], aw[2] = {~0u, ~0u};
    load_run(f.y + y * f.ys + x, n, y8, yw);
    if (f.a) load_run(f.a + y * f.as + x, n, a8, aw);
    const int ra = (r >> 1) + 1, rb = r & 1 ? ra + 1 : ra - 1;
    int mu[kRun], mv[kRun];
    chroma_run(sc[0][ra], sc[0][rb], 4 * c, mu);
    chroma_run(sc[1][ra], sc[1][rb], 4 * c, mv);
    uint32_t px[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int sh = 8 * (k & 3);
      px[k] = yuv_pixel((int)((yw[k >> 2] >> sh) & 255u), mu[k], mv[k],
                        (aw[k >> 2] >> sh) & 255u);
    }
    store_run(reinterpret_cast<uint32_t*>(f.out) + (long long)y * w + x, px,
              n);
  }
}

// K18. Replaces ffpic_tpu/ops/vp8_wavefront.py:make_wavefront (:171), a
// lax.scan over the 2 (mbh - 1) + mbw macroblock (MB) anti-diagonals. Its
// plain version is ops.vp8_wavefront.vp8_wavefront_plain, whose module
// docstring lists the edge rules this kernel keeps.
// Bound: each residual read once (1 KB an MB), the modes (68 bytes) and
// each luma byte written once (256), 11.0 MB at 1920x1080, 0.0033 ms at
// 3.35 TB/s; but the work is a chain: MB (my, mx) needs (my, mx - 1),
// (my - 1, mx) and (my - 1, mx + 1), so at least 2 (mbh - 1) + mbw MB
// steps run one after another (254 at 1080p), mbh - 1 of them hand-offs
// from one row to the next, and inside a B_PRED MB 10 steps of 4x4
// subblocks. What sets the time is the longest path through that graph,
// each MB weighted by its step's latency (c, a B_PRED MB's several times a
// 16x16 one's) and each row hand-off by its own (L).
//
// Design: one launch a frame. A CTA of kRowWarps warps takes a group of
// kRowWarps MB rows from a ticket counter (atomicAdd), a warp a row, and
// takes another group when all its rows are done; a warp walks its row
// left to right. The card need not schedule CTAs in blockIdx order, so a
// row never waits on a row that a CTA has not yet claimed: the row above
// is always held by a CTA that is already running (or by a warp of the
// same CTA), and row 0 waits on nothing. Nothing on a step's chain waits
// on memory that could have been read earlier:
//
// * the hand-off is one record an MB: the MB's bottom 16 pixels as four
//   64-bit words, each 4 pixels beside a nonzero tag, written by the 4
//   lanes that hold row 15. A 64-bit word is read or written whole, so a
//   word read with its tag set holds its pixels: the pixels and the flag
//   arrive in one round trip, with no fence, acquire or release. Between
//   the warps of a CTA the records go through a ring of kRing slots in
//   shared memory (tag: the MB's index + 1; a slot is written again only
//   once the row below has taken its record); from a CTA's last row to
//   the next group's first they go through scratch memory, zeroed for
//   every launch (tag 1), stored and read relaxed at gpu scope;
// * MB mx + 1's residuals (32 bytes a lane, two 16-byte loads) and modes
//   are loaded into registers while MB mx runs, and, for a CTA's first
//   row, the record above MB mx + 2;
// * a 16x16 MB runs in registers: lane 2 sb + h holds rows 2h and 2h + 1
//   of subblock sb (sy = sb / 4, sx = sb % 4) as two words of 4 bytes,
//   which are also the residuals' order (8 int32 a lane, a coalesced
//   run). The row above (four words, one per subblock column), the
//   corner and the left column (four words: the previous MB's column 15,
//   passed by __shfl_sync) are values every lane holds. No barrier: the
//   warp's mode is one, so no lane diverges;
// * B_PRED runs its 16 subblocks as their own wavefront, step 2 sy + sx
//   (0..9), on the whole warp: a step has one or two subblocks, and its
//   lanes 16a..16a + 15 take the step's a-th, a pixel each, so no lane
//   waits for its own subblock's turn. The MB's edges, its pixels and its
//   residuals lie in a patch of the warp's shared memory; a lane reads
//   its subblock's 13 edges there (the right column's above-right from
//   the row above the MB, columns 16..19, at every sy), writes its pixel
//   back, and a __syncwarp closes the step;
// * a B_PRED pixel of the eight averaging modes is four edges from a
//   table, (sum + 2) >> 2: the edges lie as 13 bytes in four words, the
//   four are gathered by two byte permutes (prmt) and a mask and summed
//   by one dp4a; DC and TM are formulas.
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 4;       // MB rows (warps) a CTA
constexpr int kWaveThreads = 32 * kRowWarps;
constexpr int kRing = 16;          // a power of two
constexpr unsigned long long kRecTag = 1ull << 32;

// Each averaging B-mode (VE, HE, RD, VR, LD, VL, HD, HU: bitstream modes
// 2..9) at pixel r * 4 + c of a subblock: four edge indices, a byte each
// (low byte first), into {X, A, B, C, D, E, F, G, H, I, J, K, L} (corner,
// 4 above, 4 above-right, 4 left); avg3(a, b, c) is (a, b, b, c) and
// avg2(a, b) is (a, a, b, b). The same table as ops.vp8_wavefront.B4_TAPS.
__device__ const uint32_t kB4Taps[8][16] = {
    {0x02010100, 0x03020201, 0x04030302, 0x05040403,  // VE
     0x02010100, 0x03020201, 0x04030302, 0x05040403,
     0x02010100, 0x03020201, 0x04030302, 0x05040403,
     0x02010100, 0x03020201, 0x04030302, 0x05040403},
    {0x0a090900, 0x0a090900, 0x0a090900, 0x0a090900,  // HE
     0x0b0a0a09, 0x0b0a0a09, 0x0b0a0a09, 0x0b0a0a09,
     0x0c0b0b0a, 0x0c0b0b0a, 0x0c0b0b0a, 0x0c0b0b0a,
     0x0c0c0c0b, 0x0c0c0c0b, 0x0c0c0c0b, 0x0c0c0c0b},
    {0x09000001, 0x00010102, 0x01020203, 0x02030304,  // RD
     0x0a090900, 0x09000001, 0x00010102, 0x01020203,
     0x0b0a0a09, 0x0a090900, 0x09000001, 0x00010102,
     0x0c0b0b0a, 0x0b0a0a09, 0x0a090900, 0x09000001},
    {0x01010000, 0x02020101, 0x03030202, 0x04040303,  // VR
     0x01000009, 0x02010100, 0x03020201, 0x04030302,
     0x0009090a, 0x01010000, 0x02020101, 0x03030202,
     0x090a0a0b, 0x01000009, 0x02010100, 0x03020201},
    {0x03020201, 0x04030302, 0x05040403, 0x06050504,  // LD
     0x04030302, 0x05040403, 0x06050504, 0x07060605,
     0x05040403, 0x06050504, 0x07060605, 0x08070706,
     0x06050504, 0x07060605, 0x08070706, 0x08080807},
    {0x02020101, 0x03030202, 0x04040303, 0x05050404,  // VL
     0x03020201, 0x04030302, 0x05040403, 0x06050504,
     0x03030202, 0x04040303, 0x05050404, 0x07060605,
     0x04030302, 0x05040403, 0x06050504, 0x08070706},
    {0x09090000, 0x01000009, 0x02010100, 0x03020201,  // HD
     0x0a0a0909, 0x0a090900, 0x09090000, 0x01000009,
     0x0b0b0a0a, 0x0b0a0a09, 0x0a0a0909, 0x0a090900,
     0x0c0c0b0b, 0x0c0b0b0a, 0x0b0b0a0a, 0x0b0a0a09},
    {0x0a0a0909, 0x0b0a0a09, 0x0b0b0a0a, 0x0c0b0b0a,  // HU
     0x0b0b0a0a, 0x0c0b0b0a, 0x0c0c0b0b, 0x0c0c0c0b,
     0x0c0c0b0b, 0x0c0c0c0b, 0x0c0c0c0c, 0x0c0c0c0c,
     0x0c0c0c0c, 0x0c0c0c0c, 0x0c0c0c0c, 0x0c0c0c0c},
};


__device__ __forceinline__ unsigned long long ld_relaxed64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v));
}

__device__ __forceinline__ int clip255(int x) {
  return x < 0 ? 0 : (x > 255 ? 255 : x);
}

// Word i of the record whose word `lane` lanes 0-3 hold in v, on every lane.
__device__ __forceinline__ void record_words(unsigned long long v,
                                             uint32_t (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = __shfl_sync(kFull, (uint32_t)v, i);
}

// The record at p in device memory, on every lane: lanes 0-3 hold in v
// word `lane` as last read (an MB ago); the words not yet written are
// read again until all four are.
__device__ __forceinline__ void await_global(const unsigned long long* p,
                                             unsigned long long v, int lane,
                                             uint32_t (&w)[4]) {
  while (!__all_sync(kFull, lane >= 4 || (v >> 32) != 0)) {
    if (lane < 4 && (v >> 32) == 0) v = ld_relaxed64(p + lane);
  }
  record_words(v, w);
}

// The record of MB m in a shared-memory ring slot, on every lane, once
// its four words carry the tag m + 1.
__device__ __forceinline__ void await_shared(
    const volatile unsigned long long* slot, uint32_t tag, int lane,
    uint32_t (&w)[4]) {
  unsigned long long v = lane < 4 ? slot[lane] : 0;
  while (!__all_sync(kFull, lane >= 4 || (uint32_t)(v >> 32) == tag)) {
    if (lane < 4) v = slot[lane];
  }
  record_words(v, w);
}

// B_PRED pixel c of a subblock row: the edges as the bytes of v0..v3 ({X,
// A, B, C}, {D, E, F, G}, {H, I, J, K}, {L}), its four edge indices as a
// prmt selector (sel) and a byte mask of those past 7 (msk); DC's value
// dc, TM's left pixel minus the corner lx and the pixels above wa; the
// residual r. Returns the reconstructed pixel.
__device__ __forceinline__ int bpred_pixel(uint32_t v0, uint32_t v1,
                                           uint32_t v2, uint32_t v3,
                                           uint32_t sel, uint32_t msk,
                                           int mode, int dc, int lx,
                                           uint32_t wa, int c, int r) {
  const uint32_t g = (__byte_perm(v0, v1, sel) & ~msk) |
                     (__byte_perm(v2, v3, sel) & msk);
  const int avg = (int)(__dp4a(g, 0x01010101u, 2u) >> 2);
  const int tm = clip255(lx + (int)((wa >> (8 * c)) & 255u));
  const int pred = mode == 0 ? dc : (mode == 1 ? tm : avg);
  return clip255((int)((unsigned)pred + (unsigned)r));
}

// Four pixels' prediction bytes plus four residuals, each sum wrapped to
// int32 and clipped: the reconstructed row, 4 bytes.
__device__ __forceinline__ uint32_t add_row(uint32_t pred, int4 r) {
  const int rv[4] = {r.x, r.y, r.z, r.w};
  uint32_t out = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    out |= (uint32_t)clip255((int)(((pred >> (8 * c)) & 255u) +
                                   (unsigned)rv[c])) << (8 * c);
  return out;
}

// A 16x16 prediction row of 4 pixels: mode 0..3 (DC, V, H, TM); dc the
// DC value, a the 4 pixels above, l the left pixel, x the MB's corner.
__device__ __forceinline__ uint32_t mb16_row(int mode, int dc, uint32_t a,
                                             int l, int x) {
  if (mode == 0) return (uint32_t)dc * 0x01010101u;
  if (mode == 1) return a;
  if (mode == 2) return (uint32_t)l * 0x01010101u;
  uint32_t out = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    out |= (uint32_t)clip255(l + (int)((a >> (8 * c)) & 255u) - x)
           << (8 * c);
  return out;
}

// B_PRED's shared memory, a warp's: the MB's 17 x 24 byte patch (row 0:
// bytes 3 the corner, 4..19 the 16 pixels above, 20..23 the 4 above-right;
// rows 1..16: byte 3 the pixel to the left, 4..19 the MB's row) and its 256
// residuals in the residual tensor's order.
constexpr int kPatchPitch = 24;
struct BPredScratch {
  uint32_t patch[17 * kPatchPitch / 4];
  int4 res[64];
};

// res: nmb x 256 int32; ymode: nmb; bmodes: nmb x 16; Y: (16 mbh) x (16
// mbw) bytes; scratch: 1 + 4 mbh mbw words, zeroed: the ticket of row
// groups (an int in word 0), then each MB's record, 4 words.
__global__ void __launch_bounds__(kWaveThreads)
    vp8_wavefront_kernel(const int* __restrict__ res,
                         const int* __restrict__ ymode,
                         const int* __restrict__ bmodes,
                         uint8_t* __restrict__ Y,
                         unsigned long long* __restrict__ scratch, int mbh,
                         int mbw) {
  __shared__ uint2 s_tap[8][16];      // (sel, msk) of B-modes 2..9
  __shared__ BPredScratch s_bp[kRowWarps];
  __shared__ unsigned long long s_rec[kRowWarps > 1 ? kRowWarps - 1 : 1]
                                     [kRing][4];
  __shared__ int s_taken[kRowWarps];  // records row w has taken from w - 1
  __shared__ int s_group;
  for (int i = threadIdx.x; i < 8 * 16; i += kWaveThreads) {
    const uint32_t q = kB4Taps[i >> 4][i & 15];
    uint32_t sel = 0, msk = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t t = (q >> (8 * b)) & 255u;
      sel |= (t & 7u) << (4 * b);
      msk |= (t >= 8 ? 0xffu : 0u) << (8 * b);
    }
    s_tap[i >> 4][i & 15] = make_uint2(sel, msk);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this lane's pixels outside B_PRED's steps: rows 2h, 2h + 1 of
  // subblock sb
  const int sb = lane >> 1, h = lane & 1, sy = sb >> 2, sx = sb & 3;
  const long long W = 16LL * mbw;
  int* ticket = reinterpret_cast<int*>(scratch);
  unsigned long long* rec = scratch + 1;
  volatile unsigned long long* ring_in =
      warp > 0 ? &s_rec[warp - 1][0][0] : nullptr;
  volatile unsigned long long* ring_out =
      warp < kRowWarps - 1 ? &s_rec[warp][0][0] : nullptr;
  volatile int* taken = s_taken;
  uint8_t* patch = reinterpret_cast<uint8_t*>(s_bp[warp].patch);
  int* sres = reinterpret_cast<int*>(s_bp[warp].res);
  for (;;) {
    __syncthreads();                  // the last group is done with s_rec
    if (threadIdx.x == 0) s_group = atomicAdd(ticket, 1);
    for (int i = threadIdx.x; i < (kRowWarps - 1) * kRing * 4;
         i += kWaveThreads)
      (&s_rec[0][0][0])[i] = 0;
    if (threadIdx.x < kRowWarps) s_taken[threadIdx.x] = 0;
    __syncthreads();
    const int my = s_group * kRowWarps + warp;
    if (s_group * kRowWarps >= mbh) return;
    if (my >= mbh) continue;
    // the row above: in device memory for the CTA's first row, else in
    // the ring of the warp above; this row's records: in device memory
    // from the CTA's last row, else in its ring, for the row below
    const bool has_up = my > 0, from_global = warp == 0;
    const bool publish = my + 1 < mbh;
    const bool to_global = warp == kRowWarps - 1;
    const unsigned long long* above = rec + 4LL * (my - 1) * mbw;
    unsigned long long* mine = rec + 4LL * my * mbw;
    uint32_t up[4], left[4];          // the edges of MB mx, on every lane
    unsigned long long pend = 0;      // lanes 0-3: the next record's word
    if (!has_up) {
#pragma unroll
      for (int i = 0; i < 4; ++i) up[i] = 0x7f7f7f7fu;
    } else if (from_global) {
      if (lane < 4) pend = ld_relaxed64(above + lane);
      await_global(above, pend, lane, up);
      if (mbw > 1 && lane < 4) pend = ld_relaxed64(above + 4 + lane);
    } else {
      await_shared(ring_in, 1u, lane, up);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) left[i] = 0x81818181u;
    int corner = has_up ? 129 : 127;
    const long long mb0 = (long long)my * mbw;
    const int4* rp = reinterpret_cast<const int4*>(res + mb0 * 256) + 2 * lane;
    int4 ra = __ldg(rp), rb = __ldg(rp + 1);
    int ym = __ldg(ymode + mb0), bm = __ldg(bmodes + mb0 * 16 + sb);
    for (int mx = 0; mx < mbw; ++mx) {
      const long long mb = mb0 + mx;
      // MB mx + 1's residuals and modes, in flight while MB mx runs
      int4 na = ra, nb = rb;
      int nym = ym, nbm = bm;
      if (mx + 1 < mbw) {
        const int4* np = reinterpret_cast<const int4*>(res + (mb + 1) * 256)
                         + 2 * lane;
        na = __ldg(np);
        nb = __ldg(np + 1);
        nym = __ldg(ymode + mb + 1);
        nbm = __ldg(bmodes + (mb + 1) * 16 + sb);
      }
      // the row above over MB mx + 1: its first word is MB mx's
      // above-right; past the frame, the row's last pixel four times
      uint32_t nxt[4] = {0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu};
      uint32_t upr = 0x7f7f7f7fu;
      if (has_up) {
        if (mx + 1 < mbw) {
          if (from_global) {
            await_global(above + 4LL * (mx + 1), pend, lane, nxt);
            if (mx + 2 < mbw && lane < 4)
              pend = ld_relaxed64(above + 4LL * (mx + 2) + lane);
          } else {
            await_shared(ring_in + 4 * ((mx + 1) & (kRing - 1)), mx + 2,
                         lane, nxt);
            if (lane == 0) taken[warp] = mx + 2;
          }
          upr = nxt[0];
        } else {
          upr = (up[3] >> 24) * 0x01010101u;
        }
      }
      uint32_t q0, q1;                // this lane's rows 2h and 2h + 1
      if (ym == 4) {
        // B_PRED: the 16 subblocks in 10 steps of the wavefront 2 sy + sx;
        // in step k the 16 lanes 16a..16a + 15 take the step's a-th
        // subblock (of at most two), a pixel each, from the patch, and
        // write it back to it
        if (lane < 4) {
          reinterpret_cast<uint32_t*>(patch)[1 + lane] =
              lane == 0 ? up[0] : lane == 1 ? up[1] : lane == 2 ? up[2]
                                                                : up[3];
        } else if (lane == 4) {
          reinterpret_cast<uint32_t*>(patch)[5] = upr;
        } else if (lane == 5) {
          patch[3] = (uint8_t)corner;
        }
        if (lane < 16) {
          const uint32_t lw = lane < 4 ? left[0] : lane < 8 ? left[1]
                              : lane < 12 ? left[2] : left[3];
          patch[kPatchPitch * (1 + lane) + 3] =
              (uint8_t)(lw >> (8 * (lane & 3)));
        }
        reinterpret_cast<int4*>(sres)[2 * lane] = ra;
        reinterpret_cast<int4*>(sres)[2 * lane + 1] = rb;
        int own = bm < 0 ? bm + 10 : bm;   // the B-mode of subblock sb
        own = min(max(own, 0), 9);
        __syncwarp();
        const int a = lane >> 4, r = (lane >> 2) & 3, c = lane & 3;
#pragma unroll
        for (int k = 0; k < 10; ++k) {
          const int ky = max(0, (k - 2) >> 1) + a, kx = k - 2 * ky;
          const int mode = __shfl_sync(kFull, own, (8 * ky + 2 * kx) & 31);
          if (ky <= min(3, k >> 1) && kx >= 0) {
            const int by = 1 + 4 * ky, bx = 4 + 4 * kx;
            const uint8_t* above_row = patch + kPatchPitch * (by - 1);
            const uint32_t wa =
                *reinterpret_cast<const uint32_t*>(above_row + bx);
            const uint32_t we = *reinterpret_cast<const uint32_t*>(
                (kx == 3 ? patch : above_row) + bx + 4);
            const int x = above_row[bx - 1];
            const uint8_t* lc = patch + kPatchPitch * by + bx - 1;
            const uint32_t wl = (uint32_t)lc[0] |
                                ((uint32_t)lc[kPatchPitch] << 8) |
                                ((uint32_t)lc[2 * kPatchPitch] << 16) |
                                ((uint32_t)lc[3 * kPatchPitch] << 24);
            const uint2 tap = s_tap[max(mode - 2, 0)][4 * r + c];
            const int rv = sres[16 * (4 * ky + kx) + 4 * r + c];
            const uint32_t v0 = __byte_perm((uint32_t)x, wa, 0x6540);
            const uint32_t v1 = __byte_perm(wa, we, 0x6543);
            const uint32_t v2 = __byte_perm(we, wl, 0x6543);
            const uint32_t v3 = wl >> 24;
            const int dc = (int)(__dp4a(wa, 0x01010101u,
                                        __dp4a(wl, 0x01010101u, 4u)) >> 3);
            const int lx = (int)((wl >> (8 * r)) & 255u) - x;
            patch[kPatchPitch * (by + r) + bx + c] = (uint8_t)bpred_pixel(
                v0, v1, v2, v3, tap.x, tap.y, mode, dc, lx, wa, c, rv);
          }
          __syncwarp();
        }
        const uint32_t* rows = reinterpret_cast<const uint32_t*>(
            patch + kPatchPitch * (1 + 4 * sy + 2 * h) + 4 + 4 * sx);
        q0 = rows[0];
        q1 = rows[kPatchPitch / 4];
        __syncwarp();                 // the patch is read before the next MB
      } else {
        // a 16x16 mode, in registers: this lane's two rows of 4 pixels
        const int m = min(max(ym, 0), 3);
        const uint32_t a = sx == 0 ? up[0] : sx == 1 ? up[1]
                           : sx == 2 ? up[2] : up[3];
        const uint32_t lw = sy == 0 ? left[0] : sy == 1 ? left[1]
                            : sy == 2 ? left[2] : left[3];
        int dc = 128;
        if (m == 0) {
          const int st = (int)__dp4a(up[0], 0x01010101u, __dp4a(up[1],
                                     0x01010101u, __dp4a(up[2], 0x01010101u,
                                     __dp4a(up[3], 0x01010101u, 0u))));
          const int sl = (int)__dp4a(left[0], 0x01010101u, __dp4a(left[1],
                                     0x01010101u, __dp4a(left[2],
                                     0x01010101u, __dp4a(left[3],
                                     0x01010101u, 0u))));
          dc = has_up && mx > 0 ? (st + sl + 16) >> 5
               : has_up         ? (st + 8) >> 4
               : mx > 0         ? (sl + 8) >> 4
                                : 128;
        }
        q0 = add_row(mb16_row(m, dc, a, (int)((lw >> (16 * h)) & 255u),
                              corner), ra);
        q1 = add_row(mb16_row(m, dc, a, (int)((lw >> (16 * h + 8)) & 255u),
                              corner), rb);
      }
      const long long y = 16LL * my + 4 * sy + 2 * h;
      uint8_t* o = Y + y * W + 16LL * mx + 4 * sx;
      *reinterpret_cast<uint32_t*>(o) = q0;
      *reinterpret_cast<uint32_t*>(o + W) = q1;
      if (publish) {
        if (to_global) {
          if (sy == 3 && h == 1) st_relaxed64(mine + 4 * mx + sx,
                                              kRecTag | q1);
        } else {
          // the ring slot of record mx - kRing is free once the row below
          // has taken it
          while (mx - taken[warp + 1] >= kRing) {
          }
          if (sy == 3 && h == 1)
            ring_out[4 * (mx & (kRing - 1)) + sx] =
                ((unsigned long long)(mx + 1) << 32) | q1;
        }
      }
      // MB mx + 1's left column: column 15, rows 4j..4j + 3 from the two
      // lanes of subblock (j, 3); its corner: the pixel above MB mx's
      // right column
      const uint32_t rc = __byte_perm(q0, q1, 0x7773) & 0xffffu;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        left[j] = __shfl_sync(kFull, rc, 8 * j + 6) |
                  (__shfl_sync(kFull, rc, 8 * j + 7) << 16);
      corner = has_up ? (int)(up[3] >> 24) : 127;
#pragma unroll
      for (int i = 0; i < 4; ++i) up[i] = has_up ? nxt[i] : up[i];
      ra = na;
      rb = nb;
      ym = nym;
      bm = nbm;
    }
  }
}

}  // namespace

extern "C" {

// levels: nmb x 25 x 16 int32; dq: nmb x 6 int32; has_y2: nmb bytes (0 or
// 1); out: nmb x 24 x 16 int16, 16-byte aligned
int ffpic_vp8_residuals(const void* levels, const void* dq,
                        const void* has_y2, void* out, long long nmb,
                        void* stream) {
  if (nmb <= 0 || ((uintptr_t)out & 15)) return (int)cudaErrorInvalidValue;
  const long long nblocks = nmb * 24;
  const long long grid = (nblocks + kResThreads - 1) / kResThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  vp8_residuals_kernel<<<(unsigned)grid, kResThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)levels, (const int*)dq, (const uint8_t*)has_y2,
      (int16_t*)out, nblocks);
  return (int)cudaGetLastError();
}

// frames: n <= kMaxFrames ColorFrame descriptors (ops.cuda_vp8.
// frame_words) in host memory, tile0 and tiles_x left for this launcher;
// each frame's out 4-byte aligned
int ffpic_vp8_yuv_to_rgba(const void* frames, int n, void* stream) {
  if (n <= 0 || n > kMaxFrames) return (int)cudaErrorInvalidValue;
  ColorFrames p;
  memcpy(p.f, frames, (size_t)n * sizeof(ColorFrame));
  long long tiles = 0;
  for (int k = 0; k < n; ++k) {
    ColorFrame& f = p.f[k];
    if (f.h <= 0 || f.w <= 0 || !f.y || !f.u || !f.v || !f.out ||
        ((uintptr_t)f.out & 3))
      return (int)cudaErrorInvalidValue;
    f.tile0 = (int)tiles;
    f.tiles_x = (int)(((long long)f.w + kTileCols - 1) / kTileCols);
    tiles += (long long)f.tiles_x *
             (((long long)f.h + kTileRows - 1) / kTileRows);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  vp8_yuv_to_rgba_kernel<<<(unsigned)tiles, kColorThreads, 0,
                           (cudaStream_t)stream>>>(p, n);
  return (int)cudaGetLastError();
}

// res: mbh x mbw x 256 int32; ymode: mbh x mbw int32; bmodes: mbh x mbw x
// 16 int32, each 16-byte aligned; out: (16 mbh) x (16 mbw) bytes;
// scratch: 1 + 4 mbh mbw 64-bit words, 8-byte aligned, zeroed
int ffpic_vp8_wavefront(const void* res, const void* ymode,
                        const void* bmodes, void* out, void* scratch, int mbh,
                        int mbw, void* stream) {
  if (mbh <= 0 || mbw <= 0 || mbw > (1 << 26) / 16 ||
      ((uintptr_t)res & 15) || ((uintptr_t)out & 3) || ((uintptr_t)scratch & 7))
    return (int)cudaErrorInvalidValue;
  vp8_wavefront_kernel<<<(unsigned)((mbh + kRowWarps - 1) / kRowWarps),
                         kWaveThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)res, (const int*)ymode, (const int*)bmodes, (uint8_t*)out,
      (unsigned long long*)scratch, mbh, mbw);
  return (int)cudaGetLastError();
}

}  // extern "C"
