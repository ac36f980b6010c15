// VP8 (lossy WebP) decode kernels for Hopper (sm_90a): the device stages
// of ffpic_tpu_torch.formats.vp8 and formats.webp.
//
//   K12 vp8_residuals    raw token levels (mbh, mbw, 25, 16) int32, the
//                        per-macroblock dequant factors (mbh, mbw, 6)
//                        int32 and has_y2 (mbh, mbw) -> the residuals
//                        (mbh, mbw, 24, 4, 4) int16: dequant, Y2 inverse
//                        WHT, DC scatter and the 4x4 inverse DCT
//   K13 vp8_yuv_to_rgba  MB-padded Y, U, V planes (any row pitch) ->
//                        (h, w, 4) uint8 RGBA: libwebp's fancy chroma
//                        upsampling and fixed-point colour matrix, alpha
//                        255 or from an (h, w) plane
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
// plane when there is one, and writes 4 bytes a pixel: 11.4 MB at
// 1920x1080 without alpha. About 30 integer operations a pixel are
// nothing beside that: bound by bytes.
//
// A thread per 2x2 output quad, which shares one chroma sample c and its
// neighbourhood: the rows above and below and the columns left and right,
// each clamped to the cropped chroma grid ((h + 1) / 2, (w + 1) / 2), so
// that the MB padding of U and V is never read. The top pixels mix c's
// row with the row above, the bottom ones with the row below, each
// (9 a + 3 (b + a') + b' + 8) >> 4 with a' and b' the left (west) or
// right (east) column; then each _mult_hi term (v * k) >> 8 is floored
// on its own before the sums, and (sum >> 6) is clipped to 0..255.
// Quads at the right or bottom edge of an odd size write only the
// pixels inside. Neighbouring threads take neighbouring quads of a row,
// so each warp row reads 64 neighbouring bytes of Y and writes 256 of
// RGBA per pixel row.
constexpr int kQuadX = 32, kQuadY = 8;

__device__ __forceinline__ int clip8(int x) {
  x >>= 6;
  return x < 0 ? 0 : (x > 255 ? 255 : x);
}

__device__ __forceinline__ uchar4 yuv_pixel(int y, int u, int v, int a) {
  const int yv = (y * 19077) >> 8;
  const int r = yv + ((v * 26149) >> 8) - 14234;
  const int g = yv - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708;
  const int b = yv + ((u * 33050) >> 8) - 17685;
  return make_uchar4(clip8(r), clip8(g), clip8(b), a);
}

__global__ void __launch_bounds__(kQuadX * kQuadY)
    vp8_yuv_to_rgba_kernel(const uint8_t* __restrict__ Y, long long ys,
                           const uint8_t* __restrict__ U, long long us,
                           const uint8_t* __restrict__ V, long long vs,
                           const uint8_t* __restrict__ A,
                           uchar4* __restrict__ out, int h, int w) {
  const int ch = (h + 1) >> 1, cw = (w + 1) >> 1;
  const int qx = blockIdx.x * kQuadX + threadIdx.x;
  const int qy = blockIdx.y * kQuadY + threadIdx.y;
  if (qx >= cw || qy >= ch) return;
  const int xw = qx > 0 ? qx - 1 : 0, xe = qx + 1 < cw ? qx + 1 : cw - 1;
  const int qn = qy > 0 ? qy - 1 : 0, qs = qy + 1 < ch ? qy + 1 : ch - 1;
  int um[2][2], vm[2][2];     // [row: top, bottom][column: left, right]
  {
    const uint8_t* u0 = U + qy * us;
    const uint8_t* v0 = V + qy * vs;
    const int ua = __ldg(u0 + qx), uaw = __ldg(u0 + xw), uae = __ldg(u0 + xe);
    const int va = __ldg(v0 + qx), vaw = __ldg(v0 + xw), vae = __ldg(v0 + xe);
#pragma unroll
    for (int r = 0; r < 2; r++) {
      const uint8_t* u1 = U + (long long)(r ? qs : qn) * us;
      const uint8_t* v1 = V + (long long)(r ? qs : qn) * vs;
      const int ub = __ldg(u1 + qx), ubw = __ldg(u1 + xw);
      const int ube = __ldg(u1 + xe);
      const int vb = __ldg(v1 + qx), vbw = __ldg(v1 + xw);
      const int vbe = __ldg(v1 + xe);
      um[r][0] = (9 * ua + 3 * (ub + uaw) + ubw + 8) >> 4;
      um[r][1] = (9 * ua + 3 * (ub + uae) + ube + 8) >> 4;
      vm[r][0] = (9 * va + 3 * (vb + vaw) + vbw + 8) >> 4;
      vm[r][1] = (9 * va + 3 * (vb + vae) + vbe + 8) >> 4;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; r++) {
    const int y = 2 * qy + r;
    if (y >= h) break;
#pragma unroll
    for (int c = 0; c < 2; c++) {
      const int x = 2 * qx + c;
      if (x >= w) break;
      const long long p = (long long)y * w + x;
      out[p] = yuv_pixel(__ldg(Y + y * ys + x), um[r][c], vm[r][c],
                         A ? __ldg(A + p) : 255);
    }
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
// steps run one after another (254 at 1080p), and inside a B_PRED MB 10
// steps of 4x4 subblocks. What sets the time is the latency of one MB
// step, not bytes or operations.
//
// Design (simple first): one launch a frame. A CTA of 256 threads owns
// one MB row at a time, taken from a ticket counter (atomicAdd) when it
// starts and again when it finishes, and walks the row left to right.
// The card need not schedule CTAs in blockIdx order, so a row never waits
// on a row that a CTA has not yet claimed: the row above is always held
// by a CTA that is already running, and row 0 waits on nothing. After
// each MB the row publishes done[my] = mx + 1 (a barrier, a fence, then a
// release store by thread 0); row my may start MB mx once done[my - 1] >=
// min(mx + 2, mbw) (thread 0 spins on an acquire load), which covers the
// pixels above and above-right. Pixels of the row above are read with
// __ldcg, from L2, so a stale L1 line is never used.
//
// Shared memory holds the MB's 17 x 21 patch as the original's: row 0 the
// corner, the 16 pixels above and 4 above-right (the row above clamped to
// the frame's last column, or the virtual 127 row), column 0 the left
// column (the previous MB's right column, or the virtual 129), rows and
// columns 1..16 the MB. Thread t owns pixel (r, c) = ((t >> 2) & 3, t & 3)
// of subblock t >> 4, so the 256 residuals of an MB load as one coalesced
// run. A 16x16 mode computes every pixel at once. B_PRED runs the 16
// subblocks as their own wavefront, step 2 sy + sx (0..9), a barrier
// between steps; each subblock reads its 13 edges from the patch, the
// right column's above-right from row 0 (columns 17..20), and each of the
// eight averaging modes is four edges from a table (sum + 2) >> 2.
constexpr int kWaveThreads = 256;

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

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int clip255(int x) {
  return x < 0 ? 0 : (x > 255 ? 255 : x);
}

// Edge j of the subblock whose top-left pixel is P[by][bx] (sx its column).
__device__ __forceinline__ int b4_edge(int (*P)[21], int j, int by,
                                       int bx, int sx) {
  if (j == 0) return P[by - 1][bx - 1];
  if (j <= 8) return j >= 5 && sx == 3 ? P[0][j + 12] : P[by - 1][bx + j - 1];
  return P[by + j - 9][bx - 1];
}

// res: nmb x 256 int32; ymode: nmb; bmodes: nmb x 16; Y: (16 mbh) x (16
// mbw) bytes; sync: mbh + 1 ints, zeroed: [0] the ticket, [1 + r] the MBs
// row r has done.
__global__ void __launch_bounds__(kWaveThreads)
    vp8_wavefront_kernel(const int* __restrict__ res,
                         const int* __restrict__ ymode,
                         const int* __restrict__ bmodes,
                         uint8_t* __restrict__ Y, int* __restrict__ sync,
                         int mbh, int mbw) {
  __shared__ int P[17][21];
  __shared__ uint32_t taps[8][16];
  __shared__ int s_row;
  const int t = threadIdx.x;
  if (t < 128) taps[t >> 4][t & 15] = kB4Taps[t >> 4][t & 15];
  const int sb = t >> 4, sy = sb >> 2, sx = sb & 3;
  const int r = (t >> 2) & 3, c = t & 3;
  const int by = 1 + 4 * sy, bx = 1 + 4 * sx;   // the subblock in P
  const int py = by + r, px = bx + c;           // this thread's pixel
  const long long W = 16LL * mbw;
  int* done = sync + 1;
  for (;;) {
    __syncthreads();                  // the last row is finished with P
    if (t == 0) s_row = atomicAdd(sync, 1);
    __syncthreads();
    const int my = s_row;
    if (my >= mbh) return;
    const long long y0 = 16LL * my;
    for (int mx = 0; mx < mbw; ++mx) {
      const long long x0 = 16LL * mx;
      const long long mb = (long long)my * mbw + mx;
      const int rv = __ldg(res + mb * 256 + t);
      const int ym = __ldg(ymode + mb);
      int bm = __ldg(bmodes + mb * 16 + sb);
      bm = min(max(bm < 0 ? bm + 10 : bm, 0), 9);
      if (my > 0 && t == 0) {
        const int need = min(mx + 2, mbw);
        while (ld_acquire(done + my - 1) < need) __nanosleep(32);
      }
      __syncthreads();
      if (t < 21) {                   // row 0: corner, above, above-right
        int v = 127;
        if (my > 0) {
          const long long col = min(x0 + t, W);   // padded column
          v = col == 0 ? 129 : __ldcg(Y + (y0 - 1) * W + col - 1);
        }
        P[0][t] = v;
      } else if (t >= 32 && t < 48) { // column 0: left
        P[t - 31][0] = mx == 0 ? 129 : P[t - 31][16];
      }
      __syncthreads();
      int rec = 0;
      if (ym == 4) {                  // B_PRED: 10 steps of subblocks
        for (int k = 0; k < 10; ++k) {
          if (2 * sy + sx == k) {
            int pred;
            if (bm == 0) {            // B_DC
              int sum = 4;
#pragma unroll
              for (int j = 1; j <= 4; ++j)
                sum += b4_edge(P, j, by, bx, sx) + b4_edge(P, j + 8, by, bx,
                                                           sx);
              pred = sum >> 3;
            } else if (bm == 1) {     // B_TM
              pred = clip255(b4_edge(P, 9 + r, by, bx, sx) +
                             b4_edge(P, 1 + c, by, bx, sx) -
                             b4_edge(P, 0, by, bx, sx));
            } else {
              const uint32_t q = taps[bm - 2][r * 4 + c];
              pred = (b4_edge(P, q & 255, by, bx, sx) +
                      b4_edge(P, (q >> 8) & 255, by, bx, sx) +
                      b4_edge(P, (q >> 16) & 255, by, bx, sx) +
                      b4_edge(P, q >> 24, by, bx, sx) + 2) >> 2;
            }
            rec = clip255((int)((unsigned)pred + (unsigned)rv));
            P[py][px] = rec;
          }
          __syncthreads();
        }
      } else {                        // 16x16: DC, V, H, TM
        const int m = min(max(ym, 0), 3);
        int pred;
        if (m == 0) {
          int st = 0, sl = 0;
          for (int i = 1; i <= 16; ++i) {
            st += P[0][i];
            sl += P[i][0];
          }
          pred = my > 0 && mx > 0 ? (st + sl + 16) >> 5
                 : my > 0         ? (st + 8) >> 4
                 : mx > 0         ? (sl + 8) >> 4
                                  : 128;
        } else if (m == 1) {
          pred = P[0][px];
        } else if (m == 2) {
          pred = P[py][0];
        } else {
          pred = clip255(P[py][0] + P[0][px] - P[0][0]);
        }
        rec = clip255((int)((unsigned)pred + (unsigned)rv));
        P[py][px] = rec;              // rows and columns 1..16 only
      }
      Y[(y0 + py - 1) * W + x0 + px - 1] = (uint8_t)rec;
      __syncthreads();
      if (t == 0) {
        __threadfence();
        st_release(done + my, mx + 1);
      }
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

// Y: h rows of at least w bytes at pitch ys; U, V: (h + 1) / 2 rows of at
// least (w + 1) / 2 bytes at pitches us, vs; A: h x w bytes or null; out:
// h x w x 4 bytes, 4-byte aligned
int ffpic_vp8_yuv_to_rgba(const void* Y, long long ys, const void* U,
                          long long us, const void* V, long long vs,
                          const void* A, void* out, int h, int w,
                          void* stream) {
  if (h <= 0 || w <= 0 || ((uintptr_t)out & 3))
    return (int)cudaErrorInvalidValue;
  const int ch = (h + 1) >> 1, cw = (w + 1) >> 1;
  const dim3 block(kQuadX, kQuadY);
  const dim3 grid((cw + kQuadX - 1) / kQuadX, (ch + kQuadY - 1) / kQuadY);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  vp8_yuv_to_rgba_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)Y, ys, (const uint8_t*)U, us, (const uint8_t*)V, vs,
      (const uint8_t*)A, (uchar4*)out, h, w);
  return (int)cudaGetLastError();
}

// res: mbh x mbw x 256 int32; ymode: mbh x mbw int32; bmodes: mbh x mbw x
// 16 int32; out: (16 mbh) x (16 mbw) bytes; sync: mbh + 1 ints, zeroed
int ffpic_vp8_wavefront(const void* res, const void* ymode,
                        const void* bmodes, void* out, void* sync, int mbh,
                        int mbw, void* stream) {
  if (mbh <= 0 || mbw <= 0 || mbw > (1 << 26) / 16)
    return (int)cudaErrorInvalidValue;
  vp8_wavefront_kernel<<<(unsigned)mbh, kWaveThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)res, (const int*)ymode, (const int*)bmodes, (uint8_t*)out,
      (int*)sync, mbh, mbw);
  return (int)cudaGetLastError();
}

}  // extern "C"
