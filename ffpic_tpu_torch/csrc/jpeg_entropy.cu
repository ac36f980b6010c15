// Device Huffman decode of baseline 4:2:0 JPEGs for Hopper (sm_90a).
//
// The device half of ffpic_tpu_torch.ops.jpeg_entropy_device: the host
// destuffs each scan and stages the raw entropy bytes of the batch, end
// to end, with 8 zero bytes after them; these kernels turn them into the
// int16 coefficients of each image's concatenated per-component space
// [Y | Cb | Cr], each in block raster order, which K2 and K3
// (jpeg_decode.cu) take as they are.
//
//   K9  entropy_decode  one thread per lane (a restart segment, or a
//                       speculative chunk with its entry state): Huffman
//                       symbols -> coefficients, until the lane's end
//   K10 spec_scan       one thread per DRI-less chunk: the speculative
//                       walk from the chunk's first byte (k = 0, sub = 0)
//                       to the first symbol boundary at or past its end,
//                       recording every 8th boundary state on the way
//   K11 spec_merge      one thread per chunk: the walk from the
//                       predecessor's exit until it meets a recorded
//                       boundary of its own chunk
//
// A symbol is one lookup in a 65,536-entry table of uint32 (the host's
// build_lut16): (consume << 24) | (flags << 16) | value, flags 0..63 a
// zero run with the value combined, 0xFF end of block, 0xFE sixteen
// zeros, 0xFD a magnitude that does not fit the 16-bit window (the
// value holds the raw symbol and the magnitude is read after the code);
// entry 0 is an invalid code. Four tables a group: DC-Y, AC-Y, DC-C,
// AC-C.
//
// What bounds them: the bytes are few (the scan once, about 1 bit a
// coefficient of a photo, and the zeroed coefficients), but each lane is
// a serial chain of symbols, and each symbol is two dependent loads: the
// 32-bit window (two aligned words, __byte_perm), then the table entry
// (1 MB a group, read through the read-only cache; it lives in L2). So
// a lane's time is its symbol count times that round trip, and the
// launch takes the time of its longest lane. The design keeps the chain
// short: branch-free selects as in the reference, no shared memory, no
// barriers; a warp per block so the lanes spread over as many SMs as
// there are warps. A faster design (a shared-memory fast table, more
// and shorter lanes) is later work.
//
// Every step follows ffpic_tpu/ops/jpeg_entropy_device.py exactly: a
// window index past the bytes is clamped to the last byte, as a JAX
// gather clamps it; the spill shift is clipped as in the reference; DC
// predictors and sums are int32 that wrap (uint32 here); an emitted
// value wraps to int16 (stored through uint32); the block map is read
// at clip(bmap_base + blk, 0, len - 1). A lane writes only what it
// emits: the reference's dump slot receives garbage no result reads.
//
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLaneThreads = 32;   // a warp per block: lanes spread over SMs
constexpr int kLaneCols = 12;      // jpeg_entropy_device.LANE_COLS
constexpr int kSnap = 256;         // jpeg_entropy_device.SNAP
constexpr int kSnapStride = 8;     // jpeg_entropy_device.SNAP_STRIDE
constexpr int kSnapCols = 7;       // bit, k, sub, blk, dc0, dc1, dc2
constexpr int kMergeSteps = kSnap * kSnapStride + 16;
constexpr int kRunEob = 0xFF, kRunZrl = 0xFE, kRunCode = 0xFD;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The big-endian 32-bit window of the bytes from the one holding bit
// `bit`, its byte index clamped to [0, nbytes - 1]. `words` is the staged
// buffer as uint32, 4-byte aligned, with at least 8 bytes after the last.
__device__ __forceinline__ uint32_t window(const uint32_t* __restrict__ words,
                                           int nbytes, int bit) {
  const int b = clampi(bit >> 3, 0, nbytes - 1);
  const uint32_t lo = __ldg(words + (b >> 2));
  const uint32_t hi = __ldg(words + (b >> 2) + 1);
  const unsigned a = b & 3;
  return __byte_perm(lo, hi,
                     (a << 12) | ((a + 1) << 8) | ((a + 2) << 4) | (a + 3));
}

// One table lookup at `bit` in table `tbl` and what follows from it, as
// the reference's loop bodies compute it.
struct Symbol {
  uint32_t e;     // the entry; 0 = invalid code
  int consume;    // bits of the code (and of a combined magnitude)
  int flags;
  int val;        // the sign-extended 16-bit value
  bool is_code;   // a magnitude spill: `ext` read after the code
  int r_sp, sz_sp;
  int ext;        // the spilled magnitude EXTENDed (0 unless is_code)
};

__device__ __forceinline__ Symbol lookup(const uint32_t* __restrict__ words,
                                         int nbytes,
                                         const uint32_t* __restrict__ lut,
                                         int tbl, int bit, bool is_dc) {
  Symbol y;
  const uint32_t w = window(words, nbytes, bit);
  const int win16 = (int)((w >> (16 - (bit & 7))) & 0xFFFFu);
  y.e = __ldg(lut + (size_t)tbl * 65536 + win16);
  y.consume = (int)(y.e >> 24);
  y.flags = (int)((y.e >> 16) & 0xFF);
  const int v16 = (int)(y.e & 0xFFFF);
  y.val = v16 - 2 * (v16 & 0x8000);
  y.is_code = y.flags == kRunCode;
  y.r_sp = is_dc ? 0 : (y.val >> 4);
  y.sz_sp = is_dc ? y.val : (y.val & 15);
  y.ext = 0;
  if (y.is_code && y.sz_sp > 0) {
    const int pos2 = bit + y.consume;
    const uint32_t w2 = window(words, nbytes, pos2);
    const int szu = clampi(y.sz_sp, 1, 16);
    const int mag = (int)((w2 >> (32 - (pos2 & 7) - szu)) &
                          ((1u << szu) - 1u));
    y.ext = mag < (1 << clampi(y.sz_sp - 1, 0, 15))
                ? mag - (1 << clampi(y.sz_sp, 0, 16)) + 1
                : mag;
  }
  return y;
}

// A speculative lane's state: the reference's _spec_symbol_step and the
// masked updates of its scan, snapshot and merge loops.
struct SpecState {
  int bit, k, sub, blk;
  uint32_t dc[3];
};

__device__ __forceinline__ void spec_step(
    const uint32_t* __restrict__ words, int nbytes,
    const uint32_t* __restrict__ lut, const int32_t* __restrict__ comp_of,
    const int32_t* __restrict__ tclass_of, int bpm, SpecState& s) {
  const bool is_dc = s.k == 0;
  const int subc = clampi(s.sub, 0, bpm - 1);
  const Symbol y = lookup(words, nbytes, lut,
                          __ldg(tclass_of + subc) * 2 + (is_dc ? 0 : 1),
                          s.bit, is_dc);
  const bool invalid = y.e == 0;
  const int adv = invalid ? 1 : y.consume + (y.is_code ? y.sz_sp : 0);
  if (is_dc && !invalid) {
    const int comp = clampi(__ldg(comp_of + subc), 0, 2);
    s.dc[comp] += (uint32_t)(y.is_code ? y.ext : y.val);
  }
  const bool is_comb = y.flags < 64;
  const int run = is_comb ? y.flags : y.r_sp;
  const int kk = s.k + run;
  int k_next = is_dc ? 1 : (y.flags == kRunZrl ? s.k + 16 : kk + 1);
  const bool block_end =
      !is_dc && (y.flags == kRunEob || k_next > 63) && !invalid;
  if (block_end) k_next = 0;
  if (invalid) k_next = s.k;
  int sub_next = block_end ? s.sub + 1 : s.sub;
  if (sub_next >= bpm) sub_next = 0;
  s.bit += adv;
  s.k = k_next;
  s.sub = sub_next;
  s.blk += block_end;
}

// K9. Replaces decode_lanes_bmap (ffpic_tpu/ops/jpeg_entropy_device.py
// :139), the TPU's lane-vectorised while loop: here each lane is a
// thread that runs its own loop, so a lane that finishes early costs the
// others nothing. Lane table row (int32): bit0, blk0, blk_end, img_base,
// lut_idx, bmap_base, k0, sub0, pred0[3], bit_stop.
__global__ void __launch_bounds__(kLaneThreads)
    entropy_decode_kernel(const uint32_t* __restrict__ words, int nbytes,
                          const uint32_t* __restrict__ luts,
                          const int32_t* __restrict__ zz,
                          const int32_t* __restrict__ comp_of,
                          const int32_t* __restrict__ tclass_of,
                          const int32_t* __restrict__ bmap, int bmap_len,
                          const int32_t* __restrict__ lanes, int n_lanes,
                          int bpm, int16_t* __restrict__ out, int out_size,
                          int max_steps, int32_t* __restrict__ steps_out) {
  const int lane = blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= n_lanes) return;
  const int32_t* row = lanes + (size_t)lane * kLaneCols;
  int bit = row[0], blk = row[1];
  const int blk_end = row[2], img_base = row[3];
  const uint32_t* lut = luts + (size_t)row[4] * 4 * 65536;
  const int bmap_base = row[5];
  int k = row[6], sub = row[7];
  uint32_t pred[3] = {(uint32_t)row[8], (uint32_t)row[9], (uint32_t)row[10]};
  const int bit_stop = row[11];

  bool done = blk >= blk_end || bit >= bit_stop;
  int step = 0;
  for (; !done && step < max_steps; ++step) {
    const bool is_dc = k == 0;
    const int subc = clampi(sub, 0, bpm - 1);
    const Symbol y = lookup(words, nbytes, lut,
                            __ldg(tclass_of + subc) * 2 + (is_dc ? 0 : 1),
                            bit, is_dc);
    const bool invalid = y.e == 0;
    const int total = y.consume + (y.is_code ? y.sz_sp : 0);
    const int comp = clampi(__ldg(comp_of + subc), 0, 2);
    if (is_dc) pred[comp] += (uint32_t)(y.is_code ? y.ext : y.val);

    const bool is_comb = y.flags < 64;
    const int run = is_comb ? y.flags : y.r_sp;
    const int kk = k + run;
    const bool ac_emit = !is_dc && (is_comb || y.is_code) && kk <= 63;
    const bool overrun = !is_dc && (is_comb || y.is_code) && kk > 63;
    if (is_dc || ac_emit) {
      const int pos = is_dc ? 0 : __ldg(zz + clampi(kk, 0, 63));
      const int bi = clampi(bmap_base + blk, 0, bmap_len - 1);
      const int idx = (int)((uint32_t)img_base +
                            (uint32_t)__ldg(bmap + bi) * 64u + (uint32_t)pos);
      const uint32_t v = is_dc ? pred[comp] : (uint32_t)(is_comb ? y.val
                                                                 : y.ext);
      if (idx >= 0 && idx < out_size) out[idx] = (int16_t)(uint16_t)v;
    }
    int k_next = is_dc ? 1 : (y.flags == kRunZrl ? k + 16 : kk + 1);
    const bool block_end = !is_dc && (y.flags == kRunEob || k_next > 63);
    if (block_end) k_next = 0;
    sub = block_end ? sub + 1 : sub;
    if (sub >= bpm) sub = 0;
    blk += block_end;
    bit += total;
    k = k_next;
    done = invalid || overrun || blk >= blk_end || bit >= bit_stop;
  }
  steps_out[lane] = step;
}

// K10. Replaces spec_snap_lanes (:424) and spec_scan_lanes (:374) as
// spec_decode_full (:558) calls them: both walk the same trajectory from
// (bit0, k = 0, sub = 0), so one thread walks it once. Boundary b (the
// state after b symbols) is recorded in slot b / 8 when b % 8 == 0 and
// b < 2048, for every b up to the exit boundary (the first at or past
// bit_end), which is recorded only when its index is such a multiple, as
// the JAX loop's order gives; the other slots get -1. The exit state is
// the one after min(exit, max_steps) symbols; past max_steps the walk
// goes on only as far as the snapshots need.
__global__ void __launch_bounds__(kLaneThreads)
    spec_scan_kernel(const uint32_t* __restrict__ words, int nbytes,
                     const uint32_t* __restrict__ lut,
                     const int32_t* __restrict__ comp_of,
                     const int32_t* __restrict__ tclass_of, int bpm,
                     const int32_t* __restrict__ chunks, int n_lanes,
                     int max_steps, int32_t* __restrict__ exits,
                     int32_t* __restrict__ snap) {
  const int lane = blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= n_lanes) return;
  const int bit_end = chunks[2 * lane + 1];
  SpecState s = {chunks[2 * lane], 0, 0, 0, {0u, 0u, 0u}};
  SpecState ex = s;
  int32_t* rec = snap + (size_t)lane * kSnap * kSnapCols;
  int nrec = 0;
  if (s.bit < bit_end) {
    bool saved = false;
    for (int b = 0;; ++b) {
      if (b < kSnap * kSnapStride && b % kSnapStride == 0) {
        int32_t* r = rec + (size_t)nrec * kSnapCols;
        r[0] = s.bit; r[1] = s.k; r[2] = s.sub; r[3] = s.blk;
        r[4] = (int32_t)s.dc[0]; r[5] = (int32_t)s.dc[1];
        r[6] = (int32_t)s.dc[2];
        ++nrec;
      }
      if (s.bit >= bit_end) break;
      if (b == max_steps) {
        ex = s;
        saved = true;
      }
      if (saved && b >= kSnap * kSnapStride - 1) break;
      spec_step(words, nbytes, lut, comp_of, tclass_of, bpm, s);
    }
    if (!saved) ex = s;
  }
  for (int i = nrec * kSnapCols; i < kSnap * kSnapCols; ++i) rec[i] = -1;
  int32_t* o = exits + (size_t)lane * kSnapCols;
  o[0] = ex.bit; o[1] = ex.k; o[2] = ex.sub; o[3] = ex.blk;
  o[4] = (int32_t)ex.dc[0]; o[5] = (int32_t)ex.dc[1];
  o[6] = (int32_t)ex.dc[2];
}

// K11. Replaces spec_merge_lanes (:490): from the true entry (the
// predecessor's exit), check the state against the lane's snapshots
// before each symbol; stop at the first match, past the last recorded
// bit, or after kMergeSteps symbols. The used slots are the first ones,
// their bits strictly increasing (every symbol advances at least one
// bit), so a pointer that only moves forward finds the one slot that can
// hold the state's bit: the same first match as the reference's argmax
// over all slots. Output row: matched, midx, blocks, DC sums.
__global__ void __launch_bounds__(kLaneThreads)
    spec_merge_kernel(const uint32_t* __restrict__ words, int nbytes,
                      const uint32_t* __restrict__ lut,
                      const int32_t* __restrict__ comp_of,
                      const int32_t* __restrict__ tclass_of, int bpm,
                      const int32_t* __restrict__ ent, int n_lanes,
                      const int32_t* __restrict__ snap,
                      int32_t* __restrict__ merged) {
  const int lane = blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= n_lanes) return;
  const int32_t* rec = snap + (size_t)lane * kSnap * kSnapCols;
  int nused = 0;
  while (nused < kSnap && rec[nused * kSnapCols] != -1) ++nused;
  const int maxbit = nused ? rec[(nused - 1) * kSnapCols] : -1;
  SpecState s = {ent[3 * lane], ent[3 * lane + 1], ent[3 * lane + 2], 0,
                 {0u, 0u, 0u}};
  int matched = 0, midx = 0, p = 0;
  for (int t = 0;; ++t) {
    while (p < nused && rec[p * kSnapCols] < s.bit) ++p;
    if (p < nused && rec[p * kSnapCols] == s.bit &&
        rec[p * kSnapCols + 1] == s.k && rec[p * kSnapCols + 2] == s.sub) {
      matched = 1;
      midx = p;
      break;
    }
    if (s.bit > maxbit || t > kMergeSteps) break;
    spec_step(words, nbytes, lut, comp_of, tclass_of, bpm, s);
  }
  int32_t* o = merged + (size_t)lane * 6;
  o[0] = matched; o[1] = midx; o[2] = s.blk;
  o[3] = (int32_t)s.dc[0]; o[4] = (int32_t)s.dc[1]; o[5] = (int32_t)s.dc[2];
}

bool bad_common(const void* data, int nbytes, int bpm, int n_lanes) {
  return nbytes <= 0 || bpm <= 0 || n_lanes <= 0 ||
         ((uintptr_t)data & 3) || nbytes > 0x7FFFFFF0;
}

unsigned lane_blocks(int n_lanes) {
  return (unsigned)((n_lanes + kLaneThreads - 1) / kLaneThreads);
}

}  // namespace

extern "C" {

// data: nbytes scan bytes and at least 8 zero bytes after them; out:
// out_size int16, zeroed here, then the lanes' coefficients
int ffpic_entropy_decode(const void* data, int nbytes, const void* luts,
                         const void* zz, const void* comp_of,
                         const void* tclass_of, const void* bmap,
                         int bmap_len, const void* lanes, int n_lanes,
                         int bpm, void* out, int out_size, int max_steps,
                         void* steps, int lane_cols, void* stream) {
  if (bad_common(data, nbytes, bpm, n_lanes) || lane_cols != kLaneCols ||
      bmap_len <= 0 || out_size <= 0 || max_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * (size_t)out_size, st);
  if (err != cudaSuccess) return (int)err;
  entropy_decode_kernel<<<lane_blocks(n_lanes), kLaneThreads, 0, st>>>(
      (const uint32_t*)data, nbytes, (const uint32_t*)luts,
      (const int32_t*)zz, (const int32_t*)comp_of, (const int32_t*)tclass_of,
      (const int32_t*)bmap, bmap_len, (const int32_t*)lanes, n_lanes, bpm,
      (int16_t*)out, out_size, max_steps, (int32_t*)steps);
  return (int)cudaGetLastError();
}

// chunks: (n_lanes, 2) int32 bit0, bit_end; exits (n_lanes, 7) and snap
// (n_lanes, snap_slots, 7) int32, written whole
int ffpic_spec_scan(const void* data, int nbytes, const void* lut,
                    const void* comp_of, const void* tclass_of, int bpm,
                    const void* chunks, int n_lanes, int max_steps,
                    void* exits, void* snap, int snap_slots,
                    int snap_stride, void* stream) {
  if (bad_common(data, nbytes, bpm, n_lanes) || snap_slots != kSnap ||
      snap_stride != kSnapStride || max_steps < 0)
    return (int)cudaErrorInvalidValue;
  spec_scan_kernel<<<lane_blocks(n_lanes), kLaneThreads, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)data, nbytes, (const uint32_t*)lut,
      (const int32_t*)comp_of, (const int32_t*)tclass_of, bpm,
      (const int32_t*)chunks, n_lanes, max_steps, (int32_t*)exits,
      (int32_t*)snap);
  return (int)cudaGetLastError();
}

// ent: (n_lanes, 3) int32 bit, k, sub; merged (n_lanes, 6) int32
int ffpic_spec_merge(const void* data, int nbytes, const void* lut,
                     const void* comp_of, const void* tclass_of, int bpm,
                     const void* ent, int n_lanes, const void* snap,
                     int snap_slots, void* merged, void* stream) {
  if (bad_common(data, nbytes, bpm, n_lanes) || snap_slots != kSnap)
    return (int)cudaErrorInvalidValue;
  spec_merge_kernel<<<lane_blocks(n_lanes), kLaneThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)data, nbytes, (const uint32_t*)lut,
      (const int32_t*)comp_of, (const int32_t*)tclass_of, bpm,
      (const int32_t*)ent, n_lanes, (const int32_t*)snap,
      (int32_t*)merged);
  return (int)cudaGetLastError();
}

}  // extern "C"
