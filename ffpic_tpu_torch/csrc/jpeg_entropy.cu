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
//                       symbols -> coefficients, until the lane's end;
//                       replaces decode_lanes_bmap
//                       (ffpic_tpu/ops/jpeg_entropy_device.py:139)
//   K10 spec_scan       one thread per DRI-less chunk: the speculative
//                       walk from the chunk's first byte (k = 0, sub = 0)
//                       to the first symbol boundary at or past its end,
//                       recording every 8th boundary state on the way;
//                       replaces spec_snap_lanes (:424) and
//                       spec_scan_lanes (:374)
//   K11 spec_merge      one thread per chunk: K10's walk from the
//                       predecessor's exit until it meets a recorded
//                       boundary of its own chunk; replaces
//                       spec_merge_lanes (:490)
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
// coefficient of a photo, and the zeroed coefficients), and so are the
// operations. Each lane is a serial chain of symbols, each symbol's
// position depending on the one before, so a launch takes its longest
// lane's symbol count times the time of one step of its loop. With one
// lane's loop a warp, that time is the loop's instructions issued one
// after another, each waiting on the one before, plus any memory round
// trip the loop waits on.
// K9 and K10 take the round trips off the chain and keep the loop short
// and straight:
//
// * a fast table in shared memory: for each of the group's four tables,
//   the entry of every window prefix of kFastBits bits whose windows all
//   hold one entry, with the code and any combined magnitude within the
//   prefix, and no spill (the host's fast_tables; 4 << kFastBits uint32,
//   copied in by the CTA's prologue). A hit is the 16-bit entry by
//   construction; only a miss (kFastMiss, which no entry equals) reads
//   the 1 MB-a-group table in global memory. The entry of the next
//   symbol is read as soon as its position is known, so the shared
//   memory latency overlaps the rest of the step;
// * the bit window in registers: the big-endian words w, w + 1 of the
//   lane's position (w = bit / 32) and the word after them, loaded when
//   the position enters word w + 1, a word before it is needed and kept
//   as loaded until then. The 32-bit window is one funnel shift; a
//   spilled magnitude (at most 16 bits after a code of at most 16) lies
//   within the two words. A window whose byte lies past the bytes is
//   formed as the reference forms it (window(): the last byte and what
//   follows), so the clamp holds exactly; positions within 32 bits of
//   the end take that checked step, the rest a loop without checks;
// * no branch in that loop: a miss, a spill, a DC symbol, a block end
//   and a new word are selects and predicated loads (on an H100,
//   branches for them cost more than the work they skip);
// * per-block values off the chain: the sub-blocks' table classes and
//   components packed into two registers, the block map entry of the
//   next block loaded a block ahead, zz in shared memory;
// * K9's CTAs follow the host's plan (cta_plan): rows (group, first
//   lane, lane count), at most jpeg_entropy_device.CTA_LANES lanes of
//   one table group, so a CTA holds one group's fast tables (a lane
//   whose lut_idx is not its row's group traps, once, before its loop,
//   and the launch fails). Few lanes a warp diverge little, and a warp has an SM scheduler to itself. K10
//   takes one group, and any kSpecLanes chunks make a CTA.
//
// K11 walks as K10 does (its SpecLane step) from another entry, the true
// one, and compares the state before each symbol with the one snapshot
// slot that can match it, whose (bit, k, sub) it holds in registers with
// the next slot's loaded ahead (SnapCursor): no step waits on global
// memory but for a miss of the fast table. Two chunks make a CTA (its
// other threads only help copy the fast tables in): its walks are short,
// and fewer lanes a warp diverge less.
//
// Every step follows ffpic_tpu/ops/jpeg_entropy_device.py exactly: a
// window index past the bytes is clamped to the last byte, as a JAX
// gather clamps it; the spill shift is clipped as in the reference; DC
// predictors and sums are int32 that wrap (uint32 here); an emitted
// value wraps to int16 (stored through uint32); the block map is read
// at clip(bmap_base + blk, 0, len - 1). A lane writes only what it
// emits: the reference's dump slot receives garbage no result reads.
// Table classes (tclass_of) are 0 or 1; K9-K11 read a larger one as 1.
//
// Every launcher is extern "C", launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The fast table's width and K10's CTA width; tune_entropy builds
// variants with -DFFPIC_FAST_BITS=... -DFFPIC_SPEC_LANES=...
#ifndef FFPIC_FAST_BITS
#define FFPIC_FAST_BITS 11         // jpeg_entropy_device.FAST_BITS
#endif
#ifndef FFPIC_SPEC_LANES
#define FFPIC_SPEC_LANES 8
#endif

constexpr int kLaneThreads = 32;   // K9: a warp per block
constexpr int kSpecLanes = FFPIC_SPEC_LANES;   // K10: chunks a CTA
constexpr int kMergeLanes = 2;     // K11: chunks a CTA
constexpr int kMergeThreads = 128;  // K11: its CTA, to copy the fast tables
static_assert(kMergeLanes <= kMergeThreads, "a K11 CTA walks kMergeLanes");
constexpr int kLaneCols = 12;      // jpeg_entropy_device.LANE_COLS
constexpr int kSnap = 256;         // jpeg_entropy_device.SNAP
constexpr int kSnapStride = 8;     // jpeg_entropy_device.SNAP_STRIDE
constexpr int kSnapCols = 7;       // bit, k, sub, blk, dc0, dc1, dc2
constexpr int kMergeSteps = kSnap * kSnapStride + 16;
constexpr int kRunEob = 0xFF, kRunZrl = 0xFE, kRunCode = 0xFD;
constexpr int kFastBits = FFPIC_FAST_BITS;
constexpr int kFastWords = 4 << kFastBits;   // a group's four fast tables
constexpr int kFastBytes = 4 * kFastWords;
constexpr uint32_t kFastMiss = 0xFFFFFFFFu;  // jpeg_entropy_device.FAST_MISS
constexpr int kMaxBpm = 16;        // sub-blocks an MCU (cuda_entropy.MAX_BPM)

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

// One table lookup and what follows from it, as the reference's loop
// bodies compute it (fast_lookup below).
struct Symbol {
  uint32_t e;     // the entry; 0 = invalid code
  int consume;    // bits of the code (and of a combined magnitude)
  int flags;
  int val;        // the sign-extended 16-bit value
  bool is_code;   // a magnitude spill: `ext` read after the code
  int r_sp, sz_sp;
  int ext;        // the spilled magnitude EXTENDed (0 unless is_code)
};

// A speculative lane's state: the reference's _spec_symbol_step and the
// masked updates of its scan, snapshot and merge loops.
struct SpecState {
  int bit, k, sub, blk;
  uint32_t dc[3];
};

// --- K9-K11: the fast table and the register window -----------------------

// Word i of the staged bytes as stored: 0 before them (never read for a
// window inside the bytes), word wlast past it (read only for windows
// past the bytes, which take window() instead).
__device__ __forceinline__ uint32_t raw_word(const uint32_t* __restrict__ words,
                                             int i, int wlast) {
  return i < 0 ? 0u : __ldg(words + min(i, wlast));
}

__device__ __forceinline__ uint32_t big_endian(uint32_t raw) {
  return __byte_perm(raw, 0, 0x0123);
}

// Shared memory through 32-bit addresses held in registers. The address
// passes through an opaque move, taken after the barrier that filled the
// memory: else the compiler re-derives the CTA's shared window (S2R) at
// every use inside the loop, and could move a load above the barrier.
// The loads themselves may then be scheduled freely.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  uint32_t a;
  asm volatile("mov.u32 %0, %1;"
               : "=r"(a)
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
  return a;
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// Words w = bit >> 5, w + 1 and w + 2 of the lane's position, in
// registers: w and w + 1 (big-endian) hold any 32-bit window at the
// position and any spilled magnitude after a code; w + 2 is the word the
// next step into a new word needs, loaded a word ahead and kept as
// loaded, so that nothing waits for it before then.
struct BitWindow {
  const uint32_t* __restrict__ words;
  int nbytes, wlast, w;
  uint32_t hi, lo, next_raw;

  __device__ __forceinline__ void seek(int bit) {
    w = bit >> 5;
    hi = big_endian(raw_word(words, w, wlast));
    lo = big_endian(raw_word(words, w + 1, wlast));
    next_raw = raw_word(words, w + 2, wlast);
  }

  __device__ __forceinline__ void init(const uint32_t* __restrict__ data,
                                       int n, int bit) {
    words = data;
    nbytes = n;
    // the last word within the staged bytes and their 8 bytes of padding
    wlast = (n + 4) >> 2;
    seek(bit);
  }

  // Move to `bit`, at or after the current position: a symbol moves at
  // most 32 bits, so one word; a longer move (a DC spill of a table with
  // a size past 16) seeks.
  __device__ __forceinline__ void advance(int bit) {
    advance1(bit);
    if (!synced(bit)) seek(bit);
  }

  // The one-word move alone, by selects and a predicated load; a longer
  // move leaves the window out of step (!synced) until a seek.
  __device__ __forceinline__ void advance1(int bit) {
    const bool cross = (bit >> 5) != w;
    const uint32_t lo_next = big_endian(next_raw);
    hi = cross ? lo : hi;
    lo = cross ? lo_next : lo;
    w += cross;
    if (cross) next_raw = __ldg(words + min(w + 2, wlast));
  }

  __device__ __forceinline__ bool synced(int bit) const {
    return (bit >> 5) == w;
  }

  // kChecked: the position may lie outside the bytes, where the window is
  // the reference's clamped one (window()); else it lies at least 32 bits
  // before their end, so that the window and any spilled magnitude come
  // from the registers.
  template <bool kChecked>
  __device__ __forceinline__ int win16(int bit) const {
    if (kChecked && (unsigned)(bit >> 3) >= (unsigned)nbytes)
      return (int)((window(words, nbytes, bit) >> (16 - (bit & 7))) &
                   0xFFFFu);
    return (int)(__funnelshift_l(lo, hi, bit & 31) >> 16);
  }

  // The szu (1..16) bits at pos2 = bit + consume (consume <= 16).
  template <bool kChecked>
  __device__ __forceinline__ int bits_after(int bit, int consume,
                                            int szu) const {
    const int pos2 = bit + consume;
    if (kChecked && (unsigned)(pos2 >> 3) >= (unsigned)nbytes) {
      const uint32_t w2 = window(words, nbytes, pos2);
      return (int)((w2 >> (32 - (pos2 & 7) - szu)) & ((1u << szu) - 1u));
    }
    const uint64_t v = ((uint64_t)hi << 32) | lo;
    return (int)((v << ((bit & 31) + consume)) >> (64 - szu));
  }
};

// The shared address of the fast-table entry of window win16 in table
// tbl, from the table's base `sfast`.
__device__ __forceinline__ uint32_t fast_entry(uint32_t sfast, int tbl,
                                               int win16) {
  return sfast + 4u * (uint32_t)((tbl << kFastBits) |
                                 (win16 >> (16 - kFastBits)));
}

// The symbol of window win16 in table tbl: the fast-table entry `e` (the
// global table `lut` on a miss), with the register window. Unchecked, the
// magnitude is formed for every symbol, without a branch, and kept for a
// spill only.
template <bool kChecked>
__device__ __forceinline__ Symbol fast_lookup(const BitWindow& r, uint32_t e,
                                              const uint32_t* __restrict__ lut,
                                              int tbl, int win16, int bit,
                                              bool is_dc) {
  Symbol y;
  y.e = e == kFastMiss ? __ldg(lut + (uint32_t)((tbl << 16) | win16)) : e;
  y.consume = (int)(y.e >> 24);
  y.flags = (int)((y.e >> 16) & 0xFF);
  y.val = (int)(int16_t)(uint16_t)(y.e & 0xFFFFu);
  y.is_code = y.flags == kRunCode;
  y.r_sp = is_dc ? 0 : (y.val >> 4);
  y.sz_sp = is_dc ? y.val : (y.val & 15);
  const bool spill = y.is_code && y.sz_sp > 0;
  // EXTEND of a spilled magnitude of sz bits: the clipped shifts of the
  // reference, s1 = clip(sz - 1, 0, 15) and clip(sz, 0, 16) = s1 + 1
  const int s1 = clampi(y.sz_sp - 1, 0, 15);
  int mag = 0;
  if (!kChecked || spill) mag = r.bits_after<kChecked>(bit, y.consume, s1 + 1);
  const int ext = mag < (1 << s1) ? mag - (2 << s1) + 1 : mag;
  y.ext = spill ? ext : 0;
  return y;
}

// Each sub-block's table class (times 2) and component, packed into two
// registers when the lane starts, so that a step takes the current
// sub-block's with a shift and a mask and no load. A JPEG MCU has at most
// 10 blocks; the launchers take bpm <= kMaxBpm.
struct SubBlock {
  uint32_t tmask;   // bit s: the class of sub-block s
  uint32_t cmask;   // bits 2s, 2s + 1: its component
  int bpm, sub, tcls2, comp;

  __device__ __forceinline__ void init(const int32_t* __restrict__ comp_of,
                                       const int32_t* __restrict__ tclass_of,
                                       int b, int s) {
    bpm = b;
    tmask = cmask = 0u;
    for (int i = 0; i < bpm; ++i) {
      tmask |= (uint32_t)clampi(__ldg(tclass_of + i), 0, 1) << i;
      cmask |= (uint32_t)clampi(__ldg(comp_of + i), 0, 2) << (2 * i);
    }
    move_to(s);
  }

  __device__ __forceinline__ void move_to(int s) {
    sub = s;
    const int subc = clampi(s, 0, bpm - 1);
    tcls2 = (int)((tmask >> subc) & 1u) * 2;
    comp = (int)((cmask >> (2 * subc)) & 3u);
  }
};

// Copy a group's four fast tables into shared memory (16-byte aligned).
__device__ __forceinline__ void load_fast(uint4* dst,
                                          const uint32_t* __restrict__ fast,
                                          int group) {
  const uint4* src =
      reinterpret_cast<const uint4*>(fast + (size_t)group * kFastWords);
#pragma unroll 8
  for (int i = threadIdx.x; i < kFastWords / 4; i += blockDim.x)
    dst[i] = __ldg(src + i);
}

// Add d to the one of a, b, c that i names (none for i = 3), by selects:
// an index into registers, or a reference to one, would put them in
// local memory.
__device__ __forceinline__ void add_to(uint32_t& a, uint32_t& b, uint32_t& c,
                                       int i, uint32_t d) {
  a = i == 0 ? a + d : a;
  b = i == 1 ? b + d : b;
  c = i == 2 ? c + d : c;
}

// The first bit past which a position may need window()'s clamp: a
// symbol reads at most 32 bits from its position.
__device__ __forceinline__ int unchecked_end(int nbytes) {
  return max(8 * nbytes - 32, 0);
}

// A K9 lane: decode_lanes_bmap's loop body for one lane.
struct DecodeLane {
  BitWindow r;
  SubBlock sb;
  const uint32_t* __restrict__ lut;
  const int32_t* __restrict__ bmap;
  int16_t* __restrict__ out;
  uint32_t sfast, szz;
  int bit, blk, blk_end, bit_stop, k, img_base, bmap_base, bmap_len,
      bm_next, out_size;
  uint32_t block;   // img_base + 64 * the block map entry of blk
  uint32_t p0, p1, p2;
  bool done;
  // the next step's window and fast-table entry, read ahead (unchecked)
  int win_next;
  uint32_t e_next;

  __device__ __forceinline__ void read_ahead() {
    win_next = r.win16<false>(bit);
    e_next = lds(fast_entry(sfast, sb.tcls2 + (k != 0), win_next));
  }

  // Unchecked, the step's entry was read ahead, and it reads the next
  // one's as soon as its position, k and sub are known, so that the
  // shared-memory latency overlaps the rest of the step.
  template <bool kChecked>
  __device__ __forceinline__ void step() {
    const bool is_dc = k == 0;
    const int tbl = sb.tcls2 + (is_dc ? 0 : 1);
    const int win16 = kChecked ? r.win16<true>(bit) : win_next;
    const uint32_t e0 =
        kChecked ? lds(fast_entry(sfast, tbl, win16)) : e_next;
    const Symbol y =
        fast_lookup<kChecked>(r, e0, lut, tbl, win16, bit, is_dc);
    const bool invalid = y.e == 0;
    const int total = y.consume + (y.is_code ? y.sz_sp : 0);
    add_to(p0, p1, p2, is_dc ? sb.comp : 3,
           (uint32_t)(y.is_code ? y.ext : y.val));
    const uint32_t pred = sb.comp == 0 ? p0 : (sb.comp == 1 ? p1 : p2);

    const bool is_comb = y.flags < 64;
    const int run = is_comb ? y.flags : y.r_sp;
    const int kk = k + run;
    const bool coded = is_comb || y.is_code;
    const bool ac_emit = !is_dc && coded && kk <= 63;
    const bool overrun = !is_dc && coded && kk > 63;
    const int zz_kk = (int)lds(szz + 4u * clampi(kk, 0, 63));
    const int pos = is_dc ? 0 : zz_kk;
    const int idx = (int)(block + (uint32_t)pos);
    const uint32_t v = is_dc ? pred : (uint32_t)(is_comb ? y.val : y.ext);
    if ((is_dc || ac_emit) && (unsigned)idx < (unsigned)out_size)
      out[idx] = (int16_t)(uint16_t)v;

    int k_next = is_dc ? 1 : (y.flags == kRunZrl ? k + 16 : kk + 1);
    const bool block_end = !is_dc && (y.flags == kRunEob || k_next > 63);
    if (block_end) k_next = 0;
    int sub = block_end ? sb.sub + 1 : sb.sub;
    if (sub >= sb.bpm) sub = 0;
    sb.move_to(sub);
    if (block_end) {
      ++blk;
      block = (uint32_t)img_base + (uint32_t)bm_next * 64u;
      bm_next = __ldg(bmap + clampi(bmap_base + blk + 1, 0, bmap_len - 1));
    }
    bit += total;
    k = k_next;
    if (kChecked) {
      r.advance(bit);
    } else {
      r.advance1(bit);
      read_ahead();
    }
    done = invalid || overrun || blk >= blk_end || bit >= bit_stop;
  }
};

// K9. Replaces decode_lanes_bmap (ffpic_tpu/ops/jpeg_entropy_device.py
// :139), the TPU's lane-vectorised while loop: here each lane is a
// thread that runs its own loop, so a lane that finishes early costs the
// others nothing. CTA b decodes the plan's row b (group, first lane,
// lane count <= kLaneThreads) with that group's tables, which must be
// each of its lanes' lut_idx (else __trap); each lane runs
// the loop without checks while its position is 32 bits or more before
// the end of the bytes. Lane table row
// (int32): bit0, blk0, blk_end, img_base, lut_idx, bmap_base, k0, sub0,
// pred0[3], bit_stop.
__global__ void __launch_bounds__(kLaneThreads)
    entropy_decode_kernel(const uint32_t* __restrict__ words, int nbytes,
                          const uint32_t* __restrict__ luts,
                          const uint32_t* __restrict__ fast, int n_groups,
                          const int32_t* __restrict__ zz,
                          const int32_t* __restrict__ comp_of,
                          const int32_t* __restrict__ tclass_of,
                          const int32_t* __restrict__ bmap, int bmap_len,
                          const int32_t* __restrict__ lanes, int n_lanes,
                          const int32_t* __restrict__ plan, int bpm,
                          int16_t* __restrict__ out, int out_size,
                          int max_steps, int32_t* __restrict__ steps_out) {
  extern __shared__ uint4 fast_smem[];
  __shared__ int32_t szz[64];
  const int plan_group = plan[3 * blockIdx.x];
  const int group = clampi(plan_group, 0, n_groups - 1);
  const int first = plan[3 * blockIdx.x + 1];
  const int count = plan[3 * blockIdx.x + 2];
  load_fast(fast_smem, fast, group);
  for (int i = threadIdx.x; i < 64; i += blockDim.x) szz[i] = __ldg(zz + i);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= count || first < 0 || t >= n_lanes - first) return;
  const int lane = first + t;
  const int32_t* row = lanes + (size_t)lane * kLaneCols;
  // a plan that does not match the lanes would decode with another
  // group's tables: stop the launch instead
  if (row[4] != plan_group) __trap();
  DecodeLane d;
  d.lut = luts + (size_t)group * 4 * 65536;
  d.bmap = bmap;
  d.out = out;
  d.sfast = smem_addr(fast_smem);
  d.szz = smem_addr(szz);
  d.bit = row[0];
  d.blk = row[1];
  d.blk_end = row[2];
  d.img_base = row[3];
  d.bmap_base = row[5];
  d.k = row[6];
  d.p0 = (uint32_t)row[8];
  d.p1 = (uint32_t)row[9];
  d.p2 = (uint32_t)row[10];
  d.bit_stop = row[11];
  d.bmap_len = bmap_len;
  d.out_size = out_size;
  d.r.init(words, nbytes, d.bit);
  d.sb.init(comp_of, tclass_of, bpm, row[7]);
  // this block's map entry and the next one's
  d.block = (uint32_t)d.img_base +
            (uint32_t)__ldg(bmap + clampi(d.bmap_base + d.blk, 0,
                                          bmap_len - 1)) * 64u;
  d.bm_next = __ldg(bmap + clampi(d.bmap_base + d.blk + 1, 0, bmap_len - 1));
  d.done = d.blk >= d.blk_end || d.bit >= d.bit_stop;
  const unsigned fast_end = (unsigned)unchecked_end(nbytes);
  int step = 0;
  while (!d.done && step < max_steps) {
    if ((unsigned)d.bit < fast_end) {
      // the loop that nearly every symbol takes: no bounds, no branch
      d.read_ahead();
      do {
        d.step<false>();
        ++step;
      } while (!d.done && step < max_steps && (unsigned)d.bit < fast_end &&
               d.r.synced(d.bit));
      if (!d.r.synced(d.bit)) d.r.seek(d.bit);
    } else {
      d.step<true>();
      ++step;
    }
  }
  steps_out[lane] = step;
}

// A K10 chunk's walk (and K11's): the speculative step through the fast
// table and the register window.
struct SpecLane {
  BitWindow r;
  SubBlock sb;
  const uint32_t* __restrict__ lut;
  uint32_t sfast;
  int bit, k, blk;
  uint32_t d0, d1, d2;
  int win_next;       // as DecodeLane's
  uint32_t e_next;

  __device__ __forceinline__ void read_ahead() {
    win_next = r.win16<false>(bit);
    e_next = lds(fast_entry(sfast, sb.tcls2 + (k != 0), win_next));
  }

  template <bool kChecked>
  __device__ __forceinline__ void step() {
    const bool is_dc = k == 0;
    const int tbl = sb.tcls2 + (is_dc ? 0 : 1);
    const int win16 = kChecked ? r.win16<true>(bit) : win_next;
    const uint32_t e0 =
        kChecked ? lds(fast_entry(sfast, tbl, win16)) : e_next;
    const Symbol y =
        fast_lookup<kChecked>(r, e0, lut, tbl, win16, bit, is_dc);
    const bool invalid = y.e == 0;
    const int adv = invalid ? 1 : y.consume + (y.is_code ? y.sz_sp : 0);
    add_to(d0, d1, d2, is_dc && !invalid ? sb.comp : 3,
           (uint32_t)(y.is_code ? y.ext : y.val));
    const int run = y.flags < 64 ? y.flags : y.r_sp;
    const int k_ac = y.flags == kRunZrl ? k + 16 : k + run + 1;
    // 0 or 1, as ints: a bool here made the compiler branch
    const int block_end =
        (int)(!is_dc & !invalid & ((y.flags == kRunEob) | (k_ac > 63)));
    const int k_next = invalid ? k : (is_dc ? 1 : (block_end ? 0 : k_ac));
    int sub = sb.sub + block_end;
    if (sub >= sb.bpm) sub = 0;
    sb.move_to(sub);
    bit += adv;
    k = k_next;
    blk += block_end;
    if (kChecked) {
      r.advance(bit);
    } else {
      r.advance1(bit);
      read_ahead();
    }
  }

  __device__ __forceinline__ SpecState state() const {
    return {bit, k, sb.sub, blk, {d0, d1, d2}};
  }
};

// K10. Replaces spec_snap_lanes (:424) and spec_scan_lanes (:374) as
// spec_decode_full (:558) calls them: both walk the same trajectory from
// (bit0, k = 0, sub = 0), so one thread walks it once. Boundary b (the
// state after b symbols) is recorded in slot b / 8 when b % 8 == 0 and
// b < 2048, for every b up to the exit boundary (the first at or past
// bit_end), which is recorded only when its index is such a multiple, as
// the JAX loop's order gives; the other slots get -1. The exit state is
// the one after min(exit, max_steps) symbols; past max_steps the walk
// goes on only as far as the snapshots need.
__global__ void __launch_bounds__(kSpecLanes)
    spec_scan_kernel(const uint32_t* __restrict__ words, int nbytes,
                     const uint32_t* __restrict__ lut,
                     const uint32_t* __restrict__ fast,
                     const int32_t* __restrict__ comp_of,
                     const int32_t* __restrict__ tclass_of, int bpm,
                     const int32_t* __restrict__ chunks, int n_lanes,
                     int max_steps, int32_t* __restrict__ exits,
                     int32_t* __restrict__ snap) {
  extern __shared__ uint4 fast_smem[];
  load_fast(fast_smem, fast, 0);
  __syncthreads();
  const int lane = blockIdx.x * kSpecLanes + threadIdx.x;
  if (lane >= n_lanes) return;
  const int bit_end = chunks[2 * lane + 1];
  SpecLane c;
  c.lut = lut;
  c.sfast = smem_addr(fast_smem);
  c.bit = chunks[2 * lane];
  c.k = 0;
  c.blk = 0;
  c.d0 = c.d1 = c.d2 = 0u;
  SpecState ex = {c.bit, 0, 0, 0, {0u, 0u, 0u}};
  int32_t* rec = snap + (size_t)lane * kSnap * kSnapCols;
  int nrec = 0;
  if (c.bit < bit_end) {
    c.r.init(words, nbytes, c.bit);
    c.sb.init(comp_of, tclass_of, bpm, 0);
    const unsigned fast_end = (unsigned)unchecked_end(nbytes);
    constexpr int kSnapSteps = kSnap * kSnapStride;
    bool saved = false;
    for (int b = 0;;) {
      if (b < kSnapSteps && b % kSnapStride == 0) {
        int32_t* o = rec + (size_t)nrec * kSnapCols;
        o[0] = c.bit; o[1] = c.k; o[2] = c.sb.sub; o[3] = c.blk;
        o[4] = (int32_t)c.d0; o[5] = (int32_t)c.d1; o[6] = (int32_t)c.d2;
        ++nrec;
      }
      if (c.bit >= bit_end) break;
      if (b == max_steps) {
        ex = c.state();
        saved = true;
      }
      if (saved && b >= kSnapSteps - 1) break;
      if ((unsigned)c.bit < fast_end) {
        // steps with nothing to check but the exit, up to the next
        // boundary the checks above need: a snapshot, max_steps, the end
        // of the snapshots once saved
        int until = b < kSnapSteps ? (b / kSnapStride + 1) * kSnapStride
                                   : 0x7FFFFFFF;
        if (b < max_steps) until = min(until, max_steps);
        if (saved) until = min(until, kSnapSteps - 1);
        c.read_ahead();
        do {
          c.step<false>();
          ++b;
        } while (b < until && c.bit < bit_end &&
                 (unsigned)c.bit < fast_end && c.r.synced(c.bit));
        if (!c.r.synced(c.bit)) c.r.seek(c.bit);
      } else {
        c.step<true>();
        ++b;
      }
    }
    if (!saved) ex = c.state();
  }
  for (int i = nrec * kSnapCols; i < kSnap * kSnapCols; ++i) rec[i] = -1;
  int32_t* o = exits + (size_t)lane * kSnapCols;
  o[0] = ex.bit; o[1] = ex.k; o[2] = ex.sub; o[3] = ex.blk;
  o[4] = (int32_t)ex.dc[0]; o[5] = (int32_t)ex.dc[1];
  o[6] = (int32_t)ex.dc[2];
}

// K11's view of a lane's snapshots (K10's rows bit, k, sub, ... in slot
// order, the used slots first, their bits strictly increasing, the rest
// -1): slot p's (bit, k, sub) in registers, and slot p + 1's loaded while
// the walk goes on, so that moving to it waits on nothing (nothing reads a
// loaded value before the move that takes it). The slot only moves
// forward; p == kSnap is past the last slot.
struct SnapCursor {
  const int32_t* __restrict__ rec;
  int p, bit, k, sub;        // slot p
  int nbit, nk, nsub;        // slot p + 1 (the last slot's past it)

  __device__ __forceinline__ void load_next() {
    const int32_t* o = rec + (size_t)min(p + 1, kSnap - 1) * kSnapCols;
    nbit = __ldg(o);
    nk = __ldg(o + 1);
    nsub = __ldg(o + 2);
  }

  __device__ __forceinline__ void init(const int32_t* __restrict__ r) {
    rec = r;
    p = 0;
    bit = __ldg(r);
    k = __ldg(r + 1);
    sub = __ldg(r + 2);
    load_next();
  }

  // Slot p is a used one.
  __device__ __forceinline__ bool used() const {
    return p < kSnap && bit != -1;
  }

  // Move past the used slots whose bit lies below `at`.
  __device__ __forceinline__ void seek(int at) {
    while (used() && bit < at) {
      bit = nbit;
      k = nk;
      sub = nsub;
      ++p;
      load_next();
    }
  }

  // Past the last recorded bit: every used slot lies below `at` (none
  // used: the reference's maximum bit is then -1).
  __device__ __forceinline__ bool past(int at) const {
    return !used() && (p > 0 || at > -1);
  }
};

// The state of walk c after t symbols against the snapshots: true to
// stop, with matched set on a match.
__device__ __forceinline__ bool merge_check(SnapCursor& sc, const SpecLane& c,
                                            int t, int& matched) {
  sc.seek(c.bit);
  if (sc.used() && sc.bit == c.bit && sc.k == c.k && sc.sub == c.sb.sub) {
    matched = 1;
    return true;
  }
  return sc.past(c.bit) || t > kMergeSteps;
}

// K11. Replaces spec_merge_lanes (:490): from the true entry (the
// predecessor's exit), check the state against the lane's snapshots
// before each symbol; stop at the first match, past the last recorded
// bit, or after kMergeSteps symbols. The used slots are the first ones,
// their bits strictly increasing (every symbol advances at least one
// bit), so a cursor that only moves forward finds the one slot that can
// hold the state's bit: the same first match as the reference's argmax
// over all slots. The walk is K10's (SpecLane: the group's fast tables in
// shared memory, the register window, the entry read one symbol ahead),
// the slot to compare with in registers (SnapCursor), kMergeLanes chunks a
// CTA, whose kMergeThreads threads all copy the fast tables first.
// Output row: matched, midx, blocks, DC sums.
__global__ void __launch_bounds__(kMergeThreads)
    spec_merge_kernel(const uint32_t* __restrict__ words, int nbytes,
                      const uint32_t* __restrict__ lut,
                      const uint32_t* __restrict__ fast,
                      const int32_t* __restrict__ comp_of,
                      const int32_t* __restrict__ tclass_of, int bpm,
                      const int32_t* __restrict__ ent, int n_lanes,
                      const int32_t* __restrict__ snap,
                      int32_t* __restrict__ merged) {
  extern __shared__ uint4 fast_smem[];
  load_fast(fast_smem, fast, 0);
  __syncthreads();
  const int lane = blockIdx.x * kMergeLanes + threadIdx.x;
  if (threadIdx.x >= kMergeLanes || lane >= n_lanes) return;
  SnapCursor sc;
  sc.init(snap + (size_t)lane * kSnap * kSnapCols);
  SpecLane c;
  c.lut = lut;
  c.sfast = smem_addr(fast_smem);
  c.bit = ent[3 * lane];
  c.k = ent[3 * lane + 1];
  c.blk = 0;
  c.d0 = c.d1 = c.d2 = 0u;
  c.r.init(words, nbytes, c.bit);
  c.sb.init(comp_of, tclass_of, bpm, ent[3 * lane + 2]);
  const unsigned fast_end = (unsigned)unchecked_end(nbytes);
  int t = 0, matched = 0;
  while (!merge_check(sc, c, t, matched)) {
    if ((unsigned)c.bit < fast_end) {
      // steps with no bounds to check, as K10's; the state can meet a
      // snapshot, or pass the last, only once its bit reaches slot p's
      c.read_ahead();
      bool stop = false;
      do {
        c.step<false>();
        ++t;
        if (c.bit >= sc.bit || t > kMergeSteps) {
          stop = merge_check(sc, c, t, matched);
          if (stop) break;
        }
      } while ((unsigned)c.bit < fast_end && c.r.synced(c.bit));
      if (stop) break;
      if (!c.r.synced(c.bit)) c.r.seek(c.bit);
    } else {
      c.step<true>();
      ++t;
    }
  }
  int32_t* o = merged + (size_t)lane * 6;
  o[0] = matched; o[1] = matched ? sc.p : 0; o[2] = c.blk;
  o[3] = (int32_t)c.d0; o[4] = (int32_t)c.d1; o[5] = (int32_t)c.d2;
}

// bit positions are int: 8 * nbytes and the padding must fit
bool bad_common(const void* data, int nbytes, int bpm, int n_lanes) {
  return nbytes <= 0 || bpm <= 0 || n_lanes <= 0 ||
         ((uintptr_t)data & 3) || nbytes > 0x7FFFFFFF / 8 - 8;
}

unsigned lane_blocks(int n_lanes, int per_block) {
  return (unsigned)((n_lanes + per_block - 1) / per_block);
}

// The fast tables take dynamic shared memory, past 48 KB only after this.
template <typename Kernel>
cudaError_t allow_fast_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kFastBytes);
}

}  // namespace

extern "C" {

// data: nbytes scan bytes and at least 8 zero bytes after them; fast:
// n_groups * 4 fast tables of 2^fast_bits uint32, 16-byte aligned;
// plan: (n_ctas, 3) int32 group, first lane, lane count; out: out_size
// int16, zeroed here, then the lanes' coefficients
int ffpic_entropy_decode(const void* data, int nbytes, const void* luts,
                         const void* fast, int n_groups, int fast_bits,
                         const void* zz, const void* comp_of,
                         const void* tclass_of, const void* bmap,
                         int bmap_len, const void* lanes, int n_lanes,
                         const void* plan, int n_ctas, int bpm, void* out,
                         int out_size, int max_steps, void* steps,
                         int lane_cols, void* stream) {
  if (bad_common(data, nbytes, bpm, n_lanes) || bpm > kMaxBpm ||
      lane_cols != kLaneCols || bmap_len <= 0 || out_size <= 0 ||
      max_steps < 0 || n_groups <= 0 ||
      fast_bits != kFastBits || ((uintptr_t)fast & 15) || n_ctas <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * (size_t)out_size, st);
  if (err == cudaSuccess) err = allow_fast_smem(entropy_decode_kernel);
  if (err != cudaSuccess) return (int)err;
  entropy_decode_kernel<<<(unsigned)n_ctas, kLaneThreads, kFastBytes, st>>>(
      (const uint32_t*)data, nbytes, (const uint32_t*)luts,
      (const uint32_t*)fast, n_groups, (const int32_t*)zz,
      (const int32_t*)comp_of, (const int32_t*)tclass_of,
      (const int32_t*)bmap, bmap_len, (const int32_t*)lanes, n_lanes,
      (const int32_t*)plan, bpm, (int16_t*)out, out_size, max_steps,
      (int32_t*)steps);
  return (int)cudaGetLastError();
}

// chunks: (n_lanes, 2) int32 bit0, bit_end; fast: the 4 fast tables of
// 2^fast_bits uint32 of the one group, 16-byte aligned; exits (n_lanes,
// 7) and snap (n_lanes, snap_slots, 7) int32, written whole
int ffpic_spec_scan(const void* data, int nbytes, const void* lut,
                    const void* fast, int fast_bits, const void* comp_of,
                    const void* tclass_of, int bpm, const void* chunks,
                    int n_lanes, int max_steps, void* exits, void* snap,
                    int snap_slots, int snap_stride, void* stream) {
  if (bad_common(data, nbytes, bpm, n_lanes) || bpm > kMaxBpm ||
      snap_slots != kSnap || snap_stride != kSnapStride || max_steps < 0 ||
      fast_bits != kFastBits || ((uintptr_t)fast & 15))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_fast_smem(spec_scan_kernel);
  if (err != cudaSuccess) return (int)err;
  spec_scan_kernel<<<lane_blocks(n_lanes, kSpecLanes), kSpecLanes,
                     kFastBytes, (cudaStream_t)stream>>>(
      (const uint32_t*)data, nbytes, (const uint32_t*)lut,
      (const uint32_t*)fast, (const int32_t*)comp_of,
      (const int32_t*)tclass_of, bpm, (const int32_t*)chunks, n_lanes,
      max_steps, (int32_t*)exits, (int32_t*)snap);
  return (int)cudaGetLastError();
}

// fast: the 4 fast tables of 2^fast_bits uint32 of the one group, 16-byte
// aligned; ent: (n_lanes, 3) int32 bit, k, sub; snap (n_lanes, snap_slots,
// 7) int32 as K10 writes it; merged (n_lanes, 6) int32
int ffpic_spec_merge(const void* data, int nbytes, const void* lut,
                     const void* fast, int fast_bits, const void* comp_of,
                     const void* tclass_of, int bpm, const void* ent,
                     int n_lanes, const void* snap, int snap_slots,
                     void* merged, void* stream) {
  if (bad_common(data, nbytes, bpm, n_lanes) || bpm > kMaxBpm ||
      snap_slots != kSnap || fast_bits != kFastBits ||
      ((uintptr_t)fast & 15))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_fast_smem(spec_merge_kernel);
  if (err != cudaSuccess) return (int)err;
  spec_merge_kernel<<<lane_blocks(n_lanes, kMergeLanes), kMergeThreads,
                      kFastBytes, (cudaStream_t)stream>>>(
      (const uint32_t*)data, nbytes, (const uint32_t*)lut,
      (const uint32_t*)fast, (const int32_t*)comp_of,
      (const int32_t*)tclass_of, bpm, (const int32_t*)ent, n_lanes,
      (const int32_t*)snap, (int32_t*)merged);
  return (int)cudaGetLastError();
}

}  // extern "C"
