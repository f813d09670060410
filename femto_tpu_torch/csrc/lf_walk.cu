// Kernel D, lf_walk: LF-mapping walks over the full, compact, packed,
// vseg and vrle layouts (one instantiation each), two entry points, and
// the two steps of paged locate (femto_tpu/paged.py, K16) on the row tiers.
//
// locate replaces femto_tpu/ops/search_ops.py locate_rows (115) with
// ops/rank.py lf_grank_step (883), mark_rank (821) and mark_offset (842):
// walk LF until the row is marked (at most mark_period + 1 checks), take
// its mark rank from mark_ckpt + popcounts of the segment's bitmap words,
// and decode the bit-packed mark value.  extract replaces
// ops/search_ops.py extract_backward (342): walk num_steps times, emitting
// the symbol of each row (dense codes unmapped through alpha_rev, as
// rank.py unmap_char does).
//
// The TPU walked every lane in lockstep for the longest walk and gathered
// whole [B, seg] rows per step; here each walk is a thread's or a warp's
// own and stops at its own mark, so there is no lockstep tail (the reason
// femto_tpu's locate_rows_pyramid exists), and each step reads only the
// segment prefix it counts.  On the row tiers (vseg, vrle; K11-K13) one
// serving row gives the code, the symbol list, the checkpoint, the count
// and the marks, as femto_tpu's one-row walk step (ops/rank.py
// lf_grank_step 895-911) does; a run-length segment is read by a walk
// over its slots that stops at the position it needs.
//
// lf_walk_step replaces femto_tpu/paged.py _walk_step (73): ONE step of
// the walk above per launch, its state (row, mark rank, step, done) kept
// per lane in device memory between launches, so that the host can fault
// in the rows of the next step (paged serving reads every row through the
// view's seg_slot).  A done lane is left as it is and reads no row; a
// marked lane takes its mark rank and the step number i; any other lane
// steps LF.  resolve_marks replaces paged.py _resolve_marks (86):
// mark_offset(g) + steps per lane, after the walk, a thread a lane.
//
// Two routes, one rule for the three walking entries (warp_route_smem,
// exposed as femto_lf_walk_route): extract on every layout, locate and
// the paged step on vseg and vrle take the warp route up to
// warp_route_max walks (8192 on full, compact and packed; on vseg and
// vrle a limit that grows with seg and with the index's side and
// continued segments) where a block's buffers fit an SM; locate on full,
// compact and packed keeps the thread route.  The thread route walks a
// row per thread with lf_step below: on the row tiers every step walks the
// segment's slots or fields twice (code, then count) through dependent
// loads, on the other layouts it reads the code, then its checkpoint,
// then the counted prefix.  The warp route walks a row per warp: each step
// first issues every load that depends only on the row -- the symbol or
// word at the offset, the counted prefix (16-B chunks or words, the lanes
// taking every 32nd), the segment's whole checkpoint row (full: K ints;
// compact, packed: K uint16 and the L1 row; row tiers: warp_row_fetch,
// the L1 row in registers and the row's code area, symbol list and
// relative checkpoints, for locate with the mark words and the mark
// checkpoint between them, copied to shared memory by cp.async) -- then
// checks the mark (warp_row_mark: the bit, and on a hit a popcount a lane
// of the earlier mark words and a warp sum), decodes and counts from
// registers and shared memory (SWAR per lane, warp scans of run lengths,
// a warp sum), picks the checkpoint by a shuffle, and takes C[c] and
// alpha_rev from shared memory: one dependent DRAM round trip a step, two
// on a side segment (its side row) or a continued run-length segment (its
// granules), whose addresses come from seg_woff, on a step that misses
// its mark.  extract and locate share that body (warp_row_fetch,
// warp_row_lf).  A large batch on full, compact or packed keeps the
// thread route, which moves fewer bytes a step.  A warp's buffer on a row
// tier (row_buf_words) is the stream area, the larger of the code area
// with its granules and a side row, and the row from its symbol list on,
// seg / 32 + 1 words more than extract alone needed (the mark words and
// the mark checkpoint); on 8 MiB of English prose at seg 2048 (phase 3 of
// chip_smoke.py prints it) 672 words on vrle and 664 on vseg, 12,020 and
// 11,892 bytes a block of four walks with C and alpha_rev.
//
// Bound on the H100: bytes of dependent random gathers.  Per step: one
// mark word, one symbol (word), the checkpoint and the counted row prefix;
// per hit the segment's mark words, one mark_ckpt int and two or three
// mark_vals words.  chip_smoke.py sums those over this run's steps and
// divides by 3.35 TB/s; the walk itself is a chain of dependent loads, so
// latency, not bandwidth, is what this kernel meets.
//
// The row tiers' warp step and the route rule live in fm_common.cuh,
// which csrc/dist_query.cu's owner_lf shares.
#include "fm_common.cuh"

namespace {

using femto::block_load_c;
using femto::kWarpWalks;
using femto::launch_warps;
using femto::RowFetch;
using femto::warp_buf_start;
using femto::warp_locate_row;
using femto::warp_route_smem;
using femto::warp_row_fetch;
using femto::warp_row_lf;

// One LF step from row r: LF(r) = C[c] + occ(c, r) with c = the code at r.
// Returns -1 (and leaves *code the pad code) on a pad row.
template <int L>
__device__ __forceinline__ long long lf_step(const femto::FmView& ix,
                                             long long r, int* code) {
  const long long s = r / ix.seg;
  const int off = static_cast<int>(r - s * ix.seg);
  if constexpr (femto::is_row<L>()) {
    // the count is of the row's own (local) code, as the JAX step does
    const unsigned* row = femto::row_of(ix, s);
    const int woff = __ldg(ix.seg_woff + s);
    const int lc = femto::row_lane_code<L>(ix, row, s, woff, off);
    const int c = woff > 0 ? lc : femto::row_global(ix, row, lc);
    *code = c;
    if (c >= ix.K) return -1;
    return static_cast<long long>(__ldg(ix.C + c)) +
           femto::ckpt_base<L>(ix, s, c) +
           femto::row_within<L>(ix, row, s, woff, lc, 0, off);
  }
  const int c = femto::code_at<L>(ix, s, off);
  *code = c;
  if (c >= ix.K) return -1;
  return static_cast<long long>(__ldg(ix.C + c)) +
         femto::ckpt_base<L>(ix, s, c) +
         femto::count_range<L>(ix, s, 0, off, c);
}

// ops/rank.py mark_offset: decode the packed store's slot g.
// mark_meta = [bits, exc_base, period, exc_off (words), cap].
__device__ __forceinline__ int mark_offset(const unsigned* __restrict__ mv,
                                           long long mv_len,
                                           const int* __restrict__ mm, int g) {
  const int bits = __ldg(mm + 0), exc_base = __ldg(mm + 1);
  const int period = __ldg(mm + 2), exc_off = __ldg(mm + 3);
  const int cap = __ldg(mm + 4);
  g = min(max(g, 0), cap - 1);
  const long long bp = static_cast<long long>(g) * bits;
  const long long wi = bp >> 5;
  const unsigned sh = static_cast<unsigned>(bp & 31);
  const unsigned lo = __ldg(mv + wi) >> sh;
  const unsigned hi = sh == 0 ? 0u : (__ldg(mv + wi + 1) << (32u - sh));
  const unsigned mask = (1u << bits) - 1u;
  const int k = static_cast<int>((lo | hi) & mask);
  if (k < exc_base) return k * period;
  long long e = static_cast<long long>(exc_off) + (k - exc_base);
  e = min(max(e, 0LL), mv_len - 1);
  return static_cast<int>(__ldg(mv + e));
}

template <int L>
__global__ void lf_locate_kernel(femto::FmView ix,
                                 const int* __restrict__ rows, int B,
                                 const unsigned* __restrict__ mark_bits,
                                 const int* __restrict__ mark_ckpt,
                                 const unsigned* __restrict__ mark_vals,
                                 long long mark_vals_len,
                                 const int* __restrict__ mark_meta,
                                 int mark_period, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int words_per_seg = ix.seg >> 5;
  long long r = rows[b];
  int result = -1;
  for (int i = 0; i <= mark_period && r >= 0; ++i) {
    const long long s = r / ix.seg;
    const int wl = static_cast<int>(r - s * ix.seg) >> 5;
    // the row tiers keep the segment's mark words and checkpoint in its row
    const unsigned* words = femto::is_row<L>()
                                ? femto::row_of(ix, s) + ix.off_mk
                                : mark_bits + s * words_per_seg;
    const unsigned w = __ldg(words + wl);
    const unsigned bit = static_cast<unsigned>(r & 31);
    if ((w >> bit) & 1u) {
      int g = femto::is_row<L>()
                  ? static_cast<int>(__ldg(femto::row_of(ix, s) + ix.off_mck))
                  : __ldg(mark_ckpt + s);
      for (int k = 0; k < wl; ++k) g += __popc(__ldg(words + k));
      g += __popc(w & ((1u << bit) - 1u));
      result = mark_offset(mark_vals, mark_vals_len, mark_meta, g) + i;
      break;
    }
    if (i == mark_period) break;  // no mark within reach: -1
    int c;
    r = lf_step<L>(ix, r, &c);
  }
  out[b] = result;
}

template <int L>
__global__ void lf_extract_kernel(femto::FmView ix,
                                  const int* __restrict__ rows, int B,
                                  int num_steps, int* __restrict__ chars,
                                  int* __restrict__ final_rows) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long r = rows[b];
  int* out = chars + static_cast<long long>(b) * num_steps;
  for (int t = 0; t < num_steps; ++t) {
    int c = femto::kInvalidAlpha;
    if (r >= 0) {
      const long long nxt = lf_step<L>(ix, r, &c);
      if (nxt >= 0) {
        r = nxt;
        c = femto::unmap_char(ix, c);
      }  // a pad row (invalid input) stays put and emits its pad code
    }
    out[t] = c;
  }
  final_rows[b] = static_cast<int>(r);
}

// ---- the warp route of extract: one warp a walk ----

// 16-B chunks (full, compact) or words (packed) of the counted prefix a
// lane loads at once: one round for segments up to 2048 symbols
constexpr int kLaneChunks = 8;

// One LF step from row r on full, compact or packed, by the whole warp
// (every lane holds r and gets the result); Cs: C in shared memory.
template <int L>
__device__ __forceinline__ long long warp_step_fixed(const femto::FmView& ix,
                                                     long long r, int lane,
                                                     const int* Cs,
                                                     int* code) {
  // rows lie below 2^31: a 32-bit division, 64-bit offsets after it
  const unsigned su =
      static_cast<unsigned>(r) / static_cast<unsigned>(ix.seg);
  const int off = static_cast<int>(static_cast<unsigned>(r) -
                                   su * static_cast<unsigned>(ix.seg));
  const long long s = su;
  int ck[femto::kRowRegs], l1[femto::kRowRegs];
  int c, cnt = 0;
  if constexpr (L == femto::kFull) {
    femto::warp_row_regs(static_cast<const int*>(ix.occ_ckpt) + s * ix.K,
                         ix.K, lane, ck);
  } else {
    femto::warp_row_regs(
        static_cast<const uint16_t*>(ix.occ_ckpt) + s * ix.K, ix.K, lane, ck);
    femto::warp_row_regs(ix.occ_l1 + (s / ix.grp) * ix.K, ix.K, lane, l1);
  }
  if constexpr (L == femto::kPacked) {
    const unsigned* row = static_cast<const unsigned*>(ix.bwt) + s * ix.W;
    const int per = ix.per_word, bits = ix.bits;
    const int wi = off / per, f = off - wi * per;
    const unsigned word = __ldg(row + wi);
    unsigned v[kLaneChunks];
#pragma unroll
    for (int j = 0; j < kLaneChunks; ++j) {
      const int q = lane + 32 * j;
      v[j] = q < wi ? __ldg(row + q) : 0u;
    }
    c = static_cast<int>((word >> (f * bits)) & ((1u << bits) - 1u));
    const unsigned lsbs = femto::field_lsbs(bits, per);
    const unsigned rep = static_cast<unsigned>(c) * lsbs;
    for (int q0 = 0; q0 < wi; q0 += 32 * kLaneChunks) {
      if (q0 > 0) {
#pragma unroll
        for (int j = 0; j < kLaneChunks; ++j) {
          const int q = q0 + lane + 32 * j;
          v[j] = q < wi ? __ldg(row + q) : 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < kLaneChunks; ++j)
        if (q0 + lane + 32 * j < wi)
          cnt += __popc(femto::zero_fields(v[j] ^ rep, bits, lsbs));
    }
    if (lane == 0 && f > 0)
      cnt += __popc(femto::zero_fields(word ^ rep, bits, lsbs) &
                    ((1u << (f * bits)) - 1u));
  } else {
    const uint16_t* row = static_cast<const uint16_t*>(ix.bwt) + s * ix.seg;
    const uint4* vrow = reinterpret_cast<const uint4*>(row);
    const int nq = (off + 7) >> 3;
    c = __ldg(row + off);
    uint4 v[kLaneChunks];
#pragma unroll
    for (int j = 0; j < kLaneChunks; ++j) {
      const int q = lane + 32 * j;
      if (q < nq) v[j] = __ldg(vrow + q);
    }
    const unsigned cc = static_cast<unsigned>(c) * 0x00010001u;
    for (int q0 = 0; q0 < nq; q0 += 32 * kLaneChunks) {
      if (q0 > 0) {
#pragma unroll
        for (int j = 0; j < kLaneChunks; ++j) {
          const int q = q0 + lane + 32 * j;
          if (q < nq) v[j] = __ldg(vrow + q);
        }
      }
#pragma unroll
      for (int j = 0; j < kLaneChunks; ++j) {
        const int q = q0 + lane + 32 * j;
        if (q < nq) cnt += femto::count8_u16(v[j], cc, off - 8 * q);
      }
    }
  }
  cnt = __reduce_add_sync(femto::kAllLanes, cnt);
  *code = c;
  if (c >= ix.K) return -1;
  const int base = L == femto::kFull
                       ? femto::warp_pick(ck, c)
                       : femto::warp_pick(l1, c) + femto::warp_pick(ck, c);
  return static_cast<long long>(Cs[c]) + base + cnt;
}


// One LF step from row r on vseg or vrle, by the whole warp (extract's
// step): one fetch without the marks, then the count.  buf: the warp's
// row_buf_words words of shared memory.
template <int L>
__device__ __forceinline__ long long warp_step_row(const femto::FmView& ix,
                                                   long long r, int lane,
                                                   const int* Cs,
                                                   unsigned* buf,
                                                   int* code) {
  RowFetch f;
  warp_row_fetch<L>(ix, r, false, lane, buf, f);
  return warp_row_lf<L>(ix, f, lane, Cs, buf, code);
}


// lf_extract_kernel's walks, a warp each (blockDim.x / 32 walks a block).
template <int L>
__global__ void __launch_bounds__(kWarpWalks * 32) lf_extract_warp_kernel(
    femto::FmView ix, const int* __restrict__ rows, int B, int num_steps,
    int* __restrict__ chars, int* __restrict__ final_rows, int buf_words) {
  extern __shared__ unsigned smem[];
  block_load_c(ix, smem, true);
  const int* Cs = reinterpret_cast<const int*>(smem);
  const int* rev = Cs + ix.K + 1;
  const bool remapped = ix.alpha_rev != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  unsigned* buf = smem + warp_buf_start(ix) + warp * buf_words;
  long long r = rows[b];
  int* out = chars + static_cast<long long>(b) * num_steps;
  int mine = 0;  // lane t % 32 keeps step t's symbol until 32 are stored
  for (int t = 0; t < num_steps; ++t) {
    int c = femto::kInvalidAlpha;
    if (r >= 0) {
      long long nxt;
      if constexpr (femto::is_row<L>())
        nxt = warp_step_row<L>(ix, r, lane, Cs, buf, &c);
      else
        nxt = warp_step_fixed<L>(ix, r, lane, Cs, &c);
      if (nxt >= 0) {
        r = nxt;
        c = remapped ? rev[c] : c;
      }  // a pad row (invalid input) stays put and emits its pad code
    }
    if (lane == (t & 31)) mine = c;
    if ((t & 31) == 31 || t == num_steps - 1) {
      const int t0 = t & ~31;
      if (t0 + lane <= t) out[t0 + lane] = mine;
    }
  }
  if (lane == 0) final_rows[b] = static_cast<int>(r);
}

// lf_locate_kernel's walks on vseg and vrle, a warp each: each walk stops
// at its own mark; -1 where no mark is within reach or on a pad row.
template <int L>
__global__ void __launch_bounds__(kWarpWalks * 32) lf_locate_warp_kernel(
    femto::FmView ix, const int* __restrict__ rows, int B,
    const unsigned* __restrict__ mark_vals, long long mark_vals_len,
    const int* __restrict__ mark_meta, int mark_period,
    int* __restrict__ out, int buf_words) {
  extern __shared__ unsigned smem[];
  block_load_c(ix, smem, false);
  const int* Cs = reinterpret_cast<const int*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  unsigned* buf = smem + warp_buf_start(ix) + warp * buf_words;
  long long r = rows[b];
  int result = -1;
  for (int i = 0; i <= mark_period && r >= 0; ++i) {
    int g;
    if (warp_locate_row<L>(ix, &r, i < mark_period, lane, Cs, buf, &g)) {
      if (lane == 0)
        result = mark_offset(mark_vals, mark_vals_len, mark_meta, g) + i;
      break;
    }
    if (i == mark_period) break;  // no mark within reach: -1
  }
  if (lane == 0) out[b] = result;
}


// The mark bit of row r in a row tier's serving row and, when set, its mark
// rank (the checkpoint + popcounts of the segment's earlier mark words).
__device__ __forceinline__ bool row_mark(const femto::FmView& ix,
                                         const unsigned* row, long long r,
                                         long long s, int* grank) {
  const int wl = static_cast<int>(r - s * ix.seg) >> 5;
  const unsigned* words = row + ix.off_mk;
  const unsigned w = __ldg(words + wl);
  const unsigned bit = static_cast<unsigned>(r & 31);
  if (!((w >> bit) & 1u)) return false;
  int g = static_cast<int>(__ldg(row + ix.off_mck));
  for (int k = 0; k < wl; ++k) g += __popc(__ldg(words + k));
  *grank = g + __popc(w & ((1u << bit) - 1u));
  return true;
}

template <int L>
__global__ void lf_walk_step_kernel(
    femto::FmView ix, const int* __restrict__ rows,
    const int* __restrict__ granks, const int* __restrict__ steps,
    const unsigned char* __restrict__ done, int B, int i,
    int* __restrict__ rows_out, int* __restrict__ granks_out,
    int* __restrict__ steps_out, unsigned char* __restrict__ done_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int r = rows[b], g = granks[b], st = steps[b];
  unsigned char d = done[b];
  if (!d) {
    const long long s = r / ix.seg;
    if (row_mark(ix, femto::row_of(ix, s), r, s, &g)) {
      st = i;
      d = 1;
    } else {
      int c;
      r = static_cast<int>(lf_step<L>(ix, r, &c));
    }
  }
  rows_out[b] = r;
  granks_out[b] = g;
  steps_out[b] = st;
  done_out[b] = d;
}

// lf_walk_step_kernel's lanes, a warp each.  A done lane reads no row (its
// segment may have left the cache) and copies its state; so does a lane
// on a negative row, which no walk reaches.
template <int L>
__global__ void __launch_bounds__(kWarpWalks * 32) lf_walk_step_warp_kernel(
    femto::FmView ix, const int* __restrict__ rows,
    const int* __restrict__ granks, const int* __restrict__ steps,
    const unsigned char* __restrict__ done, int B, int i,
    int* __restrict__ rows_out, int* __restrict__ granks_out,
    int* __restrict__ steps_out, unsigned char* __restrict__ done_out,
    int buf_words) {
  extern __shared__ unsigned smem[];
  block_load_c(ix, smem, false);
  const int* Cs = reinterpret_cast<const int*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  unsigned* buf = smem + warp_buf_start(ix) + warp * buf_words;
  long long r = rows[b];
  int g = granks[b], st = steps[b];
  unsigned char d = done[b];
  if (!d && r >= 0 &&
      warp_locate_row<L>(ix, &r, true, lane, Cs, buf, &g)) {
    st = i;
    d = 1;
  }
  if (lane == 0) {
    rows_out[b] = static_cast<int>(r);
    granks_out[b] = g;
    steps_out[b] = st;
    done_out[b] = d;
  }
}

__global__ void resolve_marks_kernel(const int* __restrict__ granks,
                                     const int* __restrict__ steps, int B,
                                     const unsigned* __restrict__ mark_vals,
                                     long long mark_vals_len,
                                     const int* __restrict__ mark_meta,
                                     int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  out[b] = mark_offset(mark_vals, mark_vals_len, mark_meta, granks[b]) +
           steps[b];
}

}  // namespace

// rows int32[B] -> offsets int32[B] (-1 where no mark was reached).  The
// route by warp_route_smem.
extern "C" int femto_lf_locate(const femto::FmView* ix, const void* rows,
                               int B, const void* mark_bits,
                               const void* mark_ckpt, const void* mark_vals,
                               long long mark_vals_len, const void* mark_meta,
                               int mark_period, void* out, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int buf_words = 0;
  const long long smem = warp_route_smem(*ix, B, false, &buf_words);
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    if constexpr (femto::is_row<L>()) {
      if (smem > 0) {
        launch_warps(lf_locate_warp_kernel<L>, B, smem, st, *ix,
                     static_cast<const int*>(rows), B,
                     static_cast<const unsigned*>(mark_vals), mark_vals_len,
                     static_cast<const int*>(mark_meta), mark_period,
                     static_cast<int*>(out), buf_words);
        return;
      }
    }
    lf_locate_kernel<L><<<(B + 127) / 128, 128, 0, st>>>(
        *ix, static_cast<const int*>(rows), B,
        static_cast<const unsigned*>(mark_bits),
        static_cast<const int*>(mark_ckpt),
        static_cast<const unsigned*>(mark_vals), mark_vals_len,
        static_cast<const int*>(mark_meta), mark_period,
        static_cast<int*>(out));
  });
}

// The route a call of B walks on the view takes (warp_route_smem): the
// warp route's dynamic shared memory a block in bytes, 0 on the thread
// route.  extract: 1 for lf_extract, 0 for lf_locate and lf_walk_step.
extern "C" long long femto_lf_walk_route(const femto::FmView* ix, int B,
                                         int extract) {
  int buf_words = 0;
  return warp_route_smem(*ix, B, extract != 0, &buf_words);
}

// rows int32[B] -> chars int32[B, num_steps], final_rows int32[B].  The
// route by warp_route_smem.
extern "C" int femto_lf_extract(const femto::FmView* ix, const void* rows,
                                int B, int num_steps, void* chars,
                                void* final_rows, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int buf_words = 0;
  const long long smem = warp_route_smem(*ix, B, true, &buf_words);
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    if (smem > 0) {
      launch_warps(lf_extract_warp_kernel<L>, B, smem, st, *ix,
                   static_cast<const int*>(rows), B, num_steps,
                   static_cast<int*>(chars), static_cast<int*>(final_rows),
                   buf_words);
    } else {
      lf_extract_kernel<L><<<(B + 127) / 128, 128, 0, st>>>(
          *ix, static_cast<const int*>(rows), B, num_steps,
          static_cast<int*>(chars), static_cast<int*>(final_rows));
    }
  });
}

// One paged locate step on a row-tier view: (rows, granks, steps int32[B],
// done uint8[B]) and the step number i -> the same four after the step.
// The route by warp_route_smem.
extern "C" int femto_lf_walk_step(const femto::FmView* ix, const void* rows,
                                  const void* granks, const void* steps,
                                  const void* done, int B, int i,
                                  void* rows_out, void* granks_out,
                                  void* steps_out, void* done_out,
                                  void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int buf_words = 0;
  const long long smem = warp_route_smem(*ix, B, false, &buf_words);
  return femto::dispatch_row_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    const int* in[3] = {static_cast<const int*>(rows),
                        static_cast<const int*>(granks),
                        static_cast<const int*>(steps)};
    int* o[3] = {static_cast<int*>(rows_out), static_cast<int*>(granks_out),
                 static_cast<int*>(steps_out)};
    const auto* d = static_cast<const unsigned char*>(done);
    auto* d_out = static_cast<unsigned char*>(done_out);
    if (smem > 0) {
      launch_warps(lf_walk_step_warp_kernel<L>, B, smem, st, *ix, in[0],
                   in[1], in[2], d, B, i, o[0], o[1], o[2], d_out,
                   buf_words);
    } else {
      lf_walk_step_kernel<L><<<(B + 127) / 128, 128, 0, st>>>(
          *ix, in[0], in[1], in[2], d, B, i, o[0], o[1], o[2], d_out);
    }
  });
}

// granks, steps int32[B] -> mark_offset(granks) + steps int32[B].
extern "C" int femto_resolve_marks(const void* granks, const void* steps,
                                   int B, const void* mark_vals,
                                   long long mark_vals_len,
                                   const void* mark_meta, void* out,
                                   void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  resolve_marks_kernel<<<(B + 127) / 128, 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(granks), static_cast<const int*>(steps), B,
      static_cast<const unsigned*>(mark_vals), mark_vals_len,
      static_cast<const int*>(mark_meta), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
