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
// whole [B, seg] rows per step; here each thread walks its own row and
// stops at its own mark, so there is no lockstep tail (the reason
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
// view's seg_slot).  A done lane is left as it is; a marked lane takes its
// mark rank and the step number i; any other lane steps LF.
// resolve_marks replaces paged.py _resolve_marks (86): mark_offset(g) +
// steps per lane, after the walk.  Both are one thread per lane; their
// bound is the bytes of one row prefix per live lane (lf_walk_step) and of
// the lane arrays and two or three mark_vals words a lane (resolve_marks).
//
// extract has two routes, chosen inside femto_lf_extract by B and the
// layout (femto_lf_extract_route).  The thread route walks a row per
// thread with lf_step below: on the row tiers every step walks the
// segment's slots or fields twice (code, then count) through dependent
// loads, on the other layouts it reads the code, then its checkpoint,
// then the counted prefix.  The warp route (lf_extract_warp_kernel) walks
// a row per warp: each step first issues every load that depends only on
// the row -- the symbol or word at the offset, the counted prefix (16-B
// chunks or words, the lanes taking every 32nd), the segment's whole
// checkpoint row (full: K ints; compact, packed: K uint16 and the L1
// row; row tiers: the L1 row in registers and the row's code area,
// symbol list and relative checkpoints copied to shared memory by
// cp.async) -- then decodes and counts from registers and shared memory
// (SWAR per lane, warp scans of run lengths, a warp sum), picks the
// checkpoint by a shuffle, and takes C[c] and alpha_rev from shared
// memory: one dependent DRAM round trip a step, two on a side segment
// (its side row) or a continued run-length segment (its granules), whose
// addresses come from seg_woff.  A large batch on full, compact or
// packed keeps the thread route, which moves fewer bytes a step.
//
// Bound on the H100: bytes of dependent random gathers.  Per step: one
// mark word, one symbol (word), the checkpoint and the counted row prefix;
// per hit the segment's mark words, one mark_ckpt int and two or three
// mark_vals words.  chip_smoke.py sums those over this run's steps and
// divides by 3.35 TB/s; the walk itself is a chain of dependent loads, so
// latency, not bandwidth, is what this kernel meets.
#include "fm_common.cuh"

namespace {

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
           femto::row_within<L>(ix, row, s, woff, lc, off);
  }
  const int c = femto::code_at<L>(ix, s, off);
  *code = c;
  if (c >= ix.K) return -1;
  return static_cast<long long>(__ldg(ix.C + c)) +
         femto::ckpt_base<L>(ix, s, c) + femto::count_prefix<L>(ix, s, off, c);
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

// walks (warps) a block on the warp route
constexpr int kWarpWalks = 4;
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

// Words of the warp route's shared-memory stream area on a row tier: the
// code area with its continuation granules (vrle) or a side row, the
// larger.
__host__ __device__ __forceinline__ int row_stream_words(
    const femto::FmView& ix) {
  const int code = ix.code_words + (ix.layout == femto::kVrle
                                        ? ix.ngr * ix.G : 0);
  return code > ix.side_words ? code : ix.side_words;
}

// One LF step from row r on vseg or vrle, by the whole warp; buf: the
// warp's shared memory (the stream area, then the symbol list, then the
// relative checkpoints).  The count is of the row's own (local) code, as
// lf_step's.
template <int L>
__device__ __forceinline__ long long warp_step_row(const femto::FmView& ix,
                                                   long long r, int lane,
                                                   const int* Cs,
                                                   unsigned* buf,
                                                   int* code) {
  // rows lie below 2^31: a 32-bit division, 64-bit offsets after it
  const unsigned su =
      static_cast<unsigned>(r) / static_cast<unsigned>(ix.seg);
  const int off = static_cast<int>(static_cast<unsigned>(r) -
                                   su * static_cast<unsigned>(ix.seg));
  const long long s = su;
  const int wsym = ix.off_mk - ix.off_syms;
  unsigned* syms = buf + row_stream_words(ix);
  unsigned* rel = syms + wsym;
  __syncwarp();  // the last step's reads of buf are done
  const unsigned* row = femto::row_of(ix, s);
  const int woff = __ldg(ix.seg_woff + s);
  int nsym = 0;
  if constexpr (L == femto::kVrle) nsym = __ldg(ix.seg_nsym + s);
  int l1[femto::kRowRegs];
  femto::warp_row_regs(ix.occ_l1 + (s / ix.grp) * ix.K, ix.K, lane, l1);
  // vrle: the whole code area (a run-length segment is read by a walk
  // over its slots); vseg: the prefix up to off's word
  const int ncode = L == femto::kVrle ? ix.code_words
                                      : off / (32 / ix.w_main) + 1;
  femto::warp_copy_words(buf, row, ncode, lane);
  femto::warp_copy_words(syms, row + ix.off_syms, wsym, lane);
  femto::warp_copy_words(rel, row + ix.off_rel, ix.row_words - ix.off_rel,
                         lane);
  femto::cp_async_wait_warp();
  int lc, cnt;
  if (woff > 0) {
    // a side segment: its global codes in the side table
    femto::warp_copy_words(buf, femto::side_of(ix, woff),
                           off / (32 / ix.w_side) + 1, lane);
    femto::cp_async_wait_warp();
    lc = femto::smem_field(buf, ix.w_side, off);
    cnt = femto::warp_swar_count(buf, ix.w_side, lc, off, lane);
  } else if (L == femto::kVrle && woff < 0) {
    // a run-length segment; continued (woff < -1): its ngr granule rows
    // after the code area, read as SlotStream reads them.  A segment
    // without a continuation holds its whole stream in the code area, so
    // its walk stops there.
    int nwords = ix.code_words;
    if (woff < -1 && ix.ngr > 0) {
      const long long g0 = static_cast<long long>(-woff - 2) / ix.G;
      const long long g = min(g0, ix.X - 1);
      const int total = ix.ngr * ix.G;
      for (int t = lane; t < total; t += 32) {
        const int i = t / ix.G;
        femto::cp_async4(buf + ix.code_words + t,
                         ix.seg_cont + min(g + i, ix.X - 1) * ix.G +
                             (t - i * ix.G));
      }
      femto::cp_async_wait_warp();
      nwords += total;
    }
    femto::warp_slots(buf, nwords, nsym, off, lane, &lc, &cnt);
  } else {
    lc = femto::smem_field(buf, ix.w_main, off);
    cnt = femto::warp_swar_count(buf, ix.w_main, lc, off, lane);
  }
  int c = lc;
  if (woff <= 0) {
    const int k = min(max(lc, 0), ix.S - 1);
    c = ix.wide ? static_cast<int>((syms[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu)
                : static_cast<int>((syms[k >> 2] >> ((k & 3) * 8)) & 0xFFu);
  }
  *code = c;
  if (c >= ix.K) return -1;
  const unsigned w = rel[c >> 1];
  return static_cast<long long>(Cs[c]) + femto::warp_pick(l1, c) +
         static_cast<int>((w >> ((c & 1) * 16)) & 0xFFFFu) + cnt;
}

// lf_extract_kernel's walks, a warp each (blockDim.x / 32 walks a block).
// Dynamic shared memory: C (K + 1 ints) and alpha_rev (K ints, when the
// index is remapped), then buf_words words a warp (row tiers).
template <int L>
__global__ void __launch_bounds__(kWarpWalks * 32) lf_extract_warp_kernel(
    femto::FmView ix, const int* __restrict__ rows, int B, int num_steps,
    int* __restrict__ chars, int* __restrict__ final_rows, int buf_words) {
  extern __shared__ unsigned smem[];
  int* Cs = reinterpret_cast<int*>(smem);
  int* rev = Cs + ix.K + 1;
  const bool remapped = ix.alpha_rev != nullptr;
  for (int i = threadIdx.x; i <= ix.K; i += blockDim.x) Cs[i] = __ldg(ix.C + i);
  if (remapped)
    for (int i = threadIdx.x; i < ix.K; i += blockDim.x)
      rev[i] = __ldg(ix.alpha_rev + i);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  unsigned* buf = smem + 2 * ix.K + 1 + warp * buf_words;
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

// The largest batch that takes the warp route, by layout.  Builds with
// -DFEMTO_D_WARP_MAX=0 (every call a thread a walk) or 0x7fffffff (every
// call a warp a walk) let chip_smoke.py hold each route against the other.
#ifndef FEMTO_D_WARP_MAX
#define FEMTO_D_WARP_MAX -1
#endif
// chip_d_routes.py (H100): on full, compact and packed the thread route
// draws level at 8192 walks of 32 steps and leads from 16384 (it moves a
// row prefix a step, the warp route a checkpoint row and the prefix in
// whole chunks); on vseg and vrle the warp route leads at every B
// measured, up to 2^20 walks of 32 steps or of one, so there only the
// shared-memory check below limits it.
constexpr int kWarpMaxFixed = 8192;

int warp_route_max(int layout) {
  if (FEMTO_D_WARP_MAX >= 0) return FEMTO_D_WARP_MAX;
  return layout == femto::kVseg || layout == femto::kVrle ? 0x7fffffff
                                                          : kWarpMaxFixed;
}

// Dynamic shared memory of a warp-route block of `walks` warps, in words,
// and each warp's share (0 on full, compact and packed).
int warp_smem_words(const femto::FmView& ix, int walks, int* buf_words) {
  const bool row = ix.layout == femto::kVseg || ix.layout == femto::kVrle;
  *buf_words = row ? row_stream_words(ix) + (ix.off_mk - ix.off_syms) +
                         (ix.row_words - ix.off_rel)
                   : 0;
  return 2 * ix.K + 1 + walks * *buf_words;
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

// rows int32[B] -> offsets int32[B] (-1 where no mark was reached).
extern "C" int femto_lf_locate(const femto::FmView* ix, const void* rows,
                               int B, const void* mark_bits,
                               const void* mark_ckpt, const void* mark_vals,
                               long long mark_vals_len, const void* mark_meta,
                               int mark_period, void* out, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    lf_locate_kernel<L><<<(B + 127) / 128, 128, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        *ix, static_cast<const int*>(rows), B,
        static_cast<const unsigned*>(mark_bits),
        static_cast<const int*>(mark_ckpt),
        static_cast<const unsigned*>(mark_vals), mark_vals_len,
        static_cast<const int*>(mark_meta), mark_period,
        static_cast<int*>(out));
  });
}

// 1 where a call of B walks on `layout` takes the warp route, else 0.
extern "C" long long femto_lf_extract_route(int B, int layout) {
  return B <= warp_route_max(layout) ? 1 : 0;
}

// rows int32[B] -> chars int32[B, num_steps], final_rows int32[B].  The
// route by B and the layout (femto_lf_extract_route); the thread route
// also where a checkpoint row does not fit the warp's registers or a
// block's shared memory would not fit an SM.
extern "C" int femto_lf_extract(const femto::FmView* ix, const void* rows,
                                int B, int num_steps, void* chars,
                                void* final_rows, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int walks = B < kWarpWalks ? B : kWarpWalks;
  int buf_words = 0;
  const long long smem_bytes =
      4ll * warp_smem_words(*ix, walks, &buf_words);
  const bool warp = B <= warp_route_max(ix->layout) &&
                    ix->K <= 32 * femto::kRowRegs &&
                    smem_bytes <= 227 * 1024;
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    if (warp) {
      if (smem_bytes > 48 * 1024)
        cudaFuncSetAttribute(lf_extract_warp_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
      lf_extract_warp_kernel<L><<<(B + walks - 1) / walks, walks * 32,
                                  static_cast<size_t>(smem_bytes), st>>>(
          *ix, static_cast<const int*>(rows), B, num_steps,
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
extern "C" int femto_lf_walk_step(const femto::FmView* ix, const void* rows,
                                  const void* granks, const void* steps,
                                  const void* done, int B, int i,
                                  void* rows_out, void* granks_out,
                                  void* steps_out, void* done_out,
                                  void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return femto::dispatch_row_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    lf_walk_step_kernel<L><<<(B + 127) / 128, 128, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        *ix, static_cast<const int*>(rows), static_cast<const int*>(granks),
        static_cast<const int*>(steps),
        static_cast<const unsigned char*>(done), B, i,
        static_cast<int*>(rows_out), static_cast<int*>(granks_out),
        static_cast<int*>(steps_out), static_cast<unsigned char*>(done_out));
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
