// Kernel C: batched FM count ranges over the full, compact, packed, vseg
// and vrle layouts (one instantiation each), in four entries:
//   backward_search        P steps per pattern -> (first, last);
//   backward_search_steps  the same steps, stopping once the range is
//                          empty, with the last non-empty range and the
//                          matched length (femto_tpu/ops/search_ops.py
//                          backward_search_steps, 87);
//   backward_step          one step per lane (c, first, last) -> the new
//                          range (ops/rank.py backward_step_pair, 681, on
//                          free lanes: the host regex engine's layer);
//   backward_step_masked   the same step in its masked mode, where a lane
//                          with c < 0 keeps its range (femto_tpu/paged.py
//                          _pair_step, 64: paged count, one dispatch per
//                          pattern column; row tiers only, through the
//                          view's seg_slot).
//
// Replaces femto_tpu/ops/search_ops.py backward_search (23) with its step
// ops/rank.py backward_step_pair (681), map_char (97) and _occ_dense (649)
// over ckpt_base (611) and gather_segments (122).  The TPU ran the P steps
// as a lax.scan over B lanes in lockstep, each step gathering whole
// [B, seg] segment rows (unpacking the packed tier's words into a code
// grid); here each pattern's steps are its own, skipping the left -1
// padding, and a step reads only the prefix of the segment row that the
// rank needs.  On the row tiers (K11, K12) a step maps c to its rank in
// the segment's symbol list and counts that local code in the row's code
// area (SWAR), its side row, or its run-length slots (a clamp-sum that
// stops at the offset), as femto_tpu's _occ_dense_vseg (ops/rank.py 629)
// does.
//
// Two routes, one rule for the four entries (femto::c_route_smem in
// fm_common.cuh, exposed as femto_backward_search_route): the thread
// route steps a pattern (or a lane) a thread, the warp route a pattern
// (or a lane) a warp, up to femto::c_warp_max patterns or lanes a call
// (a limit by entry kind, seg and the index's alphabet, from
// chip_c_routes.py's sweep).
// On both, a step whose first and last lie in one segment reads that
// segment once: one checkpoint of c and one pass over its prefix up to
// the larger offset, counted at both (occ(c, last) = occ(c, first) + the
// count of c between the offsets).  The thread route reads the prefix as
// femto::occ does, the pass's loads back to back in one thread, and on
// the row tiers maps c through the row's list by a binary search and
// scans the code area a field at a time or walks a run-length segment's
// slots a load after the last.  The warp route (femto::warp_count_step)
// issues both ends' loads at once -- c's checkpoint entries and the
// prefix, into the lanes' registers on full, compact and packed and by
// cp.async into the warp's shared memory on vseg and vrle, with the
// symbol list -- and waits once, then maps c by a warp count over the
// list and counts SWAR a word a lane or the run lengths by warp scans:
// one dependent DRAM round trip a step for both ranks, two on a side
// segment or a continued run-length segment.  A pattern's columns are
// loaded by its warp once, 32 a load; C and alpha_map sit in shared
// memory.  The masked entry's c < 0 lanes keep their range and read no
// row; every row-tier row is read through row_of (seg_slot), so paged
// caches work unchanged.
//
// Bound on the H100: bytes.  Each step reads, for first and for last, the
// checkpoint of c (one int, or a uint16 and an L1 int) and the row prefix
// -- once for both where they share a segment, up to the larger offset:
// 2*off bytes on the uint16 layouts, 4*ceil(off/per_word) on the packed
// one, the code words up to off and a symbol-list word on the row tiers
// (random rows: latency-bound gathers).  chip_smoke.py's bound sums those
// bytes over this run's steps, plus patterns and outputs, over 3.35
// TB/s, beside the bound of the design before (each end's row read apart).
#include "fm_common.cuh"

namespace {

using femto::kWarpWalks;

// One FM backward step for alphabet symbol sym over [first, last): the new
// range, (0, 0) for a symbol outside the alphabet or absent from it
// (ops/rank.py backward_step_pair).  Every lane runs the same two counts,
// so a warp of patterns whose ends do and do not share a segment does not
// diverge: the end at the lower offset over [0, its offset), then the
// other over [0, its offset) or, where both lie in one segment, over
// [the first's offset, its own) added to the first's count -- that
// segment's checkpoint read once and its prefix once.
template <int L>
__device__ __forceinline__ void fm_step(const femto::FmView& ix, int sym,
                                        int* first, int* last) {
  const int c = femto::map_char(ix, sym);
  if (c < 0) {
    *first = 0;
    *last = 0;
    return;
  }
  const int base = __ldg(ix.C + c);
  const int rf = *first, rl = *last;
  const long long end = ix.n_seg * ix.seg;
  const bool in_f = rf < end, in_l = rl < end;
  // rows lie below 2^31: 32-bit divisions, once each
  const unsigned seg = static_cast<unsigned>(ix.seg);
  const unsigned sf = static_cast<unsigned>(rf) / seg;
  const unsigned sl = static_cast<unsigned>(rl) / seg;
  const int of = static_cast<int>(static_cast<unsigned>(rf) - sf * seg);
  const int ol = static_cast<int>(static_cast<unsigned>(rl) - sl * seg);
  const bool shared = in_f && in_l && sf == sl;
  const bool swap = shared && of > ol;  // then the ends' offsets trade
  const int oa = swap ? ol : of, ob = swap ? of : ol;
  // an end at or past the segments' end counts every occurrence (occ)
  const int total = __ldg(ix.C + c + 1) - base;
  int ca = total, cb = total;
  if (in_f)
    ca = femto::ckpt_base<L>(ix, sf, c) +
         femto::count_range<L>(ix, sf, 0, oa, c);
  if (in_l)
    cb = (shared ? ca : femto::ckpt_base<L>(ix, sl, c)) +
         femto::count_range<L>(ix, sl, shared ? oa : 0, ob, c);
  *first = base + (swap ? cb : ca);
  *last = base + (swap ? ca : cb);
}

// kSteps false: femto_tpu's backward_search, every column but the left -1
// padding steps.  kSteps true: backward_search_steps, a column steps only
// while the range is non-empty, and prev_first / prev_last / matched
// follow the last step that left it non-empty.
template <int L, bool kSteps>
__global__ void backward_search_kernel(femto::FmView ix,
                                       const int* __restrict__ pats, int B,
                                       int P, int n_rows, int row0,
                                       int* __restrict__ first_out,
                                       int* __restrict__ last_out,
                                       int* __restrict__ pf_out,
                                       int* __restrict__ pl_out,
                                       int* __restrict__ matched_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* p = pats + static_cast<long long>(b) * P;
  int first = row0, last = n_rows;
  int pf = row0, pl = n_rows, matched = 0;
  for (int j = P - 1; j >= 0; --j) {
    const int sym = p[j];
    if (sym < 0) continue;  // left padding of a right-aligned pattern
    if (kSteps && last <= first) break;  // empty stays as it is
    fm_step<L>(ix, sym, &first, &last);
    if (kSteps && last > first) {
      pf = first;
      pl = last;
      ++matched;
    }
  }
  first_out[b] = first;
  last_out[b] = last;
  if (kSteps) {
    pf_out[b] = pf;
    pl_out[b] = pl;
    matched_out[b] = matched;
  }
}

// One thread per lane; the host engine pads its layers with c = -1 lanes.
// kMasked: a lane with c < 0 keeps (first, last) instead of stepping to
// the empty range.
template <int L, bool kMasked>
__global__ void backward_step_kernel(femto::FmView ix,
                                     const int* __restrict__ cs,
                                     const int* __restrict__ firsts,
                                     const int* __restrict__ lasts, int B,
                                     int* __restrict__ first_out,
                                     int* __restrict__ last_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int first = firsts[b], last = lasts[b];
  const int c = cs[b];
  if (!kMasked || c >= 0) fm_step<L>(ix, c, &first, &last);
  first_out[b] = first;
  last_out[b] = last;
}

// ---- the warp route: a warp a pattern or lane ----

// C and, where the index is remapped, alpha_map into the block's shared
// memory (femto::c_smem_start words), by the whole block.
__device__ __forceinline__ void block_load_tables(const femto::FmView& ix,
                                                  int* smem) {
  for (int i = threadIdx.x; i <= ix.K; i += blockDim.x)
    smem[i] = __ldg(ix.C + i);
  if (ix.alpha_map != nullptr)
    for (int i = threadIdx.x; i < femto::kAlpha; i += blockDim.x)
      smem[ix.K + 1 + i] = __ldg(ix.alpha_map + i);
  __syncthreads();
}

// fm_step by the whole warp: femto::map_char from shared memory, then
// femto::warp_count_step.
template <int L>
__device__ __forceinline__ void warp_fm_step(const femto::FmView& ix,
                                             int sym, int lane,
                                             const int* tables,
                                             unsigned* buf, int buf_words,
                                             int* first, int* last) {
  int c = -1;
  if (sym >= 0 && sym < femto::kAlpha)
    c = ix.alpha_map != nullptr ? tables[ix.K + 1 + sym] : sym;
  if (c < 0) {
    *first = 0;
    *last = 0;
    return;
  }
  femto::warp_count_step<L>(ix, c, lane, tables, buf, buf + buf_words,
                            first, last);
}

// backward_search_kernel's patterns, a warp each (blockDim.x / 32 a
// block): lane t holds column j0 - t of each 32-column chunk, right to
// left, and the warp steps them in turn.
template <int L, bool kSteps>
__global__ void __launch_bounds__(kWarpWalks * 32) backward_search_warp_kernel(
    femto::FmView ix, const int* __restrict__ pats, int B, int P,
    int n_rows, int row0, int* __restrict__ first_out,
    int* __restrict__ last_out, int* __restrict__ pf_out,
    int* __restrict__ pl_out, int* __restrict__ matched_out, int buf_words) {
  extern __shared__ unsigned smem[];
  int* tables = reinterpret_cast<int*>(smem);
  block_load_tables(ix, tables);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  unsigned* buf = smem + femto::c_smem_start(ix) + warp * 2 * buf_words;
  const int* p = pats + static_cast<long long>(b) * P;
  int first = row0, last = n_rows;
  int pf = row0, pl = n_rows, matched = 0;
  bool stop = false;
  for (int j0 = P - 1; j0 >= 0 && !stop; j0 -= 32) {
    const int mine = j0 - lane >= 0 ? __ldg(p + j0 - lane) : -1;
    const int nj = j0 + 1 < 32 ? j0 + 1 : 32;
    for (int t = 0; t < nj; ++t) {
      const int sym = __shfl_sync(femto::kAllLanes, mine, t);
      if (sym < 0) continue;  // left padding of a right-aligned pattern
      if (kSteps && last <= first) {  // empty stays as it is
        stop = true;
        break;
      }
      warp_fm_step<L>(ix, sym, lane, tables, buf, buf_words, &first, &last);
      if (kSteps && last > first) {
        pf = first;
        pl = last;
        ++matched;
      }
    }
  }
  if (lane == 0) {
    first_out[b] = first;
    last_out[b] = last;
    if (kSteps) {
      pf_out[b] = pf;
      pl_out[b] = pl;
      matched_out[b] = matched;
    }
  }
}

// backward_step_kernel's lanes, a warp each; a masked lane with c < 0
// reads no row.  The bound's one block an SM lets ptxas keep every value
// of the full and compact instances in registers (chip_smoke.py fails a
// build whose C kernels use local memory).
template <int L, bool kMasked>
__global__ void __launch_bounds__(kWarpWalks * 32, 1) backward_step_warp_kernel(
    femto::FmView ix, const int* __restrict__ cs,
    const int* __restrict__ firsts, const int* __restrict__ lasts, int B,
    int* __restrict__ first_out, int* __restrict__ last_out, int buf_words) {
  extern __shared__ unsigned smem[];
  int* tables = reinterpret_cast<int*>(smem);
  block_load_tables(ix, tables);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  unsigned* buf = smem + femto::c_smem_start(ix) + warp * 2 * buf_words;
  int first = __ldg(firsts + b), last = __ldg(lasts + b);
  const int c = __ldg(cs + b);
  if (!kMasked || c >= 0)
    warp_fm_step<L>(ix, c, lane, tables, buf, buf_words, &first, &last);
  if (lane == 0) {
    first_out[b] = first;
    last_out[b] = last;
  }
}

template <bool kMasked>
int launch_step(const femto::FmView* ix, const void* c, const void* first,
                const void* last, int B, void* first_out, void* last_out,
                void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int buf_words;
  const long long smem = femto::c_route_smem(*ix, B, true, &buf_words);
  auto launch = [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    const int* cs = static_cast<const int*>(c);
    const int* fs = static_cast<const int*>(first);
    const int* ls = static_cast<const int*>(last);
    int* fo = static_cast<int*>(first_out);
    int* lo = static_cast<int*>(last_out);
    if (smem > 0)
      femto::launch_warps(backward_step_warp_kernel<L, kMasked>, B, smem, st,
                          *ix, cs, fs, ls, B, fo, lo, buf_words);
    else
      backward_step_kernel<L, kMasked><<<(B + 127) / 128, 128, 0, st>>>(
          *ix, cs, fs, ls, B, fo, lo);
  };
  if constexpr (kMasked) return femto::dispatch_row_layout(*ix, launch);
  else return femto::dispatch_layout(*ix, launch);
}

template <bool kSteps>
int launch_search(const femto::FmView* ix, const void* pats, int B, int P,
                  int n_rows, int row0, void* first, void* last, void* pf,
                  void* pl, void* matched, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int buf_words;
  const long long smem = femto::c_route_smem(*ix, B, false, &buf_words);
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    const int* p = static_cast<const int*>(pats);
    int* f = static_cast<int*>(first);
    int* l = static_cast<int*>(last);
    int* pfo = static_cast<int*>(pf);
    int* plo = static_cast<int*>(pl);
    int* mo = static_cast<int*>(matched);
    if (smem > 0)
      femto::launch_warps(backward_search_warp_kernel<L, kSteps>, B, smem, st,
                          *ix, p, B, P, n_rows, row0, f, l, pfo, plo, mo,
                          buf_words);
    else
      backward_search_kernel<L, kSteps><<<(B + 127) / 128, 128, 0, st>>>(
          *ix, p, B, P, n_rows, row0, f, l, pfo, plo, mo);
  });
}

}  // namespace

// pats int32[B, P] right-aligned, -1 padded -> first, last int32[B].
extern "C" int femto_backward_search(const femto::FmView* ix, const void* pats,
                                     int B, int P, int n_rows, int row0,
                                     void* first, void* last, void* stream) {
  return launch_search<false>(ix, pats, B, P, n_rows, row0, first, last,
                              nullptr, nullptr, nullptr, stream);
}

// pats as above -> first, last, prev_first, prev_last, matched int32[B].
extern "C" int femto_backward_search_steps(const femto::FmView* ix,
                                           const void* pats, int B, int P,
                                           int n_rows, int row0, void* first,
                                           void* last, void* prev_first,
                                           void* prev_last, void* matched,
                                           void* stream) {
  return launch_search<true>(ix, pats, B, P, n_rows, row0, first, last,
                             prev_first, prev_last, matched, stream);
}

// c, first, last int32[B] -> the stepped first, last int32[B].
extern "C" int femto_backward_step(const femto::FmView* ix, const void* c,
                                   const void* first, const void* last, int B,
                                   void* first_out, void* last_out,
                                   void* stream) {
  return launch_step<false>(ix, c, first, last, B, first_out, last_out,
                            stream);
}

// The same on a row-tier view, lanes with c < 0 keeping their range.
extern "C" int femto_backward_step_masked(const femto::FmView* ix,
                                          const void* c, const void* first,
                                          const void* last, int B,
                                          void* first_out, void* last_out,
                                          void* stream) {
  return launch_step<true>(ix, c, first, last, B, first_out, last_out,
                           stream);
}

// The route a call of B patterns (backward_search, backward_search_steps;
// one_step 0) or lanes (backward_step, backward_step_masked; one_step 1)
// on the view takes (femto::c_route_smem): the warp route's dynamic
// shared memory a block in bytes, 0 on the thread route.
extern "C" long long femto_backward_search_route(const femto::FmView* ix,
                                                 int B, int one_step) {
  int buf_words;
  return femto::c_route_smem(*ix, B, one_step != 0, &buf_words);
}
