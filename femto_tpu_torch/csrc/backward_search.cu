// Kernel C: batched FM count ranges over the full, compact, packed, vseg
// and vrle layouts (one instantiation each), in three entries:
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
// All four share one device step, fm_step below.
//
// Replaces femto_tpu/ops/search_ops.py backward_search (23) with its step
// ops/rank.py backward_step_pair (681), map_char (97) and _occ_dense (649)
// over ckpt_base (611) and gather_segments (122).  The TPU ran the P steps
// as a lax.scan over B lanes in lockstep, each step gathering whole
// [B, seg] segment rows (unpacking the packed tier's words into a code
// grid); here one thread owns one pattern and runs every step itself,
// skipping the left -1 padding, and reads only the prefix of the segment
// row that the rank needs (packed words are compared field-wise in
// registers, fm_common.cuh count_prefix).  On the row tiers (K11, K12) a
// step maps c to its rank in the segment's symbol list and counts that
// local code in the row's code area (SWAR), its side row, or its
// run-length slots (a clamp-sum that stops at the offset), as
// femto_tpu's _occ_dense_vseg (ops/rank.py 629) does.
//
// Bound on the H100: bytes.  Each step reads, for first and for last, the
// checkpoint (one int, or a uint16 and an L1 int) and the row prefix:
// 2*off bytes on the uint16 layouts, 4*ceil(off/per_word) on the packed
// one (random rows: latency-bound gathers).  The bound counted by
// chip_smoke.py is those bytes summed over this run's steps, plus
// patterns and outputs, over 3.35 TB/s.  One thread per pattern keeps each
// gather's loads in flight back to back; sharing a row between first and
// last when both fall in one segment is left for a later change.
#include "fm_common.cuh"

namespace {

// One FM backward step for alphabet symbol sym over [first, last): the new
// range, (0, 0) for a symbol outside the alphabet or absent from it
// (ops/rank.py backward_step_pair).
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
  *first = base + femto::occ<L>(ix, c, *first);
  *last = base + femto::occ<L>(ix, c, *last);
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

template <bool kMasked>
int launch_step(const femto::FmView* ix, const void* c, const void* first,
                const void* last, int B, void* first_out, void* last_out,
                void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  auto launch = [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    backward_step_kernel<L, kMasked><<<(B + 127) / 128, 128, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        *ix, static_cast<const int*>(c), static_cast<const int*>(first),
        static_cast<const int*>(last), B, static_cast<int*>(first_out),
        static_cast<int*>(last_out));
  };
  if constexpr (kMasked) return femto::dispatch_row_layout(*ix, launch);
  else return femto::dispatch_layout(*ix, launch);
}

template <bool kSteps>
int launch_search(const femto::FmView* ix, const void* pats, int B, int P,
                  int n_rows, int row0, void* first, void* last, void* pf,
                  void* pl, void* matched, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    backward_search_kernel<L, kSteps><<<(B + 127) / 128, 128, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        *ix, static_cast<const int*>(pats), B, P, n_rows, row0,
        static_cast<int*>(first), static_cast<int*>(last),
        static_cast<int*>(pf), static_cast<int*>(pl),
        static_cast<int*>(matched));
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
