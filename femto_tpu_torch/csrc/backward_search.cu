// Kernel C, backward_search: batched FM count ranges over the full,
// compact, packed, vseg and vrle layouts (one instantiation each).
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

template <int L>
__global__ void backward_search_kernel(femto::FmView ix,
                                       const int* __restrict__ pats, int B,
                                       int P, int n_rows, int row0,
                                       int* __restrict__ first_out,
                                       int* __restrict__ last_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* p = pats + static_cast<long long>(b) * P;
  int first = row0, last = n_rows;
  for (int j = P - 1; j >= 0; --j) {
    const int sym = p[j];
    if (sym < 0) continue;  // left padding of a right-aligned pattern
    const int c = femto::map_char(ix, sym);
    if (c < 0) {  // outside the alphabet or absent: empty range
      first = 0;
      last = 0;
      continue;
    }
    const int base = __ldg(ix.C + c);
    first = base + femto::occ<L>(ix, c, first);
    last = base + femto::occ<L>(ix, c, last);
  }
  first_out[b] = first;
  last_out[b] = last;
}

}  // namespace

// pats int32[B, P] right-aligned, -1 padded -> first, last int32[B].
extern "C" int femto_backward_search(const femto::FmView* ix, const void* pats,
                                     int B, int P, int n_rows, int row0,
                                     void* first, void* last, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    backward_search_kernel<L><<<(B + 127) / 128, 128, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        *ix, static_cast<const int*>(pats), B, P, n_rows, row0,
        static_cast<int*>(first), static_cast<int*>(last));
  });
}
