// Kernel C, backward_search: batched FM count ranges, full tier.
//
// Replaces femto_tpu/ops/search_ops.py backward_search (23) with its step
// ops/rank.py backward_step_pair (681) and _occ_dense (649).  The TPU ran
// the P steps as a lax.scan over B lanes in lockstep, each step gathering
// whole [B, seg] segment rows; here one thread owns one pattern and runs
// every step itself, skipping the left -1 padding, and reads only the
// prefix of the segment row that the rank needs.
//
// Bound on the H100: bytes.  Each step reads, for first and for last, one
// checkpoint int and the first `off` symbols of one segment row (random
// rows: latency-bound gathers).  The bound counted by chip_smoke.py is
// those bytes summed over this run's steps, plus patterns and outputs,
// over 3.35 TB/s.  One thread per pattern keeps each gather's 16-byte
// loads in flight back to back; sharing a row between first and last
// when both fall in one segment is left for a later change.
#include "fm_common.cuh"

namespace {

__global__ void backward_search_kernel(const int* __restrict__ pats, int B,
                                       int P, const uint16_t* __restrict__ bwt,
                                       const int* __restrict__ occ_ckpt,
                                       const int* __restrict__ C,
                                       long long n_seg, int seg, int n_rows,
                                       int row0, int* __restrict__ first_out,
                                       int* __restrict__ last_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* p = pats + static_cast<long long>(b) * P;
  int first = row0, last = n_rows;
  for (int j = P - 1; j >= 0; --j) {
    const int c = p[j];
    if (c < 0) continue;  // left padding of a right-aligned pattern
    if (c >= femto::kAlpha) {  // outside the alphabet: empty range
      first = 0;
      last = 0;
      continue;
    }
    const int base = __ldg(C + c);
    first = base + femto::occ_full(bwt, occ_ckpt, C, n_seg, seg, c, first);
    last = base + femto::occ_full(bwt, occ_ckpt, C, n_seg, seg, c, last);
  }
  first_out[b] = first;
  last_out[b] = last;
}

}  // namespace

// pats int32[B, P] right-aligned, -1 padded -> first, last int32[B].
extern "C" int femto_backward_search(const void* pats, int B, int P,
                                     const void* bwt, const void* occ_ckpt,
                                     const void* C, long long n_seg, int seg,
                                     int n_rows, int row0, void* first,
                                     void* last, void* stream) {
  if (B > 0) {
    backward_search_kernel<<<(B + 127) / 128, 128, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pats), B, P,
        static_cast<const uint16_t*>(bwt), static_cast<const int*>(occ_ckpt),
        static_cast<const int*>(C), n_seg, seg, n_rows, row0,
        static_cast<int*>(first), static_cast<int*>(last));
  }
  return static_cast<int>(cudaGetLastError());
}
