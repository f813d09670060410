// Kernel T, paged serving's cache update (femto_tpu_torch/paged.py, K16).
//
// apply_faults replaces femto_tpu/paged.py _apply_faults (53): write the m
// rows fetched from the host, uint32[m, W], into their cache slots of the
// row cache uint32[cache_rows, W]; clear the map entries of the k evicted
// segments, slot_map[evict] = 0; map the fetched segments, slot_map[segs]
// = slots.  Entries out of range drop, as the JAX scatters' mode="drop"
// does.  The evicted and the newly mapped segments are disjoint (a segment
// faults in only while it maps to 0, and only a mapped segment has a slot
// to lose), so the two map writes need no order and one launch does both.
// The update is in place: the cache and the map are the index's own.
//
// Bound on the H100: bytes, the rows read once and written once
// (8 m W bytes) plus the slots, segments and map entries (at most 20 m
// bytes).  One thread per row word, neighbouring threads on neighbouring
// words of a row: the reads are contiguous and every row's writes too.
#include "fm_common.cuh"

namespace {

__global__ void apply_faults_kernel(unsigned* __restrict__ cache,
                                    long long cache_rows, int W,
                                    int* __restrict__ slot_map,
                                    long long n_seg,
                                    const int* __restrict__ slots,
                                    const unsigned* __restrict__ rows,
                                    const int* __restrict__ evict, int k,
                                    const int* __restrict__ segs, int m) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long words = static_cast<long long>(m) * W;
  if (t < words) {
    const long long i = t / W;
    const int slot = __ldg(slots + i);
    if (slot >= 0 && slot < cache_rows)
      cache[static_cast<long long>(slot) * W + (t - i * W)] = __ldg(rows + t);
  }
  if (t < k) {
    const int e = __ldg(evict + t);
    if (e >= 0 && e < n_seg) slot_map[e] = 0;
  }
  if (t < m) {
    const int s = __ldg(segs + t);
    if (s >= 0 && s < n_seg) slot_map[s] = __ldg(slots + t);
  }
}

}  // namespace

// cache uint32[cache_rows, W], slot_map int32[n_seg] (both updated in
// place); slots int32[m], rows uint32[m, W], evict int32[k], segs int32[m].
extern "C" int femto_apply_faults(void* cache, long long cache_rows, int W,
                                  void* slot_map, long long n_seg,
                                  const void* slots, const void* rows,
                                  const void* evict, const void* segs, int m,
                                  int k, void* stream) {
  if (W <= 0 || k > m) return static_cast<int>(cudaErrorInvalidValue);
  const long long words = static_cast<long long>(m) * W;
  if (words <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (words + 255) / 256;
  apply_faults_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(cache), cache_rows, W,
      static_cast<int*>(slot_map), n_seg, static_cast<const int*>(slots),
      static_cast<const unsigned*>(rows), static_cast<const int*>(evict), k,
      static_cast<const int*>(segs), m);
  return static_cast<int>(cudaGetLastError());
}
