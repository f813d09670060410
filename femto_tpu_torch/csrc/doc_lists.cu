// Kernel P, doc_lists and flatten_ragged: the per-segment document lists
// (K14), the sorted unique doc ids of every segment's rows, laid out as one
// ragged array.
//
// Replaces (femto_tpu/ops/build_ops.py): _doc_lists_stage (834),
// _flatten_ragged (863) and the device half of build_doc_lists_device
// (873).  The reference runs one searchsorted over all n rows, one XLA row
// sort of the [n_seg, seg] tile, a cumsum for the unique ranks and a
// scatter.  Here one block takes one segment end to end:
//   1. each row r finds its document by a bisect of doc_starts (the last
//      entry <= sa[r], i.e. searchsorted side="right" minus 1); rows with
//      sa[r] >= n_real (the pad rows of a shape-padded build) and the rows
//      past n_rows hold kBig, which sorts last and is dropped;
//   2. a bitonic sort of the segment, padded with kBig to a power of two
//      P2, in shared memory while P2 <= kSharedInts, else in the block's
//      own row of a global scratch buffer (seg reaches 65504, the largest
//      segment l1_group_for accepts: 256 KiB of ints, more than the 227 KB
//      a block may have); __syncthreads orders the global row too;
//   3. rounds of blockDim elements flag the first of each run of equal
//      values, a block scan ranks the flags, and the flagged values are
//      written left-compacted; the rest of the row gets -1 and the count
//      goes to counts[s].  In the global path the compaction runs in place
//      (a value is written at or before its own position, and a round's
//      reads finish before its writes).
// The host sums the counts into offsets (as the reference does), and
// flatten_ragged copies row s's first counts[s] ids to docs[offsets[s]..].
//
// Bound on the H100 (3.35 TB/s): bytes.  doc_lists reads sa (4 n_rows) and
// writes the rows (4 n_seg seg) and counts (4 n_seg); flatten_ragged reads
// the counts and offsets and copies 4 total bytes twice.  The bisect's
// reads of doc_starts stay in cache.  The sort is log2(P2)^2 / 2 passes
// over shared memory; the global-row path (seg > 8192 only) pays them in
// L2.
#include "fm_common.cuh"

namespace {

constexpr int kBig = 0x7fffffff;   // no document: sorts last, dropped
constexpr int kSharedInts = 8192;  // rows sorted in shared memory (32 KiB)
constexpr int kMaxThreads = 1024;

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 32;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ constexpr int block_threads(int p2) {
  return p2 / 2 < 32 ? 32 : (p2 / 2 > kMaxThreads ? kMaxThreads : p2 / 2);
}

// Exclusive block scan of one flag per thread; *total gets the sum.  Every
// thread of the block calls it; it starts and ends with a barrier.
__device__ int block_scan(int f, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = f;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;  // inclusive sums of the warps
    if (lane == nw - 1) *total = w;
  }
  __syncthreads();
  return x - f + (warp ? warp_sums[warp - 1] : 0);
}

__device__ int doc_of(const int* __restrict__ sa,
                      const int* __restrict__ doc_starts, int n_starts,
                      long long n_rows, long long n_real, long long g) {
  if (g >= n_rows) return kBig;
  const long long v = sa[g];
  if (v < 0 || v >= n_real) return kBig;
  int lo = 0, hi = n_starts;  // the first entry > v
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(doc_starts + mid) <= v) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// One block per segment; `row` is the segment's sort buffer (shared memory
// or its global scratch row of P2 ints), `out` its output row.
__global__ void doc_lists_kernel(const int* __restrict__ sa, long long n_rows,
                                 long long n_real,
                                 const int* __restrict__ doc_starts,
                                 int n_starts, int seg, int p2,
                                 int* vals, int stride,
                                 int* __restrict__ counts) {
  extern __shared__ int sh[];
  __shared__ int warp_sums[32];
  __shared__ int total;
  const long long s = blockIdx.x;
  int* out = vals + s * stride;
  int* row = p2 <= kSharedInts ? sh : out;
  for (int i = threadIdx.x; i < p2; i += blockDim.x)
    row[i] = i < seg ? doc_of(sa, doc_starts, n_starts, n_rows, n_real,
                              s * seg + i)
                     : kBig;
  __syncthreads();
  // bitonic sort, ascending
  const int half = p2 >> 1;
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const int a = row[i], b = row[l];
        if ((a > b) == ((i & k) == 0)) {
          row[i] = b;
          row[l] = a;
        }
      }
      __syncthreads();
    }
  }
  // unique ids, left-compacted
  int run = 0;
  for (int base = 0; base < p2; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < p2 ? row[i] : kBig;
    const int f = v != kBig && (i == 0 || row[i - 1] != v);
    // kBig sorts last: a round that ends in it is the last with ids
    const int last = row[min(base + static_cast<int>(blockDim.x), p2) - 1];
    const int rank = block_scan(f, warp_sums, &total);
    if (f) out[run + rank] = v;
    run += total;
    __syncthreads();
    if (last == kBig) break;
  }
  for (int i = run + threadIdx.x; i < seg; i += blockDim.x) out[i] = -1;
  if (threadIdx.x == 0) counts[s] = run;
}

__global__ void flatten_ragged_kernel(const int* __restrict__ vals,
                                      int stride,
                                      const int* __restrict__ counts,
                                      const long long* __restrict__ offsets,
                                      int* __restrict__ docs) {
  const long long s = blockIdx.x;
  const int c = counts[s];
  const long long o = offsets[s];
  for (int j = threadIdx.x; j < c; j += blockDim.x)
    docs[o + j] = vals[s * stride + j];
}

}  // namespace

// The row stride of doc_lists' vals for a segment size: seg where the sort
// runs in shared memory, else the power of two the global rows need.
extern "C" long long femto_doc_lists_stride(int seg) {
  const int p2 = pow2_at_least(seg);
  return p2 <= kSharedInts ? seg : p2;
}

// sa int32[n_rows], doc_starts int32[n_starts] -> vals int32[n_seg, stride]
// (each row's sorted unique doc ids, then -1 up to seg) and counts
// int32[n_seg].  Rows with sa >= n_real hold no document.
extern "C" int femto_doc_lists(const void* sa, long long n_rows,
                               long long n_real, const void* doc_starts,
                               int n_starts, int seg, long long n_seg,
                               void* vals, int stride, void* counts,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int p2 = pow2_at_least(seg);
  if (stride != femto_doc_lists_stride(seg) || n_seg <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = p2 <= kSharedInts ? p2 * sizeof(int) : 0;
  doc_lists_kernel<<<static_cast<unsigned>(n_seg), block_threads(p2), shmem,
                     st>>>(
      static_cast<const int*>(sa), n_rows, n_real,
      static_cast<const int*>(doc_starts), n_starts, seg, p2,
      static_cast<int*>(vals), stride, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// vals int32[n_seg, stride], counts int32[n_seg], offsets int64[n_seg + 1]
// (host cumsum of counts, on the card) -> docs int32[offsets[n_seg]].
extern "C" int femto_flatten_ragged(const void* vals, int stride,
                                    const void* counts, const void* offsets,
                                    long long n_seg, void* docs,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  flatten_ragged_kernel<<<static_cast<unsigned>(n_seg), 128, 0, st>>>(
      static_cast<const int*>(vals), stride,
      static_cast<const int*>(counts),
      static_cast<const long long*>(offsets), static_cast<int*>(docs));
  return static_cast<int>(cudaGetLastError());
}
