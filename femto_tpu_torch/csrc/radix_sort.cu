// Kernel H, radix_sort_pairs: a stable least-significant-digit radix sort
// of non-negative int64 keys carrying an int32 value, over a bit range.
//
// Replaces the lax.sort calls of femto_tpu/suffix.py: _sort3 (148, the one
// big sort of the packed keys) and the sorts inside _extend_round_impl
// (204), _full_round (280) and _filtered_round (302).  XLA's sort is a
// comparison network over several 30-bit keys; on the card an 8-bit LSD
// radix sort does one counting pass and one scatter pass per digit, in
// three steps that are all here:
//   1. radix_count_kernel: every block counts the digits of its tile of
//      4096 keys into counts[digit][block] (digit-major);
//   2. an exclusive scan of that table in digit-major order (tile sums, one
//      block over the tile sums, tiles with their carry): the start in the
//      output of each block's keys of each digit;
//   3. radix_scatter_kernel: every block ranks its keys among the block's
//      keys of the same digit in input order and writes key and value to
//      start + rank.
// Stability: a thread's j-th item is key tile + j * 256 + thread, so input
// order is (j, warp, lane).  For each j the lanes of a warp that share a
// digit find each other by __match_any_sync and rank by the count of lower
// lanes; the warps' counts are prefixed in warp order by the digit's own
// thread, which also carries the count of the earlier j.  No position comes
// from the order in which atomics return.
//
// Bound on the H100 (3.35 TB/s): bytes.  The function must read and write
// key and value once: 24 bytes per element, 6.4 GB and 1.92 ms at 2^28.
// This design moves that much per 8-bit pass (plus the keys once more for
// the counts), 8 passes for a 60-bit key, and scatters 8- and 4-byte
// elements straight to device memory, so it is many times its bound.
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // keys per block
constexpr int kRadix = 256;               // == kThreads: one digit a thread
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 16;
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kTopThreads = 1024;  // the one block over the tile sums

__device__ __forceinline__ int digit_of(long long key, int shift, int mask) {
  return static_cast<int>(static_cast<unsigned long long>(key) >> shift) &
         mask;
}

__global__ void radix_count_kernel(const long long* __restrict__ keys,
                                   long long m, int shift, int mask,
                                   long long nblocks,
                                   int* __restrict__ counts) {
  __shared__ int h[kRadix];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    const int d = i < m ? digit_of(keys[i], shift, mask) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < kRadix && lane == __ffs(peers) - 1)
      atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  counts[static_cast<long long>(threadIdx.x) * nblocks + blockIdx.x] =
      h[threadIdx.x];
}

// Scan step 1: the sum of each tile of kScanTile table entries.
__global__ void scan_tile_sum_kernel(const int* __restrict__ a, long long len,
                                     int* __restrict__ tile_sums) {
  __shared__ int warp_vals[32];
  const long long b = static_cast<long long>(blockIdx.x) * kScanTile +
                      static_cast<long long>(threadIdx.x) * kScanItems;
  int s = 0;
  for (int j = 0; j < kScanItems; ++j)
    if (b + j < len) s += a[b + j];
  int total;
  femto::block_exclusive_sum<kThreads>(s, warp_vals, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// Scan step 2 (one block): exclusive scan of the tile sums, in place.
__global__ void scan_top_kernel(int* __restrict__ tile_sums,
                                long long ntiles) {
  __shared__ int warp_vals[32];
  const long long chunk = (ntiles + kTopThreads - 1) / kTopThreads;
  const long long b = threadIdx.x * chunk;
  const long long e = min(b + chunk, ntiles);
  int s = 0;
  for (long long i = b; i < e; ++i) s += tile_sums[i];
  int total;
  int run = femto::block_exclusive_sum<kTopThreads>(s, warp_vals, &total);
  for (long long i = b; i < e; ++i) {
    const int v = tile_sums[i];
    tile_sums[i] = run;
    run += v;
  }
}

// Scan step 3: exclusive scan inside each tile plus the tile's carry, in
// place.
__global__ void scan_apply_kernel(int* __restrict__ a, long long len,
                                  const int* __restrict__ tile_sums) {
  __shared__ int warp_vals[32];
  const long long b = static_cast<long long>(blockIdx.x) * kScanTile +
                      static_cast<long long>(threadIdx.x) * kScanItems;
  int v[kScanItems];
  int s = 0;
  for (int j = 0; j < kScanItems; ++j) {
    v[j] = b + j < len ? a[b + j] : 0;
    s += v[j];
  }
  int total;
  int run = tile_sums[blockIdx.x] +
            femto::block_exclusive_sum<kThreads>(s, warp_vals, &total);
  for (int j = 0; j < kScanItems; ++j) {
    if (b + j < len) a[b + j] = run;
    run += v[j];
  }
}

// vals_in null: the value of element i is i.
__global__ void radix_scatter_kernel(const long long* __restrict__ keys_in,
                                     const int* __restrict__ vals_in,
                                     long long m, int shift, int mask,
                                     long long nblocks,
                                     const int* __restrict__ starts,
                                     long long* __restrict__ keys_out,
                                     int* __restrict__ vals_out) {
  __shared__ int cnt[kWarps][kRadix];
  __shared__ int off[kWarps][kRadix];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int w = 0; w < kWarps; ++w) cnt[w][t] = 0;
  // where this block's next key of digit t goes
  int run = starts[static_cast<long long>(t) * nblocks + blockIdx.x];
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int j = 0; j < kItems; ++j) {
    if (base + static_cast<long long>(j) * kThreads >= m) break;  // uniform
    const long long i = base + j * kThreads + t;
    const bool valid = i < m;
    long long k = 0;
    int d = kRadix;
    if (valid) {
      k = keys_in[i];
      d = digit_of(k, shift, mask);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (valid && (peers & lt) == 0) cnt[warp][d] = __popc(peers);
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w][t];
      off[w][t] = run;
      run += c;
      cnt[w][t] = 0;
    }
    __syncthreads();
    if (valid) {
      const long long dst = off[warp][d] + __popc(peers & lt);
      keys_out[dst] = k;
      vals_out[dst] = vals_in ? vals_in[i] : static_cast<int>(i);
    }
  }
}

}  // namespace

// Sorts m (keys_in int64, vals_in int32 or null for 0..m-1) pairs by bits
// [bit_lo, bit_hi) of the key, stably, in ceil((bit_hi - bit_lo) / 8)
// passes.  Pass p reads the input (p = 0) or the buffers of pass p - 1 and
// writes (k0, v0) for even p, (k1, v1) for odd p; the input is left as it
// was and the result is in the buffers of the last pass.  Scratch: counts
// int32[256 * ceil(m / 4096)], tile_sums int32[ceil(len(counts) / 4096)].
extern "C" int femto_radix_sort_pairs(const void* keys_in,
                                      const void* vals_in, void* k0, void* v0,
                                      void* k1, void* v1, long long m,
                                      int bit_lo, int bit_hi, void* counts,
                                      void* tile_sums, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nblocks = (m + kTile - 1) / kTile;
  const long long len = nblocks * kRadix;
  const long long ntiles = (len + kScanTile - 1) / kScanTile;
  const long long* src_k = static_cast<const long long*>(keys_in);
  const int* src_v = static_cast<const int*>(vals_in);
  int* cnts = static_cast<int*>(counts);
  int* sums = static_cast<int*>(tile_sums);
  int pass = 0;
  for (int shift = bit_lo; shift < bit_hi; shift += 8, ++pass) {
    const int nb = bit_hi - shift < 8 ? bit_hi - shift : 8;
    const int mask = (1 << nb) - 1;
    long long* dst_k = static_cast<long long*>(pass % 2 == 0 ? k0 : k1);
    int* dst_v = static_cast<int*>(pass % 2 == 0 ? v0 : v1);
    radix_count_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, st>>>(
        src_k, m, shift, mask, nblocks, cnts);
    scan_tile_sum_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, st>>>(
        cnts, len, sums);
    scan_top_kernel<<<1, kTopThreads, 0, st>>>(sums, ntiles);
    scan_apply_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, st>>>(
        cnts, len, sums);
    radix_scatter_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, st>>>(
        src_k, src_v, m, shift, mask, nblocks, cnts, dst_k, dst_v);
    src_k = dst_k;
    src_v = dst_v;
  }
  return static_cast<int>(cudaGetLastError());
}
