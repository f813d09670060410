// Kernel K18a, the record exchange's device side: bucket_pack and
// owner_place.
//
// Replaces (femto_tpu/parallel/bins.py): exchange (37), whose stable
// argsort of the destinations, bincount, cumsum and scatters lay each
// shard's records into a capacity-padded [D, cap] buffer per column before
// the all_to_all; and every ".at[idx].set" that places routed or
// replicated records into a shard's block: place_by_owner (148),
// dist_build's _rank_refine / _rank_scatter_body / _dist_round_body /
// _dist_finalize_body placements and the replicated epilogue's
// write-backs, dist_query's receive-side o.at[slot].set.  The shard
// dimension is blockIdx.y: one launch serves every shard a process holds.
//
// bucket_pack sorts nothing.  A record's slot is its bucket's base plus
// the number of earlier records in the same bucket, which three passes
// give: per tile of 1024 records the bucket counts (shared atomics), one
// block per (bucket, shard) scanning those counts down the tiles, and per
// tile a stable in-tile rank from warp match masks (__match_any_sync) and
// a prefix over the tile's warps.  The overflow (largest bucket less cap)
// is an atomicMax on the card; nothing is read back.
//
// Bound on the H100 (3.35 TB/s): bytes.  bucket_pack reads dest and the
// columns once and writes D*cap slots per column plus the valid flags
// (the caller zeroes them: written twice); the counts are 4*(D+1) bytes a
// tile.  owner_place reads each record and writes it once.
#include "fm_common.cuh"

namespace {

constexpr int kTile = 1024;          // records per tile, one per thread
constexpr int kMaxCols = 8;
constexpr int kMaxBuckets = 128;     // D + 1 buckets, the last one "drop"
constexpr int kScanThreads = 1024;
constexpr int kPlaceCols = 4;

struct Cols {
  const int* in[kMaxCols];
  int* out[kMaxCols];
};

struct PlaceCols {
  const void* in[kPlaceCols];
  void* out[kPlaceCols];
};

__device__ __forceinline__ int bucket_of(const int* dest, long long k, int D) {
  const int b = dest[k];
  return (b < 0 || b > D) ? D : b;
}

// Pass 1: the bucket counts of each tile of each shard.
__global__ void bucket_count_kernel(const int* __restrict__ dest,
                                    long long mm, int D, long long n_tiles,
                                    int* __restrict__ counts) {
  __shared__ int h[kMaxBuckets];
  const int d = blockIdx.y;
  const long long tile = blockIdx.x;
  for (int b = threadIdx.x; b <= D; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const long long i = tile * kTile + threadIdx.x;
  if (i < mm) atomicAdd(&h[bucket_of(dest, d * mm + i, D)], 1);
  __syncthreads();
  int* c = counts + (static_cast<long long>(d) * n_tiles + tile) * (D + 1);
  for (int b = threadIdx.x; b <= D; b += blockDim.x) c[b] = h[b];
}

// Pass 2, one block per (bucket, shard): the exclusive scan of the
// bucket's counts down the tiles (in place), and the overflow.
__global__ void bucket_scan_kernel(int* __restrict__ counts,
                                   long long n_tiles, int D, int cap,
                                   int* __restrict__ over) {
  __shared__ int warp_vals[32];
  const int b = blockIdx.x, d = blockIdx.y;
  int* c = counts + static_cast<long long>(d) * n_tiles * (D + 1) + b;
  const long long chunk = (n_tiles + kScanThreads - 1) / kScanThreads;
  const long long t0 = threadIdx.x * chunk;
  const long long t1 = min(t0 + chunk, n_tiles);
  int sum = 0;
  for (long long t = t0; t < t1; ++t) sum += c[t * (D + 1)];
  int total;
  int run = femto::block_exclusive_sum<kScanThreads>(sum, warp_vals, &total);
  for (long long t = t0; t < t1; ++t) {
    const int v = c[t * (D + 1)];
    c[t * (D + 1)] = run;
    run += v;
  }
  if (threadIdx.x == 0 && b < D) atomicMax(over + d, total - cap);
}

// Pass 3: each record's stable rank in its bucket and its slot.
__global__ void bucket_place_kernel(const int* __restrict__ dest,
                                    long long mm, int D, int cap,
                                    long long n_tiles,
                                    const int* __restrict__ counts, Cols cols,
                                    int ncols,
                                    unsigned char* __restrict__ valid) {
  __shared__ int wcnt[32][kMaxBuckets];
  const int d = blockIdx.y;
  const long long tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 32 * (D + 1); i += blockDim.x)
    wcnt[i / (D + 1)][i % (D + 1)] = 0;
  __syncthreads();
  const long long i = tile * kTile + threadIdx.x;
  const int b = i < mm ? bucket_of(dest, d * mm + i, D) : D + 1;
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const int wrank = __popc(peers & ((1u << lane) - 1u));
  if (lane == __ffs(peers) - 1 && b <= D) wcnt[warp][b] = __popc(peers);
  __syncthreads();
  for (int bb = threadIdx.x; bb <= D; bb += blockDim.x) {
    int run = 0;
    for (int w = 0; w < 32; ++w) {
      const int v = wcnt[w][bb];
      wcnt[w][bb] = run;
      run += v;
    }
  }
  __syncthreads();
  if (b >= D) return;
  const int pos =
      counts[(static_cast<long long>(d) * n_tiles + tile) * (D + 1) + b] +
      wcnt[warp][b] + wrank;
  if (pos >= cap) return;
  const long long slot =
      (static_cast<long long>(d) * D + b) * cap + pos;
  for (int c = 0; c < ncols; ++c) cols.out[c][slot] = cols.in[c][d * mm + i];
  valid[slot] = 1;
}

// out[c][d, idx - (shard0 + d) * base_mul] = in[c] where the index lies in
// shard d's block [0, M) and the record is valid; istride 0 = replicated
// records (every shard reads the same ones).
template <typename T>
__global__ void owner_place_kernel(const int* __restrict__ idx,
                                   const unsigned char* __restrict__ valid,
                                   long long mm, long long istride,
                                   int shard0, long long base_mul,
                                   long long M, int ncols, PlaceCols cols) {
  const int d = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mm) return;
  const long long k = d * istride + i;
  if (valid && !valid[k]) return;
  const long long li = static_cast<long long>(idx[k]) -
                       static_cast<long long>(shard0 + d) * base_mul;
  if (li < 0 || li >= M) return;
  for (int c = 0; c < ncols; ++c)
    static_cast<T*>(cols.out[c])[d * M + li] =
        static_cast<const T*>(cols.in[c])[k];
}

}  // namespace

// dest int32[Dl, mm] in [0, D] (D and anything outside: dropped); up to 8
// int32 columns [Dl, mm] -> out columns int32[Dl, D*cap] and valid
// uint8[Dl, D*cap] (zeroed by the caller), over int32[Dl] (filled with
// INT_MIN by the caller).  Scratch counts int32[Dl, n_tiles, D+1].
extern "C" int femto_bucket_pack(
    const void* dest, long long mm, int Dl, int D, int cap, int ncols,
    const void* i0, const void* i1, const void* i2, const void* i3,
    const void* i4, const void* i5, const void* i6, const void* i7,
    void* o0, void* o1, void* o2, void* o3, void* o4, void* o5, void* o6,
    void* o7, void* valid, void* over, void* counts, void* stream) {
  if (D < 1 || D + 1 > kMaxBuckets || ncols < 1 || ncols > kMaxCols ||
      Dl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Cols cols = {{static_cast<const int*>(i0), static_cast<const int*>(i1),
                static_cast<const int*>(i2), static_cast<const int*>(i3),
                static_cast<const int*>(i4), static_cast<const int*>(i5),
                static_cast<const int*>(i6), static_cast<const int*>(i7)},
               {static_cast<int*>(o0), static_cast<int*>(o1),
                static_cast<int*>(o2), static_cast<int*>(o3),
                static_cast<int*>(o4), static_cast<int*>(o5),
                static_cast<int*>(o6), static_cast<int*>(o7)}};
  const long long n_tiles = mm > 0 ? (mm + kTile - 1) / kTile : 1;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(Dl));
  bucket_count_kernel<<<grid, kTile, 0, st>>>(
      static_cast<const int*>(dest), mm, D, n_tiles,
      static_cast<int*>(counts));
  bucket_scan_kernel<<<dim3(D + 1, Dl), kScanThreads, 0, st>>>(
      static_cast<int*>(counts), n_tiles, D, cap, static_cast<int*>(over));
  bucket_place_kernel<<<grid, kTile, 0, st>>>(
      static_cast<const int*>(dest), mm, D, cap, n_tiles,
      static_cast<const int*>(counts), cols, ncols,
      static_cast<unsigned char*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// idx int32[Dl, mm] (istride mm) or [mm] (istride 0), valid uint8 like idx
// or null; up to 4 columns like idx -> out columns [Dl, M] of esize 4
// (int32) or 1 (uint8) bytes, updated in place.
extern "C" int femto_owner_place(const void* idx, const void* valid,
                                 long long mm, int Dl, long long istride,
                                 int shard0, long long base_mul, long long M,
                                 int esize, int ncols, const void* i0,
                                 const void* i1, const void* i2,
                                 const void* i3, void* o0, void* o1, void* o2,
                                 void* o3, void* stream) {
  if (ncols < 1 || ncols > kPlaceCols || (esize != 1 && esize != 4) ||
      Dl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PlaceCols cols = {{i0, i1, i2, i3}, {o0, o1, o2, o3}};
  const dim3 grid(static_cast<unsigned>((mm + 255) / 256),
                  static_cast<unsigned>(Dl));
  if (esize == 4)
    owner_place_kernel<int><<<grid, 256, 0, st>>>(
        static_cast<const int*>(idx),
        static_cast<const unsigned char*>(valid), mm, istride, shard0,
        base_mul, M, ncols, cols);
  else
    owner_place_kernel<unsigned char><<<grid, 256, 0, st>>>(
        static_cast<const int*>(idx),
        static_cast<const unsigned char*>(valid), mm, istride, shard0,
        base_mul, M, ncols, cols);
  return static_cast<int>(cudaGetLastError());
}
