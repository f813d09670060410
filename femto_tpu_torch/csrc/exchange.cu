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
// dimension is a grid dimension: one launch serves every shard a process
// holds.
//
// bucket_pack sorts nothing.  A record's slot is its bucket's base plus
// the number of earlier records of its shard in the same bucket.  A call
// is one launch, of one of two kernels chosen by the records a shard
// holds:
//   - bucket_pack_block, up to kOneBlockMax records a shard (the routed
//     queries' exchanges): one block a shard walks its records in chunks,
//     keeps each bucket's running count in a register of the thread that
//     owns the bucket, and writes every slot of the shard's outputs itself
//     (the records, their flags, the zeros of the empty slots) and `over`.
//     No scratch, no memset.
//   - bucket_pack_tile above that (the build's exchanges): a block takes
//     its tile number from its shard's atomic counter, so every tile it
//     waits on belongs to a block that already runs (kernel H's
//     radix_tile_pass).  It publishes the tile's D + 1 bucket counts as
//     64-bit status words (tag and count) and looks back over the earlier
//     tiles' words for each bucket's records before it.  The tile numbered
//     last then holds every bucket's total and writes `over`.  The empty
//     slots are zeroed inside the launch, each once, and no block waits
//     for the last tile to learn where they start: after its look-back a
//     tile knows that a bucket ends at most at its prefix plus the records
//     of the tiles after it, and zeroes the slots between that bound and
//     the one the tile before it had (tile 0: up to cap), column by
//     column as it writes its records.  The ranges of all tiles are each
//     bucket's [total, cap).  (Blocks past the last
//     tile that wait for its totals and then zero the tails, the way first
//     tried, zeroed after the tiles on a few blocks, and took most of the
//     call on the H100 at the sharded build's first call, whose cap is
//     four times its buckets; a memset of every output before the tiles
//     would write each record's slot twice.)  The counters and status
//     words are the call's scratch (femto_bucket_pack_scratch), zeroed by
//     the call's one cudaMemsetAsync.
// Both kernels rank a record among its tile's (or chunk's) records of the
// same bucket in input order (__match_any_sync, the warp's running count
// of the bucket in shared memory, a prefix over the warps), stage the
// records in shared memory in bucket order, and write them out as whole
// bucket runs: neighbouring threads store to neighbouring slots.  dest
// (and the optional valid flags) are read once.  A record's slot depends
// only on its tile number and its place in the tile; no position comes
// from the order in which atomics return.
//
// Bound on the H100 (3.35 TB/s): bytes.  bucket_pack reads dest, the
// valid flags where given and the columns once, and writes each of the D
// * cap slots of every column and of the flags once; the scratch is 8 (D
// + 1) bytes a tile of 6144 records.  owner_place reads each record and
// writes it once.
#include "fm_common.cuh"

namespace {

constexpr int kMaxCols = 8;
constexpr int kMaxBuckets = 128;     // D + 1 buckets, the last one "drop"
constexpr int kPlaceCols = 4;
constexpr int kIntMin = -2147483647 - 1;
// the tile pass: kTileItems records a thread, two blocks an SM (longer
// tiles ran faster on the H100 than more blocks of shorter ones)
constexpr int kTileThreads = 256;
constexpr int kTileItems = 24;
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kMinBlocks = 2;  // resident tile blocks per SM
constexpr int kLook = 8;       // earlier tiles' status words read at once
// the one-block path: chunks of kBlockThreads * kBlockItems records
constexpr int kBlockThreads = 512;
constexpr int kBlockItems = 8;
constexpr int kChunk = kBlockThreads * kBlockItems;
// Builds with another limit (-DFEMTO_K18A_ONE_BLOCK_MAX=0 or 0x7fffffff)
// let chip_smoke.py hold each route against the other on the paths' own
// calls.
#ifndef FEMTO_K18A_ONE_BLOCK_MAX
#define FEMTO_K18A_ONE_BLOCK_MAX 8192
#endif
// records a shard up to which one block packs the shard
constexpr long long kOneBlockMax = FEMTO_K18A_ONE_BLOCK_MAX;
// a status word: the count in bits 0-31, the tag above it (0: not yet
// published)
constexpr unsigned long long kAggregate = 1, kInclusive = 2;
constexpr unsigned long long kCountMask = 0xffffffffull;

static_assert(kTileThreads >= kMaxBuckets && kBlockThreads >= kMaxBuckets,
              "a thread a bucket");
static_assert(kTileItems <= 32 && kBlockItems <= 32, "a mask bit an item");

struct Cols {
  const int* in[kMaxCols];
  int* out[kMaxCols];
};

struct PlaceCols {
  const void* in[kPlaceCols];
  void* out[kPlaceCols];
};

template <int kT, int kIt>
struct PackSmem {
  int x[kT * kIt];                   // one column of the tile, bucket order
  unsigned char b[kT * kIt];         // the bucket of each place
  int off[kT / 32][kMaxBuckets];     // per warp and bucket: count, start
  int pos0[kMaxBuckets];             // a bucket's place in its run - place
  int zlo[kMaxBuckets], zhi[kMaxBuckets];  // empty slots [zlo, zhi) to zero
  int warp_vals[32];
  int keep;                          // the places before bucket D's
};

__device__ __forceinline__ int bucket_of(const int* dest,
                                         const unsigned char* vin,
                                         long long k, int D) {
  if (vin != nullptr && vin[k] == 0) return D;
  const int b = dest[k];
  return (b < 0 || b > D) ? D : b;
}

// Ranks the n records from src on (n <= kT * kIt; item j of lane l of
// warp w is record w * kIt * 32 + j * 32 + l) among the tile's records of
// their bucket, in input order: bk[j] is the item's bucket (D + 1 past n),
// place[j] its place in the tile in bucket order (records of bucket D are
// not placed), s.b the bucket of each place and s.keep the number of
// places before bucket D's.  Thread t <= D gets bucket t's count in the
// tile and its first place.
template <int kT, int kIt>
__device__ __forceinline__ void rank_tile(const int* dest,
                                          const unsigned char* vin,
                                          long long src, int n, int D,
                                          int (&bk)[kIt], int (&place)[kIt],
                                          PackSmem<kT, kIt>& s, int* cnt_out,
                                          int* start_out) {
  constexpr int kW = kT / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (t < kMaxBuckets)
    for (int w = 0; w < kW; ++w) s.off[w][t] = 0;
  __syncthreads();
  const int wbase = warp * (kIt * 32);
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const int i = wbase + j * 32 + lane;
    bk[j] = i < n ? bucket_of(dest, vin, src + i, D) : D + 1;
  }
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const unsigned peers = __match_any_sync(0xffffffffu, bk[j]);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader && bk[j] <= D) {
      before = s.off[warp][bk[j]];
      s.off[warp][bk[j]] = before + __popc(peers);
    }
    place[j] = __shfl_sync(0xffffffffu, before, leader) + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();
  // thread t owns bucket t: the tile's count, each warp's start within it
  int cnt = 0;
  if (t <= D) {
    for (int w = 0; w < kW; ++w) {
      const int c = s.off[w][t];
      s.off[w][t] = cnt;
      cnt += c;
    }
  }
  int total;
  const int start = femto::block_exclusive_sum<kT>(cnt, s.warp_vals, &total);
  if (t <= D)
    for (int w = 0; w < kW; ++w) s.off[w][t] += start;
  if (t == D) s.keep = start;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    if (bk[j] < D) {
      place[j] += s.off[warp][bk[j]];
      s.b[place[j]] = static_cast<unsigned char>(bk[j]);
    }
  }
  *cnt_out = cnt;
  *start_out = start;
}

// Zeroes slots [lo[b], hi[b]) of each bucket b < D of a shard's outputs
// (the columns and the flags): thread t's share.
template <int kT>
__device__ __forceinline__ void zero_tails(const int* lo, const int* hi,
                                           int D, int cap, long long obase,
                                           const Cols& cols, int ncols,
                                           unsigned char* vout) {
  for (int b = 0; b < D; ++b) {
    if (lo[b] >= hi[b]) continue;
    const long long s0 = obase + static_cast<long long>(b) * cap;
    for (int c = 0; c < ncols; ++c)
      femto::fill_range(cols.out[c] + s0, lo[b], hi[b], 0, threadIdx.x, kT);
    femto::fill_range(vout + s0, lo[b], hi[b], 0, threadIdx.x, kT);
  }
}

// The tile's kept places, column by column, to their slots: place i of
// bucket b goes to obase + b * cap + s.pos0[b] + i where that lies below
// cap, with its flag; thread t writes places t, t + kT, ...: whole bucket
// runs, in order.  v holds column 0's values of the items on entry; each
// next column is requested while the one before goes out.  With `zero`,
// each column's (and with column 0 the flags') slots [s.zlo[b], s.zhi[b])
// are zeroed right after its records, so that the zero stores go out
// between the loads.  s.pos0 (and s.zlo, s.zhi) are set by the caller.
template <int kT, int kIt>
__device__ __forceinline__ void write_runs(
    const Cols& cols, int ncols, long long src, const int (&bk)[kIt],
    const int (&place)[kIt], int (&v)[kIt], int D, int cap, long long obase,
    unsigned char* vout, PackSmem<kT, kIt>& s, bool zero = false) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long wsrc = src + warp * (kIt * 32) + lane;
  unsigned kept = 0;  // bit j: item j goes out
#pragma unroll
  for (int j = 0; j < kIt; ++j) kept |= (bk[j] < D ? 1u : 0u) << j;
  int dst[kIt];  // each place's slot - obase, or -1
  for (int c = 0; c < ncols; ++c) {
#pragma unroll
    for (int j = 0; j < kIt; ++j)
      if (kept >> j & 1u) s.x[place[j]] = v[j];
    if (c + 1 < ncols) {
      const int* in = cols.in[c + 1];
#pragma unroll
      for (int j = 0; j < kIt; ++j)
        v[j] = kept >> j & 1u ? in[wsrc + j * 32] : 0;
    }
    __syncthreads();
    if (c == 0) {
      const int keep = s.keep;
#pragma unroll
      for (int r = 0; r < kIt; ++r) {
        const int i = t + r * kT;
        dst[r] = -1;
        if (i < keep) {
          const int b = s.b[i];
          const int pos = s.pos0[b] + i;
          if (pos < cap) {
            dst[r] = b * cap + pos;  // D * cap < 2^31
            vout[obase + dst[r]] = 1;
          }
        }
      }
    }
    int* out = cols.out[c] + obase;
#pragma unroll
    for (int r = 0; r < kIt; ++r)
      if (dst[r] >= 0) out[dst[r]] = s.x[t + r * kT];
    if (zero) {
      for (int b = 0; b < D; ++b) {
        const long long s0 = obase + static_cast<long long>(b) * cap;
        femto::fill_range(cols.out[c] + s0, s.zlo[b], s.zhi[b], 0, t, kT);
        if (c == 0) femto::fill_range(vout + s0, s.zlo[b], s.zhi[b], 0, t, kT);
      }
    }
    __syncthreads();
  }
}

// Column 0's values of the tile's kept items.
template <int kIt>
__device__ __forceinline__ void load_first(const Cols& cols, long long src,
                                           const int (&bk)[kIt],
                                           int (&v)[kIt], int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long wsrc = src + warp * (kIt * 32) + lane;
#pragma unroll
  for (int j = 0; j < kIt; ++j)
    v[j] = bk[j] < D ? cols.in[0][wsrc + j * 32] : 0;
}

// One block a shard (blockIdx.x), every chunk of its records in turn.
__global__ void __launch_bounds__(kBlockThreads)
    bucket_pack_block(const int* __restrict__ dest,
                      const unsigned char* __restrict__ vin, long long mm,
                      int D, int cap, Cols cols, int ncols,
                      unsigned char* __restrict__ vout,
                      int* __restrict__ over) {
  __shared__ PackSmem<kBlockThreads, kBlockItems> s;
  const int t = threadIdx.x, d = blockIdx.x;
  const long long obase = static_cast<long long>(d) * D * cap;
  int run = 0;  // thread t <= D: bucket t's records in the chunks before
  for (long long base = 0; base < mm; base += kChunk) {
    const long long src = static_cast<long long>(d) * mm + base;
    const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                       mm - base));
    int bk[kBlockItems], place[kBlockItems], v[kBlockItems];
    int cnt, start;
    rank_tile(dest, vin, src, n, D, bk, place, s, &cnt, &start);
    load_first(cols, src, bk, v, D);
    if (t <= D) {
      s.pos0[t] = run - start;
      run += cnt;
    }
    write_runs(cols, ncols, src, bk, place, v, D, cap, obase, vout, s);
  }
  int most;
  femto::block_exclusive_max<kBlockThreads>(t < D ? run : kIntMin, kIntMin,
                                            s.warp_vals, &most);
  if (t == 0) over[d] = most - cap;
  if (t < D) {
    s.zlo[t] = min(run, cap);
    s.zhi[t] = cap;
  }
  __syncthreads();
  zero_tails<kBlockThreads>(s.zlo, s.zhi, D, cap, obase, cols, ncols, vout);
}

// One tile of shard blockIdx.y, its number from the shard's counter.
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
    bucket_pack_tile(const int* __restrict__ dest,
                     const unsigned char* __restrict__ vin, long long mm,
                     int D, int cap, long long n_tiles, Cols cols, int ncols,
                     unsigned char* __restrict__ vout,
                     int* __restrict__ over, int* __restrict__ counters,
                     unsigned long long* __restrict__ status) {
  __shared__ PackSmem<kTileThreads, kTileItems> s;
  __shared__ long long s_tile;
  const int t = threadIdx.x, d = blockIdx.y, nb = D + 1;
  if (t == 0) s_tile = atomicAdd(counters + d, 1);
  __syncthreads();
  const long long tile = s_tile;
  const long long obase = static_cast<long long>(d) * D * cap;
  unsigned long long* st = status + static_cast<long long>(d) * n_tiles * nb;
  const long long src = static_cast<long long>(d) * mm + tile * kTile;
  const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                     mm - tile * kTile));
  int bk[kTileItems], place[kTileItems], v[kTileItems];
  int cnt, start;
  rank_tile(dest, vin, src, n, D, bk, place, s, &cnt, &start);
  // column 0 requested now: the look-back hides its latency
  load_first(cols, src, bk, v, D);
  // each bucket's records in the tiles before this one (kLook words at
  // once, newest first: aggregates add and go on, an inclusive prefix adds
  // and ends, a word not yet published is where the next window starts;
  // tile 0 publishes its inclusive prefix at once)
  long long excl = 0;
  if (t < nb) {
    volatile unsigned long long* mine = st + tile * nb + t;
    *mine = (tile == 0 ? kInclusive : kAggregate) << 32 |
            static_cast<unsigned long long>(cnt);
    __threadfence();
    if (tile > 0) {
      const volatile unsigned long long* prev = st + t;
      for (long long p = tile - 1;;) {
        unsigned long long w[kLook];
#pragma unroll
        for (int q = 0; q < kLook; ++q)
          w[q] = p - q >= 0 ? prev[(p - q) * nb] : 0;
        int q = 0;
        bool found = false;
#pragma unroll
        for (; q < kLook; ++q) {
          if ((w[q] >> 32) < kAggregate) break;
          excl += static_cast<long long>(w[q] & kCountMask);
          if ((w[q] >> 32) == kInclusive) {
            found = true;
            break;
          }
        }
        if (found) break;
        p -= q;
      }
      *mine = kInclusive << 32 | static_cast<unsigned long long>(excl + cnt);
      __threadfence();
    }
    s.pos0[t] = static_cast<int>(excl) - start;  // mm < 2^31
    // The records after this tile, r, bound each bucket's total: it is at
    // most excl + cnt + r, so the slots from there on stay empty.  Tile t
    // zeroes what its count adds to that: [excl + cnt + r, excl + n + r)
    // (tile 0: up to cap), clipped to cap.  Over the tiles these ranges
    // are [total, cap) of each bucket, each slot once, and no tile waits.
    const long long r = mm - tile * kTile - n;
    s.zlo[t] = static_cast<int>(min(excl + cnt + r,
                                    static_cast<long long>(cap)));
    s.zhi[t] = tile == 0 ? cap
                         : static_cast<int>(min(excl + n + r,
                                                static_cast<long long>(cap)));
  }
  if (tile == n_tiles - 1) {
    // the last tile: every bucket's total, so the overflow
    int most;
    femto::block_exclusive_max<kTileThreads>(
        t < D ? static_cast<int>(excl + cnt) : kIntMin, kIntMin, s.warp_vals,
        &most);
    if (t == 0) over[d] = most - cap;
  }
  write_runs(cols, ncols, src, bk, place, v, D, cap, obase, vout, s, true);
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

long long tiles_of(long long mm) { return (mm + kTile - 1) / kTile; }

// the counters (one a shard), padded so that the status words are 8-byte
// aligned
long long header_ints(int Dl) { return 2LL * ((Dl + 1) / 2); }

}  // namespace

// Records a tile in a femto_bucket_pack call over shards of mm records (0
// on the one-block path).
extern "C" long long femto_bucket_pack_tile(long long mm) {
  return mm <= kOneBlockMax ? 0 : kTile;
}

// Scratch of femto_bucket_pack in int32 elements (0 on the one-block
// path): a tile counter a shard, then (D + 1) uint64 status words a tile.
extern "C" long long femto_bucket_pack_scratch(long long mm, int Dl, int D) {
  if (mm <= kOneBlockMax) return 0;
  return header_ints(Dl) + 2LL * Dl * tiles_of(mm) * (D + 1);
}

// dest int32[Dl, mm] in [0, D] (D and anything outside: dropped), valid_in
// uint8[Dl, mm] or null (0: dropped); up to 8 int32 columns [Dl, mm] ->
// out columns int32[Dl, D*cap], valid uint8[Dl, D*cap] and over int32[Dl],
// every element written by the call.  Scratch as femto_bucket_pack_scratch
// says (null on the one-block path).  One kernel a call; the tile path
// also zeroes the scratch with one cudaMemsetAsync.
extern "C" int femto_bucket_pack(
    const void* dest, const void* valid_in, long long mm, int Dl, int D,
    int cap, int ncols, const void* i0, const void* i1, const void* i2,
    const void* i3, const void* i4, const void* i5, const void* i6,
    const void* i7, void* o0, void* o1, void* o2, void* o3, void* o4,
    void* o5, void* o6, void* o7, void* valid, void* over, void* scratch,
    void* stream) {
  if (D < 1 || D + 1 > kMaxBuckets || ncols < 1 || ncols > kMaxCols ||
      Dl < 1 || cap < 1 || mm < 0 || mm > 0x7fffffffLL ||
      static_cast<long long>(D) * cap > 0x7fffffffLL)
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
  const int* dp = static_cast<const int*>(dest);
  const unsigned char* vp = static_cast<const unsigned char*>(valid_in);
  unsigned char* vo = static_cast<unsigned char*>(valid);
  int* op = static_cast<int*>(over);
  if (mm <= kOneBlockMax) {
    bucket_pack_block<<<Dl, kBlockThreads, 0, st>>>(dp, vp, mm, D, cap, cols,
                                                    ncols, vo, op);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, 4 * femto_bucket_pack_scratch(mm, Dl, D), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_tiles = tiles_of(mm);
  int* counters = static_cast<int*>(scratch);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(counters + header_ints(Dl));
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(Dl));
  bucket_pack_tile<<<grid, kTileThreads, 0, st>>>(
      dp, vp, mm, D, cap, n_tiles, cols, ncols, vo, op, counters, status);
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
