// Kernel H, radix_sort_pairs: a stable least-significant-digit radix sort
// of non-negative int64 keys carrying an int32 value, over a bit range.
//
// Replaces the lax.sort calls of femto_tpu/suffix.py: _sort3 (148, the one
// big sort of the packed keys) and the sorts inside _extend_round_impl
// (204), _full_round (280) and _filtered_round (302).  XLA's sort is a
// comparison network over several 30-bit keys; on the card an 8-bit LSD
// radix sort does ceil((bit_hi - bit_lo) / 8) passes, one launch each,
// after one histogram launch:
//   1. radix_digit_hist reads the keys once and counts the digit of every
//      pass at once (up to 8 x 256 bins): shared-memory counts per block,
//      added into the global table with integer atomics (sums, so their
//      order does not matter).  One memset a sort zeroes the table, the
//      tile counters and the status words.
//   2. radix_tile_pass, once a pass: a block takes its tile number (4096
//      keys; 1024 where m <= 2^18) from an atomic counter, so every tile
//      it waits on belongs to a block that already runs.  It loads the
//      tile coalesced (warp w holds keys w * kIt * 32 onwards, item j of
//      lane l at j * 32 + l) and ranks every key among the tile's keys of
//      its digit in input order: __match_any_sync in the warp, the warp's
//      running count of the digit in shared memory, a prefix over the
//      warps.  It publishes the tile's 256 counts and looks back over the
//      earlier tiles' status words (one thread a digit, 8 words a read;
//      tag and count in one 64-bit word) for the digit's keys before it;
//      the exclusive scan of the pass's global bins gives each digit's
//      start.  Keys, then values, go through shared memory into digit
//      order and out as whole digit runs: consecutive threads store
//      consecutive addresses.
//   3. radix_block_sort: where m <= kSmallMax (4096), one block holds keys
//      and values twice in shared memory and runs every pass there, in one
//      launch in all.
// Stability and determinism: a key's place depends only on its tile number
// and its place in the tile; the tile counter only hands out numbers, and
// no position comes from the order in which atomics return.
//
// Bound on the H100 (3.35 TB/s): bytes.  The function must read and write
// key and value once: 24 bytes per element, 6.4 GB and 1.92 ms at 2^28.
// An LSD sort moves 24 bytes an element a pass plus 8 for the histogram's
// read: 200 bytes at 8 passes, 16.0 ms at 2^28 (the LSD floor).
#include "fm_common.cuh"

namespace {

constexpr int kRadix = 256;
constexpr int kMaxPasses = 8;  // 63 bits in 8-bit digits
// the tile pass: one thread a digit; kItems keys a thread, fewer where the
// sort has few tiles (a tile's latency, not the card's bandwidth, then
// sets the time)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // keys per tile
constexpr int kFewItems = 4;
constexpr int kFewTile = kThreads * kFewItems;
// Builds with other routes for the same sorts (-DFEMTO_H_ONE_BLOCK=0,
// -DFEMTO_H_FEW_MAX=0 or 0x7fffffff) let chip_smoke.py hold each route
// against another on the paths' own sorts.
#ifndef FEMTO_H_FEW_MAX
#define FEMTO_H_FEW_MAX (1 << 18)
#endif
#ifndef FEMTO_H_ONE_BLOCK
#define FEMTO_H_ONE_BLOCK 1
#endif
// m up to which tiles are kFewTile
constexpr long long kFewMax = FEMTO_H_FEW_MAX;
constexpr int kMinBlocks = 3;           // resident tile blocks per SM
constexpr int kLook = 8;  // earlier tiles' status words read at once
// the histogram
constexpr int kHistThreads = 512;
constexpr int kHistUnroll = 4;
constexpr int kHistBlocksPerSm = 2;
// the one-block sort: keys and values twice, and the warps' digit counts
constexpr int kSmallThreads = 512;
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kSmallItems = 8;
constexpr int kSmallMax = kSmallThreads * kSmallItems;
// m up to which one block runs the whole sort
constexpr long long kOneBlockMax = FEMTO_H_ONE_BLOCK ? kSmallMax : 0;
constexpr int kSmallSmem = 2 * kSmallMax * 8 + 2 * kSmallMax * 4 +
                           kSmallWarps * kRadix * 4;
// scratch (int32 elements): the bins of every pass, a tile counter a
// pass, then the status words (uint64, one per tile and digit), all zeroed
// by one memset a sort
constexpr int kHeaderInts = kMaxPasses * kRadix + kMaxPasses;
// a status word: the count in bits 0-31, a tag above it; pass p publishes
// tag 2p + 1 (the tile's aggregate) or 2p + 2 (inclusive prefix), so a
// word left by an earlier pass (or 0) reads as not yet published
constexpr unsigned long long kCountMask = 0xffffffffull;

static_assert(kThreads == kRadix, "the tile pass runs one thread a digit");
static_assert(kHeaderInts % 2 == 0, "status words are 8-byte aligned");
static_assert(kSmallSmem <= 232448 - 1024, "one block's shared memory");

__device__ __forceinline__ int digit_of(long long key, int shift, int mask) {
  return static_cast<int>(static_cast<unsigned long long>(key) >> shift) &
         mask;
}

__global__ void __launch_bounds__(kHistThreads)
    radix_digit_hist(const long long* __restrict__ keys, long long m,
                     int bit_lo, int bit_hi, int* __restrict__ hist) {
  __shared__ int h[kMaxPasses * kRadix];
  const int passes = (bit_hi - bit_lo + 7) / 8;
  for (int i = threadIdx.x; i < passes * kRadix; i += kHistThreads) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long step = 32LL * kHistUnroll;
  const long long nwarps =
      static_cast<long long>(gridDim.x) * (kHistThreads / 32);
  for (long long base = ((static_cast<long long>(blockIdx.x) * kHistThreads +
                          threadIdx.x) >> 5) * step;
       base < m; base += nwarps * step) {
    long long k[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const long long i = base + u * 32 + lane;
      k[u] = i < m ? keys[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (base + u * 32 + lane >= m) break;
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p) {
        if (p >= passes) break;
        const int shift = bit_lo + 8 * p;
        const int nb = min(8, bit_hi - shift);
        const int d = digit_of(k[u], shift, (1 << nb) - 1);
        atomicAdd(&h[p * kRadix + d], 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kRadix; i += kHistThreads)
    if (h[i]) atomicAdd(&hist[i], h[i]);
}

// Pass `pass` over digit (key >> shift) & mask, tiles of kThreads * kIt
// keys.  hist: this pass's 256 global bins; kIota: the value of element i
// is i (the first pass without vals).
template <bool kIota, int kIt>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    radix_tile_pass(const long long* __restrict__ keys_in,
                    const int* __restrict__ vals_in, long long m, int pass,
                    int shift, int mask, const int* __restrict__ hist,
                    int* __restrict__ tile_counter,
                    unsigned long long* __restrict__ status,
                    long long* __restrict__ keys_out,
                    int* __restrict__ vals_out) {
  constexpr int kT = kThreads * kIt;
  __shared__ long long s_x[kT];  // the tile in digit order
  // per warp and digit: the warp's count, then its first place in s_x
  __shared__ int s_off[kWarps][kRadix];
  __shared__ int s_dst[kRadix];  // output index - place, per digit
  __shared__ int s_warp[32];
  __shared__ int s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (t == 0) s_tile = atomicAdd(tile_counter, 1);
  for (int w = 0; w < kWarps; ++w) s_off[w][t] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long tbase = tile * kT;
  const long long wbase = tbase + warp * (kIt * 32);
  long long k[kIt];
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const long long i = wbase + j * 32 + lane;
    k[j] = i < m ? keys_in[i] : 0;
  }
  // rank among the warp's earlier keys of the same digit, in input order
  int place[kIt];
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const bool ok = wbase + j * 32 + lane < m;
    const int d = ok ? digit_of(k[j], shift, mask) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader && ok) {
      before = s_off[warp][d];
      s_off[warp][d] = before + __popc(peers);
    }
    place[j] = __shfl_sync(0xffffffffu, before, leader) + __popc(peers & lt);
  }
  __syncthreads();
  // thread t owns digit t: the tile's count, each warp's start within it
  int cnt = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_off[w][t];
    s_off[w][t] = cnt;
    cnt += c;
  }
  const unsigned long long aggregate = 2ull * pass + 1,
                           inclusive = 2ull * pass + 2;
  volatile unsigned long long* mine = status + tile * kRadix + t;
  *mine = (tile == 0 ? inclusive : aggregate) << 32 |
          static_cast<unsigned long long>(cnt);
  __threadfence();
  int total;
  const int start = femto::block_exclusive_sum<kThreads>(cnt, s_warp, &total);
  const int gstart =
      femto::block_exclusive_sum<kThreads>(hist[t], s_warp, &total);
  for (int w = 0; w < kWarps; ++w) s_off[w][t] += start;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    if (wbase + j * 32 + lane < m) {
      const int d = digit_of(k[j], shift, mask);
      place[j] += s_off[warp][d];
      s_x[place[j]] = k[j];
    }
  }
  // the values, requested now: the look-back hides their latency
  int v[kIt];
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const long long i = wbase + j * 32 + lane;
    v[j] = i < m ? (kIota ? static_cast<int>(i) : vals_in[i]) : 0;
  }
  // the digit's keys in the tiles before this one
  // (kLook words at once, newest first: aggregates add and go on, an
  // inclusive prefix adds and ends, a word not yet published is where the
  // next window starts; tile 0 is inclusive, so no window passes it)
  long long excl = 0;
  if (tile > 0) {
    const volatile unsigned long long* prev = status + t;
    for (long long p = tile - 1;;) {
      unsigned long long w[kLook];
#pragma unroll
      for (int q = 0; q < kLook; ++q)
        w[q] = p - q >= 0 ? prev[(p - q) * kRadix] : 0;
      int q = 0;
      bool found = false;
#pragma unroll
      for (; q < kLook; ++q) {
        if ((w[q] >> 32) < aggregate) break;
        excl += static_cast<long long>(w[q] & kCountMask);
        if ((w[q] >> 32) == inclusive) {
          found = true;
          break;
        }
      }
      if (found) break;
      p -= q;
    }
    *mine = inclusive << 32 | static_cast<unsigned long long>(excl + cnt);
    __threadfence();
  }
  s_dst[t] = static_cast<int>(gstart + excl - start);  // m < 2^31
  __syncthreads();
  // place i of the tile in digit order goes to s_dst[digit] + i; thread t
  // writes places t, t + kThreads, ...: whole digit runs, in order
  const int n_tile =
      static_cast<int>(min(static_cast<long long>(kT), m - tbase));
  int dst[kIt];
#pragma unroll
  for (int r = 0; r < kIt; ++r) {
    const int i = t + r * kThreads;
    if (i < n_tile) {
      const long long key = s_x[i];
      dst[r] = s_dst[digit_of(key, shift, mask)] + i;
      keys_out[dst[r]] = key;
    }
  }
  __syncthreads();
  int* s_v = reinterpret_cast<int*>(s_x);
#pragma unroll
  for (int j = 0; j < kIt; ++j)
    if (wbase + j * 32 + lane < m) s_v[place[j]] = v[j];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kIt; ++r) {
    const int i = t + r * kThreads;
    if (i < n_tile) vals_out[dst[r]] = s_v[i];
  }
}

// Every pass of a sort of m <= kSmallMax elements in one block's shared
// memory; the result goes to (keys_out, vals_out).
template <bool kIota>
__global__ void __launch_bounds__(kSmallThreads)
    radix_block_sort(const long long* __restrict__ keys_in,
                     const int* __restrict__ vals_in, int m, int bit_lo,
                     int bit_hi, long long* __restrict__ keys_out,
                     int* __restrict__ vals_out) {
  extern __shared__ long long smem[];
  long long* kb[2] = {smem, smem + kSmallMax};
  int* vb0 = reinterpret_cast<int*>(smem + 2 * kSmallMax);
  int* vb[2] = {vb0, vb0 + kSmallMax};
  int(*off)[kRadix] = reinterpret_cast<int(*)[kRadix]>(vb0 + 2 * kSmallMax);
  __shared__ int s_warp[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int i = t; i < m; i += kSmallThreads) {
    kb[0][i] = keys_in[i];
    vb[0][i] = kIota ? i : vals_in[i];
  }
  int cur = 0;
  for (int shift = bit_lo; shift < bit_hi; shift += 8) {
    const int mask = (1 << min(8, bit_hi - shift)) - 1;
    for (int i = t; i < kSmallWarps * kRadix; i += kSmallThreads)
      off[i / kRadix][i % kRadix] = 0;
    __syncthreads();
    const long long* kc = kb[cur];
    const int wbase = warp * (kSmallItems * 32);
    int place[kSmallItems];
#pragma unroll
    for (int j = 0; j < kSmallItems; ++j) {
      if (wbase + j * 32 >= m) break;  // the same for the whole warp
      const int i = wbase + j * 32 + lane;
      const bool ok = i < m;
      const int d = ok ? digit_of(kc[i], shift, mask) : kRadix;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader && ok) {
        before = off[warp][d];
        off[warp][d] = before + __popc(peers);
      }
      place[j] =
          __shfl_sync(0xffffffffu, before, leader) + __popc(peers & lt);
    }
    __syncthreads();
    int cnt = 0;
    if (t < kRadix) {
      for (int w = 0; w < kSmallWarps; ++w) {
        const int c = off[w][t];
        off[w][t] = cnt;
        cnt += c;
      }
    }
    int total;
    const int start =
        femto::block_exclusive_sum<kSmallThreads>(cnt, s_warp, &total);
    if (t < kRadix)
      for (int w = 0; w < kSmallWarps; ++w) off[w][t] += start;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSmallItems; ++j) {
      const int i = wbase + j * 32 + lane;
      if (i >= m) break;
      const int p = off[warp][digit_of(kc[i], shift, mask)] + place[j];
      kb[cur ^ 1][p] = kc[i];
      vb[cur ^ 1][p] = vb[cur][i];
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int i = t; i < m; i += kSmallThreads) {
    keys_out[i] = kb[cur][i];
    vals_out[i] = vb[cur][i];
  }
}

int passes_of(int bit_lo, int bit_hi) { return (bit_hi - bit_lo + 7) / 8; }

long long tile_of(long long m) { return m <= kFewMax ? kFewTile : kTile; }

template <int kIt>
void launch_pass(bool iota, long long ntiles, cudaStream_t st,
                 const long long* src_k, const int* src_v, long long m,
                 int pass, int shift, int mask, const int* hist,
                 int* counter, unsigned long long* status, long long* dst_k,
                 int* dst_v) {
  const unsigned grid = static_cast<unsigned>(ntiles);
  if (iota)
    radix_tile_pass<true, kIt><<<grid, kThreads, 0, st>>>(
        src_k, src_v, m, pass, shift, mask, hist, counter, status, dst_k,
        dst_v);
  else
    radix_tile_pass<false, kIt><<<grid, kThreads, 0, st>>>(
        src_k, src_v, m, pass, shift, mask, hist, counter, status, dst_k,
        dst_v);
}

}  // namespace

// Scratch of femto_radix_sort_pairs in int32 elements (0 on the one-block
// path): the bins and tile counters, then ntiles * 256 status words.
extern "C" long long femto_radix_sort_scratch(long long m) {
  if (m <= kOneBlockMax) return 0;
  const long long ntiles = (m + tile_of(m) - 1) / tile_of(m);
  return kHeaderInts + 2 * ntiles * kRadix;
}

// Keys a tile in a femto_radix_sort_pairs call (0 on the one-block path).
extern "C" long long femto_radix_sort_tile(long long m) {
  return m <= kOneBlockMax ? 0 : tile_of(m);
}

// Kernels one femto_radix_sort_pairs call launches.
extern "C" long long femto_radix_sort_kernels(long long m, int bit_lo,
                                              int bit_hi) {
  if (m == 0) return 0;
  return m <= kOneBlockMax ? 1 : 1 + passes_of(bit_lo, bit_hi);
}

// Sorts m (keys_in int64, vals_in int32 or null for 0..m-1) pairs by bits
// [bit_lo, bit_hi) of the key, stably, in ceil((bit_hi - bit_lo) / 8)
// passes.  Pass p reads the input (p = 0) or the buffers of pass p - 1 and
// writes (k0, v0) for even p, (k1, v1) for odd p; the input is left as it
// was and the result is in the buffers of the last pass (where the one
// block runs every pass, it writes only those).  m < 2^31; scratch as
// femto_radix_sort_scratch(m) says.
extern "C" int femto_radix_sort_pairs(const void* keys_in,
                                      const void* vals_in, void* k0, void* v0,
                                      void* k1, void* v1, long long m,
                                      int bit_lo, int bit_hi, void* scratch,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int passes = passes_of(bit_lo, bit_hi);
  const long long* src_k = static_cast<const long long*>(keys_in);
  const int* src_v = static_cast<const int*>(vals_in);
  if (m <= kOneBlockMax) {
    const bool even = (passes - 1) % 2 == 0;
    long long* dk = static_cast<long long*>(even ? k0 : k1);
    int* dv = static_cast<int*>(even ? v0 : v1);
    cudaError_t e;
    if (src_v == nullptr) {
      e = cudaFuncSetAttribute(radix_block_sort<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmallSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      radix_block_sort<true><<<1, kSmallThreads, kSmallSmem, st>>>(
          src_k, src_v, static_cast<int>(m), bit_lo, bit_hi, dk, dv);
    } else {
      e = cudaFuncSetAttribute(radix_block_sort<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmallSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      radix_block_sort<false><<<1, kSmallThreads, kSmallSmem, st>>>(
          src_k, src_v, static_cast<int>(m), bit_lo, bit_hi, dk, dv);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const long long tile = tile_of(m), ntiles = (m + tile - 1) / tile;
  int* hist = static_cast<int*>(scratch);
  int* counters = hist + kMaxPasses * kRadix;
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(hist + kHeaderInts);
  cudaError_t e = cudaMemsetAsync(
      hist, 0, sizeof(int) * (kHeaderInts + 2 * ntiles * kRadix), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long want =
      (m + kHistThreads * kHistUnroll - 1) / (kHistThreads * kHistUnroll);
  const long long hist_blocks =
      want < static_cast<long long>(sms) * kHistBlocksPerSm
          ? want
          : static_cast<long long>(sms) * kHistBlocksPerSm;
  radix_digit_hist<<<static_cast<unsigned>(hist_blocks), kHistThreads, 0,
                     st>>>(src_k, m, bit_lo, bit_hi, hist);
  int pass = 0;
  for (int shift = bit_lo; shift < bit_hi; shift += 8, ++pass) {
    const int nb = bit_hi - shift < 8 ? bit_hi - shift : 8;
    const int mask = (1 << nb) - 1;
    long long* dst_k = static_cast<long long*>(pass % 2 == 0 ? k0 : k1);
    int* dst_v = static_cast<int*>(pass % 2 == 0 ? v0 : v1);
    (tile == kTile ? launch_pass<kItems> : launch_pass<kFewItems>)(
        src_v == nullptr, ntiles, st, src_k, src_v, m, pass, shift, mask,
        hist + pass * kRadix, counters + pass, status, dst_k, dst_v);
    src_k = dst_k;
    src_v = dst_v;
  }
  return static_cast<int>(cudaGetLastError());
}
