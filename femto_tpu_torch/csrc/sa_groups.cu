// Kernel I, group_flags and tied_compact: the groups of equal keys after a
// sort and the compaction of the slots that are still tied.
//
// Replaces (femto_tpu/suffix.py): the flag part of _sort3 (157-163),
// _compact_select (167) with ops/build_ops.py _mark_rank_select (962),
// _init_base (189), _compact_slots (342), _unresolved_of (352) and the
// keep / compact tail of the round functions (229-240, 331-338).  The TPU
// found the tied slots by a rank-select over a bitmap and the group bases
// by a cummax because scatters were its slow path; on the card both are one
// stream compaction: a count per tile, one block over the tiles, and a
// write pass in which every element learns its output position (a sum
// scan of the tied flags) and its group's first element (a max scan of the
// flagged indices) from block-wide scans plus the tile's carry.
//
// An element i of the m sorted ones is tied when its group has more than
// one element: not (flags[i] and flags[i + 1]), with flags[m] taken as set.
// Its group base is slots[g] for the last flagged g <= i (g itself when
// slots is null: the first sort, where element i sits in slot i).
//
// Bound on the H100 (3.35 TB/s): bytes.  group_flags reads 8m and writes m;
// tied_compact reads the flags (m) and the slots (4m) and writes 8 bytes
// per tied element (and 4m for base_all): at most 0.7 ms at m = 2^28.
// This design reads the flags twice (count pass, write pass).
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // elements per block
constexpr int kTopThreads = 1024;         // the one block over the tiles

__global__ void group_flags_kernel(const long long* __restrict__ keys,
                                   long long m,
                                   unsigned char* __restrict__ flags) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  flags[i] = (i == 0 || keys[i] != keys[i - 1]) ? 1 : 0;
}

// A thread's kItems consecutive elements start at b: bit j of `tied` for
// element b + j, and the last flagged index among them (-1 if none).
__device__ __forceinline__ void scan_items(
    const unsigned char* __restrict__ flags, long long m, long long b,
    unsigned* tied, int* last_flag, unsigned* flag_bits) {
  unsigned tb = 0, fb = 0;
  int last = -1;
  bool cur = b < m ? flags[b] != 0 : true;
  for (int j = 0; j < kItems; ++j) {
    const long long i = b + j;
    if (i >= m) break;
    const bool nxt = i + 1 < m ? flags[i + 1] != 0 : true;
    if (cur) {
      fb |= 1u << j;
      last = static_cast<int>(i);
    }
    if (!(cur && nxt)) tb |= 1u << j;
    cur = nxt;
  }
  *tied = tb;
  *last_flag = last;
  *flag_bits = fb;
}

// Pass 1: per tile, the number of tied elements and the last flagged index.
__global__ void tied_tile_kernel(const unsigned char* __restrict__ flags,
                                 long long m, int* __restrict__ tile_cnt,
                                 int* __restrict__ tile_last) {
  __shared__ int warp_vals[32];
  const long long b = static_cast<long long>(blockIdx.x) * kTile +
                      static_cast<long long>(threadIdx.x) * kItems;
  unsigned tied, fb;
  int last;
  scan_items(flags, m, b, &tied, &last, &fb);
  int total_cnt, total_last;
  femto::block_exclusive_sum<kThreads>(__popc(tied), warp_vals, &total_cnt);
  femto::block_exclusive_max<kThreads>(last, -1, warp_vals, &total_last);
  if (threadIdx.x == 0) {
    tile_cnt[blockIdx.x] = total_cnt;
    tile_last[blockIdx.x] = total_last;
  }
}

// Pass 2 (one block): tile_cnt -> its exclusive sums, tile_last -> the last
// flagged index before each tile, count[0] = the number of tied elements.
__global__ void tied_top_kernel(int* __restrict__ tile_cnt,
                                int* __restrict__ tile_last, long long ntiles,
                                int* __restrict__ count) {
  __shared__ int warp_vals[32];
  const long long chunk = (ntiles + kTopThreads - 1) / kTopThreads;
  const long long b = threadIdx.x * chunk;
  const long long e = min(b + chunk, ntiles);
  int s = 0, mx = -1;
  for (long long i = b; i < e; ++i) {
    s += tile_cnt[i];
    mx = max(mx, tile_last[i]);
  }
  int total, total_mx;
  int run = femto::block_exclusive_sum<kTopThreads>(s, warp_vals, &total);
  int carry =
      femto::block_exclusive_max<kTopThreads>(mx, -1, warp_vals, &total_mx);
  for (long long i = b; i < e; ++i) {
    const int c = tile_cnt[i], l = tile_last[i];
    tile_cnt[i] = run;
    tile_last[i] = carry;
    run += c;
    carry = max(carry, l);
  }
  if (threadIdx.x == 0) count[0] = total;
}

// Pass 3: write the tied elements' slots and group bases in order, and
// (base_all not null) every element's group base.
__global__ void tied_write_kernel(const unsigned char* __restrict__ flags,
                                  const int* __restrict__ slots, long long m,
                                  const int* __restrict__ tile_off,
                                  const int* __restrict__ tile_carry,
                                  int* __restrict__ slots_next,
                                  int* __restrict__ base_next,
                                  int* __restrict__ base_all) {
  __shared__ int warp_vals[32];
  const long long b = static_cast<long long>(blockIdx.x) * kTile +
                      static_cast<long long>(threadIdx.x) * kItems;
  unsigned tied, fb;
  int last;
  scan_items(flags, m, b, &tied, &last, &fb);
  int total;
  int o = tile_off[blockIdx.x] + femto::block_exclusive_sum<kThreads>(
                                     __popc(tied), warp_vals, &total);
  int g = max(tile_carry[blockIdx.x], femto::block_exclusive_max<kThreads>(
                                          last, -1, warp_vals, &total));
  for (int j = 0; j < kItems; ++j) {
    const long long i = b + j;
    if (i >= m) break;
    if (fb & (1u << j)) g = static_cast<int>(i);
    const bool t = (tied >> j) & 1u;
    if (!t && !base_all) continue;
    const int base = slots ? slots[g] : g;
    if (base_all) base_all[i] = base;
    if (t) {
      slots_next[o] = slots ? slots[i] : static_cast<int>(i);
      base_next[o] = base;
      ++o;
    }
  }
}

}  // namespace

// keys int64[m] sorted -> flags uint8[m]: 1 where a group of equal keys
// starts (flags[0] is set).
extern "C" int femto_group_flags(const void* keys, long long m, void* flags,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  group_flags_kernel<<<static_cast<unsigned>((m + 255) / 256), 256, 0, st>>>(
      static_cast<const long long*>(keys), m,
      static_cast<unsigned char*>(flags));
  return static_cast<int>(cudaGetLastError());
}

// flags uint8[m], slots int32[m] or null (element i sits in slot i).
// phase 0: count[0] = the number of tied elements; tile_cnt and tile_last
// (int32[ceil(m / 2048)] each) are left for phase 1.  phase 1: slots_next,
// base_next int32[count] = slot and group base slot of each tied element,
// ascending; base_all int32[m] or null = every element's group base slot.
extern "C" int femto_tied_compact(const void* flags, const void* slots,
                                  long long m, int phase, void* tile_cnt,
                                  void* tile_last, void* count,
                                  void* slots_next, void* base_next,
                                  void* base_all, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntiles = (m + kTile - 1) / kTile;
  const unsigned char* f = static_cast<const unsigned char*>(flags);
  if (phase == 0) {
    tied_tile_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, st>>>(
        f, m, static_cast<int*>(tile_cnt), static_cast<int*>(tile_last));
    tied_top_kernel<<<1, kTopThreads, 0, st>>>(
        static_cast<int*>(tile_cnt), static_cast<int*>(tile_last), ntiles,
        static_cast<int*>(count));
  } else {
    tied_write_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, st>>>(
        f, static_cast<const int*>(slots), m,
        static_cast<const int*>(tile_cnt), static_cast<const int*>(tile_last),
        static_cast<int*>(slots_next), static_cast<int*>(base_next),
        static_cast<int*>(base_all));
  }
  return static_cast<int>(cudaGetLastError());
}
