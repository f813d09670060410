// Kernel K18c (and K18d's per-shard steps), the sharded suffix sort's
// bodies: seed_keys, payload_block, mesh_flags, mesh_scan, compact_rows
// and fetch_owned.
//
// Replaces (femto_tpu/parallel/dist_build.py):
//   seed_keys      _seed_keys (216): the dense monotone remap and the
//                  packed 30-bit keys of every suffix over the block's
//                  right halo (the halo itself is the mesh's ppermute);
//   payload_block  _payload_block (247) with _aux_local_block (96): the
//                  previous symbol | the mark bit and SEOF doc tag << 9;
//   mesh_flags     the adjacent-diff of sorted key tuples against the
//                  previous shard's last key: _seed_sort_body's group
//                  starts (280), _rank_refine's diff (127), and on one
//                  replicated shard _rep_extend_body's / _rep_double_body's
//                  (344, 411);
//   mesh_scan      the cumsum and cummax scans: _group_state's base (195),
//                  _rank_refine's local_cum (148), the epilogue's
//                  new_base (431);
//   compact_rows   _rep_compact_body's bitmap rank-select at a
//                  cross-shard offset (305) and the epilogue's compaction
//                  of the survivors (cpos and tgt, 431-447): it ranks its
//                  own flags (the psum that merges shards is the mesh's);
//   fetch_owned    each shard's part of the psum fetches: _rep_extend_body's
//                  next T packed words, _rep_double_body's rank[pos + k],
//                  _pull_fix_body's sa[slot] and payload[pos] (478).
// The compact's slot order, the extension's sort and the write-backs are
// kernels H, L and K18a's owner_place.  The shard dimension is blockIdx.y.
//
// mesh_flags takes 16 consecutive elements a thread, templated on the key
// count (its column loop unrolled, no parameter indexed at run time): a
// column's keys in four 16-byte loads, the key before the first from the
// lane before by a shuffle, the 16 flags one 16-byte store.
//
// mesh_scan and compact_rows are one launch a call each, a single pass
// over tiles with a decoupled look-back (csrc/fm_common.cuh
// warp_lookback; the tile numbers from an atomic counter a shard, as in
// kernel H's radix_tile_pass and K18a's bucket_pack_tile): the flags are
// read once in 16-byte loads; mesh_scan's out is staged a warp at a time
// in shared memory and written once in 16-byte stores; compact_rows maps
// each of a tile's places to its kept slot in shared memory and copies
// every column (up to kMaxCols a launch) from slot to place, reading only
// the kept slots, neighbouring threads on neighbouring words, and fills
// every place no slot takes inside the same launch, each once (no memset
// of its outputs).
//
// Bound on the H100 (3.35 TB/s): bytes.  seed_keys reads the block and
// halo once (the lut stays in L1) and writes nkeys ints per symbol;
// payload_block reads the block and writes one int per symbol (the doc
// starts are a binary search in L2); mesh_flags reads nk keys and writes
// one byte; mesh_scan reads the flags (and the flagged slots) once and
// writes one int per element; compact_rows reads the flags and its kept
// slots' columns once and writes each of its M places a column once;
// fetch_owned moves the records it fetches.  The scans' scratch is 8
// bytes a tile (16,384 flags in mesh_scan, 8,192 in compact_rows).
#include "fm_common.cuh"

namespace {

constexpr int kFlagKeys = 6;
constexpr int kMaxCols = 8;                        // compact_rows' columns
// mesh_scan's and compact_rows' tiles: threads a block and rounds of 16
// flags a lane (a tile is threads x 16 x rounds flags), and the places a
// compact_rows thread copies at once; set on the H100 from a sweep of
// these and of longer look-back windows, pauses in the look-back and
// blocks that stay resident over many tiles (none of which helped).
constexpr int kScanThreads = 256;
constexpr int kScanRounds = 4;
constexpr int kScanTile = kScanThreads * 16 * kScanRounds;
constexpr int kCompactThreads = 128;
constexpr int kCompactRounds = 4;
constexpr int kCompactTile = kCompactThreads * 16 * kCompactRounds;
constexpr int kCompactBlocks = 8;  // resident blocks an SM asked of ptxas
constexpr int kU = 8;
constexpr int kIntMin = -2147483647 - 1;

// mesh_flags' threads a block (16 elements a thread)
constexpr int kFlagThreads = 256;

// mesh_flags' key columns (or their previous-shard keys), one pointer a
// column: NK is a template argument, so the column loop unrolls and no
// parameter is indexed at run time.
template <int NK>
struct KeyCols {
  const int* p[NK];
};

struct CompactCols {
  const int* in[kMaxCols];  // null: the slot's global index
  int* out[kMaxCols];
  int fill[kMaxCols];
};

__global__ void seed_keys_kernel(const int* __restrict__ text_ext,
                                 long long Lx, long long m, int shard0,
                                 long long n, long long n_pad,
                                 const int* __restrict__ lut, int per_key,
                                 int bits, int nkeys, int* k0, int* k1,
                                 int* k2) {
  const int d = blockIdx.y;
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= m) return;
  const long long g0 = static_cast<long long>(shard0 + d) * m;
  const int* te = text_ext + d * Lx;
  int* outs[3] = {k0, k1, k2};
  for (int q = 0; q < nkeys; ++q) {
    const long long j0 = p + static_cast<long long>(q) * per_key;
    int key;
    if (g0 + j0 >= n) {
      // a window from a position past the real text: its distinct
      // negative, below every real key, shorter suffixes first
      key = static_cast<int>(-1 - (g0 + j0));
    } else {
      unsigned acc = 0;
      for (int t = 0; t < per_key; ++t) {
        const long long j = j0 + t;
        const int c = g0 + j < n_pad ? __ldg(lut + (te[j] & 511)) : 0;
        acc |= static_cast<unsigned>(c) << ((per_key - 1 - t) * bits);
      }
      key = static_cast<int>(acc);
    }
    outs[q][d * m + p] = key;
  }
}

// First index in a[0, n) whose value is >= x (a ascending).
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void payload_block_kernel(const int* __restrict__ text,
                                     const int* __restrict__ prev_last,
                                     long long m, int shard0, long long n,
                                     const int* __restrict__ ds, int ndocs,
                                     int period, int* __restrict__ out) {
  const int d = blockIdx.y;
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= m) return;
  const long long gidx = static_cast<long long>(shard0 + d) * m + p;
  int aux = 0;
  if (gidx < n) {
    const int i = lower_bound(ds, ndocs, gidx);
    const bool is_start = i < ndocs && __ldg(ds + i) == gidx;
    // doc j - 1's SEOF sits at ds[j] - 1: tag j
    const int j = 1 + lower_bound(ds + 1, ndocs, gidx + 1);
    const int tag = (j <= ndocs && __ldg(ds + j) == gidx + 1) ? j : 0;
    const bool marked =
        period > 0 && (is_start || tag > 0 || gidx % period == 0);
    aux = (marked ? 1 : 0) | (tag << 1);
  }
  const int tp = p > 0 ? text[d * m + p - 1] : prev_last[d];
  out[d * m + p] = tp | (aux << 9);
}

// mesh_scan and compact_rows: one tile pass each.  A tile is kT * 16 kV
// flags of one shard, its number from the shard's atomic counter, its
// flags warp-striped: warp w holds the tile's elements [w kV 512, (w + 1)
// kV 512) in kV rounds of 512, lane l's 16 of round r one 16-byte load
// from w kV 512 + 512 r + 16 l, so that a warp's loads and stores of a
// round are 512 consecutive elements.  The tiles are aligned to the
// flags: tile k of shard d covers the row's elements [k tile - fmis, (k +
// 1) tile - fmis), fmis the row's start address mod 16, so each load is
// of the aligned 16 bytes that hold a lane's flags (bytes outside the row
// lie in the same 16-byte chunk of the row's allocation and are masked
// off).  A lane's flags, kept counts and prefixes are a few registers a
// round: the scan's values are made again from them where they are
// written.

// Bit j set where element e + j lies in [0, m) (j < 16).
__device__ __forceinline__ unsigned in_row(long long e, long long m) {
  if (e >= m || e + 16 <= 0) return 0;
  unsigned b = 0xffffu;
  if (e < 0) b &= 0xffffu << (-e);
  if (e + 16 > m) b &= (1u << (m - e)) - 1u;
  return b;
}

// mesh_flags: a thread takes 16 consecutive elements e .. e + 15 of one
// row of m (blockIdx.y), e aligned to the row's flags (e = 16 t - omis,
// omis the row's start address mod 16, as the scan's tiles are), so its
// 16 flags are one 16-byte store; a thread whose 16 lie partly outside
// the row stores its in-row flags a byte each.  A column's 16 keys are
// four 16-byte loads where the thread's first key is 16-byte aligned and
// all 16 lie in the row, else a load an element.  The key before element
// e comes from the lane before (its last), by one load at a warp's first
// lane, and from prev[d] at the row's start; the global slot 0 takes
// `first`.
// 1 where a != b, else 0, by integer arithmetic: nvcc 12.9's predicate
// packing dropped bits 0 and 1 of the second key column's mask when the
// 16 flags were ORed as comparisons (seen on the H100)
__device__ __forceinline__ unsigned differs(int a, int b) {
  const unsigned x = static_cast<unsigned>(a ^ b);
  return (x | (0u - x)) >> 31;
}

template <int NK>
__global__ void __launch_bounds__(kFlagThreads) mesh_flags_kernel(
    KeyCols<NK> k, KeyCols<NK> prev, long long m, int shard0, int first,
    unsigned char* __restrict__ out) {
  const int d = blockIdx.y;
  const int lane = threadIdx.x & 31;
  unsigned char* orow = out + d * m;
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 16 -
      static_cast<long long>(reinterpret_cast<uintptr_t>(orow) & 15);
  const unsigned live = in_row(e, m);
  unsigned neq = 0;
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    const int* row = k.p[c] + d * m;
    int v[16];
    if (live == 0xffffu &&
        (reinterpret_cast<uintptr_t>(row + e) & 15) == 0) {
      const int4* q = reinterpret_cast<const int4*>(row + e);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int4 x = __ldg(q + i);
        v[4 * i] = x.x;
        v[4 * i + 1] = x.y;
        v[4 * i + 2] = x.z;
        v[4 * i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = live >> j & 1u ? __ldg(row + e + j) : 0;
    }
    // the key before element e: the lane before's last; a warp's first
    // lane loads it (a thread whose e is 0 or less reads prev[d] below)
    int before = __shfl_up_sync(femto::kAllLanes, v[15], 1);
    if (lane == 0 && e > 0 && e <= m) before = __ldg(row + e - 1);
    const int pv = e <= 0 ? __ldg(prev.p[c] + d) : 0;
    neq |= differs(v[0], e == 0 ? pv : before);
#pragma unroll
    for (int j = 1; j < 16; ++j)
      neq |= differs(v[j], e + j == 0 ? pv : v[j - 1]) << j;
  }
  if (shard0 + d == 0 && e <= 0 && e + 16 > 0) {
    const unsigned bit = 1u << static_cast<int>(-e);
    neq = first ? neq | bit : neq & ~bit;
  }
  neq &= live;
  if (live == 0xffffu) {
    // bit j to byte j: a nibble's four bits to four bytes by one multiply
    const auto bytes4 = [](unsigned x) {
      return ((x & 15u) * 0x00204081u) & 0x01010101u;
    };
    *reinterpret_cast<uint4*>(orow + e) = make_uint4(
        bytes4(neq), bytes4(neq >> 4), bytes4(neq >> 8), bytes4(neq >> 12));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (live >> j & 1u)
        orow[e + j] = static_cast<unsigned char>(neq >> j & 1u);
  }
}

template <int NK>
void launch_mesh_flags(const void* const* keys, const void* const* prev,
                       long long m, int Dl, int shard0, int first,
                       unsigned char* out, cudaStream_t st) {
  KeyCols<NK> k, p;
  for (int c = 0; c < NK; ++c) {
    k.p[c] = static_cast<const int*>(keys[c]);
    p.p[c] = static_cast<const int*>(prev[c]);
  }
  // a thread more than m / 16 for the rows whose flags start off 16
  const long long threads = (m + 15) / 16 + 1;
  mesh_flags_kernel<NK>
      <<<dim3(static_cast<unsigned>((threads + kFlagThreads - 1) /
                                    kFlagThreads),
              Dl),
         kFlagThreads, 0, st>>>(k, p, m, shard0, first, out);
}

// A lane's 16 flags from element e of a row of m: bit j is element e + j's
// flag != 0 (0 outside [0, m)).  frow + e is 16-byte aligned.
__device__ __forceinline__ unsigned load16(const unsigned char* frow,
                                           long long e, long long m) {
  if (e >= m || e + 16 <= 0) return 0;
  const uint4 w = *reinterpret_cast<const uint4*>(frow + e);
  const unsigned ws[4] = {w.x, w.y, w.z, w.w};
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    bits |= ((ws[j >> 2] >> (8 * (j & 3)) & 0xffu) ? 1u : 0u) << j;
  return bits & in_row(e, m);
}

// The tile's number from shard blockIdx.y's counter (every thread).
__device__ __forceinline__ long long next_tile(int* counters,
                                               long long* s_tile) {
  if (threadIdx.x == 0) *s_tile = atomicAdd(counters + blockIdx.y, 1);
  __syncthreads();
  return *s_tile;
}

// The tile's first element in its row (frow: the row's flags).
__device__ __forceinline__ long long tile_start(const unsigned char* frow,
                                                long long tile, int tile_n) {
  return tile * tile_n -
         static_cast<long long>(reinterpret_cast<uintptr_t>(frow) & 15);
}

// The inclusive scan of v over the warp's lanes.
template <bool kMax>
__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = femto::lb_op<kMax>(v, y);
  }
  return v;
}

// The combination, over the lane's 16 elements from e, of mesh_scan's
// values: the flag (sum), or flag ? slot : 0 (max; none outside the row).
template <bool kMax>
__device__ __forceinline__ int lane_total(unsigned bits, long long e,
                                          long long m, const int* srow,
                                          long long g0, int none) {
  if (!kMax) return __popc(bits);
  int a = (in_row(e, m) & ~bits) ? 0 : none;
  if (bits == 0) return a;
  if (srow == nullptr)
    return max(a, static_cast<int>(g0 + e + 31 - __clz(bits)));
  for (unsigned b = bits; b; b &= b - 1) a = max(a, srow[e + __ffs(b) - 1]);
  return a;
}

// The inclusive scan of one tile (kMax: cummax of flag ? slot : 0, else
// the count of flags), its carry from the look-back.  A round's 512
// results of a warp are staged in shared memory, a lane's quad k at lane
// 4 + (k ^ (lane >> 1 & 3)): a phase of 8 lanes touches 8 distinct 16-byte
// banks both when the lanes write their quads and when they read the
// round's quads in order; then stored as quads of consecutive elements,
// 16-byte stores where the row's out is aligned as its flags are (the
// flags' address 4-byte aligned), else one element at a time.  With
// slots, a lane reads its flagged slots twice (the second time from the
// cache): for the tile's total, then for each element's value.
template <bool kMax, int kT, int kV>
__global__ void __launch_bounds__(kT)
    mesh_scan_tile(const unsigned char* __restrict__ flags,
                   const int* __restrict__ slots, long long m, int shard0,
                   long long n_tiles, int* __restrict__ out,
                   int* __restrict__ last, int* __restrict__ counters,
                   unsigned long long* __restrict__ status) {
  constexpr int kW = kT / 32, kTile = kT * 16 * kV;
  __shared__ __align__(16) int4 stage[kW][128];
  __shared__ int warp_vals[kW];
  __shared__ long long s_tile;
  __shared__ int s_excl;
  constexpr int none = kMax ? kIntMin : 0;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, d = blockIdx.y;
  const long long tile = next_tile(counters, &s_tile);
  const long long row = static_cast<long long>(d) * m;
  const unsigned char* frow = flags + row;
  const int* srow = slots ? slots + row : nullptr;
  const long long w0 = tile_start(frow, tile, kTile) + warp * (512 * kV);
  const long long g0 = static_cast<long long>(shard0 + d) * m;
  unsigned bits[kV];
  int before[kV];  // the warp's values before the lane's 16 of round r
  int wtot = none;
#pragma unroll
  for (int r = 0; r < kV; ++r) {
    const long long e = w0 + 512 * r + 16 * lane;
    bits[r] = load16(frow, e, m);
    const int inc =
        warp_inclusive<kMax>(lane_total<kMax>(bits[r], e, m, srow, g0, none));
    const int ex = __shfl_up_sync(0xffffffffu, inc, 1);
    before[r] = lane == 0 ? wtot : femto::lb_op<kMax>(wtot, ex);
    wtot = femto::lb_op<kMax>(wtot, __shfl_sync(0xffffffffu, inc, 31));
  }
  if (lane == 0) warp_vals[warp] = wtot;
  __syncthreads();
  int wpre = none, total = none;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int x = warp_vals[w];
    if (w < warp) wpre = femto::lb_op<kMax>(wpre, x);
    total = femto::lb_op<kMax>(total, x);
  }
  if (warp == 0) {
    const int ex = femto::warp_lookback<kMax>(
        status + d * n_tiles, tile, total, none);
    if (lane == 0) s_excl = ex;
  }
  __syncthreads();
  const int carry = femto::lb_op<kMax>(s_excl, wpre);
  int* orow = out + row;
  const bool vec = (reinterpret_cast<uintptr_t>(orow + w0) & 15) == 0;
  int4* sq = stage[warp];
  const int swz = lane >> 1 & 3;
#pragma unroll
  for (int r = 0; r < kV; ++r) {
    const long long e = w0 + 512 * r + 16 * lane;
    const unsigned in = in_row(e, m);
    int run = femto::lb_op<kMax>(carry, before[r]);
    int v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool f = bits[r] >> j & 1u;
      if (!kMax)
        run += f;
      else if (in >> j & 1u)
        run = max(run, !f ? 0 : srow ? srow[e + j]
                                     : static_cast<int>(g0 + e + j));
      v[j] = run;
      if (e + j == m - 1) last[d] = run;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sq[lane * 4 + (k ^ swz)] =
          make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = lane + 32 * i;  // the round's quad j: elements 4j ..
      const int4 q = sq[(j >> 2) * 4 + ((j & 3) ^ (j >> 3 & 3))];
      const long long eq = w0 + 512 * r + 4 * j;
      if (vec && eq >= 0 && eq + 4 <= m) {
        *reinterpret_cast<int4*>(orow + eq) = q;
      } else {
        const int qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int h = 0; h < 4; ++h)
          if (eq + h >= 0 && eq + h < m) orow[eq + h] = qs[h];
      }
    }
    __syncwarp();
  }
}

// One tile of shard blockIdx.y: its kept slots go, in order, to places
// off[d] + excl .. (excl: the kept slots of the tiles before, from the
// look-back).  The tile first maps each of its places to its slot
// (src_of, in shared memory); then thread t copies places t, t + kT, ...
// of every column straight from the slot to the place (or writes the
// slot's global index), so that neighbouring threads read and write
// neighbouring words within a run of kept slots and a thread's loads of
// all columns are in flight together.  The places below M that no slot
// takes get the column's fill, each written once by one tile: [0, off[d])
// split evenly over the tiles, and after the records bucket_pack_tile's
// rule (csrc/exchange.cu): with `after` slots after this tile, the
// shard's total is at most excl + cnt + after, so the tile fills [off +
// excl + cnt + after, off + excl + n + after) (n: its slots in the row;
// tile 0 up to M), clipped to M.  Over the tiles these ranges are [off +
// total, M), and no tile waits for the last one.  The column loops are
// unrolled over kMaxCols: a parameter indexed by a variable would be
// copied to local memory.
template <int kT, int kV>
__global__ void __launch_bounds__(kT, kCompactBlocks)
    compact_rows_tile(const unsigned char* __restrict__ flags,
                      const int* __restrict__ off, long long m, int shard0,
                      long long M, long long n_tiles, int ncols,
                      CompactCols cols, int* __restrict__ counters,
                      unsigned long long* __restrict__ status) {
  constexpr int kW = kT / 32, kTile = kT * 16 * kV;
  static_assert(kTile <= 65536, "a slot's place in 16 bits");
  __shared__ unsigned short src_of[kTile];  // each place's slot
  __shared__ unsigned s_bits[kTile / 16];   // each lane's flags a round
  __shared__ int s_place[kTile / 16];       // and its first place
  __shared__ int warp_vals[kW];
  __shared__ long long s_tile;
  __shared__ int s_excl;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, d = blockIdx.y;
  const long long tile = next_tile(counters, &s_tile);
  const long long row = static_cast<long long>(d) * m;
  const unsigned char* frow = flags + row;
  const long long t0 = tile_start(frow, tile, kTile);
  const int wbase = warp * (512 * kV);  // the warp's first slot
  unsigned bits[kV];
  int before[kV];  // the warp's kept slots before the lane's of round r
  int wtot = 0;
#pragma unroll
  for (int r = 0; r < kV; ++r) {
    bits[r] = load16(frow, t0 + wbase + 512 * r + 16 * lane, m);
    const int c = __popc(bits[r]);
    const int inc = warp_inclusive<false>(c);
    before[r] = wtot + inc - c;
    wtot += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) warp_vals[warp] = wtot;
  __syncthreads();
  int wpre = 0, cnt = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int v = warp_vals[w];
    if (w < warp) wpre += v;
    cnt += v;
  }
#pragma unroll
  for (int r = 0; r < kV; ++r) {
    s_bits[(warp * kV + r) * 32 + lane] = bits[r];
    s_place[(warp * kV + r) * 32 + lane] = wpre + before[r];
  }
  if (warp == 0) {
    const int ex = femto::warp_lookback<false>(
        status + d * n_tiles, tile, cnt, 0);
    if (lane == 0) s_excl = ex;
  }
  __syncthreads();
  // the map: the lanes take a round's slots k = 32 j + lane, each kept
  // one's place from its owner lane's (k / 16) flags and first place
#pragma unroll
  for (int r = 0; r < kV; ++r) {
    const int base = (warp * kV + r) * 32;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = 32 * j + lane, o = k >> 4, jj = k & 15;
      const unsigned b = s_bits[base + o];
      if (b >> jj & 1u)
        src_of[s_place[base + o] + __popc(b & ((1u << jj) - 1u))] =
            static_cast<unsigned short>(wbase + 512 * r + k);
    }
  }
  __syncthreads();
  const long long o = off[d];
  const long long p0 = o + s_excl;  // the tile's first place
  const int nst =
      static_cast<int>(max(0LL, min(static_cast<long long>(cnt), M - p0)));
  // the tile's first slot's global index (< 2^31: the slots of a mesh)
  const int g0 = static_cast<int>(static_cast<long long>(shard0 + d) * m +
                                  t0);
  const long long src0 = row + t0;
  const long long dst0 = d * M + p0;
  // kU places a thread at once: their slots, then each column's values
  // (loads in flight together), then its stores
  for (int q0 = t; q0 < nst; q0 += kT * kU) {
    int e[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + kT * u;
      e[u] = q < nst ? src_of[q] : -1;
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c >= ncols) break;
      const int* in = cols.in[c] ? cols.in[c] + src0 : nullptr;
      int* out = cols.out[c] + dst0 + q0;
      int v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        v[u] = e[u] < 0 ? 0 : in ? in[e[u]] : g0 + e[u];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (e[u] >= 0) out[kT * u] = v[u];
    }
  }
  const long long t1 = min(t0 + kTile, m);  // past the tile's last slot
  const long long n = max(0LL, t1 - max(t0, 0LL));
  const long long after = max(0LL, m - t1);
  const long long head = min(o, M);
  const long long h0 = head * tile / n_tiles;
  const long long h1 = head * (tile + 1) / n_tiles;
  const long long zlo = min(p0 + cnt + after, M);
  const long long zhi = tile == 0 ? M : min(p0 + n + after, M);
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < ncols) {
      femto::fill_range(cols.out[c] + d * M, h0, h1, cols.fill[c], t, kT);
      femto::fill_range(cols.out[c] + d * M, zlo, zhi, cols.fill[c], t,
                        kT);
    }
  }
}

__global__ void fetch_owned_kernel(const int* __restrict__ src, long long m,
                                   int shard0, const int* __restrict__ idx,
                                   const unsigned char* __restrict__ valid,
                                   long long M, long long add, int T,
                                   long long stride, int* __restrict__ out) {
  const int d = blockIdx.y;
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= M) return;
  const bool ok = !valid || valid[k];
  const long long base = static_cast<long long>(idx[k]) + add -
                         static_cast<long long>(shard0 + d) * m;
  for (int t = 0; t < T; ++t) {
    const long long lq = base + t * stride;
    int v = 0;
    if (ok && lq >= 0 && lq < m) v = src[d * m + lq];
    out[(static_cast<long long>(d) * T + t) * M + k] = v;
  }
}

unsigned blocks(long long n) { return static_cast<unsigned>((n + 255) / 256); }

// Tiles of tile_n flags over shards of m flags (the row's start may need
// one more than m / tile_n; at least one).
long long tiles_of(long long m, int tile_n) {
  return (m + 15 + tile_n - 1) / tile_n;
}

// the counters (one a shard), padded so that the status words are 8-byte
// aligned
long long header_ints(int Dl) { return 2LL * ((Dl + 1) / 2); }

// scratch (one memset a call) -> counters and status words
void scan_scratch_parts(void* scratch, int Dl, int** counters,
                        unsigned long long** status) {
  *counters = static_cast<int*>(scratch);
  *status = reinterpret_cast<unsigned long long*>(*counters +
                                                  header_ints(Dl));
}

}  // namespace

// text_ext int32[Dl, Lx] (block + halo), lut int32[512] -> nkeys keys
// int32[Dl, m] (k1, k2 null past nkeys).
extern "C" int femto_seed_keys(const void* text_ext, long long Lx, long long m,
                               int Dl, int shard0, long long n,
                               long long n_pad, const void* lut, int per_key,
                               int bits, int nkeys, void* k0, void* k1,
                               void* k2, void* stream) {
  if (nkeys < 1 || nkeys > 3 || per_key * bits > 30 || Dl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  seed_keys_kernel<<<dim3(blocks(m), Dl), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(text_ext), Lx, m, shard0, n, n_pad,
      static_cast<const int*>(lut), per_key, bits, nkeys,
      static_cast<int*>(k0), static_cast<int*>(k1), static_cast<int*>(k2));
  return static_cast<int>(cudaGetLastError());
}

// text int32[Dl, m], prev_last int32[Dl], doc_starts int32[ndocs + 1] ->
// payload int32[Dl, m].
extern "C" int femto_payload_block(const void* text, const void* prev_last,
                                   long long m, int Dl, int shard0,
                                   long long n, const void* ds, int ndocs,
                                   int period, void* out, void* stream) {
  payload_block_kernel<<<dim3(blocks(m), Dl), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(text), static_cast<const int*>(prev_last), m,
      shard0, n, static_cast<const int*>(ds), ndocs, period,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// nk keys int32[Dl, m], prev int32[Dl] each -> uint8[Dl, m].
extern "C" int femto_mesh_flags(const void* k0, const void* k1,
                                const void* k2, const void* k3,
                                const void* k4, const void* k5, int nk,
                                const void* p0, const void* p1,
                                const void* p2, const void* p3,
                                const void* p4, const void* p5, long long m,
                                int Dl, int shard0, int first, void* out,
                                void* stream) {
  if (nk < 1 || nk > kFlagKeys || Dl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* keys[kFlagKeys] = {k0, k1, k2, k3, k4, k5};
  const void* prev[kFlagKeys] = {p0, p1, p2, p3, p4, p5};
  using Launch = void (*)(const void* const*, const void* const*, long long,
                         int, int, int, unsigned char*, cudaStream_t);
  static const Launch by_nk[kFlagKeys] = {
      launch_mesh_flags<1>, launch_mesh_flags<2>, launch_mesh_flags<3>,
      launch_mesh_flags<4>, launch_mesh_flags<5>, launch_mesh_flags<6>};
  by_nk[nk - 1](keys, prev, m, Dl, shard0, first,
                static_cast<unsigned char*>(out),
                static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}


// Flags a tile of femto_mesh_scan (compact 0) or femto_compact_rows
// (compact 1): not a size.
extern "C" long long femto_scan_tile(int compact) {
  return compact ? kCompactTile : kScanTile;
}

// Scratch of femto_mesh_scan and femto_compact_rows over Dl shards of m
// flags, in int32 elements, a multiple of 4: a tile counter a shard, then
// a status word a tile.
extern "C" long long femto_scan_scratch(long long m, int Dl) {
  const long long n = max(tiles_of(m, kScanTile), tiles_of(m, kCompactTile));
  return (header_ints(Dl) + 2LL * Dl * n + 3) / 4 * 4;
}

// flags uint8[Dl, m], slots int32[Dl, m] or null -> out int32[Dl, m],
// last int32[Dl]; scratch as femto_scan_scratch says, zeroed here by one
// cudaMemsetAsync.  One kernel a call.
extern "C" int femto_mesh_scan(const void* flags, const void* slots,
                               long long m, int Dl, int shard0, int mode,
                               void* out, void* last, void* scratch,
                               void* stream) {
  if (m < 1 || Dl < 1 || (mode != 0 && mode != 1) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, 4 * femto_scan_scratch(m, Dl), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* counters;
  unsigned long long* status;
  scan_scratch_parts(scratch, Dl, &counters, &status);
  const long long n_tiles = tiles_of(m, kScanTile);
  const dim3 grid(static_cast<unsigned>(n_tiles), Dl);
  const unsigned char* f = static_cast<const unsigned char*>(flags);
  const int* s = static_cast<const int*>(slots);
  if (mode == 0)
    mesh_scan_tile<false, kScanThreads, kScanRounds>
        <<<grid, kScanThreads, 0, st>>>(f, s, m, shard0, n_tiles,
                                        static_cast<int*>(out),
                                        static_cast<int*>(last), counters,
                                        status);
  else
    mesh_scan_tile<true, kScanThreads, kScanRounds>
        <<<grid, kScanThreads, 0, st>>>(f, s, m, shard0, n_tiles,
                                        static_cast<int*>(out),
                                        static_cast<int*>(last), counters,
                                        status);
  return static_cast<int>(cudaGetLastError());
}

// flags uint8[Dl, m], off int32[Dl] (>= 0), up to 8 columns int32[Dl, m]
// (null: the slot's global index) with their fills -> outs int32[Dl, M],
// every place written by the call; scratch as femto_scan_scratch says,
// zeroed here by one cudaMemsetAsync.  One kernel a call.
extern "C" int femto_compact_rows(
    const void* flags, const void* off, long long m, int Dl, int shard0,
    long long M, int ncols, int f0, int f1, int f2, int f3, int f4, int f5,
    int f6, int f7, const void* i0, const void* i1, const void* i2,
    const void* i3, const void* i4, const void* i5, const void* i6,
    const void* i7, void* o0, void* o1, void* o2, void* o3, void* o4,
    void* o5, void* o6, void* o7, void* scratch, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || Dl < 1 || m < 0 || M < 0 ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, 4 * femto_scan_scratch(m, Dl), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* counters;
  unsigned long long* status;
  scan_scratch_parts(scratch, Dl, &counters, &status);
  CompactCols cols = {
      {static_cast<const int*>(i0), static_cast<const int*>(i1),
       static_cast<const int*>(i2), static_cast<const int*>(i3),
       static_cast<const int*>(i4), static_cast<const int*>(i5),
       static_cast<const int*>(i6), static_cast<const int*>(i7)},
      {static_cast<int*>(o0), static_cast<int*>(o1), static_cast<int*>(o2),
       static_cast<int*>(o3), static_cast<int*>(o4), static_cast<int*>(o5),
       static_cast<int*>(o6), static_cast<int*>(o7)},
      {f0, f1, f2, f3, f4, f5, f6, f7}};
  const long long n_tiles = tiles_of(m, kCompactTile);
  compact_rows_tile<kCompactThreads, kCompactRounds>
      <<<dim3(static_cast<unsigned>(n_tiles), Dl),
         kCompactThreads, 0, st>>>(
          static_cast<const unsigned char*>(flags),
          static_cast<const int*>(off), m, shard0, M, n_tiles, ncols, cols,
          counters, status);
  return static_cast<int>(cudaGetLastError());
}

// src int32[Dl, m], idx int32[M], valid uint8[M] or null -> out
// int32[Dl, T, M].
extern "C" int femto_fetch_owned(const void* src, long long m, int Dl,
                                 int shard0, const void* idx,
                                 const void* valid, long long M,
                                 long long add, int T, long long stride,
                                 void* out, void* stream) {
  if (T < 1 || Dl < 1) return static_cast<int>(cudaErrorInvalidValue);
  fetch_owned_kernel<<<dim3(blocks(M), Dl), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), m, shard0, static_cast<const int*>(idx),
      static_cast<const unsigned char*>(valid), M, add, T, stride,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
