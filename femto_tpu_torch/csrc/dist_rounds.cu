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
//                  _rank_refine's local_cum, _rep_compact_body's local
//                  ranks (305), the epilogue's new_base and survivor
//                  ranks;
//   compact_rows   _rep_compact_body's bitmap rank-select at a
//                  cross-shard offset and the epilogue's compaction of the
//                  survivors (the psum that merges shards is the mesh's);
//   fetch_owned    each shard's part of the psum fetches: _rep_extend_body's
//                  next T packed words, _rep_double_body's rank[pos + k],
//                  _pull_fix_body's sa[slot] and payload[pos] (478).
// The compact's slot order, the extension's sort and the write-backs are
// kernels H, L and K18a's owner_place.  The shard dimension is blockIdx.y.
//
// Bound on the H100 (3.35 TB/s): bytes.  seed_keys reads the block and
// halo once (the lut stays in L1) and writes nkeys ints per symbol;
// payload_block reads the block and writes one int per symbol (the doc
// starts are a binary search in L2); mesh_flags reads nk keys and writes
// one byte; mesh_scan reads the flags twice (tile totals, then the scan)
// and writes one int per element; compact_rows and fetch_owned move the
// records they keep or fetch.
#include "fm_common.cuh"

namespace {

constexpr int kFlagKeys = 6;
constexpr int kScanThreads = 1024;
constexpr int kPer = 4;                           // elements per thread
constexpr int kScanTile = kScanThreads * kPer;    // elements per tile

struct FlagKeys {
  const int* p[kFlagKeys];
};

struct Cols3 {
  const int* in[3];
  int* out[3];
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

__global__ void mesh_flags_kernel(FlagKeys k, int nk, FlagKeys prev,
                                  long long m, int shard0, int first,
                                  unsigned char* __restrict__ out) {
  const int d = blockIdx.y;
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= m) return;
  bool neq = false;
  for (int c = 0; c < nk; ++c) {
    const int cur = k.p[c][d * m + p];
    const int pv = p > 0 ? k.p[c][d * m + p - 1] : prev.p[c][d];
    neq |= cur != pv;
  }
  if (shard0 + d == 0 && p == 0) neq = first != 0;
  out[d * m + p] = neq ? 1 : 0;
}

// The value the scan combines at element i of shard d: the flag (mode 0)
// or flag ? slot : 0 (mode 1).
__device__ __forceinline__ int scan_value(const unsigned char* flags,
                                          const int* slots, long long m,
                                          int shard0, int d, long long i,
                                          int mode) {
  const long long k = d * m + i;
  if (mode == 0) return flags[k];
  if (!flags[k]) return 0;
  return slots ? slots[k]
               : static_cast<int>(static_cast<long long>(shard0 + d) * m + i);
}

__device__ __forceinline__ int combine(int a, int b, int mode) {
  return mode == 0 ? a + b : max(a, b);
}

// Pass 1: each tile's total.
__global__ void scan_tiles_kernel(const unsigned char* __restrict__ flags,
                                  const int* __restrict__ slots, long long m,
                                  int shard0, int mode, long long n_tiles,
                                  int* __restrict__ tiles) {
  __shared__ int warp_vals[32];
  const int d = blockIdx.y;
  const long long t = blockIdx.x;
  int acc = 0;
  for (int e = 0; e < kPer; ++e) {
    const long long i = t * kScanTile + threadIdx.x * kPer + e;
    if (i < m) acc = combine(acc, scan_value(flags, slots, m, shard0, d, i,
                                             mode), mode);
  }
  int total;
  if (mode == 0)
    femto::block_exclusive_sum<kScanThreads>(acc, warp_vals, &total);
  else
    femto::block_exclusive_max<kScanThreads>(acc, 0, warp_vals, &total);
  if (threadIdx.x == 0) tiles[d * n_tiles + t] = total;
}

// Pass 2, one block per shard: the tiles' exclusive scan (in place).
__global__ void scan_carry_kernel(int* __restrict__ tiles, long long n_tiles,
                                  int mode) {
  __shared__ int warp_vals[32];
  int* c = tiles + blockIdx.y * n_tiles;
  const long long chunk = (n_tiles + kScanThreads - 1) / kScanThreads;
  const long long t0 = threadIdx.x * chunk;
  const long long t1 = min(t0 + chunk, n_tiles);
  int acc = 0;
  for (long long t = t0; t < t1; ++t) acc = combine(acc, c[t], mode);
  int total;
  int run = mode == 0
                ? femto::block_exclusive_sum<kScanThreads>(acc, warp_vals,
                                                           &total)
                : femto::block_exclusive_max<kScanThreads>(acc, 0, warp_vals,
                                                           &total);
  for (long long t = t0; t < t1; ++t) {
    const int v = c[t];
    c[t] = run;
    run = combine(run, v, mode);
  }
}

// Pass 3: the inclusive scan of each tile with its carry.
__global__ void scan_apply_kernel(const unsigned char* __restrict__ flags,
                                  const int* __restrict__ slots, long long m,
                                  int shard0, int mode, long long n_tiles,
                                  const int* __restrict__ tiles,
                                  int* __restrict__ out,
                                  int* __restrict__ last) {
  __shared__ int warp_vals[32];
  const int d = blockIdx.y;
  const long long t = blockIdx.x;
  int v[kPer];
  int acc = 0;
  for (int e = 0; e < kPer; ++e) {
    const long long i = t * kScanTile + threadIdx.x * kPer + e;
    v[e] = i < m ? scan_value(flags, slots, m, shard0, d, i, mode) : 0;
    acc = combine(acc, v[e], mode);
  }
  int total;
  const int before =
      mode == 0 ? femto::block_exclusive_sum<kScanThreads>(acc, warp_vals,
                                                           &total)
                : femto::block_exclusive_max<kScanThreads>(acc, 0, warp_vals,
                                                           &total);
  int run = combine(tiles[d * n_tiles + t], before, mode);
  for (int e = 0; e < kPer; ++e) {
    const long long i = t * kScanTile + threadIdx.x * kPer + e;
    run = combine(run, v[e], mode);
    if (i < m) {
      out[d * m + i] = run;
      if (i == m - 1) last[d] = run;
    }
  }
}

__global__ void compact_rows_kernel(const unsigned char* __restrict__ flags,
                                    const int* __restrict__ rank,
                                    const int* __restrict__ off, long long m,
                                    int shard0, long long M, int ncols,
                                    Cols3 cols) {
  const int d = blockIdx.y;
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= m || !flags[d * m + p]) return;
  const long long k =
      static_cast<long long>(off[d]) + rank[d * m + p] - 1;
  if (k >= M) return;
  for (int c = 0; c < ncols; ++c) {
    const int v = cols.in[c] ? cols.in[c][d * m + p]
                             : static_cast<int>(
                                   static_cast<long long>(shard0 + d) * m + p);
    cols.out[c][d * M + k] = v;
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
  FlagKeys k = {{static_cast<const int*>(k0), static_cast<const int*>(k1),
                 static_cast<const int*>(k2), static_cast<const int*>(k3),
                 static_cast<const int*>(k4), static_cast<const int*>(k5)}};
  FlagKeys p = {{static_cast<const int*>(p0), static_cast<const int*>(p1),
                 static_cast<const int*>(p2), static_cast<const int*>(p3),
                 static_cast<const int*>(p4), static_cast<const int*>(p5)}};
  mesh_flags_kernel<<<dim3(blocks(m), Dl), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      k, nk, p, m, shard0, first, static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}

// flags uint8[Dl, m], slots int32[Dl, m] or null -> out int32[Dl, m],
// last int32[Dl]; scratch tiles int32[Dl, ceil(m / kScanTile)].
extern "C" int femto_mesh_scan(const void* flags, const void* slots,
                               long long m, int Dl, int shard0, int mode,
                               void* out, void* last, void* tiles,
                               void* stream) {
  if (m < 1 || Dl < 1 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (m + kScanTile - 1) / kScanTile;
  const dim3 grid(static_cast<unsigned>(n_tiles), Dl);
  const unsigned char* f = static_cast<const unsigned char*>(flags);
  const int* s = static_cast<const int*>(slots);
  int* tl = static_cast<int*>(tiles);
  scan_tiles_kernel<<<grid, kScanThreads, 0, st>>>(f, s, m, shard0, mode,
                                                   n_tiles, tl);
  scan_carry_kernel<<<dim3(1, Dl), kScanThreads, 0, st>>>(tl, n_tiles, mode);
  scan_apply_kernel<<<grid, kScanThreads, 0, st>>>(
      f, s, m, shard0, mode, n_tiles, tl, static_cast<int*>(out),
      static_cast<int*>(last));
  return static_cast<int>(cudaGetLastError());
}

// flags uint8[Dl, m], rank int32[Dl, m], off int32[Dl], up to 3 columns
// int32[Dl, m] (null: the slot's global index) -> outs int32[Dl, M]
// (pre-filled by the caller).
extern "C" int femto_compact_rows(const void* flags, const void* rank,
                                  const void* off, long long m, int Dl,
                                  int shard0, long long M, int ncols,
                                  const void* i0, const void* i1,
                                  const void* i2, void* o0, void* o1,
                                  void* o2, void* stream) {
  if (ncols < 1 || ncols > 3 || Dl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols3 cols = {{static_cast<const int*>(i0), static_cast<const int*>(i1),
                 static_cast<const int*>(i2)},
                {static_cast<int*>(o0), static_cast<int*>(o1),
                 static_cast<int*>(o2)}};
  compact_rows_kernel<<<dim3(blocks(m), Dl), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(flags),
      static_cast<const int*>(rank), static_cast<const int*>(off), m, shard0,
      M, ncols, cols);
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
