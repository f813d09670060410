// Kernel A, occ_build (full tier), and A', occ_build_compact (compact and
// packed tiers): BWT split + per-segment histogram + occ checkpoints.
//
// Replaces (femto_tpu/ops/build_ops.py): _split_pull (96), _hist_core
// (129), _hist_stage (159), _ckpt_stage (169) and _occ_stage (197); A'
// also the used-column selection of build_fm_arrays_device (1280-1306) and
// _ckpt_stage(compact=True): int32 L1 rows every grp segments and uint16
// checkpoints relative to them.  The TPU built the histogram as a one-hot
// MXU einsum because its vector unit has no fast scatter; on the card a
// block per segment counts into 261 shared-memory bins with shared atomics
// and writes the K used columns (alpha_map; every column on the identity
// tiers).
//
// Bound on the H100 (3.35 TB/s): bytes.  Each input read once and each
// output written once: pull 8n + bwt 2*n_pad + a_row 4n + the checkpoints
// (A: 4*261*n_seg; A': 2*K*n_seg + 4*K*n_seg/grp) + C.  At n = 2^28,
// seg = 256 that is 4.85 GB, 1.45 ms for A.  This design moves more: the
// checkpoint scan runs down the strided columns of the row-major
// [n_seg, K] counts in three passes (tile sums, one scan of the tile sums,
// local scan with carry), so the counts are written once and read twice
// more (A' keeps them in an int32 scratch array).
#include "fm_common.cuh"

namespace {

using femto::kAlpha;
using femto::kInvalidAlpha;

constexpr int kTile = 1024;       // segments per scan tile (a multiple of
                                  // every L1 group, so tiles start groups)
constexpr int kColThreads = 288;  // >= kAlpha, whole warps

// One block per segment: split pull words into the BWT symbol (low 9
// bits) and the row's aux word (the rest), count symbols, and write the
// counts of the K used columns (col_map: symbol -> column or -1; null =
// identity over K = 261).
__global__ void split_hist_kernel(const long long* __restrict__ pull,
                                  long long n, int seg,
                                  const int* __restrict__ col_map, int K,
                                  uint16_t* __restrict__ bwt,
                                  int* __restrict__ a_row,
                                  int* __restrict__ hist) {
  __shared__ int h[kAlpha];
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const long long s = blockIdx.x;
  const long long r0 = s * seg;
  for (int j = threadIdx.x; j < seg; j += blockDim.x) {
    const long long r = r0 + j;
    if (r < n) {
      const long long p = pull[r];
      const int c = static_cast<int>(p & 511);
      bwt[r] = static_cast<uint16_t>(c);
      a_row[r] = static_cast<int>(p >> 9);
      if (c < kAlpha) atomicAdd(&h[c], 1);
    } else {
      bwt[r] = static_cast<uint16_t>(kInvalidAlpha);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x) {
    const int col = col_map ? col_map[i] : i;
    if (col >= 0) hist[s * K + col] = h[i];
  }
}

// Pass 1: per tile of kTile segments, the column sums.
__global__ void tile_sum_kernel(const int* __restrict__ hist, long long n_seg,
                                int K, int* __restrict__ tile_sums) {
  const int c = threadIdx.x;
  if (c >= K) return;
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long s1 = min(s0 + kTile, n_seg);
  int acc = 0;
  for (long long s = s0; s < s1; ++s) acc += hist[s * K + c];
  tile_sums[static_cast<long long>(blockIdx.x) * K + c] = acc;
}

// Pass 2 (one block): exclusive scan of the tile sums down each column,
// then C[K+1] from the column totals.
__global__ void tile_scan_kernel(int* __restrict__ tile_sums, int n_tiles,
                                 int K, int* __restrict__ C) {
  __shared__ int total[kAlpha];
  const int c = threadIdx.x;
  if (c < K) {
    int run = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const long long i = static_cast<long long>(t) * K + c;
      const int v = tile_sums[i];
      tile_sums[i] = run;
      run += v;
    }
    total[c] = run;
  }
  __syncthreads();
  if (c == 0) {
    int run = 0;
    C[0] = 0;
    for (int i = 0; i < K; ++i) {
      run += total[i];
      C[i + 1] = run;
    }
  }
}

// Pass 3 (full tier): in place, counts -> exclusive checkpoints, carrying
// the tile's offset from pass 2.  The row stride is the compile-time
// kAlpha: with a runtime stride the compiler cannot rule out that one
// iteration's store aliases the next one's load, and it serialises them
// (that doubled kernel A's time on the H100, PERF.md).
__global__ void tile_apply_kernel(int* __restrict__ hist, long long n_seg,
                                  const int* __restrict__ tile_off) {
  const int c = threadIdx.x;
  if (c >= kAlpha) return;
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long s1 = min(s0 + kTile, n_seg);
  int run = tile_off[static_cast<long long>(blockIdx.x) * kAlpha + c];
  for (long long s = s0; s < s1; ++s) {
    const long long i = s * kAlpha + c;
    const int v = hist[i];
    hist[i] = run;
    run += v;
  }
}

// Pass 3 (compact tiers): counts -> the L1 row of every grp-th segment's
// exclusive checkpoint and each checkpoint relative to its group's row
// (below seg * grp <= 65535, so it fits uint16).
__global__ void tile_apply_compact_kernel(const int* __restrict__ hist,
                                          long long n_seg, int K, int grp,
                                          const int* __restrict__ tile_off,
                                          int* __restrict__ occ_l1,
                                          uint16_t* __restrict__ occ_rel) {
  const int c = threadIdx.x;
  if (c >= K) return;
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long s1 = min(s0 + kTile, n_seg);
  int run = tile_off[static_cast<long long>(blockIdx.x) * K + c];
  int l1 = run;
  for (long long s = s0; s < s1; ++s) {
    if (s % grp == 0) {
      l1 = run;
      occ_l1[(s / grp) * K + c] = run;
    }
    const long long i = s * K + c;
    occ_rel[i] = static_cast<uint16_t>(run - l1);
    run += hist[i];
  }
}

}  // namespace

// pull int64[n]; bwt uint16[n_seg*seg]; a_row int32[n];
// occ_ckpt int32[n_seg*261]; C int32[262];
// tile_scratch int32[ceil(n_seg/1024)*261].
extern "C" int femto_occ_build(const void* pull, long long n, long long n_seg,
                               int seg, void* bwt, void* a_row, void* occ_ckpt,
                               void* C, void* tile_scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((n_seg + kTile - 1) / kTile);
  split_hist_kernel<<<static_cast<unsigned>(n_seg), 256, 0, st>>>(
      static_cast<const long long*>(pull), n, seg, nullptr, kAlpha,
      static_cast<uint16_t*>(bwt), static_cast<int*>(a_row),
      static_cast<int*>(occ_ckpt));
  tile_sum_kernel<<<n_tiles, kColThreads, 0, st>>>(
      static_cast<const int*>(occ_ckpt), n_seg, kAlpha,
      static_cast<int*>(tile_scratch));
  tile_scan_kernel<<<1, kColThreads, 0, st>>>(
      static_cast<int*>(tile_scratch), n_tiles, kAlpha, static_cast<int*>(C));
  tile_apply_kernel<<<n_tiles, kColThreads, 0, st>>>(
      static_cast<int*>(occ_ckpt), n_seg,
      static_cast<const int*>(tile_scratch));
  return static_cast<int>(cudaGetLastError());
}

// A': pull int64[n]; col_map int32[261] (symbol -> column or -1) or null
// for the identity over K = 261; n_seg a multiple of grp (which divides
// 1024) -> bwt uint16[n_seg*seg]; a_row int32[n]; occ_rel uint16[n_seg*K];
// occ_l1 int32[n_seg/grp*K]; C int32[K+1].  Scratch: hist int32[n_seg*K],
// tile_scratch int32[ceil(n_seg/1024)*K].
extern "C" int femto_occ_build_compact(const void* pull, long long n,
                                       long long n_seg, int seg,
                                       const void* col_map, int K, int grp,
                                       void* bwt, void* a_row, void* occ_rel,
                                       void* occ_l1, void* C, void* hist,
                                       void* tile_scratch, void* stream) {
  if (K < 1 || K > kAlpha || grp < 1 || kTile % grp != 0 || n_seg % grp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((n_seg + kTile - 1) / kTile);
  split_hist_kernel<<<static_cast<unsigned>(n_seg), 256, 0, st>>>(
      static_cast<const long long*>(pull), n, seg,
      static_cast<const int*>(col_map), K, static_cast<uint16_t*>(bwt),
      static_cast<int*>(a_row), static_cast<int*>(hist));
  tile_sum_kernel<<<n_tiles, kColThreads, 0, st>>>(
      static_cast<const int*>(hist), n_seg, K,
      static_cast<int*>(tile_scratch));
  tile_scan_kernel<<<1, kColThreads, 0, st>>>(
      static_cast<int*>(tile_scratch), n_tiles, K, static_cast<int*>(C));
  tile_apply_compact_kernel<<<n_tiles, kColThreads, 0, st>>>(
      static_cast<const int*>(hist), n_seg, K, grp,
      static_cast<const int*>(tile_scratch), static_cast<int*>(occ_l1),
      static_cast<uint16_t*>(occ_rel));
  return static_cast<int>(cudaGetLastError());
}
