// Kernel A, occ_build: BWT split + per-segment histogram + occ checkpoints.
//
// Replaces (femto_tpu/ops/build_ops.py): _split_pull (96), _hist_core (129),
// _hist_stage (159), _ckpt_stage (169) and _occ_stage (197), full tier.
// The TPU built the histogram as a one-hot MXU einsum because its vector
// unit has no fast scatter; on the card a block per segment counts into
// 261 shared-memory bins with shared atomics.
//
// Bound on the H100 (3.35 TB/s): bytes.  Each input read once and each
// output written once: pull 8n + bwt 2*n_pad + a_row 4n + occ_ckpt
// 4*261*n_seg (+ C).  At n = 2^28, seg = 256 that is 4.85 GB, 1.45 ms.
// This design moves more: the checkpoint scan runs down the strided
// columns of the row-major [n_seg, 261] array in three passes (tile sums,
// one scan of the tile sums, local scan with carry), so occ_ckpt is read
// twice more and written once more (~2.2 GB extra).
#include "fm_common.cuh"

namespace {

using femto::kAlpha;
using femto::kInvalidAlpha;

constexpr int kTile = 1024;     // segments per scan tile
constexpr int kColThreads = 288;  // >= kAlpha, whole warps

// One block per segment: split pull words into the BWT symbol (low 9
// bits) and the row's aux word (the rest), and count symbols.
__global__ void split_hist_kernel(const long long* __restrict__ pull,
                                  long long n, int seg,
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
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x)
    hist[s * kAlpha + i] = h[i];
}

// Pass 1: per tile of kTile segments, the column sums.
__global__ void tile_sum_kernel(const int* __restrict__ hist, long long n_seg,
                                int* __restrict__ tile_sums) {
  const int c = threadIdx.x;
  if (c >= kAlpha) return;
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long s1 = min(s0 + kTile, n_seg);
  int acc = 0;
  for (long long s = s0; s < s1; ++s) acc += hist[s * kAlpha + c];
  tile_sums[static_cast<long long>(blockIdx.x) * kAlpha + c] = acc;
}

// Pass 2 (one block): exclusive scan of the tile sums down each column,
// then C from the column totals.
__global__ void tile_scan_kernel(int* __restrict__ tile_sums, int n_tiles,
                                 int* __restrict__ C) {
  __shared__ int total[kAlpha];
  const int c = threadIdx.x;
  if (c < kAlpha) {
    int run = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const long long i = static_cast<long long>(t) * kAlpha + c;
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
    for (int i = 0; i < kAlpha; ++i) {
      run += total[i];
      C[i + 1] = run;
    }
  }
}

// Pass 3: in place, counts -> exclusive checkpoints, carrying the tile's
// offset from pass 2.
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
      static_cast<const long long*>(pull), n, seg,
      static_cast<uint16_t*>(bwt), static_cast<int*>(a_row),
      static_cast<int*>(occ_ckpt));
  tile_sum_kernel<<<n_tiles, kColThreads, 0, st>>>(
      static_cast<const int*>(occ_ckpt), n_seg,
      static_cast<int*>(tile_scratch));
  tile_scan_kernel<<<1, kColThreads, 0, st>>>(
      static_cast<int*>(tile_scratch), n_tiles, static_cast<int*>(C));
  tile_apply_kernel<<<n_tiles, kColThreads, 0, st>>>(
      static_cast<int*>(occ_ckpt), n_seg,
      static_cast<const int*>(tile_scratch));
  return static_cast<int>(cudaGetLastError());
}
