// Kernel S, the LCP analytics' two device steps (femto_tpu_torch/lcp.py,
// K17): the windowed compare of suffix pairs and the compaction of the
// pairs still live.
//
// lcp_round replaces femto_tpu/lcp.py _lcp_round_jit (33): for each valid
// lane (i, j, h), ml = the number of equal symbols of text[i+h ..
// i+h+W) against text[j+h .. j+h+W) before the first mismatch, the text's
// end a mismatch (femto_tpu pads with -1 and -2); h becomes h + ml and the
// lane stays live only if ml == W.  Invalid lanes keep h and go dead.  The
// TPU gathered the whole [B, W] window of both sides and took a cumprod;
// here one warp owns a lane and compares 32 symbols a step (__ballot_sync
// of the mismatches, __ffs of the first), so a lane that mismatched reads
// no further.  Bound on the H100: bytes, each valid lane's symbols up to
// and including its first mismatch on both sides plus its lane state.
//
// lcp_compact replaces lcp.py _compact_lanes_jit (57): out[orig] = h for
// the lanes that resolved (orig < B_out), and the live lanes' (i, j, h,
// orig) compacted stably into M_out slots, the slots past the live count
// filled with 0, 0, 0 and B_out.  Three launches: a count per tile of 4096
// lanes, one block's scan of the tile counts (which also writes the live
// count), and the scatter, which repeats each tile's block scan
// (fm_common.cuh block_exclusive_sum) to place its lanes.  Bound: bytes,
// the lane arrays read once and the compacted ones written once.
#include "fm_common.cuh"

namespace {

constexpr int kRoundThreads = 256;             // 8 lanes (warps) a block
constexpr int kScanThreads = 1024;
constexpr int kItems = 4;                      // lanes per thread
constexpr int kTile = kScanThreads * kItems;   // lanes per compaction block

__global__ void lcp_round_kernel(const int* __restrict__ text, long long n,
                                 const int* __restrict__ ii,
                                 const int* __restrict__ jj,
                                 const int* __restrict__ hh,
                                 const unsigned char* __restrict__ valid,
                                 int B, int W, int* __restrict__ h_out,
                                 unsigned char* __restrict__ act_out) {
  const long long lane = static_cast<long long>(blockIdx.x) *
                             (kRoundThreads / 32) + (threadIdx.x >> 5);
  if (lane >= B) return;  // whole warps leave together
  const int k = threadIdx.x & 31;
  const int h = __ldg(hh + lane);
  if (!__ldg(valid + lane)) {
    if (k == 0) {
      h_out[lane] = h;
      act_out[lane] = 0;
    }
    return;
  }
  const long long a = static_cast<long long>(__ldg(ii + lane)) + h;
  const long long b = static_cast<long long>(__ldg(jj + lane)) + h;
  int ml = W;
  for (int base = 0; base < W; base += 32) {
    const long long pa = a + base + k, pb = b + base + k;
    const int x = pa < n ? __ldg(text + pa) : -1;
    const int y = pb < n ? __ldg(text + pb) : -2;
    const unsigned mis = __ballot_sync(0xffffffffu, x != y);
    if (mis) {
      ml = base + __ffs(mis) - 1;
      break;
    }
  }
  if (k == 0) {
    h_out[lane] = h + ml;
    act_out[lane] = ml == W;
  }
}

// Live lanes of each tile -> tile_counts[tile].
__global__ void compact_count_kernel(const unsigned char* __restrict__ act,
                                     int M_in, int* __restrict__ tile_counts) {
  __shared__ int warp_vals[32];
  const long long first =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int v = 0;
  for (int q = 0; q < kItems; ++q)
    if (first + q < M_in) v += __ldg(act + first + q) != 0;
  int total;
  femto::block_exclusive_sum<kScanThreads>(v, warp_vals, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block: tile_counts[0, nb) -> their exclusive sums in place, and the
// live count into tile_counts[nb].
__global__ void compact_scan_kernel(int* __restrict__ tile_counts, int nb) {
  __shared__ int warp_vals[32];
  int carry = 0;
  for (int base = 0; base < nb; base += kScanThreads) {
    const int t = base + threadIdx.x;
    const int v = t < nb ? tile_counts[t] : 0;
    int total;
    const int before =
        femto::block_exclusive_sum<kScanThreads>(v, warp_vals, &total);
    if (t < nb) tile_counts[t] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) tile_counts[nb] = carry;
}

__global__ void compact_scatter_kernel(
    int* __restrict__ out, int B_out, const int* __restrict__ ii,
    const int* __restrict__ jj, const int* __restrict__ hh,
    const unsigned char* __restrict__ act, const int* __restrict__ orig,
    int M_in, int M_out, const int* __restrict__ tile_offsets, int nb,
    int* __restrict__ i_out, int* __restrict__ j_out,
    int* __restrict__ h_out, int* __restrict__ orig_out) {
  __shared__ int warp_vals[32];
  const long long first =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  bool live[kItems];
  int v = 0;
  for (int q = 0; q < kItems; ++q) {
    live[q] = first + q < M_in && __ldg(act + first + q) != 0;
    v += live[q];
  }
  int total;
  long long pos = __ldg(tile_offsets + blockIdx.x) +
                  femto::block_exclusive_sum<kScanThreads>(v, warp_vals,
                                                           &total);
  const int n_live = __ldg(tile_offsets + nb);
  for (int q = 0; q < kItems; ++q) {
    const long long t = first + q;
    if (t < M_in) {
      if (live[q]) {
        if (pos < M_out) {
          i_out[pos] = __ldg(ii + t);
          j_out[pos] = __ldg(jj + t);
          h_out[pos] = __ldg(hh + t);
          orig_out[pos] = __ldg(orig + t);
        }
        ++pos;
      } else {
        const int o = __ldg(orig + t);
        if (o >= 0 && o < B_out) out[o] = __ldg(hh + t);
      }
    }
    if (t >= n_live && t < M_out) {  // the slots past the live lanes
      i_out[t] = 0;
      j_out[t] = 0;
      h_out[t] = 0;
      orig_out[t] = B_out;
    }
  }
}

long long compact_tiles(long long M) { return M > 0 ? (M + kTile - 1) / kTile : 1; }

}  // namespace

// Scratch of lcp_compact over max(M_in, M_out) = M lanes: int32 elements.
extern "C" long long femto_lcp_compact_scratch(long long M) {
  return compact_tiles(M) + 1;
}

// text int32[n]; lanes i, j, h int32[B], valid uint8[B]; W a multiple of
// 32 -> h_out int32[B], act_out uint8[B].
extern "C" int femto_lcp_round(const void* text, long long n, const void* i,
                               const void* j, const void* h,
                               const void* valid, int B, int W, void* h_out,
                               void* act_out, void* stream) {
  if (W <= 0 || W % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (static_cast<long long>(B) + 7) / 8;
  lcp_round_kernel<<<static_cast<unsigned>(blocks), kRoundThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(text), n, static_cast<const int*>(i),
      static_cast<const int*>(j), static_cast<const int*>(h),
      static_cast<const unsigned char*>(valid), B, W,
      static_cast<int*>(h_out), static_cast<unsigned char*>(act_out));
  return static_cast<int>(cudaGetLastError());
}

// out int32[B_out] (updated in place); lanes i, j, h, orig int32[M_in],
// act uint8[M_in] -> i_out, j_out, h_out, orig_out int32[M_out]; scratch
// int32[femto_lcp_compact_scratch(max(M_in, M_out))], whose last entry
// holds the live count afterwards.
extern "C" int femto_lcp_compact(void* out, int B_out, const void* i,
                                 const void* j, const void* h,
                                 const void* act, const void* orig, int M_in,
                                 int M_out, void* i_out, void* j_out,
                                 void* h_out, void* orig_out, void* scratch,
                                 void* stream) {
  if (M_in < 0 || M_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = compact_tiles(M_in > M_out ? M_in : M_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* tiles = static_cast<int*>(scratch);
  compact_count_kernel<<<static_cast<unsigned>(nb), kScanThreads, 0, st>>>(
      static_cast<const unsigned char*>(act), M_in, tiles);
  compact_scan_kernel<<<1, kScanThreads, 0, st>>>(tiles,
                                                  static_cast<int>(nb));
  compact_scatter_kernel<<<static_cast<unsigned>(nb), kScanThreads, 0, st>>>(
      static_cast<int*>(out), B_out, static_cast<const int*>(i),
      static_cast<const int*>(j), static_cast<const int*>(h),
      static_cast<const unsigned char*>(act), static_cast<const int*>(orig),
      M_in, M_out, tiles, static_cast<int>(nb), static_cast<int*>(i_out),
      static_cast<int*>(j_out), static_cast<int*>(h_out),
      static_cast<int*>(orig_out));
  return static_cast<int>(cudaGetLastError());
}
