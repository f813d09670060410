// Kernel B, marks_build: mark bitmap, mark checkpoints, doc SEOF rows and
// the bit-packed mark-value store.
//
// Replaces (femto_tpu/ops/build_ops.py): _marks_finish (1033), its
// rank-select _mark_rank_select (962) and _pack_mark_vals (1134).  The TPU
// found the row of every mark rank by a rank-select over the bitmap because
// scatters were its slow path; on the card a stream compaction computes the
// same thing: each marked row learns its rank from the segment's
// checkpoint plus a block-wide ballot prefix and writes its own slot.
//
// Bound on the H100 (3.35 TB/s): bytes.  Inputs a_row 4n and sa 4 bytes
// per marked row (~4n/period); outputs mark_bits n_pad/8, mark_ckpt
// 4*n_seg, mark_vals ~(n/period)*bits/8 + the exception region,
// doc_seof_rows 4*ndocs.  At n = 2^28, seg = 256, period = 20: ~1.3 GB,
// 0.4 ms.  This design reads a_row twice (count pass, place pass) and
// keeps the unpacked slots in a scratch array before the packing pass.
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;       // per segment block; whole warps
constexpr int kScanThreads = 1024;  // single-block checkpoint scan

// Pass 1, one block per segment: bitmap words by warp ballot, the
// segment's mark and exception counts, and the doc SEOF-row scatter (doc
// tags are unique, so the scatter has no conflicts; it also serves
// mark_period == 0, where SEOF rows are unmarked).
__global__ void mark_count_kernel(const int* __restrict__ sa,
                                  const int* __restrict__ a_row, long long n,
                                  int seg, int period,
                                  unsigned* __restrict__ mark_bits,
                                  int* __restrict__ seg_marks,
                                  int* __restrict__ seg_exc,
                                  int* __restrict__ doc_seof_rows) {
  __shared__ int sm, se;
  if (threadIdx.x == 0) {
    sm = 0;
    se = 0;
  }
  __syncthreads();
  const long long s = blockIdx.x;
  const long long r0 = s * seg;
  const int lane = threadIdx.x & 31;
  int my_m = 0, my_e = 0;
  // seg and blockDim are multiples of 32: every warp runs whole iterations
  for (int j = threadIdx.x; j < seg; j += blockDim.x) {
    const long long r = r0 + j;
    bool m = false, e = false;
    if (r < n) {
      const int a = a_row[r];
      m = (a & 1) != 0;
      const int tag = a >> 1;
      if (tag > 0) doc_seof_rows[tag - 1] = static_cast<int>(r);
      if (m && period > 0) e = (sa[r] % period) != 0;
    }
    const unsigned wm = __ballot_sync(0xffffffffu, m);
    const unsigned we = __ballot_sync(0xffffffffu, e);
    if (lane == 0) {
      mark_bits[r >> 5] = wm;
      my_m += __popc(wm);
      my_e += __popc(we);
    }
  }
  if (lane == 0) {
    atomicAdd(&sm, my_m);
    atomicAdd(&se, my_e);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    seg_marks[s] = sm;
    seg_exc[s] = se;
  }
}

// Exclusive block-wide scan of one int per thread (kScanThreads threads).
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[31];
  __syncthreads();
  return before;
}

// Pass 2 (one block): exclusive scans of the per-segment mark and
// exception counts -> mark_ckpt, exc_ckpt and the totals.
__global__ void mark_scan_kernel(const int* __restrict__ seg_marks,
                                 const int* __restrict__ seg_exc,
                                 long long n_seg, int* __restrict__ mark_ckpt,
                                 int* __restrict__ exc_ckpt,
                                 int* __restrict__ totals) {
  __shared__ int warp_sums[32];
  const long long chunk = (n_seg + kScanThreads - 1) / kScanThreads;
  const long long b = threadIdx.x * chunk;
  const long long e = min(b + chunk, n_seg);
  int sum_m = 0, sum_e = 0;
  for (long long i = b; i < e; ++i) {
    sum_m += seg_marks[i];
    sum_e += seg_exc[i];
  }
  int tot_m, tot_e;
  int run_m = block_exclusive_scan(sum_m, warp_sums, &tot_m);
  int run_e = block_exclusive_scan(sum_e, warp_sums, &tot_e);
  for (long long i = b; i < e; ++i) {
    mark_ckpt[i] = run_m;
    exc_ckpt[i] = run_e;
    run_m += seg_marks[i];
    run_e += seg_exc[i];
  }
  if (threadIdx.x == 0) {
    totals[0] = tot_m;
    totals[1] = tot_e;
  }
}

// Pass 3, one block per segment: every marked row computes its mark rank
// g (checkpoint + ballot prefix) and stores k = value / period in slot g,
// or, off the grid, k = exc_base + exception rank with the raw value in
// the exception region.
__global__ void mark_place_kernel(const int* __restrict__ sa,
                                  const int* __restrict__ a_row, long long n,
                                  int seg, int period,
                                  const int* __restrict__ mark_ckpt,
                                  const int* __restrict__ exc_ckpt,
                                  int exc_base, int exc_cap,
                                  unsigned* __restrict__ kslots,
                                  int* __restrict__ exc_region) {
  __shared__ int warp_m[kThreads / 32], warp_e[kThreads / 32];
  const long long s = blockIdx.x;
  const long long r0 = s * seg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int nwarps = blockDim.x >> 5;
  int g = mark_ckpt[s], ex = exc_ckpt[s];
  for (int j0 = 0; j0 < seg; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const long long r = r0 + j;
    bool m = false, e = false;
    int v = 0;
    if (j < seg && r < n) {
      m = (a_row[r] & 1) != 0;
      if (m) {
        v = sa[r];
        e = (v % period) != 0;
      }
    }
    const unsigned bm = __ballot_sync(0xffffffffu, m);
    const unsigned be = __ballot_sync(0xffffffffu, e);
    if (lane == 0) {
      warp_m[warp] = __popc(bm);
      warp_e[warp] = __popc(be);
    }
    __syncthreads();
    int pm = 0, pe = 0, tm = 0, te = 0;
    for (int w = 0; w < nwarps; ++w) {
      if (w < warp) {
        pm += warp_m[w];
        pe += warp_e[w];
      }
      tm += warp_m[w];
      te += warp_e[w];
    }
    if (m) {
      const int gg = g + pm + __popc(bm & lt);
      unsigned k;
      if (e) {
        const int er = ex + pe + __popc(be & lt);
        k = static_cast<unsigned>(exc_base + er);
        if (er < exc_cap) exc_region[er] = v;
      } else {
        k = static_cast<unsigned>(v / period);
      }
      kslots[gg] = k;
    }
    g += tm;
    ex += te;
    __syncthreads();
  }
}

// Pass 4: one thread per packed word ORs in the (at most ceil(32/bits)+1)
// slots whose bits touch it -- deterministic, no atomics.
__global__ void mark_pack_kernel(const unsigned* __restrict__ kslots,
                                 long long cap, int bits, long long n_words,
                                 unsigned* __restrict__ words) {
  const long long w =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= n_words) return;
  const long long b0 = w * 32;
  const long long g0 = b0 / bits, g1 = (b0 + 31) / bits;
  unsigned acc = 0;
  for (long long g = g0; g <= g1 && g < cap; ++g) {
    const unsigned long long k = kslots[g];
    const long long sh = g * bits - b0;
    acc |= static_cast<unsigned>(sh >= 0 ? (k << sh) : (k >> (-sh)));
  }
  words[w] = acc;
}

}  // namespace

// sa int32[n], a_row int32[n] -> mark_bits uint32[n_seg*seg/32],
// mark_ckpt int32[n_seg], doc_seof_rows int32[ndocs] (zeroed by the caller),
// totals int32[2] (n_marks, n_exceptions).  With period > 0 also
// mark_vals uint32[n_words + exc_cap] (zeroed by the caller).  Scratch:
// seg_marks, seg_exc, exc_ckpt int32[n_seg]; kslots uint32[cap] (zeroed).
extern "C" int femto_marks_build(const void* sa, const void* a_row,
                                 long long n, long long n_seg, int seg,
                                 int period, long long cap, int bits,
                                 int exc_base, int exc_cap, long long n_words,
                                 void* mark_bits, void* mark_ckpt,
                                 void* mark_vals, void* doc_seof_rows,
                                 void* totals, void* seg_marks, void* seg_exc,
                                 void* exc_ckpt, void* kslots, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_seg);
  mark_count_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int*>(sa), static_cast<const int*>(a_row), n, seg,
      period, static_cast<unsigned*>(mark_bits), static_cast<int*>(seg_marks),
      static_cast<int*>(seg_exc), static_cast<int*>(doc_seof_rows));
  mark_scan_kernel<<<1, kScanThreads, 0, st>>>(
      static_cast<const int*>(seg_marks), static_cast<const int*>(seg_exc),
      n_seg, static_cast<int*>(mark_ckpt), static_cast<int*>(exc_ckpt),
      static_cast<int*>(totals));
  if (period > 0) {
    unsigned* vals = static_cast<unsigned*>(mark_vals);
    mark_place_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int*>(sa), static_cast<const int*>(a_row), n, seg,
        period, static_cast<const int*>(mark_ckpt),
        static_cast<const int*>(exc_ckpt), exc_base, exc_cap,
        static_cast<unsigned*>(kslots), reinterpret_cast<int*>(vals + n_words));
    mark_pack_kernel<<<static_cast<unsigned>((n_words + 255) / 256), 256, 0,
                       st>>>(static_cast<const unsigned*>(kslots), cap, bits,
                             n_words, vals);
  }
  return static_cast<int>(cudaGetLastError());
}
