// Kernel N, vrle_build: the vrle tier's run-length slots (K12), three entry
// points.
//
// Replaces (femto_tpu/ops/build_ops.py): _vrle_slot_stats (523) as
// vrle_slot_count; _vrle_pack_slots (582) with _pack_bit_slots (560) as
// vrle_pack; _flatten_ragged (863, fill 0) over the continued segments'
// words as cont_flatten.  A segment's slots are the runs of its local
// codes (ranks in its symbol list), split at 2^lenbits - 1, each stored as
// local code << lenbits | length in 6, 8 or 10 bits by the segment's
// symbol count (ops/rank.py vrle_slot_geom).  The TPU found run starts and
// slot lengths with cummax / cummin scans over [chunk, seg] grids and
// packed through three constant-index scatter-adds, one per slot width;
// here one warp walks one segment 32 positions at a time: a ballot of the
// run breaks, a max-scan across lanes for the run start, a ballot of the
// slot starts (their count, their ranks), and each slot's length from the
// next start -- the last slot of a chunk waits for the next chunk.  Slot
// bits are OR-ed into a per-warp row in shared memory, then written once.
//
// Bound on the H100 (3.35 TB/s): bytes.  vrle_slot_count reads the uint16
// BWT (and the lists) and writes n_seg ints; vrle_pack reads the BWT of
// the run-length segments and writes [n_seg, words]; cont_flatten reads
// the continued segments' words and writes the flat store.
#include "fm_common.cuh"

namespace {

using femto::kAlpha;
using femto::local_code_table;
using femto::slot_geom;

constexpr int kWarps = 8;

// The slot starts among positions base .. base+31 of one segment, as a
// ballot; carries the previous chunk's last code and run start.
struct RunScan {
  int prev_code = 0;  // code at position base - 1
  int run_start = 0;  // run start at position base - 1
  __device__ __forceinline__ unsigned step(int code, int j, int maxlen,
                                           int lane) {
    int prev = __shfl_up_sync(0xffffffffu, code, 1);
    if (lane == 0) prev = prev_code;
    const bool brk = j == 0 || code != prev;
    int rs = brk ? j : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, rs, d);
      if (lane >= d) rs = max(rs, y);
    }
    rs = max(rs, run_start);
    const bool is_slot = brk || (j - rs) % maxlen == 0;
    prev_code = __shfl_sync(0xffffffffu, code, 31);
    run_start = __shfl_sync(0xffffffffu, rs, 31);
    return __ballot_sync(0xffffffffu, is_slot);
  }
};

__global__ void vrle_slot_count_kernel(const uint16_t* __restrict__ bwt,
                                       long long n_seg, int seg,
                                       const int* __restrict__ alpha_map,
                                       const int* __restrict__ syms,
                                       int smax,
                                       const unsigned char* __restrict__ nsym,
                                       int* __restrict__ slots) {
  __shared__ int amap[kAlpha];
  __shared__ unsigned char tabs[kWarps][kAlpha + 3];
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x)
    amap[i] = alpha_map[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (s >= n_seg) return;
  unsigned char* tab = tabs[warp];
  local_code_table(tab, amap, syms + s * smax, smax, lane);
  int w_slot, lenbits;
  slot_geom(__ldg(nsym + s), &w_slot, &lenbits);
  const int maxlen = (1 << lenbits) - 1;
  const uint16_t* b = bwt + s * seg;
  RunScan scan;
  int count = 0;
  for (int base = 0; base < seg; base += 32) {
    const int j = base + lane;
    const int sym = __ldg(b + j);
    const int code = sym < kAlpha ? tab[sym] : 0;
    count += __popc(scan.step(code, j, maxlen, lane));
  }
  if (lane == 0) slots[s] = count;
}

// OR one slot's bits into the warp's row buffer (dropped past `words`).
__device__ __forceinline__ void put_slot(unsigned* buf, int words, int w,
                                         int idx, unsigned val) {
  if (idx >= (words * 32) / w) return;
  const int bit = idx * w;
  const int wi = bit >> 5, sh = bit & 31;
  atomicOr(buf + wi, val << sh);
  if (sh + w > 32) atomicOr(buf + wi + 1, val >> (32 - sh));
}

__global__ void vrle_pack_kernel(const uint16_t* __restrict__ bwt,
                                 long long n_seg, int seg,
                                 const int* __restrict__ alpha_map,
                                 const int* __restrict__ syms, int smax,
                                 const unsigned char* __restrict__ nsym,
                                 const int* __restrict__ seg_woff, int words,
                                 int warps, unsigned* __restrict__ out) {
  extern __shared__ unsigned bufs[];  // [warps][words]
  __shared__ int amap[kAlpha];
  __shared__ unsigned char tabs[kWarps][kAlpha + 3];
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x)
    amap[i] = alpha_map[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s = static_cast<long long>(blockIdx.x) * warps + warp;
  if (s >= n_seg) return;
  unsigned* row = out + s * words;
  if (__ldg(seg_woff + s) >= 0) {  // not a run-length segment: zeros
    for (int i = lane; i < words; i += 32) row[i] = 0;
    return;
  }
  unsigned* buf = bufs + static_cast<long long>(warp) * words;
  for (int i = lane; i < words; i += 32) buf[i] = 0;
  unsigned char* tab = tabs[warp];
  local_code_table(tab, amap, syms + s * smax, smax, lane);
  int w_slot, lenbits;
  slot_geom(__ldg(nsym + s), &w_slot, &lenbits);
  const int maxlen = (1 << lenbits) - 1;
  const uint16_t* b = bwt + s * seg;
  RunScan scan;
  int count = 0;         // slots before this chunk
  int pend_start = -1;   // the last slot so far, waiting for its length
  unsigned pend_code = 0;
  int pend_idx = 0;
  for (int base = 0; base < seg; base += 32) {
    const int j = base + lane;
    const int sym = __ldg(b + j);
    const int code = sym < kAlpha ? tab[sym] : 0;
    const unsigned m = scan.step(code, j, maxlen, lane);
    if (m == 0) continue;
    if (lane == 0 && pend_start >= 0)
      put_slot(buf, words, w_slot, pend_idx,
               (pend_code << lenbits) |
                   static_cast<unsigned>(base + __ffs(m) - 1 - pend_start));
    const bool is_slot = (m >> lane) & 1u;
    const unsigned later = lane == 31 ? 0u : m >> (lane + 1);
    if (is_slot && later != 0) {
      const int len = __ffs(later);  // the next start is lane + len
      put_slot(buf, words, w_slot, count + __popc(m & ((1u << lane) - 1u)),
               (static_cast<unsigned>(code) << lenbits) |
                   static_cast<unsigned>(len));
    }
    const int last = 31 - __clz(m);
    pend_start = base + last;
    pend_code = static_cast<unsigned>(__shfl_sync(0xffffffffu, code, last));
    pend_idx = count + __popc(m) - 1;
    count += __popc(m);
  }
  if (lane == 0 && pend_start >= 0)
    put_slot(buf, words, w_slot, pend_idx,
             (pend_code << lenbits) |
                 static_cast<unsigned>(seg - pend_start));
  __syncwarp();
  for (int i = lane; i < words; i += 32) row[i] = buf[i];
}

__global__ void zero_kernel(unsigned* __restrict__ out, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < total) out[i] = 0;
}

// One block per continued segment: its words from column `first` on.
__global__ void cont_scatter_kernel(const unsigned* __restrict__ rle,
                                    int cols, int first,
                                    const int* __restrict__ cont_idx,
                                    const int* __restrict__ cwords,
                                    const int* __restrict__ offs,
                                    long long total,
                                    unsigned* __restrict__ out) {
  const int k = blockIdx.x;
  const unsigned* src = rle + static_cast<long long>(__ldg(cont_idx + k)) *
                                  cols + first;
  const int nw = min(__ldg(cwords + k), cols - first);
  const long long o = __ldg(offs + k);
  for (int j = threadIdx.x; j < nw; j += blockDim.x)
    if (o + j < total) out[o + j] = __ldg(src + j);
}

unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

// bwt uint16[n_seg, seg]; alpha_map int32[261]; syms int32[n_seg, smax];
// nsym uint8[n_seg] -> slots int32[n_seg].
extern "C" int femto_vrle_slot_count(const void* bwt, long long n_seg,
                                     int seg, const void* alpha_map,
                                     const void* syms, int smax,
                                     const void* nsym, void* slots,
                                     void* stream) {
  if (seg % 32 != 0 || smax < 1 || smax > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg > 0) {
    vrle_slot_count_kernel<<<blocks_for(n_seg, kWarps), 32 * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(bwt), n_seg, seg,
        static_cast<const int*>(alpha_map), static_cast<const int*>(syms),
        smax, static_cast<const unsigned char*>(nsym),
        static_cast<int*>(slots));
  }
  return static_cast<int>(cudaGetLastError());
}

// ... + seg_woff int32[n_seg] -> out uint32[n_seg, words]: the packed
// slots of the segments with seg_woff < 0, zeros for the others.
extern "C" int femto_vrle_pack(const void* bwt, long long n_seg, int seg,
                               const void* alpha_map, const void* syms,
                               int smax, const void* nsym,
                               const void* seg_woff, int words, void* out,
                               void* stream) {
  if (seg % 32 != 0 || smax < 1 || smax > 255 || words < 1 ||
      words > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  // one row buffer per warp within the default 48 KB of shared memory
  const int warps = max(1, min(kWarps, (40 << 10) / (4 * words)));
  if (n_seg > 0) {
    vrle_pack_kernel<<<blocks_for(n_seg, warps), 32 * warps,
                       static_cast<size_t>(warps) * words * 4,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(bwt), n_seg, seg,
        static_cast<const int*>(alpha_map), static_cast<const int*>(syms),
        smax, static_cast<const unsigned char*>(nsym),
        static_cast<const int*>(seg_woff), words, warps,
        static_cast<unsigned*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// rle uint32[rows, cols]; cont_idx, cwords, offs int32[m] -> out
// uint32[total]: zeros, then row cont_idx[k]'s words first ..
// first + cwords[k] at offs[k].
extern "C" int femto_cont_flatten(const void* rle, long long rows, int cols,
                                  int first, const void* cont_idx,
                                  const void* cwords, const void* offs,
                                  int m, long long total, void* out,
                                  void* stream) {
  if (first < 0 || first > cols || m < 0 || rows < 0 || total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total > 0)
    zero_kernel<<<blocks_for(total, 256), 256, 0, st>>>(
        static_cast<unsigned*>(out), total);
  if (m > 0)
    cont_scatter_kernel<<<m, 128, 0, st>>>(
        static_cast<const unsigned*>(rle), cols, first,
        static_cast<const int*>(cont_idx), static_cast<const int*>(cwords),
        static_cast<const int*>(offs), total, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
