// Kernel M, vseg_build: the row tiers' symbol lists, serving rows and side
// table (K11; the row assembly also serves vrle), three entry points.
//
// Replaces (femto_tpu/ops/build_ops.py): _stats_from_hist (211) as
// seg_syms; _codes2d_stage (320), _vseg_pack_uniform (269, side=False),
// _vseg_sym_words (358), _vseg_rel_words (372) and the row concatenation
// of _build_vseg (383) and _build_vrle (701) as vseg_rows;
// _vseg_pack_uniform(side=True) over the overflow segments as side_rows.
// The TPU mapped each BWT symbol to its local code by a compare-sum over
// the segment's list ([chunk, seg, SMAX] lanes) and packed with shift-sums
// over grids; here one warp owns one segment: it builds a 261-entry
// symbol -> local code table for its segment in shared memory (a binary
// search of the list per symbol), then each lane packs whole output words
// from the uint16 BWT row.
//
// Bound on the H100 (3.35 TB/s): bytes.  seg_syms reads the [n_seg, K]
// histogram and writes the lists; vseg_rows reads the uint16 BWT, the
// lists, the marks and the relative checkpoints (and on vrle the slot
// rows of the run-length segments) and writes each row once; side_rows
// reads the overflow segments' BWT and writes their words.  A warp's reads
// of its own row are contiguous; the table lookups stay in shared memory.
#include "fm_common.cuh"

namespace {

using femto::kAlpha;
using femto::local_code_table;

constexpr int kSymPad = 1 << 20;  // list pad (build_ops.SYM_PAD)
constexpr int kWarps = 8;         // segments per block

__device__ __forceinline__ int local_code(const unsigned char* tab,
                                          int sym) {
  return sym < kAlpha ? tab[sym] : 0;  // the pad rows past n: 0
}

// One warp per segment: the present columns of its histogram row in
// order, the first smax of them kept, the rest of the list padded.
__global__ void seg_syms_kernel(const int* __restrict__ hist,
                                long long n_seg, int K, int smax,
                                int* __restrict__ syms,
                                unsigned char* __restrict__ nsym) {
  const int lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (s >= n_seg) return;  // whole warps
  const int* h = hist + s * K;
  int* out = syms + s * smax;
  int count = 0;
  for (int c0 = 0; c0 < K; c0 += 32) {
    const int c = c0 + lane;
    const bool present = c < K && __ldg(h + c) > 0;
    const unsigned m = __ballot_sync(0xffffffffu, present);
    const int rank = count + __popc(m & ((1u << lane) - 1u));
    if (present && rank < smax) out[rank] = c;
    count += __popc(m);
  }
  for (int i = count + lane; i < smax; i += 32) out[i] = kSymPad;
  if (lane == 0)
    nsym[s] = static_cast<unsigned char>(count > smax ? 255 : count);
}

// One warp per segment: [code area | list | mark words | mark ckpt |
// relative checkpoints in pairs].
__global__ void vseg_rows_kernel(
    const uint16_t* __restrict__ bwt, long long n_seg, int seg,
    const int* __restrict__ alpha_map, const int* __restrict__ syms,
    int smax, const unsigned char* __restrict__ nsym,
    const int* __restrict__ seg_woff, int w_main, int code_words,
    const unsigned* __restrict__ rle, int rle_cols, int s_store, int wide,
    const unsigned* __restrict__ mark_bits,
    const int* __restrict__ mark_ckpt, const uint16_t* __restrict__ occ_rel,
    int K, int total, unsigned* __restrict__ out) {
  __shared__ int amap[kAlpha];
  __shared__ unsigned char tabs[kWarps][kAlpha + 3];
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x)
    amap[i] = alpha_map[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (s >= n_seg) return;
  unsigned* row = out + s * total;
  const int woff = __ldg(seg_woff + s);
  const int ns = __ldg(nsym + s);
  const int* list = syms + s * smax;
  if (woff < 0 && rle != nullptr) {
    // a run-length segment: its slot words
    const unsigned* src = rle + s * rle_cols;
    for (int i = lane; i < code_words; i += 32) row[i] = __ldg(src + i);
  } else {
    // local codes at w_main bits where the alphabet fits, else zeros
    const bool fits = ns <= (1 << w_main) && ns < 255;
    unsigned char* tab = tabs[warp];
    local_code_table(tab, amap, list, smax, lane);
    const int per = 32 / w_main;
    const int Wm = (seg + per - 1) / per;
    const uint16_t* b = bwt + s * seg;
    for (int i = lane; i < code_words; i += 32) {
      unsigned acc = 0;
      if (fits && i < Wm) {
        for (int f = 0; f < per; ++f) {
          const int j = i * per + f;
          if (j >= seg) break;
          acc |= static_cast<unsigned>(local_code(tab, __ldg(b + j)))
                 << (f * w_main);
        }
      }
      row[i] = acc;
    }
  }
  // the list, pads clipped to the entry type's max
  const int per_sym = wide ? 2 : 4;
  const int unit = 32 / per_sym;
  const int cap = wide ? 0xFFFF : 0xFF;
  const int Wsym = s_store / per_sym;
  for (int i = lane; i < Wsym; i += 32) {
    unsigned acc = 0;
    for (int f = 0; f < per_sym; ++f)
      acc |= static_cast<unsigned>(min(__ldg(list + i * per_sym + f), cap))
             << (f * unit);
    row[code_words + i] = acc;
  }
  const int Wmk = seg >> 5;
  const int off_mk = code_words + Wsym;
  for (int i = lane; i < Wmk; i += 32)
    row[off_mk + i] = __ldg(mark_bits + s * Wmk + i);
  if (lane == 0)
    row[off_mk + Wmk] = static_cast<unsigned>(__ldg(mark_ckpt + s));
  const int off_rel = off_mk + Wmk + 1;
  const uint16_t* rel = occ_rel + s * K;
  for (int i = lane; 2 * i < K; i += 32) {
    const unsigned lo = __ldg(rel + 2 * i);
    const unsigned hi = 2 * i + 1 < K ? __ldg(rel + 2 * i + 1) : 0u;
    row[off_rel + i] = lo | (hi << 16);
  }
}

// One thread per word of the side table: row 0 zeros, row k >= 1 the
// global dense codes of segment ovf_idx[k-1] at w_side bits.
__global__ void side_rows_kernel(const uint16_t* __restrict__ bwt, int seg,
                                 const int* __restrict__ alpha_map,
                                 const int* __restrict__ ovf_idx,
                                 long long words, int w_side, int Ws,
                                 unsigned* __restrict__ out) {
  __shared__ int amap[kAlpha];
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x)
    amap[i] = alpha_map[i];
  __syncthreads();
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= words) return;
  const long long k = w / Ws;
  const int i = static_cast<int>(w - k * Ws);
  unsigned acc = 0;
  if (k > 0) {
    const uint16_t* b = bwt + static_cast<long long>(__ldg(ovf_idx + k - 1)) *
                                  seg;
    const int per = 32 / w_side;
    for (int f = 0; f < per; ++f) {
      const int j = i * per + f;
      if (j >= seg) break;
      const int sym = __ldg(b + j);
      const int code = sym < kAlpha ? max(amap[sym], 0) : 0;
      acc |= static_cast<unsigned>(code) << (f * w_side);
    }
  }
  out[w] = acc;
}

unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

// hist int32[n_seg, K] -> syms int32[n_seg, smax] (pad 2^20), nsym
// uint8[n_seg] (255 above smax).
extern "C" int femto_seg_syms(const void* hist, long long n_seg, int K,
                              int smax, void* syms, void* nsym,
                              void* stream) {
  if (K < 1 || K > kAlpha || smax < 1 || smax > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg > 0) {
    seg_syms_kernel<<<blocks_for(n_seg, kWarps), 32 * kWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(hist), n_seg, K, smax,
        static_cast<int*>(syms), static_cast<unsigned char*>(nsym));
  }
  return static_cast<int>(cudaGetLastError());
}

// bwt uint16[n_seg, seg]; alpha_map int32[261]; syms int32[n_seg, smax];
// nsym uint8[n_seg]; seg_woff int32[n_seg]; rle uint32[n_seg, rle_cols]
// or null; mark_bits uint32[n_seg, seg/32]; mark_ckpt int32[n_seg];
// occ_rel uint16[n_seg, K] -> out uint32[n_seg, total].
extern "C" int femto_vseg_rows(
    const void* bwt, long long n_seg, int seg, const void* alpha_map,
    const void* syms, int smax, const void* nsym, const void* seg_woff,
    int w_main, int code_words, const void* rle, int rle_cols, int s_store,
    int wide, const void* mark_bits, const void* mark_ckpt,
    const void* occ_rel, int K, int total, void* out, void* stream) {
  const int per_sym = wide ? 2 : 4;
  if (w_main < 1 || w_main > 16 || seg % 32 != 0 || s_store % per_sym ||
      s_store > smax || smax > 255 || K < 1 || K > kAlpha ||
      code_words < (seg + 32 / w_main - 1) / (32 / w_main) ||
      (rle != nullptr && rle_cols < code_words) ||
      total != code_words + s_store / per_sym + seg / 32 + 1 + (K + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg > 0) {
    vseg_rows_kernel<<<blocks_for(n_seg, kWarps), 32 * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(bwt), n_seg, seg,
        static_cast<const int*>(alpha_map), static_cast<const int*>(syms),
        smax, static_cast<const unsigned char*>(nsym),
        static_cast<const int*>(seg_woff), w_main, code_words,
        static_cast<const unsigned*>(rle), rle_cols, s_store, wide,
        static_cast<const unsigned*>(mark_bits),
        static_cast<const int*>(mark_ckpt),
        static_cast<const uint16_t*>(occ_rel), K, total,
        static_cast<unsigned*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// bwt uint16[n_seg, seg]; alpha_map int32[261]; ovf_idx int32[novf] ->
// out uint32[novf + 1, Ws], Ws = ceil(seg / (32 / w_side)).
extern "C" int femto_side_rows(const void* bwt, long long n_seg, int seg,
                               const void* alpha_map, const void* ovf_idx,
                               int novf, int w_side, int Ws, void* out,
                               void* stream) {
  if (w_side < 1 || w_side > 16 || Ws != (seg + 32 / w_side - 1) /
                                          (32 / w_side) || novf < 0 ||
      n_seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long words = static_cast<long long>(novf + 1) * Ws;
  side_rows_kernel<<<blocks_for(words, 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(bwt), seg,
      static_cast<const int*>(alpha_map), static_cast<const int*>(ovf_idx),
      words, w_side, Ws, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
