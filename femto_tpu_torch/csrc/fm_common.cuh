// Shared device helpers of the port's FM-index kernels: one view of the
// index over the three row layouts it serves.
//
// Layouts (femto_tpu_torch/fmindex.py FMArrays, identical to femto_tpu's):
//   full     bwt uint16[n_seg, seg] symbols, INVALID_ALPHA past row n;
//            occ_ckpt int32[n_seg, K] occurrences of c in bwt[0 : s*seg)
//   compact  bwt as full; occ_ckpt uint16[n_seg, K] relative to its
//            group's row occ_l1 int32[n_seg/grp, K]
//   packed   the compact checkpoints over K dense codes, and bwt
//            uint32[n_seg, W] holding per_word codes of `bits` bits per
//            word (pad code all ones in `bits`, >= K)
//   C int32[K+1], C[c] = number of codes < c.  K = 261 on the identity
//   tiers; alpha_map (symbol -> dense code or -1) and alpha_rev (dense
//   code -> symbol) are non-null when the index is remapped.
//
// Every exported entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace femto {

constexpr int kAlpha = 261;         // alphabet.ALPHA_SIZE
constexpr int kInvalidAlpha = 511;  // alphabet.INVALID_ALPHA (pad rows)

enum Layout : int { kFull = 0, kCompact = 1, kPacked = 2 };

// Mirrored field for field by kernels.FmView (ctypes).
struct FmView {
  const void* bwt;       // uint16[n_seg, seg] | uint32[n_seg, W]
  const void* occ_ckpt;  // int32[n_seg, K] | uint16[n_seg, K]
  const int* occ_l1;     // int32[n_seg/grp, K] (compact, packed)
  const int* C;          // int32[K+1]
  const int* alpha_map;  // int32[261] or null (identity)
  const int* alpha_rev;  // int32[K] or null (identity)
  long long n_seg;
  int seg;
  int K;
  int grp;       // segments per L1 group (compact, packed)
  int W;         // words per segment row (packed)
  int per_word;  // codes per word (packed)
  int bits;      // bits per code (packed)
  int layout;    // Layout
};

// Occurrences of symbol c among the first `off` symbols of one uint16
// segment row.  The row starts 16-byte aligned (seg % 32 == 0), so whole
// 8-symbol chunks are read with one 16-byte load each and compared two
// symbols at a time (__vcmpeq2 sets 16 bits per equal half-word).
__device__ __forceinline__ int count_prefix_u16(
    const uint16_t* __restrict__ row, int off, int c) {
  const uint4* v = reinterpret_cast<const uint4*>(row);
  const unsigned cc = static_cast<unsigned>(c) * 0x00010001u;
  const int nv = off >> 3;
  int bits = 0;
  for (int i = 0; i < nv; ++i) {
    const uint4 q = __ldg(v + i);
    bits += __popc(__vcmpeq2(q.x, cc)) + __popc(__vcmpeq2(q.y, cc)) +
            __popc(__vcmpeq2(q.z, cc)) + __popc(__vcmpeq2(q.w, cc));
  }
  int cnt = bits >> 4;
  for (int j = nv << 3; j < off; ++j) cnt += (__ldg(row + j) == c);
  return cnt;
}

// Bit 0 of every `bits`-wide field of a word that holds per_word fields.
__device__ __forceinline__ unsigned field_lsbs(int bits, int per_word) {
  unsigned m = 0;
  for (int f = 0; f < per_word; ++f) m |= 1u << (f * bits);
  return m;
}

// Fields of x that are zero, as their bit 0 (SWAR): OR each field's bits
// onto its bit 0 (shifts below `bits` stay inside the field), invert.
__device__ __forceinline__ unsigned zero_fields(unsigned x, int bits,
                                                unsigned lsbs) {
  unsigned t = x;
  for (int k = 1; k < bits; ++k) t |= x >> k;
  return ~t & lsbs;
}

template <int L>
__device__ __forceinline__ int code_at(const FmView& ix, long long s,
                                       int off) {
  if constexpr (L == kPacked) {
    const unsigned* row = static_cast<const unsigned*>(ix.bwt) + s * ix.W;
    const int wi = off / ix.per_word;
    const int f = off - wi * ix.per_word;
    return static_cast<int>((__ldg(row + wi) >> (f * ix.bits)) &
                            ((1u << ix.bits) - 1u));
  } else {
    return __ldg(static_cast<const uint16_t*>(ix.bwt) + s * ix.seg + off);
  }
}

// Occurrences of dense code c before segment s.
template <int L>
__device__ __forceinline__ int ckpt_base(const FmView& ix, long long s,
                                         int c) {
  if constexpr (L == kFull) {
    return __ldg(static_cast<const int*>(ix.occ_ckpt) + s * ix.K + c);
  } else {
    const int rel = __ldg(static_cast<const uint16_t*>(ix.occ_ckpt) +
                          s * ix.K + c);
    return __ldg(ix.occ_l1 + (s / ix.grp) * ix.K + c) + rel;
  }
}

// Occurrences of dense code c among the first `off` rows of segment s.
template <int L>
__device__ __forceinline__ int count_prefix(const FmView& ix, long long s,
                                            int off, int c) {
  if constexpr (L == kPacked) {
    const unsigned* row = static_cast<const unsigned*>(ix.bwt) + s * ix.W;
    const unsigned lsbs = field_lsbs(ix.bits, ix.per_word);
    const unsigned rep = static_cast<unsigned>(c) * lsbs;
    const int nfull = off / ix.per_word;
    const int rem = off - nfull * ix.per_word;
    int cnt = 0;
    for (int i = 0; i < nfull; ++i)
      cnt += __popc(zero_fields(__ldg(row + i) ^ rep, ix.bits, lsbs));
    if (rem > 0) {
      const unsigned keep = (1u << (rem * ix.bits)) - 1u;  // rem*bits < 32
      cnt += __popc(zero_fields(__ldg(row + nfull) ^ rep, ix.bits, lsbs) &
                    keep);
    }
    return cnt;
  } else {
    return count_prefix_u16(
        static_cast<const uint16_t*>(ix.bwt) + s * ix.seg, off, c);
  }
}

// occ(c, r) for a valid dense code c (ops/rank.py _occ_dense): r at or past
// the last segment's end counts every occurrence of c.
template <int L>
__device__ __forceinline__ int occ(const FmView& ix, int c, long long r) {
  if (r >= ix.n_seg * ix.seg) return __ldg(ix.C + c + 1) - __ldg(ix.C + c);
  const long long s = r / ix.seg;
  const int off = static_cast<int>(r - s * ix.seg);
  return ckpt_base<L>(ix, s, c) + count_prefix<L>(ix, s, off, c);
}

// Alphabet symbol -> dense code, -1 outside the alphabet or absent
// (ops/rank.py map_char).
__device__ __forceinline__ int map_char(const FmView& ix, int c) {
  if (c < 0 || c >= kAlpha) return -1;
  return ix.alpha_map ? __ldg(ix.alpha_map + c) : c;
}

// Dense code -> alphabet symbol (ops/rank.py unmap_char).
__device__ __forceinline__ int unmap_char(const FmView& ix, int c) {
  return ix.alpha_rev ? __ldg(ix.alpha_rev + c) : c;
}

// Call launch(std::integral_constant<int, L>{}) for the view's layout L and
// return cudaGetLastError(); an unknown layout is refused.
template <class F>
int dispatch_layout(const FmView& ix, F&& launch) {
  switch (ix.layout) {
    case kFull: launch(std::integral_constant<int, kFull>{}); break;
    case kCompact: launch(std::integral_constant<int, kCompact>{}); break;
    case kPacked: launch(std::integral_constant<int, kPacked>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Block-wide scans of one int per thread for the build kernels' stream
// compactions and count tables.  kT threads (whole warps, at most 1024) all
// call; `warp_vals` is an int[32] in shared memory.  Returns the combination
// of the values of the threads before this one (0 or `none` for thread 0)
// and sets *total to the whole block's.
template <int kT>
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_vals,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_vals[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kT / 32 ? warp_vals[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_vals[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_vals[warp - 1] : 0) + x - v;
  *total = warp_vals[kT / 32 - 1];
  __syncthreads();
  return before;
}

// The same with max in place of +: the largest value of the threads before
// this one, `none` (a value below every input) for thread 0.
template <int kT>
__device__ __forceinline__ int block_exclusive_max(int v, int none,
                                                   int* warp_vals,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = max(x, y);
  }
  if (lane == 31) warp_vals[warp] = x;
  // the largest value of the lanes before this one in its warp
  int before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before = none;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kT / 32 ? warp_vals[lane] : none;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = max(w, y);
    }
    warp_vals[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  if (warp > 0) before = max(before, warp_vals[warp - 1]);
  *total = warp_vals[kT / 32 - 1];
  __syncthreads();
  return before;
}

}  // namespace femto
