// Shared device helpers of the port's FM-index kernels (full tier).
//
// Layout (femto_tpu_torch/fmindex.py FMArrays, identical to femto_tpu's):
//   bwt       uint16[n_seg, seg]   BWT symbols, INVALID_ALPHA past row n
//   occ_ckpt  int32[n_seg, ALPHA]  occurrences of c in bwt[0 : s*seg)
//   C         int32[ALPHA + 1]     C[c] = number of symbols < c
//
// Every exported entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace femto {

constexpr int kAlpha = 261;         // alphabet.ALPHA_SIZE
constexpr int kInvalidAlpha = 511;  // alphabet.INVALID_ALPHA (pad rows)

// Occurrences of symbol c among the first `off` symbols of one segment
// row.  The row starts 16-byte aligned (seg % 32 == 0), so whole 8-symbol
// chunks are read with one 16-byte load each and compared two symbols at a
// time (__vcmpeq2 sets 16 bits per equal half-word).
__device__ __forceinline__ int count_prefix(const uint16_t* __restrict__ row,
                                            int off, int c) {
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

// occ(c, r) of the full tier for a valid symbol c (ops/rank.py _occ_dense):
// r at or past the last segment's end counts every occurrence of c.
__device__ __forceinline__ int occ_full(const uint16_t* __restrict__ bwt,
                                        const int* __restrict__ occ_ckpt,
                                        const int* __restrict__ C,
                                        long long n_seg, int seg, int c,
                                        long long r) {
  if (r >= n_seg * seg) return __ldg(C + c + 1) - __ldg(C + c);
  long long s = r / seg;
  const int off = static_cast<int>(r - s * seg);
  return __ldg(occ_ckpt + s * kAlpha + c) +
         count_prefix(bwt + s * seg, off, c);
}

}  // namespace femto
