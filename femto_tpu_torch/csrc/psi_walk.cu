// Kernel E, psi_walk: forward (psi) walks over the full, compact and
// packed layouts (one instantiation each).
//
// Replaces femto_tpu/ops/search_ops.py psi_step (399) and its select
// _select_char (361), scanned by search.py _psi_scan_jit (243) for
// extract_context.  One step from row r:
//   1. the row's first symbol c: the last c with C[c] <= r, exactly
//      searchsorted(C, r, side="right") - 1 (absent symbols repeat C's
//      entries; stopping at the first equal entry would pick one of them);
//   2. k = r - C[c]; bisect the segments for the largest s with
//      ckpt_base(s, c) <= k;
//   3. psi(r) = the row of the (k+1)-th c, found by a scan of segment s
//      (s*seg + seg when no row of the segment hits, as in JAX).
// The step emits c, unmapped through alpha_rev on a remapped index.
//
// The TPU ran this as a lax.scan of lockstep batched steps: a fixed-count
// fori_loop bisect over [B] checkpoint gathers, then a [B, seg] cumsum of
// the gathered (unpacked) rows.  Here one thread walks one row through all
// steps: the bisect is ~log2(n_seg) dependent checkpoint loads, the select
// a scan of one row that stops at the hit.
//
// Bound on the H100: bytes of dependent random loads.  Per step the C
// entries of the bisect over K+1 ints, ~log2(n_seg) checkpoints (4 bytes
// on the full layout, 2 + 4 on the compact ones) and the row prefix up to
// the hit; plus rows in and chars out.  chip_smoke.py counts these over
// this run's steps; like kernel D the walk meets latency, not bandwidth.
#include "fm_common.cuh"

namespace {

template <int L>
__device__ __forceinline__ long long psi_step(const femto::FmView& ix,
                                              long long r, int* code) {
  // 1. last c in [0, K] with C[c] <= r (C[0] = 0 <= r)
  int lo = 0, hi = ix.K;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(ix.C + mid) <= r) lo = mid; else hi = mid - 1;
  }
  const int c = lo;
  *code = c;
  const long long k = r - __ldg(ix.C + c);
  // 2. largest segment s with ckpt_base(s, c) <= k (ckpt_base(0, c) = 0)
  long long slo = 0, shi = ix.n_seg - 1;
  while (slo < shi) {
    const long long mid = (slo + shi + 1) >> 1;
    if (femto::ckpt_base<L>(ix, mid, c) <= k) slo = mid; else shi = mid - 1;
  }
  const long long s = slo;
  // 3. the (k - base + 1)-th occurrence of c in segment s
  int want = static_cast<int>(k - femto::ckpt_base<L>(ix, s, c));
  int col = ix.seg;
  if constexpr (L == femto::kPacked) {
    const unsigned* row = static_cast<const unsigned*>(ix.bwt) + s * ix.W;
    const unsigned mask = (1u << ix.bits) - 1u;
    for (int wi = 0; wi < ix.W && col == ix.seg; ++wi) {
      const unsigned w = __ldg(row + wi);
      for (int f = 0; f < ix.per_word; ++f) {
        const int j = wi * ix.per_word + f;
        if (j >= ix.seg) break;
        if (static_cast<int>((w >> (f * ix.bits)) & mask) == c &&
            want-- == 0) {
          col = j;
          break;
        }
      }
    }
  } else {
    const uint16_t* row = static_cast<const uint16_t*>(ix.bwt) + s * ix.seg;
    for (int j = 0; j < ix.seg; ++j) {
      if (__ldg(row + j) == c && want-- == 0) {
        col = j;
        break;
      }
    }
  }
  return s * ix.seg + col;
}

template <int L>
__global__ void psi_walk_kernel(femto::FmView ix, const int* __restrict__ rows,
                                int B, int num_steps,
                                int* __restrict__ chars) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long r = rows[b];
  const int n = __ldg(ix.C + ix.K);
  int* out = chars + static_cast<long long>(b) * num_steps;
  for (int t = 0; t < num_steps; ++t) {
    if (r < 0 || r >= n) {  // outside [0, n) (invalid input): no read
      out[t] = femto::kInvalidAlpha;
      continue;
    }
    int c;
    r = psi_step<L>(ix, r, &c);
    out[t] = femto::unmap_char(ix, c);
  }
}

}  // namespace

// rows int32[B] (in [0, n)) -> chars int32[B, num_steps]: the first symbol
// of each row's suffix and of the num_steps - 1 suffixes after it.
extern "C" int femto_psi_walk(const femto::FmView* ix, const void* rows,
                              int B, int num_steps, void* chars,
                              void* stream) {
  if (B <= 0 || num_steps <= 0) return static_cast<int>(cudaGetLastError());
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    psi_walk_kernel<L><<<(B + 127) / 128, 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        *ix, static_cast<const int*>(rows), B, num_steps,
        static_cast<int*>(chars));
  });
}
