// Kernel E, psi_walk: forward (psi) walks over the full, compact, packed,
// vseg and vrle layouts (one instantiation each).
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
// On the row tiers step 3 is K13's counterpart (femto_tpu decodes the
// whole row to codes, ops/rank.py _gather_segments_vseg 577): the scan
// compares local codes with c's rank in the segment's symbol list, a
// word at a time (SWAR) on fixed-width and side rows, a slot at a time on
// run-length rows.
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

// Position of the (want+1)-th field equal to q among the first seg fields
// of w-bit words, seg when there is none.
__device__ __forceinline__ int swar_select(const unsigned* __restrict__ words,
                                           int w, int q, int want, int seg) {
  if (q < 0 || q >= (1 << w)) return seg;
  const int per = 32 / w;
  const unsigned lsbs = femto::field_lsbs(w, per);
  const unsigned rep = static_cast<unsigned>(q) * lsbs;
  const int nw = (seg + per - 1) / per;
  for (int i = 0; i < nw; ++i) {
    unsigned m = femto::zero_fields(__ldg(words + i) ^ rep, w, lsbs);
    const int left = seg - i * per;  // fields of this word inside the row
    if (left < per) m &= (1u << (left * w)) - 1u;
    const int cnt = __popc(m);
    if (want < cnt) {
      for (; want > 0; --want) m &= m - 1u;
      return i * per + (__ffs(m) - 1) / w;
    }
    want -= cnt;
  }
  return seg;
}

// Row-tier select: the (want+1)-th occurrence of dense code c in segment
// s, by its per-lane code (the global code on a side row).
template <int L>
__device__ __forceinline__ int row_select(const femto::FmView& ix,
                                          long long s, int c, int want) {
  const unsigned* row = femto::row_of(ix, s);
  const int woff = __ldg(ix.seg_woff + s);
  if (woff > 0)
    return swar_select(femto::side_of(ix, woff), ix.w_side, c, want, ix.seg);
  const int lq = femto::row_query_code(ix, row, c);
  if constexpr (L == femto::kVrle) {
    if (woff < 0) {
      int col = ix.seg;
      if (lq < 0) return col;
      femto::walk_slots(femto::slot_stream(ix, row, s, woff),
                        [&](int lsym, int start, int len) {
                          if (start >= ix.seg) return false;
                          if (lsym == lq) {
                            if (want < len) {
                              col = start + want;
                              return false;
                            }
                            want -= len;
                          }
                          return true;
                        });
      return col;
    }
  }
  return swar_select(row, ix.w_main, lq, want, ix.seg);
}

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
  if constexpr (femto::is_row<L>()) {
    col = row_select<L>(ix, s, c, want);
  } else if constexpr (L == femto::kPacked) {
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
