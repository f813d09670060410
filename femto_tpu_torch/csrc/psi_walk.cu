// Kernel E, psi_walk: forward (psi) walks over the full, compact, packed,
// vseg and vrle layouts (one instantiation each).
//
// Replaces femto_tpu/ops/search_ops.py psi_step (399) and its select
// _select_char (361), scanned by search.py _psi_scan_jit (243) for
// extract_context.  One step from row r:
//   1. the row's first symbol c: the last c with C[c] <= r, exactly
//      searchsorted(C, r, side="right") - 1 (absent symbols repeat C's
//      entries; stopping at the first equal entry would pick one of them);
//   2. k = r - C[c]; the largest segment s with ckpt_base(s, c) <= k;
//   3. psi(r) = the row of the (k+1)-th c, found by a scan of segment s
//      (s*seg + seg when no row of the segment hits, as in JAX).
// The step emits c, unmapped through alpha_rev on a remapped index.
// On the row tiers step 3 is K13's counterpart (femto_tpu decodes the
// whole row to codes, ops/rank.py _gather_segments_vseg 577): the scan
// compares local codes with c's rank in the segment's symbol list, SWAR
// on fixed-width and side rows, slot by slot on run-length rows.
//
// The TPU ran this as a lax.scan of lockstep batched steps: a fixed-count
// fori_loop bisect over [B] checkpoint gathers, then a [B, seg] cumsum of
// the gathered (unpacked) rows.  Here two routes walk a row through all
// its steps, one rule (psi_route_smem, exposed as femto_psi_walk_route)
// picking one by layout, seg and B:
//   - the thread route, a thread a walk: C bisected from global memory,
//     ~log2(n_seg) dependent checkpoint loads, then a scan of one row that
//     stops at the hit (a word at a time; a slot at a time on run-length
//     rows);
//   - the warp route, a warp a walk: c by one count over C held in the
//     lanes' registers (entry i in lane i % 32), s by a 32-way search --
//     each lane probes one pivot segment of the interval and a ballot
//     narrows it 33-fold a round (2^20 segments: 4 dependent round trips,
//     not 20; on the row tiers a probe's relative word and L1 entry issued
//     together) -- then one fetch of segment s by the whole warp (16-byte
//     loads of 8 symbols on full and compact, words on packed, into the
//     lanes' registers; on vseg and vrle the code area and the symbol
//     list by cp.async into the warp's shared memory, a side row or a
//     continued segment's granules by a second round trip, as kernel C's
//     warp step reads them), each lane counting c's matches in its run of
//     consecutive words (SWAR; on run-length rows a slot a lane, 32 slots
//     a round, starts from a warp scan of the lengths), a warp scan of
//     the counts naming the lane that holds the (k+1)-th, which finds the
//     field.  A step is the search's rounds plus one round trip (two on a
//     side or continued segment).
// Rows outside [0, n) emit INVALID_ALPHA, stay put and read nothing.
//
// Bound on the H100: bytes of dependent random loads.  Per step the C
// entries, ~log2(n_seg) checkpoints (4 bytes on the full layout, 2 + 4 on
// the compact ones) and the row prefix up to the hit; plus rows in and
// chars out.  chip_smoke.py counts these over this run's steps, and phase
// 5 sets each row beside its latency floor (steps x the route's dependent
// round trips a step x the card's dependent-load latency): on the H100 the
// warp route's rows take 3-13x that floor, itself far above the bytes
// bound.
#include "fm_common.cuh"

namespace {

// ---- the thread route: a thread a walk ----

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

// ---- the warp route: a warp a walk ----

using femto::kAllLanes;
using femto::kRowRegs;
using femto::kWarpWalks;

// Words (16-byte chunks of 8 symbols on full and compact) a lane counts
// in one pass of a select: a pass covers 32 x kSelWords of them (2048
// uint16 symbols, or 8,192 codes of 4 bits), so one pass serves a row up
// to seg 2048.
constexpr int kSelWords = 8;

// Position of the (x+1)-th set bit of m (m has more than x set bits).
__device__ __forceinline__ int nth_bit(unsigned m, int x) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const unsigned low = m & ((1u << width) - 1u);
    const int c = __popc(low);
    if (x >= c) {
      x -= c;
      m >>= width;
      pos += width;
    } else {
      m = low;
    }
  }
  return pos;
}

// One pass of a warp select: each lane holds the match masks m[j] of its
// run of consecutive words; *want (the same on every lane) counts the
// matches still to skip.  Returns on every lane pos(j, bit) of the
// (*want + 1)-th match where this pass holds it (a warp scan of the
// lanes' counts names the lane, which finds the word and the bit), else
// -1 with *want less the pass's matches.
template <class Pos>
__device__ __forceinline__ int warp_pass_hit(const unsigned (&m)[kSelWords],
                                             int lane, int* want, Pos pos) {
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kSelWords; ++j) cnt += __popc(m[j]);
  const int incl = femto::warp_inclusive_sum(cnt, lane);
  const int total = __shfl_sync(kAllLanes, incl, 31);
  if (*want >= total) {
    *want -= total;
    return -1;
  }
  const int hl = __ffs(__ballot_sync(kAllLanes, incl > *want)) - 1;
  int at = 0;
  if (lane == hl) {
    int x = *want - (incl - cnt);
    bool found = false;
#pragma unroll
    for (int j = 0; j < kSelWords; ++j) {
      const int pc = __popc(m[j]);
      if (!found) {
        if (x < pc) {
          at = pos(j, nth_bit(m[j], x));
          found = true;
        } else {
          x -= pc;
        }
      }
    }
  }
  return __shfl_sync(kAllLanes, at, hl);
}

// The (want+1)-th symbol equal to c among the seg symbols of a uint16 row
// (16-byte aligned: seg % 32 == 0), seg when there is none; each lane
// loads its run of 16-byte chunks at once.
__device__ __forceinline__ int warp_select_u16(
    const uint16_t* __restrict__ row, int seg, int c, int want, int lane) {
  const uint4* v = reinterpret_cast<const uint4*>(row);
  const unsigned cc = static_cast<unsigned>(c) * 0x00010001u;
  const int nch = seg >> 3;
  for (int p0 = 0; p0 < nch; p0 += 32 * kSelWords) {
    const int end = min(p0 + 32 * kSelWords, nch);
    const int each = (end - p0 + 31) >> 5;
    const int i0 = p0 + lane * each;
    uint4 q[kSelWords];
#pragma unroll
    for (int j = 0; j < kSelWords; ++j)
      q[j] = j < each && i0 + j < end ? __ldg(v + i0 + j)
                                      : make_uint4(0u, 0u, 0u, 0u);
    unsigned m[kSelWords];
#pragma unroll
    for (int j = 0; j < kSelWords; ++j)
      m[j] = j < each && i0 + j < end ? femto::eq8_u16(q[j], cc) : 0u;
    const int at = warp_pass_hit(m, lane, &want, [&](int j, int bit) {
      return (i0 + j) * 8 + bit;
    });
    if (at >= 0) return at;
  }
  return seg;
}

// The (want+1)-th field equal to q among the first nfields w-bit fields
// (32 / w a word) of the words word(0), word(1), ..., nfields when there
// is none or q does not fit w bits; each lane reads its run of words at
// once (SWAR: XOR with q in every field, zero fields to their bit 0).
template <class Word>
__device__ __forceinline__ int warp_select_fields(Word word, int w, int q,
                                                  int want, int nfields,
                                                  int lane) {
  if (q < 0 || q >= (1 << w)) return nfields;
  const int per = 32 / w;
  const unsigned lsbs = femto::field_lsbs(w, per);
  const unsigned rep = static_cast<unsigned>(q) * lsbs;
  const int nw = (nfields + per - 1) / per;
  for (int p0 = 0; p0 < nw; p0 += 32 * kSelWords) {
    const int end = min(p0 + 32 * kSelWords, nw);
    const int each = (end - p0 + 31) >> 5;
    const int i0 = p0 + lane * each;
    unsigned x[kSelWords];
#pragma unroll
    for (int j = 0; j < kSelWords; ++j)
      x[j] = j < each && i0 + j < end ? word(i0 + j) : 0u;
    unsigned m[kSelWords];
#pragma unroll
    for (int j = 0; j < kSelWords; ++j)
      m[j] = j < each && i0 + j < end
                 ? femto::zero_fields(x[j] ^ rep, w, lsbs) &
                       femto::keep_fields(nfields - (i0 + j) * per, per, w)
                 : 0u;
    const int at = warp_pass_hit(m, lane, &want, [&](int j, int bit) {
      return (i0 + j) * per + bit / w;
    });
    if (at >= 0) return at;
  }
  return nfields;
}

// The (want+1)-th position of local code lq in a run-length stream in
// shared memory (nwords words), seg when there is none (lq < 0: absent):
// row_select's slot walk, a slot a lane and 32 slots a round, the starts
// from a warp scan of the lengths; the slots that start at or past seg
// count nothing (the walk stops there).
__device__ __forceinline__ int warp_select_slots(const unsigned* words,
                                                 int nwords, int nsym,
                                                 int lq, int want, int seg,
                                                 int lane) {
  if (lq < 0) return seg;
  int w, lenbits;
  femto::slot_geom(nsym, &w, &lenbits);
  const int kmax = (nwords * 32) / w;
  int carry = 0;
  for (int base = 0; base < kmax && carry < seg; base += 32) {
    const int k = base + lane;
    int ls = -1, len = 0;
    if (k < kmax) femto::smem_slot(words, w, lenbits, k, &ls, &len);
    const int incl = femto::warp_inclusive_sum(len, lane);
    const int start = carry + incl - len;
    const int cnt = k < kmax && start < seg && ls == lq ? len : 0;
    const int ci = femto::warp_inclusive_sum(cnt, lane);
    const int total = __shfl_sync(kAllLanes, ci, 31);
    if (want < total) {
      const int hl = __ffs(__ballot_sync(kAllLanes, ci > want)) - 1;
      return __shfl_sync(kAllLanes, start + want - (ci - cnt), hl);
    }
    want -= total;
    carry += __shfl_sync(kAllLanes, incl, 31);
  }
  return seg;
}

// ckpt_base(s, c) with a 32-bit segment number (rows lie below 2^31); on
// compact, packed and the row tiers its two loads are independent.
template <int L>
__device__ __forceinline__ int probe_base(const femto::FmView& ix,
                                          unsigned s, int c) {
  if constexpr (L == femto::kFull) {
    return __ldg(static_cast<const int*>(ix.occ_ckpt) +
                 static_cast<long long>(s) * ix.K + c);
  } else {
    const long long g =
        static_cast<long long>(s / static_cast<unsigned>(ix.grp)) * ix.K + c;
    int rel;
    if constexpr (femto::is_row<L>()) {
      const unsigned w = __ldg(femto::row_of(ix, s) + ix.off_rel + (c >> 1));
      rel = static_cast<int>((w >> ((c & 1) * 16)) & 0xFFFFu);
    } else {
      rel = __ldg(static_cast<const uint16_t*>(ix.occ_ckpt) +
                  static_cast<long long>(s) * ix.K + c);
    }
    return __ldg(ix.occ_l1 + g) + rel;
  }
}

// Step 3 on vseg or vrle: segment s fetched by the warp (seg_woff,
// seg_nsym, the code area and the symbol list at once by cp.async into
// buf; then a side row over the code area, or a continued run-length
// segment's granules after it), c mapped to its local code by a warp
// count over the list, and the select (SWAR on fixed-width and side
// rows, slots on run-length rows).  buf: the warp's c_buf_words words.
template <int L>
__device__ __forceinline__ int warp_row_select(const femto::FmView& ix,
                                               unsigned s, int c, int want,
                                               int lane, unsigned* buf) {
  const unsigned* row = femto::row_of(ix, s);
  unsigned* list = buf + femto::row_stream_words(ix);
  __syncwarp();  // the last step's reads of buf are done
  const int woff = __ldg(ix.seg_woff + s);
  const int nsym = L == femto::kVrle ? __ldg(ix.seg_nsym + s) : 0;
  femto::warp_copy_words(buf, row, ix.code_words, lane);
  femto::warp_copy_words(list, row + ix.off_syms, ix.off_mk - ix.off_syms,
                         lane);
  femto::cp_async_wait_warp();
  const auto smem_word = [&](int i) { return buf[i]; };
  if (woff > 0) {
    // a side segment: its global codes in the side table
    femto::warp_copy_words(buf, femto::side_of(ix, woff), ix.side_words,
                           lane);
    femto::cp_async_wait_warp();
    return warp_select_fields(smem_word, ix.w_side, c, want, ix.seg, lane);
  }
  const int lq = femto::warp_list_code(ix, list, c, lane);
  if constexpr (L == femto::kVrle) {
    if (woff < 0) {
      // a run-length segment; continued (woff < -1): its granules after
      // the code area.  One without a continuation holds its whole
      // stream in the code area.
      int nwords = ix.code_words;
      if (femto::warp_count_fetch2<L>(ix, woff, 0, lane, buf)) {
        femto::cp_async_wait_warp();
        nwords += ix.ngr * ix.G;
      }
      return warp_select_slots(buf, nwords, nsym, lq, want, ix.seg, lane);
    }
  }
  return warp_select_fields(smem_word, ix.w_main, lq, want, ix.seg, lane);
}

// One psi step from row r in [0, n) by the whole warp (every lane holds r
// and gets psi(r); *code the dense code c).  cr: C in the lanes'
// registers (entry i in lane i % 32's cr[i / 32], INT_MAX past K); Cs: C
// in shared memory; buf: the warp's buffer (row tiers).
template <int L>
__device__ __forceinline__ int warp_psi_step(const femto::FmView& ix, int r,
                                             int lane,
                                             const int (&cr)[kRowRegs],
                                             const int* Cs, unsigned* buf,
                                             int* code) {
  // 1. c = the number of entries C[0..K] <= r, less one (C ascends)
  int below = 0;
#pragma unroll
  for (int j = 0; j < kRowRegs; ++j) below += cr[j] <= r;
  const int c = __reduce_add_sync(kAllLanes, below) - 1;
  *code = c;
  const int k = r - Cs[c];
  // 2. the largest s in [lo, hi] with ckpt_base(s, c) <= k: lane j probes
  // lo + ceil((j + 1) N / 33) of the N segments of [lo, hi]; the lanes
  // whose pivot holds (a prefix: ckpt_base ascends in s) give the new lo,
  // the first that does not the new hi.  base: ckpt_base(lo, c), the
  // first segment's read beside the first round's probes.
  unsigned lo = 0, hi = static_cast<unsigned>(ix.n_seg - 1);
  int base = probe_base<L>(ix, 0u, c);
  while (lo < hi) {
    const unsigned long long N = hi - lo + 1;
    const unsigned q =
        lo + static_cast<unsigned>(((lane + 1) * N + 32) / 33);
    const bool in = q <= hi;
    const int v = in ? probe_base<L>(ix, q, c) : 0;
    const int t = __popc(__ballot_sync(kAllLanes, in && v <= k));
    const unsigned q_next = __shfl_sync(kAllLanes, q, t & 31);
    const unsigned q_held = __shfl_sync(kAllLanes, q, (t + 31) & 31);
    const int v_held = __shfl_sync(kAllLanes, v, (t + 31) & 31);
    if (t < 32) hi = min(hi, q_next - 1);
    if (t > 0) {
      lo = q_held;
      base = v_held;
    }
  }
  // 3. the (k - base + 1)-th occurrence of c in segment lo
  const int want = k - base;
  int col;
  if constexpr (femto::is_row<L>()) {
    col = warp_row_select<L>(ix, lo, c, want, lane, buf);
  } else if constexpr (L == femto::kPacked) {
    const unsigned* row = static_cast<const unsigned*>(ix.bwt) +
                          static_cast<long long>(lo) * ix.W;
    col = warp_select_fields([&](int i) { return __ldg(row + i); }, ix.bits,
                             c, want, ix.seg, lane);
  } else {
    col = warp_select_u16(static_cast<const uint16_t*>(ix.bwt) +
                              static_cast<long long>(lo) * ix.seg,
                          ix.seg, c, want, lane);
  }
  return static_cast<int>(lo) * ix.seg + col;
}

// psi_walk_kernel's walks, a warp each (blockDim.x / 32 walks a block).
template <int L>
__global__ void __launch_bounds__(kWarpWalks * 32) psi_walk_warp_kernel(
    femto::FmView ix, const int* __restrict__ rows, int B, int num_steps,
    int* __restrict__ chars, int buf_words) {
  extern __shared__ unsigned smem[];
  femto::block_load_c(ix, smem, true);
  const int* Cs = reinterpret_cast<const int*>(smem);
  const int* rev = Cs + ix.K + 1;
  const bool remapped = ix.alpha_rev != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  unsigned* buf = smem + femto::warp_buf_start(ix) + warp * buf_words;
  int cr[kRowRegs];
#pragma unroll
  for (int j = 0; j < kRowRegs; ++j) {
    const int i = lane + 32 * j;
    cr[j] = i <= ix.K ? Cs[i] : 0x7fffffff;
  }
  const int n = Cs[ix.K];
  int r = rows[b];
  int* out = chars + static_cast<long long>(b) * num_steps;
  int mine = 0;  // lane t % 32 keeps step t's symbol until 32 are stored
  for (int t = 0; t < num_steps; ++t) {
    int ch = femto::kInvalidAlpha;
    if (r >= 0 && r < n) {  // outside [0, n) (invalid input): no read
      int c;
      r = warp_psi_step<L>(ix, r, lane, cr, Cs, buf, &c);
      ch = remapped ? rev[c] : c;
    }
    if (lane == (t & 31)) mine = ch;
    if ((t & 31) == 31 || t == num_steps - 1) {
      const int t0 = t & ~31;
      if (t0 + lane <= t) out[t0 + lane] = mine;
    }
  }
}

// The largest call that takes the warp route on an index.  Builds with
// -DFEMTO_E_WARP_MAX=0 (every call a thread a walk) or 0x7fffffff (every
// call a warp a walk) let chip_smoke.py and chip_e_routes.py hold each
// route against the other.
#ifndef FEMTO_E_WARP_MAX
#define FEMTO_E_WARP_MAX -1
#endif
// chip_e_routes.py (NVIDIA H100 80GB HBM3, 700 W; each route forced, in
// turns, CUDA events): both routes of a 64-step walk on the five layouts
// at seg 256, 1024 and 2048 over zipf text (no side or continued
// segment) and English prose, at every power of two B from 256 to 2^18.
// The warp route leads at small B, by 4-7x at seg 256 and 10-44x at seg
// 2048 (a thread scans a 2048-symbol row a word or a slot at a time); the
// thread route, whose step costs fewer instructions once the card is
// full, leads at large B on short segments (up to 3.2x at 2^17 walks,
// prose vseg seg 256).  They cross near 16k walks at seg 256 on every
// layout, 32k-64k at seg 1024 and 2048 on packed and vseg, never inside
// the sweep on full and compact past seg 256; on vrle near 16k-64k, but
// never inside the sweep past seg 256 where continued run-length
// segments exist (the thread route walks their slots a load after the
// last).  Hence a limit in 1024s by layout and seg (up to 256, up to
// 1024, more; -1: none), the continued segments' row for vrle; each
// swept call within 13% of the faster route.
constexpr int kEWarpMaxK[6][3] = {
    {16, -1, -1},   // full
    {16, -1, -1},   // compact
    {16, 64, -1},   // packed
    {16, 32, 64},   // vseg
    {16, 16, 64},   // vrle
    {32, -1, -1}};  // vrle with continued run-length segments

int psi_warp_max(const femto::FmView& ix) {
  if (FEMTO_E_WARP_MAX >= 0) return FEMTO_E_WARP_MAX;
  const int segs = ix.seg <= 256 ? 0 : ix.seg <= 1024 ? 1 : 2;
  const int row = ix.layout == femto::kVrle && ix.ngr > 0 ? 5 : ix.layout;
  const int k = kEWarpMaxK[row][segs];
  return k < 0 ? 0x7fffffff : k * 1024;
}

// The route of a call of B walks: the warp route's dynamic shared memory
// a block in bytes (blocks of min(B, kWarpWalks) warps: C, alpha_rev and
// a c_buf_words buffer a warp), 0 on the thread route -- past
// psi_warp_max, where C does not fit the lanes' registers or where the
// block's shared memory would not fit an SM.
long long psi_route_smem(const femto::FmView& ix, int B, int* buf_words) {
  *buf_words = femto::c_buf_words(ix);
  const int walks = B < kWarpWalks ? B : kWarpWalks;
  const long long bytes =
      4ll * (femto::warp_buf_start(ix) +
             static_cast<long long>(walks) * *buf_words);
  return B > 0 && ix.layout >= 0 && ix.layout <= femto::kVrle &&
                 B <= psi_warp_max(ix) && ix.K + 1 <= 32 * kRowRegs &&
                 bytes <= 227 * 1024
             ? bytes
             : 0;
}

}  // namespace

// rows int32[B] (in [0, n)) -> chars int32[B, num_steps]: the first symbol
// of each row's suffix and of the num_steps - 1 suffixes after it.  The
// route by psi_route_smem.
extern "C" int femto_psi_walk(const femto::FmView* ix, const void* rows,
                              int B, int num_steps, void* chars,
                              void* stream) {
  if (B <= 0 || num_steps <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int buf_words = 0;
  const long long smem = psi_route_smem(*ix, B, &buf_words);
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    if (smem > 0) {
      femto::launch_warps(psi_walk_warp_kernel<L>, B, smem, st, *ix,
                          static_cast<const int*>(rows), B, num_steps,
                          static_cast<int*>(chars), buf_words);
    } else {
      psi_walk_kernel<L><<<(B + 127) / 128, 128, 0, st>>>(
          *ix, static_cast<const int*>(rows), B, num_steps,
          static_cast<int*>(chars));
    }
  });
}

// The route a call of B walks on the view takes (psi_route_smem): the
// warp route's dynamic shared memory a block in bytes, 0 on the thread
// route.
extern "C" long long femto_psi_walk_route(const femto::FmView* ix, int B) {
  int buf_words = 0;
  return psi_route_smem(*ix, B, &buf_words);
}
