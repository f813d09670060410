// Shared device helpers of the port's FM-index kernels: one view of the
// index over the five row layouts it serves.
//
// Layouts (femto_tpu_torch/fmindex.py FMArrays, identical to femto_tpu's):
//   full     bwt uint16[n_seg, seg] symbols, INVALID_ALPHA past row n;
//            occ_ckpt int32[n_seg, K] occurrences of c in bwt[0 : s*seg)
//   compact  bwt as full; occ_ckpt uint16[n_seg, K] relative to its
//            group's row occ_l1 int32[n_seg/grp, K]
//   packed   the compact checkpoints over K dense codes, and bwt
//            uint32[n_seg, W] holding per_word codes of `bits` bits per
//            word (pad code all ones in `bits`, >= K)
//   vseg     bwt uint32[n_seg, row_words], one serving row per segment
//            (ops/rank.py VsegGeom): [code area code_words | symbol list
//            (S u8 or u16 entries, sorted, pads the dtype's max) | mark
//            words seg/32 | mark checkpoint | uint16 relative checkpoints
//            in pairs] over occ_l1; the code area holds LOCAL codes (ranks
//            in the list) at w_main bits; seg_woff[s] > 0 sends segment s
//            to row seg_woff[s] of the side table seg_ovf (GLOBAL codes at
//            w_side bits)
//   vrle     the vseg row; a segment with seg_woff < 0 holds run-length
//            slots (local code << lenbits | length, 6/8/10 bits by its
//            symbol count seg_nsym) in its code area, continued, when
//            seg_woff < -1, in the flat store seg_cont uint32[X, G] from
//            granule row (-seg_woff - 2) / G on (ngr rows are one fetch)
//   C int32[K+1], C[c] = number of codes < c.  K = 261 on the identity
//   tiers; alpha_map (symbol -> dense code or -1) and alpha_rev (dense
//   code -> symbol) are non-null when the index is remapped.
//   Paged serving (femto_tpu_torch/paged.py, row tiers only): bwt is a
//   row cache uint32[cache_rows, row_words] and seg_slot int32[n_seg]
//   maps each true segment id to its cache slot (slot 0 a dummy row);
//   n_seg stays the true segment count and every other per-segment array
//   is indexed by the true id.
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

enum Layout : int { kFull = 0, kCompact = 1, kPacked = 2, kVseg = 3,
                    kVrle = 4 };

template <int L>
__host__ __device__ constexpr bool is_row() {
  return L == kVseg || L == kVrle;
}

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
  // row tiers (vseg, vrle)
  const unsigned* seg_ovf;        // uint32[n_side, side_words]
  const unsigned char* seg_nsym;  // uint8[n_seg]
  const int* seg_woff;            // int32[n_seg]
  const unsigned* seg_cont;       // uint32[X, G] or null (ngr == 0)
  int row_words;   // words per serving row
  int code_words;  // words of the code area (the slot stream's main part)
  int w_main;      // bits per fixed-width local code
  int off_syms;    // row offsets of the symbol list, the mark words, the
  int off_mk;      // mark checkpoint and the relative checkpoints
  int off_mck;
  int off_rel;
  int S;           // symbol-list entries
  int wide;        // u16 entries (else u8)
  int w_side;      // bits per side-table code
  int side_words;
  int n_side;      // rows of seg_ovf (1: none but the dummy)
  int G;           // words per continuation granule row
  int ngr;         // granule rows a segment's continuation window reads
  long long X;     // granule rows in seg_cont
  const int* seg_slot;  // int32[n_seg] cache slots (paged serving) or null
};

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

// The symbols of an 8-symbol uint16 chunk equal to c (cc = c in both
// halves of a word): bit i set where symbol i is.
__device__ __forceinline__ unsigned eq8_u16(const uint4& q, unsigned cc) {
  const unsigned e0 = __vcmpeq2(q.x, cc), e1 = __vcmpeq2(q.y, cc);
  const unsigned e2 = __vcmpeq2(q.z, cc), e3 = __vcmpeq2(q.w, cc);
  // each equal half-word is 0xFFFF
  return (e0 & 1u) | ((e0 >> 15) & 2u) | ((e1 & 1u) << 2) |
         ((e1 >> 13) & 8u) | ((e2 & 1u) << 4) | ((e2 >> 11) & 32u) |
         ((e3 & 1u) << 6) | ((e3 >> 9) & 128u);
}

// The first v of the per fields (w bits each) of a word: none for v <= 0,
// all for v >= per.
__device__ __forceinline__ unsigned keep_fields(int v, int per, int w) {
  return v >= per ? 0xffffffffu : v <= 0 ? 0u : (1u << (v * w)) - 1u;
}

// The first v symbols of an 8-symbol chunk (eq8_u16's bits).
__device__ __forceinline__ unsigned keep8(int v) {
  return v >= 8 ? 0xffu : v <= 0 ? 0u : (1u << v) - 1u;
}

// Occurrences of c among symbols [from, to) of one uint16 segment row.
// The row starts 16-byte aligned (seg % 32 == 0), so whole 8-symbol chunks
// are read with one 16-byte load each and compared two symbols at a time
// (__vcmpeq2 sets 16 bits per equal half-word); the partial first and
// last chunks by mask.
__device__ __forceinline__ int count_range_u16(
    const uint16_t* __restrict__ row, int from, int to, int c) {
  if (to <= from) return 0;
  const uint4* v = reinterpret_cast<const uint4*>(row);
  const unsigned cc = static_cast<unsigned>(c) * 0x00010001u;
  const int i0 = from >> 3, i1 = to >> 3;
  int cnt = 0, bits = 0, i = i0;
  if (from & 7) {  // the first chunk, partial
    cnt += __popc(eq8_u16(__ldg(v + i0), cc) & keep8(to - 8 * i0) &
                  ~keep8(from & 7));
    i = i0 + 1;
  }
  for (; i < i1; ++i) {
    const uint4 q = __ldg(v + i);
    bits += __popc(__vcmpeq2(q.x, cc)) + __popc(__vcmpeq2(q.y, cc)) +
            __popc(__vcmpeq2(q.z, cc)) + __popc(__vcmpeq2(q.w, cc));
  }
  cnt += bits >> 4;  // each equal half-word set 16 bits
  if ((to & 7) && i1 >= i)  // the last chunk, partial
    cnt += __popc(eq8_u16(__ldg(v + i1), cc) & keep8(to & 7));
  return cnt;
}

// Fields of `w` bits equal to lq among fields [from, to) of words
// (ops/rank.py count_eq_packed): XOR with lq in every field, zero fields
// to their bit 0, popcount, the partial first and last words by mask.
// lq outside [0, 2^w), or to <= from, counts nothing.
__device__ __forceinline__ int swar_count_range(
    const unsigned* __restrict__ words, int w, int lq, int from, int to) {
  if (lq < 0 || lq >= (1 << w) || to <= from) return 0;
  const int per = 32 / w;
  const unsigned lsbs = field_lsbs(w, per);
  const unsigned rep = static_cast<unsigned>(lq) * lsbs;
  const int i0 = from / per, i1 = to / per;
  int cnt = 0, i = i0;
  if (from > i0 * per) {  // the first word, partial
    cnt += __popc(zero_fields(__ldg(words + i0) ^ rep, w, lsbs) &
                  keep_fields(to - i0 * per, per, w) &
                  ~keep_fields(from - i0 * per, per, w));
    i = i0 + 1;
  }
  for (; i < i1; ++i)
    cnt += __popc(zero_fields(__ldg(words + i) ^ rep, w, lsbs));
  if (to > i1 * per && i1 >= i)  // the last word, partial
    cnt += __popc(zero_fields(__ldg(words + i1) ^ rep, w, lsbs) &
                  keep_fields(to - i1 * per, per, w));
  return cnt;
}

// The w-bit field at position off of words.
__device__ __forceinline__ int field_at(const unsigned* __restrict__ words,
                                        int w, int off) {
  const int per = 32 / w;
  const int wi = off / per;
  return static_cast<int>((__ldg(words + wi) >> ((off - wi * per) * w)) &
                          ((1u << w) - 1u));
}

// ---- row tiers (vseg, vrle): ops/rank.py VsegGeom, RowCtx ----

// ops/rank.py vrle_slot_geom: the slot width (6/8/10 bits) and length bits
// of a segment with n symbols (symbol width ceil(log2(max(n, 2))), <= 6).
__device__ __forceinline__ void slot_geom(int n, int* w_slot, int* lenbits) {
  const int ws = 1 + (n > 2) + (n > 4) + (n > 8) + (n > 16) + (n > 32);
  *w_slot = 6 + 2 * ((ws > 2) + (ws > 4));
  *lenbits = *w_slot - ws;
}

// The build kernels' symbol -> local code table of one segment, filled by
// its warp: the number of the segment's listed dense codes (list: smax
// sorted entries, pads above every code) below the symbol's dense code
// amap[sym] -- its rank when listed; 0 for symbols outside the alphabet.
__device__ __forceinline__ void local_code_table(
    unsigned char* tab, const int* amap, const int* __restrict__ list,
    int smax, int lane) {
  for (int sym = lane; sym < kAlpha; sym += 32) {
    const int d = amap[sym];
    int lo = 0, hi = smax;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(list + mid) < d) lo = mid + 1; else hi = mid;
    }
    tab[sym] = static_cast<unsigned char>(d < 0 ? 0 : lo);
  }
  __syncwarp();
}

// The serving row of true segment s: through seg_slot when the index is
// paged (PagedIndex maps every segment a launch touches before it).
__device__ __forceinline__ const unsigned* row_of(const FmView& ix,
                                                  long long s) {
  if (ix.seg_slot != nullptr) s = __ldg(ix.seg_slot + s);
  return static_cast<const unsigned*>(ix.bwt) + s * ix.row_words;
}

// Entry k of the row's sorted symbol list.
__device__ __forceinline__ int row_sym(const FmView& ix,
                                       const unsigned* __restrict__ row,
                                       int k) {
  if (ix.wide)
    return static_cast<int>(
        (__ldg(row + ix.off_syms + (k >> 1)) >> ((k & 1) * 16)) & 0xFFFFu);
  return static_cast<int>(
      (__ldg(row + ix.off_syms + (k >> 2)) >> ((k & 3) * 8)) & 0xFFu);
}

// Local code of dense code c in the row's list (the number of entries
// below c), -1 when the entry there is not c (ops/rank.py query_code).
__device__ __forceinline__ int row_query_code(const FmView& ix,
                                              const unsigned* row, int c) {
  int lo = 0, hi = ix.S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row_sym(ix, row, mid) < c) lo = mid + 1; else hi = mid;
  }
  return row_sym(ix, row, min(lo, ix.S - 1)) == c ? lo : -1;
}

// Dense code of local code lc (the list entry, lc clipped to the list).
__device__ __forceinline__ int row_global(const FmView& ix,
                                          const unsigned* row, int lc) {
  return row_sym(ix, row, min(max(lc, 0), ix.S - 1));
}

__device__ __forceinline__ const unsigned* side_of(const FmView& ix,
                                                   int woff) {
  return ix.seg_ovf +
         static_cast<long long>(min(max(woff, 0), ix.n_side - 1)) *
             ix.side_words;
}

// One run-length segment's slot stream: the code area's words, then the
// ngr granule rows of the flat continuation store from the segment's
// offset (rows clamped to the store; a segment without a continuation
// reads offset 0).  Every slot past the segment's true stream starts at
// >= seg (the true lengths sum to seg), so a walk that stops at the
// position it looks for never reads it as data.
struct SlotStream {
  const unsigned* row;
  const unsigned* cont;  // granule row g0 of seg_cont, or null
  long long cont_rows;   // granule rows left from g0 (>= 1 when cont)
  int G, code_words, nwords, w, lenbits;
};

__device__ __forceinline__ SlotStream slot_stream(const FmView& ix,
                                                  const unsigned* row,
                                                  long long s, int woff) {
  SlotStream st;
  st.row = row;
  st.code_words = ix.code_words;
  st.G = ix.G;
  st.cont = nullptr;
  st.cont_rows = 0;
  st.nwords = ix.code_words + ix.ngr * ix.G;
  if (ix.ngr > 0) {
    const long long g0 = static_cast<long long>(max(-woff - 2, 0)) / ix.G;
    const long long g = min(g0, ix.X - 1);
    st.cont = ix.seg_cont + g * ix.G;
    st.cont_rows = ix.X - g;
  }
  slot_geom(__ldg(ix.seg_nsym + s), &st.w, &st.lenbits);
  return st;
}

__device__ __forceinline__ unsigned stream_word(const SlotStream& st, int t) {
  if (t < st.code_words) return __ldg(st.row + t);
  t -= st.code_words;
  const long long g = min(static_cast<long long>(t / st.G), st.cont_rows - 1);
  return __ldg(st.cont + g * st.G + (t % st.G));
}

// Walk the slots in order: visit(lsym, start, len) returns false to stop.
template <class F>
__device__ __forceinline__ void walk_slots(const SlotStream& st, F&& visit) {
  const int kmax = (st.nwords * 32) / st.w;
  const unsigned mask = (1u << st.w) - 1u;
  const unsigned lmask = (1u << st.lenbits) - 1u;
  int start = 0;
  for (int k = 0; k < kmax; ++k) {
    const int bit = k * st.w;
    const int wi = bit >> 5, sh = bit & 31;
    unsigned v = stream_word(st, wi) >> sh;
    if (sh + st.w > 32) v |= stream_word(st, wi + 1) << (32 - sh);
    v &= mask;
    const int len = static_cast<int>(v & lmask);
    if (!visit(static_cast<int>(v >> st.lenbits), start, len)) return;
    start += len;
  }
}

// Occurrences of local code lq among positions [from, to) of a run-length
// stream: each slot's overlap with the span, the walk stopping at the
// first slot that starts at or past `to`.
__device__ __forceinline__ int slots_count_range(const SlotStream& st, int lq,
                                                 int from, int to) {
  int cnt = 0;
  walk_slots(st, [&](int lsym, int start, int len) {
    if (start >= to) return false;
    if (lsym == lq) cnt += max(min(start + len, to) - max(start, from), 0);
    return true;
  });
  return cnt;
}

// Local code at position off (0 past the stream).
__device__ __forceinline__ int slots_code_at(const SlotStream& st, int off) {
  int code = 0;
  walk_slots(st, [&](int lsym, int start, int len) {
    if (start > off) return false;
    if (off < start + len) {
      code = lsym;
      return false;
    }
    return true;
  });
  return code;
}

// Per-lane code at offset off of row-tier segment s: local on main lanes,
// global on side lanes (*side set); ops/rank.py RowCtx.code_at.
template <int L>
__device__ __forceinline__ int row_lane_code(const FmView& ix,
                                             const unsigned* row, long long s,
                                             int woff, int off) {
  if (woff > 0) return field_at(side_of(ix, woff), ix.w_side, off);
  if constexpr (L == kVrle) {
    if (woff < 0) return slots_code_at(slot_stream(ix, row, s, woff), off);
  }
  return field_at(row, ix.w_main, off);
}

// Occurrences of per-lane code lq among positions [from, to) of segment s
// (ops/rank.py RowCtx.within at from = 0).
template <int L>
__device__ __forceinline__ int row_within(const FmView& ix,
                                          const unsigned* row, long long s,
                                          int woff, int lq, int from,
                                          int to) {
  if (woff > 0)
    return swar_count_range(side_of(ix, woff), ix.w_side, lq, from, to);
  if constexpr (L == kVrle) {
    if (woff < 0)
      return slots_count_range(slot_stream(ix, row, s, woff), lq, from, to);
  }
  return swar_count_range(row, ix.w_main, lq, from, to);
}

template <int L>
__device__ __forceinline__ int code_at(const FmView& ix, long long s,
                                       int off) {
  if constexpr (is_row<L>()) {
    const unsigned* row = row_of(ix, s);
    const int woff = __ldg(ix.seg_woff + s);
    const int lc = row_lane_code<L>(ix, row, s, woff, off);
    return woff > 0 ? lc : row_global(ix, row, lc);
  } else if constexpr (L == kPacked) {
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
  } else if constexpr (is_row<L>()) {
    const unsigned w = __ldg(row_of(ix, s) + ix.off_rel + (c >> 1));
    return __ldg(ix.occ_l1 + (s / ix.grp) * ix.K + c) +
           static_cast<int>((w >> ((c & 1) * 16)) & 0xFFFFu);
  } else {
    const int rel = __ldg(static_cast<const uint16_t*>(ix.occ_ckpt) +
                          s * ix.K + c);
    return __ldg(ix.occ_l1 + (s / ix.grp) * ix.K + c) + rel;
  }
}

// Occurrences of dense code c among rows [from, to) of segment s (from
// 0: its prefix).
template <int L>
__device__ __forceinline__ int count_range(const FmView& ix, long long s,
                                           int from, int to, int c) {
  if constexpr (is_row<L>()) {
    const unsigned* row = row_of(ix, s);
    const int woff = __ldg(ix.seg_woff + s);
    const int lq = woff > 0 ? c : row_query_code(ix, row, c);
    return row_within<L>(ix, row, s, woff, lq, from, to);
  } else if constexpr (L == kPacked) {
    // packed codes are `bits`-wide fields (per_word == 32 / bits), c below
    // the pad code
    return swar_count_range(static_cast<const unsigned*>(ix.bwt) + s * ix.W,
                            ix.bits, c, from, to);
  } else {
    return count_range_u16(
        static_cast<const uint16_t*>(ix.bwt) + s * ix.seg, from, to, c);
  }
}

// occ(c, r) for a valid dense code c (ops/rank.py _occ_dense): r at or past
// the last segment's end counts every occurrence of c.
template <int L>
__device__ __forceinline__ int occ(const FmView& ix, int c, long long r) {
  if (r >= ix.n_seg * ix.seg) return __ldg(ix.C + c + 1) - __ldg(ix.C + c);
  const long long s = r / ix.seg;
  const int off = static_cast<int>(r - s * ix.seg);
  return ckpt_base<L>(ix, s, c) + count_range<L>(ix, s, 0, off, c);
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
    case kVseg: launch(std::integral_constant<int, kVseg>{}); break;
    case kVrle: launch(std::integral_constant<int, kVrle>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dispatch_layout for the entries that serve the row tiers only (the paged
// steps): any other layout is refused.
template <class F>
int dispatch_row_layout(const FmView& ix, F&& launch) {
  switch (ix.layout) {
    case kVseg: launch(std::integral_constant<int, kVseg>{}); break;
    case kVrle: launch(std::integral_constant<int, kVrle>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- warp helpers: one warp walks one row (lf_walk.cu's warp route) ----

constexpr unsigned kAllLanes = 0xffffffffu;
// entries of a checkpoint row a lane holds: ceil(kAlpha / 32)
constexpr int kRowRegs = (kAlpha + 31) / 32;

// Asynchronous copy of one word from global to shared memory (cp.async:
// no register is staged, so a lane issues all of its copies at once).
__device__ __forceinline__ void cp_async4(unsigned* dst,
                                          const unsigned* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Wait for the lane's copies, then make every lane's visible to the warp.
__device__ __forceinline__ void cp_async_wait_warp() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Words [0, n) of src to dst, the lanes taking every 32nd word.
__device__ __forceinline__ void warp_copy_words(unsigned* dst,
                                                const unsigned* src, int n,
                                                int lane) {
  for (int i = lane; i < n; i += 32) cp_async4(dst + i, src + i);
}

// Entries [0, K) of a checkpoint row into registers, entry k in lane
// k % 32's v[k / 32]: every load issued before any is used.
template <class T>
__device__ __forceinline__ void warp_row_regs(const T* __restrict__ row,
                                              int K, int lane,
                                              int (&v)[kRowRegs]) {
#pragma unroll
  for (int j = 0; j < kRowRegs; ++j) {
    const int k = lane + 32 * j;
    v[j] = k < K ? static_cast<int>(__ldg(row + k)) : 0;
  }
}

// Entry c (the same on every lane) of a row that warp_row_regs loaded: a
// shuffle of every register (a select by c >> 5 of the lane's own would
// become an indexed load from local memory).
__device__ __forceinline__ int warp_pick(const int (&v)[kRowRegs], int c) {
  int x = 0;
#pragma unroll
  for (int j = 0; j < kRowRegs; ++j) {
    const int y = __shfl_sync(kAllLanes, v[j], c & 31);
    x = j == (c >> 5) ? y : x;
  }
  return x;
}

// Symbols of an 8-symbol uint16 chunk equal to c among its first `valid`
// symbols (valid >= 8: all of them).
__device__ __forceinline__ int count8_u16(const uint4& q, unsigned cc,
                                          int valid) {
  return __popc(eq8_u16(q, cc) & keep8(valid));
}

// Inclusive sum of x over the lanes up to this one.
__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAllLanes, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// swar_count_range from 0 over words in shared memory, the lanes taking
// every 32nd word: fields of `w` bits equal to lq among the first `off`
// fields, the whole warp's sum on every lane.
__device__ __forceinline__ int warp_swar_count(const unsigned* words, int w,
                                               int lq, int off, int lane) {
  if (lq < 0 || lq >= (1 << w)) return 0;
  const int per = 32 / w;
  const unsigned lsbs = field_lsbs(w, per);
  const unsigned rep = static_cast<unsigned>(lq) * lsbs;
  const int nfull = off / per;
  const int rem = off - nfull * per;
  int cnt = 0;
  for (int i = lane; i < nfull; i += 32)
    cnt += __popc(zero_fields(words[i] ^ rep, w, lsbs));
  if (rem > 0 && lane == 0)
    cnt += __popc(zero_fields(words[nfull] ^ rep, w, lsbs) & lsbs &
                  ((1u << (rem * w)) - 1u));
  return __reduce_add_sync(kAllLanes, cnt);
}

// The w-bit field at position off of words in shared memory.
__device__ __forceinline__ int smem_field(const unsigned* words, int w,
                                          int off) {
  const int per = 32 / w;
  const int wi = off / per;
  return static_cast<int>((words[wi] >> ((off - wi * per) * w)) &
                          ((1u << w) - 1u));
}

// Slot k of a run-length stream in shared memory (nwords words, w-bit
// slots: local code << lenbits | length).
__device__ __forceinline__ void smem_slot(const unsigned* words, int w,
                                          int lenbits, int k, int* lsym,
                                          int* len) {
  const int bit = k * w;
  const int wi = bit >> 5, sh = bit & 31;
  unsigned v = words[wi] >> sh;
  if (sh + w > 32) v |= words[wi + 1] << (32 - sh);
  v &= (1u << w) - 1u;
  *len = static_cast<int>(v & ((1u << lenbits) - 1u));
  *lsym = static_cast<int>(v >> lenbits);
}

// slots_code_at and slots_count_range (from 0) of a stream in shared
// memory, a slot a lane and 32 slots a round: the local code lq at
// position off (0 where no slot holds it) and its occurrences among the
// first off positions, from two passes over the slots, each a warp scan
// of the lengths a round (the first stops at the slot that holds off,
// the second where the slots start at or past off).  Every lane returns
// both.
__device__ __forceinline__ void warp_slots(const unsigned* words, int nwords,
                                           int nsym, int off, int lane,
                                           int* lq_out, int* cnt_out) {
  int w, lenbits;
  slot_geom(nsym, &w, &lenbits);
  const int kmax = (nwords * 32) / w;
  int lq = 0, carry = 0;
  for (int base = 0; base < kmax && carry <= off; base += 32) {
    const int k = base + lane;
    int ls = 0, len = 0;
    if (k < kmax) smem_slot(words, w, lenbits, k, &ls, &len);
    const int incl = warp_inclusive_sum(len, lane);
    const int start = carry + incl - len;
    const unsigned hit =
        __ballot_sync(kAllLanes, k < kmax && start <= off && off < start + len);
    if (hit) {
      lq = __shfl_sync(kAllLanes, ls, __ffs(hit) - 1);
      break;
    }
    carry += __shfl_sync(kAllLanes, incl, 31);
  }
  int cnt = 0;
  carry = 0;
  for (int base = 0; base < kmax && carry < off; base += 32) {
    const int k = base + lane;
    int ls = 0, len = 0;
    if (k < kmax) smem_slot(words, w, lenbits, k, &ls, &len);
    const int incl = warp_inclusive_sum(len, lane);
    const int start = carry + incl - len;
    if (k < kmax && ls == lq && start < off) cnt += min(off - start, len);
    carry += __shfl_sync(kAllLanes, incl, 31);
  }
  *lq_out = lq;
  *cnt_out = __reduce_add_sync(kAllLanes, cnt);
}

// ---- kernel D's warp step on the row tiers, shared by csrc/lf_walk.cu
// (extract, locate and the paged lf_walk_step) and csrc/dist_query.cu
// (K18f owner_lf, the owner's answer of a routed locate step) ----
//
// One warp serves one row: warp_row_fetch issues every load that depends
// only on the row at once (the L1 checkpoint row into registers; the code
// area, the symbol list, the relative checkpoints and, for locate, the
// mark words and the mark checkpoint into the warp's shared-memory buffer
// by cp.async), warp_row_mark reads the mark bit and rank from it, and
// warp_row_lf decodes, counts and steps LF from it: one dependent DRAM
// round trip a step, two on a side segment or a continued run-length
// segment.  warp_route_smem is the one rule that picks the warp route or
// a thread a row for every such entry, on the number of walks a call
// makes (warp_route_max); a build with -DFEMTO_D_WARP_MAX=0 or
// 0x7fffffff forces one route in either source.

// walks (warps) a block on the warp route
constexpr int kWarpWalks = 4;

// Words of the warp route's shared-memory stream area on a row tier: the
// code area with its continuation granules (vrle) or a side row, the
// larger.
__host__ __device__ __forceinline__ int row_stream_words(
    const femto::FmView& ix) {
  const int code = ix.code_words + (ix.layout == femto::kVrle
                                        ? ix.ngr * ix.G : 0);
  return code > ix.side_words ? code : ix.side_words;
}

// A warp's shared-memory buffer on a row tier, in words: the stream area,
// then the serving row from its symbol list to its end (the symbol list,
// the mark words, the mark checkpoint and the relative checkpoints, at
// their row offsets less off_syms).
__host__ __device__ __forceinline__ int row_buf_words(
    const femto::FmView& ix) {
  return row_stream_words(ix) + ix.row_words - ix.off_syms;
}

// What one warp step fetched of row r's segment s (warp_row_fetch): the
// row's offset in it, its side or run-length word, its symbol count and
// the segment's L1 checkpoint row (entry k in lane k % 32's l1[k / 32]).
struct RowFetch {
  long long s;
  int off, woff, nsym;
  int l1[femto::kRowRegs];
};

// The first round trip of a warp step from row r on vseg or vrle: every
// load that depends only on the row, issued at once -- the L1 row into
// registers, seg_woff and seg_nsym, and by cp.async into buf the code area
// (vrle: all of it, as a run-length segment is read by a walk over its
// slots; vseg: the prefix up to off's word), the symbol list and the
// relative checkpoints and, when `marks`, the mark words and the mark
// checkpoint between them (then the row from off_syms on is one
// contiguous copy) -- then waited for.
template <int L>
__device__ __forceinline__ void warp_row_fetch(const femto::FmView& ix,
                                               long long r, bool marks,
                                               int lane, unsigned* buf,
                                               RowFetch& f) {
  // rows lie below 2^31: a 32-bit division, 64-bit offsets after it
  const unsigned su =
      static_cast<unsigned>(r) / static_cast<unsigned>(ix.seg);
  f.off = static_cast<int>(static_cast<unsigned>(r) -
                           su * static_cast<unsigned>(ix.seg));
  f.s = su;
  unsigned* tail = buf + row_stream_words(ix);
  __syncwarp();  // the last step's reads of buf are done
  const unsigned* row = femto::row_of(ix, f.s);
  f.woff = __ldg(ix.seg_woff + f.s);
  f.nsym = 0;
  if constexpr (L == femto::kVrle) f.nsym = __ldg(ix.seg_nsym + f.s);
  femto::warp_row_regs(ix.occ_l1 + (f.s / ix.grp) * ix.K, ix.K, lane, f.l1);
  const int ncode = L == femto::kVrle ? ix.code_words
                                      : f.off / (32 / ix.w_main) + 1;
  femto::warp_copy_words(buf, row, ncode, lane);
  if (marks) {
    femto::warp_copy_words(tail, row + ix.off_syms,
                           ix.row_words - ix.off_syms, lane);
  } else {
    femto::warp_copy_words(tail, row + ix.off_syms, ix.off_mk - ix.off_syms,
                           lane);
    femto::warp_copy_words(tail + (ix.off_rel - ix.off_syms),
                           row + ix.off_rel, ix.row_words - ix.off_rel,
                           lane);
  }
  femto::cp_async_wait_warp();
}

// The mark bit of the fetched row (warp_row_fetch with marks) and, when
// set, its mark rank: the mark checkpoint, the popcounts of the segment's
// earlier mark words (a word a lane, then a warp sum) and of the bits
// below it in its own word.  Every lane returns the same.
__device__ __forceinline__ bool warp_row_mark(const femto::FmView& ix,
                                              const unsigned* buf,
                                              const RowFetch& f, int lane,
                                              int* grank) {
  const unsigned* tail = buf + row_stream_words(ix);
  const unsigned* words = tail + (ix.off_mk - ix.off_syms);
  const int wl = f.off >> 5;
  const unsigned w = words[wl];
  const unsigned bit = static_cast<unsigned>(f.off & 31);
  if (!((w >> bit) & 1u)) return false;
  int g = 0;
  for (int k = lane; k < wl; k += 32) g += __popc(words[k]);
  g = __reduce_add_sync(femto::kAllLanes, g);
  *grank = g + static_cast<int>(tail[ix.off_mck - ix.off_syms]) +
           __popc(w & ((1u << bit) - 1u));
  return true;
}

// The LF step from the fetched row: LF(r) = C[c] + occ(c, r), the count of
// the row's own (local) code as lf_step's, decoded and counted from buf
// (a side segment first copies its side row, a continued run-length
// segment its ngr granule rows: the second round trip, addresses from
// seg_woff); *code the dense code, -1 on a pad row.  Cs: C in shared
// memory.
template <int L>
__device__ __forceinline__ long long warp_row_lf(const femto::FmView& ix,
                                                 const RowFetch& f, int lane,
                                                 const int* Cs,
                                                 unsigned* buf, int* code) {
  const unsigned* tail = buf + row_stream_words(ix);
  const int off = f.off, woff = f.woff;
  int lc, cnt;
  if (woff > 0) {
    // a side segment: its global codes in the side table
    femto::warp_copy_words(buf, femto::side_of(ix, woff),
                           off / (32 / ix.w_side) + 1, lane);
    femto::cp_async_wait_warp();
    lc = femto::smem_field(buf, ix.w_side, off);
    cnt = femto::warp_swar_count(buf, ix.w_side, lc, off, lane);
  } else if (L == femto::kVrle && woff < 0) {
    // a run-length segment; continued (woff < -1): its ngr granule rows
    // after the code area, read as SlotStream reads them.  A segment
    // without a continuation holds its whole stream in the code area, so
    // its walk stops there.
    int nwords = ix.code_words;
    if (woff < -1 && ix.ngr > 0) {
      const long long g0 = static_cast<long long>(-woff - 2) / ix.G;
      const long long g = min(g0, ix.X - 1);
      const int total = ix.ngr * ix.G;
      for (int t = lane; t < total; t += 32) {
        const int i = t / ix.G;
        femto::cp_async4(buf + ix.code_words + t,
                         ix.seg_cont + min(g + i, ix.X - 1) * ix.G +
                             (t - i * ix.G));
      }
      femto::cp_async_wait_warp();
      nwords += total;
    }
    femto::warp_slots(buf, nwords, f.nsym, off, lane, &lc, &cnt);
  } else {
    lc = femto::smem_field(buf, ix.w_main, off);
    cnt = femto::warp_swar_count(buf, ix.w_main, lc, off, lane);
  }
  int c = lc;
  if (woff <= 0) {
    const int k = min(max(lc, 0), ix.S - 1);
    c = ix.wide ? static_cast<int>((tail[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu)
                : static_cast<int>((tail[k >> 2] >> ((k & 3) * 8)) & 0xFFu);
  }
  *code = c;
  if (c >= ix.K) return -1;
  const unsigned w = tail[(ix.off_rel - ix.off_syms) + (c >> 1)];
  return static_cast<long long>(Cs[c]) + femto::warp_pick(f.l1, c) +
         static_cast<int>((w >> ((c & 1) * 16)) & 0xFFFFu) + cnt;
}

// One locate step from row r >= 0 on vseg or vrle, by the whole warp (the
// thread route's row_mark, then lf_step): one fetch with the marks; true,
// with *grank its mark rank, where r is marked; else, when `step`, *r
// becomes LF(r) (-1 on a pad row) from the same fetch.
template <int L>
__device__ __forceinline__ bool warp_locate_row(const femto::FmView& ix,
                                                long long* r, bool step,
                                                int lane, const int* Cs,
                                                unsigned* buf, int* grank) {
  RowFetch f;
  warp_row_fetch<L>(ix, *r, true, lane, buf, f);
  if (warp_row_mark(ix, buf, f, lane, grank)) return true;
  if (step) {
    int c;
    *r = warp_row_lf<L>(ix, f, lane, Cs, buf, &c);
  }
  return false;
}

// The warp route's dynamic shared memory, in words from its start: C
// (K + 1 ints), alpha_rev (K ints, read by extract when the index is
// remapped), then row_buf_words words a warp on the row tiers.
__host__ __device__ __forceinline__ int warp_buf_start(
    const femto::FmView& ix) {
  return 2 * ix.K + 1;
}

// C into shared memory (and alpha_rev, when `rev` and the index is
// remapped), by the whole block.
__device__ __forceinline__ void block_load_c(const femto::FmView& ix,
                                             unsigned* smem, bool rev) {
  int* Cs = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i <= ix.K; i += blockDim.x)
    Cs[i] = __ldg(ix.C + i);
  if (rev && ix.alpha_rev != nullptr)
    for (int i = threadIdx.x; i < ix.K; i += blockDim.x)
      Cs[ix.K + 1 + i] = __ldg(ix.alpha_rev + i);
  __syncthreads();
}

// ---- the all-symbol rank of one row: occ(c, r) for every dense code c at
// once (csrc/regex_frontier.cu regex_fork's row route, csrc/dist_query.cu
// masked_occ_rows) ----
//
// One warp ranks one row: the checkpoint row, then one pass over the
// row's prefix [0, off) that adds each field (or run) to a counter of its
// code in shared memory, then rank[c] = checkpoint + the counter of c's
// code.  On vseg and vrle the fetch is D's warp_row_fetch without the
// marks (one dependent round trip; a side segment or a continued
// run-length segment a second one), and the counters are per local code,
// read through the symbol list; on full, compact and packed the lanes
// read the checkpoint row and the prefix from global memory and count
// into rank itself.  A rank of every code of a row so costs one decode of
// the row, where femto::occ decodes it once per code.  row_rank_min is
// the one rule that picks it or femto::occ per code; a build with
// -DFEMTO_R_ROW_RANK=0 (never) or =1 (always) forces one route.

// Words of a warp's scratch for warp_rank_row: on vseg and vrle the row
// buffer and kAlpha counters, none on full, compact and packed.
__host__ __device__ __forceinline__ int rank_scratch_words(
    const femto::FmView& ix) {
  return ix.layout == femto::kVseg || ix.layout == femto::kVrle
             ? row_buf_words(ix) + femto::kAlpha
             : 0;
}

// Entry k of a symbol list copied to shared memory (u8 or u16 entries).
__device__ __forceinline__ int smem_list_sym(const femto::FmView& ix,
                                             const unsigned* list, int k) {
  return ix.wide ? static_cast<int>((list[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu)
                 : static_cast<int>((list[k >> 2] >> ((k & 3) * 8)) & 0xFFu);
}

// One to cnt[v] for each of the first `off` w-bit fields v of words (a
// word a lane) below `limit`: the fields at or past it match no code.
__device__ __forceinline__ void warp_count_fields(const unsigned* words,
                                                  int w, int off, int limit,
                                                  int lane, int* cnt) {
  const int per = 32 / w;
  const unsigned mask = (1u << w) - 1u;
  const int nw = (off + per - 1) / per;
  for (int i = lane; i < nw; i += 32) {
    const unsigned x = words[i];
    const int nf = min(per, off - i * per);
    for (int k = 0; k < nf; ++k) {
      const int v = static_cast<int>((x >> (k * w)) & mask);
      if (v < limit) atomicAdd(cnt + v, 1);
    }
  }
}

// Each run-length slot's length before off to cnt[its local code] (a
// slot a lane, 32 slots a round, the starts from a warp scan of the
// lengths; slots_count_range's clamp-sum for every code at once).
__device__ __forceinline__ void warp_count_slots(const unsigned* words,
                                                 int nwords, int nsym,
                                                 int off, int lane,
                                                 int* cnt) {
  int w, lenbits;
  femto::slot_geom(nsym, &w, &lenbits);
  const int kmax = (nwords * 32) / w;
  int carry = 0;
  for (int base = 0; base < kmax && carry < off; base += 32) {
    const int k = base + lane;
    int ls = 0, len = 0;
    if (k < kmax) femto::smem_slot(words, w, lenbits, k, &ls, &len);
    const int incl = femto::warp_inclusive_sum(len, lane);
    const int start = carry + incl - len;
    if (k < kmax && start < off && len > 0 && ls < femto::kAlpha)
      atomicAdd(cnt + ls, min(off - start, len));
    carry += __shfl_sync(femto::kAllLanes, incl, 31);
  }
}

// rank[c] = occ(c, r) for every dense code c < K (femto::occ's answer),
// by the whole warp; rank is shared memory (K ints), complete on every
// lane at return.  scratch: rank_scratch_words(ix) words of shared memory
// (none on full, compact and packed).
template <int L>
__device__ __forceinline__ void warp_rank_row(const femto::FmView& ix,
                                              long long r, int lane,
                                              unsigned* scratch, int* rank) {
  if (r >= ix.n_seg * ix.seg) {
    for (int c = lane; c < ix.K; c += 32)
      rank[c] = __ldg(ix.C + c + 1) - __ldg(ix.C + c);
    __syncwarp();
    return;
  }
  if constexpr (femto::is_row<L>()) {
    int* cnt = reinterpret_cast<int*>(scratch + row_buf_words(ix));
    for (int c = lane; c < femto::kAlpha; c += 32) cnt[c] = 0;
    RowFetch f;
    warp_row_fetch<L>(ix, r, false, lane, scratch, f);
    const unsigned* tail = scratch + row_stream_words(ix);
    const unsigned* rel = tail + (ix.off_rel - ix.off_syms);
#pragma unroll
    for (int j = 0; j < femto::kRowRegs; ++j) {
      const int c = lane + 32 * j;
      if (c < ix.K)
        rank[c] = f.l1[j] +
                  static_cast<int>((rel[c >> 1] >> ((c & 1) * 16)) & 0xFFFFu);
    }
    const int off = f.off, woff = f.woff;
    if (woff > 0) {
      // a side segment: its global codes count into rank itself
      femto::warp_copy_words(scratch, femto::side_of(ix, woff),
                             off / (32 / ix.w_side) + 1, lane);
      femto::cp_async_wait_warp();
      warp_count_fields(scratch, ix.w_side, off, ix.K, lane, rank);
      __syncwarp();
      return;
    }
    if (L == femto::kVrle && woff < 0) {
      // a run-length segment, its continuation read as warp_row_lf reads
      // it
      int nwords = ix.code_words;
      if (woff < -1 && ix.ngr > 0) {
        const long long g0 = static_cast<long long>(-woff - 2) / ix.G;
        const long long g = min(g0, ix.X - 1);
        const int total = ix.ngr * ix.G;
        for (int t = lane; t < total; t += 32) {
          const int i = t / ix.G;
          femto::cp_async4(scratch + ix.code_words + t,
                           ix.seg_cont + min(g + i, ix.X - 1) * ix.G +
                               (t - i * ix.G));
        }
        femto::cp_async_wait_warp();
        nwords += total;
      }
      warp_count_slots(scratch, nwords, f.nsym, off, lane, cnt);
    } else {
      warp_count_fields(scratch, ix.w_main, off, femto::kAlpha, lane, cnt);
    }
    __syncwarp();
    // c's local code is the first entry of the sorted list that equals c
    // (row_query_code's lower bound)
    for (int lc = lane; lc < ix.S && lc < femto::kAlpha; lc += 32) {
      const int c = smem_list_sym(ix, tail, lc);
      if (c < ix.K && (lc == 0 || smem_list_sym(ix, tail, lc - 1) != c))
        rank[c] += cnt[lc];
    }
    __syncwarp();
  } else {
    const long long s = r / ix.seg;
    const int off = static_cast<int>(r - s * ix.seg);
    for (int c = lane; c < ix.K; c += 32)
      rank[c] = femto::ckpt_base<L>(ix, s, c);
    __syncwarp();
    if constexpr (L == femto::kPacked) {
      warp_count_fields(static_cast<const unsigned*>(ix.bwt) + s * ix.W,
                        ix.bits, off, ix.K, lane, rank);
    } else {
      // 8 uint16 symbols a 16-byte load (rows are 16-byte aligned)
      const uint4* v = reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(ix.bwt) + s * ix.seg);
      const int nv = (off + 7) >> 3;
      for (int i = lane; i < nv; i += 32) {
        const uint4 q = __ldg(v + i);
        const unsigned wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          const int c = static_cast<int>((wd[h >> 1] >> ((h & 1) * 16)) &
                                         0xFFFFu);
          if (i * 8 + h < off && c < ix.K) atomicAdd(rank + c, 1);
        }
      }
    }
    __syncwarp();
  }
}

// The fewest codes a rank of one row must answer for warp_rank_row to
// take them (else femto::occ a code): builds with -DFEMTO_R_ROW_RANK=0
// (never) or =1 (always, even for none) let chip_smoke.py and
// chip_rank_routes.py hold each route against the other.
#ifndef FEMTO_R_ROW_RANK
#define FEMTO_R_ROW_RANK -1
#endif
// chip_rank_routes.py (H100, device time queued behind a spin kernel):
// regex_fork at layers of 256-400 entries that rank 1, 2, 4, 8, 16 or 26
// codes each and at approximate layers, on all five layouts at seg 256
// and 2048 on zipf, prose and a/c/g/t text, the rows route ahead at every
// count from one code on (at one code 1.03-1.44x at seg 256, 1.6-6.6x at
// seg 2048); masked_occ_rows' rows route ahead of a thread a lane at
// every K from 5 to 261 (1.1-60x, 350 and 14,412 rows).  Hence one rule
// for every layout and seg: rows wherever a row is ranked for any code.
constexpr int kRowRankMin = 1;

__host__ __device__ __forceinline__ int row_rank_min() {
  if (FEMTO_R_ROW_RANK == 0) return 0x7fffffff;
  if (FEMTO_R_ROW_RANK == 1) return 0;
  return kRowRankMin;
}

// The largest batch that takes the warp route on an index.  Builds with
// -DFEMTO_D_WARP_MAX=0 (every call a thread a walk) or 0x7fffffff (every
// call a warp a walk) let chip_smoke.py hold each route against the other.
#ifndef FEMTO_D_WARP_MAX
#define FEMTO_D_WARP_MAX -1
#endif
// chip_d_routes.py (H100): on full, compact and packed the thread route
// draws level at 8192 walks of 32 steps and leads from 16384 (it moves a
// row prefix a step, the warp route a checkpoint row and the prefix in
// whole chunks).  On vseg and vrle the thread route's step scans the row
// prefix a field at a time and walks a run-length segment's slots a load
// after the last, so it costs more the longer the segment and where side
// or continued run-length segments exist; the warp route's step is one
// round trip.  Extract, locate and the paged step cross at about the same
// B: zipf text (neither kind of segment) near 8192 walks at seg 256,
// 131,072 at seg 1024 and 2^19 at seg 2048; English prose (side
// segments; vrle also continued ones) at 4 and 8 times those, past 2^20
// at seg 2048.  Hence kWarpMaxFixed x (seg / 256)^2, 4 times that with
// side or continued segments, 8 times with continued ones.
constexpr int kWarpMaxFixed = 8192;

inline int warp_route_max(const femto::FmView& ix) {
  if (FEMTO_D_WARP_MAX >= 0) return FEMTO_D_WARP_MAX;
  if (ix.layout != femto::kVseg && ix.layout != femto::kVrle)
    return kWarpMaxFixed;
  const bool cont = ix.ngr > 0, side = ix.n_side > 1;
  const double r = ix.seg / 256.0;
  const double max = kWarpMaxFixed * r * r * (cont ? 8 : side ? 4 : 1);
  return max < 0x7fffffff ? static_cast<int>(max) : 0x7fffffff;
}

// The route of a call of B walks, one rule for every entry: extract on
// every layout; locate, the paged step and owner_lf (csrc/dist_query.cu)
// on vseg and vrle (on full, compact and packed those keep a thread a
// walk).  The warp
// route's block holds min(B, kWarpWalks) warps; returns its dynamic
// shared memory in bytes, with *buf_words each warp's share (0 on full,
// compact and packed), or 0 where the call takes the thread route: past
// warp_route_max, where a checkpoint row does not fit the warp's
// registers, or where the block's shared memory would not fit an SM.
inline long long warp_route_smem(const femto::FmView& ix, int B,
                                 bool extract, int* buf_words) {
  const bool row = ix.layout == femto::kVseg || ix.layout == femto::kVrle;
  *buf_words = row ? row_buf_words(ix) : 0;
  const int walks = B < kWarpWalks ? B : kWarpWalks;
  const long long bytes =
      4ll * (warp_buf_start(ix) + static_cast<long long>(walks) * *buf_words);
  const bool warp = B > 0 && (extract || row) &&
                    B <= warp_route_max(ix) &&
                    ix.K <= 32 * femto::kRowRegs && bytes <= 227 * 1024;
  return warp ? bytes : 0;
}

// Launch `kernel` on the warp route: blocks of min(B, kWarpWalks) warps
// with `bytes` of dynamic shared memory (opted in past 48 KiB).
template <class K, class... A>
void launch_warps(K kernel, int B, long long bytes, cudaStream_t st,
                  A... args) {
  const int walks = B < kWarpWalks ? B : kWarpWalks;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  kernel<<<(B + walks - 1) / walks, walks * 32, static_cast<size_t>(bytes),
           st>>>(args...);
}

// ---- kernel C's count step (csrc/backward_search.cu): both ends of a
// range from one read of a segment where they share it ----
//
// A step's symbol, and so its dense code c, is known before any row is
// read.  Where first and last lie in one segment, occ(c, last) - occ(c,
// first) is the count of c between their offsets, so one checkpoint read
// and one pass over the prefix up to the larger offset serve both ranks
// (the thread route, a thread a pattern: count_range from the first end's
// offset; the warp route's counts below).  The warp route steps a pattern (or a lane) a
// warp: for each end inside the segments it issues at once c's
// checkpoint (full: one int; compact, packed and the row tiers: the L1
// int and the uint16 relative entry) and the segment's prefix up to the
// offset -- on full, compact and packed into the lanes' registers (16-B
// chunks or words, the lanes taking every 32nd), on vseg and vrle into
// the warp's shared memory by cp.async with the symbol list (the code
// area up to the offset's word; vrle: all of it, as a run-length segment
// is read by a walk over its slots) -- and waits once: one dependent DRAM
// round trip a step for both ranks, two on a side segment (its side row)
// or a continued run-length segment (its granules), whose addresses come
// from seg_woff.  Unlike D's step (warp_row_fetch), whose code comes
// from the row, no checkpoint row is read whole.  c_route_smem is the
// rule that picks the route for all four of C's entries; builds with
// -DFEMTO_C_WARP_MAX=0 or 0x7fffffff force one route.

// warp_swar_count at two offsets: fields equal to lq among the first offA
// (*cA) and offB (*cB) fields of words in shared memory, the lanes taking
// every 32nd word of the longer prefix; the warp's sums on every lane.
__device__ __forceinline__ void warp_swar_count2(const unsigned* words, int w,
                                                 int lq, int offA, int offB,
                                                 int lane, int* cA, int* cB) {
  int a = 0, b = 0;
  if (lq >= 0 && lq < (1 << w)) {
    const int per = 32 / w;
    const unsigned lsbs = field_lsbs(w, per);
    const unsigned rep = static_cast<unsigned>(lq) * lsbs;
    const int nw = (max(offA, offB) + per - 1) / per;
    for (int i = lane; i < nw; i += 32) {
      const unsigned z = zero_fields(words[i] ^ rep, w, lsbs);
      a += __popc(z & keep_fields(offA - i * per, per, w));
      b += __popc(z & keep_fields(offB - i * per, per, w));
    }
  }
  *cA = __reduce_add_sync(kAllLanes, a);
  *cB = __reduce_add_sync(kAllLanes, b);
}

// slots_count_range from 0 at two offsets over a run-length stream in
// shared memory (nwords words), a slot a lane and 32 slots a round, the
// starts from a warp scan of the lengths, up to the round whose slots
// reach the larger offset; local code lq (-1: absent, counts nothing).
// The warp's sums on every lane.
__device__ __forceinline__ void warp_slots_count2(const unsigned* words,
                                                  int nwords, int nsym,
                                                  int lq, int offA, int offB,
                                                  int lane, int* cA,
                                                  int* cB) {
  int w, lenbits;
  slot_geom(nsym, &w, &lenbits);
  const int kmax = (nwords * 32) / w;
  const int hi = max(offA, offB);
  int a = 0, b = 0, carry = 0;
  for (int base = 0; base < kmax && carry < hi; base += 32) {
    const int k = base + lane;
    int ls = -1, len = 0;
    if (k < kmax) smem_slot(words, w, lenbits, k, &ls, &len);
    const int incl = warp_inclusive_sum(len, lane);
    const int start = carry + incl - len;
    if (ls == lq) {
      a += max(min(offA - start, len), 0);
      b += max(min(offB - start, len), 0);
    }
    carry += __shfl_sync(kAllLanes, incl, 31);
  }
  *cA = __reduce_add_sync(kAllLanes, a);
  *cB = __reduce_add_sync(kAllLanes, b);
}

// Local code of dense code c in a symbol list copied to shared memory:
// row_query_code's lower bound, as the warp's count of the entries below
// c (the list is sorted, its pads above every code), -1 where the entry
// there is not c.
__device__ __forceinline__ int warp_list_code(const FmView& ix,
                                              const unsigned* list, int c,
                                              int lane) {
  int below = 0;
  for (int k = lane; k < ix.S; k += 32)
    below += smem_list_sym(ix, list, k) < c;
  const int lo = __reduce_add_sync(kAllLanes, below);
  return smem_list_sym(ix, list, min(lo, ix.S - 1)) == c ? lo : -1;
}

// 16-B chunks (full, compact) or words (packed) of the counted prefixes a
// lane loads at once in a warp step
constexpr int kCountChunks = 8;

// The warp route's in-segment counts on full, compact or packed: code c
// among the first offA rows of segment sA (*cA; none unless inA) and the
// first offB of sB (*cB; none unless inB) -- the chunks of both prefixes
// issued together, or (shared: both ends in one segment) one pass over
// the longer prefix counted at both offsets.  The warp's sums on every
// lane.
template <int L>
__device__ __forceinline__ void warp_fixed_counts(
    const FmView& ix, int c, long long sA, int offA, bool inA, long long sB,
    int offB, bool inB, bool shared, int lane, int* cA, int* cB) {
  int a = 0, b = 0;
  if constexpr (L == kPacked) {
    const unsigned* bwt = static_cast<const unsigned*>(ix.bwt);
    const unsigned* ra = bwt + (inA ? sA : 0) * ix.W;
    const unsigned* rb = bwt + (inB ? sB : 0) * ix.W;
    const int per = ix.per_word, bits = ix.bits;
    const int nA = inA ? (offA + per - 1) / per : 0;
    const int nB = inB ? (offB + per - 1) / per : 0;
    const int total = shared ? max(nA, nB) : nA + nB;
    const unsigned lsbs = field_lsbs(bits, per);
    const unsigned rep = static_cast<unsigned>(c) * lsbs;
    for (int t0 = 0; t0 < total; t0 += 32 * kCountChunks) {
      unsigned v[kCountChunks];
#pragma unroll
      for (int j = 0; j < kCountChunks; ++j) {
        const int t = t0 + lane + 32 * j;
        v[j] = t < total ? __ldg(shared || t < nA ? ra + t : rb + (t - nA))
                         : 0u;
      }
#pragma unroll
      for (int j = 0; j < kCountChunks; ++j) {
        const int t = t0 + lane + 32 * j;
        if (t >= total) continue;
        const unsigned z = zero_fields(v[j] ^ rep, bits, lsbs);
        if (shared) {
          a += __popc(z & keep_fields(offA - t * per, per, bits));
          b += __popc(z & keep_fields(offB - t * per, per, bits));
        } else if (t < nA) {
          a += __popc(z & keep_fields(offA - t * per, per, bits));
        } else {
          b += __popc(z & keep_fields(offB - (t - nA) * per, per, bits));
        }
      }
    }
  } else {
    const uint16_t* bwt = static_cast<const uint16_t*>(ix.bwt);
    const uint4* ra = reinterpret_cast<const uint4*>(bwt + (inA ? sA : 0) *
                                                               ix.seg);
    const uint4* rb = reinterpret_cast<const uint4*>(bwt + (inB ? sB : 0) *
                                                               ix.seg);
    const int nA = inA ? (offA + 7) >> 3 : 0;
    const int nB = inB ? (offB + 7) >> 3 : 0;
    const int total = shared ? max(nA, nB) : nA + nB;
    const unsigned cc = static_cast<unsigned>(c) * 0x00010001u;
    for (int t0 = 0; t0 < total; t0 += 32 * kCountChunks) {
      uint4 v[kCountChunks];
#pragma unroll
      for (int j = 0; j < kCountChunks; ++j) {
        const int t = t0 + lane + 32 * j;
        if (t < total) v[j] = __ldg(shared || t < nA ? ra + t : rb + (t - nA));
      }
#pragma unroll
      for (int j = 0; j < kCountChunks; ++j) {
        const int t = t0 + lane + 32 * j;
        if (t >= total) continue;
        const unsigned e = eq8_u16(v[j], cc);
        if (shared) {
          a += __popc(e & keep8(offA - 8 * t));
          b += __popc(e & keep8(offB - 8 * t));
        } else if (t < nA) {
          a += __popc(e & keep8(offA - 8 * t));
        } else {
          b += __popc(e & keep8(offB - 8 * (t - nA)));
        }
      }
    }
  }
  *cA = __reduce_add_sync(kAllLanes, a);
  *cB = __reduce_add_sync(kAllLanes, b);
}

// Words of one end's buffer on the row tiers: the stream area (the code
// area with its granules, or a side row) and the symbol list; 0 on full,
// compact and packed, whose counts need no buffer.
__host__ __device__ __forceinline__ int c_buf_words(const FmView& ix) {
  return ix.layout == kVseg || ix.layout == kVrle
             ? row_stream_words(ix) + ix.off_mk - ix.off_syms
             : 0;
}

// The warp route's dynamic shared memory, in words from its start: C (K
// + 1 ints), alpha_map (kAlpha ints, where the index is remapped), then
// two c_buf_words buffers a warp.
__host__ __device__ __forceinline__ int c_smem_start(const FmView& ix) {
  return ix.K + 1 + kAlpha;
}

// One end's first round trip on vseg or vrle from segment s: seg_woff,
// seg_nsym (vrle) and c's L1 int and relative word into registers and, by
// cp.async into buf, the code area up to off's word (vrle: all of it)
// and the symbol list; not waited for.
template <int L>
__device__ __forceinline__ void warp_count_fetch(const FmView& ix,
                                                 long long s, int off, int c,
                                                 int lane, unsigned* buf,
                                                 int* woff, int* nsym,
                                                 int* l1, unsigned* rel) {
  const unsigned* row = row_of(ix, s);
  *woff = __ldg(ix.seg_woff + s);
  *nsym = L == kVrle ? __ldg(ix.seg_nsym + s) : 0;
  // rows lie below 2^31: a 32-bit division
  *l1 = __ldg(ix.occ_l1 +
              static_cast<long long>(static_cast<unsigned>(s) /
                                     static_cast<unsigned>(ix.grp)) *
                  ix.K +
              c);
  *rel = __ldg(row + ix.off_rel + (c >> 1));
  const int ncode = L == kVrle ? ix.code_words : off / (32 / ix.w_main) + 1;
  warp_copy_words(buf, row, ncode, lane);
  warp_copy_words(buf + row_stream_words(ix), row + ix.off_syms,
                  ix.off_mk - ix.off_syms, lane);
}

// One end's second round trip where its segment needs one (woff, the
// segment's seg_woff): a side segment's side row up to off's word over
// the stream area, a continued run-length segment's ngr granule rows
// after the code area (clamped to the store, as SlotStream reads them).
// Returns whether it issued any; not waited for.
template <int L>
__device__ __forceinline__ bool warp_count_fetch2(const FmView& ix, int woff,
                                                  int off, int lane,
                                                  unsigned* buf) {
  if (woff > 0) {
    warp_copy_words(buf, side_of(ix, woff), off / (32 / ix.w_side) + 1,
                    lane);
    return true;
  }
  if (L == kVrle && woff < -1 && ix.ngr > 0) {
    const long long g = min(static_cast<long long>(-woff - 2) / ix.G,
                            ix.X - 1);
    const int total = ix.ngr * ix.G;
    for (int t = lane; t < total; t += 32) {
      const int i = t / ix.G;
      cp_async4(buf + ix.code_words + t,
                ix.seg_cont + min(g + i, ix.X - 1) * ix.G + (t - i * ix.G));
    }
    return true;
  }
  return false;
}

// One end's counts of dense code c from its fetched buffer at two offsets
// (the same twice where the buffer serves one end): the side row's global
// codes, or c's local code in the row's list counted in the run-length
// slots or the fixed-width code area.
template <int L>
__device__ __forceinline__ void warp_count_end(const FmView& ix, int c,
                                               int woff, int nsym,
                                               const unsigned* buf, int offA,
                                               int offB, int lane, int* cA,
                                               int* cB) {
  if (woff > 0) {
    warp_swar_count2(buf, ix.w_side, c, offA, offB, lane, cA, cB);
    return;
  }
  const int lq = warp_list_code(ix, buf + row_stream_words(ix), c, lane);
  if (L == kVrle && woff < 0) {
    const int nwords =
        ix.code_words + (woff < -1 && ix.ngr > 0 ? ix.ngr * ix.G : 0);
    warp_slots_count2(buf, nwords, nsym, lq, offA, offB, lane, cA, cB);
    return;
  }
  warp_swar_count2(buf, ix.w_main, lq, offA, offB, lane, cA, cB);
}

// One FM step of dense code c >= 0 from [*first, *last), by the whole warp
// (every lane holds the range and gets the new one): C[c] + occ(c, .) at
// both ends, an end at or past the segments' end counting every
// occurrence.  Cs: C in shared memory; buf0, buf1: the warp's two
// c_buf_words buffers (row tiers).
template <int L>
__device__ __forceinline__ void warp_count_step(const FmView& ix, int c,
                                                int lane, const int* Cs,
                                                unsigned* buf0,
                                                unsigned* buf1, int* first,
                                                int* last) {
  const long long end = ix.n_seg * ix.seg;
  const int rf = *first, rl = *last;
  const bool in_f = rf < end, in_l = rl < end;
  // rows lie below 2^31: 32-bit divisions, 64-bit offsets after them
  const unsigned seg = static_cast<unsigned>(ix.seg);
  const unsigned sf = static_cast<unsigned>(rf) / seg;
  const unsigned sl = static_cast<unsigned>(rl) / seg;
  const int of = static_cast<int>(static_cast<unsigned>(rf) - sf * seg);
  const int ol = static_cast<int>(static_cast<unsigned>(rl) - sl * seg);
  const bool shared = in_f && in_l && sf == sl;
  const int hi = shared ? max(of, ol) : of;
  int ck_f = 0, ck_l = 0, cf = 0, cl = 0;
  if constexpr (is_row<L>()) {
    __syncwarp();  // the last step's reads of the buffers are done
    int wf = 0, wl = 0, nf = 0, nl = 0, l1f = 0, l1l = 0;
    unsigned relf = 0, rell = 0;
    if (in_f) warp_count_fetch<L>(ix, sf, hi, c, lane, buf0, &wf, &nf, &l1f,
                                  &relf);
    if (in_l && !shared)
      warp_count_fetch<L>(ix, sl, ol, c, lane, buf1, &wl, &nl, &l1l, &rell);
    cp_async_wait_warp();
    bool more = false;
    if (in_f) more |= warp_count_fetch2<L>(ix, wf, hi, lane, buf0);
    if (in_l && !shared) more |= warp_count_fetch2<L>(ix, wl, ol, lane, buf1);
    if (more) cp_async_wait_warp();
    const int sh = (c & 1) * 16;
    if (in_f) {
      ck_f = l1f + static_cast<int>((relf >> sh) & 0xFFFFu);
      int other;
      warp_count_end<L>(ix, c, wf, nf, buf0, of, shared ? ol : of, lane, &cf,
                        &other);
      if (shared) cl = other;
    }
    if (in_l && !shared) {
      ck_l = l1l + static_cast<int>((rell >> sh) & 0xFFFFu);
      int same;
      warp_count_end<L>(ix, c, wl, nl, buf1, ol, ol, lane, &cl, &same);
    }
  } else {
    if (in_f) ck_f = ckpt_base<L>(ix, sf, c);
    if (in_l && !shared) ck_l = ckpt_base<L>(ix, sl, c);
    warp_fixed_counts<L>(ix, c, sf, of, in_f, sl, ol, in_l, shared, lane, &cf,
                         &cl);
  }
  if (shared) ck_l = ck_f;
  const int base = Cs[c], total = Cs[c + 1] - base;
  *first = base + (in_f ? ck_f + cf : total);
  *last = base + (in_l ? ck_l + cl : total);
}

// The largest call that takes C's warp route on an index: B patterns of
// backward_search or backward_search_steps, or B lanes of one step
// (backward_step, backward_step_masked; one_step).  Builds with
// -DFEMTO_C_WARP_MAX=0 (every call a thread a pattern or lane) or
// 0x7fffffff (every call a warp) let chip_smoke.py and chip_c_routes.py
// hold each route against the other.
#ifndef FEMTO_C_WARP_MAX
#define FEMTO_C_WARP_MAX -1
#endif
// chip_c_routes.py (NVIDIA H100 80GB HBM3, 700 W; each route forced, in
// turns, CUDA events; three runs, the geometric mean of each run's
// ratio): both routes of all four entries on the five layouts at seg 256,
// 1024 and 2048 over zipf text (31 codes), English prose (167) and
// a/c/g/t text (5), at every power of two B from 2^10 to 2^20, patterns
// of 16 symbols and one step.  The warp route leads at small B, by up to
// 30x (prose vrle seg 2048, 1024 patterns: a thread route of 8 blocks
// walks 2048-symbol prefixes a load at a time); the thread route, whose
// step costs fewer instructions once the card is full, leads at large B
// on short segments (up to 11x at 2^20 a/c/g/t patterns, vseg seg 256).
// Where they cross grows with seg and depends on the entry kind (one step
// crosses at 1/8 to 4 times the B of 16-step patterns), the layout (up
// to 4x) and the text: at seg 2048 on vseg, 64k patterns on the a/c/g/t
// text, 128k on zipf, past 2^20 on the prose.  The dense alphabet's size
// is the one property of the text that the view holds (packed, vseg and
// vrle); full and compact keep the identity alphabet, so their limits are
// the best for the three texts together.  Hence a limit, in 1024s, for
// each entry kind, layout and alphabet (up to 8 codes, up to 64, more)
// and seg (up to 256, up to 1024, more), the one that keeps each swept
// call within 10% of the faster route where the text is known (full and
// compact: within 25%); none past 2^20, which the sweep did not pass.
constexpr short kCWarpMaxK[2][11][3] = {
    // patterns: full, compact, then packed, vseg and vrle by alphabet
    {{16, 32, 64}, {8, 32, 32},
     {8, 32, 32}, {16, 64, 128}, {32, 512, 1024},
     {8, 32, 64}, {16, 32, 128}, {16, 64, 1024},
     {8, 32, 64}, {16, 32, 64}, {32, 1024, 1024}},
    // one step
    {{2, 32, 256}, {4, 32, 64},
     {1, 32, 64}, {16, 64, 256}, {32, 256, 1024},
     {16, 64, 256}, {16, 32, 128}, {16, 64, 1024},
     {8, 64, 256}, {8, 32, 128}, {32, 1024, 1024}},
};

inline int c_warp_max(const FmView& ix, bool one_step) {
  if (FEMTO_C_WARP_MAX >= 0) return FEMTO_C_WARP_MAX;
  const int alpha = ix.K <= 8 ? 0 : ix.K <= 64 ? 1 : 2;
  const int row = ix.layout == kFull      ? 0
                  : ix.layout == kCompact ? 1
                                          : 2 + 3 * (ix.layout - kPacked) +
                                                alpha;
  const int segs = ix.seg <= 256 ? 0 : ix.seg <= 1024 ? 1 : 2;
  return kCWarpMaxK[one_step ? 1 : 0][row][segs] * 1024;
}

// The route of a call of B patterns (backward_search, _steps) or, with
// one_step, lanes (backward_step, _masked): the warp route's dynamic
// shared memory a block in bytes (blocks of min(B, kWarpWalks) warps), 0
// where the call takes a thread a pattern or lane -- past c_warp_max or
// where the block's shared memory would not fit an SM.  *buf_words:
// c_buf_words.
inline long long c_route_smem(const FmView& ix, int B, bool one_step,
                              int* buf_words) {
  *buf_words = c_buf_words(ix);
  const int warps = B < kWarpWalks ? B : kWarpWalks;
  const long long bytes =
      4ll * (c_smem_start(ix) + 2ll * warps * *buf_words);
  return B > 0 && B <= c_warp_max(ix, one_step) && bytes <= 227 * 1024
             ? bytes
             : 0;
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

// A single-pass scan's decoupled look-back over one int a tile (a sum, or
// with kMax a max), for kernels whose tiles take their numbers from an
// atomic counter, so that every tile a block waits on belongs to a block
// that already runs.  A tile's status word holds a tag in its high half
// (kLbAggregate: the tile's own value, kLbInclusive: the combination of
// every tile up to it, 0: not yet published; one memset zeroes a call's
// words) and the int32 in its low half, in one 64-bit store, so a reader
// never sees a tag without its value.  No tile reads data another tile
// wrote, so no fence orders the words against other stores.
constexpr unsigned long long kLbAggregate = 1, kLbInclusive = 2;

template <bool kMax>
__device__ __forceinline__ int lb_op(int a, int b) {
  return kMax ? max(a, b) : a + b;
}

// Called by the 32 lanes of one warp of tile `tile` with its value `agg`
// (`status`: tile 0's word of the tiles' row).  Publishes agg, combines
// the earlier tiles' words 32 at a time, newest first (lane i reads tile
// - 1 - i; the words up to the nearest inclusive one are taken once all
// of them are published, else the window is read again; without an
// inclusive word all 32 are taken and the window moves on), publishes
// the tile's inclusive word and returns its exclusive prefix (`none`,
// the identity, for tile 0).
template <bool kMax>
__device__ __forceinline__ int warp_lookback(unsigned long long* status,
                                             long long tile, int agg,
                                             int none) {
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* st = status;
  if (tile == 0) {
    if (lane == 0) st[0] = kLbInclusive << 32 | static_cast<unsigned>(agg);
    return none;
  }
  if (lane == 0) st[tile] = kLbAggregate << 32 | static_cast<unsigned>(agg);
  int excl = none;
  for (long long p = tile - 1;;) {
    const long long q = p - lane;
    const unsigned long long w =
        q >= 0 ? st[q] : kLbInclusive << 32 | static_cast<unsigned>(none);
    const unsigned tag = static_cast<unsigned>(w >> 32);
    const unsigned incl = __ballot_sync(0xffffffffu, tag == kLbInclusive);
    const unsigned ready = __ballot_sync(0xffffffffu, tag != 0);
    // lanes 0 .. the nearest inclusive word (all 32 without one)
    const unsigned need = (incl & (0u - incl)) * 2u - 1u;
    if ((ready & need) != need) continue;
    int v = need >> lane & 1u ? static_cast<int>(static_cast<unsigned>(w))
                              : none;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = lb_op<kMax>(v, __shfl_xor_sync(0xffffffffu, v, o));
    excl = lb_op<kMax>(excl, v);
    if (incl) break;
    p -= 32;
  }
  if (lane == 0)
    st[tile] = kLbInclusive << 32 |
               static_cast<unsigned>(lb_op<kMax>(excl, agg));
  return excl;
}

// Sets elements [lo, hi) of p (T: int or unsigned char) to v: this
// thread's share, part of parts, in 16-byte stores where they are
// aligned.
template <typename T>
__device__ __forceinline__ void fill_range(
    T* p, long long lo, long long hi,
    typename std::remove_reference<T>::type v, long long part,
    long long parts) {
  constexpr int kVec = 16 / sizeof(T);
  if (lo >= hi) return;
  const long long mis =
      static_cast<long long>(reinterpret_cast<uintptr_t>(p + lo) & 15) /
      static_cast<long long>(sizeof(T));
  long long a = lo + (mis ? kVec - mis : 0);
  if (a > hi) a = hi;
  const long long nvec = (hi - a) / kVec;
  const long long b = a + nvec * kVec;
  if (part < a - lo) p[lo + part] = v;
  if (part < hi - b) p[b + part] = v;
  const unsigned w = sizeof(T) == 1
                         ? static_cast<unsigned char>(v) * 0x01010101u
                         : static_cast<unsigned>(v);
  uint4* q = reinterpret_cast<uint4*>(p + a);
  for (long long k = part; k < nvec; k += parts) q[k] = make_uint4(w, w, w, w);
}

}  // namespace femto
