// Kernel D, lf_walk: LF-mapping walks over the full, compact, packed,
// vseg and vrle layouts (one instantiation each), two entry points, and
// the two steps of paged locate (femto_tpu/paged.py, K16) on the row tiers.
//
// locate replaces femto_tpu/ops/search_ops.py locate_rows (115) with
// ops/rank.py lf_grank_step (883), mark_rank (821) and mark_offset (842):
// walk LF until the row is marked (at most mark_period + 1 checks), take
// its mark rank from mark_ckpt + popcounts of the segment's bitmap words,
// and decode the bit-packed mark value.  extract replaces
// ops/search_ops.py extract_backward (342): walk num_steps times, emitting
// the symbol of each row (dense codes unmapped through alpha_rev, as
// rank.py unmap_char does).
//
// The TPU walked every lane in lockstep for the longest walk and gathered
// whole [B, seg] rows per step; here each thread walks its own row and
// stops at its own mark, so there is no lockstep tail (the reason
// femto_tpu's locate_rows_pyramid exists), and each step reads only the
// segment prefix it counts.  On the row tiers (vseg, vrle; K11-K13) one
// serving row gives the code, the symbol list, the checkpoint, the count
// and the marks, as femto_tpu's one-row walk step (ops/rank.py
// lf_grank_step 895-911) does; a run-length segment is read by a walk
// over its slots that stops at the position it needs.
//
// lf_walk_step replaces femto_tpu/paged.py _walk_step (73): ONE step of
// the walk above per launch, its state (row, mark rank, step, done) kept
// per lane in device memory between launches, so that the host can fault
// in the rows of the next step (paged serving reads every row through the
// view's seg_slot).  A done lane is left as it is; a marked lane takes its
// mark rank and the step number i; any other lane steps LF.
// resolve_marks replaces paged.py _resolve_marks (86): mark_offset(g) +
// steps per lane, after the walk.  Both are one thread per lane; their
// bound is the bytes of one row prefix per live lane (lf_walk_step) and of
// the lane arrays and two or three mark_vals words a lane (resolve_marks).
//
// Bound on the H100: bytes of dependent random gathers.  Per step: one
// mark word, one symbol (word), the checkpoint and the counted row prefix;
// per hit the segment's mark words, one mark_ckpt int and two or three
// mark_vals words.  chip_smoke.py sums those over this run's steps and
// divides by 3.35 TB/s; the walk itself is a chain of dependent loads, so
// latency, not bandwidth, is what this kernel meets.
#include "fm_common.cuh"

namespace {

// One LF step from row r: LF(r) = C[c] + occ(c, r) with c = the code at r.
// Returns -1 (and leaves *code the pad code) on a pad row.
template <int L>
__device__ __forceinline__ long long lf_step(const femto::FmView& ix,
                                             long long r, int* code) {
  const long long s = r / ix.seg;
  const int off = static_cast<int>(r - s * ix.seg);
  if constexpr (femto::is_row<L>()) {
    // the count is of the row's own (local) code, as the JAX step does
    const unsigned* row = femto::row_of(ix, s);
    const int woff = __ldg(ix.seg_woff + s);
    const int lc = femto::row_lane_code<L>(ix, row, s, woff, off);
    const int c = woff > 0 ? lc : femto::row_global(ix, row, lc);
    *code = c;
    if (c >= ix.K) return -1;
    return static_cast<long long>(__ldg(ix.C + c)) +
           femto::ckpt_base<L>(ix, s, c) +
           femto::row_within<L>(ix, row, s, woff, lc, off);
  }
  const int c = femto::code_at<L>(ix, s, off);
  *code = c;
  if (c >= ix.K) return -1;
  return static_cast<long long>(__ldg(ix.C + c)) +
         femto::ckpt_base<L>(ix, s, c) + femto::count_prefix<L>(ix, s, off, c);
}

// ops/rank.py mark_offset: decode the packed store's slot g.
// mark_meta = [bits, exc_base, period, exc_off (words), cap].
__device__ __forceinline__ int mark_offset(const unsigned* __restrict__ mv,
                                           long long mv_len,
                                           const int* __restrict__ mm, int g) {
  const int bits = __ldg(mm + 0), exc_base = __ldg(mm + 1);
  const int period = __ldg(mm + 2), exc_off = __ldg(mm + 3);
  const int cap = __ldg(mm + 4);
  g = min(max(g, 0), cap - 1);
  const long long bp = static_cast<long long>(g) * bits;
  const long long wi = bp >> 5;
  const unsigned sh = static_cast<unsigned>(bp & 31);
  const unsigned lo = __ldg(mv + wi) >> sh;
  const unsigned hi = sh == 0 ? 0u : (__ldg(mv + wi + 1) << (32u - sh));
  const unsigned mask = (1u << bits) - 1u;
  const int k = static_cast<int>((lo | hi) & mask);
  if (k < exc_base) return k * period;
  long long e = static_cast<long long>(exc_off) + (k - exc_base);
  e = min(max(e, 0LL), mv_len - 1);
  return static_cast<int>(__ldg(mv + e));
}

template <int L>
__global__ void lf_locate_kernel(femto::FmView ix,
                                 const int* __restrict__ rows, int B,
                                 const unsigned* __restrict__ mark_bits,
                                 const int* __restrict__ mark_ckpt,
                                 const unsigned* __restrict__ mark_vals,
                                 long long mark_vals_len,
                                 const int* __restrict__ mark_meta,
                                 int mark_period, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int words_per_seg = ix.seg >> 5;
  long long r = rows[b];
  int result = -1;
  for (int i = 0; i <= mark_period && r >= 0; ++i) {
    const long long s = r / ix.seg;
    const int wl = static_cast<int>(r - s * ix.seg) >> 5;
    // the row tiers keep the segment's mark words and checkpoint in its row
    const unsigned* words = femto::is_row<L>()
                                ? femto::row_of(ix, s) + ix.off_mk
                                : mark_bits + s * words_per_seg;
    const unsigned w = __ldg(words + wl);
    const unsigned bit = static_cast<unsigned>(r & 31);
    if ((w >> bit) & 1u) {
      int g = femto::is_row<L>()
                  ? static_cast<int>(__ldg(femto::row_of(ix, s) + ix.off_mck))
                  : __ldg(mark_ckpt + s);
      for (int k = 0; k < wl; ++k) g += __popc(__ldg(words + k));
      g += __popc(w & ((1u << bit) - 1u));
      result = mark_offset(mark_vals, mark_vals_len, mark_meta, g) + i;
      break;
    }
    if (i == mark_period) break;  // no mark within reach: -1
    int c;
    r = lf_step<L>(ix, r, &c);
  }
  out[b] = result;
}

template <int L>
__global__ void lf_extract_kernel(femto::FmView ix,
                                  const int* __restrict__ rows, int B,
                                  int num_steps, int* __restrict__ chars,
                                  int* __restrict__ final_rows) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long r = rows[b];
  int* out = chars + static_cast<long long>(b) * num_steps;
  for (int t = 0; t < num_steps; ++t) {
    int c = femto::kInvalidAlpha;
    if (r >= 0) {
      const long long nxt = lf_step<L>(ix, r, &c);
      if (nxt >= 0) {
        r = nxt;
        c = femto::unmap_char(ix, c);
      }  // a pad row (invalid input) stays put and emits its pad code
    }
    out[t] = c;
  }
  final_rows[b] = static_cast<int>(r);
}

// The mark bit of row r in a row tier's serving row and, when set, its mark
// rank (the checkpoint + popcounts of the segment's earlier mark words).
__device__ __forceinline__ bool row_mark(const femto::FmView& ix,
                                         const unsigned* row, long long r,
                                         long long s, int* grank) {
  const int wl = static_cast<int>(r - s * ix.seg) >> 5;
  const unsigned* words = row + ix.off_mk;
  const unsigned w = __ldg(words + wl);
  const unsigned bit = static_cast<unsigned>(r & 31);
  if (!((w >> bit) & 1u)) return false;
  int g = static_cast<int>(__ldg(row + ix.off_mck));
  for (int k = 0; k < wl; ++k) g += __popc(__ldg(words + k));
  *grank = g + __popc(w & ((1u << bit) - 1u));
  return true;
}

template <int L>
__global__ void lf_walk_step_kernel(
    femto::FmView ix, const int* __restrict__ rows,
    const int* __restrict__ granks, const int* __restrict__ steps,
    const unsigned char* __restrict__ done, int B, int i,
    int* __restrict__ rows_out, int* __restrict__ granks_out,
    int* __restrict__ steps_out, unsigned char* __restrict__ done_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int r = rows[b], g = granks[b], st = steps[b];
  unsigned char d = done[b];
  if (!d) {
    const long long s = r / ix.seg;
    if (row_mark(ix, femto::row_of(ix, s), r, s, &g)) {
      st = i;
      d = 1;
    } else {
      int c;
      r = static_cast<int>(lf_step<L>(ix, r, &c));
    }
  }
  rows_out[b] = r;
  granks_out[b] = g;
  steps_out[b] = st;
  done_out[b] = d;
}

__global__ void resolve_marks_kernel(const int* __restrict__ granks,
                                     const int* __restrict__ steps, int B,
                                     const unsigned* __restrict__ mark_vals,
                                     long long mark_vals_len,
                                     const int* __restrict__ mark_meta,
                                     int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  out[b] = mark_offset(mark_vals, mark_vals_len, mark_meta, granks[b]) +
           steps[b];
}

}  // namespace

// rows int32[B] -> offsets int32[B] (-1 where no mark was reached).
extern "C" int femto_lf_locate(const femto::FmView* ix, const void* rows,
                               int B, const void* mark_bits,
                               const void* mark_ckpt, const void* mark_vals,
                               long long mark_vals_len, const void* mark_meta,
                               int mark_period, void* out, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    lf_locate_kernel<L><<<(B + 127) / 128, 128, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        *ix, static_cast<const int*>(rows), B,
        static_cast<const unsigned*>(mark_bits),
        static_cast<const int*>(mark_ckpt),
        static_cast<const unsigned*>(mark_vals), mark_vals_len,
        static_cast<const int*>(mark_meta), mark_period,
        static_cast<int*>(out));
  });
}

// rows int32[B] -> chars int32[B, num_steps], final_rows int32[B].
extern "C" int femto_lf_extract(const femto::FmView* ix, const void* rows,
                                int B, int num_steps, void* chars,
                                void* final_rows, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return femto::dispatch_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    lf_extract_kernel<L><<<(B + 127) / 128, 128, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        *ix, static_cast<const int*>(rows), B, num_steps,
        static_cast<int*>(chars), static_cast<int*>(final_rows));
  });
}

// One paged locate step on a row-tier view: (rows, granks, steps int32[B],
// done uint8[B]) and the step number i -> the same four after the step.
extern "C" int femto_lf_walk_step(const femto::FmView* ix, const void* rows,
                                  const void* granks, const void* steps,
                                  const void* done, int B, int i,
                                  void* rows_out, void* granks_out,
                                  void* steps_out, void* done_out,
                                  void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return femto::dispatch_row_layout(*ix, [&](auto layout) {
    constexpr int L = decltype(layout)::value;
    lf_walk_step_kernel<L><<<(B + 127) / 128, 128, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        *ix, static_cast<const int*>(rows), static_cast<const int*>(granks),
        static_cast<const int*>(steps),
        static_cast<const unsigned char*>(done), B, i,
        static_cast<int*>(rows_out), static_cast<int*>(granks_out),
        static_cast<int*>(steps_out), static_cast<unsigned char*>(done_out));
  });
}

// granks, steps int32[B] -> mark_offset(granks) + steps int32[B].
extern "C" int femto_resolve_marks(const void* granks, const void* steps,
                                   int B, const void* mark_vals,
                                   long long mark_vals_len,
                                   const void* mark_meta, void* out,
                                   void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  resolve_marks_kernel<<<(B + 127) / 128, 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(granks), static_cast<const int*>(steps), B,
      static_cast<const unsigned*>(mark_vals), mark_vals_len,
      static_cast<const int*>(mark_meta), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
