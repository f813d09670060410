// Kernel K18f, the sharded queries' shard-side answers: owner_occ,
// masked_occ, owner_lf and masked_lf over the full, compact, packed, vseg
// and vrle layouts (one instantiation each).
//
// Replaces (femto_tpu/parallel/dist_query.py): _occ_owner_compute (216),
// the owner's occ for the (row, dense code) requests the routed count
// (_backward_search_routed_body, 244) sends it; _occ_local_dense (58), each
// shard's masked contribution to the psum count (_backward_search_body,
// 135); _locate_routed_body's owner_answer (320), the owner's (LF, mark
// bit, mark value) of a routed locate step, sent back as one int (the
// value if marked, else -1 - LF); and _locate_body's mark_info plus
// lf_step_sharded (155, 128), the same answer masked by ownership for the
// psum walk.  The exchanges and psums around them are the mesh's.
//
// The view (fm_common.cuh FmView) is the process's shard blocks end to
// end: the checkpoints carry the global base (_package_shard), so a row's
// view segment is its global segment less shard0 * nseg_local, and the
// counts are ckpt_base + count_prefix as kernels C and D compute them.
// mark_vals holds one packed store per local shard (of mv_len / Dl words);
// a mark's slot there is its global rank less the shard's first
// checkpoint.  The shard dimension is blockIdx.y.
//
// The row tiers (vseg, vrle; femto_tpu's _vseg_local_occ and the row
// branch of owner_answer, dist_query.py 44-55 and 326-345) keep per-shard
// numbering: seg_woff's side rows count from 1 within each shard's side
// table (seg_ovf, n_side / Dl rows a shard) and continuation offsets
// from each shard's own flat store (seg_cont, X / Dl granule rows a
// shard).  Each thread serves its shard d = blockIdx.y through a view of
// that shard alone (shard_view: its rows, segment fields, L1 rows, side
// table and store) at the shard-local segment, as femto_tpu's shard_map
// body sees its blocks; the segment's mark words and global mark
// checkpoint ride its serving row, and mark_ckpt int32[Dl] holds each
// local shard's global mark base (femto_tpu's grank - mark_ckpt[0]).
//
// Bound on the H100: bytes of dependent gathers, as kernels C and D: per
// request the checkpoint and the counted row prefix (plus, for LF, the
// code and the segment's mark words and two or three mark_vals words).
#include "fm_common.cuh"

namespace {

using femto::FmView;

// ops/rank.py mark_offset on one shard's store mv[0, mv_len).
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
__device__ __forceinline__ int occ_at(const FmView& ix, long long sl,
                                      int off, int c) {
  return femto::ckpt_base<L>(ix, sl, c) +
         femto::count_prefix<L>(ix, sl, off, c);
}

// A row tier's view of local shard d alone (Dl local shards of nseg_local
// segments each): every per-shard array starts at the shard's block.
template <int L>
__device__ __forceinline__ FmView shard_view(const FmView& ix, int d, int Dl,
                                             long long nseg_local) {
  FmView v = ix;
  if constexpr (femto::is_row<L>()) {
    const long long s0 = d * nseg_local;
    v.bwt = static_cast<const unsigned*>(ix.bwt) + s0 * ix.row_words;
    v.occ_l1 = ix.occ_l1 + (s0 / ix.grp) * ix.K;
    v.seg_nsym = ix.seg_nsym + s0;
    v.seg_woff = ix.seg_woff + s0;
    v.n_side = ix.n_side / Dl;
    v.seg_ovf = ix.seg_ovf +
                static_cast<long long>(d) * v.n_side * ix.side_words;
    if (ix.ngr > 0) {
      v.X = ix.X / Dl;
      v.seg_cont = ix.seg_cont + d * v.X * ix.G;
    }
    v.n_seg = nseg_local;
  }
  return v;
}

struct Marks {
  const unsigned* bits;   // uint32[n_seg, seg / 32] (unused on row tiers)
  const int* ckpt;        // int32[n_seg], global ranks; row tiers: int32[Dl]
                          // global mark bases
  const unsigned* vals;   // Dl stores of store_len words
  long long store_len;
  const int* meta;        // int32[5]
};

// The owner's answer for row r at view segment sl: the mark value if r is
// marked, else -1 - LF(r).
template <int L>
__device__ __forceinline__ int lf_answer(const FmView& ix, long long sl,
                                         long long r, long long nseg_local,
                                         const Marks& mk) {
  const int off = static_cast<int>(r % ix.seg);
  const int c = femto::code_at<L>(ix, sl, off);
  const unsigned* words = mk.bits + sl * (ix.seg >> 5);
  const int wl = off >> 5;
  const unsigned w = __ldg(words + wl);
  const unsigned sh = static_cast<unsigned>(r & 31);
  if (!((w >> sh) & 1u)) {
    const long long lf = static_cast<long long>(__ldg(ix.C + c)) +
                         occ_at<L>(ix, sl, off, c);
    return static_cast<int>(-1 - lf);
  }
  int g = __ldg(mk.ckpt + sl);
  for (int k = 0; k < wl; ++k) g += __popc(__ldg(words + k));
  g += __popc(w & ((1u << sh) - 1u));
  const long long shard = sl / nseg_local;
  const int lrank = g - __ldg(mk.ckpt + shard * nseg_local);
  return mark_offset(mk.vals + shard * mk.store_len, mk.store_len, mk.meta,
                     lrank);
}

// lf_answer on a row tier: v is local shard d's view, sl its segment.  The
// code, the symbol list, the checkpoint, the count, the mark words and the
// global mark checkpoint all come from the one serving row.
template <int L>
__device__ __forceinline__ int lf_answer_row(const FmView& v, long long sl,
                                             long long r, int d,
                                             const Marks& mk) {
  const int off = static_cast<int>(r % v.seg);
  const unsigned* row = femto::row_of(v, sl);
  const unsigned* words = row + v.off_mk;
  const int wl = off >> 5;
  const unsigned w = __ldg(words + wl);
  const unsigned sh = static_cast<unsigned>(r & 31);
  if (!((w >> sh) & 1u)) {
    const int woff = __ldg(v.seg_woff + sl);
    const int lc = femto::row_lane_code<L>(v, row, sl, woff, off);
    const int c = woff > 0 ? lc : femto::row_global(v, row, lc);
    const long long lf = static_cast<long long>(__ldg(v.C + c)) +
                         femto::ckpt_base<L>(v, sl, c) +
                         femto::row_within<L>(v, row, sl, woff, lc, off);
    return static_cast<int>(-1 - lf);
  }
  int g = static_cast<int>(__ldg(row + v.off_mck));
  for (int k = 0; k < wl; ++k) g += __popc(__ldg(words + k));
  g += __popc(w & ((1u << sh) - 1u));
  return mark_offset(mk.vals + d * mk.store_len, mk.store_len, mk.meta,
                     g - __ldg(mk.ckpt + d));
}

template <int L>
__global__ void owner_occ_kernel(FmView ix, long long nseg_local, int shard0,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ cd,
                                 const unsigned char* __restrict__ valid,
                                 long long R, long long n_rows_total,
                                 int* __restrict__ out) {
  const int d = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const long long k = d * R + i;
  const int c = cd[k];
  int res = 0;
  if (valid[k] && c >= 0) {
    const long long r = rows[k];
    if (r >= n_rows_total) {
      res = __ldg(ix.C + c + 1) - __ldg(ix.C + c);
    } else {
      const long long s = r / ix.seg;
      const int off = min(max(static_cast<int>(r - s * ix.seg), 0),
                          ix.seg - 1);
      if constexpr (femto::is_row<L>()) {
        // the shard's own segment, clipped to its block (femto_tpu's
        // _occ_owner_compute)
        const FmView v = shard_view<L>(ix, d, gridDim.y, nseg_local);
        long long sl = s - (static_cast<long long>(shard0) + d) * nseg_local;
        sl = min(max(sl, 0LL), nseg_local - 1);
        res = occ_at<L>(v, sl, off, c);
      } else {
        long long sl = s - static_cast<long long>(shard0) * nseg_local;
        sl = min(max(sl, 0LL), ix.n_seg - 1);
        res = occ_at<L>(ix, sl, off, c);
      }
    }
  }
  out[k] = res;
}

template <int L>
__global__ void masked_occ_kernel(FmView ix, long long nseg_local,
                                  int shard0, const int* __restrict__ cd,
                                  const int* __restrict__ r, long long B,
                                  long long n_rows_total,
                                  int* __restrict__ out) {
  const int d = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int c = cd[i];
  const long long g = shard0 + d;
  int res = 0;
  if (c >= 0) {
    const long long rr = r[i];
    if (rr >= n_rows_total) {
      if (g == 0) res = __ldg(ix.C + c + 1) - __ldg(ix.C + c);
    } else {
      const long long s = rr / ix.seg;
      const long long slg = s - g * nseg_local;
      if (slg >= 0 && slg < nseg_local) {
        const int off = static_cast<int>(rr - s * ix.seg);
        if constexpr (femto::is_row<L>())
          res = occ_at<L>(shard_view<L>(ix, d, gridDim.y, nseg_local), slg,
                          off, c);
        else
          res = occ_at<L>(ix, d * nseg_local + slg, off, c);
      }
    }
  }
  out[d * B + i] = res;
}

template <int L>
__global__ void owner_lf_kernel(FmView ix, long long nseg_local, int shard0,
                                const int* __restrict__ rows,
                                const unsigned char* __restrict__ valid,
                                long long R, Marks mk,
                                int* __restrict__ out) {
  const int d = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const long long k = d * R + i;
  int res = 0;
  if (valid[k]) {
    const long long r = rows[k];
    if constexpr (femto::is_row<L>()) {
      long long sl =
          r / ix.seg - (static_cast<long long>(shard0) + d) * nseg_local;
      sl = min(max(sl, 0LL), nseg_local - 1);
      res = lf_answer_row<L>(shard_view<L>(ix, d, gridDim.y, nseg_local), sl,
                             r, d, mk);
    } else {
      long long sl = r / ix.seg - static_cast<long long>(shard0) * nseg_local;
      sl = min(max(sl, 0LL), ix.n_seg - 1);
      res = lf_answer<L>(ix, sl, r, nseg_local, mk);
    }
  }
  out[k] = res;
}

template <int L>
__global__ void masked_lf_kernel(FmView ix, long long nseg_local, int shard0,
                                 const int* __restrict__ rows, long long B,
                                 Marks mk, int* __restrict__ out) {
  const int d = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long r = rows[i];
  const long long slg =
      r / ix.seg - static_cast<long long>(shard0 + d) * nseg_local;
  int res = 0;
  if (r >= 0 && slg >= 0 && slg < nseg_local) {
    if constexpr (femto::is_row<L>())
      res = lf_answer_row<L>(shard_view<L>(ix, d, gridDim.y, nseg_local), slg,
                             r, d, mk);
    else
      res = lf_answer<L>(ix, d * nseg_local + slg, r, nseg_local, mk);
  }
  out[d * B + i] = res;
}

dim3 grid_of(long long n, int Dl) {
  return dim3(static_cast<unsigned>((n + 255) / 256),
              static_cast<unsigned>(Dl));
}

}  // namespace

// rows, cd int32[Dl, R], valid uint8[Dl, R] -> out int32[Dl, R].
extern "C" int femto_owner_occ(const FmView* ix, long long nseg_local,
                               int shard0, const void* rows, const void* cd,
                               const void* valid, long long R, int Dl,
                               long long n_rows_total, void* out,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return femto::dispatch_layout(*ix, [&](auto lay) {
    constexpr int L = decltype(lay)::value;
    owner_occ_kernel<L><<<grid_of(R, Dl), 256, 0, st>>>(
        *ix, nseg_local, shard0, static_cast<const int*>(rows),
        static_cast<const int*>(cd),
        static_cast<const unsigned char*>(valid), R, n_rows_total,
        static_cast<int*>(out));
  });
}

// cd, r int32[B] (replicated) -> out int32[Dl, B].
extern "C" int femto_masked_occ(const FmView* ix, long long nseg_local,
                                int shard0, int Dl, const void* cd,
                                const void* r, long long B,
                                long long n_rows_total, void* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return femto::dispatch_layout(*ix, [&](auto lay) {
    constexpr int L = decltype(lay)::value;
    masked_occ_kernel<L><<<grid_of(B, Dl), 256, 0, st>>>(
        *ix, nseg_local, shard0, static_cast<const int*>(cd),
        static_cast<const int*>(r), B, n_rows_total, static_cast<int*>(out));
  });
}

// rows int32[Dl, R], valid uint8[Dl, R] -> out int32[Dl, R].
extern "C" int femto_owner_lf(const FmView* ix, long long nseg_local,
                              int shard0, const void* rows,
                              const void* valid, long long R, int Dl,
                              const void* mark_bits, const void* mark_ckpt,
                              const void* mark_vals, long long mv_len,
                              const void* mark_meta, void* out,
                              void* stream) {
  if (Dl < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Marks mk = {static_cast<const unsigned*>(mark_bits),
                    static_cast<const int*>(mark_ckpt),
                    static_cast<const unsigned*>(mark_vals), mv_len / Dl,
                    static_cast<const int*>(mark_meta)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return femto::dispatch_layout(*ix, [&](auto lay) {
    constexpr int L = decltype(lay)::value;
    owner_lf_kernel<L><<<grid_of(R, Dl), 256, 0, st>>>(
        *ix, nseg_local, shard0, static_cast<const int*>(rows),
        static_cast<const unsigned char*>(valid), R, mk,
        static_cast<int*>(out));
  });
}

// rows int32[B] (replicated) -> out int32[Dl, B].
extern "C" int femto_masked_lf(const FmView* ix, long long nseg_local,
                               int shard0, int Dl, const void* rows,
                               long long B, const void* mark_bits,
                               const void* mark_ckpt, const void* mark_vals,
                               long long mv_len, const void* mark_meta,
                               void* out, void* stream) {
  if (Dl < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Marks mk = {static_cast<const unsigned*>(mark_bits),
                    static_cast<const int*>(mark_ckpt),
                    static_cast<const unsigned*>(mark_vals), mv_len / Dl,
                    static_cast<const int*>(mark_meta)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return femto::dispatch_layout(*ix, [&](auto lay) {
    constexpr int L = decltype(lay)::value;
    masked_lf_kernel<L><<<grid_of(B, Dl), 256, 0, st>>>(
        *ix, nseg_local, shard0, static_cast<const int*>(rows), B, mk,
        static_cast<int*>(out));
  });
}
