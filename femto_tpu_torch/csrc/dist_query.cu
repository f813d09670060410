// Kernel K18f, the sharded queries' shard-side answers: owner_occ,
// masked_occ, masked_occ_rows, owner_lf and masked_lf over the full,
// compact, packed, vseg and vrle layouts (one instantiation each).
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
// counts are ckpt_base + count_range as kernels C and D compute them.
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
// masked_occ_rows (the sharded frontier's ranks, K18h's masked_occ of
// every fork's lanes) answers every symbol of each row at once: a warp a
// (row, local shard), which decodes the row once where its shard owns it
// (fm_common.cuh warp_rank_row), where masked_occ gives each (row, code)
// lane a thread that decodes the row again; the lane route (that design)
// stays for builds with -DFEMTO_R_ROW_RANK=0 (row_rank_min, regex_fork's
// rule).
//
// owner_lf on vseg and vrle takes kernel D's warp route (fm_common.cuh) up
// to the same limit on the number of requests (Dl x R slots) as D's
// locate: a warp a request, which fetches the serving row with its marks
// once (one dependent round trip; two on a side segment or a continued
// run-length segment that misses its mark), then answers from shared
// memory.  A warp reads the flags and rows of two slots at once and
// answers the valid ones (kLfSlots below); an invalid slot gets its 0 and
// no row is read for it.  Past the limit, and on full, compact and packed,
// a thread a request, which scans the row prefix a field at a time and
// walks a run-length segment's slots a load after the last.  masked_lf
// keeps a thread a request.
//
// Bound on the H100: bytes of dependent gathers, as kernels C and D: per
// request the checkpoint and the counted row prefix (plus, for LF, the
// code and the segment's mark words and two or three mark_vals words);
// masked_occ_rows: each owned row once (its checkpoint row and prefix),
// the rows in and Dl x 261 answers a row out.
// The warp route moves more: each valid request's whole row from its
// symbol list on (symbols, mark words, relative checkpoints) and its L1
// row, in one round trip.  A prose docs query's first call holds 48,060
// slots a shard, a sixth of them valid, so there the warp route meets the
// bytes of its fetches and the thread route its chains of loads.
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
         femto::count_range<L>(ix, sl, 0, off, c);
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
                         femto::row_within<L>(v, row, sl, woff, lc, 0, off);
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

// Local shard d's part of occ(dense code c, row rr) (of Dl local shards):
// the owner's occ, C[c+1] - C[c] from global shard 0 at rr past the rows,
// else 0 (c < 0 too).
template <int L>
__device__ __forceinline__ int masked_occ_at(const FmView& ix,
                                             long long nseg_local,
                                             int shard0, int d, int Dl,
                                             int c, long long rr,
                                             long long n_rows_total) {
  if (c < 0) return 0;
  const long long g = shard0 + d;
  if (rr >= n_rows_total)
    return g == 0 ? __ldg(ix.C + c + 1) - __ldg(ix.C + c) : 0;
  const long long s = rr / ix.seg;
  const long long slg = s - g * nseg_local;
  if (slg < 0 || slg >= nseg_local) return 0;
  const int off = static_cast<int>(rr - s * ix.seg);
  if constexpr (femto::is_row<L>())
    return occ_at<L>(shard_view<L>(ix, d, Dl, nseg_local), slg, off, c);
  else
    return occ_at<L>(ix, d * nseg_local + slg, off, c);
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
  out[d * B + i] = masked_occ_at<L>(ix, nseg_local, shard0, d, gridDim.y,
                                    cd[i], r[i], n_rows_total);
}

// masked_occ_rows on the lane route: a thread a (row, symbol) lane, as
// masked_occ over the expanded lanes (in builds with -DFEMTO_R_ROW_RANK=0,
// and where a block of the row route would not fit an SM).
template <int L>
__global__ void masked_occ_lanes_kernel(FmView ix, long long nseg_local,
                                        int shard0,
                                        const int* __restrict__ rows,
                                        long long M, long long n_rows_total,
                                        int* __restrict__ out) {
  const int d = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= M * femto::kAlpha) return;
  const long long m = i / femto::kAlpha;
  const int a = static_cast<int>(i - m * femto::kAlpha);
  out[d * M * femto::kAlpha + i] = masked_occ_at<L>(
      ix, nseg_local, shard0, d, gridDim.y, femto::map_char(ix, a), rows[m],
      n_rows_total);
}

// (row, local shard) pairs a block of masked_occ_rows' row route
constexpr int kRankWarps = 4;

// masked_occ_rows on the row route: a warp a (row m, local shard d) pair
// (t = m * Dl + d), which ranks the row for every code at once where the
// shard owns it (warp_rank_row in its shard's view: one decode of the
// row), then writes the 261 symbols' answers (0 for an absent symbol).
// Shared memory a warp: a rank row of kAlpha ints, then its scratch.
template <int L>
__global__ void __launch_bounds__(kRankWarps * 32) masked_occ_rows_kernel(
    FmView ix, long long nseg_local, int shard0, int Dl,
    const int* __restrict__ rows, long long M, long long n_rows_total,
    int* __restrict__ out, int scratch_words) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kRankWarps + warp;
  if (t >= M * Dl) return;
  const long long m = t / Dl;
  const int d = static_cast<int>(t - m * Dl);
  int* rank = reinterpret_cast<int*>(smem) +
              warp * (femto::kAlpha + scratch_words);
  unsigned* scratch = reinterpret_cast<unsigned*>(rank + femto::kAlpha);
  const long long g = shard0 + d;
  const long long r = rows[m];
  // 0: the shard contributes nothing, 1: the totals, 2: the owner's ranks
  int mode = 0;
  if (r >= n_rows_total) {
    mode = g == 0 ? 1 : 0;
  } else {
    const long long s = r / ix.seg;
    const long long slg = s - g * nseg_local;
    if (slg >= 0 && slg < nseg_local) {
      mode = 2;
      const long long off = r - s * ix.seg;
      if constexpr (femto::is_row<L>())
        femto::warp_rank_row<L>(shard_view<L>(ix, d, Dl, nseg_local),
                                slg * ix.seg + off, lane, scratch, rank);
      else
        femto::warp_rank_row<L>(ix, (d * nseg_local + slg) * ix.seg + off,
                                lane, scratch, rank);
    }
  }
  int* o = out + (static_cast<long long>(d) * M + m) * femto::kAlpha;
  for (int a = lane; a < femto::kAlpha; a += 32) {
    const int c = femto::map_char(ix, a);
    int v = 0;
    if (c >= 0 && mode == 2)
      v = rank[c];
    else if (c >= 0 && mode == 1)
      v = __ldg(ix.C + c + 1) - __ldg(ix.C + c);
    o[a] = v;
  }
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

// Slots a warp of owner_lf's warp route.  The routed locate's calls hold
// about six capacity slots a valid request, in runs (each bucket's
// requests first): a warp a slot spends most warps on slots that hold
// none, and a warp of many slots answers a run of valid ones one after
// another.  Two slots a warp read their flags and rows in one round trip.
constexpr int kLfSlots = 2;

// owner_lf_kernel's requests on vseg and vrle, a warp a request: warp w
// takes slots k = w * kLfSlots .. of the Dl x R (slot k = d * R + i), their
// valid flags and rows a lane a slot, writes 0 to the invalid ones, then
// for each valid one fetches the serving row in shard d's view with its
// marks once and answers the mark value or -1 - LF from it.  C is read
// from global memory: a request reads one entry of it, so no block copies
// it into shared memory.
template <int L>
__global__ void __launch_bounds__(femto::kWarpWalks * 32) owner_lf_warp_kernel(
    FmView ix, long long nseg_local, int shard0, int Dl,
    const int* __restrict__ rows, const unsigned char* __restrict__ valid,
    long long R, Marks mk, int* __restrict__ out, int buf_words) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = R * Dl;
  const long long k0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) *
      kLfSlots;
  if (k0 >= n) return;
  const long long kl = k0 + lane;
  const bool here = lane < kLfSlots && kl < n;
  const bool mine = here && valid[kl];
  const int my_row = mine ? rows[kl] : 0;
  if (here && !mine) out[kl] = 0;
  unsigned* buf = smem + warp * buf_words;
  for (unsigned todo = __ballot_sync(femto::kAllLanes, mine); todo != 0;
       todo &= todo - 1) {
    const int j = __ffs(todo) - 1;
    const long long k = k0 + j;
    const int d = static_cast<int>(k / R);
    const long long r = __shfl_sync(femto::kAllLanes, my_row, j);
    long long sl =
        r / ix.seg - (static_cast<long long>(shard0) + d) * nseg_local;
    sl = min(max(sl, 0LL), nseg_local - 1);
    // the row in the shard's view: its segment there, its offset in it
    long long rv = sl * ix.seg + r % ix.seg;
    int g, res;
    if (femto::warp_locate_row<L>(shard_view<L>(ix, d, Dl, nseg_local), &rv,
                                  true, lane, ix.C, buf, &g))
      res = mark_offset(mk.vals + d * mk.store_len, mk.store_len, mk.meta,
                        g - __ldg(mk.ckpt + d));
    else
      res = static_cast<int>(-1 - rv);  // 0 on a pad row (LF -1)
    if (lane == 0) out[k] = res;
  }
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

// The route of an owner_lf call of Dl x R slots (warp_route_smem on the
// view of one shard, whose side table and continuation store hold n_side
// / Dl and X / Dl rows): the warp route's dynamic shared memory a block in
// bytes with *buf_words a warp's share, 0 on the thread route (full,
// compact and packed always).
long long owner_lf_smem(const FmView& ix, long long R, int Dl,
                        int* buf_words) {
  *buf_words = 0;
  if ((ix.layout != femto::kVseg && ix.layout != femto::kVrle) || Dl < 1)
    return 0;
  FmView v = ix;
  v.n_side = ix.n_side / Dl;
  if (ix.ngr > 0) v.X = ix.X / Dl;
  const long long B = R * Dl;
  if (femto::warp_route_smem(v, B < INT32_MAX ? static_cast<int>(B)
                                              : INT32_MAX,
                             false, buf_words) == 0)
    return 0;
  // the warps' buffers alone (C stays in global memory)
  const long long warps = (B + kLfSlots - 1) / kLfSlots;
  return 4ll * (warps < femto::kWarpWalks ? warps : femto::kWarpWalks) *
         *buf_words;
}

// The route of a masked_occ_rows call on the view (one rule with regex_fork:
// fm_common.cuh row_rank_min, on the K codes every row is ranked for): the
// row route's dynamic shared memory a block in bytes with *scratch_words a
// warp's scratch, 0 on the lane route (also where a block would not fit an
// SM).
long long masked_occ_rows_smem(const FmView& ix, long long M, int Dl,
                               int* scratch_words) {
  *scratch_words = femto::rank_scratch_words(ix);
  if (ix.K < femto::row_rank_min() || Dl < 1) return 0;
  const long long pairs = M * Dl;
  const long long warps = pairs < kRankWarps ? pairs : kRankWarps;
  const long long bytes = 4ll * warps * (femto::kAlpha + *scratch_words);
  return bytes <= 227 * 1024 ? bytes : 0;
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

// rows int32[M] (replicated) -> out int32[Dl, M, 261]: each local shard's
// part of occ(symbol a, rows[m]) for every alphabet symbol a (masked_occ's
// answer for the lane (map_char(a), rows[m]); 0 for an absent symbol).
// The route by masked_occ_rows_smem.
extern "C" int femto_masked_occ_rows(const FmView* ix, long long nseg_local,
                                     int shard0, int Dl, const void* rows,
                                     long long M, long long n_rows_total,
                                     void* out, void* stream) {
  if (Dl < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int scratch_words = 0;
  const long long smem = masked_occ_rows_smem(*ix, M, Dl, &scratch_words);
  return femto::dispatch_layout(*ix, [&](auto lay) {
    constexpr int L = decltype(lay)::value;
    if (smem > 0) {
      if (smem > 48 * 1024)
        cudaFuncSetAttribute(masked_occ_rows_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
      const long long pairs = M * Dl;
      masked_occ_rows_kernel<L>
          <<<static_cast<unsigned>((pairs + kRankWarps - 1) / kRankWarps),
             kRankWarps * 32, static_cast<size_t>(smem), st>>>(
              *ix, nseg_local, shard0, Dl, static_cast<const int*>(rows), M,
              n_rows_total, static_cast<int*>(out), scratch_words);
      return;
    }
    masked_occ_lanes_kernel<L><<<grid_of(M * femto::kAlpha, Dl), 256, 0,
                                 st>>>(
        *ix, nseg_local, shard0, static_cast<const int*>(rows), M,
        n_rows_total, static_cast<int*>(out));
  });
}

// The route a masked_occ_rows call of M rows and Dl local shards on the
// view takes (masked_occ_rows_smem): the row route's dynamic shared memory
// a block in bytes, 0 on the lane route.
extern "C" long long femto_masked_occ_rows_route(const FmView* ix,
                                                 long long M, int Dl) {
  int scratch_words = 0;
  return masked_occ_rows_smem(*ix, M, Dl, &scratch_words);
}

// rows int32[Dl, R], valid uint8[Dl, R] -> out int32[Dl, R].  The route
// by owner_lf_smem.
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
  int buf_words = 0;
  const long long smem = owner_lf_smem(*ix, R, Dl, &buf_words);
  return femto::dispatch_layout(*ix, [&](auto lay) {
    constexpr int L = decltype(lay)::value;
    if constexpr (femto::is_row<L>()) {
      if (smem > 0) {
        femto::launch_warps(owner_lf_warp_kernel<L>,
                            static_cast<int>((R * Dl + kLfSlots - 1) /
                                             kLfSlots),
                            smem, st, *ix,
                            nseg_local, shard0, Dl,
                            static_cast<const int*>(rows),
                            static_cast<const unsigned char*>(valid), R, mk,
                            static_cast<int*>(out), buf_words);
        return;
      }
    }
    owner_lf_kernel<L><<<grid_of(R, Dl), 256, 0, st>>>(
        *ix, nseg_local, shard0, static_cast<const int*>(rows),
        static_cast<const unsigned char*>(valid), R, mk,
        static_cast<int*>(out));
  });
}

// The route an owner_lf call of Dl x R slots on the view takes
// (owner_lf_smem): the warp route's dynamic shared memory a block in
// bytes, 0 on the thread route.
extern "C" long long femto_owner_lf_route(const FmView* ix, long long R,
                                          int Dl) {
  int buf_words = 0;
  return owner_lf_smem(*ix, R, Dl, &buf_words);
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
