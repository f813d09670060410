// Kernel K18b, the sample sort's and the mesh prefix's device side:
// splitter_bucket, rebalance_local and rebalance_place (one kernel),
// mesh_exclusive, add_base and add_mesh_base.
//
// Replaces (femto_tpu/parallel/dist_sort.py): _bucket_of (40), the
// [m, D-1] compare-and-sum of every key against every splitter, with one
// binary search per key tuple among the sorted splitters; and dist_sort's
// windowed rebalance (51, lines 112-146), whose per-offset masked scatters
// place each received element at global position base + i into the block
// of its owner shard me + off, a ppermute and a where an offset.  The
// rebalance kernel computes it by destination, each place of a block
// written once: in one launch a call (rebalance_local), every block whose
// owner shard is a local one, each place from the first local shard within
// the window whose records cover it, INT32_MAX where none does (on a
// LocalMesh, where every shard is local, that is the whole rebalance: no
// buffer, roll or where); or (rebalance_place) one offset's buffer and
// flags, for owners in another process, which the mesh's ppermute and a
// where then merge as before.  A shard's records in a block lie between
// two cut points (k * m - base[d] and the next), so no place or record
// needs a division.  mesh_exclusive replaces the exclusive prefix over the
// mesh of per-shard values (dist_build.py _exclusive_base 88,
// _group_state's carry 195): every shard's row arrives by the mesh's
// all_gather, and one block sums (or takes the largest of) the rows of
// the shards before each local shard.  add_base
// adds a base to a shard's checkpoints, given; add_mesh_base (its own
// entry, the same kernel) sums the base from the mesh's gathered totals,
// so that the prefix and the add are one launch (_shard_occ_base's base
// and C 1030-1041 on occ_ckpt or the L1 rows, _shard_marks' mark base
// 1069-1075 on mark_ckpt): each block sums its shard's base from the
// gathered rows itself, one block scans C.  The local sorts and the
// sample and splitter gathers are kernels H and L.  The shard dimension
// is blockIdx.y.
//
// Bound on the H100 (3.35 TB/s): bytes.  splitter_bucket reads nk keys and
// writes one int per element (the D-1 splitters stay in L1); rebalance
// reads each placed record once and writes each place of the blocks once
// (streaming loads and stores, four places a thread for loads in flight);
// add_base reads and writes the checkpoints once, a 16-B vector
// a thread, with the base row in shared memory and no 64-bit division
// below a block (one a block, then a 32-bit one a thread).  Its grid is
// sized to the work, one thread a vector: on the H100 that ran faster than
// a few blocks an SM striding over the shard (PERF.md, K18b).
// mesh_exclusive is D*A ints, launch-bound: where its only use is an add,
// add_mesh_base takes its place.
#include "fm_common.cuh"

namespace {

constexpr int kMaxKeys = 4;
constexpr int kRebalanceCols = 6;
constexpr int kMaxWindow = 3;  // dist_sort's W: 2W + 1 source shards a block
constexpr int kRebalanceThreads = 256;
constexpr int kRebalanceItems = 4;  // places a thread, a block's width apart
constexpr int kMaxColumns = 1024;  // the prefix's and the add's A
constexpr int kPrefixThreads = 256;
constexpr int kAddThreads = 256;

struct Keys {
  const int* p[kMaxKeys];
};

struct RCols {
  const int* in[kRebalanceCols];
  int* out[kRebalanceCols];
};

// dest = the number of splitter tuples below the key tuple (splitters
// sorted ascending, so "below" holds for a prefix of them).
__global__ void splitter_bucket_kernel(Keys k, int nk, long long m, Keys s,
                                       int ns, int* __restrict__ dest) {
  const int d = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int key[kMaxKeys];
  for (int c = 0; c < nk; ++c) key[c] = k.p[c][d * m + i];
  int lo = 0, hi = ns;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    bool below = false;
    for (int c = 0; c < nk; ++c) {
      const int sv = __ldg(s.p[c] + mid);
      if (sv != key[c]) {
        below = sv < key[c];
        break;
      }
    }
    if (below)
      lo = mid + 1;
    else
      hi = mid;
  }
  dest[d * m + i] = lo;
}

// floor(a / b) for b > 0.
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// dist_sort's rebalance by destination.  Element i < n_d = min(v[d], R) of
// local shard d's sorted received records sits at global position base[d]
// + i, at place base[d] + i - k * m of the block of its owner shard k.
// Block row j (blockIdx.y) writes places [0, m) of one block:
//   local: local shard j's own (k = shard0 + j), each place q from the
//   first local shard d in [j - W, j + W] whose records cover it (q between
//   d's cut points base[d] - k * m and that plus n_d: the record q less the
//   first), INT32_MAX where none does; and far[j] = 1 where shard j's first
//   or last record's owner (the owners rise with i) lies more than W shards
//   away;
//   an offset: local shard j's buffer for the block of shard k = shard0 + j
//   + off, from j's own records, 0 and vbuf 0 where none lands there.
__global__ void __launch_bounds__(kRebalanceThreads) rebalance_kernel(
    RCols cols, int ncols, long long R, const int* __restrict__ v,
    const int* __restrict__ base, int Dl, int shard0, long long m, int W,
    int local, int off, unsigned char* __restrict__ vbuf,
    int* __restrict__ far) {
  constexpr int kCands = 2 * kMaxWindow + 1;
  const int j = blockIdx.y;
  const long long me = static_cast<long long>(shard0) + j;
  const long long k = local ? me : me + off;
  const int dlo = local ? max(j - W, 0) : j;
  const int nc = local ? min(j + W, Dl - 1) - dlo + 1 : 1;
  // each source's places in the block: [lo, hi), empty past the sources
  long long lo[kCands], hi[kCands];
#pragma unroll
  for (int c = 0; c < kCands; ++c) {
    lo[c] = hi[c] = 0;
    if (c < nc) {
      const int d = dlo + c;
      const long long n = min(static_cast<long long>(__ldg(v + d)), R);
      lo[c] = __ldg(base + d) - k * m;
      hi[c] = n > 0 ? lo[c] + n : lo[c];
    }
  }
  if (local && far != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    const long long n = min(static_cast<long long>(__ldg(v + j)), R);
    const long long g0 = __ldg(base + j);
    far[j] = n > 0 && (floor_div(g0, m) < me - W ||
                       floor_div(g0 + n - 1, m) > me + W);
  }
  const int fill = local ? INT32_MAX : 0;
  const long long q0 =
      static_cast<long long>(blockIdx.x) * (kRebalanceThreads *
                                            kRebalanceItems) +
      threadIdx.x;
#pragma unroll
  for (int t = 0; t < kRebalanceItems; ++t) {
    const long long q = q0 + t * kRebalanceThreads;
    if (q < m) {
      // the lowest source shard last, so that it wins where two overlap
      // (none do when base is the exclusive prefix of v)
      int src = -1;
      long long i = 0;
#pragma unroll
      for (int c = kCands - 1; c >= 0; --c) {
        if (q >= lo[c] && q < hi[c]) {
          src = dlo + c;
          i = q - lo[c];
        }
      }
      int val[kRebalanceCols];
#pragma unroll
      for (int c = 0; c < kRebalanceCols; ++c)
        val[c] = c < ncols && src >= 0 ? __ldcs(cols.in[c] + src * R + i)
                                       : fill;
      const long long o = j * m + q;
#pragma unroll
      for (int c = 0; c < kRebalanceCols; ++c)
        if (c < ncols) __stcs(cols.out[c] + o, val[c]);
      if (vbuf != nullptr) vbuf[o] = src >= 0;
    }
  }
}

// int32 addition that wraps, as the plain versions' int32 tensors do.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// C[0] = 0, C[a + 1] = the sum of the column sums of g int32[D, A] over
// the columns up to a: each of kT threads sums a run of up to
// kMaxColumns / kT columns, one block scan places the runs.  Every thread
// of the block calls it.
template <int kT>
__device__ void scan_columns(const int* __restrict__ g, int D, int A,
                             int* __restrict__ C, int* warp_vals) {
  constexpr int kPer = kMaxColumns / kT;
  const int per = (A + kT - 1) / kT;
  const int a0 = threadIdx.x * per;
  int tot[kPer];
  int run = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    int t = 0;
    if (k < per && a0 + k < A)
      for (int j = 0; j < D; ++j) t = wrap_add(t, g[j * A + a0 + k]);
    tot[k] = t;
    run = wrap_add(run, t);
  }
  int total;
  int before = femto::block_exclusive_sum<kT>(run, warp_vals, &total);
  if (threadIdx.x == 0) C[0] = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (k < per && a0 + k < A) {
      before = wrap_add(before, tot[k]);
      C[a0 + k + 1] = before;
    }
  }
}

// base[d, a] = the sum (op 0) or the largest value, at least 0 (op 1), of
// gathered[j, a] over the shards j < shard0 + d; C (when given) the
// exclusive scan over a of the column sums.  One block.
__global__ void __launch_bounds__(kPrefixThreads)
    mesh_exclusive_kernel(const int* __restrict__ g, int D, int A,
                          int shard0, int Dl, int op, int* __restrict__ base,
                          int* __restrict__ C) {
  __shared__ int warp_vals[32];
  const int hi = shard0 + Dl < D ? shard0 + Dl : D;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    int run = 0;
    for (int j = 0; j < hi; ++j) {
      if (j >= shard0) base[(j - shard0) * A + a] = run;
      const int x = g[j * A + a];
      run = op == 0 ? wrap_add(run, x) : max(run, x);
    }
  }
  if (C) scan_columns<kPrefixThreads>(g, D, A, C, warp_vals);
}

// The add's column layouts, chosen on the host: kQuad (A % 4 == 0 and x
// 16-B aligned: every shard's run starts on a 16-B boundary, and a
// vector's four columns are one 16-B read of the row); else a scalar head
// up to the shard's first 16-B boundary, then kOne (A = 1: one scalar a
// shard) or kAny (four scalar reads of the row a vector).
enum Cols { kOne, kQuad, kAny };

// x[d] (the E = rows * A ints from x + d * E) += shard d's base row,
// broadcast over the rows.  The row goes to shared memory once a block,
// repeated past A so that the four columns from any c < A read without a
// wrap: from base[d] (g null), or the sum of g[j] (the mesh's gathered
// totals, int32[D, A]) over the shards j < shard0 + d, which the shard's
// first block also writes to base_out[d] (when given); block (0, 0) writes
// C (when given).  Then each thread adds the row to its 16-B vector; the
// few elements outside the vectors (the head, the tail) go to the shard's
// first block.
template <Cols kCols>
__global__ void __launch_bounds__(kAddThreads)
    add_base_kernel(int* __restrict__ x, long long E, int A,
                    const int* __restrict__ base, const int* __restrict__ g,
                    int D, int shard0, int* __restrict__ base_out,
                    int* __restrict__ C) {
  __shared__ __align__(16) int row[kMaxColumns + 4];
  __shared__ int warp_vals[32];
  __shared__ int col0;
  const int d = blockIdx.y;
  const int width = kCols == kOne ? 1 : A + 4;
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    const int a = k < A ? k : (k - A) % A;
    int v;
    if (g) {
      v = 0;
      for (int j = 0; j < shard0 + d; ++j) v = wrap_add(v, g[j * A + a]);
    } else {
      v = base[d * A + a];
    }
    row[k] = v;
    if (base_out && blockIdx.x == 0 && k < A) base_out[d * A + k] = v;
  }
  if (C && blockIdx.x == 0 && d == 0)
    scan_columns<kAddThreads>(g, D, A, C, warp_vals);
  int* p = x + d * E;
  long long head = 0;
  if (kCols != kQuad) {
    head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2;
    if (head > E) head = E;
  }
  const long long nv = (E - head) >> 2, tail = head + 4 * nv;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  // the block's first column: its one 64-bit division
  if (threadIdx.x == 0 && kCols != kOne)
    col0 = static_cast<int>((head + 4 * i0) % A);
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    // at most 3 head and 3 tail elements a shard
    const int t = threadIdx.x;
    const long long e = t < 4 ? t : tail + t - 4;
    if (t < 4 ? e < head : e < E)
      p[e] = wrap_add(p[e], row[kCols == kOne ? 0 : static_cast<int>(e % A)]);
  }
  const long long i = i0 + threadIdx.x;
  if (i < nv) {
    int4* v4 = reinterpret_cast<int4*>(p + head) + i;
    const int c = kCols == kOne ? 0 : (col0 + 4 * threadIdx.x) % A;
    int4 v = __ldcs(v4);
    int4 b;
    if (kCols == kOne) {
      b = make_int4(row[0], row[0], row[0], row[0]);
    } else if (kCols == kQuad) {
      b = reinterpret_cast<const int4*>(row)[c >> 2];
    } else {
      b = make_int4(row[c], row[c + 1], row[c + 2], row[c + 3]);
    }
    v.x = wrap_add(v.x, b.x);
    v.y = wrap_add(v.y, b.y);
    v.z = wrap_add(v.z, b.z);
    v.w = wrap_add(v.w, b.w);
    __stcs(v4, v);
  }
}

// One launch of add_base_kernel over x int32[Dl, rows, A]: a thread a
// 16-B vector of every shard's run.
int launch_add(void* x, long long rows, int A, int Dl, const void* base,
               const void* g, int D, int shard0, void* base_out, void* C,
               cudaStream_t st) {
  if (A < 1 || A > kMaxColumns || Dl < 1 || rows < 0 ||
      (g && (shard0 < 0 || shard0 + Dl > D)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long E = rows * A;
  long long gx = (E / 4 + kAddThreads - 1) / kAddThreads;
  if (gx < 1) gx = 1;
  const dim3 grid(static_cast<unsigned>(gx), Dl);
  int* xp = static_cast<int*>(x);
  const int* bp = static_cast<const int*>(base);
  const int* gp = static_cast<const int*>(g);
  int* bo = static_cast<int*>(base_out);
  int* cp = static_cast<int*>(C);
  if (A == 1)
    add_base_kernel<kOne><<<grid, kAddThreads, 0, st>>>(xp, E, A, bp, gp, D,
                                                       shard0, bo, cp);
  else if (A % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0)
    add_base_kernel<kQuad><<<grid, kAddThreads, 0, st>>>(xp, E, A, bp, gp, D,
                                                        shard0, bo, cp);
  else
    add_base_kernel<kAny><<<grid, kAddThreads, 0, st>>>(xp, E, A, bp, gp, D,
                                                       shard0, bo, cp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: nk int32[Dl, m]; splitters: nk int32[ns] -> dest int32[Dl, m].
extern "C" int femto_splitter_bucket(const void* k0, const void* k1,
                                     const void* k2, const void* k3, int nk,
                                     long long m, int Dl, const void* s0,
                                     const void* s1, const void* s2,
                                     const void* s3, int ns, void* dest,
                                     void* stream) {
  if (nk < 1 || nk > kMaxKeys || Dl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Keys k = {{static_cast<const int*>(k0), static_cast<const int*>(k1),
             static_cast<const int*>(k2), static_cast<const int*>(k3)}};
  Keys s = {{static_cast<const int*>(s0), static_cast<const int*>(s1),
             static_cast<const int*>(s2), static_cast<const int*>(s3)}};
  splitter_bucket_kernel<<<dim3(static_cast<unsigned>((m + 255) / 256), Dl),
                           256, 0, static_cast<cudaStream_t>(stream)>>>(
      k, nk, m, s, ns, static_cast<int*>(dest));
  return static_cast<int>(cudaGetLastError());
}

namespace {

// rebalance_kernel over cols int32[Dl, R] (ncols of them), v, base
// int32[Dl] into outs int32[Dl, m] per column: the local shards' blocks
// with far (local), else offset off's buffers with vbuf.
int launch_rebalance(const void* const* in, int ncols, long long R,
                     const void* v, const void* base, int Dl, int shard0,
                     long long m, int W, int local, int off,
                     void* const* out, void* vbuf, void* far, void* stream) {
  if (ncols < 1 || ncols > kRebalanceCols || Dl < 1 || m < 1 || R < 0 ||
      W < 0 || W > kMaxWindow)
    return static_cast<int>(cudaErrorInvalidValue);
  RCols cols;
  for (int c = 0; c < kRebalanceCols; ++c) {
    cols.in[c] = static_cast<const int*>(in[c]);
    cols.out[c] = static_cast<int*>(out[c]);
  }
  constexpr long long kPer = kRebalanceThreads * kRebalanceItems;
  rebalance_kernel<<<dim3(static_cast<unsigned>((m + kPer - 1) / kPer), Dl),
                     kRebalanceThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      cols, ncols, R, static_cast<const int*>(v),
      static_cast<const int*>(base), Dl, shard0, m, W, local, off,
      static_cast<unsigned char*>(vbuf), static_cast<int*>(far));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dist_sort's rebalance of every local owner's records, one launch: cols
// int32[Dl, R] (ncols of them), v, base int32[Dl] -> outs int32[Dl, m]
// per column (INT32_MAX where no local record lands), far int32[Dl].
extern "C" int femto_rebalance_local(
    const void* i0, const void* i1, const void* i2, const void* i3,
    const void* i4, const void* i5, int ncols, long long R, const void* v,
    const void* base, int Dl, int shard0, long long m, int W, void* o0,
    void* o1, void* o2, void* o3, void* o4, void* o5, void* far,
    void* stream) {
  const void* in[kRebalanceCols] = {i0, i1, i2, i3, i4, i5};
  void* out[kRebalanceCols] = {o0, o1, o2, o3, o4, o5};
  return launch_rebalance(in, ncols, R, v, base, Dl, shard0, m, W, 1, 0, out,
                          nullptr, far, stream);
}

// One offset of dist_sort's rebalance, for owners in another process:
// the same inputs -> bufs int32[Dl, m] per column (0 where no record
// lands) and vbuf uint8[Dl, m].
extern "C" int femto_rebalance_place(
    const void* i0, const void* i1, const void* i2, const void* i3,
    const void* i4, const void* i5, int ncols, long long R, const void* v,
    const void* base, int Dl, int shard0, long long m, int off, void* o0,
    void* o1, void* o2, void* o3, void* o4, void* o5, void* vbuf,
    void* stream) {
  if (vbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const void* in[kRebalanceCols] = {i0, i1, i2, i3, i4, i5};
  void* out[kRebalanceCols] = {o0, o1, o2, o3, o4, o5};
  return launch_rebalance(in, ncols, R, v, base, Dl, shard0, m, 0, 0, off,
                          out, vbuf, nullptr, stream);
}

extern "C" int femto_mesh_exclusive(const void* gathered, int D, int A,
                                    int shard0, int Dl, int op, void* base,
                                    void* C, void* stream) {
  if (A < 1 || A > kMaxColumns || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  mesh_exclusive_kernel<<<1, kPrefixThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gathered), D, A, shard0, Dl, op,
      static_cast<int*>(base), static_cast<int*>(C));
  return static_cast<int>(cudaGetLastError());
}

// x int32[Dl, rows, A] += base int32[Dl, A] broadcast over the rows.
extern "C" int femto_add_base(void* x, const void* base, long long rows,
                              int A, int Dl, void* stream) {
  if (base == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_add(x, rows, A, Dl, base, nullptr, 0, 0, nullptr, nullptr,
                    static_cast<cudaStream_t>(stream));
}

// x int32[Dl, rows, A] += the sum of gathered int32[D, A]'s rows of the
// shards before shard0 + d, written to base_out int32[Dl, A] and with C
// int32[A + 1] as mesh_exclusive writes them (each where not null): the
// prefix inside add_base's kernel, one launch.
extern "C" int femto_add_mesh_base(void* x, long long rows, int A, int Dl,
                                   const void* gathered, int D, int shard0,
                                   void* base_out, void* C, void* stream) {
  if (gathered == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_add(x, rows, A, Dl, nullptr, gathered, D, shard0, base_out,
                    C, static_cast<cudaStream_t>(stream));
}
