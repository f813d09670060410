// Kernel K18b, the sample sort's and the mesh prefix's device side:
// splitter_bucket, rebalance_place, mesh_exclusive and add_base.
//
// Replaces (femto_tpu/parallel/dist_sort.py): _bucket_of (40), the
// [m, D-1] compare-and-sum of every key against every splitter, with one
// binary search per key tuple among the sorted splitters; and dist_sort's
// windowed rebalance (51, lines 120-141), whose per-offset masked scatters
// place each received element at global position base + i into the block
// of its owner shard me + off.  mesh_exclusive replaces the exclusive
// prefix over the mesh of per-shard values (dist_build.py _exclusive_base
// 88, _group_state's carry 195, _shard_occ_base's base and C 1030-1041,
// _shard_marks' mark base 1069-1071): every shard's row arrives by the
// mesh's all_gather, and one block sums (or takes the largest of) the rows
// of the shards before each local shard.  add_base adds that base to a
// shard's checkpoints (occ_ckpt on the full tier, the L1 rows on the
// compact and packed tiers, mark_ckpt).  The local sorts and the sample
// and splitter gathers are kernels H and L.  The shard dimension is
// blockIdx.y.
//
// Bound on the H100 (3.35 TB/s): bytes.  splitter_bucket reads nk keys and
// writes one int per element (the D-1 splitters stay in L1);
// rebalance_place reads the received columns and writes the records of one
// offset; add_base reads and writes the checkpoints once.  mesh_exclusive
// is D*A ints, launch-bound.
#include "fm_common.cuh"

namespace {

constexpr int kMaxKeys = 4;
constexpr int kRebalanceCols = 6;
constexpr int kMaxColumns = 1024;  // mesh_exclusive's A

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

// Element i < v[d] of shard d's sorted received records sits at global
// position base[d] + i; the ones whose owner (position / m) is shard
// me + off go to their place in that block.  far[d] = 1 (when given) if
// an owner lies more than W shards away.
__global__ void rebalance_place_kernel(RCols cols, int ncols, long long R,
                                       const int* __restrict__ v,
                                       const int* __restrict__ base,
                                       int shard0, long long m, int off,
                                       int W,
                                       unsigned char* __restrict__ vbuf,
                                       int* __restrict__ far) {
  const int d = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= R || i >= v[d]) return;
  const long long me = shard0 + d;
  const long long gpos = static_cast<long long>(base[d]) + i;
  const long long owner = gpos / m;
  if (far && (owner - me > W || me - owner > W)) far[d] = 1;
  if (owner != me + off) return;
  const long long p = gpos - (me + off) * m;
  for (int c = 0; c < ncols; ++c) cols.out[c][d * m + p] = cols.in[c][d * R + i];
  vbuf[d * m + p] = 1;
}

// base[d, a] = the sum (op 0) or the largest value, at least 0 (op 1), of
// gathered[j, a] over the shards j < shard0 + d; C (when given) the
// exclusive scan over a of the column sums.  One block.
__global__ void mesh_exclusive_kernel(const int* __restrict__ g, int D, int A,
                                      int shard0, int Dl, int op,
                                      int* __restrict__ base,
                                      int* __restrict__ C) {
  __shared__ int tot[kMaxColumns];
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    int run = 0, all = 0;
    for (int j = 0; j < D; ++j) {
      if (j >= shard0 && j < shard0 + Dl) base[(j - shard0) * A + a] = run;
      const int x = g[j * A + a];
      run = op == 0 ? run + x : max(run, x);
      all += x;
    }
    tot[a] = all;
  }
  __syncthreads();
  if (C && threadIdx.x == 0) {
    int run = 0;
    C[0] = 0;
    for (int a = 0; a < A; ++a) {
      run += tot[a];
      C[a + 1] = run;
    }
  }
}

__global__ void add_base_kernel(int* __restrict__ x,
                                const int* __restrict__ base,
                                long long rows, int A) {
  const int d = blockIdx.y;
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * A) return;
  x[d * rows * A + e] += base[d * A + e % A];
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

// cols: ncols int32[Dl, R]; v, base int32[Dl] -> outs int32[Dl, m] and
// vbuf uint8[Dl, m] (zeroed by the caller), far int32[Dl] (zeroed) or null.
extern "C" int femto_rebalance_place(
    const void* i0, const void* i1, const void* i2, const void* i3,
    const void* i4, const void* i5, int ncols, long long R, const void* v,
    const void* base, int Dl, int D, int shard0, long long m, int off, int W,
    void* o0, void* o1, void* o2, void* o3, void* o4, void* o5, void* vbuf,
    void* far, void* stream) {
  if (ncols < 1 || ncols > kRebalanceCols || Dl < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RCols cols = {{static_cast<const int*>(i0), static_cast<const int*>(i1),
                 static_cast<const int*>(i2), static_cast<const int*>(i3),
                 static_cast<const int*>(i4), static_cast<const int*>(i5)},
                {static_cast<int*>(o0), static_cast<int*>(o1),
                 static_cast<int*>(o2), static_cast<int*>(o3),
                 static_cast<int*>(o4), static_cast<int*>(o5)}};
  rebalance_place_kernel<<<dim3(static_cast<unsigned>((R + 255) / 256), Dl),
                           256, 0, static_cast<cudaStream_t>(stream)>>>(
      cols, ncols, R, static_cast<const int*>(v),
      static_cast<const int*>(base), shard0, m, off, W,
      static_cast<unsigned char*>(vbuf), static_cast<int*>(far));
  return static_cast<int>(cudaGetLastError());
}

// gathered int32[D, A] -> base int32[Dl, A], C int32[A + 1] or null.
extern "C" int femto_mesh_exclusive(const void* gathered, int D, int A,
                                    int shard0, int Dl, int op, void* base,
                                    void* C, void* stream) {
  if (A < 1 || A > kMaxColumns || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  mesh_exclusive_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gathered), D, A, shard0, Dl, op,
      static_cast<int*>(base), static_cast<int*>(C));
  return static_cast<int>(cudaGetLastError());
}

// x int32[Dl, rows, A] += base int32[Dl, A] broadcast over the rows.
extern "C" int femto_add_base(void* x, const void* base, long long rows,
                              int A, int Dl, void* stream) {
  const long long e = rows * A;
  add_base_kernel<<<dim3(static_cast<unsigned>((e + 255) / 256), Dl), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(x), static_cast<const int*>(base), rows, A);
  return static_cast<int>(cudaGetLastError());
}
