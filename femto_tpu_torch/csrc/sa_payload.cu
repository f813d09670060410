// Kernel K, sa_payload, and kernel L, gather_rows: the suffix sort's
// payload and the gathers through the suffix array.
//
// sa_payload replaces femto_tpu/ops/build_ops.py _aux_positions (48) and
// build_sa_payload (82): payload[p] = text[p - 1 mod n] | aux[p] << 9, so
// that payload[sa[r]] is row r's BWT symbol with its mark / SEOF word
// above.  aux bit 0: p is mark sampled (a doc start, a doc's last position
// or on the period grid; never with mark_period 0); bits 1..: doc id + 1 at
// the last position of each non-empty doc.  The reference scatters the doc
// starts and tags into n-long arrays; here every position finds its
// document by a bisect of doc_starts, which stays in cache.  A doc start
// is marked wherever it lies, the empty documents that pad a shape-padded
// build (all starting at the first pad position) included.
//
// gather_rows replaces femto_tpu/search.py _locate_direct_jit (71), the
// direct locate tier, and gives pull = payload[sa], which the reference
// carries through its sorts as an operand (suffix.py 156): out[i] =
// src[idx[i]], -1 where idx[i] lies outside [0, len).  gather_cols is the
// same gather of up to 8 columns of one dtype through one idx (the
// sharded sorts' columns, parallel/dist_sort.py): each index is read once
// and each column written straight into the caller's output.
//
// Bound on the H100 (3.35 TB/s): bytes.  sa_payload reads the text (4n)
// and doc_starts and writes 8n: 3.2 GB, 0.96 ms at n = 2^28.  gather_rows
// reads the index (4m), one 32-byte sector per gathered row, and writes
// the output: 11.8 GB, 3.5 ms for the 2^28 payload words.  What the card
// gives is its rate of random 32-byte sectors: on the H100, builds with
// one index a thread at 128 to 1024 threads a block, or with 1, 2 or 4
// 16-B index vectors a thread and every src load of a column issued
// before its first store, with or without streaming hints, ran within
// 0.5% of each other at the 2^28 pull (and of index_select), so loads in
// flight buy nothing there, and one index a thread led at the direct
// tier's 65,536 rows.  So a thread takes one index, with streaming loads
// of idx and stores of out (__ldcs / __stcs) that leave L2 to the
// gathered sectors.  The columns of one call share each index load.
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sa_payload_kernel(const int* __restrict__ text, long long n,
                                  const int* __restrict__ doc_starts,
                                  int ndocs, int period,
                                  long long* __restrict__ payload) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  // d = the last index of doc_starts[0 .. ndocs] whose entry is <= p
  int lo = 0, hi = ndocs + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(doc_starts + mid) <= p) lo = mid + 1; else hi = mid;
  }
  const int d = lo - 1;
  bool start = false, seof = false;
  if (d >= 0 && d < ndocs) {
    // doc d holds p, so it is not empty; an empty doc before it shares its
    // start and is covered by `start`
    start = __ldg(doc_starts + d) == p;
    seof = __ldg(doc_starts + d + 1) == p + 1;
  } else if (d == ndocs && ndocs > 0) {
    // past the last document: the empty documents of a shape-padded build
    // start at its real length n_real, the first pad position
    start = __ldg(doc_starts + ndocs - 1) == p;
  }
  const long long tag = seof ? d + 1 : 0;
  const bool marked = period > 0 && (start || seof || p % period == 0);
  const long long aux = (marked ? 1 : 0) | (tag << 1);
  const long long prev = p == 0 ? n - 1 : p - 1;
  payload[p] = static_cast<long long>(text[prev]) | (aux << 9);
}

constexpr int kGatherThreads = 256;
constexpr int kMaxCols = 8;

template <class T>
struct Cols {
  const T* src[kMaxCols];
  T* out[kMaxCols];
};

template <class T>
__device__ __forceinline__ T gather_one(const T* __restrict__ src,
                                        long long len, int j) {
  return (j >= 0 && j < len) ? __ldg(src + j) : static_cast<T>(-1);
}

// One index a thread: a streaming load of idx, then each column's row
// and a streaming store of it.  The column loop is unrolled over
// kMaxCols: an index of cols by a variable would copy the whole
// parameter block to local memory in every thread.
template <class T>
__global__ void __launch_bounds__(kGatherThreads) gather_cols_kernel(
    Cols<T> cols, int ncols, long long len, const int* __restrict__ idx,
    long long m) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (i >= m) return;
  const int j = __ldcs(idx + i);
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    if (c < ncols) __stcs(cols.out[c] + i, gather_one(cols.src[c], len, j));
}

template <class T>
int gather_entry(const void* const* src, void* const* out, int ncols,
                 long long len, const void* idx, long long m, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  Cols<T> cols = {};
  for (int c = 0; c < ncols; ++c) {
    cols.src[c] = static_cast<const T*>(src[c]);
    cols.out[c] = static_cast<T*>(out[c]);
  }
  gather_cols_kernel<T>
      <<<static_cast<unsigned>((m + kGatherThreads - 1) / kGatherThreads),
         kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          cols, ncols, len, static_cast<const int*>(idx), m);
  return static_cast<int>(cudaGetLastError());
}

int gather_any(const void* const* src, void* const* out, int ncols,
               long long len, int elem_bytes, const void* idx, long long m,
               void* stream) {
  if (elem_bytes == 4)
    return gather_entry<int>(src, out, ncols, len, idx, m, stream);
  if (elem_bytes == 8)
    return gather_entry<long long>(src, out, ncols, len, idx, m, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// text int32[n], doc_starts int32[ndocs + 1] -> payload int64[n].
extern "C" int femto_sa_payload(const void* text, long long n,
                                const void* doc_starts, int ndocs, int period,
                                void* payload, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sa_payload_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                      kThreads, 0, st>>>(
      static_cast<const int*>(text), n, static_cast<const int*>(doc_starts),
      ndocs, period, static_cast<long long*>(payload));
  return static_cast<int>(cudaGetLastError());
}

// src int32[len] (elem_bytes 4) or int64[len] (8), idx int32[m] -> out[m]
// of src's type.
extern "C" int femto_gather_rows(const void* src, long long len,
                                 int elem_bytes, const void* idx, long long m,
                                 void* out, void* stream) {
  const void* s[1] = {src};
  void* o[1] = {out};
  return gather_any(s, o, 1, len, elem_bytes, idx, m, stream);
}

// ncols (1 to 8) columns src_c int32[len] (elem_bytes 4) or int64[len] (8),
// one idx int32[m] -> out_c[m] of their type: src0..src7, then
// out0..out7 (nulls past ncols).
extern "C" int femto_gather_cols(const void* idx, long long m, long long len,
                                 int elem_bytes, int ncols, const void* s0,
                                 const void* s1, const void* s2,
                                 const void* s3, const void* s4,
                                 const void* s5, const void* s6,
                                 const void* s7, void* o0, void* o1, void* o2,
                                 void* o3, void* o4, void* o5, void* o6,
                                 void* o7, void* stream) {
  const void* s[kMaxCols] = {s0, s1, s2, s3, s4, s5, s6, s7};
  void* o[kMaxCols] = {o0, o1, o2, o3, o4, o5, o6, o7};
  return gather_any(s, o, ncols, len, elem_bytes, idx, m, stream);
}
