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
// src[idx[i]], -1 where idx[i] lies outside [0, len).
//
// Bound on the H100 (3.35 TB/s): bytes.  sa_payload reads the text (4n)
// and doc_starts and writes 8n: 3.2 GB, 0.96 ms at n = 2^28.  gather_rows
// reads the index (4m), one 32-byte sector per gathered row, and writes
// the output: 11.8 GB, 3.5 ms for the 2^28 payload words; the sectors
// bound it, not the design.
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

template <class T>
__global__ void gather_rows_kernel(const T* __restrict__ src,
                                   long long len,
                                   const int* __restrict__ idx, long long m,
                                   T* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const long long j = idx[i];
  out[i] = (j >= 0 && j < len) ? src[j] : static_cast<T>(-1);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  if (elem_bytes == 4) {
    gather_rows_kernel<int><<<grid, kThreads, 0, st>>>(
        static_cast<const int*>(src), len, static_cast<const int*>(idx), m,
        static_cast<int*>(out));
  } else if (elem_bytes == 8) {
    gather_rows_kernel<long long><<<grid, kThreads, 0, st>>>(
        static_cast<const long long*>(src), len, static_cast<const int*>(idx),
        m, static_cast<long long*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
