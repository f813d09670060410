// Kernel J, rank_init, round_keys and round_commit: the gather and
// write-back parts of a suffix-sort round over the tied slots.
//
// Replaces (femto_tpu/suffix.py): _rank_from_state (272) and the gather
// and scatter parts of _extend_round_impl (204), _full_round (280) and
// _filtered_round (302); the sort between them is kernel H and the
// regrouping kernel I.  The reference pads the active set to a few static
// sizes and masks the pad lanes; here every launch takes the exact count m.
// A round over all n slots is these kernels with every slot active, so
// _full_round has no kernel of its own.
//
// A round's sort key is one int64, hi << shift | lo:
//   doubling   hi = rank[pos], lo = rank[pos + h] + 1, or 0 past the end
//              (rank = group base slot, valid for prefixes of h symbols);
//   extension  hi = the slot's group base, lo = the first symbols of
//              key0[pos + w] (the packed first-sort key at the first
//              position not yet compared), dropping its low `drop` bits,
//              or 0 past the end.
// pos + h and pos + w are 64-bit: h passes 2^31 on the last rounds of a
// long repeat.
//
// Bound on the H100 (3.35 TB/s): bytes, one 32-byte sector per random
// access.  round_keys reads slots (4m) and gathers sa and two ranks (or one
// key word) per slot, writing 12m; round_commit reads 12m and scatters two
// ints per slot; rank_init reads sa (4n) and scatters n ints.
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void rank_all_kernel(const int* __restrict__ sa, long long n,
                                int* __restrict__ rank) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r < n) rank[sa[r]] = static_cast<int>(r);
}

__global__ void rank_tied_kernel(const int* __restrict__ sa,
                                 const int* __restrict__ slots,
                                 const int* __restrict__ base, long long m,
                                 int* __restrict__ rank) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < m) rank[sa[slots[t]]] = base[t];
}

__global__ void round_keys_kernel(const int* __restrict__ sa,
                                  const int* __restrict__ slots, long long m,
                                  long long n, const int* __restrict__ rank,
                                  long long h, const int* __restrict__ base,
                                  const long long* __restrict__ key0,
                                  long long w, int shift, int drop,
                                  int* __restrict__ pos_out,
                                  long long* __restrict__ key_out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= m) return;
  const int pos = sa[slots[t]];
  unsigned long long hi, lo = 0;
  if (rank) {
    hi = static_cast<unsigned long long>(rank[pos]);
    const long long q = pos + h;
    if (q < n) lo = static_cast<unsigned long long>(rank[q]) + 1ull;
  } else {
    hi = static_cast<unsigned long long>(base[t]);
    const long long q = pos + w;
    if (q < n) lo = static_cast<unsigned long long>(key0[q]) >> drop;
  }
  pos_out[t] = pos;
  key_out[t] = static_cast<long long>((hi << shift) | lo);
}

__global__ void round_commit_kernel(int* __restrict__ sa,
                                    int* __restrict__ rank,
                                    const int* __restrict__ slots,
                                    const int* __restrict__ spos,
                                    const int* __restrict__ base_all,
                                    long long m) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= m) return;
  const int p = spos[t];
  sa[slots[t]] = p;
  if (rank) rank[p] = base_all[t];
}

unsigned grid_for(long long count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

// rank int32[n]: rank[sa[r]] = r for every slot r, then the group base for
// the m tied slots (slots, base int32[m]).
extern "C" int femto_rank_init(const void* sa, long long n, const void* slots,
                               const void* base, long long m, void* rank,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rank_all_kernel<<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const int*>(sa), n, static_cast<int*>(rank));
  if (m > 0)
    rank_tied_kernel<<<grid_for(m), kThreads, 0, st>>>(
        static_cast<const int*>(sa), static_cast<const int*>(slots),
        static_cast<const int*>(base), m, static_cast<int*>(rank));
  return static_cast<int>(cudaGetLastError());
}

// For the m active slots: pos_out[t] = sa[slots[t]] and the round's key.
// rank not null: doubling by h; else extension from base and key0 at w.
extern "C" int femto_round_keys(const void* sa, const void* slots,
                                long long m, long long n, const void* rank,
                                long long h, const void* base,
                                const void* key0, long long w, int shift,
                                int drop, void* pos_out, void* key_out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  round_keys_kernel<<<grid_for(m), kThreads, 0, st>>>(
      static_cast<const int*>(sa), static_cast<const int*>(slots), m, n,
      static_cast<const int*>(rank), h, static_cast<const int*>(base),
      static_cast<const long long*>(key0), w, shift, drop,
      static_cast<int*>(pos_out), static_cast<long long*>(key_out));
  return static_cast<int>(cudaGetLastError());
}

// sa[slots[t]] = spos[t]; with rank (and base_all int32[m], every sorted
// element's new group base slot) also rank[spos[t]] = base_all[t].
extern "C" int femto_round_commit(void* sa, void* rank, const void* slots,
                                  const void* spos, const void* base_all,
                                  long long m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  round_commit_kernel<<<grid_for(m), kThreads, 0, st>>>(
      static_cast<int*>(sa), static_cast<int*>(rank),
      static_cast<const int*>(slots), static_cast<const int*>(spos),
      static_cast<const int*>(base_all), m);
  return static_cast<int>(cudaGetLastError());
}
