// Kernel G, sym_hist and sa_keys: the alphabet histogram of the text and
// the packed first-sort key of every suffix.
//
// Replaces (femto_tpu/suffix.py): _alpha_hist (68), _remap_stage (131) and
// _keys_stage (99).  The TPU counted symbols by a one-hot MXU contraction
// and remapped by an n x K compare-sum because it has no fast scatter or
// table lookup; on the card a block counts into 512 shared-memory bins
// (one atomic per distinct symbol of a warp, found by a warp match) and the
// remap is a 512-entry table in shared memory.  The port packs one int64
// key of per = 63 / bits codes in place of the reference's three 30-bit
// keys: key[p] = sum_j lut[text[p + j]] << ((per - 1 - j) * bits), zeros
// past the end, so a suffix that ends sorts before its extensions.
//
// Shape-padded texts (suffix.py n_real; femto_tpu/suffix.py 99's n_real):
// the positions p >= n_real hold the pad symbol 0, and their suffixes are
// 0^k, which differ only by length.  Their keys are n - 1 - p, below every
// real key (a real suffix's first code is >= 1, so its key is at least
// 1 << (per - 1) * bits >= 2^48 for any alphabet), so the first sort puts
// the pad run first, shortest suffix first, and leaves no tie in it.  The
// reference gives them the negative keys -1 - p for the same order; the
// port's radix sort takes non-negative keys.  An extension round's fetch
// key[pos + w] that lands in the pad reads (n - 1 - pos - w) >> drop,
// below 2^((e - 1) * bits) and so below every real fetch: the encoding
// holds there too, and sa_rounds.cu is unchanged.
//
// Bound on the H100 (3.35 TB/s): bytes.  sym_hist reads the text once (4n)
// and writes 513 counts; sa_keys reads the text (4n) and the table and
// writes the keys (8n): 3.2 GB, 0.96 ms at n = 2^28.  Each thread of
// sa_keys reads its `per` symbols itself; neighbours share them through L1.
#include "fm_common.cuh"

namespace {

constexpr int kSyms = 512;    // symbols lie in [0, 512)
constexpr int kThreads = 256;
constexpr int kKeyItems = 8;  // keys per thread of sa_keys

// out[s] += occurrences of symbol s; out[512] += symbols outside [0, 512).
__global__ void sym_hist_kernel(const int* __restrict__ text, long long n,
                                int* __restrict__ out) {
  __shared__ int h[kSyms + 1];
  for (int i = threadIdx.x; i <= kSyms; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // p0 is the same for a warp's lanes, so whole warps run each iteration
  for (long long p0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      (threadIdx.x - lane);
       p0 < n; p0 += stride) {
    const long long p = p0 + lane;
    int b = -1;
    if (p < n) {
      const unsigned s = static_cast<unsigned>(text[p]);
      b = s < kSyms ? static_cast<int>(s) : kSyms;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(&h[b], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= kSyms; i += blockDim.x)
    if (h[i]) atomicAdd(&out[i], h[i]);
}

__global__ void sa_keys_kernel(const int* __restrict__ text, long long n,
                               const int* __restrict__ lut, int bits, int per,
                               long long n_real,
                               long long* __restrict__ key) {
  __shared__ int sl[kSyms];
  for (int i = threadIdx.x; i < kSyms; i += blockDim.x) sl[i] = lut[i];
  __syncthreads();
  const long long base =
      static_cast<long long>(blockIdx.x) * (kThreads * kKeyItems);
  for (int it = 0; it < kKeyItems; ++it) {
    const long long p = base + it * kThreads + threadIdx.x;
    if (p >= n) return;
    if (p >= n_real) {
      key[p] = n - 1 - p;
      continue;
    }
    unsigned long long k = 0;
    for (int j = 0; j < per; ++j) {
      const long long q = p + j;
      unsigned long long c = 0;
      if (q < n) {
        const unsigned s = static_cast<unsigned>(__ldg(text + q));
        if (s < kSyms) c = static_cast<unsigned long long>(sl[s]);
      }
      k = (k << bits) | c;
    }
    key[p] = static_cast<long long>(k);
  }
}

}  // namespace

// text int32[n] -> out int32[513], zeroed by the caller: counts of symbols
// 0..511, then the number of symbols outside [0, 512).
extern "C" int femto_sym_hist(const void* text, long long n, void* out,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  sym_hist_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int*>(text), n, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// text int32[n], lut int32[512] (symbol -> dense code, 0 if absent) ->
// key int64[n] of per codes of `bits` bits each (per * bits <= 63); from
// n_real on (n_real = n: none) the pad keys n - 1 - p.
extern "C" int femto_sa_keys(const void* text, long long n, const void* lut,
                             int bits, int per, long long n_real, void* key,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_block = kThreads * kKeyItems;
  const long long blocks = (n + per_block - 1) / per_block;
  sa_keys_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int*>(text), n, static_cast<const int*>(lut), bits,
      per, n_real, static_cast<long long*>(key));
  return static_cast<int>(cudaGetLastError());
}
