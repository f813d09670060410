// Kernel F, pack_build: the packed tier's BWT words.
//
// Replaces femto_tpu/ops/build_ops.py _map_codes (898) and _pack_stage
// (923): map each BWT symbol to its dense code (alpha_map) and pack
// per_word codes of `bits` bits into each uint32 word, W =
// ceil(seg / per_word) words per segment.  The pad code, all ones in
// `bits`, fills the slots past seg in a row and the rows past n (whose
// symbol is INVALID_ALPHA in the uint16 BWT).  The TPU mapped by a
// compare-sum over the K used symbols (its gathers issue one element at a
// time) and packed with a shift-sum over a [n_seg, W, per_word] grid; here
// one thread builds one output word from its per_word symbols through a
// 261-entry table in shared memory: deterministic, no atomics.
//
// Bound on the H100 (3.35 TB/s): bytes.  bwt 2*n_seg*seg in, words
// 4*n_seg*W out (+ the 1 KiB table).  At n = 2^28, seg = 256, W = 43:
// 0.72 GB, 0.21 ms.
#include "fm_common.cuh"

namespace {

using femto::kAlpha;

constexpr int kThreads = 256;

__global__ void pack_build_kernel(const uint16_t* __restrict__ bwt,
                                  long long n_seg, int seg,
                                  const int* __restrict__ alpha_map, int W,
                                  int per_word, int bits,
                                  unsigned* __restrict__ words) {
  __shared__ int code[kAlpha];
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x)
    code[i] = alpha_map[i];
  __syncthreads();
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= n_seg * W) return;
  const unsigned pad = (1u << bits) - 1u;
  const long long s = w / W;
  const int j0 = static_cast<int>(w - s * W) * per_word;
  const uint16_t* row = bwt + s * seg;
  unsigned acc = 0;
  for (int f = 0; f < per_word; ++f) {
    const int j = j0 + f;
    unsigned v = pad;
    if (j < seg) {
      const int sym = row[j];
      if (sym < kAlpha && code[sym] >= 0) v = static_cast<unsigned>(code[sym]);
    }
    acc |= v << (f * bits);
  }
  words[w] = acc;
}

}  // namespace

// bwt uint16[n_seg, seg]; alpha_map int32[261] (symbol -> dense code or
// -1) -> words uint32[n_seg, W].
extern "C" int femto_pack_build(const void* bwt, long long n_seg, int seg,
                                const void* alpha_map, int W, int per_word,
                                int bits, void* words, void* stream) {
  if (per_word < 1 || bits < 1 || per_word * bits > 32 ||
      static_cast<long long>(W) * per_word < seg)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = n_seg * W;
  if (total > 0) {
    pack_build_kernel<<<static_cast<unsigned>((total + kThreads - 1) /
                                              kThreads),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(bwt), n_seg, seg,
        static_cast<const int*>(alpha_map), W, per_word, bits,
        static_cast<unsigned*>(words));
  }
  return static_cast<int>(cudaGetLastError());
}
