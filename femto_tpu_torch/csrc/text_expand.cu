// Kernel Q, expand_u8: the int32 alphabet codes of a text shipped as raw
// content bytes, with its escape symbols put back.
//
// Replaces femto_tpu/fmindex.py _expand_u8 (80), the device half of the
// uint8 text upload of chunked builds (the host half, _escape_positions,
// stays host numpy): code[p] = u8[p] + offset below n_real and 0 (the pad
// symbol) from n_real on, then SEOF, SOH and EOH scattered, in that order,
// at their positions.  Positions outside [0, n) are dropped; the host pads
// the position arrays with INT32_MAX.  The three scatters run after the
// fill, in order, on the caller's stream, so a position named twice keeps
// the last code as the reference's three .at[].set do.
//
// Bound on the H100 (3.35 TB/s): bytes.  The fill reads n bytes and writes
// 4n; the scatters read 4 bytes per position and write one 32-byte sector
// each: 1.34 GB, 0.40 ms for a 2^28-symbol chunk.  Each thread of the fill
// takes four bytes in one 32-bit load and writes one 16-byte vector.
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void expand_fill_kernel(const unsigned char* __restrict__ u8,
                                   long long n, long long n_real, int offset,
                                   int* __restrict__ out) {
  const long long q =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long p = q * 4;
  if (p >= n) return;
  if (p + 4 <= n && (reinterpret_cast<unsigned long long>(u8) & 3) == 0 &&
      (reinterpret_cast<unsigned long long>(out) & 15) == 0) {
    const unsigned w = reinterpret_cast<const unsigned*>(u8)[q];
    int4 v;
    v.x = p + 0 < n_real ? static_cast<int>(w & 255u) + offset : 0;
    v.y = p + 1 < n_real ? static_cast<int>((w >> 8) & 255u) + offset : 0;
    v.z = p + 2 < n_real ? static_cast<int>((w >> 16) & 255u) + offset : 0;
    v.w = p + 3 < n_real ? static_cast<int>(w >> 24) + offset : 0;
    reinterpret_cast<int4*>(out)[q] = v;
    return;
  }
  for (long long r = p; r < p + 4 && r < n; ++r)
    out[r] = r < n_real ? static_cast<int>(u8[r]) + offset : 0;
}

__global__ void expand_scatter_kernel(const int* __restrict__ pos,
                                      long long m, long long n, int code,
                                      int* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= m) return;
  const long long q = pos[t];
  if (q >= 0 && q < n) out[q] = code;
}

unsigned grid_for(long long count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

// u8 uint8[n] -> out int32[n]: u8 + offset below n_real, else 0; then
// out[pos] = code for (seof, seof_code), (soh, soh_code), (eoh, eoh_code)
// in that order, each an int32 position array of its own length.
extern "C" int femto_expand_u8(const void* u8, long long n, long long n_real,
                               int offset, const void* seof, long long m_seof,
                               int seof_code, const void* soh,
                               long long m_soh, int soh_code,
                               const void* eoh, long long m_eoh, int eoh_code,
                               void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (n > 0)
    expand_fill_kernel<<<grid_for((n + 3) / 4), kThreads, 0, st>>>(
        static_cast<const unsigned char*>(u8), n, n_real, offset, o);
  const void* pos[3] = {seof, soh, eoh};
  const long long m[3] = {m_seof, m_soh, m_eoh};
  const int code[3] = {seof_code, soh_code, eoh_code};
  for (int k = 0; k < 3; ++k)
    if (m[k] > 0)
      expand_scatter_kernel<<<grid_for(m[k]), kThreads, 0, st>>>(
          static_cast<const int*>(pos[k]), m[k], n, code[k], o);
  return static_cast<int>(cudaGetLastError());
}
