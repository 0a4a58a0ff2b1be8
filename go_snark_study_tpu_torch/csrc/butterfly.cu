// K4: one radix-2 DIT stage over Fr, lane by lane:
//   lo = even + odd*tw,  hi = even - odd*tw.
//
// Replaces go_snark_study_tpu/ops/pallas_ntt.py::_butterfly_kernel.  One
// lane per thread: three coalesced limb-row reads, one Montgomery product
// and an add/sub pair in registers, two writes.  Bound on the H100: bytes
// (160 per lane against ~264 IMADs).

#include "field.cuh"

namespace gs {

GS_HD void butterfly_lane(const uint32_t* even, const uint32_t* odd,
                          const uint32_t* tw, uint32_t* lo, uint32_t* hi,
                          long long i, long long n) {
  Fp<ModR> e = load<ModR>(even, i, n);
  Fp<ModR> t = mul<ModR>(load<ModR>(odd, i, n), load<ModR>(tw, i, n));
  store<ModR>(lo, add<ModR>(e, t), i, n);
  store<ModR>(hi, sub<ModR>(e, t), i, n);
}

}  // namespace gs

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) butterfly_kernel(
    const uint32_t* __restrict__ even, const uint32_t* __restrict__ odd,
    const uint32_t* __restrict__ tw, uint32_t* __restrict__ lo,
    uint32_t* __restrict__ hi, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) gs::butterfly_lane(even, odd, tw, lo, hi, i, n);
}

extern "C" int gs_butterfly(const void* even, const void* odd, const void* tw,
                            void* lo, void* hi, long long n, void* stream) {
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  butterfly_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)even, (const uint32_t*)odd, (const uint32_t*)tw,
      (uint32_t*)lo, (uint32_t*)hi, n);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
