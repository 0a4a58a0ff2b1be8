// K2: batched Montgomery product a*b*R^-1 mod p, p = q (field 0) or r (1).
//
// Replaces go_snark_study_tpu/ops/pallas_field.py::_mont_mul_kernel.  One
// lane per thread; the 8 limbs of each operand are read with coalesced
// limb-row loads, the CIOS product (field.cuh: PTX carry chains) runs in
// registers, the canonical result is written once.  Bound on the H100:
// bytes (96 per lane against ~264 IMADs), so the kernel is a single pass
// over its operands.
//
// Launch shape: 128 threads a block.  The H pipeline's 65,536 lanes are
// then 512 blocks, ~3.9 per SM, all resident in one wave (about 40
// registers a thread), so every SM streams its share at once and the last
// SM finishes at most one block after the mean; 256-thread blocks would
// leave 8 SMs with half the work of the others.

#include "field.cuh"

namespace gs {

template <class P>
GS_HD void mont_mul_lane(const uint32_t* a, const uint32_t* b, uint32_t* out,
                         long long i, long long n) {
  store<P>(out, mul<P>(load<P>(a, i, n), load<P>(b, i, n)), i, n);
}

}  // namespace gs

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <class P>
__global__ void __launch_bounds__(128) mont_mul_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) gs::mont_mul_lane<P>(a, b, out, i, n);
}

extern "C" int gs_mont_mul(int field, const void* a, const void* b, void* out,
                           long long n, void* stream) {
  const int threads = 128;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  auto pa = (const uint32_t*)a;
  auto pb = (const uint32_t*)b;
  auto po = (uint32_t*)out;
  if (field == 0)
    mont_mul_kernel<gs::ModQ><<<blocks, threads, 0, s>>>(pa, pb, po, n);
  else if (field == 1)
    mont_mul_kernel<gs::ModR><<<blocks, threads, 0, s>>>(pa, pb, po, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
