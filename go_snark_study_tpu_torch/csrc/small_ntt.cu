// K3: a complete G-point DIT NTT over Fr (G = 2, 4, 8 or 16) along axis 1
// of an (8, G, L) Montgomery array, one column (lane) per thread.
//
// Replaces go_snark_study_tpu/ops/pallas_ntt.py::_small_ntt_kernel.  The
// G rows of a column are read bit-reversed straight into registers, all
// log2(G) stages run there (the j = 0 twiddle is skipped: a product by
// Montgomery one is the identity), and the natural-order result is written
// once.  Stage s, butterfly j uses w_G^(j*G/2^s), entry j*G/2^s of the
// (8, G/2) table tw (limb-major); every thread reads the same entries.
// Bound on the H100: bytes at G = 16 (2 x 512 per column against ~4,500
// IMADs), so each element crosses device memory once per launch.

#include "field.cuh"

namespace gs {

template <int G>
GS_HD int bitrev_g(int i) {
  int r = 0;
#pragma unroll
  for (int b = 1; b < G; b <<= 1) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

template <int G>
GS_HD void small_ntt_lane(const uint32_t* x, uint32_t* y, const uint32_t* tw,
                          long long l, long long L) {
  Fp<ModR> rows[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int r = bitrev_g<G>(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) rows[i].v[j] = x[((long long)j * G + r) * L + l];
  }
  constexpr int LOG_G = G == 2 ? 1 : G == 4 ? 2 : G == 8 ? 3 : 4;
#pragma unroll
  for (int s = 0; s < LOG_G; ++s) {
    const int m = 2 << s;
    const int half = m / 2;
#pragma unroll
    for (int q = 0; q < G / m; ++q) {
      const int blk = q * m;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        Fp<ModR> e = rows[blk + j];
        Fp<ModR> t = rows[blk + half + j];
        if (j != 0) {
          const int k = j * (G / m);
          Fp<ModR> w;
#pragma unroll
          for (int c = 0; c < 8; ++c) w.v[c] = tw[c * (G / 2) + k];
          t = mul<ModR>(t, w);
        }
        rows[blk + j] = add<ModR>(e, t);
        rows[blk + half + j] = sub<ModR>(e, t);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) y[((long long)j * G + i) * L + l] = rows[i].v[j];
  }
}

}  // namespace gs

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <int G>
__global__ void __launch_bounds__(128) small_ntt_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
    const uint32_t* __restrict__ tw, long long L) {
  long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l < L) gs::small_ntt_lane<G>(x, y, tw, l, L);
}

extern "C" int gs_small_ntt(int g, const void* x, void* y, const void* tw,
                            long long L, void* stream) {
  const int threads = 128;
  unsigned blocks = (unsigned)((L + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  auto px = (const uint32_t*)x;
  auto py = (uint32_t*)y;
  auto pt = (const uint32_t*)tw;
  switch (g) {
    case 2: small_ntt_kernel<2><<<blocks, threads, 0, s>>>(px, py, pt, L); break;
    case 4: small_ntt_kernel<4><<<blocks, threads, 0, s>>>(px, py, pt, L); break;
    case 8: small_ntt_kernel<8><<<blocks, threads, 0, s>>>(px, py, pt, L); break;
    case 16: small_ntt_kernel<16><<<blocks, threads, 0, s>>>(px, py, pt, L); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
