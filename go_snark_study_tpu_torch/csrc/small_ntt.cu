// K3: a complete G-point DIT NTT over Fr (G = 2, 4, 8 or 16) along axis 1
// of an (8, G, L) Montgomery array, a thread per butterfly over a column
// tile in shared memory.
//
// Replaces go_snark_study_tpu/ops/pallas_ntt.py::_small_ntt_kernel.  A
// block of 256 threads owns a tile of COLS = 512/G consecutive columns (32
// at G = 16, 256 at G = 2); thread t runs butterfly b = t / COLS of column
// t % COLS at every stage (G/2 butterflies per column, so 256 threads cover
// the tile).  Stage s, butterfly j = b mod 2^s pairs rows e = (b >> s) *
// 2^(s+1) + j and e + 2^s and multiplies the odd one by w_G^(j*G/2^(s+1));
// the j = 0 skip (a product by Montgomery one is the identity) is kept.
//   * Stage 0 reads its two rows straight from device memory, bit-reversed
//     (rows bitrev(2b) and bitrev(2b) + G/2); the last stage writes its two
//     natural-order rows straight back.  Every stage between goes through
//     G x 8 limbs x COLS words = 16 KB of shared memory laid out
//     [row][limb][column], with a barrier after each stage's writes: G = 16
//     takes 3 barriers, G = 2 none.
//   * COLS >= 32, so a warp shares b: each device-memory access of a warp
//     is 32 consecutive columns of one (limb, row), a full 128-byte line;
//     its shared-memory accesses hit 32 banks; its twiddle read is a
//     broadcast and the j = 0 branch is warp-uniform.  The G/2 twiddles
//     w_G^k ((8, G/2) table, limb-major) are copied to shared memory once
//     per block.
//   * A thread holds two elements and one product's temporaries (the launch
//     bound asks for 4 blocks, 32 warps, per SM: at most 64 registers); its
//     16 loads are all in flight at once.  Past a ragged end it reads column
//     L - 1 and stores nothing, so no branch sits between its loads.
//
// Bound on the H100: bytes at every G (2 x G x 32 bytes per column against
// 17 products per column at G = 16, ~4,500 IMADs), so each element crosses
// device memory once per launch, as the TPU kernel kept its tile in VMEM.

#include "field.cuh"

namespace gs {

constexpr int NTT_THREADS = 256;
constexpr int NTT_TILE = 2 * NTT_THREADS;  // elements per block: G/2 butterflies a column

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

}  // namespace gs

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <int G>
__global__ void __launch_bounds__(gs::NTT_THREADS, 4) small_ntt_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
    const uint32_t* __restrict__ tw, long long L) {
  using gs::Fp;
  using gs::ModR;
  constexpr int COLS = gs::NTT_TILE / G;
  constexpr int LOG_G = G == 2 ? 1 : G == 4 ? 2 : G == 8 ? 3 : 4;
  __shared__ uint32_t tile[G * 8 * COLS];  // [row][limb][column]
  __shared__ uint32_t tws[G / 2 * 8];  // [k][limb]
  const int t = threadIdx.x;
  const int c = t % COLS, b = t / COLS;
  const long long l = (long long)blockIdx.x * COLS + c;
  const long long lc = l < L ? l : L - 1;

  if (t < G / 2 * 8) tws[(t % (G / 2)) * 8 + t / (G / 2)] = tw[t];
  Fp<ModR> e, o;
  const int r0 = gs::bitrev_g<G>(2 * b);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    e.v[k] = x[((long long)k * G + r0) * L + lc];
    o.v[k] = x[((long long)k * G + r0 + G / 2) * L + lc];
  }

#pragma unroll
  for (int s = 0; s < LOG_G; ++s) {
    const int half = 1 << s;
    const int j = b & (half - 1);
    const int re = (b >> s) * 2 * half + j;
    uint32_t* pe = tile + re * 8 * COLS + c;
    uint32_t* po = pe + half * 8 * COLS;
    if (s > 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        e.v[k] = pe[k * COLS];
        o.v[k] = po[k * COLS];
      }
    }
    if (j != 0) {
      const uint32_t* pw = tws + j * (G / (2 * half)) * 8;
      Fp<ModR> wj;
#pragma unroll
      for (int k = 0; k < 8; ++k) wj.v[k] = pw[k];
      o = gs::mul<ModR>(o, wj);
    }
    const Fp<ModR> lo = gs::add<ModR>(e, o), hi = gs::sub<ModR>(e, o);
    if (s + 1 < LOG_G) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        pe[k * COLS] = lo.v[k];
        po[k * COLS] = hi.v[k];
      }
      __syncthreads();
    } else if (l < L) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        y[((long long)k * G + re) * L + l] = lo.v[k];
        y[((long long)k * G + re + half) * L + l] = hi.v[k];
      }
    }
  }
}

// columns per block, threads per block and blocks of the launch for (g, L)
extern "C" int gs_small_ntt_shape(int g, long long L, long long out[3]) {
  if (g != 2 && g != 4 && g != 8 && g != 16) return (int)cudaErrorInvalidValue;
  const long long cols = gs::NTT_TILE / g;
  out[0] = cols;
  out[1] = gs::NTT_THREADS;
  out[2] = (L + cols - 1) / cols;
  return 0;
}

extern "C" int gs_small_ntt(int g, const void* x, void* y, const void* tw,
                            long long L, void* stream) {
  long long shape[3];
  int rc = gs_small_ntt_shape(g, L, shape);
  if (rc != 0) return rc;
  const unsigned blocks = (unsigned)shape[2];
  cudaStream_t s = (cudaStream_t)stream;
  auto px = (const uint32_t*)x;
  auto py = (uint32_t*)y;
  auto pt = (const uint32_t*)tw;
  switch (g) {
    case 2: small_ntt_kernel<2><<<blocks, gs::NTT_THREADS, 0, s>>>(px, py, pt, L); break;
    case 4: small_ntt_kernel<4><<<blocks, gs::NTT_THREADS, 0, s>>>(px, py, pt, L); break;
    case 8: small_ntt_kernel<8><<<blocks, gs::NTT_THREADS, 0, s>>>(px, py, pt, L); break;
    default: small_ntt_kernel<16><<<blocks, gs::NTT_THREADS, 0, s>>>(px, py, pt, L); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
