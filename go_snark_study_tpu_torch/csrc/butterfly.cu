// K4: the radix-2 DIT NTT over Fr, in two forms.
//
// Replaces go_snark_study_tpu/ops/pallas_ntt.py::_butterfly_kernel (:40).
// The TPU kernel is one stage, lo = e + o*tw, hi = e - o*tw, because the
// TPU grid runs in order and XLA wrapped the stage loop around it.
//
// Whole-transform form (radix2_ntt_kernel, gs_radix2_ntt): one launch
// computes the natural-order, unscaled NTT of every row of an (8, rows*n)
// Montgomery array, 2 <= n <= 2^13, the same bits as the stage loop
// (ops/ntt_kernels.py radix2_stages).  Stage s (1-based, half = 2^(s-1))
// pairs bit-reversed positions q and q + half, q mod 2^s < half, and takes
// the product by T[(q mod half) * n/2^s] from the (8, n/2) master table;
// the j = 0 product is skipped (T[0] is the Montgomery one, and a product
// by it returns the canonical operand).
//   * A row is one thread-block cluster of C CTAs: C = n/256 between 1 and
//     16, so 256 points a CTA up to 2^12 and 512 at 2^13.  16 is an opt-in
//     cluster size; where the card cannot place a cluster of 16 CTAs
//     (cudaOccupancyMaxActiveClusters), C stops at the portable 8.  CTA c
//     holds positions [c*P, (c+1)*P) of the bit-reversed sequence, P = n/C,
//     in shared memory laid out [limb][position], with P/2 threads.
//   * Stage 1 reads its two operands straight from device memory: CTA c
//     needs the naturals i with i mod C = rev(c), a stride-C gather per limb
//     row.  The input was just written by the product before the transform,
//     so the gather reads L2, and it needs no exchange through distributed
//     shared memory and no cluster barrier before stage 1.
//   * The first log2(P) stages are local: a thread per butterfly, in place
//     in the tile, one __syncthreads() between stages.
//   * The last log2(C) stages cross CTAs: CTA c pairs with c ^ (half / P),
//     position for position.  Of a pair's P butterflies the even CTA runs
//     the first P/2 and the odd CTA the rest, each reading one operand from
//     its own tile and one from the partner's through distributed shared
//     memory (map_shared_rank), and writing lo to the even CTA's second
//     tile and hi to the odd CTA's: each product once.  Two tiles, read one
//     and write the other, with one cluster.sync() per stage, so no CTA
//     writes a tile its partner is still reading.
//   * The last stage writes the two outputs of each butterfly to device
//     memory, positions q and q + half, each a contiguous run over a warp.
//     The cluster.sync() after it keeps every tile alive until its partner
//     has read it.
//   * Twiddles come through the read-only path (__ldg), from L1 or L2.
// Bound on the H100: at one row, the chain of stages.  A 2^12 transform
// moves 320 KB and does 20,481 products (~5.4 M IMADs), but each stage
// waits for the one before, so what counts is one warp's product latency
// per stage (the CIOS rows are serial) and a cluster barrier per crossing
// stage.  The cluster spreads a row over 16 SMs, 4 warps each, and keeps
// every stage on chip, so one launch replaces the stage form's twelve and
// the gathers and concatenations around them.
//
// Stage form (butterfly_kernel, gs_butterfly): one stage, lane by lane,
// (8, N) even, odd and tw in, lo and hi out; a lane per thread.  No path
// of the port calls it; it is kept as the stage-at-a-time reference.

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

constexpr int R2_MAX_LOG = 13;       // largest transform: 2^13 points
constexpr int R2_CTA_POINTS = 256;    // points a CTA holds while C < 16
constexpr int R2_MAX_THREADS = 512;   // 2^13 points over 8 CTAs: 1,024 a CTA

}  // namespace gs

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(256) butterfly_kernel(
    const uint32_t* __restrict__ even, const uint32_t* __restrict__ odd,
    const uint32_t* __restrict__ tw, uint32_t* __restrict__ lo,
    uint32_t* __restrict__ hi, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) gs::butterfly_lane(even, odd, tw, lo, hi, i, n);
}

// T[idx], limb-major with n/2 entries a limb row
__device__ __forceinline__ gs::Fp<gs::ModR> r2_twiddle(const uint32_t* __restrict__ T, int idx,
                                                       int tw_len) {
  gs::Fp<gs::ModR> w;
#pragma unroll
  for (int k = 0; k < 8; ++k) w.v[k] = __ldg(T + k * tw_len + idx);
  return w;
}

// x, y: (8, total) with rows of n = 2^log_n contiguous; a cluster of
// 2^log_c CTAs per row, 2^(log_n - log_c - 1) threads each
__global__ void __launch_bounds__(gs::R2_MAX_THREADS) radix2_ntt_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
    const uint32_t* __restrict__ T, int log_n, int log_c, long long total) {
  using gs::Fp;
  using gs::ModR;
  extern __shared__ uint32_t tiles[];  // [tile][limb][position]
  const int log_p = log_n - log_c;
  const int P = 1 << log_p, tw_len = 1 << (log_n - 1);
  const int t = threadIdx.x;
  const int c = blockIdx.x & ((1 << log_c) - 1);  // rank in the cluster
  const long long row = (long long)(blockIdx.x >> log_c) << log_n;

  // stage 1's operands, bit-reversed positions 2t and 2t + 1 of the CTA
  const int i0 = (int)(__brev((unsigned)(c * P + 2 * t)) >> (32 - log_n));
  Fp<ModR> e, o;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    e.v[k] = x[k * total + row + i0];
    o.v[k] = x[k * total + row + i0 + tw_len];
  }

  for (int s = 1; s <= log_p; ++s) {
    const int half = 1 << (s - 1);
    const int j = t & (half - 1);
    const int pe = ((t >> (s - 1)) << s) + j, po = pe + half;
    if (s > 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        e.v[k] = tiles[k * P + pe];
        o.v[k] = tiles[k * P + po];
      }
    }
    if (j != 0) o = gs::mul<ModR>(o, r2_twiddle(T, j << (log_n - s), tw_len));
    const Fp<ModR> lo = gs::add<ModR>(e, o), hi = gs::sub<ModR>(e, o);
    if (s == log_n) {  // one CTA a row: the last stage stores the output
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        y[k * total + row + pe] = lo.v[k];
        y[k * total + row + po] = hi.v[k];
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      tiles[k * P + pe] = lo.v[k];
      tiles[k * P + po] = hi.v[k];
    }
    if (s < log_p) __syncthreads();
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  int cur = 0;
  for (int s = log_p + 1; s <= log_n; ++s) {
    const int half = 1 << (s - 1);
    const int bit = half >> log_p;  // the partner's rank differs in this bit
    const bool odd_side = (c & bit) != 0;
    uint32_t* mine = tiles + cur * 8 * P;
    uint32_t* next = tiles + (cur ^ 1) * 8 * P;
    const uint32_t* theirs = cluster.map_shared_rank(mine, c ^ bit);
    const int r = t + (odd_side ? P / 2 : 0);
    const int qe = (c & ~bit) * P + r;  // the even operand's position
    const int j = qe & (half - 1);
    const uint32_t* src_e = odd_side ? theirs : mine;
    const uint32_t* src_o = odd_side ? mine : theirs;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      e.v[k] = src_e[k * P + r];
      o.v[k] = src_o[k * P + r];
    }
    if (j != 0) o = gs::mul<ModR>(o, r2_twiddle(T, j << (log_n - s), tw_len));
    const Fp<ModR> lo = gs::add<ModR>(e, o), hi = gs::sub<ModR>(e, o);
    if (s == log_n) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        y[k * total + row + qe] = lo.v[k];
        y[k * total + row + qe + half] = hi.v[k];
      }
    } else {
      uint32_t* next_theirs = cluster.map_shared_rank(next, c ^ bit);
      uint32_t* ne = odd_side ? next_theirs : next;
      uint32_t* no = odd_side ? next : next_theirs;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        ne[k * P + r] = lo.v[k];
        no[k * P + r] = hi.v[k];
      }
    }
    cluster.sync();
    cur ^= 1;
  }
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

// the largest cluster this card places for the whole-transform kernel at
// its largest launch (2^13 over 16 CTAs): 16 where the card has room, else 8
static int r2_max_cluster() {
  static int cmax = 0;
  if (cmax == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(16);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = 2 * 8 * 512 * sizeof(uint32_t);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 16;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    const bool room =
        cudaFuncSetAttribute(radix2_ntt_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveClusters(&active, radix2_ntt_kernel, &cfg) == cudaSuccess && active > 0;
    if (!room) cudaGetLastError();  // clear the refusal: C stops at 8
    cmax = room ? 16 : 8;
  }
  return cmax;
}

// the launch of an n-point transform over `rows` rows: cluster size, CTAs,
// threads per CTA, dynamic shared bytes per CTA, points per CTA
extern "C" int gs_radix2_ntt_shape(long long n, long long rows, long long out[5]) {
  if (n < 2 || n > (1LL << gs::R2_MAX_LOG) || (n & (n - 1)) != 0 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const long long cmax = r2_max_cluster();
  long long c = n <= gs::R2_CTA_POINTS ? 1 : n / gs::R2_CTA_POINTS;
  if (c > cmax) c = cmax;
  const long long p = n / c;
  out[0] = c;
  out[1] = c * rows;
  out[2] = p / 2;
  out[3] = (c > 1 ? 2 : 1) * 8 * p * (long long)sizeof(uint32_t);
  out[4] = p;
  return 0;
}

extern "C" int gs_radix2_ntt(const void* x, void* y, const void* T, long long n,
                             long long rows, void* stream) {
  long long shape[5];
  int rc = gs_radix2_ntt_shape(n, rows, shape);
  if (rc != 0) return rc;
  int log_n = 0, log_c = 0;
  while ((1LL << log_n) < n) ++log_n;
  while ((1LL << log_c) < shape[0]) ++log_c;
  if (shape[3] > 48 * 1024) {  // 2^13 over 8 CTAs: above the default limit only by opting in
    rc = (int)cudaFuncSetAttribute(radix2_ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)shape[3]);
    if (rc != 0) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)shape[1]);
  cfg.blockDim = dim3((unsigned)shape[2]);
  cfg.dynamicSmemBytes = (size_t)shape[3];
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)shape[0];
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = shape[0] > 1 ? 1 : 0;
  rc = (int)cudaLaunchKernelEx(&cfg, radix2_ntt_kernel, (const uint32_t*)x, (uint32_t*)y,
                               (const uint32_t*)T, log_n, log_c, n * rows);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
