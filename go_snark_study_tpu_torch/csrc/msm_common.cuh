// K1's MSM forms: the Pippenger MSM's three serial loops (ops/msm.py) run
// inside the kernel, each thread owning one lane across every step.  The
// three forms are three translation units, built in parallel:
// msm_apply.cu, msm_seg_scan.cu and msm_reduce.cu.  This header holds what
// they share: a thread's lane, the reduce kernels' parking of points in
// shared memory, the pointer arrays of the C entry points and the launch of
// a form's four instances.
//
// They replace go_snark_study_tpu/ops/pallas_curve.py::_point_kernel as the
// JAX package's MSM drives it: the jax.lax.scan / fori_loop loops of
// go_snark_study_tpu/ops/msm.py (:398 tiled accumulation, :445 segmented
// merge scan, :529 and :554 bucket reduction), each one compiled program on
// the TPU.  Here a loop is one launch (the merge scan: one per
// Hillis-Steele step), and the lane bodies are point.cuh's, the same adds in
// the same order, so the window sums are bit-identical to the JAX engine's
// and the flags fire on the same inputs.
//
// Flags: each incomplete form ORs its lanes' degeneracy flags, counted as
// msm.py counts them, into ONE int32 with atomicOr; the host reads one word
// per MSM.  The complete forms (the re-run engine) write no flag.
//
// G2: a pair of neighbouring threads per lane, one Fq2 component each
// (Fp2S), so a G2 add holds about as many registers per thread as a G1 add;
// branches that hold a shuffle are taken warp-wide (any_lane), and the tail
// of the last warp works on a clamped lane and stores nothing.  No instance
// spills: the reduce forms park their accumulators in shared memory.

#pragma once

#include "point.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

using G1 = gs::Fp<gs::ModQ>;
using G2 = gs::Fp2S<gs::ModQ>;

// thread -> its lane; the tail of a G2 warp takes the last lane (live = false)
template <class E>
__device__ __forceinline__ long long lane_of(long long n, bool* live) {
  constexpr int TPL = gs::LaneThreads<E>::value;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / TPL;
  *live = i < n;
  return i < n ? i : n - 1;
}

// The reduce kernels keep their accumulators in shared memory, 24 words a
// thread at word k * 64 + tid, and run one add per loop step on operands
// loaded from there (or from the input): one add site, no more than two
// points and one add's temporaries in registers, so the G2 instances do
// not spill.
constexpr int REDUCE_THREADS = 64;

template <class E>
__device__ __forceinline__ void park(uint32_t* sm, const gs::Jac<E>& p) {
  const uint32_t* x = gs::words(p.x);
  const uint32_t* y = gs::words(p.y);
  const uint32_t* z = gs::words(p.z);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sm[j * REDUCE_THREADS + threadIdx.x] = x[j];
    sm[(8 + j) * REDUCE_THREADS + threadIdx.x] = y[j];
    sm[(16 + j) * REDUCE_THREADS + threadIdx.x] = z[j];
  }
}

template <class E>
__device__ __forceinline__ gs::Jac<E> unpark(const uint32_t* sm) {
  gs::Jac<E> p;
  uint32_t* x = gs::words(p.x);
  uint32_t* y = gs::words(p.y);
  uint32_t* z = gs::words(p.z);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = sm[j * REDUCE_THREADS + threadIdx.x];
    y[j] = sm[(8 + j) * REDUCE_THREADS + threadIdx.x];
    z[j] = sm[(16 + j) * REDUCE_THREADS + threadIdx.x];
  }
  return p;
}

gs::InPtrs in_ptrs(const void* p, int k) {
  gs::InPtrs r{};
  for (int j = 0; j < k; ++j) r.c[j] = ((const uint32_t* const*)p)[j];
  return r;
}

gs::OutPtrs out_ptrs(const void* p, int k) {
  gs::OutPtrs r{};
  for (int j = 0; j < k; ++j) r.c[j] = ((uint32_t* const*)p)[j];
  return r;
}

unsigned blocks_for(long long lanes, int arity, int threads) {
  return (unsigned)((lanes * arity + threads - 1) / threads);
}

}  // namespace

// the four instances of a form: {G1, G2} x {incomplete + flag, complete}
#define GS_LAUNCH(KERNEL, blocks, threads, s, ...)                                     \
  do {                                                                                 \
    if (arity == 1 && complete) KERNEL<G1, true><<<blocks, threads, 0, s>>>(__VA_ARGS__); \
    else if (arity == 1) KERNEL<G1, false><<<blocks, threads, 0, s>>>(__VA_ARGS__);       \
    else if (complete) KERNEL<G2, true><<<blocks, threads, 0, s>>>(__VA_ARGS__);          \
    else KERNEL<G2, false><<<blocks, threads, 0, s>>>(__VA_ARGS__);                       \
  } while (0)

static bool bad_args(int arity, int complete, const void* flag) {
  return (arity != 1 && arity != 2) || (!complete && flag == nullptr);
}

#endif
