// K1: one Jacobian point add per lane, every intermediate in registers.
//
// Replaces go_snark_study_tpu/ops/pallas_curve.py::_point_kernel.  Eight
// instances: {mixed (p2 affine), full} x {complete, incomplete + flag} x
// {G1 over Fq, G2 over Fq2}, with the lane bodies of point.cuh.  A G1 lane
// is one thread; a G2 lane is a pair of neighbouring threads, one per Fq2
// component (Fp2S in field.cuh), so that a G2 add holds no more registers
// per thread than a G1 add and does not spill.
// Bound on the H100: operations (a G1 incomplete mixed add is 11
// Montgomery products, ~2,900 IMADs, against 292 bytes per lane).

#include "point.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <class E, bool MIXED, bool COMPLETE>
__global__ void __launch_bounds__(128) point_add_kernel(
    gs::InPtrs in1, gs::InPtrs in2, gs::OutPtrs out, int32_t* flag, long long n) {
  constexpr int TPL = gs::LaneThreads<E>::value;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / TPL;
  if constexpr (TPL == 1) {
    if (i < n) gs::point_add_lane<E, MIXED, COMPLETE>(in1.c, in2.c, out.c, flag, i, n);
    return;
  }
  // a pair shuffles with every thread of its warp: the tail computes on the
  // last lane's operands and stores nothing
  gs::Jac<E> p1, p2;
  const long long j = i < n ? i : n - 1;
  gs::load_pt(p1, in1.c, j, n);
  gs::load_pt(p2, in2.c, j, n);
  bool bad = false;
  const gs::Jac<E> r = gs::jac_add<E, MIXED, COMPLETE>(p1, p2, &bad);
  if (i < n) {
    gs::store_pt(out.c, r, i, n);
    if (!COMPLETE) flag[i] = bad ? 1 : 0;
  }
}

template <class E>
static void launch_form(int form, unsigned blocks, int threads, cudaStream_t s,
                        const gs::InPtrs& a, const gs::InPtrs& b,
                        const gs::OutPtrs& o, int32_t* flag, long long n) {
  switch (form) {
    case 0: point_add_kernel<E, true, true><<<blocks, threads, 0, s>>>(a, b, o, flag, n); break;
    case 1: point_add_kernel<E, false, true><<<blocks, threads, 0, s>>>(a, b, o, flag, n); break;
    case 2: point_add_kernel<E, true, false><<<blocks, threads, 0, s>>>(a, b, o, flag, n); break;
    case 3: point_add_kernel<E, false, false><<<blocks, threads, 0, s>>>(a, b, o, flag, n); break;
  }
}

// form: 0 madd, 1 jadd, 2 madd_f, 3 jadd_f; arity: 1 (G1) or 2 (G2).
// in1, in2, out: host arrays of 3 * arity device pointers (x, y, z; each
// G2 coordinate as c0, c1).  flag: n int32 (flagged forms only).
extern "C" int gs_point_add(int form, int arity, const void* in1, const void* in2,
                            const void* out, void* flag, long long n, void* stream) {
  if (form < 0 || form > 3 || (arity != 1 && arity != 2)) return (int)cudaErrorInvalidValue;
  if (form >= 2 && flag == nullptr) return (int)cudaErrorInvalidValue;
  gs::InPtrs a{}, b{};
  gs::OutPtrs o{};
  const int k = 3 * arity;
  for (int j = 0; j < k; ++j) {
    a.c[j] = ((const uint32_t* const*)in1)[j];
    b.c[j] = ((const uint32_t* const*)in2)[j];
    o.c[j] = ((uint32_t* const*)out)[j];
  }
  const int threads = 128;
  unsigned blocks = (unsigned)((n * arity + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (arity == 1)
    launch_form<gs::Fp<gs::ModQ>>(form, blocks, threads, s, a, b, o, (int32_t*)flag, n);
  else
    launch_form<gs::Fp2S<gs::ModQ>>(form, blocks, threads, s, a, b, o, (int32_t*)flag, n);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
