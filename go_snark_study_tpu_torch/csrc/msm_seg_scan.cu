// K1's MSM merge-scan form (see msm_common.cuh): one Hillis-Steele step d
// of the segmented scan; lane l adds the partial at l - d when both carry
// the same digit (ping-pong buffers).
//
// Replaces go_snark_study_tpu/ops/pallas_curve.py::_point_kernel as the
// JAX package's go_snark_study_tpu/ops/msm.py:445 merge scan drives it.
//
// Bound on the H100: bytes where few lanes merge (each lane reads and
// writes its point), operations where many do.  128-thread blocks at
// 160-225 registers, so it runs on latency and occupancy.

#include "msm_common.cuh"

#ifdef __CUDACC__

namespace {

template <class E, bool COMPLETE>
__global__ void __launch_bounds__(128) msm_seg_step_kernel(
    gs::InPtrs in, gs::OutPtrs out, const int32_t* __restrict__ sdig, long long P,
    long long n, long long d, int32_t* flag) {
  bool live;
  const long long lane = lane_of<E>(n, &live);
  if (gs::LaneThreads<E>::value == 1 && !live) return;
  const int32_t dig = sdig[lane];
  const bool same = lane % P >= d && sdig[lane - d] == dig;
  gs::Jac<E> acc;
  gs::load_pt(acc, in.c, lane, n);
  bool bad = false;
  if (gs::any_lane(acc.x, same)) {
    gs::Jac<E> prev;
    gs::load_pt(prev, in.c, same ? lane - d : lane, n);
    bool f = false;
    const gs::Jac<E> s = gs::jac_add<E, false, COMPLETE>(acc, prev, &f);
    if (same) {
      acc = s;
      bad = f && dig > 0;  // bucket-0 and sentinel runs are discarded
    }
  }
  if (live) gs::store_pt(out.c, acc, lane, n);
  if (!COMPLETE && live && bad) atomicOr(flag, 1);
}

}  // namespace

// in / out: 3 * arity pointers to (8, W, P); sdig (W, P) int32, n = W * P
extern "C" int gs_msm_seg_step(int arity, int complete, const void* in, const void* out,
                               const void* sdig, long long P, long long n, long long d,
                               void* flag, void* stream) {
  if (bad_args(arity, complete, flag) || n <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const gs::InPtrs a = in_ptrs(in, 3 * arity);
  const gs::OutPtrs o = out_ptrs(out, 3 * arity);
  const int threads = 128;
  GS_LAUNCH(msm_seg_step_kernel, blocks_for(n, arity, threads), threads, (cudaStream_t)stream,
            a, o, (const int32_t*)sdig, P, n, d, (int32_t*)flag);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
