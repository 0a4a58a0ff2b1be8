// K1's MSM apply form (see msm_common.cuh): the tiled accumulation.
//
// Replaces go_snark_study_tpu/ops/pallas_curve.py::_point_kernel as the
// JAX package's go_snark_study_tpu/ops/msm.py:398 scan drives it.  Lane
// (w, t) walks the plan's K steps: gather point ord3[j], fold the sign
// (y -> -y where neg3[j]), open a run on a boundary or madd into it, and
// write the partial straight to its compaction slot idx3[j] (slot p_cap:
// dropped).
//
// Bound on the H100: operations (11 Montgomery products per G1 mixed add,
// 264 IMADs each).  It launches a few waves of 128-thread blocks at
// 160-225 registers, so it runs on latency and occupancy.

#include "msm_common.cuh"

#ifdef __CUDACC__

namespace {

template <class E, bool COMPLETE>
__global__ void __launch_bounds__(128) msm_apply_kernel(
    gs::InPtrs pts, long long npts, const long long* __restrict__ ord3,
    const int32_t* __restrict__ mag3, const uint8_t* __restrict__ neg3,
    const long long* __restrict__ idx3, int K, long long lanes, long long m,
    long long p_cap, gs::OutPtrs out, long long n_out, int32_t* flag) {
  bool live;
  const long long lane = lane_of<E>(lanes, &live);
  if (gs::LaneThreads<E>::value == 1 && !live) return;
  const long long row = (lane / m) * p_cap;  // window w's compaction row
  gs::Jac<E> acc;
  gs::set_zero(acc);
  int32_t prev = -9;
  bool bad = false;
  for (int j = 0; j < K; ++j) {
    const long long o = (long long)j * lanes + lane;
    const int32_t mag = mag3[o];
    gs::Jac<E> pt;
    gs::load_pt(pt, pts.c, ord3[o], npts);
    if (neg3[o]) pt.y = gs::neg(pt.y);
    const bool boundary = mag != prev;
    if (gs::any_lane(pt.x, !boundary)) {
      bool f = false;
      const gs::Jac<E> s = gs::jac_add<E, true, COMPLETE>(acc, pt, &f);
      if (!boundary) {
        acc = s;
        bad = bad || (f && mag > 0);  // run interiors of live buckets
      }
    }
    if (boundary) acc = pt;
    prev = mag;
    const long long slot = idx3[o];
    if (live && slot != p_cap) gs::store_pt(out.c, acc, row + slot, n_out);
  }
  if (!COMPLETE && live && bad) atomicOr(flag, 1);
}

}  // namespace

// pts: 3 * arity pointers to (8, npts) affine coordinates; ord3 / idx3
// int64, mag3 int32, neg3 bool (uint8), all (K, lanes) with lanes = Wg * m;
// out: 3 * arity pointers to (8, Wg, p_cap) zero-filled, n_out = Wg * p_cap.
extern "C" int gs_msm_apply(int arity, int complete, const void* pts, long long npts,
                            const void* ord3, const void* mag3, const void* neg3,
                            const void* idx3, int K, long long lanes, long long m,
                            long long p_cap, const void* out, long long n_out, void* flag,
                            void* stream) {
  if (bad_args(arity, complete, flag) || lanes <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const gs::InPtrs a = in_ptrs(pts, 3 * arity);
  const gs::OutPtrs o = out_ptrs(out, 3 * arity);
  const int threads = 128;
  GS_LAUNCH(msm_apply_kernel, blocks_for(lanes, arity, threads), threads, (cudaStream_t)stream,
            a, npts, (const long long*)ord3, (const int32_t*)mag3, (const uint8_t*)neg3,
            (const long long*)idx3, K, lanes, m, p_cap, o, n_out, (int32_t*)flag);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
