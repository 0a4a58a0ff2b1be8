// K1's MSM reduce form (see msm_common.cuh): the bucket reduction, in two
// launches.  Stage 1, W x Q lanes: the double running sum over the D
// buckets of a chunk; stage 2, W lanes: the Q chunk sums, log2 D doublings
// (dbl-2009-l) and the final add.
//
// Replaces go_snark_study_tpu/ops/pallas_curve.py::_point_kernel as the
// JAX package's go_snark_study_tpu/ops/msm.py:529 and :554 loops drive it.
//
// Bound on the H100: a chain of dependent adds in each of 408 (stage 1) or
// 24 (stage 2) lanes: its time is one lane's add latency times 127
// (stage 1) or 50 adds plus 6 doublings (stage 2), whatever the card's
// throughput.  The accumulators live in shared memory, so no instance
// spills.

#include "msm_common.cuh"

#ifdef __CUDACC__

namespace {

// stage 1: lane (w, q) over buckets w*M + q*D + j: for j = D-1 .. 1,
// running += B_j then t += running; then running += B_0 (= S_q).  Step k
// is running += B_j (k even, j = D-1-k/2) or t += running (k odd).
template <class E, bool COMPLETE>
__global__ void __launch_bounds__(REDUCE_THREADS) msm_reduce1_kernel(
    gs::InPtrs bk, long long W, int Q, int D, gs::OutPtrs s_out, gs::OutPtrs t_out,
    int32_t* flag) {
  __shared__ uint32_t sm_run[24 * REDUCE_THREADS], sm_t[24 * REDUCE_THREADS];
  const long long n = W * Q;
  bool live;
  const long long lane = lane_of<E>(n, &live);
  if (gs::LaneThreads<E>::value == 1 && !live) return;
  const long long nb = n * D;
  const long long base = (lane / Q) * Q * D + (lane % Q) * D;
  {
    gs::Jac<E> zero;
    gs::set_zero(zero);
    park(sm_run, zero);
    park(sm_t, zero);
  }
  bool bad = false;
  for (int k = 0; k < 2 * D - 1; ++k) {
    const bool into_t = k & 1;  // the same for every lane
    uint32_t* dst = into_t ? sm_t : sm_run;
    gs::Jac<E> y;
    if (into_t)
      y = unpark<E>(sm_run);
    else
      gs::load_pt(y, bk.c, base + (D - 1 - k / 2), nb);
    bool f = false;
    park(dst, gs::jac_add<E, false, COMPLETE>(unpark<E>(dst), y, &f));
    bad = bad || f;
  }
  if (live) {
    gs::store_pt(s_out.c, unpark<E>(sm_run), lane, n);
    gs::store_pt(t_out.c, unpark<E>(sm_t), lane, n);
  }
  if (!COMPLETE && live && bad) atomicOr(flag, 1);
}

// stage 2: lane w over its Q chunk sums, q descending: run_s += S_q and
// inner += run_s for q = Q-1 .. 1; then tot += T_q for q = Q-1 .. 0; then
// inner is doubled log2 D times and the result is inner + tot.  The sum
// over T_q runs after the double running sum instead of interleaved with
// it: the accumulators are independent, so each sees the same adds in the
// same order (tot takes run_s's slot).  Step s of the loop is one add;
// the doublings and the last add follow it.
template <class E, bool COMPLETE>
__global__ void __launch_bounds__(REDUCE_THREADS) msm_reduce2_kernel(
    gs::InPtrs s_in, gs::InPtrs t_in, long long W, int Q, int log_d, gs::OutPtrs out,
    int32_t* flag) {
  __shared__ uint32_t sm_acc[24 * REDUCE_THREADS], sm_inner[24 * REDUCE_THREADS];
  bool live;
  const long long lane = lane_of<E>(W, &live);
  if (gs::LaneThreads<E>::value == 1 && !live) return;
  const long long nq = W * Q;
  const long long base = lane * Q;
  {
    gs::Jac<E> zero;
    gs::set_zero(zero);
    park(sm_acc, zero);
    park(sm_inner, zero);
  }
  const int s_steps = 2 * (Q - 1), t_end = s_steps + Q;
  bool bad = false, f = false;
  for (int s = 0; s < t_end; ++s) {  // every branch is the same for all lanes
    const bool to_inner = s < s_steps && (s & 1);
    uint32_t* dst = to_inner ? sm_inner : sm_acc;
    if (s == s_steps) {  // run_s is done: tot starts
      gs::Jac<E> zero;
      gs::set_zero(zero);
      park(sm_acc, zero);
    }
    gs::Jac<E> y;
    if (to_inner)
      y = unpark<E>(sm_acc);
    else if (s < s_steps)
      gs::load_pt(y, s_in.c, base + (Q - 1 - s / 2), nq);
    else
      gs::load_pt(y, t_in.c, base + (Q - 1 - (s - s_steps)), nq);
    park(dst, gs::jac_add<E, false, COMPLETE>(unpark<E>(dst), y, &f));
    bad = bad || f;
  }
  {  // inner x D, + tot
    gs::Jac<E> inner = unpark<E>(sm_inner);
    for (int i = 0; i < log_d; ++i) inner = gs::jac_double(inner);
    park(sm_inner, gs::jac_add<E, false, COMPLETE>(inner, unpark<E>(sm_acc), &f));
    bad = bad || f;
  }
  if (live) gs::store_pt(out.c, unpark<E>(sm_inner), lane, W);
  if (!COMPLETE && live && bad) atomicOr(flag, 1);
}

}  // namespace

// stage 1: in1 = buckets (8, W, Q*D); out1, out2 = S, T (8, W, Q).
// stage 2: in1, in2 = S, T; out1 = the window sums (8, W).  D a power of 2.
extern "C" int gs_msm_reduce(int stage, int arity, int complete, const void* in1,
                             const void* in2, long long W, int Q, int D, const void* out1,
                             const void* out2, void* flag, void* stream) {
  if (bad_args(arity, complete, flag) || W <= 0 || Q <= 0 || D <= 0 || (D & (D - 1)))
    return (int)cudaErrorInvalidValue;
  const int k = 3 * arity;
  const int threads = REDUCE_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (stage == 1) {
    GS_LAUNCH(msm_reduce1_kernel, blocks_for(W * Q, arity, threads), threads, s,
              in_ptrs(in1, k), W, Q, D, out_ptrs(out1, k), out_ptrs(out2, k), (int32_t*)flag);
  } else if (stage == 2) {
    int log_d = 0;
    while ((1 << log_d) < D) ++log_d;
    GS_LAUNCH(msm_reduce2_kernel, blocks_for(W, arity, threads), threads, s,
              in_ptrs(in1, k), in_ptrs(in2, k), W, Q, log_d, out_ptrs(out1, k), (int32_t*)flag);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
