// K1's MSM forms: the Pippenger MSM's three serial loops (ops/msm.py) run
// inside the kernel, each thread owning one lane across every step.
//
// Replaces go_snark_study_tpu/ops/pallas_curve.py::_point_kernel as the JAX
// package's MSM drives it: the jax.lax.scan / fori_loop loops of
// go_snark_study_tpu/ops/msm.py (:398 tiled accumulation, :445 segmented
// merge scan, :529 and :554 bucket reduction), each one compiled program on
// the TPU.  The port had turned every step of those loops into a host round
// of a K1 launch plus its gather / select / flag glue; here a loop is one
// launch (the merge scan: one per Hillis-Steele step), and the lane bodies
// are point.cuh's, the same adds in the same order, so the window sums are
// bit-identical to the JAX engine's and the flags fire on the same inputs.
//
//   apply    lane (w, t) walks the plan's K steps: gather point ord3[j],
//            fold the sign (y -> -y where neg3[j]), open a run on a
//            boundary or madd into it, and write the partial straight to
//            its compaction slot idx3[j] (slot p_cap: dropped).
//   seg      one Hillis-Steele step d: lane l adds the partial at l - d
//            when both carry the same digit (ping-pong buffers).
//   reduce   stage 1, W x Q lanes: the double running sum over the D
//            buckets of a chunk; stage 2, W lanes: the Q chunk sums, log2 D
//            doublings (dbl-2009-l) and the final add.
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
//
// Bound on the H100: the apply form is operations-bound (11 Montgomery
// products per G1 mixed add, 264 IMADs each); a merge-scan step, where few
// lanes merge, is bytes-bound.  Both launch a few waves of 128-thread
// blocks at 160-225 registers, so they run on latency and occupancy.  The
// reduction is a chain of dependent adds in each of 408 (stage 1) or 24
// (stage 2) lanes: its time is one lane's add latency times 127 (stage 1)
// or 50 adds plus 6 doublings (stage 2), whatever the card's throughput.

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
