// K1: one Jacobian point add per lane, every intermediate in registers.
//
// Replaces go_snark_study_tpu/ops/pallas_curve.py::_point_kernel.  Eight
// instances: {mixed (p2 affine), full} x {complete, incomplete + flag} x
// {G1 over Fq, G2 over Fq2}.  The formulas are those of the JAX package's
// ops/curve_ops.py (madd-2007-bl, add-2007-bl, dbl-2009-l) with its case
// selection: equal points -> doubling (complete forms only), inverse points
// -> identity, an identity operand -> the other operand.  The incomplete
// forms skip the doubling and write flag = 1 where h = 0 with both
// operands live; the complete forms compute the doubling only on the lanes
// that need it, which gives the same point as the JAX formula's select.
// Bound on the H100: operations (a G1 incomplete mixed add is 11
// Montgomery products, ~2,900 IMADs, against 292 bytes per lane).

#include "field.cuh"

namespace gs {

template <class E>
struct Jac {
  E x, y, z;
};

template <class P>
GS_HD void load_e(Fp<P>& e, const uint32_t* const* c, int k, long long i, long long n) {
  e = load<P>(c[k], i, n);
}

template <class P>
GS_HD void load_e(Fp2<P>& e, const uint32_t* const* c, int k, long long i, long long n) {
  e.c0 = load<P>(c[2 * k], i, n);
  e.c1 = load<P>(c[2 * k + 1], i, n);
}

template <class P>
GS_HD void store_e(uint32_t* const* c, int k, const Fp<P>& e, long long i, long long n) {
  store<P>(c[k], e, i, n);
}

template <class P>
GS_HD void store_e(uint32_t* const* c, int k, const Fp2<P>& e, long long i, long long n) {
  store<P>(c[2 * k], e.c0, i, n);
  store<P>(c[2 * k + 1], e.c1, i, n);
}

// dbl-2009-l (the identity doubles to the identity: Z3 = 2*Y*Z = 0)
template <class E>
GS_HD Jac<E> jac_double(const Jac<E>& p) {
  E a = sqr(p.x);
  E b = sqr(p.y);
  E c = sqr(b);
  E t = sqr(add(p.x, b));
  E d = dbl(sub(sub(t, a), c));
  E e = add(dbl(a), a);
  E f = sqr(e);
  Jac<E> r;
  r.x = sub(f, dbl(d));
  E c8 = dbl(dbl(dbl(c)));
  r.y = sub(mul(e, sub(d, r.x)), c8);
  r.z = dbl(mul(p.y, p.z));
  return r;
}

// MIXED: madd-2007-bl with p2 affine (z2 in {0, 1}); else add-2007-bl.
// COMPLETE: route equal points to the doubling; else flag them in *bad.
template <class E, bool MIXED, bool COMPLETE>
GS_HD Jac<E> jac_add(const Jac<E>& p1, const Jac<E>& p2, bool* bad) {
  const bool p1_zero = is_zero(p1.z);
  const bool p2_zero = is_zero(p2.z);
  E h, r;
  Jac<E> out;
  if (MIXED) {
    E z1z1 = sqr(p1.z);
    E u2 = mul(p2.x, z1z1);
    E s2 = mul(p2.y, mul(p1.z, z1z1));
    h = sub(u2, p1.x);
    r = dbl(sub(s2, p1.y));
    E hh = sqr(h);
    E i = dbl(dbl(hh));
    E j = mul(h, i);
    E v = mul(p1.x, i);
    out.x = sub(sub(sqr(r), j), dbl(v));
    out.y = sub(mul(r, sub(v, out.x)), dbl(mul(p1.y, j)));
    out.z = sub(sub(sqr(add(p1.z, h)), z1z1), hh);
  } else {
    E z1z1 = sqr(p1.z);
    E z2z2 = sqr(p2.z);
    E u1 = mul(p1.x, z2z2);
    E u2 = mul(p2.x, z1z1);
    E s1 = mul(p1.y, mul(p2.z, z2z2));
    E s2 = mul(p2.y, mul(p1.z, z1z1));
    h = sub(u2, u1);
    r = dbl(sub(s2, s1));
    E i = sqr(dbl(h));
    E j = mul(h, i);
    E v = mul(u1, i);
    out.x = sub(sub(sqr(r), j), dbl(v));
    out.y = sub(mul(r, sub(v, out.x)), dbl(mul(s1, j)));
    out.z = mul(sub(sub(sqr(add(p1.z, p2.z)), z1z1), z2z2), h);
  }
  const bool h_zero = is_zero(h);
  if (COMPLETE) {
    if (h_zero) {
      if (is_zero(r)) {
        out = jac_double(p1);  // p1 == p2
      } else {
        set_zero(out.x);  // p1 == -p2
        set_zero(out.y);
        set_zero(out.z);
      }
    }
  } else {
    *bad = h_zero && !p1_zero && !p2_zero;
  }
  if (p2_zero) out = p1;
  if (p1_zero) out = p2;
  return out;
}

template <class E, bool MIXED, bool COMPLETE>
GS_HD void point_add_lane(const uint32_t* const* in1, const uint32_t* const* in2,
                          uint32_t* const* out, int32_t* flag, long long i, long long n) {
  Jac<E> p1, p2;
  load_e(p1.x, in1, 0, i, n);
  load_e(p1.y, in1, 1, i, n);
  load_e(p1.z, in1, 2, i, n);
  load_e(p2.x, in2, 0, i, n);
  load_e(p2.y, in2, 1, i, n);
  load_e(p2.z, in2, 2, i, n);
  bool bad = false;
  Jac<E> r = jac_add<E, MIXED, COMPLETE>(p1, p2, &bad);
  store_e(out, 0, r.x, i, n);
  store_e(out, 1, r.y, i, n);
  store_e(out, 2, r.z, i, n);
  if (!COMPLETE) flag[i] = bad ? 1 : 0;
}

// up to 6 coordinate arrays per point: 3 for G1, 3 x 2 components for G2
struct InPtrs {
  const uint32_t* c[6];
};
struct OutPtrs {
  uint32_t* c[6];
};

}  // namespace gs

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <class E, bool MIXED, bool COMPLETE>
__global__ void __launch_bounds__(128) point_add_kernel(
    gs::InPtrs in1, gs::InPtrs in2, gs::OutPtrs out, int32_t* flag, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) gs::point_add_lane<E, MIXED, COMPLETE>(in1.c, in2.c, out.c, flag, i, n);
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
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (arity == 1)
    launch_form<gs::Fp<gs::ModQ>>(form, blocks, threads, s, a, b, o, (int32_t*)flag, n);
  else
    launch_form<gs::Fp2<gs::ModQ>>(form, blocks, threads, s, a, b, o, (int32_t*)flag, n);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
