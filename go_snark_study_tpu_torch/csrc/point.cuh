// Jacobian point arithmetic over Fp (G1) and Fp2S (G2, a pair of threads
// per lane), shared by K1's per-lane kernel
// (point_add.cu) and its MSM forms (msm_scan.cu).
//
// The formulas are those of the JAX package's ops/curve_ops.py
// (madd-2007-bl, add-2007-bl, dbl-2009-l) with its case selection: equal
// points -> doubling (complete forms only), inverse points -> identity, an
// identity operand -> the other operand.  The incomplete forms skip the
// doubling and report bad = h == 0 with both operands live; the complete
// forms compute the doubling only where some lane of the warp needs it,
// which gives the same point as the JAX formula's select.

#pragma once

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
GS_HD void store_e(uint32_t* const* c, int k, const Fp<P>& e, long long i, long long n) {
  store<P>(c[k], e, i, n);
}

#if defined(__CUDACC__)
// a pair of threads per lane: this thread's component of coordinate k
// (the pointer is picked from two fixed entries: indexing the kernel's
// pointer array with a runtime value would copy it to local memory)
template <class P>
GS_HD void load_e(Fp2S<P>& e, const uint32_t* const* c, int k, long long i, long long n) {
  e.c = load<P>(pair_hi() ? c[2 * k + 1] : c[2 * k], i, n);
}

template <class P>
GS_HD void store_e(uint32_t* const* c, int k, const Fp2S<P>& e, long long i, long long n) {
  store<P>(pair_hi() ? c[2 * k + 1] : c[2 * k], e.c, i, n);
}
#endif

// threads that hold one lane: 2 for Fp2S, else 1
template <class E>
struct LaneThreads {
  static constexpr int value = 1;
};
#if defined(__CUDACC__)
template <class P>
struct LaneThreads<Fp2S<P>> {
  static constexpr int value = 2;
};
#endif

template <class E>
GS_HD void load_pt(Jac<E>& p, const uint32_t* const* c, long long i, long long n) {
  load_e(p.x, c, 0, i, n);
  load_e(p.y, c, 1, i, n);
  load_e(p.z, c, 2, i, n);
}

template <class E>
GS_HD void store_pt(uint32_t* const* c, const Jac<E>& p, long long i, long long n) {
  store_e(c, 0, p.x, i, n);
  store_e(c, 1, p.y, i, n);
  store_e(c, 2, p.z, i, n);
}

template <class E>
GS_HD void set_zero(Jac<E>& p) {
  set_zero(p.x);
  set_zero(p.y);
  set_zero(p.z);
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
    const bool r_zero = is_zero(r);
    if (any_lane(h, h_zero && r_zero)) {  // the whole warp takes this branch
      const Jac<E> d = jac_double(p1);
      if (h_zero && r_zero) out = d;  // p1 == p2
    }
    if (h_zero && !r_zero) set_zero(out);  // p1 == -p2
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
  load_pt(p1, in1, i, n);
  load_pt(p2, in2, i, n);
  bool bad = false;
  Jac<E> r = jac_add<E, MIXED, COMPLETE>(p1, p2, &bad);
  store_pt(out, r, i, n);
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

