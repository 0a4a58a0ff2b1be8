// Fp / Fq2 arithmetic shared by the port's CUDA kernels.
//
// A field element is 8 little-endian 32-bit limbs holding the canonical
// Montgomery value (R = 2^256, value < p), the same integer the JAX package
// keeps in 32 8-bit limbs.  Tensors are limb-major: limb j of lane i of an
// N-lane array sits at j*N + i, so a warp's load of one limb row coalesces.
//
//   * mont_mul: CIOS with 32-bit digits.  On the device the accumulator is
//     split by columns, as sppark's mont_t does: the even limbs' products
//     a[2k] * b_i fill columns 2k, 2k+1 of one array and the odd limbs'
//     fill the other, so each row (t += a * b_i, then t += m * p with
//     m = t0 * (-p^-1 mod 2^32)) is two PTX carry chains with no data
//     between them (mad.lo.cc / madc.hi.cc).  Each chain sits inside one
//     asm statement, because the carry flag does not survive between two.
//     The host compiler gets the same CIOS on 64-bit accumulators.  Both
//     reduce the result below p once, so the two paths give the same bits.
//   * add / sub: 8-limb carry / borrow chains, then one conditional
//     subtract (add) or add (sub) of p.  All results are canonical, so any
//     exact formula for a value gives the same bits as the JAX package.
//   * Fp2S: an element of Fq2 = Fq[u]/(u^2 + 1) (beta = -1) held by a PAIR
//     of neighbouring threads, thread 2k the c0 and thread 2k+1 the c1
//     component.  Its product needs two Fp products per thread and 16
//     shuffles; a G2 point then takes as many registers per thread as a G1
//     point.  Its operations shuffle, so every thread of the warp must
//     reach them together: callers branch on any_lane(), never on one
//     lane's predicate.
//
// Everything is __host__ __device__; all but Fp2S can be compiled and
// checked on a host compiler as well.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define GS_HD __host__ __device__ __forceinline__
#else
#define GS_HD inline
#endif

namespace gs {

// BN128 base field q and scalar field r: limbs and n0 = -p^-1 mod 2^32.
struct ModQ {
  GS_HD static uint32_t limb(int i) {
    switch (i) {
      case 0: return 0xd87cfd47u;
      case 1: return 0x3c208c16u;
      case 2: return 0x6871ca8du;
      case 3: return 0x97816a91u;
      case 4: return 0x8181585du;
      case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u;
      default: return 0x30644e72u;
    }
  }
  static constexpr uint32_t n0 = 0xe4866389u;
};

struct ModR {
  GS_HD static uint32_t limb(int i) {
    switch (i) {
      case 0: return 0xf0000001u;
      case 1: return 0x43e1f593u;
      case 2: return 0x79b97091u;
      case 3: return 0x2833e848u;
      case 4: return 0x8181585du;
      case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u;
      default: return 0x30644e72u;
    }
  }
  static constexpr uint32_t n0 = 0xefffffffu;
};

template <class P>
struct Fp {
  uint32_t v[8];
};

// t (+ hi * 2^256), a value < 2p  ->  t mod p
template <class P>
GS_HD Fp<P> reduce_once(const uint32_t t[8], uint32_t hi) {
  uint32_t d[8];
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)t[j] - P::limb(j) - br;
    d[j] = (uint32_t)x;
    br = (x >> 32) & 1u;
  }
  bool ge = (hi != 0u) || (br == 0u);  // no final borrow: t >= p
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = ge ? d[j] : t[j];
  return r;
}

template <class P>
GS_HD Fp<P> add(const Fp<P>& a, const Fp<P>& b) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)a.v[j] + b.v[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_once<P>(s, (uint32_t)c);
}

template <class P>
GS_HD Fp<P> sub(const Fp<P>& a, const Fp<P>& b) {
  uint32_t d[8];
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)a.v[j] - b.v[j] - br;
    d[j] = (uint32_t)x;
    br = (x >> 32) & 1u;
  }
  // a < b: add p back (mask is all ones then, zero otherwise)
  uint32_t mask = 0u - (uint32_t)br;
  uint64_t c = 0;
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)d[j] + (P::limb(j) & mask);
    r.v[j] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

template <class P>
GS_HD Fp<P> dbl(const Fp<P>& a) {
  return add<P>(a, a);
}

#if defined(__CUDA_ARCH__)
// acc[0..7] += a[0,2,4,6] * b (column pairs 0-1, 2-3, 4-5, 6-7); top += carry
__device__ __forceinline__ void eo_mad_even(uint32_t acc[8], uint32_t& top, const uint32_t a[8], uint32_t b) {
  asm volatile(
      "mad.lo.cc.u32  %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32       %8, %8, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(top)
      : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(b));
}

// acc[0..7] += a[1,3,5,7] * b; the carry out is zero by the caller's bound
__device__ __forceinline__ void eo_mad_odd(uint32_t acc[8], const uint32_t a[8], uint32_t b) {
  asm volatile(
      "mad.lo.cc.u32  %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32    %7, %11, %12, %7;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// e0 += o[1]; then o[j] = o[j+2] + a[1,3,5,7] * b with that carry in:
// the odd accumulator moves down one column while it takes the next row
__device__ __forceinline__ void eo_rshift_odd(uint32_t& e0, uint32_t o[8], const uint32_t a[8], uint32_t b) {
  asm volatile(
      "add.cc.u32     %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
      "madc.hi.u32    %8, %12, %13, 0;"
      : "+r"(e0), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]),
        "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// d[0..6] += s[1..7], d[7] += carry
__device__ __forceinline__ void eo_merge(uint32_t d[8], const uint32_t s[8]) {
  asm volatile(
      "add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, 0;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]), "r"(s[7]));
}

// one row of CIOS over the split accumulator, value = E + O * 2^32 with O
// one column up: the row's even-limb products go down E's carry chain and
// its odd-limb products down O's, two chains with no data between them;
// then the reduction m * p the same way.  E[0] is then 0, so the next row
// swaps the arrays' roles, O moving down one column as it takes its
// products (eo_rshift_odd).
template <class P>
__device__ __forceinline__ void eo_row(uint32_t E[8], uint32_t O[8], const uint32_t a[8],
                                       uint32_t b, const uint32_t p[8], bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      E[j] = a[j] * b;
      E[j + 1] = __umulhi(a[j], b);
      O[j] = a[j + 1] * b;
      O[j + 1] = __umulhi(a[j + 1], b);
    }
  } else {
    eo_rshift_odd(E[0], O, a, b);
    eo_mad_even(E, O[7], a, b);
  }
  const uint32_t m = E[0] * P::n0;
  eo_mad_odd(O, p, m);
  eo_mad_even(E, O[7], p, m);
}

#endif

template <class P>
GS_HD Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
#if defined(__CUDA_ARCH__)
  uint32_t p[8], ev[8], od[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = P::limb(j);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    eo_row<P>(ev, od, a.v, b.v[i], p, i == 0);
    eo_row<P>(od, ev, a.v, b.v[i + 1], p, false);
  }
  eo_merge(ev, od);  // the value, below 2p, in ev
  return reduce_once<P>(ev, 0u);
#else
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.v[i] * b.v[j] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * P::n0;
    c = ((uint64_t)m * P::limb(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)m * P::limb(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  return reduce_once<P>(t, t[8]);
#endif
}

template <class P>
GS_HD Fp<P> sqr(const Fp<P>& a) {
  return mul<P>(a, a);
}

template <class P>
GS_HD bool is_zero(const Fp<P>& a) {
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) o |= a.v[j];
  return o == 0u;
}

template <class P>
GS_HD void set_zero(Fp<P>& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = 0u;
}

// -a mod p (0 stays 0)
template <class P>
GS_HD Fp<P> neg(const Fp<P>& a) {
  Fp<P> z;
  set_zero<P>(z);
  return sub<P>(z, a);
}

// the limb words of an element as this thread holds them
template <class P>
GS_HD uint32_t* words(Fp<P>& a) {
  return a.v;
}

template <class P>
GS_HD const uint32_t* words(const Fp<P>& a) {
  return a.v;
}

// whether any lane that shares this lane's instruction stream needs a
// branch; for one lane per thread that is the lane itself
template <class P>
GS_HD bool any_lane(const Fp<P>&, bool pred) {
  return pred;
}

#if defined(__CUDACC__)
// -- Fp2S: one Fq2 element over a pair of threads ----------------------------
template <class P>
struct Fp2S {
  Fp<P> c;  // component (threadIdx.x & 1) of the element
};

// The host pass of nvcc compiles these too; only the device runs them.
GS_HD bool pair_hi() {
#if defined(__CUDA_ARCH__)
  return threadIdx.x & 1u;
#else
  return false;
#endif
}

GS_HD uint32_t shfl_partner(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __shfl_xor_sync(0xffffffffu, v, 1);
#else
  return v;
#endif
}

GS_HD bool warp_any(bool pred) {
#if defined(__CUDA_ARCH__)
  return __any_sync(0xffffffffu, pred);
#else
  return pred;
#endif
}

template <class P>
GS_HD Fp<P> partner(const Fp<P>& a) {
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = shfl_partner(a.v[j]);
  return r;
}

template <class P>
GS_HD Fp<P> pick(bool hi, const Fp<P>& a, const Fp<P>& b) {
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = hi ? a.v[j] : b.v[j];
  return r;
}

template <class P>
GS_HD Fp2S<P> add(const Fp2S<P>& a, const Fp2S<P>& b) {
  return {add<P>(a.c, b.c)};
}

template <class P>
GS_HD Fp2S<P> sub(const Fp2S<P>& a, const Fp2S<P>& b) {
  return {sub<P>(a.c, b.c)};
}

template <class P>
GS_HD Fp2S<P> dbl(const Fp2S<P>& a) {
  return {dbl<P>(a.c)};
}

template <class P>
GS_HD Fp2S<P> neg(const Fp2S<P>& a) {
  return {neg<P>(a.c)};
}

// c0 = a0 b0 - a1 b1 on the low thread, c1 = a0 b1 + a1 b0 on the high one:
// the canonical values of the Karatsuba product, two products per thread
template <class P>
GS_HD Fp2S<P> mul(const Fp2S<P>& a, const Fp2S<P>& b) {
  const bool hi = pair_hi();
  const Fp<P> ao = partner<P>(a.c), bo = partner<P>(b.c);
  const Fp<P> x = mul<P>(pick<P>(hi, ao, a.c), b.c);  // a0 b0 | a0 b1
  const Fp<P> y = mul<P>(pick<P>(hi, a.c, ao), bo);   // a1 b1 | a1 b0
  return {pick<P>(hi, add<P>(x, y), sub<P>(x, y))};
}

// c0 = (a0 + a1)(a0 - a1) on the low thread, c1 = 2 a0 a1 on the high one
template <class P>
GS_HD Fp2S<P> sqr(const Fp2S<P>& a) {
  const bool hi = pair_hi();
  const Fp<P> ao = partner<P>(a.c);
  const Fp<P> x = mul<P>(pick<P>(hi, ao, add<P>(a.c, ao)), pick<P>(hi, a.c, sub<P>(a.c, ao)));
  return {pick<P>(hi, dbl<P>(x), x)};
}

template <class P>
GS_HD bool is_zero(const Fp2S<P>& a) {
  const bool z = is_zero<P>(a.c);
  const uint32_t zo = shfl_partner(z ? 1u : 0u);  // both threads shuffle
  return z && zo != 0u;
}

template <class P>
GS_HD void set_zero(Fp2S<P>& a) {
  set_zero<P>(a.c);
}

template <class P>
GS_HD uint32_t* words(Fp2S<P>& a) {
  return a.c.v;
}

template <class P>
GS_HD const uint32_t* words(const Fp2S<P>& a) {
  return a.c.v;
}

template <class P>
GS_HD bool any_lane(const Fp2S<P>&, bool pred) {
  return warp_any(pred);
}
#endif

// -- limb-major loads and stores ---------------------------------------------
template <class P>
GS_HD Fp<P> load(const uint32_t* src, long long i, long long n) {
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = src[j * n + i];
  return r;
}

template <class P>
GS_HD void store(uint32_t* dst, const Fp<P>& a, long long i, long long n) {
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j * n + i] = a.v[j];
}

}  // namespace gs
