// Fp / Fp2 arithmetic shared by the port's CUDA kernels.
//
// A field element is 8 little-endian 32-bit limbs holding the canonical
// Montgomery value (R = 2^256, value < p), the same integer the JAX package
// keeps in 32 8-bit limbs.  Tensors are limb-major: limb j of lane i of an
// N-lane array sits at j*N + i, so a warp's load of one limb row coalesces.
//
//   * mont_mul: CIOS with 32-bit digits.  Each 32x32->64-bit partial
//     product is added to a 64-bit accumulator whose high word is the
//     carry into the next column (the carry chain); the quotient digit is
//     m = t0 * (-p^-1 mod 2^32).  The output is reduced below p.
//   * add / sub: 8-limb carry / borrow chains, then one conditional
//     subtract (add) or add (sub) of p.  All results are canonical, so any
//     exact formula for a value gives the same bits as the JAX package.
//   * Fp2 = Fp[u]/(u^2 + 1) (beta = -1), Karatsuba product.
//
// Everything here is __host__ __device__ so that the arithmetic can be
// compiled and checked on a host compiler as well.

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

template <class P>
struct Fp2 {
  Fp<P> c0, c1;
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

template <class P>
GS_HD Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
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

// -- Fp2, beta = -1 ----------------------------------------------------------
template <class P>
GS_HD Fp2<P> add(const Fp2<P>& a, const Fp2<P>& b) {
  return {add<P>(a.c0, b.c0), add<P>(a.c1, b.c1)};
}

template <class P>
GS_HD Fp2<P> sub(const Fp2<P>& a, const Fp2<P>& b) {
  return {sub<P>(a.c0, b.c0), sub<P>(a.c1, b.c1)};
}

template <class P>
GS_HD Fp2<P> dbl(const Fp2<P>& a) {
  return {dbl<P>(a.c0), dbl<P>(a.c1)};
}

template <class P>
GS_HD Fp2<P> mul(const Fp2<P>& a, const Fp2<P>& b) {
  Fp<P> v0 = mul<P>(a.c0, b.c0);
  Fp<P> v1 = mul<P>(a.c1, b.c1);
  Fp<P> t = mul<P>(add<P>(a.c0, a.c1), add<P>(b.c0, b.c1));
  return {sub<P>(v0, v1), sub<P>(t, add<P>(v0, v1))};
}

template <class P>
GS_HD Fp2<P> sqr(const Fp2<P>& a) {
  Fp<P> t = mul<P>(add<P>(a.c0, a.c1), sub<P>(a.c0, a.c1));
  Fp<P> m = mul<P>(a.c0, a.c1);
  return {t, add<P>(m, m)};
}

template <class P>
GS_HD bool is_zero(const Fp2<P>& a) {
  return is_zero<P>(a.c0) && is_zero<P>(a.c1);
}

template <class P>
GS_HD void set_zero(Fp2<P>& a) {
  set_zero<P>(a.c0);
  set_zero<P>(a.c1);
}

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
