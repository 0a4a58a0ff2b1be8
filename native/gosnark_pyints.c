/* Python ints -> canonical 32-byte little-endian field values, read from the
 * int objects themselves.
 *
 * A library of its own beside libgosnark_native.so, which has no Python
 * dependency: this one is built against the running interpreter's headers
 * and loaded through ctypes.PyDLL, so every call holds the GIL.
 *
 *   gosnark_encode_ints(seq, dst, p, slow)
 *       seq: a list or tuple of n items; dst: 32 * n writable bytes; p: the
 *       modulus as 32 little-endian bytes; slow: a callable.  Each item that
 *       is an exact int in [0, p) is written as its 32 little-endian bytes;
 *       any other item x (a value >= p, a negative int, a bool, an int
 *       subclass, a numpy integer, ...) is written as slow(x), which must
 *       return 32 bytes: the caller's (x % p) encoding.  Returns the number
 *       of items slow encoded, or -1 with a Python exception set.
 *   gosnark_ints_to_bytes(seq, p, slow)
 *       the same into a new bytes object of 32 * n bytes (NULL with an
 *       exception set on failure).
 *
 * and the host group law's two long chains, G1 over Fq (deg 1) and G2 over
 * Fq2 = Fq[u]/(u^2 - nr) (deg 2), on 4x64-bit Montgomery limbs (R = 2^256):
 *
 *   gosnark_curve_new(q, nr)
 *       a context for the odd modulus q and the Fq2 non-residue nr (both 32
 *       little-endian bytes, nr < q), or NULL where q is even or below 3.
 *   gosnark_mul_scalar(ctx, deg, p, e)
 *       e * p by MSB-first double-and-add over e's bits.
 *   gosnark_combine_windows(ctx, deg, windows, c)
 *       sum_w 2^(c*w) * windows[w], MSB window first: c doublings, then one
 *       add, a window.
 *
 * Both mirror bn128/curve.py's add (add-2007-bl, routed to double or to the
 * identity at h = 0) and double (dbl-2009-l) formula for formula, with its
 * zero tests on z and its identities (0, 0, 0) and ((0, 0), (1, 0), (0, 0)),
 * so that they return the Jacobian triple the Python law returns, integer for
 * integer, as tuples of canonical ints, or the very input object where the
 * law passes an operand through unchanged.  A point is a tuple or list of
 * three coordinates; a G2 coordinate a tuple or list of two ints.  They return
 * None, and compute nothing, where a coordinate is not an exact int in
 * [0, q), a scalar not an exact int in [0, 2^256), or the windows not a list
 * or a tuple: the caller's Python law runs those.
 *
 * Build (any C compiler, the include directory of the interpreter that
 * loads it: sysconfig.get_paths()["include"]):
 *     cc -O3 -shared -fPIC -I<include> -o libgosnark_pyints.so gosnark_pyints.c
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define VALUE_BYTES 32

/* a < b for 32-byte little-endian values */
static int less_le(const unsigned char *a, const unsigned char *b) {
  for (int i = VALUE_BYTES - 1; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] < b[i];
  }
  return 0;
}

/* Writes x into out if it is an exact int in [0, 2^256); returns 1 then, 0
 * otherwise.  Never leaves an exception set. */
static int read_u256(PyObject *x, unsigned char *out) {
  if (!PyLong_CheckExact(x)) return 0;
#if PY_VERSION_HEX >= 0x030D0000
  Py_ssize_t need = PyLong_AsNativeBytes(
      x, out, VALUE_BYTES,
      Py_ASNATIVEBYTES_LITTLE_ENDIAN | Py_ASNATIVEBYTES_UNSIGNED_BUFFER | Py_ASNATIVEBYTES_REJECT_NEGATIVE);
  if (need < 0) {
    PyErr_Clear();
    return 0;
  }
  if (need > VALUE_BYTES) return 0;
#else
  /* OverflowError for a negative value or one past 32 bytes */
  if (_PyLong_AsByteArray((PyLongObject *)x, out, VALUE_BYTES, 1, 0) < 0) {
    PyErr_Clear();
    return 0;
  }
#endif
  return 1;
}

/* Writes x into out if it is an exact int in [0, p); returns 1 then, 0 if
 * the item needs the slow route.  Never leaves an exception set. */
static int encode_exact(PyObject *x, unsigned char *out, const unsigned char *p) {
  return read_u256(x, out) && less_le(out, p);
}

Py_ssize_t gosnark_encode_ints(PyObject *seq, unsigned char *dst, const unsigned char *p, PyObject *slow) {
  if (!PyList_Check(seq) && !PyTuple_Check(seq)) {
    PyErr_SetString(PyExc_TypeError, "gosnark_encode_ints takes a list or a tuple");
    return -1;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq), n_slow = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    if (PySequence_Fast_GET_SIZE(seq) != n) {
      PyErr_SetString(PyExc_RuntimeError, "the sequence changed size while it was encoded");
      return -1;
    }
    PyObject *x = PySequence_Fast_GET_ITEM(seq, i);
    unsigned char *out = dst + VALUE_BYTES * i;
    if (encode_exact(x, out, p)) continue;
    Py_INCREF(x);
    PyObject *b = PyObject_CallOneArg(slow, x);
    Py_DECREF(x);
    if (b == NULL) return -1;
    if (!PyBytes_Check(b) || PyBytes_GET_SIZE(b) != VALUE_BYTES) {
      Py_DECREF(b);
      PyErr_SetString(PyExc_ValueError, "the slow route must return 32 bytes");
      return -1;
    }
    memcpy(out, PyBytes_AS_STRING(b), VALUE_BYTES);
    Py_DECREF(b);
    ++n_slow;
  }
  return n_slow;
}

PyObject *gosnark_ints_to_bytes(PyObject *seq, const unsigned char *p, PyObject *slow) {
  if (!PyList_Check(seq) && !PyTuple_Check(seq)) {
    PyErr_SetString(PyExc_TypeError, "gosnark_ints_to_bytes takes a list or a tuple");
    return NULL;
  }
  PyObject *out = PyBytes_FromStringAndSize(NULL, VALUE_BYTES * PySequence_Fast_GET_SIZE(seq));
  if (out == NULL) return NULL;
  if (gosnark_encode_ints(seq, (unsigned char *)PyBytes_AS_STRING(out), p, slow) < 0) {
    Py_DECREF(out);
    return NULL;
  }
  return out;
}

/* ---- the host group law: G1 over Fq, G2 over Fq2, Montgomery limbs ---- */

typedef unsigned __int128 u128;

typedef struct {
  uint64_t l[4]; /* little-endian 64-bit limbs */
} fe;

typedef struct {
  fe c[2]; /* c[0] + c[1] u; G1 uses c[0] alone */
} el;

typedef struct {
  el x, y, z;
} pt;

typedef struct {
  fe q;
  uint64_t n0; /* -q^-1 mod 2^64 */
  fe r2;       /* R^2 mod q */
  fe one;      /* R mod q: 1 in Montgomery form */
  fe nr;       /* the non-residue, Montgomery form */
} curve_ctx;

static void fe_from_le(fe *r, const unsigned char *b) {
  for (int i = 0; i < 4; ++i) {
    uint64_t w = 0;
    for (int k = 7; k >= 0; --k) w = (w << 8) | b[8 * i + k];
    r->l[i] = w;
  }
}

static void fe_to_le(unsigned char *b, const fe *a) {
  for (int i = 0; i < 4; ++i)
    for (int k = 0; k < 8; ++k) b[8 * i + k] = (unsigned char)(a->l[i] >> (8 * k));
}

static int fe_is_zero(const fe *a) { return (a->l[0] | a->l[1] | a->l[2] | a->l[3]) == 0; }

static int fe_geq(const fe *a, const fe *b) {
  for (int i = 3; i >= 0; --i)
    if (a->l[i] != b->l[i]) return a->l[i] > b->l[i];
  return 1;
}

static uint64_t add4(fe *r, const fe *a, const fe *b) {
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (u128)a->l[i] + b->l[i];
    r->l[i] = (uint64_t)c;
    c >>= 64;
  }
  return (uint64_t)c;
}

static uint64_t sub4(fe *r, const fe *a, const fe *b) {
  uint64_t borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a->l[i] - b->l[i] - borrow;
    r->l[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
  return borrow;
}

static void fe_add(const curve_ctx *k, fe *r, const fe *a, const fe *b) {
  if (add4(r, a, b) || fe_geq(r, &k->q)) sub4(r, r, &k->q);
}

static void fe_sub(const curve_ctx *k, fe *r, const fe *a, const fe *b) {
  if (sub4(r, a, b)) add4(r, r, &k->q);
}

/* CIOS Montgomery product: a * b / R mod q, for a, b < q */
static void fe_mul(const curve_ctx *k, fe *r, const fe *a, const fe *b) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      c += (u128)a->l[j] * b->l[i] + t[j];
      t[j] = (uint64_t)c;
      c >>= 64;
    }
    c += t[4];
    t[4] = (uint64_t)c;
    t[5] = (uint64_t)(c >> 64);
    uint64_t m = t[0] * k->n0;
    c = ((u128)m * k->q.l[0] + t[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      c += (u128)m * k->q.l[j] + t[j];
      t[j - 1] = (uint64_t)c;
      c >>= 64;
    }
    c += t[4];
    t[3] = (uint64_t)c;
    t[4] = t[5] + (uint64_t)(c >> 64);
  }
  fe out = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || fe_geq(&out, &k->q)) sub4(&out, &out, &k->q);
  *r = out;
}

static int el_is_zero(int deg, const el *a) { return fe_is_zero(&a->c[0]) && (deg == 1 || fe_is_zero(&a->c[1])); }

static void el_add(const curve_ctx *k, int deg, el *r, const el *a, const el *b) {
  for (int i = 0; i < deg; ++i) fe_add(k, &r->c[i], &a->c[i], &b->c[i]);
}

static void el_sub(const curve_ctx *k, int deg, el *r, const el *a, const el *b) {
  for (int i = 0; i < deg; ++i) fe_sub(k, &r->c[i], &a->c[i], &b->c[i]);
}

static void el_mul(const curve_ctx *k, int deg, el *r, const el *a, const el *b) {
  if (deg == 1) {
    fe_mul(k, &r->c[0], &a->c[0], &b->c[0]);
    return;
  }
  fe v0, v1, s, t;
  fe_mul(k, &v0, &a->c[0], &b->c[0]);
  fe_mul(k, &v1, &a->c[1], &b->c[1]);
  fe_add(k, &s, &a->c[0], &a->c[1]);
  fe_add(k, &t, &b->c[0], &b->c[1]);
  fe_mul(k, &s, &s, &t);
  fe_sub(k, &s, &s, &v0);
  fe_sub(k, &r->c[1], &s, &v1);
  fe_mul(k, &v1, &v1, &k->nr);
  fe_add(k, &r->c[0], &v0, &v1);
}

static void el_sqr(const curve_ctx *k, int deg, el *r, const el *a) { el_mul(k, deg, r, a, a); }

static void el_dbl(const curve_ctx *k, int deg, el *r, const el *a) { el_add(k, deg, r, a, a); }

/* bn128/curve.py's double: dbl-2009-l; the identity (z = 0) as it is */
static void pt_double(const curve_ctx *k, int deg, pt *r, const pt *p) {
  if (el_is_zero(deg, &p->z)) {
    *r = *p;
    return;
  }
  el a, b, c, d, e, f, t, x3, y3, z3;
  el_sqr(k, deg, &a, &p->x);
  el_sqr(k, deg, &b, &p->y);
  el_sqr(k, deg, &c, &b);
  el_add(k, deg, &t, &p->x, &b);
  el_sqr(k, deg, &t, &t);
  el_sub(k, deg, &t, &t, &a);
  el_sub(k, deg, &t, &t, &c);
  el_dbl(k, deg, &d, &t);
  el_add(k, deg, &e, &a, &a);
  el_add(k, deg, &e, &e, &a);
  el_sqr(k, deg, &f, &e);
  el_dbl(k, deg, &t, &d);
  el_sub(k, deg, &x3, &f, &t);
  el_sub(k, deg, &t, &d, &x3);
  el_mul(k, deg, &y3, &e, &t);
  el_dbl(k, deg, &t, &c);
  el_dbl(k, deg, &t, &t);
  el_dbl(k, deg, &t, &t);
  el_sub(k, deg, &y3, &y3, &t);
  el_mul(k, deg, &z3, &p->y, &p->z);
  el_dbl(k, deg, &z3, &z3);
  r->x = x3;
  r->y = y3;
  r->z = z3;
}

static void pt_zero(const curve_ctx *k, int deg, pt *r) {
  memset(r, 0, sizeof *r);
  if (deg == 2) r->y.c[0] = k->one;
}

enum { ADD_NEW, ADD_P1, ADD_P2 };

/* bn128/curve.py's add: add-2007-bl, routed at h = 0 to double or to the
 * identity.  Returns ADD_P2 where the law returns p2 itself (p1 is the
 * identity), ADD_P1 where it returns p1 itself (p2 is), ADD_NEW where *r is
 * a new triple.  r may be p1. */
static int pt_add(const curve_ctx *k, int deg, pt *r, const pt *p1, const pt *p2) {
  if (el_is_zero(deg, &p1->z)) {
    *r = *p2;
    return ADD_P2;
  }
  if (el_is_zero(deg, &p2->z)) {
    *r = *p1;
    return ADD_P1;
  }
  el z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t, x3, y3, z3;
  el_sqr(k, deg, &z1z1, &p1->z);
  el_sqr(k, deg, &z2z2, &p2->z);
  el_mul(k, deg, &u1, &p1->x, &z2z2);
  el_mul(k, deg, &u2, &p2->x, &z1z1);
  el_mul(k, deg, &t, &p2->z, &z2z2);
  el_mul(k, deg, &s1, &p1->y, &t);
  el_mul(k, deg, &t, &p1->z, &z1z1);
  el_mul(k, deg, &s2, &p2->y, &t);
  el_sub(k, deg, &h, &u2, &u1);
  el_sub(k, deg, &t, &s2, &s1);
  if (el_is_zero(deg, &h)) {
    if (el_is_zero(deg, &t))
      pt_double(k, deg, r, p1);
    else
      pt_zero(k, deg, r);
    return ADD_NEW;
  }
  el_dbl(k, deg, &rr, &t);
  el_dbl(k, deg, &i, &h);
  el_sqr(k, deg, &i, &i);
  el_mul(k, deg, &j, &h, &i);
  el_mul(k, deg, &v, &u1, &i);
  el_sqr(k, deg, &x3, &rr);
  el_sub(k, deg, &x3, &x3, &j);
  el_dbl(k, deg, &t, &v);
  el_sub(k, deg, &x3, &x3, &t);
  el_sub(k, deg, &t, &v, &x3);
  el_mul(k, deg, &y3, &rr, &t);
  el_mul(k, deg, &t, &s1, &j);
  el_dbl(k, deg, &t, &t);
  el_sub(k, deg, &y3, &y3, &t);
  el_add(k, deg, &t, &p1->z, &p2->z);
  el_sqr(k, deg, &t, &t);
  el_sub(k, deg, &t, &t, &z1z1);
  el_sub(k, deg, &t, &t, &z2z2);
  el_mul(k, deg, &z3, &t, &h);
  r->x = x3;
  r->y = y3;
  r->z = z3;
  return ADD_NEW;
}

/* A chain's running value: acc, and the input object it still is (the law
 * passed that operand through unchanged), or NULL once it is a new triple. */
typedef struct {
  pt acc;
  PyObject *alias;
} chain;

static void chain_double(const curve_ctx *k, int deg, chain *s) {
  if (el_is_zero(deg, &s->acc.z)) return;
  pt_double(k, deg, &s->acc, &s->acc);
  s->alias = NULL;
}

static void chain_add(const curve_ctx *k, int deg, chain *s, const pt *p, PyObject *p_obj) {
  switch (pt_add(k, deg, &s->acc, &s->acc, p)) {
    case ADD_P2: s->alias = p_obj; break;
    case ADD_P1: break;
    default: s->alias = NULL;
  }
}

static int read_fe(const curve_ctx *k, PyObject *x, fe *r) {
  unsigned char b[VALUE_BYTES];
  if (!read_u256(x, b)) return 0;
  fe_from_le(r, b);
  if (fe_geq(r, &k->q)) return 0;
  fe_mul(k, r, r, &k->r2);
  return 1;
}

static int is_seq(PyObject *x, Py_ssize_t n) {
  return (PyTuple_Check(x) || PyList_Check(x)) && PySequence_Fast_GET_SIZE(x) == n;
}

static int read_el(const curve_ctx *k, int deg, PyObject *x, el *r) {
  if (deg == 1) return read_fe(k, x, &r->c[0]);
  return is_seq(x, 2) && read_fe(k, PySequence_Fast_GET_ITEM(x, 0), &r->c[0]) &&
         read_fe(k, PySequence_Fast_GET_ITEM(x, 1), &r->c[1]);
}

static int read_pt(const curve_ctx *k, int deg, PyObject *p, pt *r) {
  return is_seq(p, 3) && read_el(k, deg, PySequence_Fast_GET_ITEM(p, 0), &r->x) &&
         read_el(k, deg, PySequence_Fast_GET_ITEM(p, 1), &r->y) &&
         read_el(k, deg, PySequence_Fast_GET_ITEM(p, 2), &r->z);
}

static PyObject *fe_to_int(const curve_ctx *k, const fe *a) {
  static const fe one = {{1, 0, 0, 0}};
  fe c;
  unsigned char b[VALUE_BYTES];
  fe_mul(k, &c, a, &one);
  fe_to_le(b, &c);
#if PY_VERSION_HEX >= 0x030D0000
  return PyLong_FromUnsignedNativeBytes(b, VALUE_BYTES, Py_ASNATIVEBYTES_LITTLE_ENDIAN);
#else
  return _PyLong_FromByteArray(b, VALUE_BYTES, 1, 0);
#endif
}

static PyObject *el_to_obj(const curve_ctx *k, int deg, const el *a) {
  if (deg == 1) return fe_to_int(k, &a->c[0]);
  PyObject *c0 = fe_to_int(k, &a->c[0]);
  PyObject *c1 = c0 ? fe_to_int(k, &a->c[1]) : NULL;
  PyObject *out = c1 ? PyTuple_Pack(2, c0, c1) : NULL;
  Py_XDECREF(c0);
  Py_XDECREF(c1);
  return out;
}

static PyObject *chain_result(const curve_ctx *k, int deg, const chain *s) {
  if (s->alias) return Py_NewRef(s->alias);
  PyObject *x = el_to_obj(k, deg, &s->acc.x);
  PyObject *y = x ? el_to_obj(k, deg, &s->acc.y) : NULL;
  PyObject *z = y ? el_to_obj(k, deg, &s->acc.z) : NULL;
  PyObject *out = z ? PyTuple_Pack(3, x, y, z) : NULL;
  Py_XDECREF(x);
  Py_XDECREF(y);
  Py_XDECREF(z);
  return out;
}

void *gosnark_curve_new(const unsigned char *q, const unsigned char *nr) {
  curve_ctx *k = calloc(1, sizeof *k);
  if (k == NULL) return NULL;
  fe_from_le(&k->q, q);
  if (!(k->q.l[0] & 1) || (k->q.l[1] == 0 && k->q.l[2] == 0 && k->q.l[3] == 0 && k->q.l[0] < 3)) {
    free(k);
    return NULL;
  }
  uint64_t inv = k->q.l[0]; /* Newton: correct to 3 bits, then 6, 12, ... 96 */
  for (int i = 0; i < 5; ++i) inv *= 2 - k->q.l[0] * inv;
  k->n0 = (uint64_t)0 - inv;
  fe x = {{1, 0, 0, 0}}; /* 2^256 mod q, then 2^512 mod q, by doubling */
  for (int i = 0; i < 512; ++i) {
    fe_add(k, &x, &x, &x);
    if (i == 255) k->one = x;
  }
  k->r2 = x;
  fe_from_le(&k->nr, nr);
  fe_mul(k, &k->nr, &k->nr, &k->r2);
  return k;
}

PyObject *gosnark_mul_scalar(const curve_ctx *k, int deg, PyObject *p, PyObject *e) {
  unsigned char eb[VALUE_BYTES];
  pt base;
  if (!read_u256(e, eb) || !read_pt(k, deg, p, &base)) Py_RETURN_NONE;
  int top = 8 * VALUE_BYTES - 1;
  while (top >= 0 && !((eb[top / 8] >> (top % 8)) & 1)) --top;
  chain s = {.alias = NULL};
  pt_zero(k, deg, &s.acc);
  for (int i = top; i >= 0; --i) {
    chain_double(k, deg, &s);
    if ((eb[i / 8] >> (i % 8)) & 1) chain_add(k, deg, &s, &base, p);
  }
  return chain_result(k, deg, &s);
}

PyObject *gosnark_combine_windows(const curve_ctx *k, int deg, PyObject *windows, Py_ssize_t c) {
  if (!PyList_Check(windows) && !PyTuple_Check(windows)) Py_RETURN_NONE;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(windows);
  pt *w = PyMem_Malloc((n ? n : 1) * sizeof *w);
  if (w == NULL) return PyErr_NoMemory();
  for (Py_ssize_t i = 0; i < n; ++i) {
    if (!read_pt(k, deg, PySequence_Fast_GET_ITEM(windows, i), &w[i])) {
      PyMem_Free(w);
      Py_RETURN_NONE;
    }
  }
  chain s = {.alias = NULL};
  pt_zero(k, deg, &s.acc);
  for (Py_ssize_t i = n - 1; i >= 0; --i) {
    for (Py_ssize_t d = 0; d < c; ++d) chain_double(k, deg, &s);
    chain_add(k, deg, &s, &w[i], PySequence_Fast_GET_ITEM(windows, i));
  }
  PyMem_Free(w);
  return chain_result(k, deg, &s);
}
