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
 * Build (any C compiler, the include directory of the interpreter that
 * loads it: sysconfig.get_paths()["include"]):
 *     cc -O2 -shared -fPIC -I<include> -o libgosnark_pyints.so gosnark_pyints.c
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

#define VALUE_BYTES 32

/* a < b for 32-byte little-endian values */
static int less_le(const unsigned char *a, const unsigned char *b) {
  for (int i = VALUE_BYTES - 1; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] < b[i];
  }
  return 0;
}

/* Writes x into out if it is an exact int in [0, p); returns 1 then, 0 if
 * the item needs the slow route.  Never leaves an exception set. */
static int encode_exact(PyObject *x, unsigned char *out, const unsigned char *p) {
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
  return less_le(out, p);
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
