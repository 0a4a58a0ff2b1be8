"""ctypes bridge to the C++ host runtime (``native/gosnark_native.cpp``).

Mirrors ``go_snark_study_tpu/native.py``:

  * :meth:`NativeField.pack_ints` / :meth:`NativeField.unpack_ints` — python
    ints <-> (8, N) int32 limb arrays in the port's layout (Montgomery by
    default), the JAX package's host bridge; the library works in the JAX
    (32, N) 8-bit layout and the arrays are relaid here;
  * :meth:`NativeField.sparse_matvec_into` — A·w mod p as the library's
    canonical 32-byte values, written into a host buffer: the host
    products of ``SparseR1CS._products_into``, which the prover's SpMV on
    the card is held to;
  * :meth:`NativeField.witness_eval` — field-mode witness computation.

:func:`mul_scalar` and :func:`combine_windows` run the host group law's two
long chains, ``bn128.curve``'s double-and-add and the MSM's window
combination, in the same library over 4x64-bit Montgomery limbs, G1 and G2:
the same Jacobian triples as the Python law, which runs wherever they return
None.  :data:`CHAINS` counts the chains each route ran.

:func:`ints_to_bytes`, :func:`ints_into` and :func:`ints_from_bytes` are the
byte encoding every crossing shares: 32 little-endian bytes a value, reduced
mod p.  The encoder reads the int objects themselves in C
(``native/gosnark_pyints.c``, a library of its own built against this
interpreter's headers and called through ``ctypes.PyDLL``, holding the GIL):
an exact int in [0, p) is written as it is, and any other value (>= p,
negative, a bool, a numpy integer) takes the Python route ``(x % p)``, item
by item.  :data:`ENCODED` counts the values each route wrote.

The C++ library is the repository's top-level ``native/libgosnark_native.so``.
When it is absent, the first use runs ``make -C native`` (g++); if that
cannot make it, :func:`available` is False and callers take their Python
paths, which give the same values.  The encoder's library is built on first
use with the C compiler beside it (``build/native/``); without it every value
takes the Python route, with the same bytes.  This is host code: nothing
here touches the device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sysconfig
from typing import List, Sequence

import numpy as np

from .fields import Fq, Fq2

__all__ = ["available", "NativeField", "LIB_PATH", "ENCODED", "CHAINS", "ints_to_bytes", "ints_into",
           "ints_from_bytes", "mul_scalar", "combine_windows"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_ROOT, "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libgosnark_native.so")
PYINTS_SRC = os.path.join(NATIVE_DIR, "gosnark_pyints.c")
# named by the interpreter's ABI: the library holds its object layout
PYINTS_LIB = os.path.join(_ROOT, "build", "native",
                          "libgosnark_pyints" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))

# values each route of the encoder wrote in this process
ENCODED = {"native": 0, "python": 0}
# point chains (scalar multiplications and window combinations) each route ran
CHAINS = {"native": 0, "python": 0}

_lib = None
_tried_build = False
_pyints = None
_curves = {}  # (q, non-residue) -> the library's curve context


def _try_build() -> None:
    """One ``make -C native`` if make is installed.  It writes a file of
    its own and renames it into place, so that a process loading the
    library never sees it half written."""
    global _tried_build
    if _tried_build or shutil.which("make") is None:
        return
    _tried_build = True
    tmp = f"libgosnark_native.{os.getpid()}.so"
    subprocess.run(["make", "-C", NATIVE_DIR, f"TARGET={tmp}"], capture_output=True, timeout=300, check=False)
    tmp_path = os.path.join(NATIVE_DIR, tmp)
    if os.path.exists(tmp_path):
        os.replace(tmp_path, LIB_PATH)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(LIB_PATH):
        _try_build()
    if not os.path.exists(LIB_PATH):
        return None
    lib = ctypes.CDLL(LIB_PATH)
    lib.gosnark_ctx_new.restype = ctypes.c_void_p
    lib.gosnark_ctx_new.argtypes = [ctypes.c_char_p]
    lib.gosnark_ctx_free.argtypes = [ctypes.c_void_p]
    lib.gosnark_pack.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.gosnark_unpack.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.gosnark_sparse_matvec.argtypes = [  # w and out: addresses of host buffers
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.gosnark_witness_eval.restype = ctypes.c_int
    lib.gosnark_witness_eval.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_char_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _build_pyints() -> None:
    """Compiles the encoder's library when it is missing or older than its
    source, into a file of its own renamed into place."""
    if os.path.exists(PYINTS_LIB) and os.path.getmtime(PYINTS_LIB) >= os.path.getmtime(PYINTS_SRC):
        return
    cc = shutil.which("cc") or shutil.which("gcc")
    include = sysconfig.get_paths()["include"]
    if cc is None or not os.path.exists(os.path.join(include, "Python.h")):
        return
    os.makedirs(os.path.dirname(PYINTS_LIB), exist_ok=True)
    tmp = f"{PYINTS_LIB}.{os.getpid()}.tmp"
    subprocess.run([cc, "-O3", "-shared", "-fPIC", f"-I{include}", "-o", tmp, PYINTS_SRC],
                   capture_output=True, timeout=120, check=False)
    if os.path.exists(tmp):
        os.replace(tmp, PYINTS_LIB)


def _load_pyints():
    """The encoder's library (built on first use), or False where it cannot
    be built or loaded: the Python route then encodes every value."""
    global _pyints
    if _pyints is None:
        _pyints = False
        try:
            _build_pyints()
            lib = ctypes.PyDLL(PYINTS_LIB)
        except (OSError, subprocess.SubprocessError):
            return _pyints
        lib.gosnark_encode_ints.restype = ctypes.c_ssize_t
        lib.gosnark_encode_ints.argtypes = [ctypes.py_object, ctypes.c_void_p, ctypes.c_char_p, ctypes.py_object]
        lib.gosnark_ints_to_bytes.restype = ctypes.py_object
        lib.gosnark_ints_to_bytes.argtypes = [ctypes.py_object, ctypes.c_char_p, ctypes.py_object]
        lib.gosnark_curve_new.restype = ctypes.c_void_p
        lib.gosnark_curve_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.gosnark_mul_scalar.restype = ctypes.py_object
        lib.gosnark_mul_scalar.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.py_object, ctypes.py_object]
        lib.gosnark_combine_windows.restype = ctypes.py_object
        lib.gosnark_combine_windows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.py_object, ctypes.c_ssize_t]
        _pyints = lib
    return _pyints


def _curve(F):
    """(library, context, degree) for the group law over F: Fq is G1's
    field (degree 1), Fq2 G2's (degree 2); None where the C takes no such
    field (another field, a modulus it refuses) or the library is missing."""
    lib = _load_pyints()
    if not lib:
        return None
    if isinstance(F, Fq2):
        deg, q, nr = 2, F.F.q, F.non_residue
    elif isinstance(F, Fq):
        deg, q, nr = 1, F.q, 0
    else:
        return None
    key = (q, nr)
    ctx = _curves.get(key)
    if ctx is None:
        ctx = _curves[key] = (lib.gosnark_curve_new(q.to_bytes(32, "little"), (nr % q).to_bytes(32, "little"))
                              if q < 2**256 else None) or 0
    return (lib, ctx, deg) if ctx else None


def _counted(out):
    CHAINS["python" if out is None else "native"] += 1
    return out


def mul_scalar(F, p, e):
    """e·p over F's curve by ``bn128.curve``'s MSB-first double-and-add,
    in C: the triple the Python law gives.  None, for the Python law to run,
    where there is no library or curve context, a coordinate is not an exact
    int in [0, q) or e not one in [0, 2^256)."""
    curve = _curve(F)
    if curve is None:
        return _counted(None)
    lib, ctx, deg = curve
    return _counted(lib.gosnark_mul_scalar(ctx, deg, p, e))


def combine_windows(F, window_pts, c):
    """Σ_w 2^(c·w)·window_pts[w] over F's curve, MSB window first, as
    ``ops.msm.combine_window_sums``'s loop computes it, in C; None, for that
    loop to run, where :func:`mul_scalar` would give None, ``window_pts`` is
    not a list or a tuple, or c not an int in [0, 2^31)."""
    curve = _curve(F)
    if curve is None or type(c) is not int or not 0 <= c < 2**31:
        return _counted(None)
    lib, ctx, deg = curve
    return _counted(lib.gosnark_combine_windows(ctx, deg, window_pts, c))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _python_route(p: int):
    """The encoding of one value that is not an exact int in [0, p), counted."""

    def encode(x) -> bytes:
        out = (x % p).to_bytes(32, "little")
        ENCODED["python"] += 1
        return out

    return encode


def _as_seq(xs) -> Sequence:
    return xs if isinstance(xs, (list, tuple)) else list(xs)


def ints_to_bytes(xs: Sequence[int], p: int) -> bytes:
    """Each x mod p as 32 little-endian bytes: canonical values (< p).  The
    C encoder where its library loads, else the Python route: the same
    bytes either way."""
    xs = _as_seq(xs)
    lib = _load_pyints()
    if lib:
        python0 = ENCODED["python"]
        out = lib.gosnark_ints_to_bytes(xs, p.to_bytes(32, "little"), _python_route(p))
        ENCODED["native"] += len(xs) - (ENCODED["python"] - python0)
        return out
    return b"".join(map(_python_route(p), xs))


def ints_into(xs: Sequence[int], p: int, out: np.ndarray) -> None:
    """:func:`ints_to_bytes` written into ``out``, a writable C-contiguous
    uint8 array of 32 bytes a value (a pinned staging tensor's
    ``numpy()`` view, say), with no bytes object in between."""
    xs = _as_seq(xs)
    if out.dtype != np.uint8 or out.size != 32 * len(xs) or not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError(f"expected {32 * len(xs)} writable contiguous uint8 bytes for {len(xs)} values")
    lib = _load_pyints()
    if lib:
        n_slow = lib.gosnark_encode_ints(xs, out.ctypes.data, p.to_bytes(32, "little"), _python_route(p))
        ENCODED["native"] += len(xs) - n_slow
    elif xs:
        out[:] = np.frombuffer(b"".join(map(_python_route(p), xs)), dtype=np.uint8)


def ints_from_bytes(raw: bytes) -> List[int]:
    """The inverse of :func:`ints_to_bytes`: one int per 32 bytes."""
    return [int.from_bytes(raw[i : i + 32], "little") for i in range(0, len(raw), 32)]


def _bytes_to_words(a8: np.ndarray) -> np.ndarray:
    """(32, N) int32 8-bit limbs (the library's layout) -> (8, N) int32
    32-bit limbs (the port's)."""
    n = a8.shape[1]
    b = np.ascontiguousarray(a8.astype(np.uint8).reshape(8, 4, n).transpose(0, 2, 1))
    return b.view("<u4").reshape(8, n).view(np.int32)


def _words_to_bytes(a32: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_bytes_to_words`."""
    n = a32.shape[1]
    b = np.ascontiguousarray(a32, dtype=np.int32).view("<u4").reshape(8, n, 1).view(np.uint8)  # (8, N, 4)
    return np.ascontiguousarray(b.transpose(0, 2, 1)).reshape(32, n).astype(np.int32)


class NativeField:
    """One C context per modulus."""

    def __init__(self, p: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library not built: run `make -C native`")
        self.lib = lib
        self.p = p
        self._ctx = lib.gosnark_ctx_new(int(p).to_bytes(32, "little"))

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self.lib.gosnark_ctx_free(ctx)

    def ints_to_bytes(self, xs: Sequence[int]) -> bytes:
        return ints_to_bytes(xs, self.p)

    def pack_ints(self, xs: Sequence[int], mont: bool = True) -> np.ndarray:
        """python ints -> (8, N) int32 limb array, the port's layout
        (Montgomery by default): the library's ``gosnark_pack``, whose
        (32, N) 8-bit limbs are relaid into 32-bit limbs."""
        n = len(xs)
        out = np.empty((32, n), dtype=np.int32)
        self.lib.gosnark_pack(self._ctx, self.ints_to_bytes(xs), _i32ptr(out), n, 1 if mont else 0)
        return _bytes_to_words(out)

    def unpack_ints(self, arr: np.ndarray, mont: bool = True) -> List[int]:
        """(8, N) int32 limb array (canonical values) -> python ints, out of
        the Montgomery domain by default: the inverse of :meth:`pack_ints`."""
        a8 = _words_to_bytes(np.asarray(arr))
        n = a8.shape[1]
        buf = ctypes.create_string_buffer(32 * n)
        self.lib.gosnark_unpack(self._ctx, _i32ptr(a8), buf, n, 1 if mont else 0)
        return ints_from_bytes(buf.raw)

    def sparse_matvec_into(self, indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray, witness: np.ndarray,
                           out: np.ndarray) -> None:
        """CSR rows (int64 ``indptr``, ``cols``, signed ``vals``) times the
        witness, mod p, written by the library into ``out``: 32 little-endian
        bytes a row, each value canonical (< p).  ``witness`` and ``out``:
        C-contiguous uint8 arrays, the witness as :func:`ints_into` writes
        it (32 bytes a signal)."""
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        cols = np.ascontiguousarray(cols, dtype=np.int64)
        vals = np.ascontiguousarray(vals, dtype=np.int64)
        n_rows = len(indptr) - 1
        for a, size in ((witness, None), (out, 32 * n_rows)):
            if a.dtype != np.uint8 or not a.flags.c_contiguous or (size is not None and a.size != size):
                raise ValueError("sparse_matvec_into takes contiguous uint8 buffers, 32 bytes a value")
        if not out.flags.writeable:
            raise ValueError("sparse_matvec_into: the output buffer is read-only")
        if len(cols) and (cols.min() < 0 or 32 * int(cols.max()) >= witness.size):
            raise ValueError("sparse_matvec_into: a column lies outside the witness")
        self.lib.gosnark_sparse_matvec(self._ctx, _i64ptr(indptr), _i64ptr(cols), _i64ptr(vals),
                                       witness.ctypes.data, n_rows, out.ctypes.data)

    def witness_eval(self, ops: np.ndarray, seeded_witness: Sequence[int]) -> List[int]:
        """ops: (n_ops, 7) int64 in the encoding documented in the C++
        source; seeded_witness: initial signal values (one/public/private
        filled, intermediates zero)."""
        ops = np.ascontiguousarray(ops, dtype=np.int64)
        n = len(seeded_witness)
        buf = ctypes.create_string_buffer(self.ints_to_bytes(seeded_witness), 32 * n)
        if self.lib.gosnark_witness_eval(self._ctx, _i64ptr(ops), ops.shape[0], buf) != 0:
            raise ZeroDivisionError("witness evaluation: division by zero")
        return ints_from_bytes(buf.raw)
