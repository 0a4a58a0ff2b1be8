"""ctypes bridge to the C++ host runtime (``native/gosnark_native.cpp``).

Mirrors ``go_snark_study_tpu/native.py``, trimmed to the two entry points the
port calls: :meth:`NativeField.sparse_matvec` (A·w mod p, the fast prover's
row evaluations) and :meth:`NativeField.witness_eval` (field-mode witness
computation).  The JAX package's ``pack_ints``/``unpack_ints`` make its
(32, N) limb layout and are not carried over.

The library is the repository's top-level ``native/libgosnark_native.so``.
When it is absent, the first use runs ``make -C native`` (g++); if that
cannot make it, :func:`available` is False and callers take their Python
paths, which give the same values.  This is host code: nothing here touches
the device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import List, Sequence

import numpy as np

__all__ = ["available", "NativeField", "LIB_PATH"]

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libgosnark_native.so")

_lib = None
_tried_build = False


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
    lib.gosnark_sparse_matvec.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_char_p,
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


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ints_from_bytes(raw: bytes, n: int) -> List[int]:
    return [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(n)]


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
        return b"".join((x % self.p).to_bytes(32, "little") for x in xs)

    def sparse_matvec(self, indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray, witness) -> List[int]:
        """CSR rows (int64 ``indptr``, ``cols``, signed ``vals``) times the
        witness, mod p: one value per row.  ``witness``: ints, or their
        :meth:`ints_to_bytes` encoding when several products share it."""
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        cols = np.ascontiguousarray(cols, dtype=np.int64)
        vals = np.ascontiguousarray(vals, dtype=np.int64)
        n_rows = len(indptr) - 1
        out = ctypes.create_string_buffer(32 * n_rows)
        self.lib.gosnark_sparse_matvec(
            self._ctx, _i64ptr(indptr), _i64ptr(cols), _i64ptr(vals),
            witness if isinstance(witness, bytes) else self.ints_to_bytes(witness), n_rows, out,
        )
        return _ints_from_bytes(out.raw, n_rows)

    def witness_eval(self, ops: np.ndarray, seeded_witness: Sequence[int]) -> List[int]:
        """ops: (n_ops, 7) int64 in the encoding documented in the C++
        source; seeded_witness: initial signal values (one/public/private
        filled, intermediates zero)."""
        ops = np.ascontiguousarray(ops, dtype=np.int64)
        n = len(seeded_witness)
        buf = ctypes.create_string_buffer(self.ints_to_bytes(seeded_witness), 32 * n)
        if self.lib.gosnark_witness_eval(self._ctx, _i64ptr(ops), ops.shape[0], buf) != 0:
            raise ZeroDivisionError("witness evaluation: division by zero")
        return _ints_from_bytes(buf.raw, n)
