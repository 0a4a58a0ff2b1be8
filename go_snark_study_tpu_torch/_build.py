"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

into a shared library with a plain C interface, loaded with ``ctypes``:
pointers and the stream go in as ``c_void_p``, counts as ``c_longlong``,
selectors as ``c_int``.  Every entry point returns ``cudaGetLastError()``
after its launch, and :class:`Kernel` raises on anything but 0.  The file
name carries a hash of the sources and flags, so an edited kernel is never
served from a stale library.  There is no fallback: without ``nvcc``, or
when a build fails, this raises.

All sources build in parallel (one ``nvcc`` each, started together) the
first time any kernel is needed; :func:`build_all` reports the seconds and
the ``ptxas`` register and spill lines of each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["Kernel", "build_all", "SOURCES", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("mont_mul", "point_add", "msm_apply", "msm_seg_scan", "msm_reduce", "small_ntt", "butterfly",
           "r1cs_spmv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source that has no up-to-date library yet, all at
    once; load them all.  Returns {name: {"seconds", "ptxas", "cached"}}."""
    with _LOCK:
        todo = [n for n in SOURCES if n not in _LIBS]
        if not todo:
            return BUILD_LOG
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            out = _target(name)
            if out.exists():
                BUILD_LOG[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                time.perf_counter(),
                tmp,
                out,
            )
        failed = []
        done = {}
        while len(done) < len(procs):  # note each build's own finish time
            for name, (proc, t0, _, _) in procs.items():
                if name not in done and proc.poll() is not None:
                    done[name] = time.perf_counter() - t0
            time.sleep(0.05)
        for name, (proc, t0, tmp, out) in procs.items():
            log, _ = proc.communicate()
            secs = done[name]
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc rc={proc.returncode})\n{log}")
                continue
            os.replace(tmp, out)
            BUILD_LOG[name] = {"seconds": secs, "ptxas": log, "cached": False}
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return BUILD_LOG


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name]
    return lib


class Kernel:
    """The Python side of one hand-written kernel: its C entry point, its
    launch count, and where it came from.

    ``launches`` goes up by one each time the kernel is launched, and
    nowhere else; a caller may reset it to 0."""

    def __init__(self, name: str, source: str, symbol: str, argtypes, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    @property
    def source_path(self) -> str:
        return f"go_snark_study_tpu_torch/csrc/{self.source}.cu"

    def _bind(self):
        if self._fn is None:
            lib = _lib(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.gs_errstr
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._bind()(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: launch failed: {self._err(rc).decode()} ({rc})"
            )
        self.launches += 1


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
