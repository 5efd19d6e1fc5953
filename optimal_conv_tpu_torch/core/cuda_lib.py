"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and are compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` a source, all started together, then
linked into one shared library, loaded with ``ctypes``.
The build runs at first use, never at import, into
``optimal_conv_tpu_torch/build/`` (listed in ``.gitignore``), keyed by a
hash of the sources and flags so an edited kernel is rebuilt.  Each C
entry point returns ``cudaGetLastError()``; ``check`` raises on any
nonzero code.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

from ..utils import tracing

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib: ctypes.CDLL | None = None


class KernelStats:
    """Per-kernel counters: launches of the CUDA kernel by its wrapper
    (in all, and by the number of rows of the call), and calls of its
    plain PyTorch version (any device).  They report into
    ``utils/tracing.counters()``."""

    def __init__(self, name: str):
        self.name = name
        self.reset()
        tracing.register(self)

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.by_rows: collections.Counter = collections.Counter()

    def launched(self, rows: int, t0: int = 0) -> None:
        """Called by the wrapper right after it launched its kernel; `t0`
        is ``tracing.stamp()`` taken at the wrapper's entry (0 when not
        recording), and the call is tallied in the open span."""
        self.launches += 1
        self.by_rows[rows] += 1
        if t0:
            tracing.kernel_call(self.name, rows, t0)

    def credit(self, launches: int, by_rows) -> None:
        """Count launches the wrapper did not make: a CUDA graph's replay
        of those it captured (``ckks/graphs.py``).  No span tallies them:
        no wrapper ran."""
        self.launches += launches
        self.by_rows.update(by_rows)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def lib() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD / f"liboptconv_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objs = [tmp.with_name(f"{s.stem}.{os.getpid()}.o") for s in srcs]
        jobs = [[_nvcc(), *compile_flags, "-c", "-o", str(o), str(s)]
                for s, o in zip(srcs, objs)]
        try:
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in jobs]
            # every compile is waited for before a failure is raised
            outs = [proc.communicate()[0] for proc in procs]
            for cmd, proc, out in zip(jobs, procs, outs):
                _check_build(cmd, proc.returncode, out)
            link = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
            res = subprocess.run(link, capture_output=True, text=True)
            _check_build(link, res.returncode, res.stdout + res.stderr)
            os.replace(tmp, so)
        finally:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
    _lib = _bind(ctypes.CDLL(str(so)))
    return _lib


def _check_build(cmd, code: int, output: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{output}")


def _bind(dll: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # out, a, b, q, qinv, c, the launch description, stream
    dll.optconv_mont_mul.argtypes = [p] * 8
    dll.optconv_mont_mul.restype = i32
    # in, out, row_limb, q, qinv, tw, ninv; rows, l, batch and limb stride;
    # log_n, inverse, n_pass; two passes of six plan integers; stream
    dll.optconv_ntt.argtypes = [p] * 7 + [i64] * 4 + [i32] * 15 + [p]
    dll.optconv_ntt.restype = i32
    # mine, theirs, out, row_limb, q, qinv, w; rows, log_n, upper, inverse;
    # stream
    dll.optconv_ntt_cross.argtypes = [p] * 7 + [i64, i32, i32, i32, p]
    dll.optconv_ntt_cross.restype = i32
    # out, q, qinv, r2, r1, perm and row ids (or null); the seed's low
    # word; beta, |qp| drawn, |qp| of the whole key, n, threads, rows a
    # block; stream
    dll.optconv_d1_regen.argtypes = [p] * 7 + [ctypes.c_uint, i32, i32, i32,
                                               i64, i32, i32, p]
    dll.optconv_d1_regen.restype = i32
    # in, mid, out, row_limb, q, qinv, r1, c40, c80, nbytes, the two plane
    # tables, tw; rows, l, batch and limb stride; log_n, inverse, planes;
    # stream
    dll.optconv_mxu_ntt.argtypes = [p] * 13 + [i64] * 4 + [i32] * 3 + [p]
    dll.optconv_mxu_ntt.restype = i32
    # out, in, the constant table, the launch description, stream
    dll.optconv_rns_extend.argtypes = [p] * 5
    dll.optconv_rns_extend.restype = i32
    # out, a, b, q, c, the launch description, stream
    dll.optconv_mod_add.argtypes = [p] * 7
    dll.optconv_mod_add.restype = i32
    return dll


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
