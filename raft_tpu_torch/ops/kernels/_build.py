"""Build and load the hand-written CUDA kernels (route: nvcc by hand into
a shared library with a plain C interface, loaded with ctypes).

The library is compiled at first use from the sources in
``raft_tpu_torch/csrc`` into ``build/raft_tpu_torch/<hash>/`` at the repo
root (listed in .gitignore), keyed by a hash of the sources and the
compiler flags, for ``sm_90a`` (Hopper).  Each translation unit (one per
kernel and width) is compiled by its own ``nvcc``, all started together,
then linked into one library.  ``-Xptxas -v`` output (registers and spills
per kernel) is kept beside the library in ``ptxas.log``.

Nothing here is imported or run at module import time of the package:
the build happens inside the first kernel launch.  Each nvcc build and
each load of the library is counted (``obs.metrics.record_kernel_build``:
``raft_kernel_build_events_total{event}``; ``raft_jit_cache_hits`` /
``_misses`` when sampled).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from raft_tpu_torch import errors

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
#: translation units, one per kernel and width (see csrc/gj_kernels.cuh
#: and csrc/qtf_pair.cuh)
UNITS = ("gj_k1_f64.cu", "gj_k1_f32.cu", "gj_k2_f64.cu", "gj_k2_f32.cu",
         "gj_k3_mixed_f32.cu", "gj_k3_mixed_bf16.cu", "gj_k4_mixed_f32.cu",
         "gj_k4_mixed_bf16.cu", "qtf_k5_f64.cu")
SOURCES = UNITS + ("gj_kernels.cuh", "gj_group.cuh", "gj_lane.cuh",
                   "qtf_pair.cuh")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "raft_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
#: facts of the build that produced the loaded library
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise errors.KernelFailure("nvcc not found: the CUDA kernels cannot be "
                               "built", kernel="gj_solve")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels (if not built for these sources yet) and return
    the path of the shared library."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, "libraft_gj.so")
    if os.path.isfile(lib_path):
        BUILD_INFO.update(path=lib_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f".tmp{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for unit in UNITS:
        obj = os.path.join(out_dir, unit.replace(".cu", f"{tag}.o"))
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, unit)]
        procs.append((unit, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for unit, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {unit}\n{out}")
        if proc.returncode != 0:
            failed.append((unit, proc.returncode, out))
    objs = [obj for _, obj, _ in procs]
    link = None
    if not failed:
        tmp = lib_path + tag
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                               tmp, *objs],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write("\n".join(logs))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        unit, rc, out = failed[0]
        raise errors.KernelFailure(
            f"nvcc failed to build {unit}:\n" + out[-4000:],
            kernel="gj_solve", returncode=rc, failed=len(failed))
    if link.returncode != 0:
        raise errors.KernelFailure(
            "nvcc failed to link the gj kernels:\n"
            + (link.stderr or link.stdout)[-4000:],
            kernel="gj_solve", returncode=link.returncode)
    os.replace(lib_path + tag, lib_path)
    BUILD_INFO.update(path=lib_path, seconds=seconds, cached=False,
                      units=len(UNITS))
    _record("compile", seconds)
    return lib_path


def _record(event: str, seconds: float):
    """One build-cache event in the metrics registry (never raises)."""
    try:
        from raft_tpu_torch.obs import metrics
        metrics.record_kernel_build(event, seconds)
    except Exception:                                 # pragma: no cover
        pass


def ptxas_log() -> str:
    """The ``-Xptxas -v`` report of the loaded build ('' before a build)."""
    path = BUILD_INFO.get("path")
    if not path:
        return ""
    log = os.path.join(os.path.dirname(path), "ptxas.log")
    if not os.path.isfile(log):
        return ""
    with open(log) as f:
        return f.read()


def ptxas_report() -> dict:
    """``{kernel symbol: [ptxas lines]}`` parsed from the ``-Xptxas -v``
    log of the loaded build (registers, stack frame, spill stores/loads
    per instantiation)."""
    out, cur = {}, None
    for line in ptxas_log().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, [])
            continue
        if cur is not None and line.strip() and not line.startswith("=="):
            out[cur].append(line.strip().removeprefix("ptxas info    : "))
    return out


def load():
    """The loaded kernel library (built on first call), with ``argtypes``
    set on every entry point."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        t0 = time.perf_counter()
        path = build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise errors.KernelFailure(f"cannot load {path}: {e}",
                                       kernel="gj_solve") from e
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for width in ("f64", "f32"):
            fn = getattr(lib, f"raft_impedance_gj_{width}")
            fn.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
            fn.restype = I
            fn = getattr(lib, f"raft_gj_solve_{width}")
            fn.argtypes = [P, P, P, I, I, I, I, P]
            fn.restype = I
        for width in ("f32", "bf16"):
            fn = getattr(lib, f"raft_impedance_gj_mixed_{width}")
            fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, D, P]
            fn.restype = I
            fn = getattr(lib, f"raft_gj_solve_mixed_{width}")
            fn.argtypes = [P, P, P, P, P, I, I, I, I, D, P]
            fn.restype = I
        L = ctypes.c_longlong
        lib.raft_qtf_k5_scratch.argtypes = [I, I, I]
        lib.raft_qtf_k5_scratch.restype = L
        lib.raft_qtf_k5_f64.argtypes = [P] * 24 + [L, P, I, I, I, I, I, D, D,
                                                   D, D, P]
        lib.raft_qtf_k5_f64.restype = I
        lib.raft_gj_error_string.argtypes = [I]
        lib.raft_gj_error_string.restype = ctypes.c_char_p
        _LIB = lib
        _record("load", time.perf_counter() - t0)
        return lib


def check(rc: int, kernel: str, **ctx):
    """Raise KernelFailure for a non-zero cudaError_t from a launch."""
    if rc != 0:
        msg = _LIB.raft_gj_error_string(rc).decode() if _LIB else str(rc)
        raise errors.KernelFailure(f"{kernel} launch failed: {msg}",
                                   kernel=kernel, cuda_error=int(rc), **ctx)
