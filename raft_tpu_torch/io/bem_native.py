"""The native BEM core (``native/bem/bem.cpp``) through ctypes: first-order
radiation and diffraction of potential-flow members on the host.

Port of ``raft_tpu/io/bem_native.py`` (the in-process equivalent of the
reference's pyHAMS path, raft_fowt.py:596-650): the panel mesh goes to
the C++ solver and the coefficients come back as arrays, which
`solve_bem_fowt` packs into the same `BEMData` the WAMIT readers build.

The BEM solve is host C++ here as in the JAX package: a dense panel
method with one complex LU per frequency, not a kernel of the card.
The library is built at first use with g++ (``-O3 -fopenmp``) from
``native/bem/bem.cpp``, unedited, and ``raft_tpu_torch/csrc/
bem_lapack.cpp``, into ``build/raft_tpu_torch/bem-<hash>/`` at the repo
root (gitignored), keyed by a hash of both sources and the flags.  The
core's one LAPACK routine, ``zgesv``, is scipy's
(``scipy.linalg.cython_lapack``), handed to the library once at load
time: nothing depends on a system LAPACK.  The objects are compiled with
``-fopenmp`` and linked against the OpenMP runtime PyTorch ships
(``torch/lib/libgomp*.so*``, the one already in the process), so a
toolchain without its ``libgomp.spec`` builds it too.  A failed build or
load, or a PyTorch without that runtime, raises ``KernelFailure`` with
the compiler's or the loader's message.
"""
from __future__ import annotations

import ctypes as ct
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings

import numpy as np

from raft_tpu_torch import errors
from raft_tpu_torch.io import wamit as _wamit
from raft_tpu_torch.io.mesh import _host, mesh_fowt_members, write_pnl
from raft_tpu_torch.ops.kernels._build import BUILD_ROOT

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native", "bem")
SOURCES = (os.path.join(_NATIVE_DIR, "bem.cpp"),
           os.path.join(_PKG, "csrc", "bem_lapack.cpp"))
TABLE_PATH = os.path.join(_NATIVE_DIR, "greens_table.bin")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp")

_LOCK = threading.Lock()
_LIB = None
#: facts of the build that produced the loaded library
BUILD_INFO: dict = {}
#: facts of the last solve `solve_bem_fowt` ran (not a cache hit): wall
#: seconds, panels (body panels and interior lid), frequencies, headings
LAST_SOLVE: dict = {}


def _fail(msg, **ctx):
    raise errors.KernelFailure(msg, kernel="bem_native", **ctx)


def source_hash() -> str:
    h = hashlib.sha256()
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library (unless built for these sources already) and
    return its path."""
    out_dir = os.path.join(BUILD_ROOT, f"bem-{source_hash()}")
    lib_path = os.path.join(out_dir, "libraftbem.so")
    if os.path.isfile(lib_path):
        BUILD_INFO.update(path=lib_path, cached=True)
        return lib_path
    cxx = shutil.which("g++") or shutil.which("c++")
    if not cxx:
        _fail("no C++ compiler (g++) found: the native BEM core cannot be "
              "built")
    os.makedirs(out_dir, exist_ok=True)
    tag = f".tmp{os.getpid()}"
    objs = [os.path.join(out_dir, os.path.basename(src) + tag + ".o")
            for src in SOURCES]
    gomp = _openmp_runtime()
    steps = [[cxx, *CXX_FLAGS, "-c", src, "-o", obj]
             for src, obj in zip(SOURCES, objs)]
    steps.append([cxx, "-shared", *objs, gomp,
                  f"-Wl,-rpath,{os.path.dirname(gomp)}", "-o",
                  lib_path + tag])
    try:
        for cmd in steps:
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0:
                _fail("g++ failed to build the native BEM core:\n"
                      + " ".join(cmd) + "\n"
                      + (out.stderr or out.stdout)[-4000:],
                      returncode=out.returncode)
    except OSError as e:
        _fail(f"{cxx} could not run to build the native BEM core: {e}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(lib_path + tag, lib_path)
    BUILD_INFO.update(path=lib_path, cached=False, compiler=cxx,
                      openmp=gomp)
    return lib_path


def _openmp_runtime() -> str:
    """Path of the GNU OpenMP runtime PyTorch ships (already loaded in
    the process), which the library links."""
    import torch

    found = sorted(glob.glob(os.path.join(os.path.dirname(torch.__file__),
                                          "lib", "libgomp*.so*")))
    if not found:
        _fail("PyTorch ships no GNU OpenMP runtime (torch/lib/libgomp*.so*) "
              "to link the native BEM core against")
    return found[0]


def _scipy_zgesv() -> int:
    """Address of scipy's zgesv (a PyCapsule of cython_lapack)."""
    from scipy.linalg import cython_lapack

    cap = cython_lapack.__pyx_capi__["zgesv"]
    api = ct.pythonapi
    api.PyCapsule_GetName.restype = ct.c_char_p
    api.PyCapsule_GetName.argtypes = [ct.py_object]
    api.PyCapsule_GetPointer.restype = ct.c_void_p
    api.PyCapsule_GetPointer.argtypes = [ct.py_object, ct.c_char_p]
    return api.PyCapsule_GetPointer(cap, api.PyCapsule_GetName(cap))


def load():
    """The loaded library, built at the first call."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = build()
        try:
            lib = ct.CDLL(path)
        except OSError as e:
            _fail(f"failed to load {path}: {e}")
        lib.raft_bem_set_zgesv.argtypes = [ct.c_void_p]
        lib.raft_bem_set_zgesv.restype = None
        lib.raft_bem_load_tables.argtypes = [ct.c_char_p]
        lib.raft_bem_load_tables.restype = ct.c_int
        lib.raft_bem_solve2.argtypes = [
            ct.POINTER(ct.c_double), ct.c_int,            # verts
            ct.POINTER(ct.c_int32), ct.c_int, ct.c_int,   # panels, nbody
            ct.POINTER(ct.c_double), ct.c_int,            # omegas
            ct.POINTER(ct.c_double), ct.c_int,            # betas
            ct.c_double, ct.c_double, ct.c_double,        # rho, g, depth
            ct.POINTER(ct.c_double), ct.POINTER(ct.c_double),
            ct.POINTER(ct.c_double), ct.POINTER(ct.c_double)]
        lib.raft_bem_solve2.restype = ct.c_int
        lib.raft_bem_set_zgesv(_scipy_zgesv())
        if not os.path.isfile(TABLE_PATH):
            _fail(f"{TABLE_PATH} missing — run native/bem/make_tables.py")
        if lib.raft_bem_load_tables(TABLE_PATH.encode()) != 0:
            _fail(f"failed to load Green-function tables from {TABLE_PATH}")
        _LIB = lib
        return lib


def solve_radiation_diffraction(mesh, omegas, betas_deg, rho=1025.0,
                                g=9.81, depth=0.0):
    """Run the native solver on a PanelMesh.  Returns (A (nw,6,6), B
    (nw,6,6), X (nw,nbeta,6) complex) about the origin, per unit wave
    amplitude.  ``depth`` > 0 selects the finite-depth Green function
    (the solver switches to the deep-water kernel above k0*h ~ 25); 0 is
    deep water."""
    lib = load()
    verts = np.ascontiguousarray(mesh.verts, dtype=np.float64)
    panels = np.ascontiguousarray(mesh.panels, dtype=np.int32)
    omegas = np.ascontiguousarray(np.atleast_1d(omegas), dtype=np.float64)
    betas = np.ascontiguousarray(np.deg2rad(np.atleast_1d(betas_deg)),
                                 dtype=np.float64)
    nw, nb = len(omegas), len(betas)
    A = np.zeros((nw, 6, 6))
    B = np.zeros((nw, 6, 6))
    Xre = np.zeros((nw, nb, 6))
    Xim = np.zeros((nw, nb, 6))

    def p(a, t=ct.c_double):
        return a.ctypes.data_as(ct.POINTER(t))

    rc = lib.raft_bem_solve2(
        p(verts), len(verts), p(panels, ct.c_int32), len(panels),
        int(getattr(mesh, "nbody", len(panels))),
        p(omegas), nw, p(betas), nb, float(rho), float(g), float(depth),
        p(A), p(B), p(Xre), p(Xim))
    if rc != 0:
        _fail(f"raft_bem_solve failed (rc={rc})", rc=int(rc))
    return A, B, Xre + 1j * Xim


def cache_key(fowt, mesh, headings, w_bem=None, max_freqs=48,
              dw_bem=None) -> str:
    """The ``meshDir`` cache key, byte for byte the JAX package's
    (raft_tpu/io/bem_native.py:158-178): a SHA-256 over the mesh, the
    model grid, the BEM grid settings, the headings, the fluid, the
    depth and the solver's physics-version token."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.verts).tobytes())
    h.update(np.ascontiguousarray(mesh.panels).tobytes())
    h.update(_host(fowt.w).tobytes())
    h.update(np.asarray(w_bem if w_bem is not None else [], float).tobytes())
    h.update(np.array([max_freqs, -1.0 if dw_bem is None else float(dw_bem)],
                      float).tobytes())
    h.update(np.asarray(headings, float).tobytes())
    h.update(np.array([fowt.rho_water, fowt.g, fowt.depth,
                       mesh.nbody]).tobytes())
    h.update(b"raftbem-v2-finite-depth")
    return h.hexdigest()


def solve_bem_fowt(fowt, headings=None, dz=None, da=None, w_bem=None,
                   mesh_dir=None, max_freqs=48, dw_bem=None):
    """Mesh a FOWT's potMod members, run the native BEM core and return a
    numpy `BEMData` on the model frequency grid (reference:
    raft_fowt.py:568-717).

    - BEM frequencies: ``w_bem``, else a grid of step ``dw_bem`` (the
      reference's min_freq_BEM) or the model grid's, halved until at
      most ``max_freqs`` solves, ending at the model grid's top;
    - ``mesh_dir`` is a coefficient cache: WAMIT ``Output.1``/``.3`` there
      under a matching ``cache_key.txt`` are loaded instead of solving,
      and a fresh solve is written back (with ``HullMesh.pnl``).  The key
      is the JAX package's, byte for byte, so either package reloads the
      other's solve;
    - X is conjugated from the solver's e^{-i w t} convention into the
      WAMIT e^{+i w t} one used throughout."""
    rho, g = fowt.rho_water, fowt.g
    w_model = _host(fowt.w)
    if headings is None:
        headings = np.arange(0.0, 360.0, 30.0)
    headings = np.asarray(headings, float)

    mesh = None
    key = None
    if mesh_dir is not None:
        mesh = mesh_fowt_members(fowt, dz_max=dz or 3.0, da_max=da or 2.0)
        key = cache_key(fowt, mesh, headings, w_bem, max_freqs, dw_bem)
        key_path = os.path.join(mesh_dir, "cache_key.txt")
        stored = None
        if os.path.isfile(key_path):
            with open(key_path) as f:
                stored = f.read().strip()
        if stored == key and os.path.isfile(os.path.join(mesh_dir,
                                                         "Output.1")):
            return _wamit.load_bem(os.path.join(mesh_dir, "Output"),
                                   w_model, rho=rho, g=g)
        if stored is not None and stored != key:
            warnings.warn(
                f"bem: cache key changed in '{mesh_dir}' (geometry, BEM "
                "grid, or solver/key version) — re-solving and refreshing "
                "the cache")

    if w_bem is None:
        if dw_bem is not None:
            dw = float(dw_bem)
        else:
            dw = float(w_model[0]) if len(w_model) < 2 \
                else float(w_model[1] - w_model[0])
        w_bem = np.arange(dw, w_model[-1] + 0.5 * dw, dw)
        while len(w_bem) > max_freqs:
            w_bem = w_bem[::2]
        if len(w_bem) == 0 or w_bem[-1] < w_model[-1]:
            w_bem = np.r_[w_bem, w_model[-1]]
    w_bem = np.asarray(w_bem, float)

    if mesh is None:
        mesh = mesh_fowt_members(fowt, dz_max=dz or 3.0, da_max=da or 2.0)
    t0 = time.perf_counter()
    A, B, X = solve_radiation_diffraction(mesh, w_bem, headings, rho, g,
                                          depth=float(fowt.depth))
    LAST_SOLVE.clear()
    LAST_SOLVE.update(seconds=time.perf_counter() - t0,
                      panels=int(mesh.npanels), body_panels=int(mesh.nbody),
                      frequencies=len(w_bem), headings=len(headings))
    X = np.conj(X)

    # the WAMIT reader's layout: (6,6,nf) and (nh,6,nf)
    A_t = np.moveaxis(A, 0, -1)
    B_t = np.moveaxis(B, 0, -1)
    X_t = np.moveaxis(X, 0, -1)

    if mesh_dir is not None:
        os.makedirs(mesh_dir, exist_ok=True)
        write_pnl(mesh, mesh_dir)
        _wamit.write_wamit1(os.path.join(mesh_dir, "Output.1"),
                            w_bem, A_t, B_t, rho=rho)
        _wamit.write_wamit3(os.path.join(mesh_dir, "Output.3"),
                            w_bem, headings, X_t, rho=rho, g=g)
        with open(os.path.join(mesh_dir, "cache_key.txt"), "w") as f:
            f.write(key)
        return _wamit.load_bem(os.path.join(mesh_dir, "Output"),
                               w_model, rho=rho, g=g)

    # the same steps as load_bem: zero-frequency pad, model-grid
    # interpolation, wave-frame rotation
    A_m = _wamit._interp_freq(w_model, w_bem, A_t, A_t[..., 0])
    B_m = _wamit._interp_freq(w_model, w_bem, B_t, np.zeros((6, 6)))
    X_m = _wamit._interp_freq(w_model, w_bem, X_t, np.zeros_like(X_t[..., 0]))
    return _wamit.BEMData(A_BEM=A_m, B_BEM=B_m,
                          X_BEM=_wamit.rotate_to_wave_frame(X_m, headings),
                          headings=headings)
