"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into shared libraries
with a plain C interface and loaded with ``ctypes``; nothing of PyTorch's
headers is included, so a build takes seconds.  Libraries land in
``pion_tpu_torch/build/`` (not under version control), keyed on a hash of the
sources and the flags: a changed source builds anew, an unchanged one is
loaded from disk.  The build happens at first use, never at import, so the
package imports on a machine without a CUDA toolkit.

One library per translation unit and scalar type: ``sweep.cu`` once per
(scalar type, Riemann solver) -- HLL, HLLD, linear, Roe-CV and Roe-PV, each
with the equation systems that run it (HLLD: MHD and GLM only; Roe-PV: Euler
only, since for MHD it is the linear solver) -- ``mpv3.cu`` and ``trace.cu``
once per scalar type.  :func:`load_all` starts every missing build at once, one ``nvcc``
process each.  The timing probes of ``PROBES`` (``trace_floor.cu``, and
``mpv3.cu`` with its B4 probes compiled in) are built only when a timing
script asks for one (:func:`get_probe_lib`): no path launches them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
# every file a translation unit is made of: a change to any rebuilds all
SOURCES = ("sweep.cu", "riemann_mhd.cuh", "riemann_hydro.cuh", "eqns.cuh",
           "async_copy.cuh", "mpv3.cu", "trace.cu", "trace_floor.cu")

_REAL = {"float32": "-DPION_REAL=float", "float64": "-DPION_REAL=double"}

# library key -> (translation unit, compile-time definitions).  The sweep
# libraries keep their two-part key (dtype name, solver name).
# the solvers of sweep.cu by the value of -DPION_SOLVER (SOLVER_* of eqns.cuh)
SWEEP_SOLVERS = {"hll": 0, "hlld": 1, "linear": 2, "roe": 3, "roe_pv": 4}

VARIANTS: Dict[Tuple[str, ...], Tuple[str, Tuple[str, ...]]] = {
    **{(dtype, solver): ("sweep.cu", (_REAL[dtype], f"-DPION_SOLVER={i}"))
       for dtype in ("float32", "float64")
       for solver, i in SWEEP_SOLVERS.items()},
    ("mpv3", "float32"): ("mpv3.cu", (_REAL["float32"],)),
    ("mpv3", "float64"): ("mpv3.cu", (_REAL["float64"],)),
    ("trace", "float32"): ("trace.cu", (_REAL["float32"],)),
    ("trace", "float64"): ("trace.cu", (_REAL["float64"],)),
}
# timing probes: key -> (translation unit, definitions), as VARIANTS
PROBES: Dict[Tuple[str, ...], Tuple[str, Tuple[str, ...]]] = {
    ("trace_floor",): ("trace_floor.cu", ()),
    ("ydot_probe",): ("mpv3.cu", (_REAL["float32"], "-DPION_YDOT_PROBE")),
}
_UNITS = {**VARIANTS, **PROBES}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_D = ctypes.c_double
_SWEEP_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
               ctypes.c_ulonglong, _I, _I, _D, _D, _D, _D, _D, _D, _P]
_FINAL_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
               _I, _I, _D, _D, _D, _D, _D, _D, _P]
_DP = ctypes.POINTER(ctypes.c_double)
_PP = ctypes.POINTER(ctypes.c_void_p)
_MP_HEAD = [_P, _P, _P, _PP, _I, _P, _P, _P]          # cells, sources, tables
_MP_TAIL = [_L, _I, _I, _DP, _I, _I]                  # n, modes, constants
_YDOT_ARGS = _MP_HEAD + [_P, _P] + _MP_TAIL + [_P]
_UPDATE_ARGS = (_MP_HEAD + [_P, _P, _P, _P, _P, _P] + _MP_TAIL
                + [_I, _I, _D, _P, _P, _I, _P])
_TRACE_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I, _D, _I, _I, _I, _I, _P]

# C functions of each translation unit: name -> argument types
_FUNCTIONS = {
    "sweep.cu": {"pion_sweep_axis": _SWEEP_ARGS,
                 "pion_final_axis": _FINAL_ARGS},
    "mpv3.cu": {"pion_mpv3_ydot": _YDOT_ARGS,
                "pion_mpv3_update": _UPDATE_ARGS},
    "trace.cu": {"pion_octant_trace": _TRACE_ARGS},
}
# and of each timing probe, by its key in PROBES
_PROBE_FUNCTIONS = {
    ("trace_floor",): {"pion_trace_barrier_floor": [_I, _I, _I, _I, _P]},
    ("ydot_probe",): {"pion_mpv3_ydot_probe": [_I] + _MP_HEAD + [_P, _P]
                      + _MP_TAIL + [_P]},
}

_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}
_info: Dict[str, dict] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            exe = cand
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of pion_tpu_torch/csrc cannot "
            "be built (pass device='cpu' or kernels='off' to run without them)")
    return exe


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _paths(key: Tuple[str, ...], digest: str) -> Tuple[str, str]:
    unit = _UNITS[key][0][:-3]
    stem = "_".join(["libpion", unit, *(k for k in key if k != unit), digest])
    return (os.path.join(BUILD_DIR, stem + ".so"),
            os.path.join(BUILD_DIR, stem + ".log"))


def _short_name(mangled: str) -> str:
    """``sweep_axis<f,1,1,1,2>`` from a mangled kernel name: scalar type,
    then the kernel's integer template arguments."""
    m = re.search(r"\d([a-z_]+)_kernelI([fd])((?:Li\d+E)*)E", mangled)
    if not m:
        return mangled
    return (f"{m.group(1)}<"
            + ",".join([m.group(2)] + re.findall(r"Li(\d+)E", m.group(3)))
            + ">")


def parse_ptxas(log: str) -> list:
    """Registers and spill bytes of each kernel from ``nvcc -Xptxas -v``
    output: a list of ``{"kernel", "registers", "spill_stores",
    "spill_loads"}``."""
    out = []
    name = None
    spill = (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _short_name(m.group(1))
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "spill_stores": spill[0], "spill_loads": spill[1]})
            name = None
    return out


def _bind(path: str, key: Tuple[str, ...]) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    unit = _UNITS[key][0]
    for name, argtypes in {**_FUNCTIONS.get(unit, {}),
                           **_PROBE_FUNCTIONS.get(key, {})}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def _compile(keys, digest: str) -> int:
    """Build the libraries of ``keys`` not yet on disk, one ``nvcc`` each,
    all started at once; raises if any build fails.  Returns how many were
    built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for key in keys:
        so, log = _paths(key, digest)
        if key in _libs or os.path.exists(so):
            continue
        # build under a private name and rename when complete, so that a
        # build that was cut off never leaves a library that loads
        tmp = f"{so}.{os.getpid()}.tmp"
        unit, defs = _UNITS[key]
        cmd = [_nvcc(), *NVCC_FLAGS, *defs, "-I", CSRC,
               "-o", tmp, os.path.join(CSRC, unit)]
        logf = open(log, "w")
        procs.append((tmp, so, log, logf,
                      subprocess.Popen(cmd, stdout=logf,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for tmp, so, log, logf, proc in procs:
        rc = proc.wait()
        logf.close()
        if rc != 0:
            with open(log) as f:
                # the first errors say the most
                failed.append(f"{os.path.basename(so)}: nvcc exit {rc}\n"
                              f"{f.read()[:5000]}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return len(procs)


def load_all() -> dict:
    """Build (in parallel, one ``nvcc`` each) and load every library of
    ``VARIANTS``.  Returns the build record:
    ``{"seconds", "built", "variants": {name: [ptxas rows]}}``."""
    keys = list(VARIANTS)
    digest = _source_hash()
    t0 = time.time()
    built = _compile(keys, digest)
    for key in keys:
        so, log = _paths(key, digest)
        if key not in _libs:
            _libs[key] = _bind(so, key)
        if os.path.exists(log):
            with open(log) as f:
                _info["_".join(key)] = parse_ptxas(f.read())
    return {"seconds": time.time() - t0, "built": built,
            "variants": {"_".join(k): _info.get("_".join(k), [])
                         for k in keys}}


def _get(key: Tuple[str, ...]) -> ctypes.CDLL:
    if key not in VARIANTS:
        raise ValueError(f"no kernel build for {key}")
    if key not in _libs:
        load_all()
    return _libs[key]


def get_lib(dtype_name: str, solver_name: str) -> ctypes.CDLL:
    """The loaded sweep library for one (dtype, solver), building every
    library that is still missing at first use."""
    return _get((dtype_name, solver_name))


def get_mpv3_lib(dtype_name: str) -> ctypes.CDLL:
    """The loaded MPv3 chemistry library for one dtype."""
    return _get(("mpv3", dtype_name))


def get_trace_lib(dtype_name: str) -> ctypes.CDLL:
    """The loaded octant-trace library for one dtype."""
    return _get(("trace", dtype_name))


def get_probe_lib(name: str) -> ctypes.CDLL:
    """The loaded library of the timing probe ``name`` (``PROBES``), built on
    its own at first use."""
    key = (name,)
    if key not in PROBES:
        raise ValueError(f"no timing probe {name!r}")
    if key not in _libs:
        digest = _source_hash()
        _compile([key], digest)
        _libs[key] = _bind(_paths(key, digest)[0], key)
    return _libs[key]
