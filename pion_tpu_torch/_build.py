"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into shared libraries
with a plain C interface and loaded with ``ctypes``; nothing of PyTorch's
headers is included, so a build takes seconds.  Libraries land in
``pion_tpu_torch/build/`` (not under version control), keyed on a hash of the
sources and the flags: a changed source builds anew, an unchanged one is
loaded from disk.  The build happens at first use, never at import, so the
package imports on a machine without a CUDA toolkit.

One library per (scalar type, Riemann solver); :func:`load_all` starts every
missing build at once, one ``nvcc`` process each.
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
SOURCES = ("sweep.cu", "riemann_mhd.cuh", "eqns.cuh")

# (dtype name, solver name) -> compile-time definitions of sweep.cu
VARIANTS: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("float32", "hll"): ("-DPION_REAL=float", "-DPION_SOLVER=0"),
    ("float32", "hlld"): ("-DPION_REAL=float", "-DPION_SOLVER=1"),
    ("float64", "hll"): ("-DPION_REAL=double", "-DPION_SOLVER=0"),
    ("float64", "hlld"): ("-DPION_REAL=double", "-DPION_SOLVER=1"),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SWEEP_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
               ctypes.c_ulonglong, _D, _D, _D, _D, _D, _D, _P]
_FINAL_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
               _D, _D, _D, _D, _D, _D, _P]

_libs: Dict[Tuple[str, str], ctypes.CDLL] = {}
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


def _paths(key: Tuple[str, str], digest: str) -> Tuple[str, str]:
    stem = f"libpion_sweep_{key[0]}_{key[1]}_{digest}"
    return (os.path.join(BUILD_DIR, stem + ".so"),
            os.path.join(BUILD_DIR, stem + ".log"))


def _short_name(mangled: str) -> str:
    """``sweep_axis<f,1,1,1,2>`` from a mangled kernel name: scalar type,
    then EQN, SOLVER, AV, ORDER (and K for the final-axis kernel)."""
    m = re.search(r"(sweep_axis|final_axis)_kernelI([fd])((?:Li\d+E)+)E",
                  mangled)
    if not m:
        return mangled
    return (f"{m.group(1)}<{m.group(2)},"
            + ",".join(re.findall(r"Li(\d+)E", m.group(3))) + ">")


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


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.pion_sweep_axis.argtypes = _SWEEP_ARGS
    lib.pion_sweep_axis.restype = _I
    lib.pion_final_axis.argtypes = _FINAL_ARGS
    lib.pion_final_axis.restype = _I
    return lib


def load_all() -> dict:
    """Build (in parallel, one ``nvcc`` each) and load every library.
    Returns the build record:
    ``{"seconds", "built", "variants": {name: [ptxas rows]}}``."""
    keys = list(VARIANTS)
    digest = _source_hash()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    procs = []
    for key in keys:
        if key in _libs:
            continue
        so, log = _paths(key, digest)
        if os.path.exists(so):
            continue
        # build under a private name and rename when complete, so that a
        # build that was cut off never leaves a library that loads
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *VARIANTS[key], "-I", CSRC,
               "-o", tmp, os.path.join(CSRC, "sweep.cu")]
        logf = open(log, "w")
        procs.append((key, tmp, so, log, logf,
                      subprocess.Popen(cmd, stdout=logf,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for key, tmp, so, log, logf, proc in procs:
        rc = proc.wait()
        logf.close()
        if rc != 0:
            with open(log) as f:
                failed.append(f"{key}: nvcc exit {rc}\n{f.read()[-4000:]}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    for key in keys:
        so, log = _paths(key, digest)
        if key not in _libs:
            _libs[key] = _bind(so)
        if os.path.exists(log):
            with open(log) as f:
                _info["_".join(key)] = parse_ptxas(f.read())
    return {"seconds": time.time() - t0, "built": len(procs),
            "variants": {"_".join(k): _info.get("_".join(k), [])
                         for k in keys}}


def get_lib(dtype_name: str, solver_name: str) -> ctypes.CDLL:
    """The loaded library for one (dtype, solver), building every variant
    that is still missing at first use."""
    key = (dtype_name, solver_name)
    if key not in VARIANTS:
        raise ValueError(f"no kernel build for {key}")
    if key not in _libs:
        load_all()
    return _libs[key]
