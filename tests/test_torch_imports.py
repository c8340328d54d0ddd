"""The port stands alone: it imports torch and numpy, never jax and nothing
of the JAX package, and it imports without a CUDA toolkit or triton."""
import os
import pkgutil
import re
import subprocess
import sys

import torch

import pion_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _submodules():
    names = ["pion_tpu_torch"]
    for m in pkgutil.walk_packages(pion_tpu_torch.__path__, "pion_tpu_torch."):
        names.append(m.name)
    return names


def test_every_submodule_imports_without_jax_or_reference_package():
    names = _submodules()
    for needed in ("pion_tpu_torch.ops.fused_sweep", "pion_tpu_torch.sim",
                   "pion_tpu_torch._build", "pion_tpu_torch.convert",
                   "pion_tpu_torch.ics.blast", "pion_tpu_torch.physics",
                   "pion_tpu_torch.microphysics.tables",
                   "pion_tpu_torch.microphysics.base",
                   "pion_tpu_torch.microphysics.mpv3",
                   "pion_tpu_torch.microphysics.cooling",
                   "pion_tpu_torch.microphysics.fused_mpv3",
                   "pion_tpu_torch.raytracing.tracer",
                   "pion_tpu_torch.raytracing.fused_trace",
                   "pion_tpu_torch.winds", "pion_tpu_torch.ng",
                   "pion_tpu_torch.io", "pion_tpu_torch.io.snapshot",
                   "pion_tpu_torch.cli", "pion_tpu_torch.__main__",
                   "pion_tpu_torch.io.params", "pion_tpu_torch.ics.problems",
                   "pion_tpu_torch.ics.starbench",
                   "pion_tpu_torch.ics.advection",
                   "pion_tpu_torch.ics.mhd2d",
                   "pion_tpu_torch.microphysics.variants",
                   "pion_tpu_torch.microphysics.mpv7",
                   "pion_tpu_torch.ops.conduction", "pion_tpu_torch.utils",
                   "pion_tpu_torch.debug", "pion_tpu_torch.io.compare",
                   "pion_tpu_torch.io.fits", "pion_tpu_torch.analysis",
                   "pion_tpu_torch.analysis.export",
                   "pion_tpu_torch.analysis.projection",
                   "pion_tpu_torch.parallel", "pion_tpu_torch.parallel.mesh",
                   "pion_tpu_torch.parallel.halo",
                   "pion_tpu_torch.raytracing.sharded_trace",
                   "pion_tpu_torch.tracing"):
        assert needed in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'pion_tpu' or "
        "m.startswith('pion_tpu.') or m == 'triton')\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT,
               PATH=os.path.dirname(sys.executable))    # no nvcc on the path
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_no_import_of_jax_or_reference_package_in_the_sources():
    pat = re.compile(r"^\s*(import jax|from jax|import pion_tpu\b(?!_)|"
                     r"from pion_tpu(\.| import)|.*\bpion_tpu\.)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "kernel_times.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "pion_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            src = f.read()
        hits = [m.group(0) for m in pat.finditer(src)]
        assert not hits, f"{os.path.relpath(path, ROOT)}: {hits}"


def test_build_fails_loudly_without_a_compiler(monkeypatch, tmp_path):
    """Asking for a library without nvcc raises instead of falling back."""
    from pion_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    for get in (lambda: _build.get_lib("float32", "hlld"),
                lambda: _build.get_mpv3_lib("float64"),
                lambda: _build.get_trace_lib("float32")):
        try:
            get()
        except RuntimeError as e:
            assert "nvcc" in str(e)
        else:
            raise AssertionError("expected a RuntimeError without nvcc")
    # every translation unit is built once per variant from its own source
    units = {unit for unit, _ in _build.VARIANTS.values()}
    assert units == {"sweep.cu", "mpv3.cu", "trace.cu"} == set(_build._FUNCTIONS)
    assert all(os.path.exists(os.path.join(_build.CSRC, f))
               for f in _build.SOURCES)
    rows = _build.parse_ptxas(
        "ptxas info    : Compiling entry function "
        "'_ZN4pion17final_axis_kernelIdLi1ELi1ELi1ELi2ELi2EEEvPKT_' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 680 bytes cmem[0]\n")
    assert rows == [{"kernel": "final_axis<d,1,1,1,2,2>", "registers": 168,
                     "spill_stores": 4, "spill_loads": 12}]
    assert _build._short_name(
        "_ZN4pion19octant_trace_kernelIfEEvPKT_PS1_NS_9TraceGeomES1_"
    ) == "octant_trace<f>"
