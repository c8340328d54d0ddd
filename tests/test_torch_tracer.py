"""pion_tpu_torch.raytracing against the JAX package on the same seeded
inputs: both point-source tracers, parallel rays, the static geometry, and
the octant kernel's plain version against the Pallas kernel in interpret
mode.  CPU, float64."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.raytracing import tracer as ref_tracer
from pion_tpu.raytracing.pallas_trace import OctantSweep3D

from pion_tpu_torch import convert, make_geometry
from pion_tpu_torch.raytracing import (PointSourceTracer, Raytracer, Source,
                                       StarEvolution, fused_trace,
                                       parallel_rays, tracer)

torch.set_num_threads(1)

# (shape, source position as a fraction of the box): the four cases of the
# JAX package's kernel test, one 2D and one 1D
CASES = [
    ((16, 16, 16), (0.5, 0.5, 0.5)),
    ((16, 12, 20), (0.3, 0.6, 0.45)),
    ((8, 8, 8), (0.03, 0.03, 0.03)),     # corner source
    ((8, 8, 8), (0.97, 0.2, 0.6)),       # boundary, strongly off-centre
    ((12, 20), (0.3, 0.7)),
    ((24,), (0.4,)),
]
# the same sums of four products in the same order on both sides
RTOL = 1.0e-12


def setups(shape, pos_frac, kernels="auto"):
    nd = len(shape)
    xmax = tuple(n / 16 for n in shape)
    rcfg = pion_tpu.SimConfig(
        ndim=nd, eqn="euler", solver="hll", shape=shape, xmin=(0.0,) * nd,
        xmax=xmax, bcs=(("outflow", "outflow"),) * nd,
        pallas="off" if kernels == "off" else "auto")
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    pos = tuple(pos_frac[a] * xmax[a] for a in range(nd))
    dtau = np.random.default_rng(3).uniform(0.01, 0.5, shape)
    return rcfg, cfg, pos, dtau


@pytest.mark.parametrize("shape,pos_frac", CASES)
def test_shell_tracer_matches_reference(shape, pos_frac):
    """The L1-shell tracer: geometry (ds, Vshell, source cell) and the
    traced columns."""
    rcfg, cfg, pos, dtau = setups(shape, pos_frac)
    ref = ref_tracer.PointSourceTracer(rcfg, pion_tpu.make_geometry(rcfg), pos)
    tr = PointSourceTracer(cfg, make_geometry(cfg), pos)
    assert tr.src_idx == ref.src_idx and tr.tau_min == ref.tau_min
    np.testing.assert_array_equal(tr.ds, ref.ds)
    np.testing.assert_array_equal(tr.vshell, ref.vshell)
    np.testing.assert_array_equal(tr.src_pos, ref.src_pos)
    got = tr.trace(torch.from_numpy(dtau))
    want = np.asarray(ref.trace(jnp.asarray(dtau)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("shape,pos_frac", CASES[:5])
def test_plane_tracer_matches_reference(shape, pos_frac, kernels):
    """The plane-sweep tracer (2D and 3D) against the JAX package's plane
    sweep and against the port's own L1-shell oracle.  On the CPU "auto"
    takes the octant kernel's plain version, "off" the same plane sweep."""
    rcfg, cfg, pos, dtau = setups(shape, pos_frac, kernels)
    assert cfg.kernels == kernels
    ref = ref_tracer.PointSourcePlaneTracer(rcfg, pion_tpu.make_geometry(rcfg),
                                            pos)
    geom = make_geometry(cfg)
    tr = tracer.PointSourcePlaneTracer(cfg, geom, pos)
    assert tr.src_idx == ref.src_idx and tr.n_steps == ref.n_steps
    np.testing.assert_array_equal(tr.ds, ref.ds)
    np.testing.assert_array_equal(tr.vshell, ref.vshell)
    before = fused_trace.octant_trace.launches
    got = tr.trace(torch.from_numpy(dtau)).numpy()
    assert fused_trace.octant_trace.launches == before      # no card, no launch
    np.testing.assert_allclose(got, np.asarray(ref.trace(jnp.asarray(dtau))),
                               rtol=RTOL, atol=1e-15)
    oracle = PointSourceTracer(cfg, geom, pos).trace(torch.from_numpy(dtau))
    np.testing.assert_allclose(got, oracle.numpy(), rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("case,dtype,tol", [
    (0, "float64", 1e-12), (1, "float64", 1e-12), (2, "float64", 1e-12),
    (3, "float64", 1e-12), (1, "float32", 5e-6), (2, "float32", 5e-6)])
def test_octant_trace_plain_matches_pallas_interpret(case, dtype, tol):
    """The octant kernel's plain version against ``OctantSweep3D`` in
    interpret mode; float32 at the bound the JAX package's own test uses
    (reassociation along up to 20 shells)."""
    shape, pos_frac = CASES[case]
    rcfg, cfg, pos, dtau = setups(shape, pos_frac)
    tr = tracer.PointSourcePlaneTracer(cfg, make_geometry(cfg), pos)
    dtau = dtau.astype(dtype)
    sweep = OctantSweep3D(shape, tr.src_idx, tr.tau_min,
                          dtype=jnp.dtype(dtype), interpret=True)
    want = np.asarray(sweep(jnp.asarray(dtau)))
    got = fused_trace.octant_trace_plain(torch.from_numpy(dtau), tr.src_idx,
                                         tr.tau_min)
    assert got.dtype == getattr(torch, dtype)
    assert float(np.abs(got.numpy() - want).max()) <= tol * float(want.max())


def test_octant_trace_slab_and_argument_checks():
    """A 2D grid as a slab one cell deep gives the 2D tracer's columns; bad
    arguments raise."""
    rcfg, cfg, pos, dtau = setups((12, 20), (0.3, 0.7))
    tr = PointSourceTracer(cfg, make_geometry(cfg), pos)
    col = fused_trace.octant_trace_plain(torch.from_numpy(dtau)[None],
                                         (0,) + tr.src_idx, tr.tau_min)[0]
    np.testing.assert_allclose((col - torch.from_numpy(dtau)).numpy(),
                               tr.trace(torch.from_numpy(dtau)).numpy(),
                               rtol=RTOL, atol=1e-15)
    assert fused_trace.supports((1, 12, 20), (0, 3, 14), torch.float32)
    assert not fused_trace.supports((12, 20), (3, 14), torch.float32)
    assert not fused_trace.supports((4, 4, 4), (4, 0, 0), torch.float64)
    assert not fused_trace.supports((4, 4, 4), (0, 0, 0), torch.float16)
    with pytest.raises(ValueError, match="outside"):
        fused_trace.octant_trace_plain(torch.zeros(4, 4, 4), (0, 4, 0), 0.6)
    with pytest.raises(ValueError, match="nz, ny, nx"):
        fused_trace.octant_trace_plain(torch.zeros(4, 4), (0, 0), 0.6)
    _, cfg1, pos1, _ = setups((24,), (0.4,))
    with pytest.raises(ValueError, match="2 dimensions"):
        tracer.PointSourcePlaneTracer(cfg1, make_geometry(cfg1), pos1)


@pytest.mark.parametrize("axis,sign", [(0, 1), (1, -1), (2, 1)])
def test_parallel_rays_match_reference(axis, sign):
    dtau = np.random.default_rng(5).uniform(0.01, 0.5, (6, 8, 10))
    want = ref_tracer.parallel_rays(jnp.asarray(dtau), axis, sign, 0.25)
    got = parallel_rays(torch.from_numpy(dtau), axis, sign, 0.25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14,
                                   atol=1e-16)


def test_raytracer_and_star_evolution_match_reference(tmp_path):
    """``Raytracer.trace_source`` for a point source and one at infinity,
    and the evolution table read from a file."""
    rcfg, cfg, pos, dtau = setups((8, 12, 10), (0.4, 0.5, 0.2))
    rsrc = [ref_tracer.Source(position=pos, strength=1e48, effect="mfion"),
            ref_tracer.Source(at_infinity=True, axis=1, sign=-1,
                              strength=1e10, effect="uv_heating")]
    src = [convert.source_from_reference(dataclasses.asdict(s)) for s in rsrc]
    assert src == [Source(position=pos, strength=1e48, effect="mfion"),
                   Source(at_infinity=True, axis=1, sign=-1, strength=1e10,
                          effect="uv_heating")]
    ref = ref_tracer.Raytracer(rcfg, pion_tpu.make_geometry(rcfg), rsrc)
    rt = Raytracer(cfg, make_geometry(cfg), src)
    for i in range(2):
        want = ref.trace_source(i, jnp.asarray(dtau))
        got = rt.trace_source(i, torch.from_numpy(dtau))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=1e-15)
    # raw shell volumes leave float32: clipped there, as the reference does
    # without x64
    _, ds32, vs32 = rt.trace_source(0, torch.from_numpy(dtau).float())
    assert vs32.dtype == torch.float32 and bool(torch.isfinite(vs32).all())

    path = tmp_path / "star.txt"
    rows = ["# time M L Teff", "# s Msun erg/s K"]
    for t, L, T in ((0.0, 1e38, 3e4), (1e13, 2e38, 3.3e4), (2e13, 5e38, 4e4)):
        rows.append(f"{t} 30 {L} {T} 1e-6 0 0 2000")
    path.write_text("\n".join(rows) + "\n")
    want = ref_tracer.StarEvolution.from_file(str(path))
    got = StarEvolution.from_file(str(path))
    for t in (-1.0, 0.5e13, 1.7e13, 3e13):
        np.testing.assert_allclose(got.at(t), want.at(t), rtol=1e-14)
    back = convert.source_from_reference(dataclasses.asdict(
        ref_tracer.Source(position=pos, evolution=want)))
    np.testing.assert_array_equal(back.evolution.log_R, want.log_R)
    with pytest.raises(ValueError, match="unknown Source keys"):
        convert.source_from_reference({"position": pos, "colour": "blue"})
