"""pion_tpu_torch.ng against pion_tpu.ng on the same seeded inputs: level
layout, prolongation, restriction, BC89, the interface-flux slabs, and a
2-level GLM-MHD blast over three hierarchy steps.  CPU, float64 unless a
test says otherwise."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.grid import make_geometry as ref_make_geometry
from pion_tpu.ics.blast import blast_wave as ref_blast_wave
from pion_tpu.ng import NGHierarchy as RefHierarchy
from pion_tpu.ng import make_level_cfg as ref_make_level_cfg
from pion_tpu.ng import snap_ng_centre as ref_snap_ng_centre
from pion_tpu.ops import sweep as ref_sweep

from pion_tpu_torch import NGHierarchy, convert, ng
from pion_tpu_torch.grid import make_geometry
from pion_tpu_torch.ops import sweep

torch.set_num_threads(1)

OP_RTOL = 1e-13

LAYOUTS = {
    # centred nest, nothing touches the domain boundary
    "2d-centred": dict(
        ndim=2, shape=(16, 16), xmin=(0.0, 0.0), xmax=(1.0, 1.0),
        bcs=(("outflow", "outflow"),) * 2, ng_centre=None),
    # the nest sits in a corner: a reflecting face and a frozen inflow face
    # of the fine level lie on the domain boundary
    "2d-corner": dict(
        ndim=2, shape=(16, 16), xmin=(0.0, 0.0), xmax=(1.0, 1.0),
        bcs=(("outflow", "reflecting"), ("inflow", "outflow")),
        ng_centre=(1.0, 0.0)),
    # off-centre in 3D: one face on the boundary, one axis at a quarter
    "3d-offcentre": dict(
        ndim=3, shape=(8, 8, 8), xmin=(0.0, 0.0, 0.0), xmax=(1.0, 1.0, 1.0),
        bcs=(("oneway_out", "outflow"), ("outflow", "outflow"),
             ("outflow", "outflow")),
        ng_centre=(0.0, 0.5, 0.25)),
}


def ref_cfg(layout, dtype="float64", pallas="off", nlevels=2, **kw):
    base = dict(eqn="glm", solver="hlld", ntracer=1, cfl=0.3, ooa=2,
                av="falle", etav=0.1, dtype=dtype, pallas=pallas,
                nlevels=nlevels, tmax=1.0)
    base.update(LAYOUTS[layout])
    base.update(kw)
    return pion_tpu.SimConfig(**base)


def level_states(rcfg, nlevels, seed):
    """A blast wave on every level (the same physical problem), with seeded
    noise on velocities, field and psi and a random tracer."""
    centre = ref_snap_ng_centre(rcfg)
    rng = np.random.default_rng(seed)
    out = []
    for l in range(nlevels):
        c = ref_make_level_cfg(rcfg, l, centre)
        P = ref_blast_wave(c, B0=(0.1, 0.05, 0.02))
        P[2:5] += 0.1 * rng.standard_normal((3,) + c.shape)
        P[5:8] += 0.02 * rng.standard_normal((3,) + c.shape)
        P[8] = 0.01 * rng.standard_normal(c.shape)
        P[9] = rng.random(c.shape)
        out.append(P.astype(rcfg.np_dtype))
    return out


def hier_pair(layout, seed=1, **kw):
    rcfg = ref_cfg(layout, **kw)
    states = level_states(rcfg, rcfg.nlevels, seed)
    ref = RefHierarchy(rcfg)
    ref.set_states([jnp.asarray(s) for s in states])
    hier = convert.hierarchy_from_reference(dataclasses.asdict(rcfg), states,
                                            device="cpu")
    return ref, hier, states


def close(out, ref, rtol, atol=0.0):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=rtol, atol=atol)


def random_state(cfg, seed):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((cfg.nvar,) + cfg.shape)
    P[0] = rng.uniform(0.5, 2.0, cfg.shape)
    P[1] = rng.uniform(0.5, 2.0, cfg.shape)
    return P


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_level_layout_is_exact(layout):
    rcfg = ref_cfg(layout, nlevels=3 if layout == "2d-centred" else 2)
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    assert ng.snap_ng_centre(cfg) == ref_snap_ng_centre(rcfg)
    ref = RefHierarchy(rcfg)
    hier = NGHierarchy(cfg, device="cpu")
    assert hier.n_levels == ref.n_levels == rcfg.nlevels
    assert hier.centre == ref.centre
    assert hier.offs == ref.offs and hier.dom_sides == ref.dom_sides
    for c, r in zip(hier.cfgs, ref.cfgs):
        assert c.xmin == r.xmin and c.xmax == r.xmax and c.nlevels == 1
        assert c.dx == r.dx
    if layout == "2d-corner":
        assert sorted(hier.dom_sides[1]) == [(0, 1), (1, 0)]
    # a centre that is no quarter of the domain is snapped to one
    odd = dataclasses.replace(cfg, ng_centre=tuple(
        lo + 0.3 * (hi - lo) for lo, hi in zip(cfg.xmin, cfg.xmax)))
    rodd = rcfg.with_(ng_centre=odd.ng_centre)
    assert ng.snap_ng_centre(odd) == ref_snap_ng_centre(rodd)
    assert ng.make_level_cfg(odd, 1).xmin == ref_make_level_cfg(rodd, 1).xmin


def test_entry_point_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = convert.config_from_reference(
        dataclasses.asdict(ref_cfg("2d-centred")))
    with pytest.raises(RuntimeError, match="CUDA"):
        NGHierarchy(cfg)
    rcfg = ref_cfg("2d-centred")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.hierarchy_from_reference(dataclasses.asdict(rcfg),
                                         level_states(rcfg, 2, 3))


def test_what_is_not_ported_raises():
    rcfg = ref_cfg("2d-centred")
    states = level_states(rcfg, 2, 3)
    hier = convert.hierarchy_from_reference(dataclasses.asdict(rcfg), states,
                                            device="cpu")
    # several steps in one dispatch are ported: four steps in one chunk
    # equal four steps one by one
    hier.run(max_steps=4, chunk=4)
    one = convert.hierarchy_from_reference(dataclasses.asdict(rcfg), states,
                                           device="cpu").run(max_steps=4)
    assert hier.step_count == one.step_count == 4 and hier.t == one.t
    assert all(torch.equal(a, b) for a, b in zip(hier.P, one.P))
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    for kw in (dict(mesh="on"), dict(halo="explicit")):
        h = NGHierarchy(dataclasses.replace(cfg, **kw), device="cpu")
        with pytest.raises(NotImplementedError, match="item 20"):
            h.set_states(states)
    with pytest.raises(ValueError, match="levels"):
        NGHierarchy(cfg, device="cpu").set_states(states[:1])
    with pytest.raises(ValueError, match="shape"):
        NGHierarchy(cfg, device="cpu").set_states([s[:, :4] for s in states])


# ---------------------------------------------------------------------------
# operators on random states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prolongation_and_padding(layout):
    ref, hier, _ = hier_pair(layout)
    cfg = hier.cfgs[1]
    Pc = random_state(cfg, 11)
    Pf = random_state(cfg, 12)
    full = hier._prolong_padded(torch.from_numpy(Pc), 1)
    close(full, ref._prolong_padded(jnp.asarray(Pc), 1), OP_RTOL, 1e-15)
    ng_, n = cfg.ng, cfg.shape
    windows = [[(-ng_, n[a] + 2 * ng_) for a in range(cfg.ndim)],
               [(-ng_, ng_)] + [(0, n[a]) for a in range(1, cfg.ndim)],
               [(2, 6)] * (cfg.ndim - 1) + [(n[-1], ng_)]]
    for fr in windows:
        got = hier._prolong_window(torch.from_numpy(Pc), 1, fr)
        close(got, ref._prolong_window(jnp.asarray(Pc), 1, fr), OP_RTOL,
              1e-15)
        # the same values as the window of the full prolongation
        sl = (slice(None),) + tuple(slice(fs + ng_, fs + ng_ + fc)
                                    for fs, fc in fr)
        assert torch.equal(got, full[sl])
    padded = hier._pad_level(1, torch.from_numpy(Pf), torch.from_numpy(Pc))
    close(padded, ref._pad_level(1, jnp.asarray(Pf), jnp.asarray(Pc)),
          OP_RTOL, 1e-15)
    assert padded.is_contiguous()
    assert tuple(padded.shape[1:]) == tuple(s + 2 * ng_ for s in n)
    close(hier._pad_level(0, torch.from_numpy(Pc), None),
          ref._pad_level(0, jnp.asarray(Pc), None), 0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_restriction_and_bc89(layout):
    ref, hier, _ = hier_pair(layout)
    cfg = hier.cfgs[0]
    nd = cfg.ndim
    Pc, Pf = random_state(cfg, 21), random_state(cfg, 22)
    Pc_t, Pf_t = torch.from_numpy(Pc.copy()), torch.from_numpy(Pf.copy())
    got = hier._restrict(Pc_t, Pf_t, 1)
    close(got, ref._restrict(jnp.asarray(Pc), jnp.asarray(Pf), 1), OP_RTOL)
    # neither input is written; uncovered cells are bitwise untouched
    assert np.array_equal(Pc_t.numpy(), Pc) and np.array_equal(Pf_t.numpy(), Pf)
    off = hier.offs[1]
    covered = np.zeros(cfg.shape, dtype=bool)
    covered[tuple(slice(o, o + n // 2) for o, n in zip(off, cfg.shape))] = True
    assert np.array_equal(got.numpy()[:, ~covered], Pc[:, ~covered])

    rng = np.random.default_rng(23)
    faces = [rng.standard_normal(
        (cfg.nvar,) + tuple(n + (1 if a == ax else 0)
                            for a, n in enumerate(cfg.shape)))
        for ax in range(nd)]
    sums, rsums = [], []
    for ax in range(nd):
        tr = tuple(n for a, n in enumerate(cfg.shape) if a != ax)
        pl = [rng.standard_normal((cfg.nvar,) + tr) for _ in range(2)]
        got_f = [hier._restrict_face_flux(torch.from_numpy(p), ax, 1)
                 for p in pl]
        want_f = [ref._restrict_face_flux(jnp.asarray(p), ax, 1) for p in pl]
        for g, w in zip(got_f, want_f):
            close(g, w, OP_RTOL)
        sums.append(tuple(got_f))
        rsums.append(tuple(want_f))
    dU = rng.standard_normal((cfg.nvar,) + cfg.shape)
    dt = 0.0123
    got = hier._bc89_correct(
        torch.from_numpy(dU.copy()),
        lambda ax, i: torch.from_numpy(faces[ax]).select(1 + ax, i),
        sums, 0, torch.tensor(dt, dtype=torch.float64))
    want = ref._bc89_correct(
        jnp.asarray(dU), lambda ax, i: jnp.take(jnp.asarray(faces[ax]), i,
                                                axis=1 + ax), rsums, 0, dt)
    close(got, want, OP_RTOL, 1e-15)
    assert (got.numpy() != dU).any()


@pytest.mark.parametrize("layout,order", [("2d-centred", 2), ("2d-corner", 1),
                                          ("3d-offcentre", 2)])
def test_interface_flux_slabs(layout, order):
    """``interface_flux`` and ``interface_flux_pair`` give the plain sweep's
    own face tensors bit for bit, and the JAX functions to 1e-12."""
    ref, hier, states = hier_pair(layout)
    cfg, geom = hier.cfgs[1], hier.geoms[1]
    rcfg, rgeom = ref.cfgs[1], ref.geoms[1]
    Ppad = hier._pad_level(1, hier.P[1], hier.P[0])
    rPpad = jnp.asarray(Ppad.numpy())
    dt = 2.0e-3
    for scma in (False, True):
        _, faces = sweep.dynamics_dU(Ppad, cfg, geom, dt, order, scma=scma)
        for axis in range(cfg.ndim):
            n = cfg.shape[axis]
            for j in (0, n // 2, n):
                F = sweep.interface_flux(Ppad, cfg, geom, axis, j, dt, order,
                                         scma=scma)
                assert torch.equal(F, faces[axis].select(1 + axis, j))
                close(F, ref_sweep.interface_flux(
                    rPpad, rcfg, rgeom, axis, j, dt, order, scma=scma),
                    1e-12, 1e-14)
            Fa, Fb = sweep.interface_flux_pair(Ppad, cfg, geom, axis, 0, n,
                                               dt, order, scma=scma)
            assert torch.equal(Fa, faces[axis].select(1 + axis, 0))
            assert torch.equal(Fb, faces[axis].select(1 + axis, n))
            ra, rb = ref_sweep.interface_flux_pair(
                rPpad, rcfg, rgeom, axis, 0, n, dt, order, scma=scma)
            close(Fa, ra, 1e-12, 1e-14)
            close(Fb, rb, 1e-12, 1e-14)


# ---------------------------------------------------------------------------
# the hierarchy step
# ---------------------------------------------------------------------------

def scales(P):
    """One scale per variable: its largest value, for the vectors the
    largest of the whole vector."""
    s = np.abs(P).reshape(P.shape[0], -1).max(axis=1)
    s[2:5] = s[2:5].max()
    s[5:8] = s[5:8].max()
    return s.reshape((-1,) + (1,) * (P.ndim - 1))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_blast_three_steps_matches_reference(layout):
    ref, hier, states = hier_pair(layout, seed=5)
    given = [p.clone() for p in hier.P]
    held = list(hier.P)
    dts, rdts = [], []
    for _ in range(3):
        rdts.append(ref.step())
        dts.append(hier.step())
    np.testing.assert_allclose(dts, rdts, rtol=1e-12)
    np.testing.assert_allclose(hier.t, ref.t, rtol=1e-12)
    assert hier.step_count == ref.step_count == 3
    for l in range(2):
        want = np.asarray(ref.P[l])
        err = np.abs(hier.P[l].numpy() - want) / scales(want)
        assert err.max() <= 1e-9, (l, err.max())
        # the states handed in were not written by any step
        assert torch.equal(held[l], given[l])
    assert hier.compute_dt() == pytest.approx(ref.compute_dt(), rel=1e-12)
    # a step of a given size, through run's bookkeeping
    ref.step(1.0e-3)
    hier.step(1.0e-3)
    for l in range(2):
        want = np.asarray(ref.P[l])
        err = np.abs(hier.P[l].numpy() - want) / scales(want)
        assert err.max() <= 1e-9, (l, err.max())
    # the way back carries levels, clock and the snapped centre
    cfgd, Ps, t, step, last_dt = convert.hierarchy_to_reference(hier)
    assert cfgd["nlevels"] == 2 and cfgd["ng_centre"] == ref.centre
    assert (t, step, last_dt) == (hier.t, 4, 1.0e-3) and len(Ps) == 2


@pytest.mark.parametrize("layout", ["2d-centred"])
def test_fast_corrector_matches_reference_interpret(layout):
    """``kernels="auto"``: every sweep through the fused wrappers (their
    plain versions on the CPU) and the BC89 / leaf-boundary planes from
    ``interface_flux_pair``, against the JAX package with its Pallas kernels
    in interpret mode, float32, at the tolerance the JAX package's own test
    of that path uses (rtol 2e-5, atol 1e-6 of the largest value); and
    against the port's own ``kernels="off"`` path."""
    ref, hier, states = hier_pair(layout, seed=6, dtype="float32",
                                  pallas="interpret")
    assert hier.cfg0.kernels == "auto" and hier.P[0].dtype == torch.float32
    off = convert.hierarchy_from_reference(
        dataclasses.asdict(ref_cfg(layout, dtype="float32")), states,
        device="cpu")
    assert off.cfg0.kernels == "off"
    for _ in range(3):
        ref.step(1.0e-3)
        hier.step(1.0e-3)
        off.step(1.0e-3)
    for l in range(2):
        want = np.asarray(ref.P[l])
        assert np.all(np.isfinite(hier.P[l].numpy()))
        close(hier.P[l], want, 2e-5, 1e-6 * np.abs(want).max())
        close(hier.P[l], off.P[l].numpy(), 2e-5, 1e-6 * np.abs(want).max())


@pytest.mark.parametrize("layout", ["2d-corner", "3d-offcentre"])
def test_fast_corrector_float64_is_the_plain_path(layout):
    """At float64 the fast corrector (fused dU + slab faces) and the plain
    sweep with its own faces agree to rounding after three steps, BC89
    included: the slabs give the sweep's faces bit for bit."""
    rcfg = ref_cfg(layout)
    states = level_states(rcfg, 2, 7)
    fields = dataclasses.asdict(rcfg)
    off = convert.hierarchy_from_reference(fields, states, device="cpu")
    auto = convert.hierarchy_from_reference(dict(fields, pallas="auto"),
                                            states, device="cpu")
    assert (off.cfg0.kernels, auto.cfg0.kernels) == ("off", "auto")
    for _ in range(3):
        off.step()
        auto.step()
    assert auto.t == pytest.approx(off.t, rel=1e-13)
    for l in range(2):
        want = off.P[l].numpy()
        err = np.abs(auto.P[l].numpy() - want) / scales(want)
        assert err.max() <= 1e-12, (l, err.max())


def test_run_counts_steps_and_stops_at_tmax():
    rcfg = ref_cfg("2d-centred")
    states = level_states(rcfg, 2, 8)
    hier = convert.hierarchy_from_reference(dataclasses.asdict(rcfg), states,
                                            device="cpu")
    hier.run(max_steps=2)
    assert hier.step_count == 2 and hier.t > 0
    t_end = hier.t + 0.5 * hier.last_dt
    hier.run(tmax=t_end)
    assert hier.step_count == 3 and hier.t == pytest.approx(t_end, rel=1e-12)
    # the covered coarse cells are the restriction of the fine level
    back = hier._restrict(hier.P[0], hier.P[1], 1)
    assert torch.equal(back, hier.P[0])
