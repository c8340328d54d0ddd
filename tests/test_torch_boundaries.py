"""pion_tpu_torch.boundaries against pion_tpu.boundaries: exact equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu import boundaries as ref_b

from pion_tpu_torch import boundaries as b

from test_torch_eqns import to_port

torch.set_num_threads(1)

KINDS = ["periodic", "outflow", "oneway_out", "reflecting", "jetreflect",
         "axisymmetric", "inflow", "fixed"]


def _case(ndim, bcs, seed=0):
    shape = (6, 5, 7)[-ndim:]
    rcfg = pion_tpu.SimConfig(ndim=ndim, eqn="glm", ntracer=1, shape=shape,
                              xmin=(0.0,) * ndim,
                              xmax=tuple(float(s) for s in shape), bcs=bcs)
    P = np.random.default_rng(seed).standard_normal((rcfg.nvar,) + shape)
    return rcfg, P


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_bcs_matches_reference(kind, ndim):
    rcfg, P = _case(ndim, ((kind, kind),) * ndim)
    rbd = ref_b.make_fixed_strips(P, rcfg)
    cfg, Pt, bd = to_port(rcfg, P, fixed=rbd.fixed)
    before = Pt.clone()
    out = b.apply_bcs(Pt, cfg, bd)
    ref = ref_b.apply_bcs(jnp.asarray(P), rcfg, rbd)
    assert out.shape == tuple(ref.shape)
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert torch.equal(Pt, before)        # the caller's state is untouched


@pytest.mark.parametrize("ndim", [2, 3])
def test_mixed_faces_and_corner_ghosts(ndim):
    """A different kind on every face: corner ghosts must come from the
    already padded slower axes."""
    faces = [("reflecting", "outflow"), ("oneway_out", "fixed"),
             ("inflow", "jetreflect")][-ndim:]
    rcfg, P = _case(ndim, tuple(faces), seed=1)
    rbd = ref_b.make_fixed_strips(P, rcfg)
    cfg, Pt, bd = to_port(rcfg, P, fixed=rbd.fixed)
    out = b.apply_bcs(Pt, cfg, bd)
    ref = ref_b.apply_bcs(jnp.asarray(P), rcfg, rbd)
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ndim", [2, 3])
def test_make_fixed_strips(ndim):
    faces = [("fixed", "inflow"), ("outflow", "fixed"),
             ("inflow", "inflow")][-ndim:]
    rcfg, P = _case(ndim, tuple(faces), seed=2)
    cfg, _, _ = to_port(rcfg, P)
    bd = b.make_fixed_strips(P, cfg)
    rbd = ref_b.make_fixed_strips(P, rcfg)
    assert set(bd.fixed) == set(rbd.fixed) and len(bd.fixed) > 0
    for key, strip in rbd.fixed.items():
        assert np.array_equal(bd.fixed[key], strip)
    assert hash(bd) == hash(b.BoundaryData(fixed=dict(rbd.fixed)))


def test_missing_strip_and_unported_kinds_raise():
    rcfg, P = _case(2, (("inflow", "outflow"), ("outflow", "outflow")))
    cfg, Pt, _ = to_port(rcfg, P)
    with pytest.raises(ValueError, match="BoundaryData.fixed"):
        b.apply_bcs(Pt, cfg, b.BoundaryData())
    for kind in ("dmach", "dmach2", "jet"):
        rcfg, P = _case(2, ((kind, kind), ("outflow", "outflow")))
        cfg, Pt, _ = to_port(rcfg, P)
        with pytest.raises(NotImplementedError):
            b.apply_bcs(Pt, cfg, b.BoundaryData())
