"""Snapshots cross between the two packages: a file written by either loads
in the other bit for bit, in both on-disk formats, for one grid and for a
2-level hierarchy, and a run restarted in the other package steps to the
same state."""
import dataclasses
import json
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu import native as ref_native
from pion_tpu.io import snapshot as ref_snapshot
from pion_tpu.ics.blast import blast_wave as ref_blast_wave
from pion_tpu.ng import NGHierarchy as RefHierarchy

from pion_tpu_torch import NGHierarchy, Simulation, convert
from pion_tpu_torch.io import (AsyncSnapshotWriter, load_snapshot,
                               load_snapshot_raw, save_snapshot)

torch.set_num_threads(1)


def ref_cfg(nlevels=1, dtype="float64", **kw):
    base = dict(ndim=2, eqn="glm", solver="hlld", ntracer=1, shape=(16, 16),
                xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                bcs=(("outflow", "outflow"), ("reflecting", "outflow")),
                cfl=0.3, ooa=2, av="falle", etav=0.1, dtype=dtype,
                nlevels=nlevels, tmax=1.0, pallas="off")
    base.update(kw)
    return pion_tpu.SimConfig(**base)


def states_for(rcfg, seed):
    rng = np.random.default_rng(seed)
    ref = RefHierarchy(rcfg, rcfg.nlevels)
    out = []
    for c in ref.cfgs:
        P = ref_blast_wave(c, B0=(0.1, 0.05, 0.02))
        P[2:5] += 0.05 * rng.standard_normal((3,) + c.shape)
        P[9] = rng.random(c.shape)
        out.append(P.astype(rcfg.np_dtype))
    return out


def same_config(cfg, rcfg):
    mine = convert.config_to_reference(cfg)
    theirs = json.loads(ref_snapshot._cfg_to_json(rcfg))
    for k, v in theirs.items():
        got = json.loads(json.dumps(mine[k]))
        if k == "pallas":
            assert got == ("off" if v == "off" else "auto")
        else:
            assert got == v, k


@pytest.mark.parametrize("suffix", [".snap", ".npz"])
@pytest.mark.parametrize("nlevels,dtype", [(1, "float64"), (2, "float32")])
def test_reference_snapshot_loads_in_the_port(tmp_path, monkeypatch, suffix,
                                              nlevels, dtype):
    rcfg = ref_cfg(nlevels, dtype)
    P = np.stack(states_for(rcfg, 1)) if nlevels > 1 else states_for(rcfg, 1)[0]
    if suffix == ".npz":
        # the JAX package writes .npz when its native library is missing
        monkeypatch.setattr(ref_native, "compress", lambda *a, **k: None)
    extra = {"params": {"EP_chemistry": "1", "list": [1, 2.5]}}
    path = ref_snapshot.save_snapshot(str(tmp_path / "ref"), P, rcfg, 0.125,
                                      7, extra=extra)
    assert path.endswith(suffix)
    cfg, got, t, step, got_extra = load_snapshot_raw(path)
    assert got.dtype == P.dtype and np.array_equal(got, P)
    assert (t, step, got_extra) == (0.125, 7, extra)
    same_config(cfg, rcfg)
    # the suffix may be left out, and the short loader drops the extras
    assert np.array_equal(load_snapshot(str(tmp_path / "ref"))[1], P)


@pytest.mark.parametrize("suffix", [".snap", ".npz"])
@pytest.mark.parametrize("nlevels,dtype", [(1, "float32"), (2, "float64")])
def test_port_snapshot_loads_in_the_reference(tmp_path, suffix, nlevels,
                                              dtype):
    rcfg = ref_cfg(nlevels, dtype, pallas="auto")
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    P = np.stack(states_for(rcfg, 2)) if nlevels > 1 else states_for(rcfg, 2)[0]
    name = str(tmp_path / "port") + (suffix if suffix == ".npz" else "")
    path = save_snapshot(name, torch.from_numpy(P), cfg, 3.5, 11,
                         extra={"params": {"a": "b"}})
    assert path.endswith(suffix)
    rc, got, t, step, extra = ref_snapshot.load_snapshot_raw(path)
    assert got.dtype == P.dtype and np.array_equal(got, P)
    assert (t, step, extra) == (3.5, 11, {"params": {"a": "b"}})
    assert rc == rcfg
    # and back into the port
    cfg2, got2, *_ = load_snapshot_raw(path)
    assert cfg2 == cfg and np.array_equal(got2, P)


def test_snap_payload_is_the_chunked_deflate_layout(tmp_path):
    """More than one 4 MiB chunk: the chunk table, each chunk a zlib stream,
    readable by the JAX package's native library; a file cut short or with a
    wrong shape is refused."""
    rng = np.random.default_rng(4)
    rcfg = ref_cfg(1, "float64", shape=(256, 256))
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    P = rng.standard_normal((cfg.nvar,) + cfg.shape)     # 5 MiB
    path = save_snapshot(str(tmp_path / "big"), P, cfg, 0.0)
    with open(path, "rb") as f:
        assert f.read(8) == b"PTSNAP2\x00"
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
        blob = f.read()
    n_chunks, chunk = np.frombuffer(blob, "<i8", 2)
    assert (n_chunks, chunk) == (2, 4 << 20) and header["shape"] == list(P.shape)
    sizes = np.frombuffer(blob, "<i8", 2, offset=16)
    assert 32 + sizes.sum() == len(blob)
    raw = ref_native.decompress(blob, P.nbytes)
    if raw is not None:     # the native library is there
        assert np.array_equal(raw.view(np.float64).reshape(P.shape), P)
    assert np.array_equal(ref_snapshot.load_snapshot(path)[1], P)
    assert np.array_equal(load_snapshot(path)[1], P)
    with open(path, "wb") as f:
        f.write(b"PTSNAP2\x00" + hlen.to_bytes(8, "little")
                + json.dumps(header).encode() + blob[:-100])
    with pytest.raises((IOError, zlib.error)):
        load_snapshot(path)
    with pytest.raises(ValueError, match="does not match the config"):
        save_snapshot(str(tmp_path / "bad"), P[:, :8], cfg, 0.0)


def test_async_writer_round_trip(tmp_path):
    rcfg = ref_cfg(1)
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    P = torch.from_numpy(states_for(rcfg, 5)[0])
    w = AsyncSnapshotWriter()
    kept = []
    for i in range(4):
        kept.append(P.clone())
        w.submit(str(tmp_path / f"a{i}"), P, cfg, float(i), i)
        P += 1.0          # the caller may overwrite its state at once
    w.wait()
    for i in range(4):
        _, got, t, step = load_snapshot(str(tmp_path / f"a{i}"))
        assert (t, step) == (float(i), i)
        assert np.array_equal(got, kept[i].numpy())
    # an error in the worker comes up at the next call
    w.submit(str(tmp_path / "nodir" / "x"), P, cfg, 0.0, 0)
    with pytest.raises(OSError):
        w.wait()
    w.close()
    assert not w._thread.is_alive()


def step_ref(obj, n):
    for _ in range(n):
        obj.step()
    return obj


def test_hierarchy_restarts_in_the_other_package(tmp_path):
    """Three steps, save, restart in the other package, three more: the same
    state as the run that went on (1e-9), both ways."""
    rcfg = ref_cfg(2, ng_centre=(0.25, 0.5))
    states = states_for(rcfg, 6)
    ref = RefHierarchy(rcfg)
    ref.set_states([jnp.asarray(s) for s in states])
    hier = convert.hierarchy_from_reference(dataclasses.asdict(rcfg), states,
                                            device="cpu")
    step_ref(ref, 3)
    step_ref(hier, 3)
    ref_path = ref.save(str(tmp_path / "from_ref"))
    port_path = hier.save(str(tmp_path / "from_port"))
    step_ref(ref, 3)
    step_ref(hier, 3)

    in_port = NGHierarchy.restart(ref_path, device="cpu")
    assert (in_port.n_levels, in_port.step_count) == (2, 3)
    assert in_port.centre == ref.centre and in_port.cfg0.kernels == "off"
    step_ref(in_port, 3)
    in_ref = step_ref(RefHierarchy.restart(port_path), 3)
    assert in_ref.step_count == in_port.step_count == 6
    for l in range(2):
        want = np.asarray(ref.P[l])
        sc = np.abs(want).max()
        assert np.abs(in_port.P[l].numpy() - want).max() <= 1e-9 * sc
        assert np.abs(np.asarray(in_ref.P[l]) - want).max() <= 1e-9 * sc
        assert np.abs(hier.P[l].numpy() - want).max() <= 1e-9 * sc
    assert in_port.t == pytest.approx(ref.t, rel=1e-12)


def test_hierarchy_snapshot_restart_bitwise(tmp_path):
    """save -> restart -> identical continuation within the port (every
    snapshot is a full multi-level restart file), with the output policy of
    ``run``: a snapshot every two steps and the final one."""
    rcfg = ref_cfg(2)
    states = states_for(rcfg, 7)
    hier = convert.hierarchy_from_reference(dataclasses.asdict(rcfg), states,
                                            device="cpu")
    hier.outfile = str(tmp_path / "ng")
    hier.opfreq = 2
    hier.checkpoint_freq = 3
    hier.run(max_steps=3)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ng.00000002.snap", "ng.00000003.snap", "ng.999999.snap"]
    path = str(tmp_path / "ng.00000003")
    step_ref(hier, 3)
    h2 = NGHierarchy.restart(path, device="cpu")
    assert h2.n_levels == 2 and h2.step_count == 3
    step_ref(h2, 3)
    first = NGHierarchy.restart(str(tmp_path / "ng.00000002"), device="cpu")
    assert first.step_count == 2
    for l in range(2):
        assert torch.equal(hier.P[l], h2.P[l])
    # a header with a parameter section and no physics given: not ported
    hier.params = {"EP_chemistry": "1"}
    with pytest.raises(NotImplementedError, match="item 17"):
        NGHierarchy.restart(hier.save(str(tmp_path / "withparams")),
                            device="cpu")


def test_simulation_output_policy_and_restart(tmp_path):
    """``Simulation`` with an output file: timed snapshots land on their
    cadence, the final one is written, and a restart continues bit for bit;
    the JAX package restarts from the same file to 1e-9."""
    rcfg = ref_cfg(1)
    P0 = states_for(rcfg, 8)[0]
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    sim = Simulation(cfg, P0.copy(), device="cpu",
                     outfile=str(tmp_path / "run"), opfreq_time=2.0e-3)
    sim.run(tmax=5.0e-3)
    snaps = sorted(p.name for p in tmp_path.iterdir())
    times = [load_snapshot(str(tmp_path / n))[2] for n in snaps]
    assert len(snaps) == 3
    np.testing.assert_allclose(times, [2.0e-3, 4.0e-3, 5.0e-3], rtol=1e-12)
    mid = str(tmp_path / snaps[0])
    a = Simulation.restart(mid, device="cpu")
    a.run(tmax=5.0e-3)
    b = pion_tpu.Simulation.restart(mid)
    b.run(tmax=5.0e-3)
    assert a.step_count == b.step_count
    np.testing.assert_allclose(a.P.numpy(), np.asarray(b.P), rtol=1e-9,
                               atol=1e-12)
    assert a.t == pytest.approx(5.0e-3, rel=1e-12)
