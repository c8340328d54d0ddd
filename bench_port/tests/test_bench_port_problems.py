"""The inputs and the least sweep time of the existing cells, pinned to the
values the harness gave before a configuration could name its own reference
and builder; the physics of a file without a chemistry; the roofline's
counts of a reference with constants of its own and of a cylindrical grid."""
import enum
import hashlib
from types import SimpleNamespace

import pytest

from bench_port import harness, problems, roofline
from bench_port.reference import port_plain
from conftest import tiny_cell

# SHA-256 of a cell's level states at the size of ``tiny_cell``, by seed
PINNED_INPUTS = {
    ("ostar3d.front", 0):
        "9b60e80cdbb7073b59f48b0aaf5d59b86cdcee281ef62ae3062515dca828ab57",
    ("ostar3d.front", 1):
        "6a3ab830fcd93b2cff25e5989be9c2f00e1ed4d4b3016ffae8c87273a037e9ff",
    ("blast3d.replay", 0):
        "deb1f25ded9ca6667f04c835f2ab24b7d796b440132d63f83a2213411f4c12fe",
    ("blast3d.replay", 1):
        "b52451ce54db4159fa0595bd33609e4a2754fca0e532aab111d65736f07d87ac",
}
# roofline.least_s of a step's sweep launches at the full size, seconds
PINNED_LEAST_S = {"ostar3d.front": 0.0022314156179104477,
                  "blast3d.replay": 0.004981507988059701}


@pytest.mark.parametrize("name,seed", sorted(PINNED_INPUTS))
def test_inputs_are_pinned(name, seed):
    cell = tiny_cell(name)
    h = hashlib.sha256()
    for P in problems.initial_states(cell["config"], cell["traffic"], seed):
        h.update(P.tobytes())
    assert h.hexdigest() == PINNED_INPUTS[(name, seed)]


@pytest.mark.parametrize("name", sorted(PINNED_LEAST_S))
def test_least_time_is_pinned(root, name):
    config = harness.cell_of(root, name)["config"]
    least = roofline.least_s(roofline.sweep_launches(config),
                             config["sim"]["dtype"])
    assert least == PINNED_LEAST_S[name]


def test_existing_cells_take_the_default_reference(root):
    for w in harness.bench_file(root)["workloads"]:
        config = harness.cell_of(root, w["name"])["config"]
        assert problems.reference_of(config) is port_plain
        assert problems.builder_of(config) is None


def test_winds_without_chemistry_keep_their_winds():
    config = dict(tiny_cell("ostar3d.front", n=8)["config"])
    del config["chemistry"], config["sources"]
    cfg = problems.sim_config(port_plain, config, "off")
    phys = problems._physics(port_plain, config, cfg)
    assert phys.mp is None and not phys.sources
    assert len(phys.wind_sources) == 1
    assert phys.wind_sources[0].vinf == config["winds"][0]["vinf"]


def test_sources_without_chemistry_raise():
    config = dict(tiny_cell("ostar3d.front", n=8)["config"])
    del config["chemistry"]
    cfg = problems.sim_config(port_plain, config, "off")
    with pytest.raises(ValueError, match="chemistry"):
        problems._physics(port_plain, config, cfg)


def test_no_physics_without_chemistry_sources_or_winds(root):
    config = harness.cell_of(root, "blast3d.replay")["config"]
    cfg = problems.sim_config(port_plain, config, "off")
    assert problems._physics(port_plain, config, cfg) is None


def foreign(cfg):
    """``cfg`` as a reference with constants of its own has it: each
    enumeration a member of another class of the same values."""
    def like(member):
        cls = enum.Enum(type(member).__name__,
                        {m.name: m.value for m in type(member)})
        return cls(member.value)

    eqn = SimpleNamespace(value=cfg.eqn.value, is_mhd=cfg.eqn.is_mhd,
                          nbase=cfg.eqn.nbase)
    return SimpleNamespace(
        eqn=eqn, solver=like(cfg.solver), av=like(cfg.av),
        coords=like(cfg.coords), **{k: getattr(cfg, k) for k in (
            "dtype", "shape", "ng", "nvar", "ndim", "ntracer",
            "hlld_fallback")})


@pytest.mark.parametrize("solver", ["hlld", "hll"])
def test_roofline_compares_by_value(root, solver):
    config = harness.cell_of(root, "blast3d.replay")["config"]
    config = dict(config, sim=dict(config["sim"], solver=solver))
    cfg = problems.sim_config(port_plain, config, "off")
    other = foreign(cfg)
    assert other.solver != cfg.solver and other.av != cfg.av
    for axis in range(3):
        for order in (1, 2):
            for final in (False, True):
                assert (roofline._launch(other, axis, order, final)
                        == roofline._launch(cfg, axis, order, final))


def test_radial_axis_reads_the_geometry_pack():
    sim = {"ndim": 2, "eqn": "glm", "solver": "hlld", "ntracer": 1,
           "shape": [64, 128], "xmin": [0.0, -1.0], "xmax": [1.0, 1.0],
           "bcs": [["outflow", "outflow"], ["outflow", "outflow"]],
           "cfl": 0.3, "ooa": 2, "av": "falle", "etav": 0.1,
           "dtype": "float32", "tmax": 1.0}
    cart = roofline.sweep_launches({"sim": sim})
    cyl = roofline.sweep_launches({"sim": dict(
        sim, coords="cylindrical",
        bcs=[["axisymmetric", "outflow"], ["outflow", "outflow"]])})
    pack = roofline.GEO_ROWS * (64 + 4) * 4
    # one grid: B1 on axis 1, then B2 on axis 0, at each order
    assert [c[0] - a[0] for a, c in zip(cart, cyl)] == [0, pack, 0, pack]
    assert [c[1] for c in cyl] == [a[1] for a in cart]
