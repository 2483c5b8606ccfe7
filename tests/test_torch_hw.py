"""Port parity: ``repro_torch.hw`` against the reference ``repro.hw`` — the
chip registry and table bitwise, the link model, mesh factorizations and
the DVFS lattice on the same inputs."""

import dataclasses

import numpy as np
import pytest
import torch

from repro import hw as ref_hw
from repro_torch import hw as port_hw
from repro_torch.device import resolve_device, resolve_dtype


def test_registry_specs_equal():
    assert tuple(port_hw.CHIPS) == tuple(ref_hw.CHIPS)
    for name, spec in ref_hw.CHIPS.items():
        assert dataclasses.asdict(port_hw.CHIPS[name]) == \
            dataclasses.asdict(spec)
    assert port_hw.DEFAULT_CHIP == ref_hw.DEFAULT_CHIP


@pytest.mark.parametrize("field", ref_hw._TABLE_FIELDS)
def test_chip_table_columns_bitwise(field):
    a = getattr(ref_hw.CHIP_TABLE, field)
    b = getattr(port_hw.CHIP_TABLE, field)
    assert b.dtype == np.float64
    assert a.tobytes() == b.tobytes()


def test_chip_table_gather_and_indices():
    names = ["tpu-v4", "tpu-edge", "tpu-v5e", "tpu-v4"]
    ia = ref_hw.CHIP_TABLE.indices(names)
    ib = port_hw.CHIP_TABLE.indices(names)
    np.testing.assert_array_equal(ia, ib)
    ga, gb = ref_hw.CHIP_TABLE.gather(ia), port_hw.CHIP_TABLE.gather(ib)
    assert ga.keys() == gb.keys()
    for k in ga:
        np.testing.assert_array_equal(ga[k], gb[k])
    assert port_hw.chip_index("tpu-v5p") == ref_hw.chip_index("tpu-v5p")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_axis_link_counts_equal(dtype):
    rng = np.random.default_rng(3)
    n = 512
    pod = rng.choice([1, 2, 3, 4, 8], n)
    data = rng.choice([1, 2, 3, 4, 16, 32], n)
    model = rng.choice([1, 2, 3, 8, 64], n)
    links = rng.choice([0, 4, 6], n)
    per_axis = rng.choice([0, 1, 2], n)
    ref = ref_hw.axis_link_counts(pod, data, model, links, per_axis)
    t = lambda a: torch.as_tensor(a).to(dtype)
    got = port_hw.axis_link_counts(t(pod), t(data), t(model), t(links),
                                   t(per_axis))
    for r, g in zip(ref, got):
        assert g.dtype == dtype
        np.testing.assert_array_equal(r, g.numpy().astype(np.float64))


def test_axis_link_counts_scalars_and_topology():
    for chip in ("tpu-v5e", "tpu-v5p", "tpu-edge"):
        for mesh in [(4, 4), (2, 16, 16), (1, 1), (2, 2), (8,), (2, 3, 4, 5)]:
            a = ref_hw.topology_for(ref_hw.CHIPS[chip], mesh)
            b = port_hw.topology_for(port_hw.CHIPS[chip], mesh)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.n_chips == b.n_chips


@pytest.mark.parametrize("dims", [2, 3])
def test_mesh_factorizations_equal(dims):
    for n in (1, 2, 4, 12, 64, 96, 256, 1024):
        assert port_hw.mesh_factorizations(n, dims) == \
            ref_hw.mesh_factorizations(n, dims)
    with pytest.raises(ValueError):
        port_hw.mesh_factorizations(0)


def test_frequency_lattice_and_sweep_equal():
    for lo, hi, pts in [(400.0, 1600.0, 12), (250.0, 950.0, 320),
                        (500.0, 1750.0, 1), (400.0, 1050.0, 2)]:
        assert port_hw.frequency_lattice(lo, hi, pts) == \
            ref_hw.frequency_lattice(lo, hi, pts)
    for name in ref_hw.CHIPS:
        assert port_hw.frequency_sweep(name, 25) == \
            ref_hw.frequency_sweep(name, 25)


def test_normalize_mesh_equal():
    for mesh in [(8,), (4, 4), (2, 16, 16), (2, 3, 4, 5)]:
        assert port_hw.normalize_mesh(mesh) == ref_hw.normalize_mesh(mesh)
    with pytest.raises(ValueError):
        port_hw.normalize_mesh((0, 4))


def test_dynamic_power_within_an_ulp_of_reference():
    """The port cubes with x*x*x where the reference calls pow(); the two
    differ by at most a couple of ulp."""
    for name, spec in ref_hw.CHIPS.items():
        for f in ref_hw.frequency_sweep(name, 9):
            for u in (0.0, 0.3, 0.77, 1.0):
                a = spec.dynamic_power(f, u)
                b = port_hw.CHIPS[name].dynamic_power(f, u)
                assert b == pytest.approx(a, rel=1e-15)


def test_resolve_device_raises_without_cuda():
    """Asking for the card on a machine without one raises — it never lands
    on the CPU by itself.  (On a machine with a card this resolves.)"""
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device()            # the default is the card
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        resolve_dtype(torch.float16)
