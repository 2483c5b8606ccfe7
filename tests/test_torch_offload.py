"""The port's offloading analyzer (``core/offload.py``) against the
reference's, on the CPU.

``analyze`` and ``sweep_bandwidth`` (``device="cpu"``) are held BITWISE
(float64) against the reference on the inputs of ``tests/test_dse.py``'s
``test_offload_sweep_matches_analyze`` and ``tests/test_system.py``'s
``test_offload_decision_flips_with_bandwidth``, and on a census-sized pair
over 4,096 bandwidths.  The sweep against ``analyze`` point by point: within
1e-15 relative (the network leg is summed in another order in the two, as
in the reference, whose own test allows 1e-9), decisions equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import offload as roff
from repro_torch.core import offload

LOCAL = {"flops": 2e12, "hbm_bytes": 2e10, "collective_bytes": 0.0,
         "wire_bytes": 0.0}
REMOTE = {"flops": 1.2e11, "hbm_bytes": 1.5e9, "collective_bytes": 2e7,
          "wire_bytes": 2e7}
CENSUS = {"flops": 6.4e15, "hbm_bytes": 2.9e13, "collective_bytes": 0.0,
          "wire_bytes": 0.0}
SWEEP_TOL = 1e-15
FIELDS = ("local_latency_s", "remote_latency_s", "local_energy_j",
          "remote_edge_energy_j", "remote_total_energy_j")
CASES = {"dse": (LOCAL, REMOTE, 1.2e7, 3.2e4, np.array([1e6, 5e7, 1e9])),
         "census": (CENSUS, CENSUS, 16384.0, 401408.0,
                    np.geomspace(1e5, 1e10, 4096))}


@pytest.mark.parametrize("bw", [1e6, 5e7, 1e8, 1e9])
@pytest.mark.parametrize("remote_chips", [1, 4, 16])
def test_analyze_bitwise_reference(bw, remote_chips):
    kw = dict(remote_chips=remote_chips)
    got = offload.analyze(LOCAL, REMOTE, 1.2e7, 3.2e4,
                          offload.NetworkSpec(bandwidth_bps=bw), **kw)
    want = roff.analyze(LOCAL, REMOTE, 1.2e7, 3.2e4,
                        roff.NetworkSpec(bandwidth_bps=bw), **kw)
    assert got.as_dict() == want.as_dict()


def test_decision_flips_with_bandwidth():
    """``tests/test_system.py``'s case: the cloud wins once the uplink
    clears."""
    slow = offload.analyze(LOCAL, REMOTE, 1.2e7, 3.2e4,
                           offload.NetworkSpec(bandwidth_bps=1e6))
    fast = offload.analyze(LOCAL, REMOTE, 1.2e7, 3.2e4,
                           offload.NetworkSpec(bandwidth_bps=1e9))
    assert not slow.choose_remote_latency and fast.choose_remote_latency
    assert dataclasses.asdict(offload.NetworkSpec()) == dataclasses.asdict(
        roff.NetworkSpec())


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_bitwise_reference(case):
    local, remote, req, resp, bws = CASES[case]
    got = offload.sweep_bandwidth(local, remote, req, resp, bws,
                                  device="cpu")
    want = roff.sweep_bandwidth(local, remote, req, resp, bws)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
        assert got[k].dtype == (torch.bool if np.asarray(v).dtype == bool
                                else torch.float64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_matches_analyze(case):
    local, remote, req, resp, bws = CASES[case]
    sweep = offload.sweep_bandwidth(local, remote, req, resp, bws,
                                    device="cpu")
    for i in np.linspace(0, len(bws) - 1, min(8, len(bws))).astype(int):
        one = offload.analyze(local, remote, req, resp, offload.NetworkSpec(
            bandwidth_bps=float(bws[i])))
        for f in FIELDS:
            got, want = sweep[f][i].item(), getattr(one, f)
            assert abs(got - want) <= SWEEP_TOL * abs(want), f
        assert bool(sweep["choose_remote_latency"][i]) == \
            one.choose_remote_latency
        assert bool(sweep["choose_remote_battery"][i]) == \
            one.choose_remote_battery


def test_sweep_default_device_is_the_card():
    """No quiet landing on the CPU: the default device is ``"cuda"``, which
    raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        offload.sweep_bandwidth(LOCAL, REMOTE, 1.2e7, 3.2e4, [1e6])
