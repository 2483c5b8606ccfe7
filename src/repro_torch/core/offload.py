"""Offloading analyzer — the paper's §IV future work (the reference's
``core/offload.py``).

"devise approaches to discern whether offloading would adhere to the
constraints or if executing locally would be more advantageous" — given an
edge device, a cloud slice, and a network (bandwidth, RTT), decide where an
inference request should run, for latency or energy.

Energy accounting on the edge device includes radio transmit/receive power;
cloud energy is booked separately (operator view) so both the
battery-centric and the total-energy decisions are reported.

``analyze`` prices both sides with the scalar ``costmodel.simulate`` (host
floats); ``sweep_bandwidth`` is tensor code on ``device`` (the card by
default): the bandwidth array and the two-row ``simulate_batch`` live
there, in float64, and the arithmetic keeps the reference's association,
so a sweep on the card equals one on the CPU bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import costmodel
from repro_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from repro_torch.hw import chip_index, get_chip


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    bandwidth_bps: float = 100e6       # uplink
    downlink_bps: float = 300e6
    rtt_s: float = 0.04
    tx_power_w: float = 1.2            # radio while transmitting
    rx_power_w: float = 0.8


@dataclasses.dataclass(frozen=True)
class OffloadDecision:
    local_latency_s: float
    remote_latency_s: float
    local_energy_j: float              # edge-battery energy
    remote_edge_energy_j: float        # edge-battery energy when offloading
    remote_total_energy_j: float       # + cloud slice energy
    choose_remote_latency: bool
    choose_remote_battery: bool

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(local_analysis: Dict, remote_analysis: Dict,
            request_bytes: float, response_bytes: float,
            net: NetworkSpec = NetworkSpec(),
            local_chip: str = "tpu-edge", remote_chip: str = "tpu-v5e",
            remote_chips: int = 4) -> OffloadDecision:
    """local/remote_analysis: censuses of the SAME workload for each target
    (per-device)."""
    local = costmodel.simulate(local_analysis, get_chip(local_chip), 1)
    remote = costmodel.simulate(remote_analysis, get_chip(remote_chip),
                                remote_chips)

    t_net = (request_bytes / net.bandwidth_bps
             + response_bytes / net.downlink_bps + net.rtt_s)
    remote_latency = remote.latency_s + t_net
    e_radio = (request_bytes / net.bandwidth_bps) * net.tx_power_w \
        + (response_bytes / net.downlink_bps) * net.rx_power_w
    idle_during_wait = get_chip(local_chip).idle_watts * remote_latency
    remote_edge_energy = e_radio + idle_during_wait
    return OffloadDecision(
        local_latency_s=local.latency_s,
        remote_latency_s=remote_latency,
        local_energy_j=local.energy_j,
        remote_edge_energy_j=remote_edge_energy,
        remote_total_energy_j=remote_edge_energy + remote.energy_j,
        choose_remote_latency=remote_latency < local.latency_s,
        choose_remote_battery=remote_edge_energy < local.energy_j,
    )


def sweep_bandwidth(local_analysis: Dict, remote_analysis: Dict,
                    request_bytes: float, response_bytes: float,
                    bandwidths_bps, net: NetworkSpec = NetworkSpec(),
                    local_chip: str = "tpu-edge", remote_chip: str = "tpu-v5e",
                    remote_chips: int = 4,
                    device: DeviceLike = DEFAULT_DEVICE
                    ) -> Dict[str, torch.Tensor]:
    """``analyze`` over a whole uplink-bandwidth array in one batched pass,
    on ``device``.

    Both compute censuses are simulated once via ``simulate_batch`` (a
    two-row batch); the network leg is elementwise over ``bandwidths_bps``.
    Returns float64 (decisions: bool) tensors on ``device`` keyed like
    ``OffloadDecision`` fields plus ``bandwidth_bps``.
    """
    dev = resolve_device(device)
    bw = torch.as_tensor(bandwidths_bps, dtype=torch.float64).to(dev)
    wire = costmodel.wire_bytes
    sim = costmodel.simulate_batch(
        {"flops": [local_analysis["flops"], remote_analysis["flops"]],
         "hbm_bytes": [local_analysis["hbm_bytes"],
                       remote_analysis["hbm_bytes"]],
         "wire_bytes": [wire(local_analysis), wire(remote_analysis)]},
        [chip_index(local_chip), chip_index(remote_chip)], [1, remote_chips],
        dtype=torch.float64, device=dev)
    # a tensor numerator: ``float / tensor`` is a reciprocal times the
    # float in PyTorch, not the correctly rounded quotient numpy takes
    t_up = torch.as_tensor(request_bytes, dtype=torch.float64,
                           device=dev) / bw
    t_down = response_bytes / net.downlink_bps
    remote_latency = sim.latency_s[1] + t_up + t_down + net.rtt_s
    e_radio = t_up * net.tx_power_w + t_down * net.rx_power_w
    remote_edge_energy = e_radio + get_chip(local_chip).idle_watts \
        * remote_latency
    ones = torch.ones_like(bw)
    return {
        "bandwidth_bps": bw,
        "local_latency_s": sim.latency_s[0] * ones,
        "remote_latency_s": remote_latency,
        "local_energy_j": sim.energy_j[0] * ones,
        "remote_edge_energy_j": remote_edge_energy,
        "remote_total_energy_j": remote_edge_energy + sim.energy_j[1],
        "choose_remote_latency": remote_latency < sim.latency_s[0],
        "choose_remote_battery": remote_edge_energy < sim.energy_j[0],
    }
