"""Design-point dataset builder for predictor training.

A design point = (arch, shape, chip, freq, mesh).  Ground-truth labels come
from the slow-accurate path (compiled dry-run -> HxA -> cost model); to keep
the sweep tractable on one CPU the HxA census of a compiled (arch, shape,
mesh) cell is CACHED and re-simulated across the DVFS/chip sweep — exactly
how the paper reuses one profiled workload across frequencies (Fig. 2: the
same three CNNs at 397-1590 MHz).

The resulting (X, y_power, y_cycles) arrays feed predictors.kfold_evaluate —
the paper's Figs. 2-3 experiment.

Counterpart of ``repro.core.dataset``: the labels come from this package's
scalar ``costmodel.simulate`` (python floats on the host), the features
from ``features.extract``, so the matrix ``X`` is bitwise the reference's
and the labels agree to the last bits (the scalar path cubes as ``x*x*x``
where the reference calls ``pow``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import costmodel, dse, features
from repro_torch.hw import (CHIPS, frequency_sweep, get_chip,
                            mesh_factorizations)


@dataclasses.dataclass
class DesignPoint:
    arch: str
    shape: str
    chip: str
    freq_mhz: float
    mesh: Tuple[int, ...] = (16, 16)

    @property
    def n_chips(self) -> int:
        n = 1
        for d in self.mesh:
            n *= d
        return n


def load_dryrun_artifacts(art_dir: str) -> Dict[Tuple[str, str, str], dict]:
    """(arch, shape, pod-tag) -> artifact json."""
    out = {}
    if not os.path.isdir(art_dir):
        return out
    for fn in os.listdir(art_dir):
        if not fn.endswith(".json") or "__" not in fn:
            continue
        parts = fn[:-5].split("__")
        if len(parts) != 3:
            continue  # hillclimb variants carry a 4th tag; baselines only
        arch, shape, pod = parts
        try:
            with open(os.path.join(art_dir, fn)) as f:
                out[(arch, shape, pod)] = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
    return out


def build_dataset(art_dir: str, chips: Optional[List[str]] = None,
                  freq_points: int = 8, pod: str = "pod1",
                  mesh_counts: Tuple[int, ...] = (16, 64, 256),
                  mesh_freq_points: int = 4):
    """Sweep cached cells x chips x frequencies x meshes ->
    (X, y_power, y_cycles, meta).

    Labels: the calibrated simulator on the REAL compiled census (slow path),
    topology-aware — each design point's mesh prices its own collective
    time.  Features: static config/hardware numerics only (fast path inputs).
    Beyond the base-mesh DVFS sweep, ``mesh_counts`` adds a coarser
    (``mesh_freq_points``) sweep over every 2D mesh factorization of each
    count, rescaling the census first-order (``dse._scale_analysis``) — the
    coverage the predictors need now that the factorization axis carries
    signal in the DSE space.  Edge-class chips (``ici_bw == 0``) are swept
    at their only valid design point (1 chip, 1x1 mesh) instead of the base
    mesh, so the fast path stops extrapolating blindly into the edge region
    of the space.  Pass ``mesh_counts=()`` for a base-mesh-only dataset.

    The base mesh is the artifact's own (``art["mesh"]``, as the
    reference's ``reanalyze`` reads it): ``16x16`` / ``2x16x16`` for the
    reference's ``pod1`` / ``pod2`` artifacts (so their datasets stay
    bitwise the reference's), ``1x1`` at 1 chip for the port's ``card1``
    census (``launch.dryrun``); an artifact without ``"mesh"`` takes the
    reference's mesh of its pod tag.  With ``pod="card1"`` and
    ``mesh_counts=()`` this is the paper's own Fig. 2 setting: one
    accelerator swept over DVFS.  A ``card1`` census has no collective
    bytes, so ``dse._scale_analysis`` prices larger meshes from it with no
    collective time: the collective half of the census waits for ROADMAP.md
    Queue 1 item 12e (a census on more than one device).
    """
    chips = chips if chips is not None else list(CHIPS)
    arts = load_dryrun_artifacts(art_dir)
    X, y_power, y_cycles, meta = [], [], [], []

    def add_point(cfg, shape, names, chip, count, mesh, f, ana):
        res = costmodel.simulate(ana, chip, count, freq_mhz=f, mesh=mesh)
        X.append(features.extract(cfg, shape, chip, count,
                                  mesh_shape=mesh, freq_mhz=f))
        y_power.append(res.power_w)
        y_cycles.append(res.cycles)
        meta.append(DesignPoint(names[0], names[1], chip.name, f, mesh))

    for (arch, shape_name, pod_tag), art in sorted(arts.items()):
        if pod_tag != pod:
            continue
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        n_chips = art["roofline"]["n_chips"]
        analysis = {"flops": art["hxa"]["flops"],
                    "hbm_bytes": art["hxa"]["hbm_bytes"],
                    "collective_bytes": art["hxa"]["collective_bytes"],
                    "wire_bytes": art["hxa"]["wire_bytes"]}
        mesh_shape = (tuple(int(d) for d in art["mesh"].split("x"))
                      if "mesh" in art
                      else (2, 16, 16) if pod == "pod2" else (16, 16))
        for chip_name in chips:
            chip = get_chip(chip_name)
            if chip.ici_bw == 0:
                ana1 = dse._scale_analysis(
                    analysis, n_chips, dse.Candidate(chip_name, 1, (1, 1), 0.0))
                for f in frequency_sweep(chip_name, freq_points):
                    add_point(cfg, shape, (arch, shape_name), chip, 1,
                              (1, 1), f, ana1)
                continue
            for f in frequency_sweep(chip_name, freq_points):
                add_point(cfg, shape, (arch, shape_name), chip, n_chips,
                          mesh_shape, f, analysis)
            for count in mesh_counts:
                for mesh in mesh_factorizations(count, 2):
                    cand0 = dse.Candidate(chip_name, count, mesh, 0.0)
                    ana = dse._scale_analysis(analysis, n_chips, cand0)
                    for f in frequency_sweep(chip_name, mesh_freq_points):
                        add_point(cfg, shape, (arch, shape_name), chip,
                                  count, mesh, f, ana)
    return (np.asarray(X, np.float32), np.asarray(y_power, np.float64),
            np.asarray(y_cycles, np.float64), meta)
