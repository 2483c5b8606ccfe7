"""The census of every ported (arch x shape) cell, written as dry-run
artifacts (the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell on 512 placeholder devices; the
port traces its own step on the meta device (no card, no memory) through
``lowering.lower_cell`` and writes one JSON artifact per cell,
``{arch}__{shape}__card1.json`` with ``"mesh": "1x1"`` and
``roofline.n_chips = 1``, under ``experiments/dryrun/`` (or
``REPRO_ART_DIR``): the schema ``core.dataset.load_dryrun_artifacts``,
``dataset.build_dataset`` and ``Campaign.from_artifacts`` read.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all      # 32 cells, 1 skipped

A mesh of more than one device (``--multi-pod``) is not ported: the
collective half of the census waits for ROADMAP.md Queue 1 item 12e
(``models/dist.py``, ``models/sharding.py``, ``launch/mesh.py``).
``--all`` names every cell it skips, with the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import time
from typing import Iterator, List, Optional, Tuple

from repro_torch.configs.base import ARCH_NAMES, SHAPES, get_config
from repro_torch.core import costmodel, hxa
from repro_torch.hw import get_chip
from repro_torch.launch.lowering import (HXA_KEYS, kernel_substitution,
                                         lower_cell)
from repro_torch.models import api

POD_TAG = "card1"
MESH = "1x1"


def art_dir() -> str:
    d = os.environ.get("REPRO_ART_DIR",
                       os.path.abspath(os.path.join(os.getcwd(), "experiments",
                                                    "dryrun")))
    os.makedirs(d, exist_ok=True)
    return d


def _multi_pod() -> None:
    raise NotImplementedError(
        "a census on more than one device (--multi-pod, the reference's "
        "pod1 / pod2 meshes) is not ported yet: see ROADMAP.md Queue 1 item "
        "12e (models/dist.py, models/sharding.py, launch/mesh.py)")


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             save: bool = True, overrides: Optional[dict] = None) -> dict:
    """The artifact of one cell, traced on the meta device and written to
    ``art_dir()`` when ``save``.  A census on the card is
    ``lowering.lower_cell(cfg, shape, device="cuda")``."""
    if multi_pod:
        _multi_pod()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.time()
    result = lower_cell(cfg, shape, overrides=overrides or {})
    result["wall_s"] = round(time.time() - t0, 2)
    result["arch"] = arch
    result["shape"] = shape_name
    result["mesh"] = MESH
    if save:
        tag = f"{arch}__{shape_name}__{POD_TAG}"
        if overrides:
            tag += "__" + "_".join(f"{k}-{v}"
                                   for k, v in sorted(overrides.items()))
        path = os.path.join(art_dir(), tag + ".json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        print(f"[dryrun] wrote {path}")
    return result


def reanalyze(tag: str) -> dict:
    """Rebuild a reference artifact from its stored HLO
    (``hlo/{tag}.hlo.gz``) with the port's ``hxa.analyze_hlo_text``,
    ``kernel_substitution`` and cost model, as the reference's
    ``reanalyze``; the artifact is rewritten in place."""
    path = os.path.join(art_dir(), tag + ".json")
    with open(path) as f:
        art = json.load(f)
    with gzip.open(os.path.join(art_dir(), "hlo", tag + ".hlo.gz"), "rt") as f:
        text = f.read()
    analysis = hxa.analyze_hlo_text(text)
    analysis["hbm_bytes_xla"] = analysis["hbm_bytes"]
    cfg_d = art["config"]
    cfg = get_config(art["arch"])
    over = {k: cfg_d[k] for k in ("attn_impl", "ssm_impl", "remat")
            if cfg_d.get(k) is not None}
    cfg = dataclasses.replace(cfg, **over)
    shape = SHAPES[art["shape"]]
    n_chips = art["roofline"]["n_chips"]
    subst = kernel_substitution(cfg, shape, n_chips, 16)
    saved = subst["attn_bytes_saved_pd"] + subst["ssm_bytes_saved_pd"]
    if saved:
        analysis["hbm_bytes"] = max(analysis["hbm_bytes"] - saved,
                                    analysis["hbm_bytes"] * 0.05)
    analysis["kernel_substitution"] = subst
    chip = get_chip()
    art["hxa"] = {k: analysis[k] for k in HXA_KEYS}
    art["roofline"] = costmodel.roofline_terms(analysis, chip, n_chips)
    mesh_shape = tuple(int(d) for d in art["mesh"].split("x"))
    art["sim"] = costmodel.simulate(analysis, chip, n_chips,
                                    mesh=mesh_shape).as_dict()
    hlo_flops_global = analysis["flops"] * n_chips
    art["useful_flops_ratio"] = (art["model_flops"] / hlo_flops_global
                                 if hlo_flops_global else 0.0)
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    return art


_CNN = ("the CNN is not an LM cell (the reference's dryrun leaves it out "
        "too); its inference runs in chip_smoke.py")


def _not_ported(cfg, shape) -> Optional[str]:
    """Why the port has no census of this cell (None when it has one)."""
    try:
        api.build_model(cfg)
        if shape.kind == "train":
            api.check_trainable(cfg)
    except NotImplementedError as e:
        return str(e)
    return None


def _cells() -> Iterator[Tuple[str, str, Optional[str]]]:
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        if cfg.family == "cnn":
            yield arch, "-", _CNN
            continue
        for shape in cfg.applicable_shapes():
            yield arch, shape.name, _not_ported(cfg, shape)


def applicable_cells() -> Iterator[Tuple[str, str]]:
    """(arch, shape) of every cell the port traces: the dense models'
    train / prefill / decode shapes; mamba2's and zamba2's train, prefill,
    decode and long_500k shapes; whisper's and paligemma's train, prefill
    and decode shapes; deepseek v2's and v3's train, prefill and decode
    shapes (32 cells; the MoE family's routed experts are booked by shape,
    ``models/moe.py``)."""
    for arch, shape, why in _cells():
        if why is None:
            yield arch, shape


def skipped_cells() -> List[Tuple[str, str, str]]:
    """(arch, shape, why) of every cell the port does not trace yet, ``why``
    naming the ROADMAP item that ports it (``shape`` "-" for ResNet-50,
    which has no LM shapes): ResNet-50's one cell."""
    return [(a, s, why) for a, s, why in _cells() if why is not None]


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="override key=value (e.g. remat=none)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        _multi_pod()
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if args.all:
        cells = list(applicable_cells())
        for arch, shape, why in skipped_cells():
            print(f"[dryrun] skip {arch} x {shape}: {why}")
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    for arch, shape in cells:
        r = run_cell(arch, shape, overrides=overrides)
        print(f"[dryrun] {arch} x {shape} x {r['mesh']}: "
              f"state/dev {r['memory']['state_gb_per_device']:.2f} GB, "
              f"hxa-flops/dev {r['hxa']['flops']:.3e}, "
              f"dominant {r['roofline']['dominant']}, wall {r['wall_s']}s")


if __name__ == "__main__":
    main()
