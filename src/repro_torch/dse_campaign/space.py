"""Generator-backed campaign design spaces: mega-spaces that never materialize.

``dse.default_space`` builds every ``Candidate`` into a Python list, which
caps practical spaces at a few thousand points.  A ``SpaceSpec`` is the
declarative alternative: it describes the cross product

    chip set x chip-count range x mesh factorizations
             x dense DVFS frequency lattice x heterogeneous-slice variants

and addresses it purely by index arithmetic.  The flat candidate index
decomposes as ``(row, freq_point)`` where a *row* is one
(chip, variant, mesh) combination — there are only tens-to-hundreds of rows
even for million-point spaces, so the spec's resident footprint is the row
table, never the candidates.  ``slice(lo, hi)`` materializes any sub-range
as a ``CandidateBatch`` with vectorized array construction, and ``tiles()``
streams the whole space in fixed ``chunk_size`` chunks — peak candidate-array
memory is bounded by ``chunk_size`` no matter how large the space is, and any
tile index is addressable for campaign resume.

Heterogeneous-slice variants model mixed-bin / mixed-generation slices at the
cost-model level: the slice clock is governed by its slowest member, so a
variant applies a worst-bin frequency derate (``freq_scale``) to the top of
the DVFS band.  The uniform variant (scale 1.0) reproduces
``hw.frequency_sweep`` bitwise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.core.dse import Candidate, CandidateBatch
from repro_torch.hw import (CHIP_TABLE, CHIPS, ChipTable, mesh_factorizations,
                      normalize_mesh)


@dataclasses.dataclass(frozen=True)
class SliceVariant:
    """One slice-composition variant: ``freq_scale`` derates the top of the
    DVFS band (worst-bin clock governs the slice)."""

    name: str = "uniform"
    freq_scale: float = 1.0


DEFAULT_VARIANTS = (SliceVariant("uniform", 1.0),
                    SliceVariant("worst-bin-85", 0.85))


@dataclasses.dataclass(frozen=True)
class _Row:
    """One (chip, variant, mesh) combination; spans ``freq_points`` indices."""

    chip: str
    variant: SliceVariant
    mesh: Tuple[int, ...]
    n_chips: int


@dataclasses.dataclass(frozen=True)
class SpaceSpec:
    """Declarative, never-materialized campaign design space.

    ``chip_counts`` are slice sizes; every ``mesh_factorizations`` arrangement
    of each count enters the space (edge parts with ``ici_bw == 0`` collapse
    to a single-chip 1x1 mesh).  With ``mesh_dims=3`` the leading pod factor
    is carried as the candidates' ``mesh_pod`` axis and priced by the
    topology-aware collective model (it is no longer silently dropped).
    ``freq_points`` is the per-row DVFS lattice density.  Total size is
    ``rows * freq_points``; only the row table is resident.
    """

    chips: Tuple[str, ...] = tuple(CHIPS)
    chip_counts: Tuple[int, ...] = (16, 64, 256)
    freq_points: int = 12
    mesh_dims: int = 2
    variants: Tuple[SliceVariant, ...] = (SliceVariant(),)
    chunk_size: int = 4096

    def __post_init__(self):
        if self.freq_points < 1:
            raise ValueError("freq_points must be >= 1")
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        unknown = [c for c in self.chips if c not in CHIPS]
        if unknown:
            raise ValueError(f"unknown chips {unknown}; known: {list(CHIPS)}")

    # -- row table (the only resident state; O(chips x variants x meshes)) --

    @functools.cached_property
    def _rows(self) -> Tuple[_Row, ...]:
        rows = []
        for chip in self.chips:
            if CHIPS[chip].ici_bw == 0:
                meshes = ((1, 1),)
            else:
                meshes = tuple(m for n in self.chip_counts
                               for m in mesh_factorizations(n, self.mesh_dims))
            for variant in self.variants:
                for mesh in meshes:
                    rows.append(_Row(chip, variant, mesh,
                                     int(np.prod(mesh))))
        return tuple(rows)

    @functools.cached_property
    def _row_arrays(self) -> Dict[str, np.ndarray]:
        """Per-row columns for vectorized slicing (row count is tiny)."""
        rows = self._rows
        table = CHIP_TABLE
        chip_idx = table.indices([r.chip for r in rows])
        f_min = table.min_freq_mhz[chip_idx]
        f_max = table.max_freq_mhz[chip_idx]
        scale = np.asarray([r.variant.freq_scale for r in rows], np.float64)
        # worst-bin derate shrinks the top of the band, clamped into it
        f_hi = np.clip(f_max * scale, f_min, f_max)
        axes = [normalize_mesh(r.mesh) for r in rows]    # (pod, data, model)
        return {
            "chip_idx": chip_idx,
            "n_chips": np.asarray([r.n_chips for r in rows], np.int64),
            "mesh_pod": np.asarray([a[0] for a in axes], np.int64),
            "mesh_data": np.asarray([a[1] for a in axes], np.int64),
            "mesh_model": np.asarray([a[2] for a in axes], np.int64),
            "f_lo": f_min,
            "f_hi": f_hi,
        }

    def __len__(self) -> int:
        return len(self._rows) * self.freq_points

    @property
    def n_rows(self) -> int:
        """Resident row count — the actual memory footprint of the spec
        (``len(self)`` candidates are addressed, never materialized)."""
        return len(self._rows)

    def n_tiles(self, chunk_size: int = None) -> int:
        """Number of ``chunk_size`` tiles covering the space (last may be
        partial)."""
        c = chunk_size or self.chunk_size
        return -(-len(self) // c)

    # -- index arithmetic ---------------------------------------------------

    def _freqs(self, row: np.ndarray, k: np.ndarray) -> np.ndarray:
        """Frequency of lattice point ``k`` on each ``row``; the arithmetic is
        the same IEEE expression as ``hw.frequency_lattice`` (endpoints pinned
        exactly), so the uniform variant matches ``frequency_sweep`` bitwise.
        """
        cols = self._row_arrays
        lo, hi = cols["f_lo"][row], cols["f_hi"][row]
        if self.freq_points == 1:
            return hi.copy()
        f = lo + k * (hi - lo) / (self.freq_points - 1)
        return np.where(k == 0, lo, np.where(k == self.freq_points - 1, hi, f))

    def candidate(self, i: int) -> Candidate:
        """Materialize the single candidate at flat index ``i``."""
        return self.candidates_at([i])[0]

    def candidates_at(self, indices) -> list:
        """Materialize the candidates at arbitrary flat ``indices``, batched.

        The lazy-survivor path of the fused campaign evaluators: a whole
        tile streams through the device candidate-less, and only its
        frontier survivors (typically tens per tile) become ``Candidate``
        objects — in one vectorized pass instead of a per-index ``divmod``
        + frequency recomputation."""
        idx = np.asarray(indices, np.int64)
        n = len(self)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"indices outside [0, {n}): "
                             f"[{idx.min()}, {idx.max()}]")
        row, k = np.divmod(idx, self.freq_points)
        freq = self._freqs(row, k)
        rows = self._rows
        return [Candidate(rows[r].chip, rows[r].n_chips, rows[r].mesh,
                          float(f)) for r, f in zip(row, freq)]

    def slice(self, lo: int, hi: int,
              with_candidates: bool = True) -> CandidateBatch:
        """Candidates [lo, hi) as a ``CandidateBatch``, built array-natively.

        Any sub-range of the space is addressable without touching the rest —
        this is what makes campaigns resumable from an arbitrary tile index.
        ``with_candidates=False`` skips the per-candidate ``Candidate``
        construction (the only O(tile) Python cost of a slice) and returns an
        array-only batch — the zero-copy campaign paths materialize scalar
        candidates lazily via ``candidate(i)`` for frontier survivors only.
        """
        n = len(self)
        lo, hi = max(lo, 0), min(hi, n)
        if hi <= lo:
            raise ValueError(f"empty slice [{lo}, {hi}) of space of {n}")
        idx = np.arange(lo, hi)
        row, k = np.divmod(idx, self.freq_points)
        cols = self._row_arrays
        chip_idx = cols["chip_idx"][row]
        freq = self._freqs(row, k)
        rows = self._rows
        candidates = None
        if with_candidates:
            candidates = tuple(
                Candidate(rows[r].chip, rows[r].n_chips, rows[r].mesh,
                          float(f))
                for r, f in zip(row, freq))
        return CandidateBatch(
            candidates=candidates,
            chip_idx=chip_idx,
            n_chips=cols["n_chips"][row],
            mesh_data=cols["mesh_data"][row],
            mesh_model=cols["mesh_model"][row],
            freq_mhz=freq,
            mesh_pod=cols["mesh_pod"][row],
            chip_cols=CHIP_TABLE.gather(chip_idx))

    def tiles(self, start_tile: int = 0, chunk_size: int = None,
              with_candidates: bool = True
              ) -> Iterator[Tuple[int, int, CandidateBatch]]:
        """Stream the space as (tile_index, flat_lo, batch) chunks.

        Each batch holds at most ``chunk_size`` candidates; ``start_tile``
        skips already-evaluated prefixes on resume without materializing them.
        ``with_candidates=False`` streams array-only batches (see ``slice``).
        """
        c = chunk_size or self.chunk_size
        n = len(self)
        for t in range(start_tile, self.n_tiles(c)):
            lo = t * c
            yield t, lo, self.slice(lo, min(lo + c, n),
                                    with_candidates=with_candidates)

    # -- persistence --------------------------------------------------------

    def to_dict(self) -> Dict:
        """Declarative JSON form of the spec (the *recipe*, never the rows);
        carries ``size`` so ``from_dict`` can detect index-space drift."""
        return {
            "chips": list(self.chips),
            "chip_counts": list(self.chip_counts),
            "freq_points": self.freq_points,
            "mesh_dims": self.mesh_dims,
            "variants": [[v.name, v.freq_scale] for v in self.variants],
            "chunk_size": self.chunk_size,
            "size": len(self),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "SpaceSpec":
        """Rebuild a spec from ``to_dict`` output, refusing if the rebuilt
        index space has a different size (global indices would be invalid)."""
        spec = cls(chips=tuple(d["chips"]),
                   chip_counts=tuple(d["chip_counts"]),
                   freq_points=d["freq_points"],
                   mesh_dims=d["mesh_dims"],
                   variants=tuple(SliceVariant(n, s) for n, s in d["variants"]),
                   chunk_size=d["chunk_size"])
        if "size" in d and len(spec) != d["size"]:
            raise ValueError(
                f"space spec resolves to {len(spec)} candidates but the "
                f"checkpoint recorded {d['size']} — chip registry changed?")
        return spec


def tile_span(space: SpaceSpec, tile: int) -> Tuple[int, int]:
    """The flat candidate span [lo, hi) of ``tile`` — the same arithmetic
    ``SpaceSpec.tiles`` uses, exposed for random tile access (the adaptive
    campaign evaluates tiles out of order)."""
    n_tiles = space.n_tiles()
    if not 0 <= tile < n_tiles:
        raise IndexError(f"tile {tile} outside [0, {n_tiles})")
    lo = tile * space.chunk_size
    return lo, min(lo + space.chunk_size, len(space))


def default_campaign_space(chunk_size: int = 4096) -> SpaceSpec:
    """The default mega-space: every 2D/3D mesh factorization of power-of-two
    slice sizes 4..1024 x a dense 320-point DVFS lattice x two slice variants
    — >100k candidates, several hundred times ``dse.default_space``'s 192."""
    return SpaceSpec(
        chips=tuple(CHIPS),
        chip_counts=(4, 8, 16, 32, 64, 128, 256, 512, 1024),
        freq_points=320,
        mesh_dims=3,
        variants=DEFAULT_VARIANTS,
        chunk_size=chunk_size)


def tiny_campaign_space(chunk_size: int = 256) -> SpaceSpec:
    """A small seeded sub-space for tests / CI smoke (hundreds of points)."""
    return SpaceSpec(
        chips=("tpu-v5e", "tpu-v4", "tpu-edge"),
        chip_counts=(16, 64, 256),
        freq_points=16,
        mesh_dims=2,
        variants=DEFAULT_VARIANTS,
        chunk_size=chunk_size)
