"""Port parity: ``repro_torch.core.features`` against the reference
``repro.core.features``.  Pure numpy on both sides over configs and a chip
registry that compare equal, so every gate here is bitwise."""

import dataclasses

import numpy as np
import pytest

from repro.configs.base import ARCH_NAMES as REF_ARCHS
from repro.configs.base import get_config as ref_get_config
from repro.core import dse as ref_dse
from repro.core import features as ref_features
from repro.hw import get_chip as ref_get_chip
from repro_torch.configs.base import ARCH_NAMES, get_config
from repro_torch.core import dse, features
from repro_torch.hw import get_chip

CELLS = [(arch, shape.name) for arch in REF_ARCHS
         for shape in ref_get_config(arch).applicable_shapes()]
POINTS = [("tpu-v5e", 256, (16, 16), None), ("tpu-v4", 64, (4, 16), 940.0),
          ("tpu-v5p", 512, (2, 16, 16), 1200.0), ("tpu-edge", 1, (1, 1), 500.0)]


def shape_of(cfg, name):
    return next(s for s in cfg.applicable_shapes() if s.name == name)


def test_feature_names_and_archs_match():
    assert features.FEATURE_NAMES == ref_features.FEATURE_NAMES
    assert ARCH_NAMES == REF_ARCHS


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_extract_is_bitwise_the_reference(arch, shape_name):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shape, rshape = shape_of(cfg, shape_name), shape_of(rcfg, shape_name)
    for chip, n, mesh, freq in POINTS:
        got = features.extract(cfg, shape, get_chip(chip), n, mesh, freq)
        want = ref_features.extract(rcfg, rshape, ref_get_chip(chip), n, mesh,
                                    freq)
        assert len(got) == len(features.FEATURE_NAMES)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.isfinite(got).all()
        assert (features.analytic_counts(cfg, shape, n, mesh[-1])
                == ref_features.analytic_counts(rcfg, rshape, n, mesh[-1]))


@pytest.mark.parametrize("arch", ["qwen3_14b", "mamba2_130m",
                                  "deepseek_v3_671b", "whisper_small"])
def test_extract_batch_on_default_space_is_bitwise(arch):
    """The whole 192-point ``default_space`` design matrix, every shape, and
    row i equal to ``extract`` of candidate i."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    batch = dse.default_space_batch()
    rbatch = ref_dse.CandidateBatch.from_candidates(ref_dse.default_space())
    assert ([dataclasses.astuple(c) for c in batch.candidates]
            == [dataclasses.astuple(c) for c in rbatch.candidates])
    for shape in cfg.applicable_shapes():
        rshape = shape_of(rcfg, shape.name)
        got = features.extract_batch(cfg, shape, batch.chip_idx,
                                     batch.n_chips, batch.mesh_data,
                                     batch.mesh_model, batch.freq_mhz)
        want = ref_features.extract_batch(rcfg, rshape, rbatch.chip_idx,
                                          rbatch.n_chips, rbatch.mesh_data,
                                          rbatch.mesh_model, rbatch.freq_mhz)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        for i in (0, 57, len(batch) - 1):
            c = batch.candidates[i]
            row = features.extract(cfg, shape, get_chip(c.chip), c.n_chips,
                                   c.mesh, c.freq_mhz)
            np.testing.assert_array_equal(got[i], np.float32(row))
