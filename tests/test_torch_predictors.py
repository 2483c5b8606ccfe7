"""Port parity: ``repro_torch.core.predictors``, ``core.dataset`` and the
fast path of ``core.dse`` against the reference package, on the CPU.

Tolerances, stated once:
* tree fitting (``_build_cart``, ``fit``, ``partial_fit``) is the same numpy
  code under the same rngs: tree arrays bitwise, replayed call sequences
  included;
* the forest walk's [T, N] leaf values: bitwise (gathers and float32 ``<=``
  round nothing);
* ``predict_log_stats``: bitwise (float64, trees accumulated in order, as
  numpy reduces axis 0);
* ``predict`` of a forest (a float32 mean over trees): 1e-6 relative after
  ``exp`` (bitwise up to 32 trees, where XLA also sums tree by tree);
* KNN: 1e-5 relative — the log, the z-scoring and the distance sums round
  differently in XLA and torch; the test data is continuous random, and the
  test asserts no exact distance tie at the k-th place, so ``top_k`` and
  ``topk`` pick the same neighbours;
* ``kfold_evaluate``: MAPE / R^2 within 1e-6 relative for the trees, 1e-4
  for KNN;
* ``build_dataset``: X bitwise, labels within rtol 1e-15 (the scalar
  simulator cubes as ``x*x*x`` where the reference calls ``pow``).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.core import costmodel as ref_costmodel
from repro.core import dataset as ref_dataset
from repro.core import dse as ref_dse
from repro.core import features as ref_features
from repro.core import predictors as R
from repro.hw import get_chip as ref_get_chip
from repro_torch.core import costmodel, dataset, dse
from repro_torch.core import predictors as P
from repro_torch.hw import get_chip

TREE_FIELDS = ("feature", "threshold", "left", "right", "value")


def synthetic(seed, n=300, d=4, noise=0.02):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.5, 4.0, (n, d)).astype(np.float32)
    y = 5.0 * X[:, 0] * X[:, 1] ** 2 / X[:, 2] + X[:, 3]
    return X, y * np.exp(rng.normal(0, noise, n))


def assert_trees_equal(ref_trees, port_trees):
    assert len(ref_trees) == len(port_trees)
    for a, b in zip(ref_trees, port_trees):
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            assert getattr(b, f).dtype == getattr(a, f).dtype


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    y, p = rng.uniform(0.5, 3, 50), rng.uniform(0.5, 3, 50)
    assert P.mape(y, p) == R.mape(y, p)
    assert P.r2_score(y, p) == R.r2_score(y, p)


def test_models_default_to_the_card():
    """``device`` defaults to ``"cuda"``: without a card the constructor
    raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py drives it")
    for make in (P.KNNRegressor, P.DecisionTreeRegressor,
                 P.RandomForestRegressor, *P.MODELS.values()):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


# --- fitting: the same trees -------------------------------------------------


@pytest.mark.parametrize("seed,frac,depth,min_leaf",
                         [(0, 1.0, 12, 2), (1, 0.7, 6, 1), (2, 0.5, 3, 4)])
def test_build_cart_is_bitwise_the_reference(seed, frac, depth, min_leaf):
    X, y = synthetic(seed)
    yt = np.log(y)
    a = R._build_cart(X, yt, depth, min_leaf, np.random.default_rng(seed),
                      frac)
    b = P._build_cart(X, yt, depth, min_leaf, np.random.default_rng(seed),
                      frac)
    assert_trees_equal([a], [b])


def test_forest_and_tree_fit_are_bitwise_the_reference():
    X, y = synthetic(3)
    rf = R.RandomForestRegressor(n_trees=8, max_depth=8).fit(X, y, seed=5)
    pf = P.RandomForestRegressor(n_trees=8, max_depth=8,
                                 device="cpu").fit(X, y, seed=5)
    assert_trees_equal(rf._trees, pf._trees)
    assert (pf._fit_calls, pf._next_slot) == (rf._fit_calls, rf._next_slot)
    np.testing.assert_array_equal(pf._X, rf._X)
    np.testing.assert_array_equal(pf._y, rf._y)
    rt = R.DecisionTreeRegressor(max_depth=7).fit(X, y, seed=2)
    pt = P.DecisionTreeRegressor(max_depth=7, device="cpu").fit(X, y, seed=2)
    assert_trees_equal([rt._tree], [pt._tree])
    Xq = synthetic(4, n=97)[0]
    np.testing.assert_array_equal(pt.predict(Xq), rt.predict(Xq))


def test_partial_fit_replays_the_reference_call_sequence():
    """The same warm-start call sequence (seeds, rows, slot cycling) on both
    packages: the forests agree bitwise after every call, ``fit`` resets the
    warm state alike, and the next ``partial_fit`` continues alike."""
    kw = dict(n_trees=6, max_depth=6, min_leaf=2, refresh_trees=4)
    rf, pf = R.RandomForestRegressor(**kw), P.RandomForestRegressor(
        **kw, device="cpu")
    Xq = synthetic(99, n=64)[0]
    for step, seed in enumerate([7, 11, 13, 11]):
        X, y = synthetic(step, n=40 + 10 * step)
        rf.partial_fit(X, y, seed=seed)
        pf.partial_fit(X, y, seed=seed)
        assert_trees_equal(rf._trees, pf._trees)
        assert (pf._fit_calls, pf._next_slot, pf.n_rows) == (
            rf._fit_calls, rf._next_slot, rf.n_rows)
        np.testing.assert_array_equal(pf.predict(Xq), rf.predict(Xq))
    X, y = synthetic(20, n=50)
    rf.fit(X, y, seed=3)
    pf.fit(X, y, seed=3)
    rf.partial_fit(*synthetic(21, n=30), seed=9)
    pf.partial_fit(*synthetic(21, n=30), seed=9)
    assert_trees_equal(rf._trees, pf._trees)
    with pytest.raises(ValueError, match="feature width"):
        pf.partial_fit(np.ones((3, 5), np.float32), np.ones(3), seed=0)


# --- inference ---------------------------------------------------------------


@pytest.mark.parametrize("n_trees,depth", [(1, 4), (7, 8), (10, 12)])
def test_forest_walk_is_bitwise_the_reference(n_trees, depth):
    X, y = synthetic(6)
    rf = R.RandomForestRegressor(n_trees=n_trees, max_depth=depth).fit(X, y)
    pf = P.params_from_reference(P.model_state(rf), device="cpu")
    Xq = np.concatenate([synthetic(7, n=203)[0], X[:50]])   # seen + unseen
    want = np.asarray(R._forest_predict_jnp(*rf._stacked, jnp.asarray(Xq),
                                            max_depth=depth))
    got = P.forest_predict(*pf._stacked, torch.from_numpy(Xq), depth)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pf.tree_predictions(Xq).numpy(), want)


@pytest.mark.parametrize("n_trees", [1, 5, 10])
def test_predict_log_stats_bitwise_and_predict_within_1e6(n_trees):
    X, y = synthetic(8)
    rf = R.RandomForestRegressor(n_trees=n_trees, max_depth=10).fit(X, y,
                                                                     seed=1)
    pf = P.RandomForestRegressor(n_trees=n_trees, max_depth=10,
                                 device="cpu").fit(X, y, seed=1)
    Xq = synthetic(9, n=211)[0]
    mu_r, sd_r = rf.predict_log_stats(Xq)
    mu_p, sd_p = pf.predict_log_stats(Xq)
    assert mu_p.dtype == sd_p.dtype == np.float64
    np.testing.assert_array_equal(mu_p, mu_r)
    np.testing.assert_array_equal(sd_p, sd_r)
    got = pf.predict(Xq)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, rf.predict(Xq), rtol=1e-6, atol=0)


def knn_pair(seed, k=5, n=300):
    X, y = synthetic(seed, n=n, d=6)
    return (R.KNNRegressor(k=k).fit(X, y),
            P.KNNRegressor(k=k, device="cpu").fit(X, y), X)


def assert_no_kth_tie(model, Xq):
    Xz = (torch.log1p(torch.abs(torch.from_numpy(Xq))) - model._mu) \
        / model._sd
    d2 = ((Xz[:, None, :] - model._x[None]) ** 2).sum(-1)
    s = torch.sort(d2, dim=1).values
    k = min(model.k, s.shape[1])
    if k < s.shape[1]:
        gap = (s[:, k] - s[:, k - 1]) / s[:, k].clamp(min=1e-30)
        assert float(gap.min()) > 1e-4, "the test data ties at the k-th place"


@pytest.mark.parametrize("k", [1, 5, 400])
def test_knn_matches_reference_within_1e5(k):
    ref, port, _ = knn_pair(10, k=k)
    Xq = synthetic(11, n=150, d=6)[0]
    assert_no_kth_tie(port, Xq)
    got = port.predict(Xq)
    assert got.dtype == np.float64 and got.shape == (150,)
    np.testing.assert_allclose(got, np.asarray(ref.predict(Xq), np.float64),
                               rtol=1e-5, atol=0)


def test_knn_blocks_over_query_rows(monkeypatch):
    """Blocking the queries changes nothing: each row's distances, top-k
    and weights are its own."""
    _, port, _ = knn_pair(12)
    Xq = synthetic(13, n=101, d=6)[0]
    whole = port.predict(Xq)
    assert port.block_rows() >= 101
    monkeypatch.setattr(P, "KNN_BLOCK_BYTES", 4 * 300 * 6 * 7)
    assert port.block_rows() == 7
    np.testing.assert_array_equal(port.predict(Xq), whole)


@pytest.mark.parametrize("name,rtol", [("knn", 1e-4), ("decision_tree", 1e-6),
                                       ("random_forest", 1e-6)])
def test_kfold_evaluate_matches_reference(name, rtol):
    X, y = synthetic(14, n=240)
    a = R.kfold_evaluate(name, X, y, k=4, seed=2)
    b = P.kfold_evaluate(name, X, y, k=4, seed=2, device="cpu")
    assert b["model"] == name
    for key in ("mape", "r2", "mape_std"):
        np.testing.assert_allclose(b[key], a[key], rtol=rtol, atol=0)
    assert b["mape"] < 40.0 and b["r2"] > 0.5


# --- carrying a fitted model across ------------------------------------------


def test_params_from_reference_round_trips():
    X, y = synthetic(15)
    Xq = synthetic(16, n=77)[0]
    kw = dict(n_trees=5, max_depth=6, refresh_trees=2)
    rf = R.RandomForestRegressor(**kw)
    rf.partial_fit(X[:150], y[:150], seed=4)
    rf.partial_fit(X[150:], y[150:], seed=4)
    pf = P.params_from_reference(P.model_state(rf), device="cpu")
    assert isinstance(pf, P.RandomForestRegressor) and pf.refresh_trees == 2
    assert_trees_equal(rf._trees, pf._trees)
    np.testing.assert_array_equal(pf.predict(Xq), rf.predict(Xq))
    # the warm-start history came across: the next call continues alike
    rf.partial_fit(*synthetic(17, n=40), seed=4)
    pf.partial_fit(*synthetic(17, n=40), seed=4)
    assert_trees_equal(rf._trees, pf._trees)
    # the port's own state carries back to an equal model
    again = P.params_from_reference(P.model_state(pf), device="cpu")
    assert_trees_equal(pf._trees, again._trees)
    np.testing.assert_array_equal(again._X, pf._X)
    assert (again._fit_calls, again._next_slot) == (pf._fit_calls,
                                                    pf._next_slot)

    rt = R.DecisionTreeRegressor(max_depth=5).fit(X, y)
    pt = P.params_from_reference(P.model_state(rt), device="cpu")
    assert isinstance(pt, P.DecisionTreeRegressor) and pt.max_depth == 5
    np.testing.assert_array_equal(pt.predict(Xq), rt.predict(Xq))

    rk, _, _ = knn_pair(18, k=3)
    pk = P.params_from_reference(P.model_state(rk), device="cpu")
    assert isinstance(pk, P.KNNRegressor) and pk.k == 3
    # the standardized training set came across bitwise, so only the query
    # side rounds differently
    np.testing.assert_array_equal(pk._x.numpy(), np.asarray(rk._x))
    np.testing.assert_allclose(pk.predict(Xq[:, :3].repeat(2, 1)),
                               np.asarray(rk.predict(Xq[:, :3].repeat(2, 1)),
                                          np.float64), rtol=1e-5)


# --- the dataset -------------------------------------------------------------


def write_artifacts(path):
    cells = [("qwen3_14b", "train_4k", 1.0), ("mamba2_130m", "decode_32k",
                                              0.03)]
    for arch, shape, scale in cells:
        art = {"hxa": {"flops": 3.2e14 * scale, "hbm_bytes": 4.5e13 * scale,
                       "collective_bytes": 5e11 * scale,
                       "wire_bytes": 7e11 * scale},
               "roofline": {"n_chips": 256}}
        (path / f"{arch}__{shape}__pod1.json").write_text(json.dumps(art))
    (path / "stablelm_1_6b__train_4k__pod1__hc1.json").write_text("{}")
    (path / "notes.txt").write_text("not an artifact")


def test_build_dataset_matches_reference(tmp_path):
    write_artifacts(tmp_path)
    arts = dataset.load_dryrun_artifacts(str(tmp_path))
    assert arts == ref_dataset.load_dryrun_artifacts(str(tmp_path))
    assert sorted(arts) == [("mamba2_130m", "decode_32k", "pod1"),
                            ("qwen3_14b", "train_4k", "pod1")]
    kw = dict(freq_points=4, mesh_counts=(16, 64), mesh_freq_points=2)
    X, yp, yc, meta = dataset.build_dataset(str(tmp_path), **kw)
    rX, ryp, ryc, rmeta = ref_dataset.build_dataset(str(tmp_path), **kw)
    assert X.dtype == np.float32 and X.shape == rX.shape and len(X) > 100
    np.testing.assert_array_equal(X, rX)
    np.testing.assert_allclose(yp, ryp, rtol=1e-15, atol=0)
    np.testing.assert_allclose(yc, ryc, rtol=1e-15, atol=0)
    assert [(m.arch, m.shape, m.chip, m.freq_mhz, tuple(m.mesh), m.n_chips)
            for m in meta] == [(m.arch, m.shape, m.chip, m.freq_mhz,
                                tuple(m.mesh), m.n_chips) for m in rmeta]
    assert dataset.build_dataset(str(tmp_path / "missing"))[0].shape[0] == 0


# --- the fast path -----------------------------------------------------------

BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}


def test_fast_path_search_same_pick_as_reference():
    """The setup of ``tests/test_system.py``'s fast-vs-slow test, each
    package fitting its models on the same rows: the same pick, the same
    predicted power (a forest of 10 trees: bitwise) and cycles (KNN:
    1e-5).  The KNN is fitted in each package rather than carried across:
    its design matrix has columns constant over the space (the arch's),
    whose standard deviation clamps to 1e-6, so a one-ulp difference
    between XLA's and torch's ``log1p`` of a query would be magnified a
    million-fold against the other package's training set."""
    cfg, shape = ref_get_config("qwen3_14b"), REF_SHAPES["train_4k"]
    space = [c for c in ref_dse.default_space(freq_points=4)
             if c.n_chips >= 16]
    X, yp, yc = [], [], []
    for c in space:
        chip = ref_get_chip(c.chip)
        r = ref_costmodel.simulate(ref_dse._scale_analysis(BASE, 256, c),
                                   chip, c.n_chips, freq_mhz=c.freq_mhz,
                                   mesh=c.mesh)
        X.append(ref_features.extract(cfg, shape, chip, c.n_chips, c.mesh,
                                      c.freq_mhz))
        yp.append(r.power_w)
        yc.append(r.cycles)
    rf = R.RandomForestRegressor(n_trees=10).fit(np.asarray(X),
                                                 np.asarray(yp))
    knn = R.KNNRegressor().fit(np.asarray(X), np.asarray(yc))
    cons = ref_dse.Constraint(max_power_w=50_000, min_hbm_fit=False)
    ref_best, ref_details, _ = ref_dse.fast_path_search(
        "qwen3_14b", "train_4k", rf, knn, space, cons, verify_top_k=5,
        slow_verify=lambda c: ref_costmodel.simulate(
            ref_dse._scale_analysis(BASE, 256, c), ref_get_chip(c.chip),
            c.n_chips, freq_mhz=c.freq_mhz, mesh=c.mesh))

    prf = P.params_from_reference(P.model_state(rf), device="cpu")
    pknn = P.KNNRegressor(device="cpu").fit(np.asarray(X), np.asarray(yc))
    pspace = [dse.Candidate(c.chip, c.n_chips, c.mesh, c.freq_mhz)
              for c in space]
    best, details, _ = dse.fast_path_search(
        "qwen3_14b", "train_4k", prf, pknn, pspace,
        dse.Constraint(max_power_w=50_000, min_hbm_fit=False),
        verify_top_k=5,
        slow_verify=lambda c: costmodel.simulate(
            dse._scale_analysis(BASE, 256, c), get_chip(c.chip), c.n_chips,
            freq_mhz=c.freq_mhz, mesh=c.mesh))
    assert best is not None
    assert (best.chip, best.n_chips, best.mesh, best.freq_mhz) == (
        ref_best.chip, ref_best.n_chips, ref_best.mesh, ref_best.freq_mhz)
    np.testing.assert_array_equal(details["predicted_power_w"],
                                  ref_details["predicted_power_w"])
    np.testing.assert_allclose(details["predicted_cycles"],
                               ref_details["predicted_cycles"], rtol=1e-5)
    np.testing.assert_array_equal(details["order"], ref_details["order"])


def test_surrogate_features_and_tile_scores_match_reference():
    from repro.dse_campaign import tiny_campaign_space as ref_tiny
    from repro_torch.dse_campaign import tiny_campaign_space
    batch = tiny_campaign_space().slice(100, 400, with_candidates=False)
    rbatch = ref_tiny().slice(100, 400, with_candidates=False)
    assert dse.SURROGATE_FEATURES == ref_dse.SURROGATE_FEATURES
    X = dse.surrogate_features(batch)
    np.testing.assert_array_equal(X, ref_dse.surrogate_features(rbatch))
    y = X[:, 0].astype(np.float64) * X[:, 1] + X[:, 5] * 1e-12
    re_ = R.RandomForestRegressor(n_trees=4, max_depth=6).fit(X, y, seed=1)
    rl = R.KNNRegressor(k=3).fit(X, y + 1.0)
    got = dse.predict_tile_scores(
        P.params_from_reference(P.model_state(re_), device="cpu"),
        P.params_from_reference(P.model_state(rl), device="cpu"), batch)
    want = ref_dse.predict_tile_scores(re_, rl, rbatch)
    np.testing.assert_array_equal(got[0], want[0])     # forest: bitwise
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    np.testing.assert_array_equal(got[3], np.zeros(len(batch)))
