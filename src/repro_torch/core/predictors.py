"""The paper's ML predictor suite on tensors: KNN, Decision Tree (CART),
Random Forest.

Counterpart of ``repro.core.predictors``.  The paper trains "multiple
machine learning models (e.g., K-Nearest Neighbor, Decision Tree, Random
Forest Tree) for each specific task (i.e., power or performance
prediction)" and picks the best per task.

Implementation notes:
  * Tree FITTING is plain numpy (recursive CART, variance-reduction splits),
    the reference's code verbatim: it runs on the host and replays bitwise
    under the same rngs (``fit``: ``default_rng(seed)``; ``partial_fit``:
    ``default_rng((seed, fit_calls, slot))``).
  * Tree INFERENCE is the level-synchronous walk ``forest_predict``: the
    stacked tree arrays move to the model's device once per fit, and
    ``max_depth + 1`` gather steps walk all T trees over N samples at once.
    Gathers and float32 ``<=`` round nothing, so the ``[T, N]`` leaf values
    are bitwise the reference's, on any device.
  * Statistics over trees accumulate tree by tree in order: ``predict``'s
    float32 mean and ``predict_log_stats``' float64 mean and variance, as
    numpy reduces the leading axis of a ``[T, N]`` array — so the card and
    the host give the same bits, and ``predict_log_stats`` equals the
    reference's numpy statistics bitwise.  ``predict`` equals the
    reference's (an XLA float32 mean) bitwise up to 32 trees, and to float32
    ulps beyond.
  * KNN: z-scored ``log1p|x|`` features in float32 on the device;
    distances in the difference form ``sum((x_q - x_t)^2)`` (the expanded
    ``|a|^2 - 2ab + |b|^2`` rounds differently), computed over blocks of
    query rows so the ``[rows, M, F]`` difference block stays under
    ``KNN_BLOCK_BYTES``.
  * Targets are trained in log space: power and especially cycles span
    orders of magnitude across the design space; MAPE is computed in
    linear space.

Every model takes ``device`` (``"cuda"`` by default, which raises without
a card); ``predict`` / ``predict_log_stats`` accept numpy (or a tensor) and
return numpy float64.  ``params_from_reference`` builds a fitted model of
this package from a fitted model's state (``model_state``), which reads
either package's model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

# bytes of the float32 [rows, M, F] difference block one KNN predict step
# holds (M training rows, F features): 256 MiB
KNN_BLOCK_BYTES = 256 << 20


# --- metrics -------------------------------------------------------------------------

def mape(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true, np.float64), np.asarray(y_pred, np.float64)
    return float(np.mean(np.abs((y_pred - y_true) / np.maximum(np.abs(y_true), 1e-12))) * 100)


def r2_score(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true, np.float64), np.asarray(y_pred, np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return float(1.0 - ss_res / max(ss_tot, 1e-12))


def _features(X, device: torch.device) -> torch.Tensor:
    """A feature matrix as a float32 tensor on ``device`` (numpy is cast to
    float32 first, as the reference casts)."""
    if isinstance(X, torch.Tensor):
        return X.to(device=device, dtype=torch.float32)
    a = np.ascontiguousarray(X, np.float32)
    if not a.flags.writeable:          # a read-only view (of a jax buffer)
        a = a.copy()
    return torch.from_numpy(a).to(device)


# --- KNN -------------------------------------------------------------------------------

@dataclasses.dataclass
class KNNRegressor:
    k: int = 5
    log_target: bool = True
    device: Any = DEFAULT_DEVICE
    _x: Optional[torch.Tensor] = None
    _y: Optional[torch.Tensor] = None
    _mu: Optional[torch.Tensor] = None
    _sd: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def fit(self, X, y):
        # features span orders of magnitude (tokens, flops): distance in
        # log1p space, then z-scored
        X = torch.log1p(torch.abs(_features(X, self.device)))
        y = _features(np.asarray(y, np.float32), self.device)
        self._mu = X.mean(0)
        self._sd = torch.clamp(X.std(0, correction=0), min=1e-6)
        self._x = (X - self._mu) / self._sd
        self._y = torch.log(torch.clamp(y, min=1e-12)) if self.log_target else y
        return self

    def block_rows(self) -> int:
        """Query rows a predict step takes: the largest block whose
        [rows, M, F] float32 differences fit ``KNN_BLOCK_BYTES``."""
        m, f = self._x.shape
        return max(1, KNN_BLOCK_BYTES // (4 * m * f))

    def predict(self, X):
        X = torch.log1p(torch.abs(_features(X, self.device)))
        X = (X - self._mu) / self._sd
        k = min(self.k, self._x.shape[0])
        rows = self.block_rows()
        out = []
        for lo in range(0, X.shape[0], rows):
            q = X[lo:lo + rows]
            d2 = ((q[:, None, :] - self._x[None, :, :]) ** 2).sum(-1)
            neg_d2, idx = torch.topk(-d2, k, dim=1)
            w = 1.0 / (torch.sqrt(-neg_d2) + 1e-6)
            w = w / w.sum(1, keepdim=True)
            out.append((w * self._y[idx]).sum(1))
        pred = torch.cat(out) if out else X.new_zeros(0)
        pred = torch.exp(pred) if self.log_target else pred
        return pred.cpu().numpy().astype(np.float64)


# --- CART decision tree ------------------------------------------------------------------

@dataclasses.dataclass
class _TreeArrays:
    feature: np.ndarray      # int32 [n_nodes]; -1 => leaf
    threshold: np.ndarray    # float32
    left: np.ndarray         # int32 child indices
    right: np.ndarray
    value: np.ndarray        # float32 leaf predictions


def _build_cart(X: np.ndarray, y: np.ndarray, max_depth: int, min_leaf: int,
                rng: np.random.Generator, feature_frac: float) -> _TreeArrays:
    nodes: List[dict] = []

    def grow(idx: np.ndarray, depth: int) -> int:
        node_id = len(nodes)
        nodes.append({})
        yi = y[idx]
        if depth >= max_depth or idx.size < 2 * min_leaf or np.ptp(yi) < 1e-12:
            nodes[node_id] = {"leaf": float(yi.mean())}
            return node_id
        n_feat = X.shape[1]
        feats = rng.choice(n_feat, max(1, int(n_feat * feature_frac)), replace=False)
        best = None
        parent_var = yi.var() * idx.size
        for f in feats:
            xs = X[idx, f]
            order = np.argsort(xs, kind="stable")
            xs_s, ys_s = xs[order], yi[order]
            csum = np.cumsum(ys_s)
            csq = np.cumsum(ys_s ** 2)
            n = idx.size
            split_pts = np.nonzero(np.diff(xs_s) > 1e-12)[0] + 1
            split_pts = split_pts[(split_pts >= min_leaf) & (split_pts <= n - min_leaf)]
            if split_pts.size == 0:
                continue
            nl = split_pts.astype(np.float64)
            sl, sq_l = csum[split_pts - 1], csq[split_pts - 1]
            var_l = sq_l - sl ** 2 / nl
            sr, sq_r = csum[-1] - sl, csq[-1] - sq_l
            var_r = sq_r - sr ** 2 / (n - nl)
            score = var_l + var_r
            j = int(np.argmin(score))
            if best is None or score[j] < best[0]:
                thr = 0.5 * (xs_s[split_pts[j] - 1] + xs_s[split_pts[j]])
                best = (float(score[j]), int(f), float(thr))
        if best is None or best[0] >= parent_var - 1e-12:
            nodes[node_id] = {"leaf": float(yi.mean())}
            return node_id
        _, f, thr = best
        mask = X[idx, f] <= thr
        li = grow(idx[mask], depth + 1)
        ri = grow(idx[~mask], depth + 1)
        nodes[node_id] = {"feature": f, "threshold": thr, "left": li, "right": ri}
        return node_id

    grow(np.arange(X.shape[0]), 0)
    n = len(nodes)
    arr = _TreeArrays(
        feature=np.full(n, -1, np.int32), threshold=np.zeros(n, np.float32),
        left=np.zeros(n, np.int32), right=np.zeros(n, np.int32),
        value=np.zeros(n, np.float32))
    for i, nd in enumerate(nodes):
        if "leaf" in nd:
            arr.value[i] = nd["leaf"]
        else:
            arr.feature[i] = nd["feature"]
            arr.threshold[i] = nd["threshold"]
            arr.left[i] = nd["left"]
            arr.right[i] = nd["right"]
    return arr


def forest_predict(feat: torch.Tensor, thr: torch.Tensor, left: torch.Tensor,
                   right: torch.Tensor, val: torch.Tensor, X: torch.Tensor,
                   max_depth: int) -> torch.Tensor:
    """Level-synchronous walk of T stacked trees over N samples, on the
    device of ``X``.

    feat/left/right: int64 [T, n_nodes] (feature -1 marks a leaf);
    thr/val: float32 [T, n_nodes]; X: float32 [N, F].  Every sample starts
    at its tree's root and takes ``max_depth + 1`` steps (a leaf stays
    put).  Returns the [T, N] float32 leaf values.
    """
    t, n = feat.shape[0], X.shape[0]
    node = torch.zeros((t, n), dtype=torch.int64, device=X.device)
    xt = X.t()                                               # [F, N]
    for _ in range(max_depth + 1):
        f = feat.gather(1, node)                             # [T, N]
        x = xt.gather(0, f.clamp(min=0))                     # X[n, f[t, n]]
        nxt = torch.where(x <= thr.gather(1, node), left.gather(1, node),
                          right.gather(1, node))
        node = torch.where(f < 0, node, nxt)
    return val.gather(1, node)


def _stack_trees(trees: List[_TreeArrays]) -> tuple:
    """Pad every tree to the forest's max node count and stack [T, n_nodes]."""
    m = max(t.feature.shape[0] for t in trees)
    pad = lambda a, fill: np.stack(
        [np.concatenate([x, np.full(m - x.shape[0], fill, x.dtype)])
         for x in a])
    return (pad([t.feature for t in trees], -1),
            pad([t.threshold for t in trees], 0.0),
            pad([t.left for t in trees], 0),
            pad([t.right for t in trees], 0),
            pad([t.value for t in trees], 0.0))


def _to_device(stacked: tuple, device: torch.device) -> tuple:
    """``_stack_trees``' arrays as ``forest_predict``'s tensors on
    ``device``: indices as int64, thresholds and values float32."""
    feat, thr, left, right, val = stacked
    idx = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)
    return (idx(feat), torch.from_numpy(thr).to(device), idx(left),
            idx(right), torch.from_numpy(val).to(device))


def _div(x: torch.Tensor, t: int) -> torch.Tensor:
    """``x / t`` correctly rounded on every device: CUDA turns a division
    by a python scalar into a multiply by its reciprocal, so the divisor is
    a tensor."""
    return x / torch.full_like(x, t)


def _tree_sum(preds: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (tree) axis, tree by tree in order — how numpy
    reduces axis 0 of a C-contiguous array, on any device."""
    s = preds[0].clone()
    for t in range(1, preds.shape[0]):
        s += preds[t]
    return s


@dataclasses.dataclass
class DecisionTreeRegressor:
    max_depth: int = 12
    min_leaf: int = 2
    log_target: bool = True
    device: Any = DEFAULT_DEVICE
    _tree: Optional[_TreeArrays] = None
    _stacked: Optional[tuple] = None        # device tensors of ``_tree``

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def fit(self, X, y, seed: int = 0):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float64)
        yt = np.log(np.maximum(y, 1e-12)) if self.log_target else y
        self._tree = _build_cart(X, yt, self.max_depth, self.min_leaf,
                                 np.random.default_rng(seed), 1.0)
        self._stacked = _to_device(_stack_trees([self._tree]), self.device)
        return self

    def predict(self, X):
        p = forest_predict(*self._stacked, _features(X, self.device),
                           self.max_depth)[0]
        p = p.cpu().numpy().astype(np.float64)
        return np.exp(p) if self.log_target else p


@dataclasses.dataclass
class RandomForestRegressor:
    """The paper's random forest, with the warm-start surface the adaptive
    campaign (``repro_torch.dse_campaign.adaptive``) drives:

    * ``partial_fit`` appends new rows and rebuilds only ``refresh_trees``
      tree slots per call (cycling through the forest), so per-round refits
      cost a fraction of a full ``fit`` while every tree eventually sees the
      accumulated data;
    * ``predict_log_stats`` exposes the per-tree prediction spread — the
      forest-variance exploration term of the acquisition function.

    Both are seeded-deterministic: tree slot ``t`` rebuilt on the ``c``-th
    ``partial_fit`` call draws its bootstrap from ``default_rng((seed, c,
    t))``, so replaying the same call sequence (same data, same seeds)
    reproduces the forest bitwise — and the reference's forest too.
    """

    n_trees: int = 40
    max_depth: int = 12
    min_leaf: int = 2
    feature_frac: float = 0.7
    log_target: bool = True
    refresh_trees: Optional[int] = None      # per-partial_fit rebuild budget
    device: Any = DEFAULT_DEVICE
    _trees: Optional[List[_TreeArrays]] = None
    _stacked: Optional[tuple] = None         # device tensors of ``_trees``
    _X: Optional[np.ndarray] = None          # accumulated warm-start rows
    _y: Optional[np.ndarray] = None          # (transformed target space)
    _fit_calls: int = 0
    _next_slot: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _transform_y(self, y: np.ndarray) -> np.ndarray:
        return np.log(np.maximum(y, 1e-12)) if self.log_target else y

    def _restack(self) -> None:
        self._stacked = _to_device(_stack_trees(self._trees), self.device)

    def fit(self, X, y, seed: int = 0):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float64)
        yt = self._transform_y(y)
        rng = np.random.default_rng(seed)
        self._trees = []
        n = X.shape[0]
        for _ in range(self.n_trees):
            boot = rng.integers(0, n, n)                    # bootstrap sample
            self._trees.append(_build_cart(X[boot], yt[boot], self.max_depth,
                                           self.min_leaf, rng, self.feature_frac))
        self._restack()
        # a full fit resets the warm-start state (the incremental history is
        # superseded by the from-scratch forest)
        self._X, self._y = X, yt
        self._fit_calls, self._next_slot = 1, 0
        return self

    @property
    def n_rows(self) -> int:
        """Accumulated training rows (warm-start surface)."""
        return 0 if self._X is None else int(self._X.shape[0])

    def partial_fit(self, X, y, seed: int = 0):
        """Warm-start incremental refit: append ``(X, y)`` to the accumulated
        training set, then rebuild only ``refresh_trees`` tree slots
        (cyclically; ``None`` rebuilds all) on the FULL accumulated data.

        The first call builds the whole forest.  Each rebuilt slot's
        bootstrap is drawn from ``default_rng((seed, call_index, slot))`` —
        independent of which slots any other call rebuilt — so a replayed
        call sequence reproduces the forest bitwise.  Untouched slots keep
        their exact tree arrays.
        """
        X = np.asarray(X, np.float32)
        yt = self._transform_y(np.asarray(y, np.float64))
        if X.ndim != 2 or X.shape[0] != yt.shape[0]:
            raise ValueError(f"partial_fit shapes: X {X.shape} vs y {yt.shape}")
        if self._X is None:
            self._X, self._y = X, yt
        else:
            if X.shape[1] != self._X.shape[1]:
                raise ValueError(
                    f"partial_fit feature width {X.shape[1]} != accumulated "
                    f"{self._X.shape[1]}")
            self._X = np.concatenate([self._X, X])
            self._y = np.concatenate([self._y, yt])
        n = self._X.shape[0]
        if self._trees is None:
            self._trees = [None] * self.n_trees
            slots = list(range(self.n_trees))               # cold: build all
        else:
            k = self.n_trees if self.refresh_trees is None else min(
                max(int(self.refresh_trees), 1), self.n_trees)
            slots = [(self._next_slot + i) % self.n_trees for i in range(k)]
            self._next_slot = (slots[-1] + 1) % self.n_trees
        for t in slots:
            rng = np.random.default_rng((seed, self._fit_calls, t))
            boot = rng.integers(0, n, n)
            self._trees[t] = _build_cart(self._X[boot], self._y[boot],
                                         self.max_depth, self.min_leaf, rng,
                                         self.feature_frac)
        self._fit_calls += 1
        self._restack()
        return self

    def tree_predictions(self, X) -> torch.Tensor:
        """The [T, N] float32 leaf values of every tree, on the device."""
        return forest_predict(*self._stacked, _features(X, self.device),
                              self.max_depth)

    def predict(self, X):
        preds = self.tree_predictions(X)
        # float32 mean as XLA forms the reference's: the sum times the
        # float32 reciprocal of T (bitwise the reference's for T <= 32,
        # where XLA's CPU reduction runs tree by tree)
        inv = torch.tensor(1.0 / preds.shape[0], dtype=torch.float32)
        p = (_tree_sum(preds) * inv.to(preds.device)).cpu().numpy()
        p = p.astype(np.float64)
        return np.exp(p) if self.log_target else p

    def predict_log_stats(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """Per-sample (mean, std) over the per-tree predictions, in the
        model's TRAINING target space (log space when ``log_target``) — the
        spread is the epistemic-uncertainty reading the adaptive campaign's
        exploration term consumes.  float64, accumulated tree by tree and
        divided by T on the device, the square root taken by numpy on the
        host (torch's CPU ``sqrt`` is not correctly rounded): numpy's
        ``mean(0)`` / ``std(0)`` bitwise."""
        preds = self.tree_predictions(X).double()
        t = preds.shape[0]
        mean = _div(_tree_sum(preds), t)
        dev = preds - mean
        var = _div(_tree_sum(dev * dev), t)
        return mean.cpu().numpy(), np.sqrt(var.cpu().numpy())


MODELS = {
    "knn": lambda device=DEFAULT_DEVICE: KNNRegressor(k=5, device=device),
    "decision_tree": lambda device=DEFAULT_DEVICE: DecisionTreeRegressor(
        device=device),
    "random_forest": lambda device=DEFAULT_DEVICE: RandomForestRegressor(
        device=device),
}


def kfold_evaluate(model_name: str, X, y, k: int = 5, seed: int = 0,
                   device=DEFAULT_DEVICE) -> dict:
    """K-fold CV -> mean MAPE / R^2 (the paper's model-selection metric);
    the models predict on ``device``."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float64)
    n = X.shape[0]
    idx = np.random.default_rng(seed).permutation(n)
    folds = np.array_split(idx, k)
    mapes, r2s = [], []
    for i in range(k):
        test = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        m = MODELS[model_name](device=device)
        m.fit(X[train], y[train])
        pred = m.predict(X[test])
        mapes.append(mape(y[test], pred))
        r2s.append(r2_score(y[test], pred))
    return {"model": model_name, "mape": float(np.mean(mapes)),
            "r2": float(np.mean(r2s)), "mape_std": float(np.std(mapes))}


# --- carrying a fitted model across --------------------------------------------------

_KINDS = {"KNNRegressor": "knn", "DecisionTreeRegressor": "decision_tree",
          "RandomForestRegressor": "random_forest"}
_CLASSES = {"knn": KNNRegressor, "decision_tree": DecisionTreeRegressor,
            "random_forest": RandomForestRegressor}
_TREE_FIELDS = ("feature", "threshold", "left", "right", "value")
# fitted state per kind, beside the trees and the hyperparameters
_STATE = {"knn": ("_x", "_y", "_mu", "_sd"), "decision_tree": (),
          "random_forest": ("_X", "_y", "_fit_calls", "_next_slot")}


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return a if isinstance(a, (int, float)) else np.asarray(a)


def model_state(model) -> Dict:
    """A fitted model's state as plain data (numpy arrays and numbers):
    ``{"kind", "params": hyperparameters, "trees": [{field: array}],
    **fitted arrays}``.  Reads a model of this package or of the reference
    (same class and field names), so it is the bridge
    ``params_from_reference`` consumes."""
    kind = _KINDS[type(model).__name__]
    fields = [f.name for f in dataclasses.fields(model)]
    out = {"kind": kind,
           "params": {f: getattr(model, f) for f in fields
                      if not f.startswith("_") and f != "device"}}
    if kind == "decision_tree":
        out["trees"] = [model._tree]
    elif kind == "random_forest":
        out["trees"] = list(model._trees)
    if "trees" in out:
        out["trees"] = [{f: np.asarray(getattr(t, f)) for f in _TREE_FIELDS}
                        for t in out["trees"]]
    for name in _STATE[kind]:
        out[name] = _numpy(getattr(model, name))
    return out


def params_from_reference(state: Dict, device=DEFAULT_DEVICE):
    """A fitted model of this package from ``model_state`` of a fitted
    model (the reference's, typically): the same hyperparameters, tree
    arrays per slot (forests: also the accumulated rows ``_X`` / ``_y``,
    ``_fit_calls`` and ``_next_slot``, so ``partial_fit`` continues the
    same call sequence), or KNN's standardized training set ``_x``, ``_y``,
    ``_mu``, ``_sd`` — moved to ``device``."""
    kind = state["kind"]
    model = _CLASSES[kind](device=device, **state["params"])
    trees = [_TreeArrays(**{f: np.array(t[f]) for f in _TREE_FIELDS})
             for t in state.get("trees", ())]
    if kind == "knn":
        for name in _STATE[kind]:
            setattr(model, name, _features(state[name], model.device))
        return model
    if kind == "decision_tree":
        model._tree = trees[0]
    else:
        model._trees = trees
        model._X = np.asarray(state["_X"], np.float32)
        model._y = np.asarray(state["_y"], np.float64)
        model._fit_calls = int(state["_fit_calls"])
        model._next_slot = int(state["_next_slot"])
    model._stacked = _to_device(_stack_trees(trees), model.device)
    return model
