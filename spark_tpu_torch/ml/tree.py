"""Shared decision-tree machinery for the tree ensembles.

The port of ``spark_tpu/ml/tree.py``, host numpy as there: the same
seeds give the same splits and forests.

The role of the reference's `ml/tree/` package (`DecisionTree.scala`,
`RandomForest.scala:82`, `GradientBoostedTrees.scala`): binned candidate
splits over feature quantiles, variance (regression) or gini
(classification) impurity, grown host-side (ensemble member data easily
fits the host for the sizes this engine trains), with PREDICTION
flattened to arrays and evaluated vectorized over all rows at once —
one gather per tree level instead of a Python loop per row."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["grow_tree", "flatten_tree", "predict_flat", "predict_forest",
           "fit_forest"]

#: candidate split quantiles per feature (binned splits, maxBins analog)
_SPLIT_QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9)


def _impurity_cost(y: np.ndarray, kind: str) -> float:
    if len(y) == 0:
        return 0.0
    if kind == "variance":
        return float(((y - y.mean()) ** 2).sum())
    # gini * n
    _vals, counts = np.unique(y, return_counts=True)
    p = counts / counts.sum()
    return float((1.0 - (p ** 2).sum()) * len(y))


def _leaf_value(y: np.ndarray, kind: str) -> float:
    if len(y) == 0:
        return 0.0
    if kind == "variance":
        return float(y.mean())
    vals, counts = np.unique(y, return_counts=True)
    return float(vals[np.argmax(counts)])


def grow_tree(X: np.ndarray, y: np.ndarray, max_depth: int,
              min_rows: int = 1, impurity: str = "variance",
              feature_subset: Optional[int] = None,
              rng: Optional[np.random.Generator] = None,
              depth: int = 0) -> Dict:
    """Recursive best-split growth over quantile-binned candidates.

    ``feature_subset`` draws that many random candidate features at EACH
    NODE (random forests' featureSubsetStrategy — per-split, not
    per-tree, which is what makes interaction features like XOR
    learnable); thresholds are expressed in ORIGINAL feature indices so
    prediction needs no remapping."""
    if depth >= max_depth or len(y) <= min_rows or np.all(y == y[0]):
        return {"leaf": _leaf_value(y, impurity)}
    d = X.shape[1]
    if feature_subset is not None and feature_subset < d:
        feats = (rng or np.random.default_rng()).choice(
            d, size=feature_subset, replace=False)
    else:
        feats = np.arange(d)
    base = _impurity_cost(y, impurity)
    best = None
    for j in feats:
        col = X[:, j]
        for t in np.quantile(col, _SPLIT_QUANTILES):
            left = col <= t
            nl = int(left.sum())
            if nl == 0 or nl == len(y):
                continue
            cost = _impurity_cost(y[left], impurity) \
                + _impurity_cost(y[~left], impurity)
            if best is None or cost < best[0]:
                best = (cost, int(j), float(t), left)
    if best is None or best[0] >= base:
        return {"leaf": _leaf_value(y, impurity)}
    _, j, t, left = best
    return {
        "feature": j, "threshold": t,
        "left": grow_tree(X[left], y[left], max_depth, min_rows, impurity,
                          feature_subset, rng, depth + 1),
        "right": grow_tree(X[~left], y[~left], max_depth, min_rows,
                           impurity, feature_subset, rng, depth + 1),
    }


def flatten_tree(tree: Dict) -> Dict[str, np.ndarray]:
    """Dict tree → parallel arrays (feature, threshold, left, right,
    value); leaves carry feature = -1.  The array form is what a
    vectorized (and potentially on-device) predictor wants."""
    feature: List[int] = []
    threshold: List[float] = []
    left: List[int] = []
    right: List[int] = []
    value: List[float] = []

    def walk(node: Dict) -> int:
        i = len(feature)
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(0.0)
        if "leaf" in node:
            value[i] = float(node["leaf"])
            return i
        feature[i] = int(node["feature"])
        threshold[i] = float(node["threshold"])
        left[i] = walk(node["left"])
        right[i] = walk(node["right"])
        return i

    walk(tree)
    return {"feature": np.asarray(feature, np.int32),
            "threshold": np.asarray(threshold, np.float64),
            "left": np.asarray(left, np.int32),
            "right": np.asarray(right, np.int32),
            "value": np.asarray(value, np.float64)}


def predict_flat(flat: Dict[str, np.ndarray], X: np.ndarray) -> np.ndarray:
    """Vectorized prediction: every row walks the tree simultaneously,
    one level per iteration (bounded by tree depth)."""
    n = len(X)
    node = np.zeros(n, np.int32)
    feature = flat["feature"]
    for _ in range(len(feature)):        # depth bound; exits early
        f = feature[node]
        at_leaf = f < 0
        if at_leaf.all():
            break
        x = X[np.arange(n), np.clip(f, 0, X.shape[1] - 1)]
        go_left = x <= flat["threshold"][node]
        nxt = np.where(go_left, flat["left"][node], flat["right"][node])
        node = np.where(at_leaf, node, nxt).astype(np.int32)
    return flat["value"][node]


def predict_forest(flats: List[Dict[str, np.ndarray]], X: np.ndarray
                   ) -> np.ndarray:
    """(n_trees, n_rows) prediction matrix."""
    return np.stack([predict_flat(f, X) for f in flats])


def fit_forest(X: np.ndarray, y: np.ndarray, impurity: str,
               num_trees: int, max_depth: int, min_rows: int,
               subsample: float, feat_strategy: str, seed: int
               ) -> List[Dict]:
    """Bootstrap rows per tree, random feature subset PER NODE
    (`RandomForest.scala:82` contract) — shared by both forests."""
    rng = np.random.default_rng(seed)
    d = X.shape[1]
    if feat_strategy == "sqrt":
        k = max(1, int(np.sqrt(d)))
    elif feat_strategy == "onethird":
        k = max(1, d // 3)
    else:
        k = d
    trees = []
    for _ in range(num_trees):
        idx = rng.choice(len(y), size=max(1, int(len(y) * subsample)),
                         replace=True)
        trees.append(grow_tree(X[idx], y[idx], max_depth, min_rows,
                               impurity,
                               feature_subset=k if k < d else None,
                               rng=rng))
    return trees


def cached_flats(model) -> List[Dict[str, np.ndarray]]:
    """Flattened-array form of a model's trees, memoized per instance
    (repeated transform calls — tuning loops, streaming micro-batches —
    must not re-walk every node every time)."""
    trees = model.getOrDefault("trees")
    cache = getattr(model, "_flats_cache", None)
    if cache is None or cache[0] is not trees:
        cache = (trees, [flatten_tree(t) for t in trees])
        model._flats_cache = cache
    return cache[1]


def cached_flat(model) -> Dict[str, np.ndarray]:
    tree = model.getOrDefault("tree")
    cache = getattr(model, "_flat_cache", None)
    if cache is None or cache[0] is not tree:
        cache = (tree, flatten_tree(tree))
        model._flat_cache = cache
    return cache[1]
