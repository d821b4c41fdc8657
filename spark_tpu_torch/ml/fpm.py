"""Frequent pattern mining (`ml/fpm/FPGrowth.scala:158`,
`mllib/fpm/FPGrowth.scala:230` FP-tree analog).

The port of ``spark_tpu/ml/fpm.py``.  FP-growth is pointer-chasing tree
recursion — the one ML family with no useful dense-tensor form — so like
``spark_tpu`` and the reference (which runs the tree
walk inside per-partition JVM closures) the mining happens host-side;
the engine carries the data in/out columnarly.  Itemset columns follow
the Tokenizer convention: a string column of \x00-joined items (see
`feature.Tokenizer`), or python lists via createDataFrame.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..columnar import ColumnBatch, ColumnVector
from .base import Estimator, Model, Param, execute_batch

__all__ = ["FPGrowth", "FPGrowthModel"]

SEP = "\x00"


def _row_items(value) -> List[str]:
    if value is None:
        return []
    if isinstance(value, (list, tuple, np.ndarray)):
        return [str(v) for v in value if v is not None]
    return [t for t in str(value).split(SEP) if t]


class _Node:
    __slots__ = ("item", "count", "parent", "children")

    def __init__(self, item: Optional[str], parent: Optional["_Node"]):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: Dict[str, "_Node"] = {}


def _build_tree(transactions: List[Tuple[List[str], int]],
                min_count: int):
    """(tree root, header item → [(node, count)]) over transactions
    filtered/ordered by descending global frequency — the classic FP-tree
    construction (`mllib/fpm/FPGrowth.scala:230` genFreqItems+add)."""
    freq: Dict[str, int] = defaultdict(int)
    for items, cnt in transactions:
        for it in set(items):
            freq[it] += cnt
    keep = {it for it, c in freq.items() if c >= min_count}
    order = {it: (-freq[it], it) for it in keep}
    root = _Node(None, None)
    header: Dict[str, List[_Node]] = defaultdict(list)
    for items, cnt in transactions:
        path = sorted(set(items) & keep, key=order.__getitem__)
        node = root
        for it in path:
            child = node.children.get(it)
            if child is None:
                child = _Node(it, node)
                node.children[it] = child
                header[it].append(child)
            child.count += cnt
            node = child
    return root, header, freq


def _mine(transactions: List[Tuple[List[str], int]], min_count: int,
          suffix: Tuple[str, ...], out: Dict[Tuple[str, ...], int],
          max_len: Optional[int]) -> None:
    root, header, freq = _build_tree(transactions, min_count)
    for item, nodes in header.items():
        support = sum(n.count for n in nodes)
        if support < min_count:
            continue
        itemset = tuple(sorted(suffix + (item,)))
        out[itemset] = support
        if max_len is not None and len(itemset) >= max_len:
            continue
        # conditional pattern base: prefix paths of every `item` node
        cond: List[Tuple[List[str], int]] = []
        for n in nodes:
            path = []
            p = n.parent
            while p is not None and p.item is not None:
                path.append(p.item)
                p = p.parent
            if path:
                cond.append((path, n.count))
        if cond:
            _mine(cond, min_count, suffix + (item,), out, max_len)


class FPGrowth(Estimator):
    itemsCol = Param("itemsCol", "items column", "items")
    minSupport = Param("minSupport", "minimum itemset support", 0.3)
    minConfidence = Param("minConfidence", "minimum rule confidence", 0.8)
    numPartitions = Param("numPartitions", "ignored: single-host mine", None)
    maxPatternLength = Param("maxPatternLength", "itemset length cap", 10)

    def _fit(self, df):
        batch, n = execute_batch(df)
        col = batch.column(self.getOrDefault("itemsCol"))
        vals = col.to_pylist(batch.row_valid_or_true())
        transactions = [(_row_items(v), 1) for v in vals[:n]]
        min_count = max(
            int(np.ceil(self.getOrDefault("minSupport") * len(transactions))),
            1)
        itemsets: Dict[Tuple[str, ...], int] = {}
        _mine(transactions, min_count, (), itemsets,
              self.getOrDefault("maxPatternLength"))
        return FPGrowthModel(
            itemsCol=self.getOrDefault("itemsCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            minConfidence=self.getOrDefault("minConfidence"),
            itemsets={SEP.join(k): v for k, v in itemsets.items()},
            numTransactions=len(transactions))


class FPGrowthModel(Model):
    itemsCol = Param("itemsCol", "", "items")
    minConfidence = Param("minConfidence", "", 0.8)
    itemsets = Param("itemsets", "itemset(\\x00-joined) → support count",
                     None)
    numTransactions = Param("numTransactions", "", 0)

    def _sets(self) -> Dict[Tuple[str, ...], int]:
        return {tuple(k.split(SEP)): v
                for k, v in (self.getOrDefault("itemsets") or {}).items()}

    def freqItemsets(self, session):
        """DataFrame(items: \\x00-joined string, freq: int64), support
        descending then items — `FPGrowthModel.freqItemsets` analog."""
        sets = sorted(self._sets().items(), key=lambda kv: (-kv[1], kv[0]))
        words = [SEP.join(k) for k, _ in sets]
        freqs = np.array([v for _, v in sets] or [0], np.int64)
        return _two_col_df(session, "items", words, "freq",
                           freqs[:len(sets)])

    def associationRules(self, session):
        """DataFrame(antecedent, consequent, confidence, lift, support) for
        every rule X → y with confidence >= minConfidence
        (`AssociationRules.scala:90` run analog: one consequent per rule).
        """
        sets = self._sets()
        n_tx = max(self.getOrDefault("numTransactions"), 1)
        min_conf = self.getOrDefault("minConfidence")
        ants, cons, confs, lifts, sups = [], [], [], [], []
        for itemset, support in sets.items():
            if len(itemset) < 2:
                continue
            for y in itemset:
                ant = tuple(sorted(set(itemset) - {y}))
                ant_sup = sets.get(ant)
                if not ant_sup:
                    continue
                conf = support / ant_sup
                if conf < min_conf:
                    continue
                y_sup = sets.get((y,))
                ants.append(SEP.join(ant))
                cons.append(y)
                confs.append(conf)
                lifts.append(conf / (y_sup / n_tx) if y_sup else float("nan"))
                sups.append(support / n_tx)
        cap = max(len(ants), 1)
        return _local_df(session, [
            ("antecedent", ants, T.string), ("consequent", cons, T.string),
            ("confidence", confs, T.float64), ("lift", lifts, T.float64),
            ("support", sups, T.float64)], cap)

    def transform(self, df):
        """Per row: union of consequents of rules whose antecedent is a
        subset of the row's items, minus items already present."""
        from ..sql import logical as L
        from ..sql.dataframe import DataFrame
        from .feature import _string_vector
        sets = self._sets()
        min_conf = self.getOrDefault("minConfidence")
        rules: List[Tuple[frozenset, str]] = []
        for itemset, support in sets.items():
            if len(itemset) < 2:
                continue
            for y in itemset:
                ant = tuple(sorted(set(itemset) - {y}))
                ant_sup = sets.get(ant)
                if ant_sup and support / ant_sup >= min_conf:
                    rules.append((frozenset(ant), y))
        batch, n = execute_batch(df)
        vals = batch.column(self.getOrDefault("itemsCol")).to_pylist(
            batch.row_valid_or_true())
        preds = []
        for v in vals[:n]:
            items = set(_row_items(v))
            hit = {y for ant, y in rules if ant <= items and y not in items}
            preds.append(SEP.join(sorted(hit)))
        out = ColumnBatch(
            list(batch.names) + [self.getOrDefault("predictionCol")],
            list(batch.vectors) + [_string_vector(preds, batch.capacity,
                                                  batch.device)],
            batch.row_valid, batch.capacity)
        return DataFrame(df.session, L.LocalRelation(out))


def _local_df(session, columns, cap: int):
    """A DataFrame on the session's device of ``(name, values, type)``
    columns (strings or float64), ``cap`` rows of which the first
    ``len(values)`` live."""
    from ..sql import logical as L
    from ..sql.dataframe import DataFrame
    from .feature import _string_vector
    dev = session.device
    vectors, n = [], 0
    for _name, vals, dt in columns:
        n = len(vals)
        if dt.is_string:
            vectors.append(_string_vector(vals, cap, dev))
        else:
            full = np.zeros(cap, dt.np_dtype)
            full[:n] = vals
            vectors.append(ColumnVector(torch.from_numpy(full).to(dev), dt,
                                        None, None))
    batch = ColumnBatch([c[0] for c in columns], vectors,
                        torch.arange(cap, device=dev) < n, cap)
    return DataFrame(session, L.LocalRelation(batch))


def _two_col_df(session, name1: str, words: List[str], name2: str,
                vals: np.ndarray):
    return _local_df(session, [(name1, list(words), T.string),
                               (name2, np.asarray(vals), T.int64)],
                     max(len(words), 1))
