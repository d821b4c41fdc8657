"""Feature transformers (`ml/feature/` analog): assembly, scaling, indexing,
text features.

The port of ``spark_tpu/ml/feature.py``.  Numeric transformers and
estimators run torch on the session's device over ``extract_matrix``'s
tensor; the token transformers (Tokenizer, HashingTF, CountVectorizer,
StopWordsRemover, NGram, the string indexers) are host Python over the
decoded words, as in the reference, and hand their result back to the
device.  Word2Vec trains on the device with torch autograd and an
``optax.adam`` twin (``base.Adam``); its negative samples are drawn from
a ``torch.Generator`` seeded by ``seed``."""

from __future__ import annotations

import itertools
from typing import Any, Dict, List

import numpy as np
import torch

from .. import types as T
from ..expressions import AnalysisException
from ..columnar import device_tensor
from .base import (
    Adam, Estimator, Model, Param, Transformer, append_prediction,
    column_matrix, execute_batch, extract_matrix, to_numpy,
)

__all__ = [
    "VectorAssembler", "StandardScaler", "StandardScalerModel",
    "MinMaxScaler", "MinMaxScalerModel", "StringIndexer", "StringIndexerModel",
    "IndexToString", "OneHotEncoder", "Tokenizer", "HashingTF", "Binarizer",
    "Bucketizer", "SQLTransformer", "PCA", "PCAModel",
    "CountVectorizer", "CountVectorizerModel", "Word2Vec", "Word2VecModel",
    "IDF", "IDFModel", "Normalizer", "MaxAbsScaler", "MaxAbsScalerModel",
    "StopWordsRemover", "NGram", "QuantileDiscretizer", "Imputer",
    "ImputerModel", "PolynomialExpansion", "ElementwiseProduct",
    "VectorSlicer", "ChiSqSelector", "ChiSqSelectorModel",
    "RFormula", "RFormulaModel",
]


def _words(batch, col: str, n: int) -> List[Any]:
    """The live values of a column as Python objects (host decode)."""
    return batch.column(col).to_pylist(batch.row_valid_or_true())[:n]


def _host_column(batch, col: str, n: int) -> np.ndarray:
    return batch.column(col).data[:n].cpu().numpy()


def _string_vector(rows: List[Any], cap: int, device):
    from ..columnar import ColumnVector, encode_strings
    codes, dic = encode_strings(list(rows) + [None] * (cap - len(rows)))
    return ColumnVector(
        torch.from_numpy(np.where(codes < 0, 0, codes).astype(np.int32))
        .to(device), T.string, torch.from_numpy(codes >= 0).to(device), dic)


def _append_string_column(df, batch, n, rows, name):
    """Append one string column (``rows``: n python strings/None) to an
    executed batch — the shared tail of every token transformer."""
    from ..columnar import ColumnBatch
    from ..sql import logical as L
    from ..sql.dataframe import DataFrame
    vec = _string_vector(rows, batch.capacity, batch.device)
    out = ColumnBatch(list(batch.names) + [name],
                      list(batch.vectors) + [vec], batch.row_valid,
                      batch.capacity)
    return DataFrame(df.session, L.LocalRelation(out))


def _tokens(v) -> List[str]:
    return [t for t in str(v).split("\x00") if t] if v is not None else []


class VectorAssembler(Transformer):
    inputCols = Param("inputCols", "input columns", None)
    outputCol = Param("outputCol", "output column", "features")

    def transform(self, df):
        cols = self.getOrDefault("inputCols")
        if not cols:
            raise AnalysisException("VectorAssembler requires inputCols")
        batch, n = execute_batch(df)
        mat = torch.cat([column_matrix(batch, c, n) for c in cols], dim=1)
        return append_prediction(df, batch, n, mat,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class StandardScaler(Estimator):
    inputCol = Param("inputCol", "input column", "features")
    outputCol = Param("outputCol", "output column", "scaled")
    withMean = Param("withMean", "center", False)
    withStd = Param("withStd", "scale to unit std", True)

    def _fit(self, df):
        X, _, _ = extract_matrix(df, self.getOrDefault("inputCol"))
        return StandardScalerModel(
            inputCol=self.getOrDefault("inputCol"),
            outputCol=self.getOrDefault("outputCol"),
            withMean=self.getOrDefault("withMean"),
            withStd=self.getOrDefault("withStd"),
            mean=X.mean(dim=0), std=X.std(dim=0, correction=1))


class StandardScalerModel(Model):
    inputCol = Param("inputCol", "input column", "features")
    outputCol = Param("outputCol", "output column", "scaled")
    withMean = Param("withMean", "center", False)
    withStd = Param("withStd", "scale", True)
    mean = Param("mean", "fitted mean", None)
    std = Param("std", "fitted std", None)

    def transform(self, df):
        out, batch, n = extract_matrix(df, self.getOrDefault("inputCol"))
        if self.getOrDefault("withMean"):
            out = out - device_tensor(self.getOrDefault("mean"),
                                      out.device, torch.float64)
        if self.getOrDefault("withStd"):
            std = device_tensor(self.getOrDefault("std"), out.device,
                                torch.float64)
            out = out / torch.where(std == 0, torch.ones_like(std), std)
        return append_prediction(df, batch, n, out,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class MinMaxScaler(Estimator):
    inputCol = Param("inputCol", "input column", "features")
    outputCol = Param("outputCol", "output column", "scaled")

    def _fit(self, df):
        X, _, _ = extract_matrix(df, self.getOrDefault("inputCol"))
        return MinMaxScalerModel(inputCol=self.getOrDefault("inputCol"),
                                 outputCol=self.getOrDefault("outputCol"),
                                 mn=X.amin(dim=0), mx=X.amax(dim=0))


class MinMaxScalerModel(Model):
    inputCol = Param("inputCol", "", "features")
    outputCol = Param("outputCol", "", "scaled")
    mn = Param("mn", "", None)
    mx = Param("mx", "", None)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("inputCol"))
        mn = device_tensor(self.getOrDefault("mn"), X.device,
                           torch.float64)
        mx = device_tensor(self.getOrDefault("mx"), X.device,
                           torch.float64)
        rng = torch.where(mx - mn == 0, torch.ones_like(mn), mx - mn)
        return append_prediction(df, batch, n, (X - mn) / rng,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class StringIndexer(Estimator):
    inputCol = Param("inputCol", "input column", None)
    outputCol = Param("outputCol", "output column", None)
    handleInvalid = Param("handleInvalid", "error|keep", "error")

    def _fit(self, df):
        batch, n = execute_batch(df)
        col = self.getOrDefault("inputCol")
        freq: Dict[Any, int] = {}
        for v in _words(batch, col, n):
            if v is not None:
                freq[v] = freq.get(v, 0) + 1
        # most frequent first, ties broken alphabetically (Spark order)
        labels = [k for k, _ in sorted(freq.items(),
                                       key=lambda kv: (-kv[1], str(kv[0])))]
        return StringIndexerModel(
            inputCol=col, outputCol=self.getOrDefault("outputCol"),
            handleInvalid=self.getOrDefault("handleInvalid"), labels=labels)


class StringIndexerModel(Model):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    handleInvalid = Param("handleInvalid", "", "error")
    labels = Param("labels", "fitted labels", None)

    def transform(self, df):
        batch, n = execute_batch(df)
        vals = _words(batch, self.getOrDefault("inputCol"), n)
        labels = self.getOrDefault("labels")
        lookup = {v: i for i, v in enumerate(labels)}
        out = np.zeros(len(vals), np.float64)
        for i, v in enumerate(vals):
            if v in lookup:
                out[i] = lookup[v]
            elif self.getOrDefault("handleInvalid") == "keep":
                out[i] = len(labels)
            else:
                raise AnalysisException(f"unseen label: {v}")
        return append_prediction(df, batch, n, out,
                                 self.getOrDefault("outputCol"), T.float64)


class IndexToString(Transformer):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    labels = Param("labels", "", None)

    def transform(self, df):
        batch, n = execute_batch(df)
        idx = _host_column(batch, self.getOrDefault("inputCol"), n)
        labels = self.getOrDefault("labels")
        strings = [labels[int(i)] if 0 <= int(i) < len(labels) else None
                   for i in idx]
        return _append_string_column(df, batch, n, strings,
                                     self.getOrDefault("outputCol"))


class OneHotEncoder(Transformer):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    dropLast = Param("dropLast", "drop last category", True)

    def transform(self, df):
        batch, n = execute_batch(df)
        idx = batch.column(self.getOrDefault("inputCol")).data[:n] \
            .to(torch.int64)
        k = int(idx.max()) + 1 if n else 1
        width = k - 1 if self.getOrDefault("dropLast") else k
        mat = torch.zeros((n, max(width, 1)), dtype=torch.float64,
                          device=idx.device)
        rows = torch.nonzero(idx < width).flatten()
        mat[rows, idx[rows]] = 1.0
        return append_prediction(df, batch, n, mat,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class Tokenizer(Transformer):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)

    def transform(self, df):
        # tokens are re-joined with \x00 (string columns are scalar); the
        # HashingTF stage splits again — the pair composes like the reference
        batch, n = execute_batch(df)
        vals = _words(batch, self.getOrDefault("inputCol"), n)
        joined = ["\x00".join(str(v).lower().split()) if v is not None
                  else None for v in vals]
        return _append_string_column(df, batch, n, joined,
                                     self.getOrDefault("outputCol"))


class HashingTF(Transformer):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    numFeatures = Param("numFeatures", "buckets", 262144)

    def transform(self, df):
        import zlib
        batch, n = execute_batch(df)
        vals = _words(batch, self.getOrDefault("inputCol"), n)
        nf = self.getOrDefault("numFeatures")
        mat = np.zeros((n, nf), np.float64)
        for i, v in enumerate(vals):
            for tok in _tokens(v):
                mat[i, zlib.crc32(tok.encode()) % nf] += 1.0
        return append_prediction(df, batch, n, mat,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class Binarizer(Transformer):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    threshold = Param("threshold", "", 0.0)

    def transform(self, df):
        batch, n = execute_batch(df)
        x = batch.column(self.getOrDefault("inputCol")).data[:n] \
            .to(torch.float64)
        out = (x > self.getOrDefault("threshold")).to(torch.float64)
        return append_prediction(df, batch, n, out,
                                 self.getOrDefault("outputCol"), T.float64)


class Bucketizer(Transformer):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    splits = Param("splits", "bucket boundaries", None)

    def transform(self, df):
        batch, n = execute_batch(df)
        x = batch.column(self.getOrDefault("inputCol")).data[:n] \
            .to(torch.float64)
        splits = device_tensor(
            np.asarray(self.getOrDefault("splits"), np.float64), x.device)
        idx = (torch.searchsorted(splits, x, right=True) - 1) \
            .clamp(0, len(splits) - 2).to(torch.float64)
        return append_prediction(df, batch, n, idx,
                                 self.getOrDefault("outputCol"), T.float64)


class SQLTransformer(Transformer):
    statement = Param("statement", "SQL with __THIS__ placeholder", None)

    def transform(self, df):
        from ..sql.analyzer import Analyzer
        from ..sql.dataframe import DataFrame
        stmt = self.getOrDefault("statement")
        name = f"__sql_transformer_{id(self):x}"
        df.createOrReplaceTempView(name)
        try:
            out = df.session.sql(stmt.replace("__THIS__", name))
            # resolve eagerly: the plan must survive the view being dropped
            plan = Analyzer(df.session.catalog).analyze(out._plan)
            return DataFrame(df.session, plan)
        finally:
            df.session.catalog.drop(name)


class PCA(Estimator):
    inputCol = Param("inputCol", "", "features")
    outputCol = Param("outputCol", "", "pca")
    k = Param("k", "components", 2)

    def _fit(self, df):
        X, _, _ = extract_matrix(df, self.getOrDefault("inputCol"))
        mean = X.mean(dim=0)
        # the singular vectors' signs are the solver's choice, as numpy's
        # are LAPACK's
        _, _, vt = torch.linalg.svd(X - mean, full_matrices=False)
        k = self.getOrDefault("k")
        return PCAModel(inputCol=self.getOrDefault("inputCol"),
                        outputCol=self.getOrDefault("outputCol"),
                        k=k, components=vt[:k], mean=mean)


class PCAModel(Model):
    inputCol = Param("inputCol", "", "features")
    outputCol = Param("outputCol", "", "pca")
    k = Param("k", "", 2)
    components = Param("components", "", None)
    mean = Param("mean", "", None)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("inputCol"))
        mean = device_tensor(self.getOrDefault("mean"), X.device,
                             torch.float64)
        comps = device_tensor(self.getOrDefault("components"), X.device,
                              torch.float64)
        return append_prediction(df, batch, n, (X - mean) @ comps.T,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class CountVectorizer(Estimator):
    """Vocabulary-based term-count vectors (`ml/feature/CountVectorizer.scala:136`
    analog).  Input: a \x00-joined token string column (Tokenizer
    convention); output: a dense count vector per row over the fitted
    vocabulary (vocab ordered by descending corpus frequency, ties by
    term, like the reference's sortBy(-count))."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    vocabSize = Param("vocabSize", "max vocabulary size", 1 << 18)
    minDF = Param("minDF", "min documents containing a term (count if >=1, "
                  "fraction if <1)", 1.0)
    minTF = Param("minTF", "per-row min term count (count if >=1, fraction "
                  "of row tokens if <1)", 1.0)
    binary = Param("binary", "0/1 presence instead of counts", False)

    def _fit(self, df):
        batch, n = execute_batch(df)
        doc_freq: dict = {}
        corpus_freq: dict = {}
        for v in _words(batch, self.getOrDefault("inputCol"), n):
            toks = _tokens(v)
            for t in toks:
                corpus_freq[t] = corpus_freq.get(t, 0) + 1
            for t in set(toks):
                doc_freq[t] = doc_freq.get(t, 0) + 1
        min_df = self.getOrDefault("minDF")
        need = min_df if min_df >= 1 else min_df * max(n, 1)
        terms = [t for t, c in doc_freq.items() if c >= need]
        terms.sort(key=lambda t: (-corpus_freq[t], t))
        vocab = terms[: self.getOrDefault("vocabSize")]
        return CountVectorizerModel(
            inputCol=self.getOrDefault("inputCol"),
            outputCol=self.getOrDefault("outputCol"),
            minTF=self.getOrDefault("minTF"),
            binary=self.getOrDefault("binary"),
            vocabulary=vocab)


class CountVectorizerModel(Model):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    minTF = Param("minTF", "", 1.0)
    binary = Param("binary", "", False)
    vocabulary = Param("vocabulary", "fitted terms, frequency-descending",
                       None)

    def transform(self, df):
        batch, n = execute_batch(df)
        vals = _words(batch, self.getOrDefault("inputCol"), n)
        vocab = list(self.getOrDefault("vocabulary") or [])
        index = {t: i for i, t in enumerate(vocab)}
        min_tf = self.getOrDefault("minTF")
        binary = self.getOrDefault("binary")
        mat = np.zeros((n, max(len(vocab), 1)), np.float64)
        for i, v in enumerate(vals):
            toks = _tokens(v)
            for t in toks:
                j = index.get(t)
                if j is not None:
                    mat[i, j] += 1.0
            thresh = min_tf if min_tf >= 1 else min_tf * max(len(toks), 1)
            mat[i] = np.where(mat[i] >= max(thresh, 1e-300), mat[i], 0.0)
            if binary:
                mat[i] = (mat[i] > 0).astype(np.float64)
        return append_prediction(df, batch, n, mat,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class Word2Vec(Estimator):
    """Skip-gram word embeddings (`ml/feature/Word2Vec.scala:119` /
    `mllib/feature/Word2Vec.scala:42` analog).

    As in the reference: skip-gram with NEGATIVE SAMPLING as one Adam
    loop over the (center, context) pair tensor, each step two embedding
    gathers + a batched dot, float32.  The fit is split in three:
    ``_prepare`` (vocabulary and pairs, host), ``_initial_state`` (the
    drawn input embeddings and the negative-sample draw, from a
    ``torch.Generator`` seeded by ``seed``) and ``_train`` (the Adam
    loop from a given state)."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    vectorSize = Param("vectorSize", "embedding dimension", 100)
    windowSize = Param("windowSize", "context window", 5)
    minCount = Param("minCount", "min corpus occurrences", 5)
    maxIter = Param("maxIter", "training epochs", 1)
    stepSize = Param("stepSize", "Adam learning rate", 0.025)
    seed = Param("seed", "", 42)
    negative = Param("negative", "negative samples per pair", 5)
    maxSentenceLength = Param("maxSentenceLength", "tokens per row cap",
                              1000)

    def _fit(self, df):
        prep = self._prepare(df)
        return self._train(prep, self._initial_state(prep))

    def _prepare(self, df) -> Dict[str, Any]:
        """Vocabulary (frequency-descending, then term), the (center,
        context) pairs on the device, and the unigram^(3/4)
        negative-sampling distribution."""
        batch, n = execute_batch(df)
        cap_len = self.getOrDefault("maxSentenceLength")
        sents = [_tokens(v)[:cap_len]
                 for v in _words(batch, self.getOrDefault("inputCol"), n)
                 if v is not None]
        freq: dict = {}
        for s in sents:
            for t in s:
                freq[t] = freq.get(t, 0) + 1
        vocab = sorted((t for t, c in freq.items()
                        if c >= self.getOrDefault("minCount")),
                       key=lambda t: (-freq[t], t))
        if not vocab:
            raise AnalysisException("Word2Vec: empty vocabulary (minCount "
                                    "filtered every token)")
        index = {t: i for i, t in enumerate(vocab)}
        win = self.getOrDefault("windowSize")
        centers, contexts = [], []
        for s in sents:
            ids = [index[t] for t in s if t in index]
            for i, c in enumerate(ids):
                for j in range(max(0, i - win), min(len(ids), i + win + 1)):
                    if j != i:
                        centers.append(c)
                        contexts.append(ids[j])
        if not centers:
            raise AnalysisException("Word2Vec: no (center, context) pairs "
                                    "(rows shorter than 2 tokens?)")
        dev = batch.device
        counts = np.array([freq[t] for t in vocab], np.float64) ** 0.75
        return {"vocab": vocab, "device": dev,
                "centers": torch.tensor(centers, dtype=torch.int64,
                                        device=dev),
                "contexts": torch.tensor(contexts, dtype=torch.int64,
                                         device=dev),
                "neg_probs": torch.from_numpy(counts / counts.sum()).to(dev),
                "epochs": max(self.getOrDefault("maxIter"), 1) * 40}

    def _initial_state(self, prep) -> Dict[str, Any]:
        """W_in ~ U(-0.5/dim, 0.5/dim) float32 and a draw of ``negative``
        samples per pair per epoch, from one generator seeded by
        ``seed``."""
        dev = prep["device"]
        dim = self.getOrDefault("vectorSize")
        k_neg = self.getOrDefault("negative")
        V, P = len(prep["vocab"]), int(prep["centers"].shape[0])
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self.getOrDefault("seed")))
        w_in = (torch.rand((V, dim), generator=gen, device=dev,
                           dtype=torch.float32) - 0.5) / dim
        probs = prep["neg_probs"]

        def negatives(_epoch):
            return torch.multinomial(probs, P * k_neg, replacement=True,
                                     generator=gen).view(P, k_neg)
        return {"w_in": w_in, "negatives": negatives}

    def _train(self, prep, state) -> "Word2VecModel":
        """Adam over the negative-sampling loss from ``state``'s W_in
        (W_out starts at 0), one step per epoch with that epoch's
        negatives."""
        import torch.nn.functional as Fn
        ce_idx, co_idx = prep["centers"], prep["contexts"]
        w_in = device_tensor(state["w_in"], prep["device"],
                             torch.float32)
        params = [w_in.clone().requires_grad_(True),
                  torch.zeros_like(w_in).requires_grad_(True)]
        opt = Adam(params, self.getOrDefault("stepSize"))
        for e in range(prep["epochs"]):
            negs = device_tensor(state["negatives"](e), prep["device"],
                                 torch.int64)
            wi, wo = params
            ce = wi[ce_idx]                           # (P, dim) gather
            co = wo[co_idx]
            pos = (ce * co).sum(dim=1)
            neg = torch.einsum("pd,pkd->pk", ce, wo[negs])
            loss = -(Fn.logsigmoid(pos).mean()
                     + Fn.logsigmoid(-neg).sum(dim=1).mean())
            grads = torch.autograd.grad(loss, params)
            params = opt.step(params, grads)
        return Word2VecModel(
            inputCol=self.getOrDefault("inputCol"),
            outputCol=self.getOrDefault("outputCol"),
            vocabulary=prep["vocab"],
            vectors=params[0].detach().to(torch.float64))


class Word2VecModel(Model):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    vocabulary = Param("vocabulary", "", None)
    vectors = Param("vectors", "(V, dim) embedding matrix", None)

    def _vecs(self):
        return (list(self.getOrDefault("vocabulary") or []),
                to_numpy(self.getOrDefault("vectors")).astype(np.float64))

    def getVectors(self, session):
        """DataFrame(word, vector) of the fitted embeddings."""
        from ..columnar import ColumnBatch, ColumnVector
        from ..sql import logical as L
        from ..sql.dataframe import DataFrame
        vocab, vecs = self._vecs()
        cap = max(len(vocab), 1)
        dev = session.device
        batch = ColumnBatch(
            ["word", "vector"],
            [_string_vector(vocab, cap, dev),
             ColumnVector(torch.from_numpy(vecs if len(vocab)
                                           else np.zeros((1, 1))).to(dev),
                          T.ArrayType(T.float64), None, None)],
            torch.arange(cap, device=dev) < len(vocab), cap)
        return DataFrame(session, L.LocalRelation(batch))

    def findSynonyms(self, word: str, num: int):
        """[(word, cosine similarity)] of the num nearest terms."""
        vocab, vecs = self._vecs()
        if word not in vocab:
            raise AnalysisException(f"word {word!r} not in vocabulary")
        q = vecs[vocab.index(word)]
        norms = np.linalg.norm(vecs, axis=1) * max(np.linalg.norm(q), 1e-300)
        sims = vecs @ q / np.where(norms > 0, norms, 1e-300)
        order = np.argsort(-sims)
        return [(vocab[i], float(sims[i])) for i in order
                if vocab[i] != word][:num]

    def transform(self, df):
        """Row vector = mean of its tokens' embeddings (document vector,
        `ml/feature/Word2Vec.scala:289` transform contract)."""
        batch, n = execute_batch(df)
        vals = _words(batch, self.getOrDefault("inputCol"), n)
        vocab, vecs = self._vecs()
        index = {t: i for i, t in enumerate(vocab)}
        dim = vecs.shape[1] if vecs.ndim == 2 else 1
        mat = np.zeros((n, dim), np.float64)
        for i, v in enumerate(vals):
            ids = [index[t] for t in _tokens(v) if t in index]
            if ids:
                mat[i] = vecs[ids].mean(axis=0)
        return append_prediction(df, batch, n, mat,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class IDF(Estimator):
    """Inverse document frequency over count vectors
    (`ml/feature/IDF.scala:68`): idf = log((m+1)/(df+1)), the reference's
    smoothed formula; fit is one column-wise device reduction."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    minDocFreq = Param("minDocFreq", "zero idf below this df", 0)

    def _fit(self, df):
        X, _batch, n = extract_matrix(df, self.getOrDefault("inputCol"))
        dfreq = (X > 0).sum(dim=0).to(torch.float64)
        idf = torch.log((n + 1.0) / (dfreq + 1.0))
        idf[dfreq < self.getOrDefault("minDocFreq")] = 0.0
        return IDFModel(inputCol=self.getOrDefault("inputCol"),
                        outputCol=self.getOrDefault("outputCol"), idf=idf)


class IDFModel(Model):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    idf = Param("idf", "(V,) idf vector", None)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("inputCol"))
        idf = device_tensor(self.getOrDefault("idf"), X.device,
                            torch.float64)
        return append_prediction(df, batch, n, X * idf,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class Normalizer(Transformer):
    """Row p-norm scaling (`ml/feature/Normalizer.scala:39`)."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    p = Param("p", "norm order", 2.0)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("inputCol"))
        p = self.getOrDefault("p")
        if np.isinf(p):
            norms = X.abs().amax(dim=1)
        else:
            norms = (X.abs() ** p).sum(dim=1) ** (1.0 / p)
        norms = torch.where(norms > 0, norms, torch.ones_like(norms))
        return append_prediction(df, batch, n, X / norms[:, None],
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class MaxAbsScaler(Estimator):
    """Per-feature division by max |x| (`ml/feature/MaxAbsScaler.scala:62`):
    preserves sparsity/sign, lands in [-1, 1]."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)

    def _fit(self, df):
        X, _batch, _n = extract_matrix(df, self.getOrDefault("inputCol"))
        return MaxAbsScalerModel(
            inputCol=self.getOrDefault("inputCol"),
            outputCol=self.getOrDefault("outputCol"),
            maxAbs=X.abs().amax(dim=0))


class MaxAbsScalerModel(Model):
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    maxAbs = Param("maxAbs", "", None)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("inputCol"))
        m = device_tensor(self.getOrDefault("maxAbs"), X.device,
                          torch.float64)
        return append_prediction(
            df, batch, n, X / torch.where(m > 0, m, torch.ones_like(m)),
            self.getOrDefault("outputCol"), T.ArrayType(T.float64))


#: `ml/feature/StopWordsRemover.scala` default english list (abridged to
#: the reference's most common members; loadDefaultStopWords analog)
_ENGLISH_STOP_WORDS = frozenset("""a about above after again against all am
an and any are as at be because been before being below between both but
by could did do does doing down during each few for from further had has
have having he her here hers herself him himself his how i if in into is
it its itself me more most my myself no nor not of off on once only or
other ought our ours ourselves out over own same she should so some such
than that the their theirs them themselves then there these they this
those through to too under until up very was we were what when where which
while who whom why with would you your yours yourself yourselves""".split())


class StopWordsRemover(Transformer):
    """Filter stop words out of a token column
    (`ml/feature/StopWordsRemover.scala:43`); \\x00-joined Tokenizer
    convention in and out."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    stopWords = Param("stopWords", "None = english default", None)
    caseSensitive = Param("caseSensitive", "", False)

    def transform(self, df):
        batch, n = execute_batch(df)
        vals = _words(batch, self.getOrDefault("inputCol"), n)
        sw = self.getOrDefault("stopWords")
        stop = set(sw) if sw is not None else set(_ENGLISH_STOP_WORDS)
        cs = self.getOrDefault("caseSensitive")
        if not cs:
            stop = {w.lower() for w in stop}
        out_rows = []
        for v in vals:
            if v is None:
                out_rows.append(None)
                continue
            kept = [t for t in _tokens(v)
                    if (t if cs else t.lower()) not in stop]
            out_rows.append("\x00".join(kept))
        return _append_string_column(df, batch, n, out_rows,
                                     self.getOrDefault("outputCol"))


class NGram(Transformer):
    """Token n-grams (`ml/feature/NGram.scala:38`): space-joined grams,
    \\x00-separated gram list (Tokenizer convention)."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    n = Param("n", "gram size", 2)

    def transform(self, df):
        batch, nrows = execute_batch(df)
        vals = _words(batch, self.getOrDefault("inputCol"), nrows)
        g = self.getOrDefault("n")
        out_rows = []
        for v in vals:
            if v is None:
                out_rows.append(None)
                continue
            toks = _tokens(v)
            grams = [" ".join(toks[i:i + g])
                     for i in range(len(toks) - g + 1)]
            out_rows.append("\x00".join(grams))
        return _append_string_column(df, batch, nrows, out_rows,
                                     self.getOrDefault("outputCol"))


class QuantileDiscretizer(Estimator):
    """Quantile-boundary binning (`ml/feature/QuantileDiscretizer.scala:93`):
    fit computes numBuckets quantile splits (numpy's, on the host, as in
    the reference), producing a Bucketizer."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    numBuckets = Param("numBuckets", "", 2)

    def _fit(self, df):
        batch, n = execute_batch(df)
        x = _host_column(batch, self.getOrDefault("inputCol"), n) \
            .astype(np.float64)
        if np.isnan(x).any():
            # NaN poisons every quantile and un-sorts the splits; the
            # reference errors under default handleInvalid too
            raise AnalysisException(
                "QuantileDiscretizer: input column contains NaN; impute "
                "or filter first")
        nb = self.getOrDefault("numBuckets")
        qs = np.quantile(x, np.linspace(0, 1, nb + 1)[1:-1])
        splits = [-np.inf] + sorted(set(qs.tolist())) + [np.inf]
        return Bucketizer(inputCol=self.getOrDefault("inputCol"),
                          outputCol=self.getOrDefault("outputCol"),
                          splits=splits)


def _missing(x: torch.Tensor, vec, n: int, mv: float) -> torch.Tensor:
    """Cells an Imputer fills: the missing value (NaN by default) or
    NULL."""
    bad = torch.isnan(x) if np.isnan(mv) else (x == mv)
    if vec.valid is not None:
        bad = bad | ~vec.valid[:n]
    return bad


class Imputer(Estimator):
    """Missing-value imputation by mean/median
    (`ml/feature/Imputer.scala:88`).  NULL (invalid) cells and an
    optional sentinel (missingValue, default NaN) impute per column."""
    inputCols = Param("inputCols", "", None)
    outputCols = Param("outputCols", "", None)
    strategy = Param("strategy", "mean|median", "mean")
    missingValue = Param("missingValue", "", float("nan"))

    def _fit(self, df):
        strategy = self.getOrDefault("strategy")
        if strategy not in ("mean", "median"):
            raise AnalysisException(
                f"Imputer strategy must be 'mean' or 'median', got "
                f"{strategy!r}")
        batch, n = execute_batch(df)
        mv = self.getOrDefault("missingValue")
        stats = {}
        for c in self.getOrDefault("inputCols"):
            vec = batch.column(c)
            x = vec.data[:n].to(torch.float64)
            vals = x[~_missing(x, vec, n, mv)]
            if len(vals) == 0:
                raise AnalysisException(f"Imputer: column {c!r} has no "
                                        "non-missing values")
            if strategy == "median":
                # numpy's median: the mean of the two middle values
                s = torch.sort(vals).values
                m = len(s)
                med = s[m // 2] if m % 2 else (s[m // 2 - 1] + s[m // 2]) / 2
                stats[c] = float(med)
            else:
                stats[c] = float(vals.mean())
        return ImputerModel(inputCols=self.getOrDefault("inputCols"),
                            outputCols=self.getOrDefault("outputCols"),
                            missingValue=mv, surrogates=stats)


class ImputerModel(Model):
    inputCols = Param("inputCols", "", None)
    outputCols = Param("outputCols", "", None)
    missingValue = Param("missingValue", "", float("nan"))
    surrogates = Param("surrogates", "col → fill value", None)

    def transform(self, df):
        from ..columnar import ColumnBatch, ColumnVector
        from ..sql import logical as L
        from ..sql.dataframe import DataFrame
        mv = self.getOrDefault("missingValue")
        sur = self.getOrDefault("surrogates")
        batch, n = execute_batch(df)          # ONE execution for all columns
        names = list(batch.names)
        vectors = list(batch.vectors)
        for c, o in zip(self.getOrDefault("inputCols"),
                        self.getOrDefault("outputCols")):
            vec = batch.column(c)
            x = vec.data[:n].to(torch.float64)
            full = torch.zeros(batch.capacity, dtype=torch.float64,
                               device=x.device)
            full[:n] = torch.where(_missing(x, vec, n, mv),
                                   torch.full_like(x, sur[c]), x)
            names.append(o)
            vectors.append(ColumnVector(full, T.float64, None, None))
        out = ColumnBatch(names, vectors, batch.row_valid, batch.capacity)
        return DataFrame(df.session, L.LocalRelation(out))


class PolynomialExpansion(Transformer):
    """Polynomial feature expansion (`ml/feature/PolynomialExpansion.scala:42`):
    all monomials of total degree 1..degree, sklearn term order
    (include_bias=False)."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    degree = Param("degree", "", 2)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("inputCol"))
        d = X.shape[1]
        cols = [X[:, list(combo)].prod(dim=1)
                for deg in range(1, self.getOrDefault("degree") + 1)
                for combo in itertools.combinations_with_replacement(
                    range(d), deg)]
        return append_prediction(df, batch, n, torch.stack(cols, dim=1),
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


class ElementwiseProduct(Transformer):
    """Hadamard product with a fixed scaling vector
    (`ml/feature/ElementwiseProduct.scala:36`)."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    scalingVec = Param("scalingVec", "", None)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("inputCol"))
        w = device_tensor(np.asarray(self.getOrDefault("scalingVec"),
                                     np.float64), X.device)
        return append_prediction(df, batch, n, X * w,
                                 self.getOrDefault("outputCol"),
                                 T.ArrayType(T.float64))


def _select_slots(df, col: str, indices, out_col: str):
    X, batch, n = extract_matrix(df, col)
    return append_prediction(df, batch, n, X[:, list(indices)], out_col,
                             T.ArrayType(T.float64))


class VectorSlicer(Transformer):
    """Select vector sub-features by index
    (`ml/feature/VectorSlicer.scala:41`)."""
    inputCol = Param("inputCol", "", None)
    outputCol = Param("outputCol", "", None)
    indices = Param("indices", "", None)

    def transform(self, df):
        return _select_slots(df, self.getOrDefault("inputCol"),
                             self.getOrDefault("indices"),
                             self.getOrDefault("outputCol"))


class ChiSqSelector(Estimator):
    """Top-k feature selection by chi-square statistic against the label
    (`ml/feature/ChiSqSelector.scala:56`, numTopFeatures mode)."""
    featuresCol = Param("featuresCol", "", "features")
    labelCol = Param("labelCol", "", "label")
    outputCol = Param("outputCol", "", None)
    numTopFeatures = Param("numTopFeatures", "", 50)

    def _fit(self, df):
        from .stat import ChiSquareTest
        row, = ChiSquareTest.test(
            df, self.getOrDefault("featuresCol"),
            self.getOrDefault("labelCol")).collect()
        stats = np.asarray(row["statistics"], np.float64)
        pvals = np.asarray(row["pValues"], np.float64)
        k = min(self.getOrDefault("numTopFeatures"), len(stats))
        # rank by ascending p-value (the reference's numTopFeatures mode
        # sorts the ChiSqTestResult by pValue); break p-value ties on the
        # larger statistic so saturated-small p's still order sensibly
        order = np.lexsort((-stats, pvals))
        selected = sorted(order[:k].tolist())
        return ChiSqSelectorModel(
            featuresCol=self.getOrDefault("featuresCol"),
            outputCol=self.getOrDefault("outputCol"),
            selectedFeatures=selected)


class ChiSqSelectorModel(Model):
    featuresCol = Param("featuresCol", "", "features")
    outputCol = Param("outputCol", "", None)
    selectedFeatures = Param("selectedFeatures", "sorted kept indices",
                             None)

    def transform(self, df):
        return _select_slots(df, self.getOrDefault("featuresCol"),
                             self.getOrDefault("selectedFeatures"),
                             self.getOrDefault("outputCol"))


class RFormula(Estimator):
    """R model formulas (`ml/feature/RFormula.scala:88` / RFormulaParser):
    ``label ~ term + term``, ``.`` (all other columns), ``-`` removal
    (incl. ``- 1`` no-intercept, accepted and recorded), ``a:b`` numeric
    interactions.  String terms one-hot encode through
    StringIndexer+OneHotEncoder (reference-order dummy coding); the label
    string-indexes when non-numeric."""
    formula = Param("formula", "", None)
    featuresCol = Param("featuresCol", "", "features")
    labelCol = Param("labelCol", "", "label")

    def _parse(self, schema_names):
        f = self.getOrDefault("formula")
        if not f or "~" not in f:
            raise AnalysisException(f"RFormula needs 'label ~ terms', "
                                    f"got {f!r}")
        lhs, rhs = [side.strip() for side in f.split("~", 1)]
        terms: List = []
        removed: set = set()
        intercept = True
        for raw in rhs.split("+"):
            for piece in raw.split("-")[0:1]:
                piece = piece.strip()
                if piece == ".":
                    terms.extend(c for c in schema_names
                                 if c != lhs and c not in terms)
                elif piece:
                    terms.append(piece)
            for neg in raw.split("-")[1:]:
                neg = neg.strip()
                if neg == "1":
                    intercept = False
                elif neg:
                    removed.add(neg)
        deduped: List[str] = []
        for t in terms:                     # explicit repeats collapse too
            if t not in removed and t not in deduped:
                deduped.append(t)
        return lhs, deduped, intercept

    def _fit(self, df):
        names = df.schema.names
        label, terms, intercept = self._parse(names)
        batch, _n = execute_batch(df)
        stages: List = []
        for t in terms:
            if ":" in t:
                a, b = [p.strip() for p in t.split(":", 1)]
                for side in (a, b):
                    if batch.column(side).dtype.is_string:
                        raise AnalysisException(
                            f"RFormula interaction {t!r}: categorical "
                            "interactions are not supported (string "
                            "dictionary codes are not numeric values)")
                stages.append(("interact", (a, b)))
                continue
            if batch.column(t).dtype.is_string:
                stages.append(("onehot", t))
            else:
                stages.append(("num", t))
        label_is_string = label in names and \
            batch.column(label).dtype.is_string
        model = RFormulaModel(
            featuresCol=self.getOrDefault("featuresCol"),
            labelCol=self.getOrDefault("labelCol"),
            label=label, stages=stages, hasIntercept=intercept,
            labelIsString=label_is_string)
        # fit sub-models (string indexers) on this data
        model._fit_encoders(df)
        return model


class RFormulaModel(Model):
    label = Param("label", "", None)
    stages = Param("stages", "[(kind, spec)]", None)
    hasIntercept = Param("hasIntercept", "", True)
    labelIsString = Param("labelIsString", "", False)
    encoders = Param("encoders", "col → fitted StringIndexerModel", None)
    labelIndexer = Param("labelIndexer", "", None)

    def _fit_encoders(self, df):
        enc = {}
        for kind, spec in self.getOrDefault("stages"):
            if kind == "onehot":
                enc[spec] = StringIndexer(
                    inputCol=spec, outputCol=f"{spec}_si").fit(df)
        self.set("encoders", enc)
        if self.getOrDefault("labelIsString"):
            self.set("labelIndexer", StringIndexer(
                inputCol=self.getOrDefault("label"),
                outputCol="__rf_label__").fit(df))

    def transform(self, df):
        batch, n = execute_batch(df)       # ONE execution covers all terms
        dev = batch.device
        parts = []
        enc = self.getOrDefault("encoders") or {}
        for kind, spec in self.getOrDefault("stages"):
            if kind == "num":
                parts.append(column_matrix(batch, spec, n))
            elif kind == "interact":
                a, b = spec
                parts.append(column_matrix(batch, a, n)
                             * column_matrix(batch, b, n))
            else:                          # onehot from the fitted labels
                labels = enc[spec].getOrDefault("labels")
                lookup = {v: i for i, v in enumerate(labels)}
                k = len(labels)
                # dummy coding: drop the last category (reference
                # OneHotEncoder default dropLast=true); unseen → zeros
                oh = np.zeros((n, max(k - 1, 0)))
                for i, v in enumerate(_words(batch, spec, n)):
                    j = lookup.get(v, k)
                    if j < k - 1:
                        oh[i, j] = 1.0
                parts.append(torch.from_numpy(oh).to(dev))
        mat = torch.cat(parts, dim=1) if parts else \
            torch.zeros((n, 0), dtype=torch.float64, device=dev)
        out = append_prediction(df, batch, n, mat,
                                self.getOrDefault("featuresCol"),
                                T.ArrayType(T.float64))
        # the label column is OPTIONAL at scoring time (the reference
        # appends it only when present — unlabeled data must transform)
        label = self.getOrDefault("label")
        if label not in batch.names:
            return out
        li = self.getOrDefault("labelIndexer")
        if li is not None:
            labels = li.getOrDefault("labels")
            lookup = {v: float(i) for i, v in enumerate(labels)}
            lab = torch.tensor([lookup.get(v, float(len(labels)))
                                for v in _words(batch, label, n)],
                               dtype=torch.float64)
        else:
            lab = batch.column(label).data[:n].to(torch.float64)
        b3 = out._plan.batch
        return append_prediction(out, b3, n, lab,
                                 self.getOrDefault("labelCol"), T.float64)
