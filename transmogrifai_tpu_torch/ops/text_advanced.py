"""Advanced text features: count vectorization, TF-IDF, Word2Vec, LDA.

The port's copy of ``transmogrifai_tpu/ops/text_advanced.py``, the
reference's wrapped Spark text stages (core/src/main/scala/com/salesforce/
op/stages/impl/feature/OpCountVectorizer.scala, the HashingTF+IDF TF-IDF
pipeline, OpWord2Vec.scala, OpLDA.scala):

- :class:`CountVectorizer`: vocabulary-based token counts with
  ``min_df``/``max_vocab`` pruning (MLlib CountVectorizer semantics);
- :class:`TfIdfVectorizer`: token counts scaled by MLlib's smoothed
  inverse document frequency ``log((n+1)/(df+1))``;
- :class:`Word2Vec`: skip-gram with negative sampling; a document
  transforms to the mean of its token vectors, as MLlib's does;
- :class:`LDA`: online variational-Bayes topic model; the feature vector
  is the document-topic mixture, as OpLDA's.

The counting, the vocabularies and the Word2Vec transform are host numpy,
as in the JAX package. The device work of the JAX package runs on a
``device`` here: Word2Vec's SGD epochs (the JAX package's jitted
``lax.scan``) as torch ops in the working dtype, one CUDA graph of a step
replayed for every minibatch on the card; LDA's E-step (fixed-point gamma
updates over all documents at once, the JAX package's vmapped
``fori_loop``) and its M-step in float64, on the card too: float32 flushes
``exp(digamma(0.01) - ...)`` (about 3.7e-44) toward zero, and the
``+ 1e-100`` guard on ``phi_norm`` is 0 in float32, so a word could divide
0 by 0. Every draw (the Word2Vec shuffle, negatives and initial vectors,
LDA's initial topics) comes from numpy's ``default_rng(seed)`` in the JAX
package's order, so one seed gives both packages the same draws.

The estimators fit on ``device``: by default the workflow's (a prepare
plan hands its own), a fit outside a workflow on the card, raising
without one. ``LDAModel`` runs its E-step on its ``device`` at transform
time; the plans run it as a host stage (it has no array kernel), its
torch ops on that device.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..stages.base import (SequenceEstimator, SequenceModel, UnaryEstimator,
                           UnaryModel)
from ..types import OPVector, TextList
from ..utils.device import resolve_device, working_dtype
from .vector_utils import VectorColumnMetadata, vector_output

__all__ = ["CountVectorizer", "CountVectorizerModel", "TfIdfVectorizer",
           "TfIdfVectorizerModel", "Word2Vec", "Word2VecModel", "LDA",
           "LDAModel"]


# ---------------------------------------------------------------------------
# count vectorizer
# ---------------------------------------------------------------------------

def _count_matrix(token_lists, vocab_index: Dict[str, int],
                  binary: bool) -> np.ndarray:
    n, v = len(token_lists), len(vocab_index)
    mat = np.zeros((n, v), dtype=np.float64)
    for i, toks in enumerate(token_lists):
        if not toks:
            continue
        for t in toks:
            j = vocab_index.get(str(t))
            if j is not None:
                if binary:
                    mat[i, j] = 1.0
                else:
                    mat[i, j] += 1.0
    return mat


class CountVectorizerModel(SequenceModel):
    input_types = (TextList,)
    output_type = OPVector
    #: the descriptor of every output column (TF-IDF's is "tfidf")
    descriptor: Optional[str] = None

    def __init__(self, vocabulary: List[List[str]], binary: bool = False,
                 uid: Optional[str] = None):
        super().__init__(operation_name="countVec", uid=uid)
        self.vocabulary = [list(v) for v in vocabulary]
        self.binary = binary
        self._meta_cache: tuple = (None, ())

    def _column_metas(self) -> tuple:
        """The output columns' metadata, at their indices: built once per
        input wiring (per-record scoring asks for it on every record)."""
        key = tuple((f.name, f.ftype.__name__) for f in self.input_features)
        if self._meta_cache[0] != key:
            terms = [(name, ftype, t)
                     for (name, ftype), vocab in zip(key, self.vocabulary)
                     for t in vocab]
            self._meta_cache = (key, tuple(VectorColumnMetadata(
                parent_feature_name=name, parent_feature_type=ftype,
                grouping=name, indicator_value=t,
                descriptor_value=self.descriptor, index=i)
                for i, (name, ftype, t) in enumerate(terms)))
        return self._meta_cache[1]

    def _blocks(self, cols: List[FeatureColumn]) -> List[np.ndarray]:
        return [_count_matrix(col.data, {t: j for j, t in enumerate(vocab)},
                              self.binary)
                for col, vocab in zip(cols, self.vocabulary)]

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        return vector_output(self.get_output().name, self._blocks(cols),
                             self._column_metas())


class CountVectorizer(SequenceEstimator):
    """(reference OpCountVectorizer.scala / MLlib CountVectorizer)"""

    input_types = (TextList,)
    output_type = OPVector

    def __init__(self, min_df: int = 1, max_vocab: int = 10_000,
                 binary: bool = False, uid: Optional[str] = None):
        super().__init__(operation_name="countVec", uid=uid)
        self.min_df = min_df
        self.max_vocab = max_vocab
        self.binary = binary

    def _fit_vocab(self, col: FeatureColumn) -> List[str]:
        df: Dict[str, int] = {}
        for toks in col.data:
            if not toks:
                continue
            for t in set(str(x) for x in toks):
                df[t] = df.get(t, 0) + 1
        terms = [(t, c) for t, c in df.items() if c >= self.min_df]
        terms.sort(key=lambda tc: (-tc[1], tc[0]))
        return [t for t, _ in terms[:self.max_vocab]]

    def fit_columns(self, cols: List[FeatureColumn]) -> CountVectorizerModel:
        return CountVectorizerModel(
            vocabulary=[self._fit_vocab(c) for c in cols],
            binary=self.binary)


class TfIdfVectorizerModel(CountVectorizerModel):
    descriptor = "tfidf"

    def __init__(self, vocabulary: List[List[str]],
                 idf: List[List[float]], uid: Optional[str] = None):
        super().__init__(vocabulary=vocabulary, binary=False, uid=uid)
        self.operation_name = "tfIdf"
        self.idf = [[float(x) for x in v] for v in idf]

    def _blocks(self, cols: List[FeatureColumn]) -> List[np.ndarray]:
        return [tf * np.asarray(idf)
                for tf, idf in zip(super()._blocks(cols), self.idf)]


class TfIdfVectorizer(CountVectorizer):
    """TF-IDF with MLlib's smoothed IDF ``log((n+1)/(df+1))``
    (reference TF-IDF via wrapped HashingTF + IDF)."""

    def __init__(self, min_df: int = 1, max_vocab: int = 10_000,
                 uid: Optional[str] = None):
        super().__init__(min_df=min_df, max_vocab=max_vocab, binary=False,
                         uid=uid)
        self.operation_name = "tfIdf"

    def fit_columns(self, cols: List[FeatureColumn]) -> TfIdfVectorizerModel:
        vocabs, idfs = [], []
        for col in cols:
            vocab = self._fit_vocab(col)
            index = {t: j for j, t in enumerate(vocab)}
            n = col.n_rows
            df = np.zeros(len(vocab))
            for toks in col.data:
                if not toks:
                    continue
                for t in set(str(x) for x in toks):
                    j = index.get(t)
                    if j is not None:
                        df[j] += 1
            vocabs.append(vocab)
            idfs.append(list(np.log((n + 1.0) / (df + 1.0))))
        return TfIdfVectorizerModel(vocabulary=vocabs, idf=idfs)


# ---------------------------------------------------------------------------
# word2vec (skip-gram, negative sampling)
# ---------------------------------------------------------------------------

def _w2v_step(emb: torch.Tensor, out: torch.Tensor, c: torch.Tensor,
              ctx: torch.Tensor, neg: torch.Tensor, lr: float) -> None:
    """One SGD step in place on the loss of the JAX package's
    ``_fit_w2v``, ``-(mean(log_sigmoid(v.u)) + mean(sum_k
    log_sigmoid(-v.u_k)))`` over a minibatch of (center ``c``, context
    ``ctx``, negatives ``neg``), with its gradient written out: the
    gathers' gradients scatter-add into dense ones, then ``x - lr * g``."""
    b = c.shape[0]
    v, u, un = emb[c], out[ctx], out[neg]           # (B,D) (B,D) (B,K,D)
    pos = (v * u).sum(dim=1)
    neg_s = torch.bmm(un, v.unsqueeze(2)).squeeze(2)              # (B,K)
    g_pos = -torch.sigmoid(-pos) / b          # d loss / d pos
    g_neg = torch.sigmoid(neg_s) / b          # d loss / d neg_s
    g_v = g_pos.unsqueeze(1) * u + torch.bmm(g_neg.unsqueeze(1),
                                             un).squeeze(1)
    g_emb = torch.zeros_like(emb).index_add_(0, c, g_v)
    g_out = torch.zeros_like(out).index_add_(0, ctx, g_pos.unsqueeze(1) * v)
    g_out.index_add_(0, neg.reshape(-1),
                     (g_neg.unsqueeze(2) * v.unsqueeze(1))
                     .reshape(-1, v.shape[1]))
    emb -= lr * g_emb
    out -= lr * g_out


def _fit_w2v(centers: torch.Tensor, contexts: torch.Tensor,
             negatives: torch.Tensor, emb: torch.Tensor, out: torch.Tensor,
             lr: float, epochs: int) -> torch.Tensor:
    """``epochs`` passes of SGD over the (n_batches, B) minibatches, in
    order, updating ``emb`` and ``out`` in place; returns ``emb``. On the
    card one step is captured as a CUDA graph that reads its minibatch
    through a step counter on the card, and replayed for every step; on
    the CPU the steps run eagerly."""
    n_batches = centers.shape[0]
    if emb.device.type != "cuda":
        for _ in range(epochs):
            for i in range(n_batches):
                _w2v_step(emb, out, centers[i], contexts[i], negatives[i],
                          lr)
        return emb
    dev = emb.device

    def step(e, o, t):
        i = torch.remainder(t, n_batches)
        _w2v_step(e, o, centers.index_select(0, i).squeeze(0),
                  contexts.index_select(0, i).squeeze(0),
                  negatives.index_select(0, i).squeeze(0), lr)
        t += 1

    t = torch.zeros(1, dtype=torch.int64, device=dev)
    # lazy initialization (the cuBLAS handle of bmm) must not happen
    # inside the capture: warm up on copies, on a side stream
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            step(emb.clone(), out.clone(), t.clone())
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step(emb, out, t)
    for _ in range(epochs * n_batches):
        graph.replay()
    torch.cuda.synchronize(dev)
    return emb


class Word2VecModel(UnaryModel):
    input_types = (TextList,)
    output_type = OPVector

    def __init__(self, vocabulary: List[str], vectors, uid: Optional[str]
                 = None):
        super().__init__(operation_name="word2Vec", uid=uid)
        self.vocabulary = [str(t) for t in vocabulary]
        self.vectors = np.asarray(vectors, dtype=np.float64)
        self._index = {t: i for i, t in enumerate(self.vocabulary)}

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        f = self.input_features[0]
        d = self.vectors.shape[1]
        out = np.zeros((cols[0].n_rows, d))
        for i, toks in enumerate(cols[0].data):
            if not toks:
                continue
            idx = [self._index[str(t)] for t in toks
                   if str(t) in self._index]
            if idx:
                out[i] = self.vectors[idx].mean(axis=0)
        metas = [VectorColumnMetadata(
            parent_feature_name=f.name,
            parent_feature_type=f.ftype.__name__,
            descriptor_value=f"w2v_{j}") for j in range(d)]
        return vector_output(self.get_output().name, [out], metas)


class Word2Vec(UnaryEstimator):
    """Skip-gram with negative sampling; documents transform to the mean
    of their token vectors (reference OpWord2Vec.scala / MLlib Word2Vec).
    The SGD runs on ``device`` in its working dtype (float32 on the card,
    float64 on the CPU)."""

    input_types = (TextList,)
    output_type = OPVector
    #: a prepare plan sets ``device`` to its own for the fit when it is None
    takes_plan_device = True

    def __init__(self, vector_size: int = 32, window: int = 3,
                 min_count: int = 2, num_negatives: int = 4,
                 epochs: int = 5, step_size: float = 0.05,
                 batch_size: int = 512, seed: int = 42, device=None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="word2Vec", uid=uid)
        self.vector_size = vector_size
        self.window = window
        self.min_count = min_count
        self.num_negatives = num_negatives
        self.epochs = epochs
        self.step_size = step_size
        self.batch_size = batch_size
        self.seed = seed
        self.device = None if device is None else resolve_device(device)

    def fit_columns(self, cols: List[FeatureColumn]) -> Word2VecModel:
        dev = resolve_device(self.device or "cuda")
        rng = np.random.default_rng(self.seed)
        counts: Dict[str, int] = {}
        docs = []
        for toks in cols[0].data:
            toks = [str(t) for t in (toks or [])]
            docs.append(toks)
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
        vocab = sorted([t for t, c in counts.items()
                        if c >= self.min_count])
        index = {t: i for i, t in enumerate(vocab)}
        v = len(vocab)
        if v == 0:
            return Word2VecModel(vocabulary=[],
                                 vectors=np.zeros((0, self.vector_size)))
        pairs = []
        for toks in docs:
            ids = [index[t] for t in toks if t in index]
            for i, c in enumerate(ids):
                lo = max(0, i - self.window)
                hi = min(len(ids), i + self.window + 1)
                for j in range(lo, hi):
                    if j != i:
                        pairs.append((c, ids[j]))
        if not pairs:
            return Word2VecModel(
                vocabulary=vocab,
                vectors=np.zeros((v, self.vector_size)))
        pairs = np.asarray(pairs, dtype=np.int32)
        rng.shuffle(pairs)
        b = min(self.batch_size, len(pairs))
        n_batches = max(1, len(pairs) // b)
        pairs = pairs[:n_batches * b]
        centers = pairs[:, 0].reshape(n_batches, b)
        contexts = pairs[:, 1].reshape(n_batches, b)
        negatives = rng.integers(
            0, v, (n_batches, b, self.num_negatives)).astype(np.int32)
        emb0 = (rng.random((v, self.vector_size)) - 0.5) / self.vector_size
        out0 = (rng.random((v, self.vector_size)) - 0.5) / self.vector_size
        dtype = working_dtype(dev)

        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

        emb = _fit_w2v(up(centers, torch.int64), up(contexts, torch.int64),
                       up(negatives, torch.int64), up(emb0, dtype),
                       up(out0, dtype), self.step_size, self.epochs)
        return Word2VecModel(vocabulary=vocab,
                             vectors=emb.double().cpu().numpy())


# ---------------------------------------------------------------------------
# LDA (online variational Bayes)
# ---------------------------------------------------------------------------

def _exp_dirichlet_expectation(a: torch.Tensor) -> torch.Tensor:
    """``exp(digamma(a) - digamma(a.sum(axis=1)))`` row by row."""
    return torch.exp(torch.special.digamma(a) - torch.special.digamma(
        a.sum(dim=1, keepdim=True)))


def _lda_e_step(counts: torch.Tensor, exp_topic_word: torch.Tensor,
                alpha: float, n_iter: int) -> torch.Tensor:
    """Batch E-step (Hoffman et al. 2010): ``n_iter`` fixed-point gamma
    updates of every document at once. counts: (n_docs, vocab), float64."""
    k = exp_topic_word.shape[0]
    gamma = torch.ones((counts.shape[0], k), dtype=counts.dtype,
                       device=counts.device)
    for _ in range(n_iter):
        e_log_theta = _exp_dirichlet_expectation(gamma)
        phi_norm = e_log_theta @ exp_topic_word + 1e-100     # (n, vocab)
        gamma = alpha + e_log_theta * ((counts / phi_norm)
                                       @ exp_topic_word.T)
    return gamma


class LDAModel(UnaryModel):
    """A fitted LDA: the document-topic mixture of each document (its
    E-step, 50 iterations, in float64 on ``device``)."""

    input_types = (TextList,)
    output_type = OPVector

    def __init__(self, vocabulary: List[str], topic_word, alpha: float,
                 device="cuda", uid: Optional[str] = None):
        super().__init__(operation_name="lda", uid=uid)
        self.vocabulary = [str(t) for t in vocabulary]
        self.topic_word = np.asarray(topic_word, dtype=np.float64)
        self.alpha = float(alpha)
        self.device = resolve_device(device)
        self._index = {t: i for i, t in enumerate(self.vocabulary)}

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        f = self.input_features[0]
        k = self.topic_word.shape[0]
        counts = _count_matrix(cols[0].data, self._index, binary=False)
        gamma = _lda_e_step(
            torch.from_numpy(counts).to(self.device),
            torch.from_numpy(self.topic_word).to(self.device),
            self.alpha, n_iter=50)
        theta = (gamma / gamma.sum(dim=1, keepdim=True)).cpu().numpy()
        metas = [VectorColumnMetadata(
            parent_feature_name=f.name,
            parent_feature_type=f.ftype.__name__,
            descriptor_value=f"topic_{j}") for j in range(k)]
        return vector_output(self.get_output().name, [theta], metas)


class LDA(UnaryEstimator):
    """Online variational LDA; the feature vector is the document-topic
    mixture (reference OpLDA.scala / MLlib LDA). E-steps and M-steps run
    in float64 on ``device``."""

    input_types = (TextList,)
    output_type = OPVector
    #: a prepare plan sets ``device`` to its own for the fit when it is None
    takes_plan_device = True

    def __init__(self, k: int = 10, max_iter: int = 20,
                 doc_concentration: float = 0.1,
                 topic_concentration: float = 0.01,
                 min_count: int = 1, max_vocab: int = 5000,
                 seed: int = 42, device=None, uid: Optional[str] = None):
        super().__init__(operation_name="lda", uid=uid)
        self.k = k
        self.max_iter = max_iter
        self.doc_concentration = doc_concentration
        self.topic_concentration = topic_concentration
        self.min_count = min_count
        self.max_vocab = max_vocab
        self.seed = seed
        self.device = None if device is None else resolve_device(device)

    def fit_columns(self, cols: List[FeatureColumn]) -> LDAModel:
        dev = resolve_device(self.device or "cuda")
        col = cols[0]
        df: Dict[str, int] = {}
        for toks in col.data:
            for t in (toks or []):
                df[str(t)] = df.get(str(t), 0) + 1
        vocab = sorted([t for t, c in df.items() if c >= self.min_count],
                       key=lambda t: (-df[t], t))[:self.max_vocab]
        index = {t: i for i, t in enumerate(vocab)}
        counts = torch.from_numpy(
            _count_matrix(col.data, index, binary=False)).to(dev)
        rng = np.random.default_rng(self.seed)
        lam = torch.from_numpy(
            rng.gamma(100.0, 0.01, (self.k, len(vocab)))).to(dev)
        for _ in range(self.max_iter):
            exp_beta = _exp_dirichlet_expectation(lam)
            gamma = _lda_e_step(counts, exp_beta, self.doc_concentration,
                                n_iter=20)
            e_log_theta = _exp_dirichlet_expectation(gamma)
            phi_norm = e_log_theta @ exp_beta + 1e-100
            # M-step sufficient statistics
            sstats = exp_beta * (e_log_theta.T @ (counts / phi_norm))
            lam = self.topic_concentration + sstats
        topic_word = _exp_dirichlet_expectation(lam)
        return LDAModel(vocabulary=vocab,
                        topic_word=topic_word.cpu().numpy(),
                        alpha=self.doc_concentration, device=dev)
