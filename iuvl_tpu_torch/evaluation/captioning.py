"""Captioning evaluator: corpus BLEU-4 with brevity penalty and CIDEr-D
(TF-IDF weighted n-gram cosine with a length penalty, n = 1..4, sigma 6,
the hypothesis term clipped at the reference's), the port's own copy of
``iuvl_tpu/evaluation/captioning.py`` (pure Python and numpy).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict

import numpy as np


def _tokenize(s: str) -> list[str]:
    import re

    return re.findall(r"[a-z0-9]+", s.lower())


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


class CaptioningEvaluator:
    def __init__(self):
        self.reset()

    def reset(self):
        self.preds: list[list[str]] = []
        self.refs: list[list[list[str]]] = []

    def process(self, prediction: str, references: list[str]):
        self.preds.append(_tokenize(prediction))
        self.refs.append([_tokenize(r) for r in references])

    def merge(self, other):
        self.preds.extend(other.preds)
        self.refs.extend(other.refs)

    # -------------------- BLEU -------------------- #
    def _bleu(self, max_n: int = 4) -> float:
        log_precisions = []
        for n in range(1, max_n + 1):
            match, total = 0, 0
            for pred, refs in zip(self.preds, self.refs):
                pred_ng = _ngrams(pred, n)
                max_ref = Counter()
                for r in refs:
                    for g, c in _ngrams(r, n).items():
                        max_ref[g] = max(max_ref[g], c)
                match += sum(min(c, max_ref[g]) for g, c in pred_ng.items())
                total += max(sum(pred_ng.values()), 0)
            log_precisions.append(math.log(match / total) if match and total else -1e9)
        pred_len = sum(len(p) for p in self.preds)
        ref_len = sum(
            min((len(r) for r in refs), key=lambda L: (abs(L - len(p)), L))
            for p, refs in zip(self.preds, self.refs)
        )
        bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / max(pred_len, 1))
        return bp * math.exp(sum(log_precisions) / max_n)

    # -------------------- CIDEr-D -------------------- #
    def _cider(self, max_n: int = 4, sigma: float = 6.0) -> float:
        # Document frequencies over reference sets.
        df = [defaultdict(float) for _ in range(max_n)]
        for refs in self.refs:
            for n in range(max_n):
                seen = set()
                for r in refs:
                    seen |= set(_ngrams(r, n + 1).keys())
                for g in seen:
                    df[n][g] += 1.0
        n_docs = max(len(self.refs), 1)

        def tfidf_vec(tokens, n):
            ng = _ngrams(tokens, n + 1)
            total = max(sum(ng.values()), 1)
            vec = {}
            for g, c in ng.items():
                idf = math.log(max(n_docs, 1)) - math.log(max(df[n][g], 1.0))
                vec[g] = (c / total) * idf
            return vec

        def cos(v1, v2):
            # CIDEr-D similarity (pycocoevalcap cider_scorer.sim): the
            # hypothesis term is CLIPPED at the reference term so repeating
            # a high-idf n-gram cannot inflate the numerator.
            num = sum(min(v1[g], v2.get(g, 0.0)) * v2.get(g, 0.0) for g in v1)
            n1 = math.sqrt(sum(v * v for v in v1.values()))
            n2 = math.sqrt(sum(v * v for v in v2.values()))
            return num / (n1 * n2) if n1 > 0 and n2 > 0 else 0.0

        scores = []
        for pred, refs in zip(self.preds, self.refs):
            score_n = np.zeros(max_n)
            for n in range(max_n):
                vp = tfidf_vec(pred, n)
                for r in refs:
                    vr = tfidf_vec(r, n)
                    penalty = math.exp(
                        -((len(pred) - len(r)) ** 2) / (2 * sigma ** 2)
                    )
                    score_n[n] += cos(vp, vr) * penalty
                score_n[n] /= max(len(refs), 1)
            scores.append(score_n.mean() * 10.0)
        return float(np.mean(scores)) if scores else 0.0

    def evaluate(self) -> dict[str, float]:
        if not self.preds:
            return {}
        return {"BLEU4": 100.0 * self._bleu(), "CIDEr": 100.0 * self._cider()}
