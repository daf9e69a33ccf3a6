"""Image-text retrieval evaluator (ir@k / tr@k), plus the ensemble and
patch-to-image modes, the port's own copy of
``iuvl_tpu/evaluation/retrieval.py`` (numpy).

All image and text embeddings are gathered, the full similarity matrix is
computed, and image retrieval and text retrieval recall@k are reported,
with irtr = ir@1 + tr@1. ``ensemble=True``: a second per-image embedding
(the backbone branch) contributes half of the similarity, ``0.5 * s1 +
0.5 * s2``. ``mode='p2i'``: patch/interactive-to-image retrieval, the first
embedding table ranked by similarity to the second (query) table, p2ir@k.
"""

from __future__ import annotations

import numpy as np


def _norm(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-7)


class RetrievalEvaluator:
    def __init__(self, ks=(1, 5, 10), ensemble: bool = False,
                 mode: str = "default"):
        if mode not in ("default", "p2i"):
            raise ValueError(f"unknown retrieval mode {mode!r}")
        self.ks = ks
        self.ensemble = ensemble
        self.mode = mode
        self.reset()

    def reset(self):
        self.image_embs: list[np.ndarray] = []
        self.image_embs2: list[np.ndarray] = []
        self.text_embs: list[np.ndarray] = []
        self.image_ids: list[int] = []
        self.text_image_ids: list[int] = []

    def process(self, image_emb, image_id, text_embs, text_image_ids,
                image_emb2=None):
        """One image: its embedding (plus the optional second/ensemble or
        query embedding) and the caption embeddings attached to it."""
        self.image_embs.append(np.asarray(image_emb))
        self.image_ids.append(int(image_id))
        if image_emb2 is not None:
            self.image_embs2.append(np.asarray(image_emb2))
        elif self.ensemble or self.mode == "p2i":
            raise ValueError("ensemble/p2i evaluation needs image_emb2")
        for e, tid in zip(np.asarray(text_embs), text_image_ids):
            self.text_embs.append(e)
            self.text_image_ids.append(int(tid))

    def merge(self, other: "RetrievalEvaluator"):
        self.image_embs.extend(other.image_embs)
        self.image_embs2.extend(other.image_embs2)
        self.image_ids.extend(other.image_ids)
        self.text_embs.extend(other.text_embs)
        self.text_image_ids.extend(other.text_image_ids)

    # ------------------------------------------------------------------ #
    def evaluate(self) -> dict[str, float]:
        if self.mode == "p2i":
            return self._evaluate_p2i()
        return self._evaluate_default()

    def _evaluate_default(self) -> dict[str, float]:
        if not self.image_embs or not self.text_embs:
            return {}
        vi = _norm(np.stack(self.image_embs))
        vt = _norm(np.stack(self.text_embs))
        sim = vi @ vt.T  # (I, T)
        if self.ensemble:
            vi2 = _norm(np.stack(self.image_embs2))
            sim = 0.5 * sim + 0.5 * (vi2 @ vt.T)
        img_ids = np.asarray(self.image_ids)
        txt_ids = np.asarray(self.text_image_ids)

        out = {}
        # Text retrieval: for each image, rank texts.
        order_t = np.argsort(-sim, axis=1)
        match_t = txt_ids[order_t] == img_ids[:, None]
        # Image retrieval: for each text, rank images.
        order_i = np.argsort(-sim.T, axis=1)
        match_i = img_ids[order_i] == txt_ids[:, None]
        for k in self.ks:
            out[f"tr@{k}"] = 100.0 * float(match_t[:, :k].any(1).mean())
            out[f"ir@{k}"] = 100.0 * float(match_i[:, :k].any(1).mean())
        if 1 in self.ks:
            out["irtr"] = out["ir@1"] + out["tr@1"]
        return out

    def _evaluate_p2i(self) -> dict[str, float]:
        """Patch/interactive-to-image: each second embedding (the crop /
        visual-prompt query) retrieves over the full-image embedding table;
        a hit is the row with the same image id."""
        if not self.image_embs or not self.image_embs2:
            return {}
        vi = _norm(np.stack(self.image_embs))
        vq = _norm(np.stack(self.image_embs2))
        sim = vq @ vi.T  # (Q, I) — queries are row-aligned with images
        img_ids = np.asarray(self.image_ids)
        order = np.argsort(-sim, axis=1)
        match = img_ids[order] == img_ids[:, None]
        return {
            f"p2ir@{k}": 100.0 * float(match[:, :k].any(1).mean())
            for k in self.ks
        }
