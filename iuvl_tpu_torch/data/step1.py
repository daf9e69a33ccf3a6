"""Step-1 extras, the port's own copy of ``iuvl_tpu/data/step1.py``: a
caption's noun phrases and the grounding targets of an image, the
spatial prompts drawn from its gt masks, and the per-step class prompts.

- Caption stream: the caption's noun phrases (prompted "a photo of the
  {}.") and the caption itself are the contrastive phrase targets of the
  caption loss; duplicate texts share credit through a group matrix.
- Grounding stream: up to ``max_grounding`` sentences with their masks
  ("text" mode), or gt class names through a random template with the
  instance masks ("class" mode). The texts go out as (G, L) token ids; the
  train step embeds them with the live text tower.
- Spatial prompts: one click drawn from a ShapeSampler prompt of each of
  up to ``capacity`` instances.
- Class prompts: one random template a class a step, as token ids.

Every output is a dense numpy array of static shape with validity masks.
The reference's caption-to-class similarity filter of the nouns is not
reproducible offline, so every extracted phrase is kept.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .nouns import noun_prompts
from .prompts import get_prompt_templates, clean_class_name

GROUNDING_TEXT_WEIGHT = 2.0  # reference step1.yaml:155
GROUNDING_CLASS_WEIGHT = 0.5  # reference step1.yaml:156


class Step1ExtrasBuilder:
    """Per-item builder of the caption/grounding extras consumed by
    ``make_joint_train_step`` (``train/train_step.py``, its seg_extras)."""

    def __init__(
        self,
        tokenizer,
        max_phrases: int = 6,  # noun phrases + the caption itself
        max_grounding: int = 5,  # reference GROUNDING.MAX_LEN
        text_len: int = 24,  # per-text token capacity
        mask_hw: tuple[int, int] = (256, 256),
    ):
        self.tokenizer = tokenizer
        self.max_phrases = max_phrases
        self.max_grounding = max_grounding
        self.text_len = text_len
        self.mask_hw = tuple(mask_hw)
        self.templates = get_prompt_templates()

    # ------------------------------------------------------------------ #
    def empty(self) -> dict[str, np.ndarray]:
        p, g, L = self.max_phrases, self.max_grounding, self.text_len
        mh, mw = self.mask_hw
        return {
            "phrase_ids": np.zeros((p, L), np.int32),
            "phrase_mask": np.zeros((p, L), np.int32),
            "phrase_valid": np.zeros((p,), bool),
            "phrase_groups": np.eye(p, dtype=np.float32),
            "grounding_ids": np.zeros((g, L), np.int32),
            "grounding_mask": np.zeros((g, L), np.int32),
            "grounding_masks": np.zeros((g, mh, mw), np.float32),
            "grounding_valid": np.zeros((g,), bool),
            "grounding_groups": np.eye(g, dtype=np.float32),
            "grounding_task_weight": np.asarray(GROUNDING_CLASS_WEIGHT, np.float32),
        }

    def _tokenize(self, texts: Sequence[str], capacity: int):
        ids = np.zeros((capacity, self.text_len), np.int32)
        mask = np.zeros((capacity, self.text_len), np.int32)
        if texts:
            toks = self.tokenizer(list(texts), max_length=self.text_len)
            n = min(len(texts), capacity)
            ids[:n] = toks["input_ids"][:n]
            mask[:n] = toks["attention_mask"][:n]
        return ids, mask

    @staticmethod
    def _group_matrix(texts: Sequence[str], capacity: int) -> np.ndarray:
        """1 where two slots carry identical text (the reference's hash-table
        duplicate-credit sharing, criterion.py loss_captions/groundings)."""
        m = np.eye(capacity, dtype=np.float32)
        for a in range(min(len(texts), capacity)):
            for b in range(a + 1, min(len(texts), capacity)):
                if texts[a] == texts[b]:
                    m[a, b] = m[b, a] = 1.0
        return m

    # ------------------------------------------------------------------ #
    def __call__(
        self,
        caption: str | None,
        grounding_texts: Sequence[str] | None,
        grounding_masks: np.ndarray | None,  # (G_raw, mh, mw) float/bool
        mode: str = "text",
        rs: np.random.RandomState | None = None,
    ) -> dict[str, np.ndarray]:
        rs = rs or np.random.RandomState(0)
        out = self.empty()

        # ---- caption phrases (nouns prompted + raw caption last) ---- #
        if caption:
            nouns, prompted = noun_prompts(caption, self.max_phrases - 1)
            texts = prompted + [caption]
            ids, mask = self._tokenize(texts, self.max_phrases)
            n = min(len(texts), self.max_phrases)
            out["phrase_ids"], out["phrase_mask"] = ids, mask
            out["phrase_valid"][:n] = True
            out["phrase_groups"] = self._group_matrix(texts, self.max_phrases)

        # ---- grounding stream ---- #
        if grounding_texts is not None and len(grounding_texts):
            g_raw = len(grounding_texts)
            # Random target count 1..max-1 like the reference (:282), then a
            # random permutation of the available annotations.
            take = min(max(1, rs.randint(1, self.max_grounding)), g_raw)
            order = rs.permutation(g_raw)[:take]
            texts = [grounding_texts[i] for i in order]
            if mode == "class":
                texts = [
                    self.templates[rs.randint(len(self.templates))].format(
                        clean_class_name(t)
                    )
                    for t in texts
                ]
            ids, mask = self._tokenize(texts, self.max_grounding)
            out["grounding_ids"], out["grounding_mask"] = ids, mask
            out["grounding_valid"][: len(texts)] = True
            out["grounding_groups"] = self._group_matrix(texts, self.max_grounding)
            out["grounding_task_weight"] = np.asarray(
                GROUNDING_TEXT_WEIGHT if mode == "text" else GROUNDING_CLASS_WEIGHT,
                np.float32,
            )
            if grounding_masks is not None and len(grounding_masks):
                mh, mw = self.mask_hw
                sel = np.asarray(grounding_masks, np.float32)[order]
                if sel.shape[1:] != (mh, mw):
                    sel = _nearest_resize(sel, mh, mw)
                out["grounding_masks"][: len(texts)] = sel[: self.max_grounding]
        return out


def _nearest_resize(masks: np.ndarray, mh: int, mw: int) -> np.ndarray:
    h, w = masks.shape[1:]
    ys = np.clip((np.arange(mh) * h / mh).astype(int), 0, h - 1)
    xs = np.clip((np.arange(mw) * w / mw).astype(int), 0, w - 1)
    return masks[:, ys][:, :, xs]


def spatial_prompt_arrays(
    sampler,
    masks_small: np.ndarray,  # (N, ms, ms) gt masks at mask stride
    stride: int,
    rs: np.random.RandomState,
    capacity: int = 3,
) -> dict[str, np.ndarray]:
    """Dense spatial-prompt stream for ``loss_spatials`` training: up to
    ``capacity`` instances get one ShapeSampler prompt each; one positive
    click is drawn from the rasterized prompt and scaled to model INPUT
    space (reference coco_panoptic_interactive mapper shape_sampler call,
    :275-276)."""
    ms = masks_small.shape[1:] if len(masks_small) else (0, 0)
    pts = np.zeros((capacity, 2), np.float32)
    labs = np.full((capacity,), -1, np.int32)
    sm = np.zeros((capacity, *ms), np.float32)
    val = np.zeros(capacity, bool)
    if len(masks_small):
        res = sampler(masks_small.astype(bool))
        for k, (shape_mask, inst_idx) in enumerate(
            zip(res["rand_shape"][:capacity], res["indices"][:capacity])
        ):
            ys, xs = np.nonzero(shape_mask)
            if not len(ys):
                continue
            j = rs.randint(len(ys))
            pts[k] = [xs[j] * stride + stride // 2, ys[j] * stride + stride // 2]
            labs[k] = 1
            sm[k] = masks_small[inst_idx]
            val[k] = True
    return {
        "spatial_points": pts, "spatial_labels": labs,
        "spatial_masks": sm, "spatial_valid": val,
    }


class ClassPromptBank:
    """Pre-tokenized (class x template) prompt bank: per train step, sample
    one template per class (reference get_text_embeddings is_eval=False,
    vlpencoder.py:74-102) and return static-shape token ids for the live
    in-step class-embedding computation."""

    def __init__(self, class_names: Sequence[str], tokenizer, text_len: int = 24):
        self.templates = get_prompt_templates()
        k, t = len(class_names), len(self.templates)
        self.ids = np.zeros((k, t, text_len), np.int32)
        self.mask = np.zeros((k, t, text_len), np.int32)
        for i, name in enumerate(class_names):
            cname = clean_class_name(name)
            toks = tokenizer(
                [tpl.format(cname) for tpl in self.templates], max_length=text_len
            )
            self.ids[i] = toks["input_ids"]
            self.mask[i] = toks["attention_mask"]

    def sample(self, rs: np.random.RandomState) -> dict[str, np.ndarray]:
        k, t, _ = self.ids.shape
        pick = rs.randint(0, t, size=k)
        rows = np.arange(k)
        return {"ids": self.ids[rows, pick], "mask": self.mask[rows, pick]}
