"""The stage-2 instruction stream, port of ``SyntheticInstructionDataset``
of ``iuvl_tpu/data/vlp_datasets.py`` and its two registered names,
``instruction_train`` and ``synthetic_instruction``. The other VLP loaders
are not ported yet."""

from __future__ import annotations

from typing import Any

import numpy as np

from ..models.llm.conversation import default_conversation
from ..models.llm.multimodal import IGNORE_INDEX, IMAGE_TOKEN_INDEX, tokenizer_image_token
from .datasets import register_dataset
from .tokenizer import CONTEXT_LEN, build_tokenizer


class SyntheticInstructionDataset:
    """A conversation stream with one ``<image>`` token an item: a seeded
    random image, the conversation's ids with IMAGE_TOKEN_INDEX, labels
    masked (IGNORE_INDEX) up to and including the assistant marker, and the
    question's CLIP ids and mask for the unified decoder's ``'llm'`` task.
    ``vocab_size`` takes every other id modulo it (for small test LLMs)."""

    def __init__(self, image_size=1024, length=32, seed=0, tokenizer=None,
                 max_len=256, vocab_size=None, context_len=CONTEXT_LEN):
        self.image_size = image_size
        self.length = length
        self.seed = seed
        self.max_len = max_len
        self.vocab_size = vocab_size
        self.context_len = context_len
        self.tokenizer = tokenizer or build_tokenizer()

    def __len__(self):
        return self.length

    def __getitem__(self, i: int) -> dict[str, Any]:
        rs = np.random.RandomState(self.seed * 104729 + i)
        s = self.image_size
        image = (rs.rand(s, s, 3) * 255).astype(np.float32)
        conv = default_conversation()
        question = "what is in this image?"
        answer = "a scene with several objects"
        conv.append_message(conv.roles[0], f"<image>\n{question}")
        conv.append_message(conv.roles[1], answer)
        prompt = conv.get_prompt()
        # Everything up to the assistant marker is masked: the prompt is
        # tokenised in two parts split at the marker, so the answer's ids
        # and the separator's after it are supervised where they stand.
        marker = f"{conv.roles[1]}: "
        head, _, tail = prompt.rpartition(marker)
        prefix_ids = tokenizer_image_token(head + marker, self.tokenizer)
        tail_ids = self.tokenizer.encode_text(tail)
        ids = prefix_ids + tail_ids
        labels = [IGNORE_INDEX] * len(prefix_ids) + tail_ids
        ids = np.asarray(ids[: self.max_len], np.int32)
        labels = np.asarray(labels[: self.max_len], np.int32)
        if self.vocab_size:
            ids = np.where(ids == IMAGE_TOKEN_INDEX, ids, ids % self.vocab_size)
            labels = np.where(labels == IGNORE_INDEX, labels, labels % self.vocab_size)
        qt = self.tokenizer([question], max_length=self.context_len)
        return {
            "image": image, "input_ids": ids, "labels": labels,
            "clip_ids": qt["input_ids"][0], "clip_mask": qt["attention_mask"][0],
        }


@register_dataset("instruction_train")
def _build_instruction(cfg, split):
    return SyntheticInstructionDataset(
        image_size=cfg.get("IMAGE_SIZE", 1024), length=cfg.get("LENGTH", 32),
        max_len=cfg.get("MAX_LEN", 256), vocab_size=cfg.get("VOCAB_SIZE"),
        context_len=cfg.get("CONTEXT_LEN", CONTEXT_LEN),
    )


@register_dataset("synthetic_instruction")
def _build_synth_instruction(cfg, split):
    return SyntheticInstructionDataset(
        image_size=cfg.get("IMAGE_SIZE", 64), length=cfg.get("LENGTH", 8),
        max_len=cfg.get("MAX_LEN", 64), vocab_size=cfg.get("VOCAB_SIZE"),
        context_len=cfg.get("CONTEXT_LEN", CONTEXT_LEN),
    )
