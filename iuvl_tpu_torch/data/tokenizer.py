"""Text tokenizers (host side), the port's own copy of
``iuvl_tpu/data/tokenizer.py``.

The reference's CLIP tokenizer contract: context length 77, padded to the
maximum length, sot 49406 / eot 49407. Two implementations behind one API:

- ``ClipBPETokenizer``: CLIP's byte-BPE, from scratch. It needs the
  standard ``bpe_simple_vocab_16e6.txt.gz`` merges file, passed as an
  argument or found in the repository's ``assets/`` directory. Its ids
  match OpenAI CLIP's.
- ``HashWordTokenizer``: a deterministic fallback when no merges file is
  present: lowercase word split, FNV-1a hash into the mid vocab range, the
  same id layout (sot / eot / pad, eot the largest id), so that the
  language encoder's argmax-eot pooling behaves the same. Not compatible
  with pretrained CLIP weights.

Both return dense (N, max_length) int32 ids and attention masks (numpy).
"""

from __future__ import annotations

import gzip
import html
import os
import re
from pathlib import Path
from functools import lru_cache
from typing import Iterable

import numpy as np

CONTEXT_LEN = 77
VOCAB_SIZE = 49408
SOT = 49406
EOT = 49407

# Searched when no merges path is given: the repository's ``assets/``.
_MERGES_CANDIDATES = (
    Path(__file__).resolve().parents[2] / "assets" / "bpe_simple_vocab_16e6.txt.gz",
)


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> unicode mapping (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    """CLIP byte-BPE (OpenAI convention)."""

    def __init__(self, merges_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict[str, str] = {}
        # CLIP's pattern with ASCII classes in place of \p{L} / \p{N}, which
        # need the third-party ``regex`` module.
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+",
            re.IGNORECASE,
        )
        self.vocab_size = VOCAB_SIZE

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> list[int]:
        ids: list[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for tok in re.findall(self.pat, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def decode_ids(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, max_length: int = CONTEXT_LEN, **_):
        return _to_dense(self, texts, max_length)

    def batch_decode(self, ids_batch, skip_special_tokens: bool = False):
        out = []
        for row in np.asarray(ids_batch):
            toks = [int(i) for i in row if not (skip_special_tokens and i in (SOT, EOT, 0))]
            out.append(self.decode_ids(toks))
        return out


class HashWordTokenizer:
    """Deterministic offline fallback; see module docstring."""

    def __init__(self, vocab_size: int = VOCAB_SIZE):
        self.vocab_size = vocab_size
        self._reverse: dict[int, str] = {}

    def _word_id(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        wid = 1000 + (h % (SOT - 1001))
        self._reverse.setdefault(wid, word)
        return wid

    def encode_text(self, text: str) -> list[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        return [self._word_id(w) for w in re.findall(r"[a-z0-9']+|[^\sa-z0-9]", text)]

    def __call__(self, texts, max_length: int = CONTEXT_LEN, **_):
        return _to_dense(self, texts, max_length)

    def batch_decode(self, ids_batch, skip_special_tokens: bool = False):
        out = []
        for row in np.asarray(ids_batch):
            words = [self._reverse.get(int(i), "") for i in row if int(i) not in (0, SOT, EOT)]
            out.append(" ".join(w for w in words if w))
        return out


def _to_dense(tok, texts, max_length: int):
    if isinstance(texts, str):
        texts = [texts]
    ids = np.zeros((len(texts), max_length), np.int32)
    mask = np.zeros((len(texts), max_length), np.int32)
    for i, t in enumerate(texts):
        body = tok.encode_text(t)[: max_length - 2]
        row = [SOT] + body + [EOT]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def build_tokenizer(merges_path: str | None = None):
    """CLIP BPE if a merges file is available (``merges_path``, else the
    repository's ``assets/``), else the hash fallback."""
    candidates = ([merges_path] if merges_path else []) + list(_MERGES_CANDIDATES)
    for path in candidates:
        if path and os.path.exists(path):
            return ClipBPETokenizer(str(path))
    return HashWordTokenizer()
