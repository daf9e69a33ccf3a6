"""LLaVA-style input preparation and generation, PyTorch port of
``iuvl_tpu/models/llm/multimodal.py``: the image-token prompt, the splice
of the projected image features into the prompt's embeddings, and greedy
and beam decoding through the KV cache, and ``causal_lm_loss``, the
stage-2 training step's objective.

Every sequence reserves ``n_img`` slots at its image token, right-padded
to ``max_len``. The features are placed as ``dynamic_update_slice`` places
them: a start that would run past the row is moved back so that they fit
(overwriting the prompt's last tokens), and features longer than the row
raise. Decoding runs from the padded prompt length: step i of every row
is at position ``prompt_len + i``, and the first token comes from the last
(possibly padded) prompt position, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
NUM_IMAGE_TOKENS = 100  # object-query features spliced a sequence


def tokenizer_image_token(prompt: str, tokenizer, image_token: str = "<image>") -> list[int]:
    """Split on ``image_token``, tokenise the chunks and put
    IMAGE_TOKEN_INDEX between them."""
    ids: list[int] = []
    for i, chunk in enumerate(prompt.split(image_token)):
        if i > 0:
            ids.append(IMAGE_TOKEN_INDEX)
        ids.extend(tokenizer.encode_text(chunk))
    return ids


def splice_image_features(input_ids: np.ndarray, embed_fn, image_features: torch.Tensor,
                          labels: Optional[np.ndarray] = None, max_len: int = 1024,
                          pad_id: int = 0):
    """(B, T) host ids with one IMAGE_TOKEN_INDEX a row, ``embed_fn`` (ids
    -> embeddings), (B, N_img, D) features -> (inputs_embeds (B, max_len,
    D), attention_mask (B, max_len) int32, labels (B, max_len) int32) on the
    features' device, the image slots expanded in place."""
    b, _ = input_ids.shape
    n_img = image_features.shape[1]
    if n_img > max_len:
        raise ValueError(f"splice_image_features: {n_img} image features do not fit in a "
                         f"row of max_len {max_len}")
    out_ids = np.full((b, max_len), pad_id, np.int32)
    img_start = np.zeros(b, np.int64)
    attn = np.zeros((b, max_len), np.int32)
    out_labels = np.full((b, max_len), IGNORE_INDEX, np.int32)
    for i in range(b):
        row = input_ids[i]
        row = row[row != pad_id] if pad_id is not None else row
        pos = np.where(row == IMAGE_TOKEN_INDEX)[0]
        assert len(pos) == 1, "expect exactly one image token"
        p = int(pos[0])
        pre, post = row[:p], row[p + 1:]
        total = min(len(pre) + n_img + len(post), max_len)
        post_len = max(total - len(pre) - n_img, 0)
        out_ids[i, : len(pre)] = pre
        img_start[i] = len(pre)
        out_ids[i, len(pre) + n_img: total] = post[:post_len]
        attn[i, :total] = 1
        if labels is not None:
            lab = labels[i][labels[i] != pad_id] if pad_id is not None else labels[i]
            out_labels[i, : len(pre)] = lab[:p]
            out_labels[i, len(pre) + n_img: total] = lab[p + 1:][:post_len]
    dev = image_features.device
    embeds = embed_fn(torch.from_numpy(out_ids).to(dev))
    for i in range(b):
        start = min(int(img_start[i]), max_len - n_img)
        embeds[i, start: start + n_img] = image_features[i].to(embeds.dtype)
    return (embeds, torch.from_numpy(attn).to(dev), torch.from_numpy(out_labels).to(dev))


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest values of the last axis and their indices, ties to
    the lowest index first (``lax.top_k``'s order: a stable descending
    sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def prompt_pad_mask(attention_mask: torch.Tensor, max_seq_len: int) -> torch.Tensor:
    """(B, T) prompt validity -> (B, max_seq_len) True at the prompt's pads."""
    pad = attention_mask == 0
    return torch.cat([pad, pad.new_zeros(pad.shape[0], max_seq_len - pad.shape[1])], dim=1)


@torch.no_grad()
def greedy_generate(model, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor,
                    max_new_tokens: int = 64, eos_id: int = 2, forced_ids=None,
                    return_logits: bool = False):
    """Prefill the prompt, then one token at a time through the KV cache:
    (B, max_new_tokens) ids of the argmax (no stop at ``eos_id``, as in
    JAX). ``forced_ids`` (B, max_new_tokens) feeds given ids instead
    (teacher forcing); ``return_logits`` also returns each step's (B,
    max_new_tokens, V) fp32 logits."""
    del eos_id
    prompt_len = inputs_embeds.shape[1]
    logits, caches = model.prefill(inputs_embeds, attention_mask)
    pad_mask = prompt_pad_mask(attention_mask, model.cfg.max_seq_len)
    rows = [logits]
    toks = [logits.argmax(dim=-1) if forced_ids is None else forced_ids[:, 0]]
    for i in range(max_new_tokens - 1):
        emb = model.embed(toks[-1][:, None])
        logits, caches = model.decode_step(emb, caches, prompt_len + i, pad_mask)
        rows.append(logits)
        toks.append(logits.argmax(dim=-1) if forced_ids is None else forced_ids[:, i + 1])
    ids = torch.stack(toks, dim=1)
    return (ids, torch.stack(rows, dim=1)) if return_logits else ids


@torch.no_grad()
def beam_generate(model, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor,
                  max_new_tokens: int = 32, num_beams: int = 5, eos_id: int = 2,
                  length_penalty: float = 1.0) -> torch.Tensor:
    """Beam search: the beams ride the batch axis of one KV cache. The
    first top-k comes from the prefill; each step expands every beam,
    finished beams extend with ``eos_id`` at no cost, the top-k of the
    accumulated log probabilities over k x V picks the new beams, and the
    caches are reselected by beam. The best beam by score / length **
    ``length_penalty`` (length up to the first eos) -> (B, max_new_tokens)."""
    b, prompt_len, _ = inputs_embeds.shape
    k = num_beams
    logits, caches = model.prefill(inputs_embeds, attention_mask)
    logp0 = torch.log_softmax(logits, dim=-1)
    v = logp0.shape[-1]
    top_lp, top_tok = top_k(logp0, k)
    dev = logits.device
    caches = [(kc.repeat_interleave(k, dim=0), vc.repeat_interleave(k, dim=0))
              for kc, vc in caches]
    pad_mask = prompt_pad_mask(attention_mask, model.cfg.max_seq_len).repeat_interleave(k, dim=0)
    beam_scores = top_lp.reshape(b * k)
    cur_tok = top_tok.reshape(b * k)
    finished = torch.zeros(b * k, dtype=torch.bool, device=dev)
    tokens = torch.zeros(b * k, max_new_tokens, dtype=torch.long, device=dev)
    tokens[:, 0] = cur_tok
    base = torch.arange(b, device=dev)[:, None] * k
    for i in range(max_new_tokens - 1):
        logits, caches = model.decode_step(model.embed(cur_tok[:, None]), caches,
                                           prompt_len + i, pad_mask)
        logp = torch.log_softmax(logits, dim=-1)
        frozen = torch.full_like(logp, -1e9)
        frozen[:, eos_id] = 0.0
        logp = torch.where(finished[:, None], frozen, logp)
        cand = (beam_scores[:, None] + logp).reshape(b, k * v)
        new_scores, flat_idx = top_k(cand, k)
        beam_idx = (flat_idx // v + base).reshape(b * k)
        cur_tok = (flat_idx % v).reshape(b * k)
        tokens = tokens[beam_idx]
        tokens[:, i + 1] = cur_tok
        finished = finished[beam_idx] | (cur_tok == eos_id)
        beam_scores = new_scores.reshape(b * k)
        for kc, vc in caches:
            kc.copy_(kc[beam_idx])
            vc.copy_(vc[beam_idx])
    is_eos = tokens == eos_id
    lengths = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, max_new_tokens)
    norm = beam_scores / lengths.float() ** length_penalty
    best = norm.reshape(b, k).argmax(dim=1) + base[:, 0]
    return tokens[best]


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted cross-entropy: (B, T, V) logits, (B, T) labels -> the mean
    negative log-likelihood of each next token in fp32, IGNORE_INDEX
    targets left out, over ``max(valid, 1)`` (an all-ignored batch gives 0
    and a zero gradient). ``jnp.take_along_axis``'s semantics: a negative
    target counts from the end of the vocabulary, and one outside it gives
    NaN (no device assert)."""
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    valid = targets != IGNORE_INDEX
    logp = torch.log_softmax(logits.float(), dim=-1)
    v = logp.shape[-1]
    tgt = torch.where(valid, targets, 0)
    tgt = torch.where(tgt < 0, tgt + v, tgt)
    inside = (tgt >= 0) & (tgt < v)
    nll = -logp.gather(-1, tgt.clamp(0, v - 1)[..., None])[..., 0]
    nll = torch.where(inside, nll, torch.full((), float("nan"), device=nll.device))
    return (nll * valid).sum() / valid.sum().clamp(min=1)
