"""LLaVA-style VQA and captioning, PyTorch port of
``iuvl_tpu/models/llm/vqa_pipeline.py``: the question's tokens through the
text tower, the unified decoder's ``'llm'`` task (100 object-query
features) and the ``img_to_lang`` projector, the features spliced at the
``<image>`` slot of the Vicuna prompt, then the (frozen) LLaMA decodes the
answer, greedy or by beam search. Everything stays on the models' device;
the ids come to the host once, to be decoded.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .conversation import default_conversation
from .multimodal import (beam_generate, greedy_generate, splice_image_features,
                         tokenizer_image_token)


def build_vqa_prompt(question: str) -> str:
    """Vicuna-format single-turn prompt with the image placeholder."""
    conv = default_conversation()
    conv.append_message(conv.roles[0], f"<image>\n{question}")
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


@torch.no_grad()
def vqa_inputs(syslearner, llm, tokenizer, images: torch.Tensor, questions: Sequence[str],
               max_len: int = 256):
    """The LLM's inputs of :func:`answer_questions`: (inputs_embeds (B, L,
    dim), attention_mask (B, L), image features (B, 100, llm_dim)), L the
    longest row's length after the splice at ``max_len``."""
    b = images.shape[0]
    dev = images.device
    toks = tokenizer(list(questions), max_length=syslearner.cfg.contxt_len)
    ctx_tokens, _ = syslearner.encode_text_tokens(
        torch.from_numpy(toks["input_ids"]).to(dev),
        torch.from_numpy(toks["attention_mask"]).to(dev))
    image_features = syslearner.forward_llm_features(images, ctx_tokens)
    prompt_ids = [tokenizer_image_token(build_vqa_prompt(q), tokenizer) for q in questions]
    ids = np.zeros((b, max(len(p) for p in prompt_ids)), np.int32)
    for i, p in enumerate(prompt_ids):
        ids[i, : len(p)] = p
    embeds, attn, _ = splice_image_features(ids, llm.embed, image_features, max_len=max_len,
                                            pad_id=0)
    real_len = int(attn.sum(dim=1).max())  # trimmed to the longest real row
    return embeds[:, :real_len], attn[:, :real_len], image_features


@torch.no_grad()
def answer_questions(syslearner, llm, tokenizer, images: torch.Tensor,
                     questions: Sequence[str], max_new_tokens: int = 32, max_len: int = 256,
                     num_beams: int = 1, return_ids: bool = False):
    """End-to-end VQA: raw RGB images (B, H, W, 3) on the models' device and
    one question each -> the decoded answers (special tokens skipped);
    greedy, or beam search with ``num_beams > 1``. ``return_ids`` also
    returns the (B, max_new_tokens) ids."""
    embeds, attn, _ = vqa_inputs(syslearner, llm, tokenizer, images, questions, max_len)
    if num_beams > 1:
        ids = beam_generate(llm, embeds, attn, max_new_tokens=max_new_tokens,
                            num_beams=num_beams)
    else:
        ids = greedy_generate(llm, embeds, attn, max_new_tokens=max_new_tokens)
    texts = tokenizer.batch_decode(ids.cpu().numpy(), skip_special_tokens=True)
    return (texts, ids) if return_ids else texts


def caption_images(syslearner, llm, tokenizer, images: torch.Tensor,
                   prompt: str = "Describe the image in one sentence.", **kw):
    """LLM captioning: :func:`answer_questions` with one prompt an image."""
    return answer_questions(syslearner, llm, tokenizer, images, [prompt] * images.shape[0],
                            **kw)
