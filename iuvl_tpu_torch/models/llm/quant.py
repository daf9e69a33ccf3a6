"""Weight-only int8 quantisation of the frozen LLaMA / Vicuna, PyTorch port
of ``iuvl_tpu/models/llm/quant.py``.

The seven projections of every block (q, k, v, o, gate, up, down: over 99%
of a 7B's weights outside the two tables) become int8 with a per-output-
channel absmax scale; the token table, the norms and the head stay as they
are (bitsandbytes' skip list). The values are those of JAX's numpy
``_quantize_kernel``: scale = absmax / 127 in fp32, q = round(w / scale)
(half to even) clipped to +-127, and a scale of 1 where a channel's
absmax is 0. It works on the tensors where they lie, so a 7B state dict on
the card is quantised there.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .llama import PROJECTIONS


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> ((out, in) int8, (out,) fp32 scale)."""
    w = w.float()
    absmax = w.abs().amax(dim=1)
    scale = absmax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(w / safe[:, None]), -127, 127).to(torch.int8)
    return q, torch.where(absmax > 0, scale, torch.ones_like(scale))


def is_projection(key: str) -> bool:
    parts = key.split(".")
    return len(parts) >= 2 and parts[-1] == "weight" and parts[-2] in PROJECTIONS


def quantize_llama_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """A fp state dict of ``LlamaForCausalLM`` (quant 'none') -> the state
    dict of the same model with ``quant='int8'``: each projection's
    ``weight`` int8 and its ``weight_scale`` beside it."""
    out: dict = {}
    for key, t in sd.items():
        if is_projection(key) and t.dim() == 2:
            out[key], out[key + "_scale"] = quantize_weight(t)
        else:
            out[key] = t
    return out


def quantized_size_bytes(sd: Mapping[str, torch.Tensor]) -> int:
    """Bytes of every tensor of ``sd``."""
    return sum(t.numel() * t.element_size() for t in sd.values())
