"""Language encoder, PyTorch port of ``iuvl_tpu/models/xdecoder/
lang_encoder.py``: so far only ``logit_scale``, the learnable temperature
that ``forward_seg``'s class logits read (``exp(logit_scale) * cos``).

The CLIP-style text tower (token embedding, 12 transformer layers,
``lang_proj``) is not ported yet (ROADMAP.md); the seg train step takes
the class text embeddings as an input, as the JAX ``make_train_step``
does.
"""

from __future__ import annotations

import torch
from torch import nn


class LanguageEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.logit_scale = nn.Parameter(torch.ones(()))  # flax init: ones
