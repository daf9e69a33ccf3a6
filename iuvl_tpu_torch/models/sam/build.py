"""SAM registry and composite module, PyTorch port of
``iuvl_tpu/models/sam/build.py``.

``Sam.encode_image`` runs the ViT once per image; ``Sam.decode_from_embedding``
is the cheap per-prompt path over a (usually batch-1) embedding.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch
from torch import nn

from .image_encoder import ATTN_IMPLS, ImageEncoderViT
from .mask_decoder import TWOWAY_ALIASES, MaskDecoder
from .prompt_encoder import PromptEncoder

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)

TWOWAY_IMPLS = ("auto", "plain", "chunk", "chunk_plain", *TWOWAY_ALIASES)
_UNKNOWN = (
    "{field}={value!r} is not a choice of the port, which takes {allowed}: 'auto' "
    "runs the CUDA kernels, 'plain' their plain versions; for attn_impl, 'rowbias', "
    "'pallas_rp', 'window' and 'pallas' every block's attention through B2b, B14, B13 "
    "and B11 ('window_plain' B13's plain version, 'xla_naive' the materialised-bias "
    "oracle); for twoway_impl, 'chunk' the "
    "whole-chunk decode kernel (B16) and 'chunk_plain' its plain version; JAX's names "
    "'block', 'xla', 'off' and 'chunk_xla' run as 'auto', 'plain', 'plain' and "
    "'chunk_plain', its twoway 'pallas' as 'auto'.")


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """``attn_impl`` / ``twoway_impl``: ``'auto'`` runs the CUDA kernels on
    CUDA tensors (their plain versions on the CPU); ``'plain'`` runs the
    plain PyTorch versions everywhere (the reference on the card).
    ``attn_impl='rowbias'`` / ``'pallas_rp'`` / ``'pallas'`` run JAX's
    unfused encoder route with every block's attention in B2b / B14 / B11
    on the augmented q, k (forward and backward; their plain versions on
    the CPU) and the plain block tail; their rounding points are those of
    ``'plain'``, which is their reference. ``'window'`` runs the same route
    with B13 forward (backward: autograd of the plain augmented route, as
    JAX's), whose rounding points are its own: ``'window_plain'`` is its
    reference. JAX's names of the other routes are accepted (see
    ``_UNKNOWN``). ``twoway_impl='chunk'`` decodes through the whole-chunk kernel (B16;
    a shared batch-1 image embedding), ``'chunk_plain'`` through its plain
    version (JAX's ``'chunk_xla'``)."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    global_attn_indexes: Sequence[int] = (2, 5, 8, 11)
    img_size: int = 1024
    patch_size: int = 16
    prompt_embed_dim: int = 256
    window_size: int = 14
    dtype: str = "float32"
    attn_impl: str = "auto"
    twoway_impl: str = "auto"

    def __post_init__(self):
        for field, allowed in (("attn_impl", ATTN_IMPLS),
                               ("twoway_impl", TWOWAY_IMPLS)):
            value = getattr(self, field)
            if value not in allowed:
                raise ValueError(_UNKNOWN.format(field=field, value=value, allowed=allowed))

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


SAM_VARIANTS = {
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)),
    "base": dict(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)),
    "large": dict(embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)),
    "huge": dict(embed_dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)),
}


class Sam(nn.Module):
    """Image encoder + prompt encoder + mask decoder. Parameters are fp32
    (cast to ``cfg.dtype`` where used, as flax does)."""

    def __init__(self, cfg: SamConfig = SamConfig()):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.image_encoder = ImageEncoderViT(
            img_size=cfg.img_size, patch_size=cfg.patch_size,
            embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
            out_chans=cfg.prompt_embed_dim, window_size=cfg.window_size,
            global_attn_indexes=tuple(cfg.global_attn_indexes), dtype=dtype,
            attn_impl=cfg.attn_impl)
        self.prompt_encoder = PromptEncoder(
            embed_dim=cfg.prompt_embed_dim, image_embedding_size=(cfg.grid, cfg.grid),
            input_image_size=(cfg.img_size, cfg.img_size), dtype=dtype)
        self.mask_decoder = MaskDecoder(
            transformer_dim=cfg.prompt_embed_dim, dtype=dtype,
            twoway_impl=cfg.twoway_impl)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """Raw RGB (B, H, W, 3) -> normalised fp32."""
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=images.device)
        std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=images.device)
        return (images.float() - mean) / std

    def encode_image(self, images: torch.Tensor, return_fpn: bool = True):
        """Normalised (B, H, W, 3) -> (sam_embedding NHWC, {res2..res5});
        the serving path passes ``return_fpn=False`` and gets ``None`` in
        place of the FPN dict (see ``ImageEncoderViT.forward``)."""
        return self.image_encoder(images, return_fpn)

    def decode_from_embedding(self, sam_embedding, points=None, labels=None,
                              boxes=None, masks=None, return_upscaled: bool = True):
        """Per-prompt decode over a (1 or B, H, W, 256) embedding; returns
        the MaskDecoder dict."""
        sparse, dense = self.prompt_encoder(points=points, labels=labels,
                                            boxes=boxes, masks=masks,
                                            batch=sam_embedding.shape[0])
        return self.mask_decoder(sam_embedding, self.prompt_encoder.get_dense_pe(),
                                 sparse, dense, return_upscaled=return_upscaled)

    def forward(self, images, points=None, labels=None, boxes=None, masks=None):
        sam_embedding, fpn = self.encode_image(self.normalize(images))
        out = self.decode_from_embedding(sam_embedding, points, labels, boxes, masks)
        out["fpn"] = fpn
        out["sam_embedding"] = sam_embedding
        return out


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter and buffer from ``generator`` (a CPU generator;
    the model must be on the CPU) with PyTorch's default initialisation of
    each module type: linear and conv weights and biases uniform in
    +-1/sqrt(fan_in), embeddings and the Fourier matrix standard normal,
    norms at one and zero. The rel-pos tables (normal, std 0.1) and the
    pos-embed (std 0.02), zeros by default, are made non-zero so that the
    bias paths are exercised."""
    g = generator
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            bound = module.weight[0].numel() ** -0.5  # torch's fan_in
            module.weight.uniform_(-bound, bound, generator=g)
            if module.bias is not None:
                module.bias.uniform_(-bound, bound, generator=g)
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0, generator=g)
        for name, t in [*module.named_parameters(recurse=False),
                        *module.named_buffers(recurse=False)]:
            if name in ("rel_pos_h", "rel_pos_w"):
                t.normal_(0.0, 0.1, generator=g)
            elif name == "pos_embed":
                t.normal_(0.0, 0.02, generator=g)
            elif name == "positional_encoding_gaussian_matrix":
                t.normal_(0.0, 1.0, generator=g)
    return model


def target_device(device, builder: str) -> torch.device:
    """The device an entry point builds on: the card unless the caller asks
    for another. Raises when the card is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{builder}: no CUDA card (torch.cuda.is_available() is false); "
                           "pass device='cpu' to build on the CPU")
    return device


def build_sam(variant: str = "vit_b", device="cuda",
              generator: torch.Generator | None = None, **overrides) -> Sam:
    """Build ``variant`` with ``overrides`` of SamConfig on ``device`` (the
    card by default; ``device='cpu'`` for the CPU); with ``generator`` the
    weights are drawn from it (on the CPU), then moved to ``device``."""
    device = target_device(device, "build_sam")
    model = Sam(SamConfig(**{**SAM_VARIANTS[variant], **overrides}))
    if generator is not None:
        init_random_(model, generator)
    return model.to(device)


sam_model_registry = {name: functools.partial(build_sam, name) for name in SAM_VARIANTS}
