"""SysLearner — the unified top model, PyTorch port of
``iuvl_tpu/models/xdecoder/model.py``: the seg training forward, the seg
eval forward and the class text embeddings.

SAM backbone (image encoder with the SimpleFPN; prompt encoder and mask
decoder, which the seg paths do not read) -> deformable pixel decoder
-> 9-layer unified decoder, and the CLIP-style text tower with its
``logit_scale``. Parameters are fp32 and cast to ``cfg.dtype`` where used,
as flax does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..sam.build import SAM_VARIANTS, SamConfig, init_random_, target_device
from ..sam.image_encoder import ImageEncoderViT
from ..sam.mask_decoder import MaskDecoder
from ..sam.prompt_encoder import PromptEncoder
from ...ops.resize import resize_axis
from .lang_encoder import LanguageEncoder
from .pixel_decoder import DeformablePixelDecoder, MSDeformAttn, sampling_offset_grid
from .unified_decoder import UnifiedDecoder

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
# msdeform_impl values of the JAX package that the port runs (``ops/msdeform.py``):
# ``flat`` with the B7 and B8 kernels, ``hybrid`` with B15 on the small levels,
# ``wide`` and ``xla`` as the plain core.
MSDEFORM_IMPLS = ("auto", "flat", "hybrid", "wide", "xla")


@dataclasses.dataclass(frozen=True)
class SysLearnerConfig:
    """The JAX ``SysLearnerConfig``'s fields that the ported modules read;
    the others raise unless left at their defaults. ``attn_impl``:
    ``'auto'`` runs the CUDA kernels on CUDA tensors (their plain versions
    on the CPU), ``'plain'`` the plain PyTorch versions everywhere;
    ``'rowbias'`` and ``'pallas_rp'`` reach the image encoder (every block's
    attention in B2b / B14, see ``SamConfig``), the other modules run their
    kernels as under ``'auto'``."""

    sam_size: str = "base"
    img_size: int = 1024
    syslearner_dim: int = 512
    mask_proposals: int = 100
    contxt_len: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    vocab_size: int = 49408
    pixel_decoder_layers: int = 6
    nheads: int = 8
    dim_feedforward: int = 2048
    llm_dim: int = 0
    retrieval_ensemble: bool = False
    dtype: str = "float32"
    attn_impl: str = "auto"
    remat: bool = False
    msdeform_impl: str = "auto"
    pixel_decoder: str = "msdeform"
    detection: bool = False

    def __post_init__(self):
        unported = {"remat": self.remat, "detection": self.detection,
                    "llm_dim": self.llm_dim, "retrieval_ensemble": self.retrieval_ensemble,
                    "pixel_decoder": self.pixel_decoder != "msdeform",
                    "msdeform_impl": self.msdeform_impl not in MSDEFORM_IMPLS}
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                f"SysLearnerConfig: {asked} not ported yet (ROADMAP.md lists them)")

    @property
    def kernels_impl(self) -> str:
        """The impl of the modules outside the image encoder (the pixel
        decoder's deformable core, the criterion): ``'plain'`` or
        ``'auto'``; JAX's ``attn_impl`` reaches the encoder only."""
        return "plain" if self.attn_impl == "plain" else "auto"

    @property
    def num_queries(self) -> int:
        return self.mask_proposals + 1

    def sam_config(self) -> SamConfig:
        return SamConfig(**SAM_VARIANTS[self.sam_size], img_size=self.img_size,
                         dtype=self.dtype, attn_impl=self.attn_impl)


class SysLearner(nn.Module):
    def __init__(self, cfg: SysLearnerConfig = SysLearnerConfig()):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        sam = cfg.sam_config()
        self.image_encoder = ImageEncoderViT(
            img_size=sam.img_size, patch_size=sam.patch_size, embed_dim=sam.embed_dim,
            depth=sam.depth, num_heads=sam.num_heads, out_chans=sam.prompt_embed_dim,
            window_size=sam.window_size, global_attn_indexes=tuple(sam.global_attn_indexes),
            dtype=dtype, attn_impl=cfg.attn_impl)
        self.prompt_encoder = PromptEncoder(
            embed_dim=sam.prompt_embed_dim, image_embedding_size=(sam.grid, sam.grid),
            input_image_size=(sam.img_size, sam.img_size), dtype=dtype)
        self.mask_decoder = MaskDecoder(transformer_dim=sam.prompt_embed_dim, dtype=dtype,
                                        twoway_impl=sam.twoway_impl)
        d = cfg.syslearner_dim
        self.pixel_decoder = DeformablePixelDecoder(
            conv_dim=d, mask_dim=d, num_layers=cfg.pixel_decoder_layers, n_heads=cfg.nheads,
            dtype=dtype, msdeform_impl=cfg.msdeform_impl, attn_impl=cfg.kernels_impl)
        self.predictor = UnifiedDecoder(
            hidden_dim=d, dim_proj=d, num_queries=cfg.num_queries, contxt_len=cfg.contxt_len,
            nheads=cfg.nheads, dim_feedforward=cfg.dim_feedforward, mask_dim=d, dtype=dtype)
        self.lang_encoder = LanguageEncoder(
            width=cfg.text_width, proj_dim=d, layers=cfg.text_layers, heads=cfg.text_heads,
            context_length=cfg.contxt_len, vocab_size=cfg.vocab_size, dtype=dtype)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """Raw RGB (B, H, W, 3) -> normalised fp32."""
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=images.device)
        std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=images.device)
        return (images.float() - mean) / std

    def encode_image(self, images: torch.Tensor, return_embedding: bool = True):
        """Raw RGB (B, H, W, 3) -> (sam_embedding or None, fpn dict)."""
        return self.image_encoder(self.normalize(images), return_fpn=True,
                                  return_embedding=return_embedding)

    def encode_text_embeddings(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids -> (B, syslearner_dim) fp32 pooled, projected,
        unit-length text embeddings."""
        return self.lang_encoder.forward_language(input_ids)

    def _head(self, fpn, text_embeddings, task: str, **kw):
        mask_features, multi_scale = self.pixel_decoder(fpn)
        return self.predictor(multi_scale, mask_features, text_embeddings=text_embeddings,
                              logit_scale=self.lang_encoder.logit_scale, task=task, **kw)

    def forward_seg(self, images: torch.Tensor, text_embeddings: torch.Tensor) -> dict:
        """Training forward of the seg stream: raw head outputs (the SAM
        embedding, which it does not read, is not computed)."""
        _, fpn = self.encode_image(images, return_embedding=False)
        return self._head(fpn, text_embeddings, "seg")

    def evaluate_seg(self, images: torch.Tensor, text_embeddings: torch.Tensor):
        """Eval forward: raw RGB (B, H, W, 3) and (K, dim) class embeddings
        -> (mask_cls (B, Q, K), mask_pred (B, Q, H, W) fp32), the mask
        logits bilinearly resized to the input size as ``jax.image.resize``
        does."""
        _, fpn = self.encode_image(images, return_embedding=False)
        out = self._head(fpn, text_embeddings, "seg")
        h, w = images.shape[1], images.shape[2]
        mask_pred = resize_axis(resize_axis(out["pred_masks"], 2, h, "linear"), 3, w, "linear")
        return out["pred_logits"], mask_pred


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``truncated_normal(std)``: a normal cut at +-2 standard
    deviations, scaled so that the cut distribution has std ``std``."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.empty_like(t).uniform_(lo, hi, generator=generator)
    return t.copy_(torch.erfinv(2 * u - 1) * math.sqrt(2) * (std / 0.87962566103423978))


@torch.no_grad()
def init_syslearner_(model: SysLearner, generator: torch.Generator) -> SysLearner:
    """Seeded random weights on the CPU: the SAM part as ``init_random_``
    draws them (PyTorch's default per module type), the X-Decoder tables as
    flax initialises them (query and level tables normal(1), class and
    caption projections normal(0.02)), ``logit_scale`` at CLIP's log(1/0.07),
    and the sampling offsets' bias as the reference's compass grid. The
    text tower is drawn last, so that the other weights do not depend on
    its size: its linear layers as ``init_random_`` draws them, the token,
    positional and ``lang_proj`` tables as flax does (truncated normal,
    std 0.02)."""
    for name, child in model.named_children():
        if name != "lang_encoder":
            init_random_(child, generator)
    pred = model.predictor
    for t in (pred.query_feat, pred.query_embed, pred.level_embed, pred.pos_embed_caping,
              model.pixel_decoder.level_embed):
        t.normal_(0.0, 1.0, generator=generator)
    for t in (pred.class_embed, pred.caping_embed):
        t.normal_(0.0, 0.02, generator=generator)
    for m in model.modules():
        if isinstance(m, MSDeformAttn):
            m.sampling_offsets.bias.copy_(sampling_offset_grid(m.n_heads, m.n_levels,
                                                               m.n_points))
    lang = model.lang_encoder
    lang.logit_scale.fill_(math.log(1 / 0.07))
    init_random_(lang, generator)
    for t in (lang.lang_encoder.token_embedding, lang.lang_encoder.positional_embedding,
              lang.lang_proj):
        _trunc_normal_(t, 0.02, generator)
    return model


def build_syslearner(cfg: SysLearnerConfig = SysLearnerConfig(), device="cuda",
                     generator: torch.Generator | None = None) -> SysLearner:
    """Build ``cfg`` on ``device`` (the card by default; ``device='cpu'`` for
    the CPU); with ``generator`` the weights are drawn from it (on the CPU,
    :func:`init_syslearner_`), then moved to ``device``."""
    device = target_device(device, "build_syslearner")
    model = SysLearner(cfg)
    if generator is not None:
        init_syslearner_(model, generator)
    return model.to(device)
