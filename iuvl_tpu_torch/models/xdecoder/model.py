"""SysLearner — the unified top model, PyTorch port of
``iuvl_tpu/models/xdecoder/model.py``: the training forwards of the
step-1 streams (seg with grounding tokens, VLP captioning and retrieval,
spatial prompts), the seg eval forward, the class text embeddings, the
interactive path (one encode, many prompt decodes through SAM's decoder
into the unified one), the vision-language evals: grounding,
retrieval (with the backbone ensemble of ``retrieval_ensemble``) and
greedy captioning, by full re-run or KV-cached, and the vision side of the
LLM stage (``forward_llm_features``: the ``'llm'`` task's object-query
features through the ``img_to_lang`` projector of ``llm_dim``).

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
from ...ops.common import linear
from ...ops.resize import resize_axis
from .lang_encoder import LanguageEncoder, _unit
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
    the other encoder routes (``'rowbias'``, ``'pallas_rp'``, ``'window'``,
    ``'pallas'``, JAX's names; see ``SamConfig``) reach the image encoder
    only, the other modules run their kernels as under ``'auto'``.
    ``twoway_impl`` (a field of the port alone: JAX's SysLearner builds its
    mask decoder with the default ``'auto'``) picks SAM's decode design for
    the interactive path, as ``SamConfig.twoway_impl`` does."""

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
    twoway_impl: str = "auto"
    remat: bool = False
    msdeform_impl: str = "auto"
    pixel_decoder: str = "msdeform"
    detection: bool = False

    def __post_init__(self):
        unported = {"remat": self.remat, "detection": self.detection,
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
        return "plain" if self.attn_impl in ("plain", "xla", "xla_naive", "window_plain") \
            else "auto"

    @property
    def num_queries(self) -> int:
        return self.mask_proposals + 1

    def sam_config(self) -> SamConfig:
        return SamConfig(**SAM_VARIANTS[self.sam_size], img_size=self.img_size,
                         dtype=self.dtype, attn_impl=self.attn_impl,
                         twoway_impl=self.twoway_impl)


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
        if cfg.retrieval_ensemble:
            # The backbone branch of the retrieval ensemble: res5, pooled over
            # space, into the retrieval space (no bias).
            res5 = self.image_encoder.neck.down_32[2].out_channels
            self.backbone_proj = nn.Linear(res5, d, bias=False)
        if cfg.llm_dim:
            # The LLM projector: the object queries' features into the LLM's width.
            self.img_to_lang = nn.Linear(d, cfg.llm_dim)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """Raw RGB (B, H, W, 3) -> normalised fp32."""
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=images.device)
        std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=images.device)
        return (images.float() - mean) / std

    def encode_image(self, images: torch.Tensor, return_embedding: bool = True):
        """Raw RGB (B, H, W, 3) -> (sam_embedding or None, fpn dict)."""
        return self.image_encoder(self.normalize(images), return_fpn=True,
                                  return_embedding=return_embedding)

    def encode_text_embeddings(self, input_ids: torch.Tensor, attention_mask=None,
                               norm: bool = True) -> torch.Tensor:
        """(B, T) token ids -> (B, syslearner_dim) fp32 pooled, projected
        text embeddings, unit-length with ``norm``. The tower is causal:
        ``attention_mask`` is not read."""
        return self.lang_encoder.forward_language(input_ids, norm=norm)

    def encode_text_tokens(self, input_ids: torch.Tensor, attention_mask=None,
                           norm: bool = False):
        """(B, T) token ids -> ((B, T, dim) token embeddings, (B, dim) class
        embedding), fp32 (``LanguageEncoder.forward_language_token``)."""
        return self.lang_encoder.forward_language_token(input_ids, norm=norm)

    def logit_scale(self) -> torch.Tensor:
        return self.lang_encoder.logit_scale

    def _head(self, fpn, text_embeddings, task: str, **kw):
        mask_features, multi_scale = self.pixel_decoder(fpn)
        return self.predictor(multi_scale, mask_features, text_embeddings=text_embeddings,
                              logit_scale=self.lang_encoder.logit_scale, task=task, **kw)

    def forward_seg(self, images: torch.Tensor, text_embeddings: torch.Tensor,
                    grounding_tokens=None, grounding_valid=None) -> dict:
        """Training forward of the seg stream: raw head outputs (the SAM
        embedding, which it does not read, is not computed); with
        ``grounding_tokens`` (B, G, C) and their (B, G) validity the
        ``'seg_grounding'`` task."""
        _, fpn = self.encode_image(images, return_embedding=False)
        return self.seg_head(*self.pixel_decoder(fpn), text_embeddings, grounding_tokens,
                             grounding_valid)

    def seg_head(self, mask_features, multi_scale, text_embeddings, grounding_tokens=None,
                 grounding_valid=None) -> dict:
        """:meth:`forward_seg` from the pixel decoder's products: the
        unified decoder's ``'seg'`` task, or ``'seg_grounding'`` with
        grounding tokens."""
        task = "seg" if grounding_tokens is None else "seg_grounding"
        kw = {} if grounding_tokens is None else dict(grounding_tokens=grounding_tokens,
                                                      grounding_valid=grounding_valid)
        return self.predictor(multi_scale, mask_features, text_embeddings=text_embeddings,
                              logit_scale=self.lang_encoder.logit_scale, task=task, **kw)

    def forward_vlp_train(self, images: torch.Tensor, caption_ids: torch.Tensor,
                          caption_mask: torch.Tensor) -> dict:
        """Training forward of the VLP stream: the caption's tokens through
        the text tower, the ``'vlp'`` task on them (teacher forcing through
        the causal caption block), and what the captioning and retrieval
        losses read besides: the pooled caption embedding
        (``caption_class_emb``), the backbone embedding with
        ``retrieval_ensemble`` (``backbone_emb``), the token table
        (projected by ``lang_proj`` when its width is not the decoder's)
        and ``logit_scale``."""
        token_emb, class_emb = self.lang_encoder.forward_language_token(caption_ids,
                                                                        caption_mask)
        _, fpn = self.encode_image(images, return_embedding=False)
        out = self._head(fpn, None, "vlp", caption_tokens=token_emb)
        out["caption_class_emb"] = class_emb
        if self.cfg.retrieval_ensemble:
            out["backbone_emb"] = self.backbone_retrieval_emb(fpn)
        table = self.lang_encoder.lang_encoder.token_table()
        if table.shape[-1] != self.cfg.syslearner_dim:
            table = table @ self.lang_encoder.lang_proj
        out["token_table"] = table
        out["logit_scale"] = self.lang_encoder.logit_scale
        return out

    def forward_spatial_train(self, images: torch.Tensor, points: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
        """Training forward of the spatial-prompt stream: raw RGB (B, H, W,
        3), one click a prompt ((B, P, 2) input-space xy, (B, P) labels, 1
        positive, -1 pad) -> (B, P, H/4, W/4) mask logits, each prompt
        decoded by SAM on its own and injected into the unified decoder."""
        return self.spatial_decode(*self.encode_interactive(images), points, labels)

    def spatial_decode(self, sam_embedding, mask_features, multi_scale, points,
                       labels) -> torch.Tensor:
        """:meth:`forward_spatial_train` from the encode products: a batch-1
        embedding stays batch 1 (broadcast lazily in the decoders), a larger
        one is repeated a prompt (JAX's ``jnp.repeat``)."""
        b, p = points.shape[:2]
        emb = sam_embedding if b == 1 else sam_embedding.repeat_interleave(p, dim=0)
        logits = self.decode_interactive(emb, mask_features, multi_scale,
                                         points=points.reshape(b * p, 1, 2),
                                         labels=labels.reshape(b * p, 1))
        return logits.reshape(b, p, *logits.shape[1:])

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

    # -- the vision-language evals --------------------------------------------
    def evaluate_grounding(self, images: torch.Tensor, grounding_tokens: torch.Tensor,
                           grounding_valid: torch.Tensor, class_emb: torch.Tensor,
                           matched=None, return_matched: bool = False):
        """Raw RGB (B, H, W, 3), a phrase's (B, G, C) token embeddings with
        their (B, G) validity, and (B, T, C) pooled phrase embeddings ->
        (B, T, H, W) fp32 mask logits: per phrase the mask of the
        duplicated query whose caption embedding is most like the phrase's,
        bicubically resized to the input size (``jax.image.resize``'s
        kernel, not ``F.interpolate``'s). ``matched`` (B, T) gives the
        queries instead; ``return_matched`` also returns the queries."""
        _, fpn = self.encode_image(images, return_embedding=False)
        out = self._head(fpn, None, "grounding_eval", grounding_tokens=grounding_tokens,
                         grounding_valid=grounding_valid)
        nq = self.cfg.num_queries
        pred_gmasks = out["pred_masks"][:, nq: 2 * nq - 1]
        if matched is None:
            sim = torch.exp(self.lang_encoder.logit_scale) * torch.einsum(
                "bqc,btc->btq", _unit(out["pred_captions"][:, nq: 2 * nq - 1]),
                _unit(class_emb))
            matched = sim.argmax(dim=-1)
        masks = pred_gmasks[torch.arange(matched.shape[0], device=matched.device)[:, None],
                            matched]
        h, w = images.shape[1], images.shape[2]
        masks = resize_axis(resize_axis(masks, 2, h, "cubic"), 3, w, "cubic")
        return (masks, matched) if return_matched else masks

    def _class_query_emb(self, fpn: dict) -> torch.Tensor:
        return _unit(self._head(fpn, None, "seg")["pred_captions"][:, -1])

    def evaluate_retrieval(self, images: torch.Tensor) -> torch.Tensor:
        """(B, dim) unit embeddings of the images: the class query's caption
        embedding (retrieval and zero-shot classification)."""
        _, fpn = self.encode_image(images, return_embedding=False)
        return self._class_query_emb(fpn)

    def backbone_retrieval_emb(self, fpn: dict) -> torch.Tensor:
        """(B, dim) fp32: res5 averaged over space, through
        ``backbone_proj`` in the working dtype (flax's bf16 Dense rounds the
        fp32 mean to bf16 and multiplies there)."""
        res5 = fpn["res5"]
        v = res5.float().mean(dim=(1, 2)).to(res5.dtype).float()
        return linear(v, self.backbone_proj.weight, None, getattr(torch, self.cfg.dtype)).float()

    def evaluate_retrieval_ensemble(self, images: torch.Tensor):
        """Both unit retrieval embeddings from one encode: (the class
        query's, the backbone's); the evaluator averages their similarity
        matrices."""
        _, fpn = self.encode_image(images, return_embedding=False)
        return self._class_query_emb(fpn), _unit(self.backbone_retrieval_emb(fpn))

    def _caption_loop(self, images, steps: int, sot_id: int, step_row, forced_ids,
                      return_logits: bool):
        """The greedy decode both captioning paths share: ids start as
        ``sot_id`` everywhere; step t's logits row (``step_row(t, ids,
        id_t)``, (B, dim)) against the token table picks id t + 1, by argmax
        or from ``forced_ids`` (teacher forcing). Ids stay on the device."""
        b, ctx = images.shape[0], self.cfg.contxt_len
        ids = torch.full((b, ctx), sot_id, dtype=torch.long, device=images.device)
        table = self.lang_encoder.lang_encoder.token_table().float()
        rows = []
        for t in range(min(steps, ctx - 1)):
            logits = step_row(t, ids, ids[:, t]).float() @ table.t()
            if return_logits:
                rows.append(logits)
            ids[:, t + 1] = logits.argmax(dim=-1) if forced_ids is None else forced_ids[:, t + 1]
        return (ids, torch.stack(rows, dim=1)) if return_logits else ids

    def evaluate_captioning(self, images: torch.Tensor, steps: int = 50, sot_id: int = 49406,
                            forced_ids=None, return_logits: bool = False):
        """Greedy caption ids (B, contxt_len), re-running the text tower
        and the 'vlp' decoder over all the caption slots for every token;
        the image is encoded once. ``min(steps, contxt_len - 1)`` steps.
        ``forced_ids`` (B, contxt_len) decodes along given ids, and
        ``return_logits`` also returns each step's (B, steps, vocab) fp32
        logits."""
        _, fpn = self.encode_image(images, return_embedding=False)
        mask_features, multi_scale = self.pixel_decoder(fpn)

        def step_row(t, ids, _):
            tok_emb, _ = self.lang_encoder.forward_language_token(ids)
            out = self.predictor(multi_scale, mask_features, logit_scale=self.logit_scale(),
                                 task="vlp", caption_tokens=tok_emb)
            return out["pred_captionings"][:, t]

        return self._caption_loop(images, steps, sot_id, step_row, forced_ids, return_logits)

    def evaluate_captioning_cached(self, images: torch.Tensor, steps: int = 50,
                                   sot_id: int = 49406, forced_ids=None,
                                   return_logits: bool = False):
        """:meth:`evaluate_captioning`'s ids with one row a token: the query
        block runs once (``captioning_prefill``), each step takes one token
        through the KV-cached text tower and one caption row through the
        decoder's layers against the cached projections."""
        _, fpn = self.encode_image(images, return_embedding=False)
        mask_features, multi_scale = self.pixel_decoder(fpn)
        prefill = self.predictor.captioning_prefill(multi_scale, mask_features)
        caches = self.predictor.init_caption_cache(images.shape[0])
        tcaches = self.lang_encoder.init_text_cache(images.shape[0])

        def step_row(t, _, cur_id):
            e_t, _ = self.lang_encoder.forward_token_step(cur_id, t, tcaches)
            return self.predictor.caption_decode_step(prefill, caches, e_t, t)[0]

        return self._caption_loop(images, steps, sot_id, step_row, forced_ids, return_logits)

    # -- the vision side of the LLM stage --------------------------------------
    def project_image_features(self, image_feature: torch.Tensor) -> torch.Tensor:
        """(B, N, dim) features -> (B, N, llm_dim) in the working dtype
        (``img_to_lang``, flax's Dense: rounded before its bias)."""
        return linear(image_feature, self.img_to_lang.weight, self.img_to_lang.bias,
                      getattr(torch, self.cfg.dtype))

    def llm_image_features(self, images: torch.Tensor,
                           context_tokens: torch.Tensor) -> torch.Tensor:
        """Raw RGB (B, H, W, 3) and the question's (B, contxt_len, dim)
        token embeddings -> the unified decoder's ``'llm'`` task's (B,
        num_queries - 1, dim) object-query features, cut from the gradient
        (JAX's ``stop_gradient``)."""
        _, fpn = self.encode_image(images, return_embedding=False)
        out = self._head(fpn, None, "llm", caption_tokens=context_tokens)
        return out["image_feature"].detach()

    def forward_llm_features(self, images: torch.Tensor,
                             context_tokens: torch.Tensor) -> torch.Tensor:
        """:meth:`llm_image_features` through the projector: (B,
        num_queries - 1, llm_dim)."""
        return self.project_image_features(self.llm_image_features(images, context_tokens))

    # -- the interactive path: one encode, many prompt decodes --------------
    def decode_prompts(self, sam_embedding, points=None, labels=None, boxes=None, masks=None,
                       return_upscaled: bool = True, return_masks: bool = True) -> dict:
        """SAM's prompt decode from a cached (1 or B, H, W, 256) embedding:
        the MaskDecoder dict (``return_upscaled=False`` skips the upscaled
        embedding and ``return_masks=False`` the masks, as a JAX program
        that does not read them never makes them)."""
        sparse, dense = self.prompt_encoder(points=points, labels=labels, boxes=boxes,
                                            masks=masks, batch=sam_embedding.shape[0])
        return self.mask_decoder(sam_embedding, self.prompt_encoder.get_dense_pe(), sparse,
                                 dense, return_upscaled=return_upscaled,
                                 return_masks=return_masks)

    def encode_interactive(self, images: torch.Tensor):
        """Raw RGB (B, H, W, 3) -> (sam_embedding, mask_features,
        multi_scale): everything of the interactive path that the prompts
        do not change, cached across click rounds."""
        sam_embedding, fpn = self.encode_image(images)
        mask_features, multi_scale = self.pixel_decoder(fpn)
        return sam_embedding, mask_features, multi_scale

    def decode_interactive(self, sam_embedding, mask_features, multi_scale, points=None,
                           labels=None, boxes=None, masks=None) -> torch.Tensor:
        """One prompt round from the cached products: SAM's prompt decode,
        then the unified decoder's interactive task with the primary mask
        token's hypernetwork vector as the prompt query and the upscaled
        embedding as the mask-feature modulation; batch-1 caches are
        broadcast to the prompt batch. Returns (N, H/4, W/4) mask logits,
        one a prompt set. SAM's own masks are not made (B6 is skipped): this
        path does not read them."""
        dec = self.decode_prompts(sam_embedding, points=points, labels=labels, boxes=boxes,
                                  masks=masks, return_masks=False)
        n = dec["hyper_in"].shape[0]

        def tile(x):
            if x.shape[0] == n:
                return x
            if x.shape[0] == 1:
                return x.expand(n, *x.shape[1:])
            return x.repeat_interleave(n // x.shape[0], dim=0)

        out = self.predictor([tile(x) for x in multi_scale], tile(mask_features),
                             text_embeddings=None, logit_scale=self.lang_encoder.logit_scale,
                             task="interactive", sam_queries=dec["hyper_in"][:, :1],
                             sam_features=dec["upscaled_embedding"])
        return out["pred_interactive_masks"][:, 0]

    def evaluate_interactive_step(self, sam_embedding, fpn, points, labels) -> dict:
        """A click round scored by SAM's own masks (the ablation baseline):
        the prompt decode alone; ``fpn`` is not read, as in JAX."""
        del fpn
        return self.decode_prompts(sam_embedding, points=points, labels=labels)


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
    text tower is drawn after them, so that the other weights do not depend
    on its size: its linear layers as ``init_random_`` draws them, the token,
    positional and ``lang_proj`` tables as flax does (truncated normal,
    std 0.02); ``backbone_proj`` (with ``retrieval_ensemble``) as flax
    does (truncated normal, std 0.02); ``img_to_lang`` (with ``llm_dim``)
    last, as ``init_random_`` draws a linear layer."""
    for name, child in model.named_children():
        if name not in ("lang_encoder", "backbone_proj", "img_to_lang"):
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
    if model.cfg.retrieval_ensemble:
        _trunc_normal_(model.backbone_proj.weight, 0.02, generator)
    if model.cfg.llm_dim:
        init_random_(model.img_to_lang, generator)
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
