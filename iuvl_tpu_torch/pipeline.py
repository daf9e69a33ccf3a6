"""The evaluations, PyTorch port of these parts of ``iuvl_tpu/pipeline.py``:
``class_text_embeddings`` (the class-name embeddings with the prompt
ensemble), the seg-mode body of ``_evaluate_dataset`` (``evaluate_seg``,
then semantic inference into the mIoU evaluator, the panoptic merge into
the PQ evaluator and instance inference into the AP evaluator),
``_evaluate_interactive`` (the click loop, or the single-shot box / stroke
prompts, into the NoC evaluator), and the vision-language modes:
``_evaluate_grounding`` (each phrase's mask into the IoU evaluator),
``_evaluate_captioning`` (greedy ids, decoded, into BLEU-4 / CIDEr-D),
``_evaluate_retrieval`` (recall@k, with the backbone ensemble when the
model has it) and ``_evaluate_classification`` (zero-shot top-k); and the
LLM stage: ``_evaluate_vqa`` (the LLM built from the config's keys,
``build_llm``; each question answered through it into the VQA evaluator).

It works over in-memory batches and items; of the dataset layer only
the stage-2 instruction stream is ported (``data/datasets.py``). The
model's config from the config dict is ``model_config`` (JAX's
``XDecoderPipeline.model_config``) and ``initialize_model`` builds it with
seeded weights; the trainer reads both. The model's outputs
stay where the model runs: semantic argmax and instance top-k run there,
and only the argmax map, the kept instance masks and the panoptic merge's
inputs come to the host; a caption's ids come to the host once, after its
last step.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from .data.class_names import COCO_THING_IDS
from .data.prompts import clean_class_name, get_prompt_templates
from .data.tokenizer import build_tokenizer
from .data.visual_sampler import box_points
from .evaluation import (CaptioningEvaluator, ClassificationEvaluator, GroundingEvaluator,
                         InstanceAPEvaluator, InteractiveEvaluator, PanopticEvaluator,
                         RetrievalEvaluator, SemSegEvaluator, VQAEvaluator)
from .inference.interactive import make_interactive_loop, sample_fn_click, single_shot_eval
from .inference.postprocess import instance_inference, panoptic_merge, semantic_inference

IGNORE = 255  # the gt label of pixels no mask covers (detectron2's ignore label)
OBJECT_MASK_THRESHOLD = 0.8  # the panoptic merge's class-score cut (step1.yaml TEST)
CAPTIONING_STEPS = 20  # greedy steps a caption (the JAX pipeline's default)
# The JAX pipeline's VQA defaults: new tokens, beams (the reference's), and
# the splice's row length (its LLM_MAX_LEN default there; the cache's is 1024).
VQA_MAX_NEW_TOKENS, VQA_NUM_BEAMS, VQA_MAX_LEN = 8, 5, 64


def model_config(cfg: dict):
    """The ``SysLearnerConfig`` of a config dict, JAX's
    ``XDecoderPipeline.model_config`` with its defaults (``DTYPE`` bfloat16;
    ``llm_dim`` ``LLM_DIM`` 4096 only with ``Load_LLM``). JAX's
    ``ATTN_IMPL`` names (``block``, ``xla``, ...) are passed on: the config
    runs them as the port's routes, as ``SamConfig`` does."""
    from .models.xdecoder.model import SysLearnerConfig

    c = cfg
    return SysLearnerConfig(
        sam_size=c.get("SAM_SIZE", "base"),
        img_size=c.get("IMAGE_SIZE", 1024),
        syslearner_dim=c.get("SYSLEARNER_DIM", 512),
        mask_proposals=c.get("MASK_PROPOSAL", 100),
        contxt_len=c.get("CONTEXT_LEN", 77),
        vocab_size=c.get("TEXT_VOCAB_SIZE", 49408),
        text_width=c.get("TEXT_WIDTH", c.get("SYSLEARNER_DIM", 512)),
        text_layers=c.get("TEXT_LAYERS", 12),
        text_heads=c.get("TEXT_HEADS", 8),
        pixel_decoder_layers=c.get("PIXEL_DECODER_LAYERS", 6),
        nheads=c.get("NHEADS", 8),
        dim_feedforward=c.get("DIM_FEEDFORWARD", 2048),
        dtype=c.get("DTYPE", "bfloat16"),
        attn_impl=c.get("ATTN_IMPL", "auto"),
        msdeform_impl=c.get("MSDEFORM_IMPL", "auto"),
        pixel_decoder=c.get("PIXEL_DECODER", "msdeform"),
        detection=bool(c.get("DETECTION", False)),
        llm_dim=(c.get("LLM_DIM", 4096) if c.get("Load_LLM") else 0),
        retrieval_ensemble=bool(c.get("RETRIEVAL_ENSEMBLE", False)),
    )


def initialize_model(cfg: dict, device="cuda"):
    """:func:`model_config`'s SysLearner on ``device`` (the card unless
    ``device='cpu'``), its weights drawn from a CPU generator seeded 0
    (``init_syslearner_``; JAX draws its own from ``PRNGKey(0)``)."""
    from .models.xdecoder.model import build_syslearner

    return build_syslearner(model_config(cfg), device, torch.Generator().manual_seed(0))


@torch.no_grad()
def class_text_embeddings(model, names: list[str], tokenizer=None) -> torch.Tensor:
    """(K, dim) fp32 eval class embeddings on the model's device: per class
    the text tower's unit embeddings of its name in every prompt template,
    averaged and normalised to unit length."""
    tokenizer = tokenizer or build_tokenizer()
    dev = next(model.parameters()).device
    out = []
    for cls in names:
        cname = clean_class_name(cls)
        texts = [t.format(cname) for t in get_prompt_templates()]
        ids = tokenizer(texts, max_length=model.cfg.contxt_len)["input_ids"]
        mean = model.encode_text_embeddings(torch.from_numpy(ids).to(dev)).mean(0)
        out.append(mean / (torch.linalg.vector_norm(mean) + 1e-7))
    return torch.stack(out)


def gt_from_batch(batch: dict, b: int, out_hw: tuple[int, int]):
    """Image ``b``'s instance masks -> (semantic map with IGNORE where no
    mask, the valid masks upsampled to ``out_hw`` (bool), their labels)."""
    gt = np.full(out_hw, IGNORE, np.int64)
    scale = out_hw[0] // batch["masks"].shape[2]
    masks, labels = [], []
    for k in range(batch["masks"].shape[1]):
        if batch["valid"][b, k]:
            m = batch["masks"][b, k].repeat(scale, 0).repeat(scale, 1) > 0.5
            gt[m] = batch["labels"][b, k]
            masks.append(m)
            labels.append(int(batch["labels"][b, k]))
    if not masks:
        return gt, np.zeros((0, *out_hw), bool), np.zeros(0, np.int64)
    return gt, np.stack(masks), np.asarray(labels)


def gt_panoptic(gt_masks, gt_labels):
    """Instance masks -> (panoptic id map, segments), later masks on top."""
    if len(gt_masks) == 0:
        return np.zeros((1, 1), np.int32), []
    pan = np.zeros(gt_masks.shape[1:], np.int32)
    segs = []
    for i, (m, lab) in enumerate(zip(gt_masks, gt_labels)):
        pan[m] = i + 1
        segs.append({"id": i + 1, "category_id": int(lab)})
    return pan, segs


class _Clock:
    """Host seconds per stage, the card synchronised at each stage's ends
    (only when ``into`` is given)."""

    def __init__(self, into: dict | None, device: torch.device):
        self.into, self.sync = into, device.type == "cuda"

    def __call__(self, stage: str, fn):
        if self.into is None:
            return fn()
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if self.sync:
            torch.cuda.synchronize()
        self.into.setdefault(stage, []).append(time.perf_counter() - t0)
        return out


@torch.no_grad()
def evaluate_seg_batches(model, text_emb: torch.Tensor, batches: Iterable[dict],
                         name: str = "synthetic_seg", timings: dict | None = None) -> dict:
    """The seg eval of JAX's ``_evaluate_dataset`` for a panoptic dataset
    (semantic, panoptic and instance heads) over ``batches``, dicts of
    numpy arrays: ``image`` (B, H, W, 3) raw RGB, ``masks`` (B, T, h, w)
    with H a multiple of h, ``labels`` and ``valid`` (B, T). ``text_emb``
    (K + 1, dim) on the model's device. Things: COCO's for a COCO name,
    else every class. Returns the evaluators' metrics keyed
    ``<name>/<metric>``; with ``timings`` each stage's host seconds per
    image are appended to it (``evaluate_seg`` per batch)."""
    num_classes = text_emb.shape[0] - 1
    thing_ids = COCO_THING_IDS if "coco" in name else set(range(num_classes))
    dev = text_emb.device
    clock = _Clock(timings, dev)
    sem_eval = SemSegEvaluator(num_classes=num_classes, ignore_label=IGNORE)
    pan_eval = PanopticEvaluator(thing_ids=thing_ids)
    inst_eval = InstanceAPEvaluator(num_classes=num_classes)
    thing_mask = torch.tensor([i in thing_ids for i in range(num_classes)], device=dev)
    processed = 0
    for batch in batches:
        images = torch.from_numpy(np.asarray(batch["image"], np.float32)).to(dev)
        mask_cls, mask_pred = clock("evaluate_seg", lambda: model.evaluate_seg(images, text_emb))
        for b in range(images.shape[0]):
            gt_sem, gt_masks, gt_labels = gt_from_batch(batch, b, tuple(mask_pred.shape[2:]))
            processed += 1
            pred = clock("semantic", lambda: semantic_inference(
                mask_cls[b], mask_pred[b]).argmax(0).cpu().numpy())
            sem_eval.process(pred, gt_sem)
            pan_seg, segs = clock("panoptic", lambda: panoptic_merge(
                mask_cls[b].float().cpu().numpy(), mask_pred[b].float().cpu().numpy(),
                thing_ids=thing_ids, object_mask_threshold=OBJECT_MASK_THRESHOLD))
            pan_eval.process(pan_seg, segs, *gt_panoptic(gt_masks, gt_labels))

            def instances():
                inst = instance_inference(mask_cls[b], mask_pred[b], topk=100,
                                          thing_mask=thing_mask)
                keep = inst["valid"] & (inst["scores"] > 0)
                return [inst[k][keep].cpu().numpy()
                        for k in ("pred_masks", "scores", "pred_classes")]
            inst_eval.process(*clock("instance", instances), gt_masks, gt_labels)
    out = {f"{name}/{k}": v for k, v in sem_eval.evaluate().items()}
    out[f"{name}/processed"] = processed
    for ev in (pan_eval, inst_eval):
        out.update({f"{name}/{k}": v for k, v in ev.evaluate().items()})
    return out


@torch.no_grad()
def evaluate_interactive_batches(model, items: Iterable[dict], name: str = "interactive",
                                 prompt_mode: str = "Point", max_clicks: int = 20,
                                 unified: bool = True, sample_fn=sample_fn_click) -> dict:
    """JAX's ``_evaluate_interactive`` over ``items``, dicts of numpy
    arrays: ``image`` (H, W, 3) raw RGB, ``gt_masks`` (N, H, W) bool at the
    input resolution, ``spatial_query`` with ``click_points`` (N, 2) xy
    (else the first pixel of each ``rand_shape`` mask is the first click)
    and, for the single-shot modes, ``rand_shape`` (N, H, W). Each image is
    encoded once (``encode_interactive``); ``prompt_mode`` 'Point' runs the
    click loop (the draws of item i from a generator seeded i on the
    model's device), 'Box' and the stroke modes one decode, its IoU
    standing for every click. Returns the evaluator's metrics keyed
    ``<name>/<metric>``."""
    dev = next(model.parameters()).device
    evaluator = InteractiveEvaluator(max_clicks=max_clicks)
    loop = make_interactive_loop(model, max_clicks=max_clicks, unified=unified,
                                 sample_fn=sample_fn)
    for i, item in enumerate(items):
        gtn = np.asarray(item["gt_masks"], bool)
        if len(gtn) == 0:
            continue
        image = torch.from_numpy(np.asarray(item["image"], np.float32)[None]).to(dev)
        sam_emb, mask_features, multi_scale = model.encode_interactive(image)
        sq = item["spatial_query"]
        if prompt_mode != "Point":
            boxes = np.stack([box_points(m) for m in gtn]) if prompt_mode == "Box" else None
            ious, _ = single_shot_eval(model, sam_emb, gtn,
                                       "box" if prompt_mode == "Box" else "stroke",
                                       prompt_masks=sq.get("rand_shape"), boxes=boxes, seed=i)
            for iou in ious.cpu().numpy():
                evaluator.process(np.full(max_clicks, iou, np.float64))
            continue
        if "click_points" in sq:
            firsts = np.asarray(sq["click_points"], np.float32)
        else:
            firsts = []
            for m in np.asarray(sq["rand_shape"]):
                ys, xs = np.nonzero(m)
                firsts.append([xs[0], ys[0]] if len(ys) else [0, 0])
        gen = torch.Generator(device=dev).manual_seed(i)
        ious, _ = loop(sam_emb, mask_features, multi_scale, torch.from_numpy(gtn).to(dev),
                       torch.from_numpy(np.asarray(firsts, np.float32)).to(dev), gen)
        for traj in ious.cpu().numpy().T:
            evaluator.process(traj)
    return {f"{name}/{k}": v for k, v in evaluator.evaluate().items()}


def resize_hwc_np(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) array to (nh, nw, C) on the host:
    half-pixel sample positions clamped to the image, the two taps each way
    clamped too (the JAX package's ``data/augment._resize``)."""
    h, w = image.shape[:2]
    ys = np.clip(((np.arange(nh) + 0.5) * h / nh - 0.5), 0, h - 1)
    xs = np.clip(((np.arange(nw) + 0.5) * w / nw - 0.5), 0, w - 1)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    f = image.astype(np.float32)
    top = f[y0][:, x0] * (1 - fx) + f[y0][:, x1] * fx
    bot = f[y1][:, x0] * (1 - fx) + f[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def resize_chw_np(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """(C, h', w') logits -> (C, h, w), :func:`resize_hwc_np` on the host."""
    return resize_hwc_np(np.moveaxis(x, 0, -1), h, w).transpose(2, 0, 1)


def _image(item: dict, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(item["image"], np.float32)[None]).to(dev)


@torch.no_grad()
def evaluate_grounding_items(model, items: Iterable[dict], name: str = "grounding") -> dict:
    """JAX's ``_evaluate_grounding`` over ``items``, dicts of numpy arrays:
    ``image`` (H, W, 3) raw RGB, ``text_ids`` / ``text_mask`` (n, T) of the
    phrases (``texts`` names them: phrases past ``len(texts)`` are padding,
    at least one is read), ``gt_mask`` (h0, w0) bool. Each phrase's mask
    logits (``evaluate_grounding``) at their input size; where the gt is
    smaller (the image resized on its longest side and padded), cropped to
    the resized extent and resized to the gt on the host; foreground where
    positive. Returns the evaluator's metrics keyed ``<name>/<metric>``."""
    dev = next(model.parameters()).device
    evaluator = GroundingEvaluator()
    for item in items:
        ids = torch.from_numpy(np.asarray(item["text_ids"])).to(dev)
        valid = torch.from_numpy(np.asarray(item["text_mask"]).astype(bool)).to(dev)
        token_emb, class_emb = model.encode_text_tokens(ids)
        image = _image(item, dev)
        gt = np.asarray(item["gt_mask"])
        for si in range(min(max(1, len(item.get("texts", ()))), token_emb.shape[0])):
            masks = model.evaluate_grounding(image, token_emb[si][None], valid[si][None],
                                             class_emb[None, si: si + 1])
            logits = masks[0, 0].float().cpu().numpy()
            if gt.shape != logits.shape:
                h0, w0 = gt.shape
                scale = logits.shape[0] / max(h0, w0)
                rh, rw = round(h0 * scale), round(w0 * scale)
                logits = resize_chw_np(logits[None, :rh, :rw], h0, w0)[0]
            evaluator.process(logits > 0, gt)
    return {f"{name}/{k}": v for k, v in evaluator.evaluate().items()}


@torch.no_grad()
def evaluate_captioning_items(model, items: Iterable[dict], name: str = "captioning",
                              steps: int = CAPTIONING_STEPS, cached: bool = True,
                              tokenizer=None) -> dict:
    """JAX's ``_evaluate_captioning`` over ``items``: ``image`` (H, W, 3)
    raw RGB and the reference ``captions`` (or one ``caption``). Greedy
    ids over ``steps`` steps, KV-cached (``evaluate_captioning_cached``) or,
    with ``cached=False``, re-running the decoder a token
    (``evaluate_captioning``), decoded without the special tokens. Returns
    BLEU-4 and CIDEr-D keyed ``<name>/<metric>``."""
    dev = next(model.parameters()).device
    tokenizer = tokenizer or build_tokenizer()
    decode = model.evaluate_captioning_cached if cached else model.evaluate_captioning
    evaluator = CaptioningEvaluator()
    for item in items:
        ids = decode(_image(item, dev), steps=steps)[0].cpu().numpy()
        text = tokenizer.batch_decode([ids], skip_special_tokens=True)[0]
        evaluator.process(text, list(item.get("captions") or [item.get("caption", "")]))
    return {f"{name}/{k}": v for k, v in evaluator.evaluate().items()}


@torch.no_grad()
def evaluate_retrieval_items(model, items: Iterable[dict], name: str = "retrieval") -> dict:
    """JAX's ``_evaluate_retrieval`` over ``items``: ``image`` (H, W, 3) raw
    RGB and its caption's ``caption_ids`` (T,). Item i's image embedding
    (with ``cfg.retrieval_ensemble`` also the backbone's) against every
    caption's unit embedding; caption i belongs to image i. Returns ir@k,
    tr@k (k 1, 5) and irtr keyed ``<name>/<metric>``."""
    dev = next(model.parameters()).device
    ensemble = model.cfg.retrieval_ensemble
    evaluator = RetrievalEvaluator(ks=(1, 5), ensemble=ensemble)
    for i, item in enumerate(items):
        image, v2 = _image(item, dev), None
        if ensemble:
            v, v2 = (x[0].cpu().numpy() for x in model.evaluate_retrieval_ensemble(image))
        else:
            v = model.evaluate_retrieval(image)[0].cpu().numpy()
        ids = torch.from_numpy(np.asarray(item["caption_ids"])[None]).to(dev)
        evaluator.process(v, i, model.encode_text_embeddings(ids).cpu().numpy(), [i],
                          image_emb2=v2)
    return {f"{name}/{k}": v for k, v in evaluator.evaluate().items()}


@torch.no_grad()
def evaluate_classification_items(model, text_emb: torch.Tensor, items: Iterable[dict],
                                  name: str = "classification") -> dict:
    """JAX's ``_evaluate_classification`` over ``items``: ``image`` (H, W, 3)
    raw RGB and its class ``label``; ``text_emb`` (K + 1, dim) the class
    embeddings (:func:`class_text_embeddings`), whose last (background) row
    is dropped. The image embedding's logits against the K classes on the
    host. Returns top-1 / top-5 keyed ``<name>/<metric>``."""
    dev = next(model.parameters()).device
    text = text_emb.float().cpu().numpy()
    text = text[:-1] if text.shape[0] > 1 else text
    evaluator = ClassificationEvaluator(ks=(1, 5))
    for item in items:
        v = model.evaluate_retrieval(_image(item, dev)).cpu().numpy()
        evaluator.process(v @ text.T, np.asarray([item["label"]]))
    return {f"{name}/{k}": v for k, v in evaluator.evaluate().items()}


def build_llm(cfg: dict, device="cuda", generator: torch.Generator | None = None):
    """The LLM of JAX's ``_evaluate_vqa`` and ``Trainer.train_llm`` from the
    config's keys, with their defaults: ``LLM`` {``VOCAB_SIZE`` 32000,
    ``DIM`` 4096, ``LAYERS`` 32, ``HEADS`` 32, ``KV_HEADS`` 32, ``FFN_DIM``
    11008}, ``LLM_MAX_LEN`` 1024 (the cache), ``DTYPE`` bfloat16,
    ``LLM_QUANT`` none (or int8). Its weights: the HF checkpoint at
    ``LLM_WEIGHTS`` (quantised after loading with int8), else drawn from
    ``generator`` (a generator of ``device``; by default one seeded 1), kept
    in ``DTYPE`` (the norms stay fp32; JAX keeps fp32). Every product casts
    a weight to ``DTYPE`` first, so the values are those of fp32 storage,
    in half the memory at bf16, and a train step's autograd saves the
    weights themselves, not a cast copy of each. On the card unless
    ``device='cpu'``."""
    from .models.llm.convert import load_hf_llama_params
    from .models.llm.llama import LlamaConfig, build_llama
    from .models.llm.quant import quantize_llama_state_dict

    llm, dtype = cfg.get("LLM", {}), cfg.get("DTYPE", "bfloat16")
    lcfg = LlamaConfig(vocab_size=llm.get("VOCAB_SIZE", 32000), dim=llm.get("DIM", 4096),
                       layers=llm.get("LAYERS", 32), heads=llm.get("HEADS", 32),
                       kv_heads=llm.get("KV_HEADS", 32), ffn_dim=llm.get("FFN_DIM", 11008),
                       max_seq_len=cfg.get("LLM_MAX_LEN", 1024),
                       dtype=dtype, param_dtype=dtype,
                       quant=cfg.get("LLM_QUANT", "none"))
    if not cfg.get("LLM_WEIGHTS"):
        if generator is None:
            generator = torch.Generator(device=torch.device(device)).manual_seed(1)
        return build_llama(lcfg, device, generator)
    sd = load_hf_llama_params(cfg["LLM_WEIGHTS"], lcfg)
    if lcfg.quant == "int8":
        sd = quantize_llama_state_dict(sd)
    model = build_llama(lcfg, device)
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def evaluate_vqa_items(model, llm, items: Iterable[dict], name: str = "vqa",
                       max_new_tokens: int = VQA_MAX_NEW_TOKENS,
                       num_beams: int = VQA_NUM_BEAMS, max_len: int = VQA_MAX_LEN,
                       tokenizer=None) -> dict:
    """JAX's ``_evaluate_vqa`` over ``items``: ``image`` (H, W, 3) raw RGB,
    its ``question`` and the human ``answers``. One item at a time through
    ``answer_questions`` (the splice at ``max_len``; beam search with
    ``num_beams > 1``) into the VQA evaluator. Returns the accuracy keyed
    ``<name>/<metric>``. As in JAX, the default ``max_len`` holds no more
    than 64 slots: a model with 100 image features needs a longer row, up
    to the LLM's ``max_seq_len``."""
    from .models.llm.vqa_pipeline import answer_questions

    dev = next(model.parameters()).device
    tokenizer = tokenizer or build_tokenizer()
    evaluator = VQAEvaluator()
    for item in items:
        answers = answer_questions(model, llm, tokenizer, _image(item, dev), [item["question"]],
                                   max_new_tokens=max_new_tokens, max_len=max_len,
                                   num_beams=num_beams)
        evaluator.process(answers[0], list(item["answers"]))
    return {f"{name}/{k}": v for k, v in evaluator.evaluate().items()}
