"""The trainer, port of the stage-2 part of ``iuvl_tpu/train/trainer.py``:
``Trainer.__init__`` (the run directory and its checkpoint manager),
``_load_pretrained`` (``WEIGHT`` + ``RESUME_FROM`` through the fuzzy
aligner), ``train`` and ``train_llm``, stage-2 instruction tuning: the
instruction stream through :func:`prepare_llm_batch` and
:func:`make_llm_train_step` with the LLM frozen and the SysLearner's
``FIX_PARAM`` parameters frozen by the optimizer.

The seg / joint ``train`` (no ``Load_LLM``), ``eval`` and tensor
parallelism (``MODEL_PARALLEL > 1``) are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import logging
import os
from typing import Any

import numpy as np
import torch

from ..data.datasets import build_dataset
from ..models.sam.build import target_device
from ..models.xdecoder.convert import flax_paths
from ..pipeline import build_llm, initialize_model
from ..runtime.checkpoint import (CheckpointManager, align_and_update_params, latest_run_dir,
                                  next_run_dir)
from ..runtime.metrics import LossMeter, format_metrics
from ..runtime.observability import MetricsLogger
from .llm_step import make_llm_train_step, prepare_llm_batch
from .optimizer import Optimizer

logger = logging.getLogger("iuvl_tpu_torch")


def llm_optimizer(model, cfg: dict) -> Optimizer:
    """The optimizer of ``Trainer.train_llm`` over ``model`` from ``cfg``'s
    ``SOLVER`` with JAX's defaults here (weight decay 0.0, not
    ``build_optimizer``'s 0.05), its ``FIX_PARAM`` frozen. As in JAX, no
    milestones, gamma or LR multipliers are passed, so the schedule keeps
    their defaults whatever ``SOLVER`` says."""
    solver = cfg.get("SOLVER", {})
    return Optimizer(
        model.named_parameters(), paths=flax_paths(model.cfg),
        base_lr=solver.get("BASE_LR", 2e-4),
        weight_decay=solver.get("WEIGHT_DECAY", 0.0),
        total_steps=cfg.get("STEPS_PER_EPOCH", 100) * solver.get("MAX_NUM_EPOCHS", 1),
        clip_norm=solver.get("CLIP_GRADIENTS", {}).get("CLIP_VALUE", 1.0),
        warmup_iters=solver.get("WARMUP_ITERS", 10),
        frozen_substrings=tuple(cfg.get("FIX_PARAM", ())),
    )


class Trainer:
    """``cfg``: the config dict (``config.load_config``). Builds on
    ``device``, the card unless ``device='cpu'``."""

    def __init__(self, cfg: dict, device="cuda"):
        self.cfg = cfg
        self.device = target_device(device, "Trainer")
        if cfg.get("MODEL_PARALLEL", 1) > 1:
            raise NotImplementedError(
                "Trainer: MODEL_PARALLEL > 1 (tensor parallelism) is not ported yet "
                "(ROADMAP A6)")
        save_root = cfg.get("SAVE_DIR", "./runs")
        # RESUME continues the latest existing run.
        self.run_dir = (latest_run_dir(save_root) if cfg.get("RESUME") else None) \
            or next_run_dir(save_root)
        self.ckpt = CheckpointManager(os.path.join(self.run_dir, "ckpt"))

    def _load_pretrained(self, model) -> None:
        """With ``WEIGHT`` and ``RESUME_FROM``: the newest checkpoint under
        ``RESUME_FROM`` (its ``params``, or the whole file as a state dict)
        into ``model`` through :func:`align_and_update_params`."""
        cfg = self.cfg
        if not (cfg.get("WEIGHT") and cfg.get("RESUME_FROM")):
            return
        restored = CheckpointManager(cfg["RESUME_FROM"]).restore()
        if restored is None:
            logger.warning("WEIGHT load: nothing restorable at %s", cfg["RESUME_FROM"])
            return
        loaded = restored.get("params", restored)
        merged, log = align_and_update_params(model.state_dict(), loaded)
        model.load_state_dict(merged)
        for line in log[:20]:
            logger.info("weight align: %s", line)
        logger.info("weight align: %d log lines total", len(log))

    def train(self) -> dict[str, Any]:
        if self.cfg.get("Load_LLM"):
            return self.train_llm()
        raise NotImplementedError(
            "Trainer.train: only stage 2 (Load_LLM) is ported; the seg / joint trainer is "
            "ROADMAP A6")

    def train_llm(self) -> dict[str, Any]:
        """Stage-2 instruction tuning: the first ``DATASETS.TRAIN`` stream
        (``synthetic_instruction`` by default), shuffled each epoch by a
        ``RandomState(SEED)``, in batches of ``BATCH_SIZE`` (the remainder
        dropped), for ``STEPS_PER_EPOCH * MAX_NUM_EPOCHS`` steps. A
        checkpoint every quarter epoch and at the end; the loss averages
        logged every ``LOG_EVERY`` steps and at the end. Returns
        ``{'final_step', **averages}``."""
        cfg = self.cfg
        dev = self.device
        model = initialize_model(cfg, dev)
        self._load_pretrained(model)
        steps_per_epoch = cfg.get("STEPS_PER_EPOCH", 100)
        epochs = cfg.get("SOLVER", {}).get("MAX_NUM_EPOCHS", 1)
        optimizer = llm_optimizer(model, cfg)
        llm = build_llm(cfg, dev)

        train_name = (cfg.get("DATASETS", {}).get("TRAIN") or ["synthetic_instruction"])[0]
        ds = build_dataset(train_name, cfg.get(train_name.upper(), {}), "train")
        batch_size = cfg.get("BATCH_SIZE", 2)
        max_len = cfg.get("LLM_MAX_LEN", 1024)
        num_img_tokens = model.cfg.num_queries - 1

        step_fn = make_llm_train_step(model, llm, optimizer)
        mlog = MetricsLogger(self.run_dir)
        meters = LossMeter()
        log_every = cfg.get("LOG_EVERY", 10)
        eval_every = max(steps_per_epoch // 4, 1)
        total_steps = epochs * steps_per_epoch
        step = optimizer.count
        order = np.arange(len(ds))
        if batch_size > len(ds):
            raise ValueError(f"BATCH_SIZE {batch_size} > instruction dataset length {len(ds)}: "
                             "the epoch loop would yield no batches")
        rs = np.random.RandomState(cfg.get("SEED", 0))
        while step < total_steps:
            rs.shuffle(order)
            for start in range(0, len(order) - batch_size + 1, batch_size):
                if step >= total_steps:
                    break
                items = [ds[int(i)] for i in order[start: start + batch_size]]
                base_embeds, img_start, attn, labels = prepare_llm_batch(
                    llm, [it["input_ids"] for it in items], [it["labels"] for it in items],
                    num_image_tokens=num_img_tokens, max_len=max_len)
                images = torch.from_numpy(np.stack([it["image"] for it in items])).to(dev)
                if "clip_ids" in items[0]:
                    ids = torch.from_numpy(np.stack([it["clip_ids"] for it in items])).to(dev)
                    mask = torch.from_numpy(np.stack([it["clip_mask"] for it in items])).to(dev)
                    with torch.no_grad():
                        ctx, _ = model.encode_text_tokens(ids, mask)
                else:
                    ctx = torch.zeros((batch_size, model.cfg.contxt_len,
                                       model.cfg.syslearner_dim), device=dev)
                metrics = step_fn(images, ctx, base_embeds, img_start, attn, labels)
                step += 1
                meters.update({k: float(v) for k, v in metrics.items()})
                if step % log_every == 0:
                    logger.info("step %d  %s", step, format_metrics(meters.averages()))
                    mlog.log(step, meters.averages())
                if step % eval_every == 0:
                    self.ckpt.save(step, self._state(step, model, optimizer))
        final = meters.averages()
        self.ckpt.save(step, self._state(step, model, optimizer))
        mlog.log(step, final)
        return {"final_step": step, **final}

    @staticmethod
    def _state(step: int, model, optimizer: Optimizer) -> dict:
        return {"step": step, "params": model.state_dict(),
                "opt_state": optimizer.state_dict()}
