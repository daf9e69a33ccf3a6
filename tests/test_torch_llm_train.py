"""The port's stage-2 training against the JAX package's on the CPU:
``causal_lm_loss``, ``prepare_llm_batch``, the instruction stream and its
registry, the config loader, the checkpoint manager and the fuzzy weight
aligner, ``make_llm_train_step`` (two updates, fp and int8 LLM), and the
trainer: ``Trainer.train_llm`` and ``entry.main``.

Models: the X-Decoder tests' tiny SysLearner (``TINY``) with a 32-wide,
2-layer text tower over CLIP's 49408 ids and ``llm_dim`` 32, and a LLaMA of dim 32, 2
layers, 4 heads, FFN 64 over 64 ids with 64 positions; fp32, numpy weights
bridged (``bridged_params``, ``hf_state_dict``). ``tests/test_step2_e2e.py``'s
config cuts every conversation at 32 ids, before its answer, so its loss is
0 on both sides; the comparison with JAX's trainer keeps 64 ids (the answer
supervised) and 64 positions. Tolerance: the JAX suite's fp32 bar, atol =
rtol = 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import iuvl_tpu.config as jconfig
import iuvl_tpu.data.datasets as jdatasets
import iuvl_tpu.pipeline as jpipeline
import iuvl_tpu.runtime.checkpoint as jckpt
from iuvl_tpu.models.llm.convert import convert_llama
from iuvl_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from iuvl_tpu.models.llm.llama import LlamaForCausalLM as JLlama
from iuvl_tpu.models.llm.multimodal import causal_lm_loss as jcausal_lm_loss
from iuvl_tpu.models.llm.quant import quantize_llama_params
from iuvl_tpu.models.sam import build as jsb
from iuvl_tpu.models.xdecoder.model import SysLearner as JSysLearner
from iuvl_tpu.models.xdecoder.model import SysLearnerConfig as JConfig
from iuvl_tpu.train import llm_step as jllm_step
from iuvl_tpu.train.optimizer import build_optimizer
from iuvl_tpu.train.train_step import TrainState as JTrainState
from iuvl_tpu.train.trainer import Trainer as JTrainer
from iuvl_tpu_torch import config, entry
from iuvl_tpu_torch.data import datasets
from iuvl_tpu_torch.models.llm.llama import LlamaConfig, build_llama
from iuvl_tpu_torch.models.llm.multimodal import IGNORE_INDEX, IMAGE_TOKEN_INDEX, causal_lm_loss
from iuvl_tpu_torch.models.llm.quant import quantize_llama_state_dict
from iuvl_tpu_torch.models.sam import build as tsb
from iuvl_tpu_torch.models.xdecoder import convert
from iuvl_tpu_torch.models.xdecoder.model import SysLearner, SysLearnerConfig
from iuvl_tpu_torch.runtime import checkpoint
from iuvl_tpu_torch.train.llm_step import make_llm_train_step, prepare_llm_batch
from iuvl_tpu_torch.train.optimizer import Optimizer
from iuvl_tpu_torch.train.trainer import Trainer
from tests.test_torch_llm import hf_state_dict
from tests.test_torch_xdecoder import TINY, TINY_SAM, bridged_params

# CLIP's vocabulary for the text tower: the stream's question ids are HashWord
# ids up to 49406.
VISION = dict(TINY, text_width=32, text_layers=2, text_heads=4, vocab_size=49408, llm_dim=32)
LLM = dict(vocab_size=64, dim=32, layers=2, heads=4, kv_heads=4, ffn_dim=64, max_seq_len=64,
           dtype="float32")
FIX_PARAM = ["image_encoder", "pixel_decoder", "predictor", "lang_encoder", "prompt_encoder",
             "mask_decoder"]
N_IMG = TINY["mask_proposals"]  # image slots a row: num_queries - 1
# The trainer comparison's solver, which the step test's optimizers copy.
SOLVER = {"BASE_LR": 0.01, "MAX_NUM_EPOCHS": 1, "WARMUP_ITERS": 1, "WEIGHT_DECAY": 0.05}
STEPS = 3
TOL = dict(atol=1e-4, rtol=1e-4)
STEP2_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "step2_instruction.yaml")


def _close(port, ref, name=""):
    np.testing.assert_allclose(np.asarray(port.detach().float()), np.asarray(ref, np.float32),
                               err_msg=name, **TOL)


def e2e_cfg(save_dir) -> dict:
    """``tests/test_step2_e2e.py``'s config."""
    return {
        "SAM_SIZE": "tiny_test", "IMAGE_SIZE": 64, "SYSLEARNER_DIM": 32,
        "MASK_PROPOSAL": 10, "DTYPE": "float32", "CONTEXT_LEN": 7,
        "TEXT_WIDTH": 32, "TEXT_LAYERS": 2, "TEXT_HEADS": 4,
        "PIXEL_DECODER_LAYERS": 2, "NHEADS": 4, "DIM_FEEDFORWARD": 64,
        "Load_LLM": True, "LLM_DIM": 32, "LLM_MAX_LEN": 48,
        "LLM": {"VOCAB_SIZE": 64, "DIM": 32, "LAYERS": 2, "HEADS": 4,
                "KV_HEADS": 4, "FFN_DIM": 64},
        "DATASETS": {"TRAIN": ["synthetic_instruction"]},
        "SYNTHETIC_INSTRUCTION": {
            "IMAGE_SIZE": 64, "LENGTH": 6, "MAX_LEN": 32,
            "VOCAB_SIZE": 64, "CONTEXT_LEN": 7,
        },
        "BATCH_SIZE": 1, "STEPS_PER_EPOCH": 3, "LOG_EVERY": 1,
        "FIX_PARAM": list(FIX_PARAM),
        "SOLVER": {"BASE_LR": 0.01, "MAX_NUM_EPOCHS": 1, "WARMUP_ITERS": 0},
        "SAVE_DIR": str(save_dir),
    }


@pytest.fixture(scope="module")
def tiny():
    """The SysLearner's numpy weights and config, and both LLMs on one set
    of weights (fp and int8, each quantised by its own package)."""
    jsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    cfg = SysLearnerConfig(**VISION)
    sd = hf_state_dict(LlamaConfig(**LLM), seed=5)
    llms = {}
    for quant in ("none", "int8"):
        jp = convert_llama(sd, LLM["layers"])
        tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
        if quant == "int8":
            jp, tsd = quantize_llama_params(jp), quantize_llama_state_dict(tsd)
        tm = build_llama(LlamaConfig(**LLM, quant=quant), "cpu")
        tm.load_state_dict(tsd, strict=True)
        llms[quant] = (JLlama(cfg=JLlamaConfig(**LLM, quant=quant)), jp, tm)
    return dict(cfg=cfg, params=bridged_params(cfg), llms=llms, hf=sd)


# -- the loss -----------------------------------------------------------------
def _labels(rs, b, t, v):
    labels = rs.randint(0, v, (b, t))
    labels[rs.rand(b, t) < 0.4] = IGNORE_INDEX
    return labels


@pytest.mark.parametrize("case", ["ignored_rows", "all_ignored", "out_of_range"])
def test_causal_lm_loss_matches_jax(case):
    rs = np.random.RandomState(7)
    b, t, v = 2, 9, 13
    logits = (3 * rs.randn(b, t, v)).astype(np.float32)
    labels = _labels(rs, b, t, v)
    if case == "all_ignored":
        labels[:] = IGNORE_INDEX
    if case == "out_of_range":
        labels[0, 3], labels[1, 5], labels[1, 6] = v + 2, -3, -v - 1
    jl, jg = jax.value_and_grad(lambda x: jcausal_lm_loss(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss = causal_lm_loss(x, torch.from_numpy(labels))
    if case == "out_of_range":
        # a negative id counts from the end; one outside the vocabulary is NaN
        assert np.isnan(float(jl)) and np.isnan(float(loss.detach()))
        ok = labels.copy()
        ok[0, 3], ok[1, 6] = IGNORE_INDEX, IGNORE_INDEX
        wrapped = ok.copy()
        wrapped[1, 5] = v - 3
        np.testing.assert_allclose(
            float(causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(ok))),
            float(causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(wrapped))),
            rtol=1e-6)
        return
    loss.backward()
    _close(loss, jl, "loss")
    _close(x.grad, jg, "grad")
    if case == "all_ignored":
        assert float(loss.detach()) == 0.0 and not x.grad.abs().any()


def test_text_tower_takes_out_of_range_ids_as_jax():
    """The question ids of the stream are HashWord ids up to 49406: over a
    smaller text vocabulary they fall outside the table, where JAX's
    ``jnp.take`` gives rows of NaN (and a negative id counts from the end).
    The port's tower gives the same rows, in ``forward`` and the cached
    ``decode_step``."""
    jsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    small = dict(VISION, vocab_size=64)
    cfg = SysLearnerConfig(**small)
    params = bridged_params(cfg)
    tm = SysLearner(cfg)
    tm.load_state_dict(convert.flax_to_state_dict(params, cfg), strict=True)
    jm = JSysLearner(cfg=JConfig(**small))
    ids = np.asarray([[49406, 5, 63, 64, -2, 49407, 0], [3, 7, 11, 2, 9, 1, 4]], np.int32)
    mask = np.ones_like(ids)
    ref = jax.jit(lambda p, i, m: jm.apply(p, i, m, method=JSysLearner.encode_text_tokens))(
        params, ids, mask)
    with torch.no_grad():
        got = tm.encode_text_tokens(torch.from_numpy(ids), torch.from_numpy(mask))
        tower = tm.lang_encoder.lang_encoder
        caches = tower.init_cache(2)
        rows = [tower.decode_step(torch.from_numpy(ids[:, t]), t, caches)[0]
                for t in range(ids.shape[1])]
        full = tower(torch.from_numpy(ids))
    for g, r, name in zip(got, ref, ("tokens", "class embedding")):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(r)), err_msg=name)
        _close(torch.nan_to_num(g, nan=0.0), np.nan_to_num(np.asarray(r)), name)
    assert np.isnan(got[0][0].numpy()).all() and not np.isnan(got[0][1].numpy()).any()
    np.testing.assert_array_equal(np.isnan(torch.cat(rows, 1).numpy()), np.isnan(full.numpy()))


# -- the batch ----------------------------------------------------------------
@pytest.mark.parametrize("where", ["start", "middle", "truncated"])
def test_prepare_llm_batch_matches_jax(tiny, where):
    jm, jp, tm = tiny["llms"]["none"]
    rs = np.random.RandomState(11)
    max_len = 24
    rows, labs = [], []
    for n_pre, n_post in ((0, 5), (3, 9)) if where != "truncated" else ((6, 20), (2, 40)):
        if where == "middle":
            n_pre += 4
        ids = list(rs.randint(1, 64, n_pre)) + [IMAGE_TOKEN_INDEX] + list(
            rs.randint(1, 64, n_post))
        lab = [IGNORE_INDEX] * (n_pre + 1) + list(rs.randint(0, 64, n_post))
        rows.append(np.asarray(ids, np.int32))
        labs.append(np.asarray(lab, np.int32))
    ref = jllm_step.prepare_llm_batch(None, jm, jp, rows, labs, num_image_tokens=N_IMG,
                                      max_len=max_len)
    got = prepare_llm_batch(tm, rows, labs, num_image_tokens=N_IMG, max_len=max_len)
    _close(got[0], ref[0], "base_embeds")
    for name, g, r in zip(("img_start", "attention_mask", "labels"), got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


# -- the stream ---------------------------------------------------------------
@pytest.mark.parametrize("name,vocab", [("synthetic_instruction", None),
                                        ("synthetic_instruction", 64),
                                        ("instruction_train", 100)])
def test_instruction_dataset_matches_jax(name, vocab):
    cfg = {"IMAGE_SIZE": 32, "LENGTH": 3, "CONTEXT_LEN": 7}
    if vocab:
        cfg["VOCAB_SIZE"] = vocab
    ref = jdatasets.build_dataset(name, cfg, "train")
    got = datasets.build_dataset(name, cfg, "train")
    assert type(got).__name__ == type(ref).__name__ and len(got) == len(ref) == 3
    for i in range(len(ref)):
        r, g = ref[i], got[i]
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            assert g[k].dtype == r[k].dtype, k
        assert (g["input_ids"] == IMAGE_TOKEN_INDEX).sum() == 1
        assert (g["labels"] != IGNORE_INDEX).sum() > 0
    with pytest.raises(KeyError):
        datasets.build_dataset("coco_2017_train_panoptic", {}, "train")


# -- the config ---------------------------------------------------------------
def test_load_config_matches_jax(tmp_path):
    extra = tmp_path / "extra.yaml"
    extra.write_text("SOLVER:\n  BASE_LR: 0.001\n  NEW: {A: 1}\nLLM:\n  VOCAB_SIZE: 32000\n")
    overrides = ["BATCH_SIZE", "2", "STEPS_PER_EPOCH", "3", "LLM.VOCAB_SIZE", "49408",
                 "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.5", "Load_LLM", "false",
                 "FIX_PARAM", "['image_encoder']", "SOLVER.WARMUP_ITERS", "7",
                 "SAVE_DIR", "/tmp/x", "RESUME_FROM", "null", "NEW.KEY", "3"]
    files = [STEP2_YAML, str(extra)]
    got = config.load_config(files, overrides)
    assert got == jconfig.load_config(files, overrides)
    assert got["LLM"]["VOCAB_SIZE"] == 49408 and got["Load_LLM"] is False
    assert got["SOLVER"]["BASE_LR"] == 0.001 and got["NEW"]["KEY"] == 3
    argv = ["train", "--conf_files", *files, "--overrides", *overrides]
    cfg, args = config.load_opt_command(argv)
    jcfg, jargs = jconfig.load_opt_command(argv)
    assert cfg == jcfg and args.command == jargs.command == "train"
    with pytest.raises(ValueError):
        config.load_config(files, ["BATCH_SIZE"])


# -- checkpoints --------------------------------------------------------------
def test_align_and_update_params_matches_jax():
    rs = np.random.RandomState(3)

    def t(*shape):
        return rs.randn(*shape).astype(np.float32)

    template = {"image_encoder.block0.attn.qkv.weight": t(6, 2),
                "image_encoder.block0.attn.qkv.bias": t(6),
                "image_encoder.block1.attn.qkv.weight": t(6, 2),
                "predictor.layers.0.norm.weight": t(4),
                "predictor.layers.1.norm.weight": t(4),
                "img_to_lang.weight": t(3, 4),
                "img_to_lang.bias": t(3)}
    loaded = {"backbone.block0.attn.qkv.weight": t(6, 2),      # remapped (suffix 4)
              "image_encoder.block0.attn.qkv.bias": t(6),      # exact
              "image_encoder.block1.attn.qkv.weight": t(2, 6),  # exact key, wrong shape
              "other.block1.attn.qkv.weight": t(6, 2),         # remapped instead
              "layers.0.norm.weight": t(4),                    # two of suffix 3: the first
              "x.layers.0.norm.weight": t(4),
              "img_to_lang.weight": t(4, 3)}                    # shape differs: kept
    tsd = {k: torch.from_numpy(v) for k, v in template.items()}
    lsd = {k: torch.from_numpy(v) for k, v in loaded.items()}

    def nest(flat):
        out: dict = {}
        for k, v in flat.items():
            node = out
            *head, last = k.split(".")
            for p in head:
                node = node.setdefault(p, {})
            node[last] = v
        return out

    def flat_of(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    jmerged, jlog = jckpt.align_and_update_params(nest(template), nest(loaded))
    # JAX walks both trees in its flattening order: hand the port that order.
    order = [k.replace("/", ".") for k in flat_of(nest(template))]
    lorder = [k.replace("/", ".") for k in flat_of(nest(loaded))]
    merged, log = checkpoint.align_and_update_params({k: tsd[k] for k in order},
                                                     {k: lsd[k] for k in lorder})
    assert log == [line.replace("/", ".") for line in jlog]
    assert list(merged) == order
    for k, v in flat_of(jmerged).items():
        np.testing.assert_array_equal(merged[k.replace("/", ".")].numpy(), np.asarray(v),
                                      err_msg=k)
    assert any(line.startswith("remap") for line in log)
    assert any(line.startswith("missing") for line in log)


def test_checkpoint_manager_and_run_dirs(tmp_path):
    root = str(tmp_path / "runs")
    assert checkpoint.latest_run_dir(root) is None and jckpt.latest_run_dir(root) is None
    first = checkpoint.next_run_dir(root)
    assert first == os.path.join(root, "run_1")
    os.makedirs(os.path.join(root, "run_7"))
    os.makedirs(os.path.join(root, "run_x"))
    assert checkpoint.latest_run_dir(root) == jckpt.latest_run_dir(root) \
        == os.path.join(root, "run_7")
    assert checkpoint.next_run_dir(root) == os.path.join(root, "run_8")
    assert jckpt.next_run_dir(root) == os.path.join(root, "run_9")

    mgr = checkpoint.CheckpointManager(os.path.join(first, "ckpt"), max_to_keep=2)
    assert mgr.latest_step is None and mgr.restore() is None
    model = torch.nn.Linear(3, 2)
    opt = Optimizer(model.named_parameters(), base_lr=0.1, total_steps=4, warmup_iters=0)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    for step in (1, 2, 3):
        state = {"step": step, "params": {k: v + step for k, v in model.state_dict().items()},
                 "opt_state": opt.state_dict()}
        assert mgr.save(step, state)
    assert not mgr.save(3, state)  # an older or equal step is skipped, as Orbax skips it
    assert mgr.all_steps() == [2, 3] and mgr.latest_step == 3
    back = mgr.restore()
    assert back["step"] == 3
    for k, v in model.state_dict().items():
        assert torch.equal(back["params"][k], v + 3)
    assert torch.equal(mgr.restore(2)["params"]["bias"], model.bias.detach() + 2)
    opt2 = Optimizer(model.named_parameters(), base_lr=0.1, total_steps=4, warmup_iters=0)
    opt2.load_state_dict(back["opt_state"])
    assert opt2.count == 1
    for a, b in zip(opt.adamw.state.values(), opt2.adamw.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])


# -- the step -----------------------------------------------------------------
def _instruction_batch(b: int, seed: int = 0):
    ds = datasets.build_dataset("synthetic_instruction",
                                {"IMAGE_SIZE": 64, "LENGTH": b, "MAX_LEN": 64, "VOCAB_SIZE": 64,
                                 "CONTEXT_LEN": 7}, "train")
    items = [ds[i] for i in range(b)]
    rs = np.random.RandomState(seed)
    images = np.stack([it["image"] for it in items])
    ctx = rs.randn(b, TINY["contxt_len"], TINY["syslearner_dim"]).astype(np.float32)
    return images, ctx, [it["input_ids"] for it in items], [it["labels"] for it in items]


def _recording(tx, into: list):
    """``tx`` that first hands the projector's raw gradient to the host."""
    def update(grads, state, params=None):
        g = grads["params"]["img_to_lang"]
        jax.debug.callback(lambda w, b: into.append((np.asarray(w), np.asarray(b))),
                           g["kernel"], g["bias"])
        return tx.update(grads, state, params)

    return optax.GradientTransformation(tx.init, update)


@pytest.fixture(scope="module")
def jax_steps(tiny):
    """``jax_steps(quant)``: JAX's ``make_llm_train_step`` on ``tiny``'s
    models with the optimizer that ``train_llm`` builds from ``SOLVER``
    (the file's trainer comparison), jitted once a quant and fed host
    arrays (a committed device array keys another compile): (step, the
    recorded projector gradients, the optimizer)."""
    made: dict = {}

    def get(quant: str):
        if quant not in made:
            jllm = tiny["llms"][quant][0]
            jm = JSysLearner(cfg=JConfig(**VISION, attn_impl="auto", msdeform_impl="auto"))
            grads: list = []
            tx = _recording(build_optimizer(
                tiny["params"], base_lr=SOLVER["BASE_LR"], weight_decay=SOLVER["WEIGHT_DECAY"],
                total_steps=STEPS, clip_norm=1.0, warmup_iters=SOLVER["WARMUP_ITERS"],
                frozen_substrings=tuple(FIX_PARAM)), grads)
            jitted = jllm_step.make_llm_train_step(jm, jllm, tx, donate=False)

            def step(state, *args):
                return jitted(*jax.device_get((state, *args)))

            made[quant] = (step, grads, tx)
        return made[quant]

    return get


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_llm_train_step_matches_jax(tiny, jax_steps, quant):
    """Two updates of both steps from the same weights on one batch of two
    instruction items. The weight decay (0.05, ``build_optimizer``'s
    default) reaches the parameters outside FIX_PARAM that the loss does not
    reach."""
    cfg, params = tiny["cfg"], tiny["params"]
    jllm, jllm_params, tllm = tiny["llms"][quant]
    jstep, jgrads, tx = jax_steps(quant)
    jgrads.clear()
    tm = SysLearner(cfg)
    tm.load_state_dict(convert.flax_to_state_dict(params, cfg), strict=True)
    opt = Optimizer(tm.named_parameters(), paths=convert.flax_paths(cfg),
                    base_lr=SOLVER["BASE_LR"], weight_decay=SOLVER["WEIGHT_DECAY"],
                    total_steps=STEPS, clip_norm=1.0, warmup_iters=SOLVER["WARMUP_ITERS"],
                    frozen_substrings=FIX_PARAM)
    tgrads: list = []
    inner = opt.step

    def recording_step():
        tgrads.append({n: p.grad.clone() for n, p in tm.named_parameters()
                       if n.startswith("img_to_lang")})
        return inner()

    opt.step = recording_step
    step = make_llm_train_step(tm, tllm, opt)
    llm_before = {k: v.clone() for k, v in tllm.state_dict().items()}

    images, ctx, ids, labels = _instruction_batch(2)
    jbatch = jllm_step.prepare_llm_batch(None, jllm, jllm_params, ids, labels,
                                         num_image_tokens=N_IMG, max_len=LLM["max_seq_len"])
    tbatch = prepare_llm_batch(tllm, ids, labels, num_image_tokens=N_IMG,
                               max_len=LLM["max_seq_len"])
    state = JTrainState.create(params, tx)
    for i in range(2):
        state, jmetrics = jstep(state, jllm_params, images, ctx, *jbatch)
        metrics = step(torch.from_numpy(images), torch.from_numpy(ctx), *tbatch)
        assert sorted(metrics) == sorted(jmetrics)
        assert float(metrics["loss_llm"]) > 0
        _close(metrics["loss_llm"], jmetrics["loss_llm"], f"step {i}: loss_llm")
        _close(tgrads[i]["img_to_lang.weight"].t(), jgrads[i][0], f"step {i}: grad kernel")
        _close(tgrads[i]["img_to_lang.bias"], jgrads[i][1], f"step {i}: grad bias")
        want = convert.flax_to_state_dict(jax.device_get(state.params), cfg)
        got = tm.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            _close(got[k], v, f"step {i}: {k}")
    assert not torch.equal(tm.img_to_lang.weight,
                           torch.from_numpy(np.asarray(params["params"]["img_to_lang"]
                                                       ["kernel"])).t())
    for k, v in tllm.state_dict().items():
        assert torch.equal(v, llm_before[k]), k
    assert all(p.grad is None and not p.requires_grad for p in tllm.parameters())


# -- the trainer --------------------------------------------------------------
def _losses(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_runs_step2_e2e_config(tmp_path):
    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    trainer = Trainer(e2e_cfg(tmp_path), "cpu")
    out = trainer.train()
    assert out["final_step"] == 3
    assert "loss_llm" in out and np.isfinite(out["loss_llm"]), out
    records = _losses(trainer.run_dir)
    assert [r["step"] for r in records] == [1, 2, 3, 3]
    assert trainer.ckpt.latest_step == 3
    saved = trainer.ckpt.restore()
    assert saved["step"] == 3 and "img_to_lang.weight" in saved["params"]
    assert saved["opt_state"]["count"] == 3
    with pytest.raises(NotImplementedError):
        Trainer(dict(e2e_cfg(tmp_path), Load_LLM=False), "cpu").train()
    with pytest.raises(NotImplementedError):
        Trainer(dict(e2e_cfg(tmp_path), MODEL_PARALLEL=2), "cpu")


def test_trainer_matches_jax_trainer(tiny, jax_steps, tmp_path, monkeypatch):
    """Both trainers from the same weights at batch 2 (the step test's
    program serves JAX's trainer): the SysLearner through WEIGHT +
    RESUME_FROM of a port checkpoint for the port (JAX's
    ``initialize_model`` made to return the same weights), the LLM through
    LLM_WEIGHTS safetensors for both. The per-step running averages in
    ``metrics.jsonl`` and the results agree; the port's final checkpoint
    holds JAX's final parameters."""
    from safetensors.numpy import save_file

    from iuvl_tpu_torch.pipeline import model_config

    params = tiny["params"]
    llm_dir = tmp_path / "llm"
    llm_dir.mkdir()
    save_file(tiny["hf"], str(llm_dir / "model.safetensors"))
    base = e2e_cfg(tmp_path / "unused")
    base.update(LLM_MAX_LEN=LLM["max_seq_len"],
                BATCH_SIZE=2, STEPS_PER_EPOCH=STEPS, SOLVER=dict(SOLVER),
                LLM_WEIGHTS=str(llm_dir))
    base["SYNTHETIC_INSTRUCTION"] = dict(base["SYNTHETIC_INSTRUCTION"], MAX_LEN=64)
    assert model_config(base) == tiny["cfg"]

    init_dir = tmp_path / "init"
    checkpoint.CheckpointManager(str(init_dir)).save(
        0, {"params": convert.flax_to_state_dict(params, tiny["cfg"])})
    port = Trainer(dict(base, SAVE_DIR=str(tmp_path / "port"), WEIGHT=True,
                        RESUME_FROM=str(init_dir)), "cpu")
    got = port.train()

    def initialize_model(self, rng=None):
        self.model = JSysLearner(cfg=self.model_config())
        return self.model, params

    jstep = jax_steps("none")[0]  # built before JAX's builder is patched to return it
    monkeypatch.setattr(jpipeline.XDecoderPipeline, "initialize_model", initialize_model)
    monkeypatch.setattr(jllm_step, "make_llm_train_step", lambda *a, **k: jstep)
    jtrainer = JTrainer(dict(base, SAVE_DIR=str(tmp_path / "jax")))
    want = jtrainer.train()
    assert got["final_step"] == want["final_step"] == STEPS
    for k in ("loss_llm", "loss_total"):
        np.testing.assert_allclose(got[k], want[k], **TOL)
    g, w = _losses(port.run_dir), _losses(jtrainer.run_dir)
    assert [r["step"] for r in g] == [r["step"] for r in w] == [1, 2, 3, 3]
    np.testing.assert_allclose([r["loss_llm"] for r in g], [r["loss_llm"] for r in w], **TOL)
    assert all(r["loss_llm"] > 0 for r in g)
    final = port.ckpt.restore()["params"]
    jfinal = convert.flax_to_state_dict(jtrainer.ckpt.restore()["params"], tiny["cfg"])
    for k, v in jfinal.items():
        _close(final[k], v, k)


def test_trainer_and_entry_default_to_the_card(tmp_path, monkeypatch):
    """Without a card the trainer, ``initialize_model`` and the entry raise
    unless asked for the CPU."""
    import yaml

    from iuvl_tpu_torch.pipeline import initialize_model

    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = e2e_cfg(tmp_path / "runs")
    for build in (lambda: Trainer(cfg), lambda: initialize_model(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build()
    path = tmp_path / "step2_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.main(["train", "--conf_files", str(path)])
    assert {p.device.type for p in initialize_model(cfg, "cpu").parameters()} == {"cpu"}


def test_entry_main_trains(tmp_path, capsys):
    import yaml

    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    path = tmp_path / "step2_tiny.yaml"
    path.write_text(yaml.safe_dump(e2e_cfg(tmp_path / "runs")))
    assert entry.main(["train", "--conf_files", str(path), "--overrides", "DEVICE", "cpu",
                       "STEPS_PER_EPOCH", "3"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["final_step"] == 3 and np.isfinite(out["loss_llm"])
    for command in ("evaluate", "bench"):
        with pytest.raises(NotImplementedError):
            entry.main([command, "--conf_files", str(path)])
