"""Command line of the port: ``train`` with stacked YAML configs and dotted
overrides, as the JAX package's ``entry.py`` takes them.

Usage:
    python -m iuvl_tpu_torch.entry train --conf_files configs/step2_instruction.yaml \\
        --overrides BATCH_SIZE 2 LLM.VOCAB_SIZE 49408

Only stage 2 (``Load_LLM``) trains through the port; the seg / joint
trainer and ``evaluate`` are ROADMAP A6, and ``bench`` waits for the
port's benchmark. Runs on the card (``DEVICE: cpu`` in the config for the
CPU).
"""

from __future__ import annotations

import json
import logging
import sys

from .config import load_opt_command


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg, args = load_opt_command(argv)
    if args.command == "bench":
        raise NotImplementedError("entry bench: the port's benchmark is not written yet")
    if args.command != "train":
        raise NotImplementedError(f"entry {args.command}: the port's evaluation is "
                                  "ROADMAP A6")
    from .train.trainer import Trainer

    result = Trainer(cfg, cfg.get("DEVICE", "cuda")).train()
    print(json.dumps({k: float(v) if hasattr(v, "__float__") else v
                      for k, v in result.items()}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
