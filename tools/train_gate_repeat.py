"""Is a train-gate reading a property of the code or of the run? Runs
chip_smoke.py's batch-1 train phase (one step, with the control pair) of
the tree this script is started from, ``repeats`` times in one process,
printing each run's gate readings and whether the gates held (a failed
gate is reported, not raised).

    python3 tools/train_gate_repeat.py [repeats]

Run it from the root of two trees in one call (a commit and its parent,
unpacked with ``git archive``): equal readings on one tree's repeats mean
the step is deterministic, so a difference between the trees is the
code's. Needs one CUDA card.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cs.device_phase()
    from iuvl_tpu_torch.ops.cuda import build

    build.library()
    dev = torch.device("cuda", 0)
    for run in range(int(sys.argv[1]) if len(sys.argv) > 1 else 2):
        t0 = time.perf_counter()
        try:
            cs.train_phase(dev, 1, 1, True)
            print(f"repeat {run}: the gates held", flush=True)
        except RuntimeError as e:
            print(f"repeat {run}: {e}", flush=True)
        print(f"repeat {run}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
