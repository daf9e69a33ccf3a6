"""Where a served image's encode time goes on the card: SAM ViT-B (bf16,
chip_smoke.py's serving weights) encoding one 1024^2 image through the
fused encoder (``attn_impl='auto'``: B1 in the 8 windowed blocks, B2 in
the 4 global ones, B3 in all 12) and, for comparison, through ``'window'``
(B13 in every block, plain projections and tails).

    python3 tools/encode_profile.py

Per route, after two warm-up encodes: the host time of one encode (the
card synchronised, mean of 3), then ``torch.profiler`` over 3 encodes: the
host span, the device time (one stream: the kernels' sum), its share of
the span, and the 12 kernels with the most device time, a call's ms and
count an encode. Needs one CUDA card.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.models.sam import build_sam, sam_model_registry  # noqa: E402
from tools.eval_profile import device_us, kernels_of  # noqa: E402

CALLS = 3


def main() -> None:
    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    base = sam_model_registry["vit_b"](dtype="bfloat16", device=dev,
                                       generator=torch.Generator().manual_seed(cs.SEED)).eval()
    rs = np.random.RandomState(cs.SEED + 1)
    image = torch.from_numpy(rs.rand(1, 1024, 1024, 3).astype(np.float32) * 255).to(dev)
    for impl in ("auto", "window"):
        m = build_sam("vit_b", dtype="bfloat16", attn_impl=impl, device=dev).eval()
        m.load_state_dict(base.state_dict())
        with torch.no_grad():
            x = m.normalize(image)
            encode = lambda: m.encode_image(x, return_fpn=False)  # noqa: E731
            for _ in range(2):
                encode()
            host = np.mean([cs.synced(encode)[1] for _ in range(CALLS)])
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                _, span = cs.synced(lambda: [encode() for _ in range(CALLS)])
        avgs = kernels_of(prof)
        busy = sum(device_us(a) for a in avgs) / 1e3
        cs.log(f"encode {impl}: {host * 1e3:.2f} ms an encode (host, synchronised); under the "
               f"profiler {CALLS} encodes, host span {span * 1e3:.1f} ms, device time "
               f"{busy:.2f} ms ({busy / CALLS:.2f} an encode; {busy / (span * 1e3):.1%} of the "
               f"span, idle {1 - busy / (span * 1e3):.1%})")
        for a in sorted(avgs, key=device_us, reverse=True)[:12]:
            cs.log(f"encode {impl}:   {device_us(a) / 1e3 / CALLS:8.3f} ms an encode, "
                   f"{a.count // CALLS:4d} calls  {a.key[:90]}")
        del m
        torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
