"""Build the kernels and run ``chip_smoke.py``'s perf phase alone, on a
card:

    python3 tools/perf_probe.py
"""
import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

t0 = time.perf_counter()
from repro_torch import build  # noqa: E402
build.library()
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
from repro_torch.comm import kernels as K  # noqa: E402
from repro_torch.comm import matmul as MM  # noqa: E402
from repro_torch.kernels import adam_ef as A  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_grad_enabled(False)
dev = torch.device("cuda")
card = CS.card_line()
print(card, flush=True)
cfg8 = dataclasses.replace(get_config("yi-6b"), n_layers=CS.TRAIN_LAYERS)
pf = CS.perf_phase(torch, dev, {"K": K, "A": A, "MM": MM}, build,
                   Model(cfg8), cfg8)
CS.print_perf(pf, card)
