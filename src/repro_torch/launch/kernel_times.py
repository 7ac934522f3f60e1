"""Time K1's CUDA-core route, K6, K7 and #5 on the card, through their
public wrappers only, so that two checkouts can be compared in one call.

  python src/repro_torch/launch/kernel_times.py [--label NAME]

Run it as a file with the ``src`` of the checkout to measure first on
``PYTHONPATH`` (its kernels build into that checkout's ``build/``):

  PYTHONPATH=/path/to/other/src python src/repro_torch/launch/kernel_times.py

Prints one JSON object a line: K1 (``dequant_matmul``, float32
activations against int8 codes, k_x = 6) at M = 4 and 32 over yi-6b's
w_gate and gemma2-2b's wq, wk/wv and w_down, beside the fp32
``torch.matmul`` (TF32 off) on the dequantized weight; K6
(``decode_rows``) for log:6, uniform:7 and ternary at the 8-layer w_gate
stack (8 x 4096 x 11008 elements, one payload row); K7
(``ef_encode_rows``) and #5 (``encode_rows``) at every lane width at the
same stack (K7: uniform:1:w2, log:2, log:6, log:30, uniform:7:w8 (the
weight wire), log:126, uniform_amax:14:w16; #5: terngrad, the log grids,
uniform_amax:7:w8, uniform_amax:14:w16), beside their byte bounds and,
for #5, K3's amax launch alone on the same x. Times are CUDA-graph
replays (K1, four weight copies in rotation past the L2) or CUDA events
over back-to-back calls (K6, K7, #5), in ms; the card's name and power
limit come first. Last, the SM clock and power draw nvidia-smi reads
while K1 runs back to back at M = 32 on (4096, 11008) for two seconds
(medians of samples 100 ms apart): the clock the FMA floor's 66.9
TFLOP/s assumes is 1.98 GHz.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# the timing helpers of chip_smoke.py at this checkout's root
sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
from chip_smoke import bound_ms, card_line, cuda_ms, graph_ms  # noqa: E402

K1_SHAPES = [(4096, 11008), (2304, 2048), (2304, 1024), (9216, 2304)]
STACK = 8 * 4096 * 11008


def k1_times(dev):
    from repro_torch.comm import matmul as MM
    g = torch.Generator(device=dev).manual_seed(13)
    scale = torch.tensor(0.0371, device=dev)
    for K, N in K1_SHAPES:
        ws = [torch.randint(-64, 65, (K, N), generator=g, device=dev,
                            dtype=torch.int32).to(torch.int8)
              for _ in range(4)]
        wf = [MM.dequant_codes(w, scale, k_x=6, n=N, pack_bits=0,
                               w_dtype="float32", cast_dtype=None)
              for w in ws]
        for M in (4, 32):
            x = torch.randn((M, K), generator=g, device=dev)
            ms = graph_ms(torch, lambda i: MM.dequant_matmul(
                x, ws[i], scale, k_x=6, n=N, backend="cuda"), 4)
            lib = graph_ms(torch, lambda i: torch.matmul(x, wf[i]), 4)
            yield dict(kernel="K1 fma", M=M, K=K, N=N, ms=ms, library_ms=lib)
        del ws, wf


def k6_times(dev):
    from repro_torch.comm import codec as CD
    from repro_torch.comm import kernels as K
    g = torch.Generator(device=dev).manual_seed(31)
    codecs = {"log:6": CD.LogCodec(k_g=6),
              "uniform:7": CD.uniform_wire_codec(7),
              "ternary": CD.TernaryCodec()}
    out = torch.empty(STACK, device=dev)
    scales = torch.tensor([0.5], device=dev)
    for spec, codec in codecs.items():
        nbytes = codec.payload_nbytes(STACK)
        payload = torch.randint(0, 256, (1, nbytes), generator=g, device=dev,
                                dtype=torch.int32).to(torch.uint8)
        ms = cuda_ms(torch, lambda i: K.decode_rows(
            payload, scales, codec, STACK, backend="cuda", out=out), 10, 1)
        yield dict(kernel="K6", spec=spec, n=STACK, ms=ms)
        del payload


def _encode_input(dev, g, x, codec):
    """The w_gate stack as the main paths give it to the encodes: Delta+e
    (1e-3 randn) against its amax for the log grids and the amax uniform
    lanes, weights (0.02 truncated normal) against 0.5 for the absolute
    uniform wire."""
    from repro_torch.opt import engine as E
    if codec.kind == "uniform" and codec.static_scale is not None:
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                    generator=g).mul_(0.02)
        return torch.tensor(0.5, device=dev)
    torch.randn(STACK, generator=g, out=x).mul_(1e-3)
    return E.amax_scale(x.abs().amax())


def encode_times(dev):
    from repro_torch.comm import codec as CD
    from repro_torch.comm import kernels as K
    g = torch.Generator(device=dev).manual_seed(32)
    x = torch.empty(STACK, device=dev)
    e = torch.empty(STACK, device=dev)
    for spec in ("uniform:1:w2", "log:2", "log:6", "log:30", "uniform:7:w8",
                 "log:126", "uniform_amax:14:w16"):
        codec = CD.get_codec(spec)
        scale = _encode_input(dev, g, x, codec)
        nbytes = codec.payload_nbytes(STACK)
        ms = cuda_ms(torch, lambda i: K.ef_encode_rows(
            x, scale, codec, 1, backend="cuda", out=e), 10, 1)
        bnd = bound_ms(8 * STACK + nbytes + 4)[0]
        yield dict(kernel="K7", spec=codec.spec, bits=codec.bits, n=STACK,
                   ms=ms, bound_ms=bnd, share_of_bound=bnd / ms)
    u = torch.rand(STACK, generator=g, device=dev)
    for spec in ("terngrad", "log:2", "log:6", "log:30", "uniform_amax:7:w8",
                 "log:126", "uniform_amax:14:w16"):
        codec = CD.get_codec(spec)
        _encode_input(dev, g, x, codec)
        nbytes = codec.payload_nbytes(STACK)
        ubytes = 4 * STACK if codec.kind == "ternary" else 0
        ms = cuda_ms(torch, lambda i: K.encode_rows(
            x, codec, 1, u=u, backend="cuda"), 10, 1)
        amax = cuda_ms(torch, lambda i: K.amax_rows(
            x.reshape(1, -1), backend="cuda"), 10, 1)
        launch = bound_ms(4 * STACK + ubytes + nbytes + 4)[0]
        yield dict(kernel="#5", spec=codec.spec, bits=codec.bits, n=STACK,
                   ms=ms, k3_amax_ms=amax, encode_launch_ms=ms - amax,
                   bound_ms=bound_ms(8 * STACK + ubytes + nbytes + 4)[0],
                   encode_launch_bound_ms=launch,
                   encode_launch_share=(launch / (ms - amax)
                                        if ms > amax else None))
    del x, e, u


def clock_under_load(dev, seconds: float = 2.0):
    from repro_torch.comm import matmul as MM
    g = torch.Generator(device=dev).manual_seed(17)
    codes = torch.randint(-64, 65, (4096, 11008), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
    x = torch.randn((32, 4096), generator=g, device=dev)
    scale = torch.tensor(0.0371, device=dev)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                MM.dequant_matmul(x, codes, scale, k_x=6, n=11008,
                                  backend="cuda")
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    samples = []
    for line in out.splitlines():
        try:
            clock, power = (float(v) for v in line.split(","))
        except ValueError:   # a reading nvidia-smi could not take
            continue
        samples.append((clock, power))
    if not samples:
        raise RuntimeError(f"no clock readings from nvidia-smi: {out!r}")
    return dict(kernel="K1 fma", M=32, K=4096, N=11008, samples=len(samples),
                sm_clock_mhz=statistics.median(c for c, _ in samples),
                power_w=statistics.median(p for _, p in samples))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"label": args.label, "card": card_line()}), flush=True)
    dev = torch.device("cuda")
    from repro_torch import build
    build.library()
    for row in (*k1_times(dev), *k6_times(dev), *encode_times(dev),
                clock_under_load(dev)):
        print(json.dumps(dict(row, label=args.label)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
