"""Time nvcc on each kernel source: all started together with
``build.CFLAGS`` (as ``build.py`` does), then dequant_matmul.cu and
flash_attention.cu alone, without ``--split-compile`` and with it at 0
(every core) and 8. Run on a machine with the CUDA toolkit:

    python3 tools/nvcc_times.py
"""
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))
from repro_torch import build  # noqa: E402

nvcc = build.nvcc_path()
print(subprocess.run([nvcc, "--version"], capture_output=True,
                     text=True).stdout.strip().splitlines()[-1], flush=True)
out = tempfile.mkdtemp()
cus, _ = build._sources()
split = build.CFLAGS.index("--split-compile") \
    if "--split-compile" in build.CFLAGS else None
BASE = build.CFLAGS if split is None else \
    build.CFLAGS[:split] + build.CFLAGS[split + 2:]


def start(src, extra=(), base=BASE):
    return subprocess.Popen([nvcc, *base, *extra, "-I",
                             str(build.CSRC), "-c", str(src), "-o",
                             os.path.join(out, src.stem + ".o")],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.STDOUT)


t0 = time.perf_counter()
procs = [(s, start(s, base=build.CFLAGS)) for s in cus]
left = dict(procs)
while left:
    for s, p in list(left.items()):
        if p.poll() is not None:
            print(f"together: {s.name} {time.perf_counter() - t0:.1f} s "
                  f"rc {p.returncode}", flush=True)
            del left[s]
    time.sleep(0.2)
for name in ("dequant_matmul.cu", "flash_attention.cu"):
    src = build.CSRC / name
    for extra in ((), ("--split-compile", "0"), ("--split-compile", "8")):
        t = time.perf_counter()
        p = start(src, extra)
        p.wait()
        print(f"alone: {name} {' '.join(extra) or '(default)'} "
              f"{time.perf_counter() - t:.1f} s rc {p.returncode}",
              flush=True)
