"""The port's three examples (``examples/*_torch.py``, the counterparts
of ``quickstart.py``, ``serve_quantized.py`` and
``train_lm_distributed.py``) run on the CPU at small sizes, each in its
own process, printing the reference programs' lines and passing their
asserts; the distributed one under four gloo ranks (``torchrun``, data 2
x model 2). On the card: ``chip_smoke.py``'s perf phase (e)."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(args, capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_quickstart_on_the_cpu():
    out = _run([sys.executable, "examples/quickstart_torch.py", "--device",
                "cpu", "--steps", "20", "--chunk", "5"])
    assert "model: yi-6b (smoke)" in out
    assert "-> 4-bit codes" in out and "x smaller)" in out
    assert out.count("loss ") >= 4
    assert "'dispatches': 4" in out          # 5 steps a dispatch
    assert out.strip().endswith("5 steps per dispatch.")


def test_serve_quantized_on_the_cpu():
    out = _run([sys.executable, "examples/serve_quantized_torch.py",
                "--device", "cpu"])
    assert "x of fp32, measured on the tensors)" in out
    assert "k_x=2 packed 4-bit lanes" in out
    assert "greedy agreement over first 6 tokens" in out
    assert out.strip().endswith(
        "fused dequant-matmul tokens identical to unfused (qx6 + qx2)")


def test_train_lm_distributed_on_four_gloo_ranks():
    out = _run([sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "4",
                "examples/train_lm_distributed_torch.py", "--device", "cpu",
                "--data", "2", "--model", "2", "--smoke", "--layers", "2",
                "--steps", "20", "--seq", "32", "--global-batch", "4"])
    assert "2 workers x 2-way CP (cpu)" in out
    assert "per-device wire/step: exchange" in out
    assert "session stats:" in out and "loss " in out
    last = out.strip().splitlines()[-1]
    first, final = (float(v) for v in last.split()[1::2][:2])
    assert last.startswith("loss ") and final < first
