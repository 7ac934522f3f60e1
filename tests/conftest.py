"""Test bootstrap: make `pytest -x -q` work from the repo root without the
PYTHONPATH=src incantation, and register the `slow` marker used by the
subprocess-based multi-device suite."""
import os
import sys

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
# subprocess tests (tests/dist_scripts) inherit the environment, not
# sys.path - keep both in sync.
os.environ["PYTHONPATH"] = _SRC + (
    os.pathsep + os.environ["PYTHONPATH"]
    if os.environ.get("PYTHONPATH") else "")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-device subprocess tests (compile-heavy; deselect "
        "with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's kernels); skips "
        "elsewhere")
