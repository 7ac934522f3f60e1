"""Guards of the PyTorch port's boundary: it never imports JAX or the JAX
package, and its entry points run on the GPU unless told otherwise."""
import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "examples" /
                                         "paper_repro_torch.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.serve, repro_torch.serve.session, "
            "repro_torch.convert, repro_torch.core.qadam, "
            "repro_torch.train.session, repro_torch.kernels.adam_ef, "
            "repro_torch.data.pipeline, repro_torch.launch.train, "
            "repro_torch.launch.mesh, repro_torch.dist.step, "
            "repro_torch.dist.collectives, repro_torch.dist.modes, "
            "repro_torch.train.loop, repro_torch.comm.codec, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.configs.gemma2_2b, repro_torch.comm, "
            "repro_torch.core.quantizers, repro_torch.core.packing, "
            "repro_torch.core.uniforms, repro_torch.kernels.ops, "
            "repro_torch.kernels.pack, repro_torch.kernels.quantize, "
            "repro_torch.kernels.ref; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def _default(fn, name):
    return inspect.signature(fn).parameters[name].default


def test_entry_points_default_to_cuda():
    from repro_torch import convert
    from repro_torch.launch import serve as launch
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.session import ServeSession
    assert _default(Model.init, "device") == "cuda"
    assert _default(Model.init_cache, "device") == "cuda"
    assert _default(ServeSession.__init__, "device") == "cuda"
    assert _default(Engine.__init__, "device") == "cuda"
    assert _default(convert.params_from_numpy, "device") == "cuda"
    assert _default(convert.quantized_from_numpy, "device") == "cuda"
    assert _default(convert.qadam_state_from_numpy, "device") == "cuda"
    src = inspect.getsource(launch.main)
    assert 'ap.add_argument("--device", default="cuda")' in src
    from repro_torch.launch import mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.train.session import TrainSession
    assert _default(convert.dist_state_from_numpy, "device") == "cuda"
    assert _default(TrainSession.from_artifacts, "device") == "cuda"
    assert _default(mesh.make_process_group, "device") == "cuda"
    assert launch_train.parse_args(["--arch", "yi-6b"]).device == "cuda"
    from repro_torch.data import pipeline
    assert _default(pipeline.classification_dataset, "device") == "cuda"
    example = (ROOT / "examples" / "paper_repro_torch.py").read_text()
    assert 'ap.add_argument("--device", default="cuda")' in example


def test_kernel_wrappers_refuse_cuda_backend_on_cpu():
    import torch
    from repro_torch.comm import kernels as K
    from repro_torch.comm.codec import resolve_backend
    x = torch.ones(2, 8)
    assert resolve_backend(None, x) == "torch"
    assert resolve_backend("torch", x) == "torch"
    with pytest.raises(ValueError):
        resolve_backend("cuda", x)
    with pytest.raises(ValueError):
        resolve_backend("pallas", x)
    with pytest.raises(ValueError):
        K.amax_rows(x, backend="cuda")
    from repro_torch.kernels import adam_ef as A
    from repro_torch.opt import engine as E
    hp = E.hyperparams(1e-3, 0.99, 0.001, 1e-5, "cpu")
    with pytest.raises(ValueError):
        A.adam_moments(x, x, x, x, hp, backend="cuda")
    with pytest.raises(ValueError):
        A.ef_quantize(x, torch.tensor(1.0), 6, backend="cuda")
    with pytest.raises(ValueError):
        K.log_dequantize(x.to(torch.int8), torch.tensor(1.0), 6,
                         backend="cuda")
    with pytest.raises(ValueError):
        K.uniform_dequantize_rows(x.to(torch.int8), torch.ones(2), 6,
                                  backend="cuda")
    from repro_torch.comm import codec as CD
    with pytest.raises(ValueError):
        K.ef_encode_rows(x, torch.tensor(1.0), CD.LogCodec(6), 2,
                         backend="cuda")
    payload, _ = K.ef_encode_rows(x, torch.tensor(1.0), CD.LogCodec(6), 2)
    with pytest.raises(ValueError):
        K.decode_rows(payload, torch.ones(2), CD.LogCodec(6), 8,
                      backend="cuda")
    for call in (lambda: K.log_quantize(x, torch.tensor(1.0), 6,
                                        backend="cuda"),
                 lambda: K.ternary_quantize(x, x, torch.tensor(1.0),
                                            backend="cuda"),
                 lambda: K.pack_rows(x.to(torch.int8), 2, backend="cuda"),
                 lambda: K.unpack_rows(payload, 4, 8, backend="cuda")):
        with pytest.raises(ValueError):
            call()
