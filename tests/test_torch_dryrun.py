"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, at
smoke size on reduced grids, against the reference where they share
something to compare:

  * ``python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    --smoke --mesh single`` prints ``[OK]``; decode_32k, a MoE arch and
    mamba2 run in process on the 2 x 2 grid, the 2 x 2 x 2 grid too;
  * nothing touches a card: no kernel launch counter moves, CUDA is not
    initialized, every tensor of the step is a meta tensor but for the
    step's own host staging;
  * the argument bytes are the real smoke-size state's bytes, built on
    the CPU for the same rank, and its batch shard's;
  * ``comm_accounting`` is ``train.loop.comm_bytes_per_step``;
  * the ring model over recorded collectives equals the reference's
    ``parse_collectives`` on a synthetic StableHLO text of the same
    collectives;
  * a kernel on meta tensors is charged its own traffic (inputs read
    once, outputs written once) and, for K1, 2 M K N operations, with
    its plain version's passes excluded;
  * ``INPUT_SHAPES``, ``LONG_CONTEXT_ARCHS``, ``ARCH_IDS`` and
    ``shape_applicable`` equal the reference's.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as JC
from repro.launch.dryrun import parse_collectives
from repro_torch import configs as TCF
from repro_torch.comm import codec as CD
from repro_torch.comm import kernels as K
from repro_torch.comm import matmul as MM
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_for_model
from repro_torch.dist.step import TrainConfig, make_train_step, shard_batch
from repro_torch.launch import dryrun as D
from repro_torch.models.model import Model
from repro_torch.train.loop import comm_bytes_per_step

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ((2, 2), ("data", "model"))


def _run(arch, shape, grid=SMOKE, **kw):
    return D.build_and_compile(arch, shape, False, grid_override=grid,
                               smoke=True, **kw)


def test_cli_prints_ok():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-6b", "--shape", "train_4k", "--smoke", "--mesh", "single"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[OK] yi-6b x train_4k x smoke-2x2: flops=")
    assert "H100 SXM5 data sheet" in out.stdout


@pytest.mark.parametrize("arch,shape", [
    ("yi-6b", "decode_32k"), ("deepseek-moe-16b", "train_4k"),
    ("mamba2-2.7b", "prefill_32k"), ("hymba-1.5b", "long_500k")])
def test_shapes_run_on_meta(arch, shape):
    res = _run(arch, shape)
    assert not res["skipped"] and res["hlo_flops"] > 0
    assert res["hlo_bytes"] > 0 and res["collective_bytes"] > 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    assert res["calibrate_s"] == 0 and res["hardware"] == D.HARDWARE
    mem = res["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["code_bytes"] is None
    if res["kind"] == "train":
        assert {"K15 adam_moments", "K7 ef_encode_rows",
                "K6 decode_rows"} <= set(res["kernels"])
    assert not torch.cuda.is_initialized()


def test_skip_and_multi_grid():
    assert _run("yi-6b", "long_500k")["skipped"]
    res = _run("yi-6b", "train_4k", grid=((2, 2, 2),
                                          ("pod", "data", "model")))
    assert res["mesh"] == "2x2x2" and res["n_devices"] == 8


def test_no_kernel_and_no_real_memory():
    before = D._launch_counts()
    res = _run("yi-6b", "train_4k",
               train_overrides={"weight_k": 7, "model_gather_quant": 8})
    assert D._launch_counts() == before
    # the Q_x wire's kernels were charged, not launched
    assert {"K3 amax_rows", "K4 uniform_quantize_rows",
            "K12 uniform_dequantize_rows"} <= set(res["kernels"])
    assert res["host_staging_bytes"] < 1024
    assert not torch.cuda.is_initialized()


def test_argument_bytes_and_accounting_equal_the_real_state():
    res = _run("yi-6b", "train_4k", train_overrides={"weight_k": 7})
    cfg = get_config("yi-6b", smoke=True)
    rec = D.RecordingDist(0)
    grid = D.recording_grid(*SMOKE, rec)
    tc = TrainConfig(weight_k=7)
    art = make_train_step(Model(cfg), grid, tc)
    state = art.init_state(seed=0, device="cpu")
    state_bytes = sum(t.numel() * t.element_size() for k, v in state.items()
                      if k != "count" for t in _leaves(v))
    assert res["memory"]["state_bytes"] == state_bytes
    batch = {k: torch.as_tensor(v) for k, v in
             next(batch_for_model(cfg, 64, 8)).items()}
    mine = shard_batch(batch, grid.worker_index, grid.n_workers,
                       grid.model_index, grid.n_shards)
    batch_bytes = sum(v.numel() * v.element_size() for v in mine.values())
    assert res["memory"]["batch_bytes"] == batch_bytes
    assert res["memory"]["argument_bytes"] == state_bytes + batch_bytes
    assert res["comm_accounting"] == comm_bytes_per_step(art, tc)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_ring_model_equals_parse_collectives():
    def tensor(shape, dt):
        return "tensor<" + "x".join(str(s) for s in shape) + f"x{dt}>"
    ops = [("all_gather", "all-gather", 4, (32, 16), "f32", 4),
           ("all_reduce", "all-reduce", 2, (64,), "bf16", 2),
           ("reduce_scatter", "reduce-scatter", 4, (8, 3), "f32", 4),
           ("all_to_all", "all-to-all", 4, (4, 100), "ui8", 1),
           ("collective_permute", "collective-permute", 2, (7,), "f32", 4),
           ("all_gather", "all-gather", 8, (5,), "i32", 4)]
    lines = ["func.func public @main(%arg0: tensor<4xf32>) {"]
    events = []
    for i, (op, kind, n, shape, dt, size) in enumerate(ops):
        groups = f"dense<0> : tensor<{16 // n}x{n}xi64>"
        res = tensor(shape, dt)
        lines.append(f'  %{i} = "stablehlo.{op}"(%arg0) '
                     f'{{replica_groups = {groups}}} : '
                     f'(tensor<4xf32>) -> {res}')
        nbytes = size
        for s in shape:
            nbytes *= s
        events.append((kind, n, nbytes))
    lines.append("}")
    want = parse_collectives("\n".join(lines))
    got = D.ring_totals(events + [("barrier", 4, 0)])
    assert got["counts"] == want["counts"]
    for k in D.KINDS + ("total",):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_recording_dist_records_each_collective():
    rec = D.RecordingDist(0)
    grid = D.recording_grid((2, 4), ("data", "model"), rec)
    assert grid.model.members == (0, 1, 2, 3)
    assert grid.workers.members == (0, 4)
    from repro_torch.dist import collectives as C
    with D.recording(rec):
        x = torch.empty(10, device="meta")
        C.all_reduce(x, grid.model)
        C.gather_rows(x, grid.workers)
        C.exchange_rows(torch.empty((2, 6), dtype=torch.uint8,
                                    device="meta"), grid.workers)
        C.shift(x, 1, grid.model)
    kinds = [(k, n, b) for k, n, b, _ in rec.events]
    assert kinds == [("all-reduce", 4, 40), ("all-gather", 2, 80),
                     ("all-to-all", 2, 12),
                     ("collective-permute", 4, 40)]
    assert C.dist is torch.distributed


def test_kernels_are_charged_their_own_traffic():
    codec = CD.LogCodec(6)
    c = 1000
    with D.metering() as m:
        payload = torch.empty((4, codec.payload_nbytes(c)),
                              dtype=torch.uint8, device="meta")
        scales = torch.empty(4, device="meta")
        out = K.decode_rows(payload, scales, codec, c)
        x = torch.empty((4, 256), dtype=torch.bfloat16, device="meta")
        codes = torch.empty((256, 512), dtype=torch.int8, device="meta")
        y = MM.dequant_matmul(x, codes, torch.empty((), device="meta"),
                              k_x=6, n=512, cast_dtype="bfloat16")
    assert out.shape == (4, c) and out.device.type == "meta"
    k6 = m.kernels["K6 decode_rows"]
    assert k6 == {"launches": 1, "flops": 0.0,
                  "bytes": payload.numel() + 16 + 4 * c * 4}
    k1 = m.kernels["K1 dequant_matmul"]
    assert k1["flops"] == 2 * 4 * 256 * 512
    assert k1["bytes"] == x.numel() * 2 + codes.numel() + 4 + \
        y.numel() * y.element_size()
    # the plain versions' own products are not counted beside K1's
    assert m.flops == k1["flops"]
    assert m.bytes == k6["bytes"] + k1["bytes"]


def test_input_shapes_equal_the_reference():
    assert TCF.INPUT_SHAPES == JC.INPUT_SHAPES
    assert TCF.LONG_CONTEXT_ARCHS == JC.LONG_CONTEXT_ARCHS
    assert TCF.ARCH_IDS == JC.ARCH_IDS
    for arch in JC.ARCH_IDS:
        for shape in JC.INPUT_SHAPES:
            assert TCF.shape_applicable(arch, shape) == \
                JC.shape_applicable(arch, shape)


def test_model_overrides_nest():
    cfg = get_config("deepseek-moe-16b", smoke=True)
    got = D.apply_model_overrides(cfg, {"n_layers": 3,
                                        "moe.dispatch": "sort"})
    assert got.n_layers == 3 and got.moe.dispatch == "sort"
    assert D.apply_model_overrides(cfg, None) is cfg


def test_hardware_model_is_the_h100_data_sheet():
    from repro_torch.launch import mesh
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW) == (989e12, 3.35e12)
    assert (mesh.NVLINK_BW, mesh.NIC_BW) == (450e9, 50e9)
    assert mesh.link_bw(range(8)) == mesh.NVLINK_BW
    assert mesh.link_bw(range(16)) == mesh.NIC_BW
    assert mesh.production_grid_shape() == ((16, 16), ("data", "model"))
    assert mesh.production_grid_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
