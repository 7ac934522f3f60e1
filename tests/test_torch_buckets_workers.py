"""Exchange buckets at four gloo ranks: the port's distributed step is
bitwise the same for buckets {0, 1, 1 KiB} over 3 steps, in every mode
on the flat topology over 4 workers, and for ``qadam`` and ``adaptive``
on the ``2x2`` hierarchical tiers and on (data 2, model 2). Each rank
compares its own losses and state across the sizes (spawned processes,
a ``FileStore``); with more than one bucket every bucket ran from a
gradient hook inside the backward, and the collectives the hooks
launched kept one order on every rank (a mismatch would hang or
fail the run). The lists themselves: ``tests/test_torch_buckets.py``.
The tuner's choice at four ranks: each rank timing a different size
fastest, every rank still takes one size (``agree_on_bucket``).
"""
import json
import os
import time

import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.data.pipeline import batch_for_model
from repro_torch.dist import topology as T
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import make_train_step
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel
from repro_torch.tree import tree_leaves

STEPS, BATCH, SEQ = 3, 8, 32
SIZES = (0, 1, 1 << 10)
MODES = {
    "qadam": dict(weight_k=7),
    "dp_adam": dict(weight_k=7),
    "efadam": dict(weight_k=7, weight_absolute=False),
    "terngrad": dict(alpha=2e-2, grad_k=None, weight_k=None),
    "ef_sgd": dict(alpha=1e-2, beta=0.9, grad_k=None, weight_k=None),
    "adaptive": dict(weight_k=7, bit_plan=(
        "blockwise:256", "log:2", "log:6", "log:30", "log:126",
        "uniform_amax:14:w16") * 2),
}
# (grid name, make_grid kwargs, topology, modes)
RUNS = (
    ("flat4", dict(data=4), None, tuple(MODES)),
    ("2x2", dict(pod=2, data=2), (2, 2), ("qadam", "adaptive")),
    ("data2-model2", dict(data=2, model=2), None, ("qadam", "adaptive")),
)


def _fingerprint(state):
    out = []
    for k in sorted(state):
        if k == "count":
            out.append(state[k])
            continue
        for t in tree_leaves(state[k]):
            out.append(int(t.view(torch.int32).to(torch.int64).sum()))
            out.append(int((t.view(torch.int32).to(torch.int64)
                            * torch.arange(t.numel()).reshape(t.shape))
                           .sum()))
    return out


def _worker(rank, store_path, out_dir):
    torch.set_num_threads(1)
    TM.make_process_group(
        "cpu", store=torch.distributed.FileStore(store_path, 4), rank=rank,
        world_size=4)
    res = {}
    try:
        model = TModel(tget("yi-6b", smoke=True))
        for name, kw, topo, modes in RUNS:
            grid = TM.make_grid(device="cpu", **kw)
            for mode in modes:
                runs = {}
                for size in SIZES:
                    tc = TTC(mode=mode, exchange_bucket_bytes=size,
                             topology=T.HierarchicalTopology(*topo) if topo
                             else T.FlatTopology(), **MODES[mode])
                    art = make_train_step(model, grid, tc)
                    state = art.init_state(seed=0, device="cpu")
                    batches = batch_for_model(model.cfg, SEQ, BATCH, seed=0)
                    losses = []
                    for _ in range(STEPS):
                        batch = {k: torch.as_tensor(v)
                                 for k, v in next(batches).items()}
                        state, m = art.step_fn(state, batch)
                        losses.append(float(m["loss"]))
                    hooked = (art.overlap or {}).get("in_backward", 0)
                    runs[size] = dict(losses=losses, buckets=len(
                        art.buckets), hooked=hooked,
                        fp=_fingerprint(state))
                res[f"{name}:{mode}"] = runs
    finally:
        TM.close_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _spawn(worker, tmp_path, seconds):
    import torch.multiprocessing as mp
    ctx = mp.spawn(worker, args=(str(tmp_path / "store"), str(tmp_path)),
                   nprocs=4, join=False)
    deadline = time.monotonic() + seconds
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("4 gloo ranks did not finish")


def _agree_worker(rank, store_path, out_dir):
    from repro_torch.perf import autotune as AT
    torch.set_num_threads(1)
    TM.make_process_group(
        "cpu", store=torch.distributed.FileStore(store_path, 4), rank=rank,
        world_size=4)
    try:
        # this rank times candidate ``rank`` fastest, the others slower
        # by an amount that grows with the rank and the candidate
        cands = AT.CANDIDATE_BUCKETS
        mine = {b: 1.0 if j == rank else 2.0 + 0.1 * j * (rank + 1)
                for j, b in enumerate(cands)}
        agreed, tc = AT.agree_on_bucket(mine, TTC())
    finally:
        TM.close_process_group()
    with open(os.path.join(out_dir, f"agree{rank}.json"), "w") as f:
        json.dump({"local": min(mine, key=mine.get),
                   "agreed": [agreed[b] for b in cands],
                   "bucket": tc.exchange_bucket_bytes}, f)


def test_tuned_bucket_is_one_size_on_every_rank(tmp_path):
    from repro_torch.perf import autotune as AT
    _spawn(_agree_worker, tmp_path, 120)
    res = [json.load(open(tmp_path / f"agree{r}.json")) for r in range(4)]
    # alone, each rank would have taken its own size
    assert [r["local"] for r in res] == list(AT.CANDIDATE_BUCKETS)
    # together: each size's slowest rank, and the fastest of those
    for r in res:
        assert r["agreed"] == res[0]["agreed"]
        assert r["bucket"] == AT.CANDIDATE_BUCKETS[0]
    assert res[0]["agreed"][1] == pytest.approx(2.0 + 0.1 * 4)


def test_buckets_bitwise_at_four_workers(tmp_path):
    _spawn(_worker, tmp_path, 240)
    for rank in range(4):
        res = json.load(open(tmp_path / f"rank{rank}.json"))
        assert len(res) == sum(len(r[3]) for r in RUNS)
        for key, runs in res.items():
            base = runs[str(SIZES[0])]
            assert base["buckets"] == 1 and base["hooked"] == 0, key
            for size in SIZES[1:]:
                r = runs[str(size)]
                assert r["buckets"] > 1 and r["hooked"] == r["buckets"], \
                    (key, size)
                assert r["losses"] == base["losses"], (key, size, rank)
                assert r["fp"] == base["fp"], (key, size, rank)


@pytest.mark.parametrize("size", SIZES)
def test_sizes_run_in_the_reference_order(size):
    """The sizes this test sweeps give the reference's kinds of bucket
    lists: one whole-tree bucket at 0, a bucket a leaf at 1 byte."""
    from repro_torch.launch.dryrun import RecordingDist, recording_grid
    model = TModel(tget("yi-6b", smoke=True))
    g = recording_grid((4, 1), ("data", "model"), RecordingDist(0))
    art = make_train_step(model, g, TTC(exchange_bucket_bytes=size))
    n = len(tree_leaves(art.layout.shapes))
    if size == 0:
        assert len(art.buckets) == 1 and len(art.buckets[0]) == n
    elif size == 1:
        assert len(art.buckets) == n
    else:
        assert 1 < len(art.buckets) <= n
