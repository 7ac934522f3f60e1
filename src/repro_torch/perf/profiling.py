"""``torch.profiler`` trace harness (port of ``repro/perf/profiling.py``).

Wrap a run in one :func:`trace` context and its parts in
:func:`annotate` scopes: the timeline then carries the scopes' names
around every kernel launch (``record_function`` on the host, an NVTX
range on the card). The trace records CPU activity, and CUDA activity
(CUPTI) when a card is present, and is written as a Chrome trace to
``<log_dir>/plugins/profile/<run>/trace.json``, the layout the
reference's TensorBoard traces have, so :func:`trace_runs` finds the
runs the same way. Open a trace in ui.perfetto.dev or chrome://tracing.
"""
from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Iterator, Optional

import torch

DEFAULT_TRACE_DIR = os.path.join("results", "traces")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, *,
          enabled: bool = True) -> Iterator[Optional[str]]:
    """Profile everything inside the context into ``log_dir``.

    Yields the log dir (or None when ``enabled=False``, so callers can
    wrap unconditionally: ``with trace(d, enabled=args.trace):``)."""
    if not enabled:
        yield None
        return
    log_dir = log_dir or DEFAULT_TRACE_DIR
    run = os.path.join(log_dir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S")
                       + f"_{os.getpid()}")
    os.makedirs(run, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(run, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named scope on the profiler timeline: ``record_function``, and an
    NVTX range while a card is initialized."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def trace_runs(log_dir: str) -> list:
    """Profile run directories written under ``log_dir``, newest last."""
    runs = glob.glob(os.path.join(log_dir, "plugins", "profile", "*"))
    return sorted(runs, key=os.path.getmtime)
