"""The port's performance tooling (``repro_torch.perf``) on the CPU,
after ``tests/test_perf.py``: the AOT key and artifact rules
(``TestAotKey``, ``TestAotRoundtrip`` with a library-like payload), the
kernel build cache (``TestPersistentCache``: per-object keys against a
stand-in compiler, enabling mid-process, the environment switch), the
trace harness (``TestTraceHarness``), and the tuners' overrides:
``set_enc_rows`` and ``set_mm_cols`` installed and restored, ``k1_plan``
consulting an installed plan, and the tuners' restore-unless-install
rules with the card's timings stood in for. What needs the card (timing,
a real library) is in ``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``'s perf phase.
"""
import dataclasses
import glob
import json
import os
import stat
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import build, perf
from repro_torch.comm import kernels as K
from repro_torch.comm import matmul as MM
from repro_torch.perf import aot
from repro_torch.perf import autotune as AT


class TestAotKey:
    def test_python_scalars_are_value_independent(self):
        a = aot.step_key({"f": 1}, (torch.ones(4), 3, 2.5, True))
        b = aot.step_key({"f": 1}, (torch.ones(4), 9, 0.1, False))
        assert a == b

    def test_forks_on_facts_shapes_dtypes(self):
        base = aot.step_key({"f": 1}, (torch.ones(4),))
        assert aot.step_key({"f": 2}, (torch.ones(4),)) != base
        assert aot.step_key({"f": 1}, (torch.ones(5),)) != base
        assert aot.step_key({"f": 1},
                            (torch.ones(4, dtype=torch.int32),)) != base
        assert aot.step_key({"f": 1}, ({"w": torch.ones(4)},)) != base

    def test_dataclass_facts_canonicalize(self):
        @dataclasses.dataclass(frozen=True)
        class Cfg:
            k: int = 6
        assert aot.digest(Cfg()) == aot.digest(Cfg())
        assert aot.digest(Cfg(k=7)) != aot.digest(Cfg())

    def test_key_covers_sources_and_device(self, monkeypatch):
        base = aot.step_key("f", ())
        monkeypatch.setattr(build, "source_digest", lambda *a: "changed")
        assert aot.step_key("f", ()) != base
        facts = aot._device_facts()
        assert facts["platform"] == "cpu" and facts["torch"] == \
            torch.__version__ and "cuda" in facts


@pytest.fixture
def fresh_build(monkeypatch):
    """The build module's loaded-library state, restored after."""
    for name in ("_lib", "_lib_path", "origin", "_lib_objects"):
        monkeypatch.setattr(build, name, getattr(build, name))
    monkeypatch.setattr(build, "_lib", None)
    return build


class TestAotRoundtrip:
    def test_save_load_installs_the_library(self, tmp_path, fresh_build,
                                            monkeypatch):
        """A library-like payload (a shared object of the Python build,
        with no kernel signatures to bind) goes through save -> load:
        the artifact is written atomically, loads with ctypes and
        becomes the library the wrappers launch, origin "aot"."""
        import _ctypes
        src = Path(_ctypes.__file__)
        monkeypatch.setattr(build, "SIGNATURES", {})
        d = str(tmp_path / "aot")
        path = aot.save(d, "k0", src, facts={"t": 1})
        assert path.endswith(aot.SUFFIX) and not glob.glob(d + "/*.tmp.*")
        assert aot.load(d, "k0") is not None
        assert build.origin == "aot" and build._lib is not None
        assert Path(build.loaded_path()).read_bytes() == src.read_bytes()

    def test_corrupt_or_foreign_artifact_is_a_miss(self, tmp_path,
                                                   fresh_build):
        d = tmp_path / "aot"
        d.mkdir()
        (d / ("torn" + aot.SUFFIX)).write_bytes(b"torn")
        assert aot.load(str(d), "torn") is None
        # a whole artifact whose library does not load (not an ELF file)
        lib = tmp_path / "not_a_library.so"
        lib.write_bytes(b"\x7fELF-but-not-really")
        aot.save(str(d), "bad", lib)
        assert aot.load(str(d), "bad") is None
        assert aot.load(str(d), "absent") is None
        assert aot.load(None, "bad") is None
        assert build._lib is None            # nothing pretended to load

    def test_other_torch_version_is_a_miss(self, tmp_path, fresh_build,
                                           monkeypatch):
        lib = tmp_path / "x.so"
        lib.write_bytes(b"x")
        aot.save(str(tmp_path), "v", lib)
        monkeypatch.setattr(torch, "__version__", "0.0.0")
        assert aot._read(aot.artifact_path(str(tmp_path), "v")) is None

    @pytest.mark.parametrize("ran", [0, 1])
    def test_compilations_count_this_calls_nvcc_runs(self, tmp_path,
                                                     fresh_build,
                                                     monkeypatch, ran):
        """``compilations`` counts a build that ran nvcc for this step
        alone, not a library that an earlier build of the process left
        loaded (origin "built" all the same)."""
        import _ctypes
        monkeypatch.setattr(build, "SIGNATURES", {})
        monkeypatch.setattr(build, "stats", dict(build.stats))

        def library():
            build.stats["objects_compiled"] += ran
            build.stats["links"] += ran
            return build.install(_ctypes.__file__, "built")
        monkeypatch.setattr(build, "library", library)
        stats = {}
        aot.load_or_compile(lambda x: x, (torch.ones(2),),
                            aot_dir=str(tmp_path), facts="f", stats=stats,
                            device="cuda")
        want = {"compilations": 1, "aot_saves": 1} if ran else \
            {"aot_saves": 1}
        assert stats == want

    def test_cpu_passthrough_counts_nothing(self, tmp_path, fresh_build):
        def step(x):
            return x * 2
        stats = {}
        fn = aot.load_or_compile(step, (torch.ones(2),),
                                 aot_dir=str(tmp_path), facts="f",
                                 stats=stats, device="cpu")
        assert fn is step and stats == {} and build._lib is None
        assert not os.listdir(tmp_path)


FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
if args == ["--version"]:
    print("fake nvcc, release 0.0")
    sys.exit(0)
out = args[args.index("-o") + 1]
if "-c" in args:
    src = args[args.index("-c") + 1]
    data = open(src, "rb").read()
    open(out, "wb").write(b"OBJ:" + data)
else:
    ins = [a for a in args if a.endswith(".o")]
    open(out, "wb").write(b"LIB:" + b"|".join(open(i, "rb").read()
                                                for i in ins))
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` (objects and libraries are concatenated
    sources) on PATH, a fixed compute capability and a copy of csrc."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(build, "capability", lambda: "sm_90")
    monkeypatch.setattr(build, "_nvcc_version", {})
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        (csrc / p.name).write_bytes(p.read_bytes())
    return csrc


class TestPersistentCache:
    def test_objects_are_keyed_per_source(self, tmp_path, fake_toolkit):
        csrc, cache = fake_toolkit, tmp_path / "cache"
        n = len(list(csrc.glob("*.cu")))
        lib, compiled, linked, objs, _ = build.build_library(cache, csrc)
        assert len(compiled) == n and linked and lib.exists()
        assert perf.cache_entries(str(cache)) == n + 1
        # warm: nothing compiled, nothing linked
        lib2, compiled, linked, _, _ = build.build_library(cache, csrc)
        assert (lib2, compiled, linked) == (lib, [], False)
        # one source changed: its object alone, and a new library
        with open(csrc / "gather_pages.cu", "a") as f:
            f.write("\n// touched\n")
        lib3, compiled, linked, _, _ = build.build_library(cache, csrc)
        assert compiled == ["gather_pages.cu"] and linked and lib3 != lib
        assert perf.cache_entries(str(cache)) == n + 3
        # a header reaches every object
        with open(csrc / "grids.cuh", "a") as f:
            f.write("\n// touched\n")
        _, compiled, _, _, _ = build.build_library(cache, csrc)
        assert len(compiled) == n

    def test_build_needs_nvcc_even_when_warm(self, tmp_path, fake_toolkit,
                                             monkeypatch):
        """The compiler's version keys every object, so a build, warm or
        cold, needs nvcc; a host without it starts from an AOT artifact
        (the error says so)."""
        csrc, cache = fake_toolkit, tmp_path / "cache"
        build.build_library(cache, csrc)
        monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
        for where in (cache, tmp_path / "cold"):
            with pytest.raises(RuntimeError, match="aot-dir"):
                build.build_library(where, csrc)

    def test_enable_after_first_load_takes_effect(self, tmp_path,
                                                  fake_toolkit, fresh_build,
                                                  monkeypatch):
        """The library loaded from one directory; enabling another
        writes its objects and the library there, so the next process
        finds every entry."""
        csrc = fake_toolkit
        lib, _, _, objs, _ = build.build_library(tmp_path / "first", csrc)
        monkeypatch.setattr(build, "_lib_path", lib)
        monkeypatch.setattr(build, "_lib_objects", objs)
        monkeypatch.setattr(build, "_cache_dir", build._cache_dir)
        monkeypatch.setattr(build, "_cache_set", build._cache_set)
        d = str(tmp_path / "later")
        assert perf.enable_persistent_cache(d) == d
        assert perf.cache_entries(d) == len(objs) + 1
        assert build.cache_setting() == (Path(d), True)

    def test_env_off_disables(self, monkeypatch):
        monkeypatch.setattr(build, "_cache_dir", build._cache_dir)
        monkeypatch.setattr(build, "_cache_set", build._cache_set)
        monkeypatch.setenv(perf.cache.ENV_VAR, "off")
        assert perf.enable_persistent_cache() is None
        assert build.cache_setting()[0] is None
        assert perf.ensure_persistent_cache() is None
        # disabled: builds go to a private temporary directory
        assert "repro_torch_build_" in str(build.cache_dir())

    def test_ensure_requires_opt_in(self, monkeypatch, tmp_path):
        monkeypatch.setattr(build, "_cache_dir", build._cache_dir)
        monkeypatch.setattr(build, "_cache_set", False)
        monkeypatch.delenv(perf.cache.ENV_VAR, raising=False)
        assert perf.ensure_persistent_cache() is None
        assert build.cache_setting() == (build.DEFAULT_CACHE_DIR, False)
        monkeypatch.setenv(perf.cache.ENV_VAR, str(tmp_path / "env"))
        assert perf.ensure_persistent_cache() == str(tmp_path / "env")
        # a directory configured in the process wins over a later env
        monkeypatch.setenv(perf.cache.ENV_VAR, str(tmp_path / "other"))
        assert perf.ensure_persistent_cache() == str(tmp_path / "env")

    def test_default_is_the_repository_build_dir(self):
        root = Path(__file__).resolve().parents[1]
        assert Path(perf.cache.DEFAULT_CACHE_DIR) == root / "build"

    def test_cache_entries_ignores_sidecars(self, tmp_path):
        for name in ("a-1.o", "librepro_torch_x.so", ".a-2.o.tmp.7",
                     "b.o.tmp.3", "notes.txt", ".hidden.o"):
            (tmp_path / name).write_bytes(b"x")
        assert perf.cache_entries(str(tmp_path)) == 2
        assert perf.cache_entries(str(tmp_path / "absent")) == 0


class TestTraceHarness:
    def test_trace_writes_profile(self, tmp_path):
        d = str(tmp_path / "tr")
        with perf.trace(d) as out:
            assert out == d
            with perf.annotate("bench:test"):
                torch.ones(32, 32) @ torch.ones(32, 32)
        runs = perf.profiling.trace_runs(d)
        assert len(runs) == 1
        [path] = glob.glob(os.path.join(runs[0], "*.json"))
        events = json.load(open(path))["traceEvents"]
        assert any(e.get("name") == "bench:test" for e in events)

    def test_trace_disabled_is_noop(self, tmp_path):
        d = str(tmp_path / "tr")
        with perf.trace(d, enabled=False) as out:
            assert out is None
        assert not os.path.exists(d)

    def test_default_dir(self):
        assert perf.profiling.DEFAULT_TRACE_DIR == os.path.join(
            "results", "traces")


class TestTuners:
    def test_enc_rows_install_and_restore(self):
        assert K.enc_rows() == K.ENC_ROWS == 8
        K.set_enc_rows(4)
        try:
            assert K.enc_rows() == 4
        finally:
            K.set_enc_rows(None)
        assert K.enc_rows() == K.ENC_ROWS
        with pytest.raises(ValueError):
            K.set_enc_rows(0)

    def test_k1_plan_consults_the_override(self):
        m, k, n = 4, 1600, 6482
        want = MM.k1_plan(m, k, n, 8)
        key = MM.mm_key(m, k, n, 8)
        assert key == (16, k, n, 8) and MM.mm_key(20, k, n, 8)[0] == 32
        MM.set_mm_cols((256, 3), key=key)
        try:
            got = MM.k1_plan(m, k, n, 8)
            assert got.tile_n == 256 and got.grid[2] == 3
            assert got.grid[0] == -(-n // 256)
            # the slices cover K in whole 32-row units, in order
            assert got.slices[0][0] == 0 and got.slices[-1][1] == k
            assert got.k_slice % MM.TC_SLICE_ROWS == 0
            assert got.workspace == 3 * m * n
            # another shape keeps its own plan
            assert MM.k1_plan(8, k, n, 8) == MM.k1_plan(8, k, n, 8)
            assert MM.k1_plan(m, k, n, 4) != got
        finally:
            MM.set_mm_cols(None, key=key)
        assert MM.k1_plan(m, k, n, 8) == want
        with pytest.raises(ValueError):
            MM.set_mm_cols((64, 1), key=key)

    def test_slice_candidates_hold_the_planned_count(self):
        for m, k, n in ((4, 4096, 11008), (4, 1600, 6482), (32, 64, 128)):
            plan = MM.k1_plan(m, k, n, 8)
            cands = AT.slice_candidates(m, k, n, 8)
            assert plan.grid[2] in cands and 1 in cands
            assert cands == sorted(set(cands))

    def test_tuners_refuse_the_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA device"):
            AT.tune_enc_rows(iters=1, numel=64)
        with pytest.raises(RuntimeError, match="CUDA device"):
            AT.tune_mm_cols(iters=1, m=4, k=64, n=64)
        with pytest.raises(RuntimeError, match="CUDA device"):
            AT.tune_exchange_buckets(None, None, None, None)

    def test_tune_enc_rows_restores_when_not_installed(self, monkeypatch):
        monkeypatch.setattr(AT, "_card", lambda device=None: "card")
        monkeypatch.setattr(AT, "_time_roundtrip",
                            lambda spec, numel, iters, device:
                            abs(K.enc_rows() - 4) + 1.0)
        res = AT.tune_enc_rows(install=False)
        assert res["best"] == 4 and set(res["timings_s"]) == \
            set(AT.CANDIDATE_ROWS) and not res["installed"]
        assert K.enc_rows() == K.ENC_ROWS
        K.set_enc_rows(2)
        try:
            res = AT.tune_enc_rows(candidates=(4, 16), install=False)
            assert K.enc_rows() == 2       # the previous override is back
            res = AT.tune_enc_rows(candidates=(4, 16))
            assert K.enc_rows() == 4 and res["installed"]
        finally:
            K.set_enc_rows(None)

    def test_tune_mm_cols_restores_when_not_installed(self, monkeypatch):
        m, k, n = 4, 1600, 6482
        monkeypatch.setattr(AT, "_card", lambda device=None: "card")
        monkeypatch.setattr(AT, "k1_operands",
                            lambda *a, **kw: (None, None, None))

        def timed(fn, reps=20, replays=5):
            plan = MM.k1_plan(m, k, n, 8)
            return plan.grid[2] + (0.5 if plan.tile_n == 128 else 0.0)
        monkeypatch.setattr(AT, "graph_seconds", timed)
        key = MM.mm_key(m, k, n, 8)
        res = AT.tune_mm_cols(m=m, k=k, n=n, install=False)
        assert res["best"] == (256, 1) and res["key"] == key
        plan = MM.k1_plan(m, k, n, 8)
        assert res["default"] == (plan.tile_n, plan.grid[2])
        assert {t for t, _ in res["timings_s"]} == set(MM.TC_TILE_N)
        assert key not in MM._MM_COLS_OVERRIDE
        res = AT.tune_mm_cols(m=m, k=k, n=n)
        try:
            assert MM._MM_COLS_OVERRIDE[key] == (256, 1)
            assert MM.k1_plan(m, k, n, 8).grid[2] == 1
        finally:
            MM.set_mm_cols(None, key=key)
