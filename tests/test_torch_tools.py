"""The port's tools around the engine: the profiler hook, the host profile,
the example and the benchmark script.

Each runs on the CPU at a small size. The example's printed numbers are held
against the JAX example's (same ``--size 32 --frames 2``; integers equal,
floats to 1e-9 relative); the three scripts also run in a subprocess where
``import jax`` fails, and the benchmark must refuse to run without a CUDA
device unless it is given ``--device cpu``.
"""

import importlib.util
import json
import os
import re
import runpy
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_FIELDS = (
    "metric", "value", "unit", "wall_s", "end_to_end_s", "relabel_s", "transfer_s",
    "pass_s", "end_to_end_raw_s", "raw_transfer_s", "raw_pass_s", "end_to_end_mvox_s",
    "reps", "launches", "device", "power_limit",
)
PROFILE_LINES = (
    "readback mom", "readback cmin", "readback cmax", "readback pkey", "readback ptotal",
    "decode_pairs", "counts3[inv, ax] = total", "_margin_from_bbox", "FeatureTable build",
    "engine.assemble_table", "graph_from_table (cold", "graph_from_table (warm",
    "property: volume", "property: barycenter", "property: boundingbox",
    "property: border", "property: L1", "property: inertia_axis",
    "property: epidermis_surface", "property: wall_surface", "topology only",
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores (several threads each oversubscribe them badly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(relpath):
    """Import a script of the repository by its path."""
    name = os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ profile_trace
def test_profile_trace_writes_a_loadable_trace(tmp_path):
    log_dir = tmp_path / "traces" / "run"  # created by the hook
    threads = torch.get_num_threads()
    with timing.collect() as outer:
        with timing.profile_trace(str(log_dir)) as prof:
            assert prof.trace_path is None  # written on exit
            x = torch.arange(1000).sum()
        with timing.stage("after"):
            pass
    assert int(x) == 499500
    assert prof.trace_path == str(log_dir / "trace_0000.json")
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) >= 1
    assert any("sum" in e.key for e in prof.key_averages())
    assert timing.device_times(prof) == []  # no card: host entries only
    # nothing global is left changed: the profiler is off, the active stage
    # collector and the thread count are what they were
    assert not torch.autograd._profiler_enabled()
    assert [s.name for s in outer.stages] == ["after"]
    assert torch.get_num_threads() == threads
    # a second trace of the same directory takes the next name
    with timing.profile_trace(str(log_dir)) as prof2:
        torch.ones(3) + 1
    assert prof2.trace_path == str(log_dir / "trace_0001.json")
    assert sorted(os.listdir(log_dir)) == ["trace_0000.json", "trace_0001.json"]


def test_profile_trace_around_the_engine_and_a_failure(tmp_path, small3d):
    with timing.profile_trace(str(tmp_path)) as prof:
        table = engine.analyze(small3d, background=1, device="cpu")
    plain = engine.analyze(small3d, background=1, device="cpu")
    np.testing.assert_array_equal(table.count, plain.count)
    np.testing.assert_array_equal(table.wall_face_counts, plain.wall_face_counts)
    assert any(e.key == "aten::index_add_" for e in prof.key_averages())
    # a failing scope still stops the profiler, writes its trace and raises
    with pytest.raises(KeyError):
        with timing.profile_trace(str(tmp_path)) as bad:
            raise KeyError("boom")
    assert os.path.exists(bad.trace_path) and bad.trace_path != prof.trace_path
    assert not torch.autograd._profiler_enabled()


def test_profile_trace_is_exported():
    assert "profile_trace" in timing.__all__
    # the profiler is imported inside the function, not with the module
    with open(timing.__file__) as f:
        assert not re.search(r"^(import|from) torch\.profiler", f.read(), flags=re.M)


# ------------------------------------------------------------- host profile
def test_host_profile_prints_every_stage(capsys):
    hp = _load("scripts/torch_host_profile.py")
    results = hp.main(["300", "900", "--device", "cpu", "--reps", "2"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("host profile: 300 labels, 900 keys")
    assert "views, not copies" in lines[0]
    for want in PROFILE_LINES:
        hit = [ln for ln in lines if want in ln]
        assert len(hit) == 1, want
        assert re.search(r"\s\d+\.\d\d ms$", hit[0]), hit[0]
    assert "n_pairs=300" in out
    assert len(results) == len(PROFILE_LINES) and all(v >= 0 for v in results.values())


@pytest.mark.parametrize("n,n_keys,kpw", [(300, 900, 3), (500, 1200, 1), (40, 2340, 3)])
def test_host_profile_synthetic_finished_assembles(n, n_keys, kpw):
    hp = _load("scripts/torch_host_profile.py")
    image, fin = hp.synthetic_finished(n, n_keys, kpw, (64, 64, 128), torch.device("cpu"))
    assert fin.mom.dtype == torch.int64 and tuple(fin.mom.shape) == (n, 10)
    assert fin.cmin.dtype == fin.cmax.dtype == torch.int32
    assert tuple(fin.cmin.shape) == tuple(fin.cmax.shape) == (n, 3)
    assert fin.pkey.dtype == fin.ptotal.dtype == torch.int64
    assert fin.pkey.shape[0] == n_keys == fin.ptotal.shape[0]
    assert bool((fin.pkey[1:] > fin.pkey[:-1]).all())  # sorted and unique
    table = engine.assemble_table(image, fin)
    assert table.n_labels == n and table.n_pairs == n_keys // kpw
    keys = table.pair_keys()
    assert np.all(keys[1:] > keys[:-1])  # pairs ascending and unique
    assert np.all(table.pair_lo < table.pair_hi) and int(table.pair_hi.max()) < n
    assert np.all((table.wall_face_counts > 0).sum(axis=1) == kpw)
    assert int(table.wall_face_counts.sum()) == int(fin.ptotal.sum())
    assert np.all(table.cmax < np.asarray(image.shape)) and np.all(table.cmin >= 0)


def test_host_profile_presets_are_the_smoke_stacks():
    hp = _load("scripts/torch_host_profile.py")
    assert {k: v[:2] for k, v in hp.PRESETS.items()} == {
        "voronoi-512": (2031, 14176),
        "grid8": (262144, 774144),
        "grid4": (524288, 1552384),
    }


# ------------------------------------------------------------------ example
_NUM = r"[-+]?\d+(?:\.\d+)?"


def _example_numbers(out: str) -> dict:
    """The numbers of the example's printed lines (not its timings)."""
    pats = {
        "cells": rf"^({_NUM}) cells; ({_NUM}) in the L1",
        "largest": rf"^largest cell ({_NUM}): volume ({_NUM}) µm³, ({_NUM}) neighbors",
        "axis": rf"principal axis \[\s*({_NUM})\.?\s+({_NUM})\.?\s+({_NUM})\.?\s*\], "
                rf"eigenvalues \[\s*({_NUM})\s+({_NUM})\s+({_NUM})\s*\]",
        "graph": rf"^graph: ({_NUM}) vertices, ({_NUM}) walls",
        "temporal": rf"^temporal graph: ({_NUM}) vertices over ({_NUM}) timepoints",
        "change": rf"^volume change t0→t1 over ({_NUM}) lineages: mean ({_NUM})",
    }
    got = {}
    for name, pat in pats.items():
        m = re.search(pat, out, flags=re.M)
        assert m, (name, out)
        got[name] = tuple(float(v) for v in m.groups())
    return got


def test_example_numbers_equal_the_jax_example(capsys, monkeypatch):
    argv = ["--size", "32", "--frames", "2"]
    table, graph, tpg = _load("examples/full_pipeline_torch.py").main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["full_pipeline.py"] + argv)
    runpy.run_path(os.path.join(REPO, "examples", "full_pipeline.py"), run_name="__main__")
    jax_out = capsys.readouterr().out
    port, ref = _example_numbers(port_out), _example_numbers(jax_out)
    assert port.keys() == ref.keys()
    for name in port:
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-9, atol=0, err_msg=name)
    assert port["cells"][0] == table.n_labels
    assert port["graph"] == (graph.nb_vertices(), graph.nb_edges())
    assert port["temporal"] == (tpg.nb_vertices(), 2)
    # the same stage lines, engine names aside
    stage = re.compile(r"^(ingest|device sweep|readback|graph|total)", flags=re.M)
    assert len(stage.findall(port_out)) == len(stage.findall(jax_out))
    assert "device: cpu" in port_out


def test_example_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _load("examples/full_pipeline_torch.py").main(["--size", "16"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _load("scripts/torch_host_profile.py").main(["50", "60"])


# -------------------------------------------------------------------- bench
def _bench_env(tmp_path):
    return dict(
        os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", BENCH_SIZE="32",
        BENCH_CELLS="40", BENCH_REPS="1", BENCH_CACHE=str(tmp_path / "cache"),
    )


def test_bench_prints_one_json_line(tmp_path):
    env = _bench_env(tmp_path)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env,
    )
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    rec = json.loads(lines[0])
    for f in BENCH_FIELDS:
        assert f in rec, f
    assert "vs_baseline" not in rec and not any("relay" in k for k in rec)
    assert rec["reps"] == 1 and rec["launches"] == 0 and rec["device"] == "cpu"
    assert rec["unit"] == "Mvoxels/s/chip" and "32^3 stack" in rec["metric"]
    for f in ("wall_s", "end_to_end_s", "relabel_s", "transfer_s", "pass_s",
              "end_to_end_raw_s", "raw_transfer_s", "raw_pass_s"):
        assert rec[f] > 0, f
    assert rec["value"] == pytest.approx(32 ** 3 / rec["wall_s"] / 1e6)
    assert rec["end_to_end_s"] == pytest.approx(
        rec["relabel_s"] + rec["transfer_s"] + rec["pass_s"])
    assert rec["end_to_end_raw_s"] == pytest.approx(rec["raw_transfer_s"] + rec["raw_pass_s"])
    # the generated stack was cached where BENCH_CACHE says
    assert os.listdir(tmp_path / "cache") == ["voronoi_32_40_1.npz"]


def test_bench_takes_an_image_and_skips_the_cache(tmp_path, monkeypatch, capsys, small3d):
    for k, v in _bench_env(tmp_path).items():
        if k.startswith("BENCH_"):
            monkeypatch.setenv(k, v)
    rec = _load("bench_torch.py").main(["--device", "cpu"], img=np.asarray(small3d))
    assert json.loads(capsys.readouterr().out.strip()) == rec
    assert not os.path.exists(tmp_path / "cache")
    ref = engine.analyze(small3d, background=1, device="cpu")
    assert f"{ref.n_labels} labels / {ref.n_pairs} walls" in rec["metric"]


def test_bench_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py")],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=_bench_env(tmp_path),
    )
    assert res.returncode != 0
    assert res.stdout.strip() == ""  # no number of a run that did not happen
    assert "RuntimeError" in res.stderr and 'device="cpu"' in res.stderr


# ------------------------------------------------- no JAX in any of the three
@pytest.mark.parametrize("script,argv,expect", [
    ("examples/full_pipeline_torch.py", ["--size", "24", "--frames", "2", "--device", "cpu"],
     "volume change t0→t1"),
    ("bench_torch.py", ["--device", "cpu"], '"end_to_end_raw_s"'),
    ("scripts/torch_host_profile.py", ["200", "450", "--device", "cpu", "--reps", "1"],
     "topology only"),
], ids=["example", "bench", "host-profile"])
def test_script_runs_with_jax_blocked(tmp_path, script, argv, expect):
    code = textwrap.dedent(
        f"""
        import runpy, sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        sys.argv = [{script!r}] + {argv!r}
        runpy.run_path({os.path.join(REPO, script)!r}, run_name="__main__")
        leaked = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "tissue_analysis_tpu")
            and sys.modules[m] is not None
        )
        assert not leaked, leaked
        print("NO-JAX-OK")
        """
    )
    env = _bench_env(tmp_path)
    del env["PYTHONPATH"]  # each script finds the package from its own path
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path), env=env,
    )
    assert res.returncode == 0, res.stderr
    assert expect in res.stdout
    assert res.stdout.strip().endswith("NO-JAX-OK")
