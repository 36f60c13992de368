"""The harness: cells found by name, a cell made of data alone, the check
that decides ``correct`` and the faults it has to catch, and what the
benchmark may not import.

CPU tests at tiny shapes; those marked ``cuda`` need the card and skip
without one. Run with ``python -m pytest perfbench/tests``.
"""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import control, frames, harness, judge, reference, roofline, spec, trace  # noqa: E402

BENCH = os.path.join(ROOT, "BENCHMARK.json")
NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$"


def _bench():
    with open(BENCH) as f:
        return json.load(f)


def _throwaway_root(tmp, dense=False, share=1.0, **sizes):
    """A checkout of its own: the benchmark's shared files, and one cell,
    ``tiny.mix``, made of a new configuration file, a new traffic file and
    new entries in a BENCHMARK.json."""
    src = os.path.join(ROOT, "perfbench")
    dst = os.path.join(tmp, "perfbench")
    for d in ("metrics", "passes", "spans"):
        shutil.copytree(os.path.join(src, d), os.path.join(dst, d))
    shutil.copy(os.path.join(src, "limits.json"), os.path.join(dst, "limits.json"))
    os.makedirs(os.path.join(dst, "configs"))
    os.makedirs(os.path.join(dst, "traffic"))
    cfg = {"shape": [24, 32, 40], "ncells": 30, "background": 1,
           "dtype": "uint16", "voxelsize": [2.0, 0.5, 0.5]}
    cfg.update(sizes)
    traffic = {"pass": "resident", "frames": 3, "warmup": 1, "checked_share": share,
               "dense_block": ({"z": [8, 16], "y": [16, 32], "x": [0, 32], "fresh": 4096}
                               if dense else None)}
    with open(os.path.join(dst, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dst, "traffic", "mix.json"), "w") as f:
        json.dump(traffic, f)
    b = _bench()
    b["configs"] = [{"name": "tiny", "source": "a test", "file": "perfbench/configs/tiny.json",
                     "reduced": [], "why": "a test"}]
    b["workloads"] = [{"name": "tiny.mix", "config": "tiny", "traffic": "mix", "chips": 1,
                       "why": "a test"}]
    for m in b["per_layer"]:
        m["workloads"] = ["tiny.mix"]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return tmp


def _run(root, device="cpu", traced=False, wrap=None, seed=2**31 + 7, seconds=0.3):
    cell = spec.load_cell("tiny.mix", root)
    return harness.run_cell(cell, seed, seconds, traced, device, time.perf_counter(), wrap=wrap)


# ----------------------------------------------------------- BENCHMARK.json
def test_benchmark_json_keeps_to_its_contract():
    import re

    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(re.match(NAME, n) for n in names)
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for x in b["configs"] + b["workloads"] + b["per_layer"]:
        for k in ("why", "layer", "source"):
            if k in x:
                assert 1 <= len(x[k]) <= 200 and "\n" not in x[k] and "\t" not in x[k]


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_each_cell_loads_its_files_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["shape"] and c.traffic["frames"] >= 1
    assert {m["name"] for m in c.end_to_end} == {"mvox_s", "peak_mem_gib", "setup_s"}
    assert "pass_p95_ms" in {m["name"] for m in c.per_layer}
    assert callable(spec.load_module("passes", c.traffic["pass"]).make)
    assert spec.load_limits().keys() >= {"passes_wrong", "feature_gap", "inertia_gap"}


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end", "per_layer")
                                    for m in _bench()[k]])
def test_each_metric_has_a_reader(metric):
    assert callable(spec.load_module("metrics", metric).read)


def test_each_span_names_a_function_of_the_program():
    import importlib

    targets = spec.load_spans()
    assert set(targets) >= {"count", "sweep", "flat", "finish", "assemble"}
    for name, target in targets.items():
        mod, attr = target.split(":")
        assert callable(getattr(importlib.import_module(mod), attr)), name


def test_installed_spans_are_undone():
    from tissue_analysis_tpu_torch import engine

    before = engine.fit_dictionary
    with harness.installed_spans({"count": "tissue_analysis_tpu_torch.engine:fit_dictionary",
                                  "finish": "tissue_analysis_tpu_torch.engine:finish_stack"}) as on:
        assert on == ["fit_dictionary", "finish_stack"] and engine.fit_dictionary is not before
    assert engine.fit_dictionary is before


def test_a_span_the_program_lacks_raises_and_undoes_the_others():
    from tissue_analysis_tpu_torch import engine

    before = engine.fit_dictionary
    with pytest.raises(AttributeError, match="no_such_name"):
        with harness.installed_spans({"count": "tissue_analysis_tpu_torch.engine:fit_dictionary",
                                      "gone": "tissue_analysis_tpu_torch.engine:no_such_name"}):
            pass
    assert engine.fit_dictionary is before


def test_pinned_holds_the_thread_and_gives_it_back():
    cores = os.sched_getaffinity(0)
    threads = torch.get_num_threads()
    with harness.pinned():
        assert len(os.sched_getaffinity(0)) == 1 and torch.get_num_threads() == 1
    assert os.sched_getaffinity(0) == cores and torch.get_num_threads() == threads


# ------------------------------------------------------------------ frames
def test_frames_repeat_for_a_seed_and_differ_across_seeds():
    cfg = {"shape": [24, 28, 32], "ncells": 40, "dtype": "uint16"}
    a = frames.make_frame(cfg, {}, 2**31 + 3, 0, "cpu")
    assert np.array_equal(a, frames.make_frame(cfg, {}, 2**31 + 3, 0, "cpu"))
    assert not np.array_equal(a, frames.make_frame(cfg, {}, 2**31 + 3, 1, "cpu"))
    assert not np.array_equal(a, frames.make_frame(cfg, {}, 5, 0, "cpu"))
    assert a.dtype == np.uint16 and a.shape == (24, 28, 32)
    labels = np.unique(a)
    assert labels[0] == 1 and 25 <= labels.size <= 41 and labels.max() <= 41


def test_frame_labels_are_the_nearest_seed():
    shape, n = (12, 10, 14), 9
    got = frames.voronoi_frame(shape, n, 11, "cpu", background=1)
    g = torch.Generator().manual_seed(11)
    pts = torch.stack([torch.randint(0, s, (n,), generator=g) for s in shape], 1).double()
    vox = torch.stack(torch.meshgrid(*[torch.arange(s).double() for s in shape],
                                     indexing="ij"), -1).reshape(-1, 3)
    want = (torch.argmin(((vox[:, None] - pts[None]) ** 2).sum(-1), 1) + 2).reshape(shape)
    c = torch.tensor([(s - 1) / 2 for s in shape], dtype=torch.float64)
    outside = ((vox - c) ** 2).sum(-1).reshape(shape) > (0.95 * min(shape) / 2) ** 2
    want[outside] = 1
    assert torch.equal(got, want.to(torch.int32))


def test_dense_block():
    base = torch.tensor([[[1, 2, 1, 6], [3, 1, 7, 1]]], dtype=torch.int32)
    d = frames.dense_block(base.clone(), ((0, 1), (0, 2), (0, 2)), 4)
    assert d.tolist() == [[[8, 9, 1, 6], [10, 11, 7, 1]]]
    d = frames.dense_block(base.clone(), ((0, 1), (0, 2), (0, 2)), 2)
    assert d.tolist() == [[[8, 8, 1, 6], [9, 9, 7, 1]]]


def test_pass_bytes_count_stack_and_table_alone():
    assert roofline.pass_bytes((512, 512, 512), 2031, 14176) == (
        2 * 512**3 + 2031 * roofline.LABEL_BYTES + 14176 * roofline.PAIR_BYTES)
    assert roofline.pass_bytes((4, 4, 4), 70000, 0) == 4 * 64 + 70000 * roofline.LABEL_BYTES
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_bytes_per_s("cpu") is None


def test_trace_reader_names_gaps_by_span(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pass", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "assemble", "ts": 60, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 25, "dur": 15},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 95, "dur": 10},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    s = trace.read_trace(str(p), ["pass", "assemble"])
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)  # 10-40 and 95-100
    assert s.ops["k_a"] == pytest.approx(25e-6) and s.kernel_s("k_") == pytest.approx(25e-6)
    assert [g[0] for g in s.gaps] == ["assemble", "pass"]
    assert s.gaps[0][1] == pytest.approx(55e-6)


# ------------------------------------------------------- a cell made of data
@pytest.mark.parametrize("dense", [False, True])
def test_a_throwaway_cell_runs_from_files_alone(tmp_path, dense):
    root = _throwaway_root(str(tmp_path), dense=dense, share=0.5)
    res = _run(root)
    # a loaded host may fit a single pass into the window
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= res["checked"] >= 1
    assert set(res["metrics"]) == {"mvox_s", "setup_s"}  # no card: no memory
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    traced = _run(root, traced=True)
    assert traced["correct"] and "breakdown" in traced
    assert {"assemble_ms", "engine_host_ms", "pass_p95_ms"} <= set(traced["metrics"])
    assert ("flat_ms" in traced["metrics"]) == dense
    assert ("combine_ms" in traced["metrics"]) != dense


# ------------------------------------------ faults that the check must catch
class _Fault:
    def __init__(self, program, raw, device):
        self.program, self.raw, self.prev = program, raw, None

    def frame(self, k):
        return self.program.frame(k)

    def voxels(self, k):
        return self.program.voxels(k)

    def close(self):
        self.program.close()


class _Unchanged(_Fault):
    """A step that returns its state unchanged: the previous pass's table."""

    def __call__(self, k):
        t = self.program(k)
        out, self.prev = (self.prev if self.prev is not None else t), t
        return out


class _HalfLeftOut(_Fault):
    """Half of the batch left out: only the first half of the stack's
    planes analysed, its table taken for the whole."""

    def __call__(self, k):
        import dataclasses

        from tissue_analysis_tpu_torch.engine import analyze_stack

        st = self.program.stacks[self.frame(k)]
        half = dataclasses.replace(st, dense=st.dense[: st.shape[0] // 2].contiguous())
        t = analyze_stack(half, engine="auto")
        t.shape = st.shape
        return t


class _Altered(_Fault):
    """An answer altered where it is produced: one face count, one count."""

    def __call__(self, k):
        t = self.program(k)
        if k % 2:
            t.wall_face_counts = t.wall_face_counts.copy()
            t.wall_face_counts[len(t.wall_face_counts) // 2, 1] += 1
        else:
            t.count = t.count.copy()
            t.count[-1] += 1
        return t


class _AlteredOnce(_Fault):
    """One pass of the window, not the first of its frame, with one count
    altered: no share of the window is drawn, so only the comparison with
    the frame's first table can find it."""

    def __call__(self, k):
        t = self.program(k)
        if k == 4:
            t.count = t.count.copy()
            t.count[0] += 1
        return t


@pytest.mark.parametrize("fault", [_Unchanged, _HalfLeftOut, _Altered, _AlteredOnce])
def test_each_fault_makes_the_run_incorrect(tmp_path, fault):
    root = _throwaway_root(str(tmp_path), share=0.0)
    res = _run(root, wrap=fault)
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["passes_wrong"]["value"] >= 1


def test_same_integers_sees_any_integer_field():
    img = np.ones((5, 5, 5), dtype=np.uint16)
    img[1:3, 1:4, 1:4] = 2
    r = reference.reference_table(img, (1.0, 1.0, 1.0), 1, "cpu")
    t = control.ControlTable(r, np.float64)
    assert judge.same_integers(t, control.ControlTable(r, np.float64))
    for field in judge.INT_FIELDS + ("wall_face_counts",):
        u = control.ControlTable(r, np.float64)
        setattr(u, field, np.asarray(getattr(u, field)).copy())
        getattr(u, field).flat[-1] += 1
        assert not judge.same_integers(t, u), field


def test_the_control_is_not_correct(tmp_path):
    """The reference with float32 sums in the program's place, at a size
    whose sums pass 2²⁴."""
    root = _throwaway_root(str(tmp_path))
    cell = spec.load_cell("tiny.mix", root)
    cell.config.update(shape=[64, 64, 64], ncells=6)
    res = harness.run_cell(cell, 3, 0.2, False, "cpu", time.perf_counter(),
                           wrap=control.control_pass(cell.config))
    assert not res["correct"]
    assert res["checks"]["label_rows_wrong"]["value"] > 0


def test_judge_counts_rows_and_gaps():
    img = np.ones((6, 6, 6), dtype=np.uint16)
    img[1:3, 1:4, 1:5] = 2
    img[3:5, 1:4, 1:5] = 3
    r = reference.reference_table(img, (1.0, 1.0, 1.0), 1, "cpu", slab=2)
    t = control.ControlTable(r, np.float64)
    limits = spec.load_limits()
    checks, wrong = judge.judge([(0, t), (0, t)], [r], limits)
    assert wrong == 0 and all(v <= lim for v, lim in checks.values())
    r2 = reference.reference_table(img, (1.0, 1.0, 1.0), 1, "cpu", slab=2)
    r2.s1[2, 0] += 1
    t2 = control.ControlTable(r2, np.float64)
    t2.pair_hi = t2.pair_hi[:-1]
    t2.pair_lo = t2.pair_lo[:-1]
    t2.wall_face_counts = t2.wall_face_counts[:-1]
    checks, wrong = judge.judge([(0, t), (0, t2)], [r], limits)
    assert wrong == 1
    assert checks["label_rows_wrong"][0] == 1 and checks["pair_rows_wrong"][0] == 1
    assert checks["feature_gap"][0] > limits["feature_gap"]


# --------------------------------------------------------------- isolation
def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(glob.glob(os.path.join(ROOT, "perfbench", "**", "*.py"), recursive=True))
REFERENCE_SIDE = ("reference.py", "judge.py", "frames.py", "roofline.py", "trace.py")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = set(_imports(path)) & set(spec.BLOCKED_MODULES)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_the_reference_side_imports_nothing_of_the_program(name):
    found = set(_imports(os.path.join(ROOT, "perfbench", name)))
    assert "tissue_analysis_tpu_torch" not in found
    assert "tissue_analysis_tpu_torch" not in open(os.path.join(ROOT, "perfbench", name)).read()


def test_top_level_names_are_compared_whole(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import tissue_analysis_tpu_torch.engine\nfrom jax_free import x\n")
    assert set(_imports(str(p))) == {"tissue_analysis_tpu_torch", "jax_free"}
    assert not set(_imports(str(p))) & set(spec.BLOCKED_MODULES)


def test_the_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import perfbench.harness, perfbench.control, "
            "tissue_analysis_tpu_torch.engine; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tissue_analysis_tpu')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"), "--workload",
         "meristem-512.resident", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


# ---------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_frame_labels_on_the_card_are_the_nearest_seed(card):
    """The card draws other seed points than the CPU for one seed; its
    labels are still each voxel's nearest seed, and repeat."""
    shape, n, seed = (40, 48, 56), 60, 9
    got = frames.voronoi_frame(shape, n, seed, card).cpu()
    assert torch.equal(got, frames.voronoi_frame(shape, n, seed, card).cpu())
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    pts = torch.stack([torch.randint(0, s, (n,), generator=g, device=card) for s in shape],
                      1).cpu().double()
    vox = torch.stack(torch.meshgrid(*[torch.arange(s).double() for s in shape],
                                     indexing="ij"), -1).reshape(-1, 3)
    want = (torch.argmin(((vox[:, None] - pts[None]) ** 2).sum(-1), 1) + 2).reshape(shape)
    c = torch.tensor([(s - 1) / 2 for s in shape], dtype=torch.float64)
    want[((vox - c) ** 2).sum(-1).reshape(shape) > (0.95 * min(shape) / 2) ** 2] = 1
    assert torch.equal(got, want.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_a_throwaway_cell_is_correct_on_the_card(tmp_path, card, dense):
    # more labels than the first dictionary size (32), so that the count runs
    root = _throwaway_root(str(tmp_path), dense=dense, shape=[32, 48, 128], ncells=300)
    res = _run(root, device=card, traced=True)
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert "count_ms" in res["metrics"] and res["metrics"]["pass_roofline_pct"]["value"] < 100
    assert ("flat_ms" in res["metrics"]) == dense and ("sweep_ms" in res["metrics"]) != dense


@pytest.mark.cuda
def test_run_refuses_in_a_checkout_without_the_program(tmp_path, card):
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "meristem-512.resident",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
