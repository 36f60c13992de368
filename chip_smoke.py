#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc::

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. device: the card's name and ``nvidia-smi`` name / power limit;
2. build: nvcc compiles ``tissue_analysis_tpu_torch/csrc/block_sweep.cu``;
3. kernel vs plain version on the card, ``torch.equal`` on every output:
   a 64³ stack, the 512³ stack in uint16 and the same stack in int32; and
   the 64³ table on the card vs the table on the CPU;
4. main path at full size: ``voronoi_stack((512,)*3, 3500, seed=1)`` →
   ``LabeledStack.from_array(device="cuda")`` → ``analyze_stack`` →
   ``graph_from_table``, checked for kernel launches, the stack's label and
   wall counts, and field-by-field equality with the plain version's table;
5. timing: two warmups, best of 5, fenced with ``torch.cuda.synchronize``.

The last lines are a JSON record of the kernels, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SIZE = 512
NCELLS = 3500
SEED = 1
EXPECT_LABELS = 2031
EXPECT_PAIRS = 14176
FIELDS = (
    "ids", "count", "s1", "s2", "cmin", "cmax",
    "pair_lo", "pair_hi", "wall_face_counts", "margin",
)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def best_of(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def compare_sweeps(k, r) -> int:
    """torch.equal on every output; returns the max abs difference (0)."""
    import torch

    if bool(r.ovf.any()):
        raise AssertionError("dictionary overflow in a comparison case")
    err = 0
    for name in k._fields:
        a, b = getattr(k, name), getattr(r, name)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
        err = max(err, diff)
        if not torch.equal(a, b):
            raise AssertionError(f"kernel and plain version differ in {name} (max |diff| {diff})")
    return err


def tables_equal(a, b, what: str) -> None:
    import numpy as np

    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: field {f} differs")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack
    from tissue_analysis_tpu_torch.engine import analyze_stack
    from tissue_analysis_tpu_torch.graph.from_image import graph_from_table
    from tissue_analysis_tpu_torch.ops.block_sweep import (
        block_sweep,
        block_sweep_reference,
        build_kernel,
    )
    from tissue_analysis_tpu_torch.utils import timing

    # ---- 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1] device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    build_kernel()
    log(f"[2] build: block_sweep.cu compiled and loaded in {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernel vs plain version on the card
    t0 = time.perf_counter()
    img = voronoi_stack((SIZE,) * 3, NCELLS, seed=SEED)
    t_gen = time.perf_counter() - t0
    small = voronoi_stack((64,) * 3, 150, seed=0)
    st64 = LabeledStack.from_array(small, background=1, device="cuda")
    max_err = compare_sweeps(
        block_sweep(st64.dense, st64.n_labels),
        block_sweep_reference(st64.dense, st64.n_labels),
    )
    cpu64 = analyze_stack(LabeledStack.from_array(small, background=1))
    tables_equal(cpu64, analyze_stack(st64), "64^3 cuda vs cpu table")
    stack = LabeledStack.from_array(img, background=1, device="cuda")
    dense16 = stack.dense
    dense32 = dense16.to(torch.int32)
    n = stack.n_labels
    for dense in (dense16, dense32):
        max_err = max(max_err, compare_sweeps(
            block_sweep(dense, n), block_sweep_reference(dense, n)
        ))
    sync()
    log(f"[3] kernel == plain version on the card: 64^3, {SIZE}^3 uint16, "
        f"{SIZE}^3 int32 (max |diff| {max_err}); 64^3 table cuda == cpu "
        f"(stack generated in {t_gen:.1f} s)")

    # ---- 4. the main path at full size, through the kernel
    block_sweep.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stack = LabeledStack.from_array(img, background=1, device="cuda")
    table = analyze_stack(stack)
    graph = graph_from_table(table)
    sync()
    t_first = time.perf_counter() - t0
    launches = block_sweep.launches
    peak_cuda = torch.cuda.max_memory_allocated()
    if launches < 1:
        raise AssertionError("the main path did not launch the block_sweep kernel")
    if (table.n_labels, table.n_pairs) != (EXPECT_LABELS, EXPECT_PAIRS):
        raise AssertionError(
            f"expected {EXPECT_LABELS} labels / {EXPECT_PAIRS} walls, got "
            f"{table.n_labels} / {table.n_pairs}"
        )
    torch.cuda.reset_peak_memory_stats()
    plain = analyze_stack(stack, engine="torch")
    peak_plain = torch.cuda.max_memory_allocated()
    tables_equal(plain, table, f"{SIZE}^3 cuda vs plain table")
    if int(table.count.sum()) != SIZE ** 3:
        raise AssertionError("voxel counts do not cover the stack")
    vol = np.asarray(list(graph.vertex_property("volume").values()))
    bary = np.stack(list(graph.vertex_property("barycenter").values()))
    if graph.nb_vertices() != EXPECT_LABELS - 1 or graph.nb_edges() < 1:
        raise AssertionError(f"graph has {graph.nb_vertices()} vertices")
    if not (np.isfinite(vol).all() and np.isfinite(bary).all() and (vol > 0).all()):
        raise AssertionError("non-finite or empty vertex features")
    log(f"[4] main path: {launches} kernel launch(es), {table.n_labels} labels, "
        f"{table.n_pairs} walls, graph {graph.nb_vertices()} vertices / "
        f"{graph.nb_edges()} edges, table == plain version's; first pass "
        f"{t_first:.3f} s; peak device memory {peak_cuda / 2**30:.2f} GiB "
        f"(plain engine {peak_plain / 2**30:.2f} GiB)")

    # ---- 5. timing
    vox = SIZE ** 3
    t_kernel = best_of(lambda: block_sweep(dense16, n))
    t_plain = best_of(lambda: block_sweep_reference(dense16, n))
    t_analyze = best_of(lambda: analyze_stack(stack))
    t_analyze_plain = best_of(lambda: analyze_stack(stack, engine="torch"))
    t_graph = best_of(lambda: graph_from_table(table))
    t_whole = best_of(lambda: graph_from_table(analyze_stack(
        LabeledStack.from_array(img, background=1, device="cuda"))))
    for name, t in (
        ("block_sweep kernel", t_kernel),
        ("block_sweep plain", t_plain),
        ("analyze_stack cuda", t_analyze),
        ("analyze_stack plain", t_analyze_plain),
        ("graph_from_table", t_graph),
        ("whole pass (ingest+analyze+graph)", t_whole),
    ):
        log(f"[5] {name:<36s} {t * 1e3:10.3f} ms  {vox / t / 1e6:10.1f} Mvox/s")
    # one more whole pass, split by stage (each stage fenced on the card)
    with timing.collect() as stages:
        graph_from_table(analyze_stack(
            LabeledStack.from_array(img, background=1, device="cuda")))
    log("[5] stages of one whole pass: " + "; ".join(
        f"{s.name} {s.seconds * 1e3:.3f} ms" for s in stages.stages))

    print(json.dumps({"kernels": [{
        "name": "block_sweep",
        "route": "cuda",
        "source": "tissue_analysis_tpu_torch/csrc/block_sweep.cu",
        "replaces": "tissue_analysis_tpu/ops/pallas_block.py:830",
        "launches": launches,
        "max_abs_err": float(max_err),
        "ms": t_kernel * 1e3,
        "plain_ms": t_plain * 1e3,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
