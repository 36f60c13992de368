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
5. timing: two warmups, best of 5, fenced with ``torch.cuda.synchronize``;
6. a 2D image through the kernel at block (1, 128, 128) (the TPU's
   kernel-v1 path): ``voronoi_stack((4096, 4096), 4000, seed=1)`` through
   the ``SpatialImageAnalysis`` facade on the card, against the plain
   engine (table, kernel outputs and facade queries);
7. a label space past 2¹⁶ (kernel-v1's other path): ``grid_stack((512,)*3,
   (8, 8, 8))``, 262,144 labels in int32, through the dictionary retries
   32 → 64 → 128, against closed-form counts and the plain engine;
8. the 3D facade at 512³ on the card against the same facade on the plain
   engine, and ``neighbors(connectivity=3)`` with its time and peak memory;
9. ``analyze_raw`` at 512³ (no host relabel) against ``analyze``, with the
   stages of both;
10. a dictionary whose [L, 3L] face matrix is past shared memory:
    ``grid_stack((256, 256, 512), (4, 4, 4))``, 524,288 labels in int32,
    through the retries 32 → 64 → 128 → 256 → 512 (6.4 GB of faces), against
    closed-form counts and walls and the plain engine; kernel at L = 512
    against the plain version, and both timed;
11. a time series at BASELINE config 5's size: three 512³ Voronoi frames
    (seeds 1, 2, 3; frames 2 and 3 are generated in two worker processes
    while phase 3 generates frame 1), lineages by max overlap of
    consecutive frames computed on the card, ``analyze_series`` and
    ``temporal_graph_from_images`` on the card against ``analyze_stack``
    per frame and the temporal graph built on the plain engine; the series
    timed against a sequential loop;
12. streaming: the 512³ stack at ``slab_z=128``, and ``TiledSource``
    2×2×2 of it (1024³, 16,241 labels, 113,408 walls), each against the
    plain engine streamed over the same slabs and against the resident
    table of the materialised stack, with times, stages and peak device
    memory of both;
13. the adversarial inputs of ``ops/sweep_cases.py`` (no runs, runs across
    every boundary, ragged, one label, no live label, ids spread over
    n = 70,000, exactly L labels a block and one more, blocks (4, 8, 32)
    and (1, 128, 128)): the kernel against the plain version;
14. z-slab sharding (``parallel.analyze_sharded``) over a mesh of four
    slabs on one card: the 512³ stack (against phase 4's table, the plain
    engine sharded and a host stack sharded), the materialised 1024³
    tiling of phase 12 and grid4 of phase 10 (every slab converging at
    L = 512), with times beside the resident pass and peak memory; the same
    over one slab a card when there are two or more cards;
15. the profiler hook: one converged ``analyze_stack`` of the 512³ stack and
    one of grid4 under ``timing.profile_trace("build/traces")``; the trace
    file exists, the block-sweep kernel is among the device entries, and the
    device time of every other launch (what "combine + pair reduce" is made
    of) is logged, largest first;
16. the host profile: ``scripts/torch_host_profile.py`` at its voronoi-512,
    grid8 and grid4 presets, the readbacks from the card;
17. ``bench_torch.py`` on the 512³ stack already in memory (its JSON line is
    printed, its whole pass beside phase 5's), and
    ``examples/full_pipeline_torch.py --size 64`` on the card against the
    same on the CPU (table, graph and temporal graph equal);
18. the flat engine (``engine="chunked"``: segment sums and a key sort over
    the whole stack, no per-block dictionary; plain PyTorch, no kernel of
    its own): its table against the kernel engine's from phases 4, 6, 7 and
    10 at voronoi-512, 4096² 2D (native, no lift), grid8-512 and grid4, with
    its time, peak device memory, stages and device side beside the kernel
    engine's, its launches under the profiler hook, and two chunk sizes
    timed at voronoi-512 and grid4;
    dense-grid2, ``grid_stack((256, 256, 512), (2, 2, 2))``: 4,194,304
    labels, 2048 a block, past every dictionary (the face counts of L = 2048
    are 103 GB): ``engine="cuda"`` must raise and name the bytes and
    ``engine="chunked"``, ``engine="auto"`` must warn, count one reroute,
    launch no kernel and return the closed-form table (every count 8, 12,500,992 walls of 4
    faces), ``engine="chunked"`` the same; ``analyze_sharded_chunked`` of
    the 512³ stack over four slabs on one card against the resident table.

``engine.reroutes`` is set to 0 at the start and must still be 0 after
phases 3-17 and again at the end of phase 18: every path that asked for the
kernel or the plain block engine took it.

Kernel times are CUDA events over back-to-back launches (20 for the
kernel, 5 for the plain version); whole passes are best of 5 on the host
clock, fenced. Each kernel shape's bound is the larger of its bytes (the
labels read once, the outputs written once) over 3.35 TB/s and its integer
operations over 67 TOP/s (the H100 SXM's non-tensor rate), from this run's
shapes.

Every path is driven with the launch count set to 0 just before it and read
just after. The last lines are a JSON record of the kernels, the
``nvidia-smi`` line and ``{"ok": true, "device": {...}}``. It imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

SIZE = 512
NCELLS = 3500
SEED = 1
EXPECT_LABELS = 2031
EXPECT_PAIRS = 14176
SIZE_2D, NCELLS_2D = 4096, 4000
EXPECT_LABELS_2D, EXPECT_PAIRS_2D = 2933, 8773
GRID_CELL = 8
EXPECT_LABELS_GRID = (SIZE // GRID_CELL) ** 3  # 262,144
EXPECT_PAIRS_GRID = 3 * (SIZE // GRID_CELL) ** 2 * (SIZE // GRID_CELL - 1)
# a default block holds 1x2x16 grid cells plus 50 past its far faces: 82
# dictionary labels, so L doubles 32 -> 64 -> 128 (three sweeps)
EXPECT_GRID_LAUNCHES, EXPECT_GRID_L = 3, 128
GRID4_SHAPE, GRID4_CELL = (256, 256, 512), 4
_G4 = tuple(s // GRID4_CELL for s in GRID4_SHAPE)
EXPECT_LABELS_GRID4 = _G4[0] * _G4[1] * _G4[2]  # 524,288
EXPECT_PAIRS_GRID4 = (
    (_G4[0] - 1) * _G4[1] * _G4[2] + _G4[0] * (_G4[1] - 1) * _G4[2]
    + _G4[0] * _G4[1] * (_G4[2] - 1)
)
# a default block holds 2x4x32 cells plus 200 past its far faces: 456
# dictionary labels, so L doubles 32 -> ... -> 512 (five sweeps)
EXPECT_GRID4_LAUNCHES, EXPECT_GRID4_L = 5, 512
DENSE2_SHAPE, DENSE2_CELL = (256, 256, 512), 2
_D2 = tuple(s // DENSE2_CELL for s in DENSE2_SHAPE)
EXPECT_LABELS_DENSE2 = _D2[0] * _D2[1] * _D2[2]  # 4,194,304
EXPECT_PAIRS_DENSE2 = (
    (_D2[0] - 1) * _D2[1] * _D2[2] + _D2[0] * (_D2[1] - 1) * _D2[2]
    + _D2[0] * _D2[1] * (_D2[2] - 1)
)  # 12,500,992
# a default block holds 4x8x64 cells: L doubles 32 -> 1024 (six sweeps), and
# the faces of 2048 blocks at L = 2048 do not fit an 80 GB card
EXPECT_DENSE2_LAUNCHES, EXPECT_DENSE2_FACE_BYTES = 6, 2048 * 2048 * 3 * 2048 * 4
SERIES_SEEDS = (2, 3)  # frames after the seed-1 stack
SLAB_Z = 128
TILES = (2, 2, 2)
EXPECT_LABELS_TILED, EXPECT_PAIRS_TILED = 16241, 113408
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


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call (ms): CUDA events around ``reps``
    back-to-back calls, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    sync()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    sync()
    return t0.elapsed_time(t1) / reps / 1e3


HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor (fp32-class) rate
OPS_PER_VOXEL = 25  # 10 moment adds, 6 products, 6 min/max, 3 face compares


def sweep_bound(dense, block, L) -> dict:
    """The least time the card could take for one sweep of ``dense``: the
    bytes (labels read once; ids, mom, gmin, gmax, faces and ovf written
    once) over the memory rate, or the operations over the integer rate,
    whichever is larger."""
    B = 1
    for s, b in zip(dense.shape, block):
        B *= -(-s // b)
    bytes_ = dense.numel() * dense.element_size() + B * (4 + L * (4 + 80 + 24 + 12 * L))
    ops = OPS_PER_VOXEL * dense.numel()
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return {"bytes": bytes_, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def max_abs_diff(a, b) -> int:
    """max |a - b| over two integer tensors of one shape, in int64, taken in
    chunks of 2^27 elements (faces reach 6.4 GB at grid4's L = 512)."""
    import torch

    a, b = a.reshape(-1), b.reshape(-1)
    m = torch.zeros((), dtype=torch.int64, device=a.device)
    step = 1 << 27
    for i in range(0, a.numel(), step):
        d = a[i:i + step].to(torch.int64) - b[i:i + step].to(torch.int64)
        m = torch.maximum(m, d.abs_().max())
    return int(m)


def compare_sweeps(k, r) -> int:
    """The max abs difference over every kernel output and its plain
    version's; raises unless it is 0."""
    if bool(r.ovf.any()):
        raise AssertionError("dictionary overflow in a comparison case")
    diffs = {}
    for name in k._fields:
        a, b = getattr(k, name), getattr(r, name)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        diffs[name] = max_abs_diff(a, b)
    if any(diffs.values()):
        raise AssertionError(f"kernel and plain version differ (max |diff| per output {diffs})")
    return max(diffs.values())


def tables_equal(a, b, what: str) -> None:
    import numpy as np

    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: field {f} differs")


def stages_line(stages) -> str:
    return "; ".join(f"{s.name} {s.seconds * 1e3:.3f} ms" for s in stages.stages)


def stage_sums(st) -> str:
    """Stage times summed by name (a streamed or sharded run repeats them)."""
    sums: dict = {}
    for s in st.stages:
        sums[s.name] = sums.get(s.name, 0.0) + s.seconds
    return "; ".join(f"{k} {v * 1e3:.3f} ms" for k, v in sums.items())


def facade_equal(a, b, queries, what: str) -> None:
    """The same facade queries on two analyses give equal results."""
    import numpy as np

    for q in queries:
        x, y = getattr(a, q)(), getattr(b, q)()
        if q == "inertia_axis":
            same = x.keys() == y.keys() and all(
                np.array_equal(x[k][0], y[k][0]) and np.array_equal(x[k][1], y[k][1])
                for k in x
            )
        else:
            same = x == y
        if not same:
            raise AssertionError(f"{what}: {q} differs")


def phase_2d(log_prefix="[6]"):
    """A 2D image through the facade on the card: kernel-v1's block."""
    from tissue_analysis_tpu_torch import SpatialImageAnalysis
    from tissue_analysis_tpu_torch.analysis import AnalysisConfig
    from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack
    from tissue_analysis_tpu_torch.engine import BLOCK_2D, _GOOD_L, analyze_stack
    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep, block_sweep_reference
    from tissue_analysis_tpu_torch.utils import timing

    t0 = time.perf_counter()
    img = voronoi_stack((SIZE_2D, SIZE_2D), NCELLS_2D, seed=SEED)
    t_gen = time.perf_counter() - t0

    block_sweep.launches = 0
    a = SpatialImageAnalysis(img, background=1, device="cuda")
    table = a.table()
    sync()
    launches = block_sweep.launches
    if launches < 1:
        raise AssertionError("the 2D path did not launch the block_sweep kernel")
    if (table.n_labels, table.n_pairs) != (EXPECT_LABELS_2D, EXPECT_PAIRS_2D):
        raise AssertionError(
            f"2D: expected {EXPECT_LABELS_2D} labels / {EXPECT_PAIRS_2D} walls, "
            f"got {table.n_labels} / {table.n_pairs}"
        )
    if int(table.count.sum()) != SIZE_2D ** 2:
        raise AssertionError("2D: pixel counts do not cover the image")
    stack = a.stack()
    tables_equal(analyze_stack(stack, engine="torch"), table, "2D cuda vs plain table")
    lifted = stack.dense[None]
    n = stack.n_labels
    L = _GOOD_L[((1, SIZE_2D, SIZE_2D), n, BLOCK_2D, 32)]
    err = compare_sweeps(
        block_sweep(lifted, n, BLOCK_2D, L), block_sweep_reference(lifted, n, BLOCK_2D, L)
    )
    plain = SpatialImageAnalysis(
        img, background=1, device="cuda", config=AnalysisConfig(background=1, engine="torch")
    )
    facade_equal(a, plain, ("area", "perimeter", "neighbors", "inertia_axis", "L1"),
                 "2D facade cuda vs plain")
    t_k = event_ms(lambda: block_sweep(lifted, n, BLOCK_2D, L))
    t_p = event_ms(lambda: block_sweep_reference(lifted, n, BLOCK_2D, L), reps=5, warmup=1)
    bound = sweep_bound(lifted, BLOCK_2D, L)
    t_whole = best_of(lambda: SpatialImageAnalysis(img, background=1, device="cuda").table())
    with timing.collect() as stages:
        SpatialImageAnalysis(img, background=1, device="cuda").table()
    log(f"{log_prefix} 2D {SIZE_2D}^2: {launches} kernel launch(es) at block {BLOCK_2D}, "
        f"L={L}, {table.n_labels} labels, {table.n_pairs} walls; table, kernel "
        f"(max |diff| {err}) and facade area/perimeter/neighbors/inertia_axis/L1 "
        f"== plain engine's (image generated in {t_gen:.1f} s)")
    log(f"{log_prefix} 2D kernel {t_k * 1e3:.3f} ms (bound {bound['bound_ms']:.3f} ms, "
        f"{smem_line(L)}), plain {t_p * 1e3:.3f} ms; whole facade "
        f"pass (relabel + H2D + analyze) {t_whole * 1e3:.3f} ms "
        f"({SIZE_2D ** 2 / t_whole / 1e6:.1f} Mpix/s)")
    log(f"{log_prefix} stages of one 2D facade pass: {stages_line(stages)}")
    return launches, err, t_k, t_p, bound, (img, table)


def phase_grid(log_prefix="[7]"):
    """262,144 labels (int32) through the dictionary retries."""
    import numpy as np
    import torch

    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack
    from tissue_analysis_tpu_torch.engine import _GOOD_L, analyze_stack
    from tissue_analysis_tpu_torch.ops.block_sweep import (
        DEFAULT_BLOCK, block_sweep, block_sweep_reference,
    )
    from tissue_analysis_tpu_torch.utils import timing

    img = grid_stack((SIZE,) * 3, (GRID_CELL,) * 3)
    stack = LabeledStack.from_array(img, background=None, device="cuda")
    n = stack.n_labels
    if n != EXPECT_LABELS_GRID or stack.dense.dtype != (
        torch.int32 if n > 0xFFFF else torch.uint16
    ):
        raise AssertionError(f"grid: {n} labels in {stack.dense.dtype}")
    _GOOD_L.pop((stack.shape, n, DEFAULT_BLOCK, 32), None)
    block_sweep.launches = 0
    table = analyze_stack(stack)
    sync()
    launches = block_sweep.launches
    L = _GOOD_L[(stack.shape, n, DEFAULT_BLOCK, 32)]
    if (launches, L) != (EXPECT_GRID_LAUNCHES, EXPECT_GRID_L):
        raise AssertionError(
            f"grid: expected {EXPECT_GRID_LAUNCHES} launches up to L={EXPECT_GRID_L}, "
            f"got {launches} up to L={L}"
        )
    if not np.all(table.count == GRID_CELL ** 3):
        raise AssertionError("grid: a cell's voxel count is not 512")
    if table.n_pairs != EXPECT_PAIRS_GRID:
        raise AssertionError(f"grid: {table.n_pairs} walls, expected {EXPECT_PAIRS_GRID}")
    if not np.all(table.wall_face_counts.sum(axis=1) == GRID_CELL ** 2):
        raise AssertionError("grid: a wall's face total is not 64")
    tables_equal(analyze_stack(stack, engine="torch"), table, "grid cuda vs plain table")
    dense = stack.dense
    dense_dtype = str(dense.dtype).replace("torch.", "")
    err = compare_sweeps(
        block_sweep(dense, n, DEFAULT_BLOCK, L), block_sweep_reference(dense, n, DEFAULT_BLOCK, L)
    )
    t_k = event_ms(lambda: block_sweep(dense, n, DEFAULT_BLOCK, L))
    t_p = event_ms(lambda: block_sweep_reference(dense, n, DEFAULT_BLOCK, L), reps=5, warmup=1)
    bound = sweep_bound(dense, DEFAULT_BLOCK, L)
    t_an = best_of(lambda: analyze_stack(stack))
    with timing.collect() as stages:
        analyze_stack(stack)
    log(f"{log_prefix} grid {SIZE}^3 cell {GRID_CELL}^3: {launches} kernel launches "
        f"(up to L={L}), {n} labels {dense_dtype}, {table.n_pairs} walls, every count "
        f"{GRID_CELL ** 3}, every wall 64 faces; table == plain engine's; kernel at "
        f"L={L} == plain version (max |diff| {err})")
    log(f"{log_prefix} grid kernel L={L} {t_k * 1e3:.3f} ms (bound {bound['bound_ms']:.3f} ms, "
        f"{smem_line(L)}), plain {t_p * 1e3:.3f} ms; "
        f"analyze_stack (cuda, converged L) {t_an * 1e3:.3f} ms")
    log(f"{log_prefix} stages of one grid analyze_stack: {stages_line(stages)}")
    return launches, err, t_k, t_p, bound, (img, table)


def smem_line(L) -> str:
    """The kernel's shared memory a CTA at this dictionary size."""
    from tissue_analysis_tpu_torch.ops.block_sweep import build_kernel

    return f"{build_kernel().ta_block_sweep_smem_bytes(L):,} B shared a CTA"


def phase_facade_3d(img, log_prefix="[8]"):
    """The 3D facade at 512³ on the card vs the same on the plain engine."""
    import torch

    from tissue_analysis_tpu_torch import SpatialImageAnalysis
    from tissue_analysis_tpu_torch.analysis import AnalysisConfig
    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep

    block_sweep.launches = 0
    a = SpatialImageAnalysis(img, background=1, device="cuda")
    queries = ("volume", "neighbors", "L1", "border_cells", "wall_surfaces")
    for q in queries:
        getattr(a, q)()
    sync()
    launches = block_sweep.launches
    if launches < 1:
        raise AssertionError("the 3D facade did not launch the block_sweep kernel")
    plain = SpatialImageAnalysis(
        img, background=1, device="cuda", config=AnalysisConfig(background=1, engine="torch")
    )
    facade_equal(a, plain, queries, "3D facade cuda vs plain")
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    nb26 = a.neighbors(connectivity=3)
    sync()
    t_26 = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n26 = sum(len(v) for v in nb26.values()) // 2
    n6 = sum(len(v) for v in a.neighbors().values()) // 2
    if not n26 >= n6 > 0:
        raise AssertionError(f"26-connectivity found {n26} pairs, 6-connectivity {n6}")
    log(f"{log_prefix} 3D facade {SIZE}^3: {launches} kernel launch(es); volume, neighbors, "
        f"L1, border_cells, wall_surfaces == plain engine's; neighbors(connectivity=3) "
        f"{n26} pairs (6-conn {n6}) in {t_26 * 1e3:.3f} ms, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    return launches


def phase_raw(img, log_prefix="[9]"):
    """analyze_raw at 512³ (no host relabel) vs analyze."""
    from tissue_analysis_tpu_torch.engine import analyze, analyze_raw
    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep
    from tissue_analysis_tpu_torch.utils import timing

    block_sweep.launches = 0
    raw = analyze_raw(img, background=1, device="cuda")
    sync()
    launches = block_sweep.launches
    if launches < 1:
        raise AssertionError("analyze_raw did not launch the block_sweep kernel")
    tables_equal(analyze(img, background=1, device="cuda"), raw, "analyze_raw vs analyze")
    t_raw = best_of(lambda: analyze_raw(img, background=1, device="cuda"))
    t_rel = best_of(lambda: analyze(img, background=1, device="cuda"))
    with timing.collect() as st_raw:
        analyze_raw(img, background=1, device="cuda")
    with timing.collect() as st_rel:
        analyze(img, background=1, device="cuda")
    if not any(s.name == "raw-mode host compaction" for s in st_raw.stages):
        raise AssertionError("analyze_raw took the relabel path")
    log(f"{log_prefix} analyze_raw {SIZE}^3: {launches} kernel launch(es), table == "
        f"analyze()'s; whole pass {t_raw * 1e3:.3f} ms vs relabel path {t_rel * 1e3:.3f} ms")
    log(f"{log_prefix} stages, raw: {stages_line(st_raw)}")
    log(f"{log_prefix} stages, relabel: {stages_line(st_rel)}")
    return launches


def same_value(a, b) -> bool:
    """Exact equality of property values (dicts, sequences, arrays)."""
    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_value(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(
            same_value(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def graphs_equal(a, b, what: str) -> None:
    """Vertices, edges (with their ends) and every property of two graphs."""
    if list(a.vertices()) != list(b.vertices()) or list(a.edges()) != list(b.edges()):
        raise AssertionError(f"{what}: vertices or edges differ")
    if any(a.edge_vertices(e) != b.edge_vertices(e) for e in a.edges()):
        raise AssertionError(f"{what}: edge ends differ")
    for kind in ("vertex", "edge", "graph"):
        names = getattr(a, f"{kind}_property_names")()
        if sorted(names) != sorted(getattr(b, f"{kind}_property_names")()):
            raise AssertionError(f"{what}: {kind} property names differ")
        for name in names:
            if not same_value(getattr(a, f"{kind}_property")(name),
                              getattr(b, f"{kind}_property")(name)):
                raise AssertionError(f"{what}: {kind} property {name} differs")


def phase_grid4(log_prefix="[10]"):
    """524,288 labels: a dictionary whose face matrix is past shared memory."""
    import numpy as np
    import torch

    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack
    from tissue_analysis_tpu_torch.engine import _GOOD_L, analyze_stack
    from tissue_analysis_tpu_torch.ops.block_sweep import (
        DEFAULT_BLOCK, block_sweep, block_sweep_reference,
    )
    from tissue_analysis_tpu_torch.utils import timing

    img = grid_stack(GRID4_SHAPE, (GRID4_CELL,) * 3)
    stack = LabeledStack.from_array(img, background=None, device="cuda")
    n = stack.n_labels
    if n != EXPECT_LABELS_GRID4 or stack.dense.dtype != (
        torch.int32 if n > 0xFFFF else torch.uint16
    ):
        raise AssertionError(f"grid4: {n} labels in {stack.dense.dtype}")
    key = (stack.shape, n, DEFAULT_BLOCK, 32)
    _GOOD_L.pop(key, None)
    block_sweep.launches = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    table = analyze_stack(stack)
    sync()
    launches = block_sweep.launches
    peak = torch.cuda.max_memory_allocated() - base
    L = _GOOD_L[key]
    if (launches, L) != (EXPECT_GRID4_LAUNCHES, EXPECT_GRID4_L):
        raise AssertionError(
            f"grid4: expected {EXPECT_GRID4_LAUNCHES} launches up to L={EXPECT_GRID4_L}, "
            f"got {launches} up to L={L}"
        )
    if not 3 * L * L * 4 > 232448:
        raise AssertionError(f"grid4: an [L, 3L] face matrix at L={L} would fit shared memory")
    cell3 = GRID4_CELL ** 3
    if not np.all(table.count == cell3):
        raise AssertionError(f"grid4: a cell's voxel count is not {cell3}")
    if table.n_pairs != EXPECT_PAIRS_GRID4:
        raise AssertionError(f"grid4: {table.n_pairs} walls, expected {EXPECT_PAIRS_GRID4}")
    if not np.all(table.wall_face_counts.sum(axis=1) == GRID4_CELL ** 2):
        raise AssertionError("grid4: a wall's face total is not 16")
    tables_equal(analyze_stack(stack, engine="torch"), table, "grid4 cuda vs plain table")
    dense = stack.dense
    err = compare_sweeps(
        block_sweep(dense, n, DEFAULT_BLOCK, L), block_sweep_reference(dense, n, DEFAULT_BLOCK, L)
    )
    t_k = event_ms(lambda: block_sweep(dense, n, DEFAULT_BLOCK, L))
    t_p = event_ms(lambda: block_sweep_reference(dense, n, DEFAULT_BLOCK, L), reps=5, warmup=1)
    bound = sweep_bound(dense, DEFAULT_BLOCK, L)
    t_an = best_of(lambda: analyze_stack(stack))
    with timing.collect() as stages:
        analyze_stack(stack)
    log(f"{log_prefix} grid {GRID4_SHAPE} cell {GRID4_CELL}^3: {launches} kernel launches "
        f"(up to L={L}), {n} labels {str(dense.dtype)[6:]}, "
        f"{table.n_pairs} walls, every "
        f"count {cell3}, every wall 16 faces; table == plain engine's; kernel at L={L} "
        f"== plain version (max |diff| {err}); the first analyze_stack took "
        f"{peak / 2**30:.2f} GiB of device memory at its peak (above the stack)")
    log(f"{log_prefix} grid4 kernel L={L} {t_k * 1e3:.3f} ms (bound {bound['bound_ms']:.3f} ms, "
        f"{smem_line(L)}), plain {t_p * 1e3:.3f} ms; "
        f"analyze_stack (cuda, converged L) {t_an * 1e3:.3f} ms")
    log(f"{log_prefix} stages of one grid4 analyze_stack: {stages_line(stages)}")
    return launches, err, t_k, t_p, bound, (img, table)


def _voronoi_frame(shape, ncells: int, seed: int):
    """One series frame (run in a worker process)."""
    import numpy as np

    from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack

    t0 = time.perf_counter()
    img = np.asarray(voronoi_stack(shape, ncells, seed=seed))
    return img, time.perf_counter() - t0


def max_overlap_lineage(a, b, background: int = 1) -> dict:
    """{mother: [daughters]}: each label of frame b (not the background)
    descends from the label of frame a it overlaps most (ties: the smaller
    label), computed on the card."""
    import numpy as np
    import torch

    ta = torch.from_numpy(np.asarray(a).astype(np.int64)).cuda().reshape(-1)
    tb = torch.from_numpy(np.asarray(b).astype(np.int64)).cuda().reshape(-1)
    keep = (ta != background) & (tb != background)
    nb = int(tb.max()) + 1
    keys, cnt = torch.unique(ta[keep] * nb + tb[keep], return_counts=True)
    mother, daughter = keys // nb, keys % nb
    order = torch.argsort(mother, stable=True)
    order = order[torch.argsort(-cnt[order], stable=True)]
    order = order[torch.argsort(daughter[order], stable=True)]
    d, m = daughter[order], mother[order]
    first = torch.ones_like(d, dtype=torch.bool)
    first[1:] = d[1:] != d[:-1]
    out: dict = {}
    for mo, da in zip(m[first].tolist(), d[first].tolist()):
        out.setdefault(int(mo), []).append(int(da))
    return out


def phase_series(frames, t_gens, log_prefix="[11]"):
    """Three 512³ frames through analyze_series and the temporal graph."""
    from tissue_analysis_tpu_torch import TemporalPropertyGraph, graph_from_table
    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.engine import analyze_stack
    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep
    from tissue_analysis_tpu_torch.series import analyze_series, temporal_graph_from_images
    from tissue_analysis_tpu_torch.utils import timing

    t0 = time.perf_counter()
    lineages = [max_overlap_lineage(a, b) for a, b in zip(frames, frames[1:])]
    sync()
    t_lin = time.perf_counter() - t0
    block_sweep.launches = 0
    tables = analyze_series(frames, background=1, devices=["cuda"])
    sync()
    launches = block_sweep.launches
    if launches < len(frames):
        raise AssertionError(f"series: {launches} kernel launches for {len(frames)} frames")
    for i, (img, t) in enumerate(zip(frames, tables)):
        ref = analyze_stack(LabeledStack.from_array(img, background=1, device="cuda"))
        tables_equal(ref, t, f"series frame {i} vs analyze_stack")
    block_sweep.launches = 0
    tpg = temporal_graph_from_images(frames, lineages, background=1, devices=["cuda"])
    sync()
    launches_tpg = block_sweep.launches
    if launches_tpg < len(frames):
        raise AssertionError("temporal_graph_from_images did not launch the kernel per frame")
    plain_graphs = [
        graph_from_table(analyze_stack(
            LabeledStack.from_array(img, background=1, device="cuda"), engine="torch"),
            background=1)
        for img in frames
    ]
    plain = TemporalPropertyGraph().extend(plain_graphs, lineages)
    graphs_equal(tpg, plain, "temporal graph cuda vs plain")
    et = tpg.edge_property("edge_type")
    n_lineage = sum(1 for e in tpg.edges() if et[e] == "t")
    if n_lineage != sum(len(d) for m in lineages for d in m.values()):
        raise AssertionError(f"temporal graph: {n_lineage} lineage edges")

    def sequential():
        return [analyze_stack(LabeledStack.from_array(img, background=1, device="cuda"))
                for img in frames]

    t_series = best_of(lambda: analyze_series(frames, background=1, devices=["cuda"]),
                       reps=3, warmup=1)
    t_seq = best_of(sequential, reps=3, warmup=1)
    with timing.collect() as stages:
        analyze_series(frames, background=1, devices=["cuda"])
    labels = [t.n_labels for t in tables]
    log(f"{log_prefix} series of {len(frames)} {SIZE}^3 frames: {launches} kernel launch(es), "
        f"labels {labels}; every frame == analyze_stack; temporal graph "
        f"{tpg.nb_vertices()} vertices / {tpg.nb_edges()} edges ({n_lineage} lineage) == "
        f"plain engine's ({launches_tpg} launches)")
    log(f"{log_prefix} analyze_series (dispatch/collect) {t_series * 1e3:.3f} ms vs sequential "
        f"loop {t_seq * 1e3:.3f} ms; lineages on the card {t_lin * 1e3:.3f} ms; frames "
        f"generated in {', '.join(f'{g:.1f}' for g in t_gens)} s")
    log(f"{log_prefix} stages of one analyze_series: {stages_line(stages)}")
    return launches


def phase_stream(img, log_prefix="[12]"):
    """Streamed 512³ and 1024³ against resident tables."""
    import numpy as np
    import torch

    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.engine import analyze_stack
    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep
    from tissue_analysis_tpu_torch.streaming import TiledSource, analyze_streamed
    from tissue_analysis_tpu_torch.utils import timing

    def run(fn):
        """(result, seconds, peak device bytes above those allocated before,
        stages) of one call; each stage is fenced, so the time includes the
        fences."""
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with timing.collect() as st:
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            dt = time.perf_counter() - t0
        return out, dt, torch.cuda.max_memory_allocated() - base, st

    launches = {}
    results = []
    src = TiledSource(np.asarray(img), TILES, background=1)
    for name, source, materialize in (
        (f"{SIZE}^3", np.asarray(img), lambda: np.asarray(img)),
        (f"{SIZE * TILES[0]}^3 tiled", src, lambda: src.read(0, src.shape[0])),
    ):
        block_sweep.launches = 0
        streamed, t_s, peak_s, st_s = run(
            lambda: analyze_streamed(source, background=1, slab_z=SLAB_Z, device="cuda"))
        launches[name] = block_sweep.launches
        slabs = -(-source.shape[0] // SLAB_Z)
        if launches[name] < slabs:
            raise AssertionError(f"stream {name}: {launches[name]} launches for {slabs} slabs")
        # the plain version on the same slabs: the kernel at this path's
        # shapes (X = 1024 and n = 16,241 for the tiled source)
        plain, t_p, _, _ = run(lambda: analyze_streamed(
            source, background=1, slab_z=SLAB_Z, engine="torch", device="cuda"))
        tables_equal(plain, streamed, f"stream {name} kernel vs plain engine")
        del plain
        t0 = time.perf_counter()
        full = materialize()
        t_mat = time.perf_counter() - t0
        resident, t_r, peak_r, st_r = run(
            lambda: analyze_stack(LabeledStack.from_array(full, background=1, device="cuda")))
        tables_equal(resident, streamed, f"stream {name} vs resident")
        results.append((name, streamed, t_s, peak_s, st_s, t_r, peak_r, st_r, t_mat, slabs, t_p))
        kept = (full, resident)  # the tiled stack's, for phase 14
        del full, resident
    tiled = results[1][1]
    if (tiled.n_labels, tiled.n_pairs) != (EXPECT_LABELS_TILED, EXPECT_PAIRS_TILED):
        raise AssertionError(
            f"tiled: expected {EXPECT_LABELS_TILED} labels / {EXPECT_PAIRS_TILED} walls, got "
            f"{tiled.n_labels} / {tiled.n_pairs}")
    for name, t, t_s, peak_s, st_s, t_r, peak_r, st_r, t_mat, slabs, t_p in results:
        log(f"{log_prefix} stream {name} slab_z={SLAB_Z} ({slabs} slabs, "
            f"{launches[name]} launches): {t.n_labels} labels, {t.n_pairs} walls, table == "
            f"the plain engine streamed and == resident; streamed {t_s * 1e3:.3f} ms (plain "
            f"engine {t_p * 1e3:.3f} ms), peak device memory {peak_s / 2**30:.3f} GiB; resident (relabel + H2D + analyze) {t_r * 1e3:.3f} ms, peak "
            f"{peak_r / 2**30:.3f} GiB (stack materialised in {t_mat:.1f} s; peaks are "
            f"above what earlier phases left allocated)")
        log(f"{log_prefix} stages, streamed {name}: {stage_sums(st_s)}")
        log(f"{log_prefix} stages, resident {name}: {stage_sums(st_r)}")
    return sum(launches.values()), kept


def phase_sharded(stack, table, tiled, grid4, log_prefix="[14]"):
    """z-slab sharding: four slabs on one card (and, with two or more
    cards, one slab a card) at 512³, the materialised 1024³ tiling and
    grid4, each against its resident table. Returns the kernel launches of
    the one-card runs: (uint16 stacks, grid4)."""
    import torch

    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.engine import _GOOD_L, analyze_stack
    from tissue_analysis_tpu_torch.ops.block_sweep import DEFAULT_BLOCK, block_sweep
    from tissue_analysis_tpu_torch.parallel import Mesh, analyze_sharded, make_mesh
    from tissue_analysis_tpu_torch.utils import timing

    def launched(fn):
        block_sweep.launches = 0
        out = fn()
        sync()
        return out, block_sweep.launches

    def peak_of(fn) -> int:
        """Peak bytes of one call above what was allocated before it, on the
        card where that is largest."""
        cards = range(torch.cuda.device_count())
        base = [torch.cuda.memory_allocated(i) for i in cards]
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        fn()
        for i in cards:
            torch.cuda.synchronize(i)
        return max(torch.cuda.max_memory_allocated(i) - b for i, b in zip(cards, base))

    def run_mesh(mesh, label):
        k = len(mesh.devices)
        # ---- voronoi-512: stack on the card, and one on the host (H2D a slab)
        got, l512 = launched(lambda: analyze_sharded(stack, mesh))
        if l512 < k:
            raise AssertionError(f"sharded 512: {l512} kernel launches for {k} slabs")
        tables_equal(table, got, f"sharded 512 ({label}) vs resident")
        tables_equal(analyze_sharded(stack, mesh, engine="torch"), got,
                     f"sharded 512 ({label}) vs plain engine sharded")
        host = LabeledStack.from_numpy(stack.dense.cpu().numpy(), stack.ids, stack.voxelsize,
                                       stack.background_segment, device="cpu")
        tables_equal(table, analyze_sharded(host, mesh), f"sharded 512 ({label}) from the host")
        t_sh = best_of(lambda: analyze_sharded(stack, mesh))
        t_res = best_of(lambda: analyze_stack(stack))
        peak = peak_of(lambda: analyze_sharded(stack, mesh))
        peak_r = peak_of(lambda: analyze_stack(stack))
        with timing.collect() as st:
            analyze_sharded(stack, mesh)
        log(f"{log_prefix} sharded {SIZE}^3 on {label}: {l512} kernel launches, table == "
            f"resident, == plain engine sharded, == sharded from a host stack; "
            f"analyze_sharded {t_sh * 1e3:.3f} ms vs analyze_stack resident "
            f"{t_res * 1e3:.3f} ms; peak device memory on the fullest card "
            f"{peak / 2**30:.3f} GiB (resident {peak_r / 2**30:.3f} GiB) above the stack")
        log(f"{log_prefix} stages, sharded {SIZE}^3 on {label}: {stage_sums(st)}")

        # ---- the 1024^3 tiling, materialised
        full, resident = tiled
        t0 = time.perf_counter()
        big = LabeledStack.from_array(full, background=1, device="cuda")
        sync()
        t_ing = time.perf_counter() - t0
        got, l1024 = launched(lambda: analyze_sharded(big, mesh))
        if l1024 < k:
            raise AssertionError(f"sharded 1024: {l1024} kernel launches for {k} slabs")
        tables_equal(resident, got, f"sharded 1024 ({label}) vs resident")
        if (got.n_labels, got.n_pairs) != (EXPECT_LABELS_TILED, EXPECT_PAIRS_TILED):
            raise AssertionError(f"sharded 1024: {got.n_labels} labels / {got.n_pairs} walls")
        t_sh = best_of(lambda: analyze_sharded(big, mesh), reps=3, warmup=1)
        t_res = best_of(lambda: analyze_stack(big), reps=3, warmup=1)
        peak = peak_of(lambda: analyze_sharded(big, mesh))
        peak_r = peak_of(lambda: analyze_stack(big))
        del big
        log(f"{log_prefix} sharded {SIZE * TILES[0]}^3 tiled on {label}: {l1024} kernel "
            f"launches, {got.n_labels} labels, {got.n_pairs} walls, table == resident; "
            f"analyze_sharded {t_sh * 1e3:.3f} ms vs analyze_stack resident "
            f"{t_res * 1e3:.3f} ms (best of 3); peak device memory on the fullest card "
            f"{peak / 2**30:.3f} GiB (resident {peak_r / 2**30:.3f} GiB) above the stack; "
            f"relabel + H2D "
            f"{t_ing:.1f} s")

        # ---- grid4: every slab converges at L = 512 (the global face path)
        img4, table4 = grid4
        g4 = LabeledStack.from_array(img4, background=None, device="cuda")
        slab = -(-GRID4_SHAPE[0] // (k * DEFAULT_BLOCK[0])) * DEFAULT_BLOCK[0]
        key = ((min(slab, GRID4_SHAPE[0]),) + GRID4_SHAPE[1:], g4.n_labels, DEFAULT_BLOCK, 32)
        _GOOD_L.pop(key, None)
        got, lg4 = launched(lambda: analyze_sharded(g4, mesh))
        slabs = -(-GRID4_SHAPE[0] // slab)
        if (lg4, _GOOD_L[key]) != (slabs * EXPECT_GRID4_LAUNCHES, EXPECT_GRID4_L):
            raise AssertionError(f"sharded grid4: {lg4} launches, converged at L={_GOOD_L[key]}")
        tables_equal(table4, got, f"sharded grid4 ({label}) vs resident")
        t_sh = best_of(lambda: analyze_sharded(g4, mesh), reps=3, warmup=1)
        t_res = best_of(lambda: analyze_stack(g4), reps=3, warmup=1)
        del g4
        log(f"{log_prefix} sharded grid4 on {label}: {lg4} kernel launches ({slabs} slabs, "
            f"L 32 -> {_GOOD_L[key]} each), table == resident; converged analyze_sharded "
            f"{t_sh * 1e3:.3f} ms vs analyze_stack resident {t_res * 1e3:.3f} ms (best of 3)")
        return l512 + l1024, lg4

    launches = run_mesh(Mesh((torch.device("cuda:0"),) * 4), "4 slabs on cuda:0")
    cards = torch.cuda.device_count()
    if cards >= 2:
        run_mesh(make_mesh(), f"{cards} cards, a slab each")
    else:
        log(f"{log_prefix} across cards: not run, this machine has {cards} card; the "
            f"4-slab mesh on cuda:0 above is what ran")
    return launches


def load_script(relpath):
    """Import a script of the repository (beside this file) by its path."""
    here = os.path.dirname(os.path.abspath(__file__))
    name = os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(here, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_profiler(stack, grid4, log_prefix="[15]"):
    """One converged analyze_stack at voronoi-512 and at grid4 under the
    profiler hook; returns the kernel launches of each."""
    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.engine import analyze_stack
    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep
    from tissue_analysis_tpu_torch.utils import timing

    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "traces")
    img4, table4 = grid4
    g4 = LabeledStack.from_array(img4, background=None, device="cuda")
    launches = []
    for name, st, want in ((f"voronoi-{SIZE}", stack, None), ("grid4", g4, table4)):
        analyze_stack(st)  # the allocator and the converged L, outside the trace
        block_sweep.launches = 0
        with timing.profile_trace(log_dir) as prof:
            got = analyze_stack(st)
        launches.append(block_sweep.launches)
        if launches[-1] != 1:
            raise AssertionError(f"profiler {name}: {launches[-1]} launches in a converged pass")
        if want is not None:
            tables_equal(want, got, f"profiled {name} vs unprofiled")
        if not (prof.trace_path and os.path.getsize(prof.trace_path) > 0):
            raise AssertionError(f"profiler {name}: no trace file")
        rows = timing.device_times(prof)
        sweep = [r for r in rows if "block_sweep_kernel" in r[0]]
        if len(sweep) != 1 or sweep[0][1] != 1 or not sweep[0][2] > 0:
            raise AssertionError(
                f"profiler {name}: no device entry of the block-sweep kernel among "
                f"{[r[0][:40] for r in rows]}")
        copies = [r for r in rows if r[0].startswith(("Memcpy", "Memset"))]
        others = [r for r in rows if r not in sweep and r not in copies]
        log(f"{log_prefix} profiler {name}: trace {os.path.relpath(prof.trace_path)} "
            f"({os.path.getsize(prof.trace_path):,} B); device time {sum(r[2] for r in rows) / 1e3:.3f} ms "
            f"in {sum(r[1] for r in rows)} launches and copies: block_sweep_kernel "
            f"{sweep[0][2] / 1e3:.3f} ms; {len(others)} other kernels "
            f"{sum(r[2] for r in others) / 1e3:.3f} ms in {sum(r[1] for r in others)} launches "
            f"(combine + pair reduce, and the overflow check's reduce); copies and "
            f"memsets {sum(r[2] for r in copies) / 1e3:.3f} ms")
        for key, calls, us in copies + others[:12]:
            short = key.replace("void ", "").replace("at::native::", "").replace(
                "at_cuda_detail::cub::", "")
            log(f"{log_prefix}   {name} {us / 1e3:9.3f} ms  x{calls:<3d} {short[:120]}")
        ops = timing.device_times(prof, by_op=True)
        log(f"{log_prefix}   {name} the same device time by the operator that launched it: "
            + "; ".join(f"{k} {us / 1e3:.3f} ms x{c}" for k, c, us in ops[:14]))
    del g4
    return launches


def phase_host_profile(log_prefix="[16]"):
    """The host profile's lines at the three presets, readbacks from the card."""
    hp = load_script(os.path.join("scripts", "torch_host_profile.py"))
    for preset, extra in (("voronoi-512", []), ("grid8", ["--graph-reps", "1"]),
                          ("grid4", ["--graph-reps", "1"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            results = hp.main(["--preset", preset] + extra)
        for line in out.getvalue().splitlines():
            log(f"{log_prefix} {preset}: {line}")
        whole = results["engine.assemble_table (all of the above)"]
        if not (len(results) == 21 and whole > 0):
            raise AssertionError(f"host profile {preset}: {len(results)} lines")


def phase_bench_example(img, t_whole, log_prefix="[17]"):
    """bench_torch.py on the stack in memory, and the example on the card
    against the CPU; returns the kernel launches of (one timed bench pass,
    the example)."""
    import numpy as np

    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep

    import bench_torch

    rec = bench_torch.main([], img=np.asarray(img))  # prints its JSON line
    if rec["launches"] < 1 or rec["backend"] != "cuda":
        raise AssertionError(f"bench: {rec['launches']} launches on {rec['backend']}")
    if f"{EXPECT_LABELS} labels / {EXPECT_PAIRS} walls" not in rec["metric"]:
        raise AssertionError(f"bench: {rec['metric']}")
    ratio = rec["end_to_end_s"] / t_whole
    log(f"{log_prefix} bench_torch: whole pass (end_to_end_s) {rec['end_to_end_s'] * 1e3:.3f} ms "
        f"beside phase 5's {t_whole * 1e3:.3f} ms (ratio {ratio:.3f}); resident pass + graph "
        f"{rec['wall_s'] * 1e3:.3f} ms ({rec['value']:.1f} Mvox/s), raw whole pass "
        f"{rec['end_to_end_raw_s'] * 1e3:.3f} ms; {rec['launches']} launch(es) a timed pass; "
        f"{rec['device']}, {rec['power_limit']}")
    # both are host-clock times of a host-bound pass on a shared host: the
    # guard is for a pass that is not the same work, not for noise
    if not 1 / 3 < ratio < 3:
        raise AssertionError(f"bench: whole pass {ratio:.2f}x phase 5's")

    ex = load_script(os.path.join("examples", "full_pipeline_torch.py"))
    out = io.StringIO()
    block_sweep.launches = 0
    with contextlib.redirect_stdout(out):
        table, graph, tpg = ex.main(["--size", "64", "--device", "cuda"])
    sync()
    launches = block_sweep.launches
    if launches < 5:  # facade, analyze, graph_from_image and two frames
        raise AssertionError(f"example: {launches} kernel launches")
    with contextlib.redirect_stdout(io.StringIO()):
        table_c, graph_c, tpg_c = ex.main(["--size", "64", "--device", "cpu"])
    tables_equal(table_c, table, "example cuda vs cpu table")
    graphs_equal(graph, graph_c, "example cuda vs cpu graph")
    graphs_equal(tpg, tpg_c, "example cuda vs cpu temporal graph")
    for line in out.getvalue().splitlines():
        if line.strip():
            log(f"{log_prefix} example: {line}")
    log(f"{log_prefix} example --size 64: {launches} kernel launches; table, graph and "
        f"temporal graph == the CPU run's")
    return rec["launches"], launches


def no_reroute(phase: str) -> None:
    """A phase that asked for the kernel (or the plain block engine) took it."""
    from tissue_analysis_tpu_torch import engine

    if engine.reroutes != 0:
        raise AssertionError(f"{phase}: {engine.reroutes} stack(s) rerouted to the flat engine")


def phase_flat(stack, table, img2d, grid8, grid4, log_prefix="[18]"):
    """The flat engine against the kernel engine's tables, dense-grid2's
    capacity route, and the flat engine sharded; returns its record."""
    import warnings

    import numpy as np
    import torch

    from tissue_analysis_tpu_torch import engine
    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack
    from tissue_analysis_tpu_torch.ops import segred, stencil
    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep
    from tissue_analysis_tpu_torch.parallel import Mesh, analyze_sharded, analyze_sharded_chunked
    from tissue_analysis_tpu_torch.utils import timing

    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "traces")
    t_phase = time.perf_counter()

    def peak_of(fn) -> int:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        sync()
        return torch.cuda.max_memory_allocated() - base

    record = []
    cases = (
        (f"voronoi-{SIZE}", stack, table, True),
        (f"voronoi-{SIZE_2D}^2 2D", lambda: LabeledStack.from_array(
            img2d[0], background=1, device="cuda"), img2d[1], False),
        (f"grid8-{SIZE}", lambda: LabeledStack.from_array(
            grid8[0], background=None, device="cuda"), grid8[1], False),
        ("grid4", lambda: LabeledStack.from_array(
            grid4[0], background=None, device="cuda"), grid4[1], True),
    )
    for name, st, want, detail in cases:
        if callable(st):
            st = st()
        n = st.n_labels
        block_sweep.launches, engine.reroutes = 0, 0
        got = engine.analyze_stack(st, engine="chunked")
        sync()
        if block_sweep.launches or engine.reroutes:
            raise AssertionError(f"flat {name}: {block_sweep.launches} kernel launches")
        tables_equal(want, got, f"flat engine {name} vs the kernel engine")
        t_flat = best_of(lambda: engine.analyze_stack(st, engine="chunked"))
        t_block = best_of(lambda: engine.analyze_stack(st))
        t_flat_dev = best_of(lambda: engine.flat_sweep(st))
        t_block_dev = best_of(lambda: engine.finish_stack(engine.dispatch_stack(st)))
        peak = peak_of(lambda: engine.analyze_stack(st, engine="chunked"))
        peak_block = peak_of(lambda: engine.analyze_stack(st))
        with timing.collect() as stages:
            engine.analyze_stack(st, engine="chunked")
        with timing.profile_trace(log_dir) as prof:
            engine.flat_sweep(st)
        rows = timing.device_times(prof)
        if not rows or any("block_sweep_kernel" in r[0] for r in rows):
            raise AssertionError(f"flat {name}: device entries {[r[0][:40] for r in rows]}")
        n_dev, t_prof = sum(r[1] for r in rows), sum(r[2] for r in rows) / 1e3
        log(f"{log_prefix} flat engine {name}: table == the kernel engine's ({n} labels, "
            f"{got.n_pairs} walls, 0 kernel launches); analyze_stack chunked "
            f"{t_flat * 1e3:.3f} ms vs cuda {t_block * 1e3:.3f} ms; device side (flat_sweep) "
            f"{t_flat_dev * 1e3:.3f} ms vs kernel + combine (dispatch + finish_stack) "
            f"{t_block_dev * 1e3:.3f} ms; peak device memory above the stack "
            f"{peak / 2**30:.3f} GiB vs {peak_block / 2**30:.3f} GiB; one profiled flat_sweep: "
            f"{t_prof:.3f} ms of device time in {n_dev} launches and copies")
        log(f"{log_prefix} stages, flat {name}: {stages_line(stages)}")
        record.append({
            "shape": name, "ms": t_flat * 1e3, "kernel_engine_ms": t_block * 1e3,
            "device_ms": t_flat_dev * 1e3, "kernel_engine_device_ms": t_block_dev * 1e3,
            "peak_bytes": peak, "kernel_engine_peak_bytes": peak_block,
            "profiled_device_ms": t_prof, "profiled_launches": n_dev,
        })
        if detail:
            # the reference's chunk (2^21 voxels) beside the port's default
            parts = []
            for chunk in (1 << 21, segred.DEFAULT_CHUNK):
                for part, fn in (("moments", segred.moment_sweep), ("pairs", stencil.pair_sweep)):
                    t = best_of(lambda: fn(st.dense, n, chunk), reps=3, warmup=1)
                    parts.append(f"{part} chunk=2^{chunk.bit_length() - 1} {t * 1e3:.3f} ms")
            log(f"{log_prefix} flat {name}, by part (best of 3): " + "; ".join(parts))
        del st, got

    # ---- dense-grid2: 2048 labels a block, past every dictionary
    t0 = time.perf_counter()
    img = grid_stack(DENSE2_SHAPE, (DENSE2_CELL,) * 3)
    st = LabeledStack.from_array(img, background=None, device="cuda")
    sync()
    t_make = time.perf_counter() - t0
    if st.n_labels != EXPECT_LABELS_DENSE2:
        raise AssertionError(f"dense-grid2: {st.n_labels} labels")
    block_sweep.launches = 0
    try:
        engine.analyze_stack(st, engine="cuda")
    except ValueError as err:
        msg = str(err)
    else:
        raise AssertionError("dense-grid2: engine='cuda' returned a table")
    launches = block_sweep.launches
    if (f"{EXPECT_DENSE2_FACE_BYTES:,} bytes" not in msg or 'engine="chunked"' not in msg
            or launches != EXPECT_DENSE2_LAUNCHES):
        raise AssertionError(f"dense-grid2: {launches} launches, then: {msg}")
    engine.reroutes = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sync()
        t0 = time.perf_counter()
        block_sweep.launches = 0
        auto = engine.analyze_stack(st)
        sync()
        t_auto = time.perf_counter() - t0
    warned = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    if (engine.reroutes != 1 or len(warned) != 1 or 'engine="chunked"' not in warned[0]
            or block_sweep.launches != 0):
        raise AssertionError(f"dense-grid2 auto: {engine.reroutes} reroutes, "
                             f"{block_sweep.launches} kernel launches, warnings {warned}")
    engine.reroutes = 0
    if not (auto.n_labels == EXPECT_LABELS_DENSE2 and np.all(auto.count == DENSE2_CELL ** 3)):
        raise AssertionError("dense-grid2: a cell's voxel count is not 8")
    if auto.n_pairs != EXPECT_PAIRS_DENSE2:
        raise AssertionError(f"dense-grid2: {auto.n_pairs} walls, expected {EXPECT_PAIRS_DENSE2}")
    if not np.all(auto.wall_face_counts.sum(axis=1) == DENSE2_CELL ** 2):
        raise AssertionError("dense-grid2: a wall's face total is not 4")
    if not np.all(auto.cmax - auto.cmin == DENSE2_CELL - 1):
        raise AssertionError("dense-grid2: a cell's bbox is not 2x2x2")
    # one timed pass (its host assemble of 12.5 M pairs takes over a second)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with timing.collect() as stages:
        t0 = time.perf_counter()
        flat = engine.analyze_stack(st, engine="chunked")
        t_flat = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    tables_equal(auto, flat, "dense-grid2 chunked vs auto")
    del flat
    t_flat_dev = best_of(lambda: engine.flat_sweep(st))
    log(f"{log_prefix} dense-grid2 {DENSE2_SHAPE} cell {DENSE2_CELL}^3 ({st.n_labels} labels, "
        f"{EXPECT_LABELS_DENSE2 // 2048} a block; made and relabeled in {t_make:.1f} s): "
        f"engine='cuda' raised after {launches} launches: {msg}")
    log(f"{log_prefix} dense-grid2 engine='auto': 1 reroute before any launch, 1 warning, table in "
        f"{t_auto * 1e3:.3f} ms == closed form ({auto.n_pairs} walls of 4 faces, every count 8) "
        f"== engine='chunked'; analyze_stack chunked {t_flat * 1e3:.3f} ms (one pass), device "
        f"side {t_flat_dev * 1e3:.3f} ms, peak device memory above the stack "
        f"{peak / 2**30:.3f} GiB")
    log(f"{log_prefix} dense-grid2 warning: {warned[0]}")
    log(f"{log_prefix} stages, dense-grid2 chunked: {stages_line(stages)}")
    record.append({
        "shape": "dense-grid2", "ms": t_flat * 1e3, "device_ms": t_flat_dev * 1e3,
        "peak_bytes": peak, "auto_ms": t_auto * 1e3, "cuda_launches_before_raise": launches,
    })
    del st, auto, img

    # ---- the flat engine sharded: four slabs on one card
    mesh = Mesh((torch.device("cuda:0"),) * 4)
    block_sweep.launches = 0
    got = analyze_sharded_chunked(stack, mesh)
    sync()
    if block_sweep.launches:
        raise AssertionError("sharded flat engine launched the block-sweep kernel")
    tables_equal(table, got, "analyze_sharded_chunked vs resident")
    t_sh = best_of(lambda: analyze_sharded_chunked(stack, mesh))
    t_sh_k = best_of(lambda: analyze_sharded(stack, mesh))
    with timing.collect() as stages:
        analyze_sharded_chunked(stack, mesh)
    log(f"{log_prefix} analyze_sharded_chunked {SIZE}^3 on 4 slabs on cuda:0: table == "
        f"resident; {t_sh * 1e3:.3f} ms vs analyze_sharded (kernel) {t_sh_k * 1e3:.3f} ms")
    log(f"{log_prefix} stages, sharded flat {SIZE}^3: {stage_sums(stages)}")
    record.append({"shape": f"sharded voronoi-{SIZE} x4", "ms": t_sh * 1e3,
                   "kernel_engine_ms": t_sh_k * 1e3})
    no_reroute("phase 18")
    log(f"{log_prefix} the phase took {time.perf_counter() - t_phase:.1f} s")
    return record


def phase_adversarial(log_prefix="[13]") -> int:
    """The kernel against its plain version on the adversarial inputs;
    returns the max |diff|."""
    import torch

    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep, block_sweep_reference
    from tissue_analysis_tpu_torch.ops.sweep_cases import CASES

    worst = 0
    for name, make in CASES.items():
        dense, n, block, L = make()
        t = torch.from_numpy(dense).cuda()
        k, r = block_sweep(t, n, block, L), block_sweep_reference(t, n, block, L)
        over = bool(r.ovf.any())
        if over != (name == "alternate-x-over-L"):
            raise AssertionError(f"{name}: overflow {over}")
        if over:
            # an overflowing block's flag and its L smallest ids are defined
            if not (torch.equal(k.ovf, r.ovf) and torch.equal(k.ids, r.ids)):
                raise AssertionError(f"{name}: ovf or ids differ")
        else:
            worst = max(worst, compare_sweeps(k, r))
    sync()
    log(f"{log_prefix} adversarial inputs: {len(CASES)} cases ({', '.join(CASES)}) == plain "
        f"version (max |diff| {worst}; alternate-x-over-L: every block overflows, flags "
        f"and ids equal)")
    return worst


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    # the series frames after the first are generated in worker processes
    # while this one generates the first
    pool = ProcessPoolExecutor(
        max_workers=len(SERIES_SEEDS), mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(_voronoi_frame, (SIZE,) * 3, NCELLS, seed)
                   for seed in SERIES_SEEDS]
        return run_phases(futures)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(futures) -> int:
    import numpy as np
    import torch

    from tissue_analysis_tpu_torch import engine
    from tissue_analysis_tpu_torch.core.spatial_image import SpatialImage
    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack
    from tissue_analysis_tpu_torch.engine import analyze_stack
    from tissue_analysis_tpu_torch.graph.from_image import graph_from_table
    from tissue_analysis_tpu_torch.ops.block_sweep import (
        DEFAULT_BLOCK,
        block_sweep,
        block_sweep_reference,
        build_kernel,
    )
    from tissue_analysis_tpu_torch.utils import timing

    # ---- 1. device
    t_start = time.perf_counter()
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
    engine.reroutes = 0
    t0 = time.perf_counter()
    img = voronoi_stack((SIZE,) * 3, NCELLS, seed=SEED)
    t_gen = time.perf_counter() - t0
    # wait for the other frames before anything is timed: receiving one
    # (268 MB unpickled in the executor's thread) holds the interpreter lock
    done = [f.result() for f in futures]
    t_wait = time.perf_counter() - t0 - t_gen
    small = voronoi_stack((64,) * 3, 150, seed=0)
    st64 = LabeledStack.from_array(small, background=1, device="cuda")
    max_err = compare_sweeps(
        block_sweep(st64.dense, st64.n_labels),
        block_sweep_reference(st64.dense, st64.n_labels),
    )
    cpu64 = analyze_stack(LabeledStack.from_array(small, background=1, device="cpu"))
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
        f"(stack generated in {t_gen:.1f} s, then {t_wait:.1f} s waiting for the "
        f"other series frames)")

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
    t_kernel = event_ms(lambda: block_sweep(dense16, n))
    t_plain = event_ms(lambda: block_sweep_reference(dense16, n), reps=5, warmup=1)
    b512 = sweep_bound(dense16, DEFAULT_BLOCK, 32)
    log(f"[5] block_sweep kernel at {SIZE}^3: bound {b512['bound_ms']:.3f} ms "
        f"({b512['bytes']:,} B); {smem_line(32)}")
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
    log("[5] stages of one whole pass: " + stages_line(stages))

    # ---- 6-9. kernel-v1's paths (2D, n >= 2^16), the facade, analyze_raw
    l2d, e2d, k2d, p2d, b2d, img2d = phase_2d()
    lgr, egr, kgr, pgr, bgr, grid8 = phase_grid()
    phase_facade_3d(img)
    phase_raw(img)

    # ---- 10-12. past the shared-memory dictionary, time series, streaming
    lg4, eg4, kg4, pg4, bg4, grid4 = phase_grid4()
    frames = [img] + [SpatialImage(a) for a, _ in done]
    l_series = phase_series(frames, [t_gen] + [t for _, t in done])
    del frames, done
    l_stream, tiled = phase_stream(img)

    # ---- 13. adversarial inputs, every label layout and face path
    e_adv = phase_adversarial()

    # ---- 14. z-slab sharding against the resident tables
    l_sh16, l_sh_g4 = phase_sharded(stack, table, tiled, grid4)
    del tiled

    # ---- 15-17. the profiler hook, the host profile, the bench and the example
    l_prof, l_prof_g4 = phase_profiler(stack, grid4)
    phase_host_profile()
    l_bench, l_example = phase_bench_example(img, t_whole)
    no_reroute("phases 3-17")

    # ---- 18. the flat engine: no per-block dictionary, no kernel of its own
    flat = phase_flat(stack, table, img2d, grid8, grid4)
    del img2d, grid8, grid4
    log(f"all 18 phases took {time.perf_counter() - t_start:.1f} s")

    def shape(name, launches_main, err, t_k, t_p, bound):
        return {"shape": name, "launches_main_path": launches_main, "max_abs_err": float(err),
                "ms": t_k * 1e3, "plain_ms": t_p * 1e3, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"]}

    src = "tissue_analysis_tpu_torch/csrc/block_sweep.cu"
    k1_shapes = [shape(f"voronoi-{SIZE} uint16 block 8x16x128 L=32", launches, max_err,
                       t_kernel, t_plain, b512)]
    k2_shapes = [
        shape(f"voronoi {SIZE_2D}^2 2D uint16 block 1x128x128 L=32", l2d, e2d, k2d, p2d, b2d),
        shape(f"grid8-{SIZE} int32 L=128", lgr, egr, kgr, pgr, bgr),
        shape(f"grid4 {GRID4_SHAPE} int32 L=512", lg4, eg4, kg4, pg4, bg4),
    ]
    print(json.dumps({"kernels": [{
        "name": "block_sweep",
        "route": "cuda",
        "source": src,
        "replaces": "tissue_analysis_tpu/ops/pallas_block.py:830",
        "launches": launches,
        "max_abs_err": float(max(max_err, e_adv)),
        "ms": t_kernel * 1e3,
        "plain_ms": t_plain * 1e3,
        "bound_ms": b512["bound_ms"],
        "bound_by": b512["bound_by"],
        # no single PyTorch call computes the sweep
        "library_ms": None,
        "shapes": k1_shapes,
        # the same contract on the series frames and the streamed slabs
        "launches_series": l_series,
        "launches_stream": l_stream,
        # 512^3 and the 1024^3 tiling, four slabs on one card
        "launches_sharded": l_sh16,
        # one profiled pass, one timed pass of bench_torch.py, the example
        "launches_profiler": l_prof,
        "launches_bench": l_bench,
        "launches_example": l_example,
    }, {
        # kernel-v1's contract: the 2D lift and the int32 label space; ms,
        # plain_ms and bound_ms are the sums over the 4096^2 image and the
        # grid8 512^3 stack, launches count all three shapes
        "name": "block_sweep (kernel-v1 contract: 2D block 1x128x128, n >= 2^16)",
        "route": "cuda",
        "source": src,
        "replaces": "tissue_analysis_tpu/ops/pallas_block.py:678",
        "launches": l2d + lgr + lg4,
        "max_abs_err": float(max(e2d, egr, eg4, e_adv)),
        "ms": (k2d + kgr) * 1e3,
        "plain_ms": (p2d + pgr) * 1e3,
        "bound_ms": b2d["bound_ms"] + bgr["bound_ms"],
        "bound_by": "bytes" if "operations" not in (b2d["bound_by"], bgr["bound_by"])
        else "operations",
        "library_ms": None,
        "shapes": k2_shapes,
        # grid4, four slabs on one card, each from L = 32 to 512
        "launches_sharded": l_sh_g4,
        # one profiled converged pass of grid4
        "launches_profiler": l_prof_g4,
    }],
        # plain PyTorch (scatter and sort library kernels), the yardstick of
        # the hand kernel: whole analyze_stack and device side, ms, per shape
        "flat_engine": flat,
    }), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
