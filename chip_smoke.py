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
    and (1, 128, 128)): the kernel against the plain version.

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

import json
import multiprocessing
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
    return launches, err, t_k, t_p, bound


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
    return launches, err, t_k, t_p, bound


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
    return launches, err, t_k, t_p, bound


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

    def stage_sums(st) -> str:
        sums: dict = {}
        for s in st.stages:
            sums[s.name] = sums.get(s.name, 0.0) + s.seconds
        return "; ".join(f"{k} {v * 1e3:.3f} ms" for k, v in sums.items())

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
    return sum(launches.values())


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
    l2d, e2d, k2d, p2d, b2d = phase_2d()
    lgr, egr, kgr, pgr, bgr = phase_grid()
    phase_facade_3d(img)
    phase_raw(img)

    # ---- 10-12. past the shared-memory dictionary, time series, streaming
    lg4, eg4, kg4, pg4, bg4 = phase_grid4()
    frames = [img] + [SpatialImage(a) for a, _ in done]
    l_series = phase_series(frames, [t_gen] + [t for _, t in done])
    del frames, done
    l_stream = phase_stream(img)

    # ---- 13. adversarial inputs, every label layout and face path
    e_adv = phase_adversarial()

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
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
