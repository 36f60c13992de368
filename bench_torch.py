#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: full per-cell feature table + adjacency
graph on a 512³ stack (``voronoi_stack((512,)*3, 3500, seed=1)``: 2031
labels, 14176 walls), the counterpart of ``bench.py``.

    python bench_torch.py                 # on the current CUDA device
    python bench_torch.py --device cpu    # the plain engine, on the CPU

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "Mvoxels/s/chip", "wall_s": ..., ...}

- ``wall_s`` / ``value``: ``analyze_stack`` + ``graph_from_table`` on a
  device-resident stack, two warmups (the first converges the per-block
  dictionary size), then the best of ``BENCH_REPS`` passes;
- ``end_to_end_s`` = ``relabel_s`` + ``transfer_s`` + ``pass_s``: ingest from
  the host array (host relabel, then the host→device copy), pass and graph;
- ``end_to_end_raw_s`` = ``raw_transfer_s`` + ``raw_pass_s``: the same through
  ``analyze_raw`` (raw labels uploaded, no host relabel), its ``ingest:``
  stages summed as the transfer;
- ``device`` / ``power_limit``: the card as ``nvidia-smi`` names it;
  ``launches``: kernel launches of one timed pass (≥ 1 on a card).

Every time is taken on the host clock between ``torch.cuda.synchronize``
fences. Before any number is printed the timed table is held against the
plain engine's (``engine="torch"``) field by field, and at the default size
against the stack's known label and wall counts. Without a CUDA device and
without ``--device cpu`` the script raises: nothing falls back to the CPU.

Env knobs: BENCH_SIZE (default 512), BENCH_CELLS (default 3500),
BENCH_REPS (default 5), BENCH_CACHE (default ``build/bench_cache`` beside
this file: the generated stack is kept there, ~45 s to make at 512³).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

DEFAULT_SIZE, DEFAULT_CELLS = 512, 3500
EXPECT_LABELS, EXPECT_PAIRS = 2031, 14176  # of the default stack


def _get_stack(n: int, ncells: int, seed: int):
    cache_dir = os.environ.get("BENCH_CACHE", os.path.join(_HERE, "build", "bench_cache"))
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"voronoi_{n}_{ncells}_{seed}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["img"]
    from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack

    img = np.asarray(voronoi_stack((n, n, n), ncells, seed=seed))
    np.savez_compressed(path, img=img)
    return img


def main(argv=None, img=None) -> dict:
    """Run the benchmark and print its JSON line; returns the record.
    ``img`` is the stack to time (default: the cached one of the env knobs)."""
    import torch

    from tissue_analysis_tpu_torch.core.stack import LabeledStack, resolve_device
    from tissue_analysis_tpu_torch.engine import analyze_raw, analyze_stack
    from tissue_analysis_tpu_torch.features.table import FeatureTable
    from tissue_analysis_tpu_torch.graph.from_image import graph_from_table
    from tissue_analysis_tpu_torch.ops.block_sweep import block_sweep
    from tissue_analysis_tpu_torch.utils import timing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' for the plain engine")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # raises without a card unless "cpu"
    on_card = dev.type == "cuda"

    n = int(os.environ.get("BENCH_SIZE", str(DEFAULT_SIZE)))
    ncells = int(os.environ.get("BENCH_CELLS", str(DEFAULT_CELLS)))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    if img is None:
        img = _get_stack(n, ncells, seed=1)
    img = np.asarray(img)

    def fence() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    stack = LabeledStack.from_array(img, background=1, device=dev)
    voxels = float(np.prod(stack.shape))

    # TWO warmups: the first converges the dictionary size (rerun-larger
    # sweeps) and builds the kernel, the second runs the converged pass
    table = analyze_stack(stack)
    table = analyze_stack(stack)

    # the table that is timed is the right one, before any number is printed
    plain = analyze_stack(stack, engine="torch")
    for f in FeatureTable._ARRAY_FIELDS:
        x, y = getattr(table, f), getattr(plain, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"timed table differs from the plain engine's in {f}")
    if int(table.count.sum()) != int(voxels) or table.n_pairs < 1:
        raise AssertionError("the table does not cover the stack")
    if img.shape == (DEFAULT_SIZE,) * 3 and ncells == DEFAULT_CELLS and (
        (table.n_labels, table.n_pairs) != (EXPECT_LABELS, EXPECT_PAIRS)
    ):
        raise AssertionError(
            f"expected {EXPECT_LABELS} labels / {EXPECT_PAIRS} walls, got "
            f"{table.n_labels} / {table.n_pairs}"
        )

    times = []
    launches = 0
    for _ in range(reps):
        block_sweep.launches = 0
        fence()
        t0 = time.perf_counter()
        table = analyze_stack(stack)
        graph_from_table(table)  # property-graph export is part of the pass
        fence()
        times.append(time.perf_counter() - t0)
        launches = block_sweep.launches
    if on_card and launches < 1:
        raise AssertionError("a timed pass on the card launched no block_sweep kernel")

    # end to end: ingest (native relabel, then the host->device copy) + pass
    # + graph export, split by stage
    e2e = []
    for _ in range(reps):
        fence()
        t0 = time.perf_counter()
        with timing.collect() as tc:  # fences the copy inside from_array
            st = LabeledStack.from_array(img, background=1, device=dev)
        fence()
        t2 = time.perf_counter()
        transfer = sum(s.seconds for s in tc.stages
                       if s.name == "ingest: host->device transfer")
        tb = analyze_stack(st)
        graph_from_table(tb)
        fence()
        t3 = time.perf_counter()
        e2e.append((t3 - t0, t2 - t0 - transfer, transfer, t3 - t2))
    e2e_best, relabel_s, transfer_s, pass_s = min(e2e)
    # headline from the best across BOTH timed loops (identical work:
    # device-resident pass + graph export)
    best = min(times + [e[3] for e in e2e])

    # raw-mode end to end: the RAW labels uploaded + device pass; no host
    # relabel stage exists at all. Bit-identical to the relabel path.
    analyze_raw(img, background=1, device=dev)  # warmup 1: converge L
    analyze_raw(img, background=1, device=dev)  # warmup 2: the converged pass
    e2e_raw = []
    for _ in range(reps):
        fence()
        t0 = time.perf_counter()
        with timing.collect() as tc:
            tr = analyze_raw(img, background=1, device=dev)
            graph_from_table(tr)
        fence()
        dt = time.perf_counter() - t0
        # the upload and the id-range scan, each fenced by its stage
        xfer = sum(s.seconds for s in tc.stages if s.name.startswith("ingest:"))
        e2e_raw.append((dt, xfer))
    e2e_raw_best, raw_transfer_s = min(e2e_raw)
    raw_pass_s = e2e_raw_best - raw_transfer_s

    device, power_limit = "cpu", None
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        device, power_limit = (s.strip() for s in smi.split(",", 1))

    record = {
        "metric": (
            f"full feature table + adjacency graph, {img.shape[0]}^3 stack, "
            f"{table.n_labels} labels / {table.n_pairs} walls"
        ),
        "value": voxels / best / 1e6,
        "unit": "Mvoxels/s/chip",
        "wall_s": best,
        "end_to_end_s": e2e_best,
        "relabel_s": relabel_s,
        "transfer_s": transfer_s,
        "pass_s": pass_s,
        "end_to_end_raw_s": e2e_raw_best,
        "raw_transfer_s": raw_transfer_s,
        "raw_pass_s": raw_pass_s,
        "end_to_end_mvox_s": voxels / min(e2e_best, e2e_raw_best) / 1e6,
        "reps": reps,
        "launches": launches,
        "device": device,
        "power_limit": power_limit,
        "backend": dev.type,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
