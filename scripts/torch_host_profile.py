#!/usr/bin/env python3
"""Attribute the host-side milliseconds of the port's pass, stage by stage.

The device stages are timed by fenced ``timing.collect()`` stages; this
script times the HOST side alone, on synthetic but shape-exact inputs made
from a numpy seed: a finished sweep (``engine.Finished``: per-label moments
and bbox, sorted unique wall-pair keys and their face totals, on the
device), then every step ``engine.assemble_table`` takes with it, then
``graph_from_table``:

  - the five readbacks (``.cpu().numpy()``) of mom, cmin, cmax, pkey, ptotal
  - ``combine.decode_pairs``, and its ``counts3[inv, ax] = total`` fill apart
  - ``engine._margin_from_bbox``
  - the ``FeatureTable`` build (empty-row masking, column copies)
  - ``engine.assemble_table`` as a whole, to hold the parts against
  - ``graph_from_table`` cold, warm, per property and topology only

Each line is the best of ``--reps`` runs (``--graph-reps`` for the graph
lines, which take seconds at 262,144 labels). It changes nothing it measures.

Usage, from the repository root::

    python scripts/torch_host_profile.py [n_labels] [n_keys] [--device cpu]
    python scripts/torch_host_profile.py --preset grid4

``n_keys`` counts (lo, hi, axis) keys, three a wall (a Voronoi tissue: a
wall has faces along every axis). The presets are the label and wall counts
of the stacks ``chip_smoke.py`` runs: ``voronoi-512`` (2031 labels, 14176
walls, three keys a wall), ``grid8`` (262,144 labels, 774,144 walls) and
``grid4`` (524,288 labels, 1,552,384 walls), both grids of boxes with one
key a wall. ``--device`` defaults to the current CUDA device and
raises without one; on ``cpu`` the readbacks are views and cost nothing.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import resolve_device  # noqa: E402
from tissue_analysis_tpu_torch.features.table import FeatureTable  # noqa: E402
from tissue_analysis_tpu_torch.graph import from_image as fi  # noqa: E402
from tissue_analysis_tpu_torch.ops import combine  # noqa: E402

# name: (n_labels, n_walls, keys per wall, stack shape)
PRESETS = {
    "voronoi-512": (2031, 14176, 3, (512, 512, 512)),
    "grid8": (262144, 774144, 1, (512, 512, 512)),
    "grid4": (524288, 1552384, 1, (256, 256, 512)),
}


def synthetic_finished(n: int, n_keys: int, keys_per_wall: int, shape, device, seed: int = 0):
    """A shape-exact ``engine.Finished`` on ``device``, and the image facts
    ``engine.assemble_table`` reads beside it. Values are valid (every label
    has voxels, a bbox inside ``shape``, lo < hi < n) and otherwise random."""
    rng = np.random.default_rng(seed)
    mom = rng.integers(1, 1 << 40, size=(n, 10), dtype=np.int64)
    cmin = np.stack([rng.integers(0, s // 2, size=n) for s in shape], axis=1).astype(np.int32)
    cmax = (cmin + np.stack([rng.integers(0, s // 2, size=n) for s in shape], axis=1)).astype(
        np.int32)
    # unique (lo, hi) walls, lo < hi: oversample, dedupe, keep n_walls
    n_walls = max(1, n_keys // keys_per_wall)
    n_walls = min(n_walls, n * (n - 1) // 2)
    walls = np.empty(0, dtype=np.int64)
    while walls.shape[0] < n_walls:
        m = int(1.3 * (n_walls - walls.shape[0])) + 64
        lo = rng.integers(0, n - 1, size=m)
        hi = lo + 1 + (rng.integers(0, 1 << 62, size=m) % (n - 1 - lo))
        walls = np.union1d(walls, lo * n + hi)
    walls = np.sort(rng.permutation(walls)[:n_walls])
    lo, hi = walls // n, walls % n
    if keys_per_wall == 3:
        lo, hi = np.repeat(lo, 3), np.repeat(hi, 3)
        ax = np.tile(np.arange(3, dtype=np.int64), n_walls)
    else:
        ax = rng.integers(0, 3, size=n_walls)
    pkey = lo * (4 * n) + hi * 4 + ax  # ascending and unique by construction
    ptotal = rng.integers(1, 500, size=pkey.shape[0], dtype=np.int64)
    fin = engine.Finished(*(torch.from_numpy(a).to(device)
                            for a in (mom, cmin, cmax, pkey, ptotal)))
    image = types.SimpleNamespace(
        ndim=3, n_labels=n, ids=np.arange(n, dtype=np.int64), shape=tuple(shape),
        voxelsize=(1.0, 1.0, 1.0), background_segment=0,
    )
    return image, fin


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_labels", nargs="?", type=int, default=PRESETS["voronoi-512"][0])
    ap.add_argument("n_keys", nargs="?", type=int, default=3 * PRESETS["voronoi-512"][1])
    ap.add_argument("--preset", choices=sorted(PRESETS))
    ap.add_argument("--device", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--graph-reps", type=int, default=None,
                    help="runs of each graph_from_table line (default: --reps)")
    args = ap.parse_args(argv)
    n, n_keys, kpw, shape = args.n_labels, args.n_keys, 3, (512, 512, 512)
    if args.preset:
        n, walls, kpw, shape = PRESETS[args.preset]
        n_keys = walls * kpw
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    image, fin = synthetic_finished(n, n_keys, kpw, shape, dev)
    results: dict = {}

    def t(label, fn, reps=args.reps):
        best = float("inf")
        out = None
        for _ in range(reps):
            if on_card:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        print(f"{label:<46s} {best * 1e3:8.2f} ms", flush=True)
        results[label] = best
        return out

    where = (torch.cuda.get_device_name(dev) if on_card
             else "cpu: the readbacks are views, not copies")
    print(f"host profile: {n} labels, {fin.pkey.shape[0]} keys "
          f"({kpw} a wall), {args.preset or 'by argument'}, device {where}", flush=True)

    # ---- engine.assemble_table, step by step
    mom = t("readback mom int64 [n, 10]", lambda: fin.mom.cpu().numpy())
    cmin = t("readback cmin int32 [n, 3] -> int64",
             lambda: fin.cmin.cpu().numpy().astype(np.int64))
    cmax = t("readback cmax int32 [n, 3] -> int64",
             lambda: fin.cmax.cpu().numpy().astype(np.int64))
    pkey = t("readback pkey int64 [K]", lambda: fin.pkey.cpu().numpy())
    ptotal = t("readback ptotal int64 [K]", lambda: fin.ptotal.cpu().numpy())
    pair_lo, pair_hi, counts = t(
        "decode_pairs", lambda: combine.decode_pairs(pkey, ptotal, n, 3))

    # the fill of decode_pairs alone, on the index arrays it builds
    rest = pkey % np.int64(4 * n)
    gk = ((pkey // np.int64(4 * n)) << 32) | (rest >> 2)
    ax = rest & 3
    starts = np.ones(gk.shape[0], dtype=bool)
    starts[1:] = gk[1:] != gk[:-1]
    inv = np.cumsum(starts) - 1
    n_pairs = int(starts.sum())

    def fill():
        counts3 = np.zeros((n_pairs, 3), dtype=np.int64)
        counts3[inv, ax] = ptotal
        return counts3

    if not np.array_equal(t("  of it: counts3[inv, ax] = total", fill), counts):
        raise AssertionError("the fill timed apart is not decode_pairs's")

    count = mom[:, 0].copy()
    margin = t("_margin_from_bbox",
               lambda: engine._margin_from_bbox(count, cmin, cmax, image.shape))

    def build_table():
        cnt = mom[:, 0].copy()
        empty = cnt == 0
        lo_, hi_ = cmin.copy(), cmax.copy()
        lo_[empty] = 0
        hi_[empty] = 0
        return FeatureTable(
            ids=image.ids.copy(), shape=image.shape, voxelsize=image.voxelsize,
            background_segment=image.background_segment,
            count=cnt, s1=mom[:, 1:4].copy(), s2=mom[:, 4:].copy(), cmin=lo_, cmax=hi_,
            pair_lo=pair_lo, pair_hi=pair_hi, wall_face_counts=counts, margin=margin,
        )

    t("FeatureTable build (masks, column copies)", build_table)
    table = t("engine.assemble_table (all of the above)",
              lambda: engine.assemble_table(image, fin))
    print(f"{'':<46s}  n_pairs={table.n_pairs}", flush=True)

    # ---- graph_from_table
    g_reps = args.reps if args.graph_reps is None else args.graph_reps
    t("graph_from_table (cold cache each rep)",
      lambda: fi.graph_from_table(build_table()), g_reps)
    t("graph_from_table (warm table caches)", lambda: fi.graph_from_table(table), g_reps)
    for prop in fi.DEFAULT_PROPERTIES:
        tb = build_table()
        fi.graph_from_table(tb, default_properties=())  # warm topology inputs
        t(f"  property: {prop}",
          lambda p=prop, tb=tb: fi.graph_from_table(tb, default_properties=(p,)), g_reps)
    t("  topology only (no properties)",
      lambda: fi.graph_from_table(table, default_properties=()), g_reps)
    return results


if __name__ == "__main__":
    main()
