"""End-to-end example on the PyTorch/CUDA port: segmented stacks → features →
graphs → lineage stats.

The flow of ``examples/full_pipeline.py`` (``SpatialImageAnalysis`` →
``graph_from_image`` → ``TemporalPropertyGraph`` → ``temporal_change``) on
``tissue_analysis_tpu_torch``, on synthetic stacks so it runs anywhere:

    python examples/full_pipeline_torch.py [--size 64] [--frames 2] [--device cpu]

``--device`` defaults to the current CUDA device (the hand-written kernel
sweeps the stacks) and raises without one; ``cpu`` runs the plain engine.
Both print the same numbers.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tissue_analysis_tpu_torch import (  # noqa: E402
    SpatialImageAnalysis,
    analyze,
    graph_from_image,
    temporal_graph_from_images,
)
from tissue_analysis_tpu_torch.core.stack import resolve_device  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu_torch.graph.temporal import temporal_change  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' for the plain engine")
    args = ap.parse_args(argv)
    n = args.size
    dev = resolve_device(args.device)

    print(f"== single frame ({n}³) ==")
    print(f"device: {dev}")
    img = voronoi_stack((n, n, n), max(20, n), seed=0, voxelsize=(2.0, 0.5, 0.5))

    # reference-compatible facade
    a = SpatialImageAnalysis(img, background=1, device=dev)
    l1 = a.L1()
    print(f"{a.nb_labels()} cells; {len(l1)} in the L1 (epidermis) layer")
    vol = a.volume()
    big = max(vol, key=vol.get)
    print(f"largest cell {big}: volume {vol[big]:.1f} µm³, "
          f"{len(a.neighbors(big))} neighbors")
    evecs, evals = a.inertia_axis(big)
    print(f"  principal axis {evecs[0].round(3)}, eigenvalues {evals.round(1)}")

    # native one-pass API with per-stage timing
    with timing.collect() as t:
        table = analyze(np.asarray(img), voxelsize=img.voxelsize, background=1, device=dev)
        g = graph_from_image(img, background=1, device=dev)
    print(f"graph: {g.nb_vertices()} vertices, {g.nb_edges()} walls")
    print(t.report())

    print(f"\n== time series ({args.frames} frames) ==")
    frames = [
        voronoi_stack((n, n, n), max(20, n) + 5 * i, seed=i)
        for i in range(args.frames)
    ]
    graphs_labels = [
        set(np.unique(np.asarray(f))) - {1} for f in frames
    ]
    lineages = [
        {l: [l] for l in a_ & b_}
        for a_, b_ in zip(graphs_labels, graphs_labels[1:])
    ]
    t0 = time.perf_counter()
    tpg = temporal_graph_from_images(frames, lineages, background=1, devices=[dev])
    print(f"temporal graph: {tpg.nb_vertices()} vertices over "
          f"{tpg.graph_property('nb_time_points')} timepoints "
          f"({time.perf_counter()-t0:.2f}s)")
    growth = temporal_change(tpg, "volume", tpg.vertex_at_time(0), rank=1)
    if growth:
        vals = np.array(list(growth.values()))
        print(f"volume change t0→t1 over {len(growth)} lineages: "
              f"mean {vals.mean():+.1f}")
    return table, g, tpg


if __name__ == "__main__":
    main()
