"""Multi-device equality check of the z-slab-sharded engine.

Runs :func:`~tissue_analysis_tpu_torch.parallel.sharded.analyze_sharded` on
a mesh of ``n_devices`` entries of one device (through the block engine and
through the flat engine), and the streamed engine, and holds every table
against ``engine.analyze_stack`` on the same device,
field by field::

    python -m tissue_analysis_tpu_torch.parallel.dryrun 8          # the CPU
    python -m tissue_analysis_tpu_torch.parallel.dryrun 4 cuda     # one card

The cases are the reference dryrun's (``tissue_analysis_tpu/parallel/
dryrun.py``): a depth no mesh size divides, a few hundred cells with a
dictionary small enough that slabs rerun, and a wide stack streamed in thin
slabs. It prints one ``dryrun_multichip ok: ...`` line and raises on any
difference. It imports no JAX.
"""

from __future__ import annotations

import sys

FIELDS = (
    "ids", "count", "s1", "s2", "cmin", "cmax",
    "pair_lo", "pair_hi", "wall_face_counts", "margin",
)


def _check(got, ref, what: str) -> None:
    import numpy as np

    for f in FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: field {f} differs from analyze_stack's")


def run(n_devices: int, device="cpu") -> None:
    from tissue_analysis_tpu_torch import engine
    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack
    from tissue_analysis_tpu_torch.parallel.sharded import analyze_sharded, make_mesh
    from tissue_analysis_tpu_torch.streaming import analyze_streamed
    from tissue_analysis_tpu_torch.utils import timing

    mesh = make_mesh(n_devices, device=device)

    def stack_of(img):
        return LabeledStack.from_array(img, background=1, device=device)

    # case 1: a depth (30) that no mesh size of 4 or 8 divides
    st1 = stack_of(voronoi_stack((30, 24, 24), 25, seed=3))
    ref1 = engine.analyze_stack(st1)
    _check(analyze_sharded(st1, mesh), ref1, "case1")
    _check(analyze_sharded(st1, mesh, engine="chunked"), ref1, "case1, flat engine")

    # case 2: several blocks a slab and every seam crossed by cells; at
    # L = 4 the slabs rerun with L doubled
    st2 = stack_of(voronoi_stack((120, 16, 128), 400, seed=7, sphere=False))
    L = 4
    for key in [k for k in engine._GOOD_L if k[3] == L]:
        del engine._GOOD_L[key]
    with timing.collect() as t:
        got2 = analyze_sharded(st2, mesh, L=L)
    sweeps = sum(s.name == "device sweep (block)" for s in t.stages)
    slabs = sum(s.name == "shard: shift + z-seam" for s in t.stages)
    if sweeps <= slabs:
        raise AssertionError(f"case2: {sweeps} sweeps of {slabs} slabs, no rerun at L={L}")
    ref2 = engine.analyze_stack(st2)
    _check(got2, ref2, "case2")
    _check(analyze_sharded(st2, mesh, engine="chunked"), ref2, "case2, flat engine")

    # case 3: the streamed path, cross-section much wider than a slab
    img3 = voronoi_stack((32, 192, 192), 150, seed=11, sphere=False)
    got3 = analyze_streamed(img3, background=1, slab_z=8, device=device)
    _check(got3, engine.analyze_stack(stack_of(img3)), "case3")

    print(
        f"dryrun_multichip ok: {n_devices} x {mesh.devices[0]}, sharded (block and "
        f"flat engine) and streamed tables == analyze_stack (case1 {st1.n_labels} labels, "
        f"depth 30; case2 {st2.n_labels} labels, {sweeps} sweeps of {slabs} "
        f"slabs from L={L}; case3 streamed slab_z=8, {got3.n_labels} labels)",
        flush=True,
    )


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
        sys.argv[2] if len(sys.argv) > 2 else "cpu")
