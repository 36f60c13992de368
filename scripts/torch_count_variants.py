#!/usr/bin/env python3
"""Time the block_label_count kernel against its variants and the parent's kernel, in one process.

Run from the repository root on a machine with a CUDA card and nvcc::

    python scripts/torch_count_variants.py --parent build/parent

Every variant is a build of this tree's ``csrc/block_sweep.cu`` (changed by
text substitution where it says so) or a plan that ``count_plan`` does not
choose, launched through ``ops.block_sweep._launch_count``:

- ``kept``: the kernel and plan as they are;
- ``ring-2``: two tiles a CTA (hash 2^12), one CTA an SM where one tile
  lets two or three share it;
- ``ring-4-hash-8192``: up to four tiles beside a hash of 2^13 slots, the
  first design's hash (one CTA an SM);
- ``hash-8192``: one tile beside a hash of 2^13 slots;
- ``direct``: the direct-load path on stacks TMA could take;
- ``int32-288``: int32 tiles counted by 288 threads (kept: 576);
- ``pipeline``: the TMA tiles and barriers with the count skipped, the
  time of the copies alone (its counts are not checked);
- ``parent``: the count kernel of the tree given by ``--parent`` (its C
  signature before the largest count).

Inputs (seeded): voronoi-512 in uint16 and int32, the 4096² image lifted
to ``[1, Y, X]`` (block 1×128×128), grid8-512, grid4, dense-grid2,
empty-512 (every label n, nothing live), and voronoi-512 cropped to rows of
301 uint16 (the direct path). Every checked count equals
``block_label_counts_reference`` and the largest count its maximum.
Times are CUDA events over 20 launches after 3; the card's name and power
limit head the output, and ``--out`` appends one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KEPT_THREADS = "return kBulk && sizeof(T) == 4 ? 576 : 288;"
COUNT_CALL = "count_tile<T>(reinterpret_cast<const T*>(ring + static_cast<size_t>(s) * c.stage_bytes),"


def build(bs, out_dir: str, parent: str | None) -> dict:
    """nvcc every source variant in parallel; the loaded libraries by name."""
    src = open(bs._SRC).read()
    for needle in (KEPT_THREADS, COUNT_CALL):
        if needle not in src:
            raise RuntimeError(f"source changed: {needle!r} not found")
    sources = {
        "kept": src,
        "int32-288": src.replace(KEPT_THREADS, "return 288;"),
        "pipeline": src.replace(COUNT_CALL, "if (false) " + COUNT_CALL),
    }
    if parent:
        sources["parent"] = open(os.path.join(parent, "tissue_analysis_tpu_torch", "csrc",
                                              "block_sweep.cu")).read()
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [bs._nvcc(), *bs._NVCC_FLAGS, cu, "-o", os.path.join(out_dir, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        if name == "parent":
            lib.ta_block_label_count.argtypes = [vp] + [ci] * 9 + [vp] * 2
        else:
            lib.ta_block_label_count.argtypes = [vp] + [ci] * 17 + [vp] * 3
        lib.ta_block_label_count.restype = ci
        libs[name] = lib
    return libs


def inputs():
    """(name, dense on the card, n, block), made from seeds."""
    import torch

    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack, voronoi_stack

    v = LabeledStack.from_array(voronoi_stack((512,) * 3, 3500, seed=1), background=1, device="cuda")
    yield "voronoi-512 uint16", v.dense, v.n_labels, (8, 16, 128)
    yield "voronoi-512 int32", v.dense.to(torch.int32), v.n_labels, (8, 16, 128)
    yield "voronoi-512 rows of 301", v.dense[:, :, :301].contiguous(), v.n_labels, (8, 16, 128)
    yield "empty-512", torch.ones((512,) * 3, dtype=torch.uint16, device="cuda"), 1, (8, 16, 128)
    del v
    img = LabeledStack.from_array(voronoi_stack((4096, 4096), 4000, seed=1), background=1, device="cuda")
    yield "4096^2 2D", img.dense[None], img.n_labels, (1, 128, 128)
    for name, shape, cell in (("grid8-512", (512,) * 3, 8), ("grid4", (256, 256, 512), 4),
                              ("dense-grid2", (256, 256, 512), 2)):
        g = LabeledStack.from_array(grid_stack(shape, (cell,) * 3), background=None, device="cuda")
        yield name, g.dense.to(torch.int32), g.n_labels, (8, 16, 128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a tree whose count kernel is timed beside")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch

    import tissue_analysis_tpu_torch.ops.block_sweep as bs

    if not torch.cuda.is_available():
        print("torch_count_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)
    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
    libs = build(bs, out_dir, a.parent)
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    cap = 2607  # the kernel's dictionary bound, max_dict_size()
    plan = bs.count_plan

    def fixed(p, hbits):
        return 128 + 4 * ((1 << hbits) + p.nlist + 32)

    def variant_plan(name):
        def f(dense, block, c):
            p = plan(dense, block, c)
            if name == "direct":
                return p._replace(path="direct", stages=0, stage_bytes=0, smem=fixed(p, p.hbits))
            if p.path != "bulk" or name not in ("ring-2", "ring-4-hash-8192", "hash-8192"):
                return p
            hb = p.hbits if name == "ring-2" else 13
            room = bs._MAX_SMEM - fixed(p, hb)
            st = 2 if name == "ring-2" else 1 if name == "hash-8192" else min(4, room // (p.stage_bytes + 8))
            return p._replace(hbits=hb, stages=st, smem=fixed(p, hb) + st * (p.stage_bytes + 8))
        return f

    def parent_count(lib, dense, n, block):
        Z, Y, X = dense.shape
        B = 1
        for s_, b_ in zip(dense.shape, block):
            B *= -(-s_ // b_)
        out = torch.empty((B,), dtype=torch.int32, device=dense.device)
        err = lib.ta_block_label_count(dense.data_ptr(), int(dense.dtype == torch.int32), Z, Y, X,
                                       *block, cap, n, out.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent count: CUDA error {err}")
        return out

    def events_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(a.reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / a.reps

    runs = [("kept", "kept"), ("ring-2", "kept"), ("ring-4-hash-8192", "kept"), ("hash-8192", "kept"),
            ("direct", "kept"), ("int32-288", "int32-288"), ("pipeline", "pipeline")]
    if "parent" in libs:
        runs.insert(0, ("parent", "parent"))
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "cases": {}}
    bad = []
    for case, dense, n, block in inputs():
        want = bs.block_label_counts_reference(dense, n, block, cap)
        row = {}
        for name, lib in runs:
            if name == "int32-288" and dense.dtype != torch.int32:
                continue
            if name == "parent":
                fn = lambda: parent_count(libs[lib], dense, n, block)  # noqa: E731
                equal, path = bool(torch.equal(fn(), want)), None
                ms = events_ms(fn)
            else:
                bs.count_plan = variant_plan(name)
                try:
                    fn = lambda: bs._launch_count(libs[lib], dense, n, block, cap)  # noqa: E731
                    got = fn()
                    path = bs.block_label_counts.path
                    equal = None if name == "pipeline" else bool(
                        torch.equal(got.counts, want) and int(got.largest) == int(want.max()))
                    ms = events_ms(fn)
                finally:
                    bs.count_plan = plan
            if equal is False:
                bad.append((case, name))
            row[name] = {"ms": ms, "equal": equal, "path": path}
        record["cases"][case] = row
        print(f"{case}: " + "; ".join(
            f"{k} {v['ms']:.4f} ms{'' if v['equal'] is not False else ' UNEQUAL'}"
            f"{'' if v['path'] is None else ' ' + v['path']}" for k, v in row.items()), flush=True)
        del dense, want
        torch.cuda.empty_cache()
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "a") as f:
            f.write(json.dumps(record) + "\n")
    if bad:
        print(f"UNEQUAL: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
