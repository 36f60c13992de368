#!/usr/bin/env python3
"""Time the port's block-sweep CUDA kernel and engine pass of one or more source trees, in turns.

Run from the repository root on a machine with a CUDA card and nvcc::

    python scripts/torch_sweep_ab.py                      # this tree only
    python scripts/torch_sweep_ab.py --trees build/parent . --order ABBA
    python scripts/torch_sweep_ab.py --trees build/parent . --order ABBA --rounds 2 \
        --out chiprun_out/ab.jsonl

The inputs are made once (seeded) and saved under ``build/sweep_ab/``:

- ``voronoi-512``: ``voronoi_stack((512,)*3, 3500, seed=1)`` relabeled,
  uint16, block (8, 16, 128), L = 32;
- ``2d-4096``: ``voronoi_stack((4096, 4096), 4000, seed=1)`` lifted to
  ``[1, Y, X]``, uint16, block (1, 128, 128), L = 32;
- ``grid8-512``: ``grid_stack((512,)*3, (8,)*3)``, int32, L = 128;
- ``grid4``: ``grid_stack((256, 256, 512), (4,)*3)``, int32, L = 512;
- ``empty-512``: 512³ voxels all of label n = 1, so no voxel takes part:
  the cost of walking a stack with no dictionary, moment or face work;
- ``voronoi-64``: a 64³ stack, for the wrapper's host time per launch.

Each tree runs in its own process (``sys.path`` pointing at the tree), in
the order given: ``--order ABBA`` with two trees runs A B B A, and
``--rounds`` repeats that. A process checks its kernel against its plain
version (``torch.equal`` on every output), then times it with CUDA events
over ``--reps`` back-to-back launches after three warmups; the same for
the count kernel (``block_label_counts`` at the kernel's bound, against
``block_label_counts_reference``, with the load path it took where the
tree reports one); then the host
time a launch takes to enqueue on ``voronoi-64`` (the mean over 1000 calls
without a sync, the device then being idle behind the host). Then the
engine on the same stacks (``engine="auto"``, on the card, a stack of
segment ids ``0..n-1``), fenced on the host clock: ``first_ms``, the best
of three ``analyze_stack`` calls each after the converged dictionary sizes
are forgotten (what a new shape pays: the overflow reruns, or a count);
``converged_ms``, the best of seven calls; ``first_device_ms`` and
``device_ms``, the same two for ``finish_stack(dispatch_stack(...))``, the
device side without the readback and host assembly. Last, the count's
share of a converged ``analyze_stack`` at voronoi-512 (``count_split``):
the device time of the count kernel and of any reduction launched after
it, from one pass under ``timing.profile_trace``; and on the host clock
the wrapper's enqueue (mean of 200 calls, no sync), the readback of the
largest count after a sync (mean of 50; a tree without a largest count
reads ``counts.max()``), and ``torch.cuda.mem_get_info`` (the
``cudaMemGetInfo`` that ``givable_bytes`` asks, mean of 200). Every result
is one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CASES = {
    # name: (block, L)
    "voronoi-512": ((8, 16, 128), 32),
    "2d-4096": ((1, 128, 128), 32),
    "grid8-512": ((8, 16, 128), 128),
    "grid4": ((8, 16, 128), 512),
    "empty-512": ((8, 16, 128), 32),
}
HOST_CASE = "voronoi-64"
DATA = os.path.join("build", "sweep_ab")


def make_inputs(repo: str) -> None:
    """Save every case's dense stack and label count under DATA."""
    import numpy as np
    import torch

    sys.path.insert(0, repo)
    from tissue_analysis_tpu_torch.core.stack import LabeledStack
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack, voronoi_stack

    os.makedirs(DATA, exist_ok=True)
    makers = {
        "voronoi-512": lambda: (voronoi_stack((512,) * 3, 3500, seed=1), 1),
        "2d-4096": lambda: (voronoi_stack((4096, 4096), 4000, seed=1), 1),
        "grid8-512": lambda: (grid_stack((512,) * 3, (8, 8, 8)), None),
        "grid4": lambda: (grid_stack((256, 256, 512), (4, 4, 4)), None),
        HOST_CASE: lambda: (voronoi_stack((64,) * 3, 150, seed=0), 1),
    }
    for name, make in makers.items():
        path = os.path.join(DATA, name + ".npy")
        if os.path.exists(path):
            continue
        img, bg = make()
        st = LabeledStack.from_array(img, background=bg, device="cpu")
        dense = st.dense if st.ndim == 3 else st.dense[None]
        if name.startswith("grid"):
            dense = dense.to(torch.int32)
        save(name, dense.numpy(), st.n_labels)
    if not os.path.exists(os.path.join(DATA, "empty-512.npy")):
        save("empty-512", np.ones((512,) * 3, dtype=np.uint16), 1)


def save(name: str, dense, n: int) -> None:
    import numpy as np

    np.save(os.path.join(DATA, name + ".npy"), np.ascontiguousarray(dense))
    with open(os.path.join(DATA, name + ".n"), "w") as f:
        f.write(str(n))


def worker(tree: str, reps: int, smi: str) -> None:
    """Time one tree's kernel on every case; print one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import tissue_analysis_tpu_torch.ops.block_sweep as bs

    if not os.path.abspath(bs.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {bs.__file__}, not the tree {tree}")
    bs.build_kernel()

    def load(name):
        dense = torch.from_numpy(np.load(os.path.join(DATA, name + ".npy"))).cuda()
        with open(os.path.join(DATA, name + ".n")) as f:
            return dense, int(f.read())

    def equal(k, r):
        ok = ~r.ovf.bool()
        return bool(torch.equal(k.ovf, r.ovf)) and all(
            bool(torch.equal(getattr(k, f)[ok], getattr(r, f)[ok]))
            for f in ("ids", "mom", "gmin", "gmax", "faces"))

    def events_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "reps": reps, "cases": {}}
    cap = bs.max_dict_size()
    for name, (block, L) in CASES.items():
        dense, n = load(name)
        ref = bs.block_sweep_reference(dense, n, block, L)
        fn = lambda: bs.block_sweep(dense, n, block, L)  # noqa: E731
        out["cases"][name] = {"equal": equal(fn(), ref), "ms": events_ms(fn)}
        del ref
        count = lambda: bs.block_label_counts(dense, n, block, cap)  # noqa: E731
        want = bs.block_label_counts_reference(dense, n, block, cap)
        out["cases"][name]["count"] = {
            "equal": bool(torch.equal(count(), want)), "ms": events_ms(count),
            "path": getattr(bs.block_label_counts, "path", None)}
        del dense, want
        torch.cuda.empty_cache()
    from tissue_analysis_tpu_torch import engine
    from tissue_analysis_tpu_torch.core.stack import LabeledStack

    def best_ms(fn, reps, before=lambda: None):
        best = float("inf")
        for _ in range(reps):
            before()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    for name in CASES:
        dense, n = load(name)
        st = LabeledStack(dense=dense, ids=np.arange(n), voxelsize=(1.0,) * 3,
                          background_segment=None)
        out["cases"][name]["engine"] = {
            "first_ms": best_ms(lambda: engine.analyze_stack(st), 3, engine._GOOD_L.clear),
            "converged_ms": best_ms(lambda: engine.analyze_stack(st), 7),
            "first_device_ms": best_ms(lambda: engine.finish_stack(engine.dispatch_stack(st)),
                                       3, engine._GOOD_L.clear),
            "device_ms": best_ms(lambda: engine.finish_stack(engine.dispatch_stack(st)), 7),
        }
        del st, dense
        torch.cuda.empty_cache()

    out["count_split"] = count_split(bs, engine, load, LabeledStack, cap)

    dense, n = load(HOST_CASE)
    for _ in range(20):
        bs.block_sweep(dense, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        bs.block_sweep(dense, n)
    t_host = (time.perf_counter() - t0) / 1000
    torch.cuda.synchronize()
    out["host_us_per_launch_64"] = t_host * 1e6
    print(json.dumps(out), flush=True)


def count_split(bs, engine, load, LabeledStack, cap) -> dict:
    """The count's share of a converged ``analyze_stack`` at voronoi-512:
    device ms by the profiler, host µs by the clock (see the docstring)."""
    import numpy as np
    import torch

    from tissue_analysis_tpu_torch.utils import timing

    dense, n = load("voronoi-512")
    st = LabeledStack(dense=dense, ids=np.arange(n), voxelsize=(1.0,) * 3,
                      background_segment=None)
    block = (8, 16, 128)
    engine.analyze_stack(st)  # converged L, allocator warm
    with timing.profile_trace(os.path.join("build", "traces_ab")) as prof:
        engine.analyze_stack(st)
    rows = timing.device_times(prof)
    ops = timing.device_times(prof, by_op=True)
    kernel = [r for r in rows if "block_label_count_kernel" in r[0]]
    split = {
        "kernel_device_ms": sum(r[2] for r in kernel) / 1e3,
        "max_device_ms": sum(us for k, _, us in ops if k == "aten::max") / 1e3,
        "launches_and_copies": sum(r[1] for r in rows),
    }
    pair = getattr(bs, "count_block_labels", None)
    call = ((lambda: pair(dense, n, block, cap)) if pair else
            (lambda: bs.block_label_counts(dense, n, block, cap)))
    read = ((lambda r: int(r.largest)) if pair else (lambda r: int(r.max())))
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    split["wrapper_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(50):
        r = call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        read(r)
        total += time.perf_counter() - t0
    split["readback_host_us"] = total / 50 * 1e6
    t0 = time.perf_counter()
    for _ in range(200):
        torch.cuda.mem_get_info(dense.device)
    split["mem_get_info_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    return split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--order", default="A", help="letters naming trees: A = first")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--smi", default="", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(a.worker, a.reps, a.smi)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    make_inputs(os.path.abspath(a.trees[-1]))
    print(f"inputs ready in {time.perf_counter() - t0:.1f} s; {smi}", flush=True)
    lines = []
    for _ in range(a.rounds):
        for letter in a.order:
            tree = a.trees[ord(letter) - ord("A")]
            cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree,
                   "--reps", str(a.reps), "--smi", smi]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                print(res.stdout, res.stderr, file=sys.stderr)
                return res.returncode
            line = res.stdout.strip().splitlines()[-1]
            lines.append(line)
            rec = json.loads(line)
            summary = ", ".join(
                f"{c} {v['ms']:.3f} ms{'' if v['equal'] else ' UNEQUAL'} (engine first "
                f"{v['engine']['first_ms']:.3f}, converged {v['engine']['converged_ms']:.3f}; "
                f"device first {v['engine']['first_device_ms']:.3f}, converged "
                f"{v['engine']['device_ms']:.3f} ms)"
                for c, v in rec["cases"].items())
            counts = ", ".join(
                f"{c} {v['count']['ms']:.4f} ms{'' if v['count']['equal'] else ' UNEQUAL'}"
                f"{'' if v['count']['path'] is None else ' ' + v['count']['path']}"
                for c, v in rec["cases"].items())
            sp = rec["count_split"]
            print(f"{letter} {tree}: {summary}; host {rec['host_us_per_launch_64']:.1f} us/launch; "
                  f"count {counts}; count split at voronoi-512: kernel "
                  f"{sp['kernel_device_ms']:.4f} ms, max {sp['max_device_ms']:.4f} ms (device), "
                  f"wrapper {sp['wrapper_host_us']:.1f} us, readback {sp['readback_host_us']:.1f} us, "
                  f"mem_get_info {sp['mem_get_info_host_us']:.1f} us (host), "
                  f"{sp['launches_and_copies']} launches and copies a pass", flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    bad = [c for line in lines for c, v in json.loads(line)["cases"].items()
           if not (v["equal"] and v["count"]["equal"])]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
