#!/usr/bin/env python3
"""Readings of the numbers that decide ``correct``, for setting their limits.

    python perfbench/calibrate.py --workload meristem-512.resident \\
        --seeds 11 12 13 --control-seeds 21 22 23 --seconds 2 \\
        --out build/calibrate.json

One process runs the cell once for each of ``--seeds`` with the program
(the lower readings: sound runs) and once for each of ``--control-seeds``
with the control in its place (:mod:`perfbench.control`: the upper
readings), each a short window at the cell's own sizes and load, and writes
every run's compared numbers to ``--out`` as JSON, the largest sound and
the smallest control reading of each number beside them. The benchmark's
own runs never run it. Needs the cell's CUDA devices, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    build = os.path.join(ROOT, "build")
    os.environ["TA_NATIVE_CACHE"] = os.path.join(build, "native")
    sys.path.insert(0, ROOT)

    import torch

    from perfbench import control, harness, spec

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    cell = spec.load_cell(args.workload, ROOT)
    runs = []
    for role, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            wrap = control.control_pass(cell.config) if role == "control" else None
            res = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                                   t0, wrap=wrap)
            got = {k: v["value"] for k, v in res["checks"].items()}
            runs.append({"role": role, "seed": seed, "correct": res["correct"],
                         "passes": res["attempted"], "checks": got,
                         "run_s": time.perf_counter() - t0})
            print(json.dumps(runs[-1]), flush=True)
            torch.cuda.empty_cache()
    names = list(runs[0]["checks"]) if runs else []
    summary = {}
    for n in names:
        sound = [r["checks"][n] for r in runs if r["role"] == "program"]
        ctrl = [r["checks"][n] for r in runs if r["role"] == "control"]
        summary[n] = {"lower": max(sound) if sound else None,
                      "upper": min(ctrl) if ctrl else None}
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "runs": runs, "readings": summary}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
