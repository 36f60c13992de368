#!/usr/bin/env python3
"""Benchmark of tissue_analysis_tpu_torch: one run of one cell.

    python perfbench/run.py --workload meristem-512.resident --seed 7 \\
        --seconds 20 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the ``tissue_analysis_tpu_torch`` package. The cell's configuration,
traffic mix and metrics are found by name from ``BENCHMARK.json``
(``perfbench/spec.py``); ``perfbench/harness.py`` says what a run does.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
which the last lines of standard error repeat.

The run fails, and prints no result, without as many CUDA devices as the
cell asks for, when the program's package is not the checkout's own, and
when the process holds a module of JAX or of the JAX package after the
window. The program's kernel library and its native host library are built
into ``build/`` inside the checkout, so that only a checkout's first run
builds them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = os.path.join(ROOT, "build")
    os.environ["TA_NATIVE_CACHE"] = os.path.join(build, "native")
    os.environ.pop("TA_STAGE_VERBOSE", None)  # it would fence every stage
    sys.path.insert(0, ROOT)

    from perfbench import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"the cell asks for {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} are visible")
    try:
        import tissue_analysis_tpu_torch as program
    except ImportError as e:
        _fail(f"the program's package is missing from this checkout: {e}")
    where = os.path.dirname(os.path.abspath(program.__file__))
    if os.path.dirname(where) != ROOT:
        _fail(f"tissue_analysis_tpu_torch was imported from {where}, not from {ROOT}")
    first = not glob.glob(os.path.join(build, "kernels", "*.so"))

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, first_setup=first)

    found = sorted(m for m in sys.modules if m.split(".")[0] in spec.BLOCKED_MODULES)
    if found:
        _fail(f"modules that no run may load are loaded: {', '.join(found)}", 3)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
