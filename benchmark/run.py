"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks.  With ``--trace 0`` the
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones.  Exit 0 with a correct result, 1 with a wrong one; 2, with no result
printed, where the run cannot measure (no card, too few cards, no native
library, an unknown cell), where a metric that the cell declares read
nothing (a traced run whose profiler dropped a K1 launch), or where ``jax``
or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness, spec

    try:
        cell = spec.load_cell(args.workload)
        line, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    except (harness.SetupError, harness.NotMeasured, KeyError, ImportError, FileNotFoundError) as e:
        print(f"[benchmark] cannot measure: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"[benchmark] the process loaded {bad}: the port's run must not load JAX or the JAX package",
              file=sys.stderr, flush=True)
        return 2
    for c in checks:
        print(f"[benchmark] {c}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
