"""The control: the reference put in the program's place, one bit narrower.

    python3 -m benchmark.control --workload <name> --seeds <a,b,c> [--requests N]

For each seed it makes the answers of N requests (default 64) as the reference computes them with every scalar one bit
narrower than the traffic's ``scalar_bits`` (:func:`reference.control_scalar`),
and compares them, as a run compares the program's, with the reference at
full width.  Each line printed is one seed's comparison; the control is
caught when ``wrong_answers`` is above its limit, 0.  Neither the program
nor a card is needed: the control stands where the program's answers would.
It draws the inputs on the card where there is one, as a run does.
"""

import argparse
import json
import sys
import time

from benchmark import spec


def control_run(cell, seed: int, requests: int) -> dict:
    from benchmark.harness import count_wrong
    from benchmark.traffic import Traffic

    import torch

    traffic = Traffic(cell.traffic, seed)
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    system = cell.system(cell.config, traffic, device)
    t0 = time.perf_counter()
    answers = system.expected(range(requests), bits=traffic.scalar_bits)
    wrong = count_wrong(system, answers)
    return {"workload": cell.name, "seed": seed, "wrong_answers": wrong, "limit": 0, "compared": requests,
            "caught": wrong > 0, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the control of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=64)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    caught = True
    for seed in (int(x) for x in args.seeds.split(",")):
        out = control_run(cell, seed, args.requests)
        caught &= out["caught"]
        print(json.dumps(out), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
