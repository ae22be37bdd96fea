"""The readings the limits of ``correct`` are set from: the program's sound
runs over many seeds, and the control (the plain reference computed one
precision below the configuration's, in the program's place) over a few.

    python -m benchmark.control --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 --seconds 2

One process, on the card, at the cell's own size. Prints one JSON line per
reading, then each number's lower reading (the largest over the program's
seeds) and upper reading (the smallest over the control's). The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys


def control_reading(reg, cell, seed, device="cuda"):
    """The judged numbers of the control on ``seed``'s inputs, each with its
    limit."""
    from benchmark import harness

    c = reg.cell(cell)
    cfg = reg.config(c["config"])
    driver = importlib.import_module(f"benchmark.drivers.{cfg['driver']}")
    dev = harness.Device(device)
    session = driver.Session(reg, cfg, reg.data("traffic", c["traffic"]), seed, dev)
    session.step(harness.Record(cell, seed))  # one call, so a sort has a batch to judge
    session.close()
    return session.judge(control=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings of the program and of the control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA device", file=sys.stderr)
        return 2
    reg = harness.Registry()
    lower, upper = {}, {}
    for seed in args.seeds:
        result, _ = harness.run_cell(reg, args.workload, seed, args.seconds, False)
        values = {k: c["value"] for k, c in result["checks"].items()}
        print(json.dumps({"seed": seed, "side": "program", "correct": result["correct"],
                          "values": values}), flush=True)
        for k, v in values.items():
            lower[k] = max(lower.get(k, v), v)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        values = {k: v for k, (v, _) in control_reading(reg, args.workload, seed).items()}
        print(json.dumps({"seed": seed, "side": "control", "values": values}), flush=True)
        for k, v in values.items():
            upper[k] = min(upper.get(k, v), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
