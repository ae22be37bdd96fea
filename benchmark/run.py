"""Run one cell of BENCHMARK.json once and print its result as the last line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero with no result when the card is
missing, when a forbidden module was loaded, or when anything fails.
"""

import os
import sys
import time

T0 = time.perf_counter()  # set-up is timed from here

# The bytecode of every module a run imports, torch's above all (some 5 s to
# compile on a machine that ships none), cached at a fixed path inside the
# checkout, so that only a checkout's first run compiles it; also where the
# environment asks for no bytecode to be written. A prefix set by the
# caller's environment wins.
sys.pycache_prefix = sys.pycache_prefix or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t = time.perf_counter()
    import torch

    split = [("import torch", time.perf_counter() - t)]
    from benchmark import harness

    reg = harness.Registry()
    chips = reg.cell(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    try:
        result, lines = harness.run_cell(reg, args.workload, args.seed, args.seconds,
                                         bool(args.trace), t0=T0, split=split)
    except harness.Forbidden as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
