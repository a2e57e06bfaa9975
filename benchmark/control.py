#!/usr/bin/env python3
"""The control of a cell's comparison, read on the card at the cell's own
size: the reference computed with its planes rounded through bfloat16,
put in the program's place, for each seed given. Every number it prints
has to lie above its limit on some number of the cell (the benchmark's
own runs never run this).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 3
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "reference"), os.path.dirname(HERE)]

from hrbench import runner  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        res = runner.run(args.workload, seed, args.seconds, False, device="cuda",
                         control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"], "checks": res["checks"]}),
              flush=True)
        failed_all &= not res["correct"]
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
