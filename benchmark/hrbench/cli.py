"""The command line of one run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA cards as the cell asks for and exits non-zero,
printing no result, without them. Its last line on standard output is the
result's JSON object; its last lines on standard error are the numbers
compared, each beside its limit."""
from __future__ import annotations

import argparse
import json
import os
import sys


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    from hrbench import cells

    # kernel caches at fixed paths inside the checkout (the port builds
    # its own kernels into hybrid_rendering_torch/build/)
    cache = os.path.join(cells.BENCH_DIR, "out", "cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    import torch

    # the program's host work is one Python thread issuing to the card;
    # few intra-op threads keep the process from contending with itself
    torch.set_num_threads(2)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from hrbench import runner

    result = runner.run(args.workload, args.seed, args.seconds, bool(args.trace),
                        device="cuda", t0=t0)
    frames_path = runner.write_summary(args.workload, args.seed, {
        "frame_intervals_ms": result.pop("frame_intervals_ms"),
        "trace_record": result.pop("trace_record", None)}, "frames" if not args.trace else "trace")
    print(f"frames and trace record: {frames_path}", file=sys.stderr)
    card = runner.power_limit()
    result["card"] = card
    checks = result.pop("checks")
    result["checks"] = checks  # the numbers compared come last
    print(f"card: {card}", file=sys.stderr)
    print("set-up phases: " + ", ".join(f"{k} {v:.3f}" for k, v in result["setup_phases"].items()),
          file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
