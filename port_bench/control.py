"""The correctness check's control, on the card at a cell's own size.

    python3 port_bench/control.py --workload <name> --seed <n> [--seed ...]
        [--seconds <s>]

For each seed: one run of the cell (as run.py makes it, a short window),
then, beside the program's readings of each number compared, the
control's: the plain reference put in the program's place in the nearest
precision below the configuration's (fp8 where the program rounds to
bfloat16: every product's input, the caches and Dia's cross K / V; the
DAC with TF32 for its float32), read on the same prompts and tokens, and
judged by the same comparison with the cell's limits as the program:
`control_correct`, and `control_correct_f32_dac` for fp8 in the decoder
with the DAC in float32. Both have to come out false. Prints one JSON
line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from port_bench import common, harness
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = common.Cell(common.benchmark(ROOT), args.workload, ROOT)
    for seed in args.seed:
        t0 = time.perf_counter()
        res = harness.run(cell, seed, args.seconds, 0, device="cuda",
                          t_proc0=t0, control=True)
        out = {"workload": args.workload, "seed": seed,
               "correct": res["correct"], **res["control"],
               "checks": {k: v["value"] for k, v in res["checks"].items()},
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
