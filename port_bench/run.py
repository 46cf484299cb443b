"""Run one cell of the port's benchmark once, on the card.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`: each number the correctness check compared beside its
limit (also the last lines of standard error). Exits non-zero, printing
no result, without a card (or with fewer than the cell asks for), and if
`jax`, `jaxlib`, `flax` or the JAX package `tts_tpu` was imported.
"""
from __future__ import annotations

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tts_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `tts_tpu_torch` is not `tts_tpu`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # caches of the program's libraries stay in the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "port_bench" / ".cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "port_bench" / ".cache" / "triton"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch
    from port_bench import common, harness
    cell = common.Cell(common.benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, args.trace,
                         device="cuda", t_proc0=T_PROC0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of the JAX side: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
