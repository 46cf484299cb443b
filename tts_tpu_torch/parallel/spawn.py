"""Run a function on every rank of a small world of local processes.

    from tts_tpu_torch.parallel.spawn import run_ranks
    logs = run_ranks("my_module:rank_main", 4, args=(out_dir,),
                     backend="gloo", device="cpu", timeout=120)

starts `world` Python processes, each of which joins a process group
through a `file://` rendezvous in a fresh temporary directory (no TCP port,
so several worlds may come up on one machine at once), calls
`rank_main(*args)` and leaves the group. `device` is every rank's device
("cpu", or "cuda:0" for ranks that share one card; None gives each rank
cuda:LOCAL_RANK); `backend` is passed on as given (see
distributed.init_distributed). On the CPU each rank runs torch on one
thread.

The parent waits at most `timeout` seconds. When a rank exits non-zero or
the time runs out it kills every rank still running and raises with each
rank's last output; otherwise it returns each rank's output (stdout and
stderr). `env` adds environment variables for every rank (a dict) or each
rank (a list of dicts).
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])   # the directory holding the package


def run_ranks(target: str, world: int, *, args=(), timeout: float,
              backend: str | None = None, device: str | None = None,
              env=None) -> list[str]:
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        spec = json.dumps(dict(target=target, args=list(args), world=world,
                               init=f"file://{tmp}/rendezvous",
                               backend=backend, device=device))
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs = []
        try:
            for r in range(world):
                e = dict(os.environ)
                e["PYTHONPATH"] = os.pathsep.join(
                    [ROOT] + [p for p in [e.get("PYTHONPATH")] if p])
                e.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                         LOCAL_WORLD_SIZE=str(world))
                e.update((env[r] if isinstance(env, list) else env) or {})
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tts_tpu_torch.parallel.spawn", spec],
                    stdout=logs[r], stderr=subprocess.STDOUT, env=e))
            deadline = time.monotonic() + timeout
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                elif time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout:.0f} s"
                else:
                    time.sleep(0.05)
            if failed is None:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        out = []
        for f in logs:
            f.seek(0)
            out.append(f.read())
            f.close()
        if failed is not None:
            tails = "\n".join(f"--- rank {r} ---\n{o[-4000:]}"
                              for r, o in enumerate(out))
            raise RuntimeError(f"{target} on {world} ranks: {failed}\n{tails}")
        return out


def _rank_main(spec: dict) -> None:
    import torch
    import torch.distributed as dist
    from .distributed import init_distributed
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    init_distributed(spec["init"], spec["world"], backend=spec["backend"],
                     device=spec["device"])
    try:
        mod, fn = spec["target"].split(":")
        getattr(importlib.import_module(mod), fn)(*spec["args"])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(json.loads(sys.argv[1]))
