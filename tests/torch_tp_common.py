"""Helpers for the port's parallelism tests: run a rank program of
tests/torch_tp_ranks.py on 4 spawned CPU ranks (gloo, a file:// rendezvous,
one torch thread a rank) and read back what each rank wrote."""
import os

import torch

from tts_tpu_torch.parallel.spawn import ROOT, run_ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT = 300   # seconds for the whole world; a hung rank fails the test


def on_ranks(tmp_path, fn, inputs, world=4, env=None):
    torch.save(inputs, os.path.join(tmp_path, "in.pt"))
    base = {"PYTHONPATH": os.pathsep.join([ROOT, TESTS])}
    envs = [dict(base, **e) for e in env] if env else base
    run_ranks(f"torch_tp_ranks:{fn}", world, args=(str(tmp_path),),
              timeout=RANK_TIMEOUT, backend="gloo", device="cpu", env=envs)
    return [torch.load(os.path.join(tmp_path, f"out{r}.pt"), weights_only=False)
            for r in range(world)]
