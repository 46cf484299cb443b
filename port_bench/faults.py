"""Faults planted in the timed path, for the tests that show the
correctness check fails a broken program: each is a function of the run
and the built runner, applied after set-up through `Run.patch` (undone at
the run's end). The cells run on one chip, so a fault of the exchange
between chips has no place to be planted.
"""
from __future__ import annotations

import importlib


def frozen_step(run, runner) -> None:
    """A decode chunk that returns its state unchanged."""
    def same(cfg, w, st, *a, **k):
        return st
    if run.traffic["mode"] == "server":
        mod = importlib.import_module(run.fam.ENGINE_MODULE)
        run.patch(mod, run.fam.ENGINE_CHUNK, same)
    else:
        mod = importlib.import_module(run.fam.RUNNER_MODULE)
        run.patch(mod, "decode_chunk", same)


def half_batch(run, runner) -> None:
    """Half of the batch left out, the mean taken over the rest: the LM
    heads computed for the first half of the rows, and every row given
    their mean (Dia: the guidance pair's unconditional row left out, its
    conditional row taken for both)."""
    mod = importlib.import_module(run.fam.ENGINE_MODULE
                                  if run.traffic["mode"] == "server"
                                  else run.fam.RUNNER_MODULE)
    if hasattr(mod, "cfg_logits"):
        plain = mod.cfg_logits

        def cfg_logits(cfg, w, h):
            return plain(cfg, w, h[0::2].repeat_interleave(2, 0))
        run.patch(mod, "cfg_logits", cfg_logits)
    else:
        plain = mod._logits_last

        def logits_last(cfg, w, x):
            out = plain(cfg, w, x[:max(1, x.shape[0] // 2)])
            return out.mean(0, keepdim=True).expand(x.shape[0], -1, -1)
        run.patch(mod, "_logits_last", logits_last)


def token_altered(run, runner) -> None:
    """One channel's token moved to the next id where it is drawn."""
    from tts_tpu_torch.ops import sampling
    audio = run.cfg["audio_vocab_size"]

    def alter(t):
        t = t.clone()
        t[..., 3] = (t[..., 3] + 1) % audio
        return t

    if run.traffic["mode"] == "server":
        plain = sampling.select_batched

        def select_batched(*a, **k):
            toks, st = plain(*a, **k)
            return alter(toks), st
        run.patch(sampling, "select_batched", select_batched)
    else:
        plain = sampling.sample_or_greedy

        def sample_or_greedy(*a, **k):
            toks, st = plain(*a, **k)
            return alter(toks), st
        run.patch(sampling, "sample_or_greedy", sample_or_greedy)


FAULTS = {"frozen_step": frozen_step, "half_batch": half_batch,
          "token_altered": token_altered}
