"""perf_battery — Harvard-sentence generation benchmark, the port of the
JAX package's `apps/perf_battery.py`.

Parity: reference examples/perf_battery/perf_battery.cpp — 30 phonetically
balanced Harvard sentences, reporting mean generation time (ms) and mean
real-time factor (generation ms / audio ms). Also emits one JSON line for
automation. Runs on the card unless `--device cpu` is given.

    python -m tts_tpu_torch.apps.perf_battery -mp model.gguf
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# 'Harvard Sentences' (https://en.wikipedia.org/wiki/Harvard_sentences); the
# same set the reference uses (perf_battery.cpp:25-55, including its missing
# comma that fuses two sentences — kept separate here).
TEST_SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "A large size in stockings is hard to sell.",
    "The boy was there when the sun rose.",
    "A rod is used to catch pink salmon.",
    "The source of the huge river is the clear spring.",
    "Kick the ball straight and follow through.",
    "Help the woman get back to her feet.",
    "A pot of tea helps to pass the evening.",
    "Smoky fires lack flame and heat.",
    "The soft cushion broke the man's fall.",
    "The salt breeze came across from the sea.",
    "The girl at the booth sold fifty bonds.",
    "The small pup gnawed a hole in the sock.",
    "The fish twisted and turned on the bent hook.",
    "Press the pants and sew a button on the vest.",
    "The swan dive was far short of perfect.",
    "The beauty of the view stunned the young boy.",
    "Two blue fish swam in the tank.",
    "Her purse was full of useless trash.",
    "The colt reared and threw the tall rider.",
    "It snowed, rained, and hailed the same morning.",
    "Read verse out loud for pleasure.",
]


def run_battery(runner, config, sentences=None, warmup: bool = True):
    """Generate each sentence once (after one untimed warm-up call that
    builds the kernels and fills the caches); returns (generation ms,
    audio ms) per sentence, the audio NaN where a call returned none."""
    sentences = sentences or TEST_SENTENCES
    if warmup:
        runner.generate(sentences[0], config)
    gen_ms, audio_ms = [], []
    for sentence in sentences:
        t0 = time.perf_counter()
        resp = runner.generate(sentence, config)
        dt = (time.perf_counter() - t0) * 1000.0
        gen_ms.append(dt)
        audio_ms.append(resp.n_outputs / (resp.sample_rate / 1000.0)
                        if resp.n_outputs else float("nan"))
    return gen_ms, audio_ms


def printout(arch, gen_ms, audio_ms):
    """(the reference's text report, the JSON blob) of a battery's lists."""
    gen_mean = float(np.mean(gen_ms))
    rtf = [g / a for g, a in zip(gen_ms, audio_ms) if a and not np.isnan(a)]
    rtf_mean = float(np.mean(rtf)) if rtf else float("nan")
    text = (f"Mean Stats for arch {arch}:\n\n"
            f"  Generation Time (ms):             {gen_mean:.6f}\n"
            f"  Generation Real Time Factor (ms): {rtf_mean:.6f}\n")
    blob = {"arch": arch, "mean_generation_ms": round(gen_mean, 3),
            "mean_generation_rtf": round(rtf_mean, 6),
            "sentences": len(gen_ms)}
    return text, blob


def main(argv=None) -> int:
    from ..common import GenerationConfig
    from ..models.registry import runner_from_file

    p = argparse.ArgumentParser(prog="perf_battery")
    p.add_argument("--model-path", "-mp", required=True)
    p.add_argument("--temperature", "-t", type=float, default=1.0)
    p.add_argument("--topk", "-tk", type=int, default=50)
    p.add_argument("--repetition-penalty", "-r", type=float, default=1.0)
    p.add_argument("--voice", "-v", default="")
    p.add_argument("--no-cross-attn", "-ca", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--n-threads", "-nt", type=int, default=0)  # compat no-op
    p.add_argument("--use-metal", "-m", action="store_true")   # compat no-op
    args = p.parse_args(argv)

    config = GenerationConfig(
        voice=args.voice, top_k=args.topk, temperature=args.temperature,
        repetition_penalty=args.repetition_penalty,
        use_cross_attn=not args.no_cross_attn)
    runner = runner_from_file(args.model_path, config, device=args.device)
    gen_ms, audio_ms = run_battery(runner, config)
    text, blob = printout(runner.arch, gen_ms, audio_ms)
    print(text)
    print(json.dumps(blob))
    return 0


if __name__ == "__main__":
    sys.exit(main())
