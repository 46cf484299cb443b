"""tts-cli for the port — command-line TTS generation on the card.

Same flags as the JAX package's `apps/cli.py` (parity: reference
examples/cli/cli.cpp; --n-threads / --use-metal are accepted and ignored),
plus `--device` (default cuda; `--device cpu` runs the plain PyTorch
versions). `--conditional-prompt` re-encodes a Parler model's voice
description through the T5 encoder GGUF at `--text-encoder-path` before
generating; `--play` plays the audio where a playback backend is installed
and otherwise writes the file. A Kokoro model takes `-v` for its voice pack
(the default af_heart falls back to the file's first voice) and
`--espeak-voice-id` for an espeak phonemizer, and writes 24 kHz audio.

    python -m tts_tpu_torch.apps.cli -mp model.gguf -p "Hello" -sp out.wav
"""
from __future__ import annotations

import argparse
import sys
import time

from ..audio.vad import apply_energy_voice_inactivity_detection
from ..audio.wav import write_audio_file
from ..common import GenerationConfig
from ..models.registry import runner_from_file


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tts-cli",
                                description="TTS generation (PyTorch/CUDA port)")
    p.add_argument("--model-path", "-mp", required=True,
                   help="Parler, Kokoro, Orpheus or Dia GGUF model file, "
                        "or test:dummy")
    p.add_argument("--prompt", "-p", required=True,
                   help="text prompt to synthesize")
    p.add_argument("--save-path", "-sp", default="TTS.cpp.wav",
                   help="output .wav/.aiff path")
    p.add_argument("--temperature", "-t", type=float, default=1.0)
    p.add_argument("--topk", "-tk", type=int, default=50)
    p.add_argument("--top-p", "-tp", type=float, default=1.0)
    p.add_argument("--repetition-penalty", "-r", type=float, default=1.0)
    p.add_argument("--no-cross-attn", "-ca", action="store_true")
    p.add_argument("--conditional-prompt", "-cp", default="")
    p.add_argument("--text-encoder-path", "-tep", default="")
    p.add_argument("--voice", "-v", default="")
    p.add_argument("--espeak-voice-id", "-eid", default="")
    p.add_argument("--max-tokens", "-mt", type=int, default=0)
    p.add_argument("--vad", "-va", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--play", action="store_true",
                   help="play audio (requires a playback backend)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    # accepted for reference-CLI compatibility; no-ops here
    p.add_argument("--n-threads", "-nt", type=int, default=0)
    p.add_argument("--use-metal", "-m", action="store_true")
    return p


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = build_parser().parse_args(argv)
    if args.conditional_prompt and not args.text_encoder_path:
        print("The '--text-encoder-path' must be specified when "
              "'--conditional-prompt' is passed.", file=sys.stderr)
        return 1
    if not (0.0 < args.top_p <= 1.0):
        print(f"The '--top-p' value must be between 0.0 and 1.0. It was set "
              f"to '{args.top_p:.6f}'.", file=sys.stderr)
        return 1

    config = GenerationConfig(
        voice=args.voice, top_k=args.topk, temperature=args.temperature,
        repetition_penalty=args.repetition_penalty,
        use_cross_attn=not args.no_cross_attn,
        espeak_voice_id=args.espeak_voice_id, max_tokens=args.max_tokens,
        top_p=args.top_p, seed=args.seed)

    runner = runner_from_file(args.model_path, config, device=args.device)
    if args.conditional_prompt:
        runner.update_conditional_prompt(args.text_encoder_path,
                                         args.conditional_prompt)
    resp = runner.generate(args.prompt, config)
    if resp.n_outputs == 0:
        print(f"Got empty response for prompt, '{args.prompt}'.", file=sys.stderr)
        return 1
    audio = resp.audio
    if args.vad:
        audio = apply_energy_voice_inactivity_detection(
            audio, sample_rate=float(resp.sample_rate))
    played = False
    if args.play:
        try:
            from .playback import play_audio
            played = play_audio(audio, resp.sample_rate)
        except Exception as e:  # noqa: BLE001 — no playback backend
            print(f"playback unavailable ({e}); writing file instead",
                  file=sys.stderr)
    if not played:
        write_audio_file(audio, args.save_path, resp.sample_rate)
    total_ms = (time.perf_counter() - t0) * 1000.0
    print(f"Total time: {total_ms:.2f} ms  "
          f"(audio: {len(audio) / resp.sample_rate:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
