"""phonemize — standalone text -> IPA command line for the port.

Parity: reference examples/phonemize/phonemize.cpp (flags --phonemizer-path,
--prompt, --use-espeak). Host-only: the phonemizer is pure Python.

    python -m tts_tpu_torch.apps.phonemize -mp kokoro.gguf -p "Hello there."
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phonemize",
                                description="Convert text to IPA phonemes")
    p.add_argument("--phonemizer-path", "-mp", default="",
                   help="GGUF file containing phonemizer rules (or a model "
                        "GGUF with embedded phonemizer)")
    p.add_argument("--prompt", "-p", required=True)
    p.add_argument("--use-espeak", "-ue", action="store_true")
    p.add_argument("--espeak-voice-id", "-eid", default="gmw/en-US")
    args = p.parse_args(argv)

    if args.use_espeak:
        from ..text.phonemizer import EspeakPhonemizer
        ph = EspeakPhonemizer(voice=args.espeak_voice_id)
    else:
        if not args.phonemizer_path:
            print("--phonemizer-path is required for the native phonemizer",
                  file=sys.stderr)
            return 1
        from ..gguf.reader import GGUFReader
        from ..text.phonemizer import Phonemizer
        with GGUFReader(args.phonemizer_path) as r:
            ph = Phonemizer.from_gguf(r)
    print(ph.text_to_phonemes(args.prompt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
