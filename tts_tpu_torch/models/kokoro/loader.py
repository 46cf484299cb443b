"""Kokoro runner assembly from a GGUF file (parity: kokoro/loader.cpp)."""
from __future__ import annotations

from ...common import GenerationConfig, default_device, strict_fp32
from ...gguf.reader import GGUFReader
from ...text import SinglePassTokenizer
from .model import KokoroConfig, KokoroRunner, load_kokoro_weights, load_voices


def load_kokoro_runner(reader: GGUFReader, config: GenerationConfig,
                       device=None) -> KokoroRunner:
    """Build a KokoroRunner on `device` (default cuda) and close the reader:
    every tensor is copied onto the device (the voice packs stay on the
    host; one row a chunk goes to the device). The rule-based phonemizer
    comes from the same file's `phonemizer.*` keys when it has them."""
    dev = default_device(device)
    strict_fp32()
    try:
        cfg = KokoroConfig.from_gguf(reader)
        tokenizer = SinglePassTokenizer.from_gguf(reader, "tokenizer.ggml.tokens")
        weights = load_kokoro_weights(reader, cfg, device=dev)
        # the reference hardcodes style_half_size=128 and harmonic_num=8
        # (kokoro/model.h:212,227); infer them from the weights so small
        # checkpoints work
        cfg.style_half_size = int(weights.prosody.layers_ada[0].gamma_w.shape[1])
        cfg.harmonic_num = int(weights.decoder.generator.m_source_w.shape[1]) - 1
        voices = load_voices(reader)
        phonemizer = None
        if "phonemizer.graphemes" in reader.metadata:
            try:
                from ...text.phonemizer import Phonemizer
                phonemizer = Phonemizer.from_gguf(reader)
            except Exception:  # noqa: BLE001 — as the JAX loader: no phonemizer
                phonemizer = None
    finally:
        reader.close()
    return KokoroRunner(cfg, weights, tokenizer, voices, phonemizer, device=dev)
