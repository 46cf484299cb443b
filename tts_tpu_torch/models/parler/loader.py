"""Parler runner assembly from a GGUF file (parity: parler/loader.cpp)."""
from __future__ import annotations

from ...common import GenerationConfig, default_device
from ...gguf.reader import GGUFReader
from ...text import UnigramTokenizer
from ..codec.dac import DACConfig, DACRunner, load_dac_weights
from .model import ParlerConfig, ParlerRunner, load_parler_weights


def load_parler_runner(reader: GGUFReader, config: GenerationConfig,
                       device=None) -> ParlerRunner:
    """Build a ParlerRunner on `device` (default cuda) and close the reader:
    every tensor is copied onto the device."""
    dev = default_device(device)
    try:
        cfg = ParlerConfig.from_gguf(reader)
        cfg.use_cross_attn = config.use_cross_attn
        tokenizer = UnigramTokenizer.from_gguf(reader)
        weights = load_parler_weights(reader, cfg, device=dev)
        dac = None
        if any(n.startswith("audio_encoder.") for n in reader.tensor_names()):
            dac_cfg = DACConfig.from_gguf(reader)
            dac = DACRunner(dac_cfg, load_dac_weights(reader, dac_cfg, device=dev))
    finally:
        reader.close()
    return ParlerRunner(cfg, weights, tokenizer, dac)
