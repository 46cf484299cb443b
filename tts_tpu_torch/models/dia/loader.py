"""Dia runner assembly from a GGUF file (parity: dia/loader.cpp)."""
from __future__ import annotations

from ...common import GenerationConfig, default_device
from ...gguf.reader import GGUFReader
from ..codec.dac import DACConfig, DACRunner, load_dac_weights
from .model import DiaConfig, DiaRunner, load_dia_weights


def load_dia_runner(reader: GGUFReader, config: GenerationConfig,
                    device=None) -> DiaRunner:
    """Build a DiaRunner on `device` (default cuda) and close the reader:
    every tensor is copied onto the device. The DAC-44k decoder comes from
    the same file's `audio_encoder.` tensors when it has them."""
    dev = default_device(device)
    try:
        cfg = DiaConfig.from_gguf(reader)
        weights = load_dia_weights(reader, cfg, device=dev)
        dac = None
        if any(n.startswith("audio_encoder.") for n in reader.tensor_names()):
            dac_cfg = DACConfig.from_gguf(reader)
            dac = DACRunner(dac_cfg, load_dac_weights(reader, dac_cfg,
                                                      device=dev))
    finally:
        reader.close()
    return DiaRunner(cfg, weights, dac, device=dev)
