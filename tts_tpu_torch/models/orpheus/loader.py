"""Orpheus runner assembly from a GGUF file (parity: orpheus/loader.cpp)."""
from __future__ import annotations

from ...common import GenerationConfig, default_device
from ...gguf.reader import GGUFReader
from ...text import BPETokenizer
from ..codec.snac import SNACConfig, SNACRunner, load_snac_weights
from .model import OrpheusConfig, OrpheusRunner, load_orpheus_weights


def load_orpheus_runner(reader: GGUFReader, config: GenerationConfig,
                        device=None) -> OrpheusRunner:
    """Build an OrpheusRunner on `device` (default cuda) and close the
    reader: every tensor is copied onto the device. The SNAC decoder comes
    from the same file's `snac.` tensors when it has them."""
    dev = default_device(device)
    try:
        cfg = OrpheusConfig.from_gguf(reader)
        tokenizer = BPETokenizer.from_gguf(reader)
        weights = load_orpheus_weights(reader, cfg, device=dev)
        snac = None
        if any(n.startswith("snac.") for n in reader.tensor_names()):
            snac_cfg = SNACConfig.from_gguf(reader)
            snac = SNACRunner(snac_cfg, load_snac_weights(reader, snac_cfg,
                                                          device=dev))
    finally:
        reader.close()
    return OrpheusRunner(cfg, weights, tokenizer, snac)
