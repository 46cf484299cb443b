"""GGUF checkpoint writers (offline tooling), the port of the JAX package's
`convert/writers.py`.

Given plain numpy weight dicts (e.g. extracted from HF torch state dicts),
write GGUF files with the exact key/tensor naming the reference engine, the
JAX package and this port load. The download step is decoupled: callers
hand in arrays. The files are written with the port's own GGUF writer
(`gguf/writer.py`) on the host, byte for byte those of the JAX writers.

Naming parity: py-gguf/tts_encoders/*.py (see each function's docstring).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..gguf import GGUFWriter


def write_parler_gguf(
    path: str,
    *,
    hidden_size: int,
    n_layers: int,
    n_attn_heads: int,
    n_output_heads: int,
    output_vocab_size: int,
    max_generation: int,
    max_ctx: int,
    bos_token_id: int,
    eos_token_id: int,
    decoder_tensors: Dict[str, np.ndarray],
    tokenizer_tokens: Sequence[str],
    tokenizer_scores: Sequence[float],
    tokenizer_unk_id: int = 0,
    tokenizer_eos_id: int = 1,
    text_encoding: Optional[np.ndarray] = None,
    dac_tensors: Optional[Dict[str, np.ndarray]] = None,
    dac_strides: Sequence[int] = (8, 8, 4, 2),
    dac_paddings: Sequence[int] = (4, 4, 2, 1),
    dac_up_sampling_factor: int = 512,
) -> None:
    """Parler-TTS GGUF (parity: parler_tts_gguf_encoder.py + dac encoder).

    decoder_tensors keys are relative to the 'decoder.' prefix (e.g.
    'layers.0.self_attn.q_proj.weight'); dac_tensors relative to
    'audio_encoder.'.
    """
    w = GGUFWriter(path, "parler-tts")
    w.add_u32("parler-tts.decoder.hidden_size", hidden_size)
    w.add_u32("parler-tts.decoder.num_hidden_layers", n_layers)
    w.add_u32("parler-tts.decoder.attention.head_count", n_attn_heads)
    w.add_u32("parler-tts.decoder.output_heads", n_output_heads)
    w.add_u32("parler-tts.decoder.out_vocab_size", output_vocab_size)
    w.add_u32("parler-tts.decoder.audio_vocab_size", eos_token_id)
    w.add_u32("parler-tts.decoder.max_generation", max_generation)
    w.add_u32("parler-tts.decoder.context_length", max_ctx)
    w.add_u32("audio.bos_token_id", bos_token_id)
    w.add_u32("audio.eos_token_id", eos_token_id)
    if text_encoding is not None:
        w.add_u32("parler-tts.decoder.encode_length", text_encoding.shape[0])
    w.add_str("tokenizer.ggml.model", "unigram")
    w.add_array("tokenizer.ggml.tokens", list(tokenizer_tokens))
    w.add_array("tokenizer.ggml.scores",
                np.asarray(tokenizer_scores, np.float32))
    w.add_u32("tokenizer.ggml.unknown_token_id", tokenizer_unk_id)
    w.add_u32("tokenizer.ggml.eos_token_id", tokenizer_eos_id)
    if dac_tensors is not None:
        w.add_u32("dac.up_scaling_factor", dac_up_sampling_factor)
        w.add_u32("dac.up_sampling_factor", dac_up_sampling_factor)
        for i, (s, p) in enumerate(zip(dac_strides, dac_paddings)):
            w.add_u32(f"dac.dac_layer_stride_{i}", s)
            w.add_u32(f"dac.dac_layer_padding_{i}", p)
    for name, arr in decoder_tensors.items():
        w.add_tensor(f"decoder.{name}", np.asarray(arr, np.float32))
    if text_encoding is not None:
        w.add_tensor("decoder.text_encoding",
                     np.asarray(text_encoding, np.float32))
    for name, arr in (dac_tensors or {}).items():
        w.add_tensor(f"audio_encoder.{name}", np.asarray(arr, np.float32))
    w.write()


def write_t5_gguf(
    path: str,
    *,
    hidden_size: int,
    n_layers: int,
    n_attn_heads: int,
    vocab_size: int,
    output_size: int,
    tensors: Dict[str, np.ndarray],
    tokenizer_tokens: Sequence[str],
    tokenizer_scores: Sequence[float],
    max_ctx: int = 512,
) -> None:
    """T5 encoder GGUF (parity: t5_encoder_gguf_encoder.py). tensors keys are
    full names ('t5encoder.enc.blk.N.attn_q', ...)."""
    w = GGUFWriter(path, "t5encoder")
    w.add_u32("t5encoder.embedding_length", hidden_size)
    w.add_u32("t5encoder.block_count", n_layers)
    w.add_u32("t5encoder.attention.head_count", n_attn_heads)
    w.add_u32("t5encoder.vocab_size", vocab_size)
    w.add_u32("t5encoder.output_size", output_size)
    w.add_u32("t5encoder.context_length", max_ctx)
    w.add_str("tokenizer.ggml.model", "unigram")
    w.add_array("tokenizer.ggml.tokens", list(tokenizer_tokens))
    w.add_array("tokenizer.ggml.scores",
                np.asarray(tokenizer_scores, np.float32))
    w.add_u32("tokenizer.ggml.unknown_token_id", 2)
    w.add_u32("tokenizer.ggml.eos_token_id", 1)
    w.add_u32("tokenizer.ggml.bos_token_id", 0)
    for name, arr in tensors.items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    w.write()


def write_kokoro_gguf(
    path: str,
    *,
    albert_hidden: int,
    albert_layers: int,
    albert_heads: int,
    albert_recurrence: int,
    duration_hidden: int,
    f0_n_blocks: int,
    duration_layers: int,
    text_encoder_layers: int,
    gen_kernels: int,
    gen_upsamples: int,
    decoder_blocks: int,
    gen_padding: int,
    gen_n_fft: int,
    gen_hop: int,
    up_sampling_factor: int,
    up_strides: Sequence[int],
    up_paddings: Sequence[int],
    noise_strides: Sequence[int],
    noise_paddings: Sequence[int],
    res_dilations: Sequence[Sequence[int]],
    res_paddings: Sequence[Sequence[int]],
    noise_res_dilations: Sequence[Sequence[int]],
    noise_res_paddings: Sequence[Sequence[int]],
    tensors: Dict[str, np.ndarray],
    voices: Dict[str, np.ndarray],
    tokenizer_tokens: Sequence[str],
    phonemizer: Optional[dict] = None,
    max_context_length: int = 512,
) -> None:
    """Kokoro GGUF (parity: kokoro_gguf_encoder.py metadata + tensor naming;
    tensors keys are full names under 'kokoro.', voices are (N, 256) packs)."""
    w = GGUFWriter(path, "kokoro")
    a = "kokoro.duration_predictor.albert"
    w.add_u32(f"{a}.context_length", max_context_length)
    w.add_u32(f"{a}.hidden_size", albert_hidden)
    w.add_u32(f"{a}.layers", albert_layers)
    w.add_u32(f"{a}.attn_heads", albert_heads)
    w.add_u32(f"{a}.recurrence", albert_recurrence)
    w.add_u32("kokoro.duration_predictor.hidden_size", duration_hidden)
    w.add_u32("kokoro.duration_predictor.f0_n_blocks", f0_n_blocks)
    w.add_u32("kokoro.duration_predictor.layers", duration_layers)
    w.add_u32("kokoro.text_encoder.layers", text_encoder_layers)
    g = "kokoro.decoder.generator"
    w.add_u32(f"{g}.kernels", gen_kernels)
    w.add_u32(f"{g}.upsamples", gen_upsamples)
    w.add_u32(f"{g}.layers", decoder_blocks)
    w.add_u32(f"{g}.padding", gen_padding)
    w.add_u32(f"{g}.n_fft", gen_n_fft)
    w.add_u32(f"{g}.hop", gen_hop)
    w.add_u32(f"{g}.up_sampling_factor", up_sampling_factor)
    for i, (s, p) in enumerate(zip(up_strides, up_paddings)):
        w.add_u32(f"{g}.up_convs.{i}.stride", s)
        w.add_u32(f"{g}.up_convs.{i}.padding", p)
    for i, (s, p) in enumerate(zip(noise_strides, noise_paddings)):
        w.add_u32(f"{g}.noise_blocks.{i}.stride", s)
        w.add_u32(f"{g}.noise_blocks.{i}.padding", p)
        for j, (d, pp) in enumerate(zip(noise_res_dilations[i],
                                        noise_res_paddings[i])):
            w.add_u32(f"{g}.noise_blocks.{i}.res_block.{j}.dilation", d)
            w.add_u32(f"{g}.noise_blocks.{i}.res_block.{j}.padding", pp)
    for i, (dil, pad) in enumerate(zip(res_dilations, res_paddings)):
        for j, (d, pp) in enumerate(zip(dil, pad)):
            w.add_u32(f"{g}.res_blocks.{i}.{j}.dilation", d)
            w.add_u32(f"{g}.res_blocks.{i}.{j}.padding", pp)
    w.add_array("tokenizer.ggml.tokens", list(tokenizer_tokens))
    w.add_array("kokoro.voices", sorted(voices))
    if phonemizer:
        w.add_u32("phonemizer.type", 0)
        w.add_array("phonemizer.graphemes", phonemizer["graphemes"])
        w.add_array("phonemizer.rules.keys", phonemizer.get("rule_keys", []))
        w.add_array("phonemizer.rules.phonemes", phonemizer.get("rule_phonemes", []))
        w.add_array("phonemizer.dictionary.keys", phonemizer.get("dict_keys", []))
        w.add_array("phonemizer.dictionary.values", phonemizer.get("dict_values", []))
    for name, arr in tensors.items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    for name, pack in voices.items():
        w.add_tensor(f"kokoro.voice_tensors.{name}", np.asarray(pack, np.float32))
    w.write()


def write_dia_gguf(
    path: str,
    *,
    head_size: int,
    encoder_hidden: int,
    decoder_hidden: int,
    encoder_layers: int,
    decoder_layers: int,
    encoder_heads: int,
    decoder_heads: int,
    query_heads: int,
    output_heads: int,
    output_vocab: int,
    audio_vocab: int,
    max_generation: int,
    max_encoder_context: int,
    eos_token_id: int,
    bos_token_id: int,
    pad_token_id: int,
    max_delay: int,
    tensors: Dict[str, np.ndarray],
    delay_pattern: Optional[Sequence[int]] = None,
    dac_tensors: Optional[Dict[str, np.ndarray]] = None,
    dac_strides: Sequence[int] = (8, 8, 4, 2),
    dac_paddings: Sequence[int] = (4, 4, 2, 1),
    dac_up_sampling_factor: int = 512,
) -> None:
    """Dia GGUF (parity: dia_gguf_encoder.py); tensors keys are full names
    under 'dia.'."""
    w = GGUFWriter(path, "dia")
    w.add_u32("dia.attn_head_size", head_size)
    w.add_u32("dia.eos_token_id", eos_token_id)
    w.add_u32("dia.bos_token_id", bos_token_id)
    w.add_u32("dia.pad_token_id", pad_token_id)
    w.add_u32("dia.max_delay", max_delay)
    w.add_u32("dia.encoder.max_context_length", max_encoder_context)
    w.add_u32("dia.encoder.attn_heads", encoder_heads)
    w.add_u32("dia.encoder.layers", encoder_layers)
    w.add_u32("dia.encoder.hidden_size", encoder_hidden)
    w.add_u32("dia.decoder.hidden_size", decoder_hidden)
    w.add_u32("dia.decoder.layers", decoder_layers)
    w.add_u32("dia.decoder.output_heads", output_heads)
    w.add_u32("dia.decoder.attn_heads", decoder_heads)
    w.add_u32("dia.decoder.query_heads", query_heads)
    w.add_u32("dia.decoder.output_vocab_size", output_vocab)
    w.add_u32("dia.decoder.audio_vocab_size", audio_vocab)
    w.add_u32("dia.decoder.max_generation_size", max_generation)
    if delay_pattern is not None:
        # our extension: the per-channel delay pattern (the reference
        # hardcodes {0,8,...,15} for 9 heads, dia/model.h:83)
        w.add_array("dia.decoder.delay_pattern", [int(x) for x in delay_pattern])
    if dac_tensors is not None:
        w.add_u32("dac.up_sampling_factor", dac_up_sampling_factor)
        for i, (s, p) in enumerate(zip(dac_strides, dac_paddings)):
            w.add_u32(f"dac.dac_layer_stride_{i}", s)
            w.add_u32(f"dac.dac_layer_padding_{i}", p)
    for name, arr in tensors.items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    for name, arr in (dac_tensors or {}).items():
        w.add_tensor(f"audio_encoder.{name}", np.asarray(arr, np.float32))
    w.write()


def write_orpheus_gguf(
    path: str,
    *,
    vocab_size: int,
    attn_heads: int,
    kv_attn_heads: int,
    head_dim: int,
    hidden_size: int,
    n_layers: int,
    stopping_token_id: int,
    bos_token_id: int,
    eos_token_id: int,
    tensors: Dict[str, np.ndarray],
    tokenizer_tokens: Sequence[str],
    tokenizer_merges: Sequence[str],
    snac_tensors: Optional[Dict[str, np.ndarray]] = None,
    snac_strides: Sequence[int] = (8, 8, 4, 2),
    snac_paddings: Sequence[int] = (4, 4, 2, 1),
    snac_groupings: Sequence[int] = (1, 1, 1, 1),
    snac_up_sampling_factor: int = 512,
) -> None:
    """Orpheus GGUF (parity: orpheus_gguf_encoder.py); tensors keys are full
    names under 'orpheus.', snac_tensors under 'snac.'."""
    w = GGUFWriter(path, "orpheus")
    w.add_u32("orpheus.vocab_size", vocab_size)
    w.add_u32("orpheus.attn_heads", attn_heads)
    w.add_u32("orpheus.kv_attn_heads", kv_attn_heads)
    w.add_u32("orpheus.head_dim", head_dim)
    w.add_u32("orpheus.hidden_size", hidden_size)
    w.add_u32("orpheus.layers", n_layers)
    w.add_u32("orpheus.stopping_token_id", stopping_token_id)
    w.add_str("tokenizer.ggml.model", "bpe")
    w.add_array("tokenizer.ggml.tokens", list(tokenizer_tokens))
    w.add_array("tokenizer.ggml.merges", list(tokenizer_merges))
    w.add_u32("tokenizer.ggml.bos_token_id", bos_token_id)
    w.add_u32("tokenizer.ggml.eos_token_id", eos_token_id)
    if snac_tensors is not None:
        w.add_u32("snac.audio_token_channels", 3)
        w.add_u32("snac.up_sampling_factor", snac_up_sampling_factor)
        for i, (s, p, gr) in enumerate(zip(snac_strides, snac_paddings,
                                           snac_groupings)):
            w.add_u32(f"snac.snac_layer_stride_{i}", s)
            w.add_u32(f"snac.snac_layer_padding_{i}", p)
            w.add_u32(f"snac.snac_layer_grouping_{i}", gr)
    for name, arr in tensors.items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    for name, arr in (snac_tensors or {}).items():
        w.add_tensor(f"snac.{name}", np.asarray(arr, np.float32))
    w.write()
