"""quantize — GGUF -> GGUF weight-only quantization, on the card.

The port of the JAX package's `apps/quantize.py`: the same allow-lists per
architecture, the same flags (output heads, text embeddings, cross-attention
K/V, DAC / SNAC -> F16, Kokoro's non-quantizable -> F16) and the same
rewritten GGUF with `general.quantization_type` recorded. Each tensor to
quantize is read from the input's mmap, moved to the device, quantized there
(`ops.quantize.quantize_blocks`: the hand-written kernel on the card, its
plain PyTorch version with `--device cpu`) and brought back, one tensor at a
time. The bytes are those of `gguf.quants.quantize`.

    python -m tts_tpu_torch.apps.quantize -mp model.gguf -qp model-q4.gguf -qt Q4_0
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..common import default_device
from ..gguf import GGUFReader, GGUFWriter, quants
from ..ops.quantize import quantize_blocks
from ..utils.profiling import StageTimer

VALID_TYPES = {
    "FP16": quants.GGML_TYPE_F16, "F16": quants.GGML_TYPE_F16,
    "Q4_0": quants.GGML_TYPE_Q4_0, "Q4": quants.GGML_TYPE_Q4_0,
    "Q5_0": quants.GGML_TYPE_Q5_0, "Q5": quants.GGML_TYPE_Q5_0,
    "Q8_0": quants.GGML_TYPE_Q8_0, "Q8": quants.GGML_TYPE_Q8_0,
}


class QuantizationParams:
    def __init__(self, quantize_type: int, quantize_output_heads=False,
                 quantize_text_embeddings=False, quantize_cross_attn_kv=False,
                 convert_dac_to_f16=False, convert_non_quantizable_to_f16=False):
        self.quantize_type = quantize_type
        self.quantize_output_heads = quantize_output_heads
        self.quantize_text_embeddings = quantize_text_embeddings
        self.quantize_cross_attn_kv = quantize_cross_attn_kv
        self.convert_dac_to_f16 = convert_dac_to_f16
        self.convert_non_quantizable_to_f16 = convert_non_quantizable_to_f16


def kokoro_is_f16_compatible(name: str) -> bool:
    return ("voice_tensors" not in name and "bias" not in name and
            "gamma" not in name and "beta" not in name and
            "alpha" not in name and not name.endswith("embd") and
            not name.endswith("norm"))


def kokoro_is_quantizable(name: str, params: QuantizationParams) -> bool:
    compatible_parts = ("duration_proj", "encode", "shared_lstm",
                        "duration_lstm", "layers")
    if kokoro_is_f16_compatible(name):
        if name.startswith("kokoro.albert") or \
                name.startswith("kokoro.text_encoder.lstm"):
            return True
        if name.startswith("kokoro.duration_predictor."):
            parts = name.split(".")
            if len(parts) > 2 and parts[2] in compatible_parts:
                return True
    return False


def dia_is_quantizable(name: str, params: QuantizationParams) -> bool:
    quantizable = not name.startswith("audio_encoder") and \
        not name.endswith("norm")
    if not params.quantize_output_heads:
        quantizable = quantizable and not name.startswith("dia.decoder.heads")
    return quantizable


def parler_is_quantizable(name: str, params: QuantizationParams) -> bool:
    quantizable = (not name.startswith("audio_encoder") and
                   not name.endswith("norm.weight") and
                   not name.endswith("text_encoding") and
                   not name.endswith("positional_embed") and
                   not name.endswith("norm.bias"))
    if not params.quantize_output_heads:
        quantizable = quantizable and not name.endswith("weight.head")
    if not params.quantize_text_embeddings:
        quantizable = quantizable and not name.endswith("embed_prompts")
    if not params.quantize_cross_attn_kv:
        quantizable = quantizable and \
            not name.endswith("encoder_attn.k_proj.weight") and \
            not name.endswith("encoder_attn.v_proj.weight")
    return quantizable


def orpheus_is_quantizable(name: str, params: QuantizationParams) -> bool:
    """The llama projections and MLP quantize; norms, rope frequency factors
    and SNAC stay f32."""
    quantizable = (name.startswith("orpheus.") and
                   "layernorm" not in name and
                   not name.endswith("norm") and
                   "rope_frequencies" not in name)
    if not params.quantize_output_heads:
        quantizable = quantizable and not name.endswith("lm_head")
    if not params.quantize_text_embeddings:
        quantizable = quantizable and not name.endswith("embed_tokens")
    return quantizable


def is_quantizable(arch: str, name: str, params: QuantizationParams) -> bool:
    if arch == "parler-tts":
        return parler_is_quantizable(name, params)
    if arch == "dia":
        return dia_is_quantizable(name, params)
    if arch == "kokoro":
        return kokoro_is_quantizable(name, params)
    if arch == "orpheus":
        return orpheus_is_quantizable(name, params)
    raise ValueError(f"architecture {arch!r} is not supported for quantization")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _on_device(r: GGUFReader, name: str, qtype: int, dev: torch.device,
               timer: StageTimer) -> bytes:
    """One f32 tensor of the input, quantized to `qtype` on `dev`: read from
    the mmap, host -> device, the kernel, device -> host (each a stage of
    `timer`, synchronized)."""
    with timer.stage("read"):
        arr = np.array(r.array(name), np.float32, copy=True)
    with timer.stage("host->device"):
        x = torch.from_numpy(arr).to(dev)
        _sync(dev)
    with timer.stage("kernel"):
        q = quantize_blocks(x, qtype)
        _sync(dev)
    with timer.stage("device->host"):
        return q.cpu().numpy().tobytes()


def quantize_gguf(in_path: str, out_path: str, params: QuantizationParams,
                  log=print, device=None) -> StageTimer:
    """Rewrite `in_path` into `out_path` with its quantizable F32 tensors in
    `params.quantize_type`, on `device` (default `cuda`: raises without a
    card; `"cpu"` runs the plain version). Returns the times of its read /
    host->device / kernel / device->host / write stages."""
    dev = default_device(device)
    timer = StageTimer()
    r = GGUFReader(in_path)
    arch = r.architecture
    w = GGUFWriter(out_path, arch)
    for key, value in r.metadata.items():
        if key == "general.architecture":
            continue
        if isinstance(value, np.ndarray):
            w.add_array(key, value)
        elif isinstance(value, list):
            w.add_array(key, value)
        elif isinstance(value, bool):
            w.add_bool(key, value)
        elif isinstance(value, float):
            w.add_f32(key, value)
        elif isinstance(value, int):
            w.add_u32(key, value) if 0 <= value < 2 ** 32 else w.add_kv(key, value)
        else:
            w.add_str(key, str(value))
    w.add_u32("general.quantization_version", 2)
    w.add_u32("general.quantization_type", params.quantize_type)

    for name in r.tensor_names():
        ti = r.tensors[name]
        raw = r.raw(name)
        if ti.ggml_type != quants.GGML_TYPE_F32:
            # keep already-converted tensors as-is
            w.add_raw_tensor(name, ti.shape, ti.ggml_type, bytes(raw))
            continue
        row = ti.shape[-1] if ti.shape else 1
        wants_quant = is_quantizable(arch, name, params) and \
            params.quantize_type != quants.GGML_TYPE_F16
        # rows must be divisible by the 32-wide block
        if wants_quant and row % quants.QK == 0 and len(ti.shape) >= 2:
            w.add_raw_tensor(name, ti.shape, params.quantize_type, _on_device(
                r, name, params.quantize_type, dev, timer))
            log(f"quantized {name} -> {quants.TYPE_NAMES[params.quantize_type]}")
        elif (params.quantize_type == quants.GGML_TYPE_F16 and
              is_quantizable(arch, name, params)) or \
            (params.convert_dac_to_f16 and name.startswith(("audio_encoder.", "snac."))) or \
            (params.convert_non_quantizable_to_f16 and arch == "kokoro" and
             kokoro_is_f16_compatible(name)):
            w.add_raw_tensor(name, ti.shape, quants.GGML_TYPE_F16, _on_device(
                r, name, quants.GGML_TYPE_F16, dev, timer))
            log(f"converted {name} -> F16")
        else:
            w.add_raw_tensor(name, ti.shape, ti.ggml_type, bytes(raw))
    with timer.stage("write"):
        w.write()
    r.close()
    return timer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="quantize",
                                description="GGUF weight-only quantization")
    p.add_argument("--model-path", "-mp", required=True)
    p.add_argument("--quantized-model-path", "-qp", required=True)
    p.add_argument("--quantized-type", "-qt", default="Q4_0")
    p.add_argument("--n-threads", "-nt", type=int, default=0)  # compat no-op
    p.add_argument("--convert-dac-to-f16", "-df", action="store_true")
    p.add_argument("--quantize-output-heads", "-qh", action="store_true")
    p.add_argument("--quantize-text-embedding", "-qe", action="store_true")
    p.add_argument("--quantize-cross-attn-kv", "-qkv", action="store_true")
    p.add_argument("--convert-non-quantized-to-f16", "-nqf", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where to quantize: cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.quantized_type not in VALID_TYPES:
        print(f"ERROR: {args.quantized_type} is not a valid quantization type.",
              file=sys.stderr)
        return 1
    params = QuantizationParams(
        quantize_type=VALID_TYPES[args.quantized_type],
        quantize_output_heads=args.quantize_output_heads,
        quantize_text_embeddings=args.quantize_text_embedding,
        quantize_cross_attn_kv=args.quantize_cross_attn_kv,
        convert_dac_to_f16=args.convert_dac_to_f16,
        convert_non_quantizable_to_f16=args.convert_non_quantized_to_f16,
    )
    quantize_gguf(args.model_path, args.quantized_model_path, params,
                  device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
