"""Tiny cells for the harness's own tests: each configuration at a size a
CPU runs in seconds (the widths cut, the structure kept), under its cell's
traffic with short ramps."""
from __future__ import annotations

import copy

from port_bench import common

TINY_DAC = {"decoder_channels": [32, 16, 8, 8, 4]}
TINY = {
    "parler-tts-mini-v1": {
        "num_hidden_layers": 2, "hidden_size": 128, "num_attention_heads": 2,
        "ffn_dim": 256, "max_position_embeddings": 128,
        "max_generation_size": 64, "description_rows": 8,
        "text_encoder_hidden_size": 128,
        # the heads' scales grown with the square root of the width cut, so
        # that the logits spread as at the published width
        "head_scales": [0.057, 0.113], "weight_scales": [0.0057, 0.017]},
    "dia-1.6b": {
        "encoder_n_layer": 1, "encoder_n_embd": 128, "encoder_n_hidden": 256,
        "encoder_n_head": 2, "encoder_head_dim": 64, "decoder_n_layer": 2,
        "decoder_n_embd": 128, "decoder_n_hidden": 256, "gqa_query_heads": 2,
        "kv_heads": 1, "gqa_head_dim": 64, "cross_query_heads": 2,
        "cross_head_dim": 64, "max_generation_size": 48,
        "head_scales": [0.008, 0.024], "weight_scales": [0.008, 0.024]},
}
TINY_TRAFFIC = {"ramp_s": 0.5, "clients": 4, "batch_slots": 4,
                "trace_s": 1.0}
# limits of the tiny models, from their CPU readings (program / control:
# widest gap 0.02-0.06 / 0.33-4.6, Dia's logits' relative RMS 0.0033-0.0038 / 0.12-0.17)
TINY_LIMITS = {"logit_gap": 0.2, "logit_err": 0.02, "audio_err": 1.5e-3}
TINY_PROMPTS = {"parler-tts-mini-v1": [5, 20], "dia-1.6b": [20, 60]}


def tiny_cell(workload: str):
    """The cell `workload` of BENCHMARK.json at a tiny size."""
    cell = common.Cell(common.benchmark(), workload)
    cfg = copy.deepcopy(cell.config)
    cfg.update(TINY[cell.config_entry["name"]])
    cfg["dac"].update(TINY_DAC)
    cell.config = cfg
    traffic = copy.deepcopy(cell.traffic)
    for k, v in TINY_TRAFFIC.items():
        if k in traffic:
            traffic[k] = v
    traffic["prompt_sizes"] = TINY_PROMPTS[cell.config_entry["name"]]
    # every other request greedy, so that a few seconds judge some
    traffic["sampling"] = [{"greedy": True}, traffic["sampling"][0]]
    traffic["judge"] = {"greedy": 1, "audio": 2}
    cell.traffic = traffic
    names = common.load_json(common.BENCH_DIR / "limits" / f"{workload}.json")
    cell.limits = {k: v for k, v in TINY_LIMITS.items() if k in names}
    return cell
