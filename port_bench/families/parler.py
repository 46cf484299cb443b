"""Parler-TTS: the system under test built from the seed, and the plain
reference's view of the same request.

The weights are made on the card in the port's containers (QuantTensor
stacks, float32 tensors), shaped as `tts_tpu_torch.apps.quantize -qt Q4_0
-qh` leaves a checkpoint, and the runner is built with its constructor, as
`models/parler/loader.py` builds it from a GGUF.
"""
from __future__ import annotations

import threading

from port_bench import text, weights
from port_bench.reference import parler as ref
from port_bench.reference import tokenizer as ref_tok

SOURCES = ("quant_matmul", "decode_attention", "parler_megastep")
ENGINE_MODULE = "tts_tpu_torch.runtime.batched_parler"
ENGINE_CHUNK = "batched_decode_chunk"
RUNNER_MODULE = "tts_tpu_torch.models.parler.model"
RUNNER_LOOP = "generate_tokens_chunked"
SAMPLE_RATE = 44100
UNK, EOS_TEXT = 2, 1


def make_raw(cfg: dict, seed: int, device) -> dict:
    """Every tensor of the checkpoint, made on `device` from `seed`."""
    m = weights.Maker(seed, device)
    ws = cfg["weight_scales"]
    L, H, F = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["ffn_dim"]
    n_out, vocab = cfg["num_codebooks"], cfg["vocab_size"]
    r = {}
    for ln in ("ln1", "lnc", "ln2"):
        r[ln + "_w"] = m.normal((L, H), 0.02, 1.0)
        r[ln + "_b"] = m.normal((L, H), 0.02)
    for name in ("q", "k", "v", "o", "cq", "co"):
        r[name] = m.q4((L,), H, H, *ws)
    r["fc1"] = m.q4((L,), F, H, *ws)
    r["fc2"] = m.q4((L,), H, F, *ws)
    r["ck_proj"] = m.normal((L, H, H), 0.02)
    r["cv_proj"] = m.normal((L, H, H), 0.02)
    r["final_ln_w"] = m.normal((H,), 0.02, 1.0)
    r["final_ln_b"] = m.normal((H,), 0.02)
    r["embds"] = m.normal((n_out, vocab + 1, H), 0.1)
    r["prompt_embd"] = m.normal((cfg["prompt_vocab_size"], H), 1.0)
    r["pos_embd"] = m.normal((cfg["max_position_embeddings"], H), 0.1)
    r["text_encoding"] = m.normal((cfg["description_rows"],
                                   cfg["text_encoder_hidden_size"]), 1.0)
    r["heads"] = m.q4((n_out,), vocab, H, *cfg["head_scales"],
                      zero_rows_from=cfg["audio_vocab_size"])
    r["dac"] = weights.make_dac(m, cfg["dac"])
    return r


def vocab(cfg: dict) -> tuple[list, list]:
    pieces = text.parler_vocab(cfg["prompt_vocab_size"])
    scores = [-1.0] * len(pieces)
    scores[UNK] = -10.0
    return pieces, scores


class Recorder:
    """The ids the program's text front end gave each prompt."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids: dict = {}

    def put(self, prompt: str, ids: list) -> None:
        with self.lock:
            self.ids[prompt] = list(ids)


def build(cfg: dict, raw: dict, device, recorder: Recorder, patch=setattr):
    """The ParlerRunner over `raw` (no copy of the blocks), with the DAC."""
    from tts_tpu_torch.gguf import quants
    from tts_tpu_torch.models.codec.dac import DACConfig, DACRunner
    from tts_tpu_torch.models.parler.model import (
        ParlerConfig, ParlerLayerWeights, ParlerRunner, ParlerWeights,
        precompute_cross_kv)
    from tts_tpu_torch.ops.quant_matmul import QuantTensor
    from tts_tpu_torch.text import UnigramTokenizer

    q4 = quants.GGML_TYPE_Q4_0

    def qt(name):
        return QuantTensor(*raw[name], q4)

    pc = ParlerConfig(
        n_output_heads=cfg["num_codebooks"],
        n_encode_length=cfg["description_rows"],
        hidden_size=cfg["hidden_size"],
        max_ctx_length=cfg["max_position_embeddings"],
        n_attn_heads=cfg["num_attention_heads"],
        output_vocab_size=cfg["vocab_size"], eos_token_id=cfg["eos_token_id"],
        audio_vocab_size=cfg["audio_vocab_size"],
        max_generation_size=cfg["max_generation_size"],
        n_layers=cfg["num_hidden_layers"], bos_token_id=cfg["bos_token_id"],
        use_cross_attn=True)
    k_ws = list(raw["ck_proj"].unbind(0))
    v_ws = list(raw["cv_proj"].unbind(0))
    cross_k, cross_v = precompute_cross_kv(pc, raw["text_encoding"], k_ws, v_ws)
    layers = ParlerLayerWeights(
        ln1_w=raw["ln1_w"], ln1_b=raw["ln1_b"], q_w=qt("q"), k_w=qt("k"),
        v_w=qt("v"), o_w=qt("o"), lnc_w=raw["lnc_w"], lnc_b=raw["lnc_b"],
        cq_w=qt("cq"), co_w=qt("co"), cross_k=cross_k, cross_v=cross_v,
        ln2_w=raw["ln2_w"], ln2_b=raw["ln2_b"], fc1=qt("fc1"), fc2=qt("fc2"))

    hc, hs = raw["heads"]
    heads = QuantTensor(hc.reshape(-1, hc.shape[-1]),
                        hs.reshape(-1, hs.shape[-1]), q4)
    w = ParlerWeights(layers=layers, embds=raw["embds"],
                      prompt_embd=raw["prompt_embd"], pos_embd=raw["pos_embd"],
                      final_ln_w=raw["final_ln_w"],
                      final_ln_b=raw["final_ln_b"], heads=heads)
    pieces, scores = vocab(cfg)

    class RecordingTokenizer(UnigramTokenizer):
        def tokenize(self, prompt):
            ids = super().tokenize(prompt)
            recorder.put(prompt, ids)
            return ids

    tok = RecordingTokenizer({p: i for i, p in enumerate(pieces)}, UNK,
                             scores, EOS_TEXT)
    dac = DACRunner(DACConfig(), dac_weights(raw["dac"], cfg["dac"]))
    return ParlerRunner(pc, w, tok, dac, cross_kv_projs=(k_ws, v_ws))


def dac_weights(d: dict, dac: dict):
    """The port's DACWeights over the harness's DAC tensors."""
    from tts_tpu_torch.models.codec.dac import (CodecLayerWeights, DACWeights,
                                                QuantizeLayerWeights,
                                                ResidualUnitWeights)
    qs = [QuantizeLayerWeights(d[f"quantizers.{i}.codebook.weight"],
                               d[f"quantizers.{i}.out_proj.weight"],
                               d[f"quantizers.{i}.out_proj.bias"])
          for i in range(dac["n_codebooks"])]
    layers = []
    for i in range(1, len(dac["upsampling_ratios"]) + 1):
        b = f"decoder_block.{i}."
        units = []
        for j in range(3):
            u = f"{b}residual_unit.{j}.res."
            units.append(ResidualUnitWeights(
                d[u + "initial.alpha"], d[u + "initial.weight"],
                d[u + "initial.bias"], d[u + "final.alpha"],
                d[u + "final.weight"], d[u + "final.bias"]))
        layers.append(CodecLayerWeights(d[b + "final.alpha"],
                                        d[b + "final.weight"],
                                        d[b + "final.bias"], units))
    return DACWeights(qs, d["initial.weight"], d["initial.bias"], layers,
                      d["final.alpha"], d["final.weight"], d["final.bias"])


# ---------------------------------------------------------------------------
# the request's text and the reference's view of it
# ---------------------------------------------------------------------------

def prompt(start: int, size: int) -> str:
    """A prompt of `size` tokens, EOS included (one token a word)."""
    return text.parler_prompt(start, size - 1)


def ref_ids(cfg: dict, prompt_text: str) -> list:
    pieces, scores = vocab(cfg)
    return ref_tok.unigram(prompt_text, pieces, scores, UNK) + [EOS_TEXT]


def program_ids(recorder: Recorder, prompt_text: str):
    """The program's ids for the prompt, with the EOS its engine appends."""
    with recorder.lock:
        ids = recorder.ids.get(prompt_text)
    return None if ids is None else ids + [EOS_TEXT]


def ref_logits(raw, cfg, ids, tokens, n_steps, rounding="float32"):
    return ref.logits(raw, cfg, ids, tokens[:n_steps], rounding)


def ref_frames(cfg: dict, tokens, n_steps: int) -> list:
    return ref.delay_undo(tokens, n_steps, cfg["num_codebooks"],
                          cfg["audio_vocab_size"])


def decode_steps(cfg: dict, prompt_tokens: int) -> int:
    """Decode steps of a request: every position up to the window."""
    return cfg["max_generation_size"] - prompt_tokens


def last_position(cfg: dict) -> int:
    """The last cache position a decode step runs at (the window's end)."""
    return cfg["max_generation_size"] - 1


def step_work(cfg: dict, positions: list) -> dict:
    """(flops, bytes) by kernel of one batched decode step whose live slots
    sit at `positions`: K5's GEMVs, K4's attention, K1's LM heads."""
    from port_bench import roofline as rl
    n = len(positions)
    return {"k5": rl.parler_k5_step(cfg, n),
            "k4": rl.parler_k4_step(cfg, positions),
            "heads": rl.parler_heads(cfg, n)}


def vocode_frames(cfg: dict, traffic: dict) -> list:
    """Every frame count the cell hands the DAC: whole requests' (one a
    prompt size), or a stream's segments (the first chunk's frames, then
    margin-overlapped segments of at most two chunks)."""
    if traffic.get("stream"):
        from tts_tpu_torch.server.server import BatchedModelWorker
        first = CHUNK - (cfg["num_codebooks"] - 1)
        return list(range(first, 2 * BatchedModelWorker.STREAM_MARGIN +
                          CHUNK + 1))
    lo, hi = traffic["prompt_sizes"]
    return [decode_steps(cfg, p) - (cfg["num_codebooks"] - 1)
            for p in range(lo, hi + 1)]


CHUNK = 32   # the server's batched worker's chunk (BatchedModelWorker)
