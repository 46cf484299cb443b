"""Dia: the system under test built from the seed, and the plain
reference's view of the same request.

The weights are made on the card in the port's containers, shaped as
`tts_tpu_torch.apps.quantize -qt Q4_0 -qh` leaves a Dia checkpoint, and
the runner is built with its constructor, as `models/dia/loader.py`
builds it from a GGUF.
"""
from __future__ import annotations

import threading

from port_bench import text, weights
from port_bench.families.parler import dac_weights
from port_bench.reference import dia as ref
from port_bench.reference import tokenizer as ref_tok

SOURCES = ("quant_matmul", "decode_attention", "dia_megastep", "dia_flat")
ENGINE_MODULE = "tts_tpu_torch.runtime.batched_dia"
ENGINE_CHUNK = "batched_dia_decode_chunk"
RUNNER_MODULE = "tts_tpu_torch.models.dia.model"
RUNNER_LOOP = "dia_generate_tokens_chunked"
LOGITS_FN = "cfg_logits"    # a step's CFG-merged logits, before sampling
SAMPLE_RATE = 44100


def make_raw(cfg: dict, seed: int, device) -> dict:
    """Every tensor of the checkpoint, made on `device` from `seed`."""
    m = weights.Maker(seed, device)
    ws = cfg["weight_scales"]
    EL, EH, EF = cfg["encoder_n_layer"], cfg["encoder_n_embd"], \
        cfg["encoder_n_hidden"]
    EQ = cfg["encoder_n_head"] * cfg["encoder_head_dim"]
    L, H, F = cfg["decoder_n_layer"], cfg["decoder_n_embd"], \
        cfg["decoder_n_hidden"]
    Q = cfg["gqa_query_heads"] * cfg["gqa_head_dim"]
    KV = cfg["kv_heads"] * cfg["gqa_head_dim"]
    C = cfg["cross_query_heads"] * cfg["cross_head_dim"]
    n_out, vocab = cfg["channels"], cfg["output_vocab_size"]
    r = {"enc_embedding": m.normal((cfg["text_vocab_size"], EH), 1.0),
         "enc_norm": m.normal((EH,), 0.1, 1.0),
         "enc_sa_norm": m.normal((EL, EH), 0.1, 1.0),
         "enc_mlp_norm": m.normal((EL, EH), 0.1, 1.0)}
    for n in "qkv":
        r["enc_" + n] = m.q4((EL,), EQ, EH, *ws)
    r["enc_o"] = m.q4((EL,), EH, EQ, *ws)
    r["enc_gate"] = m.q4((EL,), EF, EH, *ws)
    r["enc_up"] = m.q4((EL,), EF, EH, *ws)
    r["enc_wo"] = m.q4((EL,), EH, EF, *ws)
    r["dec_norm"] = m.normal((H,), 0.1, 1.0)
    for n in ("sa_norm", "ca_norm", "mlp_norm"):
        r[n] = m.normal((L, H), 0.1, 1.0)
    r["self_q"] = m.q4((L,), Q, H, *ws)
    r["self_k"] = m.q4((L,), KV, H, *ws)
    r["self_v"] = m.q4((L,), KV, H, *ws)
    r["self_o"] = m.q4((L,), H, Q, *ws)
    r["cross_q"] = m.q4((L,), C, H, *ws)
    r["cross_k"] = m.q4((L,), C, EH, *ws)
    r["cross_v"] = m.q4((L,), C, EH, *ws)
    r["cross_o"] = m.q4((L,), H, C, *ws)
    r["gate"] = m.q4((L,), F, H, *ws)
    r["up"] = m.q4((L,), F, H, *ws)
    r["wo"] = m.q4((L,), H, F, *ws)
    r["dec_embds"] = m.normal((n_out, vocab, H), 0.5)
    r["heads"] = m.q4((n_out,), vocab, H, *cfg["head_scales"],
                      zero_rows_from=cfg["audio_vocab_size"])
    r["dac"] = weights.make_dac(m, cfg["dac"])
    return r


class Recorder:
    """The byte ids the program's text front end gave each prompt."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids: dict = {}

    def put(self, prompt: str, ids: list) -> None:
        with self.lock:
            self.ids[prompt] = list(ids)


def program_config(cfg: dict):
    from tts_tpu_torch.models.dia.model import DiaConfig
    return DiaConfig(
        n_output_heads=cfg["channels"],
        n_encoder_layers=cfg["encoder_n_layer"],
        n_decoder_layers=cfg["decoder_n_layer"],
        encoder_hidden_size=cfg["encoder_n_embd"],
        decoder_hidden_size=cfg["decoder_n_embd"],
        encoder_attn_heads=cfg["encoder_n_head"],
        decoder_attn_heads=cfg["gqa_query_heads"],
        decoder_query_heads=cfg["gqa_query_heads"] // cfg["kv_heads"],
        head_size=cfg["gqa_head_dim"], eos_token_id=cfg["eos_token_id"],
        pad_token_id=cfg["pad_token_id"], bos_token_id=cfg["bos_token_id"],
        output_vocab_size=cfg["output_vocab_size"],
        audio_vocab_size=cfg["audio_vocab_size"],
        max_generation_size=cfg["max_generation_size"],
        max_encoder_context_length=cfg["encoder_max_position_embeddings"],
        cfg_scale=cfg["cfg_scale"], cfg_max_output=cfg["cfg_max_output"],
        max_delay=cfg["max_delay"],
        delay_pattern=tuple(cfg["delay_pattern"]))


def build(cfg: dict, raw: dict, device, recorder: Recorder, patch=setattr):
    """The DiaRunner over `raw` (no copy of the blocks), with the DAC, and
    the text front end recorded where the runner and the engine call it
    (`patch(module, name, value)` sets the recording wrapper)."""
    import tts_tpu_torch.models.dia.model as dm
    import tts_tpu_torch.runtime.batched_dia as bd
    from tts_tpu_torch.gguf import quants
    from tts_tpu_torch.models.codec.dac import DACConfig, DACRunner
    from tts_tpu_torch.ops.quant_matmul import QuantTensor

    q4 = quants.GGML_TYPE_Q4_0

    def qt(name):
        return QuantTensor(*raw[name], q4)

    enc = dm.DiaEncoderLayer(
        sa_norm=raw["enc_sa_norm"], q=qt("enc_q"), k=qt("enc_k"),
        v=qt("enc_v"), o=qt("enc_o"), mlp_norm=raw["enc_mlp_norm"],
        gate=qt("enc_gate"), up=qt("enc_up"), wo=qt("enc_wo"))
    dec = dm.DiaDecoderLayer(
        sa_norm=raw["sa_norm"], self_q=qt("self_q"), self_k=qt("self_k"),
        self_v=qt("self_v"), self_o=qt("self_o"), ca_norm=raw["ca_norm"],
        cross_q=qt("cross_q"), cross_k=qt("cross_k"), cross_v=qt("cross_v"),
        cross_o=qt("cross_o"), mlp_norm=raw["mlp_norm"], gate=qt("gate"),
        up=qt("up"), wo=qt("wo"))
    hc, hs = raw["heads"]
    w = dm.DiaWeights(
        enc_embedding=raw["enc_embedding"], enc_layers=enc,
        enc_norm=raw["enc_norm"], dec_embds=raw["dec_embds"],
        dec_layers=dec, dec_norm=raw["dec_norm"],
        heads=QuantTensor(hc.reshape(-1, hc.shape[-1]),
                          hs.reshape(-1, hs.shape[-1]), q4))
    plain = dm.tokenize_sentence

    def recording(prompt_text, c):
        ids = plain(prompt_text, c)
        recorder.put(prompt_text, ids)
        return ids

    # the runner (dia.model) and the engine (batched_dia) call it by name
    patch(dm, "tokenize_sentence", recording)
    patch(bd, "tokenize_sentence", recording)
    dac = DACRunner(DACConfig(), dac_weights(raw["dac"], cfg["dac"]))
    return dm.DiaRunner(program_config(cfg), w, dac, device=device)


# ---------------------------------------------------------------------------
# the request's text and the reference's view of it
# ---------------------------------------------------------------------------

def prompt(start: int, size: int) -> str:
    """A script of at most `size` bytes as Dia's tokenizer counts them."""
    return text.dia_script(start, size)


def ref_ids(cfg: dict, prompt_text: str) -> list:
    return ref_tok.dia_bytes(prompt_text, cfg["encoder_max_position_embeddings"])


def program_ids(recorder: Recorder, prompt_text: str):
    with recorder.lock:
        return recorder.ids.get(prompt_text)


def ref_logits(raw, cfg, ids, tokens, n_steps, rounding="float32"):
    return ref.logits(raw, cfg, ids, tokens[:n_steps], n_steps,
                      cfg["max_generation_size"], rounding)


def ref_frames(cfg: dict, tokens, n_steps: int) -> list:
    return ref.delay_undo(cfg, tokens, n_steps)


def decode_steps(cfg: dict, prompt_tokens: int) -> int:
    """Decode steps of a request: up to the end of the wind-down that
    starts max_delay steps before the window's end."""
    return cfg["max_generation_size"] - 1


def last_position(cfg: dict) -> int:
    """The last cache position a decode step runs at: the wind-down ends
    at the window's last row, whose step is not taken."""
    return cfg["max_generation_size"] - 2


ENGINE_CROSS_ROWS = 256   # the batched engine's one cross bucket


def step_work(cfg: dict, positions: list) -> dict:
    """(flops, bytes) by kernel of one batched decode step whose live pairs
    sit at `positions`: K11's GEMVs, K4's self- and cross-attention, K1's
    LM heads."""
    from port_bench import roofline as rl
    n = len(positions)
    return {"k11": rl.dia_k11_step(cfg, n),
            "k4": rl.dia_attn_step(cfg, positions, [ENGINE_CROSS_ROWS] * n),
            "heads": rl.dia_heads(cfg, n)}


def single_step_work(cfg: dict, pos: int, prompt_bytes: int) -> dict:
    """(flops, bytes) by kernel of one single-stream step at `pos`: K10's
    layer stack over the cross bucket that holds the prompt, K1's heads."""
    from port_bench import roofline as rl
    return {"k10": rl.dia_k10_step(cfg, pos, rl.cross_bucket(prompt_bytes)),
            "heads": rl.dia_heads(cfg, 1)}


def vocode_frames(cfg: dict, traffic: dict) -> list:
    """Every frame count the cell hands the DAC: a whole request's, the
    same for every prompt (its window less the delay undo's)."""
    return [decode_steps(cfg, 0) - cfg["max_delay"]]
