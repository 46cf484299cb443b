"""Dia (1.6B, two-speaker dialogue) in PyTorch, the port of the JAX package's
`models/dia/model.py`.

Parity: reference src/models/dia/model.cpp. An encoder-decoder with
classifier-free guidance: the conditional and the unconditional sequence
run as a batch of 2 throughout (model.cpp:697-704).
  * RMS norm eps 1e-5, no bias (model.cpp:344-349)
  * NeoX RoPE at theta 10000 on q/k, the cross-attention K at encoder
    positions too (model.cpp:394, 452, 489)
  * softmax scale 1.0: Dia does not scale by 1/sqrt(d) (model.cpp:399, 563)
  * SiLU-gated MLP: silu(gate(x)) * up(x) -> wo (model.cpp:416)
  * the encoder's pad mask is block-diagonal: real tokens attend real
    tokens, pads attend pads (model.cpp:728-737)
  * cross-attention attends the full padded encoder window; K rows past the
    prompt are zero (model.cpp:486-500)
  * CFG merge cond + scale * (cond - uncond), tokens above the audio vocab
    masked to -inf (model.cpp:358-371)
  * delay pattern {0, 8, ..., 15}: EOS on channel 0 starts a max_delay
    wind-down that forces EOS / PAD per channel (model.cpp:806-823)

The decode loop keeps its state on the device (position, delay counter and
done flag are one-element tensors) and syncs the host once per chunk; a
step taken once generation is done leaves the state as it was (the JAX
package's frozen-state chunk semantics). The KV cache is updated in place.

Decode step routes, chosen by the weights and never by the device:
  * K10 (ops/dia_megastep.py) when the 9 decode projections are
    block-quantized with one qtype and the dims qualify: the layer stack
    over the bucketed bf16 cross K/V with the analytic pad-tail fold
    (`prep_dia_cross`), then the final norm and the stacked heads (K1);
    one persistent launch for heads of 64 or 128, K11's launch sequence at
    one pair for the other head sizes K4 takes;
  * per matmul otherwise (`decode_layers`: K1 for quantized weights, K4
    for the self-attention of both rows, the full cross window in plain
    PyTorch).
On CPU tensors every kernel runs its plain PyTorch version. The encoder's
products have M = 2 x 1024 rows: dequant + torch.matmul (in float32, TF32
off), as in JAX. The batched engine (runtime/batched_dia.py) shares the
encoder, the embedding, the final norm and the CFG merge with the runner.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple

import numpy as np
import torch

from ...common import (GenerationConfig, SAMPLE_RATE_DAC, TTSResponse,
                       chunk_schedule, default_device, kv_cache_dtype,
                       megakernel_enabled, strict_fp32)
from ...gguf.reader import GGUFReader
from ...ops import sampling
from ...ops.attention import apply_rope_neox, sdpa
from ...ops.decode_attention import (STEP_HEAD_SIZES, decode_attention_batched,
                                     require_head_size)
from ...ops.dia_megastep import (cross_attention_plain, dia_megastep,
                                 dia_megastep_batched, inv_freq,
                                 prep_dia_cross, prep_dia_mega)
from ...ops.linear import (Weight, dense, from_gguf_tensor, matmul,
                           stack_weights)
from ...ops.llama_megastep import rms_norm
from ...ops.quant_matmul import QuantTensor
from ..base import TTSRunner


@dataclasses.dataclass(eq=False)
class DiaConfig:
    """Defaults = Dia 1.6B (dia/model.h:64-87)."""

    n_output_heads: int = 9
    n_encoder_layers: int = 12
    n_decoder_layers: int = 18
    encoder_hidden_size: int = 1024
    decoder_hidden_size: int = 2048
    encoder_attn_heads: int = 16
    decoder_attn_heads: int = 16
    decoder_query_heads: int = 4
    head_size: int = 128
    eos_token_id: int = 1024
    pad_token_id: int = 1025
    bos_token_id: int = 1026
    output_vocab_size: int = 1028
    audio_vocab_size: int = 1024
    max_generation_size: int = 3072
    max_encoder_context_length: int = 1024
    cfg_scale: float = 3.0
    cfg_max_output: int = 1024
    max_delay: int = 15
    delay_pattern: tuple = (0, 8, 9, 10, 11, 12, 13, 14, 15)

    @property
    def n_kv_heads(self) -> int:
        # the reference computes kv heads as attn / query (model.cpp:452)
        return self.decoder_attn_heads // self.decoder_query_heads

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "DiaConfig":
        c = cls()
        g = r.metadata.get
        c.head_size = int(g("dia.attn_head_size", c.head_size))
        c.eos_token_id = int(g("dia.eos_token_id", c.eos_token_id))
        c.bos_token_id = int(g("dia.bos_token_id", c.bos_token_id))
        c.pad_token_id = int(g("dia.pad_token_id", c.pad_token_id))
        c.max_delay = int(g("dia.max_delay", c.max_delay))
        c.max_encoder_context_length = int(g("dia.encoder.max_context_length",
                                             c.max_encoder_context_length))
        c.encoder_attn_heads = int(g("dia.encoder.attn_heads", c.encoder_attn_heads))
        c.n_encoder_layers = int(g("dia.encoder.layers", c.n_encoder_layers))
        enc_h = g("dia.encoder.hidden_size")
        if enc_h is None and "dia.encoder.embedding" in r.tensors:
            # the reference converter never writes this key (the C++ loader
            # relies on the 1.6B default): infer it from the embedding
            enc_h = r.tensors["dia.encoder.embedding"].shape[-1]
        if enc_h is not None:
            c.encoder_hidden_size = int(enc_h)
        c.decoder_hidden_size = int(g("dia.decoder.hidden_size", c.decoder_hidden_size))
        c.n_decoder_layers = int(g("dia.decoder.layers", c.n_decoder_layers))
        c.n_output_heads = int(g("dia.decoder.output_heads", c.n_output_heads))
        c.decoder_attn_heads = int(g("dia.decoder.attn_heads", c.decoder_attn_heads))
        c.decoder_query_heads = int(g("dia.decoder.query_heads", c.decoder_query_heads))
        c.output_vocab_size = int(g("dia.decoder.output_vocab_size", c.output_vocab_size))
        c.audio_vocab_size = int(g("dia.decoder.audio_vocab_size", c.audio_vocab_size))
        c.max_generation_size = int(g("dia.decoder.max_generation_size",
                                      c.max_generation_size))
        dp = g("dia.decoder.delay_pattern")
        if dp is not None:
            c.delay_pattern = tuple(int(x) for x in dp)
        elif c.n_output_heads != len(c.delay_pattern):
            # a non-default head count without a pattern: delays spread over
            # 0..max_delay (channel 0 always undelayed)
            n = c.n_output_heads
            c.delay_pattern = (0,) + tuple(
                c.max_delay - (n - 1 - i) for i in range(1, n))
        return c


class DiaEncoderLayer(NamedTuple):
    """All leaves stacked on the layer axis 0."""
    sa_norm: Any
    q: Weight; k: Weight; v: Weight; o: Weight
    mlp_norm: Any
    gate: Weight; up: Weight; wo: Weight


class DiaDecoderLayer(NamedTuple):
    """All leaves stacked on the layer axis 0."""
    sa_norm: Any
    self_q: Weight; self_k: Weight; self_v: Weight; self_o: Weight
    ca_norm: Any
    cross_q: Weight; cross_k: Weight; cross_v: Weight; cross_o: Weight
    mlp_norm: Any
    gate: Weight; up: Weight; wo: Weight


class DiaWeights(NamedTuple):
    enc_embedding: Any               # (256, enc_H) dense
    enc_layers: DiaEncoderLayer
    enc_norm: Any
    dec_embds: Any                   # (n_heads, vocab+, H) dense
    dec_layers: DiaDecoderLayer
    dec_norm: Any
    heads: Weight                    # (n_heads * vocab, H)


def _layer(layers, i: int):
    return type(layers)(*[f[i] for f in layers])


def _heads(x, nh: int):
    """(B, T, nh * D) -> (B, nh, T, D)."""
    b, t, _ = x.shape
    return x.reshape(b, t, nh, -1).transpose(1, 2)


@torch.no_grad()
def dia_encode(cfg: DiaConfig, w: DiaWeights, tokens: torch.Tensor,
               sentence_length: int):
    """tokens (2, Tc) byte ids (row 0 the prompt, row 1 zeros: the
    unconditional input has the same length mask). Returns (hidden (2, Tc,
    enc_H), cross_k (L, 2, heads, Tc, D), cross_v likewise), the cross-K rows
    at and past sentence_length zero (the reference's cache semantics)."""
    t = cfg.max_encoder_context_length
    dev = tokens.device
    pos = torch.arange(t, device=dev)
    x = w.enc_embedding[tokens.long()]                       # (2, T, H)
    real = pos < sentence_length
    bias = torch.zeros((t, t), device=dev).masked_fill(
        real[:, None] != real[None, :], float("-inf"))
    ha = cfg.encoder_attn_heads
    for i in range(cfg.n_encoder_layers):
        lw = _layer(w.enc_layers, i)
        h = rms_norm(x, lw.sa_norm)
        q, k, v = (_heads(matmul(h, m), ha) for m in (lw.q, lw.k, lw.v))
        inv = inv_freq(q.shape[-1], dev)
        a = sdpa(apply_rope_neox(q, pos, inv), apply_rope_neox(k, pos, inv),
                 v, bias, scale=1.0)
        x = x + matmul(a.transpose(1, 2).reshape(2, t, -1), lw.o)
        h = rms_norm(x, lw.mlp_norm)
        x = x + matmul(torch.nn.functional.silu(matmul(h, lw.gate)) *
                       matmul(h, lw.up), lw.wo)
    hidden = rms_norm(x, w.enc_norm)
    ks, vs = [], []
    for i in range(cfg.n_decoder_layers):
        lw = _layer(w.dec_layers, i)
        k = _heads(matmul(hidden, lw.cross_k), cfg.decoder_attn_heads)
        k = apply_rope_neox(k, pos, inv_freq(k.shape[-1], dev))
        ks.append(k * real[None, None, :, None])
        vs.append(_heads(matmul(hidden, lw.cross_v), cfg.decoder_attn_heads))
    return hidden, torch.stack(ks), torch.stack(vs)


class DiaCross(NamedTuple):
    """A request's cross K/V as its decode route reads them: the full f32
    window (L, 2, heads, Tc, D) on the per-matmul route (vtail None, n_tail
    0), or prep_dia_cross's bucketed bf16 rows (L, 2 heads, Sb, D), vtail
    and n_tail on K10's."""
    ck: Any
    cv: Any
    vtail: Any
    n_tail: int


class Mega(NamedTuple):
    """K10's weights and their qtype (see maybe_prep_dia_mega).
    `persistent`: the single stream takes the persistent K10 (heads of 64
    or 128); else the same function through K11's launch sequence at one
    pair."""
    layers: Any
    qtype: int
    persistent: bool = True


def maybe_prep_dia_mega(cfg: DiaConfig, w: DiaWeights) -> Mega | None:
    """K10's weights when its route applies: uniformly quantized decode
    projections and kernel-friendly dims (the JAX package's gate,
    model.py:377-383, without its platform test: the weights choose the
    route, not the device; the widths the GEMV takes are `prep_dia_mega`'s
    to refuse); TTS_TPU_MEGAKERNEL=0 turns it off, as in the JAX gate
    (unset or "1": by the weights; common.megakernel_enabled). None -> the
    per-matmul route (K1 per projection, K4). Heads that no decode route's
    attention takes raise ValueError (every route runs K4); heads that the
    persistent K10 does not take (other than 64 and 128) get K11's launch
    sequence (`persistent` False)."""
    require_head_size(cfg.head_size, "Dia")
    if not megakernel_enabled() or cfg.head_size % 64:
        return None
    try:
        layers, qtype = prep_dia_mega(w.dec_layers, cfg.head_size)
    except ValueError:
        return None
    return Mega(layers, qtype, cfg.head_size in STEP_HEAD_SIZES)


def embed_step(w: DiaWeights, tokens_in: torch.Tensor) -> torch.Tensor:
    """The decoder input of B requests: the sum of the codebook embeddings of
    tokens_in (B, n_heads), each row given to both CFG rows -> (2B, H),
    request s on rows 2s, 2s + 1. One reduction layout for any B, so a slot
    of the batched engine sums as the single-stream runner does. Ids past
    a table's end read its last row, as JAX's gather clamps them."""
    heads_i = torch.arange(w.dec_embds.shape[0], device=tokens_in.device)
    tok = tokens_in.clamp(max=w.dec_embds.shape[1] - 1)
    x = w.dec_embds[heads_i[None, :], tok].sum(dim=1)
    return x.repeat_interleave(2, dim=0)


def final_norm(w: DiaWeights, x: torch.Tensor) -> torch.Tensor:
    """The final RMS norm of x (2B, H), one CFG pair at a time: a mean over
    (2B, H) on the card may reduce with a thread layout that depends on B,
    and a slot of the batched engine must come out bit for bit as the
    runner's pair."""
    return torch.cat([rms_norm(x[r:r + 2], w.dec_norm)
                      for r in range(0, x.shape[0], 2)])


def cfg_logits(cfg: DiaConfig, w: DiaWeights, h: torch.Tensor) -> torch.Tensor:
    """Normed rows h (2B, H) -> (B, n_heads, vocab) CFG-merged logits: the
    stacked heads (K1 for quantized heads; per-head padded columns sliced
    off), cond + cfg_scale * (cond - uncond), tokens above cfg_max_output
    set to -inf."""
    out = matmul(h, w.heads)
    nh = cfg.n_output_heads
    out = out.reshape(-1, 2, nh, out.shape[-1] // nh)[..., : cfg.output_vocab_size]
    cond, uncond = out[:, 0], out[:, 1]
    merged = cond + cfg.cfg_scale * (cond - uncond)
    tok = torch.arange(cfg.output_vocab_size, device=h.device)
    return merged.masked_fill(tok > cfg.cfg_max_output, float("-inf"))


def decode_layers(cfg: DiaConfig, w: DiaWeights, x, kv_k, kv_v, pos,
                  cross: DiaCross):
    """The per-matmul decode step of B requests over x (2B, H), pair s at
    cache row pos[s] (pos (B,) int32) of its caches kv_k / kv_v (L, 2B,
    n_kv, ctx, D). Row pos[s] is written in place (a frozen pair's too:
    nothing reads it), then attended with rows [0, pos[s]] through K4 at
    scale 1.0. The cross-attention reads the full f32 window (the runner's
    DiaCross, vtail None) or, as the JAX engine's per-matmul route does,
    the bucketed rows with the pad-tail fold (the engine's). Returns the
    layers' output before the final norm."""
    rows = x.shape[0]
    nh, nkv, d = cfg.decoder_attn_heads, cfg.n_kv_heads, cfg.head_size
    pos2 = pos.repeat_interleave(rows // pos.numel())
    p = pos2.long().clamp(max=kv_k.shape[3] - 1)
    r_i = torch.arange(rows, device=x.device)
    inv = inv_freq(d, x.device)

    def rope(y, n):  # (R, n * D) -> (R, n, D), row r at pos2[r]
        y = y.reshape(rows, n, d).transpose(0, 1)
        return apply_rope_neox(y, pos2, inv).transpose(0, 1)

    for i in range(cfg.n_decoder_layers):
        lw = _layer(w.dec_layers, i)
        h = rms_norm(x, lw.sa_norm)
        q = rope(matmul(h, lw.self_q), nh)
        kv_k[i][r_i, :, p] = rope(matmul(h, lw.self_k), nkv).to(kv_k.dtype)
        kv_v[i][r_i, :, p] = matmul(h, lw.self_v).reshape(rows, nkv, d).to(kv_v.dtype)
        a = decode_attention_batched(q.contiguous(), kv_k[i], kv_v[i], pos2, 1.0)
        x = x + matmul(a.reshape(rows, nh * d), lw.self_o)
        h = rms_norm(x, lw.ca_norm)
        cq = rope(matmul(h, lw.cross_q), nh)
        ck, cv = (c[i].reshape(rows, nh, -1, d) for c in (cross.ck, cross.cv))
        if cross.vtail is None:
            ca = sdpa(cq[:, :, None, :], ck, cv, None, scale=1.0)
        else:
            ca = cross_attention_plain(cq, ck, cv, cross.vtail[i].reshape(
                rows, nh, d), cross.n_tail)
        x = x + matmul(ca.reshape(rows, nh * d), lw.cross_o)
        h = rms_norm(x, lw.mlp_norm)
        x = x + matmul(torch.nn.functional.silu(matmul(h, lw.gate)) *
                       matmul(h, lw.up), lw.wo)
    return x


def step_logits(cfg: DiaConfig, w: DiaWeights, tokens_in, pos, kv_k, kv_v,
                cross: DiaCross, mega: Mega | None) -> torch.Tensor:
    """The forward half of a decode step for one request: embedding, the
    layers (K10 or per matmul), final norm, heads, CFG merge -> (n_heads,
    vocab) logits. tokens_in (n_heads,); pos (1,) int32; kv_k / kv_v (L, 2,
    n_kv, ctx, D), row pos written in place."""
    x = embed_step(w, tokens_in[None])
    kw = dict(n_heads=cfg.decoder_attn_heads, n_kv=cfg.n_kv_heads)
    if mega is not None and mega.persistent:
        xo, _, _ = dia_megastep(mega.layers, x, kv_k, kv_v, pos, cross.ck,
                                cross.cv, cross.vtail, cross.n_tail,
                                qtype=mega.qtype, **kw)
    elif mega is not None:
        # K11's launch sequence at one pair, which computes what K10
        # computes, bit for bit: views of the pair's caches and cross K/V
        heads = cfg.decoder_attn_heads
        xo, _, _ = dia_megastep_batched(
            mega.layers, x, kv_k[:, None], kv_v[:, None], pos,
            *(t.unflatten(1, (2, heads))[:, None]
              for t in (cross.ck, cross.cv, cross.vtail)),
            cross.n_tail, qtype=mega.qtype, **kw)
    else:
        xo = decode_layers(cfg, w, x, kv_k, kv_v, pos, cross)
    return cfg_logits(cfg, w, final_norm(w, xo))[0]


class DiaState(NamedTuple):
    kv_k: Any            # (L, 2, n_kv, max_steps, D)
    kv_v: Any
    pos: Any             # (1,) int32: cache row of this step
    tokens_in: Any       # (n_heads,) int64
    delay_steps: Any     # (1,) int32, -1 = wind-down not started
    done: Any            # (1,) bool
    out_tokens: Any      # (max_steps, n_heads) int64
    sampler_state: sampling.SamplerState


def init_state(cfg: DiaConfig, max_steps: int, device=None) -> DiaState:
    """The decode state before the first step, on `device` (default cuda,
    see common.default_device)."""
    device = default_device(device)
    nh = cfg.n_output_heads
    shape = (cfg.n_decoder_layers, 2, cfg.n_kv_heads, max_steps, cfg.head_size)
    kv = dict(dtype=kv_cache_dtype(device), device=device)
    return DiaState(
        kv_k=torch.zeros(shape, **kv), kv_v=torch.zeros(shape, **kv),
        pos=torch.zeros((1,), dtype=torch.int32, device=device),
        tokens_in=torch.full((nh,), cfg.bos_token_id, dtype=torch.int64,
                             device=device),
        delay_steps=torch.full((1,), -1, dtype=torch.int32, device=device),
        done=torch.zeros((1,), dtype=torch.bool, device=device),
        out_tokens=torch.zeros((max_steps, nh), dtype=torch.int64, device=device),
        sampler_state=sampling.init_state(nh, device))


_DELAY: dict = {}


def delay_pattern(cfg: DiaConfig, device) -> torch.Tensor:
    """(n_heads,) int32 delays on `device`, made once per pattern and
    device."""
    key = (cfg.delay_pattern, str(device))
    if key not in _DELAY:
        _DELAY[key] = torch.tensor(cfg.delay_pattern, dtype=torch.int32,
                                   device=device)
    return _DELAY[key]


def wind_down(cfg: DiaConfig, tokens_in, delay_steps, pos, max_steps: int):
    """check_stopping (model.cpp:806-823) on a step's INPUT, for rows of
    requests: tokens_in (B, n_heads), delay_steps and pos (B,). EOS on
    channel 0, or a position max_delay from the end, starts the wind-down;
    during it, channel c gets EOS at wind-down step delay[c] and PAD after.
    Returns (the step's input tokens, the decremented delay counter, whether
    the wind-down just ended)."""
    delay = delay_pattern(cfg, tokens_in.device)[None, :]
    ds = torch.where((delay_steps == -1) & (
        (tokens_in[:, 0] == cfg.eos_token_id) |
        (pos >= max_steps - cfg.max_delay)), cfg.max_delay, delay_steps)
    in_delay = (ds > 0)[:, None]
    after = (cfg.max_delay - ds)[:, None]
    t_in = torch.where(in_delay & (delay == after), cfg.eos_token_id, tokens_in)
    t_in = torch.where(in_delay & (after > delay), cfg.pad_token_id, t_in)
    ds = torch.where(ds > 0, ds - 1, ds)
    return t_in, ds, ds == 0


def next_tokens(cfg: DiaConfig, toks, new_pos) -> torch.Tensor:
    """The next step's input: channel c gets BOS until the step past c
    (toks (B, n_heads), new_pos (B,))."""
    heads_i = torch.arange(cfg.n_output_heads, device=toks.device)
    return torch.where(new_pos[:, None] > heads_i[None, :], toks,
                       torch.full_like(toks, cfg.bos_token_id))


def decode_step(cfg: DiaConfig, w: DiaWeights, st: DiaState, cross: DiaCross,
                generator, *, max_steps: int, mega: Mega | None = None,
                logits: torch.Tensor | None = None, **sample_kw) -> DiaState:
    """One decode step (the JAX package's `dia_decode_chunk` step): the
    wind-down, the forward (`step_logits`, or the given `logits`), sampling,
    then the frozen-state select: a step at which generation is done keeps
    the state as it was, `done` aside (the KV cache aside too: the stale row
    pos is written, and no later step reads it). Writes this step's K/V in
    place; everything else out of place."""
    t_in, ds, ended = wind_down(cfg, st.tokens_in[None], st.delay_steps,
                                st.pos, max_steps)
    now_done = ended | st.done | (st.pos >= max_steps)
    pos_c = st.pos.clamp(max=max_steps - 1)
    if logits is None:
        logits = step_logits(cfg, w, t_in[0], pos_c, st.kv_k, st.kv_v, cross,
                             mega)
    toks, s_state = sampling.sample_or_greedy(generator, logits,
                                              st.sampler_state, **sample_kw)
    out = st.out_tokens.index_copy(0, pos_c.long(), toks[None, :])
    new_pos = st.pos + 1

    def sel(old, new):
        return torch.where(now_done, old, new)

    return DiaState(
        st.kv_k, st.kv_v, sel(st.pos, new_pos),
        sel(st.tokens_in, next_tokens(cfg, toks[None], new_pos)[0]),
        sel(st.delay_steps, ds), now_done | st.done, sel(st.out_tokens, out),
        sampling.SamplerState(*[sel(a, b) for a, b in
                                zip(st.sampler_state, s_state)]))


def decode_chunk(cfg: DiaConfig, w: DiaWeights, st: DiaState, cross: DiaCross,
                 n_steps: int, generator, **step_kw) -> DiaState:
    """n_steps decode steps with no host sync."""
    for _ in range(n_steps):
        st = decode_step(cfg, w, st, cross, generator, **step_kw)
    return st


@torch.no_grad()
def dia_generate_tokens_chunked(cfg: DiaConfig, w: DiaWeights, cross: DiaCross,
                                generator, *, max_steps: int,
                                chunk: int | None = None,
                                mega: Mega | None = None, **sample_kw):
    """The AR loop with one host sync per chunk; chunk sizes follow
    `chunk_schedule` (64, 128, 256, ...) unless `chunk` pins one. Every step
    before the wind-down ends is real and the wind-down ends by the step at
    max_steps - 1, so chunks are cut there: the steps skipped would leave
    the state as it was. Returns (out_tokens (max_steps, n_heads) tensor,
    n_steps)."""
    sched = iter(lambda: chunk, None) if chunk else chunk_schedule()
    st = init_state(cfg, max_steps, w.dec_norm.device)
    n = 0
    for c in sched:
        c = min(c, max_steps - n)
        if c <= 0:
            break
        st = decode_chunk(cfg, w, st, cross, c, generator, max_steps=max_steps,
                          mega=mega, **sample_kw)
        n += c
        if bool(st.done):
            break
    return st.out_tokens, int(st.pos)


def adjust_output_tokens(out: np.ndarray, n_steps: int, cfg: DiaConfig) -> np.ndarray:
    """Delay undo (model.cpp:825-847): frame i channel c reads out[i +
    delay_pattern[c], c]; frames holding a token outside the audio vocab are
    dropped."""
    delay = np.asarray(cfg.delay_pattern)
    out = np.asarray(out[:n_steps])
    frames = []
    for i in range(max(0, n_steps - cfg.max_delay)):
        idx = i + delay
        if np.any(idx >= n_steps):
            break
        row = out[idx, np.arange(cfg.n_output_heads)]
        if np.all(row < cfg.audio_vocab_size):
            frames.append(row)
    if not frames:
        return np.zeros((0, cfg.n_output_heads), np.int64)
    return np.stack(frames).astype(np.int64)


def tokenize_sentence(text: str, cfg: DiaConfig) -> List[int]:
    """Byte tokenizer with [S1] / [S2] -> 0x01 / 0x02 (model.cpp:639-684)."""
    text = text.strip()
    if not text.startswith("[S1]") and not text.startswith("[S2]"):
        text = "[S1] " + text
    if not text.endswith("."):
        text = text + "."
    text = text.replace("[S1]", "\x01").replace("[S2]", "\x02")
    data = text.encode("utf-8")
    if len(data) > cfg.max_encoder_context_length:
        raise ValueError(
            f"Dia supports at most {cfg.max_encoder_context_length} "
            f"characters; got {len(data)}")
    return list(data)


def encode_request(cfg: DiaConfig, w: DiaWeights, ids: List[int]):
    """dia_encode on the prompt ids: (cross_k, cross_v) (L, 2, heads, Tc, D)
    on the weights' device."""
    tokens = torch.zeros((2, cfg.max_encoder_context_length), dtype=torch.int64,
                         device=w.dec_norm.device)
    tokens[0, :len(ids)] = torch.tensor(ids, dtype=torch.int64)
    _, ck, cv = dia_encode(cfg, w, tokens, len(ids))
    return ck, cv


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

@torch.no_grad()
def load_dia_weights(r: GGUFReader, cfg: DiaConfig, device=None) -> DiaWeights:
    """The encoder and decoder weights on `device` (default cuda, see
    common.default_device); the 9 stacked heads become one (9 x vocab, H)
    weight."""
    device = default_device(device)

    def get(name):
        return from_gguf_tensor(r, name, device)

    enc = []
    for l in range(cfg.n_encoder_layers):
        b = f"dia.encoder.layers.{l}."
        enc.append(DiaEncoderLayer(
            sa_norm=get(b + "pre_sa_norm"), q=get(b + "q_proj"),
            k=get(b + "k_proj"), v=get(b + "v_proj"), o=get(b + "o_proj"),
            mlp_norm=get(b + "post_sa_norm"), gate=get(b + "gate"),
            up=get(b + "up"), wo=get(b + "wo")))
    dec = []
    for l in range(cfg.n_decoder_layers):
        b = f"dia.decoder.layers.{l}."
        dec.append(DiaDecoderLayer(
            sa_norm=get(b + "pre_sa_norm"),
            self_q=get(b + "self_q_proj"), self_k=get(b + "self_k_proj"),
            self_v=get(b + "self_v_proj"), self_o=get(b + "self_o_proj"),
            ca_norm=get(b + "pre_ca_norm"),
            cross_q=get(b + "cross_q_proj"), cross_k=get(b + "cross_k_proj"),
            cross_v=get(b + "cross_v_proj"), cross_o=get(b + "cross_o_proj"),
            mlp_norm=get(b + "pre_mlp_norm"), gate=get(b + "gate"),
            up=get(b + "up"), wo=get(b + "wo")))
    heads = stack_weights([get(f"dia.decoder.heads.{i}")
                           for i in range(cfg.n_output_heads)])
    if isinstance(heads, QuantTensor):
        heads = QuantTensor(heads.codes.reshape(-1, heads.codes.shape[-1]),
                            heads.scales.reshape(-1, heads.scales.shape[-1]),
                            heads.qtype)
    else:
        heads = heads.reshape(-1, heads.shape[-1])

    def stack(lws, cls):
        return cls(*[stack_weights([getattr(lw, f) for lw in lws])
                     for f in cls._fields])

    return DiaWeights(
        enc_embedding=dense(get("dia.encoder.embedding")),
        enc_layers=stack(enc, DiaEncoderLayer),
        enc_norm=get("dia.encoder.norm"),
        dec_embds=torch.stack([dense(get(f"dia.decoder.embeddings.{i}"))
                               for i in range(cfg.n_output_heads)]),
        dec_layers=stack(dec, DiaDecoderLayer),
        dec_norm=get("dia.decoder.norm"), heads=heads)


def check_device(weights: DiaWeights, device=None) -> torch.device:
    """The device a runner or engine runs on (default cuda, see
    common.default_device), which its weights must lie on: their device
    (with its index) is returned."""
    device = default_device(device)
    w = weights.dec_norm.device
    if w.type != device.type or device.index not in (None, w.index):
        raise ValueError(f"the weights lie on {w}, not on {device}")
    return w


class DiaRunner(TTSRunner):
    """Runs on `device` (default cuda; raises when there is no card and the
    caller did not ask for device="cpu"), where its weights lie."""

    arch = "dia"
    sample_rate = SAMPLE_RATE_DAC
    tokenizer = None   # a byte tokenizer: tokenize_sentence

    def __init__(self, cfg: DiaConfig, weights: DiaWeights, dac_runner=None,
                 device=None):
        self.device = check_device(weights, device)
        strict_fp32()
        self.cfg = cfg
        if isinstance(weights.heads, QuantTensor):
            # per-head vocab padding (1028 -> 1280) with zero scales, bf16
            # scales (the `_dqdot` numerics of the decode loop's heads) and
            # packed Q4 codes; padded logits are zero and sliced off before
            # the CFG merge
            weights = weights._replace(heads=weights.heads.fast_stacked_heads(
                cfg.n_output_heads, cfg.output_vocab_size))
        self.weights = weights
        self.dac = dac_runner
        self.mega = maybe_prep_dia_mega(cfg, weights)

    def encode(self, ids: List[int]) -> DiaCross:
        """Encoder pass and the cross K/V for the active decode route."""
        ck, cv = encode_request(self.cfg, self.weights, ids)
        if self.mega is None:
            return DiaCross(ck, cv, None, 0)
        return DiaCross(*prep_dia_cross(ck, cv, len(ids)))

    def _encoded(self, text: str, config: GenerationConfig):
        """Tokenize and encode `text`: (the cross K/V of the decode route,
        the generation window, the seeded generator, the step's keywords)."""
        cfg = self.cfg
        cross = self.encode(tokenize_sentence(text, cfg))
        max_steps = cfg.max_generation_size
        if config.max_tokens and config.max_tokens > cfg.max_delay:
            max_steps = config.max_tokens
        seed = config.seed if config.seed is not None else np.random.randint(2 ** 31)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        step_kw = dict(max_steps=max_steps, mega=self.mega,
                       do_sample=config.sample,
                       temperature=float(config.temperature),
                       top_k=int(config.top_k), top_p=float(config.top_p),
                       repetition_penalty=float(config.repetition_penalty))
        return cross, max_steps, gen, step_kw

    def generate_codes(self, text: str, config: GenerationConfig) -> np.ndarray:
        """Text -> (frames, n_heads) int codes (delay-undone, filtered)."""
        cross, _, gen, step_kw = self._encoded(text, config)
        out, n_steps = dia_generate_tokens_chunked(self.cfg, self.weights,
                                                   cross, gen, **step_kw)
        return adjust_output_tokens(out.cpu().numpy(), n_steps, self.cfg)

    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        config = config or GenerationConfig()
        codes = self.generate_codes(text, config)
        if self.dac is None or codes.shape[0] == 0:
            return TTSResponse(np.zeros(0, np.float32), SAMPLE_RATE_DAC)
        return TTSResponse(np.asarray(self.dac.decode(codes), np.float32),
                           SAMPLE_RATE_DAC)

    @torch.no_grad()
    def generate_stream(self, text: str, config: GenerationConfig | None = None,
                        chunk: int = 64, margin: int = 16):
        """Streaming generation (the JAX runner's `generate_stream`): the
        encoder, then decode chunks of `chunk` steps, each vocoded through
        the DAC with `margin` frames of overlap (`dac.stream_segment`;
        delay-undone frames are append-only, so the stream matches
        `generate` away from the seams). Each chunk reads the host one
        tensor: [done, pos] over the output rows so far. The steps are
        `generate_codes`'s (K10 on a quantized model), so greedy codes are
        equal."""
        from ..codec.dac import stream_segment
        config = config or GenerationConfig()
        cfg = self.cfg
        cross, max_steps, gen, step_kw = self._encoded(text, config)
        st = init_state(cfg, max_steps, self.device)
        emitted = n = 0
        while True:
            c = min(chunk, max_steps - n)
            if c > 0:
                st = decode_chunk(cfg, self.weights, st, cross, c, gen, **step_kw)
                n += c
            packed = torch.cat([st.done.long(), st.pos.long(),
                                st.out_tokens[:n].reshape(-1)]).cpu().numpy()
            done = bool(packed[0]) or n >= max_steps
            codes = adjust_output_tokens(
                packed[2:].reshape(n, cfg.n_output_heads), int(packed[1]), cfg)
            if self.dac is not None:
                seg, emitted = stream_segment(self.dac, codes, emitted, done,
                                              margin)
                if seg is not None:
                    yield seg
            if done:
                break
