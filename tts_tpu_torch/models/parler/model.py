"""Parler-TTS decoder in PyTorch, the port of the JAX package's
`models/parler/model.py`.

Model math (reference build_parler_graph, model.cpp:520-614): pre-LN
transformer, learned positional embeddings, causal self-attention with KV
cache, cross-attention against K/V precomputed from the baked T5 text
encoding, tanh-GELU MLP, 9 codebook LM heads. Decode embeds the 9 previous
codebook tokens by summing 9 embedding tables.

Generation protocol (model.cpp:762-858): prompt prefill (no sampling) ->
per-step 9-head sampling with per-channel delay (head i receives BOS until
step > i) and EOS latching; stop when all channels saw EOS or position
reaches max_generation; delay-undo + invalid-frame filtering -> DAC.

The decode loop keeps all its state on the device: position and step are
one-element int32 tensors that the kernels read from device memory, and a
step that runs after generation is done leaves the state as it was (the
JAX package's frozen-state chunk semantics), so the host syncs once per
chunk. The KV cache is updated in place.

Decode step paths, chosen by the weights and not by the device: when all 8
projections are block-quantized with one qtype and the dims qualify, the
transformer stack runs as the megastep (ops/parler_megastep, kernel K2,
which uses K3 for attention); otherwise per matmul (K1 for quantized
weights, K3 for the self-attention). A second megastep route, K12 (one
persistent launch per step, ops/parler_flat), is taken when the runner's
`mega` is a `ParlerFlat` (`maybe_prep_parler_flat`); the runner keeps K2
by default, as the JAX runner does. On CPU tensors every kernel runs its
plain PyTorch version.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ...common import (GenerationConfig, SAMPLE_RATE_DAC, TTSResponse,
                       chunk_schedule, default_device, kv_cache_dtype,
                       strict_fp32)
from ...gguf.reader import GGUFReader
from ...ops import sampling
from ...ops.attention import sdpa
from ...ops.decode_attention import decode_attention
from ...ops.linear import (Weight, dense, from_gguf_tensor, matmul,
                           stack_weights, take_rows)
from ...ops.parler_flat import (ParlerFlat, parler_flat_megastep,
                                prep_parler_flat)
from ...ops.parler_megastep import (LN_EPS, layer_norm, parler_megastep,
                                    prep_mega_layers)
from ...ops.quant_matmul import QuantTensor
from ...text import UnigramTokenizer
from ..base import TTSRunner


@dataclasses.dataclass(eq=False)
class ParlerConfig:
    """Reference defaults = Parler Mini v1 (parler/model.h:66-82); overridden
    by GGUF keys parler-tts.decoder.* (model.cpp:51-108)."""

    n_output_heads: int = 9
    n_encode_length: int = 0
    hidden_size: int = 1024
    max_ctx_length: int = 4096
    n_attn_heads: int = 16
    output_vocab_size: int = 1088
    eos_token_id: int = 1024
    audio_vocab_size: int = 1024
    max_generation_size: int = 2580
    n_layers: int = 24
    bos_token_id: int = 1025
    use_cross_attn: bool = True

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.n_attn_heads

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "ParlerConfig":
        g = lambda keys, d: r.first_key(keys, d)  # noqa: E731
        c = cls()
        c.n_encode_length = int(g(["parler-tts.decoder.encode_length", "encode_length"], 0))
        c.hidden_size = int(g(["parler-tts.decoder.hidden_size", "hidden_size"], c.hidden_size))
        c.n_output_heads = int(g(["parler-tts.decoder.output_heads", "output_heads"], c.n_output_heads))
        c.max_ctx_length = int(g(["parler-tts.decoder.context_length", "ctx_length"], c.max_ctx_length))
        c.n_attn_heads = int(g(["parler-tts.decoder.attention.head_count", "attn_heads"], c.n_attn_heads))
        c.output_vocab_size = int(g(["parler-tts.decoder.out_vocab_size", "out_vocab_size"], c.output_vocab_size))
        c.audio_vocab_size = int(g(["parler-tts.decoder.audio_vocab_size", "audio_vocab_size"], c.audio_vocab_size))
        c.max_generation_size = int(g(["parler-tts.decoder.max_generation", "max_generation"], c.max_generation_size))
        c.n_layers = int(g(["parler-tts.decoder.num_hidden_layers", "num_hidden_layers"], c.n_layers))
        c.bos_token_id = int(g(["audio.bos_token_id", "bos_token_id"], c.bos_token_id))
        c.eos_token_id = int(g(["audio.eos_token_id", "eos_token_id"], c.eos_token_id))
        return c


class ParlerLayerWeights(NamedTuple):
    """All leaves stacked on the layer axis 0."""
    ln1_w: Any; ln1_b: Any
    q_w: Weight; k_w: Weight; v_w: Weight; o_w: Weight
    lnc_w: Any; lnc_b: Any          # cross-attn norm (zeros if disabled)
    cq_w: Weight; co_w: Weight      # cross q / out proj
    cross_k: Any; cross_v: Any      # (L, heads, Tc, D) precomputed
    ln2_w: Any; ln2_b: Any
    fc1: Weight; fc2: Weight


class ParlerWeights(NamedTuple):
    layers: ParlerLayerWeights
    embds: Any                      # (n_heads, vocab+, H) audio codebook embeds
    prompt_embd: Weight             # (prompt_vocab, H)
    pos_embd: Any                   # (max_ctx, H)
    final_ln_w: Any; final_ln_b: Any
    heads: Weight                   # (n_heads * vocab, H) stacked LM heads


def _split_heads(x, n_heads):
    """(T, H) -> (heads, T, D)."""
    return x.reshape(x.shape[0], n_heads, -1).transpose(0, 1)


def _layer(layers: ParlerLayerWeights, i: int) -> ParlerLayerWeights:
    return ParlerLayerWeights(*[f[i] for f in layers])


def _layer_step(cfg: ParlerConfig, lw: ParlerLayerWeights, x, kv_k, kv_v,
                pos, attn_bias, use_cross: bool):
    """One transformer layer over x (T, H). kv_k/kv_v (heads, ctx, D) are
    this layer's cache, written in place at rows [pos, pos+T): T > 1 is the
    prefill (pos 0, causal `attn_bias`), T == 1 a decode step (pos a
    one-element device tensor, attention through K3)."""
    t = x.shape[0]
    h = layer_norm(x, lw.ln1_w, lw.ln1_b)
    q = _split_heads(matmul(h, lw.q_w), cfg.n_attn_heads)
    k = _split_heads(matmul(h, lw.k_w), cfg.n_attn_heads)
    v = _split_heads(matmul(h, lw.v_w), cfg.n_attn_heads)
    if t == 1:
        p = pos.long().reshape(1).clamp(max=kv_k.shape[1] - 1)
        kv_k.index_copy_(1, p, k.to(kv_k.dtype))
        kv_v.index_copy_(1, p, v.to(kv_v.dtype))
        attn = decode_attention(q[:, 0, :].contiguous(), kv_k, kv_v, pos)[:, None, :]
    else:
        kv_k[:, pos:pos + t] = k.to(kv_k.dtype)
        kv_v[:, pos:pos + t] = v.to(kv_v.dtype)
        attn = sdpa(q, kv_k, kv_v, bias=attn_bias)        # (heads, T, D)
    x = x + matmul(attn.transpose(0, 1).reshape(t, cfg.hidden_size), lw.o_w)
    if use_cross:
        h = layer_norm(x, lw.lnc_w, lw.lnc_b)
        q = _split_heads(matmul(h, lw.cq_w), cfg.n_attn_heads)
        attn = sdpa(q, lw.cross_k, lw.cross_v)
        x = x + matmul(attn.transpose(0, 1).reshape(t, cfg.hidden_size), lw.co_w)
    h = layer_norm(x, lw.ln2_w, lw.ln2_b)
    h = torch.nn.functional.gelu(matmul(h, lw.fc1), approximate="tanh")
    return x + matmul(h, lw.fc2)


def final_norm(w: ParlerWeights, x):
    """The decoder's final layer norm over rows x (T, H).

    torch's layer_norm computes each row with the same threads and order
    whatever the number of rows, so a batch row comes out bit for bit as
    the same row alone: the batched engine's logits then equal the
    single-stream step's (a two-pass mean over (B, H) is reduced with a
    thread layout that depends on B)."""
    return torch.nn.functional.layer_norm(x, x.shape[-1:], w.final_ln_w,
                                          w.final_ln_b, eps=LN_EPS)


def _transformer(cfg: ParlerConfig, w: ParlerWeights, x, kv_k, kv_v, pos,
                 attn_bias, use_cross: bool):
    """All layers, then the final layer norm. kv_k/kv_v: (L, heads, ctx, D)."""
    for i in range(cfg.n_layers):
        x = _layer_step(cfg, _layer(w.layers, i), x, kv_k[i], kv_v[i], pos,
                        attn_bias, use_cross)
    return final_norm(w, x)


def _logits_last(cfg: ParlerConfig, w: ParlerWeights, x):
    """(B, H) hidden rows -> (B, n_heads, vocab) logits via the stacked head
    matmul (K1 for quantized heads, one row per slot). Per-head vocab
    padding (fast_stacked_heads) gives exactly-zero columns, sliced off
    here."""
    out = matmul(x, w.heads)
    vocab_p = out.shape[-1] // cfg.n_output_heads
    return out.reshape(x.shape[0], cfg.n_output_heads, vocab_p)[
        :, :, : cfg.output_vocab_size]


def embed_step(cfg: ParlerConfig, w: ParlerWeights, tokens_in, pos):
    """A decode step's input rows: the sum of the 9 codebook embeddings of
    tokens_in (B, n_heads) plus the positional embedding at pos (B,)."""
    heads_i = torch.arange(cfg.n_output_heads, device=tokens_in.device)
    tok = tokens_in.clamp(max=w.embds.shape[1] - 1)
    return w.embds[heads_i[None, :], tok].sum(dim=1) + \
        w.pos_embd[pos.long().clamp(max=w.pos_embd.shape[0] - 1)]


@torch.no_grad()
def parler_prefill(cfg: ParlerConfig, w: ParlerWeights, tokens: torch.Tensor,
                   kv_k, kv_v, use_cross: bool = True) -> None:
    """Prompt prefill: tokens (P,) write KV rows [0, P) in place.

    The JAX package pads P to a length bucket for XLA's static shapes (its
    padded rows are junk that audio steps overwrite before any query reads
    them); eager PyTorch prefills the exact length."""
    p = tokens.shape[0]
    x = take_rows(w.prompt_embd, tokens) + w.pos_embd[:p]
    i = torch.arange(p, device=x.device)[:, None]
    j = torch.arange(kv_k.shape[-2], device=x.device)[None, :]
    bias = torch.zeros((p, kv_k.shape[-2]), device=x.device).masked_fill(
        j > i, float("-inf"))
    _transformer(cfg, w, x, kv_k, kv_v, 0, bias, use_cross)


class DecodeState(NamedTuple):
    kv_k: Any
    kv_v: Any
    pos: Any            # (1,) int32: current cache position (prompt_len + step)
    step: Any           # (1,) int32: audio step counter
    tokens_in: Any      # (n_heads,) int64 next input codebook tokens
    eos_seen: Any       # (n_heads,) bool — lags one step for the feed
    out_tokens: Any     # (max_gen, n_heads) int64
    sampler_state: sampling.SamplerState


class Mega(NamedTuple):
    """The megastep's weights and their qtype (see maybe_prep_mega)."""
    layers: Any
    qtype: int


def init_state(cfg: ParlerConfig, prompt_len: int, kv_k, kv_v) -> DecodeState:
    nh, dev = cfg.n_output_heads, kv_k.device
    return DecodeState(
        kv_k=kv_k, kv_v=kv_v,
        pos=torch.tensor([prompt_len], dtype=torch.int32, device=dev),
        step=torch.zeros((1,), dtype=torch.int32, device=dev),
        tokens_in=torch.full((nh,), cfg.bos_token_id, dtype=torch.int64, device=dev),
        eos_seen=torch.zeros((nh,), dtype=torch.bool, device=dev),
        out_tokens=torch.zeros((cfg.max_generation_size, nh), dtype=torch.int64,
                               device=dev),
        sampler_state=sampling.init_state(nh, dev))


def not_done(cfg: ParlerConfig, st: DecodeState) -> torch.Tensor:
    """(1,) bool on the device. Reference check_stopping (model.cpp:715-732):
    stop at max position or when every channel latched EOS (only checked
    once outputs exist). Quirk kept from the reference: the position test is
    pos < max_generation_size although pos counts the prompt too."""
    max_steps = cfg.max_generation_size
    return ((st.step == 0) | ~st.eos_seen.all()) & (st.pos < max_steps) & \
        (st.step < max_steps)


def step_logits(cfg: ParlerConfig, w: ParlerWeights, st: DecodeState, *,
                use_cross: bool,
                mega: Mega | ParlerFlat | None = None) -> torch.Tensor:
    """The forward half of a decode step: embeddings sum, transformer
    (K12 for a `ParlerFlat` prepared for this `use_cross`, K2 for a `Mega`,
    else per matmul, as the JAX decode body chooses), final LN, LM heads ->
    (n_heads, vocab) logits. Writes this step's K/V into the cache in
    place."""
    x = embed_step(cfg, w, st.tokens_in[None, :], st.pos)
    if isinstance(mega, ParlerFlat) and mega.use_cross == use_cross:
        xo, _, _ = parler_flat_megastep(mega, x, st.kv_k, st.kv_v, st.pos,
                                        qtype=mega.qtype,
                                        n_heads=cfg.n_attn_heads)
        x = final_norm(w, xo)
    elif isinstance(mega, Mega):
        xo, _, _ = parler_megastep(mega.layers, x, st.kv_k, st.kv_v, st.pos,
                                   qtype=mega.qtype, use_cross=use_cross,
                                   n_heads=cfg.n_attn_heads)
        x = final_norm(w, xo)
    else:
        x = _transformer(cfg, w, x, st.kv_k, st.kv_v, st.pos, None, use_cross)
    return _logits_last(cfg, w, x)[0]


def advance(cfg: ParlerConfig, st: DecodeState, logits: torch.Tensor,
            generator, *, do_sample: bool, temperature: float, top_k: int,
            top_p: float, repetition_penalty: float) -> DecodeState:
    """The other half of a decode step: sampling from `logits`, delay/BOS
    feed, EOS latch; the state comes back out of place (the cache aside)."""
    heads_i = torch.arange(cfg.n_output_heads, device=st.tokens_in.device)
    toks, s_state = sampling.sample_or_greedy(
        generator, logits, st.sampler_state, do_sample=do_sample,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty)
    row = st.step.long().clamp(max=cfg.max_generation_size - 1)
    out = st.out_tokens.index_copy(0, row, toks[None, :])
    # the feed uses eos_seen as of BEFORE this sample (reference lag,
    # model.cpp:779-785), then latches with the new sample
    eos_tok = torch.full_like(toks, cfg.eos_token_id)
    nxt = torch.where(st.step + 1 > heads_i,
                      torch.where(st.eos_seen, eos_tok, toks),
                      torch.full_like(toks, cfg.bos_token_id))
    eos = st.eos_seen | (toks == cfg.eos_token_id)
    return DecodeState(st.kv_k, st.kv_v, st.pos + 1, st.step + 1, nxt, eos,
                       out, s_state)


def decode_step(cfg: ParlerConfig, w: ParlerWeights, st: DecodeState,
                generator, *, use_cross: bool,
                mega: Mega | ParlerFlat | None = None,
                **sample_kw) -> DecodeState:
    """One decode step: `step_logits`, then `advance` with `sample_kw`
    (do_sample, temperature, top_k, top_p, repetition_penalty). Writes this
    step's K/V into the cache in place; everything else out of place."""
    logits = step_logits(cfg, w, st, use_cross=use_cross, mega=mega)
    return advance(cfg, st, logits, generator, **sample_kw)


def decode_chunk(cfg: ParlerConfig, w: ParlerWeights, st: DecodeState,
                 n_steps: int, generator, **step_kw) -> DecodeState:
    """n_steps decode steps with no host sync; a step taken after the stop
    condition holds leaves the state unchanged (the KV cache aside: it
    writes the stale row `pos`, which no later step reads)."""
    for _ in range(n_steps):
        keep = not_done(cfg, st)                 # (1,): broadcasts to any leaf
        st2 = decode_step(cfg, w, st, generator, **step_kw)

        def sel(a, b):
            return torch.where(keep, b, a)

        st = DecodeState(
            st.kv_k, st.kv_v, sel(st.pos, st2.pos), sel(st.step, st2.step),
            sel(st.tokens_in, st2.tokens_in), sel(st.eos_seen, st2.eos_seen),
            sel(st.out_tokens, st2.out_tokens),
            sampling.SamplerState(*[sel(a, b) for a, b in
                                    zip(st.sampler_state, st2.sampler_state)]))
    return st


@torch.no_grad()
def generate_tokens_chunked(cfg: ParlerConfig, w: ParlerWeights,
                            prompt_len: int, kv_k, kv_v, generator,
                            chunk: int | None = None, **step_kw):
    """Chunked generation with one host sync per chunk; chunk sizes follow
    `chunk_schedule` (64, 128, 256, ...) unless `chunk` pins one. Returns
    (out_tokens (max_gen, n_heads) tensor, n_steps int)."""
    sched = iter(lambda: chunk, None) if chunk else chunk_schedule()
    st = init_state(cfg, prompt_len, kv_k, kv_v)
    # Until the stop is seen every step is real, so the host knows pos and
    # step; chunks are cut where the max-position / max-step test must stop
    # generation, which skips only steps that would leave the state as it was.
    left = cfg.max_generation_size - max(prompt_len, 0)
    for c in sched:
        c = min(c, left)
        if c <= 0:
            break
        st = decode_chunk(cfg, w, st, c, generator, **step_kw)
        left -= c
        if not bool(not_done(cfg, st)):
            break
    return st.out_tokens, int(st.step)


def maybe_prep_mega(cfg: ParlerConfig, w: ParlerWeights) -> Mega | None:
    """The megastep's weights when its path applies: all 8 projections
    block-quantized with one qtype and kernel-friendly dims (as the JAX
    package's gate, model.py:461-463). Depends on the weights, not on the
    device. None -> the per-matmul path."""
    if (cfg.hidden_size % 128 or cfg.head_size % 64 or
            cfg.hidden_size // 32 < 8):
        return None
    try:
        return Mega(*prep_mega_layers(w.layers))
    except ValueError:
        return None


def maybe_prep_parler_flat(cfg: ParlerConfig,
                           w: ParlerWeights) -> ParlerFlat | Mega | None:
    """K12's weights (ops/parler_flat) when the megastep applies and the
    shapes suit K12, else K2's `Mega` (as the JAX function falls back when
    `prep_parler_flat` raises), else None (per matmul). Chosen by the
    weights, never by the device. The runner preps K2 (`maybe_prep_mega`);
    assign `runner.mega = maybe_prep_parler_flat(cfg, runner.weights)` to
    take the K12 route."""
    mega = maybe_prep_mega(cfg, w)
    if mega is None:
        return None
    try:
        return prep_parler_flat(mega.layers, mega.qtype, cfg.max_ctx_length,
                                use_cross=cfg.use_cross_attn)
    except ValueError:
        return mega


def adjust_output_tokens(out: np.ndarray, n_steps: int, cfg: ParlerConfig) -> np.ndarray:
    """Delay-undo + invalid-frame filtering (reference model.cpp:734-760).

    frame i channel ii reads out[i+ii, ii]; frames containing any token
    >= audio_vocab_size (EOS/BOS/pad) are dropped.
    """
    nh = cfg.n_output_heads
    out = np.asarray(out[:n_steps])
    frames = []
    for i in range(n_steps):
        idx = i + np.arange(nh)
        if np.any(idx >= n_steps):
            break
        row = out[idx, np.arange(nh)]
        if np.all(row < cfg.audio_vocab_size):
            frames.append(row)
    if not frames:
        return np.zeros((0, nh), np.int64)
    return np.stack(frames).astype(np.int64)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def precompute_cross_kv(cfg: ParlerConfig, text_encoding: torch.Tensor,
                        k_ws: list, v_ws: list):
    """Per-layer cross K/V (L, heads, Tc, D) from the baked text encoding
    (reference prep_cross_key_values, model.cpp:110-173)."""
    ks = [_split_heads(matmul(text_encoding, kw), cfg.n_attn_heads) for kw in k_ws]
    vs = [_split_heads(matmul(text_encoding, vw), cfg.n_attn_heads) for vw in v_ws]
    return torch.stack(ks).contiguous(), torch.stack(vs).contiguous()


@torch.no_grad()
def load_parler_weights(r: GGUFReader, cfg: ParlerConfig, prefix: str = "decoder.",
                        device=None) -> ParlerWeights:
    """The decoder's weights on `device` (default cuda, see
    common.default_device)."""
    device = default_device(device)
    names = set(r.tensor_names())

    def get(name: str) -> Weight:
        return from_gguf_tensor(r, prefix + name, device)

    H = cfg.hidden_size
    zeros_h = torch.zeros((H,), device=device)
    zeros_hh = torch.zeros((H, H), device=device)
    lws, k_ws, v_ws = [], [], []
    for l in range(cfg.n_layers):
        b = f"layers.{l}."
        has_cross = (prefix + b + "encoder_attn.q_proj.weight") in names and cfg.use_cross_attn
        k_ws.append(get(b + "encoder_attn.k_proj.weight") if has_cross else None)
        v_ws.append(get(b + "encoder_attn.v_proj.weight") if has_cross else None)
        lws.append(dict(
            ln1_w=get(b + "self_attn_layer_norm.weight"),
            ln1_b=get(b + "self_attn_layer_norm.bias"),
            q_w=get(b + "self_attn.q_proj.weight"),
            k_w=get(b + "self_attn.k_proj.weight"),
            v_w=get(b + "self_attn.v_proj.weight"),
            o_w=get(b + "self_attn.out_proj.weight"),
            lnc_w=get(b + "encoder_attn_layer_norm.weight") if has_cross else zeros_h,
            lnc_b=get(b + "encoder_attn_layer_norm.bias") if has_cross else zeros_h,
            cq_w=get(b + "encoder_attn.q_proj.weight") if has_cross else zeros_hh,
            co_w=get(b + "encoder_attn.out_proj.weight") if has_cross else zeros_hh,
            ln2_w=get(b + "final_layer_norm.weight"),
            ln2_b=get(b + "final_layer_norm.bias"),
            fc1=get(b + "fc1.weight"),
            fc2=get(b + "fc2.weight"),
        ))

    use_cross = cfg.use_cross_attn and all(k is not None for k in k_ws) and \
        (prefix + "text_encoding") in names
    if use_cross:
        text_encoding = torch.from_numpy(np.array(
            r.array(prefix + "text_encoding"), dtype=np.float32)).to(device)
        cfg.n_encode_length = text_encoding.shape[0]
        cross_k, cross_v = precompute_cross_kv(cfg, text_encoding, k_ws, v_ws)
    else:
        cfg.use_cross_attn = False
        tc = max(cfg.n_encode_length, 1)
        cross_k = torch.zeros((cfg.n_layers, cfg.n_attn_heads, tc, cfg.head_size),
                              device=device)
        cross_v = torch.zeros_like(cross_k)

    layer_stack = ParlerLayerWeights(**{
        f: stack_weights([lw[f] for lw in lws]) for f in ParlerLayerWeights._fields
        if f not in ("cross_k", "cross_v")
    }, cross_k=cross_k, cross_v=cross_v)
    embds = torch.stack([dense(get(f"embed_tokens.{i}.weight"))
                         for i in range(cfg.n_output_heads)])
    heads = stack_weights([get(f"lm_heads.{i}.weight.head")
                           for i in range(cfg.n_output_heads)])
    # flatten stacked heads (nh, vocab, H) -> (nh*vocab, H) for one matmul
    if isinstance(heads, QuantTensor):
        heads = QuantTensor(heads.codes.reshape(-1, heads.codes.shape[-1]),
                            heads.scales.reshape(-1, heads.scales.shape[-1]),
                            heads.qtype)
    else:
        heads = heads.reshape(-1, heads.shape[-1])
    return ParlerWeights(
        layers=layer_stack, embds=embds, prompt_embd=get("embed_prompts"),
        pos_embd=dense(get("positional_embed")),
        final_ln_w=get("layer_norm.weight"), final_ln_b=get("layer_norm.bias"),
        heads=heads)


class ParlerRunner(TTSRunner):
    arch = "parler-tts"

    def __init__(self, cfg: ParlerConfig, weights: ParlerWeights,
                 tokenizer: UnigramTokenizer, dac_runner=None):
        strict_fp32()
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.dac = dac_runner
        if isinstance(weights.heads, QuantTensor):
            # per-head vocab padding + bf16 scales (the `_dqdot` numerics of
            # the decode loop's LM-head matvec) + packed Q4 codes
            weights = weights._replace(heads=weights.heads.fast_stacked_heads(
                cfg.n_output_heads, cfg.output_vocab_size))
        self.weights = weights
        self.device = weights.pos_embd.device
        self.mega = maybe_prep_mega(cfg, weights)

    def _empty_kv(self):
        c = self.cfg
        shape = (c.n_layers, c.n_attn_heads, c.max_ctx_length, c.head_size)
        dt = kv_cache_dtype(self.device)
        return (torch.zeros(shape, dtype=dt, device=self.device),
                torch.zeros(shape, dtype=dt, device=self.device))

    def generate_codes(self, text: str, config: GenerationConfig) -> np.ndarray:
        """Text -> (frames, n_heads) int codes (delay-undone, filtered)."""
        cfg = self.cfg
        ids = self.tokenizer.tokenize(text)
        ids.append(self.tokenizer.eos_token)
        tokens = torch.tensor(ids, dtype=torch.int64, device=self.device)
        kv_k, kv_v = self._empty_kv()
        parler_prefill(cfg, self.weights, tokens, kv_k, kv_v,
                       use_cross=cfg.use_cross_attn)
        seed = config.seed if config.seed is not None else np.random.randint(2**31)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        out, n_steps = generate_tokens_chunked(
            cfg, self.weights, len(ids), kv_k, kv_v, gen,
            use_cross=cfg.use_cross_attn, do_sample=config.sample,
            temperature=float(config.temperature), top_k=int(config.top_k),
            top_p=float(config.top_p),
            repetition_penalty=float(config.repetition_penalty),
            mega=self.mega)
        return adjust_output_tokens(out.cpu().numpy(), n_steps, cfg)

    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        config = config or GenerationConfig()
        codes = self.generate_codes(text, config)
        if self.dac is None or codes.shape[0] == 0:
            return TTSResponse(np.zeros(0, np.float32), SAMPLE_RATE_DAC)
        audio = self.dac.decode(codes)
        return TTSResponse(np.asarray(audio, np.float32), SAMPLE_RATE_DAC)
