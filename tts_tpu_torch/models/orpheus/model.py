"""Orpheus (3B, llama-3 architecture) in PyTorch, the port of the JAX
package's `models/orpheus/model.py`.

Parity: reference src/models/orpheus/model.cpp. A plain llama decoder: RMS
norm (eps 1e-5), GQA (24 q / 8 kv heads), NeoX RoPE theta 500000 with llama3
frequency factors, SiLU MLP, single LM head (vocab 156940). Tokens go to
SNAC in groups of 7 redistributed over 3 codebook heads with the fixed
offset undo t - 128266 - (i%7)*4096 (prepare_output_tokens,
model.cpp:371-387).

The decode loop keeps all its state on the device (position, output count
and done flag are one-element tensors the kernels read from device memory);
a step that runs after generation is done leaves the state as it was (the
JAX package's frozen-state chunk semantics), so the host syncs once per
chunk. The KV cache is updated in place.

Decode step routes, chosen by the weights and never by the device, as the
JAX package's `maybe_prep_llama_flat` chooses them:
  * K6 (ops/llama_flat.py) when every projection and the LM head are
    block-quantized with one qtype: the whole step, head included;
  * K8 (ops/llama_megastep.py) when the projections are but the head is not
    (e.g. an F16 head, as the quantizer leaves it without -qh): the layers,
    then the final norm and the head per matmul;
  * per matmul otherwise (`decode_layers`: K1 for quantized weights, K4
    for attention, one row per sequence as in the batched engine).
Both kernels use K3 for attention. On CPU tensors every kernel runs its
plain PyTorch version. Prefill runs per matmul (K1 for M <= 256).
The batched engine (runtime/batched_llama.py) shares the prefill, the
per-matmul decode layers, the prompt ids and the voice check with the
runner.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, NamedTuple

import numpy as np
import torch

from ...common import (GenerationConfig, SAMPLE_RATE_SNAC, TTSResponse,
                       chunk_schedule, default_device, kv_cache_dtype,
                       strict_fp32)
from ...gguf.reader import GGUFReader
from ...ops import sampling
from ...ops.attention import apply_rope_neox, gqa_prefill, rope_freqs
from ...ops.decode_attention import decode_attention_batched
from ...ops.linear import (Weight, dense, from_gguf_tensor, matmul,
                           stack_weights, take_rows)
from ...ops.llama_flat import LlamaFlat, llama_flat_megastep, prep_llama_flat
from ...ops.llama_megastep import llama_megastep, prep_llama_mega, rms_norm
from ...ops.quant_matmul import QuantTensor
from ...text import BPETokenizer
from ..base import TTSRunner

ORPHEUS_VOICES = ("zoe", "zac", "jess", "leo", "mia", "julia", "leah")
PREPENDED_TOKENS = (128259, 128000)
APPENDED_TOKENS = (128009, 128260, 128261, 128257)
HEAD_MAP = (0, 1, 2, 2, 1, 2, 2)  # token slot -> SNAC codebook head


@dataclasses.dataclass(eq=False)
class OrpheusConfig:
    """Defaults = Orpheus 3B (orpheus/model.h:30-46)."""

    vocab_size: int = 156940
    n_attn_heads: int = 24
    n_kv_heads: int = 8
    head_size: int = 128
    max_context_length: int = 1024
    max_generation_size: int = 2100
    stopping_token_id: int = 128258
    eos_token_id: int = 128001
    bos_token_id: int = 128000
    hidden_size: int = 3072
    n_layers: int = 28
    rope_theta: float = 500000.0

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "OrpheusConfig":
        c = cls()
        g = r.metadata.get
        c.vocab_size = int(g("orpheus.vocab_size", c.vocab_size))
        c.n_attn_heads = int(g("orpheus.attn_heads", c.n_attn_heads))
        c.n_kv_heads = int(g("orpheus.kv_attn_heads", c.n_kv_heads))
        c.head_size = int(g("orpheus.head_dim", c.head_size))
        c.stopping_token_id = int(g("orpheus.stopping_token_id", c.stopping_token_id))
        c.eos_token_id = int(g("tokenizer.ggml.eos_token_id", c.eos_token_id))
        c.bos_token_id = int(g("tokenizer.ggml.bos_token_id", c.bos_token_id))
        c.hidden_size = int(g("orpheus.hidden_size", c.hidden_size))
        c.n_layers = int(g("orpheus.layers", c.n_layers))
        return c


class OrpheusLayer(NamedTuple):
    """All leaves stacked on the layer axis 0."""
    in_norm: Any
    q: Weight; k: Weight; v: Weight; o: Weight
    post_norm: Any
    gate: Weight; up: Weight; down: Weight


class OrpheusWeights(NamedTuple):
    embd: Weight
    layers: OrpheusLayer
    out_norm: Any
    head: Weight
    rope_freqs: Any                 # llama3 frequency factors (head_size/2,)


def _layer(layers: OrpheusLayer, i: int) -> OrpheusLayer:
    return OrpheusLayer(*[f[i] for f in layers])


def _llama_step(cfg: OrpheusConfig, w: OrpheusWeights, inv, x, kv_k, kv_v,
                attn_bias):
    """The prefill: all layers and the final norm over the prompt x (T, H);
    kv_k/kv_v (L, n_kv, ctx, D) are written in place at rows [0, T), and
    `attn_bias` (T, ctx) is the causal mask over the whole cache."""
    t = x.shape[0]
    nh, nkv, d = cfg.n_attn_heads, cfg.n_kv_heads, cfg.head_size
    scale = 1.0 / np.sqrt(d)
    positions = torch.arange(t, device=x.device)
    for i in range(cfg.n_layers):
        lw = _layer(w.layers, i)
        kk, vv = kv_k[i], kv_v[i]
        h = rms_norm(x, lw.in_norm)
        q = apply_rope_neox(matmul(h, lw.q).reshape(t, nh, d).transpose(0, 1),
                            positions, inv)
        k = apply_rope_neox(matmul(h, lw.k).reshape(t, nkv, d).transpose(0, 1),
                            positions, inv)
        v = matmul(h, lw.v).reshape(t, nkv, d).transpose(0, 1)
        kk[:, :t] = k.to(kk.dtype)
        vv[:, :t] = v.to(vv.dtype)
        a = gqa_prefill(q, kk, vv, attn_bias, scale).transpose(0, 1)
        x = x + matmul(a.reshape(t, -1), lw.o)
        h = rms_norm(x, lw.post_norm)
        x = x + matmul(torch.nn.functional.silu(matmul(h, lw.gate)) *
                       matmul(h, lw.up), lw.down)
    return rms_norm(x, w.out_norm)


def decode_layers(cfg: OrpheusConfig, w: OrpheusWeights, inv, x, kv_k, kv_v,
                  pos):
    """The per-matmul decode step: all layers and the final norm over x
    (B, H), one row per sequence (the runner's B = 1, the batched engine's
    slots), each at its own cache row pos (B,) int32 on the device. Row
    pos[s] of kv_k/kv_v (L, B, n_kv, ctx, D) is written in place (a frozen
    slot's too: nothing reads it), then attended with rows [0, pos[s]]
    through K4."""
    b = x.shape[0]
    nh, nkv, d = cfg.n_attn_heads, cfg.n_kv_heads, cfg.head_size
    scale = 1.0 / np.sqrt(d)
    slots = torch.arange(b, device=x.device)
    p = pos.long().clamp(max=kv_k.shape[3] - 1)
    for i in range(cfg.n_layers):
        lw = _layer(w.layers, i)
        kk, vv = kv_k[i], kv_v[i]
        h = rms_norm(x, lw.in_norm)
        # RoPE over (heads, B, D), each row at its own position
        q = apply_rope_neox(matmul(h, lw.q).reshape(b, nh, d).transpose(0, 1),
                            pos, inv).transpose(0, 1)
        k = apply_rope_neox(matmul(h, lw.k).reshape(b, nkv, d).transpose(0, 1),
                            pos, inv).transpose(0, 1)
        kk[slots, :, p] = k.to(kk.dtype)
        vv[slots, :, p] = matmul(h, lw.v).reshape(b, nkv, d).to(vv.dtype)
        a = decode_attention_batched(q.contiguous(), kk, vv, pos, scale)
        x = x + matmul(a.reshape(b, -1), lw.o)
        h = rms_norm(x, lw.post_norm)
        x = x + matmul(torch.nn.functional.silu(matmul(h, lw.gate)) *
                       matmul(h, lw.up), lw.down)
    return rms_norm(x, w.out_norm)


@torch.no_grad()
def orpheus_prefill(cfg: OrpheusConfig, w: OrpheusWeights, inv,
                    tokens: torch.Tensor, kv_k, kv_v) -> torch.Tensor:
    """Prompt prefill: tokens (P,) write KV rows [0, P) in place; returns the
    last position's logits (vocab,). kv_k/kv_v (L, n_kv, ctx, D) may be a
    slot's view of the batched engine's (L, B, n_kv, ctx, D) caches: rows
    past P, which may hold an earlier request's K/V, are masked out.

    The JAX package pads P to a length bucket for XLA's static shapes (its
    padded rows are junk that decode overwrites before any query reads
    them); eager PyTorch prefills the exact length."""
    p = tokens.shape[0]
    x = take_rows(w.embd, tokens)
    j = torch.arange(kv_k.shape[-2], device=x.device)
    bias = torch.zeros((p, kv_k.shape[-2]), device=x.device).masked_fill(
        j[None, :] > j[:p, None], float("-inf"))
    h = _llama_step(cfg, w, inv, x, kv_k, kv_v, bias)
    # the head may be vocab-padded (fast_lm_head); padded logits are exactly
    # zero — slice before sampling
    return matmul(h[p - 1:p], w.head)[0, : cfg.vocab_size]


class OrpheusState(NamedTuple):
    kv_k: Any
    kv_v: Any
    pos: Any            # (1,) int32: cache row of this step's token
    token_in: Any       # (1,) int64
    n_out: Any          # (1,) int32: tokens in out_tokens
    done: Any           # (1,) bool: the stopping token was sampled
    out_tokens: Any     # (max_steps,) int64
    sampler_state: sampling.SamplerState


class Mega(NamedTuple):
    """A decode route's prepared weights (see maybe_prep_llama_flat):
    LlamaFlat for K6, LlamaMegaLayers for K8."""
    step: Any
    qtype: int


def maybe_prep_llama_mega(cfg: OrpheusConfig, w: OrpheusWeights) -> Mega | None:
    """K8's weights when its route applies: uniformly quantized projections
    and kernel-friendly dims (the JAX package's gate, model.py:222-228).
    Depends on the weights, not on the device. None -> the per-matmul
    route."""
    if cfg.hidden_size % 128 or cfg.head_size % 64:
        return None
    try:
        return Mega(*prep_llama_mega(w.layers))
    except ValueError:
        return None


def maybe_prep_llama_flat(cfg: OrpheusConfig, w: OrpheusWeights) -> Mega | None:
    """K6's weights when the LM head is a QuantTensor of the layers' qtype,
    else K8's (maybe_prep_llama_mega), else None, as the JAX package's
    `maybe_prep_llama_flat` chooses."""
    mega = maybe_prep_llama_mega(cfg, w)
    if mega is None:
        return None
    try:
        return Mega(prep_llama_flat(mega.step, w.head, w.out_norm, mega.qtype,
                                    cfg.n_attn_heads, cfg.n_kv_heads),
                    mega.qtype)
    except ValueError:
        return mega


def cache_ctx(cfg: OrpheusConfig) -> int:
    """KV-cache rows: the prompt and generation windows rounded up to 512,
    as in the JAX package (its flat kernel's flash page)."""
    n = cfg.max_context_length + cfg.max_generation_size
    return -(-n // 512) * 512


def init_state(cfg: OrpheusConfig, first_token, prompt_len: int, kv_k, kv_v,
               max_steps: int) -> OrpheusState:
    """The decode state after prefill; first_token is the (1,) token sampled
    from the prefill logits."""
    dev = kv_k.device
    tok = first_token.reshape(1).long()
    return OrpheusState(
        kv_k=kv_k, kv_v=kv_v,
        pos=torch.tensor([prompt_len], dtype=torch.int32, device=dev),
        token_in=tok, n_out=torch.ones((1,), dtype=torch.int32, device=dev),
        done=tok == cfg.stopping_token_id,
        out_tokens=torch.zeros((max_steps,), dtype=torch.int64,
                               device=dev).index_copy(0, torch.zeros_like(tok), tok),
        sampler_state=sampling.init_state(1, dev))


def step_logits(cfg: OrpheusConfig, w: OrpheusWeights, inv, st: OrpheusState,
                mega: Mega | None) -> torch.Tensor:
    """The forward half of a decode step: embedding, the layers (K6, K8 or
    per matmul), final norm, LM head -> (1, vocab) logits. Writes this
    step's K/V into the cache in place."""
    x = take_rows(w.embd, st.token_in)
    kw = dict(n_heads=cfg.n_attn_heads, n_kv=cfg.n_kv_heads, inv_freq=inv)
    if mega is not None and isinstance(mega.step, LlamaFlat):
        lg, _, _ = llama_flat_megastep(mega.step, x, st.kv_k, st.kv_v, st.pos,
                                       qtype=mega.qtype, **kw)
        return lg[:, : cfg.vocab_size]
    if mega is not None:
        xo, _, _ = llama_megastep(mega.step, x, st.kv_k, st.kv_v, st.pos,
                                  qtype=mega.qtype, **kw)
        h = rms_norm(xo, w.out_norm)
    else:
        h = decode_layers(cfg, w, inv, x, st.kv_k.unsqueeze(1),
                          st.kv_v.unsqueeze(1), st.pos)
    return matmul(h, w.head)[:, : cfg.vocab_size]


def advance(cfg: OrpheusConfig, st: OrpheusState, logits, generator, *,
            max_steps: int, do_sample: bool, temperature: float, top_k: int,
            top_p: float, repetition_penalty: float) -> OrpheusState:
    """The other half of a decode step: sample from `logits`, append the
    token, latch the stop; the state comes back out of place (the cache
    aside)."""
    toks, s_state = sampling.sample_or_greedy(
        generator, logits, st.sampler_state, do_sample=do_sample,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty)
    row = st.n_out.long().clamp(max=max_steps - 1)
    out = st.out_tokens.index_copy(0, row, toks)
    return OrpheusState(st.kv_k, st.kv_v, st.pos + 1, toks, st.n_out + 1,
                        toks == cfg.stopping_token_id, out, s_state)


def finished(st: OrpheusState, max_steps: int) -> torch.Tensor:
    """(1,) bool on the device: stop sampled or max_steps tokens out."""
    return st.done | (st.n_out >= max_steps)


def decode_chunk(cfg: OrpheusConfig, w: OrpheusWeights, inv, st: OrpheusState,
                 n_steps: int, generator, *, mega: Mega | None = None,
                 max_steps: int, **sample_kw) -> OrpheusState:
    """n_steps decode steps with no host sync; a step taken once the stop
    condition holds leaves the state unchanged (the KV cache aside: it
    writes the stale row `pos`, which no later step reads)."""
    for _ in range(n_steps):
        now_done = finished(st, max_steps)
        st2 = advance(cfg, st, step_logits(cfg, w, inv, st, mega), generator,
                      max_steps=max_steps, **sample_kw)

        def sel(a, b):
            return torch.where(now_done, a, b)

        st = OrpheusState(
            st.kv_k, st.kv_v, sel(st.pos, st2.pos),
            sel(st.token_in, st2.token_in), sel(st.n_out, st2.n_out),
            now_done | st2.done,
            sel(st.out_tokens, st2.out_tokens),
            sampling.SamplerState(*[sel(a, b) for a, b in
                                    zip(st.sampler_state, st2.sampler_state)]))
    return st


@torch.no_grad()
def orpheus_generate_tokens_chunked(cfg: OrpheusConfig, w: OrpheusWeights, inv,
                                    first_token, prompt_len: int, kv_k, kv_v,
                                    generator, *, max_steps: int,
                                    chunk: int | None = None,
                                    mega: Mega | None = None, **sample_kw):
    """The AR loop after prefill with one host sync per chunk; chunk sizes
    follow `chunk_schedule` (64, 128, 256, ...) unless `chunk` pins one.
    Stops on the stopping token or at max_steps tokens (generate_from_batch,
    model.cpp:389-405). Returns (out_tokens (max_steps,) tensor, n_out)."""
    sched = iter(lambda: chunk, None) if chunk else chunk_schedule()
    st = init_state(cfg, first_token, prompt_len, kv_k, kv_v, max_steps)
    # every step before the stop is real; chunks are cut at the last step
    # that can add a token, which skips only steps that change nothing
    left = max_steps - 1
    for c in sched:
        c = min(c, left)
        if c <= 0 or bool(finished(st, max_steps)):
            break
        st = decode_chunk(cfg, w, inv, st, c, generator, mega=mega,
                          max_steps=max_steps, **sample_kw)
        left -= c
    return st.out_tokens, int(st.n_out)


def check_voice(voice: str) -> None:
    """Raise the reference's error for a voice Orpheus does not have."""
    if voice and voice not in ORPHEUS_VOICES:
        raise ValueError(f"Voice '{voice}' is not a valid Orpheus voice")


def prompt_ids(tokenizer, text: str, voice: str) -> list:
    """model.cpp:355-369: <prepend> + BPE("voice: text") + <append>."""
    if voice:
        text = f"{voice}: {text}"
    return list(PREPENDED_TOKENS) + tokenizer.tokenize(text) + \
        list(APPENDED_TOKENS)


def prepare_output_tokens(out: np.ndarray, n_out: int) -> list:
    """Redistribute flat tokens into 3 SNAC heads with offset undo
    (model.cpp:371-387): slot ii of each 7-group maps to head HEAD_MAP[ii],
    value t - 128266 - (ii%7)*4096."""
    out = np.asarray(out[:n_out], dtype=np.int64)
    chunks = len(out) // 7
    heads = [[], [], []]
    for i in range(chunks):
        for ii in range(7):
            t = out[i * 7 + ii] - 128266 - (ii % 7) * 4096
            heads[HEAD_MAP[ii]].append(int(t))
    return heads


@torch.no_grad()
def load_orpheus_weights(r: GGUFReader, cfg: OrpheusConfig,
                         device=None) -> OrpheusWeights:
    """The decoder's weights on `device` (default cuda, see
    common.default_device)."""
    device = default_device(device)

    def get(name):
        return from_gguf_tensor(r, name, device)

    lws = []
    for l in range(cfg.n_layers):
        b = f"orpheus.layers.{l}."
        lws.append(OrpheusLayer(
            in_norm=get(b + "input_layernorm"),
            q=get(b + "self_attn.q_proj"), k=get(b + "self_attn.k_proj"),
            v=get(b + "self_attn.v_proj"), o=get(b + "self_attn.o_proj"),
            post_norm=get(b + "post_attention_layernorm"),
            gate=get(b + "mlp.gate_proj"), up=get(b + "mlp.up_proj"),
            down=get(b + "mlp.down_proj")))
    layers = OrpheusLayer(*[stack_weights([getattr(lw, f) for lw in lws])
                            for f in OrpheusLayer._fields])
    return OrpheusWeights(
        embd=get("orpheus.embed_tokens"), layers=layers,
        out_norm=get("orpheus.norm"), head=get("orpheus.lm_head"),
        rope_freqs=dense(get("orpheus.rope_frequencies")))


class OrpheusRunner(TTSRunner):
    arch = "orpheus"
    sample_rate = SAMPLE_RATE_SNAC

    def __init__(self, cfg: OrpheusConfig, weights: OrpheusWeights,
                 tokenizer: BPETokenizer, snac_runner=None):
        strict_fp32()
        self.cfg = cfg
        if isinstance(weights.head, QuantTensor):
            # the 156,940-row head: N padded to 256 with zero scales, bf16
            # scales (the `_dqdot` numerics of the decode loop's head) and
            # packed Q4 codes
            weights = weights._replace(head=weights.head.fast_lm_head())
        self.weights = weights
        self.tokenizer = tokenizer
        self.snac = snac_runner
        self.device = weights.out_norm.device
        # RoPE inverse frequencies (head_size/2,), factors folded in: once
        self.inv_freq = rope_freqs(cfg.head_size, cfg.rope_theta,
                                   weights.rope_freqs)
        # K6/K8 weights are prepared at the first generate, as the JAX
        # runner does: they copy the qkv projections and scales, and a
        # server that never decodes this model single-stream never needs
        # them.
        self._mega: Mega | None = None
        self._mega_ready = False
        self._prep_lock = threading.Lock()

    @property
    def mega(self) -> Mega | None:
        with self._prep_lock:
            if not self._mega_ready:
                self._mega = maybe_prep_llama_flat(self.cfg, self.weights)
                self._mega_ready = True
        return self._mega

    def list_voices(self):
        return list(ORPHEUS_VOICES)

    def _prompt_ids(self, text: str, voice: str):
        return prompt_ids(self.tokenizer, text, voice)

    def generate_tokens(self, text: str, config: GenerationConfig):
        """Text -> (out_tokens numpy (max_generation,), n_out, seed)."""
        cfg = self.cfg
        check_voice(config.voice)
        ids = self._prompt_ids(text, config.voice)
        if len(ids) > cfg.max_context_length:
            raise ValueError("prompt too large for the context window")
        dev = self.device
        shape = (cfg.n_layers, cfg.n_kv_heads, cache_ctx(cfg), cfg.head_size)
        kv_k = torch.zeros(shape, dtype=kv_cache_dtype(dev), device=dev)
        kv_v = torch.zeros_like(kv_k)
        logits = orpheus_prefill(cfg, self.weights, self.inv_freq,
                                 torch.tensor(ids, device=dev), kv_k, kv_v)
        seed = config.seed if config.seed is not None else np.random.randint(2 ** 31)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        sample_kw = dict(do_sample=config.sample,
                         temperature=float(config.temperature),
                         top_k=int(config.top_k), top_p=float(config.top_p),
                         repetition_penalty=float(config.repetition_penalty))
        first, _ = sampling.sample_or_greedy(
            gen, logits[None, :], sampling.init_state(1, dev), **sample_kw)
        out, n_out = orpheus_generate_tokens_chunked(
            cfg, self.weights, self.inv_freq, first, len(ids), kv_k, kv_v, gen,
            max_steps=cfg.max_generation_size, mega=self.mega, **sample_kw)
        return out.cpu().numpy(), n_out, seed

    def vocode(self, out: np.ndarray, n_out: int, seed) -> np.ndarray:
        """Tokens -> waveform through SNAC, with the position-stable noise of
        `seed` (empty when there is no SNAC or no whole 7-token group)."""
        return self.vocode_heads(prepare_output_tokens(out, n_out), seed)

    def vocode_heads(self, heads: list, seed) -> np.ndarray:
        """`vocode` from the 3 SNAC codebook head lists of
        `prepare_output_tokens` (the batched engine's results)."""
        if self.snac is None or not heads[2]:
            return np.zeros(0, np.float32)
        # guard the codebook gather against out-of-range ids (the reference
        # feeds them to get_rows unchecked)
        cb = self.snac.weights.quantizers[0].codebook.shape[0]
        heads = [np.clip(np.asarray(h, np.int64), 0, cb - 1).tolist()
                 for h in heads]
        from ..codec.snac import make_noise_layers
        noise_layers = make_noise_layers(
            self.snac.cfg, seed, 4 * (self.cfg.max_generation_size // 7 + 1))
        return np.asarray(self.snac.decode(heads, noise_layers=noise_layers),
                          np.float32)

    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        config = config or GenerationConfig()
        out, n_out, seed = self.generate_tokens(text, config)
        return TTSResponse(self.vocode(out, n_out, seed), SAMPLE_RATE_SNAC)
