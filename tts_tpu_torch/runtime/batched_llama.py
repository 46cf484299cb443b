"""Continuous-batching decode engine for llama-family (Orpheus) decoders,
the port of the JAX package's `runtime/batched_llama.py`.

Same design as runtime/batched_parler.py: one set of weights and a fixed
number of batch slots decoded together, so one read of the weights (1.86 GB
per step at Orpheus-3B width) serves every active request. Slots have their
own positions, sampling parameters, stop state and KV caches, and are
refilled between chunks.

Decode step routes, chosen by the weights as the JAX engine chooses them:
  * head_size a multiple of 128 and `maybe_prep_llama_flat` giving the
    flat weights (the LM head quantized like the layers): kernel K7
    (ops/llama_flat.py), the whole step and the head;
  * otherwise, when the projections are uniformly quantized
    (`maybe_prep_llama_flat` / `maybe_prep_llama_mega` giving the layer
    weights, e.g. with an F16 head): kernel K9 (ops/llama_megastep.py),
    then the final norm and the head per matmul;
  * otherwise per matmul (the model's `decode_layers`, the runner's own
    step: K1 for quantized projections, K4 for attention).
Each slot's arithmetic is the single-stream step's, row for row (each K7
slot equals K6, each K9 slot K8), so greedy requests decode to the tokens
of `OrpheusRunner`.

The decode loop keeps its state on the device and syncs the host once per
chunk (the `_not_done` mask). The KV caches and `out_tokens` are updated in
place; the engine's worker thread is the only one that touches its tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..common import GenerationConfig, kv_cache_dtype
from ..models.orpheus.model import (Mega, OrpheusConfig, OrpheusWeights,
                                    cache_ctx, check_voice, decode_layers,
                                    maybe_prep_llama_flat,
                                    maybe_prep_llama_mega, orpheus_prefill,
                                    prepare_output_tokens, prompt_ids)
from ..ops import sampling
from ..ops.attention import rope_freqs
from ..ops.linear import matmul, take_rows
from ..ops.llama_flat import LlamaFlat, llama_flat_megastep_batched
from ..ops.llama_megastep import (llama_megastep_batched, rms_norm,
                                  step_scratch)


class BatchedLlamaState(NamedTuple):
    kv_k: Any           # (L, B, n_kv, ctx, D)
    kv_v: Any
    pos: Any            # (B,) int32: cache row of this step's token
    n_out: Any          # (B,) int32: tokens emitted
    token_in: Any       # (B,) int64
    active: Any         # (B,) bool: the slot holds a live request
    done: Any           # (B,) bool: the stopping token was sampled
    out_tokens: Any     # (B, max_gen) int64
    sampler_state: sampling.BatchedSamplerState
    # per-request sampling parameters
    do_sample: Any      # (B,) bool
    temperature: Any    # (B,) f32
    top_k: Any          # (B,) int64
    top_p: Any          # (B,) f32
    repetition_penalty: Any  # (B,) f32


def init_batched_llama_state(cfg: OrpheusConfig, b: int, ctx: int,
                             device) -> BatchedLlamaState:
    shape = (cfg.n_layers, b, cfg.n_kv_heads, ctx, cfg.head_size)
    kv = dict(dtype=kv_cache_dtype(device), device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return BatchedLlamaState(
        kv_k=torch.zeros(shape, **kv), kv_v=torch.zeros(shape, **kv),
        pos=torch.zeros((b,), dtype=torch.int32, device=device),
        n_out=torch.zeros((b,), dtype=torch.int32, device=device),
        token_in=torch.zeros((b,), dtype=torch.int64, device=device),
        active=torch.zeros((b,), dtype=torch.bool, device=device),
        done=torch.zeros((b,), dtype=torch.bool, device=device),
        out_tokens=torch.zeros((b, cfg.max_generation_size),
                               dtype=torch.int64, device=device),
        sampler_state=sampling.init_batched_state(b, 1, device),
        do_sample=torch.zeros((b,), dtype=torch.bool, device=device),
        temperature=torch.ones((b,), **f32),
        top_k=torch.zeros((b,), dtype=torch.int64, device=device),
        top_p=torch.ones((b,), **f32),
        repetition_penalty=torch.ones((b,), **f32))


def _not_done(cfg: OrpheusConfig, st: BatchedLlamaState) -> torch.Tensor:
    """(B,) bool: the slot's request is live, has not sampled the stopping
    token and has room for another token (the single-stream stop test)."""
    return st.active & ~st.done & (st.n_out < cfg.max_generation_size)


def batched_llama_step(cfg: OrpheusConfig, w: OrpheusWeights, inv,
                       st: BatchedLlamaState, generator, *,
                       mega: Mega | None = None,
                       scratch=None) -> BatchedLlamaState:
    """One decode step for every slot. Slots that are not live leave their
    state as it was (their cache row at the frozen pos aside)."""
    b = st.pos.shape[0]
    cont = _not_done(cfg, st)
    x = take_rows(w.embd, st.token_in)                        # (B, H)
    kw = dict(n_heads=cfg.n_attn_heads, n_kv=cfg.n_kv_heads, inv_freq=inv,
              scratch=scratch)
    if mega is not None and isinstance(mega.step, LlamaFlat):
        lg, _, _ = llama_flat_megastep_batched(
            mega.step, x, st.kv_k, st.kv_v, st.pos, qtype=mega.qtype, **kw)
    else:
        if mega is not None:
            xo, _, _ = llama_megastep_batched(
                mega.step, x, st.kv_k, st.kv_v, st.pos, qtype=mega.qtype, **kw)
            h = rms_norm(xo, w.out_norm)
        else:
            h = decode_layers(cfg, w, inv, x, st.kv_k, st.kv_v, st.pos)
        lg = matmul(h, w.head)
    # the head may be vocab-padded (fast_lm_head): padded logits are exactly
    # zero, sliced off before sampling
    logits = lg[:, None, : cfg.vocab_size]                    # (B, 1, vocab)
    u = sampling.draw_u(generator, (b, 1), x.device)
    toks, s_state = sampling.select_batched(
        logits, st.sampler_state, u, do_sample=st.do_sample,
        temperature=st.temperature, top_k=st.top_k, top_p=st.top_p,
        repetition_penalty=st.repetition_penalty)
    tok = toks[:, 0]
    slots = torch.arange(b, device=x.device)
    row = st.n_out.long().clamp(max=cfg.max_generation_size - 1)
    st.out_tokens[slots, row] = torch.where(cont, tok, st.out_tokens[slots, row])
    c1 = cont[:, None]
    return st._replace(
        pos=torch.where(cont, st.pos + 1, st.pos),
        n_out=torch.where(cont, st.n_out + 1, st.n_out),
        token_in=torch.where(cont, tok, st.token_in),
        done=torch.where(cont, st.done | (tok == cfg.stopping_token_id),
                         st.done),
        sampler_state=sampling.BatchedSamplerState(*[
            torch.where(c1, new, old)
            for new, old in zip(s_state, st.sampler_state)]))


@torch.no_grad()
def batched_llama_decode_chunk(cfg: OrpheusConfig, w: OrpheusWeights, inv,
                               st: BatchedLlamaState, n_steps: int, generator,
                               **step_kw) -> BatchedLlamaState:
    """n_steps batched decode steps with no host sync."""
    for _ in range(n_steps):
        st = batched_llama_step(cfg, w, inv, st, generator, **step_kw)
    return st


def insert_llama_request(cfg: OrpheusConfig, st: BatchedLlamaState, slot: int,
                         prompt_len: int, first_token: torch.Tensor,
                         config: GenerationConfig) -> None:
    """Arm slot `slot` for a request whose prompt is already prefilled into
    the slot's cache and whose first token (a (1,) device tensor) was
    sampled from the prefill logits: position, count, feed, stop and
    sampler state, and the request's sampling parameters (in place, with no
    host sync)."""
    first = first_token.reshape(1).long()
    st.pos[slot] = prompt_len
    st.n_out[slot] = 1
    st.token_in[slot:slot + 1] = first
    st.active[slot] = True
    st.done[slot:slot + 1] = first == cfg.stopping_token_id
    st.out_tokens[slot] = 0
    st.out_tokens[slot, :1] = first
    st.sampler_state.last_token[slot] = -1
    st.sampler_state.repeat_count[slot] = 0
    st.do_sample[slot] = bool(config.sample)
    st.temperature[slot] = float(config.temperature)
    st.top_k[slot] = int(config.top_k)
    st.top_p[slot] = float(config.top_p)
    st.repetition_penalty[slot] = float(config.repetition_penalty)


class BatchedLlamaEngine:
    """Slot-based continuous batching over one Orpheus model. Results are
    the 3 SNAC codebook head lists per request (`prepare_output_tokens`).

    The state is sized to exactly `n_slots` (the JAX engine pads it to a
    multiple of 8 for its TPU kernels' sublanes; K7 and K9 take any count,
    running it in groups of at most R = 8 slots on the batched
    persistent step, 16 on the launch sequence). The caches have
    `cache_ctx(cfg)` rows, the runner's, and the kernels read that count
    from the cache tensor. The route's weights are prepared once, here.

    As in the JAX engine, a request's `seed` seeds only the sampling of its
    first token (from the prefill logits); decode sampling draws (n_slots,
    1) uniforms per step from one torch.Generator seeded from `seed`. A
    prompt is prefilled straight into its slot's cache: rows past the
    prompt may still hold an earlier request's K/V, which the prefill's
    causal mask hides and which decode overwrites before it reads them.
    """

    def __init__(self, cfg: OrpheusConfig, weights: OrpheusWeights, tokenizer,
                 n_slots: int = 8, chunk: int = 32, seed: int = 0):
        self.cfg = cfg
        self.weights = weights
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        self.chunk = chunk
        self.device = weights.out_norm.device
        self.inv_freq = rope_freqs(cfg.head_size, cfg.rope_theta,
                                   weights.rope_freqs)
        self.ctx = cache_ctx(cfg)
        if cfg.head_size % 128 == 0:
            self.mega = maybe_prep_llama_flat(cfg, weights)
        else:
            self.mega = maybe_prep_llama_mega(cfg, weights)
        self.scratch = None
        if self.mega is not None and self.device.type == "cuda":
            layers = self.mega.step.layers if isinstance(
                self.mega.step, LlamaFlat) else self.mega.step
            self.scratch = step_scratch(layers, n_slots, cfg.n_attn_heads,
                                        self.ctx, self.device)
        self.state = init_batched_llama_state(cfg, n_slots, self.ctx,
                                              self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.slot_req: List[Optional[int]] = [None] * n_slots
        self.pending: List[tuple] = []
        self.results: Dict[int, list] = {}
        self.errors: Dict[int, str] = {}
        self._next_id = 0

    def validate_prompt(self, text: str, config: GenerationConfig) -> None:
        """Raise ValueError if this engine cannot take the request (checked
        before queueing, so one bad request never fails the others)."""
        check_voice(config.voice)
        n = len(prompt_ids(self.tokenizer, text, config.voice))
        if n > self.cfg.max_context_length:
            raise ValueError(
                f"prompt ({n} tokens) too large for the context window "
                f"({self.cfg.max_context_length})")

    def submit(self, text: str, config: GenerationConfig) -> int:
        self.validate_prompt(text, config)
        rid = self._next_id
        self._next_id += 1
        self.pending.append((rid, text, config))
        self._fill_slots()
        return rid

    def _prefill(self, slot: int, text: str, config: GenerationConfig):
        """Prefill the prompt into the slot's cache view and sample the first
        token; returns (prompt_len, first token (1,) on the device)."""
        cfg = self.cfg
        ids = prompt_ids(self.tokenizer, text, config.voice)
        if len(ids) > cfg.max_context_length:
            raise ValueError("prompt too large for the context window")
        logits = orpheus_prefill(
            cfg, self.weights, self.inv_freq,
            torch.tensor(ids, dtype=torch.int64, device=self.device),
            self.state.kv_k[:, slot], self.state.kv_v[:, slot])
        seed = config.seed if config.seed is not None else \
            np.random.randint(2 ** 31)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        first, _ = sampling.sample_or_greedy(
            gen, logits[None, :], sampling.init_state(1, self.device),
            do_sample=config.sample, temperature=float(config.temperature),
            top_k=int(config.top_k), top_p=float(config.top_p),
            repetition_penalty=float(config.repetition_penalty))
        return len(ids), first

    def _fill_slots(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.pending:
                continue
            rid, text, config = self.pending.pop(0)
            try:
                plen, first = self._prefill(slot, text, config)
            except Exception as e:  # noqa: BLE001 — fail only this request
                self.errors[rid] = str(e)
                continue
            insert_llama_request(self.cfg, self.state, slot, plen, first,
                                 config)
            self.slot_req[slot] = rid

    def peek(self, rid: int):
        """(progress, out_tokens row) of an in-flight request, else None:
        the slot's own `n_out` and output row, fetched whole to the host
        (the server's streaming drain reads them after each chunk; worker
        thread only)."""
        for slot, r in enumerate(self.slot_req):
            if r == rid:
                return (int(self.state.n_out.cpu()[slot]),
                        self.state.out_tokens[slot].cpu().numpy())
        return None

    def step(self) -> List[int]:
        """Run one decode chunk; returns the newly finished request ids."""
        self.state = batched_llama_decode_chunk(
            self.cfg, self.weights, self.inv_freq, self.state, self.chunk,
            self.generator, mega=self.mega, scratch=self.scratch)
        done = (~_not_done(self.cfg, self.state)).cpu()   # the chunk's sync
        slots = [s for s in range(self.n_slots)
                 if self.slot_req[s] is not None and bool(done[s])]
        n_out = self.state.n_out.cpu() if slots else None
        finished = []
        for slot in slots:
            rid = self.slot_req[slot]
            out = self.state.out_tokens[slot].cpu().numpy()
            # the stop token stays in the stream as in the single-stream
            # path; prepare_output_tokens drops the incomplete trailing
            # 7-group it lands in
            self.results[rid] = prepare_output_tokens(out, int(n_out[slot]))
            self.slot_req[slot] = None
            self.state.active[slot] = False
            finished.append(rid)
        self._fill_slots()
        return finished

    def run_until_done(self, max_chunks: int = 1000) -> None:
        for _ in range(max_chunks):
            self.step()
            if not self.pending and all(r is None for r in self.slot_req):
                return
        raise RuntimeError("batched engine did not converge")
