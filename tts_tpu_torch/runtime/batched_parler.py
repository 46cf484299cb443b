"""Continuous-batching decode engine for the Parler decoder, the port of the
JAX package's `runtime/batched_parler.py`.

One set of weights and a fixed number of batch slots decoded together: one
read of the weights (the dominant device-memory cost of a decode step at
small batch) serves every active request. Slots have their own positions,
sampling parameters, EOS/delay state and KV caches, and are refilled
between chunks.

Decode step paths, chosen by the weights as in the single-stream runner:
when `maybe_prep_mega` applies, the transformer stack is kernel K5
(ops/parler_megastep.py, the batched GEMV plus K4 for attention); otherwise
per matmul (`_batched_layer`: K1 for quantized projections, K4 for the
self-attention). Each slot's arithmetic is the single-stream step's, row for
row, so greedy requests decode to the same codes as `ParlerRunner`.

The decode loop keeps its state on the device and syncs the host once per
chunk (the `_not_done` mask), as the JAX engine's `step()` does. The KV
caches and `out_tokens` are updated in place; the engine's worker thread is
the only one that touches its tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..common import GenerationConfig, kv_cache_dtype
from ..models.parler.model import (Mega, ParlerConfig, ParlerWeights, _layer,
                                   _logits_last, adjust_output_tokens,
                                   embed_step, final_norm, maybe_prep_mega,
                                   parler_prefill)
from ..ops import sampling
from ..ops.attention import sdpa
from ..ops.decode_attention import decode_attention_batched
from ..ops.linear import matmul
from ..ops.parler_megastep import (layer_norm, parler_megastep_batched,
                                   step_scratch)

MAX_PROMPT = 512   # the JAX engine's last prompt bucket


class BatchedParlerState(NamedTuple):
    kv_k: Any           # (L, B, heads, ctx, D)
    kv_v: Any
    pos: Any            # (B,) int32
    step: Any           # (B,) int32
    tokens_in: Any      # (B, n_out_heads) int64
    eos_seen: Any       # (B, n_out_heads) bool
    active: Any         # (B,) bool: the slot holds a live request
    out_tokens: Any     # (B, max_gen, n_out_heads) int64
    sampler_state: sampling.BatchedSamplerState
    # per-request sampling parameters
    do_sample: Any      # (B,) bool
    temperature: Any    # (B,) f32
    top_k: Any          # (B,) int64
    top_p: Any          # (B,) f32
    repetition_penalty: Any  # (B,) f32


def init_batched_state(cfg: ParlerConfig, b: int, device) -> BatchedParlerState:
    L, nh, ctx, d = (cfg.n_layers, cfg.n_attn_heads, cfg.max_ctx_length,
                     cfg.head_size)
    no = cfg.n_output_heads
    kv = dict(dtype=kv_cache_dtype(device), device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return BatchedParlerState(
        kv_k=torch.zeros((L, b, nh, ctx, d), **kv),
        kv_v=torch.zeros((L, b, nh, ctx, d), **kv),
        pos=torch.zeros((b,), dtype=torch.int32, device=device),
        step=torch.zeros((b,), dtype=torch.int32, device=device),
        tokens_in=torch.full((b, no), cfg.bos_token_id, dtype=torch.int64,
                             device=device),
        eos_seen=torch.zeros((b, no), dtype=torch.bool, device=device),
        active=torch.zeros((b,), dtype=torch.bool, device=device),
        out_tokens=torch.zeros((b, cfg.max_generation_size, no),
                               dtype=torch.int64, device=device),
        sampler_state=sampling.init_batched_state(b, no, device),
        do_sample=torch.zeros((b,), dtype=torch.bool, device=device),
        temperature=torch.ones((b,), **f32),
        top_k=torch.zeros((b,), dtype=torch.int64, device=device),
        top_p=torch.ones((b,), **f32),
        repetition_penalty=torch.ones((b,), **f32))


def _not_done(cfg: ParlerConfig, st: BatchedParlerState) -> torch.Tensor:
    """(B,) bool: the slot's request is live and not finished (the
    single-stream stop test, per slot)."""
    m = cfg.max_generation_size
    return st.active & ((st.step == 0) | ~st.eos_seen.all(dim=1)) & \
        (st.pos < m) & (st.step < m)


def _batched_layer(cfg: ParlerConfig, x, lw, kv_k, kv_v, pos, use_cross: bool,
                   tp_group=None):
    """The per-matmul path's layer: x (B, H); kv_k/kv_v (B, heads, ctx, D)
    this layer's caches, each slot's row pos[s] written in place (inactive
    slots too, at their frozen pos: nothing reads that row); pos (B,).

    With `tp_group`, lw is this rank's tensor-parallel shard
    (parallel/sharding.shard_parler_weights) and the caches hold its heads:
    the layer runs those heads and sums the row-sharded products of o,
    cross-o and fc2 over the group."""
    b, nh = x.shape[0], kv_k.shape[1]
    h = layer_norm(x, lw.ln1_w, lw.ln1_b)
    q = matmul(h, lw.q_w).reshape(b, nh, -1)
    k = matmul(h, lw.k_w).reshape(b, nh, -1)
    v = matmul(h, lw.v_w).reshape(b, nh, -1)
    slots = torch.arange(b, device=x.device)
    p = pos.long().clamp(max=kv_k.shape[2] - 1)
    kv_k[slots, :, p] = k.to(kv_k.dtype)
    kv_v[slots, :, p] = v.to(kv_v.dtype)
    attn = decode_attention_batched(q, kv_k, kv_v, pos)          # (B, nh, D)
    x = x + _tp_sum(matmul(attn.reshape(b, -1), lw.o_w), tp_group)
    if use_cross:
        h = layer_norm(x, lw.lnc_w, lw.lnc_b)
        cq = matmul(h, lw.cq_w).reshape(b, nh, 1, -1)
        ca = sdpa(cq, lw.cross_k, lw.cross_v)                   # (B, nh, 1, D)
        x = x + _tp_sum(matmul(ca.reshape(b, -1), lw.co_w), tp_group)
    h = layer_norm(x, lw.ln2_w, lw.ln2_b)
    h = torch.nn.functional.gelu(matmul(h, lw.fc1), approximate="tanh")
    return x + _tp_sum(matmul(h, lw.fc2), tp_group)


def _tp_sum(y, tp_group):
    """y summed over the tensor-parallel group (in place), or y."""
    if tp_group is not None:
        torch.distributed.all_reduce(y, group=tp_group)
    return y


def batched_decode_step(cfg: ParlerConfig, w: ParlerWeights,
                        st: BatchedParlerState, generator, *, use_cross: bool,
                        mega: Mega | None = None, scratch=None,
                        tp_group=None) -> BatchedParlerState:
    """One decode step for every slot. Slots that are not live leave their
    state as it was (their cache row at the frozen pos aside).

    With `tp_group` (a tensor-parallel process group), w and st are this
    rank's shards (parallel/sharding: heads over tp, slots over dp) and the
    step runs the per-matmul path; the group's ranks draw from identically
    seeded generators, so they sample alike."""
    b, nh = st.tokens_in.shape
    cont = _not_done(cfg, st)
    x = embed_step(cfg, w, st.tokens_in, st.pos)
    if tp_group is not None and mega is not None:
        raise ValueError("the tensor-parallel step takes the per-matmul path "
                         "(mega=None)")
    if mega is not None:
        x, _, _ = parler_megastep_batched(
            mega.layers, x, st.kv_k, st.kv_v, st.pos, qtype=mega.qtype,
            use_cross=use_cross, n_heads=cfg.n_attn_heads, scratch=scratch)
    else:
        for i in range(cfg.n_layers):
            x = _batched_layer(cfg, x, _layer(w.layers, i), st.kv_k[i],
                               st.kv_v[i], st.pos, use_cross, tp_group)
    logits = _logits_last(cfg, w, final_norm(w, x))            # (B, nh, V)
    u = sampling.draw_u(generator, (b, nh), x.device)
    toks, s_state = sampling.select_batched(
        logits, st.sampler_state, u, do_sample=st.do_sample,
        temperature=st.temperature, top_k=st.top_k, top_p=st.top_p,
        repetition_penalty=st.repetition_penalty)
    c1 = cont[:, None]
    slots = torch.arange(b, device=x.device)
    row = st.step.long().clamp(max=cfg.max_generation_size - 1)
    st.out_tokens[slots, row] = torch.where(c1, toks, st.out_tokens[slots, row])
    # the feed uses eos_seen as of BEFORE this sample (reference lag), then
    # latches with the new sample
    heads_i = torch.arange(nh, device=x.device)[None, :]
    nxt = torch.where(st.step[:, None] + 1 > heads_i,
                      torch.where(st.eos_seen, cfg.eos_token_id, toks),
                      cfg.bos_token_id)
    eos = st.eos_seen | (toks == cfg.eos_token_id)
    return st._replace(
        pos=torch.where(cont, st.pos + 1, st.pos),
        step=torch.where(cont, st.step + 1, st.step),
        tokens_in=torch.where(c1, nxt, st.tokens_in),
        eos_seen=torch.where(c1, eos, st.eos_seen),
        sampler_state=sampling.BatchedSamplerState(*[
            torch.where(c1, new, old)
            for new, old in zip(s_state, st.sampler_state)]))


@torch.no_grad()
def batched_decode_chunk(cfg: ParlerConfig, w: ParlerWeights,
                         st: BatchedParlerState, n_steps: int, generator,
                         **step_kw) -> BatchedParlerState:
    """n_steps batched decode steps with no host sync."""
    for _ in range(n_steps):
        st = batched_decode_step(cfg, w, st, generator, **step_kw)
    return st


def insert_request(cfg: ParlerConfig, st: BatchedParlerState, slot: int,
                   prompt_len: int, config: GenerationConfig) -> None:
    """Arm slot `slot` for a request whose prompt is already prefilled into
    the slot's cache: position, step, feed, EOS and sampler state, and the
    request's sampling parameters (in place)."""
    st.pos[slot] = prompt_len
    st.step[slot] = 0
    st.tokens_in[slot] = cfg.bos_token_id
    st.eos_seen[slot] = False
    st.active[slot] = True
    st.out_tokens[slot] = 0
    st.sampler_state.last_token[slot] = -1
    st.sampler_state.repeat_count[slot] = 0
    st.do_sample[slot] = bool(config.sample)
    st.temperature[slot] = float(config.temperature)
    st.top_k[slot] = int(config.top_k)
    st.top_p[slot] = float(config.top_p)
    st.repetition_penalty[slot] = float(config.repetition_penalty)


class BatchedParlerEngine:
    """Slot-based continuous batching over one Parler model.

    The state is sized to exactly `n_slots`. (The JAX engine rounds the slot
    count up to a multiple of 8 for its TPU kernel, which puts slots on the
    8 f32 sublanes; the H100 kernel K5 takes any count, running it in groups
    of at most 16 slots, so there is nothing to pad. Padding never changed
    a request's result.)

    Sampling draws (n_slots, 9) uniforms per step from one torch.Generator
    seeded from `seed`; as in the JAX engine, a request's own `seed` does not
    seed batched sampling. A prompt is prefilled straight into its slot's
    cache: rows past the prompt still hold an earlier request's K/V, which
    the prefill's causal mask hides and which decode overwrites before it
    reads them (each step writes row pos, then attends rows [0, pos]), so no
    fresh cache is copied in per request.
    """

    def __init__(self, cfg: ParlerConfig, weights: ParlerWeights, tokenizer,
                 n_slots: int = 8, chunk: int = 32, seed: int = 0):
        self.cfg = cfg
        self.weights = weights
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        self.chunk = chunk
        self.device = weights.pos_embd.device
        self.set_weights(weights)
        self.state = init_batched_state(cfg, n_slots, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.slot_req: List[Optional[int]] = [None] * n_slots
        self.pending: List[tuple] = []
        self.results: Dict[int, Any] = {}
        self.errors: Dict[int, str] = {}
        self._next_id = 0

    def set_weights(self, weights: ParlerWeights) -> None:
        """Take `weights` and prep the step from them: K5's tiled weights
        (which hold the cross K/V) and, on the card, its scratch, whose
        attention partials are sized by the cross K/V's rows as well as the
        context. A conditional-prompt update changes those rows; the server
        calls this between two chunks."""
        self.weights = weights
        self.mega = maybe_prep_mega(self.cfg, weights)
        self.scratch = None
        if self.mega is not None and self.device.type == "cuda":
            self.scratch = step_scratch(self.mega.layers, self.n_slots,
                                        self.cfg.n_attn_heads,
                                        self.cfg.max_ctx_length, self.device)

    def validate_prompt(self, text: str, config: GenerationConfig) -> None:
        """Raise ValueError if this engine cannot take the request (checked
        before queueing, so one bad request never fails the others)."""
        ids = self.tokenizer.tokenize(text)
        if len(ids) + 1 > MAX_PROMPT:
            raise ValueError(
                f"prompt ({len(ids) + 1} tokens) exceeds the batched "
                f"engine's context window ({MAX_PROMPT})")

    def submit(self, text: str, config: GenerationConfig) -> int:
        self.validate_prompt(text, config)
        rid = self._next_id
        self._next_id += 1
        self.pending.append((rid, text, config))
        self._fill_slots()
        return rid

    def _prefill(self, slot: int, text: str) -> int:
        ids = self.tokenizer.tokenize(text)
        ids.append(self.tokenizer.eos_token)
        if len(ids) > MAX_PROMPT:
            raise ValueError("prompt too large for the context window")
        tokens = torch.tensor(ids, dtype=torch.int64, device=self.device)
        parler_prefill(self.cfg, self.weights, tokens, self.state.kv_k[:, slot],
                       self.state.kv_v[:, slot],
                       use_cross=self.cfg.use_cross_attn)
        return len(ids)

    def _fill_slots(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.pending:
                continue
            rid, text, config = self.pending.pop(0)
            try:
                plen = self._prefill(slot, text)
            except Exception as e:  # noqa: BLE001 — fail only this request
                self.errors[rid] = str(e)
                continue
            insert_request(self.cfg, self.state, slot, plen, config)
            self.slot_req[slot] = rid

    def peek(self, rid: int):
        """(progress, out_tokens row) of an in-flight request, else None:
        the slot's own `step` and output row, fetched whole to the host
        (the server's streaming drain reads them after each chunk; worker
        thread only)."""
        for slot, r in enumerate(self.slot_req):
            if r == rid:
                return (int(self.state.step.cpu()[slot]),
                        self.state.out_tokens[slot].cpu().numpy())
        return None

    def step(self) -> List[int]:
        """Run one decode chunk; returns the newly finished request ids."""
        self.state = batched_decode_chunk(
            self.cfg, self.weights, self.state, self.chunk, self.generator,
            use_cross=self.cfg.use_cross_attn, mega=self.mega,
            scratch=self.scratch)
        done = (~_not_done(self.cfg, self.state)).cpu()   # the chunk's sync
        slots = [s for s in range(self.n_slots)
                 if self.slot_req[s] is not None and bool(done[s])]
        steps = self.state.step.cpu() if slots else None
        finished = []
        for slot in slots:
            rid = self.slot_req[slot]
            out = self.state.out_tokens[slot].cpu().numpy()
            self.results[rid] = adjust_output_tokens(out, int(steps[slot]),
                                                     self.cfg)
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
