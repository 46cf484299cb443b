"""Continuous-batching decode engine for Dia, the port of the JAX package's
`runtime/batched_dia.py`.

Same design as runtime/batched_parler.py: one set of weights and a fixed
number of batch slots decoded together. Each Dia request is a CFG pair, so
B slots decode as 2B rows through one read of the weights (0.70 GB per step
at Dia-1.6B width). Slots have their own positions, sampling parameters,
delay wind-down and KV caches, and each its own bucketed cross K/V with the
analytic pad-tail fold (ops/dia_megastep.prep_dia_cross). The engine fixes
one cross bucket (256 rows), so that slot cross arrays stack: prompts of
more bytes are refused at submit (`validate_prompt`) and the server sends
them to its single-stream pool.

Decode step routes, chosen by the weights as the runner chooses them:
  * K11 (ops/dia_megastep.py) when the decode projections are uniformly
    quantized: each pair's arithmetic is K10's on that pair's state, bit
    for bit, so greedy requests decode to the codes of `DiaRunner` when the
    runner's bucket is the engine's (prompts of 129-256 bytes, or a window
    of at most 256 rows);
  * per matmul otherwise (the model's `decode_layers`, over the bucketed
    cross K/V with the tail fold as the JAX engine's per-matmul route).

The decode loop keeps its state on the device and syncs the host once per
chunk. The KV caches and `out_tokens` are updated in place; the engine's
worker thread is the only one that touches its tensors. A slot's caches
are not cleared when a request takes it: rows past a request's position
are never read (each step writes its row, then attends rows [0, pos]).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..common import GenerationConfig, default_device, kv_cache_dtype
from ..models.dia.model import (DiaConfig, DiaCross, DiaWeights,
                                adjust_output_tokens, cfg_logits,
                                check_device, decode_layers, embed_step,
                                encode_request,
                                final_norm, maybe_prep_dia_mega, next_tokens,
                                tokenize_sentence, wind_down)
from ..ops import sampling
from ..ops.dia_megastep import (dia_megastep_batched, prep_dia_cross,
                                step_scratch)


class BatchedDiaState(NamedTuple):
    kv_k: Any          # (L, B, 2, n_kv, ctx, D)
    kv_v: Any
    cross_k: Any       # (L, B, 2, heads, Sb, D) bf16
    cross_v: Any
    vtail: Any         # (L, B, 2, heads, D) f32
    pos: Any           # (B,) int32: cache row of this step
    tokens_in: Any     # (B, n_heads) int64
    delay_steps: Any   # (B,) int32, -1 = wind-down not started
    active: Any        # (B,) bool: the slot holds a live request
    done: Any          # (B,) bool
    out_tokens: Any    # (B, ctx, n_heads) int64
    sampler_state: sampling.BatchedSamplerState
    # per-request sampling parameters
    do_sample: Any     # (B,) bool
    temperature: Any   # (B,) f32
    top_k: Any         # (B,) int64
    top_p: Any         # (B,) f32
    repetition_penalty: Any  # (B,) f32


def init_batched_dia_state(cfg: DiaConfig, b: int, device=None,
                           cross_bucket: int = 256) -> BatchedDiaState:
    """The state of b empty slots on `device` (default cuda, see
    common.default_device)."""
    device = default_device(device)
    L, nkv, d = cfg.n_decoder_layers, cfg.n_kv_heads, cfg.head_size
    nh, heads = cfg.n_output_heads, cfg.decoder_attn_heads
    ctx = cfg.max_generation_size
    kv = dict(dtype=kv_cache_dtype(device), device=device)
    f32 = dict(dtype=torch.float32, device=device)
    cross = (L, b, 2, heads, cross_bucket, d)
    return BatchedDiaState(
        kv_k=torch.zeros((L, b, 2, nkv, ctx, d), **kv),
        kv_v=torch.zeros((L, b, 2, nkv, ctx, d), **kv),
        cross_k=torch.zeros(cross, dtype=torch.bfloat16, device=device),
        cross_v=torch.zeros(cross, dtype=torch.bfloat16, device=device),
        vtail=torch.zeros((L, b, 2, heads, d), **f32),
        pos=torch.zeros((b,), dtype=torch.int32, device=device),
        tokens_in=torch.full((b, nh), cfg.bos_token_id, dtype=torch.int64,
                             device=device),
        delay_steps=torch.full((b,), -1, dtype=torch.int32, device=device),
        active=torch.zeros((b,), dtype=torch.bool, device=device),
        done=torch.zeros((b,), dtype=torch.bool, device=device),
        out_tokens=torch.zeros((b, ctx, nh), dtype=torch.int64, device=device),
        sampler_state=sampling.init_batched_state(b, nh, device),
        do_sample=torch.zeros((b,), dtype=torch.bool, device=device),
        temperature=torch.ones((b,), **f32),
        top_k=torch.zeros((b,), dtype=torch.int64, device=device),
        top_p=torch.ones((b,), **f32),
        repetition_penalty=torch.ones((b,), **f32))


def _not_done(cfg: DiaConfig, st: BatchedDiaState) -> torch.Tensor:
    """(B,) bool: the slot's request is live and not done."""
    return st.active & ~st.done & (st.pos < cfg.max_generation_size)


def batched_dia_step(cfg: DiaConfig, w: DiaWeights, st: BatchedDiaState,
                     generator, *, n_tail: int, mega=None,
                     scratch=None) -> BatchedDiaState:
    """One decode step for every slot, with the single-stream step's
    wind-down and freeze semantics per slot: a slot at which generation is
    done keeps its pre-wind-down state (only `done` flips; its stale cache
    row is written in its own cache, and nothing reads it)."""
    b = st.pos.shape[0]
    max_steps = cfg.max_generation_size
    cont = _not_done(cfg, st)
    t_in, ds, ended = wind_down(cfg, st.tokens_in, st.delay_steps, st.pos,
                                max_steps)
    now_done = ended | st.done | ~st.active
    pos_c = st.pos.clamp(max=max_steps - 1)
    x = embed_step(w, t_in)                                   # (2B, H)
    if mega is not None:
        xo, _, _ = dia_megastep_batched(
            mega.layers, x, st.kv_k, st.kv_v, pos_c, st.cross_k, st.cross_v,
            st.vtail, n_tail, qtype=mega.qtype,
            n_heads=cfg.decoder_attn_heads, n_kv=cfg.n_kv_heads,
            scratch=scratch)
    else:
        xo = decode_layers(cfg, w, x, st.kv_k.flatten(1, 2),
                           st.kv_v.flatten(1, 2), pos_c, DiaCross(
                               st.cross_k.flatten(1, 2),
                               st.cross_v.flatten(1, 2),
                               st.vtail.flatten(1, 2), n_tail))
    logits = cfg_logits(cfg, w, final_norm(w, xo))            # (B, nh, vocab)
    u = sampling.draw_u(generator, (b, cfg.n_output_heads), x.device)
    toks, s_state = sampling.select_batched(
        logits, st.sampler_state, u, do_sample=st.do_sample,
        temperature=st.temperature, top_k=st.top_k, top_p=st.top_p,
        repetition_penalty=st.repetition_penalty)
    go = cont & ~now_done
    g1 = go[:, None]
    slots = torch.arange(b, device=x.device)
    row = pos_c.long()
    st.out_tokens[slots, row] = torch.where(g1, toks, st.out_tokens[slots, row])
    new_pos = st.pos + 1
    return st._replace(
        pos=torch.where(go, new_pos, st.pos),
        tokens_in=torch.where(g1, next_tokens(cfg, toks, new_pos), st.tokens_in),
        delay_steps=torch.where(go, ds, st.delay_steps),
        done=torch.where(cont, now_done, st.done),
        sampler_state=sampling.BatchedSamplerState(*[
            torch.where(g1, new, old)
            for new, old in zip(s_state, st.sampler_state)]))


@torch.no_grad()
def batched_dia_decode_chunk(cfg: DiaConfig, w: DiaWeights,
                             st: BatchedDiaState, n_steps: int, generator,
                             **step_kw) -> BatchedDiaState:
    """n_steps batched decode steps with no host sync."""
    for _ in range(n_steps):
        st = batched_dia_step(cfg, w, st, generator, **step_kw)
    return st


def insert_dia_request(cfg: DiaConfig, st: BatchedDiaState, slot: int, ck, cv,
                       vtail, config: GenerationConfig) -> None:
    """Arm slot `slot` for an encoded request (prep_dia_cross's outputs
    reshaped (L, 2, heads, Sb, D) and (L, 2, heads, D)): its cross K/V,
    position, feed, wind-down, stop and sampler state, and its sampling
    parameters (in place, with no host sync)."""
    st.cross_k[:, slot] = ck
    st.cross_v[:, slot] = cv
    st.vtail[:, slot] = vtail
    st.pos[slot] = 0
    st.tokens_in[slot] = cfg.bos_token_id
    st.delay_steps[slot] = -1
    st.active[slot] = True
    st.done[slot] = False
    st.out_tokens[slot] = 0
    st.sampler_state.last_token[slot] = -1
    st.sampler_state.repeat_count[slot] = 0
    st.do_sample[slot] = bool(config.sample)
    st.temperature[slot] = float(config.temperature)
    st.top_k[slot] = int(config.top_k)
    st.top_p[slot] = float(config.top_p)
    st.repetition_penalty[slot] = float(config.repetition_penalty)


class BatchedDiaEngine:
    """Slot-based continuous batching over one Dia model. Results are the
    delay-undone (frames, n_heads) code arrays (adjust_output_tokens).

    The state is sized to exactly `n_slots` (the JAX engine pads it to a
    multiple of 4 slots for its TPU kernel's 8 sublanes; K11 takes any
    count, running it in groups of at most 8 pairs: two GEMV rows each, 16
    in all). The caches have
    `max_generation_size` rows. The route's weights are prepared once,
    here. Decode sampling draws (n_slots, n_heads) uniforms per step from
    one torch.Generator seeded from `seed`. The engine runs on `device`
    (default cuda; raises when there is no card and the caller did not ask
    for device="cpu"), where its weights lie.
    """

    def __init__(self, cfg: DiaConfig, weights: DiaWeights, tokenizer=None,
                 n_slots: int = 4, chunk: int = 32, seed: int = 0,
                 cross_bucket: int = 256, device=None):
        self.device = check_device(weights, device)
        self.cfg = cfg
        self.weights = weights
        self.n_slots = n_slots
        self.chunk = chunk
        self.cross_bucket = min(cross_bucket, cfg.max_encoder_context_length)
        self.n_tail = cfg.max_encoder_context_length - self.cross_bucket
        self.mega = maybe_prep_dia_mega(cfg, weights)
        self.scratch = None
        if self.mega is not None and self.device.type == "cuda":
            self.scratch = step_scratch(
                self.mega.layers, 2 * n_slots, cfg.decoder_attn_heads,
                cfg.max_generation_size, self.cross_bucket, self.device)
        self.state = init_batched_dia_state(cfg, n_slots, self.device,
                                            self.cross_bucket)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.slot_req: List[Optional[int]] = [None] * n_slots
        self.pending: List[tuple] = []
        self.results: Dict[int, np.ndarray] = {}
        self.errors: Dict[int, str] = {}
        self._next_id = 0

    def validate_prompt(self, text: str, config: GenerationConfig) -> None:
        """Raise ValueError before queueing when the prompt exceeds the
        engine's cross bucket (256 bytes, against the encoder's window on
        the single-stream path: the server routes such prompts there)."""
        n = len(tokenize_sentence(text, self.cfg))
        if n > self.cross_bucket:
            raise ValueError(f"prompt ({n} bytes) exceeds the batched "
                             f"engine's cross bucket ({self.cross_bucket})")

    def submit(self, text: str, config: GenerationConfig) -> int:
        self.validate_prompt(text, config)
        rid = self._next_id
        self._next_id += 1
        self.pending.append((rid, text, config))
        self._fill_slots()
        return rid

    def _encode(self, text: str):
        """The encoder pass and the request's cross K/V in the engine's
        bucket: (ck, cv (L, 2, heads, Sb, D) bf16, vtail (L, 2, heads, D))."""
        cfg = self.cfg
        ids = tokenize_sentence(text, cfg)
        if len(ids) > self.cross_bucket:
            raise ValueError(f"prompt ({len(ids)} bytes) exceeds the engine's "
                             f"cross bucket ({self.cross_bucket})")
        ck, cv = encode_request(cfg, self.weights, ids)
        ckb, cvb, vtail, n_tail = prep_dia_cross(ck, cv, self.cross_bucket,
                                                 buckets=(self.cross_bucket,))
        assert n_tail == self.n_tail
        L, heads, d = cfg.n_decoder_layers, cfg.decoder_attn_heads, cfg.head_size
        return (ckb.reshape(L, 2, heads, -1, d), cvb.reshape(L, 2, heads, -1, d),
                vtail.reshape(L, 2, heads, d))

    def _fill_slots(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.pending:
                continue
            rid, text, config = self.pending.pop(0)
            try:
                ck, cv, vtail = self._encode(text)
            except Exception as e:  # noqa: BLE001 — fail only this request
                self.errors[rid] = str(e)
                continue
            insert_dia_request(self.cfg, self.state, slot, ck, cv, vtail, config)
            self.slot_req[slot] = rid

    def peek(self, rid: int):
        """(progress, out_tokens row) of an in-flight request, else None:
        the slot's own `pos` and output row, fetched whole to the host
        (the server's streaming drain reads them after each chunk; worker
        thread only)."""
        for slot, r in enumerate(self.slot_req):
            if r == rid:
                return (int(self.state.pos.cpu()[slot]),
                        self.state.out_tokens[slot].cpu().numpy())
        return None

    def step(self) -> List[int]:
        """Run one decode chunk; returns the newly finished request ids."""
        self.state = batched_dia_decode_chunk(
            self.cfg, self.weights, self.state, self.chunk, self.generator,
            n_tail=self.n_tail, mega=self.mega, scratch=self.scratch)
        done = (~_not_done(self.cfg, self.state)).cpu()    # the chunk's sync
        slots = [s for s in range(self.n_slots)
                 if self.slot_req[s] is not None and bool(done[s])]
        pos = self.state.pos.cpu() if slots else None
        finished = []
        for slot in slots:
            rid = self.slot_req[slot]
            out = self.state.out_tokens[slot].cpu().numpy()
            self.results[rid] = adjust_output_tokens(out, int(pos[slot]),
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
