"""Device-side multi-head token sampling (plain PyTorch; the JAX package has
no Pallas kernel here).

Same semantics as the JAX package's `ops/sampling.py` (reference
src/sampler.cpp):

  * greedy argmax over raw logits when sampling is off
  * repetition penalty: the (single) last token's logit is *divided* by
    rp^consecutive_repeat_count
  * temperature division, numerically-stable softmax
  * top-k restriction
  * top-p nucleus: trim sorted probs at the first prefix reaching top_p,
    sample u ~ U(0,1) * min(prefix_sum, top_p)

Sampling is split into drawing the uniforms (`draw_u`, from an explicit
torch.Generator) and selecting with them (`select`), so tests can hand the
JAX package's uniforms to `select` and compare tokens: the two frameworks'
generators give different numbers from one seed. All heads sample
independently; nothing here syncs with the host.

The batched sampler (`select_batched`, for the continuous-batching engine)
takes B rows with per-row parameters as tensors, so one step serves a batch
of requests with mixed settings, as the JAX package's `sample_batched`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..common import default_device


class SamplerState(NamedTuple):
    """Per-head repetition-penalty state (reference sampler::reset)."""

    last_token: torch.Tensor    # (H,) int64, -1 = none
    repeat_count: torch.Tensor  # (H,) int64


def init_state(n_heads: int, device=None) -> SamplerState:
    """On `device` (default cuda, see common.default_device)."""
    device = default_device(device)
    return SamplerState(
        last_token=torch.full((n_heads,), -1, dtype=torch.int64, device=device),
        repeat_count=torch.zeros((n_heads,), dtype=torch.int64, device=device))


def update_state(state: SamplerState, tokens: torch.Tensor) -> SamplerState:
    same = tokens == state.last_token
    return SamplerState(last_token=tokens,
                        repeat_count=torch.where(same, state.repeat_count + 1,
                                                 torch.ones_like(tokens)))


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(H, V) -> (H,) argmax (first maximum). No penalties applied."""
    return torch.argmax(logits, dim=-1)


def draw_u(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) draws of `shape`: (n_heads,) for `select`, (B, n_heads) for
    `select_batched`, as the JAX samplers draw them."""
    return torch.rand(shape, generator=generator, device=device)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def select(logits: torch.Tensor, state: SamplerState, u: torch.Tensor,
           temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
           repetition_penalty: float = 1.0):
    """Pick one token per head from (H, V) logits with uniforms u (H,).

    Returns (tokens (H,) int64, new_state)."""
    h, v = logits.shape
    x = logits.float()
    if repetition_penalty != 1.0:
        factor = repetition_penalty ** state.repeat_count.float()
        hit = torch.arange(v, device=x.device)[None, :] == state.last_token[:, None]
        x = torch.where(hit, x / factor[:, None], x)
    if temperature != 1.0:
        x = x / temperature
    if 0 < top_k < v:
        # only the top_k entries can be selected; their full-softmax mass
        # needs just the global logsumexp
        topv, order = torch.topk(x, top_k, dim=-1)
        sorted_p = torch.exp(topv - torch.logsumexp(x, dim=-1, keepdim=True))
        v_eff = top_k
    else:
        probs = torch.softmax(x, dim=-1)
        order = torch.argsort(-probs, dim=-1, stable=True)
        sorted_p = torch.gather(probs, -1, order)
        v_eff = v
    keep = torch.ones((h, v_eff), dtype=torch.bool, device=x.device)
    kept_p = sorted_p
    cum = torch.cumsum(kept_p, dim=-1)
    if top_p < 1.0:
        # keep entries whose preceding cumulative mass is < top_p (the entry
        # that crosses top_p is included)
        keep = (cum - kept_p) < top_p
        kept_p = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
        cum = torch.cumsum(kept_p, dim=-1)
        max_head_prob = torch.clamp(kept_p.sum(dim=-1), max=top_p)
    else:
        # u in [0,1) vs cumsum of top-k probs; overflow mass falls on the
        # last pick, equivalent to clamping u at the sum
        max_head_prob = torch.ones((h,), device=x.device)
    found = keep & (cum >= (u * max_head_prob)[:, None])
    last_kept = v_eff - 1 - _first_true(torch.flip(keep, dims=[-1]))
    pick = torch.where(found.any(dim=-1), _first_true(found), last_kept)
    tokens = torch.gather(order, -1, pick[:, None])[:, 0]
    new_state = update_state(state, tokens) if repetition_penalty != 1.0 \
        else state
    return tokens, new_state


def sample_or_greedy(generator, logits, state, *, do_sample: bool,
                     temperature: float, top_k: int, top_p: float,
                     repetition_penalty: float):
    """Entry used by the decode step: greedy, or draw u then select."""
    if not do_sample:
        return greedy(logits), state
    u = draw_u(generator, logits.shape[0], logits.device)
    return select(logits, state, u, temperature, top_k, top_p,
                  repetition_penalty)


# ---------------------------------------------------------------------------
# batched sampling: B requests with per-request parameters
# ---------------------------------------------------------------------------

class BatchedSamplerState(NamedTuple):
    last_token: torch.Tensor    # (B, H) int64, -1 = none
    repeat_count: torch.Tensor  # (B, H) int64


def init_batched_state(b: int, n_heads: int, device=None) -> BatchedSamplerState:
    """On `device` (default cuda, see common.default_device)."""
    device = default_device(device)
    return BatchedSamplerState(
        last_token=torch.full((b, n_heads), -1, dtype=torch.int64, device=device),
        repeat_count=torch.zeros((b, n_heads), dtype=torch.int64, device=device))


BATCHED_TOP_K_CAP = 256
"""Cap on per-request top_k in the batched sampler, as in the JAX package: it
pre-selects the BATCHED_TOP_K_CAP most likely tokens instead of sorting the
whole vocabulary. Requests with top_k == 0 (no restriction) or top_k > the
cap are truncated to the cap; for nucleus sampling this only clips mass
deeper than the top-256 tokens. The server reports it in the
X-TTS-Top-K-Applied header."""


def select_batched(logits: torch.Tensor, state: BatchedSamplerState,
                   u: torch.Tensor, *, do_sample: torch.Tensor,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor, repetition_penalty: torch.Tensor):
    """Pick one token per (row, head) from logits (B, H, V) with uniforms
    u (B, H); every parameter is a (B,) tensor.

    Per row, the semantics of `select` / `greedy`: greedy rows take the raw
    argmax; sampled rows apply penalty, temperature, top-k (capped at
    BATCHED_TOP_K_CAP) and top-p. The repetition state advances for every
    row. Returns (tokens (B, H) int64, new_state)."""
    b, h, v = logits.shape
    kmax = min(BATCHED_TOP_K_CAP, v)
    dev = logits.device
    x = logits.float()
    factor = repetition_penalty[:, None] ** state.repeat_count.float()
    hit = torch.arange(v, device=dev)[None, None, :] == state.last_token[:, :, None]
    pen = torch.where((repetition_penalty != 1.0)[:, None, None],
                      torch.where(hit, x / factor[:, :, None], x), x)
    scaled = pen / temperature.clamp(min=1e-6)[:, None, None]
    # only the kmax most likely entries can be selected; their full-softmax
    # mass needs just the global logsumexp
    topv, order = torch.topk(scaled, kmax, dim=-1)
    sorted_p = torch.exp(topv - torch.logsumexp(scaled, dim=-1, keepdim=True))
    k_eff = torch.where(top_k > 0, top_k.clamp(max=kmax),
                        torch.full_like(top_k, kmax))
    keep = torch.arange(kmax, device=dev)[None, None, :] < k_eff[:, None, None]
    zeros = torch.zeros_like(sorted_p)
    kept_p = torch.where(keep, sorted_p, zeros)
    cum = torch.cumsum(kept_p, dim=-1)
    tp = top_p[:, None, None]
    # keep entries whose preceding cumulative mass is < top_p (the entry that
    # crosses top_p is included)
    keep = keep & ((tp >= 1.0) | ((cum - kept_p) < tp))
    kept_p = torch.where(keep, sorted_p, zeros)
    cum = torch.cumsum(kept_p, dim=-1)
    # u in [0,1) vs cumsum of the kept probs; overflow mass falls on the last
    # pick, equivalent to clamping u at the sum
    max_head = torch.where(top_p[:, None] < 1.0,
                           torch.minimum(kept_p.sum(dim=-1), top_p[:, None]),
                           torch.ones_like(u))
    found = keep & (cum >= (u * max_head)[:, :, None])
    last_kept = kmax - 1 - _first_true(torch.flip(keep, dims=[-1]))
    pick = torch.where(found.any(dim=-1), _first_true(found), last_kept)
    sampled = torch.gather(order, -1, pick[:, :, None])[:, :, 0]
    tokens = torch.where(do_sample[:, None], sampled, torch.argmax(x, dim=-1))
    same = tokens == state.last_token
    return tokens, BatchedSamplerState(
        last_token=tokens,
        repeat_count=torch.where(same, state.repeat_count + 1,
                                 torch.ones_like(tokens)))
