"""Recurrent layers and norms for Kokoro (plain PyTorch).

Counterparts of the JAX package's `ops/rnn.py`, which runs its LSTMs as
`lax.scan` in XLA and reaches no Pallas kernel. The input projection is
hoisted out of the recurrence (one `x @ w_ih.T + (b_ih + b_hh)` product
over every timestep); each timestep is then one small step of plain torch:
the recurrent product, the gates (order i, f, g, o, as torch.nn.LSTM stores
them: the Kokoro checkpoints are converted from torch), the cell and the
output.

`masked_bilstm` runs only the valid prefix of a padded sequence: the JAX
version carries the state through the padded steps and emits zeros there,
so stopping at the valid length and zeroing the tail gives the same result.
Both directions run as one batched step (`torch.baddbmm` over the stacked
recurrent weights), the backward one over the time-reversed prefix.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LSTMWeights(NamedTuple):
    w_ih: torch.Tensor  # (4H, I)
    w_hh: torch.Tensor  # (4H, H)
    b_ih: torch.Tensor  # (4H,)
    b_hh: torch.Tensor  # (4H,)


def _cell(g: torch.Tensor, c: torch.Tensor):
    """One LSTM cell update from the gate pre-activations g (..., 4H): one
    sigmoid over all four gates (the g gate's is unused) and one tanh over
    the g gate keep the step at few launches."""
    i, f, _, o = torch.sigmoid(g).chunk(4, dim=-1)
    hidden = c.shape[-1]
    c = torch.addcmul(f * c, i, torch.tanh(g[..., 2 * hidden:3 * hidden]))
    return o * torch.tanh(c), c


def _scan(gx: torch.Tensor, w_hh_t: torch.Tensor, h: torch.Tensor,
          c: torch.Tensor) -> torch.Tensor:
    """The recurrence of D LSTMs at once: gate inputs gx (D, T, 4H),
    recurrent weights w_hh_t (D, H, 4H), states h / c (D, 1, H) ->
    outputs (D, T, H), one batched step a timestep."""
    hs = gx.new_empty(gx.shape[0], gx.shape[1], h.shape[-1])
    for t in range(gx.shape[1]):
        h, c = _cell(torch.baddbmm(gx[:, t:t + 1], h, w_hh_t), c)
        hs[:, t:t + 1] = h
    return hs


def lstm(x: torch.Tensor, w: LSTMWeights, reverse: bool = False,
         h0: torch.Tensor | None = None,
         c0: torch.Tensor | None = None) -> torch.Tensor:
    """Single-direction LSTM. x: (T, I) -> (T, H)."""
    hidden = w.w_hh.shape[-1]
    h = (x.new_zeros(hidden) if h0 is None else h0).reshape(1, 1, hidden)
    c = (x.new_zeros(hidden) if c0 is None else c0).reshape(1, 1, hidden)
    gx = x @ w.w_ih.T + (w.b_ih + w.b_hh)
    if reverse:
        gx = gx.flip(0)
    out = _scan(gx[None], w.w_hh.T.contiguous()[None], h, c)[0]
    return out.flip(0) if reverse else out


def bilstm(x: torch.Tensor, fwd: LSTMWeights, bwd: LSTMWeights) -> torch.Tensor:
    """Bidirectional LSTM: concat(forward, backward) -> (T, 2H)."""
    return torch.cat([lstm(x, fwd), lstm(x, bwd, reverse=True)], dim=-1)


def masked_bilstm(x: torch.Tensor, length: int, fwd: LSTMWeights,
                  bwd: LSTMWeights) -> torch.Tensor:
    """Bidirectional LSTM over the first `length` rows of a padded (T, I)
    sequence -> (T, 2H), rows >= length zero. The backward direction starts
    at the last valid row; both run as one batched step a timestep."""
    n = max(0, min(int(length), x.shape[0]))
    hidden = fwd.w_hh.shape[-1]
    out = x.new_zeros(x.shape[0], 2 * hidden)
    if n == 0:
        return out
    xs = x[:n]
    gx = torch.stack([xs @ fwd.w_ih.T + (fwd.b_ih + fwd.b_hh),
                      (xs @ bwd.w_ih.T + (bwd.b_ih + bwd.b_hh)).flip(0)])
    zero = x.new_zeros(2, 1, hidden)
    hs = _scan(gx, torch.stack([fwd.w_hh.T, bwd.w_hh.T]), zero, zero)
    out[:n, :hidden] = hs[0]
    out[:n, hidden:] = hs[1].flip(0)
    return out


def layer_norm(x: torch.Tensor, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: (x - mean) / sqrt(var + eps) * gamma +
    beta, the variance without Bessel's correction."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    ms = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps).to(x.dtype)) * gamma


def ada_layer_norm(x: torch.Tensor, style: torch.Tensor, w_fc: torch.Tensor,
                   b_fc: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """StyleTTS2 AdaLayerNorm: the style vector gives (gamma, beta) through
    a linear layer (fc output (2C,) split in halves); plain LayerNorm, then
    (1 + gamma) * xhat + beta (kokoro/model.cpp:1017-1029)."""
    gamma, beta = (style @ w_fc.T + b_fc).chunk(2, dim=-1)
    return (1.0 + gamma) * layer_norm(x, 1.0, 0.0, eps) + beta


def adain_1d(x: torch.Tensor, style: torch.Tensor, w_fc: torch.Tensor,
             b_fc: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """AdaIN1d: instance norm over time of x (C, T), then the
    style-conditioned affine per channel (kokoro/model.cpp:1169-1231)."""
    gamma, beta = (style @ w_fc.T + b_fc).chunk(2, dim=-1)
    return (1.0 + gamma[:, None]) * layer_norm(x, 1.0, 0.0, eps) + beta[:, None]
