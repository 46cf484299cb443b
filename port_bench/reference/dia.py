"""Dia-1.6B, teacher-forced over a whole request.

Encoder: byte embeddings over the 1024-position window (row 0 the prompt,
row 1 all zeros, the unconditional input), RMS norms (eps 1e-5), NeoX RoPE
(theta 10000) on q / k, softmax scale 1.0, a block-diagonal mask (real
positions attend real ones, pads pads), SiLU-gated MLPs, a final norm.
Each decoder layer's cross K (RoPE at the encoder positions, rows at and
past the prompt's length zero) and V come from that output.

Decoder: both guidance rows embed the sum of the 9 codebooks' fed tokens;
grouped-query self-attention (16 q heads over 4 K / V heads, RoPE at the
step's position, causal, scale 1.0), cross-attention over the whole
1024-row window (scale 1.0), SiLU-gated MLP, a final norm, 9 heads, then
cond + 3 (cond - uncond) with tokens past 1024 masked. The fed tokens
follow Dia's rules: BOS on channel c until step c + 1; a wind-down of
`max_delay` steps from the step at max_steps - max_delay (or an EOS fed on
channel 0) that feeds channel c EOS at its delay and PAD after.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .parler import attention
from .q4 import ROUNDINGS, dequant

EPS = 1e-5


def _rms(x, w):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w


def _rope(x, pos, theta):
    """NeoX RoPE: pairs (i, i + D/2) rotated; x (..., T, D), pos (T,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device).float() / d)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _split(x, nh):
    """(B, T, nh * D) -> (B, nh, T, D)."""
    b, t, _ = x.shape
    return x.reshape(b, t, nh, -1).transpose(1, 2)


def _mm(raw, name, x, layer, rnd=lambda t: t):
    codes, scales = raw[name]
    return rnd(x) @ dequant(codes[layer], scales[layer]).T


@torch.no_grad()
def encode(raw: dict, cfg: dict, ids: list):
    """(cross_k, cross_v), each (L, 2, heads, 1024, D) float32."""
    dev = raw["enc_embedding"].device
    T = cfg["encoder_max_position_embeddings"]
    tokens = torch.zeros((2, T), dtype=torch.long, device=dev)
    tokens[0, :len(ids)] = torch.tensor(ids, dtype=torch.long, device=dev)
    pos = torch.arange(T, device=dev)
    real = pos < len(ids)
    mask = real[:, None] == real[None, :]
    theta, nh = cfg["rope_theta"], cfg["encoder_n_head"]
    x = raw["enc_embedding"][tokens]
    for l in range(cfg["encoder_n_layer"]):
        h = _rms(x, raw["enc_sa_norm"][l])
        q, k, v = (_split(_mm(raw, "enc_" + n, h, l), nh) for n in "qkv")
        a = attention(_rope(q, pos, theta), _rope(k, pos, theta), v, mask,
                      scale=1.0)
        x = x + _mm(raw, "enc_o", a.transpose(1, 2).reshape(2, T, -1), l)
        h = _rms(x, raw["enc_mlp_norm"][l])
        x = x + _mm(raw, "enc_wo", F.silu(_mm(raw, "enc_gate", h, l)) *
                    _mm(raw, "enc_up", h, l), l)
    hidden = _rms(x, raw["enc_norm"])
    ks, vs = [], []
    for l in range(cfg["decoder_n_layer"]):
        k = _rope(_split(_mm(raw, "cross_k", hidden, l),
                         cfg["cross_query_heads"]), pos, theta)
        ks.append(k * real[None, None, :, None])
        vs.append(_split(_mm(raw, "cross_v", hidden, l),
                         cfg["cross_query_heads"]))
    return torch.stack(ks), torch.stack(vs)


def decoder_inputs(cfg: dict, tokens, n_steps: int, max_steps: int) -> list:
    """The tokens fed to each of the n_steps steps (Dia's delay and
    wind-down rules) from the tokens drawn, tokens (n_steps, 9)."""
    n_out, md = cfg["channels"], cfg["max_delay"]
    delay = cfg["delay_pattern"]
    bos, eos, pad = cfg["bos_token_id"], cfg["eos_token_id"], \
        cfg["pad_token_id"]
    fed, cur, ds = [], [bos] * n_out, -1
    for t in range(n_steps):
        if ds == -1 and (cur[0] == eos or t >= max_steps - md):
            ds = md
        row = list(cur)
        if ds > 0:
            after = md - ds
            row = [eos if delay[c] == after else pad if after > delay[c]
                   else row[c] for c in range(n_out)]
            ds -= 1
        fed.append(row)
        cur = [int(tokens[t][c]) if t + 1 > c else bos for c in range(n_out)]
    return fed


@torch.no_grad()
def logits(raw: dict, cfg: dict, ids: list, tokens, n_steps: int,
           max_steps: int, rounding: str = "float32") -> torch.Tensor:
    """(n_steps, 9, vocab) CFG-merged logits of the steps whose drawn tokens
    are `tokens` (n_steps, 9), for the prompt bytes `ids`."""
    rnd = ROUNDINGS[rounding]
    dev = raw["enc_embedding"].device
    ck, cv = encode(raw, cfg, ids)
    ck, cv = rnd(ck), rnd(cv)
    fed = torch.tensor(decoder_inputs(cfg, tokens, n_steps, max_steps),
                       dtype=torch.long, device=dev)
    n_out, theta = cfg["channels"], cfg["rope_theta"]
    nh, nkv = cfg["gqa_query_heads"], cfg["kv_heads"]
    x = raw["dec_embds"][torch.arange(n_out, device=dev)[None, :], fed].sum(1)
    x = x[None].repeat(2, 1, 1)                          # (2, n, H)
    pos = torch.arange(n_steps, device=dev)
    causal = torch.ones((n_steps, n_steps), dtype=torch.bool,
                        device=dev).tril()
    for l in range(cfg["decoder_n_layer"]):
        def mm(name, h):
            return _mm(raw, name, h, l, rnd)
        h = _rms(x, raw["sa_norm"][l])
        q = _rope(_split(mm("self_q", h), nh), pos, theta)
        k = rnd(_rope(_split(mm("self_k", h), nkv), pos, theta))
        v = rnd(_split(mm("self_v", h), nkv))
        rep = nh // nkv
        a = attention(q, k.repeat_interleave(rep, 1),
                      v.repeat_interleave(rep, 1), causal, scale=1.0)
        x = x + mm("self_o", a.transpose(1, 2).reshape(2, n_steps, -1))
        h = _rms(x, raw["ca_norm"][l])
        cq = _rope(_split(mm("cross_q", h), nh), pos, theta)
        a = attention(cq, ck[l], cv[l], scale=1.0)
        x = x + mm("cross_o", a.transpose(1, 2).reshape(2, n_steps, -1))
        h = _rms(x, raw["mlp_norm"][l])
        x = x + mm("wo", F.silu(mm("gate", h)) * mm("up", h))
    h = _rms(x, raw["dec_norm"])
    codes, scales = raw["heads"]
    out = rnd(h) @ dequant(codes.reshape(-1, codes.shape[-1]),
                           scales.reshape(-1, scales.shape[-1])).T
    out = out.reshape(2, n_steps, n_out, -1)
    merged = out[0] + cfg["cfg_scale"] * (out[0] - out[1])
    tok = torch.arange(merged.shape[-1], device=dev)
    return merged.masked_fill(tok > cfg["cfg_max_output"], float("-inf"))


def delay_undo(cfg: dict, tokens, n_steps: int) -> list:
    """Frames: frame i channel c is the token drawn at step i + delay[c];
    frames holding a token outside the audio vocabulary are dropped."""
    delay, md = cfg["delay_pattern"], cfg["max_delay"]
    out = []
    for i in range(max(0, n_steps - md)):
        if i + max(delay) >= n_steps:
            break
        row = [int(tokens[i + d][c]) for c, d in enumerate(delay)]
        if all(r < cfg["audio_vocab_size"] for r in row):
            out.append(row)
    return out
