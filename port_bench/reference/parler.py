"""Parler-TTS Mini's audio decoder, teacher-forced over a whole request.

A pre-LN transformer (layer norm eps 1e-5): causal self-attention over the
prompt and the audio steps, cross-attention over the description
encoding's K / V (its own projections of the encoding, every row
attended), a tanh-GELU MLP, a final layer norm and 9 codebook heads. The
prompt's rows embed its token ids; audio step t embeds the sum of the 9
codebooks' tokens fed to it (BOS on channel c until step c + 1, then the
token that channel drew at the step before) and sits at position P + t;
its output row gives step t's logits. Learned positional embeddings.

`rounding` rounds every product's input and the self-attention's K / V,
where the program rounds to bfloat16: identity for the reference, fp8 for
the control.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .q4 import ROUNDINGS, dequant

LN_EPS = 1e-5


def _ln(x, w, b):
    return F.layer_norm(x, x.shape[-1:], w, b, eps=LN_EPS)


def _heads(x, nh):
    """(T, H) -> (nh, T, D)."""
    return x.reshape(x.shape[0], nh, -1).transpose(0, 1)


def attention(q, k, v, mask=None, scale=None):
    """softmax(q k^T * scale + mask) v in float32; q (..., Tq, D), k / v
    (..., Tk, D), mask a boolean (Tq, Tk) of the pairs attended."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = (q @ k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def decoder_inputs(tokens: torch.Tensor, n_out: int, bos: int) -> torch.Tensor:
    """(n, n_out) tokens fed to each audio step from the tokens drawn,
    tokens (n, n_out)."""
    n = tokens.shape[0]
    fed = torch.full((n, n_out), bos, dtype=torch.long, device=tokens.device)
    t = torch.arange(n, device=tokens.device)[:, None]
    c = torch.arange(n_out, device=tokens.device)[None, :]
    prev = torch.cat([torch.full_like(tokens[:1], bos), tokens[:-1]])
    return torch.where(t > c, prev, fed)


@torch.no_grad()
def logits(raw: dict, cfg: dict, prompt_ids: list, tokens: torch.Tensor,
           rounding: str = "float32") -> torch.Tensor:
    """(n, n_out, vocab) float32 logits of the n audio steps whose drawn
    tokens are `tokens` (n, n_out), after the prompt `prompt_ids`."""
    rnd = ROUNDINGS[rounding]
    dev = raw["pos_embd"].device
    H, nh, L = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_hidden_layers"]
    n_out, vocab = cfg["num_codebooks"], cfg["vocab_size"]
    tokens = tokens.to(dev).long()
    P, n = len(prompt_ids), tokens.shape[0]

    def mm(x, name, layer=None):
        codes, scales = raw[name]
        if layer is not None:
            codes, scales = codes[layer], scales[layer]
        return rnd(x) @ dequant(codes, scales).T

    ids = torch.tensor(prompt_ids, dtype=torch.long, device=dev)
    fed = decoder_inputs(tokens, n_out, cfg["bos_token_id"])
    x = torch.cat([
        raw["prompt_embd"][ids],
        raw["embds"][torch.arange(n_out, device=dev)[None, :], fed].sum(1)])
    x = x + raw["pos_embd"][:P + n]
    S = P + n
    causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    enc = raw["text_encoding"]
    for l in range(L):
        h = _ln(x, raw["ln1_w"][l], raw["ln1_b"][l])
        q = _heads(mm(h, "q", l), nh)
        k = _heads(rnd(mm(h, "k", l)), nh)
        v = _heads(rnd(mm(h, "v", l)), nh)
        a = attention(q, k, v, causal)
        x = x + mm(a.transpose(0, 1).reshape(S, H), "o", l)
        h = _ln(x, raw["lnc_w"][l], raw["lnc_b"][l])
        cq = _heads(mm(h, "cq", l), nh)
        ck = _heads(enc @ raw["ck_proj"][l].T, nh)
        cv = _heads(enc @ raw["cv_proj"][l].T, nh)
        a = attention(cq, ck, cv)
        x = x + mm(a.transpose(0, 1).reshape(S, H), "co", l)
        h = _ln(x, raw["ln2_w"][l], raw["ln2_b"][l])
        x = x + mm(F.gelu(mm(h, "fc1", l), approximate="tanh"), "fc2", l)
    h = _ln(x[P:], raw["final_ln_w"], raw["final_ln_b"])
    codes, scales = raw["heads"]
    out = rnd(h) @ dequant(codes.reshape(-1, codes.shape[-1]),
                           scales.reshape(-1, scales.shape[-1])).T
    return out.reshape(n, n_out, vocab)


def delay_undo(tokens, n_steps: int, n_out: int, audio_vocab: int):
    """Frames (T, n_out): frame i channel c is the token drawn at step i + c;
    frames holding a token outside the audio vocabulary are dropped."""
    out = []
    for i in range(n_steps):
        if i + n_out - 1 >= n_steps:
            break
        row = [int(tokens[i + c][c]) for c in range(n_out)]
        if all(r < audio_vocab for r in row):
            out.append(row)
    return out
