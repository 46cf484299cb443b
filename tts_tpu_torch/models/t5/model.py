"""T5 text encoder (flan-t5 variant) in PyTorch, the port of the JAX
package's `models/t5/model.py`.

Parler uses it for conditional prompts (reference
src/models/parler/t5/model.cpp): it encodes the voice description, from
which the decoder's cross K/V are rebuilt.

Math parity (build_t5_graph, t5/model.cpp:216-298): RMS norm (eps 1e-6),
attention with NO 1/sqrt(d) scaling (softmax scale 1.0) plus the shared
relative-attention bias and the pad mask, gated-GELU MLP gelu(wi_0 x) *
(wi_1 x) with tanh GELU, final norm, optional down projection with bias.
The projections go through `ops/linear.matmul`: kernel K1 for quantized
weights (its f32 mode up to 256 rows), plain float32 products for dense
ones. The attention is plain torch, as the JAX package computes it in XLA.
Sequences are padded to a length bucket (`T5Runner.buckets`), as in the
JAX package; the pad mask keeps the pad rows out of every real row.

Reference quirks (t5/model.cpp:308-317): the reference computes buckets
with C++ INTEGER division inside the log and adds the direction offset
when query > key, the transpose of the HF convention the weights were
trained with. The port follows HF, as the JAX package does;
`reference_pos_buckets` keeps the reference's formula for its test.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ...common import default_device, strict_fp32
from ...gguf.reader import GGUFReader
from ...ops.attention import t5_relative_buckets
from ...ops.linear import (Weight, dense, from_gguf_tensor, matmul,
                           stack_weights, take_rows)
from ...text import UnigramTokenizer

RMS_EPS = 1e-6
BUCKETS = (32, 64, 128, 256, 512)   # the runner's padded prompt lengths


def length_bucket(n: int, buckets=BUCKETS) -> int:
    """The first bucket that holds n rows (n itself past the last)."""
    return next((b for b in buckets if n <= b), n)


@dataclasses.dataclass(eq=False)
class T5Config:
    """Defaults = flan-t5-xl-ish (t5/model.h:40-51); a GGUF's
    t5encoder.* keys override them."""

    n_layers: int = 24
    n_attn_heads: int = 32
    hidden_size: int = 2048
    relative_attn_buckets: int = 32
    eos_token_id: int = 1
    bos_token_id: int = 0
    max_context_length: int = 512
    output_size: int = 1536
    vocab_size: int = 0

    @property
    def head_size(self) -> int:
        return 64 if self.hidden_size == 2048 else self.hidden_size // self.n_attn_heads

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "T5Config":
        c = cls()
        c.n_layers = int(r.get("t5encoder.block_count", c.n_layers))
        c.hidden_size = int(r.get("t5encoder.embedding_length", c.hidden_size))
        c.n_attn_heads = int(r.get("t5encoder.attention.head_count", c.n_attn_heads))
        c.max_context_length = int(r.get("t5encoder.context_length", c.max_context_length))
        c.bos_token_id = int(r.get("tokenizer.ggml.bos_token_id", c.bos_token_id))
        c.eos_token_id = int(r.get("tokenizer.ggml.eos_token_id", c.eos_token_id))
        c.vocab_size = int(r.get("t5encoder.vocab_size", 0))
        c.output_size = int(r.get("t5encoder.output_size", c.output_size))
        return c


class T5LayerWeights(NamedTuple):
    """All leaves stacked on the layer axis 0."""
    attn_norm: Any
    q: Weight; k: Weight; v: Weight; o: Weight
    mlp_norm: Any
    wi_0: Weight; wi_1: Weight; wo: Weight


class T5Weights(NamedTuple):
    embd: Weight
    rel_bias: Any               # (buckets, heads)
    layers: T5LayerWeights
    out_norm: Any
    down_proj: Any              # (output_size, H) or None
    down_proj_bias: Any         # (output_size,) or None


def _rms(x, w, eps: float = RMS_EPS):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def reference_pos_buckets(t: int, n_total_buckets: int = 32) -> np.ndarray:
    """The bucket matrix exactly as the reference computes it on the host
    (t5/model.cpp:308-317, its integer division included)."""
    n_buckets = n_total_buckets // 2
    max_exact = n_buckets // 2
    denom = np.log(128.0 / max_exact)
    out = np.zeros((t, t), np.int32)
    for i in range(t):
        for ii in range(t):
            rpos = i - ii
            ab = abs(rpos)
            if ab < max_exact:
                b = ab
            else:
                # C++: (int)((log(ab / max_exact) / denom) * max_exact) with
                # INTEGER division ab / max_exact
                b = min(n_buckets - 1,
                        max_exact + int(np.log(ab // max_exact) / denom * max_exact))
            out[i, ii] = (n_buckets if rpos > 0 else 0) + b
    return out


@torch.no_grad()
def t5_encode(cfg: T5Config, w: T5Weights, tokens: torch.Tensor, valid_len: int,
              pos_buckets: torch.Tensor) -> torch.Tensor:
    """tokens (T,) -> encoding (T, output_size) float32. Key positions >=
    valid_len are masked out of attention, so that bucket padding cannot
    leak into the real rows. pos_buckets (T, T) from t5_relative_buckets."""
    t, nh = tokens.shape[0], cfg.n_attn_heads
    x = take_rows(w.embd, tokens).float()
    bias = w.rel_bias[pos_buckets.reshape(-1)].reshape(t, t, -1).permute(2, 0, 1)
    pad = torch.zeros(t, device=x.device).masked_fill(
        torch.arange(t, device=x.device) >= valid_len, float("-inf"))
    bias = bias + pad[None, None, :]
    for i in range(cfg.n_layers):
        lw = T5LayerWeights(*[f[i] for f in w.layers])
        h = _rms(x, lw.attn_norm)
        q = matmul(h, lw.q).reshape(t, nh, -1).transpose(0, 1)
        k = matmul(h, lw.k).reshape(t, nh, -1).transpose(0, 1)
        v = matmul(h, lw.v).reshape(t, nh, -1).transpose(0, 1)
        probs = torch.softmax(torch.matmul(q, k.transpose(1, 2)) + bias, dim=-1)
        a = torch.matmul(probs, v).transpose(0, 1).reshape(t, -1)
        x = x + matmul(a, lw.o)
        h = _rms(x, lw.mlp_norm)
        # tanh GELU: both ggml_gelu and HF's gated-gelu (gelu_new)
        up = torch.nn.functional.gelu(matmul(h, lw.wi_0), approximate="tanh")
        x = x + matmul(up * matmul(h, lw.wi_1), lw.wo)
    x = _rms(x, w.out_norm)
    if w.down_proj is not None:
        x = matmul(x, w.down_proj)
        if w.down_proj_bias is not None:
            x = x + w.down_proj_bias
    return x


@torch.no_grad()
def load_t5_weights(r: GGUFReader, cfg: T5Config, device=None) -> T5Weights:
    """The encoder's weights on `device` (default cuda, see
    common.default_device). The relative-attention bias is the first
    layer's (T5 shares it across layers)."""
    device = default_device(device)
    names = set(r.tensor_names())

    def get(name):
        return from_gguf_tensor(r, name, device)

    lws, rel_bias = [], None
    for l in range(cfg.n_layers):
        b = f"t5encoder.enc.blk.{l}."
        if rel_bias is None and (b + "attn_rel_b") in names:
            rel_bias = dense(get(b + "attn_rel_b"))
        lws.append(T5LayerWeights(
            attn_norm=get(b + "attn_norm"),
            q=get(b + "attn_q"), k=get(b + "attn_k"), v=get(b + "attn_v"),
            o=get(b + "attn_o"), mlp_norm=get(b + "ffn_norm"),
            wi_0=get(b + "ffn_up"), wi_1=get(b + "ffn_gate"),
            wo=get(b + "ffn_down")))
    layers = T5LayerWeights(*[stack_weights([getattr(lw, f) for lw in lws])
                              for f in T5LayerWeights._fields])
    return T5Weights(
        embd=get("t5encoder.token_embd"), rel_bias=rel_bias, layers=layers,
        out_norm=get("t5encoder.enc.final_layer_norm"),
        down_proj=get("t5encoder.down_proj")
        if "t5encoder.down_proj" in names else None,
        down_proj_bias=get("t5encoder.down_proj_bias")
        if "t5encoder.down_proj_bias" in names else None)


class T5Runner:
    """Parity: t5_runner (t5/model.cpp:322-368). Runs where its weights
    lie; prompts are padded to a length bucket."""

    def __init__(self, cfg: T5Config, weights: T5Weights,
                 tokenizer: UnigramTokenizer, buckets=BUCKETS):
        strict_fp32()
        self.cfg = cfg
        self.weights = weights
        self.tokenizer = tokenizer
        self.buckets = buckets
        self.device = weights.out_norm.device
        self._bucket_cache: dict = {}

    def bucket(self, n: int) -> int:
        return length_bucket(n, self.buckets)

    def encode_tokens(self, ids) -> torch.Tensor:
        """Token ids -> (len(ids), output_size) float32 on the runner's
        device."""
        t = len(ids)
        tb = self.bucket(t)
        toks = torch.zeros(tb, dtype=torch.int64)
        toks[:t] = torch.tensor(ids, dtype=torch.int64)
        if tb not in self._bucket_cache:
            pos = torch.arange(tb, device=self.device)
            self._bucket_cache[tb] = t5_relative_buckets(
                pos, pos, self.cfg.relative_attn_buckets, 128)
        out = t5_encode(self.cfg, self.weights, toks.to(self.device), t,
                        self._bucket_cache[tb])
        return out[:t]

    def generate(self, prompt: str) -> torch.Tensor:
        ids = self.tokenizer.tokenize(prompt)
        ids.append(self.cfg.eos_token_id)
        return self.encode_tokens(ids)


def text_encoder_from_file(path: str, tokenizer: UnigramTokenizer | None = None,
                           device=None) -> T5Runner:
    """A T5Runner from a T5 encoder GGUF on `device` (default cuda; raises
    when there is no card and the caller did not ask for device="cpu").
    `tokenizer` defaults to the GGUF's own; every tensor is copied onto the
    device and the file closed."""
    dev = default_device(device)
    with GGUFReader(path) as r:
        cfg = T5Config.from_gguf(r)
        if tokenizer is None:
            tokenizer = UnigramTokenizer.from_gguf(r)
        weights = load_t5_weights(r, cfg, device=dev)
    return T5Runner(cfg, weights, tokenizer)
