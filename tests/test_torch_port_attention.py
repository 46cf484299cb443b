"""PyTorch port: kernels K3's and K4's plain versions (single-query decode
attention, one sequence or a batch at mixed positions) against the JAX
package's `_xla_fallback` and its batched XLA path, on the CPU, at the
shapes the card's kernel groups: GQA with 1, 3 and 4 q heads a kv head, D
64 and 128."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_tpu.ops.decode_attention import _xla_fallback
from tts_tpu.ops.decode_attention import decode_attention_batched as jax_batched
from tts_tpu_torch.ops.decode_attention import (decode_attention,
                                                decode_attention_batched)

CTX, D = 512, 64


@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("pos", [0, 255, 256, 257, CTX - 1])
def test_plain_vs_xla_fallback(rng, pos, n_rep):
    """Positions on the kernel's 256-row page edges, GQA 1 and 4. Both sides
    are an f32 masked softmax; only the summation order differs, so 1e-5
    absolute on outputs of size ~1."""
    hkv = 2
    q = rng.standard_normal((hkv * n_rep, D)).astype(np.float32)
    k = rng.standard_normal((hkv, CTX, D)).astype(np.float32)
    v = rng.standard_normal((hkv, CTX, D)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    ref = np.asarray(_xla_fallback(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), pos, scale))
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           torch.tensor([pos], dtype=torch.int32)).numpy()
    assert out.shape == (hkv * n_rep, D)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_plain_reads_only_rows_up_to_pos(rng):
    """Rows past pos must not matter: garbage there changes nothing."""
    q = torch.from_numpy(rng.standard_normal((4, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((4, CTX, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((4, CTX, D)).astype(np.float32))
    pos = torch.tensor([300], dtype=torch.int32)
    a = decode_attention(q, k, v, pos)
    k[:, 301:] = 1e4
    v[:, 301:] = -1e4
    assert torch.equal(decode_attention(q, k, v, pos), a)


@pytest.mark.parametrize("n_rep", [3, 4])
@pytest.mark.parametrize("pos", [0, 255, 256, 257, CTX - 1])
def test_plain_vs_xla_fallback_gqa_d128(rng, pos, n_rep):
    """The grouping K3 reads a kv head's page with: D 128 with 3 (Orpheus's
    24 / 8) and 4 (Dia's 16 / 4) q heads a kv head. 1e-5 absolute, as
    above."""
    hkv, d = 2, 128
    q = rng.standard_normal((hkv * n_rep, d)).astype(np.float32)
    k = rng.standard_normal((hkv, CTX, d)).astype(np.float32)
    v = rng.standard_normal((hkv, CTX, d)).astype(np.float32)
    ref = np.asarray(_xla_fallback(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), pos, 1.0 / np.sqrt(d)))
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           torch.tensor([pos], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# slots at positions on both sides of the 256-row page edges, one at 0
MIXED = (0, 1, 255, 256, 257, 300, 511, 100)


@pytest.mark.parametrize("n_rep,d", [(1, 64), (3, 128), (4, 128)])
def test_batched_plain_mixed_positions(rng, n_rep, d):
    """K4's plain version with every slot at its own position across page
    edges, against the JAX batched reference (the XLA path, `_xla_fallback`
    per slot): 1e-5 absolute."""
    hkv, b = 2, len(MIXED)
    q = rng.standard_normal((b, hkv * n_rep, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, CTX, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, CTX, d)).astype(np.float32)
    pos = np.asarray(MIXED, np.int32)
    ref = np.asarray(jax_batched(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), use_pallas=False))
    out = decode_attention_batched(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(pos)).numpy()
    assert out.shape == (b, hkv * n_rep, d)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
