"""PyTorch port: kernel K3's plain version (single-query decode attention)
against the JAX package's `_xla_fallback`, on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_tpu.ops.decode_attention import _xla_fallback
from tts_tpu_torch.ops.decode_attention import decode_attention

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
