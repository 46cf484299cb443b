"""PyTorch port: the plain versions of kernels K4 (batched decode attention)
and K5 (batched Parler decode step), and the batched sampler, against the
JAX package on the CPU.

K4's plain version meets the TPU kernel `paged_decode_attention_batched`
run in Pallas interpret mode and the vmapped `_xla_fallback`; K5's meets
`parler_megastep_batched_reference` (the JAX package's spec for its batched
kernel) at `test_torch_port_megastep.py::tiny_q4` shapes; `select_batched`
is fed the uniforms JAX's `sample_batched` draws, so the tokens must be
equal. Slots sit at mixed positions across page boundaries throughout.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_megastep import tiny  # noqa: F401  (module fixture)
from tts_tpu.ops import sampling as js
from tts_tpu.ops.decode_attention import (decode_attention_batched,
                                          paged_decode_attention_batched)
from tts_tpu.ops.parler_megastep import parler_megastep_batched_reference
from tts_tpu_torch.ops import decode_attention as da
from tts_tpu_torch.ops import parler_megastep as pm
from tts_tpu_torch.ops import sampling as ps

POS = [0, 255, 256, 511]   # CTX 512 = two 256-row pages


def _kv_inputs(rng, n_rep, dtype):
    b, hkv, ctx, d = 4, 2, 512, 64
    q = rng.standard_normal((b, hkv * n_rep, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, ctx, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, ctx, d)).astype(np.float32)
    if dtype == "bfloat16":   # both sides read the same bf16 values
        k, v = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) for a in (k, v))
    return q, k, v


def _torch(a):
    a = np.array(a)   # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rep", [1, 2])
def test_k4_plain_vs_jax(rng, n_rep, dtype):
    """f32 softmax over the same values in another order: 1e-5 of the
    largest output, against the Pallas kernel and the vmapped fallback."""
    q, k, v = _kv_inputs(rng, n_rep, dtype)
    pos = np.asarray(POS, np.int32)
    jq, jk, jv, jp = (jnp.asarray(a) for a in (q, k, v, pos))
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(paged_decode_attention_batched(jq, jk, jv, jp, page=256))
    xla = np.asarray(decode_attention_batched(jq, jk, jv, jp, use_pallas=False))
    got = da.decode_attention_batched(_torch(q), _torch(k), _torch(v),
                                      torch.from_numpy(pos)).numpy()
    for ref in (kern, xla):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    # slot s is K3's plain version on slot s's cache, exactly
    for s, p in enumerate(POS):
        np.testing.assert_array_equal(got[s], da.decode_attention_plain(
            _torch(q)[s], _torch(k)[s], _torch(v)[s], p).numpy())


def test_k4_plain_shared_kv(rng):
    """The cross-attention mode: one (Hkv, Tc, D) cache and one position
    shared by every slot."""
    q = torch.from_numpy(rng.standard_normal((3, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((4, 40, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((4, 40, 64)).astype(np.float32))
    got = da.decode_attention_batched(q, k, v, torch.tensor([39], dtype=torch.int32))
    for s in range(3):
        assert torch.equal(got[s], da.decode_attention_plain(q[s], k, v, 39))


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_k5_plain_vs_batched_reference(tiny, cache):  # noqa: F811
    """B = 4 slots at the positions of the JAX package's own test. On an f32
    cache the port (writes the current row, then attends rows [0, pos]) and
    the reference (folds the current row in f32) compute the same values:
    1e-5 of the largest value. On a bf16 cache the port attends the current
    row rounded to bf16 (2^-9 relative): 2^-8 of the largest value."""
    cfg, jmega, pmega, qtype = tiny
    rng = np.random.default_rng(7)
    L, H, heads, d = cfg.n_layers, cfg.hidden_size, cfg.n_attn_heads, cfg.head_size
    b, ctx = 4, cfg.max_ctx_length
    pos = np.asarray([0, 1, 63, 127], np.int32)
    shape = (L, b, heads, ctx, d)
    kv = rng.standard_normal((2, *shape)).astype(np.float32) * 0.3
    x = rng.standard_normal((b, H)).astype(np.float32) * 0.5
    jkv = jnp.asarray(kv)
    if cache == "bfloat16":
        jkv = jkv.astype(jnp.bfloat16)
    kw = dict(qtype=qtype, use_cross=True, n_heads=heads)
    ref = [np.asarray(a) for a in parler_megastep_batched_reference(
        jmega, jnp.asarray(x), jkv[0], jkv[1], jnp.asarray(pos), **kw)]
    kk, vv = _torch(jkv[0]).clone(), _torch(jkv[1]).clone()
    got = [a.numpy() for a in pm.parler_megastep_batched(
        pmega, torch.from_numpy(x), kk, vv, torch.from_numpy(pos), **kw)]
    rel = 1e-5 if cache == "float32" else 2 ** -8
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a, r, rtol=0, atol=rel * np.abs(r).max())
    # each slot wrote its k/v at its own row pos[s] and nowhere else
    for s, p in enumerate(pos):
        assert torch.equal(kk[:, s, :, p].reshape(L, H),
                           torch.from_numpy(got[1][:, s]).to(kk.dtype))
        rows = np.arange(ctx) != p
        assert torch.equal(kk[:, s][:, :, rows], _torch(jkv[0])[:, s][:, :, rows])


def test_k5_plain_slot_equals_k2_plain(tiny):  # noqa: F811
    """Slot s of the batched plain version is K2's plain version on slot s's
    state, bit for bit."""
    cfg, _, pmega, qtype = tiny
    gen = torch.Generator().manual_seed(3)
    L, H, heads, d = cfg.n_layers, cfg.hidden_size, cfg.n_attn_heads, cfg.head_size
    shape = (L, 3, heads, cfg.max_ctx_length, d)
    kk, vv = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
    x = torch.randn((3, H), generator=gen)
    pos = torch.tensor([5, 127, 64], dtype=torch.int32)
    kw = dict(qtype=qtype, use_cross=True, n_heads=heads)
    k0, v0 = kk.clone(), vv.clone()
    xo, kn, vn = pm.parler_megastep_batched(pmega, x, kk, vv, pos, **kw)
    for s in range(3):
        ks, vs = k0[:, s].clone(), v0[:, s].clone()
        xs, kns, vns = pm.parler_megastep(pmega, x[s:s + 1], ks, vs, pos[s:s + 1], **kw)
        assert torch.equal(xo[s:s + 1], xs) and torch.equal(kn[:, s], kns)
        assert torch.equal(vn[:, s], vns) and torch.equal(kk[:, s], ks)


def test_select_batched_vs_jax_sample_batched():
    """Mixed per-row parameters in one batch, over several steps with the
    repetition state carried by each package: tokens equal."""
    rng = np.random.default_rng(11)
    b, h, v = 6, 9, 1088
    params = dict(
        do_sample=np.array([1, 1, 1, 1, 0, 1], bool),
        temperature=np.array([0.7, 1.0, 1.0, 0.8, 1.0, 1.3], np.float32),
        top_k=np.array([50, 0, 300, 5, 0, 256], np.int32),
        top_p=np.array([1.0, 0.9, 1.0, 0.8, 1.0, 0.95], np.float32),
        repetition_penalty=np.array([1.0, 1.1, 1.3, 1.0, 1.5, 1.2], np.float32))
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    tparams = {k: torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
               for k, a in params.items()}
    js_state = js.init_batched_state(b, h)
    ps_state = ps.init_batched_state(b, h, device="cpu")
    key = jax.random.PRNGKey(5)
    prev = None
    for _ in range(6):
        x = (rng.standard_normal((b, h, v)) * 3).astype(np.float32)
        if prev is not None:   # boost the last token so repeats occur
            np.put_along_axis(x, prev[:, :, None], 8.0 + np.take_along_axis(
                x, prev[:, :, None], -1), -1)
        key, sub = jax.random.split(key)
        ref, js_state = js.sample_batched(sub, jnp.asarray(x), js_state, **jparams)
        u = torch.from_numpy(np.array(jax.random.uniform(sub, (b, h))))
        out, ps_state = ps.select_batched(torch.from_numpy(x), ps_state, u,
                                          **tparams)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(ps_state.repeat_count.numpy(),
                                      np.asarray(js_state.repeat_count))
        prev = out.numpy()
