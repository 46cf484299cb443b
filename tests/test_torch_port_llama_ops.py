"""PyTorch port: the Orpheus step's ops against the JAX package, on the CPU.

Kernel K8's plain version against `llama_megastep_reference`, kernel K6's
plain version against the TPU kernel `llama_flat_megastep` in Pallas
interpret mode, and RoPE and the padded LM head against their JAX
counterparts, at the `tests/test_llama_megastep.py::tiny_q4_llama` shapes
(L=2, H=256, 4 q / 2 kv heads of 64, F=512), for Q4_0 and Q8_0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_port_megastep import jax_fields
from tts_tpu.gguf import quants
from tts_tpu.models.orpheus.model import OrpheusLayer, OrpheusWeights
from tts_tpu.ops import attention as jatt
from tts_tpu.ops.linear import stack_weights
from tts_tpu.ops.llama_flat import llama_flat_megastep as jax_flat_step
from tts_tpu.ops.llama_flat import prep_llama_flat as jax_prep_flat
from tts_tpu.ops.llama_megastep import llama_megastep_reference
from tts_tpu.ops.llama_megastep import prep_llama_mega as jax_prep_mega
from tts_tpu.ops.quant_matmul import QuantTensor as JQuantTensor
from tts_tpu_torch.models.orpheus.convert import (llama_mega_from_numpy,
                                                  orpheus_weights_from_numpy)
from tts_tpu_torch.ops.attention import apply_rope_neox, rope_freqs
from tts_tpu_torch.ops.llama_flat import llama_flat_megastep, prep_llama_flat
from tts_tpu_torch.ops.llama_megastep import llama_megastep, prep_llama_mega
from tts_tpu_torch.ops.quant_matmul import QuantTensor

L, H, HEADS, KV, F, VOCAB, THETA = 2, 256, 4, 2, 512, 100, 500000.0
D = H // HEADS


def tiny_llama(rng, qtype):
    """`tiny_q4_llama`'s weights for any block qtype, in the JAX package's
    types: quantized projections and head, f32 norms and embedding, llama3
    frequency factors of 1.25 (the head's 100 rows are not a multiple of
    256, so the padded head has zero rows)."""
    def quant(n, k):
        w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
        codes, scales = quants.unpack_planar(quants.quantize(w, qtype), qtype,
                                             (n, k))
        return JQuantTensor.from_planar(codes, scales, qtype)

    def f32(*s, scale=0.05):
        return jnp.asarray(rng.standard_normal(s).astype(np.float32) * scale)

    kvn = KV * D
    layers = OrpheusLayer(
        in_norm=f32(L, H) + 1,
        q=stack_weights([quant(H, H) for _ in range(L)]),
        k=stack_weights([quant(kvn, H) for _ in range(L)]),
        v=stack_weights([quant(kvn, H) for _ in range(L)]),
        o=stack_weights([quant(H, H) for _ in range(L)]),
        post_norm=f32(L, H) + 1,
        gate=stack_weights([quant(F, H) for _ in range(L)]),
        up=stack_weights([quant(F, H) for _ in range(L)]),
        down=stack_weights([quant(H, F) for _ in range(L)]))
    return OrpheusWeights(embd=f32(VOCAB, H), layers=layers,
                          out_norm=f32(H) + 1, head=quant(VOCAB, H),
                          rope_freqs=jnp.ones((D // 2,)) * 1.25)


@pytest.fixture(scope="module", params=[quants.GGML_TYPE_Q4_0,
                                        quants.GGML_TYPE_Q8_0],
                ids=["Q4_0", "Q8_0"])
def tiny(request):
    qtype = request.param
    jw = tiny_llama(np.random.default_rng(3), qtype)
    jmega, jq = jax_prep_mega(jw.layers)
    assert jq == qtype
    pw = orpheus_weights_from_numpy(jax_fields(jw), device="cpu")
    pmega, pq = prep_llama_mega(pw.layers)
    assert pq == qtype
    # the JAX prep's layout carried across equals the port's own prep
    conv = llama_mega_from_numpy(
        {f: np.asarray(getattr(jmega, f)) for f in jmega._fields}, qtype,
        device="cpu")
    for f in pmega._fields:
        a, b = getattr(pmega, f), getattr(conv, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    inv = rope_freqs(D, THETA, pw.rope_freqs)
    return qtype, jw, jmega, pw, pmega, inv


def _inputs(pos, ctx):
    rng = np.random.default_rng(pos)
    kv = rng.standard_normal((2, L, KV, ctx, D)).astype(np.float32) * 0.3
    x = rng.standard_normal((1, H)).astype(np.float32) * 0.5
    return x, kv[0], kv[1]


def _close(got, want, what):
    # Same bf16-rounded weights and activations, f32 sums in another order:
    # agreement to ~1e-7 of the largest value, until a last-ulp difference
    # flips one activation's bf16 rounding (2^-8 relative). The next
    # projection spreads that over its outputs, the RMS norm after it makes
    # more roundings flip, and the MLP spreads those: at pos 41 one flip in
    # the attention output of layer 0 moved that layer's x_out by 2.3e-3
    # (0.1% of its largest value). So 1e-2 of the largest value, the JAX
    # package's own bound between these two functions
    # (tests/test_llama_megastep.py).
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("pos,ctx", [(0, 128), (3, 128), (41, 128),
                                     (700, 1024)])
def test_k8_plain_vs_reference(tiny, pos, ctx):
    """Positions on both sides of the 256- and 512-row pages."""
    qtype, jw, jmega, pw, pmega, inv = tiny
    x, kv_k, kv_v = _inputs(pos, ctx)
    xo, kn, vn = (np.asarray(a) for a in llama_megastep_reference(
        jmega, jnp.asarray(x), jnp.asarray(kv_k), jnp.asarray(kv_v),
        jnp.int32(pos), qtype=qtype, n_heads=HEADS, n_kv=KV, rope_base=THETA,
        rope_freq_factors=jw.rope_freqs))
    kk, vv = torch.from_numpy(kv_k.copy()), torch.from_numpy(kv_v.copy())
    pxo, pkn, pvn = (a.numpy() for a in llama_megastep(
        pmega, torch.from_numpy(x), kk, vv,
        torch.tensor([pos], dtype=torch.int32), qtype=qtype, n_heads=HEADS,
        n_kv=KV, inv_freq=inv))
    for what, a, b in (("x_out", pxo, xo), ("k_new", pkn, kn),
                       ("v_new", pvn, vn)):
        _close(a, b, what)
    # the step wrote this token's k/v into cache row pos, and nothing else
    np.testing.assert_array_equal(kk.numpy()[:, :, pos].reshape(L, -1), pkn)
    np.testing.assert_array_equal(vv.numpy()[:, :, pos].reshape(L, -1), pvn)
    keep = np.arange(ctx) != pos
    np.testing.assert_array_equal(kk.numpy()[:, :, keep], kv_k[:, :, keep])


@pytest.mark.parametrize("pos,ctx", [(3, 128), (41, 128), (700, 1024)])
def test_k6_plain_vs_pallas_interpret(tiny, pos, ctx):
    """K6's plain version against the TPU kernel run in interpret mode:
    logits over the real vocab, the padded logits exactly 0, k_new, v_new."""
    qtype, jw, jmega, pw, pmega, inv = tiny
    jflat = jax_prep_flat(jmega, jw.head, jw.out_norm, qtype, VOCAB, HEADS,
                          KV, ctx)
    x, kv_k, kv_v = _inputs(pos, ctx)
    lg, kn, vn = (np.asarray(a) for a in jax_flat_step(
        jflat, jnp.asarray(x), jnp.asarray(kv_k), jnp.asarray(kv_v),
        jnp.int32(pos), qtype=qtype, n_heads=HEADS, n_kv=KV, rope_base=THETA,
        rope_freq_factors=jw.rope_freqs, interpret=True))
    pflat = prep_llama_flat(pmega, pw.head, pw.out_norm, qtype, HEADS, KV)
    assert pflat.head.shape == (256, H)
    assert pflat.head.scales.dtype == pflat.layers.qkv_scales.dtype == torch.bfloat16
    plg, pkn, pvn = (a.numpy() for a in llama_flat_megastep(
        pflat, torch.from_numpy(x), torch.from_numpy(kv_k.copy()),
        torch.from_numpy(kv_v.copy()), torch.tensor([pos], dtype=torch.int32),
        qtype=qtype, n_heads=HEADS, n_kv=KV, inv_freq=inv))
    assert plg.shape == (1, 256)
    _close(plg[:, :VOCAB], lg[:, :VOCAB], "logits")
    np.testing.assert_array_equal(plg[:, VOCAB:], 0.0)
    _close(pkn, kn, "k_new")
    _close(pvn, vn, "v_new")


def test_k6_gate_needs_a_head_of_the_layer_qtype(tiny):
    qtype, jw, jmega, pw, pmega, inv = tiny
    with pytest.raises(ValueError, match="LM head"):
        prep_llama_flat(pmega, pw.head.dense(), pw.out_norm, qtype, HEADS, KV)
    other = quants.GGML_TYPE_Q8_0 if qtype == quants.GGML_TYPE_Q4_0 \
        else quants.GGML_TYPE_Q4_0
    with pytest.raises(ValueError, match="LM head"):
        prep_llama_flat(pmega, pw.head, pw.out_norm, other, HEADS, KV)


def test_fast_lm_head_matches_jax(tiny):
    """Padded to 256 rows with zero scales, bf16 scales, Q4 packed: the JAX
    package's fast_lm_head carried across equals the port's, bit for bit."""
    qtype, jw, jmega, pw, pmega, inv = tiny
    jh = jw.head.fast_lm_head()
    want = QuantTensor.from_transposed(np.asarray(jh.codes_t),
                                       np.asarray(jh.scales_t), qtype, "cpu")
    got = pw.head.fast_lm_head()
    assert got.shape == want.shape == (256, H)
    assert got.is_packed == want.is_packed == (qtype == quants.GGML_TYPE_Q4_0)
    assert got.scales.dtype == want.scales.dtype == torch.bfloat16
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.scales, want.scales)
    assert not got.scales[VOCAB:].any()


def test_rope_matches_jax():
    """rope_freqs (factors divide inv_freq) and apply_rope_neox against the
    JAX package's at positions up to the Orpheus cache's end, D = 128:
    float32 pow, cos and sin may differ by an ulp (angles reach 3584 rad)."""
    rng = np.random.default_rng(0)
    ff = (1.0 + rng.random(64)).astype(np.float32)
    want = np.asarray(jatt.rope_freqs(128, THETA, jnp.asarray(ff)))
    got = rope_freqs(128, THETA, torch.from_numpy(ff)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    positions = np.array([0, 1, 511, 2100, 3583], np.int32)
    want = np.asarray(jatt.apply_rope_neox(jnp.asarray(x),
                                           jnp.asarray(positions), THETA,
                                           jnp.asarray(ff)))
    got = apply_rope_neox(torch.from_numpy(x), torch.from_numpy(positions),
                          rope_freqs(128, THETA, torch.from_numpy(ff)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
