"""PyTorch port: block-dequant (QuantTensor) and kernel K1's plain version
against the JAX package, on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_tpu import native
from tts_tpu.ops import quant_matmul as jqm
from tts_tpu.ops.parler_megastep import _qdot_ref
from tts_tpu_torch.gguf import quants
from tts_tpu_torch.ops import quant_matmul as qm
from tts_tpu_torch.ops.linear import take_rows

QTYPES = [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0, quants.GGML_TYPE_Q8_0]
# K spans two of the JAX layout's 2048-row packing blocks, so the layout
# conversion is exercised across a block edge.
N, K = 40, 2176


def _planar(rng, qtype, n=N, k=K):
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.02
    raw = quants.quantize(w, qtype)
    return raw, quants.unpack_planar(raw, qtype, (n, k))


def _both(rng, qtype, packed):
    """The same quantized weight in both packages' layouts."""
    _, (codes, scales) = _planar(rng, qtype)
    jt = jqm.QuantTensor.from_planar(codes, scales, qtype)
    pt = qm.QuantTensor.from_planar(codes, scales, qtype, "cpu")
    if packed:
        jt, pt = jt.pack(), pt.pack()
    return jt, pt


@pytest.mark.parametrize("qtype,packed", [(q, False) for q in QTYPES] +
                         [(quants.GGML_TYPE_Q4_0, True)])
def test_dequant_bit_exact(rng, qtype, packed):
    jt, pt = _both(rng, qtype, packed)
    assert pt.is_packed == packed == jt.is_packed
    ref = np.asarray(jqm.dequant_t(jt.codes_t, jt.scales_t, qtype)).T
    np.testing.assert_array_equal(pt.dense().numpy(), ref)
    # the JAX layout carried across (transposed, 2048-row half-split nibbles)
    conv = qm.QuantTensor.from_transposed(np.asarray(jt.codes_t),
                                          np.asarray(jt.scales_t), qtype,
                                          device="cpu")
    assert conv.is_packed == packed
    np.testing.assert_array_equal(conv.codes.numpy(), pt.codes.numpy())
    np.testing.assert_array_equal(conv.dense().numpy(), ref)


@pytest.mark.parametrize("qtype", QTYPES)
def test_unpack_planar_transposed_matches_native(rng, qtype):
    raw, _ = _planar(rng, qtype)
    c0, s0 = native.unpack_planar_transposed(raw, qtype, (N, K))
    c1, s1 = quants.unpack_planar_transposed(raw, qtype, (N, K))
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_array_equal(s0, s1)


@pytest.mark.parametrize("m", [1, 8, 200])
@pytest.mark.parametrize("qtype", QTYPES)
def test_plain_matmul_f32_scales_vs_xla(rng, qtype, m):
    """f32 scales: exact f32 dequant and dot on both sides; only the
    summation order differs (K = 2176 terms of size ~0.02), so 1e-5
    relative to the largest output."""
    jt, pt = _both(rng, qtype, packed=qtype == quants.GGML_TYPE_Q4_0)
    x = rng.standard_normal((m, K)).astype(np.float32)
    ref = np.asarray(jqm.quant_matmul_xla(jnp.asarray(x), jt.codes_t,
                                          jt.scales_t, qtype))
    out = qm.quant_matmul(torch.from_numpy(x), pt).numpy()
    assert out.shape == (m, N) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("qtype", QTYPES)
def test_plain_matmul_bf16_scales_vs_qdot_ref(rng, qtype):
    """bf16 scales: both sides round the dequantized weight and the
    activation to bf16 and sum exact products in f32; only the summation
    order differs, so 1e-5 relative to the largest output."""
    jt, pt = _both(rng, qtype, packed=qtype == quants.GGML_TYPE_Q4_0)
    x = rng.standard_normal((3, K)).astype(np.float32)
    ref = np.asarray(_qdot_ref(jnp.asarray(x), jt.codes_t,
                               jt.scales_t.astype(jnp.bfloat16),
                               jqm._BIAS[qtype]))
    pt16 = qm.QuantTensor(pt.codes, pt.scales.to(torch.bfloat16), qtype)
    out = qm.quant_matmul(torch.from_numpy(x), pt16).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("qtype", QTYPES)
def test_take_rows_bit_exact(rng, qtype):
    jt, pt = _both(rng, qtype, packed=qtype == quants.GGML_TYPE_Q4_0)
    ids = np.array([3, 0, 39, 3, 17], np.int32)
    ref = np.asarray(jt.take_rows(jnp.asarray(ids)))
    out = take_rows(pt, torch.from_numpy(ids).long()).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("qtype", QTYPES)
def test_pad_n_bit_exact(rng, qtype):
    """N padded to a multiple of 256 with zero rows, as the JAX pad_n pads
    its output columns: the dense weights agree bit for bit and the padded
    outputs are exactly zero."""
    jt, pt = _both(rng, qtype, packed=qtype == quants.GGML_TYPE_Q4_0)
    jp, pp = jt.pad_n(), pt.pad_n()
    assert pp.shape == (256, K) and pp.is_packed == pt.is_packed
    ref = np.asarray(jqm.dequant_t(jp.codes_t, jp.scales_t, qtype)).T
    np.testing.assert_array_equal(pp.dense().numpy(), ref)
    out = qm.quant_matmul(torch.from_numpy(
        rng.standard_normal((2, K)).astype(np.float32)), pp)
    assert torch.all(out[:, N:] == 0)


@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
def test_fast_stacked_heads_logits(rng, qtype):
    """Per-head padded, bf16-scale heads: logits sliced back to the vocab
    match the JAX heads through `_qdot_ref` (the TPU kernel's bf16 mode)
    within summation-order noise, padded columns are exactly zero, and the
    JAX padded layout carried across equals the port's own."""
    nh, vocab, k = 3, 300, 128
    _, (codes, scales) = _planar(rng, qtype, nh * vocab, k)
    jt = jqm.QuantTensor.from_planar(codes, scales, qtype) \
        .fast_stacked_heads(nh, vocab)
    pt = qm.QuantTensor.from_planar(codes, scales, qtype, "cpu") \
        .fast_stacked_heads(nh, vocab)
    assert pt.shape == (nh * 512, k) and pt.scales.dtype == torch.bfloat16
    x = rng.standard_normal((1, k)).astype(np.float32)
    out = qm.quant_matmul(torch.from_numpy(x), pt).numpy().reshape(nh, 512)
    ref = np.asarray(_qdot_ref(jnp.asarray(x), jt.codes_t, jt.scales_t,
                               jqm._BIAS[qtype])).reshape(nh, 512)
    assert np.all(out[:, vocab:] == 0)
    np.testing.assert_allclose(out[:, :vocab], ref[:, :vocab], rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    conv = qm.QuantTensor.from_transposed(np.asarray(jt.codes_t),
                                          np.asarray(jt.scales_t), qtype,
                                          device="cpu")
    np.testing.assert_array_equal(conv.codes.numpy(), pt.codes.numpy())
    assert torch.equal(conv.scales, pt.scales)
