"""PyTorch port: kernel K2's plain version (the Parler decode step) against
the JAX package's `parler_megastep_reference`, on the CPU, at the
`tests/test_megastep.py::tiny_q4` shapes (L=2, H=256, 4 heads, F=512,
Tc=32, CTX=128)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_tpu.ops import quant_matmul as jqm
from tts_tpu.ops.parler_megastep import parler_megastep_reference
from tts_tpu.ops.parler_megastep import prep_mega_layers as jax_prep_mega
from tts_tpu_torch.gguf import quants
from tts_tpu_torch.models.parler.convert import parler_weights_from_numpy
from tts_tpu_torch.ops.parler_megastep import parler_megastep, prep_mega_layers


def tiny_q4(rng):
    from bench import build_q4_parler
    cfg, w = build_q4_parler(rng, n_layers=2, hidden=256, heads=4, ffn=512,
                             enc_len=32, max_ctx=128)
    cfg.max_generation_size = 48
    return cfg, w


def jax_fields(w):
    """A JAX ParlerWeights as numpy fields for parler_weights_from_numpy:
    dense leaves as arrays, QuantTensors as (codes_t, scales_t, qtype)."""
    def leaf(v):
        if isinstance(v, jqm.QuantTensor):
            return (np.asarray(v.codes_t), np.asarray(v.scales_t), v.qtype)
        return np.asarray(v)
    d = {f: leaf(getattr(w, f)) for f in w._fields if f != "layers"}
    d["layers"] = {f: leaf(getattr(w.layers, f)) for f in w.layers._fields}
    return d


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    cfg, w = tiny_q4(rng)
    jmega, qtype = jax_prep_mega(w.layers)
    pmega, pq = prep_mega_layers(
        parler_weights_from_numpy(jax_fields(w), device="cpu").layers)
    assert pq == qtype
    return cfg, jmega, pmega, qtype


@pytest.mark.parametrize("use_cross", [True, False])
@pytest.mark.parametrize("pos", [1, 37, 127])
def test_plain_vs_reference(tiny, pos, use_cross):
    cfg, jmega, pmega, qtype = tiny
    rng = np.random.default_rng(pos)
    L, H, heads, d = cfg.n_layers, cfg.hidden_size, cfg.n_attn_heads, cfg.head_size
    shape = (L, heads, cfg.max_ctx_length, d)
    kv_k = rng.standard_normal(shape).astype(np.float32) * 0.3
    kv_v = rng.standard_normal(shape).astype(np.float32) * 0.3
    x = rng.standard_normal((1, H)).astype(np.float32) * 0.5
    xo, kn, vn = (np.asarray(a) for a in parler_megastep_reference(
        jmega, jnp.asarray(x), jnp.asarray(kv_k), jnp.asarray(kv_v),
        jnp.int32(pos), qtype=qtype, use_cross=use_cross, n_heads=heads))
    kk, vv = torch.from_numpy(kv_k.copy()), torch.from_numpy(kv_v.copy())
    pxo, pkn, pvn = (a.numpy() for a in parler_megastep(
        pmega, torch.from_numpy(x), kk, vv,
        torch.tensor([pos], dtype=torch.int32), qtype=qtype,
        use_cross=use_cross, n_heads=heads))
    # Same bf16-rounded weights and activations, f32 sums in another order:
    # measured ~2e-7 of the largest value; a last-ulp difference can still
    # move one activation's bf16 rounding by 2^-8 relative, which the next
    # projection spreads over its outputs, so 5e-4 of the largest value.
    for a, b in ((pxo, xo), (pkn, kn), (pvn, vn)):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-4 * np.abs(b).max())
    # the step wrote this token's k/v into cache row pos, and nothing else
    written = kk.numpy()[:, :, pos, :].reshape(L, H)
    np.testing.assert_array_equal(written, pkn)
    np.testing.assert_array_equal(vv.numpy()[:, :, pos, :].reshape(L, H), pvn)
    keep = np.arange(cfg.max_ctx_length) != pos
    np.testing.assert_array_equal(kk.numpy()[:, :, keep], kv_k[:, :, keep])


# (qtype, codes as they come): Q4_0 packed and unpacked (prep packs them),
# Q5_0 and Q8_0 one-byte codes
TILE_QTYPES = [(quants.GGML_TYPE_Q4_0, True), (quants.GGML_TYPE_Q4_0, False),
               (quants.GGML_TYPE_Q5_0, False), (quants.GGML_TYPE_Q8_0, False)]


@pytest.mark.parametrize("hidden,ffn", [(1024, 256), (128, 4096)])
@pytest.mark.parametrize("qtype,packed", TILE_QTYPES)
def test_tiles_read_back_the_row_major_weights(qtype, packed, hidden, ffn):
    """prep_mega_layers tiles each projection for the GEMV; the plain
    versions' read-back (projection_rows) gives every layer's row-major
    codes and bf16 scales bit for bit: qkv, o / cross-q / cross-o (H / 16
    tiles each of occ), fc1 and fc2, at K 1024 (H: every projection but
    fc2) and K 4096 (F: fc2), with Q4_0 codes nibble-packed whether they
    came packed or not."""
    from tts_tpu_torch.models.parler.model import ParlerLayerWeights
    from tts_tpu_torch.ops import parler_megastep as pm
    from tts_tpu_torch.ops.quant_matmul import QuantTensor
    g = torch.Generator().manual_seed(qtype)
    L, heads = 2, hidden // 64
    hi = {quants.GGML_TYPE_Q4_0: 16, quants.GGML_TYPE_Q5_0: 32}.get(qtype, 256)

    def quant(n, k):
        codes = torch.randint(0, hi, (L, n, k), generator=g).to(torch.uint8)
        if qtype == quants.GGML_TYPE_Q8_0:
            codes = codes.view(torch.int8)
        scales = torch.rand((L, n, k // 32), generator=g).to(torch.bfloat16)
        w = QuantTensor(codes, scales, qtype)
        return w.pack() if packed else w

    vec = torch.ones(L, hidden)
    cross = torch.zeros(L, heads, 4, 64)
    hh = [quant(hidden, hidden) for _ in range(6)]
    f1, f2 = quant(ffn, hidden), quant(hidden, ffn)
    mega, qt = pm.prep_mega_layers(ParlerLayerWeights(
        vec, vec, *hh[:4], vec, vec, *hh[4:], cross, cross, vec, vec, f1, f2))
    assert qt == qtype
    th = hidden // pm.TILE_ROWS
    want = {"qkv": hh[:3], "o": [hh[3]], "cq": [hh[4]], "co": [hh[5]],
            "fc1": [f1], "fc2": [f2]}
    for l in range(L):
        got = {"qkv": pm.projection_rows(mega.qkv_codes[l], mega.qkv_scales[l]),
               "fc1": pm.projection_rows(mega.fc1_codes[l], mega.fc1_scales[l]),
               "fc2": pm.projection_rows(mega.fc2_codes[l], mega.fc2_scales[l])}
        for i, name in enumerate(("o", "cq", "co")):
            got[name] = pm.projection_rows(mega.occ_codes[l, i * th:(i + 1) * th],
                                           mega.occ_scales[l, i * th:(i + 1) * th])
        for name, ms in want.items():
            codes = torch.cat([m.pack().codes[l] for m in ms])
            scales = torch.cat([m.scales[l] for m in ms])
            assert torch.equal(got[name][0], codes), (name, l)
            assert got[name][1].dtype == torch.bfloat16
            assert torch.equal(got[name][1], scales), (name, l)
