"""PyTorch port: the Dia decode steps' plain versions (K10, K11) against the
JAX package, on the CPU.

The same seeded numpy inputs go through the JAX package's
`dia_megastep_reference` / `dia_megastep_batched_reference` (what its
`dia_megastep*` dispatchers run off the TPU) and the port's
`dia_megastep_plain` / `dia_megastep_batched_plain`, with the JAX prep's
weights carried across by `dia_mega_from_numpy`. Tolerance 1e-2 of the
largest value: both round weights and activations to bf16 the same way,
and a sum in another order can flip one rounding. The caches are float32,
so the port's write-then-attend of the current token is exact, except in
the bf16-cache cases, where the port rounds the current row to bf16 first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.gguf import quants
from tts_tpu.models.dia.model import (DiaConfig, DiaDecoderLayer,
                                      DiaEncoderLayer, DiaWeights)
from tts_tpu.ops import dia_megastep as jdm
from tts_tpu.ops.quant_matmul import QuantTensor as JQuant
from tts_tpu_torch.models.dia.convert import (dia_mega_from_numpy,
                                              dia_weights_from_numpy)
from tts_tpu_torch.ops import dia_megastep as pdm

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run many tiny torch ops: one intra-op thread keeps
    the CPU to the other test workers and JAX's compiles, which share it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Q4, Q5, Q8 = quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0, quants.GGML_TYPE_Q8_0


def tiny_cfg(tc=64):
    """test_dia_megastep.py's tiny config (2 decoder layers, H 256, 4 q / 2
    kv heads of 64) with an encoder window of `tc` rows."""
    return DiaConfig(
        n_encoder_layers=1, n_decoder_layers=2, encoder_hidden_size=128,
        decoder_hidden_size=256, decoder_attn_heads=4, decoder_query_heads=2,
        head_size=64, output_vocab_size=256, max_generation_size=32,
        max_encoder_context_length=tc)


def _quant(rng, n, k, layers, qtype):
    """A stacked JAX QuantTensor (layers, K, N) of random weights."""
    cs, ss = [], []
    for _ in range(layers):
        w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
        codes, scales = quants.unpack_planar(quants.quantize(w, qtype), qtype,
                                             (n, k))
        cs.append(np.ascontiguousarray(codes.T))
        ss.append(np.ascontiguousarray(scales.T.astype(np.float32)))
    return JQuant(jnp.asarray(np.stack(cs)), jnp.asarray(np.stack(ss)), qtype)


def jax_decoder(cfg, qtype, seed=0):
    """A JAX DiaDecoderLayer stack of random block-quantized weights with
    norms away from 1."""
    rng = np.random.default_rng(seed)
    L, H = cfg.n_decoder_layers, cfg.decoder_hidden_size
    QH = cfg.decoder_attn_heads * cfg.head_size
    KVH = cfg.n_kv_heads * cfg.head_size
    F, E = 512, cfg.encoder_hidden_size

    def norm():
        return jnp.asarray(1 + 0.1 * rng.standard_normal((L, H)), jnp.float32)

    return DiaDecoderLayer(
        sa_norm=norm(), self_q=_quant(rng, QH, H, L, qtype),
        self_k=_quant(rng, KVH, H, L, qtype), self_v=_quant(rng, KVH, H, L, qtype),
        self_o=_quant(rng, H, QH, L, qtype), ca_norm=norm(),
        cross_q=_quant(rng, QH, H, L, qtype), cross_k=_quant(rng, QH, E, L, qtype),
        cross_v=_quant(rng, QH, E, L, qtype), cross_o=_quant(rng, H, QH, L, qtype),
        mlp_norm=norm(), gate=_quant(rng, F, H, L, qtype),
        up=_quant(rng, F, H, L, qtype), wo=_quant(rng, H, F, L, qtype))


def mega_pair(cfg, qtype):
    """(JAX DiaMegaLayers, the port's copy of it, qtype)."""
    mega, qt = jdm.prep_dia_mega(jax_decoder(cfg, qtype))
    fields = {f: np.asarray(getattr(mega, f)) for f in mega._fields}
    return mega, dia_mega_from_numpy(fields, qt, cfg.head_size, device="cpu"), qt


def fake_cross(cfg, sentence_len, seed=1, batch=()):
    """(L, *batch, 2, heads, Tc, D) cross K/V with the K rows past the
    prompt zero, as dia_encode leaves them."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_decoder_layers, *batch, 2, cfg.decoder_attn_heads,
             cfg.max_encoder_context_length, cfg.head_size)
    ck = rng.standard_normal(shape).astype(np.float32) * 0.3
    cv = rng.standard_normal(shape).astype(np.float32) * 0.3
    ck[..., sentence_len:, :] = 0.0
    return ck, cv


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() /
                 np.abs(want).max())


def _t(a):
    """A JAX or numpy array as a torch tensor (bf16 kept)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# sentence lengths at the bucket edges of a 1024-row window: the bucket and
# the tail each side of 128 and 256, and past 512
BUCKET_CASES = [(1, 128), (128, 128), (129, 256), (256, 256), (257, 512),
                (700, 1024)]


@pytest.mark.parametrize("sentence_len,sb", BUCKET_CASES)
def test_prep_dia_cross_matches_jax(sentence_len, sb):
    """The bucket, the tail count, the bf16 rows and the tail's V sum."""
    cfg = tiny_cfg(tc=1024)
    ck, cv = fake_cross(cfg, sentence_len)
    jck, jcv, jvt, jnt = jdm.prep_dia_cross(jnp.asarray(ck), jnp.asarray(cv),
                                            sentence_len)
    pck, pcv, pvt, pnt = pdm.prep_dia_cross(torch.from_numpy(ck),
                                            torch.from_numpy(cv), sentence_len)
    assert pnt == jnt == 1024 - sb and pck.shape[2] == sb
    assert torch.equal(pck, _t(jck)) and torch.equal(pcv, _t(jcv))
    np.testing.assert_allclose(pvt.numpy(), np.asarray(jvt), rtol=1e-5,
                               atol=1e-4)


def test_prep_dia_mega_matches_jax():
    """The port's prep of the port's weights equals the JAX prep carried
    across: codes exactly, scales bf16, norms stacked (sa, ca, mlp)."""
    cfg = tiny_cfg()
    dec = jax_decoder(cfg, Q4)
    mega, qt = jdm.prep_dia_mega(dec)
    fields = {f: np.asarray(getattr(mega, f)) for f in mega._fields}
    carried = dia_mega_from_numpy(fields, qt, cfg.head_size, device="cpu")

    def leaf(v):
        return (np.asarray(v.codes_t), np.asarray(v.scales_t), v.qtype) \
            if isinstance(v, JQuant) else np.asarray(v)

    zeros = np.zeros((1, 1), np.float32)
    w = dia_weights_from_numpy(dict(
        enc_embedding=zeros, enc_norm=zeros, dec_embds=zeros, dec_norm=zeros,
        heads=zeros, enc_layers={f: zeros for f in DiaEncoderLayer._fields},
        dec_layers={f: leaf(getattr(dec, f)) for f in DiaDecoderLayer._fields}),
        device="cpu")
    own, qt2 = pdm.prep_dia_mega(w.dec_layers, cfg.head_size)
    assert qt2 == qt
    for f in own._fields:
        assert getattr(own, f).dtype == getattr(carried, f).dtype, f
        assert torch.equal(getattr(own, f), getattr(carried, f)), f
    assert own.qkv_scales.dtype == torch.bfloat16
    assert DiaWeights._fields == type(w)._fields


@pytest.mark.parametrize("qtype", [Q4, Q8])
@pytest.mark.parametrize("sentence_len,sb", BUCKET_CASES)
def test_k10_plain_matches_reference(qtype, sentence_len, sb):
    """K10's plain version against `dia_megastep_reference` at a 1024-row
    encoder window, at every bucket edge (n_tail 896 down to 0), at cache
    positions 0, 255, 256 and 599 of a 600-row cache (the cache row pos is
    written in place and equals the reference's k_new there)."""
    cfg = tiny_cfg(tc=1024)
    mega, pmega, qt = mega_pair(cfg, qtype)
    ck, cv = fake_cross(cfg, sentence_len)
    jck, jcv, jvt, jnt = jdm.prep_dia_cross(jnp.asarray(ck), jnp.asarray(cv),
                                            sentence_len)
    rng = np.random.default_rng(sentence_len)
    L, nkv, d, ctx = cfg.n_decoder_layers, cfg.n_kv_heads, cfg.head_size, 600
    kvk = rng.standard_normal((L, 2, nkv, ctx, d)).astype(np.float32) * 0.5
    kvv = rng.standard_normal((L, 2, nkv, ctx, d)).astype(np.float32) * 0.5
    x = rng.standard_normal((2, cfg.decoder_hidden_size)).astype(np.float32)
    kw = dict(qtype=qt, n_heads=cfg.decoder_attn_heads, n_kv=nkv)
    for p in (0, 255, 256, ctx - 1):
        want = jdm.dia_megastep_reference(
            mega, jnp.asarray(x), jnp.asarray(kvk), jnp.asarray(kvv),
            jnp.int32(p), jck, jcv, jvt, jnt, **kw)
        tk, tv = torch.from_numpy(kvk.copy()), torch.from_numpy(kvv.copy())
        got = pdm.dia_megastep(pmega, torch.from_numpy(x), tk, tv, p, _t(jck),
                               _t(jcv), _t(jvt), jnt, **kw)
        for g, w_ in zip(got, want):
            assert rel_err(g, w_) < 1e-2, (p, rel_err(g, w_))
        assert torch.equal(tk[:, :, :, p].reshape(L, 2, -1), got[1])
        assert torch.equal(tv[:, :, :, p].reshape(L, 2, -1), got[2])
        rows = torch.arange(ctx) != p
        assert torch.equal(tk[:, :, :, rows], torch.from_numpy(kvk)[:, :, :, rows])


@pytest.mark.parametrize("pos", [0, 255, 256, 1000])
@pytest.mark.parametrize("qtype", [Q4, Q5, Q8])
def test_k10_plain_matches_reference_bf16_cache(qtype, pos):
    """K10's plain version against `dia_megastep_reference` on a bf16 cache
    of 1024 rows, at positions on both sides of the 256-row pages and past
    the third, every qtype, bucket 256 with a 768-row tail. The port rounds
    the current token's k / v to bf16 in cache row pos before it attends
    it, the reference attends them in f32: within the file's 1e-2. Row pos
    holds k_new / v_new in bf16 and no other row changes."""
    cfg = tiny_cfg(tc=1024)
    mega, pmega, qt = mega_pair(cfg, qtype)
    ck, cv = fake_cross(cfg, 200)
    jck, jcv, jvt, jnt = jdm.prep_dia_cross(jnp.asarray(ck), jnp.asarray(cv), 200)
    rng = np.random.default_rng(pos)
    L, nkv, d, ctx = cfg.n_decoder_layers, cfg.n_kv_heads, cfg.head_size, 1024
    kvk, kvv = (jnp.asarray(rng.standard_normal((L, 2, nkv, ctx, d)) * 0.5,
                            jnp.bfloat16) for _ in range(2))
    x = rng.standard_normal((2, cfg.decoder_hidden_size)).astype(np.float32)
    kw = dict(qtype=qt, n_heads=cfg.decoder_attn_heads, n_kv=nkv)
    want = jdm.dia_megastep_reference(mega, jnp.asarray(x), kvk, kvv,
                                      jnp.int32(pos), jck, jcv, jvt, jnt, **kw)
    tk, tv = _t(kvk), _t(kvv)
    got = pdm.dia_megastep(pmega, torch.from_numpy(x), tk, tv, pos, _t(jck),
                           _t(jcv), _t(jvt), jnt, **kw)
    assert jnt == 768 and tk.dtype == torch.bfloat16
    for g, w_ in zip(got, want):
        assert rel_err(g, w_) < 1e-2, rel_err(g, w_)
    assert torch.equal(tk[:, :, :, pos].reshape(L, 2, -1),
                       got[1].to(torch.bfloat16))
    assert torch.equal(tv[:, :, :, pos].reshape(L, 2, -1),
                       got[2].to(torch.bfloat16))
    rows = torch.arange(ctx) != pos
    assert torch.equal(tk[:, :, :, rows], _t(kvk)[:, :, :, rows])
    assert torch.equal(tv[:, :, :, rows], _t(kvv)[:, :, :, rows])


def test_cross_tail_fold_matches_full_window():
    """The bucket plus the analytic tail equals attention over the whole
    padded window, in float32 (no bf16 rounding of the rows): 1e-5."""
    cfg = tiny_cfg(tc=1024)
    ck, cv = fake_cross(cfg, 100)
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    full_k = torch.from_numpy(ck[0]).reshape(2, 4, 1024, 64)
    full_v = torch.from_numpy(cv[0]).reshape(2, 4, 1024, 64)
    for scale in (0.1, 3.0):   # logits below and above the tail's 0
        want = pdm.cross_attention_plain(q * scale, full_k, full_v, None, 0)
        for sb in (128, 512):
            got = pdm.cross_attention_plain(
                q * scale, full_k[:, :, :sb], full_v[:, :, :sb],
                full_v[:, :, sb:].sum(dim=2), 1024 - sb)
            assert rel_err(got, want) < 1e-5, (scale, sb)


def test_k10_tail_fold_matches_full_window_step():
    """A whole K10 step with the bucketed cross K/V and its tail against
    the same step over the whole window (Sb == Tc, no tail), as
    test_dia_megastep.py's test_cross_tail_fold_exact holds the JAX
    version: the tail's V rows are summed in f32 but read as bf16 rows by
    the full window, so 2e-2."""
    cfg = tiny_cfg(tc=256)
    _, pmega, qt = mega_pair(cfg, Q4)
    ck, cv = (torch.from_numpy(a) for a in fake_cross(cfg, 11))
    full = pdm.prep_dia_cross(ck, cv, 256, buckets=(256,))
    part = pdm.prep_dia_cross(ck, cv, 11, buckets=(128, 256))
    assert full[3] == 0 and part[3] == 128
    L, nkv, d = cfg.n_decoder_layers, cfg.n_kv_heads, cfg.head_size
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 256)).astype(np.float32))
    kw = dict(qtype=qt, n_heads=cfg.decoder_attn_heads, n_kv=nkv)
    outs = [pdm.dia_megastep_plain(pmega, x, torch.zeros(L, 2, nkv, 8, d),
                                   torch.zeros(L, 2, nkv, 8, d), 0, *c, **kw)
            for c in (full, part)]
    assert rel_err(outs[1][0], outs[0][0]) < 2e-2


# pairs at positions on both sides of the 256-row page edges, one at 0
MIXED_POS = (0, 255, 256, 511)


def test_k11_plain_matches_reference_at_mixed_positions():
    """K11's plain version against `dia_megastep_batched_reference`, 4 pairs
    at mixed positions of a 512-row cache, each with its own cross K/V
    (bucket 256 of a 1024-row window, n_tail 768); and each pair equals K10's
    plain version on that pair's state bit for bit."""
    cfg = tiny_cfg(tc=1024)
    mega, pmega, qt = mega_pair(cfg, Q4)
    b, ctx = len(MIXED_POS), 512
    L, nkv, d, h = (cfg.n_decoder_layers, cfg.n_kv_heads, cfg.head_size,
                    cfg.decoder_attn_heads)
    ck, cv = fake_cross(cfg, 200, batch=(b,))
    packed = [jdm.prep_dia_cross(jnp.asarray(ck[:, s]), jnp.asarray(cv[:, s]),
                                 256, buckets=(256,)) for s in range(b)]
    jck, jcv = (jnp.stack([p[i].reshape(L, 2, h, 256, d) for p in packed], 1)
                for i in (0, 1))
    jvt = jnp.stack([p[2].reshape(L, 2, h, d) for p in packed], 1)
    n_tail = packed[0][3]
    rng = np.random.default_rng(11)
    kvk = rng.standard_normal((L, b, 2, nkv, ctx, d)).astype(np.float32) * 0.5
    kvv = rng.standard_normal((L, b, 2, nkv, ctx, d)).astype(np.float32) * 0.5
    x = rng.standard_normal((2 * b, cfg.decoder_hidden_size)).astype(np.float32)
    pos = np.asarray(MIXED_POS, np.int32)
    kw = dict(qtype=qt, n_heads=h, n_kv=nkv)
    want = jdm.dia_megastep_batched_reference(
        mega, jnp.asarray(x), jnp.asarray(kvk), jnp.asarray(kvv),
        jnp.asarray(pos), jck, jcv, jvt, n_tail, **kw)
    tk, tv = torch.from_numpy(kvk.copy()), torch.from_numpy(kvv.copy())
    got = pdm.dia_megastep_batched(pmega, torch.from_numpy(x), tk, tv,
                                   torch.from_numpy(pos), _t(jck), _t(jcv),
                                   _t(jvt), n_tail, **kw)
    assert got[0].shape == (2 * b, 256) and got[1].shape == (L, 2 * b, nkv * d)
    for g, w_ in zip(got, want):
        assert rel_err(g, w_) < 1e-2
    for s, p in enumerate(MIXED_POS):
        k1, v1 = torch.from_numpy(kvk[:, s].copy()), torch.from_numpy(kvv[:, s].copy())
        one = pdm.dia_megastep_plain(
            pmega, torch.from_numpy(x[2 * s:2 * s + 2]), k1, v1, p,
            _t(jck)[:, s].flatten(1, 2), _t(jcv)[:, s].flatten(1, 2),
            _t(jvt)[:, s].flatten(1, 2), n_tail, **kw)
        assert torch.equal(got[0][2 * s:2 * s + 2], one[0])
        assert torch.equal(got[1][:, 2 * s:2 * s + 2], one[1])
        assert torch.equal(tk[:, s], k1) and torch.equal(tv[:, s], v1)


def test_cpu_tensors_take_the_plain_versions():
    """No launch path is taken for CPU tensors: the counters stay at zero
    and no library is loaded."""
    kernels = (pdm.KERNEL, pdm.KERNEL_BATCHED, pdm.CROSS, pdm.CROSS_BATCHED)
    before = [k.launches for k in kernels]
    cfg = tiny_cfg()
    _, pmega, qt = mega_pair(cfg, Q4)
    ck, cv = (torch.from_numpy(a) for a in fake_cross(cfg, 9))
    cross = pdm.prep_dia_cross(ck, cv, 9)
    L, nkv, d = cfg.n_decoder_layers, cfg.n_kv_heads, cfg.head_size
    kw = dict(qtype=qt, n_heads=cfg.decoder_attn_heads, n_kv=nkv)
    pdm.dia_megastep(pmega, torch.randn(2, 256), torch.zeros(L, 2, nkv, 8, d),
                     torch.zeros(L, 2, nkv, 8, d), 3, *cross, **kw)
    # the same cross K/V in two pairs, (L, B, 2, heads, ...)
    bc = [torch.stack([t.reshape(L, 2, 4, *t.shape[2:])] * 2, 1)
          for t in cross[:3]]
    pdm.dia_megastep_batched(pmega, torch.randn(4, 256),
                             torch.zeros(L, 2, 2, nkv, 8, d),
                             torch.zeros(L, 2, 2, nkv, 8, d),
                             torch.tensor([0, 7], dtype=torch.int32), *bc,
                             cross[3], **kw)
    assert [k.launches for k in kernels] == before
    assert all(k._fn is None for k in kernels)
