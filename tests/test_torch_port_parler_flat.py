"""PyTorch port: kernel K12 (ops/parler_flat.py, the one-launch Parler
decode step) against the JAX package, on the CPU, at the
`tests/test_parler_flat.py` tiny shapes (L=2, H=256, 4 heads, F=512,
CTX=256, Tc=24), weights made from a numpy seed by `bench.build_q4_parler`
and carried across with `parler_weights_from_numpy`.

On CPU tensors the port's `parler_flat_megastep` runs its plain version;
the JAX side runs `parler_megastep_reference` (the spec) and its Pallas
`parler_flat_megastep` in interpret mode, as tests/test_parler_flat.py does.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import _BenchTok, build_q4_parler
from test_torch_port_megastep import jax_fields
from test_torch_port_parler import tpu_numerics  # noqa: F401 (fixture)
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.models.parler.model import ParlerRunner as JaxRunner
from tts_tpu.models.parler.model import maybe_prep_parler_flat as jax_prep_flat
from tts_tpu.ops.parler_flat import parler_flat_megastep as jax_flat_megastep
from tts_tpu.ops.parler_flat import prep_parler_flat as jax_prep_parler_flat
from tts_tpu.ops.parler_megastep import parler_megastep_reference
from tts_tpu.ops.parler_megastep import prep_mega_layers as jax_prep_mega
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.parler import model as pmodel
from tts_tpu_torch.models.parler.convert import parler_weights_from_numpy
from tts_tpu_torch.ops import parler_flat as pf
from tts_tpu_torch.ops.parler_megastep import prep_mega_layers


def tiny(seed=11, **kw):
    """tests/test_parler_flat.py's tiny model from a numpy seed: the JAX
    config and weights, and the port's config and weights on the CPU."""
    args = dict(n_layers=2, hidden=256, heads=4, ffn=512, enc_len=24,
                max_ctx=256)
    args.update(kw)
    jcfg, jw = build_q4_parler(np.random.default_rng(seed), **args)
    jcfg.max_generation_size = 48
    cfg = pmodel.ParlerConfig(**dataclasses.asdict(jcfg))
    return jcfg, jw, cfg, parler_weights_from_numpy(jax_fields(jw), device="cpu")


@pytest.fixture(scope="module")
def flats():
    jcfg, jw, cfg, pw = tiny()
    jmega, qtype = jax_prep_mega(jw.layers)
    pmega, pq = prep_mega_layers(pw.layers)
    assert pq == qtype
    return jcfg, jmega, pmega, qtype


@pytest.mark.parametrize("use_cross", [True, False])
@pytest.mark.parametrize("pos", [1, 41, 200])
def test_plain_vs_reference_and_pallas(flats, pos, use_cross):
    """(1) against `parler_megastep_reference`, 5e-4 of the largest value:
    the same bf16 roundings with f32 sums in another order (the bar and
    reasoning of tests/test_torch_port_megastep.py); (2) against the JAX
    Pallas K12 in interpret mode, 2e-2 relative (tests/test_parler_flat.py's
    bar: its tiles sum in yet another order); (3) the step wrote this
    token's k/v into cache row pos and touched no other row."""
    jcfg, jmega, pmega, qtype = flats
    L, H, heads, d = (jcfg.n_layers, jcfg.hidden_size, jcfg.n_attn_heads,
                      jcfg.head_size)
    ctx = jcfg.max_ctx_length
    rng = np.random.default_rng(pos)
    kv = rng.standard_normal((2, L, heads, ctx, d)).astype(np.float32) * 0.3
    x = rng.standard_normal((1, H)).astype(np.float32) * 0.5
    ref = [np.asarray(a) for a in parler_megastep_reference(
        jmega, jnp.asarray(x), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
        jnp.int32(pos), qtype=qtype, use_cross=use_cross, n_heads=heads)]
    jflat = jax_prep_parler_flat(jmega, qtype, ctx, use_cross=use_cross)
    pallas = [np.asarray(a) for a in jax_flat_megastep(
        jflat, jnp.asarray(x), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
        jnp.int32(pos), qtype=qtype, n_heads=heads, interpret=True)]
    flat = pf.prep_parler_flat(pmega, qtype, ctx, use_cross=use_cross)
    kk, vv = torch.from_numpy(kv[0].copy()), torch.from_numpy(kv[1].copy())
    got = [a.numpy() for a in pf.parler_flat_megastep(
        flat, torch.from_numpy(x), kk, vv,
        torch.tensor([pos], dtype=torch.int32), qtype=qtype, n_heads=heads)]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-4 * np.abs(b).max())
    for a, b in zip(got, pallas):
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 2e-2
    np.testing.assert_array_equal(kk.numpy()[:, :, pos].reshape(L, H), got[1])
    np.testing.assert_array_equal(vv.numpy()[:, :, pos].reshape(L, H), got[2])
    keep = np.arange(ctx) != pos
    np.testing.assert_array_equal(kk.numpy()[:, :, keep], kv[0][:, :, keep])
    np.testing.assert_array_equal(vv.numpy()[:, :, keep], kv[1][:, :, keep])


def test_prep_takes_qualifying_weights_and_refuses_other_shapes(monkeypatch):
    """A ParlerFlat on Parler-shaped weights (heads of 64) through both
    packages' preps (the JAX one with TTS_TPU_MEGAKERNEL=1, its CPU gate);
    heads of 128 (H 256, 2 heads) pass the megastep gate but not K12's, and
    `maybe_prep_parler_flat` then gives K2's Mega. Unquantized weights give
    None (per matmul)."""
    monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "1")
    jcfg, jw, cfg, pw = tiny()
    flat = pmodel.maybe_prep_parler_flat(cfg, pw)
    assert isinstance(flat, pf.ParlerFlat)
    assert (flat.use_cross, flat.n_heads, flat.ctx) == (True, 4, 256)
    jflat, _ = jax_prep_flat(jcfg, jw)
    assert type(jflat).__name__ == "ParlerFlatMega"
    mega = pmodel.maybe_prep_mega(cfg, pw)
    assert flat.qtype == mega.qtype
    assert all(torch.equal(a, b) for a, b in zip(flat.layers, mega.layers))
    _, _, cfg2, pw2 = tiny(heads=2)
    assert cfg2.head_size == 128
    other = pmodel.maybe_prep_parler_flat(cfg2, pw2)
    assert isinstance(other, pmodel.Mega)
    with pytest.raises(ValueError):
        pf.prep_parler_flat(other.layers, other.qtype, cfg2.max_ctx_length)
    dense = pw._replace(layers=pw.layers._replace(q_w=torch.zeros(256, 256)))
    assert pmodel.maybe_prep_parler_flat(cfg, dense) is None


def _runners(monkeypatch):
    monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "1")
    jcfg, jw, cfg, pw = tiny()
    tok = _BenchTok()
    jr = JaxRunner(jcfg, jw, tok)
    pr = pmodel.ParlerRunner(cfg, pw, tok)
    pr.mega = pmodel.maybe_prep_parler_flat(cfg, pr.weights)
    assert isinstance(pr.mega, pf.ParlerFlat)
    return jr, pr


def test_runner_on_the_k12_route_matches_jax(monkeypatch, tpu_numerics):  # noqa: F811
    """The port's runner on the K12 route (runner.mega assigned, as
    tests/test_parler_flat.py does for the JAX runner) gives the JAX
    runner's greedy codes on its phase route exactly; against the JAX
    runner on its flat route (the Pallas kernel in interpret mode, whose
    tiles sum in another order) at least 90% of the codes agree, the bar of
    tests/test_parler_flat.py."""
    jr, pr = _runners(monkeypatch)
    text = "hello flat"
    assert jr._mega is not None and type(jr._mega).__name__ != "ParlerFlatMega"
    phase = jr.generate_codes(text, JConfig(sample=False))
    got = pr.generate_codes(text, GenerationConfig(sample=False))
    assert got.shape[0] > 0
    np.testing.assert_array_equal(got, phase)
    jr._mega, jr._mega_qtype = jax_prep_flat(jr.cfg, jr.weights)
    assert type(jr._mega).__name__ == "ParlerFlatMega"
    flat = jr.generate_codes(text, JConfig(sample=False))
    n = min(flat.shape[0], got.shape[0])
    assert n > 0 and (flat[:n] == got[:n]).mean() > 0.9


def test_mismatched_use_cross_takes_the_per_matmul_path(monkeypatch):
    """A ParlerFlat prepared without the cross block, asked for a step with
    it, runs the per-matmul path (as the JAX decode body does), giving the
    per-matmul logits exactly; K12's entry is never called."""
    jcfg, jw, cfg, pw = tiny()
    mega = pmodel.maybe_prep_mega(cfg, pw)
    flat = pf.prep_parler_flat(mega.layers, mega.qtype, cfg.max_ctx_length,
                               use_cross=False)

    def refuse(*a, **k):
        raise AssertionError("K12 taken with a mismatched use_cross")

    shape = (cfg.n_layers, cfg.n_attn_heads, cfg.max_ctx_length, cfg.head_size)
    logits = []
    for m in (flat, None):
        st = pmodel.init_state(cfg, 5, torch.zeros(shape), torch.zeros(shape))
        with monkeypatch.context() as mp:
            mp.setattr(pmodel, "parler_flat_megastep", refuse)
            logits.append(pmodel.step_logits(cfg, pw, st, use_cross=True, mega=m))
    assert torch.equal(logits[0], logits[1])
    # and with the matching use_cross the flat route runs K12's entry
    calls = []

    def count(*a, **k):
        calls.append(1)
        return pf.parler_flat_megastep(*a, **k)

    monkeypatch.setattr(pmodel, "parler_flat_megastep", count)
    st = pmodel.init_state(cfg, 5, torch.zeros(shape), torch.zeros(shape))
    pmodel.step_logits(cfg, pw, st, use_cross=False, mega=flat)
    assert calls == [1]
