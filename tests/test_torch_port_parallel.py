"""PyTorch port: the sequence-parallel DAC decode, the serving mesh and the
dp x tp batched Parler chunk (tts_tpu_torch/parallel), on 4 CPU ranks over
gloo; and the DAC's `valid` masking that the sequence-parallel decode rests
on, against the JAX package's."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_e2e_parler import make_tiny_parler_gguf
from test_torch_port_megastep import jax_fields
from torch_tp_common import on_ranks
from tts_tpu.gguf import GGUFReader as JReader
from tts_tpu.models.codec import dac as jdac
from tts_tpu.runtime import batched_parler as jbp
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.gguf import GGUFReader
from tts_tpu_torch.models.codec import dac
from tts_tpu_torch.models.parler.convert import parler_weights_from_numpy
from tts_tpu_torch.models.parler.model import ParlerConfig
from tts_tpu_torch.runtime import batched_parler as pbp


@pytest.fixture(scope="module")
def tiny_dac_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dac") / "parler-tiny.gguf")
    make_tiny_parler_gguf(path, np.random.default_rng(0))
    return path


@pytest.mark.parametrize("t,pad", [(13, 51), (70, 58)])
def test_dac_valid_masks_the_padding(tiny_dac_path, t, pad):
    """A decode of t frames padded to t + pad with `valid` = t equals the
    exact-length decode bit for bit on its first t frames, and the JAX
    dac_decode(..., valid=t) on the same padded codes within
    test_torch_port_dac.py's bound (1e-3 absolute after the final tanh)."""
    r, jr = GGUFReader(tiny_dac_path), JReader(tiny_dac_path)
    cfg = dac.DACConfig.from_gguf(r)
    w = dac.load_dac_weights(r, cfg, device="cpu")
    jcfg = jdac.DACConfig.from_gguf(jr)
    jw = jdac.load_dac_weights(jr, jcfg)
    codes = np.random.default_rng(t).integers(0, 10, (t + pad, 3))
    exact = dac.dac_decode(cfg, w, torch.from_numpy(codes[:t]))
    padded = dac.dac_decode(cfg, w, torch.from_numpy(codes), valid=t)
    up = cfg.up_sampling_factor
    np.testing.assert_array_max_ulp(padded[:t * up].numpy(), exact.numpy(), 1)
    ref = np.asarray(jdac.dac_decode(jcfg, jw, jnp.asarray(codes, jnp.int32),
                                     valid=jnp.int32(t)))
    np.testing.assert_allclose(padded.numpy(), ref, rtol=0, atol=1e-3)
    unmasked = dac.dac_decode(cfg, w, torch.from_numpy(codes))
    assert not torch.equal(unmasked[:t * up], exact)   # the mask matters


def test_sharded_dac_decode_exact(tiny_dac_path, tmp_path):
    """Frames over 2 and 4 ranks with a halo of 24 (the tiny strides 4, 2
    give a larger receptive field in frames than the real 512x model): bit
    for bit the unsharded decode, on every rank."""
    r = GGUFReader(tiny_dac_path)
    cfg = dac.DACConfig.from_gguf(r)
    w = dac.load_dac_weights(r, cfg, device="cpu")
    codes = torch.from_numpy(np.random.default_rng(5).integers(0, 10, (50, 3)))
    full = dac.dac_decode(cfg, w, codes)
    outs = on_ranks(tmp_path, "dac_sp", dict(path=tiny_dac_path, codes=codes,
                                             margin=24))
    for rank, o in enumerate(outs):
        for n in (2, 4):
            assert o[n].shape == full.shape
            assert torch.equal(o[n], full), (rank, n)


def test_serving_mesh_is_host_major(tmp_path):
    """4 ranks on 2 hosts, placed alternately (ranks 0 and 2 on host 0):
    the (dp, tp) mesh's rows are hosts, tp the ranks of one host, and the
    slots split over ranks (the world) or over the dp rows."""
    envs = [dict(GROUP_RANK=str(r % 2), LOCAL_WORLD_SIZE="2") for r in range(4)]
    outs = on_ranks(tmp_path, "serving", {}, env=envs)
    for r, o in enumerate(outs):
        assert o["names"] == ("dp", "tp")
        assert o["mesh"] == [[0, 2], [1, 3]]
        assert o["world"] == list(range(10)[r * 2:(r + 1) * 2 if r < 3 else 10])
        assert o["dp"] == (list(range(5)) if r % 2 == 0 else list(range(5, 10)))


@pytest.fixture(scope="module")
def q4_parler():
    from bench import build_q4_parler
    jcfg, jw = build_q4_parler(np.random.default_rng(4), n_layers=2, hidden=256,
                               heads=8, ffn=512, enc_len=16, max_ctx=128)
    jcfg.max_generation_size = 64
    cfg = ParlerConfig(**dataclasses.asdict(jcfg))
    return cfg, parler_weights_from_numpy(jax_fields(jw), device="cpu")


@pytest.fixture(scope="module")
def dense_parler():
    """test_parallel.py's dp x tp model: dense f32 weights, vocab 32."""
    from __graft_entry__ import _tiny_parler
    jcfg, jw = _tiny_parler(dict(n_attn_heads=8, hidden_size=64,
                                 output_vocab_size=32, eos_token_id=10 ** 9,
                                 bos_token_id=31))
    cfg = ParlerConfig(**dataclasses.asdict(jcfg))
    return jcfg, jw, cfg, parler_weights_from_numpy(jax_fields(jw), device="cpu")


SLOTS = 8
MIXED = (3, 17, 40, 5, 60, 9, 33, 1)   # each slot's prompt length
SHARED = 4
STEPS = 6


def port_state(cfg, kv, positions):
    st = pbp.init_batched_state(cfg, SLOTS, "cpu")
    for s, p in enumerate(positions):
        st.kv_k[:, s] = torch.from_numpy(kv[0, :, s])
        st.kv_v[:, s] = torch.from_numpy(kv[1, :, s])
        pbp.insert_request(cfg, st, s, p, GenerationConfig(sample=False))
    return st


def cache(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, cfg.n_layers, SLOTS, cfg.n_attn_heads, cfg.max_ctx_length,
         cfg.head_size)).astype(np.float32) * 0.1


def test_dp_tp_chunk_token_exact(q4_parler, dense_parler, tmp_path):
    """The batched chunk over a 2 x 2 mesh (slots over dp, heads over tp),
    greedy: on Q4_0 weights (K1's plain version on each shard) with slots
    at mixed positions, tokens equal the port's unsharded chunk; on
    test_parallel.py's dense model with every slot at one position, they
    equal the JAX package's unsharded chunk (its own test holds its 2 x 4
    mesh to that). (Q4_0 against JAX is not a token-exact case: its stacked
    heads round activations to bf16, where an f32 ulp can flip a near tie.)"""
    cfg, w = q4_parler
    jcfg, jw, dcfg, dw = dense_parler
    cases = {"mixed": (cfg, w, port_state(cfg, cache(cfg, 6), MIXED)),
             "shared": (dcfg, dw, port_state(dcfg, cache(dcfg, 3),
                                              (SHARED,) * SLOTS))}
    want = {}
    for name, (c, ww, st) in cases.items():
        st2 = pbp.batched_decode_chunk(
            c, ww, pbp.BatchedParlerState(*[
                x.clone() if torch.is_tensor(x) else x for x in st]),
            STEPS, torch.Generator().manual_seed(0), use_cross=True)
        want[name] = st2.out_tokens[:, :STEPS]
    outs = on_ranks(tmp_path, "dp_tp", dict(cases=cases, steps=STEPS))
    for name in cases:
        for r, o in enumerate(outs):
            half = slice(0, 4) if r < 2 else slice(4, 8)   # rank = dp * 2 + tp
            assert torch.equal(o[name][:, :STEPS], want[name][half]), (name, r)
    kv = cache(dcfg, 3)
    jst = jbp.init_batched_state(jcfg, SLOTS, jax.random.PRNGKey(0))
    for s in range(SLOTS):
        jst = jbp.insert_request(jcfg, jst, s, jnp.asarray(kv[0, :, s]),
                                 jnp.asarray(kv[1, :, s]), SHARED, False, 1.0,
                                 0, 1.0, 1.0)
    jout = np.asarray(jbp.batched_decode_chunk(jcfg, jw, jst, n_steps=STEPS)
                      .out_tokens)[:, :STEPS]
    np.testing.assert_array_equal(want["shared"].numpy(), jout)
    got = torch.cat([outs[0]["shared"], outs[2]["shared"]])[:, :STEPS]
    np.testing.assert_array_equal(got.numpy(), jout)
