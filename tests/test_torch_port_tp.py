"""PyTorch port: Megatron TP and the weight-gather mode for the quantized
Parler decode step (tts_tpu_torch/parallel/tp_megastep.py), on 4 CPU ranks
over gloo, against the JAX package's `parallel/tp_megastep.py` on the
conftest's 8-device CPU mesh, at `tests/test_tp_megastep.py::q4_setup`'s
inputs (bench.build_q4_parler, seed 3: L=2, H=256, 8 heads, F=512, Tc=32,
CTX=128). Also the gate that refuses K shards K1 cannot take, and the
distributed entry points' device rule."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_megastep import jax_fields
from torch_tp_common import on_ranks
from tts_tpu.ops.parler_megastep import prep_mega_layers as jax_prep_mega
from tts_tpu.parallel import tp_megastep as jtp
from tts_tpu.parallel.mesh import make_mesh as jax_mesh
from tts_tpu_torch.models.parler.convert import parler_weights_from_numpy
from tts_tpu_torch.ops.parler_megastep import (parler_megastep_plain,
                                               prep_mega_layers)
from tts_tpu_torch.parallel import distributed
from tts_tpu_torch.parallel.sharding import require_k_shards
from tts_tpu_torch.parallel.tp_megastep import prep_tp_layers

# Both packages compute the TP step in f32 from the same f32-scale weights
# (the JAX layout's quant_matmul at HIGHEST, the port's K1 plain version);
# only the order of partial sums differs (the all-reduce against psum), so
# 1e-4 of the output's peak (measured differences ~1e-6 of it).
TP_REL = 1e-4
# The gather mode runs K2's function (bf16-rounded weights and activations)
# on both sides: test_torch_port_megastep.py's bound, 5e-4 of the peak.
MEGA_REL = 5e-4


@pytest.fixture(scope="module")
def q4_setup():
    from bench import build_q4_parler
    rng = np.random.default_rng(3)
    cfg, w = build_q4_parler(rng, n_layers=2, hidden=256, heads=8, ffn=512,
                             enc_len=32, max_ctx=128)
    L, H, nh, d = (cfg.n_layers, cfg.hidden_size, cfg.n_attn_heads,
                   cfg.head_size)
    kv = rng.standard_normal((2, L, nh, 128, d)).astype(np.float32) * 0.3
    x = rng.standard_normal((1, H)).astype(np.float32) * 0.5
    pw = parler_weights_from_numpy(jax_fields(w), device="cpu")
    return cfg, w, pw, kv[0], kv[1], x


def close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def test_megatron_tp_matches_jax(q4_setup, tmp_path):
    """tp 2 and 4 at pos 41, and 4 steps at tp 4 with each step's k/v
    written into the cache (pos 40-43), against the JAX megastep_tp."""
    cfg, w, pw, kv_k, kv_v, x = q4_setup
    nh = cfg.n_attn_heads
    outs = on_ranks(tmp_path, "parler_tp", dict(
        layers=pw.layers, x=torch.from_numpy(x), kv_k=torch.from_numpy(kv_k),
        kv_v=torch.from_numpy(kv_v), pos=41, pos0=40, n_heads=nh))
    for tp in (2, 4):
        mesh = jax_mesh(tp=tp, dp=1)
        tpl, _ = jtp.prep_tp_layers(w.layers, tp)
        tpl = jtp.shard_tp_layers(tpl, mesh)
        want = jtp.megastep_tp(tpl, jnp.asarray(x), jnp.asarray(kv_k),
                               jnp.asarray(kv_v), jnp.int32(41), mesh=mesh,
                               qtype=2, use_cross=True, n_heads=nh)
        for r, o in enumerate(outs):
            for got, ref, what in zip(o[tp], want, ("x", "k_new", "v_new")):
                close(got, ref, TP_REL, f"tp {tp} rank {r} {what}")
        if tp == 4:
            L, d = cfg.n_layers, cfg.head_size
            kk, vv, xx = jnp.asarray(kv_k), jnp.asarray(kv_v), jnp.asarray(x)
            for s in range(4):
                xx, kn, vn = jtp.megastep_tp(
                    tpl, xx, kk, vv, jnp.int32(40 + s), mesh=mesh, qtype=2,
                    use_cross=True, n_heads=nh)
                upd = lambda c, n: jax.lax.dynamic_update_slice(  # noqa: E731
                    c, n.reshape(L, nh, 1, d), (0, 0, 40 + s, 0))
                kk, vv = upd(kk, kn), upd(vv, vn)
                for r, o in enumerate(outs):
                    close(o["steps"][s:s + 1], xx, TP_REL, f"step {s} rank {r}")


def test_weight_gather_bit_equal_to_unsharded(q4_setup, tmp_path):
    """The gather mode at tp 4: each rank holds a quarter of the tiled
    weights, and its step equals the port's unsharded step (the plain
    version of K2) bit for bit, cache writes included; against the JAX
    megastep_weight_gather within K2's port bound."""
    cfg, w, pw, kv_k, kv_v, x = q4_setup
    nh = cfg.n_attn_heads
    mega, qtype = prep_mega_layers(pw.layers)
    outs = on_ranks(tmp_path, "parler_gather", dict(
        mega=mega, qtype=qtype, x=torch.from_numpy(x), n_heads=nh,
        kv_k=torch.from_numpy(kv_k), kv_v=torch.from_numpy(kv_v), pos=77))
    kk, vv = torch.from_numpy(kv_k.copy()), torch.from_numpy(kv_v.copy())
    want = parler_megastep_plain(mega, torch.from_numpy(x), kk, vv, 77,
                                 qtype=qtype, use_cross=True, n_heads=nh)
    whole = sum(getattr(mega, f).numel() for f in
                ("qkv_codes", "occ_codes", "fc1_codes", "fc2_codes"))
    jmega, _ = jax_prep_mega(w.layers)
    mesh = jax_mesh(tp=4, dp=1)
    jwant = jtp.megastep_weight_gather(
        jtp.shard_mega_gather(jmega, mesh), jnp.asarray(x), jnp.asarray(kv_k),
        jnp.asarray(kv_v), jnp.int32(77), mesh=mesh, qtype=qtype,
        use_cross=True, n_heads=nh)
    for r, o in enumerate(outs):
        assert o["code_bytes"] * 4 == whole, r        # a quarter of the codes
        for got, ref in zip((o["x"], o["k"], o["v"], o["kv_k"], o["kv_v"]),
                            (*want, kk, vv)):
            assert torch.equal(got, ref), r
        for got, ref, what in zip((o["x"], o["k"], o["v"]), jwant,
                                  ("x", "k_new", "v_new")):
            close(got, ref, MEGA_REL, f"rank {r} {what} vs JAX")


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_k_shard_gate_refuses(q4_setup, tp):
    """On the card every K shard must be a multiple of 64 (K1's step); on
    the CPU whole 32-weight blocks. The refusal names the projection."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    require_k_shards({"o": (1024, True), "fc2": (4096, True)}, tp, cuda)
    with pytest.raises(ValueError, match="o's K shard"):
        require_k_shards({"o": (64 * tp + 32 * tp, True)}, tp, cuda)
    require_k_shards({"o": (64 * tp + 32 * tp, True)}, tp, cpu)
    with pytest.raises(ValueError, match="fc2's K shard"):
        require_k_shards({"fc2": (16 * tp, True)}, tp, cpu)
    with pytest.raises(ValueError, match="qkv's K shard"):
        require_k_shards({"qkv": (96, False)}, tp, cuda)
    # the prep asks the rule of the weights' device: whole blocks here (256
    # / 8 = 32 would be refused on the card), and tp must divide the heads
    prep_tp_layers(q4_setup[2].layers, tp)
    with pytest.raises(ValueError, match="divide"):
        prep_tp_layers(q4_setup[2].layers, 2 * 8)


def test_distributed_entry_points_need_a_card(monkeypatch):
    """init_distributed is a no-op without a world; with one it asks for
    the rank's card unless told device="cpu", and raises without it."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() is False
    assert distributed.init_distributed(world_size=1) is False
    assert distributed.host_slot_range(8) == range(8)
    assert distributed.group_rank_size() == (0, 1)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: there is nothing to refuse")
    with pytest.raises(RuntimeError, match="does not exist"):
        distributed.init_distributed("file:///nonexistent/rendezvous", 2, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.rank_device()
    with pytest.raises(RuntimeError, match="needs an initialized"):
        distributed.serving_mesh()
