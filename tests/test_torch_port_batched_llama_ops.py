"""PyTorch port: the batched Orpheus decode kernels K9 and K7 against the
JAX package, on the CPU.

K9's plain version against `llama_megastep_batched_reference` and K7's
against the TPU kernel `llama_flat_megastep_batched` in Pallas interpret
mode, 8 slots at mixed positions that straddle the attention pages with one
slot at pos 0 (the batched TPU kernels once rotated every slot by slot 0's
position, and lockstep tests could not see it). The engine that runs them
is tested in tests/test_torch_port_batched_llama.py.
"""
import numpy as np
import torch

import jax.numpy as jnp

from test_llama_megastep import tiny_q4_llama
from test_torch_port_batched_llama import one_torch_thread  # noqa: F401
from test_torch_port_llama_ops import (HEADS, KV, L, THETA, _close,  # noqa: F401
                                       tiny)
from test_torch_port_megastep import jax_fields
from tts_tpu.models.orpheus.model import _rms
from tts_tpu.ops.llama_flat import llama_flat_megastep_batched as jax_k7
from tts_tpu.ops.llama_flat import prep_llama_flat as jax_prep_flat
from tts_tpu.ops.llama_megastep import llama_megastep_batched_reference
from tts_tpu.ops.llama_megastep import prep_llama_mega as jax_prep_mega
from tts_tpu.ops.quant_matmul import quant_matmul_xla
from tts_tpu_torch.models.orpheus.convert import orpheus_weights_from_numpy
from tts_tpu_torch.ops.attention import rope_freqs
from tts_tpu_torch.ops.llama_flat import (llama_flat_megastep_batched,
                                          prep_llama_flat)
from tts_tpu_torch.ops.llama_megastep import (llama_megastep_batched,
                                              prep_llama_mega)

# slots straddling the 128- and 256-row pages, one at pos 0
MIXED = (3, 41, 127, 128, 129, 200, 255, 0)
CTX = 256


def _kv(rng, b, n_kv, d):
    kv = rng.standard_normal((2, L, b, n_kv, CTX, d)).astype(np.float32) * 0.3
    return kv[0], kv[1]


def test_k9_plain_vs_reference(tiny):
    """K9's plain version (K8's per slot) against the per-slot JAX reference,
    Q4_0 and Q8_0, 8 slots: 1e-2 of the largest value, PR 3's bound between
    these two functions (tests/test_torch_port_llama_ops.py `_close`: one
    flipped bf16 activation rounding spreads through the next
    projections). Each slot's row pos[s] is written, and no other row."""
    qtype, jw, jmega, pw, pmega, inv = tiny
    rng = np.random.default_rng(11)
    b, d = len(MIXED), 256 // HEADS
    kv_k, kv_v = _kv(rng, b, KV, d)
    x = rng.standard_normal((b, 256)).astype(np.float32) * 0.5
    pos = np.array(MIXED, np.int32)
    xo, kn, vn = (np.asarray(a) for a in llama_megastep_batched_reference(
        jmega, jnp.asarray(x), jnp.asarray(kv_k), jnp.asarray(kv_v),
        jnp.asarray(pos), qtype=qtype, n_heads=HEADS, n_kv=KV,
        rope_base=THETA, rope_freq_factors=jw.rope_freqs))
    kk, vv = torch.from_numpy(kv_k.copy()), torch.from_numpy(kv_v.copy())
    got = llama_megastep_batched(pmega, torch.from_numpy(x), kk, vv,
                                 torch.from_numpy(pos), qtype=qtype,
                                 n_heads=HEADS, n_kv=KV, inv_freq=inv)
    pxo, pkn, pvn = (a.numpy() for a in got)
    assert pxo.shape == (b, 256) and pkn.shape == pvn.shape == (L, b, KV * d)
    for s in range(b):
        for what, a, r in (("x_out", pxo[s], xo[s]), ("k_new", pkn[:, s], kn[:, s]),
                           ("v_new", pvn[:, s], vn[:, s])):
            _close(a, r, f"slot {s} (pos {MIXED[s]}) {what}")
        p = MIXED[s]
        np.testing.assert_array_equal(kk.numpy()[:, s, :, p].reshape(L, -1),
                                      pkn[:, s])
        np.testing.assert_array_equal(vv.numpy()[:, s, :, p].reshape(L, -1),
                                      pvn[:, s])
        keep = np.arange(CTX) != p
        np.testing.assert_array_equal(kk.numpy()[:, s, :, keep],
                                      kv_k[:, s, :, keep])


def test_k7_plain_vs_pallas_interpret():
    """K7's plain version against the TPU kernel in interpret mode at the
    setup of tests/test_llama_flat.py (2 q / 1 kv heads of 128, 8 slots,
    128-row pages): per slot, logits within 2e-2 of the largest (the JAX
    package's own bound: the TPU kernel rounds q, K/V and the softmax
    probabilities to bf16 for its page dots, the port keeps f32), k_new and
    v_new within 1e-2. Against the per-slot reference plus the head, 1e-2
    (PR 3's bound). The padded logits are exactly 0."""
    rng = np.random.default_rng(7)
    cfg, jw = tiny_q4_llama(rng, heads=2, kv=1, ctx=CTX)
    jmega, qtype = jax_prep_mega(jw.layers)
    jflat = jax_prep_flat(jmega, jw.head, jw.out_norm, qtype, cfg.vocab_size,
                          2, 1, CTX, mode="fullk", page=128)
    pw = orpheus_weights_from_numpy(jax_fields(jw), device="cpu")
    pmega, pq = prep_llama_mega(pw.layers, 128)
    pflat = prep_llama_flat(pmega, pw.head, pw.out_norm, pq, 2, 1)
    inv = rope_freqs(128, cfg.rope_theta, pw.rope_freqs)
    b, vocab = len(MIXED), cfg.vocab_size
    kv_k, kv_v = _kv(rng, b, 1, 128)
    x = rng.standard_normal((b, 256)).astype(np.float32) * 0.5
    pos = np.array(MIXED, np.int32)
    lg, kn, vn = (np.asarray(a) for a in jax_k7(
        jflat, jnp.asarray(x), jnp.asarray(kv_k), jnp.asarray(kv_v),
        jnp.asarray(pos), qtype=qtype, n_heads=2, n_kv=1,
        rope_base=cfg.rope_theta, rope_freq_factors=jw.rope_freqs,
        interpret=True))
    xo, kr, vr = llama_megastep_batched_reference(
        jmega, jnp.asarray(x), jnp.asarray(kv_k), jnp.asarray(kv_v),
        jnp.asarray(pos), qtype=qtype, n_heads=2, n_kv=1,
        rope_base=cfg.rope_theta, rope_freq_factors=jw.rope_freqs)
    lg_ref = np.asarray(quant_matmul_xla(_rms(xo, jw.out_norm), jw.head.codes_t,
                                         jw.head.scales_t, qtype))
    plg, pkn, pvn = (a.numpy() for a in llama_flat_megastep_batched(
        pflat, torch.from_numpy(x), torch.from_numpy(kv_k.copy()),
        torch.from_numpy(kv_v.copy()), torch.from_numpy(pos), qtype=qtype,
        n_heads=2, n_kv=1, inv_freq=inv))
    assert plg.shape == (b, 256)    # the 64-row head padded to 256 rows
    np.testing.assert_array_equal(plg[:, vocab:], 0.0)
    for s in range(b):
        want = lg[s, :vocab]
        np.testing.assert_allclose(plg[s, :vocab], want, rtol=0,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=f"slot {s} logits vs Pallas K7")
        _close(plg[s, :vocab], lg_ref[s], f"slot {s} logits vs reference")
        for what, a, r in (("k_new", pkn[:, s], kn[:, s]),
                           ("v_new", pvn[:, s], vn[:, s]),
                           ("k_new ref", pkn[:, s], np.asarray(kr)[:, s]),
                           ("v_new ref", pvn[:, s], np.asarray(vr)[:, s])):
            _close(a, r, f"slot {s} (pos {MIXED[s]}) {what}")
