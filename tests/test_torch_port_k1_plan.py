"""PyTorch port: K1's host-side plan and the numerics its tensor-core design
rests on, on the CPU.

The plan (`k1_plan`: tiles and the K split over a cluster) must not depend
on M, since the order of an output's sums follows it; the ring's depth
(`k1_unit`, `k1_stages`) may, and must fit the card's shared memory at
every M. The
f32 mode runs three bf16 products against the exact codes: the three bf16
parts of an activation carry its 24 bits, which an emulation of the
kernel's arithmetic checks against the JAX package's reference.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_tpu.ops import quant_matmul as jqm
from tts_tpu.ops.parler_megastep import _qdot_ref
from tts_tpu_torch.gguf import quants
from tts_tpu_torch.ops import quant_matmul as qm

QTYPES = [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0, quants.GGML_TYPE_Q8_0]
SMEM_LIMIT = 227 * 1024   # csrc/quant_matmul.cu
# (N, K) of the main paths' K1 calls: Parler-Mini's heads and layers,
# Dia-1.6B's heads, encoder and cross K/V, Orpheus-3B's layers and head
MAIN_SHAPES = [(11520, 1024), (11520, 2048), (1024, 1024), (4096, 1024),
               (1024, 4096), (3072, 1024), (2048, 2048), (8192, 2048),
               (2048, 8192), (3072, 3072), (1024, 3072), (8192, 3072),
               (3072, 8192), (157184, 3072), (512, 1024), (4096, 2048)]


def test_k1_plan_takes_no_rows():
    """The plan's arguments are N, K and the SM count: M cannot reach it."""
    assert list(inspect.signature(qm.k1_plan).parameters) == ["n", "k", "sms"]


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("n,k", MAIN_SHAPES + [(1, 64), (65, 128), (200, 4096)])
def test_k1_plan_splits(n, k, sms):
    """Tiles of 64 features cover N; the K split is 1, 2, 4 or 8 ranks,
    each a whole number of 64-element stages and at least 256 elements
    when split, and is doubled only while the blocks are fewer than the
    SMs."""
    tiles, ks = qm.k1_plan(n, k, sms)
    assert tiles == -(-n // 64) and ks in (1, 2, 4, 8)
    assert k % (64 * ks) == 0
    if ks > 1:
        assert k // ks >= qm.MIN_SPLIT_K and tiles * (ks // 2) < sms
    can_double = (ks < 8 and k % (128 * ks) == 0 and k // (2 * ks) >= 256)
    assert tiles * ks >= sms or not can_double


def test_k1_plan_at_the_heads():
    """The LM heads at 132 SMs: 180 tiles, no split; the Orpheus head's
    2456 tiles neither; Parler's 1024-feature projections over K 4096 take
    8 ranks, its 4096-feature ones over K 1024 4."""
    assert qm.k1_plan(11520, 1024, 132) == (180, 1)
    assert qm.k1_plan(11520, 2048, 132) == (180, 1)
    assert qm.k1_plan(157184, 3072, 132) == (2456, 1)
    assert qm.k1_plan(1024, 4096, 132) == (16, 8)
    assert qm.k1_plan(4096, 1024, 132) == (64, 4)


@pytest.mark.parametrize("k", [32, 96, 1000])
def test_k1_plan_refuses_k(k):
    with pytest.raises(ValueError):
        qm.k1_plan(128, k, 132)


def test_k1_unit():
    """A stage takes 8 blocks of a row (a 128-byte line of packed codes)
    up to 16 rows, 4 up to 32, else 2, and 2 where a rank's K does not
    divide."""
    assert [qm.k1_unit(m, 1024) for m in (1, 16, 17, 32, 33, 256)] == \
        [8, 8, 4, 4, 2, 2]
    assert qm.k1_unit(1, 320) == 2 and qm.k1_unit(20, 384) == 4
    assert qm.k1_unit(8, 128) == 2


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_k1_ring_fits_at_every_m(packed, bf16):
    """2-12 stages at every M from 1 to 256 and every stage width, within
    the card's shared memory with the K split's sums; the heads' rows (up
    to 16, bf16) keep at least 4 stages of whole lines in flight."""
    for m in range(1, qm.MAX_KERNEL_M + 1):
        for kr in (256, 320, 512, 1024, 3072):
            ub = qm.k1_unit(m, kr)
            st = qm.k1_stages(m, ub, packed, bf16)
            per = qm.k1_stage_bytes(m, ub, packed, bf16)
            red = 64 * ((m + 7) // 8 * 8 + 4) * 4
            assert 2 <= st <= 12 and per % 128 == 0
            assert max(st * per, red) <= SMEM_LIMIT, (m, kr)
            if bf16 and packed and m <= 16 and kr % 256 == 0:
                assert ub == 8 and st >= 4


def _split3(x: torch.Tensor):
    """The kernel's f32-mode activation parts (csrc/quant_matmul.cu
    stage_x_kernel): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
    mid), each remainder exact in f32."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def test_k1_f32_parts_carry_the_activation(rng):
    """hi + mid + lo equals x to within 2^-24 of |x| over eight decades."""
    x = torch.from_numpy((rng.standard_normal(20000) *
                          10.0 ** rng.uniform(-4, 4, 20000)).astype(np.float32))
    hi, mid, lo = _split3(x)
    back = hi.double() + mid.double() + lo.double()
    assert float(((back - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -24


def _emulate(x: torch.Tensor, w: qm.QuantTensor) -> torch.Tensor:
    """The kernel's arithmetic, in f64 where the tensor cores' sums are
    exact: f32 mode sums each 32-weight block's products of the exact codes
    with the three parts, applies the block's scale and adds the blocks in
    f32; bf16 mode sums bf16(weight) * bf16(x) per block in f32."""
    codes = qm.unpack_codes(w.codes) if w.is_packed else w.codes
    c = (codes.double() - qm.BIAS[w.qtype])               # (N, K), exact
    n, k = c.shape
    if w.scales.dtype == torch.bfloat16:
        wd = (c * w.scales.double().repeat_interleave(32, -1)).to(torch.bfloat16)
        prod = x.to(torch.bfloat16).double()[:, None, :] * wd.double()[None]
        per_block = prod.reshape(x.shape[0], n, k // 32, 32).sum(-1).float()
        return per_block.sum(-1)
    parts = sum(p.double() for p in _split3(x))
    prod = parts[:, None, :] * c[None]
    per_block = prod.reshape(x.shape[0], n, k // 32, 32).sum(-1).float()
    return (per_block * w.scales.float()[None]).sum(-1)


@pytest.mark.parametrize("qtype", QTYPES)
def test_k1_f32_mode_emulated_vs_xla(rng, qtype):
    """Three bf16 passes against the exact codes give the JAX package's
    exact-f32 product (quant_matmul_xla) within 1e-5 of the largest
    output, the tolerance chip_smoke holds the kernel to."""
    n, k = 48, 1024
    raw = quants.quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.02,
                          qtype)
    codes, scales = quants.unpack_planar(raw, qtype, (n, k))
    jt = jqm.QuantTensor.from_planar(codes, scales, qtype)
    pt = qm.QuantTensor.from_planar(codes, scales, qtype, "cpu")
    x = rng.standard_normal((5, k)).astype(np.float32)
    ref = np.asarray(jqm.quant_matmul_xla(jnp.asarray(x), jt.codes_t,
                                          jt.scales_t, qtype))
    got = _emulate(torch.from_numpy(x), pt).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("qtype", QTYPES)
def test_k1_bf16_mode_emulated_vs_qdot_ref(rng, qtype):
    """bf16 mode is one bf16 product with f32 sums: the JAX megastep's
    `_qdot_ref` within 1e-5 of the largest output."""
    n, k = 48, 1024
    raw = quants.quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.02,
                          qtype)
    codes, scales = quants.unpack_planar(raw, qtype, (n, k))
    jt = jqm.QuantTensor.from_planar(codes, scales, qtype)
    pt = qm.QuantTensor.from_planar(codes, scales, qtype, "cpu")
    pt = qm.QuantTensor(pt.codes, pt.scales.to(torch.bfloat16), qtype)
    x = rng.standard_normal((3, k)).astype(np.float32)
    ref = np.asarray(_qdot_ref(jnp.asarray(x), jt.codes_t,
                               jt.scales_t.astype(jnp.bfloat16), jqm._BIAS[qtype]))
    got = _emulate(torch.from_numpy(x), pt).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_k1_cpu_runs_plain_and_counts_nothing(rng):
    """A CPU tensor runs the plain version: no launch, no shape tallied."""
    raw = quants.quantize(rng.standard_normal((64, 256)).astype(np.float32) * 0.02,
                          quants.GGML_TYPE_Q4_0)
    codes, scales = quants.unpack_planar(raw, quants.GGML_TYPE_Q4_0, (64, 256))
    w = qm.QuantTensor.from_planar(codes, scales, quants.GGML_TYPE_Q4_0, "cpu").pack()
    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    n0, tally = qm.KERNEL.launches, dict(qm.SHAPES)
    assert torch.equal(qm.quant_matmul(x, w), qm.quant_matmul_plain(x, w))
    assert qm.KERNEL.launches == n0 and dict(qm.SHAPES) == tally
