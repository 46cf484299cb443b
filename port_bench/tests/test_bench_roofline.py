"""The roofline arithmetic against hand counts at tiny shapes, and at the
cells' shapes against the bytes chip_smoke's bounds used (PERF.md)."""
import pytest

from port_bench import common
from port_bench import roofline as rl


def test_k1_call_by_hand():
    # x (2, 64) f32 @ W^T, W (64, 64) Q4_0 packed, bf16 scales:
    # 128 blocks of 16 code bytes + 2 scale bytes; x in, out 2 x 64 f32
    fl, by = rl.k1_call(2, 64, 64, 2, "bf16", True)
    assert fl == 2 * 2 * 64 * 64
    assert by == 128 * 18 + 4 * (2 * 64 + 2 * 64)
    assert rl.k1_call(2, 64, 64, 2, "f32", True)[1] == 128 * 20 + 1024


def test_gemv_and_attention_by_hand():
    fl, by = rl.gemv_step([(64, 32), (32, 64)], rows=3)
    assert fl == 2 * 3 * 64 * 32 * 2
    assert by == 2 * (64 * 18 + 4 * 3 * 96)
    # 1 query row, 2 heads over 1 kv head of 8, 5 cache rows of bf16
    fl, by = rl.attention(1, 2, 1, 8, 5)
    assert fl == 4 * 2 * 8 * 5
    assert by == 2 * 1 * 5 * 8 * 2 + 2 * 4 * 2 * 8


def test_bound_takes_the_larger():
    assert rl.bound_s(989e12, 0) == pytest.approx(1.0)
    assert rl.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert rl.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_tiny_steps_by_hand():
    cfg = {"hidden_size": 64, "ffn_dim": 128, "num_hidden_layers": 2,
           "num_attention_heads": 2, "description_rows": 4,
           "num_codebooks": 9, "vocab_size": 1088}
    fl, by = rl.parler_k5_step(cfg, 1)
    mats = [(64, 64)] * 6 + [(128, 64), (64, 128)]
    assert fl == 2 * 2 * sum(n * k for n, k in mats)
    # a slot at pos 3 (4 rows), heads of 32: self + cross (4 f32 rows)
    fl4, by4 = rl.parler_k4_step(cfg, [3])
    per = (4 * 2 * 32 * 4 + 4 * 2 * 32 * 4)
    assert fl4 == 2 * per
    # a layer: the self part's bf16 K and V (2 heads x 4 rows x 32 x 2 B
    # each) and its q and out (f32, 2 x 32 each), the cross part's q and
    # out, and the f32 cross K and V (2 heads x 4 rows x 32 x 4 B each)
    self_kv, q_out = 2 * (2 * 4 * 32 * 2), 2 * (2 * 32 * 4)
    cross_kv = 2 * (2 * 4 * 32 * 4)
    assert by4 == 2 * (self_kv + q_out + q_out + cross_kv)


def test_cells_shapes_match_chip_smoke_bounds():
    """PERF.md §6 'bounds' bytes': K10 701.2 MB of weights (norms
    included there, 0.5 MB) + 73.8 of K / V at pos 1000 + 75.8 of the
    256-row cross bucket; K1's Parler heads 6.68; Parler's K / V at pos
    1000 98.4; K2's 211.4 = the weights + 12.6 MB of f32 cross K / V +
    0.6 of norms."""
    d = common.load_json(common.BENCH_DIR / "configs/dia-1.6b.json")
    p = common.load_json(common.BENCH_DIR / "configs/parler-tts-mini-v1.json")
    w = sum(rl.block_bytes(n, k) for n, k in rl.dia_mats(d)) * 18
    assert w / 1e6 == pytest.approx(701.2 - 0.5, abs=0.1)
    kv = 18 * 2 * 4 * 128 * 2 * 2 * 1001
    assert kv / 1e6 == pytest.approx(73.8, abs=0.05)
    cross = rl.dia_attn_step(d, [0], [256])[1] - \
        rl.dia_attn_step(d, [0], [0])[1]
    assert cross / 1e6 == pytest.approx(75.5, abs=0.05)   # + 0.3 of V sums
    assert rl.k1_call(1, 9 * 1280, 1024, 2, "bf16", True)[1] / 1e6 == \
        pytest.approx(6.68, abs=0.01)
    pw = sum(rl.block_bytes(n, k) for n, k in rl.parler_mats(p)) * 24
    assert (pw + 24 * 16 * 64 * 64 * 4 * 2) / 1e6 == \
        pytest.approx(211.4 - 0.6, abs=0.1)
