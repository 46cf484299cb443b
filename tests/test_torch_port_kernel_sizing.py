"""PyTorch port: the host-side sizing of the decode kernels, on the CPU.

The decode attention's arrival counters (`decode_attention.arrivals`: one
zeroed buffer per device and stream, made once, which every launch leaves
zeroed) and the llama GEMV's launch shape as `ops/llama_megastep.py`
reckons it after csrc/gemv.cuh: the shared memory of every Orpheus and
Dia projection's launch, the weight ring's stages, the grid, that one
launch copies each weight once, and the L2 bytes its staging reads, which
for a batched Orpheus-3B step must stay below the weights it streams.
The Parler GEMV's shared memory (`ops/parler_megastep.py` after
csrc/parler_gemv.cuh) at Parler-Mini's widths. The persistent K10's plan
(`ops/dia_flat.py` after csrc/dia_flat.cu): each GEMV phase's (tile, K
range) items, its shared memory, scratch and attention items.
"""
import pytest
import torch

from tts_tpu_torch.ops import decode_attention as da
from tts_tpu_torch.ops import dia_flat as dfl
from tts_tpu_torch.ops import llama_megastep as lm
from tts_tpu_torch.ops import parler_megastep as pm


def test_arrivals_are_zeroed_shared_and_grow():
    a = da.arrivals("cpu", 10)
    assert a.dtype == torch.int32 and a.numel() >= da.MIN_ARRIVALS
    assert not a.any()
    assert da.arrivals(torch.device("cpu"), a.numel()) is a
    b = da.arrivals("cpu", a.numel() + 1)
    assert b.numel() >= 2 * a.numel() and not b.any()
    assert da.arrivals("cpu", 5) is b


# (name, output features or pairs, K, SiLU(gate) * up) of each GEMV launch of
# a decode step at Orpheus-3B width (28 layers of H 3072, 24 / 8 heads of
# 128, F 8192, the head padded to 157,184 rows) and Dia-1.6B's (H 2048, 16 /
# 4 heads of 128, F 8192; o, cross q and cross o are H x H)
ORPHEUS_GEMVS = (("qkv", 5120, 3072, False), ("o", 3072, 3072, False),
                 ("gate/up", 8192, 3072, True), ("down", 3072, 8192, False),
                 ("head", 157184, 3072, False))
DIA_GEMVS = (("qkv", 3072, 2048, False), ("o", 2048, 2048, False),
             ("gate/up", 8192, 2048, True), ("down", 2048, 8192, False))
GEMVS = [("orpheus",) + g for g in ORPHEUS_GEMVS] + \
    [("dia",) + g for g in DIA_GEMVS]


@pytest.mark.parametrize("b", [1, 2, 8, 16])
@pytest.mark.parametrize("model,name,n,k,silu", GEMVS)
def test_gemv_shared_memory_fits(model, name, n, k, silu, b):
    """Every Orpheus and Dia projection at 1, 2, 8 and 16 rows asks for no
    more dynamic shared memory than a block may have; up to 8 rows, and at
    16 up to K 4096, two blocks fit on one SM (each takes 1 KB more than it
    asks), so a launch's blocks fit beside the blocks of the launch before
    it (programmatic dependent launch). 16 rows x K 8192 (down) take one
    block an SM: 64 KB of rows, the ring and the slots of 3 other ranks."""
    smem = lm.gemv_smem_bytes(b, k)
    assert smem <= lm.GEMV_SMEM_LIMIT
    two = 2 * (smem + 1024) <= lm.GEMV_SM_SMEM
    assert two == (b <= 8 or k <= 4096)


@pytest.mark.parametrize("b,packed,scale_bf16,stages", [
    (1, True, True, 6), (8, True, True, 6), (9, True, True, 4),
    (16, True, True, 4), (1, True, False, 5), (16, True, False, 3),
    (1, False, True, 3), (16, False, False, 2)])
def test_gemv_ring_stages(b, packed, scale_bf16, stages):
    """A warp's ring holds about 7 KB of weights at one n-tile (1-8 rows)
    and 4.5 KB at two: 6 / 4 stages of 1,152 bytes for Q4_0 with bf16
    scales, fewer for f32 scales and one-byte codes, never under 2."""
    assert lm.gemv_ring_stages(b, packed, scale_bf16) == stages
    budget = 7168 if b <= 8 else 4608
    assert stages * lm.gemv_stage_bytes(packed, scale_bf16) <= max(
        budget, 2 * lm.gemv_stage_bytes(packed, scale_bf16))


@pytest.mark.parametrize("pairs,k,sms,clusters", [
    (1, 256, 132, 1), (32, 256, 132, 4), (500, 3072, 132, 63),
    (1536, 3072, 132, 66), (2560, 3072, 132, 66), (78592, 3072, 132, 132),
    (8192, 3072, 132, 66), (8448, 3072, 132, 132),
    (1536, 8192, 132, 33), (1024, 8192, 132, 33), (1000, 8192, 131, 32)])
def test_gemv_grid(pairs, k, sms, clusters):
    """Clusters of 2 blocks (4 past K 4096), one block per SM, two where the
    (tile, K range) items are at least twice the warps of one block an SM
    (Orpheus's head: 9,824 tiles; gate / up's 1,024 x 2 fall just short),
    no more clusters than 8-pair tiles."""
    assert lm.gemv_k_split(k) == (2 if k <= 4096 else 4)
    assert lm.gemv_clusters(pairs, k, sms) == clusters
    per_sm = lm.gemv_blocks_per_sm(pairs, k, sms)
    assert per_sm == (2 if -(-pairs // 8) * lm.gemv_k_split(k) >= 16 * sms else 1)
    assert clusters * lm.gemv_k_split(k) <= per_sm * sms


@pytest.mark.parametrize("model,name,n,k,silu", GEMVS + [
    ("ragged", "store", 1000, 256, False), ("ragged", "silu", 36, 512, True)])
def test_gemv_reads_each_weight_once(model, name, n, k, silu):
    """Every 32-weight block of every tile is copied exactly once by one
    launch on 132 SMs: the K ranges of a cluster's blocks and the tiles of
    its warps cover the weights without overlap (16 rows x K 8192 no
    longer stream the weights twice)."""
    pairs = n if silu else n // 2
    count = lm.gemv_schedule(pairs, k, 132)
    assert count.shape == (-(-pairs // 8), k // 32)
    assert (count == 1).all()


@pytest.mark.parametrize("b", [1, 8, 16])
def test_orpheus_step_staging_reckoning(b):
    """Orpheus-3B's batched step (28 layers of qkv, o, gate / up and down,
    then the 157,184-row head) on 132 SMs: each cluster reads each input
    row's f32 elements once, twice under an RMS prologue (66 clusters of 2,
    132 for the head's launch of two blocks an SM; 33 of 4 for down's K
    8192); up to 8 slots that stays under the step's Q4_0 weight bytes
    (0.5625 bytes a weight)."""
    H, F, kvn, L, vocab = 3072, 8192, 2048, 28, 157184
    gemvs = [(H + kvn, H, True, False), (H, H, False, False),
             (F, H, True, True), (H, F, False, False)] * L + \
        [(vocab, H, True, False)]
    staged = sum(lm.gemv_staging_bytes(b, n, k, rms=rms, silu=silu, sms=132)
                 for n, k, rms, silu in gemvs)
    weights = sum((2 * n if silu else n) * k for n, k, _, silu in gemvs) * 0.5625
    assert staged == b * 4 * (L * (66 * H * 2 + 66 * H + 66 * H * 2 + 33 * F)
                              + 132 * H * 2)
    assert (staged < weights) == (b <= 8)


@pytest.mark.parametrize("cb,scale_dtype", [(16, torch.bfloat16),
                                            (32, torch.float32)])
@pytest.mark.parametrize("kind,n,d", [("pairs", 1000, 0), ("rope", 512, 64),
                                      ("rope", 384, 128), ("silu", 36, 0)])
def test_gemv_tile_layout_and_roundtrip(kind, n, d, cb, scale_dtype):
    """The tiled layout the GEMV streams (lm.gemv_tile): tile t's stage s
    holds, block-major, the codes of blocks 4s..4s+3 of the tile's 16 rows
    (the "a" rows of pairs 8t..8t+7, then their "b" rows; zeros past the
    last pair) and their scales row-major; gemv_untile gives the rows back,
    gate and up apart for SiLU(gate) * up."""
    g = torch.Generator().manual_seed(0)
    k, L = 512, 2
    nb = k // 32

    def mat():
        return (torch.randint(0, 256, (L, n, nb * cb), generator=g,
                              dtype=torch.uint8),
                torch.rand((L, n, nb), generator=g).to(scale_dtype))

    (ca, sa), (cb_, sb) = mat(), mat()
    silu = kind == "silu"
    pairs = n if silu else n // 2
    ra, rb = lm.gemv_pair_rows(kind, pairs, d)
    if not silu:
        cb_, sb = ca, sa
    ct, st = lm.gemv_tile(ca, sa, ra, rb, codes_b=cb_, scales_b=sb)
    tiles = -(-pairs // 8)
    assert ct.shape == (L, tiles, k // 128, 64 * cb) and ct.dtype == ca.dtype
    assert st.shape == (L, tiles, k // 128, 64) and st.dtype == scale_dtype
    for t, s, j, rho in ((0, 0, 0, 0), (1, 3, 2, 9), (tiles - 1, 2, 3, 15),
                         (tiles - 1, 1, 1, 7), (tiles // 2, 0, 3, 12)):
        p = 8 * t + rho % 8
        got_c = ct[1, t, s, (16 * j + rho) * cb:(16 * j + rho + 1) * cb]
        got_s = st[1, t, s, 4 * rho + j]
        if p >= pairs:
            assert not got_c.any() and float(got_s) == 0.0
            continue
        src_c, src_s, rows = (ca, sa, ra) if rho < 8 else (cb_, sb, rb)
        blk = 4 * s + j
        assert torch.equal(got_c, src_c[1, rows[p], blk * cb:(blk + 1) * cb])
        assert torch.equal(got_s, src_s[1, rows[p], blk])
    back = lm.gemv_untile(ct, st, ra, rb, n, apart=silu)
    want = ((ca, sa), (cb_, sb)) if silu else (ca, sa)
    for a, b in zip(torch.utils._pytree.tree_leaves(back),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(torch.utils._pytree.tree_leaves(
            lm.weight_rows(ct, st, kind, n, d)),
            torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("k", [1024, 4096])
def test_parler_gemv_shared_memory_fits(k, b, packed):
    """Every Parler-Mini GEMV launch (K 1024: qkv, o, cq, co, fc1; K 4096:
    fc2) at 1, 8 and 16 rows, Q4_0 packed and one-byte codes, asks for no
    more dynamic shared memory than a block may have: the 8 warps' rings of
    4 stages (1152 / 2176 bytes), the partial sums, and the rows as bf16.
    Two blocks fit on one SM (each takes 1 KB more than it asks), so that
    the next launch's blocks start beside a launch's (programmatic
    dependent launch), except fc2's 16 rows, and its 8 rows of one-byte
    codes."""
    smem = pm.gemv_smem_bytes(b, k, packed)
    ring = 8 * 4 * (1152 if packed else 2176)
    assert smem == ring + 8 * (1 if b <= 8 else 2) * 512 + b * (k * 2 + 32)
    assert smem <= pm.GEMV_SMEM_LIMIT
    two = 2 * (smem + 1024) <= lm.GEMV_SM_SMEM
    assert two == (k == 1024 or b == 1 or (b == 8 and packed))


# (hidden, ffn, q heads, kv heads): Dia-1.6B's decoder and the tiny test
# width of tests/test_torch_port_cuda.py (_tiny_dia)
DIA_WIDTHS = {"dia": (2048, 8192, 16, 4), "tiny": (256, 512, 4, 2)}


@pytest.mark.parametrize("model,items,stages", [
    ("dia", dict(qkv=384, o=256, cq=256, co=256, gate_up=2048, down=512),
     dict(qkv=8, o=8, cq=8, co=8, gate_up=8, down=16)),
    ("tiny", dict(qkv=64, o=32, cq=32, co=32, gate_up=128, down=32),
     dict(qkv=1, o=1, cq=1, co=1, gate_up=1, down=2))])
def test_dia_flat_gemv_items(model, items, stages):
    """Each GEMV phase of a layer: its tiles of 8 pairs times k_split(K) K
    ranges (the launch sequence's cluster size: 2 at K 2048, 4 at K 8192),
    each range whole ring stages of 128 weights, covering K once."""
    phases = dfl.gemv_phases(*DIA_WIDTHS[model])
    assert [p.name for p in phases] == ["qkv", "o", "cq", "co", "gate_up", "down"]
    assert {p.name: p.items for p in phases} == items
    assert {p.name: p.stages for p in phases} == stages
    for p in phases:
        assert p.k_split == lm.gemv_k_split(p.k)
        assert p.items == p.tiles * p.k_split
        assert p.stages * p.k_split * lm.GEMV_UNIT_K == p.k


@pytest.mark.parametrize("grid,busy", [(132, dict(qkv=384, o=256, gate_up=1056,
                                                  down=512)),
                                       (264, dict(qkv=384, o=256, gate_up=2048,
                                                  down=512))])
def test_dia_flat_warps_with_items(grid, busy):
    """At Dia-1.6B width on 132 SMs (one or two blocks an SM): the warps
    that hold an item in each phase; o / cq / co leave most of the 1,056
    or 2,112 warps idle."""
    phases = {p.name: p for p in dfl.gemv_phases(*DIA_WIDTHS["dia"])}
    for name, n in busy.items():
        assert dfl.warps_with_items(phases[name], grid) == n


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("hidden,ffn", [(2048, 2048), (2048, 8192), (256, 512)])
def test_dia_flat_shared_memory_fits(hidden, ffn, packed):
    """A block's dynamic shared memory for the pair at K 2048 and K 8192:
    8 warps' rings of 8 stages (a whole item at K 2048: 1,152 bytes a
    Q4_0 stage, 2,176 of one-byte codes), the two buffers of range sums,
    the f32 rows and norm weights of an RMS prologue, and the two rows
    staged as bf16 at the larger K; within the 227 KB a block may have,
    with room for the attention's static shared memory (under 10 KB). One
    block an SM: 136 KB at Dia-1.6B width in Q4_0, 200 KB in Q8_0."""
    smem = dfl.smem_bytes(hidden, ffn, packed)
    ring = 8 * 8 * (1152 if packed else 2176)
    k = max(hidden, ffn)
    assert dfl.RING_STAGES * lm.GEMV_UNIT_K * lm.gemv_k_split(2048) == 2048
    assert smem == ring + 2 * 8 * 32 * 16 + 3 * hidden * 4 + 2 * (2 * k + 32)
    assert smem + 10 * 1024 <= dfl.SMEM_LIMIT
    if (hidden, ffn) == (2048, 8192):
        assert smem == (139328 if packed else 204864)
        assert 2 * (smem + 1024) > lm.GEMV_SM_SMEM


def test_dia_flat_scratch_and_attention_items():
    """Scratch floats (attention output, cross q, SiLU output, page
    partials over the larger of ctx and the bucket) and words (an arrival
    counter per row and head, the barrier's two); the attention's page
    items: self-attention 2 q heads a block (n_rep 4 or 2) over the pages
    up to pos, cross-attention one head a block over the bucket's pages."""
    assert dfl.n_pages(3072, 256) == 12 and dfl.n_pages(640, 1024) == 4
    assert dfl.scratch_floats(2048, 8192, 16, 128, 3072, 256) == \
        4 * 2048 + 2 * 8192 + 2 * 16 * 12 * 130
    assert dfl.scratch_floats(256, 512, 4, 64, 640, 1024) == \
        4 * 256 + 2 * 512 + 2 * 4 * 4 * 66
    assert dfl.scratch_words(16) == 34
    assert dfl.attention_items(16, 4, 1000, 3072, 256) == (64, 32)
    assert dfl.attention_items(16, 4, 5000, 3072, 1024) == (192, 128)
    assert dfl.attention_items(4, 2, 255, 640, 128) == (4, 8)
    assert dfl.attention_items(4, 4, 256, 640, 128) == (16, 8)
    assert dfl.attention_items(3, 3, 0, 640, 128) == (6, 6)
