"""PyTorch port: the host-side plans of the two persistent steps that run a
whole decode step in one cooperative launch with fewer waits, on the CPU.

K12, the Parler step (`ops/parler_flat.py` after csrc/parler_flat.cu): the
grid barriers a step passes (a layer norm or a GEMV that reads a whole
vector keeps one; the qkv -> self-attention and cross-q -> cross-attention
hand-offs wait per head instead, and a head's pages merge by arrival), the
GEMV tiles each head's attention waits for, and the scratch words. The
batched persistent llama step, K9 and K7's layer stack
(`ops/llama_persistent.py` after csrc/llama_flat_batched.cu): its shared
memory at Orpheus-3B width and the rows R one launch takes, its attention
items over slots at mixed positions and their arrival counters, its grid
barriers, and the route gate that sends heads of 64 / 128 to it and other
head sizes to the launch sequence. The kernels themselves run only on the
card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""
import pytest
import torch

from tts_tpu_torch.ops import _build
from tts_tpu_torch.ops import llama_megastep as lm
from tts_tpu_torch.ops import llama_persistent as lp
from tts_tpu_torch.ops import parler_flat as pf

PARLER_MINI = dict(n_layers=24, hidden=1024, heads=16, ffn=4096, ctx=4096, tc=256)
ORPHEUS_3B = dict(n_layers=28, hidden=3072, heads=24, kv_heads=8, ffn=8192, ctx=3584)


def launch_sequence_barriers(n_layers, use_cross, pos, tc):
    """The grid barriers of the eight-phase K12 this plan replaced: one after
    each phase, one more after a combine where more than one 256-row page
    of the self (cross) attention is live, none after the last fc2."""
    per = 5 + int(pos >= 256)
    if use_cross:
        per += 3 + int(tc > 256)
    return n_layers * per - 1


@pytest.mark.parametrize("pos", [0, 255, 256, 1000])
@pytest.mark.parametrize("use_cross", [True, False])
def test_k12_barriers(use_cross, pos):
    """6 grid barriers a layer with the cross block and 4 without (143 and
    95 a step at 24 layers), whatever the position, against the 8-9 (5-6)
    a layer of the eight-phase plan."""
    L = PARLER_MINI["n_layers"]
    got = pf.barriers(L, use_cross)
    assert got == (143 if use_cross else 95)
    assert got + 1 == (6 if use_cross else 4) * L
    old = launch_sequence_barriers(L, use_cross, pos, PARLER_MINI["tc"])
    # a combine barrier gone once a second page is live, and the qkv (and
    # cross-q) hand-off per head
    assert old - got == L * (1 + int(use_cross) + int(pos >= 256))


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("heads", [4, 16, 24])
def test_k12_readiness_counts_each_heads_tiles(heads, cross):
    """A head's attention waits for 3 D / 16 = 12 qkv tiles (its q, k and v
    rows at D 64) or D / 16 = 4 cross-q tiles: the kernel counts tile T of
    the qkv (cross-q) GEMV on head (16 T mod H) / 64, and every head gets
    exactly its count, from tiles of its own features only."""
    d, tile = pf.HEAD_D, pf.TILE
    hidden = heads * d
    n = hidden if cross else 3 * hidden
    want = pf.head_tiles(cross)
    assert want == (4 if cross else 12)
    counts = [0] * heads
    for t in range(n // tile):
        h = (t * tile) % hidden // d
        feats = range(t * tile, (t + 1) * tile)
        assert all(f % hidden // d == h for f in feats)
        counts[h] += 1
    assert counts == [want] * heads


@pytest.mark.parametrize("heads,ctx,tc", [(16, 4096, 256), (16, 4096, 300),
                                          (4, 640, 300)])
def test_k12_scratch(heads, ctx, tc):
    """The scratch: the floats before the words (the pages' partials over
    the longer of the cache and the cross K/V), then the barrier's 2
    words, the barrier count (word 2), a pad word and 3 counters a head
    (qkv readiness, cross readiness, page arrivals)."""
    m = dict(PARLER_MINI, heads=heads, hidden=heads * 64, ctx=ctx, tc=tc)
    assert pf.scratch_words(m["heads"]) == 4 + 3 * heads
    pages = -(-max(ctx, tc) // 256)
    at = pf.words_at(m["n_layers"], m["hidden"], m["ffn"], heads, ctx, tc)
    assert at == 24 * 3 * m["hidden"] + 2 * m["hidden"] + 4096 + heads * pages * 66
    assert pf.scratch_floats(m["n_layers"], m["hidden"], m["ffn"], heads, ctx,
                             tc) == at + 4 + 3 * heads
    keep, pf._last_words = pf._last_words, None
    try:
        with pytest.raises(RuntimeError, match="no K12 launch"):
            pf.barriers_passed()
    finally:
        pf._last_words = keep


@pytest.mark.parametrize("route,qkv_bf16", [("k9", False), ("k7", True)])
def test_k9_shared_memory_and_rows(route, qkv_bf16):
    """At Orpheus-3B width (Q4_0 packed; K9's layers keep f32 qkv scales,
    K7's bf16): the dynamic shared memory of R = 8 rows (6 ring stages a
    warp, the range sums, the rows staged as bf16 at K 8192, no f32 copy)
    plus the static shared memory fits the 227 KB a block may have. K9's
    does not at R + 1 rows; K7's 9 rows would fit, and R stops at the 8
    rows of the mma's one n-tile."""
    h, f = ORPHEUS_3B["hidden"], ORPHEUS_3B["ffn"]
    r = lp.max_rows(h, f, True, qkv_bf16)
    assert r == 8 == lp.MAX_SLOTS
    assert lp.batched_stages(True, qkv_bf16) == 6
    stage = 1152 if qkv_bf16 else 1280
    smem = lp.batched_smem_bytes(r, h, f, True, qkv_bf16)
    assert smem == 8 * 6 * stage + 8192 + 8 * (2 * f + 32)
    assert smem + lp.STATIC_SMEM <= lp.SMEM_LIMIT
    over = lp.batched_smem_bytes(r + 1, h, f, True, qkv_bf16) + lp.STATIC_SMEM
    if route == "k9":
        assert over > lp.SMEM_LIMIT
    else:
        assert over <= lp.SMEM_LIMIT
    # K8's layout at 8 rows (f32 rows and norm weights, 8 stages) would not fit
    k8_style = (8 * 8 * stage + 8192 + 9 * h * 4 + 8 * (2 * f + 32)
                + lp.STATIC_SMEM)
    assert k8_style > lp.SMEM_LIMIT


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("h,f", [(3072, 8192), (2048, 8192), (256, 512)])
def test_k9_rows_fit_at_other_widths(h, f, packed):
    """R fits the block at each width and qtype layout (3 ring stages of
    one-byte Q5_0 / Q8_0 codes), and never passes the n-tile's 8 rows."""
    for qkv_bf16 in (True, False):
        r = lp.max_rows(h, f, packed, qkv_bf16)
        assert 1 <= r <= lp.MAX_SLOTS
        assert lp.batched_stages(packed, qkv_bf16) == (6 if packed else 3)
        assert (lp.batched_smem_bytes(r, h, f, packed, qkv_bf16)
                + lp.STATIC_SMEM <= lp.SMEM_LIMIT)


LLAMA_SLOTS = (0, 255, 256, 257, 511, 1000, 2047, 3000)


@pytest.mark.parametrize("slot,pos", list(enumerate(LLAMA_SLOTS)))
def test_k9_attention_items_per_slot(slot, pos):
    """8 slots at chip_smoke's positions across 256-row pages at Orpheus-3B
    width on 132 blocks: 24 heads x 32 live pages exceed one round of the
    grid, so two q heads a block (G 2); slot s has 12 groups x its live
    pages, each (slot, group) with more than one page merged by arrival on
    counter s * 12 + group, within the B * heads words the step keeps."""
    heads, ctx = ORPHEUS_3B["heads"], ORPHEUS_3B["ctx"]
    g, items = lp.batched_attention_items(heads, LLAMA_SLOTS, ctx, 132)
    assert g == 2
    live = pos // 256 + 1
    assert items[slot] == heads // g * live
    assert sum(items) == 12 * 32
    counters = {slot * heads // g + j for j in range(heads // g)}
    assert max(counters) < lp.batched_scratch_words(8, heads) - 2
    assert lp.batched_scratch_words(8, heads) == 8 * 24 + 2


def test_k9_attention_one_head_a_block_within_one_round():
    """Few live pages keep one q head a block: 3 slots at pos 0 / 1 / 2 are
    72 items on 132 blocks."""
    g, items = lp.batched_attention_items(24, (0, 1, 2), 3584, 132)
    assert g == 1 and items == [24, 24, 24]


@pytest.mark.parametrize("n_layers,barriers", [(28, 139), (4, 19), (1, 4)])
def test_k9_barriers_and_scratch(n_layers, barriers):
    """5 L - 1 grid barriers a batched step, as K8's; scratch floats B
    times K8's (attention output, SiLU output, page partials)."""
    assert lp.barriers(n_layers, False) == barriers
    assert lp.batched_scratch_floats(8, 3072, 8192, 24, 128, 3584) == \
        8 * (3072 + 8192 + 24 * 14 * 130)


def _layers(hidden, ffn, d, n_kv, packed=True, qkv_bf16=False):
    """Orpheus-like LlamaMegaLayers of one layer on the meta device (shapes
    only), as the route gate reads them."""
    cb = 16 if packed else 32
    kvn = hidden + 2 * n_kv * d

    def tiles(pairs, k, sdt=torch.bfloat16):
        t = -(-pairs // 8)
        return (torch.empty((1, t, k // 128, 64 * cb), dtype=torch.uint8,
                            device="meta"),
                torch.empty((1, t, k // 128, 64), dtype=sdt, device="meta"))

    qc, qs = tiles(kvn // 2, hidden, torch.bfloat16 if qkv_bf16 else torch.float32)
    oc, os_ = tiles(hidden // 2, hidden)
    gc, gs = tiles(ffn, hidden)
    dc, ds = tiles(hidden // 2, ffn)
    norms = torch.empty((1, 2, hidden), device="meta")
    return lm.LlamaMegaLayers(qc, qs, oc, os_, gc, gs, dc, ds, norms)


@pytest.mark.parametrize("d,heads,persistent", [
    (128, 24, True), (64, 48, True), (80, 24, False), (192, 16, False),
    (256, 12, False)])
def test_route_gate_by_head_size(d, heads, persistent):
    """Heads of 64 / 128 go to the batched persistent step; heads of 80,
    192 and 256 to the launch sequence (layers_cuda), decided from the
    shapes before any launch."""
    layers = _layers(d * heads, 8192, d, 8)
    assert lm.takes_persistent_batched(layers, d) is persistent


@pytest.mark.parametrize("b,sizes", [(1, [1]), (8, [8]), (9, [5, 4]),
                                     (16, [8, 8]), (20, [7, 7, 6])])
def test_route_groups_past_r_rows(b, sizes):
    """More than R = 8 rows run in slot groups of at most R, as even as can
    be (`_build.slot_groups`); the launch sequence takes groups of at most
    16."""
    r = lp.max_rows(3072, 8192, True, False)
    groups = _build.slot_groups(b, r)
    assert [g.stop - g.start for g in groups] == sizes
    assert groups[0].start == 0 and groups[-1].stop == b
    assert all(a.stop == c.start for a, c in zip(groups, groups[1:]))
    assert len(_build.slot_groups(b, lm.MAX_BATCH)) == -(-b // 16)
