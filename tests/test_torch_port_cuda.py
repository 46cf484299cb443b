"""PyTorch port: each hand-written kernel against its plain version on the
card, at small shapes. Needs an NVIDIA GPU with nvcc (sm_90a); skipped
elsewhere. On the card:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda

(`--noconftest`: tests/conftest.py imports JAX, which the port's GPU
machine need not have; this file uses none of its fixtures.)

chip_smoke.py holds the same kernels to their plain versions at the main
path's full shapes. The batched kernels (K4, K5) are checked with slots at
mixed positions across 256-row page boundaries, and each slot against the
one-sequence kernel (K3, K2) on that slot's state, bit for bit. The Orpheus
steps (K8, K6) are checked at positions on both sides of K3's 256-row
pages, with bf16 caches; their batched forms (K9, K7) at 1, 5, 8 and 16
slots at mixed positions (one at 0), each slot against K8 / K6 bit for
bit. Two more tests launch the GEMVs at the 48 KB shared-memory edge. The
Parler GEMV (K2, K5, K12) gives a row in each of a launch's 16 positions
the bits a one-row launch gives it, for every epilogue and quant type. The
Dia steps: the cross-attention with and without its pad tail at every
bucket; K10 (the persistent step, one launch) at positions across the
pages and at both tail cases, and bit for bit against the launch sequence
(K11 at one pair) for every qtype, both cache dtypes, positions 0-1000
and buckets with and without a tail, writing only cache row pos, the same
bits over 1,000 launches, one launch a step; K11 at 1, 3 and 8 pairs at
mixed positions, each pair against K10 bit for bit.
The batched steps past one launch's rows run in slot groups: K5, K9 and K7
at 20 slots and K11 at 12 pairs, slots at positions across the pages, each
slot against its one-sequence kernel bit for bit. K12, the one-launch
Parler step, against its plain version and K2 bit for bit, at positions
across the pages, with and without the cross-attention, and one launch
on its own counter per step; on 2 layers it equals K2 at pos 0 / 256 /
300 and its kernel counts the barriers of its plan. The batched
persistent llama step (K9 / K7's layer stack, csrc/llama_flat_batched.cu)
at 3 slots across the pages equals the launch sequence bit for bit, one
launch a step. K3 / K4 at heads of 128 with 3 and 4 q heads
a kv head; K3's pages merged by its last block in one launch at 1, 2 and
16 pages, the arrival counters left at 0; the llama GEMV's rows each equal
a one-row launch at 1, 8, 9 and 16 rows over K 3072 and 8192, and a row in
each of a launch's 16 positions equals the one-row launch for every
epilogue, quant type and scale type; 100 iterations of dependent GEMV
launches with K3 between them, enqueued without a sync, each held to the
plain version (the programmatic dependent launch's wait). The persistent
llama step (K8 and K6, one cooperative launch of csrc/llama_flat.cu)
bit for bit against the launch sequence (K9's / K7's at one slot) for every
qtype, both cache dtypes and heads of 64 and 128 at positions across the
pages, the same bits over 1,000 launches, one launch a step on its own
counter, and its refusals (heads of 256, two positions, f32 scales past
the qkv phase). K3 / K4 and the cross-attention entry at heads of 8, 80,
96, 192 and 256 (the generic path) against their plain versions, and the
head sizes they refuse. K1 at every row count from 1 to 256 that changes
its warp layout, K 1024-8192 (split over 1-8 cluster ranks and not), both
numeric modes and every quant type, against its plain version; each row of
a call equal to that row's call alone bit for bit; its counters and
refusals. The GGUF quantize kernel (csrc/quantize.cu, no TPU counterpart)
byte for byte against its plain version on the card and on the CPU, on
seeded draws (past its grid's cap too) and on chip_smoke's edge blocks;
its counter and refusals.
"""
import pytest
import torch

from tts_tpu_torch.gguf import quants
from tts_tpu_torch.ops import decode_attention as da
from tts_tpu_torch.ops import dia_flat as dfl
from tts_tpu_torch.ops import dia_megastep as dm
from tts_tpu_torch.ops import llama_flat as lf
from tts_tpu_torch.ops import llama_megastep as lm
from tts_tpu_torch.ops import parler_flat as pf
from tts_tpu_torch.ops import parler_megastep as pm
from tts_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand_quant(n, k, qtype, scale_dtype, dev):
    hi = {quants.GGML_TYPE_Q4_0: 16, quants.GGML_TYPE_Q5_0: 32}.get(qtype, 256)
    codes = torch.randint(0, hi, (n, k), device=dev, dtype=torch.int32)
    codes = (codes - 128).to(torch.int8) if hi == 256 else codes.to(torch.uint8)
    scales = (torch.rand((n, k // 32), device=dev) * 0.004 + 0.002).to(scale_dtype)
    return qm.QuantTensor(codes, scales, qtype)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype,packed", [(quants.GGML_TYPE_Q4_0, True),
                                          (quants.GGML_TYPE_Q4_0, False),
                                          (quants.GGML_TYPE_Q5_0, False),
                                          (quants.GGML_TYPE_Q8_0, False)])
@pytest.mark.parametrize("m,n,k", [(1, 1001, 256), (37, 96, 4096), (5, 130, 320),
                                   (20, 130, 384), (16, 70, 192)])
def test_k1_matches_plain(dev, qtype, packed, scale_dtype, m, n, k):
    """Same rounding on both sides, f32 sums in another order: 1e-5 of the
    largest output."""
    torch.manual_seed(0)
    w = _rand_quant(n, k, qtype, scale_dtype, dev)
    w = w.pack() if packed else w
    x = torch.randn((m, k), device=dev)
    got, ref = qm.quant_matmul_cuda(x, w), qm.quant_matmul_plain(x, w)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


K1_TYPES = [(quants.GGML_TYPE_Q4_0, True), (quants.GGML_TYPE_Q4_0, False),
            (quants.GGML_TYPE_Q5_0, False), (quants.GGML_TYPE_Q8_0, False)]


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype,packed", K1_TYPES)
@pytest.mark.parametrize("k", [1024, 2048, 3072, 4096, 8192])
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 64, 100, 128, 255, 256])
def test_k1_matches_plain_at_every_row_count(dev, m, k, qtype, packed,
                                             scale_dtype):
    """K1 at each of its warp layouts (1-8, 9-16, 17-32, 33-64, 65-128,
    129-256 rows) and K splits (N 200: 4 tiles, split 2-8 ways by K): 1e-5
    of the largest output, as test_k1_matches_plain."""
    torch.manual_seed(m * 7 + k)
    w = _rand_quant(200, k, qtype, scale_dtype, dev)
    w = w.pack() if packed else w
    x = torch.randn((m, k), device=dev)
    got, ref = qm.quant_matmul_cuda(x, w), qm.quant_matmul_plain(x, w)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 17, 256])
def test_k1_without_k_split(dev, m, scale_dtype):
    """N 20000 (313 tiles, two blocks an SM and more): no K split."""
    torch.manual_seed(m)
    w = _rand_quant(20000, 1024, quants.GGML_TYPE_Q4_0, scale_dtype, dev).pack()
    assert qm.k1_plan(20000, 1024, qm._sm_count(dev))[1] == 1
    x = torch.randn((m, 1024), device=dev)
    got, ref = qm.quant_matmul_cuda(x, w), qm.quant_matmul_plain(x, w)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype,packed", K1_TYPES)
@pytest.mark.parametrize("n,k", [(200, 4096), (11520, 1024), (20000, 1024)])
def test_k1_rows_independent(dev, n, k, qtype, packed, scale_dtype):
    """Each row of a K1 call of M rows has the bits of that row's call
    alone, and of the same row in a call of other rows, at M 2, 9, 17, 64,
    100 and 256 (every warp layout), with and without a K split: the
    engines' greedy parity with the runners rests on it."""
    torch.manual_seed(n + k)
    w = _rand_quant(n, k, qtype, scale_dtype, dev)
    w = w.pack() if packed else w
    x = torch.randn((256, k), device=dev)
    alone = torch.cat([qm.quant_matmul_cuda(x[r:r + 1].contiguous(), w)
                       for r in range(256)])
    for m in (2, 9, 17, 64, 100, 256):
        assert torch.equal(qm.quant_matmul_cuda(x[:m].contiguous(), w), alone[:m]), m
    rows = torch.tensor([200, 3, 77, 3, 255, 0, 128], device=dev)
    assert torch.equal(qm.quant_matmul_cuda(x[rows].contiguous(), w), alone[rows])


def test_k1_counts_and_refusals(dev):
    """One launch on the counter and one on the shape tally a call; raises
    for M > 256, M 0, K not a multiple of 64, and dtypes or devices the
    kernel does not take (no fallback)."""
    w = _rand_quant(96, 256, quants.GGML_TYPE_Q4_0, torch.bfloat16, dev).pack()
    x = torch.randn((3, 256), device=dev)
    n0 = qm.KERNEL.launches
    key = (3, 96, 256, quants.GGML_TYPE_Q4_0, "bf16", True)
    s0 = qm.SHAPES[key]
    qm.quant_matmul_cuda(x, w)
    qm.quant_matmul(x, w)
    assert qm.KERNEL.launches == n0 + 2 and qm.SHAPES[key] == s0 + 2
    with pytest.raises(ValueError):
        qm.quant_matmul_cuda(torch.randn((257, 256), device=dev), w)
    with pytest.raises(ValueError):
        qm.quant_matmul_cuda(torch.randn((0, 256), device=dev), w)
    with pytest.raises(ValueError):
        qm.quant_matmul_cuda(x.double(), w)
    with pytest.raises(ValueError):
        qm.quant_matmul_cuda(x, qm.QuantTensor(w.codes, w.scales.half(), w.qtype))
    with pytest.raises(ValueError):
        qm.quant_matmul_cuda(x, w.to("cpu"))
    w96 = _rand_quant(96, 96, quants.GGML_TYPE_Q8_0, torch.float32, dev)
    with pytest.raises(ValueError):
        qm.quant_matmul_cuda(torch.randn((3, 96), device=dev), w96)
    assert qm.KERNEL.launches == n0 + 2
    # M > 256 goes to dequant + torch.matmul, as in the JAX package
    big = torch.randn((300, 256), device=dev)
    torch.testing.assert_close(qm.quant_matmul(big, w), qm.quant_matmul_plain(big, w))
    assert qm.KERNEL.launches == n0 + 2


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("pos", [0, 255, 256, 257, 639])
def test_k3_matches_plain(dev, cache_dtype, n_rep, pos):
    """f32 softmax over the same values in another order: 1e-5 absolute."""
    torch.manual_seed(0)
    q = torch.randn((4 * n_rep, 64), device=dev)
    k = torch.randn((4, 640, 64), device=dev).to(cache_dtype)
    v = torch.randn((4, 640, 64), device=dev).to(cache_dtype)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    torch.testing.assert_close(da.decode_attention_cuda(q, k, v, p),
                               da.decode_attention_plain(q, k, v, p),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
@pytest.mark.parametrize("use_cross", [True, False])
def test_k2_matches_plain(dev, qtype, use_cross):
    """Two layers at H=256: bf16 roundings agree, f32 sums differ in order;
    5e-4 of the largest value (see tests/test_torch_port_megastep.py)."""
    from tts_tpu_torch.models.parler.model import ParlerLayerWeights
    torch.manual_seed(0)
    L, H, F, heads, ctx = 2, 256, 512, 4, 320

    def stack(n, k):
        ws = [_rand_quant(n, k, qtype, torch.bfloat16, dev).pack() for _ in range(L)]
        return qm.QuantTensor(torch.stack([w.codes for w in ws]),
                              torch.stack([w.scales for w in ws]), qtype)

    vec = lambda one=0.0: torch.randn((L, H), device=dev) * 0.1 + one  # noqa: E731
    lw = ParlerLayerWeights(
        vec(1), vec(), stack(H, H), stack(H, H), stack(H, H), stack(H, H),
        vec(1), vec(), stack(H, H), stack(H, H),
        torch.randn((L, heads, 16, 64), device=dev),
        torch.randn((L, heads, 16, 64), device=dev), vec(1), vec(),
        stack(F, H), stack(H, F))
    mega, qt = pm.prep_mega_layers(lw)
    x = torch.randn((1, H), device=dev)
    kc = torch.randn((L, heads, ctx, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((L, heads, ctx, 64), device=dev).to(torch.bfloat16)
    pos = torch.tensor([300], dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    kw = dict(qtype=qt, use_cross=use_cross, n_heads=heads)
    got = pm.parler_megastep_cuda(mega, x, k1, v1, pos, **kw)
    ref = pm.parler_megastep_plain(mega, x, k2, v2, pos, **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * b.abs().max().item())
    # the step wrote its own k/v (in bf16) at row pos and no other row
    rows = torch.arange(ctx, device=dev) != 300
    assert torch.equal(k1[:, :, rows], kc[:, :, rows])
    assert torch.equal(v1[:, :, rows], vc[:, :, rows])
    assert torch.equal(k1[:, :, 300], got[1].reshape(L, heads, 64).to(torch.bfloat16))
    assert torch.equal(v1[:, :, 300], got[2].reshape(L, heads, 64).to(torch.bfloat16))


MIXED = [0, 255, 256, 257, 511, 639]


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_k4_matches_plain_and_k3(dev, cache_dtype, n_rep):
    """Slots at mixed positions: 1e-5 absolute against the plain version;
    each slot equals K3 on its own cache bit for bit."""
    torch.manual_seed(0)
    b = len(MIXED)
    q = torch.randn((b, 4 * n_rep, 64), device=dev)
    k = torch.randn((b, 4, 640, 64), device=dev).to(cache_dtype)
    v = torch.randn((b, 4, 640, 64), device=dev).to(cache_dtype)
    p = torch.tensor(MIXED, dtype=torch.int32, device=dev)
    got = da.decode_attention_batched_cuda(q, k, v, p)
    torch.testing.assert_close(got, da.decode_attention_batched_plain(q, k, v, p),
                               rtol=0, atol=1e-5)
    for s in range(b):
        assert torch.equal(got[s], da.decode_attention_cuda(q[s], k[s], v[s],
                                                            p[s:s + 1]))


def test_k4_shared_kv_and_strided_q(dev):
    """Cross-attention mode (one K/V and one position for every slot) with q
    a strided view of wider rows, as the batched step passes it."""
    torch.manual_seed(0)
    qkv = torch.randn((3, 3 * 256), device=dev)
    q = qkv[:, :256].unflatten(1, (4, 64))
    k = torch.randn((4, 40, 64), device=dev)
    v = torch.randn((4, 40, 64), device=dev)
    p = torch.tensor([39], dtype=torch.int32, device=dev)
    torch.testing.assert_close(da.decode_attention_batched_cuda(q, k, v, p),
                               da.decode_attention_batched_plain(q, k, v, p),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rep", [3, 4])
def test_k3_k4_gqa_d128_match_plain(dev, cache_dtype, n_rep):
    """Heads of 128 with 3 and 4 q heads a kv head (Orpheus-3B, Dia), which
    one block serves from one read of the kv head's page: K3 at positions
    across the pages and K4 with slots at those positions, 1e-5 absolute
    against the plain versions; each K4 slot equals K3 bit for bit."""
    torch.manual_seed(0)
    b = len(MIXED)
    q = torch.randn((b, 2 * n_rep, 128), device=dev)
    k = torch.randn((b, 2, 640, 128), device=dev).to(cache_dtype)
    v = torch.randn((b, 2, 640, 128), device=dev).to(cache_dtype)
    p = torch.tensor(MIXED, dtype=torch.int32, device=dev)
    got = da.decode_attention_batched_cuda(q, k, v, p)
    torch.testing.assert_close(got, da.decode_attention_batched_plain(q, k, v, p),
                               rtol=0, atol=1e-5)
    for s in range(b):
        one = da.decode_attention_cuda(q[s], k[s], v[s], p[s:s + 1])
        torch.testing.assert_close(one, da.decode_attention_plain(
            q[s], k[s], v[s], p[s:s + 1]), rtol=0, atol=1e-5)
        assert torch.equal(got[s], one)


@pytest.mark.parametrize("d", [1, 8, 36, 80, 96, 100, 192, 256, 320, 512, 1024])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rep", [1, 3, 4])
def test_k3_k4_other_head_sizes_match_plain(dev, cache_dtype, n_rep, d):
    """Head sizes other than 64 / 128 on the generic path, at each of its
    widths (256, 512, 1024): rows wider than a warp's 16-byte lanes (bf16
    192 / 256, f32 192 / 256 and past), rows whose chunks do not divide 32
    (80, 96, 192), and rows that are not whole 16-byte chunks, read
    element by element (1, 36 in bf16, 100). K3 at positions across the
    pages and K4 with slots at those positions, 1e-5 absolute against the
    plain versions (f32 softmax, sums in another order); each K4 slot
    equals K3 bit for bit."""
    torch.manual_seed(0)
    b = len(MIXED)
    q = torch.randn((b, 2 * n_rep, d), device=dev)
    k = torch.randn((b, 2, 640, d), device=dev).to(cache_dtype)
    v = torch.randn((b, 2, 640, d), device=dev).to(cache_dtype)
    p = torch.tensor(MIXED, dtype=torch.int32, device=dev)
    got = da.decode_attention_batched_cuda(q, k, v, p)
    torch.testing.assert_close(got, da.decode_attention_batched_plain(q, k, v, p),
                               rtol=0, atol=1e-5)
    for s in range(b):
        assert torch.equal(got[s], da.decode_attention_cuda(q[s], k[s], v[s],
                                                            p[s:s + 1]))


@pytest.mark.parametrize("d", [1025, 1536, 2048])
def test_k3_refuses_head_sizes_it_does_not_take(dev, d):
    """Heads wider than 1024 (a lane's registers, csrc/attention.cuh) raise
    before any launch."""
    q = torch.randn((2, d), device=dev)
    k = torch.randn((2, 64, d), device=dev)
    p = torch.tensor([3], dtype=torch.int32, device=dev)
    before = da.KERNEL.launches
    with pytest.raises(ValueError):
        da.decode_attention_cuda(q, k, k, p)
    assert da.KERNEL.launches == before and not da.head_size_ok(d)


@pytest.mark.parametrize("d", [1, 36, 80, 100, 192, 256, 320, 512])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_dia_cross_attention_other_head_sizes(dev, cache_dtype, d):
    """The cross-attention entry takes K4's head sizes: bucket 256 with a
    tail of 768, and 512 with none, 1e-5 of the largest output."""
    torch.manual_seed(0)
    q = torch.randn((2, 2, d), device=dev)
    for sb, n_tail in ((256, 768), (512, 0)):
        ck = torch.randn((2, 2, sb, d), device=dev).to(cache_dtype)
        cv = torch.randn((2, 2, sb, d), device=dev).to(cache_dtype)
        vt = torch.randn((2, 2, d), device=dev) * 10
        got = dm.cross_attention_cuda(q, ck, cv, vt, n_tail)
        ref = dm.cross_attention_plain(q, ck, cv, vt, n_tail)
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * ref.abs().max().item())


def _device_events(fn, calls: int = 10) -> int:
    """Kernels (and memsets / copies) the card ran for one fn() call, over
    `calls` calls and rounded (the profiler may miss an event of its
    window; two launches a call would read 2)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return round(sum(e.device_type == torch.autograd.DeviceType.CUDA
                     for e in prof.events()) / calls)


@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("pos,pages", [(100, 1), (300, 2), (4095, 16)])
def test_k3_merges_its_pages_in_one_launch(dev, n_rep, pos, pages):
    """1, 2 and 16 live pages of a 4096-row cache: the last page block to
    finish merges them (no combine launch, no memset), 1e-5 absolute
    against the plain version; the arrival counters are left at 0, so a
    second call gives the same output bit for bit."""
    torch.manual_seed(0)
    q = torch.randn((4 * n_rep, 64), device=dev)
    k = torch.randn((4, 4096, 64), device=dev).to(torch.bfloat16)
    v = torch.randn((4, 4096, 64), device=dev).to(torch.bfloat16)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    assert pos // da.PAGE + 1 == pages
    got = da.decode_attention_cuda(q, k, v, p)
    torch.testing.assert_close(got, da.decode_attention_plain(q, k, v, p),
                               rtol=0, atol=1e-5)
    assert torch.equal(da.decode_attention_cuda(q, k, v, p), got)
    assert not da.arrivals(dev, 4 * n_rep).any()
    before = da.KERNEL.launches
    assert _device_events(lambda: da.decode_attention_cuda(q, k, v, p)) == 1
    assert da.KERNEL.launches - before == 11


def test_cross_attention_and_k4_leave_the_counters_zero(dev):
    """The Dia cross-attention over 4 pages with its tail and K4 over
    mixed positions share one stream's counters: each call is one launch
    and leaves them at 0."""
    torch.manual_seed(0)
    q = torch.randn((3, 4, 128), device=dev)
    ck = torch.randn((3, 4, 1024, 128), device=dev).to(torch.bfloat16)
    cv = torch.randn((3, 4, 1024, 128), device=dev).to(torch.bfloat16)
    vt = torch.randn((3, 4, 128), device=dev)
    assert _device_events(lambda: dm.cross_attention_cuda(q, ck, cv, vt, 100)) == 1
    torch.testing.assert_close(dm.cross_attention_cuda(q, ck, cv, vt, 100),
                               dm.cross_attention_plain(q, ck, cv, vt, 100),
                               rtol=0, atol=1e-5)
    kb = torch.randn((len(MIXED), 2, 640, 64), device=dev).to(torch.bfloat16)
    qb = torch.randn((len(MIXED), 8, 64), device=dev)
    p = torch.tensor(MIXED, dtype=torch.int32, device=dev)
    assert _device_events(lambda: da.decode_attention_batched_cuda(qb, kb, kb, p)) == 1
    torch.cuda.synchronize()
    assert not da.arrivals(dev, len(MIXED) * 8).any()


def _tiny_mega(dev, qtype, tc=16):
    """Two random layers at H=256 with Tc cross rows. Q8_0 scales are
    divided by 16 (exact in bf16) so that its weights have Q4_0's magnitude
    (std ~0.02): with codes up to +-128 at Q4's scales the activations grow
    to ~1e2 and one flipped bf16 rounding moves a whole slot past any fixed
    tolerance."""
    from tts_tpu_torch.models.parler.model import ParlerLayerWeights
    L, H, F, heads = 2, 256, 512, 4
    div = 16.0 if qtype == quants.GGML_TYPE_Q8_0 else 1.0

    def stack(n, k):
        ws = [_rand_quant(n, k, qtype, torch.bfloat16, dev).pack() for _ in range(L)]
        return qm.QuantTensor(torch.stack([w.codes for w in ws]),
                              torch.stack([w.scales for w in ws]) / div, qtype)

    vec = lambda one=0.0: torch.randn((L, H), device=dev) * 0.1 + one  # noqa: E731
    lw = ParlerLayerWeights(
        vec(1), vec(), stack(H, H), stack(H, H), stack(H, H), stack(H, H),
        vec(1), vec(), stack(H, H), stack(H, H),
        torch.randn((L, heads, tc, 64), device=dev),
        torch.randn((L, heads, tc, 64), device=dev), vec(1), vec(),
        stack(F, H), stack(H, F))
    return pm.prep_mega_layers(lw)


@pytest.mark.parametrize("b", [3, 12])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
def test_k5_matches_k2_and_plain(dev, qtype, b):
    """B slots at mixed positions (B = 12 takes the 16-row kernel): each slot
    equals a K2 step on that slot's state bit for bit; against the plain
    version, 5e-4 of the largest value (see test_k2_matches_plain)."""
    torch.manual_seed(0)
    mega, qt = _tiny_mega(dev, qtype)
    L, H, heads, ctx = 2, 256, 4, 640
    pos = torch.tensor((MIXED * 2)[:b], dtype=torch.int32, device=dev)
    kc = torch.randn((L, b, heads, ctx, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((L, b, heads, ctx, 64), device=dev).to(torch.bfloat16)
    x = torch.randn((b, H), device=dev)
    kw = dict(qtype=qt, use_cross=True, n_heads=heads)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = pm.parler_megastep_batched_cuda(mega, x, k1, v1, pos, **kw)
    for s in range(b):
        ks, vs = kc[:, s].clone(), vc[:, s].clone()
        xs, kn, vn = pm.parler_megastep_cuda(mega, x[s:s + 1], ks, vs,
                                             pos[s:s + 1], **kw)
        assert torch.equal(got[0][s:s + 1], xs) and torch.equal(got[1][:, s], kn)
        assert torch.equal(got[2][:, s], vn)
        assert torch.equal(k1[:, s], ks) and torch.equal(v1[:, s], vs)
    ref = pm.parler_megastep_batched_plain(mega, x, k2, v2, pos, **kw)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=5e-4 * r.abs().max().item())


def _tiny_llama(dev, qtype, d=64, h=256, kv=None):
    """Two random llama layers at H=256 (4 q / 2 kv heads of 64, F 512; with
    d 128, 2 q / 1 kv heads; with d 256, one of each; F = 2 h; kv kv heads
    where given) as K8's and K6's weights, with a 1000-row head (padded to 1024), llama3 frequency factors
    of 1.25. Q8_0 scales are divided by 16, as in _tiny_mega."""
    from tts_tpu_torch.models.orpheus.model import OrpheusLayer
    from tts_tpu_torch.ops.attention import rope_freqs
    L, H, F = 2, h, 2 * h
    heads = H // d
    kv = kv or max(1, heads // 2)
    div = 16.0 if qtype == quants.GGML_TYPE_Q8_0 else 1.0

    def quant(n, k):
        w = _rand_quant(n, k, qtype, torch.float32, dev).pack()
        return qm.QuantTensor(w.codes, w.scales / div, qtype)

    def stack(n, k):
        ws = [quant(n, k) for _ in range(L)]
        return qm.QuantTensor(torch.stack([w.codes for w in ws]),
                              torch.stack([w.scales for w in ws]), qtype)

    vec = lambda: torch.randn((L, H), device=dev) * 0.1 + 1  # noqa: E731
    lw = OrpheusLayer(vec(), stack(H, H), stack(kv * d, H), stack(kv * d, H),
                      stack(H, H), vec(), stack(F, H), stack(F, H), stack(H, F))
    mega, qt = lm.prep_llama_mega(lw, d)
    flat = lf.prep_llama_flat(mega, quant(1000, H), vec()[0], qt, heads, kv)
    inv = rope_freqs(d, 500000.0, torch.full((d // 2,), 1.25, device=dev))
    return mega, flat, qt, dict(qtype=qt, n_heads=heads, n_kv=kv, inv_freq=inv)


def _llama_inputs(dev, pos):
    kc = torch.randn((2, 2, 640, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((2, 2, 640, 64), device=dev).to(torch.bfloat16)
    x = torch.randn((1, 256), device=dev)
    return x, kc, vc, torch.tensor([pos], dtype=torch.int32, device=dev)


# Same bf16 roundings, f32 sums in another order; one flipped bf16 rounding
# of an activation spreads through the next projections (measured 0.1% of
# the largest value on the CPU, tests/test_torch_port_llama_ops.py): 1e-2 of
# the largest value.
LLAMA_TOL = 1e-2


@pytest.mark.parametrize("pos", [0, 255, 256, 300, 639])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
def test_k8_matches_plain(dev, qtype, pos):
    """K8 (f32 qkv scales, bf16 others) against its plain version; the step
    writes its own k/v (in bf16) at row pos and no other row."""
    torch.manual_seed(0)
    mega, _, _, kw = _tiny_llama(dev, qtype)
    assert mega.qkv_scales.dtype == torch.float32
    x, kc, vc, p = _llama_inputs(dev, pos)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = lm.llama_megastep_cuda(mega, x, k1, v1, p, **kw)
    ref = lm.llama_megastep_plain(mega, x, k2, v2, p, **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=LLAMA_TOL * b.abs().max().item())
    rows = torch.arange(640, device=dev) != pos
    assert torch.equal(k1[:, :, rows], kc[:, :, rows])
    assert torch.equal(v1[:, :, rows], vc[:, :, rows])
    assert torch.equal(k1[:, :, pos], got[1].reshape(2, 2, 64).to(torch.bfloat16))
    assert torch.equal(v1[:, :, pos], got[2].reshape(2, 2, 64).to(torch.bfloat16))


@pytest.mark.parametrize("pos", [0, 255, 256, 639])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
def test_k6_matches_plain(dev, qtype, pos):
    """K6 (every scale bf16, the padded head) against its plain version: the
    logits, whose 24 padded rows are exactly 0, k_new and v_new."""
    torch.manual_seed(0)
    _, flat, _, kw = _tiny_llama(dev, qtype)
    x, kc, vc, p = _llama_inputs(dev, pos)
    got = lf.llama_flat_megastep_cuda(flat, x, kc.clone(), vc.clone(), p, **kw)
    ref = lf.llama_flat_megastep_plain(flat, x, kc.clone(), vc.clone(), p, **kw)
    assert got[0].shape == (1, 1024)
    assert not got[0][:, 1000:].any()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=LLAMA_TOL * b.abs().max().item())


def test_llama_launch_counters(dev):
    """Each wrapper counts its own launches: K8 and K6 are one persistent
    launch a step each (the head inside K6's), with no GEMV, K3 or K4
    launch."""
    torch.manual_seed(0)
    mega, flat, _, kw = _tiny_llama(dev, quants.GGML_TYPE_Q4_0)
    x, kc, vc, p = _llama_inputs(dev, 300)
    counters = (lm.KERNEL, lf.KERNEL, da.KERNEL, lm.KERNEL_BATCHED,
                lf.KERNEL_BATCHED, da.KERNEL_BATCHED)
    before = [k.launches for k in counters]
    lm.llama_megastep(mega, x, kc, vc, p, **kw)
    lf.llama_flat_megastep(flat, x, kc, vc, p, **kw)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 0, 0, 0, 0]
    assert _device_events(lambda: lf.llama_flat_megastep(flat, x, kc, vc, p, **kw),
                          calls=5) <= 3   # the step, and the copy of x


def _llama_sequence(w, x, kc, vc, p, kw):
    """K8's (K6's) function through the launch sequence: K9's (K7's) at one
    slot, on views of the same caches (written in place)."""
    fn = (lf.llama_flat_megastep_batched_sequence if isinstance(w, lf.LlamaFlat)
          else lm.llama_megastep_batched_sequence)
    out, kn, vn = fn(w, x, kc[:, None], vc[:, None], p, **kw)
    return out, kn[:, 0], vn[:, 0]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0,
                                   quants.GGML_TYPE_Q8_0])
def test_persistent_llama_equals_launch_sequence(dev, qtype, cache_dtype, d):
    """The persistent K8 (f32 qkv scales) and K6 (bf16 scales, the head its
    last phase) against the launch sequence (K9 / K7 at one slot) on the
    same state, at positions on both sides of the 256-row pages: x_out (the
    logits, their padded rows 0), k_new, v_new and both caches bit for bit;
    cache row pos is the only row either writes."""
    torch.manual_seed(0)
    mega, flat, _, kw = _tiny_llama(dev, qtype, d)
    kv = kw["n_kv"]
    kc = torch.randn((2, kv, 640, d), device=dev).to(cache_dtype)
    vc = torch.randn((2, kv, 640, d), device=dev).to(cache_dtype)
    x = torch.randn((1, 256), device=dev)
    for pos in (0, 255, 256, 257, 639):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        for w, step in ((mega, lm.llama_megastep_cuda),
                        (flat, lf.llama_flat_megastep_cuda)):
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            got = step(w, x, k1, v1, p, **kw)
            seq = _llama_sequence(w, x, k2, v2, p, kw)
            for a, b in zip(got, seq):
                assert torch.equal(a, b), (pos, step.__name__)
            assert torch.equal(k1, k2) and torch.equal(v1, v2)
            rows = torch.arange(640, device=dev) != pos
            assert torch.equal(k1[:, :, rows], kc[:, :, rows])
            assert torch.equal(v1[:, :, rows], vc[:, :, rows])
            assert torch.equal(k1[:, :, pos],
                               got[1].reshape(2, kv, d).to(cache_dtype))
        assert not got[0][:, 1000:].any()


def test_persistent_llama_takes_widths_in_any_order(dev):
    """One kernel serves models of several widths (and heads of 64 and 128):
    its shared memory opt-in only rises, so a wide model's step after a
    narrow one's is not refused as too large to be resident. K6 at H 512,
    then H 256, then H 512 again, each equal to the launch sequence."""
    torch.manual_seed(0)
    p = torch.tensor([300], dtype=torch.int32, device=dev)
    models = {h: _tiny_llama(dev, quants.GGML_TYPE_Q4_0, 128, h) for h in (512, 256)}
    for h in (512, 256, 512):
        _, flat, _, kw = models[h]
        kv = kw["n_kv"]
        kc = torch.randn((2, kv, 640, 128), device=dev).to(torch.bfloat16)
        x = torch.randn((1, h), device=dev)
        got = lf.llama_flat_megastep_cuda(flat, x, kc.clone(), kc.clone(), p, **kw)
        seq = _llama_sequence(flat, x, kc.clone(), kc.clone(), p, kw)
        for a, b in zip(got, seq):
            assert torch.equal(a, b), h


def test_persistent_llama_pairs_of_heads(dev):
    """Past one round of the grid (heads x live pages > its blocks) the
    attention phase serves two q heads a block, which at 3 q heads a kv
    head read two kv heads: 24 / 8 heads of 64 at H 1536, positions on
    both sides of 1280 (5 -> 6 pages: 120 -> 144 items), K8 and K6 bit for
    bit against the launch sequence (K4 serves all 3 heads of a kv head in
    one block)."""
    torch.manual_seed(0)
    mega, flat, _, kw = _tiny_llama(dev, quants.GGML_TYPE_Q4_0, 64, 1536, 8)
    assert kw["n_heads"] == 24 and kw["n_kv"] == 8
    kc = torch.randn((2, 8, 1536, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((2, 8, 1536, 64), device=dev).to(torch.bfloat16)
    x = torch.randn((1, 1536), device=dev)
    for pos in (1000, 1279, 1280, 1535):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        for w, step in ((mega, lm.llama_megastep_cuda),
                        (flat, lf.llama_flat_megastep_cuda)):
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            got = step(w, x, k1, v1, p, **kw)
            seq = _llama_sequence(w, x, k2, v2, p, kw)
            for a, b in zip(got, seq):
                assert torch.equal(a, b), (pos, step.__name__)
            assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_persistent_llama_repeats_its_bits(dev):
    """1,000 K6 launches back to back on the same state (each rewrites cache
    row pos with the same bits) give the first launch's logits, k_new and
    v_new bit for bit: the grid barrier's count runs on over 10 x 1,000
    barriers without a reset, and the arrival counters stay zeroed."""
    torch.manual_seed(0)
    _, flat, _, kw = _tiny_llama(dev, quants.GGML_TYPE_Q4_0)
    x, kc, vc, p = _llama_inputs(dev, 600)
    first = [t.clone() for t in lf.llama_flat_megastep_cuda(flat, x, kc, vc, p, **kw)]
    outs = [lf.llama_flat_megastep_cuda(flat, x, kc, vc, p, **kw)
            for _ in range(1000)]
    for i, o in enumerate(first):
        assert torch.equal(torch.stack([r[i] for r in outs]),
                           o.expand(1000, *o.shape)), i


def test_persistent_llama_grid_and_refusals(dev):
    """One launch of a grid of whole SMs; what the persistent step does not
    take raises, with no launch: heads of 256 (its gate sends them to the
    launch sequence), two positions, f32 o / gate / up / down scales."""
    from tts_tpu_torch.ops import llama_persistent as lp
    torch.manual_seed(0)
    mega, flat, _, kw = _tiny_llama(dev, quants.GGML_TYPE_Q4_0)
    x, kc, vc, p = _llama_inputs(dev, 3)
    lm.llama_megastep_cuda(mega, x, kc, vc, p, **kw)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert lp.launched_blocks == sms * lp.blocks_per_sm and lp.blocks_per_sm >= 1
    before = (lm.KERNEL.launches, lf.KERNEL.launches)
    m256, f256, _, kw256 = _tiny_llama(dev, quants.GGML_TYPE_Q4_0, 256)
    k256 = torch.zeros((2, 1, 640, 256), device=dev, dtype=torch.bfloat16)
    for w, step in ((m256, lm.llama_megastep_cuda),
                    (f256, lf.llama_flat_megastep_cuda)):
        with pytest.raises(ValueError, match="heads of"):
            step(w, x, k256, k256.clone(), p, **kw256)
    with pytest.raises(ValueError):
        lm.llama_megastep_cuda(mega, x, kc, vc, p.repeat(2), **kw)
    with pytest.raises(ValueError, match="bfloat16"):
        lm.llama_megastep_cuda(mega._replace(o_scales=mega.o_scales.float()),
                               x, kc, vc, p, **kw)
    assert (lm.KERNEL.launches, lf.KERNEL.launches) == before


# slots of the batched llama steps: at positions on both sides of K4's
# 256-row pages, the first at pos 0 (B = 1 takes it alone)
LLAMA_MIXED = (0, 255, 256, 257, 639, 511, 1, 300, 128, 383, 384, 500, 512,
               600, 2, 638)


def _llama_batch(dev, b):
    kc = torch.randn((2, b, 2, 640, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((2, b, 2, 640, 64), device=dev).to(torch.bfloat16)
    x = torch.randn((b, 256), device=dev)
    pos = torch.tensor(LLAMA_MIXED[:b], dtype=torch.int32, device=dev)
    return x, kc, vc, pos


@pytest.mark.parametrize("b", [1, 5, 8, 16])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
def test_k9_matches_k8_and_plain(dev, qtype, b):
    """B slots at mixed positions (B up to 8 one batched persistent launch,
    16 two groups of 8): each slot's x_out, k_new, v_new and cache equal a K8 step
    on that slot's state bit for bit; against the plain version, LLAMA_TOL
    of the largest value."""
    torch.manual_seed(0)
    mega, _, _, kw = _tiny_llama(dev, qtype)
    x, kc, vc, pos = _llama_batch(dev, b)
    k1, v1 = kc.clone(), vc.clone()
    got = lm.llama_megastep_batched_cuda(mega, x, k1, v1, pos, **kw)
    assert got[0].shape == (b, 256) and got[1].shape == (2, b, 128)
    for s in range(b):
        ks, vs = kc[:, s].clone(), vc[:, s].clone()
        xs, kn, vn = lm.llama_megastep_cuda(mega, x[s:s + 1], ks, vs,
                                            pos[s:s + 1], **kw)
        assert torch.equal(got[0][s:s + 1], xs), s
        assert torch.equal(got[1][:, s], kn) and torch.equal(got[2][:, s], vn)
        assert torch.equal(k1[:, s], ks) and torch.equal(v1[:, s], vs)
    ref = lm.llama_megastep_batched_plain(mega, x, kc.clone(), vc.clone(),
                                          pos, **kw)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=LLAMA_TOL * r.abs().max().item())


@pytest.mark.parametrize("b", [1, 5, 8, 16])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
def test_k7_matches_k6_and_plain(dev, qtype, b):
    """K7 at mixed positions: each slot's logits, k_new, v_new and cache
    equal a K6 step on that slot's state bit for bit; the padded logits are
    exactly 0; against the plain version, LLAMA_TOL."""
    torch.manual_seed(0)
    _, flat, _, kw = _tiny_llama(dev, qtype)
    x, kc, vc, pos = _llama_batch(dev, b)
    k1, v1 = kc.clone(), vc.clone()
    got = lf.llama_flat_megastep_batched_cuda(flat, x, k1, v1, pos, **kw)
    assert got[0].shape == (b, 1024) and not got[0][:, 1000:].any()
    for s in range(b):
        ks, vs = kc[:, s].clone(), vc[:, s].clone()
        lg, kn, vn = lf.llama_flat_megastep_cuda(flat, x[s:s + 1], ks, vs,
                                                 pos[s:s + 1], **kw)
        assert torch.equal(got[0][s:s + 1], lg), s
        assert torch.equal(got[1][:, s], kn) and torch.equal(got[2][:, s], vn)
        assert torch.equal(k1[:, s], ks) and torch.equal(v1[:, s], vs)
    ref = lf.llama_flat_megastep_batched_plain(flat, x, kc.clone(), vc.clone(),
                                               pos, **kw)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=LLAMA_TOL * r.abs().max().item())


def test_batched_llama_launch_counters(dev):
    """K9 and K7 count their own launches: 5 slots of heads of 64 are one
    batched persistent launch on K9's or K7's counter, and K7's head GEMV
    one more on K7's; no K4, K6, K8 or K3 launch."""
    torch.manual_seed(0)
    mega, flat, _, kw = _tiny_llama(dev, quants.GGML_TYPE_Q4_0)
    x, kc, vc, pos = _llama_batch(dev, 5)
    counters = (lm.KERNEL_BATCHED, lf.KERNEL_BATCHED, da.KERNEL_BATCHED,
                lm.KERNEL, lf.KERNEL, da.KERNEL)
    before = [k.launches for k in counters]
    scratch = lm.step_scratch(mega, 5, 4, 640, dev)
    lm.llama_megastep_batched(mega, x, kc, vc, pos, scratch=scratch, **kw)
    lf.llama_flat_megastep_batched(flat, x, kc, vc, pos, scratch=scratch, **kw)
    torch.cuda.synchronize()
    after = [k.launches for k in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 2, 0, 0, 0, 0]


# The norm's statistics are summed in another order than the plain
# version's, which can flip the bf16 rounding of a few normalized inputs; a
# flip moves an output by about |w x| 2^-8, up to ~1e-3 of the largest one.
BOUNDARY_TOL = 5e-3


def _tiles(w, kind, up=None, d=0):
    """w (and SiLU's up) tiled for the GEMV, its pairs `kind`'s."""
    n = w.shape[0]
    rows = lm.gemv_pair_rows(kind, n if kind == "silu" else n // 2, d)
    return lm.gemv_tile(w.codes, w.scales, *rows,
                        codes_b=None if up is None else up.codes,
                        scales_b=None if up is None else up.scales)


def _llama_gemv(dev, x, w, qt, out, *, rms_w=None, res=None):
    """One launch of the llama GEMV on K7's counter: RMS(x; rms_w) @ W^T
    stored (EPI_STORE), or res + x @ W^T (EPI_RESIDUAL) without a norm."""
    import ctypes
    from tts_tpu_torch.ops import _build
    vp, null = _build.ptr, ctypes.c_void_p(0)
    b, k = x.shape
    rms = rms_w is not None
    codes, scales = _tiles(w, "pairs")
    lm.KERNEL_BATCHED(vp(x), vp(rms_w) if rms else null, int(rms), vp(codes),
                      vp(scales), vp(codes), vp(scales), qt, 1, 1, b,
                      w.shape[0], k, null if rms else vp(res), vp(out),
                      lm.EPI_STORE if rms else lm.EPI_RESIDUAL, null, null, 0,
                      null, null, 0, 0, 0, 0, 0, 0, _build.stream_ptr(dev))


@pytest.mark.parametrize("b,k", [(8, 3072), (16, 1536), (16, 3072), (8, 8192),
                                 (14, 8192), (16, 8192)])
def test_llama_gemv_at_the_48k_shared_memory_boundary(dev, b, k):
    """Launches whose dynamic shared memory (the warps' weight rings, rank
    0's slots for the other blocks' sums, and the block's K range of the b
    rows as bf16, lm.gemv_smem_bytes) spans 64-149 KB: past the 48 KB a
    block gets without opting in, and at 16 x 8192 (Orpheus's down at 16
    rows: K split over clusters of 4, 64 KB of rows a block) the most any
    launch asks. Every launch opts in to the most it may ask. The
    RMS-prologue GEMV against its plain version, within BOUNDARY_TOL."""
    torch.manual_seed(0)
    qt, n = quants.GGML_TYPE_Q4_0, 64
    w = _rand_quant(n, k, qt, torch.bfloat16, dev).pack()
    x = torch.randn((b, k), device=dev)
    nw = torch.rand(k, device=dev) + 0.5
    out = torch.empty((b, n), device=dev)
    _llama_gemv(dev, x, w, qt, out, rms_w=nw)
    ref = lm.dqdot(lm.rms_norm(x, nw), w.codes, w.scales, qt)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=BOUNDARY_TOL * ref.abs().max().item())


@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("k", [3072, 8192])
@pytest.mark.parametrize("b", [1, 8, 9, 16])
def test_llama_gemv_rows_equal_one_row(dev, b, k, rms):
    """Every row of a b-row launch equals a 1-row launch on that row bit for
    bit, with the RMS prologue and without (a residual add), at one n-tile
    (1-8 rows) and two (9-16), with K split over clusters of 2 (3072) and
    of 4 (8192)."""
    torch.manual_seed(0)
    qt, n = quants.GGML_TYPE_Q4_0, 1000
    w = _rand_quant(n, k, qt, torch.bfloat16, dev).pack()
    x = torch.randn((b, k), device=dev)
    nw = torch.rand(k, device=dev) + 0.5 if rms else None
    res = torch.randn((b, n), device=dev)
    out = torch.empty((b, n), device=dev)
    _llama_gemv(dev, x, w, qt, out, rms_w=nw, res=res)
    for r in range(b):
        one = torch.empty((1, n), device=dev)
        _llama_gemv(dev, x[r:r + 1], w, qt, one, rms_w=nw, res=res[r:r + 1])
        assert torch.equal(out[r:r + 1], one), f"row {r} of {b}"
    ref = (lm.dqdot(lm.rms_norm(x, nw), w.codes, w.scales, qt) if rms else
           res + lm.dqdot(x, w.codes, w.scales, qt))
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=BOUNDARY_TOL * ref.abs().max().item())


def _gemv(dev, x, w, out, epi, *, rms_w=None, res=None, up=None, rope=None):
    """One launch of tts_llama_gemv on K7's counter: x (b, K) against the
    QuantTensor w (its qtype, packing and scale dtype; tiled for the launch
    by _tiles), with an RMS prologue when rms_w is given; `up` is SiLU(gate)
    * up's second weight;
    `rope` (pos, inv, hidden, kvh, d, kc, vc) feeds the RoPE epilogue, row
    r's cache at kc / vc[r] (bf16, (n_kv, ctx, d) each)."""
    import ctypes
    from tts_tpu_torch.ops import _build
    vp, null = _build.ptr, ctypes.c_void_p(0)
    b, k = x.shape
    pos, inv, hidden, kvh, d, kc, vc = rope if rope is not None else \
        (None, None, 0, 0, 0, None, None)
    ctx = kc.shape[2] if kc is not None else 0
    kind = "rope" if rope is not None else "silu" if up is not None else "pairs"
    codes, scales = _tiles(w, kind, up, d)
    lm.KERNEL_BATCHED(
        vp(x), vp(rms_w) if rms_w is not None else null, int(rms_w is not None),
        vp(codes), vp(scales), vp(codes), vp(scales), w.qtype,
        int(w.is_packed), int(w.scales.dtype == torch.bfloat16), b, w.shape[0],
        k, vp(res) if res is not None else null, vp(out), epi,
        vp(inv) if inv is not None else null, vp(pos) if pos is not None else null,
        1, vp(kc) if kc is not None else null, vp(vc) if vc is not None else null,
        hidden, kvh, d, ctx, 1, kc[0].numel() if kc is not None else 0,
        _build.stream_ptr(dev))


GEMV_EPIS = ("store", "residual", "silu", "rope_qkv", "rope_q")


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0,
                                   quants.GGML_TYPE_Q8_0])
@pytest.mark.parametrize("epi", GEMV_EPIS)
def test_gemv_row_in_each_position_equals_one_row(dev, epi, qtype, scale_dtype):
    """The tensor-core GEMV gives a row the same bits in each of the 16
    positions of a launch (two n-tiles of 8 columns) as a one-row launch
    gives it: each epilogue (store and SiLU(gate) * up with the RMS
    prologue, the residual add without, RoPE with the k / v cache write and
    with q alone), Q4_0 packed, Q5_0 and Q8_0, f32 and bf16 scales. Rows at
    their own positions write their own caches, compared too."""
    from tts_tpu_torch.ops.attention import rope_freqs
    torch.manual_seed(0)
    b, k, heads, kv, d, ctx = 16, 512, 4, 2, 64, 64
    hidden, kvh = heads * d, kv * d
    n = {"rope_qkv": hidden + 2 * kvh, "rope_q": hidden}.get(epi, 384)
    w = _rand_quant(n, k, qtype, scale_dtype, dev).pack()
    up = _rand_quant(n, k, qtype, scale_dtype, dev).pack() if epi == "silu" else None
    x = torch.randn((b, k), device=dev)
    rms_w = None if epi == "residual" else torch.rand(k, device=dev) + 0.5
    res = torch.randn((b, n), device=dev) if epi == "residual" else None
    code = {"store": lm.EPI_STORE, "residual": lm.EPI_RESIDUAL,
            "silu": lm.EPI_SILU_MUL}.get(epi, lm.EPI_ROPE_QKV)
    pos = torch.randint(0, ctx, (b,), dtype=torch.int32, device=dev)
    inv = rope_freqs(d, 10000.0, device=dev)
    kc0 = torch.randn((b, kv, ctx, d), device=dev).to(torch.bfloat16)
    vc0 = torch.randn((b, kv, ctx, d), device=dev).to(torch.bfloat16)

    def launch(rows, kc, vc):
        out = torch.empty((len(range(*rows.indices(b))), n), device=dev)
        rope = None
        if epi.startswith("rope"):
            cache = (kc, vc) if epi == "rope_qkv" else (None, None)
            rope = (pos[rows], inv, hidden, kvh if epi == "rope_qkv" else 0, d,
                    *cache)
        _gemv(dev, x[rows], w, out, code, rms_w=rms_w, up=up,
              res=res[rows] if res is not None else None, rope=rope)
        return out

    kc, vc = kc0.clone(), vc0.clone()
    out = launch(slice(0, b), kc, vc)
    for r in range(b):
        k1, v1 = kc0[r:r + 1].clone(), vc0[r:r + 1].clone()
        one = launch(slice(r, r + 1), k1, v1)
        assert torch.equal(out[r:r + 1], one), f"row {r}"
        assert torch.equal(kc[r:r + 1], k1) and torch.equal(vc[r:r + 1], v1), r
    if epi in ("store", "residual"):
        ref = lm.dqdot(lm.rms_norm(x, rms_w), w.codes, w.scales, qtype) \
            if rms_w is not None else res + lm.dqdot(x, w.codes, w.scales, qtype)
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=BOUNDARY_TOL * ref.abs().max().item())


def test_gemv_chain_with_k3_between_equals_plain(dev):
    """100 iterations of a layer's dependent launches, enqueued with no host
    sync: q = RMS(x) @ Wq into one reused buffer, K3 with q's heads over a
    fixed cache into one reused buffer, x' = x + attn @ Wo into the next row
    of a history. Each iteration is then held to the plain version computed
    from the kernels' own x before it: a launch that read its input before
    the kernel before it had finished (before griddepcontrol.wait), or
    wrote a buffer that kernel still read, shows as an iteration that
    disagrees."""
    torch.manual_seed(0)
    qt, H, heads, d, ctx, steps = quants.GGML_TYPE_Q4_0, 256, 4, 64, 320, 100
    wq = _rand_quant(H, H, qt, torch.bfloat16, dev).pack()
    wo = _rand_quant(H, H, qt, torch.bfloat16, dev).pack()
    nw = torch.rand(H, device=dev) + 0.5
    kc = torch.randn((1, heads, ctx, d), device=dev).to(torch.bfloat16)
    vc = torch.randn((1, heads, ctx, d), device=dev).to(torch.bfloat16)
    pos = torch.tensor([300], dtype=torch.int32, device=dev)
    hist = torch.empty((steps + 1, 1, H), device=dev)
    hist[0] = torch.randn((1, H), device=dev)
    q = torch.empty((1, H), device=dev)
    attn = torch.empty((1, heads, d), device=dev)
    part = da.attention_scratch(1, heads, ctx, d, dev)
    for i in range(steps):
        _gemv(dev, hist[i], wq, q, lm.EPI_STORE, rms_w=nw)
        da._launch(da.KERNEL, q.view(1, heads, d), kc, vc, pos, None, attn, part)
        _gemv(dev, attn.view(1, H), wo, hist[i + 1], lm.EPI_RESIDUAL, res=hist[i])
    torch.cuda.synchronize()
    for i in range(steps):
        q_ref = lm.dqdot(lm.rms_norm(hist[i], nw), wq.codes, wq.scales, qt)
        a_ref = da.decode_attention_plain(q_ref.view(heads, d), kc[0], vc[0], pos)
        upd = lm.dqdot(a_ref.reshape(1, H), wo.codes, wo.scales, qt)
        torch.testing.assert_close(hist[i + 1] - hist[i], upd, rtol=0,
                                   atol=BOUNDARY_TOL * upd.abs().max().item(),
                                   msg=lambda m, i=i: f"iteration {i}: {m}")


def _parler_gemv(dev, x, w, out, epi, *, ln=None, res=None, cache=None):
    """One launch of tts_parler_gemv on K5's counter: x (b, K) against the
    QuantTensor w, tiled as the prep tiles it (pm.tile_projection), with the
    layer norm (ln = (weight, bias)) as a prologue when given; `cache` (kc,
    vc, pos, hidden, d) feeds the qkv epilogue, row r's cache at kc / vc[r]
    (bf16, (heads, ctx, d) each)."""
    import ctypes
    from tts_tpu_torch.ops import _build
    vp, null = _build.ptr, ctypes.c_void_p(0)
    b, k = x.shape
    codes, scales = pm.tile_projection(w)
    kc, vc, pos, hidden, d = cache if cache is not None else \
        (None, None, None, 0, 0)

    def opt(t):
        return vp(t) if t is not None else null

    pm.KERNEL_BATCHED(vp(x), opt(ln and ln[0]), opt(ln and ln[1]),
                      int(ln is not None), vp(codes), vp(scales), w.qtype,
                      int(w.pack().is_packed), b, w.shape[0], k, opt(res),
                      vp(out), epi, opt(kc), opt(vc), opt(pos), hidden, d,
                      kc.shape[2] if kc is not None else 0, 1,
                      kc[0].numel() if kc is not None else 0,
                      _build.stream_ptr(dev))


def _parler_plain(x, w, epi, *, ln=None, res=None):
    """The GEMV's plain version: `_dqdot` of LN?(x) and w, then the
    epilogue (the qkv epilogue's outputs are its store's)."""
    h = pm.layer_norm(x, *ln) if ln is not None else x
    y = pm._qdot(h, w.codes, w.scales, w.qtype)
    if epi == pm.EPI_GELU:
        return torch.nn.functional.gelu(y, approximate="tanh")
    return res + y if epi == pm.EPI_RESIDUAL else y


PARLER_EPIS = {"qkv": pm.EPI_QKV, "store": pm.EPI_STORE, "gelu": pm.EPI_GELU,
               "residual": pm.EPI_RESIDUAL}


@pytest.mark.parametrize("k", [384, 4096])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0,
                                   quants.GGML_TYPE_Q8_0])
@pytest.mark.parametrize("epi", list(PARLER_EPIS))
def test_parler_gemv_row_in_each_position_equals_one_row(dev, epi, qtype, k):
    """The Parler GEMV (K2, K5, K12) gives a row the same bits in each of
    the 16 positions of a launch (two n-tiles of 8 columns) as a one-row
    launch gives it: each epilogue (qkv with its k / v cache write, store
    and tanh-GELU behind the layer norm, the residual add without), Q4_0,
    Q5_0 and Q8_0, at K 384 (3 stages, no K split: 8 tiles a block) and K
    4096 (K split over the block's 8 warps, 4 stages each). Rows at their
    own positions write their own caches, compared too; the launch is held
    to its plain version within BOUNDARY_TOL."""
    torch.manual_seed(0)
    b, heads, d, ctx = 16, 4, 64, 64
    hidden = heads * d
    code = PARLER_EPIS[epi]
    n = 3 * hidden if epi == "qkv" else 384
    w = _rand_quant(n, k, qtype, torch.bfloat16, dev).pack()
    x = torch.randn((b, k), device=dev)
    ln = None if epi == "residual" else (torch.rand(k, device=dev) + 0.5,
                                         torch.randn(k, device=dev) * 0.1)
    res = torch.randn((b, n), device=dev) if epi == "residual" else None
    pos = torch.randint(0, ctx, (b,), dtype=torch.int32, device=dev)
    kc0 = torch.randn((b, heads, ctx, d), device=dev).to(torch.bfloat16)
    vc0 = torch.randn((b, heads, ctx, d), device=dev).to(torch.bfloat16)

    def launch(rows, kc, vc):
        out = torch.empty((len(range(*rows.indices(b))), n), device=dev)
        cache = (kc, vc, pos[rows], hidden, d) if epi == "qkv" else None
        _parler_gemv(dev, x[rows], w, out, code, ln=ln,
                     res=res[rows] if res is not None else None, cache=cache)
        return out

    kc, vc = kc0.clone(), vc0.clone()
    out = launch(slice(0, b), kc, vc)
    for r in range(b):
        k1, v1 = kc0[r:r + 1].clone(), vc0[r:r + 1].clone()
        one = launch(slice(r, r + 1), k1, v1)
        assert torch.equal(out[r:r + 1], one), f"row {r}"
        assert torch.equal(kc[r:r + 1], k1) and torch.equal(vc[r:r + 1], v1), r
    if epi == "qkv":   # row r's k and v, in bf16, at its cache row pos[r]
        for r in range(b):
            p = int(pos[r])
            assert torch.equal(kc[r, :, p], out[r, hidden:2 * hidden].view(
                heads, d).to(torch.bfloat16))
            assert torch.equal(vc[r, :, p], out[r, 2 * hidden:].view(
                heads, d).to(torch.bfloat16))
    ref = _parler_plain(x, w, code, ln=ln, res=res)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=BOUNDARY_TOL * ref.abs().max().item())


@pytest.mark.parametrize("b,k,qtype", [
    (3, 1024, quants.GGML_TYPE_Q4_0), (4, 1024, quants.GGML_TYPE_Q4_0),
    (16, 4096, quants.GGML_TYPE_Q4_0), (16, 4096, quants.GGML_TYPE_Q8_0)])
def test_parler_gemv_at_the_48k_shared_memory_boundary(dev, b, k, qtype):
    """The Parler GEMV's dynamic shared memory (the warps' weight rings,
    the K-range partial sums and the b rows as bf16, pm.gemv_smem_bytes)
    crosses the 48 KB a block gets without opting in between 3 and 4 rows
    of Parler-Mini's K 1024 (47,200 and 49,280 bytes), and is largest at 16
    rows of its F 4096 (fc2 of K5 at 16 slots: 176,640 bytes for Q4_0,
    209,408 for Q8_0). Every instantiation opts in to the most a launch may
    ask; the LN-prologue launch agrees with its plain version within
    BOUNDARY_TOL."""
    smem = pm.gemv_smem_bytes(b, k, qtype == quants.GGML_TYPE_Q4_0)
    assert (smem > 48 * 1024) == ((b, k) != (3, 1024))
    assert smem <= pm.GEMV_SMEM_LIMIT
    torch.manual_seed(0)
    n = 64
    w = _rand_quant(n, k, qtype, torch.bfloat16, dev).pack()
    x = torch.randn((b, k), device=dev)
    ln = (torch.rand(k, device=dev) + 0.5, torch.randn(k, device=dev) * 0.1)
    out = torch.empty((b, n), device=dev)
    _parler_gemv(dev, x, w, out, pm.EPI_STORE, ln=ln)
    ref = _parler_plain(x, w, pm.EPI_STORE, ln=ln)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=BOUNDARY_TOL * ref.abs().max().item())


@pytest.mark.parametrize("sb,n_tail", [(128, 896), (128, 0), (256, 768),
                                       (512, 512), (1024, 0)])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_dia_cross_attention_matches_plain(dev, sb, n_tail, cache_dtype):
    """The cross-attention of K10 / K11 (every bucket row attended, scale
    1.0, the tail merged after the pages) against its plain version: 1e-5
    of the largest output."""
    torch.manual_seed(0)
    q = torch.randn((3, 4, 128), device=dev)
    ck = torch.randn((3, 4, sb, 128), device=dev).to(cache_dtype)
    cv = torch.randn((3, 4, sb, 128), device=dev).to(cache_dtype)
    vt = torch.randn((3, 4, 128), device=dev) * 10
    got = dm.cross_attention_cuda(q, ck, cv, vt, n_tail)
    ref = dm.cross_attention_plain(q, ck, cv, vt, n_tail)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


def _tiny_dia(dev, qtype):
    """Two random Dia decoder layers at H=256 (4 q / 2 kv heads of 64, F
    512) as K10's weights (bf16 scales; Q8_0 scales divided by 16, as in
    _tiny_mega)."""
    from tts_tpu_torch.models.dia.model import DiaDecoderLayer
    L, H, F = 2, 256, 512
    div = 16.0 if qtype == quants.GGML_TYPE_Q8_0 else 1.0

    def stack(n, k):
        ws = [_rand_quant(n, k, qtype, torch.float32, dev).pack()
              for _ in range(L)]
        return qm.QuantTensor(torch.stack([w.codes for w in ws]),
                              torch.stack([w.scales for w in ws]) / div, qtype)

    vec = lambda: torch.randn((L, H), device=dev) * 0.1 + 1  # noqa: E731
    lw = DiaDecoderLayer(vec(), stack(H, H), stack(128, H), stack(128, H),
                         stack(H, H), vec(), stack(H, H), None, None,
                         stack(H, H), vec(), stack(F, H), stack(F, H),
                         stack(H, F))
    mega, qt = dm.prep_dia_mega(lw, 64)
    return mega, dict(qtype=qt, n_heads=4, n_kv=2)


def _dia_cross(dev, lead, sb):
    ck = torch.randn((2, *lead, 4, sb, 64), device=dev).to(torch.bfloat16)
    cv = torch.randn((2, *lead, 4, sb, 64), device=dev).to(torch.bfloat16)
    return ck, cv, torch.randn((2, *lead, 4, 64), device=dev) * 8


@pytest.mark.parametrize("sb,n_tail", [(128, 896), (256, 0)])
@pytest.mark.parametrize("pos", [0, 255, 256, 639])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
def test_k10_matches_plain(dev, qtype, pos, sb, n_tail):
    """K10 against its plain version (LLAMA_TOL: the same roundings, f32
    sums in another order); the step writes each row's k/v (in bf16) at
    row pos of that row's cache and no other row."""
    torch.manual_seed(0)
    mega, kw = _tiny_dia(dev, qtype)
    kc = torch.randn((2, 2, 2, 640, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((2, 2, 2, 640, 64), device=dev).to(torch.bfloat16)
    ck, cv, vt = (t.flatten(1, 2) for t in _dia_cross(dev, (2,), sb))
    x = torch.randn((2, 256), device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = dm.dia_megastep_cuda(mega, x, k1, v1, p, ck, cv, vt, n_tail, **kw)
    ref = dm.dia_megastep_plain(mega, x, k2, v2, p, ck, cv, vt, n_tail, **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=LLAMA_TOL * b.abs().max().item())
    rows = torch.arange(640, device=dev) != pos
    assert torch.equal(k1[:, :, :, rows], kc[:, :, :, rows])
    assert torch.equal(v1[:, :, :, rows], vc[:, :, :, rows])
    assert torch.equal(k1[:, :, :, pos], got[1].reshape(2, 2, 2, 64).to(torch.bfloat16))
    assert torch.equal(v1[:, :, :, pos], got[2].reshape(2, 2, 2, 64).to(torch.bfloat16))


def _dia_state(dev, cache_dtype, ctx, sb):
    """A pair's random state for the tiny Dia: x (2, 256), caches (2, 2, 2,
    ctx, 64) and the bucketed cross K/V (2, 2, 4, sb, 64) with its tail."""
    kc = torch.randn((2, 2, 2, ctx, 64), device=dev).to(cache_dtype)
    vc = torch.randn((2, 2, 2, ctx, 64), device=dev).to(cache_dtype)
    return torch.randn((2, 256), device=dev), kc, vc, _dia_cross(dev, (2,), sb)


def _launch_sequence(mega, x, kc, vc, p, ck, cv, vt, n_tail, kw):
    """K10's function through the launch sequence: K11 at one pair (views
    of the same caches, written in place)."""
    return dm.dia_megastep_batched_cuda(mega, x, kc[:, None], vc[:, None], p,
                                        ck[:, None], cv[:, None], vt[:, None],
                                        n_tail, **kw)


@pytest.mark.parametrize("sb,n_tail", [(128, 896), (1024, 0)])
@pytest.mark.parametrize("pos", [0, 255, 256, 1000])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0,
                                   quants.GGML_TYPE_Q8_0])
def test_persistent_k10_equals_launch_sequence(dev, qtype, cache_dtype, pos,
                                               sb, n_tail):
    """The persistent K10 (one cooperative launch) against the launch
    sequence on the same state: x_out, k_new, v_new and both caches bit for
    bit; cache row pos is the only row either writes."""
    torch.manual_seed(0)
    mega, kw = _tiny_dia(dev, qtype)
    ctx = 1024
    x, kc, vc, (ck, cv, vt) = _dia_state(dev, cache_dtype, ctx, sb)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = dm.KERNEL.launches
    got = dm.dia_megastep_cuda(mega, x, k1, v1, p, ck.flatten(1, 2),
                               cv.flatten(1, 2), vt.flatten(1, 2), n_tail, **kw)
    assert dm.KERNEL.launches - before == 1
    seq = _launch_sequence(mega, x, k2, v2, p, ck, cv, vt, n_tail, kw)
    for a, b in zip(got, seq):
        assert torch.equal(a, b)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    rows = torch.arange(ctx, device=dev) != pos
    assert torch.equal(k1[:, :, :, rows], kc[:, :, :, rows])
    assert torch.equal(v1[:, :, :, rows], vc[:, :, :, rows])
    assert torch.equal(k1[:, :, :, pos], got[1].reshape(2, 2, 2, 64).to(cache_dtype))


def test_persistent_k10_repeats_its_bits(dev):
    """1,000 launches back to back on the same state (each rewrites cache
    row pos with the same bits) give the first launch's outputs bit for
    bit: the grid barrier's generation word runs on over 143 x 1,000
    barriers without a reset, and the arrival counters stay zeroed."""
    torch.manual_seed(0)
    mega, kw = _tiny_dia(dev, quants.GGML_TYPE_Q4_0)
    x, kc, vc, (ck, cv, vt) = _dia_state(dev, torch.bfloat16, 1024, 256)
    p = torch.tensor([700], dtype=torch.int32, device=dev)
    args = (ck.flatten(1, 2), cv.flatten(1, 2), vt.flatten(1, 2), 768)
    first = [t.clone() for t in dm.dia_megastep_cuda(mega, x, kc, vc, p, *args, **kw)]
    outs = [dm.dia_megastep_cuda(mega, x, kc, vc, p, *args, **kw) for _ in range(1000)]
    for i, o in enumerate(first):
        assert torch.equal(torch.stack([r[i] for r in outs]),
                           o.expand(1000, *o.shape)), i


def test_persistent_k10_one_launch_and_refusals(dev):
    """One launch a step on K10's own counter over a grid of whole SMs; no
    GEMV, K4 or cross-attention launch. What the persistent step does not
    take raises, with no launch: f32 cross K/V, two positions."""
    torch.manual_seed(0)
    mega, kw = _tiny_dia(dev, quants.GGML_TYPE_Q4_0)
    x, kc, vc, (ck, cv, vt) = _dia_state(dev, torch.bfloat16, 640, 256)
    ck, cv, vt = (t.flatten(1, 2) for t in (ck, cv, vt))
    counters = (dm.KERNEL, dm.KERNEL_BATCHED, dm.CROSS, dm.CROSS_BATCHED,
                da.KERNEL, da.KERNEL_BATCHED)
    before = [k.launches for k in counters]
    for i in range(3):
        dm.dia_megastep(mega, x, kc, vc, torch.tensor([i], dtype=torch.int32,
                                                      device=dev),
                        ck, cv, vt, 768, **kw)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [3, 0, 0, 0, 0, 0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert dfl.launched_blocks == sms * dfl.blocks_per_sm and dfl.blocks_per_sm >= 1
    p = torch.tensor([3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bf16 cross K/V"):
        dm.dia_megastep_cuda(mega, x, kc, vc, p, ck.float(), cv.float(), vt,
                             768, **kw)
    with pytest.raises(ValueError):
        dm.dia_megastep_cuda(mega, x, kc, vc, p.repeat(2), ck, cv, vt, 768, **kw)
    assert dm.KERNEL.launches - before[0] == 3


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
def test_k11_matches_k10_and_plain(dev, qtype, b):
    """K11 at b pairs at mixed positions across the 256-row pages (one at
    0), n_tail 768: each pair's outputs and caches equal K10 on that pair's
    state bit for bit; the whole against the plain version (LLAMA_TOL);
    the launch counters count K11's own launches."""
    torch.manual_seed(0)
    mega, kw = _tiny_dia(dev, qtype)
    slots = [0, 255, 256, 257, 300, 511, 512, 639][:b]
    kc = torch.randn((2, b, 2, 2, 640, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((2, b, 2, 2, 640, 64), device=dev).to(torch.bfloat16)
    ck, cv, vt = _dia_cross(dev, (b, 2), 256)
    x = torch.randn((2 * b, 256), device=dev)
    pos = torch.tensor(slots, dtype=torch.int32, device=dev)
    before = (dm.KERNEL_BATCHED.launches, dm.CROSS_BATCHED.launches)
    k1, v1 = kc.clone(), vc.clone()
    got = dm.dia_megastep_batched_cuda(mega, x, k1, v1, pos, ck, cv, vt, 768,
                                       **kw)
    assert (dm.KERNEL_BATCHED.launches - before[0],
            dm.CROSS_BATCHED.launches - before[1]) == (12, 2)
    for s in range(b):
        ks, vs = kc[:, s].clone(), vc[:, s].clone()
        one = dm.dia_megastep_cuda(mega, x[2 * s:2 * s + 2], ks, vs,
                                   pos[s:s + 1],
                                   *(t[:, s].flatten(1, 2).contiguous()
                                     for t in (ck, cv, vt)), 768, **kw)
        r = slice(2 * s, 2 * s + 2)
        assert torch.equal(got[0][r], one[0])
        assert torch.equal(got[1][:, r], one[1]) and torch.equal(got[2][:, r], one[2])
        assert torch.equal(k1[:, s], ks) and torch.equal(v1[:, s], vs)
    ref = dm.dia_megastep_batched_plain(mega, x, kc.clone(), vc.clone(), pos,
                                        ck, cv, vt, 768, **kw)
    for a, r_ in zip(got, ref):
        torch.testing.assert_close(a, r_, rtol=0,
                                   atol=LLAMA_TOL * r_.abs().max().item())


# ---------------------------------------------------------------------------
# slot groups: batched steps past the rows one launch takes
# ---------------------------------------------------------------------------

# 20 slots at positions on both sides of the 256-row pages, in no order
GROUP_POS = (0, 255, 256, 257, 639, 511, 1, 300, 128, 383, 384, 500, 512,
             600, 2, 638, 254, 513, 100, 767)


def test_grouped_k5_equals_k2(dev):
    """K5 at 20 slots runs as two groups of 10: each slot's x_out, k_new,
    v_new and cache equal a K2 step on that slot's state bit for bit, and
    the groups launch 2 x 8 per layer on K5's counter."""
    torch.manual_seed(0)
    mega, qt = _tiny_mega(dev, quants.GGML_TYPE_Q4_0)
    b, L, heads, ctx = 20, 2, 4, 768
    pos = torch.tensor(GROUP_POS, dtype=torch.int32, device=dev)
    kc = torch.randn((L, b, heads, ctx, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((L, b, heads, ctx, 64), device=dev).to(torch.bfloat16)
    x = torch.randn((b, 256), device=dev)
    kw = dict(qtype=qt, use_cross=True, n_heads=heads)
    k1, v1 = kc.clone(), vc.clone()
    before = pm.KERNEL_BATCHED.launches
    scratch = pm.step_scratch(mega, b, heads, ctx, dev)
    got = pm.parler_megastep_batched(mega, x, k1, v1, pos, scratch=scratch, **kw)
    assert pm.KERNEL_BATCHED.launches - before == 2 * 6 * L
    assert got[0].shape == (b, 256) and got[1].shape == (L, b, 256)
    for s in range(b):
        ks, vs = kc[:, s].clone(), vc[:, s].clone()
        xs, kn, vn = pm.parler_megastep_cuda(mega, x[s:s + 1], ks, vs,
                                             pos[s:s + 1], **kw)
        assert torch.equal(got[0][s:s + 1], xs), s
        assert torch.equal(got[1][:, s], kn) and torch.equal(got[2][:, s], vn)
        assert torch.equal(k1[:, s], ks) and torch.equal(v1[:, s], vs)


@pytest.mark.parametrize("route", ["k9", "k7"])
def test_grouped_llama_steps_equal_one_sequence(dev, route):
    """K9 / K7 at 20 slots (two groups of 10, the head GEMV per group):
    each slot equals a K8 / K6 step on that slot's state bit for bit."""
    torch.manual_seed(0)
    mega, flat, _, kw = _tiny_llama(dev, quants.GGML_TYPE_Q4_0)
    b = 20
    kc = torch.randn((2, b, 2, 640, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((2, b, 2, 640, 64), device=dev).to(torch.bfloat16)
    x = torch.randn((b, 256), device=dev)
    pos = torch.tensor([min(p, 639) for p in GROUP_POS], dtype=torch.int32,
                       device=dev)
    batched, one, w = ((lm.llama_megastep_batched_cuda, lm.llama_megastep_cuda,
                        mega) if route == "k9" else
                       (lf.llama_flat_megastep_batched_cuda,
                        lf.llama_flat_megastep_cuda, flat))
    k1, v1 = kc.clone(), vc.clone()
    scratch = lm.step_scratch(mega, b, 4, 640, dev)
    got = batched(w, x, k1, v1, pos, scratch=scratch, **kw)
    assert got[0].shape[0] == b and got[1].shape == (2, b, 128)
    for s in range(b):
        ks, vs = kc[:, s].clone(), vc[:, s].clone()
        o, kn, vn = one(w, x[s:s + 1], ks, vs, pos[s:s + 1], **kw)
        assert torch.equal(got[0][s:s + 1], o), s
        assert torch.equal(got[1][:, s], kn) and torch.equal(got[2][:, s], vn)
        assert torch.equal(k1[:, s], ks) and torch.equal(v1[:, s], vs)


def test_grouped_k11_equals_k10(dev):
    """K11 at 12 pairs runs as two groups of 6 pairs (12 rows): each pair's
    outputs and caches equal K10 on that pair's state bit for bit."""
    torch.manual_seed(0)
    mega, kw = _tiny_dia(dev, quants.GGML_TYPE_Q4_0)
    b = 12
    kc = torch.randn((2, b, 2, 2, 640, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((2, b, 2, 2, 640, 64), device=dev).to(torch.bfloat16)
    ck, cv, vt = _dia_cross(dev, (b, 2), 256)
    x = torch.randn((2 * b, 256), device=dev)
    pos = torch.tensor([min(p, 639) for p in GROUP_POS[:b]], dtype=torch.int32,
                       device=dev)
    k1, v1 = kc.clone(), vc.clone()
    scratch = dm.step_scratch(mega, 2 * b, 4, 640, 256, dev)
    before = dm.KERNEL_BATCHED.launches
    got = dm.dia_megastep_batched_cuda(mega, x, k1, v1, pos, ck, cv, vt, 768,
                                       scratch=scratch, **kw)
    assert dm.KERNEL_BATCHED.launches - before == 2 * 6 * 2
    for s in range(b):
        ks, vs = kc[:, s].clone(), vc[:, s].clone()
        one = dm.dia_megastep_cuda(mega, x[2 * s:2 * s + 2], ks, vs,
                                   pos[s:s + 1],
                                   *(t[:, s].flatten(1, 2).contiguous()
                                     for t in (ck, cv, vt)), 768, **kw)
        r = slice(2 * s, 2 * s + 2)
        assert torch.equal(got[0][r], one[0]), s
        assert torch.equal(got[1][:, r], one[1]) and torch.equal(got[2][:, r], one[2])
        assert torch.equal(k1[:, s], ks) and torch.equal(v1[:, s], vs)


# ---------------------------------------------------------------------------
# K12: the one-launch Parler step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("use_cross", [True, False])
@pytest.mark.parametrize("pos", [0, 255, 256, 639])
@pytest.mark.parametrize("qtype", [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q8_0])
def test_k12_matches_plain_and_k2(dev, qtype, pos, use_cross, cache_dtype):
    """K12 equals K2 on the same state bit for bit (x_out, k_new, v_new and
    the cache); against its plain version, 5e-4 of the largest value (see
    test_k2_matches_plain); it writes row pos and no other row. The cross
    K/V have 300 rows, so the cross-attention takes two pages and their
    combine."""
    torch.manual_seed(0)
    mega, qt = _tiny_mega(dev, qtype, tc=300)
    L, heads, ctx = 2, 4, 640
    flat = pf.prep_parler_flat(mega, qt, ctx, use_cross=use_cross)
    x = torch.randn((1, 256), device=dev)
    kc = torch.randn((L, heads, ctx, 64), device=dev).to(cache_dtype)
    vc = torch.randn((L, heads, ctx, 64), device=dev).to(cache_dtype)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    k12, v12, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = pf.parler_flat_megastep(flat, x, k12, v12, p, qtype=qt, n_heads=heads)
    two = pm.parler_megastep_cuda(mega, x, k2, v2, p, qtype=qt,
                                  use_cross=use_cross, n_heads=heads)
    for a, b in zip(got, two):
        assert torch.equal(a, b)
    assert torch.equal(k12, k2) and torch.equal(v12, v2)
    ref = pf.parler_flat_megastep_plain(flat, x, kc.clone(), vc.clone(), p,
                                        qtype=qt, n_heads=heads)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * b.abs().max().item())
    rows = torch.arange(ctx, device=dev) != pos
    assert torch.equal(k12[:, :, rows], kc[:, :, rows])
    assert torch.equal(v12[:, :, rows], vc[:, :, rows])
    assert torch.equal(k12[:, :, pos], got[1].reshape(L, heads, 64).to(cache_dtype))


@pytest.mark.parametrize("use_cross", [True, False])
@pytest.mark.parametrize("pos", [0, 256, 300])
def test_k12_equals_k2_with_its_barrier_plan(dev, pos, use_cross):
    """K12 on 2 layers equals K2 bit for bit (x_out, k_new, v_new and both
    caches) at pos 0 / 256 / 300 with and without the cross block (a
    300-row cross K/V: two pages merged by arrival), and its block 0 counts
    the grid barriers of the plan: 6 a layer with the cross block, 4
    without, none after the last fc2."""
    torch.manual_seed(0)
    mega, qt = _tiny_mega(dev, quants.GGML_TYPE_Q4_0, tc=300)
    L, heads, ctx = 2, 4, 640
    flat = pf.prep_parler_flat(mega, qt, ctx, use_cross=use_cross)
    x = torch.randn((1, 256), device=dev)
    kc = torch.randn((L, heads, ctx, 64), device=dev).to(torch.bfloat16)
    vc = torch.randn((L, heads, ctx, 64), device=dev).to(torch.bfloat16)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    k12, v12, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = pf.parler_flat_megastep_cuda(flat, x, k12, v12, p, qtype=qt,
                                       n_heads=heads)
    assert pf.barriers_passed() == pf.barriers(L, use_cross) == \
        (11 if use_cross else 7)
    two = pm.parler_megastep_cuda(mega, x, k2, v2, p, qtype=qt,
                                  use_cross=use_cross, n_heads=heads)
    for a, b in zip(got, two):
        assert torch.equal(a, b)
    assert torch.equal(k12, k2) and torch.equal(v12, v2)


def test_k12_launch_counter(dev):
    """One K12 launch per step on K12's own counter, over a grid of whole
    SMs; K2's GEMV and K3 are not launched."""
    torch.manual_seed(0)
    mega, qt = _tiny_mega(dev, quants.GGML_TYPE_Q4_0)
    flat = pf.prep_parler_flat(mega, qt, 640)
    kc = torch.zeros((2, 4, 640, 64), device=dev, dtype=torch.bfloat16)
    counters = (pf.KERNEL, pm.KERNEL, da.KERNEL)
    before = [k.launches for k in counters]
    for i in range(3):
        pf.parler_flat_megastep(flat, torch.randn((1, 256), device=dev), kc,
                                kc.clone(), torch.tensor([i], dtype=torch.int32,
                                                         device=dev),
                                qtype=qt, n_heads=4)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [3, 0, 0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert pf.launched_blocks % sms == 0 and pf.launched_blocks >= sms


# ---------------------------------------------------------------------------
# K9 / K7's batched persistent step (csrc/llama_flat_batched.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("route", ["k9", "k7"])
def test_persistent_k9_equals_layers_cuda(dev, route, cache_dtype):
    """3 slots at positions 255, 256 and 600 (one, two and three pages) in
    one batched persistent launch equal the launch sequence
    (`layers_cuda`, and K7's head GEMV after it) bit for bit: x_out (the
    logits), k_new, v_new and every cache; one launch on K9's counter (K7:
    the step and its head), no K4."""
    torch.manual_seed(0)
    mega, flat, _, kw = _tiny_llama(dev, quants.GGML_TYPE_Q4_0)
    w, step, seq, counter = (
        (mega, lm.llama_megastep_batched_cuda, lm.llama_megastep_batched_sequence,
         lm.KERNEL_BATCHED) if route == "k9" else
        (flat, lf.llama_flat_megastep_batched_cuda,
         lf.llama_flat_megastep_batched_sequence, lf.KERNEL_BATCHED))
    kc = torch.randn((2, 3, 2, 640, 64), device=dev).to(cache_dtype)
    vc = torch.randn((2, 3, 2, 640, 64), device=dev).to(cache_dtype)
    x = torch.randn((3, 256), device=dev)
    pos = torch.tensor([255, 256, 600], dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = (counter.launches, da.KERNEL_BATCHED.launches)
    got = step(w, x, k1, v1, pos, **kw)
    torch.cuda.synchronize()
    assert (counter.launches - before[0], da.KERNEL_BATCHED.launches - before[1]) \
        == ((1 if route == "k9" else 2), 0)
    ref = seq(w, x, k2, v2, pos, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


# the GGUF quantize kernel (csrc/quantize.cu; no TPU kernel: the JAX
# quantizer's host path, tts_tpu/native.py quantize)

QUANT_TYPES = [quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0, quants.GGML_TYPE_Q8_0]


@pytest.mark.parametrize("qtype", QUANT_TYPES)
@pytest.mark.parametrize("n,k,scale", [(1, 32, 1.0), (3, 224, 1.0), (48, 96, 1.0),
                                       (256, 1024, 0.02), (1000, 4096, 0.02)])
def test_quantize_matches_plain(dev, qtype, n, k, scale):
    """Byte-equal to the plain version on the card and on the CPU; 1000 x
    4096 (128,000 blocks) passes the grid's cap, so warps stride."""
    from tts_tpu_torch.ops import quantize as oq
    torch.manual_seed(n + qtype)
    x = torch.randn((n, k), device=dev) * scale
    got = oq.quantize_blocks_cuda(x, qtype)
    assert torch.equal(got, oq.quantize_blocks_plain(x, qtype))
    assert torch.equal(got.cpu(), oq.quantize_blocks_plain(x.cpu(), qtype))


@pytest.mark.parametrize("qtype", QUANT_TYPES)
def test_quantize_plain_same_on_card_and_cpu(dev, qtype):
    """The plain version gives the CPU's bytes on the card at a million
    blocks: its scale is one IEEE division (torch divides a CUDA tensor by
    a Python scalar as a product with the reciprocal, which parted Q8_0's
    scale from numpy's in ~4 blocks a million)."""
    from tts_tpu_torch.ops import quantize as oq
    torch.manual_seed(qtype)
    x = torch.randn((8192, 4096), device=dev) * 0.02
    got = oq.quantize_blocks_plain(x, qtype).cpu()
    assert torch.equal(got, oq.quantize_blocks_plain(x.cpu(), qtype))
    assert torch.equal(oq.quantize_blocks_cuda(x, qtype).cpu(), got)


@pytest.mark.parametrize("qtype", QUANT_TYPES)
def test_quantize_edge_blocks(dev, qtype):
    """Ties of |x| with opposite signs, +-0, all-zero blocks, Q8_0's half-way
    block, fp16 scales subnormal and overflowing; and a block read from a
    base that is 4 but not 16 bytes aligned."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from tts_tpu_torch.ops import quantize as oq
    b = torch.from_numpy(chip_smoke.quant_edge_blocks())
    got = oq.quantize_blocks_cuda(b.to(dev), qtype)
    assert torch.equal(got.cpu(), oq.quantize_blocks_plain(b, qtype))
    flat = torch.randn(65, device=dev)
    assert torch.equal(oq.quantize_blocks_cuda(flat[1:33], qtype),
                       oq.quantize_blocks_plain(flat[1:33], qtype))


def test_quantize_counter_and_refusals(dev):
    """One launch a call on its counter (the dispatcher's CPU path launches
    nothing); F16 / F32 are casts, not launches; partial blocks and other
    types are refused."""
    from tts_tpu_torch.ops import quantize as oq
    x = torch.randn((4, 64), device=dev)
    before = oq.KERNEL.launches
    oq.quantize_blocks(x, quants.GGML_TYPE_Q4_0)
    oq.quantize_blocks(x, quants.GGML_TYPE_Q8_0)
    oq.quantize_blocks(x.cpu(), quants.GGML_TYPE_Q5_0)
    f16 = oq.quantize_blocks(x, quants.GGML_TYPE_F16)
    assert torch.equal(f16, x.half().reshape(-1).view(torch.uint8))
    torch.cuda.synchronize()
    assert oq.KERNEL.launches - before == 2
    with pytest.raises(ValueError, match="whole blocks"):
        oq.quantize_blocks_cuda(torch.randn(48, device=dev), quants.GGML_TYPE_Q4_0)
    with pytest.raises(ValueError, match="no block format"):
        oq.quantize_blocks_cuda(x, quants.GGML_TYPE_F16)


# ---------------------------------------------------------------------------
# TTS_TPU_KV_DTYPE=float32: the persistent steps on the caches it makes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["parler", "orpheus", "dia"])
def test_persistent_step_on_the_variables_f32_cache(dev, monkeypatch, family):
    """With TTS_TPU_KV_DTYPE=float32, `kv_cache_dtype` gives the card
    float32 caches (unset: bfloat16), and each family's persistent step
    (K12, the llama step K8, K10) runs on them in one launch on its own
    counter, bit for bit equal to its launch sequence (K2; K9 at one
    slot; K11 at one pair), at pos 300 (two pages)."""
    from tts_tpu_torch.common import kv_cache_dtype
    monkeypatch.delenv("TTS_TPU_KV_DTYPE", raising=False)
    assert kv_cache_dtype(dev) == torch.bfloat16
    monkeypatch.setenv("TTS_TPU_KV_DTYPE", "float32")
    dt = kv_cache_dtype(dev)
    assert dt == torch.float32
    torch.manual_seed(0)
    p = torch.tensor([300], dtype=torch.int32, device=dev)
    if family == "parler":
        mega, qt = _tiny_mega(dev, quants.GGML_TYPE_Q4_0, tc=300)
        flat = pf.prep_parler_flat(mega, qt, 640)
        x = torch.randn((1, 256), device=dev)
        kc = torch.randn((2, 4, 640, 64), device=dev).to(dt)
        counter = pf.KERNEL
        step = lambda k, v: pf.parler_flat_megastep(  # noqa: E731
            flat, x, k, v, p, qtype=qt, n_heads=4)
        seq = lambda k, v: pm.parler_megastep_cuda(  # noqa: E731
            mega, x, k, v, p, qtype=qt, use_cross=True, n_heads=4)
    elif family == "orpheus":
        mega, _, _, kw = _tiny_llama(dev, quants.GGML_TYPE_Q4_0)
        x = torch.randn((1, 256), device=dev)
        kc = torch.randn((2, kw["n_kv"], 640, 64), device=dev).to(dt)
        counter = lm.KERNEL
        step = lambda k, v: lm.llama_megastep(mega, x, k, v, p, **kw)  # noqa: E731
        seq = lambda k, v: _llama_sequence(mega, x, k, v, p, kw)  # noqa: E731
    else:
        mega, kw = _tiny_dia(dev, quants.GGML_TYPE_Q4_0)
        x, kc, _, (ck, cv, vt) = _dia_state(dev, dt, 640, 128)
        counter = dm.KERNEL
        step = lambda k, v: dm.dia_megastep(  # noqa: E731
            mega, x, k, v, p, ck.flatten(1, 2), cv.flatten(1, 2),
            vt.flatten(1, 2), 896, **kw)
        seq = lambda k, v: _launch_sequence(  # noqa: E731
            mega, x, k, v, p, ck, cv, vt, 896, kw)
    vc = torch.randn_like(kc)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = counter.launches
    got = step(k1, v1)
    torch.cuda.synchronize()
    assert counter.launches - before == 1
    for a, b in zip(got, seq(k2, v2)):
        assert torch.equal(a, b)
    assert k1.dtype == torch.float32
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
