"""PyTorch port: the host-side sizing of the decode kernels, on the CPU.

The decode attention's arrival counters (`decode_attention.arrivals`: one
zeroed buffer per device and stream, made once, which every launch leaves
zeroed) and the llama GEMV's launch shape as `ops/llama_megastep.py`
reckons it after csrc/gemv.cuh: the rows staged per pass in shared memory
and the L2 bytes that staging reads, which for a batched Orpheus-3B step
must stay below the weights it streams.
"""
import pytest
import torch

from tts_tpu_torch.ops import decode_attention as da
from tts_tpu_torch.ops import llama_megastep as lm


def test_arrivals_are_zeroed_shared_and_grow():
    a = da.arrivals("cpu", 10)
    assert a.dtype == torch.int32 and a.numel() >= da.MIN_ARRIVALS
    assert not a.any()
    assert da.arrivals(torch.device("cpu"), a.numel()) is a
    b = da.arrivals("cpu", a.numel() + 1)
    assert b.numel() >= 2 * a.numel() and not b.any()
    assert da.arrivals("cpu", 5) is b


@pytest.mark.parametrize("b,k,rows", [
    (1, 3072, 1), (8, 3072, 8), (16, 3072, 16), (16, 1536, 16),
    (8, 8192, 8), (9, 8192, 9), (16, 8192, 8), (16, 2048, 16)])
def test_gemv_rows_per_pass(b, k, rows):
    """All rows in one pass while b x k bf16 fit in the stage limit (16 x
    8192 do not: two passes of 8); every pass within the limit."""
    rp = lm.gemv_rows_per_pass(b, k)
    assert rp == rows
    assert rp * k * 2 <= lm.GEMV_STAGE_LIMIT
    assert -(-b // rp) == -(-b * k * 2 // lm.GEMV_STAGE_LIMIT)


def test_gemv_rows_per_pass_refuses_a_row_too_long():
    assert lm.gemv_rows_per_pass(1, lm.GEMV_STAGE_LIMIT) == 0


@pytest.mark.parametrize("pairs,sms,blocks", [
    (1, 132, 2), (4, 132, 2), (25, 132, 4), (1536, 132, 128),
    (2560, 132, 132), (78592, 132, 132), (1000, 131, 84), (2000, 131, 132)])
def test_gemv_blocks_are_whole_clusters_one_per_sm(pairs, sms, blocks):
    """A block of GEMV_WARPS warps per GEMV_WARPS pairs, at most one per SM,
    rounded up to whole clusters."""
    assert lm.gemv_blocks(pairs, sms) == blocks
    assert blocks % lm.GEMV_CLUSTER == 0


@pytest.mark.parametrize("b", [1, 8, 16])
def test_orpheus_step_staging_reckoning(b):
    """Orpheus-3B's batched step (28 layers of qkv, o, gate / up and down,
    then the 157,184-row head) on 132 SMs: each cluster reads each input
    row's f32 elements once (66 clusters, 64 for o and down's 1,536 pairs);
    up to 8 slots that stays under the step's Q4_0 weight bytes (0.5625
    bytes a weight)."""
    H, F, kvn, L, vocab = 3072, 8192, 2048, 28, 157184
    gemvs = [(H + kvn, H, True, False), (H, H, False, False),
             (F, H, True, True), (H, F, False, False)] * L + \
        [(vocab, H, True, False)]
    staged = sum(lm.gemv_staging_bytes(b, n, k, rms=rms, silu=silu, sms=132)
                 for n, k, rms, silu in gemvs)
    weights = sum((2 * n if silu else n) * k for n, k, _, silu in gemvs) * 0.5625
    assert staged == b * 4 * (L * (66 * H + 64 * H + 66 * H + 64 * F) + 66 * H)
    assert (staged < weights) == (b <= 8)
