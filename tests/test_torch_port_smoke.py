"""chip_smoke.py's layer-by-layer check of the Parler decode step (K2), on
the CPU: it passes the plain version and fails a step that skips a bf16
rounding or drops the current K/V row. And its in-place rewrite of an
Orpheus GGUF's generation window (Orpheus serving's depth cut), which the
port's loader reads.

On the CPU the "kernel" is a (possibly broken) plain version and the
yardstick pair (plain on the CPU vs plain on DEV) is one version run twice,
so the tolerance is the check's floor, 1e-5 of the largest value.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from tts_tpu_torch.ops import parler_megastep as pm  # noqa: E402
from tts_tpu_torch.ops import quant_matmul as qm  # noqa: E402

plain = pm.parler_megastep_plain


def no_round_fc2(*a, **k):
    """The step with fc2's input left in f32 (not rounded to bf16)."""
    qdot = pm._qdot
    ffn = pm.mega_dims(a[0])[2]

    def q(h, codes, scales, qt):
        if h.shape[-1] == ffn:   # fc2's input; every other product has K = H
            w = qm.QuantTensor(codes, scales, qt).dense(torch.float32)
            return h @ w.to(torch.bfloat16).float().T
        return qdot(h, codes, scales, qt)

    pm._qdot = q
    try:
        return plain(*a, **k)
    finally:
        pm._qdot = qdot


def drop_row(*a, **k):
    """The step with self-attention over rows [0, pos) only."""
    attn = pm.decode_attention_plain

    def at(q, kk, vv, pos):
        return attn(q, kk, vv, pos - 1 if torch.is_tensor(pos) else pos)

    pm.decode_attention_plain = at
    try:
        return plain(*a, **k)
    finally:
        pm.decode_attention_plain = attn


@pytest.fixture(scope="module")
def small_step(monkeypatch_module):
    monkeypatch_module.setattr(cs, "DEV", torch.device("cpu"))
    monkeypatch_module.setattr(cs, "MINI", dict(cs.MINI, n_layers=4, hidden=256,
                                                heads=4, ffn=1024, enc_len=16))
    gen = torch.Generator().manual_seed(0)
    mega, qtype = cs.mini_mega(gen)
    shape = (4, 4, 256, 64)
    kc = (torch.randn(shape, generator=gen) * 0.5).to(torch.bfloat16)
    vc = (torch.randn(shape, generator=gen) * 0.5).to(torch.bfloat16)
    x = torch.randn((1, 256), generator=gen)
    return mega, x, kc, vc, dict(qtype=qtype, use_cross=True, n_heads=4)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("step,p,ok", [
    (plain, 1, True), (plain, 200, True),
    (no_round_fc2, 200, False), (drop_row, 1, False), (drop_row, 200, False)])
def test_k2_layer_check(small_step, monkeypatch, step, p, ok):
    mega, x, kc, vc, kw = small_step
    monkeypatch.setattr(pm, "parler_megastep_cuda", step)
    pos = torch.tensor([p], dtype=torch.int32)
    if ok:
        errs = cs.check_k2_layers(mega, x, kc, vc, pos, kw)
        assert len(errs) == 3 * 4 and max(errs) == 0.0
    else:
        with pytest.raises(AssertionError, match="layer by layer"):
            cs.check_k2_layers(mega, x, kc, vc, pos, kw)


def test_orpheus_window_rewritten_in_place(tmp_path):
    """`set_gguf_u32` rewrites `orpheus.max_generation_size` in place and
    the port's OrpheusConfig takes the window from it; a GGUF without the
    key keeps the default window, as the JAX package's config does."""
    from tts_tpu.gguf import GGUFReader as JReader
    from tts_tpu.models.orpheus.model import OrpheusConfig as JConfig
    from tts_tpu_torch.gguf import GGUFReader, GGUFWriter
    from tts_tpu_torch.models.orpheus.model import OrpheusConfig

    def write(path, window=None):
        w = GGUFWriter(str(path), "orpheus")
        if window is not None:
            w.add_u32("orpheus.max_generation_size", window)
        w.add_u32("orpheus.layers", 2)
        w.add_array("tokenizer.ggml.tokens", ["a", "b"])
        w.add_tensor("orpheus.norm", torch.ones(8).numpy())
        w.write()

    bare, stated = tmp_path / "bare.gguf", tmp_path / "stated.gguf"
    write(bare)
    write(stated, 2100)
    before = stated.read_bytes()
    assert OrpheusConfig.from_gguf(GGUFReader(str(bare))).max_generation_size == \
        JConfig.from_gguf(JReader(str(bare))).max_generation_size == 2100
    cs.set_gguf_u32(str(stated), "orpheus.max_generation_size", 1050)
    after = stated.read_bytes()
    assert len(after) == len(before)
    assert sum(a != b for a, b in zip(after, before)) == 2   # 2100 -> 1050
    cfg = OrpheusConfig.from_gguf(GGUFReader(str(stated)))
    assert (cfg.max_generation_size, cfg.n_layers) == (1050, 2)
    with pytest.raises(ValueError, match="no single u32"):
        cs.set_gguf_u32(str(bare), "orpheus.max_generation_size", 1050)
