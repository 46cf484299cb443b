"""The plain reference agrees with itself on tiny seeded models, and its
text front ends, dequantization and DAC with the program's (which the
reference itself never imports)."""
import numpy as np
import pytest
import torch

from port_bench import text
from port_bench.families import dia as fdia
from port_bench.families import parler as fparler
from port_bench.reference import dac as rdac
from port_bench.reference import q4
from port_bench.reference import tokenizer as rtok
from port_bench.tests.tiny import tiny_cell


def test_q4_blocks_by_hand():
    codes = torch.zeros((1, 16), dtype=torch.uint8)
    codes[0, 0] = 0x9F          # value 0 = 15 - 8, value 16 = 9 - 8
    w = q4.dequant(codes, torch.tensor([[0.5]]))
    assert w.shape == (1, 32)
    assert w[0, 0] == 3.5 and w[0, 16] == 0.5 and w[0, 1] == -4.0


def test_q4_matches_the_program():
    from tts_tpu_torch.ops.quant_matmul import dequant
    g = torch.Generator().manual_seed(1)
    codes = torch.randint(0, 256, (3, 8, 32), generator=g, dtype=torch.uint8)
    scales = torch.rand((3, 8, 2), generator=g)
    assert torch.equal(q4.dequant(codes, scales),
                       dequant(codes, scales, 2))


def test_tokenizers_match_the_program():
    from tts_tpu_torch.models.dia.model import DiaConfig, tokenize_sentence
    from tts_tpu_torch.text import UnigramTokenizer
    cfg = tiny_cell("parler.serve.stream").config
    pieces, scores = fparler.vocab(cfg)
    prog = UnigramTokenizer({p: i for i, p in enumerate(pieces)},
                            fparler.UNK, scores, fparler.EOS_TEXT)
    for start in range(0, 400, 37):
        for size in (5, 17, 60):
            s = fparler.prompt(start, size)
            ids = rtok.unigram(s, pieces, scores, fparler.UNK)
            assert ids == prog.tokenize(s) and len(ids) == size - 1
    for start in range(0, 60, 7):
        for size in (20, 77, 200):
            s = text.dia_script(start, size)
            assert rtok.dia_bytes(s, 1024) == tokenize_sentence(s, DiaConfig())
            assert size - 12 <= len(rtok.dia_bytes(s, 1024)) <= size


@pytest.mark.parametrize("workload", ["parler.serve.stream", "dia.cli"])
def test_teacher_forcing_is_causal(workload):
    """A step's logits do not depend on the tokens drawn after it."""
    cell = tiny_cell(workload)
    fam = fparler if cell.config["family"] == "parler" else fdia
    raw = fam.make_raw(cell.config, 5, "cpu")
    ids = fam.ref_ids(cell.config, fam.prompt(3, 9 if fam is fparler else 30))
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 1024, (20, 9), generator=g)
    n = cell.config["max_generation_size"] - 1 if fam is fdia else 20
    if fam is fdia:
        tokens = torch.randint(0, 1024, (n, 9), generator=g)
    full = fam.ref_logits(raw, cell.config, ids, tokens, tokens.shape[0])
    part = fam.ref_logits(raw, cell.config, ids, tokens, 12)
    torch.testing.assert_close(part, full[:12], rtol=1e-5, atol=1e-5)
    assert torch.isfinite(full[..., :1024]).all()


def test_dac_matches_the_program():
    from port_bench.families.parler import dac_weights
    from tts_tpu_torch.models.codec.dac import DACConfig, dac_decode
    cfg = tiny_cell("dia.cli").config
    raw = fdia.make_raw(cfg, 6, "cpu")
    frames = torch.randint(0, 1024, (14, 9),
                           generator=torch.Generator().manual_seed(3))
    want = dac_decode(DACConfig(), dac_weights(raw["dac"], cfg["dac"]), frames)
    got = rdac.decode(raw["dac"], cfg["dac"], frames)
    assert got.shape == (14 * 512,)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_delay_undo_by_hand():
    cfg = tiny_cell("dia.cli").config
    toks = np.arange(30 * 9).reshape(30, 9) % 1000
    frames = fdia.ref_frames(cfg, toks, 30)
    assert len(frames) == 30 - 15
    assert frames[2][0] == toks[2][0] and frames[2][1] == toks[2 + 8][1]
    pf = fparler.ref_frames(tiny_cell("parler.serve.stream").config, toks, 30)
    assert len(pf) == 30 - 8 and pf[4][3] == toks[7][3]
