"""PyTorch port: the offline tools against the JAX package's, on the CPU.

- `ops.quantize.quantize_blocks_plain` (the quantize kernel's plain version)
  against the numpy spec `tts_tpu.gguf.quants.quantize`, bit for bit, on
  seeded draws and on edge blocks (ties of |x| with opposite signs, +-0 and
  all-zero blocks, Q8_0's half-way block, subnormal and overflowing fp16
  scales);
- the port's `apps.quantize` against the JAX tool on its numpy path (the
  native library forced off, as tests/test_native.py does) on tiny
  Parler, Dia, Orpheus and Kokoro GGUFs, every type and each flag: the
  output files byte-equal; T5 is refused by both;
- the five GGUF writers of `convert` against `tts_tpu.convert` on the same
  numpy inputs: byte-equal files;
- the phonemizer trainer against the JAX trainer: the same rules,
  dictionary, score and GGUF bytes; the espeak and nltk paths refuse alike.

The JAX quantizer's native host library rounds Q8_0 with `roundf` and so
parts from numpy on the half-way block; the port follows numpy
(`test_half_way_q8_block_follows_numpy`).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import test_conditional_prompt as cp
import test_e2e_kokoro as e2e_kokoro
import test_e2e_parler as e2e_parler
import test_torch_port_dia as tdia
import test_torch_port_orpheus as torpheus
from test_kokoro import tiny_kokoro
from test_torch_port_kokoro import PHONEMIZER, VOCAB as KOKORO_VOCAB
from test_train_phonemizer import LEXICON
from tts_tpu import native
from tts_tpu.apps import quantize as jquantize
from tts_tpu.apps import train_phonemizer as jtrain
from tts_tpu.convert import writers as jwriters
from tts_tpu.gguf import quants as jquants
from tts_tpu_torch import convert as pconvert
from tts_tpu_torch.apps import quantize as pquantize
from tts_tpu_torch.apps import train_phonemizer as ptrain
from tts_tpu_torch.ops.quantize import quantize_blocks, quantize_blocks_plain

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import quant_edge_blocks as edge_blocks  # noqa: E402

Q4, Q5, Q8 = jquants.GGML_TYPE_Q4_0, jquants.GGML_TYPE_Q5_0, jquants.GGML_TYPE_Q8_0
F16 = jquants.GGML_TYPE_F16
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("qtype", [Q4, Q5, Q8])
@pytest.mark.parametrize("shape,scale", [((48, 96), 1.0), ((256, 1024), 1.0),
                                         ((256, 1024), 0.02)])
def test_plain_quantize_matches_numpy(qtype, shape, scale):
    x = np.random.default_rng(shape[0] + qtype).standard_normal(shape) \
        .astype(np.float32) * np.float32(scale)
    got = quantize_blocks_plain(torch.from_numpy(x), qtype).numpy()
    np.testing.assert_array_equal(got, jquants.quantize(x, qtype))


@pytest.mark.parametrize("qtype", [Q4, Q5, Q8, F16])
def test_quantize_blocks_edge_blocks(qtype):
    b = edge_blocks()
    with np.errstate(over="ignore"):
        want = jquants.quantize(b, qtype)
    np.testing.assert_array_equal(quantize_blocks(torch.from_numpy(b), qtype).numpy(),
                                  want)


def test_quantize_blocks_refuses_partial_blocks():
    with pytest.raises(ValueError, match="whole blocks"):
        quantize_blocks_plain(torch.zeros(48), Q4)
    with pytest.raises(ValueError, match="no block format"):
        quantize_blocks_plain(torch.zeros(64), F16)


def test_half_way_q8_block_follows_numpy():
    """[127, 0.49999997, -0.49999997, 0, ...]: numpy rounds half away from
    zero as sign(s) * floor(|s| + 0.5) in f32, and 0.49999997 + 0.5 rounds
    to 1.0, so the codes are 127, 1, -1; the port agrees."""
    blk = edge_blocks()[5]
    want = jquants.quantize(blk, Q8)
    assert list(want[2:5].view(np.int8)) == [127, 1, -1]
    np.testing.assert_array_equal(
        quantize_blocks(torch.from_numpy(blk), Q8).numpy(), want)


@pytest.mark.skipif(not native.available(), reason="native toolchain unavailable")
def test_half_way_q8_block_jax_native_parts_from_numpy():
    """The JAX tool's native library rounds with roundf: codes 127, 0, 0.
    Its bytes hence depend on whether native/libttsnative.so loads."""
    blk = edge_blocks()[5]
    got = native.quantize(blk[None], Q8)
    assert list(got[2:5].view(np.int8)) == [127, 0, 0]
    assert not np.array_equal(got, jquants.quantize(blk, Q8))


# ---------------------------------------------------------------------------
# the quantize tool: the port's against the JAX one on its numpy path
# ---------------------------------------------------------------------------

def write_kokoro(path, writer=None):
    cfg, w = tiny_kokoro(np.random.default_rng(0))
    rng = np.random.default_rng(4)
    voices = {"af_heart": rng.standard_normal((32, 16)).astype(np.float32) * 0.2,
              "bm_lewis": rng.standard_normal((32, 16)).astype(np.float32) * 0.2}
    orig = e2e_kokoro.write_kokoro_gguf
    base = writer or orig
    e2e_kokoro.write_kokoro_gguf = \
        lambda *a, **k: base(*a, phonemizer=PHONEMIZER, **k)
    try:
        e2e_kokoro.serialize_kokoro(path, cfg, w, voices, KOKORO_VOCAB)
    finally:
        e2e_kokoro.write_kokoro_gguf = orig


FAMILIES = {
    "parler": lambda p: e2e_parler.make_tiny_parler_gguf(p, np.random.default_rng(0)),
    "dia": lambda p: tdia.write_tiny_dia(p, np.random.default_rng(1)),
    "orpheus": lambda p: torpheus.write_tiny_orpheus(p, np.random.default_rng(2)),
    "kokoro": write_kokoro,
}
FLAGS = ("-qh", "-qe", "-qkv", "-df", "-nqf")


@pytest.fixture(scope="module")
def family_ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    out = {}
    for name, write in FAMILIES.items():
        out[name] = str(d / f"{name}.gguf")
        write(out[name])
    return out


@pytest.fixture
def numpy_path(monkeypatch):
    """The JAX tool on its numpy path (quants.quantize), as
    tests/test_native.py::test_fallback_paths forces it."""
    monkeypatch.setattr(native, "_load", lambda: None)


def quantize_both(src, tmp_path, argv):
    jax_out, port_out = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    assert jquantize.main(["-mp", src, "-qp", jax_out, *argv]) == 0
    assert pquantize.main(["-mp", src, "-qp", port_out, *argv,
                           "--device", "cpu"]) == 0
    with open(jax_out, "rb") as f:
        want = f.read()
    with open(port_out, "rb") as f:
        got = f.read()
    return got, want


@pytest.mark.parametrize("flags", [(), FLAGS], ids=["no-flags", "all-flags"])
@pytest.mark.parametrize("qt", ["Q4_0", "Q5_0", "Q8_0", "F16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_quantize_tool_bytes_equal_jax(family_ggufs, numpy_path, tmp_path,
                                       family, qt, flags, capsys):
    got, want = quantize_both(family_ggufs[family], tmp_path, ["-qt", qt, *flags])
    assert got == want


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_quantize_tool_each_flag_bytes_equal_jax(family_ggufs, numpy_path,
                                                 tmp_path, family, flag, capsys):
    got, want = quantize_both(family_ggufs[family], tmp_path,
                              ["-qt", "Q8", flag, "-nt", "4"])
    assert got == want


def test_quantize_tool_type_aliases_and_tensor_types(family_ggufs, numpy_path,
                                                     tmp_path, capsys):
    """FP16 / Q4 / Q5 aliases, and the tensor types the rules give Parler."""
    from tts_tpu_torch.gguf import GGUFReader
    for qt in ("FP16", "Q4", "Q5"):
        got, want = quantize_both(family_ggufs["parler"], tmp_path, ["-qt", qt])
        assert got == want
    r = GGUFReader(str(tmp_path / "port.gguf"))
    types = {n: r.tensors[n].ggml_type for n in r.tensor_names()}
    assert r.metadata["general.quantization_type"] == Q5
    assert types["decoder.layers.0.fc1.weight"] == Q5
    assert types["decoder.layers.0.encoder_attn.k_proj.weight"] == \
        jquants.GGML_TYPE_F32
    assert types["decoder.lm_heads.0.weight.head"] == jquants.GGML_TYPE_F32
    assert all(t == jquants.GGML_TYPE_F32 for n, t in types.items()
               if n.startswith("audio_encoder."))
    r.close()


def test_quantize_tool_refuses_t5_like_jax(tmp_path, numpy_path):
    src = str(tmp_path / "t5.gguf")
    cp.make_tiny_t5_gguf(src, np.random.default_rng(0))
    params = (Q4,)
    with pytest.raises(ValueError, match="t5encoder"):
        jquantize.quantize_gguf(src, str(tmp_path / "j.gguf"),
                                jquantize.QuantizationParams(*params),
                                log=lambda *a: None)
    with pytest.raises(ValueError, match="t5encoder"):
        pquantize.quantize_gguf(src, str(tmp_path / "p.gguf"),
                                pquantize.QuantizationParams(*params),
                                log=lambda *a: None, device="cpu")


def test_quantize_main_bad_type(family_ggufs, tmp_path, capsys):
    assert pquantize.main(["-mp", family_ggufs["parler"], "-qp",
                           str(tmp_path / "x.gguf"), "-qt", "Q3_K",
                           "--device", "cpu"]) == 1
    assert "Q3_K is not a valid quantization type" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.gguf")


def test_quantize_tool_timer_stages(family_ggufs, tmp_path):
    lines = []
    timer = pquantize.quantize_gguf(family_ggufs["dia"], str(tmp_path / "q.gguf"),
                                    pquantize.QuantizationParams(Q4),
                                    log=lines.append, device="cpu")
    n = sum(line.startswith("quantized ") for line in lines)
    assert n > 0
    assert set(timer.totals) == {"read", "host->device", "kernel",
                                 "device->host", "write"}
    assert timer.counts["kernel"] == n and timer.counts["write"] == 1


# ---------------------------------------------------------------------------
# the GGUF writers
# ---------------------------------------------------------------------------

def both_writers(monkeypatch, module, name):
    """module.<name> writes `path` with the JAX writer and `path.port` with
    the port's, from the same arguments."""
    jw, pw = getattr(jwriters, name), getattr(pconvert, name)

    def write(path, *a, **k):
        jw(path, *a, **k)
        pw(path + ".port", *a, **k)

    monkeypatch.setattr(module, name, write)


def assert_files_equal(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("family", ["parler", "t5", "dia", "orpheus", "kokoro"])
def test_writers_bytes_equal_jax(family, tmp_path, monkeypatch):
    path = str(tmp_path / f"{family}.gguf")
    if family == "parler":
        both_writers(monkeypatch, e2e_parler, "write_parler_gguf")
        FAMILIES["parler"](path)
    elif family == "t5":
        both_writers(monkeypatch, cp, "write_t5_gguf")
        cp.make_tiny_t5_gguf(path, np.random.default_rng(0))
    elif family == "dia":
        both_writers(monkeypatch, tdia, "write_dia_gguf")
        FAMILIES["dia"](path)
    elif family == "orpheus":
        both_writers(monkeypatch, torpheus, "write_orpheus_gguf")
        FAMILIES["orpheus"](path)
    else:
        both_writers(monkeypatch, e2e_kokoro, "write_kokoro_gguf")
        write_kokoro(path, writer=e2e_kokoro.write_kokoro_gguf)
    assert_files_equal(path, path + ".port")


def test_parler_writer_text_encoding_and_no_dac(tmp_path):
    """The optional parts: a text encoding (its encode_length key) and no
    DAC keys."""
    rng = np.random.default_rng(3)
    kw = dict(hidden_size=32, n_layers=1, n_attn_heads=2, n_output_heads=2,
              output_vocab_size=12, max_generation=10, max_ctx=16,
              bos_token_id=9, eos_token_id=8,
              decoder_tensors={"layer_norm.weight": rng.standard_normal(32)},
              tokenizer_tokens=["<unk>", "</s>", "a"],
              tokenizer_scores=[-10.0, -1.0, -2.0],
              text_encoding=rng.standard_normal((5, 32)))
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    jwriters.write_parler_gguf(a, **kw)
    pconvert.write_parler_gguf(b, **kw)
    assert_files_equal(a, b)


# ---------------------------------------------------------------------------
# the phonemizer trainer
# ---------------------------------------------------------------------------

def english_lexicon():
    with open(os.path.join(HERE, "data", "english_lexicon.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("lexicon", ["small", "english"])
def test_trainer_matches_jax(lexicon, tmp_path):
    lex = LEXICON if lexicon == "small" else english_lexicon()
    jt, pt = jtrain.PhonemizationTrainer(), ptrain.PhonemizationTrainer()
    jt.train(lex)
    pt.train(lex)
    assert pt.rules == jt.rules
    assert pt.dictionary == jt.dictionary
    assert pt.verify(lex) == jt.verify(lex)
    if lexicon == "small":
        assert pt.verify(lex) == 1.0
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    jt.export_gguf(a)
    pt.export_gguf(b)
    assert_files_equal(a, b)


def test_trainer_gguf_loads_in_the_port(tmp_path):
    from tts_tpu_torch.gguf import GGUFReader
    from tts_tpu_torch.text.phonemizer import Phonemizer
    t = ptrain.PhonemizationTrainer()
    t.train(LEXICON)
    path = str(tmp_path / "ph.gguf")
    t.export_gguf(path)
    ph = Phonemizer.from_gguf(GGUFReader(path))
    for word, ipa in LEXICON.items():
        assert ph.text_to_phonemes(word) == ipa, word


def test_trainer_main_lexicon_json(tmp_path, capsys):
    lex = str(tmp_path / "lex.json")
    with open(lex, "w") as f:
        json.dump(LEXICON, f)
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    assert jtrain.main(["--export-path", a, "--lexicon-json", lex]) == 0
    want = capsys.readouterr().out
    assert ptrain.main(["--export-path", b, "--lexicon-json", lex]) == 0
    assert capsys.readouterr().out == want.replace(a, b)
    assert_files_equal(a, b)


def test_trainer_espeak_and_nltk_refuse_like_jax(tmp_path, monkeypatch, capsys):
    """Without espeak-ng both refuse the espeak path; without the nltk
    corpus both `main`s print why and return 1."""
    import ctypes.util
    if ctypes.util.find_library("espeak-ng") or ctypes.util.find_library("espeak"):
        pytest.skip("espeak-ng is installed here: there is nothing to refuse")
    for mod in (jtrain, ptrain):
        with pytest.raises(RuntimeError, match="espeak-ng shared library not found"):
            mod.lexicon_from_espeak(["cat"])
    words = tmp_path / "words.txt"
    words.write_text("cat\ndog\n")
    for mod in (jtrain, ptrain):
        with pytest.raises(RuntimeError, match="espeak-ng"):
            mod.main(["--export-path", str(tmp_path / "x.gguf"),
                      "--words-file", str(words)])
    monkeypatch.setitem(sys.modules, "nltk.corpus", None)
    errs = []
    for mod in (jtrain, ptrain):
        assert mod.main(["--export-path", str(tmp_path / "x.gguf")]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "nltk corpus unavailable" in errs[0]
    assert not os.path.exists(tmp_path / "x.gguf")
