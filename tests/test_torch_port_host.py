"""PyTorch port: its own copies of the host-side modules (GGUF writer and
reader, unigram tokenizer, WAV) against the JAX package's, on the CPU."""
import numpy as np
import pytest

from tts_tpu.audio import wav as jwav
from tts_tpu.gguf import GGUFReader as JReader
from tts_tpu.text import UnigramTokenizer as JTokenizer
from tts_tpu_torch.audio import wav
from tts_tpu_torch.gguf import GGUFReader, GGUFWriter, quants
from tts_tpu_torch.text import UnigramTokenizer

TOKENS = ["<unk>", "</s>", " ", "he", "llo", "wor", "ld", "a", "b", "c",
          "hello", " w", "é"]
SCORES = [-10.0, -1.0, -1.0, -2.0, -2.0, -2.0, -2.0, -3.0, -3.0, -3.0,
          -2.5, -1.5, -4.0]


def test_gguf_written_by_the_port_reads_the_same_in_both(tmp_path, rng):
    """Every kind of value and tensor chip_smoke.py writes: both readers see
    the same metadata, dense arrays and raw Q4_0 blocks."""
    path = str(tmp_path / "t.gguf")
    w = GGUFWriter(path, "parler-tts")
    w.add_u32("parler-tts.decoder.hidden_size", 64)
    w.add_str("tokenizer.ggml.model", "unigram")
    w.add_array("tokenizer.ggml.tokens", TOKENS)
    w.add_array("tokenizer.ggml.scores", np.asarray(SCORES, np.float32))
    dense = rng.standard_normal((3, 64)).astype(np.float32)
    w.add_tensor("decoder.dense", dense)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    raw = quants.quantize(q, quants.GGML_TYPE_Q4_0)
    w.add_raw_tensor("decoder.q4", (4, 64), quants.GGML_TYPE_Q4_0, raw.tobytes())
    w.write()
    with JReader(path) as jr, GGUFReader(path) as pr:
        assert pr.architecture == jr.architecture == "parler-tts"
        for key in ("parler-tts.decoder.hidden_size", "tokenizer.ggml.model",
                    "tokenizer.ggml.tokens"):
            assert pr.get(key) == jr.get(key)
        np.testing.assert_array_equal(pr.get("tokenizer.ggml.scores"),
                                      np.asarray(SCORES, np.float32))
        assert pr.tensor_names() == jr.tensor_names()
        np.testing.assert_array_equal(pr.array("decoder.dense"), dense)
        np.testing.assert_array_equal(jr.array("decoder.dense"), dense)
        np.testing.assert_array_equal(pr.raw("decoder.q4"), jr.raw("decoder.q4"))
        np.testing.assert_array_equal(pr.array("decoder.q4"),
                                      jr.array("decoder.q4"))


@pytest.mark.parametrize("text", [
    "hello world", "  hello   world  ", "abc", "hello, wörld!", "", "é é",
    "he llo wor ld",
])
def test_unigram_tokenizer_matches_jax(text):
    """Same ids, unknown-token merging and whitespace handling included."""
    vocab = {t: i for i, t in enumerate(TOKENS)}
    ours = UnigramTokenizer(vocab, 0, SCORES, 1)
    ref = JTokenizer(vocab, 0, SCORES, 1)
    assert ours.tokenize(text) == ref.tokenize(text)


def test_wav_written_by_the_port_reads_the_same_in_both(tmp_path, rng):
    audio = (rng.standard_normal(1000) * 0.3).astype(np.float32)
    path = str(tmp_path / "a.wav")
    wav.write_audio_file(audio, path, 44100)
    a, ra = wav.read_audio_file(path)
    b, rb = jwav.read_audio_file(path)
    assert ra == rb == 44100
    np.testing.assert_array_equal(a, b)
    # 16-bit PCM: within one quantization step of the input
    np.testing.assert_allclose(a, np.clip(audio, -1, 1), rtol=0,
                               atol=1.0 / 32767 + 1e-7)
