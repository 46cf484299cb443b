"""PyTorch port: the rule-based phonemizer and the single-pass tokenizer
against the JAX package's, on the CPU.

The port keeps its own copy of `text/phonemizer.py` (it imports nothing of
the JAX package); here both phonemizers, built from the same dictionary and
grapheme rules, must give the same IPA string for every sentence of
tests/test_phonemizer.py and for a set of longer sentences that reach the
number, acronym, roman-numeral, possessive, contraction, symbol and
punctuation handlers, directly and through a GGUF round trip; the
phonemize command lines agree too.
"""
import numpy as np
import pytest

from test_phonemizer import mk_phonemizer as jax_phonemizer
from tts_tpu.gguf import GGUFWriter as JGGUFWriter
from tts_tpu.text import phonemizer as jph
from tts_tpu.text.tokenizer import SinglePassTokenizer as JSinglePass
from tts_tpu_torch.gguf import GGUFReader, GGUFWriter
from tts_tpu_torch.text import phonemizer as pph
from tts_tpu_torch.text.tokenizer import SinglePassTokenizer

GRAPHEMES = ["<unk>"] + list("abcdefghijklmnopqrstuvwxyz") + ["ch", "sh", "th"]
CAT_RULES = [(["c", "^", "a", "cat"], "k"), (["a", "c", "t", "cat"], "æ"),
             (["t", "a", "$", "cat"], "t")]
WILDCARD_RULES = [(["a"], "ɑ"), (["b"], "b"), (["t"], "t"), (["c"], "k"),
                  (["a", "b", "*t"], "æ")]
POSSESSIVE = {"dog": "dˈɔːɡ", "cats": "kˈæts", "sofa": "sˈoʊfə"}

# (dictionary, rules, text): every sentence of tests/test_phonemizer.py
SENTENCES = [
    ({}, None, "42"), ({}, None, "3.5"), ({}, None, "1,234"),
    ({"hello": "həlˈoʊ", "world": "wˈɜːld"}, None, "hello world"),
    ({"hi": "hˈaɪ"}, None, "hi!"), ({}, None, "tts"),
    ({}, CAT_RULES, "cat"), ({}, WILDCARD_RULES, "bat"), ({}, None, "XIV"),
    (POSSESSIVE, None, "dog's"), (POSSESSIVE, None, "sofa's"),
    (POSSESSIVE, None, "cats's"), ({"they": "ðˈeɪ"}, None, "they're"),
    ({"i": "ˈaɪ"}, None, "i've"), ({"b": "bi"}, None, "a + b"),
    ({"cafe": "kæfˈeɪ"}, None, "café"),
    ({"yes": "jˈɛs", "no": "nˈoʊ"}, None, "yes. no!"),
    ({"well": "wˈɛl", "known": "nˈoʊn"}, None, "well-known"),
]

# longer text through one phonemizer holding all of the above
ALL_DICT = {"hello": "həlˈoʊ", "world": "wˈɜːld", "hi": "hˈaɪ", "they": "ðˈeɪ",
            "i": "ˈaɪ", "b": "bi", "cafe": "kæfˈeɪ", "yes": "jˈɛs",
            "no": "nˈoʊ", "well": "wˈɛl", "known": "nˈoʊn", "read": "ɹˈɛd:ing",
            "$rd": "θˈɜːd", "#word#": "wˈɜːd", **POSSESSIVE}
ALL_RULES = CAT_RULES + WILDCARD_RULES + [(["s", "h", "*"], "ʃ"),
                                          (["th"], "θ"), (["e"], "ɛ")]
LONG = [
    "Hello world, they're reading 3rd; i've 1,234,567 cats's toys!",
    "The U.S.A. and NASA's XIV mission cost $12.50 -- or 3.14159 more?",
    "Well-known dog's sofa: café at 10:30, 2024... yes! no? maybe.",
    "a + b = c; x * y / z & q % r @ s # t, with tabs\tand\nnewlines.",
    "MCMXCIV and MMXXIV, I II III IV V; iPhone vs TTS vs tts vs Tts.",
    "Numbers: 0, 7, 13, 99, 100, 101, 999, 1000, 1001, 1000000, 2000000000.",
]


def port_phonemizer(dictionary=None, rules=None):
    """tests/test_phonemizer.py's mk_phonemizer with the port's classes."""
    d = pph.PhonemeDictionary()
    for k, v in (dictionary or {}).items():
        out = [pph.response_from_string(x, k) for x in v.split(",")]
        kk = k
        if kk[:1] in ("$", "#"):
            kk = kk[1:]
        if kk.endswith("#"):
            kk = kk[:-1]
        d.lookup_map[kk] = out
    wp = pph.WordPhonemizer(SinglePassTokenizer(GRAPHEMES))
    for keys, ph in (rules or []):
        wp.add_rule(keys, ph)
    return pph.Phonemizer(d, wp)


@pytest.mark.parametrize("dictionary,rules,text", SENTENCES,
                         ids=[s[2] for s in SENTENCES])
def test_every_sentence_equals_jax(dictionary, rules, text):
    want = jax_phonemizer(dictionary, rules).text_to_phonemes(text)
    assert port_phonemizer(dictionary, rules).text_to_phonemes(text) == want


@pytest.mark.parametrize("text", LONG)
def test_long_sentences_equal_jax(text):
    want = jax_phonemizer(ALL_DICT, ALL_RULES).text_to_phonemes(text)
    got = port_phonemizer(ALL_DICT, ALL_RULES).text_to_phonemes(text)
    assert got == want and got


def test_number_helpers_equal_jax():
    for n in (0, 5, 21, 300, 999, 1001, 12_345, 1_000_001, 987_654_321_012):
        assert pph.build_number_phoneme(n) == jph.build_number_phoneme(n)
    for n in range(1000):
        assert pph.build_subthousand_phoneme(n) == jph.build_subthousand_phoneme(n)
    for w in ("café", "niño", "ÀÇÈÌÑÒÙ", "plain"):
        assert pph.replace_accents(w) == jph.replace_accents(w)


def test_espeak_raises_without_the_library(monkeypatch):
    """As the JAX one: the optional espeak path raises at construction
    when no espeak-ng library is found."""
    import ctypes.util
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    with pytest.raises(RuntimeError, match="espeak"):
        pph.EspeakPhonemizer()
    with pytest.raises(RuntimeError, match="espeak"):
        jph.EspeakPhonemizer()


def _write_phonemizer_gguf(writer_cls, path):
    w = writer_cls(path, "kokoro")
    w.add_u32("phonemizer.type", 0)
    w.add_array("phonemizer.graphemes", GRAPHEMES)
    # tests/test_phonemizer.py's three rules, then ALL_RULES (keys joined
    # by dots, as the converter writes them)
    w.add_array("phonemizer.rules.keys",
                ["c", "a", "t"] + [".".join(k) for k, _ in ALL_RULES])
    w.add_array("phonemizer.rules.phonemes",
                ["k", "æ", "t"] + [ph for _, ph in ALL_RULES])
    w.add_array("phonemizer.dictionary.keys", sorted(ALL_DICT))
    w.add_array("phonemizer.dictionary.values", [ALL_DICT[k] for k in sorted(ALL_DICT)])
    w.write()


def test_gguf_roundtrip_equals_jax(tmp_path):
    """tests/test_phonemizer.py's GGUF round trip, and the long sentences,
    through both packages' readers and `Phonemizer.from_gguf`, from files
    written by either package's writer."""
    from tts_tpu.gguf import GGUFReader as JGGUFReader
    for name, writer in (("port", GGUFWriter), ("jax", JGGUFWriter)):
        path = str(tmp_path / f"{name}.gguf")
        _write_phonemizer_gguf(writer, path)
        with GGUFReader(path) as r:
            port = pph.Phonemizer.from_gguf(r)
        with JGGUFReader(path) as r:
            ref = jph.Phonemizer.from_gguf(r)
        assert port.text_to_phonemes("hello") == "həlˈoʊ"
        assert port.text_to_phonemes("cat") == "kæt"
        for text in LONG + ["hello", "cat", "cats's sofa's dog's"]:
            assert port.text_to_phonemes(text) == ref.text_to_phonemes(text)


def test_phonemize_cli_equals_jax(tmp_path, capsys):
    from tts_tpu.apps import phonemize as japp
    from tts_tpu_torch.apps import phonemize as papp
    path = str(tmp_path / "ph.gguf")
    _write_phonemizer_gguf(GGUFWriter, path)
    outs = []
    for app in (papp, japp):
        assert app.main(["-mp", path, "-p", LONG[0]]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].strip()
    assert papp.main(["-p", "hi"]) == 1     # no rules file, no espeak


@pytest.mark.parametrize("text", ["", "a", "abcab", "ʃtʃɑːʔ xyz", "cchh",
                                  "ðə kwˈɪk bɹˈaʊn fˈɑːks"])
def test_single_pass_tokenizer_equals_jax(text):
    """Ids (shorter matches first, unknown characters skipped, duplicated
    tokens keeping their lowest id) and the longest-match split."""
    tokens = ["$", "a", "b", "ab", "ʃ", "tʃ", "ɑː", "ɑ", "c", "ch", "chh", "b",
              " ", "ð", "ə", "k", "w", "ˈ", "ɪ"]
    p, j = SinglePassTokenizer(tokens), JSinglePass(tokens)
    assert p.tokenize(text) == j.tokenize(text)
    assert p.token_split(text) == j.token_split(text)
    assert p.index["b"] == 2


def test_single_pass_from_gguf(tmp_path):
    path = str(tmp_path / "t.gguf")
    w = GGUFWriter(path, "kokoro")
    toks = ["$", " ", "a", "b", "ab", "a"]
    w.add_array("tokenizer.ggml.tokens", toks)
    w.write()
    with GGUFReader(path) as r:
        t = SinglePassTokenizer.from_gguf(r, "tokenizer.ggml.tokens")
    assert t.tokens == toks and t.tokenize("ab a") == JSinglePass(toks).tokenize("ab a")
    assert np.array_equal(t.tokenize("aab"), [2, 2, 3])
