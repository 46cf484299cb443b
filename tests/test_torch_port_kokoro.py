"""PyTorch port: Kokoro against the JAX package, on the CPU.

The LSTMs (the padded tail included), the norms and the DSP helpers each
against `tts_tpu.ops.{rnn,dsp}` on seeded numpy inputs; the Adain and
generator residual blocks; `kokoro_duration` (durations equal, hidden
states within 1e-5) and `kokoro_generate` from the JAX durations and one
uv array (the waveform within 2e-4 of max(peak, 1), the JAX package's own
bound in tests/test_kokoro.py) on tests/test_kokoro.py's tiny model; then
a tiny Kokoro GGUF (tests/test_e2e_kokoro.py's writer, with a rule-based
phonemizer) text -> WAV through both registries with both runners' noise
set to one numpy array, the port's stream against its generate, the
weights carried across against the GGUF load, and the port's CLI and
server on device="cpu".

The STFT's angle at a bin that is real in exact arithmetic (DC, Nyquist,
and every bin of frame 0, where the reflect pad and the window are
symmetric) is +pi or -pi by the sign of a zero imaginary part, which the
JAX package's FFT leaves to its own arithmetic; the port fixes it (+pi,
ops/dsp.py). The model comparisons give the JAX package's `stft` the same
rule (`jax_stft_rule`, a monkeypatch: no file of the JAX package changes);
`test_stft_matches_jax` holds every other angle to the JAX one directly.

The waveforms are held to the JAX package's generation graph run op by op
(its function under jax.jit, `kokoro_generate.__wrapped__`; fixture
`jax_eager`): under jit XLA fuses the generator's elementwise chains and
rounds them otherwise, and the tiny random model, whose spectrum is
exp(25..55) at its peak, amplifies an ulp of its harmonic source past the
bound; the port's source computes tanh and the phase's running sum as XLA
does on the CPU (`dsp.rational_tanh`, `dsp.scan_sum`, held here bit for
bit).
"""
import dataclasses
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_e2e_kokoro import serialize_kokoro
from test_kokoro import tiny_kokoro
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.models.kokoro import model as jmodel
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.ops import dsp as jdsp
from tts_tpu.ops import rnn as jrnn
from tts_tpu_torch.apps import cli
from tts_tpu_torch.audio.wav import decode_wav, read_audio_file
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.kokoro import model as pmodel
from tts_tpu_torch.models.kokoro.convert import kokoro_weights_from_numpy
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.ops import dsp, rnn

WAVE_TOL = 2e-4     # of max(|peak|, 1): tests/test_kokoro.py's bound


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


def rule_stft(x, window, n_fft, hop, abs_and_angle=True, one_sided=True):
    """The JAX package's stft with the port's angle rule at real bins: the
    imaginary parts of DC and Nyquist set to 0, and every zero part made
    +0 (a select, which XLA keeps; it drops `x + 0.0` under jit)."""
    ri = _JAX_STFT(x, window, n_fft, hop, abs_and_angle=False,
                   one_sided=one_sided)
    re, im = ri[..., 0, :, :], ri[..., 1, :, :]
    im = im.at[..., 0].set(0.0)
    if n_fft % 2 == 0:
        im = im.at[..., n_fft // 2].set(0.0)
    re = jnp.where(re == 0, 0.0, re)
    im = jnp.where(im == 0, 0.0, im)
    if abs_and_angle:
        return jnp.stack([jnp.hypot(re, im), jnp.arctan2(im, re)], axis=-3)
    return jnp.stack([re, im], axis=-3)


_JAX_STFT = jdsp.stft


@pytest.fixture
def jax_stft_rule(monkeypatch):
    monkeypatch.setattr(jdsp, "stft", rule_stft)


@pytest.fixture
def jax_eager(jax_stft_rule, monkeypatch):
    monkeypatch.setattr(jmodel, "kokoro_generate",
                        jmodel.kokoro_generate.__wrapped__)


# ---------------------------------------------------------------------------
# ops: rnn
# ---------------------------------------------------------------------------

def _lstm_pair(rng, inp, hid):
    def one():
        return [rng.standard_normal(s).astype(np.float32) * 0.3
                for s in ((4 * hid, inp), (4 * hid, hid), (4 * hid,), (4 * hid,))]
    return one(), one()


@pytest.mark.parametrize("t,length", [(9, 9), (16, 7), (12, 1)])
def test_lstms_equal_jax(rng, t, length):
    fwd, bwd = _lstm_pair(rng, 10, 6)
    x = rng.standard_normal((t, 10)).astype(np.float32)
    jf, jb = jrnn.LSTMWeights(*map(jnp.asarray, fwd)), jrnn.LSTMWeights(*map(jnp.asarray, bwd))
    pf, pb = rnn.LSTMWeights(*map(_t, fwd)), rnn.LSTMWeights(*map(_t, bwd))
    for rev in (False, True):
        _close(rnn.lstm(_t(x), pf, reverse=rev), jrnn.lstm(jnp.asarray(x), jf, reverse=rev), 1e-5)
    _close(rnn.bilstm(_t(x), pf, pb), jrnn.bilstm(jnp.asarray(x), jf, jb), 1e-5)
    got = rnn.masked_bilstm(_t(x), length, pf, pb)
    _close(got, jrnn.masked_bilstm(jnp.asarray(x), length, jf, jb), 1e-5)
    assert not got[length:].any()           # the padded tail is zero
    # each direction of the batched step equals the unbatched LSTM on the
    # valid prefix (to rounding: the CPU's elementwise kernels take other
    # vector paths on the strided gate slices of two directions)
    _close(got[:length, :6], rnn.lstm(_t(x[:length]), pf), 1e-6)
    _close(got[:length, 6:], rnn.lstm(_t(x[:length]), pb, reverse=True), 1e-6)


def test_norms_equal_jax(rng):
    x = rng.standard_normal((7, 12)).astype(np.float32) * 3 + 1
    g, b = (rng.standard_normal(12).astype(np.float32) for _ in range(2))
    style = rng.standard_normal(5).astype(np.float32)
    w_fc = rng.standard_normal((24, 5)).astype(np.float32)
    b_fc = rng.standard_normal(24).astype(np.float32)
    J = jnp.asarray
    _close(rnn.layer_norm(_t(x), _t(g), _t(b)), jrnn.layer_norm(J(x), J(g), J(b)), 1e-5)
    _close(rnn.rms_norm(_t(x), _t(g)), jrnn.rms_norm(J(x), J(g)), 1e-5)
    _close(rnn.ada_layer_norm(_t(x), _t(style), _t(w_fc), _t(b_fc)),
           jrnn.ada_layer_norm(J(x), J(style), J(w_fc), J(b_fc)), 1e-5)
    xc = x.T.copy()                                           # (C=12, T=7)
    _close(rnn.adain_1d(_t(xc), _t(style), _t(w_fc), _t(b_fc)),
           jrnn.adain_1d(J(xc), J(style), J(w_fc), J(b_fc)), 1e-5)


# ---------------------------------------------------------------------------
# ops: dsp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,n", [(8, 4, 203), (20, 5, 600), (16, 4, 64)])
def test_stft_matches_jax(rng, n_fft, hop, n):
    """Magnitudes within 1e-5 of the largest, angles within 1e-5 rad of
    the JAX ones up to a whole turn (at a real bin with a negative real
    part the JAX FFT's leftover sign gives -pi or +pi), and the port's real
    bins (DC, Nyquist, every bin of frame 0) exactly 0 or +pi."""
    x = np.tanh(rng.standard_normal(n).astype(np.float32))
    w = dsp.hann_window(n_fft)
    _close(w, jdsp.hann_window(n_fft), 0)
    got = dsp.stft(_t(x), w, n_fft, hop).numpy()
    want = np.asarray(_JAX_STFT(jnp.asarray(x), jdsp.hann_window(n_fft), n_fft, hop))
    ri = np.asarray(_JAX_STFT(jnp.asarray(x), jdsp.hann_window(n_fft), n_fft, hop,
                              abs_and_angle=False))
    _close(got[0], want[0], 1e-5)
    turn = np.abs(np.remainder(got[1] - want[1] + np.pi, 2 * np.pi) - np.pi)
    assert turn.max() <= 1e-5
    real = np.zeros(got[1].shape, bool)
    real[0] = real[:, 0] = True
    if n_fft % 2 == 0:
        real[:, n_fft // 2] = True
    np.testing.assert_array_equal(
        got[1][real], np.where(ri[0][real] < 0, np.pi, 0.0).astype(np.float32))
    _close(dsp.stft(_t(x), w, n_fft, hop, abs_and_angle=False).numpy()[0], ri[0], 1e-5)


def test_stft_negative_dc_and_zero_frames_equal_jax():
    """A frame whose DC bin is negative (+pi on both) and an all-zero frame
    (angle 0 on both); and the port's rule where the JAX FFT leaves -0: an
    all-zero frame of mixed-sign zeros gives 0, not +-pi."""
    n_fft, hop = 20, 5
    x = np.zeros(200, np.float32)
    x[60:80] = -1.0                        # frames around 14: negative DC
    got = dsp.stft(_t(x), dsp.hann_window(n_fft), n_fft, hop).numpy()
    want = np.asarray(_JAX_STFT(jnp.asarray(x), jdsp.hann_window(n_fft), n_fft, hop))
    assert got[1, 14, 0] == want[1, 14, 0] == np.float32(np.pi)
    assert (got[1, 30:] == 0).all() and (want[1, 30:] == 0).all()
    mixed = np.copysign(np.zeros(200, np.float32),
                        np.random.default_rng(3).standard_normal(200))
    assert not dsp.stft(_t(mixed), dsp.hann_window(n_fft), n_fft, hop)[1].any()


@pytest.mark.parametrize("n_fft,hop,frames", [(8, 4, 50), (20, 5, 121), (16, 4, 9)])
def test_istft_and_window_sum_equal_jax(rng, n_fft, hop, frames):
    w = dsp.hann_window(n_fft)
    jw = jdsp.hann_window(n_fft)
    _close(dsp.window_squared_sum(n_fft, hop, frames, w),
           jdsp.window_squared_sum(n_fft, hop, frames, jw), 1e-6)
    bins = n_fft // 2 + 1
    spec = np.stack([np.exp(rng.standard_normal((frames, bins)) * 0.5),
                     rng.uniform(-np.pi, np.pi, (frames, bins))]).astype(np.float32)
    _close(dsp.istft(_t(spec), w, n_fft, hop),
           jdsp.istft(jnp.asarray(spec), jw, n_fft, hop), 1e-5)
    # a real signal survives stft -> istft away from the edges
    x = rng.standard_normal(frames * hop).astype(np.float32)
    back = dsp.istft(dsp.stft(_t(x), w, n_fft, hop), w, n_fft, hop)[: frames * hop]
    _close(back[n_fft:-n_fft], x[n_fft:-n_fft], 1e-5)


def test_upscale_uv_noise_tanh_scan_sum_equal_jax(rng):
    x = rng.standard_normal((3, 37)).astype(np.float32)
    for factor in (1, 4, 300):
        _close(dsp.upscale_linear(_t(x), factor), jdsp.upscale_linear(jnp.asarray(x), factor), 0)
    f0 = rng.uniform(0, 20, 500).astype(np.float32)
    noise = rng.random((9, 500)).astype(np.float32)
    for p, j in zip(dsp.uv_noise(_t(f0), 9, _t(noise)),
                    jdsp.uv_noise(jnp.asarray(f0), 9, jnp.asarray(noise))):
        _close(p, j, 0)
    alpha = np.abs(rng.standard_normal((4, 1))).astype(np.float32) + 0.5
    xs = rng.standard_normal((4, 30)).astype(np.float32)
    _close(dsp.snake_1d(_t(xs), _t(alpha)), jdsp.snake_1d(jnp.asarray(xs), jnp.asarray(alpha)), 1e-6)
    # the harmonic source's tanh and its phase's running sum: the bits of
    # jnp.tanh and jnp.cumsum on the CPU
    v = np.concatenate([rng.standard_normal(200_000) * sc
                        for sc in (1e-4, 0.01, 0.3, 2, 10)]).astype(np.float32)
    v[:4] = (0.0, -0.0, 8.5, -20.0)
    np.testing.assert_array_equal(dsp.rational_tanh(_t(v)).numpy(),
                                  np.asarray(jnp.tanh(jnp.asarray(v))))
    for n in (1, 15, 16, 17, 500, 20480):
        a = rng.random((9, n)).astype(np.float32)
        np.testing.assert_array_equal(dsp.scan_sum(_t(a)).numpy(),
                                      np.asarray(jnp.cumsum(jnp.asarray(a), axis=-1)))


# ---------------------------------------------------------------------------
# the model's graphs on tests/test_kokoro.py's tiny model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, JAX weights, port cfg, port weights) of the tiny model."""
    cfg, w = tiny_kokoro(np.random.default_rng(0))
    pcfg = pmodel.KokoroConfig(**dataclasses.asdict(cfg))
    pw = kokoro_weights_from_numpy(jax.tree_util.tree_map(np.asarray, w),
                                   device="cpu")
    return cfg, w, pcfg, pw


TOKENS = [0, 5, 7, 3, 9, 2, 11, 4, 0]


def _duration_both(tiny, tokens, p, style):
    cfg, w, pcfg, pw = tiny
    t = np.zeros(p, np.int32)
    t[: len(tokens)] = tokens
    dj, hj = jmodel.kokoro_duration(cfg, w, jnp.asarray(t), jnp.int32(len(tokens)),
                                    jnp.asarray(style))
    dp, hp = pmodel.kokoro_duration(pcfg, pw, torch.from_numpy(t).long(),
                                    len(tokens), _t(style))
    return t, (np.asarray(dj), np.asarray(hj)), (dp.numpy(), hp.numpy())


@pytest.mark.parametrize("p", [16, 32])
def test_duration_equals_jax(tiny, p):
    style = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    _, (dj, hj), (dp, hp) = _duration_both(tiny, TOKENS, p, style)
    np.testing.assert_array_equal(dp, dj)
    np.testing.assert_allclose(hp, hj, atol=1e-5)


def test_generate_equals_jax(tiny, jax_eager):
    """The generation graph from the JAX durations / hidden states and one
    uv array, at two frame buckets."""
    cfg, w, pcfg, pw = tiny
    rng = np.random.default_rng(2)
    style, style2 = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
    t, (dj, hj), _ = _duration_both(tiny, TOKENS, 16, style)
    total = int(dj.sum())
    for f in (total + 3, total + 40):
        uv = rng.random((cfg.harmonic_num + 1, int(2 * f * cfg.upsample_scale))
                        ).astype(np.float32)
        wj, tj = jmodel.kokoro_generate(cfg, w, jnp.asarray(t), jnp.int32(len(TOKENS)),
                                        jnp.asarray(dj), jnp.asarray(hj),
                                        jnp.asarray(style), jnp.asarray(style2),
                                        jnp.asarray(uv), n_frames=f)
        wp, tp = pmodel.kokoro_generate(pcfg, pw, torch.from_numpy(t).long(),
                                        len(TOKENS), _t(dj), _t(hj), _t(style),
                                        _t(style2), _t(uv), n_frames=f)
        assert tp == int(tj) == total
        assert wp.shape == (f * cfg.up_sampling_factor,)
        assert not wp[total * cfg.up_sampling_factor:].any()
        _close(wp, wj, WAVE_TOL)


def test_res_blocks_equal_jax(tiny):
    cfg, w, pcfg, pw = tiny
    rng = np.random.default_rng(3)
    style = rng.standard_normal(8).astype(np.float32)
    for blk_j, blk_p, cin in ((w.decoder.decoder_blocks[1], pw.decoder.decoder_blocks[1], 24),
                              (w.prosody.f0_blocks[0], pw.prosody.f0_blocks[0], 24),
                              (w.decoder.encoder_block, pw.decoder.encoder_block, 32)):
        x = rng.standard_normal((cin, 40)).astype(np.float32)
        oj, vj = jmodel.ada_res_block(jnp.asarray(x), jnp.asarray(style), blk_j, 33)
        op, vp = pmodel.ada_res_block(_t(x), _t(style), blk_p, 33)
        assert int(vj) == vp
        _close(op, oj, 1e-5)
    gj, gp = w.decoder.generator.res_blocks[2], pw.decoder.generator.res_blocks[2]
    x = rng.standard_normal((12, 80)).astype(np.float32)
    _close(pmodel.gen_res_block(_t(x), _t(style), gp, (1, 3, 5), (1, 3, 5), 70),
           jmodel.gen_res_block(jnp.asarray(x), jnp.asarray(style), gj,
                                (1, 3, 5), (1, 3, 5), 70), 1e-5)


# ---------------------------------------------------------------------------
# GGUF, runners, CLI and server
# ---------------------------------------------------------------------------

GRAPHEMES = ["<unk>"] + list("abcdefghijklmnopqrstuvwxyz")
VOCAB = ["$", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m",
         "n", "o", " ", "p", "r", "s", "t", "u", "w", "ɑ", "æ", "ə", "ˈ", "ɪ",
         "ʃ", "ð"]
PHONEMIZER = dict(graphemes=GRAPHEMES,
                  rule_keys=[c for c in "abcdefghijklmnopqrstuvwxyz"],
                  rule_phonemes=["æ", "b", "k", "d", "ɪ", "f", "g", "h", "ɪ",
                                 "j", "k", "l", "m", "n", "ɑ", "p", "k", "r",
                                 "s", "t", "ə", "f", "w", "ks", "i", "s"],
                  dict_keys=["the", "hello"], dict_values=["ðə", "həlˈoʊ"])
PROMPT = "The cat sat on a mat, and the dog ran off."
LONG_PROMPT = " ".join(["the quick brown fox jumps over a lazy dog."] * 3)


@pytest.fixture(scope="module")
def kokoro_gguf(tmp_path_factory):
    cfg, w = tiny_kokoro(np.random.default_rng(0))
    rng = np.random.default_rng(4)
    voices = {"af_heart": rng.standard_normal((32, 16)).astype(np.float32) * 0.2,
              "bm_lewis": rng.standard_normal((32, 16)).astype(np.float32) * 0.2}
    path = str(tmp_path_factory.mktemp("kokoro") / "kokoro-tiny.gguf")
    # serialize_kokoro, with a rule-based phonemizer in the file
    import test_e2e_kokoro
    orig = test_e2e_kokoro.write_kokoro_gguf
    test_e2e_kokoro.write_kokoro_gguf = \
        lambda *a, **k: orig(*a, phonemizer=PHONEMIZER, **k)
    try:
        serialize_kokoro(path, cfg, w, voices, VOCAB)
    finally:
        test_e2e_kokoro.write_kokoro_gguf = orig
    return path, cfg, w


NOISE = np.random.default_rng(5).random((4, 2 * 10240 * 16)).astype(np.float32)


@pytest.fixture
def same_noise(monkeypatch, jax_eager):
    """Both runners draw NOISE's leading block: the JAX one through
    `jax.random.uniform` (its only draw), the port through its `noise`
    method."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(NOISE[: shape[0], : shape[1]]))
    monkeypatch.setattr(pmodel.KokoroRunner, "noise",
                        lambda self, shape, seed=None: torch.from_numpy(
                            NOISE[: shape[0], : shape[1]].copy()))


@pytest.fixture(scope="module")
def runners(kokoro_gguf):
    path = kokoro_gguf[0]
    return runner_from_file(path, device="cpu"), jax_runner_from_file(path)


def test_runner_text_to_wav_equals_jax(runners, same_noise):
    port, ref = runners
    assert port.arch == "kokoro" and port.sample_rate == 24000
    assert port.list_voices() == ref.list_voices() == ["af_heart", "bm_lewis"]
    assert port.cfg.style_half_size == ref.cfg.style_half_size == 8
    assert port.cfg.harmonic_num == ref.cfg.harmonic_num == 3
    for text, voice in ((PROMPT, "af_heart"), ("hello the world!", "bm_lewis"),
                        ("abc def", "nobody")):
        assert port.phonemizer.text_to_phonemes(text) == ref.phonemizer.text_to_phonemes(text)
        got = port.generate(text, GenerationConfig(voice=voice, seed=0))
        want = ref.generate(text, JConfig(voice=voice, seed=0))
        assert got.sample_rate == want.sample_rate == 24000
        assert got.n_outputs > 0 and got.n_outputs % 32 == 0
        _close(got.audio, want.audio, WAVE_TOL)


def test_runner_long_text_chunks_and_stream(runners, same_noise):
    """A text of more than 512 tokens: the same chunks as the JAX runner
    (the tiny model's context is 64), the same waveform, and the port's
    stream equal to its generate chunk for chunk."""
    port, ref = runners
    text = " ".join(["abcdefg hijklmnop"] * 40) + "."
    clauses = [text]
    chunks = port.tokenize_chunks(clauses)
    assert sum(len(c) for c in chunks) > 512
    assert chunks == ref.tokenize_chunks(clauses) and len(chunks) > 8
    conf = GenerationConfig(voice="af_heart", seed=1)
    whole = port.generate(LONG_PROMPT, conf).audio
    parts = list(port.generate_stream(LONG_PROMPT, conf))
    assert len(parts) > 1
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    _close(whole, ref.generate(LONG_PROMPT, JConfig(voice="af_heart", seed=1)).audio,
           WAVE_TOL)
    assert list(port.generate_stream("...", conf)) == []


def test_seeded_noise_repeats(runners):
    port, _ = runners
    a, b = port.noise((4, 100), seed=7), port.noise((4, 100), seed=7)
    assert torch.equal(a, b) and 0 <= float(a.min()) and float(a.max()) < 1
    assert not torch.equal(a, port.noise((4, 100), seed=8))


def test_weights_from_numpy_equal_gguf_load(runners, kokoro_gguf):
    port, _ = runners
    _, _, w = kokoro_gguf
    carried = kokoro_weights_from_numpy(jax.tree_util.tree_map(np.asarray, w),
                                        device="cpu")
    a = jax.tree_util.tree_leaves(carried, is_leaf=lambda x: x is None)
    b = jax.tree_util.tree_leaves(port.weights, is_leaf=lambda x: x is None)
    assert len(a) == len(b) > 300
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.shape == y.shape and torch.equal(x, y)


def test_cli_writes_24k_wav(kokoro_gguf, tmp_path, same_noise):
    path = kokoro_gguf[0]
    out = str(tmp_path / "k.wav")
    assert cli.main(["-mp", path, "-p", PROMPT, "-sp", out, "--device", "cpu",
                     "-v", "bm_lewis", "--seed", "3"]) == 0
    audio, rate = read_audio_file(out)
    assert rate == 24000 and audio.size > 0 and audio.size % 32 == 0
    port = runner_from_file(path, device="cpu")
    want = port.generate(PROMPT, GenerationConfig(voice="bm_lewis", seed=3)).audio
    np.testing.assert_allclose(audio, np.clip(want, -1, 1), atol=1.5 / 32767)


def test_server_pool_voices_and_stream(kokoro_gguf, same_noise):
    """Kokoro through the worker pool even with batch slots (no batched
    engine), /v1/audio/voices, and a streamed request equal to the same
    request sent whole within 1 LSB."""
    from tts_tpu_torch.server.server import build_server, serve
    srv = build_server(kokoro_gguf[0], batch_slots=2, n_parallel=2,
                       timeout=120, device="cpu")
    httpd = serve(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        for _ in range(600):
            if srv.state != "LOADING":
                break
            time.sleep(0.05)
        assert srv.state == "READY", srv.load_error
        assert srv.batched_workers == {}
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/v1/audio/voices", timeout=30) as r:
            assert json.loads(r.read())["voices"] == {"kokoro-tiny": ["af_heart", "bm_lewis"]}

        def post(payload):
            req = urllib.request.Request(
                base + "/v1/audio/speech", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.headers.get("Content-Type", ""), r.read()

        body = {"input": LONG_PROMPT, "voice": "af_heart", "seed": 2}
        mime, wav = post(body)
        audio, rate = decode_wav(wav)
        assert rate == 24000 and audio.size > 0
        mime, pcm = post(dict(body, stream=True))
        assert "rate=24000" in mime
        streamed = np.frombuffer(pcm, "<i2").astype(np.int32)
        whole = np.round(audio * 32767).astype(np.int32)
        assert streamed.shape == whole.shape
        assert np.abs(streamed - whole).max() <= 1
        assert srv.metrics_json()["streams_total"] == 1
    finally:
        httpd.shutdown()


def test_entry_points_need_a_card_unless_asked(kokoro_gguf):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: there is nothing to refuse")
    from tts_tpu_torch.gguf.reader import GGUFReader
    from tts_tpu_torch.models.kokoro.loader import load_kokoro_runner
    path, _, w = kokoro_gguf
    tree = jax.tree_util.tree_map(np.asarray, w)
    with GGUFReader(path) as r:
        for make in (lambda: runner_from_file(path),
                     lambda: load_kokoro_weights_default(r),
                     lambda: kokoro_weights_from_numpy(tree),
                     lambda: pmodel.KokoroRunner(pmodel.KokoroConfig(), None,
                                                 None, {}),
                     lambda: cli.main(["-mp", path, "-p", "hi", "-sp", "/dev/null"])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_kokoro_runner(GGUFReader(path), GenerationConfig())


def load_kokoro_weights_default(r):
    return pmodel.load_kokoro_weights(r, pmodel.KokoroConfig.from_gguf(r))
