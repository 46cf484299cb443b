"""PyTorch port: streaming and conditional prompts through the server and
the CLI, over real HTTP on the CPU (device="cpu").

- `"stream": true` through a batched worker (Parler, Dia and Orpheus, the
  engines' chunk cut to a few steps so that the worker vocodes each slot's
  new frames between chunks) gives chunked 16-bit PCM with the
  `audio/pcm;rate=...` header: the samples of the same request answered
  whole, within 1 LSB on >= 95% of samples and within the seam tolerance
  (0.2) elsewhere; through the single-stream path (no batched worker) the
  runner's own `generate_stream`, sample for sample.
- Admission: with n_parallel 1, a second single-stream stream waits, then
  gets 503 while the first holds the slot; /metrics counts streams_total
  and streams_rejected.
- A failing stream segment ends that stream and counts the request as
  failed; a request in the other slot still succeeds.
- /v1/audio/conditional-prompt: 501 without --text-encoder-path, 400 for an
  empty prompt or n_parallel > 1, 200 with one, after which the batched
  engine's greedy answer equals the runner's on the new cross K/V.
- The CLI's --conditional-prompt (refused without --text-encoder-path, a
  WAV with one, Tc the prompt's token count) and --play with no playback
  backend (the file is written).
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_conditional_prompt import make_tiny_t5_gguf
from test_torch_port_dia import write_tiny_dia
from test_torch_port_orpheus import (cut_port_window, small_prompt_ids,  # noqa: F401
                                     write_tiny_orpheus)
from test_torch_port_parler import _gguf
from test_torch_port_server import _get, _post, _start
from tts_tpu.gguf import quants
from tts_tpu_torch.apps import cli
from tts_tpu_torch.audio.wav import decode_wav, read_audio_file
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models import registry
from tts_tpu_torch.server import server as srv_mod
from tts_tpu_torch.server.server import TTSServer, build_server

GREEDY = GenerationConfig(sample=False)


def stream(base, payload, timeout=120):
    """POST a stream request: (status, content type, int16 samples)."""
    req = urllib.request.Request(
        base + "/v1/audio/speech", data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            assert r.headers.get("Transfer-Encoding") == "chunked"
            return r.status, r.headers["Content-Type"], np.frombuffer(
                r.read(), "<i2")
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def pcm(audio):
    return (np.clip(audio, -1, 1) * 32767).astype("<i2")


def like_whole(got, whole):
    """The streamed samples against the whole answer's 16-bit samples."""
    assert got.shape == whole.shape and whole.size
    diff = np.abs(got.astype(np.int32) - whole.astype(np.int32))
    assert (diff <= 1).mean() >= 0.95
    assert diff.max() <= 0.2 * 32767


def small_chunks(srv, n=3):
    for bw in srv.batched_workers.values():
        bw.engine.chunk = n


@pytest.fixture(scope="module")
def parler(tmp_path_factory):
    d = tmp_path_factory.mktemp("parler-stream")
    return _gguf(d, 32, 4, quants.GGML_TYPE_Q4_0, False)


def test_stream_through_the_batched_worker(parler):
    srv = build_server(parler, config=GREEDY, batch_slots=2, device="cpu")
    httpd, base = _start(srv)
    small_chunks(srv)
    try:
        texts = ("hello", "wor ld a b c")
        whole = {t: decode_wav(_post(base + "/v1/audio/speech", {"input": t})[1])[0]
                 for t in texts}
        got = {}
        threads = [threading.Thread(target=lambda t=t: got.__setitem__(
            t, stream(base, {"input": t}))) for t in texts]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for t in texts:
            code, mime, samples = got[t]
            assert code == 200
            assert mime == "audio/pcm;rate=44100;encoding=signed-integer;bits=16"
            like_whole(samples, pcm(whole[t]))
        m = json.loads(_get(base + "/metrics")[1])
        assert m["streams_total"] == 2 and m["requests_failed"] == 0
        assert m["requests_total"] == 4 and m["streams_rejected"] == 0
    finally:
        httpd.shutdown()


def test_stream_through_the_single_stream_path(parler):
    srv = build_server(parler, config=GREEDY, device="cpu")
    httpd, base = _start(srv)
    try:
        assert not srv.batched_workers
        code, mime, samples = stream(base, {"input": "hello"})
        assert code == 200 and mime.startswith("audio/pcm;rate=44100")
        runner = srv.runners["parler-q"]
        want = np.concatenate(list(runner.generate_stream("hello", GREEDY)))
        np.testing.assert_array_equal(samples, pcm(want))
        assert srv.metrics_json()["streams_total"] == 1
    finally:
        httpd.shutdown()


def test_dia_and_orpheus_stream_through_their_workers(tmp_path, monkeypatch,
                                                      small_prompt_ids):
    """The DAC path with the Dia engine, the SNAC path (position-stable
    noise of the request's seed) with the Orpheus engine."""
    cut_port_window(monkeypatch)
    dia = str(tmp_path / "dia.gguf")
    write_tiny_dia(dia, np.random.default_rng(1))
    orpheus = str(tmp_path / "orpheus.gguf")
    write_tiny_orpheus(orpheus, np.random.default_rng(0))
    for path, payload, rate in (
            (dia, {"input": "[S1] a b c d. [S2] e f g."}, 44100),
            (orpheus, {"input": "abcd cab", "voice": "zoe", "seed": 7}, 24000)):
        srv = build_server(path, config=GREEDY, batch_slots=2, device="cpu")
        httpd, base = _start(srv)
        small_chunks(srv)
        try:
            whole, r = decode_wav(_post(base + "/v1/audio/speech", payload)[1])
            code, mime, samples = stream(base, payload)
            assert code == 200 and mime.startswith(f"audio/pcm;rate={rate};")
            like_whole(samples, pcm(whole))
            assert srv.metrics_json()["requests_failed"] == 0
        finally:
            httpd.shutdown()


def test_single_stream_admission_503():
    srv = TTSServer({"dummy": "test:dummy"}, "dummy", GenerationConfig(),
                    n_parallel=1, timeout=1, device="cpu")
    httpd, base = _start(srv)
    started, release = threading.Event(), threading.Event()
    runner = srv.runners["dummy"]

    def slow_stream(text, config=None, **kw):
        started.set()
        release.wait(30)
        yield runner.generate(text, config).audio

    runner.generate_stream = slow_stream
    first = {}
    th = threading.Thread(target=lambda: first.update(r=stream(base, {"input": "a"})))
    try:
        th.start()
        assert started.wait(30)
        code, _, body = stream(base, {"input": "b"})
        assert code == 503
        assert json.loads(body)["error"]["type"] == "unavailable_error"
        release.set()
        th.join(60)
        assert first["r"][0] == 200 and first["r"][2].size == 44100
        m = json.loads(_get(base + "/metrics")[1])
        assert m["streams_total"] == 1 and m["streams_rejected"] == 1
        assert m["requests_failed"] == 0
    finally:
        release.set()
        httpd.shutdown()


def test_failing_segment_fails_its_stream_only(parler, monkeypatch):
    def boom(self, task, ss, n, out, done):
        raise RuntimeError("vocoder fault")

    monkeypatch.setattr(srv_mod.BatchedModelWorker, "_stream_segment", boom)
    srv = build_server(parler, config=GREEDY, batch_slots=2, device="cpu")
    httpd, base = _start(srv)
    small_chunks(srv)
    try:
        got = {}
        th = threading.Thread(target=lambda: got.update(
            s=stream(base, {"input": "wor ld a b c"})))
        th.start()
        code, body, _ = _post(base + "/v1/audio/speech", {"input": "hello"})
        th.join(60)
        assert code == 200 and decode_wav(body)[0].size
        assert got["s"][0] == 200      # the stream had begun
        m = json.loads(_get(base + "/metrics")[1])
        assert m["streams_total"] == 1 and m["requests_failed"] == 1
        assert m["requests_total"] == 2
    finally:
        httpd.shutdown()


@pytest.fixture(scope="module")
def t5(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("t5") / "t5.gguf")
    make_tiny_t5_gguf(path, np.random.default_rng(1), out_size=32)
    return path


def _post_prompt(base, payload):
    return _post(base + "/v1/audio/conditional-prompt", payload)


def test_conditional_prompt_route(parler, t5):
    srv = build_server(parler, config=GREEDY, batch_slots=2, device="cpu")
    httpd, base = _start(srv)
    try:   # no encoder path
        code, body, _ = _post_prompt(base, {"conditional_prompt": "calm"})
        assert code == 501
        assert json.loads(body)["error"]["type"] == "not_supported_error"
    finally:
        httpd.shutdown()
    srv = build_server(parler, config=GREEDY, n_parallel=2,
                       text_encoder_path=t5, device="cpu")
    httpd, base = _start(srv)
    try:
        assert _post_prompt(base, {"conditional_prompt": "calm"})[0] == 400
    finally:
        httpd.shutdown()
    srv = build_server(parler, config=GREEDY, batch_slots=2,
                       text_encoder_path=t5, device="cpu")
    httpd, base = _start(srv)
    try:
        for bad in ({}, {"conditional_prompt": ""}, {"conditional_prompt": 3},
                    {"conditional_prompt": "calm", "model": "nope"}):
            assert _post_prompt(base, bad)[0] == 400, bad
        runner = srv.runners["parler-q"]
        before = runner.weights.layers.cross_k.shape[2]
        code, body, _ = _post_prompt(base, {"conditional_prompt": "calm voice"})
        assert code == 200 and json.loads(body) == {"success": True}
        tc = runner.cfg.n_encode_length
        assert runner.weights.layers.cross_k.shape[2] == tc != before
        eng = srv.batched_workers["parler-q"].engine
        assert eng.weights is runner.weights
        for text in ("hello", "wor ld a b c"):
            code, body, _ = _post(base + "/v1/audio/speech", {"input": text})
            assert code == 200
            np.testing.assert_array_equal(
                decode_wav(body)[0], decode_wav(srv_mod.encode_wav(
                    runner.generate(text, GREEDY).audio, 44100))[0])
    finally:
        httpd.shutdown()


def test_cli_conditional_prompt_and_play(parler, t5, tmp_path, capsys,
                                         monkeypatch):
    assert cli.main(["-mp", parler, "-p", "hello", "-cp", "calm",
                     "--device", "cpu"]) == 1
    assert "'--text-encoder-path' must be specified" in capsys.readouterr().err
    made = []
    load = registry.runner_from_file

    def keep(*a, **k):
        made.append(load(*a, **k))
        return made[-1]

    monkeypatch.setattr(cli, "runner_from_file", keep)
    wav = str(tmp_path / "cp.wav")
    assert cli.main(["-mp", parler, "-p", "hello world", "-cp", "calm voice",
                     "-tep", t5, "-sp", wav, "--seed", "1", "--device",
                     "cpu"]) == 0
    audio, rate = read_audio_file(wav)
    assert rate == 44100 and audio.size > 0 and np.all(np.abs(audio) <= 1)
    ids = made[0].tokenizer.tokenize("calm voice")
    assert made[0].cfg.n_encode_length == len(ids) + 1   # and the EOS
    played = str(tmp_path / "played.wav")
    assert cli.main(["-mp", parler, "-p", "hello", "--play", "-sp", played,
                     "--device", "cpu"]) == 0
    assert "no playback backend" in capsys.readouterr().err
    assert read_audio_file(played)[0].size > 0
