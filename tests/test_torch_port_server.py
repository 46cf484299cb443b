"""PyTorch port: the OpenAI-style server over real HTTP on the CPU
(device="cpu"), the port's counterpart of tests/test_server.py: routes,
error JSON (a stream's and the conditional-prompt route's too; their paths
are tests/test_torch_port_server_stream.py's), /metrics, LOADING 503,
`--text-encoder-path` reaching the server, concurrent requests, and
`--batch-slots 2` against `--batch-slots 0` on a tiny Parler GGUF under a
greedy default config: byte-identical WAVs, and the same for a tiny
Orpheus GGUF (its batched engine against the worker pool)."""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from test_torch_port_orpheus import (cut_port_window, small_prompt_ids,  # noqa: F401
                                     write_tiny_orpheus)
from test_torch_port_parler import _gguf
from tts_tpu.gguf import quants
from tts_tpu_torch.audio.wav import decode_wav
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.server import server as srv_mod
from tts_tpu_torch.server.server import TTSServer, build_server, serve


def _start(srv):
    httpd = serve(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    for _ in range(600):
        if srv.state != "LOADING":
            break
        time.sleep(0.05)
    assert srv.state == "READY", srv.load_error
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


@pytest.fixture(scope="module")
def dummy():
    srv = TTSServer({"dummy": "test:dummy"}, "dummy", GenerationConfig(),
                    n_parallel=2, timeout=60, device="cpu")
    httpd, base = _start(srv)
    yield base
    httpd.shutdown()


@pytest.mark.parametrize("path,code,key", [
    ("/health", 200, "status"), ("/v1/models", 200, "data"),
    ("/v1/audio/voices", 200, "voices"), ("/metrics", 200, "realtime_factor"),
    ("/nope", 404, "error")])
def test_get_routes(dummy, path, code, key):
    got, body, mime = _get(dummy + path)
    assert got == code and "json" in mime and key in json.loads(body)
    if code == 404:
        assert json.loads(body)["error"]["type"] == "not_found_error"


def test_index_page(dummy):
    code, body, mime = _get(dummy + "/")
    assert code == 200 and "html" in mime and b"/v1/audio/speech" in body


@pytest.mark.parametrize("fmt,mime,magic", [("wav", "audio/wav", b"RIFF"),
                                            ("aiff", "audio/aiff", b"FORM")])
def test_speech_formats(dummy, fmt, mime, magic):
    code, body, headers = _post(dummy + "/v1/audio/speech",
                                {"input": "ab", "response_format": fmt})
    assert code == 200 and headers["Content-Type"] == mime
    assert body[:4] == magic
    if fmt == "wav":
        audio, rate = decode_wav(body)
        assert rate == 44100 and len(audio) == 2 * 44100


@pytest.mark.parametrize("path,payload,code,etype", [
    ("/v1/audio/speech", {}, 400, "invalid_request_error"),
    ("/v1/audio/speech", {"input": ""}, 400, "invalid_request_error"),
    ("/v1/audio/speech", {"input": "x", "response_format": "mp3"}, 501,
     "not_supported_error"),
    ("/v1/audio/speech", {"input": "x", "model": "nope"}, 400,
     "invalid_request_error"),
    ("/v1/audio/speech", {"input": "", "stream": True}, 400,
     "invalid_request_error"),
    # the fixture's two workers: conditional prompts need one
    ("/v1/audio/conditional-prompt", {"conditional_prompt": "calm"}, 400,
     "invalid_request_error"),
    ("/v1/nope", {"input": "x"}, 404, "not_found_error")])
def test_error_json(dummy, path, payload, code, etype):
    got, body, _ = _post(dummy + path, payload)
    err = json.loads(body)["error"]
    assert got == code and err["code"] == code and err["type"] == etype


def test_concurrent_requests_and_metrics(dummy):
    before = json.loads(_get(dummy + "/metrics")[1])
    codes = []

    def hit():
        codes.append(_post(dummy + "/v1/audio/speech", {"input": "a"})[0])

    threads = [threading.Thread(target=hit) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert codes == [200] * 3
    m = json.loads(_get(dummy + "/metrics")[1])
    assert m["requests_total"] - before["requests_total"] == 3
    assert m["requests_failed"] == before["requests_failed"]
    assert m["audio_seconds_total"] - before["audio_seconds_total"] == 3.0
    assert m["state"] == "READY" and "uptime_seconds" in m


def test_loading_503():
    """Before load() has finished, model routes answer 503; /health is up."""
    srv = TTSServer({"dummy": "test:dummy"}, "dummy", GenerationConfig(),
                    device="cpu")
    handler = type("H", (srv_mod._Handler,), {"server_obj": srv})
    from http.server import ThreadingHTTPServer
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, body, _ = _get(base + "/v1/models")
        assert code == 503
        assert json.loads(body)["error"]["type"] == "unavailable_error"
        assert _post(base + "/v1/audio/speech", {"input": "x"})[0] == 503
        assert _get(base + "/health")[0] == 200
    finally:
        httpd.shutdown()


def test_batched_server_matches_unbatched(tmp_path):
    """Concurrent requests through --batch-slots 2 (the batched engine) give
    the same bytes as --batch-slots 0 (the worker pool), greedy; a third
    request waits for a free slot."""
    _gguf(tmp_path, 32, 4, quants.GGML_TYPE_Q4_0, False)
    texts = ("hello world", "wor ld a b", "hello")

    def boot(slots):
        return _start(build_server(str(tmp_path / "parler-q.gguf"),
                                   config=GenerationConfig(sample=False),
                                   batch_slots=slots, device="cpu"))

    httpd, base = boot(0)
    ref = {t: _post(base + "/v1/audio/speech", {"input": t}) for t in texts}
    httpd.shutdown()
    srv = build_server(str(tmp_path / "parler-q.gguf"),
                       config=GenerationConfig(sample=False), batch_slots=2,
                       device="cpu")
    httpd, base = _start(srv)
    assert list(srv.batched_workers) == ["parler-q"]
    results = {}

    def req(text):
        results[text] = _post(base + "/v1/audio/speech", {"input": text})

    threads = [threading.Thread(target=req, args=(t,)) for t in texts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    httpd.shutdown()
    for text in texts:
        code, body, headers = results[text]
        assert code == ref[text][0] == 200, (text, body[:200])
        assert body == ref[text][1] and headers["Content-Type"] == "audio/wav"
        assert "X-TTS-Top-K-Applied" not in headers   # greedy: no cap applies
    assert srv.metrics_json()["requests_total"] == 3


def test_top_k_cap_header(tmp_path):
    """A sampled request the batched engine serves with top_k 0 is told the
    cap it got; one with top_k 50 is not."""
    _gguf(tmp_path, 32, 4, quants.GGML_TYPE_Q4_0, False)
    httpd, base = _start(build_server(str(tmp_path / "parler-q.gguf"),
                                      batch_slots=2, device="cpu"))
    try:
        code, _, headers = _post(base + "/v1/audio/speech",
                                 {"input": "hello", "top_k": 0})
        assert code == 200 and headers["X-TTS-Top-K-Applied"] == "256"
        code, _, headers = _post(base + "/v1/audio/speech",
                                 {"input": "hello", "top_k": 50})
        assert "X-TTS-Top-K-Applied" not in headers
    finally:
        httpd.shutdown()


def test_main_refuses_text_encoder(capsys, monkeypatch):
    """`--text-encoder-path` is no longer refused: main hands it to the
    server (whose conditional-prompt route reads it) and serves."""
    built = []

    class Httpd:
        def serve_forever(self):
            raise KeyboardInterrupt

    def fake_serve(server, host, port):
        built.append(server)
        return Httpd()

    monkeypatch.setattr(srv_mod, "serve", fake_serve)
    assert srv_mod.main(["-mp", "test:dummy", "-tep", "t5.gguf",
                         "--device", "cpu"]) == 0
    assert built[0].text_encoder_path == "t5.gguf"
    assert "not supported" not in capsys.readouterr().err


@pytest.mark.parametrize("slots", [0, 8])
def test_orpheus_served_by_the_pool(tmp_path, monkeypatch, small_prompt_ids,
                                    slots):
    """An Orpheus model under --batch-slots 8 gets a batched worker (the
    continuous-batching engine), under --batch-slots 0 the worker pool.
    Concurrent greedy requests with a voice and a seed give 24 kHz WAVs,
    byte-identical to the pool's answers; an unknown voice gets the
    runner's error, and /v1/audio/voices lists the Orpheus voices. The tiny
    GGUF, its in-vocab prompt ids and the cut generation window come from
    tests/test_torch_port_orpheus.py."""
    import numpy as np
    cut_port_window(monkeypatch)
    path = str(tmp_path / "orpheus.gguf")
    write_tiny_orpheus(path, np.random.default_rng(0))
    texts = ("abcd cab", "ab", "dd cadd")

    def payload(text):
        return {"input": text, "voice": "zoe", "seed": 7}

    def boot(n):
        return _start(build_server(path, config=GenerationConfig(sample=False),
                                   batch_slots=n, device="cpu"))

    httpd, base = boot(0)
    ref = {t: _post(base + "/v1/audio/speech", payload(t)) for t in texts}
    httpd.shutdown()
    srv = build_server(path, config=GenerationConfig(sample=False),
                       batch_slots=slots, device="cpu")
    httpd, base = _start(srv)
    results = {}

    def req(text):
        results[text] = _post(base + "/v1/audio/speech", payload(text))

    try:
        assert list(srv.batched_workers) == (["orpheus"] if slots else [])
        code, body, _ = _get(base + "/v1/audio/voices")
        assert code == 200 and "zoe" in json.loads(body)["voices"]["orpheus"]
        threads = [threading.Thread(target=req, args=(t,)) for t in texts]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        code, body, _ = _post(base + "/v1/audio/speech",
                              {"input": "abcd", "voice": "bob"})
        assert code == 500 and b"not a valid Orpheus voice" in body
    finally:
        httpd.shutdown()
    for text in texts:
        code, body, headers = results[text]
        assert code == ref[text][0] == 200, (text, body[:200])
        assert headers["Content-Type"] == "audio/wav" and body == ref[text][1]
        audio, rate = decode_wav(body)
        assert rate == 24000 and audio.size == 12 * 8
        assert "X-TTS-Top-K-Applied" not in headers   # greedy: no cap applies
