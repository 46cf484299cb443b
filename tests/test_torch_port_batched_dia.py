"""PyTorch port: the continuous-batching Dia engine against the JAX
package's engine and the port's own single-stream runner, and the server
with Dia behind `--batch-slots`, on the CPU.

The tiny Dia GGUFs of tests/test_torch_port_dia.py, five prompts through two
slots (slots are reused while the other is mid-generation), on each route:
per matmul (F32) and K11's plain version (Q4_0 layers and heads). Greedy
codes equal, request by request, to the JAX engine's (the JAX side with
TTS_TPU_MEGAKERNEL=1 and bf16-scale heads through the kernel's plain
reference) and, on K11's route, to the port's `DiaRunner` (both take the
whole 64-row window as their bucket, so each pair's step is K10's). On the
per-matmul route the engine reads the bucketed bf16 cross K/V, as the JAX
engine does, and the runner the f32 window. Both sides decode from the JAX
encoder's cross K/V (test_torch_port_dia.jax_encoder says why). Then the
engine's behaviour and the server over real HTTP.
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_port_dia import (PROMPTS, ggufs, jax_encoder,  # noqa: F401
                                 quantized, write_tiny_dia)
from test_torch_port_parler import tpu_numerics  # noqa: F401  (fixture)
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.gguf import quants
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.runtime.batched_dia import BatchedDiaEngine as JEngine
from tts_tpu_torch.audio.wav import decode_wav
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.dia import model as pmodel
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.runtime import batched_dia
from tts_tpu_torch.runtime.batched_dia import BatchedDiaEngine


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run many tiny torch ops: one intra-op thread keeps
    the CPU to the other test workers and JAX's compiles, which share it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GREEDY = dict(sample=False, seed=0)


@pytest.mark.parametrize("name,route", [("f32", None), ("q4", "K11")])
def test_engine_greedy_matches_jax_engine_and_runner(ggufs, tpu_numerics,
                                                     monkeypatch, name, route):
    """Five prompts through two slots: every request's codes equal the JAX
    engine's and, on K11's route, the port runner's."""
    jr = jax_runner_from_file(ggufs[name])
    pr = runner_from_file(ggufs[name], device="cpu")
    for mod in (pmodel, batched_dia):
        monkeypatch.setattr(mod, "encode_request", jax_encoder(jr))
    eng = BatchedDiaEngine(pr.cfg, pr.weights, n_slots=2, chunk=7, device="cpu")
    assert (eng.mega is not None) == (route == "K11")
    assert eng.state.pos.shape == (2,) and eng.cross_bucket == 64
    assert eng.n_tail == 0
    rids = [eng.submit(t, GenerationConfig(**GREEDY)) for t in PROMPTS]
    eng.run_until_done()
    assert not eng.errors and all(r is None for r in eng.slot_req)
    jeng = JEngine(jr.cfg, jr.weights, n_slots=2, chunk=7)
    assert (jeng.mega is None) == (route is None)
    jids = [jeng.submit(t, JConfig(**GREEDY)) for t in PROMPTS]
    jeng.run_until_done()
    for text, rid, jid in zip(PROMPTS, rids, jids):
        assert np.array_equal(eng.results[rid], jeng.results[jid]), text
        if route == "K11":
            want = pr.generate_codes(text, GenerationConfig(**GREEDY))
            assert np.array_equal(eng.results[rid], want), text


def test_engine_mixed_sampling_and_validation(ggufs):
    """Per-slot sampling parameters in one batch (greedy, top-k, top-p,
    repetition penalty) on K11's route: every request finishes with codes in
    the audio vocab; the greedy one among sampled ones still gives the
    runner's codes; a prompt past the window is refused at submit."""
    pr = runner_from_file(ggufs["q4"], device="cpu")
    eng = BatchedDiaEngine(pr.cfg, pr.weights, n_slots=3, chunk=6, seed=1,
                           device="cpu")
    assert eng.device.type == "cpu"
    cfgs = [GenerationConfig(**GREEDY),
            GenerationConfig(temperature=1.5, top_k=4, seed=3),
            GenerationConfig(top_p=0.8, repetition_penalty=1.1, seed=4),
            GenerationConfig(temperature=0.7, top_k=0, seed=5)]
    rids = [eng.submit(PROMPTS[0], c) for c in cfgs]
    eng.run_until_done()
    for rid in rids:
        codes = eng.results[rid]
        assert codes.ndim == 2 and codes.shape[1] == 3
        assert ((codes >= 0) & (codes < 8)).all()
    want = pr.generate_codes(PROMPTS[0], cfgs[0])
    assert np.array_equal(eng.results[rids[0]], want)
    with pytest.raises(ValueError, match="at most 64"):
        eng.submit("x" * 80, GenerationConfig())
    assert not eng.pending and not eng.errors


def test_failing_encode_fails_only_itself(ggufs, monkeypatch):
    """A request whose encoder pass raises is recorded in engine.errors; the
    requests around it, through the one slot, complete; the state lies on
    the weights' device and an empty slot stays frozen."""
    pr = runner_from_file(ggufs["f32"], device="cpu")
    eng = BatchedDiaEngine(pr.cfg, pr.weights, n_slots=2, chunk=8, device="cpu")
    real = eng._encode

    def boom(text):
        if "bad" in text:
            raise ValueError("synthetic encode failure")
        return real(text)

    monkeypatch.setattr(eng, "_encode", boom)
    good1, bad = (eng.submit(t, GenerationConfig(**GREEDY)) for t in ("ab", "bad"))
    assert bad in eng.errors and "synthetic" in eng.errors[bad]
    assert int(eng.state.pos[1]) == 0 and not bool(eng.state.active[1])
    eng.step()
    assert all(t.device.type == "cpu" for t in eng.state[:11])
    assert 0 < int(eng.state.pos[0]) <= 8 and int(eng.state.pos[1]) == 0
    eng.run_until_done()
    assert good1 in eng.results and bad not in eng.results


def _post(base, payload, timeout=300):
    req = urllib.request.Request(base + "/v1/audio/speech",
                                 data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_batches_dia_and_routes_long_prompts_to_the_pool(tmp_path):
    """The port's server on a Q4_0 Dia GGUF with a 512-row encoder window
    (the engine's bucket 256, n_tail 256) on device="cpu", batch_slots 2:
    three concurrent requests through the batched worker and a 300-byte
    prompt, which the engine refuses, through the single-stream pool; every
    answer a 44.1 kHz WAV of whole 8-sample DAC frames."""
    from tts_tpu_torch.server.server import build_server, serve
    f32 = str(tmp_path / "dia512.gguf")
    write_tiny_dia(f32, np.random.default_rng(1), tc=512, max_gen=24)
    quantized(f32, str(tmp_path / "dia.gguf"), quants.GGML_TYPE_Q4_0, True)
    os.remove(f32)
    srv = build_server(str(tmp_path), config=GenerationConfig(top_k=4),
                       batch_slots=2, device="cpu")
    httpd = serve(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        t0 = time.time()
        while srv.state == "LOADING" and time.time() - t0 < 120:
            time.sleep(0.05)
        assert srv.state == "READY", srv.load_error
        worker = srv.batched_workers["dia"]
        assert worker.arch == "dia" and worker.engine.n_tail == 256
        assert worker.engine.mega is not None
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        long_prompt = "[S1] " + "la " * 100
        with pytest.raises(ValueError, match="cross bucket"):
            worker.engine.validate_prompt(long_prompt, GenerationConfig())
        results = {}

        def req(i, text):
            results[i] = _post(base, {"input": text, "seed": i})

        texts = PROMPTS[:3] + [long_prompt]
        threads = [threading.Thread(target=req, args=(i, t))
                   for i, t in enumerate(texts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(len(texts)):
            code, body = results[i]
            assert code == 200, body[:200]
            audio, rate = decode_wav(body)
            assert rate == 44100 and audio.size > 0 and audio.size % 8 == 0
        m = srv.metrics_json()
        assert m["requests_total"] == 4 and m["requests_failed"] == 0
    finally:
        httpd.shutdown()
