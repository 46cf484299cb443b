"""tts-server for the port — OpenAI-compatible HTTP TTS server on the card.

The port of the JAX package's `server/server.py` (parity: reference
examples/server/server.cpp): routes GET /, /health, /metrics, /v1/models,
/v1/audio/voices and POST /v1/audio/speech and /v1/audio/conditional-prompt;
multi-model directories with per-request `model` selection; per-request
sampling overrides; WAV/AIFF responses; chunked 16-bit PCM streaming
(`"stream": true`); OpenAI-style error JSON; LOADING-state 503; a worker
pool with a task queue.

Workers share one loaded model per model id, so N workers cost one copy of
the weights and the pool size sets request-level concurrency (their work
serializes on the card's stream). With `--batch-slots N` (N > 1), Parler,
Orpheus and Dia requests go to a continuous-batching engine instead
(runtime/batched_parler.py, runtime/batched_llama.py,
runtime/batched_dia.py): concurrent requests decode together, one read of
the weights serving every slot. A request the engine does not take (a
prompt longer than it takes: for Dia, more than 256 bytes) goes to the
worker pool. Kokoro has no decode loop to batch: its requests always go to
the worker pool.

Streams: a model with a batched worker streams through it (the request
holds a slot like any other; after each chunk the worker vocodes the
slot's new frames and queues the PCM); other models run the runner's
`generate_stream` on the HTTP thread, at most `--n-parallelism` streams at
once (503 beyond). A stream segment that fails ends that stream and counts
the request as failed (the JAX server marks it dead and still reports
success); a client too slow to drain its queue loses the rest of its
stream, as there.

Conditional prompts (`--text-encoder-path`, a T5 GGUF): POST
/v1/audio/conditional-prompt re-encodes a Parler model's voice prompt
(`ParlerRunner.update_conditional_prompt`); its batched worker re-preps its
engine between two chunks.

    python -m tts_tpu_torch.server.server -mp model.gguf --batch-slots 8
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import queue
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..audio.wav import encode_aiff, encode_wav
from ..common import (SAMPLE_RATE_DAC, SAMPLE_RATE_SNAC, GenerationConfig,
                      default_device)
from ..models.registry import runner_from_file
from ..ops import sampling

MIMETYPE_JSON = "application/json; charset=utf-8"
MIMETYPE_WAV = "audio/wav"
MIMETYPE_AIFF = "audio/aiff"
MIMETYPE_HTML = "text/html; charset=utf-8"

ERROR_TYPES = {
    400: "invalid_request_error",
    401: "authentication_error",
    403: "permission_error",
    404: "not_found_error",
    500: "server_error",
    501: "not_supported_error",
    503: "unavailable_error",
}

INDEX_HTML = """<!doctype html>
<html><head><title>tts_tpu_torch server</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:720px;margin:2rem auto;padding:0 1rem}
 textarea{width:100%;height:6rem} select,input,button{margin:.25rem 0;padding:.4rem}
</style></head>
<body>
<h1>tts_tpu_torch</h1>
<p>Text-to-speech on the GPU. POST <code>/v1/audio/speech</code> with
<code>{"input": "...", "model": "..."}</code>; GET <code>/v1/models</code>,
<code>/v1/audio/voices</code>, <code>/health</code>, <code>/metrics</code>.</p>
<textarea id="text">The quick brown fox jumps over the lazy dog.</textarea>
<div><select id="model"></select>
 <input id="temp" type="number" step="0.05" value="1.0">
 <input id="topk" type="number" value="50">
 <button id="go">Generate</button> <span id="status"></span></div>
<audio id="player" controls></audio>
<script>
async function boot(){
 const models=await (await fetch('/v1/models')).json();
 for(const m of models.data){model.add(new Option(m.id,m.id));}
}
go.onclick=async()=>{
 status.textContent='generating…';
 const body={input:text.value,temperature:parseFloat(temp.value),
             top_k:parseInt(topk.value),model:model.value};
 const r=await fetch('/v1/audio/speech',{method:'POST',body:JSON.stringify(body)});
 if(!r.ok){status.textContent='error: '+await r.text();return;}
 player.src=URL.createObjectURL(await r.blob());player.play();
 status.textContent='done';
};
boot();
</script></body></html>"""


def format_error(message: str, code: int) -> dict:
    return {"error": {"code": code, "message": message,
                      "type": ERROR_TYPES.get(code, "server_error")}}


class ServerTask:
    def __init__(self, prompt: str, config: GenerationConfig, model: str,
                 stream_q: "queue.Queue | None" = None):
        self.id = uuid.uuid4().hex
        self.prompt = prompt
        self.config = config
        self.model = model
        self.event = threading.Event()
        self.success = False
        self.message = ""
        self.audio: Optional[np.ndarray] = None
        self.sample_rate = 0
        # a streaming request's PCM chunks (None ends the stream); None for
        # a request answered whole
        self.stream_q = stream_q


class _Refresh:
    """A request to the batched worker's thread to take the runner's new
    weights between two chunks."""

    def __init__(self):
        self.event = threading.Event()
        self.error = ""


BATCHABLE_ARCHS = ("parler-tts", "orpheus", "dia")


class BatchedModelWorker:
    """Continuous-batching dispatcher for one Parler, Orpheus or Dia model.

    HTTP threads hand over ServerTasks through a queue; one worker thread
    owns the engine and its tensors, refills slots between chunks, vocodes
    finished requests and wakes their HTTP threads. For a streaming request
    it vocodes the slot's new frames after every chunk (margin-overlap
    segments, `STREAM_MARGIN` frames of context) into the task's queue.
    """

    STREAM_MARGIN = 16  # the vocoders' receptive-field context, in frames

    def __init__(self, runner, n_slots: int, chunk: int = 32):
        self.runner = runner
        self.arch = getattr(runner, "arch", "")
        if self.arch == "orpheus":
            from ..runtime.batched_llama import BatchedLlamaEngine as Engine
        elif self.arch == "dia":
            from ..runtime.batched_dia import BatchedDiaEngine
            Engine = functools.partial(BatchedDiaEngine, device=runner.device)
        else:
            from ..runtime.batched_parler import BatchedParlerEngine as Engine
        self.engine = Engine(runner.cfg, runner.weights, runner.tokenizer,
                             n_slots=n_slots, chunk=chunk)
        self.q: "queue.Queue" = queue.Queue()
        self.tasks: Dict[int, ServerTask] = {}
        # streaming requests' vocode state (worker thread only): rid ->
        # {"emitted": frames yielded, "noise": SNAC noise, "dead": the
        # client stopped draining}
        self.streams: Dict[int, dict] = {}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tts-batched-worker")
        self._thread.start()

    def submit(self, task: ServerTask) -> None:
        self.q.put(task)

    def refresh_weights(self, timeout: float = 600.0) -> None:
        """Take the runner's new weights (a conditional-prompt update): the
        worker thread re-preps the engine's step between two chunks (K5's
        weights and its attention scratch are sized by the cross K/V's
        rows), never in the middle of one. Returns once it has; raises if
        the re-prep failed."""
        req = _Refresh()
        self.q.put(req)
        if not req.event.wait(timeout):
            raise RuntimeError("the batched worker did not take the new "
                               "weights in time")
        if req.error:
            raise RuntimeError(req.error)

    def _busy(self) -> bool:
        return bool(self.engine.pending) or bool(self.engine.errors) or any(
            r is not None for r in self.engine.slot_req)

    def _finish(self, task: ServerTask, message: str = "") -> None:
        task.success = not message
        task.message = message
        if task.stream_q is not None:
            task.stream_q.put(None)
        task.event.set()

    def _take(self, task) -> None:
        """A task from the queue: a request into the engine, or a refresh."""
        if isinstance(task, _Refresh):
            try:
                self.engine.set_weights(self.runner.weights)
            except Exception as e:  # noqa: BLE001
                task.error = f"{type(e).__name__}: {e}"
            task.event.set()
            return
        try:
            rid = self.engine.submit(task.prompt, task.config)
        except Exception as e:  # noqa: BLE001
            self._finish(task, str(e))
            return
        self.tasks[rid] = task
        if task.stream_q is not None:
            self.streams[rid] = {"emitted": 0, "noise": None, "dead": False}

    def _loop(self) -> None:
        while True:
            # drain incoming requests; block only when fully idle
            try:
                task = self.q.get(block=not self._busy())
            except queue.Empty:
                task = None
            while task is not None:
                self._take(task)
                try:
                    task = self.q.get(block=False)
                except queue.Empty:
                    task = None
            # a request that failed in prefill fails alone
            for rid, msg in list(self.engine.errors.items()):
                del self.engine.errors[rid]
                self.streams.pop(rid, None)
                t = self.tasks.pop(rid, None)
                if t is not None:
                    self._finish(t, msg)
            if not self._busy():
                continue
            try:
                finished = self.engine.step()
            except Exception as e:  # noqa: BLE001
                for t in self.tasks.values():
                    self._finish(t, str(e))
                self.tasks.clear()
                self.streams.clear()
                continue
            # streams: vocode each live slot's new frames
            for rid, ss in list(self.streams.items()):
                t = self.tasks.get(rid)
                if rid in finished or ss["dead"] or t is None:
                    continue
                got = self.engine.peek(rid)
                if got is None:
                    continue
                try:
                    self._stream_segment(t, ss, got[0], got[1], done=False)
                except Exception as e:  # noqa: BLE001
                    # this stream ends, failed; its slot decodes on and its
                    # result is dropped, the other slots go on
                    del self.streams[rid], self.tasks[rid]
                    self._finish(t, f"stream segment failed: "
                                    f"{type(e).__name__}: {e}")
            for rid in finished:
                t = self.tasks.pop(rid, None)
                codes = self.engine.results.pop(rid, None)
                ss = self.streams.pop(rid, None)
                if t is None:
                    continue
                try:
                    if ss is not None:
                        self._stream_final(t, ss, codes)
                    else:
                        t.audio, t.sample_rate = self._vocode(t, codes)
                    self._finish(t)
                except Exception as e:  # noqa: BLE001
                    self._finish(t, str(e))

    def _seed(self, task: ServerTask) -> int:
        return task.config.seed if task.config.seed is not None else \
            np.random.randint(2 ** 31)

    def _stream_segment(self, task: ServerTask, ss: dict, n: int, out,
                        done: bool) -> None:
        """Vocode a streaming slot's newly decoded frames: `out` is its raw
        out_tokens row and n its progress (engine.peek), delay-undone here
        on the host."""
        if self.arch == "orpheus":
            from ..models.orpheus.model import prepare_output_tokens
            self._stream_push_snac(task, ss, prepare_output_tokens(out, n), done)
        else:
            if self.arch == "dia":
                from ..models.dia.model import adjust_output_tokens as adjust
            else:
                from ..models.parler.model import adjust_output_tokens as adjust
            self._stream_push_dac(task, ss, adjust(out, n, self.runner.cfg),
                                  done)

    def _stream_final(self, task: ServerTask, ss: dict, codes) -> None:
        """The rest of a finished streaming request, from its results."""
        if codes is None:
            return
        if self.arch == "orpheus":
            self._stream_push_snac(task, ss, codes, True)
        else:
            self._stream_push_dac(task, ss, codes, True)

    def _stream_push_dac(self, task: ServerTask, ss: dict, codes,
                         done: bool) -> None:
        from ..models.codec.dac import stream_segment
        task.sample_rate = SAMPLE_RATE_DAC
        dac = self.runner.dac
        if dac is None or codes is None or codes.shape[0] == 0:
            return
        seg, ss["emitted"] = stream_segment(dac, codes, ss["emitted"], done,
                                            self.STREAM_MARGIN)
        if seg is not None:
            self._stream_push(task, ss, seg)

    def _stream_push_snac(self, task: ServerTask, ss: dict, heads,
                          done: bool) -> None:
        from ..models.codec.snac import make_noise_layers, stream_segment
        task.sample_rate = SAMPLE_RATE_SNAC
        snac = self.runner.snac
        if snac is None or heads is None or not heads[2]:
            return
        if ss["noise"] is None:   # the runner's position-stable noise
            ss["noise"] = make_noise_layers(
                snac.cfg, self._seed(task),
                4 * (self.runner.cfg.max_generation_size // 7 + 1))
        seg, ss["emitted"] = stream_segment(snac, heads, ss["emitted"], done,
                                            self.STREAM_MARGIN, ss["noise"])
        if seg is not None:
            self._stream_push(task, ss, seg)

    def _stream_push(self, task: ServerTask, ss: dict, chunk) -> None:
        if chunk.size == 0 or ss["dead"]:
            return
        try:
            task.stream_q.put_nowait(chunk)
        except queue.Full:   # the client stopped draining: never block decode
            ss["dead"] = True

    def _vocode(self, task: ServerTask, codes):
        if self.arch == "orpheus":
            # the runner's SNAC path: codebook ids clipped, position-stable
            # noise keyed by the request's seed
            return (self.runner.vocode_heads(codes, self._seed(task)),
                    SAMPLE_RATE_SNAC)
        dac = self.runner.dac
        if dac is not None and codes is not None and codes.shape[0] > 0:
            return np.asarray(dac.decode(codes), np.float32), SAMPLE_RATE_DAC
        return np.zeros(0, np.float32), SAMPLE_RATE_DAC


class TTSServer:
    """The models, the worker pool and the batched workers behind the HTTP
    handler. Runs on `device` (default cuda; raises when there is no card
    and the caller did not pass device="cpu")."""

    def __init__(self, model_map: Dict[str, str], default_model: str,
                 default_config: GenerationConfig, n_parallel: int = 1,
                 text_encoder_path: str = "", timeout: float = 300.0,
                 batch_slots: int = 0, device=None):
        self.device = default_device(device)
        self.model_map = model_map
        self.default_model = default_model
        self.default_config = default_config
        self.n_parallel = max(1, n_parallel)
        self.batch_slots = batch_slots
        self.batched_workers: Dict[str, BatchedModelWorker] = {}
        self.text_encoder_path = text_encoder_path
        self.timeout = timeout
        self.state = "LOADING"
        self.load_error = ""
        self.runners: Dict[str, object] = {}
        self.queue: "queue.Queue[ServerTask]" = queue.Queue()
        self.workers = []
        self.created = int(time.time())
        self._lock = threading.Lock()
        # admission control for single-stream streams: they run on their
        # HTTP thread, at most n_parallel at once
        self.stream_slots = threading.Semaphore(self.n_parallel)
        self.metrics = {
            "requests_total": 0, "requests_failed": 0,
            "streams_total": 0, "streams_rejected": 0,
            "audio_seconds_total": 0.0, "wall_seconds_total": 0.0,
        }

    def record(self, task: ServerTask, wall_s: float) -> None:
        with self._lock:
            self.metrics["requests_total"] += 1
            if not task.success:
                self.metrics["requests_failed"] += 1
            elif task.audio is not None and task.sample_rate:
                self.metrics["audio_seconds_total"] += (
                    len(task.audio) / task.sample_rate)
            self.metrics["wall_seconds_total"] += wall_s

    def record_stream(self, ok: bool, samples: int, rate: int,
                      wall_s: float) -> None:
        with self._lock:
            m = self.metrics
            m["streams_total"] += 1
            m["requests_total"] += 1
            if not ok:
                m["requests_failed"] += 1
            m["audio_seconds_total"] += samples / rate
            m["wall_seconds_total"] += wall_s

    def metrics_json(self) -> dict:
        with self._lock:
            m = dict(self.metrics)
        w = m["wall_seconds_total"]
        m["realtime_factor"] = round(m["audio_seconds_total"] / w, 4) if w else 0.0
        m["uptime_seconds"] = int(time.time()) - self.created
        m["state"] = self.state
        return m

    # -- lifecycle -----------------------------------------------------------
    def load(self) -> None:
        """Build the kernels (on the card, so that a failed build shows here
        and not on the first request), load every model, start the workers,
        then report READY. A failure leaves the state FAILED, with the error
        in `load_error`."""
        try:
            if self.device.type == "cuda":
                from ..ops import _build
                _build.build()
            for model_id, path in self.model_map.items():
                runner = runner_from_file(path, self.default_config,
                                          device=self.device)
                self.runners[model_id] = runner
                arch = getattr(runner, "arch", "")
                if self.batch_slots > 1 and arch in BATCHABLE_ARCHS:
                    self.batched_workers[model_id] = BatchedModelWorker(
                        runner, n_slots=self.batch_slots)
        except Exception as e:  # noqa: BLE001
            self.load_error = f"{type(e).__name__}: {e}"
            self.state = "FAILED"
            raise
        for i in range(self.n_parallel):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"tts-worker-{i}")
            t.start()
            self.workers.append(t)
        self.state = "READY"

    def _worker_loop(self) -> None:
        while True:
            task = self.queue.get()
            if task is None:
                return
            try:
                resp = self.runners[task.model].generate(task.prompt, task.config)
                task.audio = resp.audio
                task.sample_rate = resp.sample_rate
                task.success = True
            except Exception as e:  # noqa: BLE001
                task.message = str(e)
                task.success = False
            task.event.set()

    def submit(self, task: ServerTask) -> ServerTask:
        t0 = time.perf_counter()
        bw = self.batched_workers.get(task.model)
        if bw is not None:
            try:
                bw.engine.validate_prompt(task.prompt, task.config)
            except ValueError:
                # not a request the batched engine takes (e.g. longer than
                # its window): the worker pool accepts it or raises its own
                # per-request error
                bw = None
        if bw is not None:
            bw.submit(task)
        else:
            self.queue.put(task)
        if not task.event.wait(self.timeout):
            task.success = False
            task.message = "request timed out"
        self.record(task, time.perf_counter() - t0)
        return task

    # -- model metadata ------------------------------------------------------
    def models_json(self) -> dict:
        return {"object": "list", "data": [
            {"id": mid, "object": "model", "created": self.created,
             "owned_by": "tts_tpu_torch"} for mid in sorted(self.model_map)]}

    def voices_json(self) -> dict:
        voices = {}
        for mid, runner in self.runners.items():
            try:
                voices[mid] = [str(v) for v in runner.list_voices()]
            except Exception:  # noqa: BLE001
                voices[mid] = []
        return {"voices": voices}


class _Handler(BaseHTTPRequestHandler):
    server_obj: TTSServer = None  # injected

    def _send(self, code: int, body: bytes, mime: str,
              extra_headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", mime)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin",
                         self.headers.get("Origin", "*"))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, data: dict) -> None:
        self._send(code, json.dumps(data).encode(), MIMETYPE_JSON)

    def _error(self, message: str, code: int) -> None:
        self._send_json(code, format_error(message, code))

    def log_message(self, fmt, *args):
        sys.stderr.write("request: %s\n" % (fmt % args))

    def _check_ready(self) -> bool:
        srv = self.server_obj
        if srv.state == "LOADING":
            self._error("Loading model", 503)
            return False
        if srv.state == "FAILED":
            self._error(f"model failed to load: {srv.load_error}", 503)
            return False
        return True

    def do_OPTIONS(self):
        self.send_response(200)
        self.send_header("Access-Control-Allow-Credentials", "true")
        self.send_header("Access-Control-Allow-Methods", "GET, POST")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.end_headers()

    def do_GET(self):
        if self.path == "/":
            self._send(200, INDEX_HTML.encode(), MIMETYPE_HTML)
            return
        if self.path == "/health":
            self._send_json(200, {"status": "ok"})
            return
        if self.path == "/metrics":
            self._send_json(200, self.server_obj.metrics_json())
            return
        if not self._check_ready():
            return
        if self.path == "/v1/models":
            self._send_json(200, self.server_obj.models_json())
            return
        if self.path == "/v1/audio/voices":
            self._send_json(200, self.server_obj.voices_json())
            return
        self._error("File Not Found", 404)

    def do_POST(self):
        if not self._check_ready():
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            data = json.loads(self.rfile.read(length) or b"{}")
        except Exception:  # noqa: BLE001
            self._error("invalid JSON body", 400)
            return
        if self.path == "/v1/audio/speech":
            self._handle_tts(data)
        elif self.path == "/v1/audio/conditional-prompt":
            self._handle_conditional(data)
        else:
            self._error("File Not Found", 404)

    def _handle_tts(self, data: dict) -> None:
        srv = self.server_obj
        if not isinstance(data.get("input"), str):
            self._error("the 'input' field is required for tts generation "
                        "and must be passed as a string.", 400)
            return
        prompt = data["input"]
        if not prompt:
            self._error("the 'input' field must be a non empty string", 400)
            return
        fmt = data.get("response_format", "wav")
        if fmt not in ("wav", "wave", "aiff"):
            self._error("Currently 'wav' and 'aiff' are the only supported "
                        "formats for the 'response_format' field.", 501)
            return
        conf = dataclasses.replace(srv.default_config)
        if isinstance(data.get("temperature"), (int, float)):
            conf.temperature = float(data["temperature"])
        if isinstance(data.get("top_k"), (int, float)):
            conf.top_k = int(data["top_k"])
        if isinstance(data.get("top_p"), (int, float)):
            conf.top_p = float(data["top_p"])
        if isinstance(data.get("repetition_penalty"), (int, float)):
            conf.repetition_penalty = float(data["repetition_penalty"])
        if isinstance(data.get("voice"), str):
            conf.voice = data["voice"]
        if isinstance(data.get("seed"), int):
            conf.seed = data["seed"]
        model = data.get("model", srv.default_model)
        if model not in srv.model_map:
            self._error(f"Invalid Model: {model}", 400)
            return
        if data.get("stream") is True:
            self._handle_tts_stream(prompt, conf, model)
            return
        task = srv.submit(ServerTask(prompt, conf, model))
        if not task.success:
            self._error(task.message or "generation failed", 500)
            return
        if task.audio is None or len(task.audio) == 0:
            self._error("Model returned an empty response.", 500)
            return
        # Requests that the batched engine serves are truncated to its top
        # BATCHED_TOP_K_CAP tokens (ops/sampling.py): tell the client.
        extra = None
        if (srv.batched_workers.get(model) is not None and conf.sample
                and (conf.top_k == 0 or conf.top_k > sampling.BATCHED_TOP_K_CAP)):
            extra = {"X-TTS-Top-K-Applied": str(sampling.BATCHED_TOP_K_CAP)}
        if fmt == "aiff":
            self._send(200, encode_aiff(task.audio, task.sample_rate),
                       MIMETYPE_AIFF, extra)
        else:
            self._send(200, encode_wav(task.audio, task.sample_rate),
                       MIMETYPE_WAV, extra)


    def _start_pcm(self, rate: int) -> None:
        self.send_response(200)
        self.send_header("Content-Type",
                         f"audio/pcm;rate={rate};encoding=signed-integer;bits=16")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _send_pcm(self, chunk) -> int:
        """One chunk of the chunked body: the waveform as 16-bit PCM.
        Returns the samples written."""
        pcm = (np.clip(chunk, -1, 1) * 32767).astype("<i2").tobytes()
        if pcm:
            self.wfile.write(f"{len(pcm):X}\r\n".encode() + pcm + b"\r\n")
        return len(pcm) // 2

    def _handle_tts_stream(self, prompt: str, conf, model: str) -> None:
        """Chunked 16-bit PCM (the time-to-first-audio path). A model with
        a batched worker streams through its engine; otherwise the runner's
        `generate_stream` runs on this thread under admission control (at
        most n_parallel streams, 503 beyond). The generator is suspended
        while each chunk is written, so a slow client holds no work on the
        card. Both paths count in /metrics."""
        srv = self.server_obj
        bw = srv.batched_workers.get(model)
        if bw is not None:
            try:
                bw.engine.validate_prompt(prompt, conf)
            except ValueError:
                bw = None   # too large for the engine: the single-stream path
        if bw is not None:
            self._handle_tts_stream_batched(bw, prompt, conf, model)
            return
        runner = srv.runners[model]
        if not srv.stream_slots.acquire(timeout=min(srv.timeout, 30.0)):
            with srv._lock:
                srv.metrics["streams_rejected"] += 1
            self._error("too many concurrent streams", 503)
            return
        t0 = time.perf_counter()
        samples, ok, started = 0, False, False
        rate = int(getattr(runner, "sample_rate", SAMPLE_RATE_DAC))
        try:
            gen = runner.generate_stream(prompt, conf)
            for chunk in gen:
                if not started:
                    self._start_pcm(rate)
                    started = True
                samples += self._send_pcm(chunk)
            if not started:
                self._start_pcm(rate)
            self.wfile.write(b"0\r\n\r\n")
            ok = True
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001
            if not started:
                self._error(str(e), 500)
        finally:
            srv.stream_slots.release()
            srv.record_stream(ok, samples, rate, time.perf_counter() - t0)

    def _handle_tts_stream_batched(self, bw, prompt: str, conf,
                                   model: str) -> None:
        """Stream PCM out of the continuous-batching engine: the request
        holds a batch slot like any other, and the worker thread pushes
        the vocoded segments of its slot into the task's queue after each
        chunk. A failed segment ends the stream and the request counts as
        failed."""
        srv = self.server_obj
        t0 = time.perf_counter()
        samples, ok = 0, False
        task = ServerTask(prompt, conf, model, stream_q=queue.Queue(maxsize=256))
        rate = int(getattr(srv.runners[model], "sample_rate", SAMPLE_RATE_DAC))
        try:
            bw.submit(task)
            self._start_pcm(rate)
            while True:
                chunk = task.stream_q.get(timeout=srv.timeout)
                if chunk is None:
                    break
                samples += self._send_pcm(chunk)
            self.wfile.write(b"0\r\n\r\n")
            task.event.wait(srv.timeout)
            ok = task.success
        except (BrokenPipeError, queue.Empty):
            pass
        finally:
            srv.record_stream(ok, samples, rate, time.perf_counter() - t0)

    def _handle_conditional(self, data: dict) -> None:
        """Re-encode a model's voice prompt through the T5 encoder at
        --text-encoder-path and rebuild its cross K/V (Parler)."""
        srv = self.server_obj
        if srv.n_parallel > 1:
            self._error("conditional prompts cannot be updated with "
                        "parallelism greater than 1", 400)
            return
        if not srv.text_encoder_path:
            self._error("the server was started without a text encoder "
                        "path; conditional prompts are unsupported", 501)
            return
        prompt = data.get("conditional_prompt")
        if not isinstance(prompt, str) or not prompt:
            self._error("the 'conditional_prompt' field is required and must "
                        "be a non empty string", 400)
            return
        model = data.get("model", srv.default_model)
        if model not in srv.model_map:
            self._error(f"Invalid Model: {model}", 400)
            return
        try:
            srv.runners[model].update_conditional_prompt(
                srv.text_encoder_path, prompt)
            bw = srv.batched_workers.get(model)
            if bw is not None:
                bw.refresh_weights()
        except Exception as e:  # noqa: BLE001
            self._error(str(e), 500)
            return
        self._send_json(200, {"success": True})


def build_server(model_path: str, default_model: str = "",
                 config: Optional[GenerationConfig] = None,
                 n_parallel: int = 1, text_encoder_path: str = "",
                 timeout: float = 300.0, batch_slots: int = 0,
                 device=None) -> TTSServer:
    """A TTSServer over one GGUF file or every .gguf in a directory (or a
    `test:` model)."""
    model_map: Dict[str, str] = {}
    if os.path.isdir(model_path):
        for entry in sorted(os.listdir(model_path)):
            if entry.endswith(".gguf"):
                model_map[os.path.splitext(entry)[0]] = os.path.join(model_path, entry)
        if not model_map:
            raise ValueError(f"No model found in directory {model_path}")
    else:
        stem = os.path.splitext(os.path.basename(model_path))[0]
        model_map[stem] = model_path
    if default_model:
        stem = os.path.splitext(os.path.basename(default_model))[0]
        if stem not in model_map:
            raise ValueError(f"Invalid Default Model Provided: {stem}")
        default = stem
    else:
        default = sorted(model_map)[0]
    return TTSServer(model_map, default, config or GenerationConfig(),
                     n_parallel=n_parallel, text_encoder_path=text_encoder_path,
                     timeout=timeout, batch_slots=batch_slots, device=device)


def serve(server: TTSServer, host: str = "127.0.0.1", port: int = 8080):
    """Bind the HTTP server and start loading the models in the background;
    the caller runs `serve_forever`."""
    handler = type("BoundHandler", (_Handler,), {"server_obj": server})
    httpd = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=server.load, daemon=True).start()
    return httpd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tts-server",
                                description="TTS server (PyTorch/CUDA port)")
    p.add_argument("--model-path", "-mp", required=True)
    p.add_argument("--default-model", "-dm", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", "-p", type=int, default=8080)
    p.add_argument("--temperature", "-t", type=float, default=1.0)
    p.add_argument("--topk", "-tk", type=int, default=50)
    p.add_argument("--top-p", "-tp", type=float, default=1.0)
    p.add_argument("--repetition-penalty", "-r", type=float, default=1.0)
    p.add_argument("--voice", "-v", default="")
    p.add_argument("--espeak-voice-id", "-eid", default="")
    p.add_argument("--no-cross-attn", "-ca", action="store_true")
    p.add_argument("--text-encoder-path", "-tep", default="")
    p.add_argument("--n-parallelism", "-np", type=int, default=1)
    p.add_argument("--batch-slots", "-bs", type=int, default=0,
                   help="continuous-batching slots for Parler, Orpheus "
                        "and Dia models (0 = off); requests decode together "
                        "on the card. Kokoro is feed-forward and is served "
                        "by the worker pool")
    p.add_argument("--timeout", type=int, default=300)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    # accepted for reference compatibility; no-ops here
    p.add_argument("--n-threads", "-nt", type=int, default=0)
    p.add_argument("--n-http-threads", "-ht", type=int, default=0)
    p.add_argument("--use-metal", "-m", action="store_true")
    p.add_argument("--ssl-file-cert", "-sfc", default="")
    p.add_argument("--ssl-file-key", "-sfk", default="")
    args = p.parse_args(argv)
    if not (0.0 < args.top_p <= 1.0):
        print("The '--top-p' value must be between 0.0 and 1.0.", file=sys.stderr)
        return 1
    config = GenerationConfig(
        voice=args.voice, top_k=args.topk, temperature=args.temperature,
        repetition_penalty=args.repetition_penalty,
        use_cross_attn=not args.no_cross_attn,
        espeak_voice_id=args.espeak_voice_id, top_p=args.top_p)
    server = build_server(args.model_path, args.default_model, config,
                          n_parallel=args.n_parallelism,
                          text_encoder_path=args.text_encoder_path,
                          timeout=args.timeout, batch_slots=args.batch_slots,
                          device=args.device)
    httpd = serve(server, args.host, args.port)
    if args.ssl_file_cert and args.ssl_file_key:
        import ssl
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(args.ssl_file_cert, args.ssl_file_key)
        httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
        print(f"Running with SSL: key = {args.ssl_file_key}, "
              f"cert = {args.ssl_file_cert}")
    print(f"tts-server listening on {args.host}:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
