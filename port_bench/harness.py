"""One run of one cell: set-up, the measured window, the correctness check
against the plain reference, and the contract's last line.

Set-up builds the cell's CUDA sources (the port's fixed build directory
inside the checkout), makes the weights on the card from the seed, builds
the program's runner with its constructor and, for a served cell, the
port's TTSServer with a BatchedModelWorker, served by the port's own
`serve` on 127.0.0.1 at an ephemeral port. The load generator then runs
for the traffic's ramp and the window. Spans and counts are recorded from
this file's wrappers around the calls into each layer (no program file
changes); the traced run adds torch.profiler's device activity.

`run` takes the device as an argument so that the harness's own tests can
drive a whole run on the CPU at a tiny size; `run.py` refuses to run
without a card.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import random
import sys
import threading
import time

import numpy as np
import torch

from port_bench import common, loadgen
from port_bench.reference import dac as ref_dac
from port_bench.reference.q4 import strict_fp32

N_SPECS = 5000          # requests drawn from the seed, more than a run sends
READINGS = ("logit_gap", "logit_err", "audio_err")  # set from readings
LOGIT_READINGS = ("logit_gap", "logit_err")          # the decoder's
TRACE_ATTEMPTS = 3      # traced sessions a run tries until one records
                        # (nearly) every counted launch
TRACE_LEAD_S = 2.0      # a served run's first session starts this far
                        # into the window
DRAIN_S = 60.0          # how long the requests in flight at the close may take


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Run:
    """Everything one run measured: what the metric readers read."""

    def __init__(self, cell, seed, seconds, trace, device):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace_on, self.device = bool(trace), torch.device(device)
        self.cfg, self.traffic = cell.config, cell.traffic
        self.fam = common.family(self.cfg["family"], cell.bench_dir)
        self.spans = common.Spans()
        self.trace = None            # trace.DeviceTrace of a --trace 1 run
        self.records: list = []      # one dict a request sent
        self.outputs: dict = {}      # request key -> (raw tokens, n steps)
        self.logits: dict = {}       # request key -> the program's logits,
                                     # one tensor a step (greedy requests)
        self.logit_steps = None      # the list the current request fills
        self.trace_ok = False        # a traced session held every launch
        self.window = (0.0, 0.0)
        self.setup_s = 0.0
        self.launches: dict = {}     # kernel counter -> launches in the trace
        self.k1_shapes: dict = {}    # K1's launches in the trace by shape
        self.prompt_bytes = 0        # the single stream's current prompt

        self.drain_s = DRAIN_S
        self._patched: list = []     # (module, name, original)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def patch(self, obj, name: str, value) -> None:
        """Set obj.name for this run (a wrapper around a call into the
        program); `unpatch` puts every original back."""
        self._patched.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def unpatch(self) -> None:
        while self._patched:
            obj, name, value = self._patched.pop()
            setattr(obj, name, value)


# ---------------------------------------------------------------------------
# wrappers around the calls into the program's layers
# ---------------------------------------------------------------------------

def _capture_outputs(run: Run, module, captured: list) -> None:
    """Each finished request's raw tokens, where the program delay-undoes
    them (`adjust_output_tokens`, called by name in `module`)."""
    plain = module.adjust_output_tokens

    def adjust(out, n_steps, cfg):
        captured.append((np.array(out, copy=True), int(n_steps)))
        return plain(out, n_steps, cfg)

    run.patch(module, "adjust_output_tokens", adjust)


def _warm_vocoder(run: Run, dac) -> None:
    """Decode once at every frame count the cell will hand the DAC: the
    convolutions' first call at a new length picks and builds its cuDNN
    plans, which must not fall in the window."""
    t0 = time.perf_counter()
    frames = sorted(set(run.fam.vocode_frames(run.cfg, run.traffic)))
    n_cb = run.cfg["dac"]["n_codebooks"]
    for n in frames:
        dac.decode(np.zeros((n, n_cb), np.int64))
    log(f"vocoder warm-up: {len(frames)} lengths ({frames[0]}-{frames[-1]} "
        f"frames) in {time.perf_counter() - t0:.3f} s")


def _wrap_vocoder(run: Run, dac) -> None:
    plain = dac.decode

    def decode(codes):
        if run.trace_on:
            run.sync()
        t0 = time.perf_counter()
        out = plain(codes)               # returns on the host: synchronized
        run.spans.add("vocoder.decode", t0, time.perf_counter(),
                      frames=int(np.asarray(codes).shape[0]))
        return out

    dac.decode = decode


def _wrap_engine(run: Run, worker) -> None:
    """engine.step (one chunk and its sync): a span with the slots live at
    its start and, traced, their positions; the finished requests' raw
    tokens under their keys."""
    import importlib
    engine = worker.engine
    module = importlib.import_module(run.fam.ENGINE_MODULE)
    captured: list = []
    _capture_outputs(run, module, captured)
    plain = engine.step

    def step():
        live = [s for s, r in enumerate(engine.slot_req) if r is not None]
        pos = engine.state.pos.cpu().tolist() if run.trace_on else None
        n0 = len(captured)
        t0 = time.perf_counter()
        finished = plain()
        t1 = time.perf_counter()
        run.spans.add("engine.step", t0, t1, live=live, pos=pos,
                      chunk=engine.chunk)
        for rid, out in zip(finished, captured[n0:]):
            task = worker.tasks.get(rid)
            if task is not None:
                run.outputs[task.config.seed] = out
        return finished

    engine.step = step


def _k1_shapes() -> dict:
    from tts_tpu_torch.ops import quant_matmul as qm
    with qm._SHAPES_LOCK:
        return dict(qm.SHAPES)


def _kernel_counters() -> dict:
    """The program's launch counters (`_build.Kernel.launches`) by name."""
    from tts_tpu_torch.ops import decode_attention as da
    from tts_tpu_torch.ops import dia_megastep as dm
    from tts_tpu_torch.ops import parler_megastep as pm
    from tts_tpu_torch.ops import quant_matmul as qm
    return {"k1": qm.KERNEL.launches, "k4": da.KERNEL_BATCHED.launches,
            "k5": pm.KERNEL_BATCHED.launches, "k10": dm.KERNEL.launches,
            "k11": dm.KERNEL_BATCHED.launches,
            "cross": dm.CROSS_BATCHED.launches + dm.CROSS.launches}


# ---------------------------------------------------------------------------
# the served cells
# ---------------------------------------------------------------------------

def _serve(run: Run, runner):
    """The port's server over the built runner: a TTSServer whose `load`
    registers the runner and a BatchedModelWorker as TTSServer.load does
    (the server takes only model files; no program file changes), served by
    the port's `serve`."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.server import server as srv
    slots = int(run.traffic["batch_slots"])
    mid = run.cell.config_entry["name"]
    server = srv.TTSServer({mid: "(built in process)"}, mid,
                           GenerationConfig(), n_parallel=1, timeout=600.0,
                           batch_slots=slots, device=run.device)
    def load():
        try:
            server.runners[mid] = runner
            worker = srv.BatchedModelWorker(runner, n_slots=slots)
            _wrap_engine(run, worker)
            server.batched_workers[mid] = worker
            for i in range(server.n_parallel):
                threading.Thread(target=server._worker_loop, daemon=True,
                                 name=f"tts-worker-{i}").start()
            server.state = "READY"
        except Exception as e:  # noqa: BLE001 — reported by the wait below
            server.load_error = f"{type(e).__name__}: {e}"
            server.state = "FAILED"

    server.load = load
    httpd = srv.serve(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="http").start()
    while server.state == "LOADING":
        time.sleep(0.01)
    if server.state != "READY":
        raise RuntimeError(f"the server failed to load: {server.load_error}")
    return httpd


def _served_window(run: Run, runner) -> None:
    httpd = _serve(run, runner)
    host, port = httpd.server_address[:2]
    specs = loadgen.request_specs(run.traffic, run.seed, run.fam.prompt,
                                  N_SPECS)
    run.specs = {s["key"]: s for s in specs}
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    server_cores, client_cores = _split_cores()
    all_cores = os.sched_getaffinity(0)
    proc = ctx.Process(target=loadgen.clients_main,
                       args=(child, host, port, specs, run.traffic,
                             run.seconds, run.drain_s, client_cores),
                       daemon=True)
    proc.start()
    child.close()
    _pin_process(server_cores)
    try:
        ramp = float(run.traffic["ramp_s"])
        if not parent.poll(120) or parent.recv() != "ready":
            raise RuntimeError("the load generator did not start")
        t_start = time.perf_counter()
        parent.send("go")
        w0 = t_start + ramp
        w1 = w0 + run.seconds
        run.window = (w0, w1)
        if run.trace_on:
            # sessions of trace_s seconds one after another, from early in
            # the window, until one holds every counted launch
            ts = float(run.traffic["trace_s"])
            _sleep_until(w0 + TRACE_LEAD_S)
            for _ in range(TRACE_ATTEMPTS):
                _trace_start(run)
                time.sleep(ts)
                _trace_stop(run)
                run.trace_ok = _trace_complete(run)
                if run.trace_ok:
                    break
        deadline = w1 + run.drain_s + 120
        while not parent.poll(1.0):
            if not proc.is_alive() or time.perf_counter() > deadline:
                raise RuntimeError("the load generator ended without a report")
        got = parent.recv()
        proc.join(30)
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
        parent.close()
        _pin_process(all_cores)
    run.stuck = got["stuck"]
    for rec in got["records"]:
        for k in ("t_send", "t_first", "t_done"):
            if rec.get(k) is not None:
                rec[k] += t_start
        for c in rec.get("chunks", ()):
            c[0] += t_start
        rec["audio"] = _pcm(rec, bool(run.traffic["stream"]))
        run.records.append(rec)
    log("requests (client, key, ok, sent, first audio, done; s from the "
        "window's start): " + " ".join(
            f"{r['client']}/{r['key']}/{int(r['ok'])}/{r['t_send'] - w0:.2f}/"
            f"{(r['t_first'] or w0) - w0:.2f}/{r.get('t_done', w0) - w0:.2f}"
            for r in sorted(run.records, key=lambda r: r["t_send"])))
    run.memory_peak = _memory_peak(run)
    httpd.shutdown()
    httpd.server_close()


def _split_cores() -> tuple:
    """(the server's cores, the load generator's): the last core this
    process may run on goes to the load generator's child, so that its
    reading of the streams takes no time from the server's threads."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        return None, None
    return set(cores[:-1]), {cores[-1]}


def _pin_process(cores) -> None:
    """Every thread of this process on `cores` (threads started later
    inherit it from the thread that starts them)."""
    if not cores:
        return
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except OSError:     # a thread that ended meanwhile
            pass


def _pcm(rec: dict, stream: bool):
    """A response's samples as float32 in [-1, 1) (None unless it is
    audio): streams are raw 16-bit PCM, whole requests WAV files."""
    body = rec.pop("body", b"")
    if not rec["ok"]:
        return None
    if not stream:
        from tts_tpu_torch.audio.wav import decode_wav
        audio, _ = decode_wav(body)
        return np.asarray(audio, np.float32)
    return np.frombuffer(body, "<i2").astype(np.float32) / 32767.0


# ---------------------------------------------------------------------------
# the single-stream cells
# ---------------------------------------------------------------------------

def _runner_window(run: Run, runner) -> None:
    """One client calling the runner's `generate` back to back in this
    process, as apps/cli.py does. The window opens after one warm-up
    request and closes at the end of the first request that ends
    `seconds` or more after it opened, so that it holds whole requests."""
    import importlib

    from tts_tpu_torch.common import GenerationConfig
    module = importlib.import_module(run.fam.RUNNER_MODULE)
    captured: list = []
    _capture_outputs(run, module, captured)
    loop = getattr(module, run.fam.RUNNER_LOOP)

    def decode_loop(*a, **k):
        if run.trace_on:
            run.sync()
        t0 = time.perf_counter()
        out, n = loop(*a, **k)
        run.spans.add("runner.decode", t0, time.perf_counter(), steps=int(n),
                      prompt_bytes=run.prompt_bytes)
        return out, n

    run.patch(module, run.fam.RUNNER_LOOP, decode_loop)
    _capture_logits(run, module)
    encode = getattr(runner, "encode", None)
    if encode is not None:
        def timed_encode(ids):
            if run.trace_on:
                run.sync()
            t0 = time.perf_counter()
            run.prompt_bytes = len(ids)
            out = encode(ids)
            if run.trace_on:
                run.sync()
            run.spans.add("runner.encode", t0, time.perf_counter(),
                          prompt_bytes=len(ids))
            return out
        runner.encode = timed_encode

    specs = loadgen.request_specs(run.traffic, run.seed, run.fam.prompt,
                                  N_SPECS)
    run.specs = {s["key"]: s for s in specs}

    def one(spec) -> dict:
        p = spec["params"]
        conf = GenerationConfig(temperature=p["temperature"], top_k=p["top_k"],
                                top_p=p["top_p"],
                                repetition_penalty=p["repetition_penalty"],
                                sample=not spec["greedy"], seed=spec["key"])
        rec = {"key": spec["key"], "ok": False, "error": "",
               "t_send": time.perf_counter()}
        run.logit_steps = [] if spec["greedy"] else None
        try:
            n0 = len(captured)
            resp = runner.generate(spec["text"], conf)
            rec["audio"] = np.asarray(resp.audio, np.float32)
            rec["ok"] = resp.audio.size > 0
            if len(captured) > n0:
                run.outputs[spec["key"]] = captured[-1]
        except Exception as e:  # noqa: BLE001 — a failed request counts
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["audio"] = None
        rec["t_done"] = rec["t_first"] = time.perf_counter()
        if run.logit_steps:
            run.logits[spec["key"]] = run.logit_steps
        run.logit_steps = None
        run.spans.add("runner.generate", rec["t_send"], rec["t_done"])
        return rec

    one(specs[0])                                     # warm-up
    run.logits.clear()
    run.sync()
    w0 = time.perf_counter()
    ts = float(run.traffic["trace_s"])
    attempts, tracing, w1 = 0, False, None
    i = 1
    # traced sessions from the window's start, each over whole requests and
    # at least trace_s long, until one holds every counted launch
    while w1 is None or tracing:
        if run.trace_on and not run.trace_ok and not tracing and \
                attempts < TRACE_ATTEMPTS:
            _trace_start(run)
            tracing, t_tr = True, time.perf_counter()
            attempts += 1
        rec = one(specs[i])
        i += 1
        run.records.append(rec)
        if w1 is None and rec["t_done"] - w0 >= run.seconds:
            w1 = rec["t_done"]
        if tracing and rec["t_done"] - t_tr >= ts:
            _trace_stop(run)
            tracing, run.trace_ok = False, _trace_complete(run)
    run.window = (w0, w1)
    run.stuck = 0
    run.memory_peak = _memory_peak(run)


def _capture_logits(run: Run, module) -> None:
    """The merged logits of every decode step of a greedy request, as the
    program hands them to its sampler (the family's LOGITS_FN, called by
    name in `module`): kept as they are, no copy and no sync."""
    name = getattr(run.fam, "LOGITS_FN", None)
    if name is None:
        return
    plain = getattr(module, name)

    def logits(*a, **k):
        out = plain(*a, **k)
        if run.logit_steps is not None:
            run.logit_steps.append(out)
        return out

    run.patch(module, name, logits)


def _warm_profiler(run: Run) -> None:
    """Start and stop the profiler once in set-up: its first start (CUPTI's
    initialization) takes seconds, which must not fall in the window."""
    from port_bench.trace import DeviceTrace
    t = DeviceTrace(run.spans, run.device.type)
    t.start()
    if run.device.type == "cuda":
        torch.zeros(1, device=run.device).add_(1)
    run.sync()
    t.stop()


def _sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.perf_counter()))


def _trace_start(run: Run) -> None:
    from port_bench.trace import DeviceTrace
    run.trace = DeviceTrace(run.spans, run.device.type)
    run.counters0 = _kernel_counters()
    run.k1_shapes0 = _k1_shapes()
    run.trace.start()


def _trace_stop(run: Run) -> None:
    """Stop the session. The counters are read after the sync and before
    the profiler's stop (seconds, during which the server's threads launch
    on): a launch they count is in the session."""
    run.sync()
    c1, k1 = _kernel_counters(), _k1_shapes()
    run.trace.stop()
    run.launches = {k: c1[k] - run.counters0[k] for k in c1}
    run.k1_shapes = {s: n - run.k1_shapes0.get(s, 0) for s, n in k1.items()
                     if n > run.k1_shapes0.get(s, 0)}
    top = sorted(run.trace.by_kernel().items(), key=lambda kv: -kv[1][0])
    log(f"traced {run.trace.window_s:.3f} s, busy {run.trace.busy_s():.4f} s; "
        f"launch counters {run.launches}; by kernel (s, events): "
        + ", ".join(f"{k} {v[0]:.4f} {v[1]}" for k, v in top[:16]))


def _trace_complete(run: Run) -> bool:
    """The traced session holds (nearly) every launch of the port's
    kernels that their counters counted over it."""
    from port_bench.roofline import KERNELS
    names = {n for part in ("k1", "k4", "k5", "k10", "k11")
             for n in KERNELS[part] if n != "stage_x_kernel"}
    launched = sum(v for k, v in run.launches.items())
    return run.device.type != "cuda" or run.trace.complete(launched, names)


def _memory_peak(run: Run) -> int:
    if run.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(run.device))


# ---------------------------------------------------------------------------
# the end-to-end metrics
# ---------------------------------------------------------------------------

def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between closest
    ranks; an infinite value (a request that failed) sorts last."""
    v = sorted(values)
    if not v:
        return math.inf
    x = (len(v) - 1) * q / 100.0
    lo, hi = int(math.floor(x)), int(math.ceil(x))
    if math.isinf(v[hi]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def window_requests(run: Run) -> tuple[list, list]:
    """(requests sent in the window, requests that completed in it)."""
    w0, w1 = run.window
    sent = [r for r in run.records if w0 <= r["t_send"] < w1]
    done = [r for r in run.records if r["ok"] and w0 <= r["t_done"] <= w1]
    return sent, done


def window_audio_s(run: Run) -> float:
    """Seconds of audio delivered inside the window by requests that
    completed: a stream's chunks as they arrived in it (16-bit samples), a
    whole response's audio where it completed in it. A failed request
    delivers none."""
    w0, w1 = run.window
    rate = run.fam.SAMPLE_RATE
    if run.traffic.get("stream"):
        n = sum(size for r in run.records if r["ok"]
                for t, size in r["chunks"] if w0 <= t <= w1)
        return n / 2 / rate
    _, done = window_requests(run)
    return sum(r["audio"].size for r in done) / rate


def end_to_end(run: Run) -> dict:
    w0, w1 = run.window
    sent, done = window_requests(run)
    audio = window_audio_s(run)
    # one quantity under two names: the served cells' own, whose host-bound
    # runs spread more, keeps a bound of its own
    rate = (audio / (w1 - w0), "audio-s/s")
    out = {"audio_s_per_wall_s": rate, "served_audio_s_per_wall_s": rate,
           "setup_s": (run.setup_s, "s")}
    if run.traffic.get("stream"):
        ttfa = ttfa_values(run)
        log(f"ttfa: {len(ttfa)} streamed requests sent in the window, "
            f"{sum(math.isinf(t) for t in ttfa)} without first audio; "
            f"p50 {percentile(ttfa, 50):.4f} s, p90 {percentile(ttfa, 90):.4f} s")
    log(f"window {w1 - w0:.3f} s: {len(sent)} requests sent, {len(done)} "
        f"completed, {audio:.3f} s of audio delivered")
    return out


def ttfa_values(run: Run) -> list:
    w0, w1 = run.window
    return [(r["t_first"] - r["t_send"]) if r["ok"] and r["t_first"]
            else math.inf for r in run.records if w0 <= r["t_send"] < w1]


# ---------------------------------------------------------------------------
# the correctness check
# ---------------------------------------------------------------------------

def judge(run: Run, raw: dict, recorder, checksum0: float,
          control: bool = False) -> tuple[dict, dict]:
    """The numbers compared, each (value, limit), and with `control` the
    control's readings of the same numbers and its verdicts. Every greedy
    request the window completed: the reference's logits at the served
    tokens (the widest gap by which a served token's logit lies below the
    reference's best) and, where the family captures them, the program's
    own logits against the reference's (relative RMS error); a sample of
    the window's completed requests, drawn from the seed and holding the
    longest: the audio (the reference's delay undo and DAC of the served
    tokens against what the client received); for all of them the text
    ids and the decode steps."""
    from port_bench import weights
    fam, cfg = run.fam, run.cfg
    limits = cell_limits(run.cell)
    sent, done = window_requests(run)
    rng = random.Random(run.seed)
    done = sorted(done, key=lambda r: r["key"])
    greedy = [r for r in done if run.specs[r["key"]]["greedy"]]
    judge_n = run.traffic["judge"]
    pick_g = greedy
    pick_a = _sample(rng, done, judge_n["audio"], run)
    int16 = run.traffic["mode"] == "server"
    nums = {"requests_failed": sum(not r["ok"] for r in sent) + run.stuck,
            "greedy_unjudged": max(0, judge_n["greedy"] - len(pick_g)),
            "weights_changed": abs(weights.checksum(raw) - checksum0),
            "ids_differing": 0, "steps_differing": 0, "audio_len_differing": 0,
            "logits_missing": 0, "logit_gap": 0.0, "logit_err": 0.0,
            "audio_err": 0.0}
    ctrl = {n: 0.0 for n in READINGS}
    strict_fp32()
    in_g, in_a = {id(r) for r in pick_g}, {id(r) for r in pick_a}
    for r in {id(r): r for r in pick_g + pick_a}.values():
        spec = run.specs[r["key"]]
        ids = fam.ref_ids(cfg, spec["text"])
        if fam.program_ids(recorder, spec["text"]) != ids:
            nums["ids_differing"] += 1
        out = run.outputs.get(r["key"])
        if out is None:
            nums["steps_differing"] += 1
            continue
        tokens, n_steps = out
        if n_steps != fam.decode_steps(cfg, len(ids)):
            nums["steps_differing"] += 1
        tok = torch.as_tensor(tokens[:n_steps], device=run.device).long()
        if id(r) in in_g and n_steps > 0:
            lg = fam.ref_logits(raw, cfg, ids, tok, n_steps)
            best = lg.max(-1).values
            gap = best - lg.gather(-1, tok[..., None])[..., 0]
            nums["logit_gap"] = max(nums["logit_gap"], float(gap.max()))
            if "logit_err" in limits:
                steps = run.logits.get(r["key"])
                if steps is None or len(steps) < n_steps:
                    nums["logits_missing"] += 1
                else:
                    mine = torch.cat(steps[:n_steps]).reshape(lg.shape)
                    nums["logit_err"] = max(nums["logit_err"],
                                            rel_rms(mine.float(), lg))
            if control:
                lc = fam.ref_logits(raw, cfg, ids, tok, n_steps, "fp8")
                pick = lc.argmax(-1, keepdim=True)
                cgap = best - lg.gather(-1, pick)[..., 0]
                ctrl["logit_gap"] = max(ctrl["logit_gap"], float(cgap.max()))
                ctrl["logit_err"] = max(ctrl["logit_err"], rel_rms(lc, lg))
                del lc
            del lg
        if id(r) in in_a:
            frames = torch.tensor(fam.ref_frames(cfg, tokens, n_steps),
                                  dtype=torch.long, device=run.device)
            want = ref_dac.decode(raw["dac"], cfg["dac"], frames) \
                if frames.numel() else torch.zeros(0, device=run.device)
            got = torch.as_tensor(r["audio"], device=run.device)
            if got.numel() != want.numel() or want.numel() == 0:
                nums["audio_len_differing"] += 1
                continue
            rms = float(want.square().mean().sqrt())
            nums["audio_err"] = max(nums["audio_err"],
                                    float((got - want).abs().max()) / rms)
            if control:
                torch.backends.cudnn.allow_tf32 = True
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    c = ref_dac.decode(raw["dac"], cfg["dac"], frames)
                finally:
                    strict_fp32()
                if int16:   # served as the program's is: 16-bit, truncated
                    c = torch.trunc(c.clamp(-1, 1) * 32767.0) / 32767.0
                ctrl["audio_err"] = max(ctrl["audio_err"],
                                        float((c - want).abs().max()) / rms)
    checks = {k: (nums[k], 0) for k in EXACT}
    if "logit_err" in limits:
        checks["logits_missing"] = (nums["logits_missing"], 0)
    # the numbers with limits set from readings: those the cell's limits
    # file names
    for name in READINGS:
        if name in limits:
            checks[name] = (nums[name], limits[name])
    if control:
        exact_ok = all(v <= lim for k, (v, lim) in checks.items()
                       if k not in READINGS)
        ctrl = {"program": {n: nums[n] for n in READINGS if n in limits},
                "control": {n: ctrl[n] for n in READINGS if n in limits},
                # the control in the program's place: fp8 in the decoder
                # and TF32 in the DAC; and fp8 in the decoder with the DAC
                # in float32, whose audio is the reference's own
                "control_correct": exact_ok and verdict(ctrl, limits),
                "control_correct_f32_dac": exact_ok and verdict(
                    {n: ctrl[n] for n in LOGIT_READINGS}, limits)}
    return checks, ctrl


EXACT = ("requests_failed", "greedy_unjudged", "weights_changed",
         "ids_differing", "steps_differing", "audio_len_differing")


def cell_limits(cell) -> dict:
    """The limits of the numbers a cell compares (limits/<cell>.json, or a
    test's own on `cell.limits`), without the readings kept beside them."""
    limits = getattr(cell, "limits", None) or common.load_json(
        cell.bench_dir / "limits" / f"{cell.name}.json")
    return {n: float(v) for n, v in limits.items() if n in READINGS}


def verdict(readings: dict, limits: dict) -> bool:
    """Whether every reading of a number with a limit lies within it (the
    program's `correct` and the control's use this one comparison)."""
    return all(readings[n] <= limits[n] for n in readings if n in limits)


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """RMS of got - want over RMS of want, on want's finite entries (the
    masked tokens are -inf on both sides); non-finite where got is not
    finite there."""
    fin = torch.isfinite(want)
    d = (got - want)[fin]
    err = float(d.square().mean().sqrt() / want[fin].square().mean().sqrt())
    return err if math.isfinite(err) else math.inf


def _sample(rng: random.Random, reqs: list, n: int, run: Run) -> list:
    """n requests drawn from `reqs` with the longest (most decode steps,
    fewest prompt tokens or bytes) among them."""
    if not reqs:
        return []
    longest = min(reqs, key=lambda r: (run.specs[r["key"]]["size"], r["key"]))
    rest = [r for r in reqs if r is not longest]
    return [longest] + rng.sample(rest, min(n - 1, len(rest)))


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(cell, seed: int, seconds: float, trace: int, device="cuda",
        t_proc0: float | None = None, control: bool = False,
        fault=None, drain_s: float = DRAIN_S) -> dict:
    """One run of `cell`; returns the contract's result (the last line) with
    "checks" last, and with `control`, "control" beside it. `fault` (a
    function of the Run, for the harness's own tests) breaks the timed path
    after set-up."""
    t_proc0 = time.perf_counter() if t_proc0 is None else t_proc0
    r = Run(cell, seed, seconds, trace, device)
    r.drain_s = drain_s
    try:
        return _run(r, cell, seed, trace, t_proc0, control, fault)
    finally:
        r.unpatch()


def _run(r: Run, cell, seed, trace, t_proc0, control, fault) -> dict:
    if r.device.type == "cuda":
        from tts_tpu_torch.ops import _build
        _build.build(r.fam.SOURCES)
        torch.cuda.reset_peak_memory_stats(r.device)
    strict_fp32()
    raw = r.fam.make_raw(r.cfg, seed, r.device)
    r.sync()
    from port_bench import weights
    checksum0 = weights.checksum(raw)
    recorder = r.fam.Recorder()
    runner = r.fam.build(r.cfg, raw, r.device, recorder, r.patch)
    if runner.dac is not None:
        _warm_vocoder(r, runner.dac)
        _wrap_vocoder(r, runner.dac)
    if trace:
        _warm_profiler(r)
    if fault is not None:
        fault(r, runner)
    if r.traffic["mode"] == "server":
        _served_window(r, runner)
    else:
        _runner_window(r, runner)
    if trace and not r.trace_ok:
        raise RuntimeError(
            f"none of {TRACE_ATTEMPTS} traced sessions of {r.traffic['trace_s']}"
            f" s held 90% of the launches the program's counters counted: "
            f"the per-layer metrics would be read from a trace that lost "
            f"kernels")
    r.setup_s = r.window[0] - t_proc0
    e2e = end_to_end(r)
    per_layer = per_layer_metrics(r) if trace else {}
    del runner
    checks, ctrl = judge(r, raw, recorder, checksum0, control)
    sent, _ = window_requests(r)
    correct = all(v <= lim for v, lim in checks.values())
    names = [m["name"] for m in cell.metrics("end_to_end" if not trace
                                             else "per_layer")]
    source = e2e if not trace else per_layer
    metrics = {n: {"value": source[n][0], "unit": source[n][1]}
               for n in names if n in source and math.isfinite(source[n][0])}
    for n in names:
        if n in source and not math.isfinite(source[n][0]):
            log(f"{n}: {source[n][0]} (requests without audio), left out")
    result = {"correct": correct, "attempted": len(sent),
              "failed": checks["requests_failed"][0], "metrics": metrics,
              "device": device_info(r)}
    if trace and r.trace is not None:
        result["breakdown"] = r.trace.breakdown()
    if control:
        result["control"] = ctrl
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def device_info(r: Run) -> dict:
    if r.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(r.device),
         "count": r.cell.chips, "memory_peak_bytes": r.memory_peak}
    if r.trace is not None:
        d["busy_s"] = r.trace.busy_s()
        d["window_s"] = r.trace.window_s
    return d


def per_layer_metrics(r: Run) -> dict:
    """Every per-layer metric of the cell, from its own reader (a reader
    that finds nothing to read returns None and the metric is left out)."""
    out = {}
    for m in r.cell.metrics("per_layer"):
        v = common.metric_reader(m["name"], r.cell.bench_dir).read(r)
        if v is not None:
            out[m["name"]] = (v, m["unit"])
        else:
            log(f"{m['name']}: nothing to read in this run")
    return out
