"""The load generator: one general generator that every traffic file feeds.

A traffic file (traffic/<name>.json) gives the mix's parameters:

    mode          "server": clients POST /v1/audio/speech to the port's
                  server in a closed loop (each sends its next request when
                  the last one ends), coroutines of one thread in a child
                  process of their own;
                  "runner": one client calls the runner's `generate` back
                  to back in the harness's process, as the CLI does
    clients       closed-loop clients ("server")
    batch_slots   the server's --batch-slots ("server")
    stream        true: chunked PCM (time to first audio), false: a WAV
    prompt_sizes  [lo, hi]: prompt tokens (Parler, EOS included) or script
                  bytes (Dia), every size in the range once a cycle
    sampling      the requests' sampling parameters, one entry each a cycle;
                  {"greedy": true} is greedy decoding (top_k 1 through the
                  server)
    ramp_s        clients start evenly spread over the ramp, which ends
                  where the measured window starts ("server")
    trace_s       seconds of the window that a --trace 1 run traces
    judge         "greedy": the fewest greedy requests the window must
                  complete (the check compares the logits of all it did);
                  "audio": requests whose audio the check compares

The requests come from the seed alone: the same seed gives the same
requests in the same order. Every seed draws the same multiset of sizes
and parameters, in another order, so that the work does not move with the
seed. Standard library only: the child process imports this module.
"""
from __future__ import annotations

import asyncio
import json
import os
import random
import time


def request_specs(traffic: dict, seed: int, prompt_fn, n: int) -> list:
    """n requests: {key, text, size, params, greedy}. `prompt_fn(start,
    size)` makes a prompt of `size` from the sentences' word or sentence
    `start`."""
    rng = random.Random(seed)
    lo, hi = traffic["prompt_sizes"]
    sizes, mixes = [], []
    out = []
    for key in range(n):
        if not sizes:
            sizes = list(range(lo, hi + 1))
            rng.shuffle(sizes)
        if not mixes:
            mixes = list(traffic["sampling"])
            rng.shuffle(mixes)
        size, mix = sizes.pop(), mixes.pop()
        greedy = bool(mix.get("greedy"))
        params = ({"temperature": 1.0, "top_k": 1, "top_p": 1.0,
                   "repetition_penalty": 1.0} if greedy else
                  {k: mix[k] for k in ("temperature", "top_k", "top_p",
                                       "repetition_penalty")})
        out.append({"key": key, "text": prompt_fn(rng.randrange(10 ** 6), size),
                    "size": size, "params": params, "greedy": greedy})
    return out


async def _post(host: str, port: int, spec: dict, stream: bool,
                timeout: float) -> dict:
    """One request over its own connection (the server answers in
    HTTP/1.0 and closes it), read as it arrives: a stream's chunked body
    chunk by chunk. Times from this process's time.perf_counter."""
    body = json.dumps(dict(input=spec["text"], stream=stream, seed=spec["key"],
                           **spec["params"])).encode()
    head = (f"POST /v1/audio/speech HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Type: application/json\r\nContent-Length: {len(body)}"
            f"\r\nConnection: close\r\n\r\n").encode()
    rec = {"key": spec["key"], "ok": False, "t_first": None, "status": 0,
           "error": ""}
    rec["t_send"] = time.perf_counter()
    writer = None
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout)
        writer.write(head + body)
        await writer.drain()
        rec["body"] = await asyncio.wait_for(_response(reader, rec), timeout)
        rec["t_done"] = time.perf_counter()
        rec["ok"] = rec["status"] == 200 and len(rec["body"]) > 0
        if not stream and rec["ok"]:
            rec["t_first"] = rec["t_done"]
        if not rec["ok"]:
            rec["error"] = rec["body"][:300].decode("utf-8", "replace")
    except (OSError, ValueError, asyncio.TimeoutError,
            asyncio.IncompleteReadError) as e:
        rec["t_done"] = time.perf_counter()
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        if writer is not None:
            writer.close()
    return rec


async def _response(reader, rec: dict) -> bytes:
    """The status, then the body: chunked (the time and size of each chunk
    in rec["chunks"], the first's time in rec["t_first"]), by
    Content-Length, or to the connection's end."""
    rec["status"] = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        line = (await reader.readline()).strip()
        if not line:
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    if headers.get("transfer-encoding", "").lower() == "chunked":
        parts, rec["chunks"] = [], []
        while True:
            size = int((await reader.readline()).split(b";")[0], 16)
            if size == 0:
                break
            parts.append(await reader.readexactly(size))
            t = time.perf_counter()
            rec["chunks"].append([t, size])
            if rec["t_first"] is None:
                rec["t_first"] = t
            await reader.readexactly(2)
        return b"".join(parts)
    if "content-length" in headers:
        return await reader.readexactly(int(headers["content-length"]))
    return await reader.read()


def clients_main(conn, host: str, port: int, specs: list, traffic: dict,
                 seconds: float, drain_s: float, cores=None) -> None:
    """The child process, on `cores` (the server's process keeps the
    others): says it is ready, starts the clients when told
    to on `conn`, runs the closed loop until the window's end, lets the
    requests in flight end (at most `drain_s`), and sends back every
    request's record, its times in seconds from the start (the parent
    puts them on its own clock: no clock is shared between processes).
    The clients are coroutines of one thread."""
    if cores:
        os.sched_setaffinity(0, cores)
    conn.send("ready")
    conn.recv()
    records, stuck = asyncio.run(_clients(host, port, specs, traffic,
                                          seconds, drain_s))
    conn.send({"records": records, "stuck": stuck})
    conn.close()


async def _clients(host, port, specs, traffic, seconds, drain_s):
    n = int(traffic["clients"])
    ramp = float(traffic["ramp_s"])
    stream = bool(traffic["stream"])
    t_start = time.perf_counter()
    t_end = t_start + ramp + seconds
    nxt = iter(specs)
    records = []

    async def client(i: int) -> None:
        await asyncio.sleep(ramp * i / n)
        while time.perf_counter() < t_end:
            spec = next(nxt, None)
            if spec is None:
                return
            rec = await _post(host, port, spec, stream, drain_s + seconds)
            rec["client"] = i
            records.append(rec)

    tasks = [asyncio.ensure_future(client(i)) for i in range(n)]
    _, pending = await asyncio.wait(
        tasks, timeout=max(0.0, t_end + drain_s - time.perf_counter()))
    for t in pending:
        t.cancel()
    for rec in records:
        for k in ("t_send", "t_first", "t_done"):
            if rec.get(k) is not None:
                rec[k] -= t_start
        for c in rec.get("chunks", ()):
            c[0] -= t_start
    return records, len(pending)
