#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

1. Device: the card's name and power limit (nvidia-smi); build every kernel
   from tts_tpu_torch/csrc with nvcc, all sources at once.
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with the tolerance printed, and timed by device
   time (torch.profiler; the time with the host's launch path logged
   beside) with the plain version, a one-call PyTorch yardstick where one
   exists (SDPA for K3 / K4), and its bound (bytes over 3.35 TB/s,
   operations over the peak rate for their type, the larger). The decode
   steps (K2, K5) are held layer by layer, against the plain version on
   the CPU as a yardstick; K3 / K4 also at heads of 128 with 3 and 4 q
   heads a kv head (one launch a K3 call); K4 and K5 at 8 slots at mixed
   positions across page boundaries, and each of their slots against K3 /
   K2 on that slot's state, bit for bit; K3 / K4 and the cross-attention
   entry at heads of 1, 36, 80, 100, 192, 200, 256, 320 and 512 (the
   generic path, which takes 1-1024), bf16 and f32 caches, timed at 80,
   100, 192, 256 and 320 beside their plain versions and SDPA. K7's check
   prints the L2 bytes its launch
   sequence's GEMVs read to stage their input rows beside its weight bytes
   (and fails unless they are fewer). K12 (one cooperative launch) against
   K2 bit for bit, with the grid barriers its kernel counted equal to its
   plan (6 a layer with the cross block, 4 without); K9 / K7 (the batched
   persistent step, one launch a group of at most 8 slots) each slot bit
   for bit against K8 / K6 and the step against its launch sequence, one
   launch a group on the counters, timed beside the sequence.
3. Reference: a small Q4_0 Parler on the card (kernels) and on the CPU
   (plain versions), float32 caches on both; the card follows the CPU's
   greedy token history and its logits must match at every step. Then the
   JAX package's runtime switches on it (phases 6 and 9 do the same for
   Orpheus and Dia), counters zeroed before and read after each run:
   TTS_TPU_KV_DTYPE=float32 (the runner's caches float32 on its default
   and persistent routes, the engine's state float32, greedy codes equal
   across them) and TTS_TPU_MEGAKERNEL=0 (the per-matmul route: the
   runner teacher-forced against the CPU, K1 and K3 / K4 risen and no step
   kernel, the engine's codes equal to the runner's; Dia's engine, which
   reads the bucketed bf16 cross K/V, held to the CPU engine's).
4. Main path: a Parler-Mini-shaped Q4_0 GGUF (24 layers, H 1024, 16 heads,
   F 4096, 9 heads x vocab 1088, DAC-44k vocoder; random weights from a
   seed) written with the port's GGUF writer, turned into a WAV by the
   port's CLI (sampled, fixed seed, 256 decode steps). Every kernel's
   launch counter is set to 0 just before and read just after; K1-K3 must
   have risen. The same CLI again on the K12 route (the runner's mega from
   maybe_prep_parler_flat): K12 must have risen, K2 and K3 not. Then both
   routes timed stage by stage in turns (K2, K12, K12, K2), a device trace
   of 32 decode steps on each (the card's busy share, device time by
   kernel), and their greedy codes over the 256 steps (equal). Then the
   runner's greedy stream (generate_stream) on each route: its codes equal
   those, its waveform the DAC's of them (95% of samples within 1e-4, all
   within 0.2); time to the first chunk and the chunk count logged. Then
   TTS_TPU_DAC_DTYPE=bfloat16 on the DAC-44k decoder: bf16 convolution
   weights, the card's bf16 decode against the CPU's (no farther from it
   than bf16 is from f32 on the CPU), and the bf16 vocode timed beside the
   f32 one.
4b. Quantize tool (run after phase 4): a Parler-TTS Mini f32 GGUF (full
   width and depth, DAC-44k; random from its own seed) written by the
   port's convert.write_parler_gguf, quantized by the port's
   `apps.quantize -qt Q4_0 -qh` on the card (the GGUF block-quantization
   kernel, csrc/quantize.cu; one launch a quantized tensor), every tensor
   byte for byte against the kernel's plain version on the card, and the
   output decoded by the port's CLI to a WAV (K1-K3 must rise); Q5_0,
   Q8_0 and F16 with -qh -qe -qkv -df on a 2-layer copy at full width; the
   kernel against its plain version and numpy on edge blocks (ties of |x|
   with opposite signs, +-0, Q8_0's half-way block, subnormal and
   overflowing fp16 scales); the tool's wall time by stage (read, host ->
   device, kernel, device -> host, write) and the kernel timed at each
   shape it quantized, beside its bound.
5. Serving path: the port's HTTP server in this process (batch_slots 8,
   the same GGUF) answers 12 concurrent requests with mixed sampling
   parameters, 2 of them streamed (`"stream": true`, top-k 1); counters
   set to 0 just before, read just after; K1, K4 and K5 must have risen;
   each stream's 16-bit PCM against the same request sent whole (within 1
   LSB for 95% of samples), its time to the first samples logged, and
   /metrics counting the streams. Then the batched decode step timed and
   traced, one request through batch_slots 0, and the engine's greedy
   codes against the single-stream runner's (equal). The Orpheus and Dia
   serving phases stream 2 of their 12 requests the same way.
5b. Conditional prompt: a T5 encoder GGUF at flan-t5-large width (24
   layers, d 1024, 16 heads, d_ff 2816, Q4_0; random from a seed) held to
   its plain version (dequant + matmul) on the card; the Parler CLI with
   --conditional-prompt / --text-encoder-path (a valid WAV, Tc the
   description's token count); the server with --text-encoder-path: POST
   /v1/audio/conditional-prompt, then 4 greedy requests through the
   batched engine (K5 at the new Tc) equal the runner's on the K12 and K2
   routes; K2's and K12's layer checks at that Tc.
6. Orpheus reference: a small Q4_0 Orpheus on both decode routes (Q4_0
   head: K6; F16 head: K8) on the card and on the CPU, teacher-forced
   logits compared at every step, and the tokens vocoded through SNAC on
   both.
7. Orpheus main path: an Orpheus-3B-shaped Q4_0 GGUF (28 layers, H 3072,
   24/8 heads of 128, F 8192, vocab 156,940, Q4_0 head, F16 embeddings,
   SNAC-24k; random weights from a seed) turned into a WAV by the port's
   CLI with a voice (sampled, fixed seed, up to ORPHEUS_CLI_TOKENS = 1024
   tokens); counters set
   to 0 just before, read just after; K1 and K6 must have risen, K3 and
   the launch sequences' GEMV not (K6 is one launch a step). Then the path
   timed stage by stage and a device trace of 32 decode steps: one K6
   launch a step, at most 75 kernels a step; the runner's greedy stream
   over the whole window against generate_tokens and its SNAC decode; the K8 route (the head
   swapped for an F16 one, 64 decode steps): one K8 launch a step, and
   the K9 route (the batched engine on those weights,
   8 slots, 64 batched steps): one K9 launch a step, K7 and K4 none.
8. Orpheus serving: the port's HTTP server in this process (batch_slots 8,
   the Orpheus-3B GGUF, its `orpheus.max_generation_size` rewritten to
   700 tokens before the server loads it: ORPHEUS_SERVING_TOKENS) answers 12 concurrent requests with a voice and
   mixed sampling parameters; counters set to 0 just before, read just
   after; K1 and K7 must have risen. Then the batched step timed and
   traced (2 K7 launches a step, the persistent layer stack's and the head
   GEMV's, no K4), one request through batch_slots 0, and the engine's
   greedy tokens against the single-stream runner's (K6's; equal).

9. Dia reference: a small Q4_0 Dia's encoder on the card against the CPU's,
   then its teacher-forced CFG-merged logits (K10) card vs CPU from the
   same cross K/V, and the codes vocoded on both.
10. Dia main path: a Dia-1.6B-shaped Q4_0 GGUF (encoder 12 layers of H
   1024, decoder 18 layers of H 2048, 16 q / 4 kv heads of 128, F 8192, 9
   codebooks of vocab 1028, DAC-44k; random weights from a seed; the
   generation window cut to 512 steps) turned into a WAV by the port's
   CLI; counters set to 0 just before, read just after; K1 and K10 must
   have risen, K4 and the cross-attention entry not (K10 runs both inside
   its one launch). Then the path timed stage by stage and a device trace
   of 32 decode steps: one K10 launch a step, at most 95 kernels a step;
   the runner's greedy stream against generate_codes and the DAC.
11. Dia serving: the port's HTTP server in this process (batch_slots 8, the
   Dia-1.6B GGUF, its generation window rewritten to DIA_SERVING_STEPS)
   answers 12 concurrent dialogue requests of 20-200 bytes
   with mixed sampling parameters; K1, K4, K11 and its cross-attention
   must have risen. Then the batched step timed and traced, one request
   through batch slots 0, and the engine's greedy codes against the
   runner's (K10's) over 300 steps.
12. Slot groups, on small models (run before phases 10-11): engines past
   one launch's rows, a Parler one with 20 slots, an Orpheus one with 20
   (heads of 128: K7) and a Dia one with 12, every slot busy with a greedy
   request: each request's codes equal the single-stream runner's. Then
   the server with batch_slots 12 on the small Dia GGUF reaches READY and
   answers a request.
13. Head sizes other than 64 / 128, on small models (run before phases
   10-11): Parler, Orpheus and Dia GGUFs with heads of 256, 192 and 100,
   each runner on the card teacher-forced against the CPU's plain
   versions, and each engine's greedy codes (tokens) against its runner's
   on the card (the persistent steps take 64 / 128 only: Orpheus's single
   stream runs K7 / K9 at one slot there, Dia's K11 at one pair; heads of
   100 take the per-matmul route, K1 and K3 / K4, as the JAX gates send
   them, and Dia's engine there is held to the CPU engine's).

14. K1's census: each main path's K1 calls by shape (qm.SHAPES, counted
   over the same windows as the launch counters), and K1 held against its
   plain version at every shape of it (within 1e-5 of the largest output)
   and timed there beside its bound, its plain version and dequant +
   torch.matmul (device time of back-to-back calls from CUDA events, the
   calls queued behind a spin kernel: queued_ms). Each CLI path also logs
   its prefill's (Dia: encoder's) device time and K1's part of it.
15. Kokoro (run last; plain PyTorch: its JAX path reaches no Pallas kernel,
   and the phase fails if any K1-K12 counter rises on it): a
   Kokoro-82M-shaped F32 GGUF (hexgrad/Kokoro-82M widths; random weights
   from the phase's own seed, the duration head's bias set for ~3 frames a
   token and the F0 head's for voiced speech; two voices and a rule-based
   phonemizer) turned into 24 kHz WAVs by the port's CLI (one sentence, and
   a prompt of several chunks: 600 samples a frame of every chunk); the
   duration graph card vs CPU on 18 tokens (hidden states within 1e-4 of
   their largest, durations equal) and the generation graph on the card
   from the CPU's durations and noise (99.9% of samples within 1e-3 of the
   CPU's peak; the STFT's real-bin angles equal); the runner's stream on
   the long prompt against its `generate`; the stages timed (duration
   graph, generation graph, the LSTM scans' share, a request traced); the
   server with batch slots 8 (Kokoro takes the worker pool) answering 12
   concurrent requests, 2 streamed, each stream within 1 LSB of the same
   request sent whole.
16. Parallelism (tts_tpu_torch/parallel; its own seeded generators, run
   after phase 15): each model's Megatron TP step (Parler-Mini, Orpheus-3B
   and the Dia-1.6B decoder at full width, random Q4_0, 4 steps with cache
   writes at positions 1000-1003) at tp=1 under NCCL in this process (a
   world of one), then 4 spawned ranks over gloo sharing cuda:0 (named by
   the caller: NCCL refuses two ranks on one card), each with a timeout: a
   rank that fails or hangs fails the run. Ranks 0 and 1: (a) tp=2, each
   step fed tp=1's input and cache rows, x_out / k_new / v_new within
   TP_REL of tp=1's peak, K1 risen in every rank, each step on the host
   clock; (b) the weight-gather mode at tp=2, bit for bit against K2 on
   the unsharded Parler-Mini weights; (c) sharded_dac_decode of DAC-44k
   over 256 frames at sp=2 against the card's unsharded decode (bit
   equality reported; the streams' criterion held). All four: (d) dp x tp
   2 x 2, the batched Parler chunk at Parler-Mini width with 8 slots at
   positions across the 256- and 512-row pages, 8 steps: teacher-forced
   logits within TP_REL of the unsharded chunk's, greedy tokens equal
   wherever the top-2 gap exceeds that bound. gloo's times go through the
   host: correctness and each shard's K1, not scaling. Then K4 at the dp x
   tp shard (4 slots, 8 heads of 64, at the 8 steps' positions) against
   its plain version.
17. The perf battery (apps/perf_battery.py): main() on the Kokoro-82M GGUF
   (30 sentences and the warm-up; no K1-K12 counter may rise) and
   run_battery on a Parler-Mini GGUF (8 sentences, 64 decode steps or
   more; K1-K3 must rise), both JSON blobs logged; one sentence under
   utils.profiling.trace, whose file must name K1's kernel. Then K1 is
   held against its plain version and timed at the shapes phases 16-17
   added to the census (the shards, the battery's prefills).

Phase 2 holds K1 at 1-256 rows (each warp layout: 1-8, 9-16, 17-32,
33-64, 65-128, 129-256 rows; both numeric modes, every quant type, K
1024-8192) within 1e-5 of the largest output of its
plain version, and each row of a 16-row heads call and of a 256-row f32
prefill call bit for bit against that row's call alone. It also holds K12
(the one-launch Parler step) at Parler-Mini width
at positions 0-4095 with and without the cross block: bit for bit against
K2 on the same state, layer by layer against its plain version, and timed
beside K2 in turns; then it times each Parler GEMV launch alone (qkv, o,
cq, co, fc1, fc2 at 1, 8 and 16 rows) beside its weight bytes. It holds K8
and K6 (the persistent llama step, one cooperative launch) at Orpheus-3B
width bit for bit against the launch sequence (K9 / K7 at one slot) at
positions 0-3583, Q4_0 on 28 layers and Q5_0 / Q8_0 on 2, layer by layer
against their plain versions at positions around the pages (every layer
a case; each case's yardstick the larger of two pairs, plain summed in
another order and, on 4 layers, plain on the CPU, each against plain on
the card; three seeded defects in the
kernel's place, the normed x rounded toward zero, a lost K row and slot
0's position read for every slot, must each fail that judge:
check_yardstick_defects), and times
them beside the launch sequence in turns (at pos 1000, and K6 at the
cache's first and last rows); K1 also at the T5 encoder's shapes (64 rows, 1024 x 1024, 2816 x
1024, 1024 x 2816, f32 mode);
and K9 and K7 at 8 slots at mixed positions (one at 0): each slot bit for
bit against K8 / K6 on its state (also at 16 slots on 4 layers), layer by
layer against the plain versions, K7's logits per slot, timed. It holds K10
(the persistent Dia step, one cooperative launch) at Dia-1.6B width bit
for bit against the launch sequence (K11 at one pair) and layer by layer
against its plain version at positions 0-3071 over cross buckets of 128
(with an 896-row tail) and 1024 rows, Q5_0 and Q8_0 on 2 layers bit for
bit too, and times it beside the launch sequence in turns; and K11 at 4
and 8 pairs at mixed positions, each pair bit for bit against K10, and
times it. The CPU
yardsticks of the layer checks compare a few layers of each step (K5 6 of
24, K6-K9 4 of 28 (K6 / K8 at 4 positions), K10 / K11 2 of 18; the llama
and Dia steps' dequantization done once per layer for all slots), to keep
the run in its time.

The run logs each phase's seconds and, at its end, the phases' total
against PHASE_BUDGET_S (700 s) and the build's and phases' against
TOTAL_BUDGET_S (900 s) of its 1200 s limit. The last three lines of
standard output are the card's name and power limit, one JSON object
describing each kernel, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

from tts_tpu_torch.gguf import GGUFWriter, quants
from tts_tpu_torch.ops import _build
from tts_tpu_torch.ops import decode_attention as da
from tts_tpu_torch.ops import dia_flat as dfl
from tts_tpu_torch.ops import dia_megastep as dm
from tts_tpu_torch.ops import llama_flat as lf
from tts_tpu_torch.ops import llama_megastep as lm
from tts_tpu_torch.ops import llama_persistent as lp
from tts_tpu_torch.ops import parler_flat as pf
from tts_tpu_torch.ops import parler_megastep as pm
from tts_tpu_torch.ops import quant_matmul as qm
from tts_tpu_torch.ops import quantize as oq

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}   # dense, CUDA cores / tensor cores
SEED = 0
DEV = torch.device("cuda")

# Parler-TTS Mini v1 (tts_tpu/models/parler/model.py ParlerConfig defaults)
MINI = dict(n_layers=24, hidden=1024, heads=16, ffn=4096, n_out=9,
            vocab=1088, ctx=4096, enc_len=64)
DECODE_STEPS = 256
PROMPT = "hey, how are you doing today?"
TOKENS = ["<unk>", "</s>", " ", ",", "?", "."] + [chr(c) for c in range(97, 123)] + \
    ["he", "ow", "ar", "yo", "ou", "do", "in", "ng", "to", "da", "ay"]


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() in ms: CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_key(name: str) -> str:
    """A device event's kernel name without namespace, return type and
    template arguments (at most 48 characters)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", name)[0][:48]


class DeviceTime(NamedTuple):
    ms: float        # device time of one call
    by_name: dict    # its split by kernel name, ms
    events: float    # device events (kernels, memsets, copies) of one call
    counts: dict     # device events of one call by kernel name


def busy_ms(spans) -> float:
    """The time in ms that at least one of the (start, end) spans (µs)
    covers: kernels launched with programmatic dependent launch start while
    the kernel before them still runs and wait for it, so their spans
    overlap, and a sum of durations would count the overlap twice."""
    total, cur_s, cur_e = 0.0, None, None
    for st, en in sorted(spans):
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def device_ms(fn, iters: int = 20, warmup: int = 3) -> DeviceTime:
    """Device time of one fn() call in ms, its split by kernel name and its
    device events: the time the device was busy with the kernels (and
    memsets / copies) the calls ran, from a torch.profiler trace of `iters`
    calls (busy_ms: overlapping spans counted once), over `iters`; by name
    likewise, each name's spans merged. Host time between launches is not
    counted, so a host-bound call reads as its kernels' work. A trace that
    holds no device activity (the profiler can lose a window's events) is
    taken again, twice at most; raises where the third shows none
    either."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans: dict = defaultdict(list)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                spans[kernel_key(e.name)].append((e.time_range.start,
                                                  e.time_range.end))
        if spans:
            break
        log("  torch.profiler recorded no device activity; tracing again")
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    by_name = {k: busy_ms(v) / iters for k, v in spans.items()}
    every = [sp for v in spans.values() for sp in v]
    return DeviceTime(busy_ms(every) / iters, by_name, len(every) / iters,
                      {k: len(v) / iters for k, v in spans.items()})


def step_ms(fn, label: str, iters: int = 20) -> float:
    """The device time of one fn() call (device_ms: the kernels' work),
    which the kernels line reports, logged beside the time CUDA events give
    over the same calls, the host's launch path included (host-bound steps
    are slower end to end than their kernels)."""
    dt = device_ms(fn, iters=iters)
    log(f"  {label}: {dt.ms:.4f} ms of device time per call ({dt.events:.1f} "
        f"device events), {cuda_ms(fn, iters=iters):.4f} ms with the host's "
        f"launch path")
    return dt.ms


last_trace: dict | None = None   # device_trace's numbers, None: not measured


def device_trace(fn, label: str, per: int):
    """Run fn() once under torch.profiler (device activity only) and print
    the card's busy share over the span from the first kernel's start to
    the last one's end (busy_ms), and device time by kernel name, per `per` units
    (steps); returns fn()'s result and keeps the kernels and busy share per
    unit in `last_trace`. Only the profiler is a diagnostic: where it fails
    to start or to report device activity the trace says "not measured"
    (`last_trace` None), but an error from fn() itself ends the run."""
    from torch.profiler import ProfilerActivity, profile
    global last_trace
    last_trace = None
    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:
        log(f"  device trace, {label}: not measured ({e!r})")
        prof = None
    try:
        out = fn()
        torch.cuda.synchronize()
    except BaseException:
        if prof is not None:
            with contextlib.suppress(Exception):   # fn()'s error is reported
                prof.stop()
        raise
    if prof is None:
        return out
    try:
        prof.stop()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as e:
        log(f"  device trace, {label}: not measured ({e!r})")
        return out
    if not kernels:
        log(f"  device trace, {label}: not measured (no device events)")
        return out
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    span = (max(e.time_range.end for e in kernels) -
            min(e.time_range.start for e in kernels)) / 1e3
    spans: dict = defaultdict(list)
    for e in kernels:
        spans[kernel_key(e.name)].append((e.time_range.start, e.time_range.end))
    by_name = {k: busy_ms(v) for k, v in spans.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  device trace, {label}: {len(kernels) / per:.1f} kernels, "
        f"busy {busy / per:.4f} ms of a {span / per:.4f} ms span per step "
        f"(busy share {busy / span:.3f}); by kernel, ms per step: "
        + ", ".join(f"{n} {t / per:.4f}" for n, t in top))
    last_trace = dict(kernels=len(kernels) / per, busy_share=busy / span,
                      busy_ms=busy / per, span_ms=span / per)
    return out


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes / HBM rate and operations /
    the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, ref, rel: float, why: str) -> float:
    """|got - ref| <= rel * max|ref|; prints the case; returns the error."""
    err = max_err(got, ref)
    tol = rel * float(ref.float().abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= tol
    log(f"  {name}: max_abs_err {err:.3e} tol {tol:.3e} ({why}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# random quantized weights, made on the card from a seed
# ---------------------------------------------------------------------------

def rand_quant(gen, n, k, qtype, scale_dtype, packed=True):
    """A random (n, k) QuantTensor on the card: codes uniform over the
    type's range, scales uniform in [0.002, 0.006] (weights of std ~0.02)."""
    hi = {quants.GGML_TYPE_Q4_0: 16, quants.GGML_TYPE_Q5_0: 32,
          quants.GGML_TYPE_Q8_0: 256}[qtype]
    codes = torch.randint(0, hi, (n, k), generator=gen, device=DEV,
                          dtype=torch.int32)
    if qtype == quants.GGML_TYPE_Q8_0:
        codes = (codes - 128).to(torch.int8)
    else:
        codes = codes.to(torch.uint8)
    scales = (torch.rand((n, k // 32), generator=gen, device=DEV) * 0.004
              + 0.002).to(scale_dtype)
    qt = qm.QuantTensor(codes, scales, qtype)
    return qt.pack() if packed else qt


def stack_quant(gen, layers, n, k, scale_dtype=torch.bfloat16,
                qtype=quants.GGML_TYPE_Q4_0):
    """`layers` random (n, k) weights stacked; Q8_0's scales divided by 16
    (its codes span 16x Q4_0's), so that the weights keep std ~0.02."""
    ws = [rand_quant(gen, n, k, qtype, scale_dtype) for _ in range(layers)]
    div = 16.0 if qtype == quants.GGML_TYPE_Q8_0 else 1.0
    return qm.QuantTensor(torch.stack([w.codes for w in ws]),
                          torch.stack([w.scales for w in ws]) / div, qtype)


def tensor_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

QNAME = {quants.GGML_TYPE_Q4_0: "Q4_0", quants.GGML_TYPE_Q5_0: "Q5_0",
         quants.GGML_TYPE_Q8_0: "Q8_0"}


def k1_bound(m, n, k, w) -> tuple[float, str]:
    """K1's bound: the weight, x and out bytes over the HBM rate, or the
    products over the bf16 tensor-core rate: 2 M N K in bf16 mode, three
    times that in f32 mode (the fewest bf16 passes that carry an f32
    activation's 24 bits against the exact codes)."""
    passes = 1 if w.scales.dtype == torch.bfloat16 else 3
    return bound(tensor_bytes((w.codes, w.scales)) + m * k * 4 + m * n * 4,
                 passes * 2.0 * m * n * k, "bf16")


def k1_rows_alone(label, x, w) -> None:
    """Every row of a K1 call of M rows equals that row's call alone, bit
    for bit (the engines' greedy parity rests on it)."""
    got = qm.quant_matmul_cuda(x, w)
    for r in range(x.shape[0]):
        if not torch.equal(got[r:r + 1], qm.quant_matmul_cuda(x[r:r + 1].contiguous(), w)):
            raise AssertionError(f"K1 {label}: row {r} of {x.shape[0]} differs "
                                 f"from its call alone")
    log(f"  {label}: each of {x.shape[0]} rows equals its call alone, bit for bit: ok")


def check_k1(gen) -> dict:
    log("K1 quant_matmul (csrc/quant_matmul.cu) vs quant_matmul_plain:")
    H, N = MINI["hidden"], MINI["n_out"] * 1280   # heads, per-head padded
    Q4, Q5, Q8 = (quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0,
                  quants.GGML_TYPE_Q8_0)
    bf16, f32 = torch.bfloat16, torch.float32
    OH, OF = ORPHEUS["hidden"], ORPHEUS["ffn"]
    cases = [  # name, M, N, K, qtype, scale dtype, packed
        ("heads Q4_0 packed bf16", 1, N, H, Q4, bf16, True),
        ("prefill Q4_0 packed f32", 64, 4 * H, H, Q4, f32, True),
        ("Q4_0 unpacked f32", 8, 4 * H, H, Q4, f32, False),
        ("Q8_0 f32", 64, 4 * H, H, Q8, f32, False),
        ("Q8_0 bf16", 1, N, H, Q8, bf16, False),
        ("Q5_0 f32", 64, 4 * H, H, Q5, f32, False),
        ("Q5_0 bf16", 1, N, H, Q5, bf16, False),
        ("ragged N Q8_0 f32", 3, 1001, H, Q8, f32, False),
        ("fc2 K=4096 Q4_0 f32", 64, H, 4 * H, Q4, f32, True),
    ]
    # the cases of 16, 17, 100 and 256 rows draw from a generator of their own,
    # so that the later checks' inputs stay as they were
    own = torch.Generator(device=DEV)
    own.manual_seed(SEED + 5)
    cases += [(*c, own) for c in (
        ("Dia serving heads 16 rows", 16, N, DIA["hidden"], Q4, bf16, True),
        ("17 rows Q4_0 packed bf16", 17, N, DIA["hidden"], Q4, bf16, True),
        ("prefill 100 rows Q4_0 f32", 100, OH, OH, Q4, f32, True),
        ("prefill 256 rows gate Q4_0 f32", 256, OF, OH, Q4, f32, True),
        ("prefill 256 rows down Q8_0 f32", 256, OH, OF, Q8, f32, False),
        ("prefill 256 rows Q5_0 bf16", 256, 4 * H, H, Q5, bf16, False))]
    # the T5 encoder's products (flan-t5-large, f32 mode) at the rows of
    # the conditional-prompt path's bucket; K 2816 is not a power of two
    m5, (th, tf) = t5_bucket(), (T5_LARGE["hidden"], T5_LARGE["ffn"])
    cases += [(*c, own) for c in (
        (f"T5 q/k/v/o {m5} rows Q4_0 f32", m5, th, th, Q4, f32, True),
        (f"T5 up/gate {m5} rows Q4_0 f32", m5, tf, th, Q4, f32, True),
        (f"T5 down K={tf} {m5} rows Q4_0 f32", m5, th, tf, Q4, f32, True))]
    errs = []
    for name, m, n, k, qt, sd, packed, *g in cases:
        g = g[0] if g else gen
        w = rand_quant(g, n, k, qt, sd, packed)
        x = torch.randn((m, k), generator=g, device=DEV)
        got = qm.quant_matmul_cuda(x, w)
        ref = qm.quant_matmul_plain(x, w)
        errs.append(check_close(name, got, ref, 1e-5,
                                "same rounding, f32 sums in another order"))
    for label, m, n, k, qt, sd in (
            ("Dia serving heads 16x11520x2048 bf16", 16, N, DIA["hidden"], Q4, bf16),
            ("Orpheus prefill gate 256x8192x3072 f32", 256, OF, OH, Q4, f32),
            (f"T5 down {m5}x{th}x{tf} f32", m5, th, tf, Q4, f32)):
        k1_rows_alone(label, torch.randn((m, k), generator=own, device=DEV),
                      rand_quant(own, n, k, qt, sd))
    # timed at the main path's per-step shape: the 9 stacked heads, cold in
    # L2 as in the decode step (copies rotate through > 50 MB)
    ws = [rand_quant(gen, N, H, Q4, bf16) for _ in range(12)]
    x = torch.randn((1, H), generator=gen, device=DEV)
    it = iter(range(1 << 30))

    def nxt():
        return ws[next(it) % len(ws)]

    ms = k1_device_ms(lambda: qm.quant_matmul_cuda(x, nxt()), iters=50)
    plain_ms = device_ms(lambda: qm.quant_matmul_plain(x, nxt())).ms
    lib_ms = device_ms(lambda: x @ nxt().dense().T).ms
    b_ms, b_by = k1_bound(1, N, H, ws[0])
    log(f"  heads 1x{N}x{H}, device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"dequant+matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="quant_matmul", route="cuda",
                source="tts_tpu_torch/csrc/quant_matmul.cu",
                replaces="tts_tpu/ops/quant_matmul.py:134",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


# K1's census: the main paths' K1 calls by shape (M, N, K, qtype, scale
# dtype, packed), counted on qm.SHAPES over each path's counted window;
# time_k1_census times every shape of it at the end of the run.
K1_CENSUS: dict = {}
# gemv_ab.py --only k1's shapes: from the census of PR 12's run (96 shapes,
# chip_smoke.K1_CENSUS; `gemv_ab.py --census LOG` takes a run's whole
# census), the heads and the Orpheus head row, and each Parler-Mini and
# Orpheus-3B prefill matrix at the CLI's prompt (23 / 17 tokens) and at 64
# and 256 rows.
_Q4 = quants.GGML_TYPE_Q4_0
K1_SHAPES = tuple(
    [(m, n, k, _Q4, "bf16", True) for m, n, k in (
        (1, 11520, 1024), (8, 11520, 1024), (2, 11520, 2048),
        (16, 11520, 2048), (1, 157184, 3072))] +
    [(m, n, k, _Q4, "f32", True) for m in (23, 64, 256) for n, k in (
        (1024, 1024), (4096, 1024), (1024, 4096))] +
    [(m, n, k, _Q4, "f32", True) for m in (17, 64, 256) for n, k in (
        (3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192))])


def zero_counts() -> None:
    """Every kernel's launch counter and K1's shape tally set to 0."""
    for k in KERNELS.values():
        k.launches = 0
    qm.SHAPES.clear()


def read_counts(path: str | None = None) -> dict:
    """Every kernel's launches since zero_counts; with `path`, K1's shape
    tally is kept as that main path's census."""
    if path is not None:
        K1_CENSUS[path] = dict(qm.SHAPES)
    return {n: k.launches for n, k in KERNELS.items()}


def whole_trace(fn, whole, what: str, iters: int = 20,
                warmup: int = 3) -> DeviceTime:
    """device_ms of fn(), taken again (twice at most) until `whole(dt)`
    says the trace holds the call's kernels: the profiler can lose some of
    a window's events, and a part of a call would read as the call."""
    for _ in range(3):
        dt = device_ms(fn, iters=iters, warmup=warmup)
        if whole(dt):
            return dt
        log(f"  the trace lost kernels of {what}; tracing again")
    raise RuntimeError(f"torch.profiler lost kernels of {what} three times")


def k1_device_ms(fn, iters: int = 20) -> float:
    """device_ms of a K1 call, whose trace must hold the matmul kernel (its
    conversion kernel alone would read as K1)."""
    return whole_trace(fn, lambda dt: dt.counts.get("qmm_kernel", 0) >= 1,
                       "K1", iters).ms


def queued_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """The device time of `iters` back-to-back fn() calls, over iters, from
    CUDA events: the calls are queued behind a spin kernel of ~10 ms, so
    that the device runs them without waiting for the host, and the events
    time the device alone (the gaps between kernels included). No profiler
    session: chip_smoke's hundreds of them in a row have lost a window's
    events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_inputs(gen, shape) -> tuple[list, torch.Tensor]:
    """A census shape's inputs: copies of a random weight that exceed the
    L2 cache together (at most 12), to take in turn, and x (M, K)."""
    m, n, k, qt, sd, packed = shape
    dtype = torch.bfloat16 if sd == "bf16" else torch.float32
    one = rand_quant(gen, n, k, qt, dtype, packed)
    nbytes = tensor_bytes((one.codes, one.scales))
    ws = [one] + [rand_quant(gen, n, k, qt, dtype, packed)
                  for _ in range(min(11, int(120e6 // nbytes)))]
    return ws, torch.randn((m, k), generator=gen, device=DEV)


def time_k1_census(paths=None) -> float:
    """K1 at every shape of the census, held against its plain version on
    the same inputs (within 1e-5 of the largest output, as check_k1) and
    timed by device time (queued_ms) beside its bound (k1_bound), its plain
    version and dequant + torch.matmul, timed alike, with the launches of
    each main path; weights taken in turn from copies that exceed the L2
    cache together. With `paths`, the shapes of those main paths that no
    other path has (phase 16's shards, after phase 14 took the rest).
    Returns the largest error."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 12)
    shapes = {s for p in (paths or K1_CENSUS) for s in K1_CENSUS[p]}
    if paths:
        shapes -= {s for p, c in K1_CENSUS.items() if p not in paths for s in c}
    shapes = sorted(shapes, key=lambda s: (s[4], s[0], s[1], s[2]))
    log(f"K1 census: {len(shapes)} shapes over {len(K1_CENSUS)} main paths, "
        f"{sum(s in K1_SHAPES for s in shapes)} of them in K1_SHAPES")
    log(f"K1 census shapes: {json.dumps([list(s) for s in shapes])}")
    errs = [0.0]
    for shape in shapes:
        m, n, k, qt, sd, packed = shape
        ws, x = k1_inputs(gen, shape)
        one = ws[0]
        errs.append(check_close(
            f"K1 {m}x{n}x{k} {QNAME[qt]} {sd}{' packed' if packed else ''}",
            qm.quant_matmul_cuda(x, one), qm.quant_matmul_plain(x, one), 1e-5,
            "same rounding, f32 sums in another order"))
        nbytes = tensor_bytes((one.codes, one.scales))
        it = iter(range(1 << 30))

        def nxt():
            return ws[next(it) % len(ws)]

        ms = queued_ms(lambda: qm.quant_matmul_cuda(x, nxt()))
        plain_ms = queued_ms(lambda: qm.quant_matmul_plain(x, nxt()), 3, 1)
        lib_ms = queued_ms(lambda: x @ nxt().dense().T, 3, 1)
        b_ms, b_by = k1_bound(m, n, k, one)
        per_path = {p: c[shape] for p, c in K1_CENSUS.items() if shape in c}
        log(f"  K1 {m}x{n}x{k} {QNAME[qt]} {sd}{' packed' if packed else ''}: "
            f"kernel {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s of weights), "
            f"plain {plain_ms:.4f}, dequant+matmul {lib_ms:.4f}, bound "
            f"{b_ms:.4f} ({b_by}); launches {per_path}")
        del ws
        torch.cuda.empty_cache()
    return max(errs)


def prefill_device(label, fn) -> None:
    """A prefill's (or encoder's) device time and K1's part of it (its
    conversion and matmul kernels), over 3 calls."""
    dt = device_ms(fn, iters=3, warmup=1)
    k1 = sum(t for n, t in dt.by_name.items() if "qmm" in n or "stage_x" in n)
    log(f"  {label}, device time: {dt.ms:.4f} ms a call, K1 {k1:.4f} ms of it "
        f"({dt.events:.0f} device events)")


K3_POS = (0, 1, 255, 256, 257, 1000)   # and ctx - 1: around the pages
GQA = ((24, 8), (16, 4))   # q / kv heads of 128: Orpheus-3B (n_rep 3), Dia (4)


def gqa_gen():
    """The GQA checks' own generator, so that they leave the inputs the
    later checks draw from the run's generator as they were."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 3)
    return gen


def sdpa(q, k, v, mask=None) -> torch.Tensor:
    """PyTorch's scaled_dot_product_attention on q (B, Hq, 1, D) and k/v
    (B, Hkv, T, D), GQA through enable_gqa: the attention's one-call
    yardstick, which the port never calls."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1])


def check_k3(gen) -> dict:
    log("K3 decode_attention (csrc/decode_attention.cu) vs decode_attention_plain:")
    heads, ctx, d, L = MINI["heads"], MINI["ctx"], 64, MINI["n_layers"]
    kc = torch.randn((L, heads, ctx, d), generator=gen, device=DEV).to(torch.bfloat16)
    vc = torch.randn((L, heads, ctx, d), generator=gen, device=DEV).to(torch.bfloat16)
    q = torch.randn((heads, d), generator=gen, device=DEV)
    why = "f32 softmax over the same values, sums in another order"
    errs = []
    for p in K3_POS + (ctx - 1,):
        pos = torch.tensor([p], dtype=torch.int32, device=DEV)
        errs.append(check_close(f"bf16 cache pos {p}",
                                da.decode_attention_cuda(q, kc[0], vc[0], pos),
                                da.decode_attention_plain(q, kc[0], vc[0], pos),
                                1e-5, why))
    # GQA at head size 128: one block reads a kv head's page for all its q
    # heads
    ggen = gqa_gen()
    for hq, hkv in GQA:
        kg, vg = (torch.randn((hkv, ctx, 128), generator=ggen, device=DEV)
                  .to(torch.bfloat16) for _ in range(2))
        qg = torch.randn((hq, 128), generator=ggen, device=DEV)
        for p in K3_POS + (ctx - 1,):
            pos = torch.tensor([p], dtype=torch.int32, device=DEV)
            errs.append(check_close(
                f"GQA {hq}/{hkv} heads of 128 (n_rep {hq // hkv}), bf16, pos {p}",
                da.decode_attention_cuda(qg, kg, vg, pos),
                da.decode_attention_plain(qg, kg, vg, pos), 1e-5, why))
    pos = torch.tensor([777], dtype=torch.int32, device=DEV)
    k32, v32 = kc[1, :4].float(), vc[1, :4].float()
    errs.append(check_close("f32 cache, GQA n_rep 4 pos 777",
                            da.decode_attention_cuda(q, k32, v32, pos),
                            da.decode_attention_plain(q, k32, v32, pos), 1e-5, why))
    ck = torch.randn((heads, MINI["enc_len"], d), generator=gen, device=DEV)
    cv = torch.randn((heads, MINI["enc_len"], d), generator=gen, device=DEV)
    tc = torch.tensor([MINI["enc_len"] - 1], dtype=torch.int32, device=DEV)
    errs.append(check_close("cross-attention f32 Tc 64",
                            da.decode_attention_cuda(q, ck, cv, tc),
                            da.decode_attention_plain(q, ck, cv, tc), 1e-5, why))
    # timed at pos 1000 by device time, layers taken in turn (each layer's
    # rows once per step, from device memory)
    p = 1000
    pos = torch.tensor([p], dtype=torch.int32, device=DEV)
    it = iter(range(1 << 30))

    def layer():
        return next(it) % L

    def kern():
        l = layer()
        return da.decode_attention_cuda(q, kc[l], vc[l], pos)

    def plain():
        l = layer()
        return da.decode_attention_plain(q, kc[l], vc[l], pos)

    qb = q.to(torch.bfloat16)[None, :, None, :]

    def lib():
        l = layer()
        return sdpa(qb, kc[l, None, :, :p + 1], vc[l, None, :, :p + 1])

    k3 = device_ms(kern)
    ms, plain_ms, lib_ms = k3.ms, device_ms(plain).ms, device_ms(lib).ms
    # one launch a call (the profiler may miss an event of the window, so
    # "one" is anything that rounds to it; two launches would read ~2)
    if not 0.5 < k3.events < 1.5:
        raise AssertionError(f"K3 at pos {p} ran {k3.events} device events a "
                             f"call, not one launch")
    nbytes = 2 * heads * (p + 1) * d * 2 + 2 * heads * d * 4
    b_ms, b_by = bound(nbytes, 4 * heads * (p + 1) * d, "f32")
    log(f"  16 heads, pos {p}, bf16, device time: kernel {ms:.4f} ms (one "
        f"launch, {cuda_ms(kern):.4f} ms with the host's launch path), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    for hq, hkv in GQA:
        kg, vg = (torch.randn((8, hkv, ctx, 128), generator=ggen, device=DEV)
                  .to(torch.bfloat16) for _ in range(2))
        qg = torch.randn((hq, 128), generator=ggen, device=DEV)
        qgb = qg.to(torch.bfloat16)[None, :, None, :]

        def g_kern(l):
            return da.decode_attention_cuda(qg, kg[l], vg[l], pos)

        def g_sdpa(l):
            return sdpa(qgb, kg[l, None, :, :p + 1], vg[l, None, :, :p + 1])

        g_ms = device_ms(lambda: g_kern(layer() % 8)).ms
        g_lib = device_ms(lambda: g_sdpa(layer() % 8)).ms
        g_bound = bound(2 * hkv * (p + 1) * 128 * 2 + 2 * hq * 128 * 4,
                        4 * hq * (p + 1) * 128, "f32")[0]
        log(f"  GQA {hq}/{hkv} heads of 128, pos {p}, bf16, device time: "
            f"kernel {g_ms:.4f} ms, sdpa {g_lib:.4f} ms, bound {g_bound:.4f} ms")
    return dict(name="decode_attention", route="cuda",
                source="tts_tpu_torch/csrc/decode_attention.cu",
                replaces="tts_tpu/ops/decode_attention.py:27",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def mini_mega(gen):
    """Random Parler-Mini MegaLayers on the card (Q4_0 packed, bf16 scales,
    tiled for the GEMV)."""
    return pm.prep_mega_layers(mini_layers(gen))


def mini_layers(gen):
    """Random Parler-Mini ParlerLayerWeights on the card, the source of
    mini_mega (gemv_ab.py preps them once per version of the package)."""
    from tts_tpu_torch.models.parler.model import ParlerLayerWeights
    L, H, F = MINI["n_layers"], MINI["hidden"], MINI["ffn"]
    heads, tc = MINI["heads"], MINI["enc_len"]

    def vec(scale=0.1, one=False):
        return torch.randn((L, H), generator=gen, device=DEV) * scale + (1.0 if one else 0.0)

    cross = [torch.randn((L, heads, tc, H // heads), generator=gen, device=DEV)
             for _ in range(2)]
    lw = ParlerLayerWeights(
        ln1_w=vec(one=True), ln1_b=vec(), q_w=stack_quant(gen, L, H, H),
        k_w=stack_quant(gen, L, H, H), v_w=stack_quant(gen, L, H, H),
        o_w=stack_quant(gen, L, H, H), lnc_w=vec(one=True), lnc_b=vec(),
        cq_w=stack_quant(gen, L, H, H), co_w=stack_quant(gen, L, H, H),
        cross_k=cross[0], cross_v=cross[1], ln2_w=vec(one=True), ln2_b=vec(),
        fc1=stack_quant(gen, L, F, H), fc2=stack_quant(gen, L, H, F))
    return lw


def layer_errors(one, n_layers, x, kc, vc, pos, kw, kernel, plain, label,
                 err, base, layers=None, alt=None, slots=False,
                 every_layer=False) -> list[float]:
    """Layer by layer at full width: each layer's kernels and its plain
    version take the same input (the kernels' output of the layer before)
    and fresh copies of that layer's cache, and each layer's update of x
    (x_out - x_in, the residual taken out so that it cannot hide the
    layer's work), k_new and v_new are compared, relative to the largest
    value. `one(l)` gives layer l's weights as a one-layer stack; `layers`
    (default all) are the layers compared, the others run the kernels only.
    How much a correct version moves is measured alongside: the plain
    version on the host's CPU against the plain version on the card, two
    correct versions whose sums run in other orders. Appends each compared
    layer's relative error and yardstick to `err` / `base` (defaultdicts of
    lists, by output name) and returns the absolute errors.

    With `alt` (the step's plain version summed in another order, on the
    card; or several such versions), a case's yardstick is the largest of
    the pairs' differences:
    a case shows a flipped bf16 rounding or none, so the pair of one case
    often shows none where the kernel shows one, and two pairs give the
    yardstick twice the chances to show one. With `every_layer` (and
    `alt`), every layer is a case: the layers outside `layers` are held
    against plain on the card with the other-order pair alone (the CPU
    pair, slow at full width, stays on `layers`), so that the kernel and
    the yardstick are sampled over the same many cases and the largest
    flip of each is seen. With `slots` (a batched step), each slot of the
    batch is a case of its own: 8 slots of 4 layers give the yardstick 64
    cases."""
    names = ("x_out - x_in", "k_new", "v_new")
    alts = () if alt is None else tuple(alt) if isinstance(alt, (list, tuple)) \
        else (alt,)
    abs_errs, xin = [], x
    for l in range(n_layers):
        w = one(l)

        def run(fn, dev):
            xl = xin.to(dev)
            kwd = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()}
            xo, k, v = fn(type(w)(*(t.to(dev) for t in w)), xl,
                          kc[l:l + 1].to(dev, copy=True),
                          vc[l:l + 1].to(dev, copy=True), pos.to(dev), **kwd)
            return [t.to(DEV) for t in (xo - xl, k, v)]

        got = run(kernel, DEV)
        cpu_pair = layers is None or l in layers
        if cpu_pair or (every_layer and alts):
            ref = run(plain, DEV)
            pairs = [run(a, DEV) for a in alts]
            if cpu_pair:
                with dequant_once():
                    pairs.append(run(plain, torch.device("cpu")))
            for i, nm in enumerate(names):
                if not slots:
                    cases = [(got[i], ref[i], [p[i] for p in pairs])]
                else:   # (x_out - x_in) is (B, H), k_new / v_new (1, B, KV)
                    def take(t, s, i=i):
                        return t[s] if i == 0 else t[:, s]
                    cases = [(take(got[i], s), take(ref[i], s),
                              [take(p[i], s) for p in pairs])
                             for s in range(x.shape[0])]
                for a, b, cs in cases:
                    if not bool(torch.isfinite(a).all()):
                        raise AssertionError(f"{label} layer {l} {nm} is not "
                                             f"finite")
                    scale = float(b.abs().max())
                    abs_errs.append(max_err(a, b))
                    err[nm].append(abs_errs[-1] / scale)
                    base[nm].append(max(max_err(c, b) for c in cs) / scale)
        xin = xin + got[0]
    return abs_errs


@contextlib.contextmanager
def dequant_once():
    """Within the block the plain llama and Dia steps untile and dequantize
    each weight once, and the plain Parler steps untile each once: their
    batched plain versions loop over the slots, which all read the same
    layer's weights, and that work is most of the CPU yardstick's time. The
    values are the same."""
    real, memo = lm.dequant, {}
    real_rows, rows_memo = lm.weight_rows, {}
    mods = (lm, lf, dm, pm)

    def dequant(codes, scales, qtype, dtype=torch.float32):
        key = (codes.data_ptr(), scales.data_ptr(), tuple(codes.shape), qtype,
               dtype)
        if key not in memo:   # the codes are kept, so their address is not reused
            memo[key] = codes, real(codes, scales, qtype, dtype)
        return memo[key][1]

    def weight_rows(codes_t, scales_t, kind, n, d=0):
        key = (codes_t.data_ptr(), scales_t.data_ptr(), tuple(codes_t.shape),
               kind, n, d)
        if key not in rows_memo:   # kept likewise
            rows_memo[key] = codes_t, real_rows(codes_t, scales_t, kind, n, d)
        return rows_memo[key][1]

    lm.dequant = dequant
    for m in mods:
        m.weight_rows = weight_rows
    try:
        yield
    finally:
        lm.dequant = real
        for m in mods:
            m.weight_rows = real_rows


def judge_layers(err, base, label, where) -> None:
    """One layer computes the same bf16 roundings with f32 sums in another
    order, so it agrees to f32 noise unless a rounding flips (a 2^-9 jump
    of one activation that moves the products it feeds). Over the compared
    cases, the kernel's largest and mean error must stay within 4x the
    yardstick pair's largest and mean difference, or 1e-5. (The mean, not
    the median: a layer either flips a rounding or agrees to f32 noise, and
    which of the two the median layer does changes with the last bit of
    the input.) A missing rounding or a lost K/V row moves every layer and
    fails the mean."""
    for nm in err:
        e, b = np.asarray(err[nm]), np.asarray(base[nm])
        tol_max = max(4 * float(b.max()), 1e-5)
        tol_mean = max(4 * float(b.mean()), 1e-5)
        ok = e.max() <= tol_max and e.mean() <= tol_mean
        log(f"  {where} ({e.size} cases), {nm}: relative error max "
            f"{e.max():.3e} (tol {tol_max:.3e}), mean {e.mean():.3e} (tol "
            f"{tol_mean:.3e}), median {np.median(e):.3e}; yardstick pair: max "
            f"{b.max():.3e}, mean {b.mean():.3e}, median {np.median(b):.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {where} {nm}: kernel disagrees "
                                 f"with its plain version")


def check_k2_layers(mega, x, kc, vc, pos, kw, kernel=None, plain=None,
                    label="K2", layers=None) -> list[float]:
    """`layer_errors` and `judge_layers` over the layers of a Parler step
    at one position (`layers`, default every one). `kernel` / `plain`
    default to K2's step and its plain version; K5's batched pair takes x
    (B, H), caches (L, B, ...) and pos (B,) the same way. Returns the
    absolute errors."""
    err, base = defaultdict(list), defaultdict(list)
    abs_errs = layer_errors(
        lambda l: pm.MegaLayers(*(t[l:l + 1] for t in mega[:-1]), mega.cross_pos),
        mega.norms.shape[0], x, kc, vc, pos, kw,
        kernel or pm.parler_megastep_cuda, plain or pm.parler_megastep_plain,
        label, err, base, layers=layers)
    judge_layers(err, base, label, f"pos {pos.tolist()} layers "
                 f"{'all' if layers is None else list(layers)} layer by layer, "
                 f"yardstick plain on the CPU vs plain on the card")
    return abs_errs


def check_k2(gen, mega, qtype) -> dict:
    log("K2 parler_megastep (csrc/parler_megastep.cu + K3) vs parler_megastep_plain:")
    L, H, heads, ctx = MINI["n_layers"], MINI["hidden"], MINI["heads"], MINI["ctx"]
    d = H // heads
    kc = (torch.randn((L, heads, ctx, d), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn((L, heads, ctx, d), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((1, H), generator=gen, device=DEV)
    kw = dict(qtype=qtype, use_cross=True, n_heads=heads)
    errs = []
    for p in (1, 1000):
        pos = torch.tensor([p], dtype=torch.int32, device=DEV)
        errs += check_k2_layers(mega, x, kc, vc, pos, kw)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got = pm.parler_megastep_cuda(mega, x, k1, v1, pos, **kw)
        ref = pm.parler_megastep_plain(mega, x, k2, v2, pos, **kw)
        # A sanity bound on the whole step. Over 24 random layers the step
        # is chaotic at the bf16 roundings: the plain version itself moves
        # this much when every element of x moves by one ulp (a flipped
        # activation rounding is a 2^-9 jump that later layers spread),
        # which is what another summation order does. The kernel must stay
        # within 4x that self-sensitivity; the layer-by-layer check above is
        # the tight one.
        ulp = torch.randint(0, 2, x.shape, generator=gen, device=DEV) * 2 - 1
        alt = pm.parler_megastep_plain(mega, x * (1 + ulp * 2 ** -23), kc.clone(),
                                       vc.clone(), pos, **kw)
        for nm, a, b, c in zip(("x_out", "k_new", "v_new"), got, ref, alt):
            sens = max_err(c, b)
            rel = max(4 * sens / float(b.abs().max()), 1e-4)   # 1e-4: one flip
            check_close(f"pos {p} 24-layer {nm}", a, b, rel,
                        f"4x the plain version's change under 1-ulp changes "
                        f"of x, {sens:.3e}")
        rows = torch.arange(ctx, device=DEV) != p
        if not (torch.equal(k1[:, :, rows], k2[:, :, rows]) and
                torch.equal(v1[:, :, rows], v2[:, :, rows])):
            raise AssertionError("K2 wrote cache rows other than pos")
        errs.append(check_close(f"pos {p} cache row k", k1[:, :, p].float(),
                                got[1].reshape(L, heads, d).to(torch.bfloat16).float(),
                                0.0, "the written row is k_new in bf16"))
    p = 1000
    pos = torch.tensor([p], dtype=torch.int32, device=DEV)
    ms = step_ms(lambda: pm.parler_megastep_cuda(mega, x, kc, vc, pos, **kw),
                 f"K2 step at pos {p}")
    plain_ms = device_ms(lambda: pm.parler_megastep_plain(
        mega, x, kc, vc, pos, **kw), iters=5, warmup=1).ms
    # weights, norms and cross K/V read once; self-attention K/V rows up to
    # pos read once; this token's k/v written; x in and out
    wbytes = tensor_bytes(mega[:11])
    kv_bytes = 2 * L * heads * (p + 1) * d * 2
    flops = 2 * L * (6 * H * H + 2 * H * MINI["ffn"])
    b_ms, b_by = bound(wbytes + kv_bytes + 2 * L * H * 2 + 2 * H * 4, flops, "bf16")
    launches = 8 * L
    log(f"  24 layers, pos {p}: kernels (device time) {ms:.4f} ms/step ({launches} launches: "
        f"{6 * L} gemv + {2 * L} attention), plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {wbytes / 1e6:.1f} MB weights + "
        f"{kv_bytes / 1e6:.1f} MB KV)")

    def steps():
        for _ in range(5):
            pm.parler_megastep_cuda(mega, x, kc, vc, pos, **kw)

    device_trace(steps, f"K2 step alone, pos {p}", 5)
    return dict(name="parler_megastep", route="cuda",
                source="tts_tpu_torch/csrc/parler_megastep.cu",
                replaces="tts_tpu/ops/parler_megastep.py:253",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


MIXED_POS = (0, 1, 255, 256, 257, 1000, 2047, 4095)   # around page edges
K5_LAYERS = (0, 4, 9, 14, 19, 23)   # compared with the CPU yardstick


def check_k4(gen) -> dict:
    log("K4 decode_attention batched (csrc/decode_attention.cu) vs "
        "decode_attention_batched_plain:")
    heads, ctx, d = MINI["heads"], MINI["ctx"], 64
    b = len(MIXED_POS)
    kc = torch.randn((b, heads, ctx, d), generator=gen, device=DEV).to(torch.bfloat16)
    vc = torch.randn((b, heads, ctx, d), generator=gen, device=DEV).to(torch.bfloat16)
    q = torch.randn((b, heads, d), generator=gen, device=DEV)
    pos = torch.tensor(MIXED_POS, dtype=torch.int32, device=DEV)
    why = "f32 softmax over the same values, sums in another order"
    got = da.decode_attention_batched_cuda(q, kc, vc, pos)
    errs = [check_close(f"B {b}, bf16 cache, pos {list(MIXED_POS)}", got,
                        da.decode_attention_batched_plain(q, kc, vc, pos), 1e-5, why)]
    # K3 is K4 with B = 1: every slot of the batch, and a one-slot batch,
    # equal K3 on that slot bit for bit (same page split, same merge order)
    for s in range(b):
        k3 = da.decode_attention_cuda(q[s], kc[s], vc[s], pos[s:s + 1])
        one = da.decode_attention_batched_cuda(q[s:s + 1], kc[s:s + 1],
                                               vc[s:s + 1], pos[s:s + 1])[0]
        if not (torch.equal(got[s], k3) and torch.equal(one, k3)):
            raise AssertionError(f"K4 slot {s} (pos {MIXED_POS[s]}) is not "
                                 f"K3 bit for bit")
    log(f"  every slot, and a B = 1 call on it, equals K3 bit for bit: ok")
    ggen = gqa_gen()
    for hq, hkv in GQA:   # slots at the same mixed positions, heads of 128
        kg, vg = (torch.randn((b, hkv, ctx, 128), generator=ggen, device=DEV)
                  .to(torch.bfloat16) for _ in range(2))
        qg = torch.randn((b, hq, 128), generator=ggen, device=DEV)
        got = da.decode_attention_batched_cuda(qg, kg, vg, pos)
        errs.append(check_close(
            f"B {b}, GQA {hq}/{hkv} heads of 128, bf16 cache, pos "
            f"{list(MIXED_POS)}", got,
            da.decode_attention_batched_plain(qg, kg, vg, pos), 1e-5, why))
        for s in range(b):
            if not torch.equal(got[s], da.decode_attention_cuda(
                    qg[s], kg[s], vg[s], pos[s:s + 1])):
                raise AssertionError(f"K4 GQA {hq}/{hkv} slot {s} (pos "
                                     f"{MIXED_POS[s]}) is not K3 bit for bit")
        log(f"  GQA {hq}/{hkv}: every slot equals K3 bit for bit: ok")
        del kg, vg
    ck = torch.randn((heads, MINI["enc_len"], d), generator=gen, device=DEV)
    cv = torch.randn((heads, MINI["enc_len"], d), generator=gen, device=DEV)
    tc = torch.tensor([MINI["enc_len"] - 1], dtype=torch.int32, device=DEV)
    errs.append(check_close("shared cross K/V, f32, Tc 64",
                            da.decode_attention_batched_cuda(q, ck, cv, tc),
                            da.decode_attention_batched_plain(q, ck, cv, tc),
                            1e-5, why))
    # timed at the mixed positions, with the engine's reused scratch
    out = torch.empty_like(q)
    scratch = da.attention_scratch(b, heads, ctx, d, DEV)
    ms = device_ms(lambda: da.decode_attention_batched_cuda(
        q, kc, vc, pos, out=out, scratch=scratch)).ms
    plain_ms = device_ms(lambda: da.decode_attention_batched_plain(
        q, kc, vc, pos), iters=10, warmup=2).ms
    qb = q.to(torch.bfloat16)[:, :, None, :]
    mask = (torch.arange(ctx, device=DEV)[None, :] <= pos[:, None])[:, None, None, :]
    lib_ms = device_ms(lambda: sdpa(qb, kc, vc, mask)).ms
    rows = sum(p + 1 for p in MIXED_POS)
    nbytes = 2 * heads * rows * d * 2 + 2 * b * heads * d * 4 + b * 4
    b_ms, b_by = bound(nbytes, 4 * heads * rows * d, "f32")
    log(f"  B {b}, 16 heads, mixed pos, bf16, device time: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, masked sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    return dict(name="decode_attention_batched", route="cuda",
                source="tts_tpu_torch/csrc/decode_attention.cu",
                replaces="tts_tpu/ops/decode_attention.py:148",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


# the generic path's head sizes checked, at each of its widths (256, 512;
# K3's limit of 1024 in tests/test_torch_port_cuda.py)
OTHER_HEADS = (1, 36, 80, 100, 192, 200, 256, 320, 512)
OTHER_TIMED = (80, 100, 192, 256, 320)   # timed beside SDPA (bf16)
OTHER_POS = (0, 255, 256, 257, 1000, 2047, 3000, 3583)   # its slots / positions


def check_other_head_sizes() -> None:
    """K3 and K4 at head sizes other than 64 / 128 (the generic path, which
    takes 1 to 1024): rows that are not whole 16-byte chunks, read element
    by element (1, 36 and 100 in bf16, 1 in f32), rows whose 16-byte chunks
    do not divide a warp (80, 100, 192) and rows wider than a warp's lanes
    (bf16 256 / 320 / 512, f32 192 and up), over bf16 and f32 caches of
    3584 rows with Orpheus's 24 / 8 heads. K3 at OTHER_POS and K4 with 8
    slots at those positions against the plain versions (1e-5 of the
    largest output), each K4 slot equal to K3 bit for bit, and the
    cross-attention entry over a 256-row bucket with a 768-row tail; then
    K3 and K4 timed (bf16, OTHER_TIMED) beside their plain versions, SDPA
    and their bounds. Its own generator, so that the later checks' inputs
    stay as they were."""
    log("K3 / K4 at other head sizes (csrc/decode_attention.cu's generic path) "
        "vs their plain versions, 24 / 8 heads, caches of 3584 rows:")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 11)
    hq, hkv, ctx, b = 24, 8, 3584, len(OTHER_POS)
    why = "f32 softmax over the same values, sums in another order"
    pos = torch.tensor(OTHER_POS, dtype=torch.int32, device=DEV)
    for d in OTHER_HEADS:
        for dt in (torch.bfloat16, torch.float32):
            kc, vc = (torch.randn((b, hkv, ctx, d), generator=gen, device=DEV)
                      .to(dt) for _ in range(2))
            q = torch.randn((b, hq, d), generator=gen, device=DEV)
            name = f"heads of {d}, {str(dt)[6:]} cache"
            for s, p in enumerate(OTHER_POS):
                check_close(f"K3 {name}, pos {p}",
                            da.decode_attention_cuda(q[s], kc[s], vc[s], pos[s:s + 1]),
                            da.decode_attention_plain(q[s], kc[s], vc[s], p),
                            1e-5, why)
            got = da.decode_attention_batched_cuda(q, kc, vc, pos)
            check_close(f"K4 {name}, 8 slots at {list(OTHER_POS)}", got,
                        da.decode_attention_batched_plain(q, kc, vc, pos), 1e-5, why)
            for s in range(b):
                if not torch.equal(got[s], da.decode_attention_cuda(
                        q[s], kc[s], vc[s], pos[s:s + 1])):
                    raise AssertionError(f"K4 {name} slot {s} is not K3 bit "
                                         f"for bit")
            ck, cv = kc[:2, :, :256], vc[:2, :, :256]
            vt = torch.randn((2, hkv, d), generator=gen, device=DEV) * 8
            qc = q[:2, :hkv].contiguous()
            check_close(f"cross-attention {name}, Sb 256, n_tail 768",
                        dm.cross_attention_cuda(qc, ck.contiguous(),
                                                cv.contiguous(), vt, 768),
                        dm.cross_attention_plain(qc, ck, cv, vt, 768), 1e-5, why)
            if dt == torch.bfloat16 and d in OTHER_TIMED:
                p = 1000
                p1 = torch.tensor([p], dtype=torch.int32, device=DEV)
                qb = q.to(torch.bfloat16)[:, :, None, :]
                k3 = device_ms(lambda: da.decode_attention_cuda(
                    q[4], kc[4], vc[4], p1)).ms
                k3_plain = cuda_ms(lambda: da.decode_attention_plain(
                    q[4], kc[4], vc[4], p), iters=10)
                k4_plain = cuda_ms(lambda: da.decode_attention_batched_plain(
                    q, kc, vc, pos), iters=3, warmup=1)
                k3_lib = device_ms(lambda: sdpa(qb[4:5], kc[4:5, :, :p + 1],
                                                vc[4:5, :, :p + 1])).ms
                k3_bound = bound(2 * hkv * (p + 1) * d * 2 + 2 * hq * d * 4,
                                 4 * hq * (p + 1) * d, "f32")[0]
                out = torch.empty_like(q)
                scratch = da.attention_scratch(b, hq, ctx, d, DEV)
                k4 = device_ms(lambda: da.decode_attention_batched_cuda(
                    q, kc, vc, pos, out=out, scratch=scratch)).ms
                mask = (torch.arange(ctx, device=DEV)[None, :] <=
                        pos[:, None])[:, None, None, :]
                k4_lib = device_ms(lambda: sdpa(qb, kc, vc, mask)).ms
                rows = sum(p + 1 for p in OTHER_POS)
                k4_bound = bound(2 * hkv * rows * d * 2 + 2 * b * hq * d * 4
                                 + b * 4, 4 * hq * rows * d, "f32")[0]
                log(f"  heads of {d}, bf16, device time: K3 at pos {p} "
                    f"{k3:.4f} ms (plain {k3_plain:.4f}, sdpa {k3_lib:.4f}, "
                    f"bound {k3_bound:.4f}); K4 at 8 slots {k4:.4f} ms "
                    f"(plain {k4_plain:.4f}, masked sdpa {k4_lib:.4f}, bound "
                    f"{k4_bound:.4f})")
            del kc, vc
    torch.cuda.empty_cache()


def check_k5(gen, mega, qtype) -> dict:
    log("K5 parler_megastep batched (csrc/parler_megastep.cu + K4) vs K2 and "
        "parler_megastep_batched_plain:")
    L, H, heads, ctx = MINI["n_layers"], MINI["hidden"], MINI["heads"], MINI["ctx"]
    d, b = H // heads, len(MIXED_POS)
    shape = (L, b, heads, ctx, d)
    kc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((b, H), generator=gen, device=DEV)
    pos = torch.tensor([min(p, ctx - 1) for p in MIXED_POS], dtype=torch.int32,
                       device=DEV)
    kw = dict(qtype=qtype, use_cross=True, n_heads=heads)
    # (a) slot s of K5 is a K2 step on slot s's state, bit for bit
    k5, v5 = kc.clone(), vc.clone()
    xo, kn, vn = pm.parler_megastep_batched_cuda(mega, x, k5, v5, pos, **kw)
    for s in range(b):
        k2, v2 = kc[:, s].clone(), vc[:, s].clone()
        xs, ks, vs = pm.parler_megastep_cuda(mega, x[s:s + 1], k2, v2,
                                             pos[s:s + 1], **kw)
        if not (torch.equal(xo[s:s + 1], xs) and torch.equal(kn[:, s], ks)
                and torch.equal(vn[:, s], vs) and torch.equal(k5[:, s], k2)
                and torch.equal(v5[:, s], v2)):
            raise AssertionError(f"K5 slot {s} (pos {int(pos[s])}) differs "
                                 f"from K2 on its state")
    del k5, v5
    log(f"  each slot's x_out, k_new, v_new and cache equal a K2 step on that "
        f"slot's state bit for bit (max_abs_err 0): ok")
    # (b) layer by layer against the plain version, K2's yardstick; the
    # CPU yardstick runs the plain step per slot, so K5_LAYERS of the 24
    errs = check_k2_layers(mega, x, kc, vc, pos, kw,
                           kernel=pm.parler_megastep_batched_cuda,
                           plain=pm.parler_megastep_batched_plain, label="K5",
                           layers=K5_LAYERS)
    scratch = pm.step_scratch(mega, b, heads, ctx, DEV)
    ms = step_ms(lambda: pm.parler_megastep_batched_cuda(
        mega, x, kc, vc, pos, scratch=scratch, **kw), f"K5 step at {b} slots")
    plain_ms = device_ms(lambda: pm.parler_megastep_batched_plain(
        mega, x, kc, vc, pos, **kw), iters=3, warmup=1).ms
    # weights, norms and cross K/V read once for all slots; each slot's
    # self-attention K/V rows up to its pos; this token's k/v written; x in
    # and out
    wbytes = tensor_bytes(mega[:11])
    kv_bytes = 2 * L * heads * sum(int(p) + 1 for p in pos) * d * 2
    flops = 2 * b * L * (6 * H * H + 2 * H * MINI["ffn"])
    b_ms, b_by = bound(wbytes + kv_bytes + 2 * b * L * H * 2 + 2 * b * H * 4,
                       flops, "bf16")
    log(f"  B {b}, 24 layers, mixed pos: kernels (device time) {ms:.4f} ms/step "
        f"({8 * L} launches), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {wbytes / 1e6:.1f} MB weights + {kv_bytes / 1e6:.1f} MB KV)")
    return dict(name="parler_megastep_batched", route="cuda",
                source="tts_tpu_torch/csrc/parler_megastep.cu",
                replaces="tts_tpu/ops/parler_megastep.py:406",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# each Parler GEMV launch: (name, layer norm before it, epilogue)
PARLER_GEMVS = (("qkv", 1, pm.EPI_QKV), ("o", 0, pm.EPI_RESIDUAL),
                ("cq", 1, pm.EPI_STORE), ("co", 0, pm.EPI_RESIDUAL),
                ("fc1", 1, pm.EPI_GELU), ("fc2", 0, pm.EPI_RESIDUAL))


def time_parler_gemv(mega, qtype) -> None:
    """The Parler GEMV's layer norm prologue against the plain version's on
    the card (how many staged values differ), then each Parler GEMV launch
    alone at Parler-Mini width, at 1, 8 and 16
    rows (K2's one, K5's 8 and 16 slots; rows at MIXED_POS for the qkv
    epilogue's cache write): device time per launch (torch.profiler, the
    GEMV kernel's spans alone), the launch's weight bytes (one layer's
    tiles of the projection) and the rate they stream at, beside their
    bound at 3.35 TB/s. Each launch takes the next layer's weights and
    follows a 64 MB write that evicts the 50 MB L2, so its weights come
    from device memory, as in a decode step (198 MB of weights)."""
    log("Parler GEMV (csrc/parler_gemv.cuh), one launch at a time, device "
        "time per launch:")
    L, H, F = pm.mega_dims(mega)
    heads, ctx = MINI["heads"], MINI["ctx"]
    d, th = H // heads, H // pm.TILE_ROWS
    g = torch.Generator(device=DEV)
    g.manual_seed(SEED + 9)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    vp, null = ctypes.c_void_p, ctypes.c_void_p(0)
    packed = int(lm.tiles_packed(mega.qkv_codes))
    stream = _build.stream_ptr(DEV)
    where = {"qkv": (mega.qkv_codes, mega.qkv_scales, 0, 3 * H, H, 0),
             "o": (mega.occ_codes, mega.occ_scales, 0, H, H, None),
             "cq": (mega.occ_codes, mega.occ_scales, th, H, H, 2),
             "co": (mega.occ_codes, mega.occ_scales, 2 * th, H, H, None),
             "fc1": (mega.fc1_codes, mega.fc1_scales, 0, F, H, 4),
             "fc2": (mega.fc2_codes, mega.fc2_scales, 0, H, F, None)}
    # the layer norm prologue against the plain version's on the card, on
    # identity Q4_0 weights (code 9, scale 1, on the diagonal), whose product
    # is the staged bf16 row itself
    eye = torch.full((H, H), 8, dtype=torch.uint8, device=DEV)
    eye[torch.arange(H), torch.arange(H)] = 9
    ec, es = pm.tile_projection(qm.QuantTensor(
        eye, torch.ones((H, H // 32), dtype=torch.bfloat16, device=DEV), quants.GGML_TYPE_Q4_0))
    differ = 0
    for _ in range(16):
        x = torch.randn((16, H), generator=g, device=DEV) * \
            torch.rand((16, 1), generator=g, device=DEV) * 4
        staged = torch.empty((16, H), device=DEV)
        pm.KERNEL_BATCHED(vp(x.data_ptr()), vp(_build.addr(mega.norms, 0, 0)),
                          vp(_build.addr(mega.norms, 0, 1)), 1, vp(ec.data_ptr()),
                          vp(es.data_ptr()), quants.GGML_TYPE_Q4_0, 1, 16, H, H, null,
                          vp(staged.data_ptr()), pm.EPI_STORE, null, null, null, 0, 0,
                          0, 0, 0, stream)
        want = torch.cat([pm.layer_norm(x[r:r + 1], mega.norms[0, 0], mega.norms[0, 1])
                          for r in range(16)]).to(torch.bfloat16).float()
        differ += int((staged != want).sum())
    log(f"  layer norm prologue: {differ} of {16 * 16 * H} staged values differ "
        f"from the plain version's layer_norm on the card, rounded to bf16")
    for b in (1, 8, 16):
        xs = {k: torch.randn((b, k), generator=g, device=DEV) for k in (H, F)}
        out = torch.zeros((b, 3 * H + F), device=DEV)
        kc, vc = (torch.zeros((b, heads, ctx, d), dtype=torch.bfloat16,
                              device=DEV) for _ in range(2))
        pos = torch.tensor((MIXED_POS * 2)[:b], dtype=torch.int32, device=DEV)
        for name, ln, epi in PARLER_GEMVS:
            codes, scales, t0, n, k, norm = where[name]
            nbytes = tensor_bytes([codes[0, t0:t0 + n // pm.TILE_ROWS],
                                   scales[0, t0:t0 + n // pm.TILE_ROWS]])
            turn = [0]

            def launch():
                l = turn[0] % L
                turn[0] += 1
                flush.zero_()
                lnw, lnb = ((vp(_build.addr(mega.norms, l, norm)),
                             vp(_build.addr(mega.norms, l, norm + 1)))
                            if ln else (null, null))
                pm.KERNEL_BATCHED(
                    vp(xs[k].data_ptr()), lnw, lnb, ln,
                    vp(_build.addr(codes, l, t0)), vp(_build.addr(scales, l, t0)),
                    qtype, packed, b, n, k, vp(out.data_ptr()), vp(out.data_ptr()),
                    epi, vp(kc.data_ptr()), vp(vc.data_ptr()), vp(pos.data_ptr()),
                    H, d, ctx, 1, heads * ctx * d, stream)

            us = whole_trace(launch, lambda dt: "gemv_kernel" in dt.by_name,
                             f"the {name} GEMV").by_name["gemv_kernel"] * 1e3
            log(f"  {b:2d} rows, {name:3s} ({n} x {k}): {us:.2f} us a launch, "
                f"{nbytes / 1e6:.3f} MB of weights, {nbytes / us / 1e6:.3f} "
                f"TB/s (bound {nbytes / HBM_BYTES_PER_S * 1e6:.2f} us)")
        del kc, vc
    del flush
    torch.cuda.empty_cache()


K12_POS = (0, 1, 255, 256, 1000, 4095)   # around K3's 256-row pages
K12_LAYERS = (0, 8, 16, 23)              # compared with the CPU yardstick


def k12_step(m, x, kc, vc, pos, *, qtype, use_cross, n_heads):
    """K12 on one stack of MegaLayers, in the layer check's calling form."""
    flat = pf.ParlerFlat(m, qtype, use_cross, n_heads, kc.shape[2])
    return pf.parler_flat_megastep_cuda(flat, x, kc, vc, pos, qtype=qtype,
                                        n_heads=n_heads)


def k12_plain(m, x, kc, vc, pos, *, qtype, use_cross, n_heads):
    flat = pf.ParlerFlat(m, qtype, use_cross, n_heads, kc.shape[2])
    return pf.parler_flat_megastep_plain(flat, x, kc, vc, pos, qtype=qtype,
                                         n_heads=n_heads)


def check_k12(gen, mega, qtype) -> dict:
    """K12 at Parler-Mini width: at each of K12_POS, with and without the
    cross block, equal to K2 on the same state bit for bit (x_out, k_new,
    v_new and both caches), and layer by layer against its plain version
    (K2's yardstick; K12_LAYERS of the 24 with the CPU yardstick, judged
    over the positions of each cross setting). Then timed beside K2 at
    pos 1000, with the plain version and the bound, and traced."""
    log("K12 parler_flat_megastep (csrc/parler_flat.cu, one cooperative "
        "launch) vs K2 and parler_flat_megastep_plain:")
    L, H, heads, ctx = MINI["n_layers"], MINI["hidden"], MINI["heads"], MINI["ctx"]
    d = H // heads
    kc = (torch.randn((L, heads, ctx, d), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn((L, heads, ctx, d), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((1, H), generator=gen, device=DEV)
    errs = []
    for use_cross in (True, False):
        kw = dict(qtype=qtype, use_cross=use_cross, n_heads=heads)
        flat = pf.prep_parler_flat(mega, qtype, ctx, use_cross=use_cross)
        err, base = defaultdict(list), defaultdict(list)
        for p in K12_POS:
            pos = torch.tensor([p], dtype=torch.int32, device=DEV)
            k12, v12, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            got = pf.parler_flat_megastep_cuda(flat, x, k12, v12, pos,
                                               qtype=qtype, n_heads=heads)
            two = pm.parler_megastep_cuda(mega, x, k2, v2, pos, **kw)
            if not (all(torch.equal(a, b) for a, b in zip(got, two))
                    and torch.equal(k12, k2) and torch.equal(v12, v2)):
                raise AssertionError(f"K12 differs from K2 at pos {p}, "
                                     f"use_cross {use_cross}")
            passed = pf.barriers_passed()
            if passed != pf.barriers(L, use_cross):
                raise AssertionError(f"K12 passed {passed} grid barriers at pos "
                                     f"{p}, use_cross {use_cross}; its plan "
                                     f"has {pf.barriers(L, use_cross)}")
            del k12, v12, k2, v2
            errs += layer_errors(
                lambda l: pm.MegaLayers(*(t[l:l + 1] for t in mega[:-1]),
                                        mega.cross_pos),
                L, x, kc, vc, pos, kw, k12_step, k12_plain, "K12", err, base,
                layers=K12_LAYERS)
        log(f"  use_cross {use_cross}: x_out, k_new, v_new and both caches "
            f"equal K2's bit for bit at pos {list(K12_POS)} (max_abs_err 0); "
            f"the kernel counted {pf.barriers(L, use_cross)} grid barriers a "
            f"step at each, its plan's ({6 if use_cross else 4} a layer): ok")
        judge_layers(err, base, "K12", f"use_cross {use_cross}, pos "
                     f"{list(K12_POS)}, layers {list(K12_LAYERS)} layer by "
                     f"layer, yardstick plain on the CPU vs plain on the card")
    p = 1000
    pos = torch.tensor([p], dtype=torch.int32, device=DEV)
    kw = dict(qtype=qtype, use_cross=True, n_heads=heads)
    flat = pf.prep_parler_flat(mega, qtype, ctx)

    def k12():
        pf.parler_flat_megastep_cuda(flat, x, kc, vc, pos, qtype=qtype,
                                     n_heads=heads)

    def k2():
        pm.parler_megastep_cuda(mega, x, kc, vc, pos, **kw)

    # in turns: K2, K12, K12, K2, host-inclusive and by device time
    times = [cuda_ms(fn, iters=20) for fn in (k2, k12, k12, k2)]
    dtimes = [device_ms(fn).ms for fn in (k2, k12, k12, k2)]
    ms = min(dtimes[1:3])
    plain_ms = device_ms(lambda: pf.parler_flat_megastep_plain(
        flat, x, kc, vc, pos, qtype=qtype, n_heads=heads), iters=5, warmup=1).ms
    # K2's bytes: weights, norms and cross K/V read once; K/V rows up to
    # pos read once; this token's k/v written; x in and out
    wbytes = tensor_bytes(mega[:11])
    kv_bytes = 2 * L * heads * (p + 1) * d * 2
    flops = 2 * L * (6 * H * H + 2 * H * MINI["ffn"])
    b_ms, b_by = bound(wbytes + kv_bytes + 2 * L * H * 2 + 2 * H * 4, flops, "bf16")
    log(f"  {L} layers, pos {p}: K12 {times[1]:.4f} / {times[2]:.4f} ms/step "
        f"(1 launch of {pf.launched_blocks} blocks of 256 threads; "
        f"{pf.barriers(L, True)} grid barriers), K2 {times[0]:.4f} / {times[3]:.4f} ms/step "
        f"({8 * L} launches), with the host's launch path; device time K12 "
        f"{dtimes[1]:.4f} / {dtimes[2]:.4f}, K2 {dtimes[0]:.4f} / "
        f"{dtimes[3]:.4f} ms/step, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {wbytes / 1e6:.1f} MB weights + {kv_bytes / 1e6:.1f} MB KV)")

    def steps(fn):
        def run():
            for _ in range(5):
                fn()
        return run

    device_trace(steps(k12), f"K12 step alone, pos {p}", 5)
    device_trace(steps(k2), f"K2 step alone, pos {p}", 5)
    return dict(name="parler_flat_megastep", route="cuda",
                source="tts_tpu_torch/csrc/parler_flat.cu",
                replaces="tts_tpu/ops/parler_flat.py:170",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------------------
# phase 2, Orpheus: K8 and K6 at Orpheus-3B width
# ---------------------------------------------------------------------------

# Orpheus-3B: canopylabs' config, a Llama-3.2-3B body (the JAX package's
# OrpheusConfig defaults). The cache has cache_ctx(OrpheusConfig()) rows.
ORPHEUS = dict(n_layers=28, hidden=3072, heads=24, kv_heads=8, ffn=8192,
               vocab=156940, ctx=3584, theta=500000.0)
# the persistent step against the launch sequence: around the 256-row
# pages, to the cache's last row
LLAMA_POS = (0, 255, 256, 511, 512, 1000, 3000, 3583)
LLAMA_LAYER_POS = (0, 256, 1000, 3000)   # layer by layer against the plain version
LLAMA_LAYERS = (0, 9, 18, 27)            # compared at each of them
VOICE = "zoe"


def llama3_rope_factors(d: int, theta: float) -> np.ndarray:
    """The llama3 RoPE frequency factors of Llama-3.2's rope_scaling (factor
    32, low 1, high 4, 8192 original positions), as a GGUF stores them in
    `orpheus.rope_frequencies`: inv_freq is divided by them."""
    factor, low, high, old_ctx = 32.0, 1.0, 4.0, 8192.0
    wavelen = 2 * np.pi * theta ** (np.arange(0, d, 2) / d)
    smooth = (old_ctx / wavelen - low) / (high - low)
    f = np.where(wavelen < old_ctx / high, 1.0,
                 np.where(wavelen > old_ctx / low, factor,
                          1.0 / ((1 - smooth) / factor + smooth)))
    return f.astype(np.float32)


def orpheus_source_weights(gen, qtype=quants.GGML_TYPE_Q4_0, n_layers=None):
    """Random Orpheus-3B weights on the card before the steps' prep: the
    stacked OrpheusLayer of `n_layers` (default all 28; Q4_0 packed or Q5_0
    / Q8_0 bytes, f32 scales), the head (156,940 rows, the same qtype), the
    final norm's weight, the head size and the step's keyword arguments
    (RoPE inverse frequencies with the llama3 factors)."""
    from tts_tpu_torch.models.orpheus.model import OrpheusLayer
    from tts_tpu_torch.ops.attention import rope_freqs
    L, H, F = n_layers or ORPHEUS["n_layers"], ORPHEUS["hidden"], ORPHEUS["ffn"]
    d = H // ORPHEUS["heads"]
    kvn, f32 = ORPHEUS["kv_heads"] * d, torch.float32

    def vec():
        return torch.randn((L, H), generator=gen, device=DEV) * 0.1 + 1.0

    def sq(n, k):
        return stack_quant(gen, L, n, k, f32, qtype)

    lw = OrpheusLayer(vec(), sq(H, H), sq(kvn, H), sq(kvn, H), sq(H, H), vec(),
                      sq(F, H), sq(F, H), sq(H, F))
    head = rand_quant(gen, ORPHEUS["vocab"], H, qtype, f32)
    if qtype == quants.GGML_TYPE_Q8_0:
        head = qm.QuantTensor(head.codes, head.scales / 16.0, qtype)
    inv = rope_freqs(d, ORPHEUS["theta"], torch.from_numpy(
        llama3_rope_factors(d, ORPHEUS["theta"])).to(DEV))
    return lw, head, vec()[0], d, dict(n_heads=ORPHEUS["heads"],
                                       n_kv=ORPHEUS["kv_heads"], inv_freq=inv)


def orpheus_kernel_weights(gen, qtype=quants.GGML_TYPE_Q4_0, n_layers=None):
    """Random Orpheus-3B weights on the card as the two steps take them: K8's
    layers (Q4_0 packed, or Q5_0 / Q8_0; qkv scales f32, the others bf16),
    K6's (every scale bf16, the head padded from 156,940 to 157,184 rows),
    both tiled for the GEMV, and the step's keyword arguments."""
    lw, head, out_norm, d, kw = orpheus_source_weights(gen, qtype, n_layers)
    mega, qtype = lm.prep_llama_mega(lw, d)
    del lw
    flat = lf.prep_llama_flat(mega, head, out_norm, qtype, kw["n_heads"],
                              kw["n_kv"])
    return mega, flat, dict(qtype=qtype, **kw)


def k6_layers(m, x, kc, vc, pos, *, qtype, n_heads, n_kv, inv_freq):
    """K6's layers alone (the persistent step without the head phase, on
    K6's counter)."""
    xo, kn, vn, _ = lm.persistent_step(lf.KERNEL, m, x, kc, vc, pos,
                                       qtype=qtype, n_heads=n_heads, n_kv=n_kv,
                                       inv_freq=inv_freq)
    return xo, kn, vn


def llama_sequence(w, x, kc, vc, pos, **kw):
    """K8's (K6's) function through the launch sequence (4 GEMV and 1 K4
    launch a layer, K6's head GEMV after them): K9's (K7's) at one slot, on
    views of the same caches (written in place)."""
    fn = (lf.llama_flat_megastep_batched_sequence if isinstance(w, lf.LlamaFlat)
          else lm.llama_megastep_batched_sequence)
    out, kn, vn = fn(w, x, kc[:, None], vc[:, None], pos, **kw)
    return out, kn[:, 0], vn[:, 0]


def llama_equal_sequence(steps, x, kc, vc, kw, label, positions) -> None:
    """At each position: the persistent K8 and K6 (one launch) and the
    launch sequence on copies of the same state give the same x_out (K6:
    logits), k_new, v_new and caches, bit for bit; raises otherwise."""
    for p in positions:
        pos = torch.tensor([p], dtype=torch.int32, device=DEV)
        for name, (w, kern) in steps.items():
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            got = kern(w, x, k1, v1, pos, **kw)
            seq = llama_sequence(w, x, k2, v2, pos, **kw)
            if not (all(torch.equal(a, b) for a, b in zip(got, seq))
                    and torch.equal(k1, k2) and torch.equal(v1, v2)):
                raise AssertionError(f"{name} differs from the launch "
                                     f"sequence: {label}, pos {p}")
            del k1, v1, k2, v2
    log(f"  {label}: {' and '.join(steps)} (one launch) give the launch "
        f"sequence's (K9 / K7 at one slot) x_out / logits, k_new, v_new and "
        f"both caches bit for bit at positions {list(positions)} "
        f"(max_abs_err 0): ok")


def persistent_ms(fn, prefix: str, label: str) -> float:
    """A persistent kernel's device time a launch, by the launches the
    trace recorded (torch.profiler drops some of a cooperative kernel's
    events), logged beside the events it recorded of the 20 calls."""
    for _ in range(3):
        dt = device_ms(fn)
        name = next((k for k in dt.by_name if k.startswith(prefix)), None)
        if name is not None:
            log(f"  {label}: {dt.counts[name] * 20:.0f} of 20 launches in the "
                f"trace, {dt.ms:.4f} ms of device time a call with its copies")
            return dt.by_name[name] / dt.counts[name]
    raise RuntimeError(f"torch.profiler recorded no {prefix} launch")


def k7_layers(m, x, kc, vc, pos, *, qtype, n_heads, n_kv, inv_freq):
    """K7's layer stack alone (the batched persistent step on K7's counter,
    no head)."""
    return lm.persistent_batched(lf.KERNEL_BATCHED, m, x, kc, vc, pos,
                                 qtype=qtype, n_heads=n_heads, n_kv=n_kv,
                                 inv_freq=inv_freq)


@contextlib.contextmanager
def other_order():
    """The plain llama and Dia steps summed in another order: every `_dqdot`
    product with the two halves of K summed apart, then added, and every
    RMS norm's mean of squares taken in float64: another correct version,
    whose difference from the plain version is a yardstick of the checks
    (the kernels' block sums change rstd in its last bits, and so flip the
    bf16 rounding of an activation now and then, as this does). (The Parler
    check moves x by one ulp instead; here the RMS norm's bf16 rounding of
    x absorbs such a move, so it would measure nothing.)"""
    def dqdot(x, codes, scales, qtype):
        w = qm.dequant(codes, scales, qtype).to(torch.bfloat16).float()
        xb, h = x.to(torch.bfloat16).float(), w.shape[-1] // 2
        return xb[:, :h] @ w[:, :h].T + xb[:, h:] @ w[:, h:].T

    def rms_norm(x, w, eps=lm.RMS_EPS):
        ms = x.double().square().mean(dim=-1, keepdim=True).float()
        return x * torch.rsqrt(ms + eps) * w

    mods = (lm, lf, dm)
    saved = [(m.dqdot, m.rms_norm) for m in mods]
    for m in mods:
        m.dqdot, m.rms_norm = dqdot, rms_norm
    try:
        yield
    finally:
        for m, (d, r) in zip(mods, saved):
            m.dqdot, m.rms_norm = d, r


@contextlib.contextmanager
def kernel_order():
    """The plain llama step with the RMS prologue's arithmetic that
    csrc/gemv.cuh documents for the kernels (the squares rounded to f32,
    summed in f64, rounded once to f32, times f32 1 / K, plus eps, rsqrt;
    then x * rstd * w) and the attention in float64: another correct
    version. The plain version's f32 mean parts from the kernels' rstd by
    an ulp now and then, which flips the bf16 rounding of a normed input
    (a jump of one k_new entry by ~3e-5 of the largest); this version
    flips where the kernels do, and its attention where the kernels' other
    order of sums may."""
    def rms_norm(x, w, eps=lm.RMS_EPS):
        ss = x.square().double().sum(dim=-1, keepdim=True).float()
        return x * torch.rsqrt(ss * (1.0 / x.shape[-1]) + eps) * w

    def attention(q, kv_k, kv_v, pos, scale=None):
        n_rep = q.shape[0] // kv_k.shape[0]
        kk = kv_k.double().repeat_interleave(n_rep, dim=0)
        vv = kv_v.double().repeat_interleave(n_rep, dim=0)
        logits = torch.einsum("hd,hkd->hk", q.double(), kk) * da._scale(q, scale)
        mask = torch.arange(kv_k.shape[1], device=q.device) <= pos
        probs = torch.softmax(logits.masked_fill(~mask[None, :], float("-inf")),
                              dim=-1)
        return torch.einsum("hk,hkd->hd", probs, vv).float()

    saved = lm.rms_norm, lm.decode_attention_plain
    lm.rms_norm, lm.decode_attention_plain = rms_norm, attention
    try:
        yield
    finally:
        lm.rms_norm, lm.decode_attention_plain = saved


def other_order_plain(*a, **k):
    """K8's plain version summed in another order (other_order)."""
    with other_order():
        return lm.llama_megastep_plain(*a, **k)


def kernel_order_plain(*a, **k):
    """K8's plain version in the kernels' RMS order (kernel_order)."""
    with kernel_order():
        return lm.llama_megastep_plain(*a, **k)


LLAMA_ALTS = (other_order_plain, kernel_order_plain)   # K8 / K6's yardstick pairs


def check_llama(gen, mega, flat, kw) -> list[dict]:
    """K8 and K6, the persistent llama step (one cooperative launch of
    csrc/llama_flat.cu; K6 with its head phase), at Orpheus-3B width: bit
    for bit against the launch sequence (K9 / K7 at one slot) at
    LLAMA_POS, Q4_0 on 28 layers and Q5_0 / Q8_0 on 2; layer by layer
    against the plain version at LLAMA_LAYER_POS, every layer a case (each
    case's yardstick the larger of layer_errors' two pairs, plain summed
    in another order and, at LLAMA_LAYERS, plain on the CPU, each against
    plain on the card), the whole step
    against the plain version summed in another order; then timed at pos 1000 beside the launch sequence in
    turns (sequence, step, step, sequence), with the grid it launched."""
    log("K8 llama_megastep and K6 llama_flat_megastep (csrc/llama_flat.cu: "
        "one cooperative launch a step) vs the launch sequence (K9 / K7 at one "
        "slot) and their plain versions, Orpheus-3B width, bf16 cache of "
        f"{ORPHEUS['ctx']} rows:")
    L, H, vocab = ORPHEUS["n_layers"], ORPHEUS["hidden"], ORPHEUS["vocab"]
    nkv, d, ctx = ORPHEUS["kv_heads"], H // ORPHEUS["heads"], ORPHEUS["ctx"]
    for line in ptxas_summary("llama_flat"):
        log(f"  ptxas llama_flat: {line}")
    shape = (L, nkv, ctx, d)
    kc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((1, H), generator=gen, device=DEV)
    llama_equal_sequence({"K8": (mega, lm.llama_megastep_cuda),
                          "K6": (flat, lf.llama_flat_megastep_cuda)},
                         x, kc, vc, kw, f"Q4_0, {L} layers", LLAMA_POS)
    for qt in (quants.GGML_TYPE_Q5_0, quants.GGML_TYPE_Q8_0):
        qmega, qflat, qkw = orpheus_kernel_weights(gen, qt, n_layers=2)
        llama_equal_sequence({"K8": (qmega, lm.llama_megastep_cuda),
                              "K6": (qflat, lf.llama_flat_megastep_cuda)},
                             x, kc[:2], vc[:2], qkw, f"qtype {qt}, 2 layers",
                             LLAMA_POS)
        del qmega, qflat
        torch.cuda.empty_cache()
    steps = {  # label: (weights, kernel step, plain step, layer kernel, names)
        "K8": (mega, lm.llama_megastep_cuda, lm.llama_megastep_plain,
               lm.llama_megastep_cuda, ("x_out", "k_new", "v_new")),
        "K6": (flat, lf.llama_flat_megastep_cuda, lf.llama_flat_megastep_plain,
               k6_layers, ("logits", "k_new", "v_new"))}
    errs = {label: [] for label in steps}
    pooled = {label: (defaultdict(list), defaultdict(list)) for label in steps}
    whole = {label: (defaultdict(list), defaultdict(list)) for label in steps}
    agree = 0
    for p in LLAMA_LAYER_POS:
        pos = torch.tensor([p], dtype=torch.int32, device=DEV)
        for label, (w, kern, plain, layer_kern, names) in steps.items():
            layers = w if label == "K8" else w.layers
            errs[label] += layer_errors(
                lambda l: lm.LlamaMegaLayers(*(t[l:l + 1] for t in layers)),
                L, x, kc, vc, pos, kw, layer_kern, lm.llama_megastep_plain,
                label, *pooled[label], layers=LLAMA_LAYERS, alt=LLAMA_ALTS,
                every_layer=True)
            # the whole step, pooled over the positions: 28 random layers
            # are chaotic at the bf16 roundings (as 24 Parler layers are,
            # K2), so it is held to the plain version summed in another
            # order, and K6's logits are reported
            got = kern(w, x, kc.clone(), vc.clone(), pos, **kw)
            ref = plain(w, x, kc.clone(), vc.clone(), pos, **kw)
            with other_order():
                alt = plain(w, x, kc.clone(), vc.clone(), pos, **kw)
            if label == "K6":
                if got[0][:, vocab:].any():
                    raise AssertionError("K6's padded logits are not 0")
                got, ref, alt = ([t[0][:, :vocab], t[1], t[2]]
                                 for t in (got, ref, alt))
                agree += int(got[0].argmax() == ref[0].argmax())
                log(f"  pos {p} K6 logits: max |kernel - plain| / max|logit| "
                    f"{max_err(got[0], ref[0]) / float(ref[0].abs().max()):.3e}")
            for nm, a, b, c in zip(names, got, ref, alt):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{label} pos {p} {nm} is not finite")
                scale = float(b.abs().max())
                whole[label][0][nm].append(max_err(a, b) / scale)
                whole[label][1][nm].append(max_err(c, b) / scale)
    log(f"  K6 logits argmax equal to the plain version's at "
        f"{agree}/{len(LLAMA_LAYER_POS)} positions (a near-tie among 156,940 "
        f"random logits may part them)")
    for label in steps:
        judge_layers(*pooled[label], label, f"{label} all {L} layers at "
                     f"positions {list(LLAMA_LAYER_POS)}, layer by layer, "
                     f"yardstick the largest of plain summed in another order, "
                     f"plain in the kernels' RMS order and (layers "
                     f"{list(LLAMA_LAYERS)}) plain on the CPU, vs plain on the "
                     f"card")
        judge_layers(*whole[label], label, f"{label} whole 28-layer step at "
                     f"positions {list(LLAMA_LAYER_POS)}, yardstick plain vs "
                     f"plain summed in another order")
    rows = []
    p = 1000
    pos = torch.tensor([p], dtype=torch.int32, device=DEV)
    kv_bytes = 2 * L * nkv * (p + 1) * d * 2   # rows 0..pos, bf16
    for label, (w, kern, plain, _, _) in steps.items():
        def step():
            return kern(w, x, kc, vc, pos, **kw)

        def seq():
            return llama_sequence(w, x, kc, vc, pos, **kw)

        # in turns: sequence, step, step, sequence; device and host time
        host = [cuda_ms(fn, iters=20) for fn in (seq, step, step, seq)]
        name = "llama_megastep" if label == "K8" else "llama_flat_megastep"
        dev_ms = [device_ms(seq).ms,
                  persistent_ms(step, "llama_flat_kernel", label),
                  persistent_ms(step, "llama_flat_kernel", label),
                  device_ms(seq).ms]
        ms = min(dev_ms[1:3])
        plain_ms = device_ms(lambda: plain(w, x, kc, vc, pos, **kw), iters=3,
                             warmup=1).ms
        if label == "K8":
            wts = list(w)
        else:
            wts = list(w.layers) + [w.head.codes, w.head.scales, w.out_norm]
        wbytes = tensor_bytes(wts)
        n_weights = sum(t.numel() for t in wts if t.dtype == torch.uint8) * 2
        out_bytes = (w.head.shape[0] * 4 if label == "K6" else H * 4) + \
            2 * L * nkv * d * 4
        b_ms, b_by = bound(wbytes + kv_bytes + H * 4 + out_bytes,
                           2 * n_weights, "bf16")
        head = label == "K6"
        layers = w.layers if head else w
        smem = lp.smem_bytes(H, ORPHEUS["ffn"], lm.tiles_packed(layers.qkv_codes),
                             layers.qkv_scales.dtype == torch.bfloat16)
        log(f"  {label} {L} layers{' + head' if head else ''}, pos {p}: step "
            f"{host[1]:.4f} / {host[2]:.4f} ms (1 launch of "
            f"{lp.launched_blocks} blocks, {lp.blocks_per_sm} an SM, "
            f"{smem} bytes of dynamic shared memory, {lp.barriers(L, head)} grid "
            f"barriers), launch sequence {host[0]:.4f} / {host[3]:.4f} ms "
            f"({4 * L + head} gemv + {L} K4 launches), with the host's launch "
            f"path; device time step {dev_ms[1]:.4f} / {dev_ms[2]:.4f}, "
            f"launch sequence {dev_ms[0]:.4f} / {dev_ms[3]:.4f} ms; plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{wbytes / 1e6:.1f} MB weights + {kv_bytes / 1e6:.1f} MB KV), "
            f"library none")
        if head:
            device_trace(lambda: [step() for _ in range(5)],
                         f"K6 step alone, pos {p}", 5)
            device_trace(lambda: [seq() for _ in range(5)],
                         f"K6's launch sequence alone, pos {p}", 5)
        rows.append(dict(
            name=name, route="cuda", source="tts_tpu_torch/csrc/llama_flat.cu",
            replaces="tts_tpu/ops/llama_megastep.py:124" if label == "K8"
            else "tts_tpu/ops/llama_flat.py:381",
            max_abs_err=max(errs[label]), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    # how the step grows with the rows it attends (28 attention phases):
    # K6 and its launch sequence at the cache's first and last row
    for p2 in (0, ctx - 1):
        pos2 = torch.tensor([p2], dtype=torch.int32, device=DEV)
        s_ms = persistent_ms(lambda: lf.llama_flat_megastep_cuda(
            flat, x, kc, vc, pos2, **kw), "llama_flat_kernel", f"K6 at pos {p2}")
        q_ms = device_ms(lambda: llama_sequence(flat, x, kc, vc, pos2, **kw)).ms
        log(f"  K6 at pos {p2}: step {s_ms:.4f} ms, launch sequence {q_ms:.4f} "
            f"ms a step (device time)")
    phases = lp.gemv_phases(H, ORPHEUS["ffn"], ORPHEUS["heads"], nkv,
                            flat.head.shape[0])
    log(f"  the step's phases a layer on {lp.launched_blocks} blocks: "
        + ", ".join(f"{ph.name} {ph.items} (tile, K range) items of "
                    f"{ph.stages} stages, "
                    f"{dfl.warps_with_items(ph, lp.launched_blocks)} warps busy"
                    for ph in phases)
        + f"; attention page items at pos 1000 / 3583: "
        f"{lp.attention_items(ORPHEUS['heads'], p, ctx, lp.launched_blocks)} / "
        f"{lp.attention_items(ORPHEUS['heads'], ctx - 1, ctx, lp.launched_blocks)}")
    del kc, vc
    torch.cuda.empty_cache()
    return rows


# slots of the batched Orpheus steps: both sides of K4's 256-row pages, one
# at pos 0; 16 slots spread over 0..3000 for the bit-identity repeat
LLAMA_SLOTS = (0, 255, 256, 257, 511, 1000, 2047, 3000)
LLAMA_SLOTS_16 = (0, 1, 255, 256, 257, 511, 512, 700, 1000, 1023, 1024, 1500,
                  2047, 2048, 2600, 3000)


def llama_slots_equal_single(mega, flat, kw, pos, layers_note) -> None:
    """Each slot of K9 (K7) equals K8 (K6) run alone on that slot's state,
    bit for bit: x_out (logits), k_new, v_new and the slot's cache."""
    L, H = mega.norms.shape[0], ORPHEUS["hidden"]
    nkv, d, ctx = ORPHEUS["kv_heads"], H // ORPHEUS["heads"], ORPHEUS["ctx"]
    b = pos.numel()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + b)
    shape = (L, b, nkv, ctx, d)
    kc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((b, H), generator=gen, device=DEV)
    pairs = (("K9", "K8", mega, lm.llama_megastep_batched_cuda,
              lm.llama_megastep_cuda),
             ("K7", "K6", flat, lf.llama_flat_megastep_batched_cuda,
              lf.llama_flat_megastep_cuda))
    for batched, single, w, kern_b, kern_1 in pairs:
        kb, vb = kc.clone(), vc.clone()
        got = kern_b(w, x, kb, vb, pos, **kw)
        for s in range(b):
            k1, v1 = kc[:, s].clone(), vc[:, s].clone()
            one = kern_1(w, x[s:s + 1], k1, v1, pos[s:s + 1], **kw)
            if not (torch.equal(got[0][s:s + 1], one[0])
                    and torch.equal(got[1][:, s], one[1])
                    and torch.equal(got[2][:, s], one[2])
                    and torch.equal(kb[:, s], k1) and torch.equal(vb[:, s], v1)):
                raise AssertionError(f"{batched} slot {s} (pos {int(pos[s])}) "
                                     f"differs from {single} on its state")
        del kb, vb
        log(f"  {batched} at {b} slots ({layers_note}), positions "
            f"{pos.tolist()}: each slot's outputs and cache equal {single} "
            f"on that slot's state bit for bit: ok")
    del kc, vc
    torch.cuda.empty_cache()


def batched_equal_sequence(mega, flat, kw, pos, layers_note) -> None:
    """K9 and K7 (the batched persistent step, one launch a group of at most
    R slots; K7's head GEMV after it) equal their launch sequences
    (layers_cuda, K7's head GEMV) bit for bit: x_out (logits), k_new, v_new
    and every cache; the counters show one K9 launch a group (K7: and its
    head), no K4."""
    L, H = mega.norms.shape[0], ORPHEUS["hidden"]
    nkv, d, ctx = ORPHEUS["kv_heads"], H // ORPHEUS["heads"], ORPHEUS["ctx"]
    b = pos.numel()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 100 + b)
    shape = (L, b, nkv, ctx, d)
    kc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((b, H), generator=gen, device=DEV)
    r = lp.max_rows(H, ORPHEUS["ffn"], lm.tiles_packed(mega.qkv_codes),
                    mega.qkv_scales.dtype == torch.bfloat16)
    groups = len(_build.slot_groups(b, r))
    heads = len(_build.slot_groups(b, lm.MAX_BATCH))
    for label, w, kern, seq, counter, want in (
            ("K9", mega, lm.llama_megastep_batched_cuda,
             lm.llama_megastep_batched_sequence, lm.KERNEL_BATCHED, groups),
            ("K7", flat, lf.llama_flat_megastep_batched_cuda,
             lf.llama_flat_megastep_batched_sequence, lf.KERNEL_BATCHED,
             groups + heads)):
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        torch.cuda.synchronize()
        before = (counter.launches, da.KERNEL_BATCHED.launches)
        got = kern(w, x, k1, v1, pos, **kw)
        torch.cuda.synchronize()
        n = (counter.launches - before[0], da.KERNEL_BATCHED.launches - before[1])
        ref = seq(w, x, k2, v2, pos, **kw)
        if not (all(torch.equal(a, c) for a, c in zip(got, ref))
                and torch.equal(k1, k2) and torch.equal(v1, v2)):
            raise AssertionError(f"{label} at {b} slots differs from its "
                                 f"launch sequence")
        if n != (want, 0):
            raise AssertionError(f"{label} at {b} slots: {n[0]} launches on "
                                 f"its counter and {n[1]} K4, expected "
                                 f"{want} and 0")
        del k1, v1, k2, v2
        log(f"  {label} at {b} slots ({layers_note}): {n[0]} launch"
            f"{'es' if n[0] > 1 else ''} on its counter ({groups} group"
            f"{'s' if groups > 1 else ''} of at most R = {r} rows, "
            f"{lp.launched_blocks} blocks, {lp.blocks_per_sm} an SM"
            f"{', and its head GEMV' if label == 'K7' else ''}), no K4; "
            f"x_out / logits, k_new, v_new and every cache equal the launch "
            f"sequence's (layers_cuda) bit for bit: ok")
    del kc, vc
    torch.cuda.empty_cache()


def batched_step_ms(fn, launches: int, label: str) -> float:
    """Device time of one batched step whose persistent launches
    (`launches` a call of llama_batched_kernel) torch.profiler may drop from
    a trace: their time per recorded launch times `launches`, plus the
    call's other device work (K7's head GEMV, the copies), from the same
    trace."""
    for _ in range(3):
        dt = device_ms(fn)
        name = next((k for k in dt.by_name
                     if k.startswith("llama_batched_kernel")), None)
        if name is not None:
            other = sum(v for k, v in dt.by_name.items() if k != name)
            per = dt.by_name[name] / dt.counts[name]
            log(f"  {label}: {dt.counts[name] * 20:.0f} of {20 * launches} "
                f"persistent launches in the trace, {per:.4f} ms a launch, "
                f"{other:.4f} ms of other device work a call")
            return launches * per + other
    raise RuntimeError("torch.profiler recorded no llama_batched_kernel launch")


def other_order_batched_plain(*a, **k):
    """K9's plain version summed in another order (other_order)."""
    with other_order():
        return lm.llama_megastep_batched_plain(*a, **k)


def k7_staging(flat, b: int, sms: int) -> tuple[int, int]:
    """(staging bytes, weight bytes) of one K7 step at b rows: the bytes the
    step's GEMV launches read from L2 to stage their f32 input rows
    (lm.gemv_staging_bytes: each cluster reads its rows once, twice under
    an RMS prologue), beside the weights they stream once."""
    layers = flat.layers
    L, H = layers.norms.shape[0], layers.norms.shape[2]
    F = layers.gate_up_codes.shape[1] * lm.GEMV_TILE_PAIRS
    kvn = layers.qkv_codes.shape[1] * 2 * lm.GEMV_TILE_PAIRS
    gemvs = [(kvn, H, True, False), (H, H, False, False), (F, H, True, True),
             (H, F, False, False)] * L + [(flat.head.shape[0], H, True, False)]
    staged = sum(lm.gemv_staging_bytes(b, n, k, rms=rms, silu=silu, sms=sms)
                 for n, k, rms, silu in gemvs)
    weights = tensor_bytes(list(layers) + [flat.head.codes, flat.head.scales])
    return staged, weights


def check_llama_batched(gen, mega, flat, kw) -> list[dict]:
    """K9 and K7 (the batched persistent step, csrc/llama_flat_batched.cu)
    at Orpheus-3B width, 8 slots at LLAMA_SLOTS: each slot bit for bit
    against K8 / K6 on its state (and at 16 slots, two groups, on the
    LLAMA_LAYERS stack), the step bit for bit against its launch sequence
    (layers_cuda) with one launch a group on the counters, layer by layer
    against the plain version (the yardstick of check_llama), K7's
    whole-step logits against the plain version's per slot, then timed
    beside the launch sequence in turns."""
    log("K9 llama_megastep_batched and K7 llama_flat_megastep_batched "
        "(csrc/llama_flat_batched.cu, one cooperative launch a group of slots; "
        "K7's head GEMV after it) vs K8 / K6, the launch sequence "
        "(csrc/llama_megastep.cu + K4) and their plain versions, "
        f"Orpheus-3B width, bf16 cache of {ORPHEUS['ctx']} rows, 8 slots at "
        f"positions {list(LLAMA_SLOTS)}:")
    L, H, vocab = ORPHEUS["n_layers"], ORPHEUS["hidden"], ORPHEUS["vocab"]
    nkv, d, ctx = ORPHEUS["kv_heads"], H // ORPHEUS["heads"], ORPHEUS["ctx"]
    b = len(LLAMA_SLOTS)
    pos = torch.tensor(LLAMA_SLOTS, dtype=torch.int32, device=DEV)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    staged, wbytes = k7_staging(flat, b, sms)
    ok = staged < wbytes
    log(f"  K7's launch sequence at {b} slots, reckoned L2 reads to stage the "
        f"GEMVs' input rows: {staged / 1e9:.3f} GB per batched step against "
        f"{wbytes / 1e9:.3f} GB of weights: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K7 stages more bytes than its weights")
    llama_slots_equal_single(mega, flat, kw, pos, "28 layers")
    batched_equal_sequence(mega, flat, kw, pos, "28 layers")
    sub = list(LLAMA_LAYERS)
    mega4 = lm.LlamaMegaLayers(*(t[sub] for t in mega))
    flat4 = lf.LlamaFlat(lm.LlamaMegaLayers(*(t[sub] for t in flat.layers)),
                         flat.head, flat.out_norm)
    pos16 = torch.tensor(LLAMA_SLOTS_16, dtype=torch.int32, device=DEV)
    llama_slots_equal_single(mega4, flat4, kw, pos16,
                             f"layers {list(LLAMA_LAYERS)}")
    batched_equal_sequence(mega4, flat4, kw, pos16, f"layers {list(LLAMA_LAYERS)}")
    del mega4, flat4
    shape = (L, b, nkv, ctx, d)
    kc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((b, H), generator=gen, device=DEV)
    steps = {  # label: (weights, kernel step, plain step, layer kernel)
        "K9": (mega, lm.llama_megastep_batched_cuda,
               lm.llama_megastep_batched_plain, lm.llama_megastep_batched_cuda),
        "K7": (flat, lf.llama_flat_megastep_batched_cuda,
               lf.llama_flat_megastep_batched_plain, k7_layers)}
    errs = {}
    for label, (w, kern, plain, layer_kern) in steps.items():
        layers = w if label == "K9" else w.layers
        err, base = defaultdict(list), defaultdict(list)
        errs[label] = layer_errors(
            lambda l: lm.LlamaMegaLayers(*(t[l:l + 1] for t in layers)),
            L, x, kc, vc, pos, kw, layer_kern, lm.llama_megastep_batched_plain,
            label, err, base, layers=LLAMA_LAYERS, alt=other_order_batched_plain,
            slots=True)
        judge_layers(err, base, label, f"{label} layers {list(LLAMA_LAYERS)} x "
                     f"8 slots, layer by layer, yardstick the larger of plain "
                     f"on the CPU and plain summed in another order vs plain on the "
                     f"card")
    # K7's whole step per slot: logits against the plain version's, with
    # the plain version summed in another order beside it. Every K7 slot is a K6 step
    # bit for bit (checked above), and K6's whole step is held to this
    # yardstick pooled over 7 positions in check_llama; 8 slots of a
    # 28-layer step chaotic at the bf16 roundings are too few cases for a
    # yardstick of their own (a flipped rounding in one slot moved k_new
    # by 3.0e-3 against the yardstick pair's 6.3e-4 in one run), so this
    # is a sanity bound: 1e-2 of the largest value, the CPU tests' bound
    # between these two functions.
    w = flat
    got = lf.llama_flat_megastep_batched_cuda(w, x, kc.clone(), vc.clone(), pos, **kw)
    ref = lf.llama_flat_megastep_batched_plain(w, x, kc.clone(), vc.clone(), pos, **kw)
    with other_order():
        alt = lf.llama_flat_megastep_batched_plain(w, x, kc.clone(), vc.clone(),
                                                   pos, **kw)
    if got[0][:, vocab:].any():
        raise AssertionError("K7's padded logits are not 0")
    err, base = defaultdict(list), defaultdict(list)
    agree, rels = 0, []
    for s in range(b):
        for nm, a, r, c in zip(("logits", "k_new", "v_new"),
                               (got[0][s, :vocab], got[1][:, s], got[2][:, s]),
                               (ref[0][s, :vocab], ref[1][:, s], ref[2][:, s]),
                               (alt[0][s, :vocab], alt[1][:, s], alt[2][:, s])):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"K7 slot {s} {nm} is not finite")
            scale = float(r.abs().max())
            err[nm].append(max_err(a, r) / scale)
            base[nm].append(max_err(c, r) / scale)
        rels.append(err["logits"][-1])
        agree += int(got[0][s, :vocab].argmax() == ref[0][s, :vocab].argmax())
    log(f"  K7 logits per slot, max |kernel - plain| / max|logit|: "
        f"{', '.join(f'{r:.3e}' for r in rels)}; argmax equal to the plain "
        f"version's in {agree}/{b} slots (a near-tie among 156,940 random "
        f"logits may part them)")
    for nm in err:
        e, yb = np.asarray(err[nm]), np.asarray(base[nm])
        ok = e.max() <= 1e-2
        log(f"  K7 whole 28-layer step, 8 slots, {nm}: relative error max "
            f"{e.max():.3e}, mean {e.mean():.3e} (sanity bound 1e-2); plain "
            f"vs plain summed in another order: max {yb.max():.3e}, mean "
            f"{yb.mean():.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K7 whole step {nm}: kernel disagrees with "
                                 f"its plain version")
    del got, ref, alt
    rows = []
    kv_bytes = 2 * L * nkv * sum(p + 1 for p in LLAMA_SLOTS) * d * 2
    scratch = lm.step_scratch(mega, b, ORPHEUS["heads"], ctx, DEV)
    seqs = {"K9": lm.llama_megastep_batched_sequence,
            "K7": lf.llama_flat_megastep_batched_sequence}
    for label, (w, kern, plain, _) in steps.items():
        def step():
            return kern(w, x, kc, vc, pos, **kw)

        def seq():
            return seqs[label](w, x, kc, vc, pos, scratch=scratch, **kw)

        # in turns: sequence, step, step, sequence; device and host time
        host = [cuda_ms(fn, iters=20) for fn in (seq, step, step, seq)]
        dev_ms = [device_ms(seq).ms,
                  batched_step_ms(step, 1, f"{label} step at {b} slots"),
                  batched_step_ms(step, 1, f"{label} step at {b} slots"),
                  device_ms(seq).ms]
        ms = min(dev_ms[1:3])
        log(f"  {label} at {b} slots: step {host[1]:.4f} / {host[2]:.4f} ms "
            f"(1 launch of {lp.launched_blocks} blocks, "
            f"{lp.barriers(L, False)} grid barriers"
            f"{', then the head GEMV' if label == 'K7' else ''}), launch "
            f"sequence {host[0]:.4f} / {host[3]:.4f} ms ({4 * L + (label == 'K7')} "
            f"gemv + {L} K4 launches), with the host's launch path; device "
            f"time step {dev_ms[1]:.4f} / {dev_ms[2]:.4f}, launch sequence "
            f"{dev_ms[0]:.4f} / {dev_ms[3]:.4f} ms")
        plain_ms = device_ms(lambda: plain(w, x, kc, vc, pos, **kw), iters=1,
                             warmup=0).ms
        if label == "K9":
            wts = list(w)
        else:
            wts = list(w.layers) + [w.head.codes, w.head.scales, w.out_norm]
        wbytes = tensor_bytes(wts)
        n_weights = sum(t.numel() for t in wts if t.dtype == torch.uint8) * 2
        out_bytes = b * ((w.head.shape[0] if label == "K7" else H) * 4 +
                         2 * L * nkv * d * 4)
        b_ms, b_by = bound(wbytes + kv_bytes + b * H * 4 + out_bytes,
                           2 * b * n_weights, "bf16")
        g, items = lp.batched_attention_items(ORPHEUS["heads"], LLAMA_SLOTS,
                                              ctx, lp.launched_blocks)
        log(f"  {label} 28 layers{' + head' if label == 'K7' else ''}, 8 slots "
            f"at {list(LLAMA_SLOTS)}: kernels (device time) {ms:.4f} ms per "
            f"batched step ({1 + (label == 'K7')} launch"
            f"{'es' if label == 'K7' else ''}; attention items a layer "
            f"{sum(items)}, {g} q heads a page block), plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; {wbytes / 1e6:.1f} MB weights + "
            f"{kv_bytes / 1e6:.1f} MB KV), library none")
        if label == "K7":
            device_trace(lambda: [kern(w, x, kc, vc, pos, **kw)
                                  for _ in range(5)], "K7 step alone, 8 slots", 5)
        rows.append(dict(
            name="llama_megastep_batched" if label == "K9"
            else "llama_flat_megastep_batched",
            route="cuda", source="tts_tpu_torch/csrc/llama_flat_batched.cu",
            replaces="tts_tpu/ops/llama_megastep.py:395" if label == "K9"
            else "tts_tpu/ops/llama_flat.py:381",
            max_abs_err=max(errs[label]), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del kc, vc
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the layer checks' yardstick against seeded defects
# ---------------------------------------------------------------------------

DEFECT_SEED = SEED + 17   # the phase's own draws: no earlier one moves
DEFECT_LAYERS = 2         # the first layers of the Orpheus-3B stack
DEFECT_POS = 1000


def defect_rounds_toward_zero(*a, **k):
    """K8's plain version with its prologues' normed x rounded toward zero
    (the low 16 bits cleared) instead of to nearest on its way to bf16."""
    real = lm.rms_norm

    def rms_norm(x, w, eps=lm.RMS_EPS):
        return (real(x, w, eps).view(torch.int32) & -65536).view(torch.float32)

    lm.rms_norm = rms_norm
    try:
        return lm.llama_megastep_plain(*a, **k)
    finally:
        lm.rms_norm = real


def defect_lost_k_row(*a, **k):
    """K8's plain version that never writes the new K row: the cache keeps
    its old row at pos, which the attention reads, and k_new comes back 0."""
    real, calls = lm._write_row, [0]

    def write_row(cache, p, rows, n_heads):
        calls[0] += 1
        if calls[0] % 2 == 0:   # each layer writes its K row, then its V row
            real(cache, p, rows, n_heads)

    lm._write_row = write_row
    try:
        xo, kn, vn = lm.llama_megastep_plain(*a, **k)
    finally:
        lm._write_row = real
    return xo, torch.zeros_like(kn), vn


def defect_slot0_position(w, x, kc, vc, pos, **kw):
    """K9's plain version reading slot 0's position for every slot (the
    batched TPU kernels' old fault)."""
    return lm.llama_megastep_batched_plain(
        w, x, kc, vc, pos[:1].expand(pos.shape[0]).contiguous(), **kw)


def check_yardstick_defects(mega, kw) -> None:
    """The llama layer checks' judge (layer_errors with its two-pair
    yardstick, then judge_layers) on three seeded defects in the place of
    the kernel, at Orpheus-3B width on the stack's first DEFECT_LAYERS
    layers: the normed x rounded toward zero and a lost K row on the
    single step at pos DEFECT_POS, slot 0's position read for every slot
    on the batched step at LLAMA_SLOTS. judge_layers must fail each one;
    its log line gives each output's error against its tolerance."""
    log("The llama layer checks' yardstick (the larger of plain on the CPU "
        "and plain summed in another order, each vs plain on the card) "
        f"against seeded defects, Orpheus-3B width, layers 0-{DEFECT_LAYERS - 1}:")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(DEFECT_SEED)
    H, nkv = ORPHEUS["hidden"], ORPHEUS["kv_heads"]
    d, ctx, b = H // ORPHEUS["heads"], ORPHEUS["ctx"], len(LLAMA_SLOTS)

    def one(l):
        return lm.LlamaMegaLayers(*(t[l:l + 1] for t in mega))

    def cache(*lead):
        return (torch.randn((DEFECT_LAYERS, *lead, nkv, ctx, d), generator=gen,
                            device=DEV) * 0.5).to(torch.bfloat16)

    single = (torch.randn((1, H), generator=gen, device=DEV), cache(), cache(),
              torch.tensor([DEFECT_POS], dtype=torch.int32, device=DEV))
    batched = (torch.randn((b, H), generator=gen, device=DEV), cache(b),
               cache(b), torch.tensor(LLAMA_SLOTS, dtype=torch.int32, device=DEV))
    cases = (("normed x rounded toward zero", defect_rounds_toward_zero, single,
              lm.llama_megastep_plain, LLAMA_ALTS, False),
             ("lost K row", defect_lost_k_row, single, lm.llama_megastep_plain,
              LLAMA_ALTS, False),
             ("slot 0's position for every slot", defect_slot0_position,
              batched, lm.llama_megastep_batched_plain,
              other_order_batched_plain, True))
    for name, defect, (x, kc, vc, pos), plain, alt, slots in cases:
        err, base = defaultdict(list), defaultdict(list)
        layer_errors(one, DEFECT_LAYERS, x, kc, vc, pos, kw, defect, plain,
                     name, err, base, alt=alt, slots=slots)
        try:
            judge_layers(err, base, "defect", name)
        except AssertionError as e:
            log(f"  caught: {e}")
            continue
        raise AssertionError(f"the layer check passed a seeded defect: {name}")
    del single, batched
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Parler GGUFs written with the port's writer
# ---------------------------------------------------------------------------

def rand_q4_raw(rng, n, k) -> bytes:
    """Random Q4_0 blocks: fp16 scales in [0.002, 0.006], random nibbles."""
    nb = n * k // 32
    blk = rng.integers(0, 256, (nb, 18), dtype=np.uint8)
    d = rng.uniform(0.002, 0.006, nb).astype(np.float16)
    blk[:, :2] = d.view(np.uint8).reshape(nb, 2)
    return blk.tobytes()


def dac_tensors(rng, dac_chans, n_q) -> dict:
    """A DAC decoder's tensors, named as under `audio_encoder.` (tts_tpu
    bench.py build_dac_44k shapes when dac_chans is the 44 kHz model's
    1536/768/384/192/96), latent 1024, n_q codebooks of dim 8, random from
    rng."""
    t = {}

    def f32(name, *shape, scale=0.02):
        t[name] = rng.standard_normal(shape, dtype=np.float32) * scale

    def alpha(name, ch):
        t[name] = np.abs(rng.standard_normal((1, ch, 1), dtype=np.float32)
                         * 0.05) + 0.5

    f32("initial.weight", dac_chans[0], 1024, 7, scale=0.05)
    f32("initial.bias", dac_chans[0], scale=0.05)
    for i, s in enumerate((8, 8, 4, 2)):
        cin, cout = dac_chans[i], dac_chans[i + 1]
        b = f"decoder_block.{i + 1}."
        alpha(b + "final.alpha", cin)
        f32(b + "final.weight", cin, cout, 2 * s, scale=0.05)
        f32(b + "final.bias", cout, scale=0.05)
        for j in range(3):
            ub = f"{b}residual_unit.{j}.res."
            for part, kk in (("initial", 7), ("final", 1)):
                alpha(ub + part + ".alpha", cout)
                f32(ub + part + ".weight", cout, cout, kk, scale=0.05)
                f32(ub + part + ".bias", cout, scale=0.05)
    alpha("final.alpha", dac_chans[-1])
    f32("final.weight", 1, dac_chans[-1], 7, scale=0.001)
    f32("final.bias", 1, scale=0.05)
    for i in range(n_q):
        b = f"quantizers.{i}."
        f32(b + "codebook.weight", 1024, 8, scale=0.05)
        f32(b + "out_proj.weight", 1024, 8, 1, scale=0.05)
        f32(b + "out_proj.bias", 1024, scale=0.05)
    return t


def add_dac(w, rng, dac_chans, n_q) -> None:
    """dac_tensors' decoder added to the GGUF writer w under `audio_encoder.`."""
    for name, arr in dac_tensors(rng, dac_chans, n_q).items():
        w.add_tensor("audio_encoder." + name, arr)


def write_parler(path, rng, *, n_layers, hidden, heads, ffn, n_out, vocab,
                 ctx, enc_len, max_generation, dac_chans):
    """A Q4_0 Parler GGUF as `tts_tpu.apps.quantize` leaves one (with
    quantized LM heads): block-quantized projections, audio embeddings and
    heads; F32 norms, prompt/positional embeddings, cross-attention K/V
    projections, text encoding and DAC decoder."""
    H = hidden
    w = GGUFWriter(path, "parler-tts")
    for key, v in (("parler-tts.decoder.hidden_size", H),
                   ("parler-tts.decoder.num_hidden_layers", n_layers),
                   ("parler-tts.decoder.attention.head_count", heads),
                   ("parler-tts.decoder.output_heads", n_out),
                   ("parler-tts.decoder.out_vocab_size", vocab),
                   ("parler-tts.decoder.audio_vocab_size", 1024),
                   ("parler-tts.decoder.max_generation", max_generation),
                   ("parler-tts.decoder.context_length", ctx),
                   ("parler-tts.decoder.encode_length", enc_len),
                   ("audio.bos_token_id", 1025), ("audio.eos_token_id", 1024),
                   ("tokenizer.ggml.unknown_token_id", 0),
                   ("tokenizer.ggml.eos_token_id", 1),
                   ("dac.up_sampling_factor", 512)):
        w.add_u32(key, v)
    w.add_str("tokenizer.ggml.model", "unigram")
    w.add_array("tokenizer.ggml.tokens", TOKENS)
    w.add_array("tokenizer.ggml.scores",
                np.asarray([-10.0] + [-1.0] * (len(TOKENS) - 1), np.float32))
    for i, (s, p) in enumerate(zip((8, 8, 4, 2), (4, 4, 2, 1))):
        w.add_u32(f"dac.dac_layer_stride_{i}", s)
        w.add_u32(f"dac.dac_layer_padding_{i}", p)
    Q4 = quants.GGML_TYPE_Q4_0

    def q4(name, n, k):
        w.add_raw_tensor("decoder." + name, (n, k), Q4, rand_q4_raw(rng, n, k))

    def f32(name, *shape, scale=0.02, one=False):
        a = rng.standard_normal(shape, dtype=np.float32) * scale + (1.0 if one else 0.0)
        w.add_tensor(name, a)

    for l in range(n_layers):
        b = f"layers.{l}."
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm",
                   "final_layer_norm"):
            f32(f"decoder.{b}{ln}.weight", H, one=True)
            f32(f"decoder.{b}{ln}.bias", H)
        for n in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                  "self_attn.out_proj", "encoder_attn.q_proj",
                  "encoder_attn.out_proj"):
            q4(f"{b}{n}.weight", H, H)
        for n in ("encoder_attn.k_proj", "encoder_attn.v_proj"):
            f32(f"decoder.{b}{n}.weight", H, H)
        q4(f"{b}fc1.weight", ffn, H)
        q4(f"{b}fc2.weight", H, ffn)
    f32("decoder.layer_norm.weight", H, one=True)
    f32("decoder.layer_norm.bias", H)
    f32("decoder.embed_prompts", len(TOKENS), H, scale=1.0)
    f32("decoder.positional_embed", ctx, H, scale=0.1)
    f32("decoder.text_encoding", enc_len, H, scale=1.0)
    for i in range(n_out):
        q4(f"embed_tokens.{i}.weight", 1090, H)
        q4(f"lm_heads.{i}.weight.head", vocab, H)
    add_dac(w, rng, dac_chans, n_out)
    w.write()


def prompt_len(text: str = PROMPT) -> int:
    from tts_tpu_torch.text import UnigramTokenizer
    tok = UnigramTokenizer({t: i for i, t in enumerate(TOKENS)}, 0,
                           [-10.0] + [-1.0] * (len(TOKENS) - 1), 1)
    return len(tok.tokenize(text)) + 1   # + EOS


# ---------------------------------------------------------------------------
# phase 3: a small model, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def check_small_reference(tmp, hidden=256, heads=4, name="parler-small.gguf",
                          n_steps=48, per_matmul=False) -> None:
    """A small Q4_0 Parler (written to tmp/name) decoded greedily on the CPU
    (plain versions); the card (kernels) follows the same token history
    (teacher forcing) and its logits must match at every step.
    Free-running greedy tokens are reported too, but not required to
    match: with 9 x 1088 random logits a near-tie flips on a last-bit
    difference, and the history then parts. The tolerance comes from the
    CPU's own sensitivity, measured alongside on a run whose positional
    embeddings moved by one ulp. The runners take K2's route, or with
    `per_matmul` (TTS_TPU_MEGAKERNEL=0, or heads that are not a multiple
    of 64) the per-matmul route, whose card steps must launch K1 and K3
    and no step kernel. On the default GGUF, the runtime switches follow
    (parler_switches)."""
    from tts_tpu_torch.models.parler import model as pmodel
    from tts_tpu_torch.models.registry import runner_from_file
    log(f"Reference: small Q4_0 Parler (L=2, H={hidden}, {heads} heads of "
        f"{hidden // heads}, {n_steps} steps, "
        f"{'per matmul' if per_matmul else 'K2'}), f32 caches, card kernels vs "
        f"CPU plain versions:")
    path = os.path.join(tmp, name)
    write_parler(path, np.random.default_rng(SEED + 1), n_layers=2,
                 hidden=hidden, heads=heads, ffn=1024, n_out=9, vocab=1088,
                 ctx=256, enc_len=16, max_generation=prompt_len() + 48,
                 dac_chans=(64, 32, 16, 8, 4))
    kw = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
              repetition_penalty=1.0)
    runners, states = [], []
    gen = torch.Generator().manual_seed(SEED)
    for dev, perturb in ((DEV, False), (torch.device("cpu"), False),
                         (torch.device("cpu"), True)):
        r = runner_from_file(path, device=dev)
        if (r.mega is None) != per_matmul:
            raise AssertionError("small model must take the "
                                 f"{'per-matmul' if per_matmul else 'megastep'} "
                                 f"path")
        if perturb:   # every positional embedding moved by one ulp, +-
            pe = r.weights.pos_embd
            pe.mul_(1 + (torch.randint(0, 2, pe.shape, generator=gen) * 2 - 1)
                    * 2 ** -23)
        cfg = r.cfg
        ids = r.tokenizer.tokenize(PROMPT) + [r.tokenizer.eos_token]
        shape = (cfg.n_layers, cfg.n_attn_heads, cfg.max_ctx_length, cfg.head_size)
        kk, vv = torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)
        pmodel.parler_prefill(cfg, r.weights, torch.tensor(ids, device=dev), kk, vv)
        runners.append(r)
        states.append(pmodel.init_state(cfg, len(ids), kk, vv))
    (rg, rc, rp), (sg, sc, sp) = runners, states
    worst, sens, first, agree, n = 0.0, 0.0, None, 0, 0
    zero_counts()
    with torch.no_grad():
        for _ in range(n_steps):
            lg, lc, lp = (pmodel.step_logits(r.cfg, r.weights, s, use_cross=True,
                                             mega=r.mega)
                          for r, s in zip(runners, (sg, sc, sp)))
            lg = lg.cpu()
            scale = float(lc.abs().max())
            worst = max(worst, max_err(lg, lc) / scale)
            sens = max(sens, max_err(lp, lc) / scale)
            first = worst if first is None else first
            agree += int((lg.argmax(-1) == lc.argmax(-1)).sum())
            n += lc.shape[0]
            sc = pmodel.advance(rc.cfg, sc, lc, None, **kw)
            sg = pmodel.advance(rg.cfg, sg, lg.to(DEV), None, **kw)
            sp = pmodel.advance(rp.cfg, sp, lp, None, **kw)
            # the card and the perturbed run follow the CPU's history
            sg = sg._replace(tokens_in=sc.tokens_in.to(DEV),
                             eos_seen=sc.eos_seen.to(DEV))
            sp = sp._replace(tokens_in=sc.tokens_in, eos_seen=sc.eos_seen)
    # A last-bit difference can flip one bf16 rounding of an activation (a
    # 2^-9 jump); the CPU's own logits move by `sens` when its inputs move
    # by one ulp. The card must stay within 4x that, or 1e-3.
    tol = max(4 * sens, 1e-3)
    launched = route_counts(("quant_matmul", "decode_attention")
                            if per_matmul else ("parler_megastep",
                                                "decode_attention"))
    log(f"  teacher-forced logits, max |card - cpu| / max|logit|: {worst:.3e} "
        f"(step 0: {first:.3e}); the CPU's own change under 1-ulp input "
        f"changes: {sens:.3e}; tol {tol:.3e}; argmax agreement {agree}/{n}; "
        f"launches {launched}")
    if worst > tol:
        raise AssertionError("small-model logits differ between card and CPU")
    steps = int(sc.step)
    codes = pmodel.adjust_output_tokens(sc.out_tokens.numpy(), steps, rc.cfg)
    wa, wb = (r.dac.decode(codes) for r in (rg, rc))
    err = float(np.abs(wa - wb).max()) if codes.shape[0] else 0.0
    log(f"  {codes.shape[0]} frames vocoded on both: waveform max_abs_err "
        f"{err:.3e} (tol 1e-3: f32 convolutions, TF32 off, other sum order)")
    if wa.shape != (codes.shape[0] * 512,) or wa.shape != wb.shape or err > 1e-3:
        raise AssertionError("small-model waveform differs between card and CPU")
    if name == "parler-small.gguf" and not per_matmul:
        parler_switches(tmp, path)


# ---------------------------------------------------------------------------
# the JAX package's runtime switches on the card (phases 3, 6 and 10)
# ---------------------------------------------------------------------------

SWITCH_STEPS = 24   # greedy steps (tokens) of the switch checks' generations
# the kernels a route must not launch: every step kernel (K2, K5-K12)
STEP_KERNELS = ("parler_megastep", "parler_megastep_batched",
                "parler_flat_megastep", "llama_flat_megastep", "llama_megastep",
                "llama_flat_megastep_batched", "llama_megastep_batched",
                "dia_megastep", "dia_megastep_batched")


@contextlib.contextmanager
def env_set(name: str, value: str):
    """os.environ[name] = value inside the block, restored after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def route_counts(must, must_not=()) -> dict:
    """The launches since zero_counts of the kernels that launched: each of
    `must` must have launched and none of `must_not`."""
    torch.cuda.synchronize()
    launched = {n: c for n, c in read_counts().items() if c}
    missing = [n for n in must if not launched.get(n)]
    stray = [n for n in must_not if launched.get(n)]
    if missing or stray:
        raise AssertionError(f"route: {missing} not launched, {stray} launched "
                             f"({launched})")
    return launched


def want_f32(seen, label) -> None:
    """`seen`: the dtypes a model module's kv_cache_dtype gave (recording)."""
    if not seen or any(dt != torch.float32 for dt in seen):
        raise AssertionError(f"{label}: caches {seen}, not float32")


def parler_switches(tmp, path) -> None:
    """The small Parler (K2's route by default) under the JAX package's
    switches, on the card. TTS_TPU_KV_DTYPE=float32: the runner's caches
    are float32, and its greedy codes on K2's route equal those on K12's
    (K12 = K2 bit for bit) and the engine's (K5, its state float32: each
    slot = K2). TTS_TPU_MEGAKERNEL=0: the gates give the per-matmul route;
    the runner teacher-forced against the CPU (check_small_reference, K1 and
    K3 on the card, no step kernel) and the engine's codes equal to the
    runner's (K1 and K4, no step kernel)."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.parler import model as pmodel
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.batched_parler import BatchedParlerEngine
    greedy = GenerationConfig(sample=False)
    same = (lambda a, b: a.shape == b.shape and np.array_equal(a, b))

    def runner():
        r = runner_from_file(path)
        prompts = serving_prompts(r.tokenizer, n=2, lo=3, hi=20)
        lens = [len(r.tokenizer.tokenize(p)) + 1 for p in prompts]
        r.cfg = dataclasses.replace(r.cfg, max_generation_size=max(lens) +
                                    SWITCH_STEPS)
        return r, prompts

    log("Switches, small Parler: TTS_TPU_KV_DTYPE=float32")
    with env_set("TTS_TPU_KV_DTYPE", "float32"):
        r, prompts = runner()
        zero_counts()
        with recording(pmodel, "kv_cache_dtype") as seen:
            want = {p: r.generate_codes(p, greedy) for p in prompts}
        want_f32(seen, "Parler runner")
        k2 = route_counts(("parler_megastep", "decode_attention"),
                          ("parler_flat_megastep",))
        r.mega = pmodel.maybe_prep_parler_flat(r.cfg, r.weights)
        zero_counts()
        for p in prompts:
            if not same(r.generate_codes(p, greedy), want[p]):
                raise AssertionError("Parler f32 caches: the K12 route's codes "
                                     "differ from K2's")
        k12 = route_counts(("parler_flat_megastep",), ("parler_megastep",))
        log(f"  runner, f32 caches: K2 route {k2}, K12 route {k12}, greedy "
            f"codes equal")
        eng = BatchedParlerEngine(r.cfg, r.weights, r.tokenizer, n_slots=2,
                                  chunk=32)
        if eng.state.kv_k.dtype != torch.float32:
            raise AssertionError("Parler engine: caches not float32")
        engine_parity("Parler f32 caches, K5", eng, prompts, want.get, same)
    log("Switches, small Parler: TTS_TPU_MEGAKERNEL=0")
    with env_set("TTS_TPU_MEGAKERNEL", "0"):
        check_small_reference(tmp, name="parler-small-pm.gguf", n_steps=12,
                              per_matmul=True)
        r, prompts = runner()
        zero_counts()
        want = {p: r.generate_codes(p, greedy) for p in prompts}
        one = route_counts(("quant_matmul", "decode_attention"), STEP_KERNELS)
        eng = BatchedParlerEngine(r.cfg, r.weights, r.tokenizer, n_slots=2,
                                  chunk=32)
        if r.mega is not None or eng.mega is not None:
            raise AssertionError("TTS_TPU_MEGAKERNEL=0 left a fused route")
        zero_counts()
        engine_parity("Parler per matmul, K4", eng, prompts, want.get, same)
        many = route_counts(("quant_matmul", "decode_attention_batched"),
                            STEP_KERNELS)
        log(f"  runner {one}, engine {many}")


# ---------------------------------------------------------------------------
# phase 4: the main path at Parler-Mini width
# ---------------------------------------------------------------------------

KERNELS = {"quant_matmul": qm.KERNEL, "parler_megastep": pm.KERNEL,
           "decode_attention": da.KERNEL,
           "decode_attention_batched": da.KERNEL_BATCHED,
           "parler_megastep_batched": pm.KERNEL_BATCHED,
           "llama_flat_megastep": lf.KERNEL, "llama_megastep": lm.KERNEL,
           "llama_flat_megastep_batched": lf.KERNEL_BATCHED,
           "llama_megastep_batched": lm.KERNEL_BATCHED,
           "dia_megastep": dm.KERNEL, "dia_cross_attention": dm.CROSS,
           "dia_megastep_batched": dm.KERNEL_BATCHED,
           "dia_cross_attention_batched": dm.CROSS_BATCHED,
           "parler_flat_megastep": pf.KERNEL, "quantize": oq.KERNEL}
SINGLE_PATH = ("quant_matmul", "parler_megastep", "decode_attention")
SERVING_PATH = ("quant_matmul", "decode_attention_batched",
                "parler_megastep_batched")


@contextlib.contextmanager
def k12_route():
    """Every ParlerRunner built inside takes the K12 route: right after its
    own __init__ its `mega` becomes `maybe_prep_parler_flat` of its weights,
    the port of what tests/test_parler_flat.py does to the JAX runner (the
    CLI has no flag for the route, as the JAX CLI has none)."""
    from tts_tpu_torch.models.parler import model as pmodel
    init = pmodel.ParlerRunner.__init__

    def take_k12(self, *a, **k):
        init(self, *a, **k)
        self.mega = pmodel.maybe_prep_parler_flat(self.cfg, self.weights)
        if not isinstance(self.mega, pf.ParlerFlat):
            raise AssertionError("the model does not take the K12 route")

    pmodel.ParlerRunner.__init__ = take_k12
    try:
        yield
    finally:
        pmodel.ParlerRunner.__init__ = init


def cli_wav(path, wav, label) -> tuple[dict, np.ndarray]:
    """The port's CLI on `path` (sampled, top-k 50, seed SEED), every
    kernel's counter set to 0 just before and read just after (K1's census
    kept under `label`); the WAV must be a valid waveform. Returns
    (launches, audio)."""
    from tts_tpu_torch.apps import cli
    from tts_tpu_torch.audio.wav import read_audio_file
    zero_counts()
    rc = cli.main(["-mp", path, "-p", PROMPT, "-sp", wav, "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches = read_counts(label)
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    audio, rate = read_audio_file(wav)
    log(f"  CLI wrote {wav}: {audio.size} samples at {rate} Hz; launches {launches}")
    if rate != 44100 or audio.size == 0 or audio.size % 512 or \
            not np.all(np.isfinite(audio)) or np.abs(audio).max() > 1.0:
        raise AssertionError("CLI output is not a valid waveform")
    return launches, audio


def timed_route(r, mega, label) -> dict:
    """The Parler path stage by stage, synchronized, with `mega` as the
    runner's decode route: prefill, DECODE_STEPS sampled decode steps (top-k
    50, seed SEED), delay undo, vocode. Returns the stage times, launches
    per decode step and audio-s per wall-s."""
    from tts_tpu_torch.common import kv_cache_dtype
    from tts_tpu_torch.models.parler import model as pmodel
    cfg = r.cfg
    ids = r.tokenizer.tokenize(PROMPT) + [r.tokenizer.eos_token]
    tokens = torch.tensor(ids, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    shape = (cfg.n_layers, cfg.n_attn_heads, cfg.max_ctx_length, cfg.head_size)
    kk = torch.zeros(shape, dtype=kv_cache_dtype(DEV), device=DEV)
    vv = torch.zeros_like(kk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pmodel.parler_prefill(cfg, r.weights, tokens, kk, vv)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = {n: k.launches for n, k in KERNELS.items()}
    out, steps = pmodel.generate_tokens_chunked(
        cfg, r.weights, len(ids), kk, vv, gen, use_cross=True, do_sample=True,
        temperature=1.0, top_k=50, top_p=1.0, repetition_penalty=1.0,
        mega=mega)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    per_step = {n: (k.launches - before[n]) / steps for n, k in KERNELS.items()
                if k.launches != before[n]}
    codes = pmodel.adjust_output_tokens(out.cpu().numpy(), steps, cfg)
    t3 = time.perf_counter()
    wav_np = r.dac.decode(codes)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    audio_s = wav_np.size / 44100.0
    stats = dict(route=label, prefill_ms=(t1 - t0) * 1e3, decode_steps=steps,
                 decode_ms_per_step=(t2 - t1) * 1e3 / steps,
                 vocode_ms=(t4 - t3) * 1e3, frames=int(codes.shape[0]),
                 audio_s=audio_s,
                 audio_s_per_wall_s=audio_s / (t4 - t0),
                 decode_audio_s_per_wall_s=steps * 512 / 44100.0 / (t2 - t1),
                 launches_per_step=per_step)
    log(f"  timed, {label}: {json.dumps(stats)}")
    if steps != DECODE_STEPS or wav_np.size != codes.shape[0] * 512 or \
            not np.all(np.isfinite(wav_np)):
        raise AssertionError("timed run produced the wrong shape")
    return stats


def trace_route(r, mega, label) -> None:
    """A steady window of 32 sampled decode steps on the route `mega`, from
    the prompt's end, under the device trace."""
    from tts_tpu_torch.common import kv_cache_dtype
    from tts_tpu_torch.models.parler import model as pmodel
    cfg = r.cfg
    ids = r.tokenizer.tokenize(PROMPT) + [r.tokenizer.eos_token]
    shape = (cfg.n_layers, cfg.n_attn_heads, cfg.max_ctx_length, cfg.head_size)
    kk = torch.zeros(shape, dtype=kv_cache_dtype(DEV), device=DEV)
    vv = torch.zeros_like(kk)
    pmodel.parler_prefill(cfg, r.weights, torch.tensor(ids, device=DEV), kk, vv)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    st = pmodel.init_state(cfg, len(ids), kk, vv)
    st = device_trace(lambda: pmodel.decode_chunk(
        cfg, r.weights, st, 32, gen, use_cross=True, do_sample=True,
        temperature=1.0, top_k=50, top_p=1.0, repetition_penalty=1.0,
        mega=mega), f"main-path decode, {label}", 32)
    toks = st.out_tokens[:min(32, DECODE_STEPS)]
    if int(st.step) != toks.shape[0] or bool((toks < 0).any()) or \
            bool((toks >= cfg.output_vocab_size).any()):
        raise AssertionError("traced decode window produced wrong tokens")


def greedy_out(r, mega) -> tuple[np.ndarray, int]:
    """DECODE_STEPS greedy decode steps on the route `mega` from the
    prompt: the raw (max_gen, 9) tokens and the step count."""
    from tts_tpu_torch.common import kv_cache_dtype
    from tts_tpu_torch.models.parler import model as pmodel
    cfg = r.cfg
    ids = r.tokenizer.tokenize(PROMPT) + [r.tokenizer.eos_token]
    shape = (cfg.n_layers, cfg.n_attn_heads, cfg.max_ctx_length, cfg.head_size)
    kk = torch.zeros(shape, dtype=kv_cache_dtype(DEV), device=DEV)
    vv = torch.zeros_like(kk)
    pmodel.parler_prefill(cfg, r.weights, torch.tensor(ids, device=DEV), kk, vv)
    out, steps = pmodel.generate_tokens_chunked(
        cfg, r.weights, len(ids), kk, vv, None, use_cross=True,
        do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
        repetition_penalty=1.0, mega=mega)
    return out.cpu().numpy(), steps


# ---------------------------------------------------------------------------
# streams: the runners' generate_stream and the server's chunked PCM
# ---------------------------------------------------------------------------

# a stream against one decode of the whole (tests/test_streaming.py's
# margins): this share of the samples within 1e-4, and every one within
# STREAM_SEAM; through the server, 16-bit samples within 1 LSB
STREAM_CLOSE = 0.95
STREAM_SEAM = 0.2
STREAMS: dict = {}   # label: the stream's numbers, for the summary


@contextlib.contextmanager
def recording(module, name):
    """Every result of module.name kept in the yielded list (the codes a
    stream delay-undoes each round)."""
    seen, orig = [], getattr(module, name)

    def wrapped(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def timed_stream(chunks) -> tuple[list, float, float]:
    """Drain a generate_stream: (the chunks, seconds to the first, seconds
    in all; the host's clock, each chunk on the host when it comes)."""
    t0 = time.perf_counter()
    out, first = [], None
    for c in chunks:
        if first is None:
            first = time.perf_counter() - t0
        out.append(c)
    return out, first, time.perf_counter() - t0


def hold_stream(label, chunks, full, first_s, total_s, rate) -> None:
    """A runner's stream against its `generate`'s waveform `full`: the same
    length, STREAM_CLOSE of the samples within 1e-4 and all within
    STREAM_SEAM, in at least two chunks; its time to the first chunk and
    chunk count are logged and kept in STREAMS."""
    stream = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if stream.shape != full.shape or not full.size:
        raise AssertionError(f"{label} stream: {stream.shape} samples, "
                             f"generate {full.shape}")
    diff = np.abs(stream - full)
    stats = dict(chunks=len(chunks), first_chunk_s=first_s, total_s=total_s,
                 audio_s=full.size / rate,
                 within_1e_4=float((diff <= 1e-4).mean()),
                 max_abs_err=float(diff.max()))
    STREAMS[label] = stats
    log(f"  {label} stream: {json.dumps(stats)} (at least {STREAM_CLOSE} "
        f"within 1e-4, all within {STREAM_SEAM})")
    if stats["within_1e_4"] < STREAM_CLOSE or stats["max_abs_err"] > STREAM_SEAM \
            or len(chunks) < 2:
        raise AssertionError(f"{label}: the stream does not match generate's "
                             f"waveform")


def parler_streams(r, routes, out, steps) -> None:
    """The runner's greedy stream on each route (K2, K12): its codes equal
    the greedy codes `out` / `steps` of generate_tokens_chunked, and its
    waveform the DAC's of them."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.parler import model as pmodel
    want = pmodel.adjust_output_tokens(out, steps, r.cfg)
    full = np.asarray(r.dac.decode(want), np.float32)
    greedy = GenerationConfig(sample=False, seed=SEED)
    for mega, label in routes:
        r.mega = mega
        with recording(pmodel, "adjust_output_tokens") as seen:
            chunks, first, total = timed_stream(r.generate_stream(PROMPT, greedy))
        if not np.array_equal(seen[-1], want):
            raise AssertionError(f"Parler stream, {label}: its codes differ "
                                 f"from generate's")
        hold_stream(f"Parler runner, {label}", chunks, full, first, total, 44100)


def post_stream(base, payload, timeout=900):
    """A `"stream": true` request: (status, Content-Type, the int16 samples
    or the error body, seconds to the first samples)."""
    req = urllib.request.Request(
        base + "/v1/audio/speech", data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            head = r.read(2)
            first = time.perf_counter() - t0
            return (r.status, r.headers.get("Content-Type", ""),
                    np.frombuffer(head + r.read(), "<i2"), first)
    except urllib.error.HTTPError as e:
        return e.code, "", e.read(), None


def wav_int16(body) -> np.ndarray:
    """A WAV response's 16-bit samples."""
    from tts_tpu_torch.audio.wav import decode_wav
    audio, _ = decode_wav(body)
    return np.round(audio * 32767).astype(np.int16)


def run_main_path(tmp) -> tuple[dict, dict, str]:
    """The Parler CLI main path on K2's route (K1-K3 must have been
    launched), then on the K12 route (K12 must have been launched, K2 and
    K3 not); both routes timed stage by stage in turns (K2, K12, K12, K2)
    and traced; their greedy codes equal. Returns (the K2 route's launches,
    the K12 route's launches, the GGUF's path)."""
    from tts_tpu_torch.common import kv_cache_dtype
    from tts_tpu_torch.models.parler import model as pmodel
    from tts_tpu_torch.models.registry import runner_from_file

    n_prompt = prompt_len()
    path = os.path.join(tmp, "parler-mini-q4.gguf")
    t0 = time.perf_counter()
    write_parler(path, np.random.default_rng(SEED), n_layers=MINI["n_layers"],
                 hidden=MINI["hidden"], heads=MINI["heads"], ffn=MINI["ffn"],
                 n_out=MINI["n_out"], vocab=MINI["vocab"], ctx=MINI["ctx"],
                 enc_len=MINI["enc_len"],
                 max_generation=n_prompt + DECODE_STEPS,
                 dac_chans=(1536, 768, 384, 192, 96))
    log(f"Main path: wrote {os.path.getsize(path) / 1e6:.1f} MB GGUF in "
        f"{time.perf_counter() - t0:.1f} s; prompt {n_prompt} tokens, "
        f"{DECODE_STEPS} decode steps")
    launches, audio = cli_wav(path, os.path.join(tmp, "out.wav"), "Parler CLI")
    for n in SINGLE_PATH:
        if launches[n] == 0:
            raise AssertionError(f"kernel {n} was not launched on the main path")
    log("Main path, K12 route (the runner's mega from maybe_prep_parler_flat):")
    with k12_route():
        k12_launches, audio12 = cli_wav(path, os.path.join(tmp, "out-k12.wav"),
                                        "Parler CLI, K12 route")
    if k12_launches["parler_flat_megastep"] == 0 or \
            k12_launches["parler_megastep"] or k12_launches["decode_attention"]:
        raise AssertionError("the K12 route did not run on K12 alone")
    log(f"  K12 launched {k12_launches['parler_flat_megastep']} times, K2 and "
        f"K3 not; the sampled WAV equals the K2 route's: "
        f"{bool(np.array_equal(audio, audio12))}")

    r = runner_from_file(path)
    k2 = r.mega
    flat = pmodel.maybe_prep_parler_flat(r.cfg, r.weights)
    for mega, label in ((k2, "K2 route"), (flat, "K12 route"),
                        (flat, "K12 route"), (k2, "K2 route")):
        timed_route(r, mega, label)
    trace_route(r, k2, "K2 route")
    trace_route(r, flat, "K12 route")
    ids = r.tokenizer.tokenize(PROMPT) + [r.tokenizer.eos_token]
    shape = (r.cfg.n_layers, r.cfg.n_attn_heads, r.cfg.max_ctx_length,
             r.cfg.head_size)
    kk = torch.zeros(shape, dtype=kv_cache_dtype(DEV), device=DEV)
    vv = torch.zeros_like(kk)
    tokens = torch.tensor(ids, device=DEV)
    prefill_device(f"Parler prefill ({len(ids)} tokens)", lambda: pmodel.parler_prefill(
        r.cfg, r.weights, tokens, kk, vv))
    del kk, vv
    (o2, n2), (o12, n12) = greedy_out(r, k2), greedy_out(r, flat)
    if n2 != n12 or not np.array_equal(o2, o12):
        raise AssertionError("greedy codes of the K12 route differ from the "
                             "K2 route's")
    log(f"  greedy codes of the two routes equal over {n2} steps: ok")
    parler_streams(r, ((k2, "K2 route"), (flat, "K12 route")), o2, n2)
    check_dac_bf16(r.dac)
    return launches, k12_launches, path


DAC_BF16_FRAMES = 16    # frames of the card-vs-CPU bf16 check (the CPU's share)
DAC_TIMED_FRAMES = 256  # frames of the timed vocodes
DAC_OUT_SCALE = 0.005   # the check's final convolution, scaled into tanh's linear range


def check_dac_bf16(dac) -> None:
    """TTS_TPU_DAC_DTYPE=bfloat16 at DAC-44k width (the main path's random
    decoder), on seeded random codes. A DACRunner built under the variable
    holds its convolution weights in bf16 (codebooks, biases and alphas
    float32), and compute_dtype="float32" overrides it. The card's bf16
    decode of DAC_BF16_FRAMES frames against the CPU's (torch's bf16
    convolutions there), with the final convolution scaled by
    DAC_OUT_SCALE: the random decoder drives tanh into saturation, where a
    last-bit change flips a sample across 0 by ~2, and scaled the waveform
    measures the convolutions' roundings. Each side rounds activations and
    outputs to bf16 in its own sum order, so the card's may sit as far
    from the CPU's as bf16 sits from f32 on the CPU, and no farther
    (relative RMS, or 1e-2). Then the bf16 vocode timed beside the f32 one
    (unscaled), DAC_TIMED_FRAMES frames, in turns (f32, bf16, bf16, f32;
    host clock around decodes that end on the host)."""
    from tts_tpu_torch.models.codec import dac as pdac
    with env_set("TTS_TPU_DAC_DTYPE", "bfloat16"):
        bf16 = pdac.DACRunner(dac.cfg, dac.weights)
        kept = pdac.DACRunner(dac.cfg, dac.weights, compute_dtype="float32")
    w = bf16.weights
    if (w.in_w.dtype, w.layers[0].up_w.dtype, w.in_b.dtype,
            w.quantizers[0].codebook.dtype, kept.weights.in_w.dtype) != (
            torch.bfloat16, torch.bfloat16, torch.float32, torch.float32,
            torch.float32):
        raise AssertionError("TTS_TPU_DAC_DTYPE=bfloat16: wrong weight dtypes")
    rng = np.random.default_rng(SEED + 19)
    codes = rng.integers(0, 1024, (DAC_TIMED_FRAMES, dac.cfg.n_heads))
    short = codes[:DAC_BF16_FRAMES]
    scaled = dac.weights._replace(out_w=dac.weights.out_w * DAC_OUT_SCALE,
                                  out_b=dac.weights.out_b * DAC_OUT_SCALE)
    card = pdac.DACRunner(dac.cfg, scaled, compute_dtype="bfloat16")
    cpu_f32 = pdac.DACRunner(dac.cfg, to_dev(scaled, torch.device("cpu")))
    cpu_bf16 = pdac.DACRunner(dac.cfg, cpu_f32.weights, compute_dtype="bfloat16")
    ref, base, got = (x.decode(short) for x in (cpu_bf16, cpu_f32, card))

    def rms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)) /
                     max(np.sqrt(np.mean(b ** 2)), 1e-12))

    tol = max(rms(ref, base), 1e-2)
    err = rms(got, ref)
    log(f"DAC-44k in bf16 (TTS_TPU_DAC_DTYPE=bfloat16), {short.shape[0]} "
        f"frames, final conv x {DAC_OUT_SCALE}: card vs CPU relative RMS "
        f"{err:.3e}, max |diff| {float(np.abs(got - ref).max()):.3e} (peak "
        f"{float(np.abs(ref).max()):.3e}); the CPU's bf16 vs its f32: "
        f"{rms(ref, base):.3e}; tol {tol:.3e}")
    if got.shape != ref.shape or not np.isfinite(got).all() or err > tol:
        raise AssertionError("the card's bf16 DAC differs from the CPU's")
    secs = {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "f32", "bf16", "bf16", "f32"):
        run = dac if name == "f32" else bf16
        torch.cuda.synchronize()
        t = time.perf_counter()
        run.decode(codes)
        secs[name].append(time.perf_counter() - t)
    f32_ms, bf16_ms = (1e3 * min(secs[k][1:]) for k in ("f32", "bf16"))
    log(f"  vocode of {codes.shape[0]} frames on the card: f32 {f32_ms:.2f} ms, "
        f"bf16 {bf16_ms:.2f} ms ({f32_ms / bf16_ms:.2f}x; host clock, the "
        f"best of two after a warm-up each)")


# ---------------------------------------------------------------------------
# phase 4b: the quantize tool on the card
# ---------------------------------------------------------------------------

TOOL_SEED = SEED + 18     # the phase's own draws: no earlier one moves
TOOL_STEPS = 64           # decode steps of the CLI on the tool's Q4_0 output
TOOL_SMALL_LAYERS = 2     # the copy the other formats are held on
TOOL_FLAGS = ("-qh", "-qe", "-qkv", "-df")


def quant_edge_blocks() -> np.ndarray:
    """The blocks where a quantizer most easily parts from numpy's: ties of
    |x| with opposite signs (the scale's sign), +-0 and all-zero blocks,
    Q8_0's half-way block (0.49999997 + 0.5 rounds to 1.0 in f32), a block
    whose fp16 scale is subnormal (|m| ~ 1e-6) and one whose fp16 scale
    overflows (|m| > 65504 x 8)."""
    rng = np.random.default_rng(7)
    b = np.zeros((9, 32), np.float32)
    b[1, 0] = -0.0                                   # -0 among zeros
    b[2, :] = -0.0                                   # all -0
    b[3, [3, 7, 9]] = [0.5, -0.5, 0.1]               # |x| tie, + first
    b[4, [3, 7, 9]] = [-0.5, 0.5, 0.1]               # |x| tie, - first
    b[5, :3] = [127.0, 0.49999997, -0.49999997]      # Q8_0's half-way block
    b[6] = rng.standard_normal(32).astype(np.float32) * 1e-6   # fp16 subnormal d
    b[7] = rng.standard_normal(32).astype(np.float32)
    b[7, 5] = -7e5                                   # fp16 d overflows to inf
    b[8] = np.repeat(np.float32([1.0, -1.0]), 16)    # every |x| tied
    return b


def parler_f32(gen, n_layers: int) -> tuple[dict, np.ndarray]:
    """Parler-TTS Mini's decoder in float32 at full width (MINI), under the
    names write_parler_gguf takes, and a text encoding, drawn on the card
    from `gen` and brought to the host as numpy: projections, audio
    embeddings and heads N(0, 0.02), norms 1 + N(0, 0.02), the prompt
    embeddings and text encoding N(0, 1), the positions N(0, 0.1)."""
    H, F = MINI["hidden"], MINI["ffn"]
    t = {}

    def f32(name, *shape, scale=0.02, one=False):
        a = torch.randn(shape, generator=gen, device=DEV) * scale
        t[name] = (a + 1.0 if one else a).cpu().numpy()

    for l in range(n_layers):
        b = f"layers.{l}."
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm",
                   "final_layer_norm"):
            f32(f"{b}{ln}.weight", H, one=True)
            f32(f"{b}{ln}.bias", H)
        for n in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                  "self_attn.out_proj", "encoder_attn.q_proj",
                  "encoder_attn.k_proj", "encoder_attn.v_proj",
                  "encoder_attn.out_proj"):
            f32(f"{b}{n}.weight", H, H)
        f32(f"{b}fc1.weight", F, H)
        f32(f"{b}fc2.weight", H, F)
    f32("layer_norm.weight", H, one=True)
    f32("layer_norm.bias", H)
    f32("embed_prompts", len(TOKENS), H, scale=1.0)
    f32("positional_embed", MINI["ctx"], H, scale=0.1)
    for i in range(MINI["n_out"]):
        f32(f"embed_tokens.{i}.weight", 1090, H)
        f32(f"lm_heads.{i}.weight.head", MINI["vocab"], H)
    f32("text_encoding", MINI["enc_len"], H, scale=1.0)
    return t, t.pop("text_encoding")


def write_parler_f32(path, n_layers, decoder, text_encoding, dac) -> None:
    """A Parler-TTS Mini f32 GGUF through the port's convert writer."""
    from tts_tpu_torch.convert import write_parler_gguf
    write_parler_gguf(
        path, hidden_size=MINI["hidden"], n_layers=n_layers,
        n_attn_heads=MINI["heads"], n_output_heads=MINI["n_out"],
        output_vocab_size=MINI["vocab"],
        max_generation=prompt_len() + TOOL_STEPS, max_ctx=MINI["ctx"],
        bos_token_id=1025, eos_token_id=1024, decoder_tensors=decoder,
        tokenizer_tokens=TOKENS,
        tokenizer_scores=[-10.0] + [-1.0] * (len(TOKENS) - 1),
        text_encoding=text_encoding, dac_tensors=dac)


def quantize_tool(src, dst, argv):
    """`python -m tts_tpu_torch.apps.quantize -mp src -qp dst *argv`, run in
    this process (so that its launches count): (wall s, its stage timer,
    tensors it quantized, tensors it converted to F16)."""
    import io
    from tts_tpu_torch.apps import quantize as pquantize
    out = io.StringIO()
    with recording(pquantize, "StageTimer") as timers, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = pquantize.main(["-mp", src, "-qp", dst, *argv])
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the quantize tool returned {rc}")
    lines = out.getvalue().splitlines()
    return (wall, timers[0], sum(ln.startswith("quantized ") for ln in lines),
            sum(ln.startswith("converted ") for ln in lines))


def differing(a, b) -> int:
    """Bytes that differ between two uint8 arrays or tensors (every byte
    of the longer one when their sizes differ)."""
    if a.shape != b.shape:
        return max(a.numel() if torch.is_tensor(a) else a.size,
                   b.numel() if torch.is_tensor(b) else b.size)
    return int((a != b).sum())


def hold_tool_output(src, dst) -> tuple[int, dict]:
    """Every tensor of the tool's output `dst` against the f32 input `src`:
    a block-quantized one byte for byte against quantize_blocks_plain of the
    same f32 tensor on the card, an F16 one against the numpy cast
    (gguf.quants), any other against the input's bytes. Returns (differing
    bytes, tensors by type)."""
    from tts_tpu_torch.gguf import GGUFReader
    rs, rd = GGUFReader(src), GGUFReader(dst)
    bad, types = 0, collections.Counter()
    try:
        if rd.tensor_names() != rs.tensor_names():
            raise AssertionError("the tool's output lost or reordered tensors")
        for name in rd.tensor_names():
            qt, got = rd.tensors[name].ggml_type, rd.raw(name)
            types[quants.TYPE_NAMES[qt]] += 1
            if rd.tensors[name].shape != rs.tensors[name].shape:
                raise AssertionError(f"{name}: the tool changed its shape")
            if quants.is_quantized(qt):
                x = torch.from_numpy(np.array(rs.array(name), np.float32)).to(DEV)
                bad += differing(torch.from_numpy(np.array(got)).to(DEV),
                                 oq.quantize_blocks_plain(x, qt))
            elif qt == quants.GGML_TYPE_F16 and \
                    rs.tensors[name].ggml_type == quants.GGML_TYPE_F32:
                bad += differing(got, quants.quantize(rs.array(name), qt))
            else:
                bad += differing(got, rs.raw(name))
    finally:
        rs.close()
        rd.close()
    return bad, dict(types)


def quantize_bound(n_values: int, qtype: int) -> tuple[float, str]:
    """The kernel's bound: each f32 value read once, each block written
    once; 4 operations a value (a product, a sum and the two clamps) at
    the f32 rate."""
    return bound(4 * n_values + n_values // 32 * quants.block_info(qtype)[1],
                 4 * n_values, "f32")


def run_quantize_tool(tmp) -> dict:
    """The quantize tool on the card: a Parler-TTS Mini f32 GGUF (full
    width and depth, DAC-44k; random from TOOL_SEED) written by the port's
    convert writer, quantized by `python -m tts_tpu_torch.apps.quantize -qt
    Q4_0 -qh` (run in this process, its launches counted), every tensor
    held byte for byte against its plain version (hold_tool_output), the
    output decoded by the port's CLI to a WAV (K1-K3 must rise); then Q5_0,
    Q8_0 and F16 with -qh -qe -qkv -df on a copy of TOOL_SMALL_LAYERS
    layers, the edge blocks against the plain version and numpy, and the
    kernel timed at the shapes of the tensors it quantized (the embeddings'
    1090 rows time as the heads' 1088). Returns the kernels line's row."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(TOOL_SEED)
    decoder, text_encoding = parler_f32(gen, MINI["n_layers"])
    dac = dac_tensors(np.random.default_rng(TOOL_SEED),
                      (1536, 768, 384, 192, 96), MINI["n_out"])
    t_draw = time.perf_counter() - t0
    f32_path = os.path.join(tmp, "parler-mini-f32.gguf")
    write_parler_f32(f32_path, MINI["n_layers"], decoder, text_encoding, dac)
    n_params = sum(a.size for a in decoder.values())
    log(f"Quantize tool: Parler-TTS Mini f32 GGUF ({n_params / 1e6:.1f} M "
        f"decoder parameters, DAC-44k {sum(a.size for a in dac.values()) / 1e6:.1f} "
        f"M), {os.path.getsize(f32_path) / 1e9:.3f} GB, drawn in {t_draw:.1f} s "
        f"and written in {time.perf_counter() - t0 - t_draw:.1f} s")
    small = {k: v for k, v in decoder.items() if not k.startswith("layers.") or
             int(k.split(".")[1]) < TOOL_SMALL_LAYERS}
    del decoder
    q4_path = os.path.join(tmp, "parler-mini-tool-q4.gguf")
    zero_counts()
    wall, timer, n_q, n_f16 = quantize_tool(f32_path, q4_path, ["-qt", "Q4_0", "-qh"])
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["quantize"] != n_q or n_q == 0 or any(
            v for k, v in launches.items() if k != "quantize"):
        raise AssertionError(f"the tool's launches {launches} are not one a "
                             f"quantized tensor ({n_q})")
    split = ", ".join(f"{k} {timer.totals.get(k, 0.0):.3f} s" for k in
                      ("read", "host->device", "kernel", "device->host", "write"))
    log(f"  -qt Q4_0 -qh: {wall:.3f} s wall ({split}); {n_q} tensors "
        f"quantized, {n_f16} converted to F16, {launches['quantize']} kernel "
        f"launches; {os.path.getsize(q4_path) / 1e6:.1f} MB")
    t1 = time.perf_counter()
    bad, types = hold_tool_output(f32_path, q4_path)
    log(f"  every tensor of the Q4_0 output against its plain version (or the "
        f"input's bytes): {bad} bytes differ, tensors by type {types} "
        f"({time.perf_counter() - t1:.1f} s){'' if bad == 0 else ': FAIL'}")
    want_q4 = 8 * MINI["n_layers"] + 2 * MINI["n_out"]
    if bad or types.get("Q4_0") != want_q4:
        raise AssertionError(f"the tool's Q4_0 output: {bad} bytes differ, "
                             f"{types.get('Q4_0')} Q4_0 tensors (want {want_q4})")
    os.remove(f32_path)
    cli, _ = cli_wav(q4_path, os.path.join(tmp, "tool-q4.wav"),
                     "Parler CLI on the quantize tool's output")
    if any(cli[n] == 0 for n in SINGLE_PATH):
        raise AssertionError("the CLI on the tool's output did not run K1-K3")
    os.remove(q4_path)

    small_path = os.path.join(tmp, "parler-mini-2l-f32.gguf")
    write_parler_f32(small_path, TOOL_SMALL_LAYERS, small, text_encoding, dac)
    for qt in ("Q5_0", "Q8_0", "F16"):
        dst = os.path.join(tmp, f"parler-mini-2l-{qt}.gguf")
        wall, _, n_q, n_f16 = quantize_tool(small_path, dst, ["-qt", qt, *TOOL_FLAGS])
        b, types = hold_tool_output(small_path, dst)
        bad += b
        log(f"  {TOOL_SMALL_LAYERS} layers, -qt {qt} {' '.join(TOOL_FLAGS)}: "
            f"{wall:.3f} s, {n_q} quantized, {n_f16} converted to F16; {b} "
            f"bytes differ; tensors by type {types}{'' if b == 0 else ': FAIL'}")
        if b or (qt != "F16" and n_q != types.get(qt)) or not n_f16:
            raise AssertionError(f"the tool's {qt} output disagrees")
        os.remove(dst)
    os.remove(small_path)

    edge = torch.from_numpy(quant_edge_blocks())
    for qt in QNAME:
        got = oq.quantize_blocks_cuda(edge.to(DEV), qt)
        with np.errstate(over="ignore"):   # the overflowing fp16 scale
            want = quants.quantize(edge.numpy(), qt)
        b = differing(got, oq.quantize_blocks_plain(edge.to(DEV), qt)) + \
            differing(got.cpu().numpy(), want)
        bad += b
        if b:
            raise AssertionError(f"{QNAME[qt]} edge blocks: {b} bytes differ")
    log(f"  edge blocks ({edge.shape[0]}: ties of |x| with opposite signs, +-0, "
        f"all zero, Q8_0's half-way block, subnormal and overflowing fp16 "
        f"scales): the kernel equals its plain version on the card and numpy, "
        f"Q4_0 / Q5_0 / Q8_0: ok")

    H, F = MINI["hidden"], MINI["ffn"]
    row = None
    for qt, shapes in ((quants.GGML_TYPE_Q4_0, ((H, H), (F, H), (H, F),
                                                (MINI["vocab"], H))),
                       (quants.GGML_TYPE_Q5_0, ((F, H),)),
                       (quants.GGML_TYPE_Q8_0, ((F, H),))):
        for shape in shapes:
            # copies that exceed the 50 MB L2 together, taken in turn: the
            # tool finds each tensor cold
            n = shape[0] * shape[1]
            xs = [torch.randn(shape, generator=gen, device=DEV) * 0.02
                  for _ in range(min(16, -(-120_000_000 // (4 * n))))]
            turn = itertools.cycle(xs)

            def launch():
                return oq.quantize_blocks_cuda(next(turn), qt)

            # CUDA events over back-to-back launches (queued_ms): a long run's
            # profiler sessions can lose a window's events, which would read
            # as a faster kernel; the profiler's time, its events all there
            # (whole_trace), is logged beside
            ms = queued_ms(launch, iters=64)
            prof_ms = whole_trace(launch, lambda dt: dt.counts.get(
                "quantize_kernel", 0) >= 1, "the quantize kernel").ms
            x = xs[0]
            plain_ms = queued_ms(lambda: oq.quantize_blocks_plain(x, qt), iters=8)
            b_ms, b_by = quantize_bound(x.numel(), qt)
            log(f"  kernel {QNAME[qt]} {shape[0]}x{shape[1]}: {ms:.4f} ms a launch "
                f"(CUDA events, 64 back-to-back launches; torch.profiler "
                f"{prof_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}; {x.numel() * 4 / 1e6:.2f} MB read, {len(xs)} copies "
                f"taken in turn): the bound is {b_ms / ms:.0%} of the kernel's time")
            if row is None and shape == (F, H):   # the largest Q4_0 tensors
                row = dict(name="quantize", route="cuda",
                           source="tts_tpu_torch/csrc/quantize.cu",
                           replaces="tts_tpu/native.py quantize (host C++)",
                           max_abs_err=0, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
    row["max_abs_err"] = bad
    row["launches"] = launches["quantize"]
    return row


# ---------------------------------------------------------------------------
# phase 5: the serving path, continuous batching through the HTTP server
# ---------------------------------------------------------------------------

def _post(base, payload, timeout=600):
    req = urllib.request.Request(base + "/v1/audio/speech",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def start_server(path, config, batch_slots, text_encoder_path=""):
    """The port's server in this process on 127.0.0.1, an ephemeral port;
    returns (server, httpd, base url) once it is READY (kernels built,
    model loaded), or raises."""
    from tts_tpu_torch.server.server import build_server, serve
    srv = build_server(path, config=config, batch_slots=batch_slots,
                       text_encoder_path=text_encoder_path, timeout=900.0,
                       device=DEV)
    httpd = serve(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    t0 = time.perf_counter()
    while srv.state == "LOADING" and time.perf_counter() - t0 < 300:
        time.sleep(0.1)
    if srv.state != "READY":
        httpd.shutdown()
        raise AssertionError(f"server not READY after {time.perf_counter() - t0:.0f} s: "
                             f"{srv.state} {srv.load_error}")
    log(f"  server READY in {time.perf_counter() - t0:.1f} s "
        f"(batch_slots {batch_slots})")
    return srv, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def serving_prompts(tokenizer, n=12, lo=5, hi=60):
    """n prompts whose token counts (EOS included) spread over [lo, hi]."""
    text = (PROMPT + " ") * 8
    out = []
    for t in np.linspace(lo, hi, n).round().astype(int):
        k = next(k for k in range(1, len(text))
                 if len(tokenizer.tokenize(text[:k].strip())) + 1 >= t)
        out.append(text[:k].strip())
    return out


def check_wav(body, want_rate=44100, frame=512) -> float:
    """Seconds of audio in a WAV response; raises if it is not one."""
    from tts_tpu_torch.audio.wav import decode_wav
    audio, rate = decode_wav(body)
    if rate != want_rate or audio.size == 0 or audio.size % frame or \
            not np.all(np.isfinite(audio)):
        raise AssertionError("response is not a valid waveform")
    return audio.size / rate


def serving_burst(path, engine_cls, params, rate, frame, kernels, label,
                  prompts=None, streamed=(3, 9)):
    """The port's server in this process (batch_slots 8, a sampled default
    config with top-k 50) answers 12 concurrent requests with the given
    per-request parameters, those at `streamed` with `"stream": true` and
    top-k 1 (so that their tokens do not depend on the batch); every
    answer must be a WAV at `rate` of whole `frame`s with the right top-k
    cap header (a stream: 16-bit PCM with its rate in the header), /metrics
    must count 12 requests, the streams and no failure, and each of
    `kernels` must have been launched (counters set to 0 just before, read
    just after). Each stream's samples must equal those of the same request
    sent whole afterwards, within 1 LSB for STREAM_CLOSE of them and
    STREAM_SEAM elsewhere; its time to the first samples is logged. Then
    the batched decode step alone: an `engine_cls` engine with 8 live
    slots, a 32-step chunk timed (one host sync), a 32-step chunk traced;
    and one request through batch_slots 0. `prompts` default to
    `serving_prompts` of the runner's tokenizer. Returns (runner, prompts,
    stats, launches)."""
    from tts_tpu_torch.common import GenerationConfig
    log(f"{label} serving: the port's server, batch_slots 8, sampled default "
        f"config, 12 concurrent requests ({len(streamed)} streamed):")
    srv, httpd, base = start_server(path, GenerationConfig(top_k=50), 8)
    runner = srv.runners[srv.default_model]
    prompts = prompts or serving_prompts(runner.tokenizer)
    params = [dict(p, top_k=1) if i in streamed else p
              for i, p in enumerate(params[:len(prompts)])]
    results = [None] * len(prompts)

    def req(i):
        t0 = time.perf_counter()
        if i in streamed:
            r = post_stream(base, dict(input=prompts[i], **params[i]))
        else:
            r = _post(base, dict(input=prompts[i], **params[i]))
        results[i] = (r, time.perf_counter() - t0)

    threads = [threading.Thread(target=req, args=(i,)) for i in range(len(prompts))]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts(f"{label} serving")
    m = srv.metrics_json()
    secs, pcm = [], {}
    for i, (res, _) in enumerate(results):
        code, body = res[0], res[2 if i in streamed else 1]
        if code != 200:
            raise AssertionError(f"request {i} answered {code}: {bytes(body)[:300]!r}")
        if i in streamed:
            want = f"audio/pcm;rate={rate};encoding=signed-integer;bits=16"
            if res[1] != want or body.size == 0 or body.size % frame:
                raise AssertionError(f"stream {i}: {res[1]!r}, {body.size} samples")
            pcm[i] = body
            secs.append(body.size / rate)
            continue
        secs.append(check_wav(body, rate, frame))
        capped = res[2].get("X-TTS-Top-K-Applied")
        if capped != ("256" if params[i]["top_k"] == 0 else None):
            raise AssertionError(f"request {i}: X-TTS-Top-K-Applied {capped!r}")
    # each stream against the same request answered whole (sent together)
    whole_res = {}
    threads = [threading.Thread(target=lambda i=i: whole_res.__setitem__(
        i, _post(base, dict(input=prompts[i], **params[i])))) for i in streamed]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stream_stats = {}
    for i in streamed:
        code, body, _ = whole_res[i]
        if code != 200:
            raise AssertionError(f"request {i} sent whole answered {code}")
        whole = wav_int16(body)
        if whole.shape != pcm[i].shape:
            raise AssertionError(f"stream {i}: {pcm[i].size} samples, whole "
                                 f"{whole.size}")
        diff = np.abs(pcm[i].astype(np.int32) - whole.astype(np.int32))
        stream_stats[i] = dict(first_samples_s=results[i][0][3],
                               latency_s=results[i][1], audio_s=whole.size / rate,
                               within_1_lsb=float((diff <= 1).mean()),
                               max_lsb=int(diff.max()))
        if stream_stats[i]["within_1_lsb"] < STREAM_CLOSE or \
                diff.max() > STREAM_SEAM * 32767:
            raise AssertionError(f"stream {i} differs from its request sent "
                                 f"whole: {stream_stats[i]}")
    STREAMS[f"{label} server"] = stream_stats
    httpd.shutdown()
    lat = sorted(t for _, t in results)
    log(f"  audio seconds per request {[round(x, 3) for x in secs]}; every "
        f"response a WAV or (streams {list(streamed)}) 16-bit PCM, top-k cap "
        f"headers right; /metrics requests {m['requests_total']}, streams "
        f"{m['streams_total']}, failed {m['requests_failed']}; launches "
        f"{launches}")
    log(f"  streams through the batched worker, each against the same request "
        f"sent whole: {json.dumps(stream_stats)}")
    if m["requests_total"] != len(prompts) or m["requests_failed"] or \
            m["streams_total"] != len(streamed) or m["streams_rejected"]:
        raise AssertionError("/metrics does not count 12 requests, the streams "
                             "and 0 failures")
    for n in kernels:
        if launches[n] == 0:
            raise AssertionError(f"kernel {n} was not launched on the {label} "
                                 f"serving path")
    stats = dict(requests=len(prompts), wall_s=wall, audio_s=sum(secs),
                 audio_s_per_wall_s=sum(secs) / wall,
                 latency_p50_s=lat[len(lat) // 2], latency_max_s=lat[-1])

    eng = engine_cls(runner.cfg, runner.weights, runner.tokenizer, n_slots=8,
                     chunk=32)
    for p, kw in zip(prompts[:8], params):
        eng.submit(p, GenerationConfig(**kw))
    eng.step()
    torch.cuda.synchronize()
    before = {n: k.launches for n, k in KERNELS.items()}
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    stats["decode_ms_per_batched_step"] = (time.perf_counter() - t0) * 1e3 / 32
    stats["launches_per_batched_step"] = {
        n: (k.launches - before[n]) / 32 for n, k in KERNELS.items()}
    device_trace(eng.step, f"{label} batched decode, 8 slots", 32)
    if any(r is None for r in eng.slot_req):
        raise AssertionError("a slot finished inside the timed window")
    del eng
    torch.cuda.empty_cache()

    srv0, httpd0, base0 = start_server(path, GenerationConfig(top_k=50), 0)
    t0 = time.perf_counter()
    code, body, _ = _post(base0, dict(input=prompts[5], **params[5]))
    t1 = time.perf_counter()
    httpd0.shutdown()
    if code != 200:
        raise AssertionError(f"batch_slots 0 request answered {code}")
    one_s = check_wav(body, rate, frame)
    stats.update(single_latency_s=t1 - t0, single_audio_s_per_wall_s=one_s / (t1 - t0))
    log(f"  timed: {json.dumps(stats)}")
    del srv0
    torch.cuda.empty_cache()
    return runner, prompts, stats, launches


def serving_params(**extra) -> list[dict]:
    """12 requests' mixed sampling parameters."""
    return [dict(temperature=(0.7, 1.0)[i % 2], top_k=(50, 0)[i // 2 % 2],
                 top_p=(1.0, 0.9)[i // 4 % 2],
                 repetition_penalty=(1.0, 1.1)[i // 3 % 2], **extra)
            for i in range(12)]


def run_serving(path) -> dict:
    """The Parler serving path (`serving_burst`: K1, K4 and K5 must have
    been launched), then greedy parity of the engine with the single-stream
    runner. Returns the launch counts of the 12 requests."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.runtime.batched_parler import BatchedParlerEngine
    runner, prompts, _, launches = serving_burst(
        path, BatchedParlerEngine, serving_params(), 44100, 512, SERVING_PATH,
        "Parler")
    lens = [len(runner.tokenizer.tokenize(p)) + 1 for p in prompts]
    log(f"  Parler prompt tokens {lens}")
    # greedy parity: 4 prompts of different lengths in 8 slots against the
    # single-stream runner (generation cut to 96 steps past the longest
    # prompt: parity needs no more)
    cfg = dataclasses.replace(runner.cfg, max_generation_size=max(lens) + 96)
    single = copy.copy(runner)
    single.cfg = cfg
    greedy = GenerationConfig(sample=False)
    eng = BatchedParlerEngine(cfg, runner.weights, runner.tokenizer, n_slots=8,
                              chunk=32)
    picks = [prompts[i] for i in (0, 4, 8, 11)]
    rids = [eng.submit(p, greedy) for p in picks]
    eng.run_until_done()
    for rid, p in zip(rids, picks):
        want = single.generate_codes(p, greedy)
        got = eng.results[rid]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"greedy codes of the engine differ from the "
                                 f"runner's for a {len(p)}-char prompt: "
                                 f"{got.shape} vs {want.shape}")
    log(f"  greedy parity: 4 requests in 8 slots give the single-stream "
        f"runner's codes exactly ({[eng.results[r].shape[0] for r in rids]} "
        f"frames): ok")
    return launches


# ---------------------------------------------------------------------------
# conditional prompts: the T5 encoder behind the Parler runner, CLI and server
# ---------------------------------------------------------------------------

# flan-t5-large, the text encoder Parler-TTS Mini v1's config names: 24
# layers, d_model 1024, 16 heads of 64, d_ff 2816 (gated GELU), 32 relative
# buckets over a distance of 128, vocab 32128. No down projection: its
# output is the Parler-Mini decoder's hidden size.
T5_LARGE = dict(n_layers=24, hidden=1024, heads=16, ffn=2816, vocab=32128)
DESCRIPTION = "a calm female voice, speaking slowly, in a quiet room."


def write_t5(path, rng, *, n_layers, hidden, heads, ffn, vocab) -> None:
    """A T5 encoder GGUF as `tts_tpu.convert.write_t5_gguf` lays one out:
    Q4_0 projections, F32 norms and relative-attention bias (the first
    layer's), F16 token embeddings, the unigram vocab of TOKENS."""
    w = GGUFWriter(path, "t5encoder")
    for key, v in (("embedding_length", hidden), ("block_count", n_layers),
                   ("attention.head_count", heads), ("vocab_size", vocab),
                   ("output_size", hidden), ("context_length", 512)):
        w.add_u32(f"t5encoder.{key}", v)
    w.add_str("tokenizer.ggml.model", "unigram")
    w.add_array("tokenizer.ggml.tokens", TOKENS)
    w.add_array("tokenizer.ggml.scores",
                np.asarray([-10.0] + [-1.0] * (len(TOKENS) - 1), np.float32))
    for key, v in (("unknown_token_id", 0), ("eos_token_id", 1),
                   ("bos_token_id", 0)):
        w.add_u32(f"tokenizer.ggml.{key}", v)

    def q4(name, n, k):
        w.add_raw_tensor(name, (n, k), quants.GGML_TYPE_Q4_0, rand_q4_raw(rng, n, k))

    def f32(name, *shape, scale=0.1, one=False):
        w.add_tensor(name, rng.standard_normal(shape, dtype=np.float32) * scale
                     + (1.0 if one else 0.0))

    for l in range(n_layers):
        b = f"t5encoder.enc.blk.{l}."
        f32(b + "attn_norm", hidden, one=True)
        for n in ("attn_q", "attn_k", "attn_v", "attn_o"):
            q4(b + n, hidden, hidden)
        if l == 0:
            f32(b + "attn_rel_b", 32, heads, scale=1.0)
        f32(b + "ffn_norm", hidden, one=True)
        q4(b + "ffn_up", ffn, hidden)
        q4(b + "ffn_gate", ffn, hidden)
        q4(b + "ffn_down", hidden, ffn)
    w.add_tensor("t5encoder.token_embd", rng.standard_normal(
        (vocab, hidden), dtype=np.float32), quants.GGML_TYPE_F16)
    f32("t5encoder.enc.final_layer_norm", hidden, one=True)
    w.write()


def t5_bucket() -> int:
    """The T5 runner's rows for DESCRIPTION: its tokens (and the EOS)
    padded to the first length bucket that holds them."""
    from tts_tpu_torch.models.t5.model import length_bucket
    from tts_tpu_torch.text import UnigramTokenizer
    tok = UnigramTokenizer({t: i for i, t in enumerate(TOKENS)}, 0,
                           [-10.0] + [-1.0] * (len(TOKENS) - 1), 1)
    return length_bucket(len(tok.tokenize(DESCRIPTION)) + 1)


def dense_t5(w):
    """The T5 weights with every projection dequantized to float32 (the
    plain version of K1's products: dequant + torch.matmul)."""
    from tts_tpu_torch.models.t5.model import T5LayerWeights
    deq = [f.dense() if isinstance(f, qm.QuantTensor) else f for f in w.layers]
    return w._replace(layers=T5LayerWeights(*deq))


def check_t5(t5_path, tokenizer) -> int:
    """The T5 encoder at flan-t5-large width on the card (K1 in f32 mode at
    M = the description's bucket) against its plain version (dequant +
    float32 matmul), within 4x the plain version's own move between the
    card and the host's CPU (or 1e-5 of the largest output); timed. Returns
    the description's token count, Tc."""
    from tts_tpu_torch.models.t5 import model as t5m
    enc = t5m.text_encoder_from_file(t5_path, tokenizer)
    ids = tokenizer.tokenize(DESCRIPTION) + [enc.cfg.eos_token_id]
    plain = t5m.T5Runner(enc.cfg, dense_t5(enc.weights), tokenizer)
    before = qm.KERNEL.launches
    got = enc.encode_tokens(ids)
    if qm.KERNEL.launches - before != 7 * enc.cfg.n_layers:
        raise AssertionError(f"T5 encode launched K1 {qm.KERNEL.launches - before} "
                             f"times, want 7 a layer")
    ref = plain.encode_tokens(ids)
    host_w = t5m.T5Weights(*[t.cpu() if torch.is_tensor(t) else
                             (type(t)(*[f.cpu() for f in t]) if t is not None else None)
                             for t in plain.weights])
    host = t5m.T5Runner(enc.cfg, host_w, tokenizer).encode_tokens(ids).to(DEV)
    scale = float(ref.abs().max())
    yard = max_err(host, ref) / scale
    tol = max(4 * yard, 1e-5)
    err = max_err(got, ref) / scale
    ms = cuda_ms(lambda: enc.encode_tokens(ids), iters=5, warmup=1)
    dev = device_ms(lambda: enc.encode_tokens(ids), iters=3, warmup=1)
    plain_ms = cuda_ms(lambda: plain.encode_tokens(ids), iters=3, warmup=1)
    log(f"  T5 (flan-t5-large width, Q4_0) encode of {len(ids)} tokens (bucket "
        f"{enc.bucket(len(ids))}): max |K1 - plain| / max {err:.3e} (tol "
        f"{tol:.3e}: 4x the plain version's card-vs-CPU move {yard:.3e}); "
        f"{ms:.4f} ms a call on the host clock, {dev.ms:.4f} ms of device "
        f"time; plain (dequant + matmul) {plain_ms:.4f} ms")
    if not bool(torch.isfinite(got).all()) or got.shape != (len(ids), enc.cfg.hidden_size) \
            or err > tol:
        raise AssertionError("T5 on the card disagrees with its plain version")
    del enc, plain, host_w
    torch.cuda.empty_cache()
    return len(ids)


def run_conditional_prompt(tmp, path) -> None:
    """Conditional prompts on the Parler-Mini GGUF: a flan-t5-large-width
    T5 GGUF written; T5 held to its plain version (check_t5); the CLI with
    --conditional-prompt and --text-encoder-path (a valid WAV, Tc the
    description's token count; K1's census kept); the server with
    --text-encoder-path: POST /v1/audio/conditional-prompt on the K12
    route, then greedy (top-k 1) requests through the batched engine equal
    the runner's on both routes (K2, K12) at the new Tc; K2's and K12's
    layer checks at that Tc."""
    from tts_tpu_torch.apps import cli
    from tts_tpu_torch.audio.wav import read_audio_file
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.parler import model as pmodel
    t5_path = os.path.join(tmp, "flan-t5-large-q4.gguf")
    t0 = time.perf_counter()
    write_t5(t5_path, np.random.default_rng(SEED + 7), **T5_LARGE)
    log(f"Conditional prompt: wrote {os.path.getsize(t5_path) / 1e6:.1f} MB "
        f"T5 GGUF in {time.perf_counter() - t0:.1f} s; description "
        f"{DESCRIPTION!r}")
    from tts_tpu_torch.text import UnigramTokenizer
    tok = UnigramTokenizer({t: i for i, t in enumerate(TOKENS)}, 0,
                           [-10.0] + [-1.0] * (len(TOKENS) - 1), 1)
    tc = check_t5(t5_path, tok)

    made = []
    load = cli.runner_from_file

    def keep(*a, **k):
        made.append(load(*a, **k))
        return made[-1]

    wav = os.path.join(tmp, "conditional.wav")
    cli.runner_from_file = keep
    try:
        zero_counts()
        rc = cli.main(["-mp", path, "-p", PROMPT, "-sp", wav, "--seed",
                       str(SEED), "-cp", DESCRIPTION, "-tep", t5_path])
        torch.cuda.synchronize()
        launches = read_counts("Parler CLI, conditional prompt")
    finally:
        cli.runner_from_file = load
    audio, rate = read_audio_file(wav)
    got_tc = made[0].cfg.n_encode_length
    log(f"  CLI with --conditional-prompt wrote {audio.size} samples at {rate} "
        f"Hz; Tc {got_tc} (the description's {tc} tokens); launches {launches}")
    if rc != 0 or rate != 44100 or audio.size == 0 or audio.size % 512 or \
            not np.all(np.isfinite(audio)) or np.abs(audio).max() > 1.0 or \
            got_tc != tc or made[0].weights.layers.cross_k.shape[2] != tc:
        raise AssertionError("the conditional-prompt CLI run failed")
    r = made[0]
    t0 = time.perf_counter()
    r.update_conditional_prompt(t5_path, DESCRIPTION)
    torch.cuda.synchronize()
    log(f"  update_conditional_prompt: {(time.perf_counter() - t0) * 1e3:.1f} "
        f"ms (the encoder's GGUF read, T5, every layer's cross K/V, K2's "
        f"prep)")
    del made, r
    torch.cuda.empty_cache()

    srv, httpd, base = start_server(path, GenerationConfig(top_k=50), 8,
                                    text_encoder_path=t5_path)
    try:
        runner = srv.runners[srv.default_model]
        runner.mega = pmodel.maybe_prep_parler_flat(runner.cfg, runner.weights)
        t0 = time.perf_counter()
        req = urllib.request.Request(
            base + "/v1/audio/conditional-prompt",
            data=json.dumps({"conditional_prompt": DESCRIPTION}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            code, body = resp.status, resp.read()
        post_ms = (time.perf_counter() - t0) * 1e3
        eng = srv.batched_workers[srv.default_model].engine
        if code != 200 or json.loads(body) != {"success": True} or \
                not isinstance(runner.mega, pf.ParlerFlat) or \
                runner.cfg.n_encode_length != tc or eng.weights is not runner.weights \
                or eng.mega.layers.cross_k.shape[2] != tc:
            raise AssertionError(f"POST /v1/audio/conditional-prompt: {code} "
                                 f"{body[:200]!r}")
        log(f"  server: POST /v1/audio/conditional-prompt answered 200 in "
            f"{post_ms:.1f} ms (loading the encoder, T5, cross K/V, the K12 "
            f"route's prep, the engine's K5 prep between two chunks); Tc {tc}")
        prompts = serving_prompts(runner.tokenizer, n=4, lo=5, hi=40)
        results = [None] * len(prompts)

        def one(i):
            results[i] = _post(base, dict(input=prompts[i], top_k=1, seed=i))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for route in ("K12", "K2"):
            if route == "K2":
                runner.mega = pmodel.maybe_prep_mega(runner.cfg, runner.weights)
            for i, (code, body, _) in enumerate(results):
                want = runner.generate(prompts[i], GenerationConfig(top_k=1, seed=i))
                if code != 200 or not np.array_equal(
                        wav_int16(body), (np.clip(want.audio, -1, 1) * 32767).astype(np.int16)):
                    raise AssertionError(f"the engine's greedy answer {i} differs "
                                         f"from the runner's on the {route} route")
        log(f"  4 greedy (top-k 1) requests through the engine (K5, Tc {tc}) "
            f"equal the runner's on the K12 and the K2 route: ok")
        mega = runner.mega.layers
    finally:
        httpd.shutdown()
    # K2's and K12's layer checks at the new Tc
    L, H, heads, ctx = MINI["n_layers"], MINI["hidden"], MINI["heads"], MINI["ctx"]
    d = H // heads
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 13)
    kc = (torch.randn((L, heads, ctx, d), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn((L, heads, ctx, d), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((1, H), generator=gen, device=DEV)
    kw = dict(qtype=quants.GGML_TYPE_Q4_0, use_cross=True, n_heads=heads)
    pos = torch.tensor([1000], dtype=torch.int32, device=DEV)
    check_k2_layers(mega, x, kc, vc, pos, kw, layers=K12_LAYERS)
    err, base = defaultdict(list), defaultdict(list)
    layer_errors(lambda l: pm.MegaLayers(*(t[l:l + 1] for t in mega[:-1]),
                                         mega.cross_pos),
                 L, x, kc, vc, pos, kw, k12_step, k12_plain, "K12", err, base,
                 layers=K12_LAYERS)
    judge_layers(err, base, "K12", f"Tc {tc}, pos 1000, layers "
                 f"{list(K12_LAYERS)} layer by layer, yardstick plain on the "
                 f"CPU vs plain on the card")
    del kc, vc, srv
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Orpheus GGUFs written with the port's writer
# ---------------------------------------------------------------------------

# SNAC-24k (hubertsiuzdak/snac_24khz): latent 768, decoder 1024 channels
# halving per block at rates 8/8/4/2, 3 codebooks of 4096 x 8 at strides
# 4/2/1, noise blocks, depthwise convolutions.
SNAC_24K = dict(latent=768, dims=(1024, 512, 256, 128, 64), codebook=4096)
ORPHEUS_PIECES = ["a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l",
                  "m", "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x",
                  "y", "z", ",", "?", ":", "Ġ", "he", "hey", "ow", "Ġh", "Ġhow",
                  "ar", "Ġar", "Ġare", "yo", "Ġyo", "Ġyou", "do", "Ġdo", "in",
                  "ing", "Ġdoing", "to", "da", "ay", "Ġto", "Ġtoda", "Ġtoday",
                  "zo", "zoe"]
ORPHEUS_MERGES = ["h e", "he y", "o w", "Ġ h", "Ġh ow", "a r", "Ġ ar",
                  "Ġar e", "y o", "Ġ yo", "Ġyo u", "d o", "Ġ do", "i n",
                  "in g", "Ġdo ing", "t o", "d a", "a y", "Ġ to", "Ġto da",
                  "Ġtoda y", "z o", "zo e"]
SPECIAL = (128000, 128009, 128257, 128258, 128259, 128260, 128261)


def orpheus_vocab(n: int) -> list[str]:
    """n token strings: <unk>, the BPE pieces above, then placeholders; the
    BPE merge loop runs on the prompt, and the special ids of the prompt
    format sit where PREPENDED_TOKENS / APPENDED_TOKENS want them."""
    base = ["<unk>"] + ORPHEUS_PIECES
    return base + [f"<|{'special' if i in SPECIAL else 'piece'}_{i}|>"
                   for i in range(len(base), n)]


def write_orpheus(path, rng, *, n_layers, hidden, heads, kv_heads, ffn,
                  vocab, q4_head, snac_dims, snac_latent, max_generation=None):
    """An Orpheus GGUF as `tts_tpu.apps.quantize -qt Q4_0` leaves one:
    Q4_0 projections (and with q4_head, as -qh gives it, a Q4_0 LM head;
    else F16), an F16 embed_tokens, F32 norms and llama3 RoPE factors, and
    a SNAC decoder in F32 under `snac.` (residual units depthwise). With
    `max_generation`, `orpheus.max_generation_size` states the window."""
    d = hidden // heads
    w = GGUFWriter(path, "orpheus")
    if max_generation is not None:
        w.add_u32("orpheus.max_generation_size", max_generation)
    for key, v in (("orpheus.vocab_size", vocab), ("orpheus.attn_heads", heads),
                   ("orpheus.kv_attn_heads", kv_heads), ("orpheus.head_dim", d),
                   ("orpheus.hidden_size", hidden), ("orpheus.layers", n_layers),
                   ("orpheus.stopping_token_id", 128258),
                   ("tokenizer.ggml.bos_token_id", 128000),
                   ("tokenizer.ggml.eos_token_id", 128009),
                   ("snac.audio_token_channels", 3),
                   ("snac.up_sampling_factor", 512)):
        w.add_u32(key, v)
    w.add_str("tokenizer.ggml.model", "bpe")
    w.add_array("tokenizer.ggml.tokens", orpheus_vocab(vocab))
    w.add_array("tokenizer.ggml.merges", ORPHEUS_MERGES)
    Q4 = quants.GGML_TYPE_Q4_0

    def q4(name, n, k):
        w.add_raw_tensor(name, (n, k), Q4, rand_q4_raw(rng, n, k))

    def f32(name, *shape, scale=0.02, one=False):
        a = rng.standard_normal(shape, dtype=np.float32) * scale + (1.0 if one else 0.0)
        w.add_tensor(name, a)

    def f16(name, *shape):
        w.add_tensor(name, (rng.standard_normal(shape, dtype=np.float32)
                            * 0.02).astype(np.float16))

    for l in range(n_layers):
        b = f"orpheus.layers.{l}."
        f32(b + "input_layernorm", hidden, scale=0.1, one=True)
        f32(b + "post_attention_layernorm", hidden, scale=0.1, one=True)
        for n, rows, cols in (("self_attn.q_proj", hidden, hidden),
                              ("self_attn.k_proj", kv_heads * d, hidden),
                              ("self_attn.v_proj", kv_heads * d, hidden),
                              ("self_attn.o_proj", hidden, hidden),
                              ("mlp.gate_proj", ffn, hidden),
                              ("mlp.up_proj", ffn, hidden),
                              ("mlp.down_proj", hidden, ffn)):
            q4(b + n, rows, cols)
    f16("orpheus.embed_tokens", vocab, hidden)
    f32("orpheus.norm", hidden, scale=0.1, one=True)
    if q4_head:
        q4("orpheus.lm_head", vocab, hidden)
    else:
        f16("orpheus.lm_head", vocab, hidden)
    w.add_tensor("orpheus.rope_frequencies",
                 llama3_rope_factors(d, ORPHEUS["theta"]))
    s = "snac."
    for i in range(3):
        f32(f"{s}quantizers.{i}.codebook.weight", SNAC_24K["codebook"], 8, scale=0.5)
        f32(f"{s}quantizers.{i}.out_proj.weight", snac_latent, 8, 1, scale=0.3)
        f32(f"{s}quantizers.{i}.out_proj.bias", snac_latent, scale=0.05)
    f32(s + "in.weight", snac_latent, 1, 7, scale=0.3)
    f32(s + "in.bias", snac_latent, scale=0.05)
    f32(s + "up.weight", snac_dims[0], snac_latent, 1, scale=snac_latent ** -0.5)
    f32(s + "up.bias", snac_dims[0], scale=0.05)

    def alpha(name, c):
        w.add_tensor(name, np.abs(rng.standard_normal((1, c, 1), dtype=np.float32)
                                  * 0.05) + 0.5)

    for i, (st, pad) in enumerate(zip((8, 8, 4, 2), (4, 4, 2, 1))):
        cin, cout = snac_dims[i], snac_dims[i + 1]
        w.add_u32(f"snac.snac_layer_stride_{i}", st)
        w.add_u32(f"snac.snac_layer_padding_{i}", pad)
        w.add_u32(f"snac.snac_layer_grouping_{i}", cout)
        b = f"{s}layers.{i}."
        alpha(b + "alpha", cin)
        f32(b + "weight", cin, cout, 2 * st, scale=(cin * st) ** -0.5)
        f32(b + "bias", cout, scale=0.05)
        f32(b + "noise_weight", cout, cout, 1, scale=0.1 * cout ** -0.5)
        for j in range(3):
            ub = f"{b}residual_unit.{j}.res."
            alpha(ub + "initial.alpha", cout)
            f32(ub + "initial.weight", cout, 1, 7, scale=0.2)
            f32(ub + "initial.bias", cout, scale=0.05)
            alpha(ub + "final.alpha", cout)
            f32(ub + "final.weight", cout, cout, 1, scale=0.5 * cout ** -0.5)
            f32(ub + "final.bias", cout, scale=0.05)
    alpha(s + "alpha_out", snac_dims[-1])
    f32(s + "final.weight", 1, snac_dims[-1], 7, scale=0.05)
    f32(s + "final.bias", 1, scale=0.05)
    w.write()


# ---------------------------------------------------------------------------
# phase 6: a small Orpheus, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def check_small_orpheus(tmp, hidden=256, heads=4, kv_heads=2,
                        n_steps=48, per_matmul=False) -> None:
    """A small Q4_0 Orpheus on both decode routes (Q4_0 head: K6; F16 head:
    K8; for heads other than 64 / 128, K7 / K9 at one slot), decoded
    greedily on the CPU (plain versions); the card (kernels) follows the
    same token history (teacher forcing) and its logits must match at
    every step, within 4x the CPU's own change when every embedding moves
    by one ulp, or 1e-3 (the Parler check's rule). Then the CPU's tokens
    are vocoded on both (SNAC, 4 channel widths). With `per_matmul`
    (TTS_TPU_MEGAKERNEL=0, or heads that are not a multiple of 64) the
    Q4_0-head model alone, on the per-matmul route: K1 and K4 on the card,
    no step kernel. At the default widths the runtime switches follow
    (orpheus_switches)."""
    from tts_tpu_torch.models.orpheus import model as omodel
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.ops.llama_flat import LlamaFlat
    d = hidden // heads
    kw = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
              repetition_penalty=1.0, max_steps=n_steps + 1)
    routes = (((True, "per matmul"),) if per_matmul else
              ((True, "K6"), (False, "K8")))
    for q4_head, route in routes:
        log(f"Reference: small Q4_0 Orpheus (L=2, H={hidden}, {heads}/"
            f"{kv_heads} heads of {d}, F 1024, "
            f"{'Q4_0' if q4_head else 'F16'} head: {route}), f32 caches, "
            f"{n_steps} steps, card kernels vs CPU plain versions:")
        path = os.path.join(tmp, f"orpheus-small-{route.replace(' ', '-')}"
                                 f"-d{d}.gguf")
        write_orpheus(path, np.random.default_rng(SEED + 2), n_layers=2,
                      hidden=hidden, heads=heads, kv_heads=kv_heads, ffn=1024,
                      vocab=1000, q4_head=q4_head, snac_dims=(64, 32, 16, 8, 4),
                      snac_latent=32)
        gen = torch.Generator().manual_seed(SEED)
        runs = []
        for dev, perturb in ((DEV, False), (torch.device("cpu"), False),
                             (torch.device("cpu"), True)):
            r = runner_from_file(path, device=dev)
            if (r.mega is None) != per_matmul or (not per_matmul and (
                    (route == "K6") != isinstance(r.mega.step, LlamaFlat) or
                    r.mega.persistent != (d in da.STEP_HEAD_SIZES))):
                raise AssertionError(f"small model did not take the {route} "
                                     f"route")
            if perturb:   # every embedding moved by one ulp, +-
                e = r.weights.embd
                e.mul_(1 + (torch.randint(0, 2, e.shape, generator=gen) * 2 - 1)
                       * 2 ** -23)
            cfg = r.cfg
            ids = [1, 2] + r.tokenizer.tokenize(f"{VOICE}: {PROMPT}") + [3]
            shape = (cfg.n_layers, cfg.n_kv_heads, 512, cfg.head_size)
            kk, vv = torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)
            lg = omodel.orpheus_prefill(cfg, r.weights, r.inv_freq,
                                        torch.tensor(ids, device=dev), kk, vv)
            runs.append([r, lg, kk, vv, len(ids)])
        first = runs[1][1].argmax().reshape(1)
        pre = max_err(runs[0][1].cpu(), runs[1][1]) / float(runs[1][1].abs().max())
        states = [omodel.init_state(r.cfg, first.to(kk.device), n, kk, vv,
                                    n_steps + 1) for r, _, kk, vv, n in runs]
        worst, sens, agree = 0.0, 0.0, 0
        zero_counts()
        with torch.no_grad():
            for _ in range(n_steps):
                lg, lc, lp = (omodel.step_logits(r.cfg, r.weights, r.inv_freq, s,
                                                 r.mega)
                              for (r, *_), s in zip(runs, states))
                lg = lg.cpu()
                scale = float(lc.abs().max())
                worst = max(worst, max_err(lg, lc) / scale)
                sens = max(sens, max_err(lp, lc) / scale)
                agree += int(lg.argmax() == lc.argmax())
                sc = omodel.advance(runs[1][0].cfg, states[1], lc, None, **kw)
                # the card and the perturbed run follow the CPU's history
                states = [omodel.advance(r.cfg, s, l.to(s.kv_k.device), None, **kw)
                          ._replace(token_in=sc.token_in.to(s.kv_k.device))
                          for (r, *_), s, l in zip(runs, states, (lg, lc, lp))]
                states[1] = sc
        tol = max(4 * sens, 1e-3)
        launched = route_counts(("quant_matmul", "decode_attention_batched"),
                                STEP_KERNELS) if per_matmul else \
            {n: c for n, c in read_counts().items() if c}
        log(f"  prefill logits (K1) max |card - cpu| / max|logit| {pre:.3e}; "
            f"teacher-forced decode logits ({route}): {worst:.3e}; the CPU's own "
            f"change under 1-ulp embedding changes: {sens:.3e}; tol {tol:.3e}; "
            f"argmax agreement {agree}/{n_steps}; launches {launched}")
        if worst > tol or pre > tol:
            raise AssertionError(f"small-model {route} logits differ between "
                                 f"card and CPU")
        out, n_out = states[1].out_tokens.numpy(), int(states[1].n_out)
        if n_out != n_steps + 1:
            raise AssertionError(f"small model ran {n_out} tokens")
        wa, wb = (r.vocode(out, n_out, SEED) for r, *_ in runs[:2])
        err = float(np.abs(wa - wb).max())
        log(f"  {n_out} tokens vocoded on both: {wa.size} samples, waveform "
            f"max_abs_err {err:.3e} (tol 1e-3: f32 convolutions, TF32 off, "
            f"other sum order)")
        if wa.size != 4 * (n_out // 7) * 512 or wa.shape != wb.shape or err > 1e-3:
            raise AssertionError("small-model waveform differs between card and CPU")
    if (hidden, heads, kv_heads) == (256, 4, 2) and not per_matmul:
        orpheus_switches(tmp)


def orpheus_switches(tmp) -> None:
    """The small Orpheus (heads of 64; Q4_0 head: K6) under the JAX
    package's switches, on the card, greedy over SWITCH_STEPS tokens.
    TTS_TPU_KV_DTYPE=float32: the runner's caches are float32 on K6's
    route; the engine (K9, the batched persistent step, its state float32)
    gives the runner's tokens on the engine's route (K8, persistent).
    TTS_TPU_MEGAKERNEL=0: the runner teacher-forced against the CPU on the
    per-matmul route (check_small_orpheus: K1 and K4 on the card, no step
    kernel), and the engine's tokens equal to the runner's (K1 and K4)."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.orpheus import model as omodel
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine
    greedy = GenerationConfig(sample=False)
    prompts = ["hey?", "how are you doing?"]
    path = os.path.join(tmp, "orpheus-small-K6-d64.gguf")

    def runner():
        r = runner_from_file(path)
        r.cfg = dataclasses.replace(r.cfg, max_generation_size=SWITCH_STEPS)
        return r

    def tokens(r, p):
        out, n_out, _ = r.generate_tokens(p, greedy)
        return omodel.prepare_output_tokens(out, n_out)

    with small_orpheus_prompt_ids():
        log("Switches, small Orpheus: TTS_TPU_KV_DTYPE=float32")
        with env_set("TTS_TPU_KV_DTYPE", "float32"):
            r = runner()
            zero_counts()
            with recording(omodel, "kv_cache_dtype") as seen:
                k6 = {p: tokens(r, p) for p in prompts}
            want_f32(seen, "Orpheus runner")
            one = route_counts(("llama_flat_megastep",), ("decode_attention",
                                                          "llama_megastep"))
            eng = BatchedLlamaEngine(r.cfg, r.weights, r.tokenizer, n_slots=2,
                                     chunk=32)
            if eng.state.kv_k.dtype != torch.float32:
                raise AssertionError("Orpheus engine: caches not float32")
            r._mega, r._mega_ready = eng.mega, True
            zero_counts()
            k8 = {p: tokens(r, p) for p in prompts}
            route = route_counts(("llama_megastep",), ("llama_flat_megastep",))
            zero_counts()
            engine_parity("Orpheus f32 caches, K9", eng, prompts, k8.get,
                          lambda a, b: a == b)
            route_counts(("llama_megastep_batched",))
            log(f"  runner, f32 caches: K6 route {one} ({len(k6[prompts[1]][0])} "
                f"frames), the engine's route {route}")
        log("Switches, small Orpheus: TTS_TPU_MEGAKERNEL=0")
        with env_set("TTS_TPU_MEGAKERNEL", "0"):
            check_small_orpheus(tmp, n_steps=12, per_matmul=True)
            r = runner()
            zero_counts()
            want = {p: tokens(r, p) for p in prompts}
            one = route_counts(("quant_matmul", "decode_attention_batched"),
                               STEP_KERNELS)
            eng = BatchedLlamaEngine(r.cfg, r.weights, r.tokenizer, n_slots=2,
                                     chunk=32)
            if r.mega is not None or eng.mega is not None:
                raise AssertionError("TTS_TPU_MEGAKERNEL=0 left a fused route")
            zero_counts()
            engine_parity("Orpheus per matmul, K4", eng, prompts, want.get,
                          lambda a, b: a == b)
            many = route_counts(("quant_matmul", "decode_attention_batched"),
                                STEP_KERNELS)
            log(f"  runner {one}, engine {many}")


# ---------------------------------------------------------------------------
# phase 7: the Orpheus main path at Orpheus-3B width, and the K8 route
# ---------------------------------------------------------------------------

ORPHEUS_PATH = ("quant_matmul", "llama_flat_megastep")
# the Orpheus CLI's generation window, of the model's 2100 tokens: a depth
# cut that keeps the script in its time; its K6 positions reach ~1040, and
# check_llama holds K6 up to row 3583
ORPHEUS_CLI_TOKENS = 1024
# kernels the Orpheus single stream must not launch: K6 and K8 run their
# GEMVs and attention inside their one launch
ORPHEUS_NOT_PATH = ("decode_attention", "decode_attention_batched",
                    "llama_megastep_batched", "llama_flat_megastep_batched")
ORPHEUS_KERNELS_PER_STEP = 75   # the Orpheus CLI's device trace may show at most
K8_ROUTE_STEPS = 64
K9_ROUTE_STEPS = 64
TOKEN_AUDIO_S = 2048 / 7 / 24000   # 7 tokens -> 4 SNAC frames of 512 samples


def run_orpheus_main_path(tmp) -> tuple[dict, dict]:
    """Orpheus-3B Q4_0 (Q4_0 head) + SNAC-24k text -> WAV through the port's
    CLI on the card (sampled, top-k 50, fixed seed, up to
    ORPHEUS_CLI_TOKENS tokens);
    counters set to 0 just before, read just after: K1 and K6 must have
    risen, and neither K3 nor a launch-sequence GEMV (K6 runs them inside
    its one launch). Then the same path timed stage by stage (one K6 launch
    a decode step) and a device trace of 32 decode steps (at most
    ORPHEUS_KERNELS_PER_STEP kernels a step), and the K8 route: the loaded
    weights with the head swapped for an F16 one, 64 decode steps through
    the runner's decode loop, one K8 launch a step."""
    from tts_tpu_torch.apps import cli
    from tts_tpu_torch.audio.wav import read_audio_file
    from tts_tpu_torch.common import GenerationConfig, kv_cache_dtype
    from tts_tpu_torch.models.orpheus import model as omodel
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.ops import sampling
    from tts_tpu_torch.ops.llama_flat import LlamaFlat
    from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine
    path = os.path.join(tmp, "orpheus-3b-q4.gguf")
    t0 = time.perf_counter()
    write_orpheus(path, np.random.default_rng(SEED), n_layers=ORPHEUS["n_layers"],
                  hidden=ORPHEUS["hidden"], heads=ORPHEUS["heads"],
                  kv_heads=ORPHEUS["kv_heads"], ffn=ORPHEUS["ffn"],
                  vocab=ORPHEUS["vocab"], q4_head=True,
                  snac_dims=SNAC_24K["dims"], snac_latent=SNAC_24K["latent"],
                  max_generation=ORPHEUS_CLI_TOKENS)
    log(f"Orpheus main path: wrote {os.path.getsize(path) / 1e6:.1f} MB GGUF in "
        f"{time.perf_counter() - t0:.1f} s; voice {VOICE!r}, prompt {PROMPT!r}")
    wav = os.path.join(tmp, "orpheus.wav")
    zero_counts()
    t0 = time.perf_counter()
    rc = cli.main(["-mp", path, "-p", PROMPT, "-v", VOICE, "-sp", wav,
                   "--seed", str(SEED)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts("Orpheus CLI")
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    audio, rate = read_audio_file(wav)
    log(f"  CLI wrote {wav} in {cli_s:.1f} s (load included): {audio.size} "
        f"samples at {rate} Hz; launches {launches}")
    if rate != 24000 or audio.size == 0 or audio.size % 2048 or \
            not np.all(np.isfinite(audio)) or np.abs(audio).max() > 1.0:
        raise AssertionError("CLI output is not a valid waveform")
    for n in ORPHEUS_PATH:
        if launches[n] == 0:
            raise AssertionError(f"kernel {n} was not launched on the Orpheus path")
    for n in ORPHEUS_NOT_PATH + ("llama_megastep",):
        if launches[n]:
            raise AssertionError(f"kernel {n} was launched on the Orpheus path")

    # the same path, stage by stage, synchronized
    t0 = time.perf_counter()
    r = runner_from_file(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg, w, inv = r.cfg, r.weights, r.inv_freq
    if not isinstance(r.mega.step, LlamaFlat):
        raise AssertionError("Orpheus-3B with a Q4_0 head did not take K6")
    ids = r._prompt_ids(PROMPT, VOICE)
    shape = (cfg.n_layers, cfg.n_kv_heads, omodel.cache_ctx(cfg), cfg.head_size)
    kk = torch.zeros(shape, dtype=kv_cache_dtype(DEV), device=DEV)
    vv = torch.zeros_like(kk)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    kw = dict(do_sample=True, temperature=1.0, top_k=50, top_p=1.0,
              repetition_penalty=1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = omodel.orpheus_prefill(cfg, w, inv, torch.tensor(ids, device=DEV),
                                    kk, vv)
    first, _ = sampling.sample_or_greedy(gen, logits[None], sampling.init_state(1, DEV),
                                         **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = {n: k.launches for n, k in KERNELS.items()}
    out, n_out = omodel.orpheus_generate_tokens_chunked(
        cfg, w, inv, first, len(ids), kk, vv, gen,
        max_steps=cfg.max_generation_size, mega=r.mega, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    steps = n_out - 1
    per_step = {n: (k.launches - before[n]) / steps for n, k in KERNELS.items()}
    out_np = out.cpu().numpy()
    t3 = time.perf_counter()
    wav_np = r.vocode(out_np, n_out, SEED)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    audio_s = wav_np.size / 24000.0
    stats = dict(prompt_tokens=len(ids), load_s=load_s,
                 prefill_ms=(t1 - t0) * 1e3, tokens=n_out, decode_steps=steps,
                 decode_ms_per_step=(t2 - t1) * 1e3 / steps,
                 snac_ms=(t4 - t3) * 1e3, audio_s=audio_s,
                 audio_s_per_wall_s=audio_s / (t4 - t0),
                 decode_audio_s_per_wall_s=steps * TOKEN_AUDIO_S / (t2 - t1),
                 launches_per_step=per_step)
    log(f"  timed: {json.dumps(stats)}")
    tokens = torch.tensor(ids, device=DEV)
    prefill_device(f"Orpheus prefill ({len(ids)} tokens)", lambda: omodel.orpheus_prefill(
        cfg, w, inv, tokens, kk, vv))
    if n_out != cfg.max_generation_size and out_np[n_out - 1] != cfg.stopping_token_id:
        raise AssertionError(f"generation stopped at {n_out} tokens without "
                             f"the stopping token")
    if wav_np.size != 4 * (n_out // 7) * 512 or not np.all(np.isfinite(wav_np)):
        raise AssertionError("timed run produced the wrong shape")
    if not ((out_np[:n_out] >= 0) & (out_np[:n_out] < cfg.vocab_size)).all():
        raise AssertionError("a token is out of the vocabulary")
    # a steady window of 32 decode steps, from the prompt's end again
    st = omodel.init_state(cfg, first, len(ids), kk, vv, cfg.max_generation_size)
    before = {n: KERNELS[n].launches for n in ("llama_flat_megastep",) + ORPHEUS_NOT_PATH}
    st = device_trace(lambda: omodel.decode_chunk(
        cfg, w, inv, st, 32, gen, mega=r.mega,
        max_steps=cfg.max_generation_size, **kw), "Orpheus decode (K6)", 32)
    if int(st.n_out) != 33:
        raise AssertionError("traced decode window produced the wrong count")
    window = {n: (KERNELS[n].launches - b) / 32 for n, b in before.items()}
    if window.pop("llama_flat_megastep") != 1 or any(window.values()) or \
            last_trace is None or last_trace["kernels"] > ORPHEUS_KERNELS_PER_STEP:
        raise AssertionError(f"Orpheus decode: launches a step {window}, "
                             f"device trace {last_trace}: want one K6 launch a "
                             f"step, no launch sequence and at most "
                             f"{ORPHEUS_KERNELS_PER_STEP} kernels a step")
    log(f"  Orpheus decode: 1 K6 launch a step, {last_trace['kernels']:.1f} "
        f"kernels a step in the device trace (at most "
        f"{ORPHEUS_KERNELS_PER_STEP}): ok")

    # the runner's greedy stream (K6) over the whole window: its tokens
    # equal generate_tokens', its waveform the SNAC decode of them
    greedy = GenerationConfig(sample=False, seed=SEED, voice=VOICE)
    g_out, g_n, _ = r.generate_tokens(PROMPT, greedy)
    want = omodel.prepare_output_tokens(g_out, g_n)
    full = r.vocode(g_out, g_n, SEED)
    with recording(omodel, "prepare_output_tokens") as seen:
        chunks, first_s, total_s = timed_stream(r.generate_stream(PROMPT, greedy))
    if seen[-1] != want:
        raise AssertionError("Orpheus stream: its tokens differ from "
                             "generate_tokens'")
    hold_stream(f"Orpheus runner, K6, {g_n} tokens", chunks, full, first_s,
                total_s, 24000)

    # the K8 route: the same layers with an F16 head (as the quantizer leaves
    # it without -qh), through the runner's decode loop
    head = w.head.dense()[:cfg.vocab_size].to(torch.float16).float()
    r8 = omodel.OrpheusRunner(cfg, w._replace(head=head), r.tokenizer, r.snac)
    if not isinstance(r8.mega.step, lm.LlamaMegaLayers):
        raise AssertionError("the F16 head did not take the K8 route")
    del r
    torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    out8, n8 = omodel.orpheus_generate_tokens_chunked(
        cfg, r8.weights, inv, first, len(ids), kk, vv, gen,
        max_steps=K8_ROUTE_STEPS + 1, mega=r8.mega, **kw)
    torch.cuda.synchronize()
    k8_launches = {n: k.launches for n, k in KERNELS.items()}
    t8 = (time.perf_counter() - t0) * 1e3 / (n8 - 1)
    toks = out8[:n8].cpu()
    log(f"  K8 route (F16 head): {n8 - 1} decode steps, {t8:.4f} ms/step; "
        f"launches {k8_launches}")
    if n8 != K8_ROUTE_STEPS + 1 or \
            k8_launches["llama_megastep"] != K8_ROUTE_STEPS or \
            k8_launches["llama_flat_megastep"] or \
            any(k8_launches[n] for n in ORPHEUS_NOT_PATH) or \
            bool((toks < 0).any()) or bool((toks >= cfg.vocab_size).any()):
        raise AssertionError("the K8 route did not decode through K8, one "
                             "launch a step")
    del kk, vv
    torch.cuda.empty_cache()

    # the K9 route: the batched engine on the same F16-head weights, 8 slots
    # (prompts of mixed length, sampled), K9_ROUTE_STEPS batched steps
    eng = BatchedLlamaEngine(cfg, r8.weights, r8.tokenizer, n_slots=8,
                             chunk=K9_ROUTE_STEPS // 2)
    if not isinstance(eng.mega.step, lm.LlamaMegaLayers):
        raise AssertionError("the F16 head did not take the K9 route")
    texts = serving_prompts(r8.tokenizer, n=8)
    for i, text in enumerate(texts):
        eng.submit(text, GenerationConfig(voice=VOICE, top_k=50, seed=i))
    torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    t9 = (time.perf_counter() - t0) * 1e3 / K9_ROUTE_STEPS
    k9_launches = {n: k.launches for n, k in KERNELS.items()}
    st = eng.state
    n_out = st.n_out.cpu()
    toks = st.out_tokens.cpu()
    log(f"  K9 route (F16 head, batched engine, 8 slots): {K9_ROUTE_STEPS} "
        f"batched steps, {t9:.4f} ms per step (host clock, prefill of the "
        f"8 prompts before); tokens per slot {n_out.tolist()}; launches "
        f"{k9_launches}")
    for s in range(8):
        n, t = int(n_out[s]), toks[s, :int(n_out[s])]
        # every step until the stopping token (if one was sampled) is real
        if n != K9_ROUTE_STEPS + 1 and t[-1] != cfg.stopping_token_id or \
                bool((t < 0).any()) or bool((t >= cfg.vocab_size).any()):
            raise AssertionError(f"K9 route slot {s}: {n} tokens, out of "
                                 f"range or stopped early")
    if k9_launches["llama_megastep_batched"] != K9_ROUTE_STEPS or \
            k9_launches["llama_flat_megastep_batched"] or \
            k9_launches["decode_attention_batched"]:
        raise AssertionError("the K9 route did not decode through K9, one "
                             "launch a batched step")
    return launches, k8_launches, k9_launches


# ---------------------------------------------------------------------------
# phase 8: serving Orpheus-3B, continuous batching through the HTTP server
# ---------------------------------------------------------------------------

ORPHEUS_SERVING_PATH = ("quant_matmul", "llama_flat_megastep_batched")
GREEDY_TOKENS = 200   # the greedy parity check's generation window
# Orpheus serving's generation window, a third of the model's 2100 tokens:
# a depth cut that keeps the whole script in its time with phases 16-17 and
# the quantize tool's phase 4b
ORPHEUS_SERVING_TOKENS = 700


def set_gguf_u32(path, key: str, value: int) -> None:
    """Rewrite one u32 metadata value of a GGUF in place (same width:
    nothing after it moves), then read it back."""
    from tts_tpu_torch.gguf import GGUFReader
    from tts_tpu_torch.gguf.reader import T_U32
    name = key.encode()
    tag = len(name).to_bytes(8, "little") + name + T_U32.to_bytes(4, "little")
    with open(path, "r+b") as f:
        head = f.read(1 << 20)       # the keys written before the vocab
        at = head.find(tag)
        if at < 0 or head.find(tag, at + 1) >= 0:
            raise ValueError(f"{path}: no single u32 {key!r} in the header")
        f.seek(at + len(tag))
        f.write(value.to_bytes(4, "little"))
    got = GGUFReader(path).metadata[key]
    if got != value:
        raise AssertionError(f"{path}: {key} reads {got} after writing {value}")


def run_orpheus_serving(path) -> dict:
    """The Orpheus serving path (`serving_burst` with a voice on every
    request: K1 and K7 must have been launched; K7's batched step is 2
    launches a step at 8 slots, its layer stack's and its head's, with no
    K4), then the engine's greedy tokens against the single-stream
    runner's (K6). Returns the launch counts of the 12 requests."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.orpheus import model as omodel
    from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine
    params = [dict(p, seed=i) for i, p in enumerate(serving_params(voice=VOICE))]
    runner, prompts, stats, launches = serving_burst(
        path, BatchedLlamaEngine, params, 24000, 2048, ORPHEUS_SERVING_PATH,
        "Orpheus")
    per = stats["launches_per_batched_step"]
    log(f"  Orpheus batched step at 8 slots: {per['llama_flat_megastep_batched']} "
        f"K7 launches a step (the batched persistent step and the head GEMV), "
        f"{per['decode_attention_batched']} K4")
    if per["llama_flat_megastep_batched"] != 2 or per["decode_attention_batched"]:
        raise AssertionError("the Orpheus batched step is not K7's 2 launches "
                             "a step")
    lens = [len(runner._prompt_ids(p, VOICE)) for p in prompts]
    log(f"  Orpheus prompt tokens {lens}; tokens per request (whole 7-token "
        f"groups, from the audio): {round(stats['audio_s'] / 12 / TOKEN_AUDIO_S)}"
        f" on average")

    # greedy parity: 2 greedy requests among 4 sampled ones in 8 slots
    # against the single-stream runner (K6), generation cut to
    # GREEDY_TOKENS tokens (parity needs no more)
    cfg = dataclasses.replace(runner.cfg, max_generation_size=GREEDY_TOKENS)
    single = copy.copy(runner)
    single.cfg = cfg
    single._mega, single._mega_ready = runner.mega, True
    eng = BatchedLlamaEngine(cfg, runner.weights, runner.tokenizer, n_slots=8,
                             chunk=32)
    greedy = GenerationConfig(sample=False, voice=VOICE)
    picks = [0, 4, 8, 11, 2, 6]
    rids = [eng.submit(prompts[i], greedy if j < 2 else GenerationConfig(
        **params[i])) for j, i in enumerate(picks)]
    eng.run_until_done()
    for rid, i in zip(rids[:2], picks):
        out, n_out, _ = single.generate_tokens(prompts[i], greedy)
        want = omodel.prepare_output_tokens(out, n_out)
        if eng.results[rid] != want:
            raise AssertionError(f"greedy tokens of the engine differ from the "
                                 f"runner's for prompt {i} ({lens[i]} tokens)")
    log(f"  greedy parity: 2 greedy requests among 4 sampled ones in 8 slots "
        f"give the single-stream runner's (K6's) tokens exactly "
        f"({GREEDY_TOKENS} tokens each): ok")
    return launches


# ---------------------------------------------------------------------------
# Dia-1.6B: K10 and K11 against their plain versions
# ---------------------------------------------------------------------------

# Dia-1.6B: nari-labs' config (the JAX package's DiaConfig defaults): a
# 12-layer encoder of H 1024 (16 heads of 128, F 4096) over a 1024-byte
# window, an 18-layer decoder of H 2048 (16 q / 4 kv heads of 128, F 8192,
# cross-attention 16 x 128), 9 codebooks of vocab 1028, the DAC-44k decoder.
# The one cut: max_generation_size 512 of 3072 in the GGUF, so that the
# runs fit in the script's time (the kernel checks keep the 3072-row
# cache).
DIA = dict(enc_layers=12, enc_hidden=1024, enc_heads=16, enc_ffn=4096,
           n_layers=18, hidden=2048, heads=16, kv_heads=4, ffn=8192, n_out=9,
           vocab=1028, tc=1024, max_gen=512)
DIA_CTX = 3072                                 # the published cache rows
DIA_POS = (0, 255, 256, 1000, 3071)            # around K4's 256-row pages
DIA_BUCKETS = ((128, 896), (1024, 0))          # (Sb, n_tail)
DIA_YARDSTICK = (0, 17)                        # compared with the CPU yardstick
DIA_SLOTS = {4: (0, 255, 256, 3000),
             8: (0, 255, 256, 257, 511, 1000, 2047, 3071)}
DiaStepLayer = collections.namedtuple(
    "DiaStepLayer", dm.DiaMegaLayers._fields + ("ck", "cv", "vtail"))


def dia_source_weights(gen, qtype=quants.GGML_TYPE_Q4_0, n_layers=None):
    """Random Dia-1.6B decoder weights on the card before the step's prep
    (a stacked DiaDecoderLayer of `n_layers` (default all 18), Q4_0 packed
    or Q5_0 / Q8_0 bytes, bf16 scales) and the head size."""
    from tts_tpu_torch.models.dia.model import DiaDecoderLayer
    L, H, F = n_layers or DIA["n_layers"], DIA["hidden"], DIA["ffn"]
    kvn = DIA["kv_heads"] * H // DIA["heads"]

    def vec():
        return torch.randn((L, H), generator=gen, device=DEV) * 0.1 + 1.0

    def sq(n, k):
        return stack_quant(gen, L, n, k, qtype=qtype)

    lw = DiaDecoderLayer(
        vec(), sq(H, H), sq(kvn, H), sq(kvn, H), sq(H, H), vec(), sq(H, H),
        None, None, sq(H, H), vec(), sq(F, H), sq(F, H), sq(H, F))
    return lw, H // DIA["heads"]


def dia_kernel_weights(gen, qtype=quants.GGML_TYPE_Q4_0, n_layers=None):
    """Random Dia-1.6B decoder weights on the card in K10's layout (bf16
    scales, tiled for the GEMV; dia_source_weights) and the step's keyword
    arguments."""
    lw, d = dia_source_weights(gen, qtype, n_layers)
    mega, qt = dm.prep_dia_mega(lw, d)
    return mega, dict(qtype=qt, n_heads=DIA["heads"], n_kv=DIA["kv_heads"])


def dia_cross(gen, lead, sb):
    """Random bucketed cross K/V (bf16, (L, *lead, heads, sb, D)) and the
    tail's V sums (f32, (L, *lead, heads, D)) on the card."""
    d = DIA["hidden"] // DIA["heads"]
    shape = (DIA["n_layers"], *lead, DIA["heads"], sb, d)
    ck, cv = ((torch.randn(shape, generator=gen, device=DEV) * 0.5)
              .to(torch.bfloat16) for _ in range(2))
    vt = torch.randn((DIA["n_layers"], *lead, DIA["heads"], d), generator=gen,
                     device=DEV) * 8
    return ck, cv, vt


def dia_step(fn):
    """A Dia step in `layer_errors`' form: the weights of one layer come
    with that layer's cross K/V (DiaStepLayer)."""
    def run(w, x, kc, vc, pos, **kw):
        return fn(dm.DiaMegaLayers(*w[:len(dm.DiaMegaLayers._fields)]), x, kc,
                  vc, pos, w.ck, w.cv, w.vtail, **kw)
    return run


def one_dia_layer(mega, ck, cv, vt):
    return lambda l: DiaStepLayer(*(t[l:l + 1] for t in (*mega, ck, cv, vt)))


def other_order_dia_plain(*a, **k):
    """K10's plain version summed in another order (other_order)."""
    with other_order():
        return dm.dia_megastep_plain(*a, **k)


def other_order_dia_batched_plain(*a, **k):
    """K11's plain version summed in another order (other_order)."""
    with other_order():
        return dm.dia_megastep_batched_plain(*a, **k)


def dia_bound(mega, rows, kv_rows, cross, sb):
    """(bound_ms, bound_by, MB of weights, MB of K/V) of a Dia step over
    `rows` rows: weights, norms, the bucketed cross K/V and the tail sums
    read once; `kv_rows` self-attention K/V rows (summed over the rows'
    caches, bf16) read; x in and out, each row's k/v written (f32 out, bf16
    cache); 2 operations per weight and row, 4 per attended element and
    head."""
    L, H, heads, nkv = DIA["n_layers"], DIA["hidden"], DIA["heads"], DIA["kv_heads"]
    d = H // heads
    wbytes = tensor_bytes(mega)
    kv_bytes = 2 * L * nkv * kv_rows * d * 2
    n_weights = sum(t.numel() for t in mega if t.dtype == torch.uint8) * 2
    flops = 2 * rows * n_weights + 4 * L * heads * d * (kv_rows + rows * sb)
    io = 2 * rows * H * 4 + rows * L * 2 * nkv * d * (4 + 2)
    b_ms, b_by = bound(wbytes + kv_bytes + tensor_bytes(cross) + io, flops,
                       "bf16")
    return b_ms, b_by, wbytes / 1e6, kv_bytes / 1e6


def dia_sequence(mega, x, kc, vc, pos, ck, cv, vt, n_tail, **kw):
    """K10's function through the launch sequence (6 GEMV, 1 K4 and 1
    cross-attention launch a layer): K11 at one pair, on views of the same
    caches (written in place) and of K10's cross K/V (L, 2 heads, Sb, D)."""
    heads = kw["n_heads"]
    return dm.dia_megastep_batched_cuda(
        mega, x, kc[:, None], vc[:, None], pos,
        *(t.unflatten(1, (2, heads))[:, None] for t in (ck, cv, vt)), n_tail,
        **kw)


def dia_equal_sequence(mega, x, kc, vc, ck, cv, vt, n_tail, kw, label) -> None:
    """At each of DIA_POS: K10 (one launch) and the launch sequence on
    copies of the same state give the same x_out, k_new, v_new and caches,
    bit for bit; raises otherwise."""
    for p in DIA_POS:
        pos = torch.tensor([p], dtype=torch.int32, device=DEV)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got = dm.dia_megastep_cuda(mega, x, k1, v1, pos, ck, cv, vt, n_tail, **kw)
        seq = dia_sequence(mega, x, k2, v2, pos, ck, cv, vt, n_tail, **kw)
        if not (all(torch.equal(a, b) for a, b in zip(got, seq))
                and torch.equal(k1, k2) and torch.equal(v1, v2)):
            raise AssertionError(f"K10 differs from the launch sequence: "
                                 f"{label}, pos {p}")
        del k1, v1, k2, v2
    log(f"  {label}: x_out, k_new, v_new and both caches equal the launch "
        f"sequence's (K11 at one pair) bit for bit at positions "
        f"{list(DIA_POS)} (max_abs_err 0): ok")


def check_dia(gen, mega, kw) -> dict:
    """K10, the persistent step (one cooperative launch), at Dia-1.6B width:
    the cross-attention kernel alone (with and without a tail); then at
    DIA_POS x DIA_BUCKETS (Sb 128 with an 896-row tail, Sb 1024 with none)
    bit for bit against the launch sequence (K11 at one pair), and layer by
    layer against its plain version, judged against the yardstick pair;
    Q5_0 and Q8_0 weights on 2 layers bit for bit against the launch
    sequence likewise; the cache rows it writes; then timed at pos 1000
    over the engine's bucket (256, tail 768) beside the launch sequence, in
    turns, with the grid it launched and a device trace of each."""
    log("K10 dia_megastep (csrc/dia_flat.cu: one cooperative launch a step) "
        "vs the launch sequence (K11 at one pair) and dia_megastep_plain, "
        f"Dia-1.6B width, bf16 cache of {DIA_CTX} rows, positions "
        f"{list(DIA_POS)}, buckets (Sb, n_tail) {list(DIA_BUCKETS)}:")
    L, H, heads, nkv = DIA["n_layers"], DIA["hidden"], DIA["heads"], DIA["kv_heads"]
    d = H // heads
    for line in ptxas_summary("dia_flat"):
        log(f"  ptxas dia_flat: {line}")
    errs = []
    why = "f32 softmax over the same values, sums in another order"
    for sb, nt in DIA_BUCKETS + ((256, 768),):
        ck, cv, vt = (t[0] for t in dia_cross(gen, (2,), sb))
        q = torch.randn((2, heads, d), generator=gen, device=DEV)
        for tail in sorted({nt, 0}):
            errs.append(check_close(
                f"cross-attention Sb {sb} n_tail {tail}",
                dm.cross_attention_cuda(q, ck, cv, vt, tail),
                dm.cross_attention_plain(q, ck, cv, vt, tail), 1e-5, why))
    shape = (L, 2, nkv, DIA_CTX, d)
    kc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((2, H), generator=gen, device=DEV)
    err, base = defaultdict(list), defaultdict(list)
    for sb, nt in DIA_BUCKETS:
        ck, cv, vt = (t.flatten(1, 2) for t in dia_cross(gen, (2,), sb))
        dia_equal_sequence(mega, x, kc, vc, ck, cv, vt, nt, kw,
                           f"Q4_0, {L} layers, Sb {sb} n_tail {nt}")
        for p in DIA_POS:
            pos = torch.tensor([p], dtype=torch.int32, device=DEV)
            errs += layer_errors(one_dia_layer(mega, ck, cv, vt), L, x, kc, vc,
                                 pos, dict(kw, n_tail=nt),
                                 dia_step(dm.dia_megastep_cuda),
                                 dia_step(dm.dia_megastep_plain), "K10", err,
                                 base, layers=DIA_YARDSTICK,
                                 alt=dia_step(other_order_dia_plain), slots=True)
    judge_layers(err, base, "K10", f"K10 layers {list(DIA_YARDSTICK)} x 2 rows "
                 f"at positions {list(DIA_POS)} x buckets {list(DIA_BUCKETS)}, "
                 f"layer by layer, yardstick the larger of plain on the CPU "
                 f"and plain summed in another order vs plain on the card")
    for qt in (quants.GGML_TYPE_Q5_0, quants.GGML_TYPE_Q8_0):
        qmega, qkw = dia_kernel_weights(gen, qt, n_layers=2)
        for sb, nt in DIA_BUCKETS:
            ck, cv, vt = (t[:2].flatten(1, 2) for t in dia_cross(gen, (2,), sb))
            dia_equal_sequence(qmega, x, kc[:2], vc[:2], ck, cv, vt, nt, qkw,
                               f"qtype {qt}, 2 layers, Sb {sb} n_tail {nt}")
        del qmega
    p = 1000
    pos = torch.tensor([p], dtype=torch.int32, device=DEV)
    ck, cv, vt = (t.flatten(1, 2) for t in dia_cross(gen, (2,), 256))
    k1, v1 = kc.clone(), vc.clone()
    got = dm.dia_megastep_cuda(mega, x, k1, v1, pos, ck, cv, vt, 768, **kw)
    rows = torch.arange(DIA_CTX, device=DEV) != p
    if not (torch.equal(k1[:, :, :, rows], kc[:, :, :, rows]) and
            torch.equal(v1[:, :, :, rows], vc[:, :, :, rows])):
        raise AssertionError("K10 wrote cache rows other than pos")
    errs.append(check_close("pos 1000 cache row k", k1[:, :, :, p].float(),
                            got[1].reshape(L, 2, nkv, d).to(torch.bfloat16).float(),
                            0.0, "the written row is k_new in bf16"))
    del k1, v1

    def k10():
        dm.dia_megastep_cuda(mega, x, kc, vc, pos, ck, cv, vt, 768, **kw)

    def seq():
        dia_sequence(mega, x, kc, vc, pos, ck, cv, vt, 768, **kw)

    def k10_device_ms():
        """K10's launch alone, per launch the trace recorded (the profiler
        has dropped some of a cooperative kernel's events), beside the
        events it recorded of the 20 calls."""
        for _ in range(3):
            dt = device_ms(k10)
            name = next((k for k in dt.by_name if k.startswith("dia_flat_kernel")), None)
            if name is not None:
                log(f"  K10: {dt.counts[name] * 20:.0f} of 20 launches in the "
                    f"trace, {dt.ms:.4f} ms of device time a call with the "
                    f"copy of x")
                return dt.by_name[name] / dt.counts[name]
        raise RuntimeError("torch.profiler recorded no K10 launch")

    # in turns: sequence, K10, K10, sequence; with the host and device time
    times = [cuda_ms(fn, iters=20) for fn in (seq, k10, k10, seq)]
    dtimes = [device_ms(seq).ms, k10_device_ms(), k10_device_ms(),
              device_ms(seq).ms]
    ms = min(dtimes[1:3])
    plain_ms = device_ms(lambda: dm.dia_megastep_plain(
        mega, x, kc, vc, pos, ck, cv, vt, 768, **kw), iters=3, warmup=1).ms
    b_ms, b_by, wmb, kvmb = dia_bound(mega, 2, 2 * (p + 1), (ck, cv, vt), 256)
    smem = dfl.smem_bytes(H, DIA["ffn"])
    log(f"  {L} layers, pos {p}, Sb 256: K10 {times[1]:.4f} / {times[2]:.4f} "
        f"ms/step (1 launch of {dfl.launched_blocks} blocks of 256 threads, "
        f"{dfl.blocks_per_sm} an SM, {smem} bytes of dynamic shared memory; "
        f"{8 * L - 1} grid barriers), launch sequence {times[0]:.4f} / "
        f"{times[3]:.4f} ms/step ({6 * L} gemv + {L} K4 + {L} cross "
        f"launches), with the host's launch path; device time K10 "
        f"{dtimes[1]:.4f} / {dtimes[2]:.4f}, launch sequence {dtimes[0]:.4f} / "
        f"{dtimes[3]:.4f} ms/step; plain {plain_ms:.4f} ms, bound {b_ms:.4f} "
        f"ms ({b_by}; {wmb:.1f} MB weights + {kvmb:.1f} MB KV + "
        f"{tensor_bytes((ck, cv, vt)) / 1e6:.1f} MB cross), library none")
    items = dfl.attention_items(heads, nkv, p, DIA_CTX, 256)
    log(f"  K10's phases a layer on {dfl.launched_blocks} blocks: " + ", ".join(
        f"{ph.name} {ph.items} (tile, K range) items of {ph.stages} stages, "
        f"{dfl.warps_with_items(ph, dfl.launched_blocks)} warps busy"
        for ph in dfl.gemv_phases(H, DIA["ffn"], heads, nkv))
        + f"; {items[0]} self- and {items[1]} cross-attention page items")
    device_trace(lambda: [k10() for _ in range(5)], f"K10 step alone, pos {p}", 5)
    device_trace(lambda: [seq() for _ in range(5)],
                 f"launch sequence alone, pos {p}", 5)
    del kc, vc
    torch.cuda.empty_cache()
    return dict(name="dia_megastep", route="cuda",
                source="tts_tpu_torch/csrc/dia_flat.cu",
                replaces="tts_tpu/ops/dia_megastep.py:148",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_dia_batched(gen, mega, kw) -> dict:
    """K11 at Dia-1.6B width: at 4 and 8 pairs at mixed positions (one at
    0, both sides of K4's pages), each pair's outputs and caches bit for
    bit against K10 on that pair's state; at 8 pairs layer by layer against
    the plain version (each row a case, the yardstick the larger of plain
    on the CPU and plain summed in another order); timed."""
    log("K11 dia_megastep_batched (csrc/dia_megastep.cu + K4 + the "
        "cross-attention) vs K10 and dia_megastep_batched_plain, Dia-1.6B "
        f"width, bf16 caches of {DIA_CTX} rows, cross bucket 256 (n_tail 768):")
    L, H, heads, nkv = DIA["n_layers"], DIA["hidden"], DIA["heads"], DIA["kv_heads"]
    d = H // heads
    for b, slots in DIA_SLOTS.items():
        pos = torch.tensor(slots, dtype=torch.int32, device=DEV)
        shape = (L, b, 2, nkv, DIA_CTX, d)
        kc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
        vc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
        ck, cv, vt = dia_cross(gen, (b, 2), 256)
        x = torch.randn((2 * b, H), generator=gen, device=DEV)
        kb, vb = kc.clone(), vc.clone()
        got = dm.dia_megastep_batched_cuda(mega, x, kb, vb, pos, ck, cv, vt,
                                           768, **kw)
        for s in range(b):
            k1, v1 = kc[:, s].clone(), vc[:, s].clone()
            one = dm.dia_megastep_cuda(
                mega, x[2 * s:2 * s + 2], k1, v1, pos[s:s + 1],
                *(t[:, s].flatten(1, 2).contiguous() for t in (ck, cv, vt)),
                768, **kw)
            r = slice(2 * s, 2 * s + 2)
            if not (torch.equal(got[0][r], one[0]) and torch.equal(got[1][:, r], one[1])
                    and torch.equal(got[2][:, r], one[2])
                    and torch.equal(kb[:, s], k1) and torch.equal(vb[:, s], v1)):
                raise AssertionError(f"K11 pair {s} (pos {slots[s]}) differs "
                                     f"from K10 on its state")
        log(f"  K11 at {b} pairs, positions {list(slots)}: each pair's "
            f"outputs and caches equal K10 on that pair's state bit for bit "
            f"(max_abs_err 0): ok")
        del kb, vb, got
        if b != 8:
            del kc, vc
            continue
        err, base = defaultdict(list), defaultdict(list)
        errs = layer_errors(one_dia_layer(mega, ck, cv, vt), L, x, kc, vc, pos,
                            dict(kw, n_tail=768),
                            dia_step(dm.dia_megastep_batched_cuda),
                            dia_step(dm.dia_megastep_batched_plain), "K11", err,
                            base, layers=DIA_YARDSTICK,
                            alt=dia_step(other_order_dia_batched_plain), slots=True)
        judge_layers(err, base, "K11", f"K11 layers {list(DIA_YARDSTICK)} x 16 "
                     f"rows, layer by layer, yardstick the larger of plain on "
                     f"the CPU and plain summed in another order vs plain on the card")
        scratch = dm.step_scratch(mega, 2 * b, heads, DIA_CTX, 256, DEV)
        ms = step_ms(lambda: dm.dia_megastep_batched_cuda(
            mega, x, kc, vc, pos, ck, cv, vt, 768, scratch=scratch, **kw),
            f"K11 step at {b} pairs")
        plain_ms = device_ms(lambda: dm.dia_megastep_batched_plain(
            mega, x, kc, vc, pos, ck, cv, vt, 768, **kw), iters=2, warmup=1).ms
        b_ms, b_by, wmb, kvmb = dia_bound(mega, 2 * b, 2 * sum(p + 1 for p in slots),
                                          (ck, cv, vt), 256)
        log(f"  K11 {L} layers, 8 pairs at {list(slots)}: kernels (device time) {ms:.4f} ms "
            f"per batched step ({6 * L} gemv + {L} K4 + {L} cross launches), "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {wmb:.1f} "
            f"MB weights + {kvmb:.1f} MB KV + "
            f"{tensor_bytes((ck, cv, vt)) / 1e6:.1f} MB cross), library none")
        device_trace(lambda: [dm.dia_megastep_batched_cuda(
            mega, x, kc, vc, pos, ck, cv, vt, 768, scratch=scratch, **kw)
            for _ in range(5)], "K11 step alone, 8 pairs", 5)
        del kc, vc
    torch.cuda.empty_cache()
    return dict(name="dia_megastep_batched", route="cuda",
                source="tts_tpu_torch/csrc/dia_megastep.cu",
                replaces="tts_tpu/ops/dia_megastep.py:478",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------------------
# Dia GGUFs written with the port's writer
# ---------------------------------------------------------------------------

DIA_PROMPT = ("[S1] Dia is an open weights text to dialogue model. [S2] You "
              "get full control over scripts and voices.")
DIALOGUE = ("[S1] Oh fire! Oh my goodness! What's the procedure? What do we "
            "do, people? The smoke could be coming through an air duct! [S2] "
            "Oh my god! Okay, it's happening. Everybody stay calm! [S1] What's "
            "the procedure? [S2] Everybody stay calm! [S1] Look, we have to go "
            "now, right now, before it spreads.")


def write_dia(path, rng, *, enc_layers, enc_hidden, enc_heads, enc_ffn,
              n_layers, hidden, heads, kv_heads, ffn, n_out, vocab, tc,
              max_gen, dac_chans):
    """A Dia GGUF as `tts_tpu.apps.quantize -qt Q4_0 -qh` leaves one: Q4_0
    encoder and decoder projections (cross K/V too) and heads, F32 norms
    and embeddings, and a DAC decoder in F32. The heads' rows from EOS
    (1024) on have zero scales: their logits are exactly 0, which random
    weights at these widths (merged logits of std ~4) never sample, so
    every request runs the whole window."""
    d, ed = hidden // heads, enc_hidden // enc_heads
    w = GGUFWriter(path, "dia")
    for key, v in (("dia.attn_head_size", d), ("dia.eos_token_id", 1024),
                   ("dia.bos_token_id", 1026), ("dia.pad_token_id", 1025),
                   ("dia.max_delay", 15), ("dia.encoder.max_context_length", tc),
                   ("dia.encoder.attn_heads", enc_heads),
                   ("dia.encoder.layers", enc_layers),
                   ("dia.encoder.hidden_size", enc_hidden),
                   ("dia.decoder.hidden_size", hidden),
                   ("dia.decoder.layers", n_layers),
                   ("dia.decoder.output_heads", n_out),
                   ("dia.decoder.attn_heads", heads),
                   ("dia.decoder.query_heads", heads // kv_heads),
                   ("dia.decoder.output_vocab_size", vocab),
                   ("dia.decoder.audio_vocab_size", 1024),
                   ("dia.decoder.max_generation_size", max_gen),
                   ("dac.up_sampling_factor", 512)):
        w.add_u32(key, v)
    for i, (st, pad) in enumerate(zip((8, 8, 4, 2), (4, 4, 2, 1))):
        w.add_u32(f"dac.dac_layer_stride_{i}", st)
        w.add_u32(f"dac.dac_layer_padding_{i}", pad)
    Q4 = quants.GGML_TYPE_Q4_0

    def q4(name, n, k, zero_rows=0):
        raw = np.frombuffer(rand_q4_raw(rng, n, k), np.uint8).reshape(n, -1).copy()
        if zero_rows:   # the fp16 scale of every block of the last rows
            raw[n - zero_rows:].reshape(zero_rows, -1, 18)[:, :, :2] = 0
        w.add_raw_tensor(name, (n, k), Q4, raw.tobytes())

    def f32(name, *shape, scale=0.02, one=False):
        w.add_tensor(name, rng.standard_normal(shape, dtype=np.float32) * scale
                     + (1.0 if one else 0.0))

    e = "dia.encoder."
    f32(e + "embedding", 256, enc_hidden, scale=1.0)
    f32(e + "norm", enc_hidden, scale=0.1, one=True)
    for l in range(enc_layers):
        b = f"{e}layers.{l}."
        f32(b + "pre_sa_norm", enc_hidden, scale=0.1, one=True)
        f32(b + "post_sa_norm", enc_hidden, scale=0.1, one=True)
        for n in ("q_proj", "k_proj", "v_proj"):
            q4(b + n, enc_heads * ed, enc_hidden)
        q4(b + "o_proj", enc_hidden, enc_heads * ed)
        q4(b + "gate", enc_ffn, enc_hidden)
        q4(b + "up", enc_ffn, enc_hidden)
        q4(b + "wo", enc_hidden, enc_ffn)
    dd = "dia.decoder."
    f32(dd + "norm", hidden, scale=0.1, one=True)
    for l in range(n_layers):
        b = f"{dd}layers.{l}."
        for n in ("pre_sa_norm", "pre_ca_norm", "pre_mlp_norm"):
            f32(b + n, hidden, scale=0.1, one=True)
        q4(b + "self_q_proj", heads * d, hidden)
        q4(b + "self_k_proj", kv_heads * d, hidden)
        q4(b + "self_v_proj", kv_heads * d, hidden)
        q4(b + "self_o_proj", hidden, heads * d)
        q4(b + "cross_q_proj", heads * d, hidden)
        q4(b + "cross_k_proj", heads * d, enc_hidden)
        q4(b + "cross_v_proj", heads * d, enc_hidden)
        q4(b + "cross_o_proj", hidden, heads * d)
        q4(b + "gate", ffn, hidden)
        q4(b + "up", ffn, hidden)
        q4(b + "wo", hidden, ffn)
    for i in range(n_out):
        f32(f"{dd}embeddings.{i}", vocab, hidden, scale=0.5)
        q4(f"{dd}heads.{i}", vocab, hidden, zero_rows=vocab - 1024)
    add_dac(w, rng, dac_chans, n_out)
    w.write()


def dia_small_runners(tmp, hidden=256, heads=4, kv_heads=2,
                      name="dia-small.gguf", per_matmul=False):
    """A small Q4_0 Dia (L=2, H=256, 4/2 heads of 64 unless told otherwise,
    F 1024; a 1-layer encoder of H 128; 9 codebooks of 1028; a 1024-byte
    window; a small DAC) written to tmp/name and loaded on the card, on the
    CPU, and on the CPU with every decoder embedding moved by one ulp; on
    the K10 route, or the per-matmul one with `per_matmul`."""
    from tts_tpu_torch.models.registry import runner_from_file
    path = os.path.join(tmp, name)
    write_dia(path, np.random.default_rng(SEED + 3), enc_layers=1,
              enc_hidden=128, enc_heads=2, enc_ffn=256, n_layers=2,
              hidden=hidden, heads=heads, kv_heads=kv_heads, ffn=1024, n_out=9,
              vocab=1028, tc=1024, max_gen=64, dac_chans=(64, 32, 16, 8, 4))
    gen = torch.Generator().manual_seed(SEED)
    runners = [runner_from_file(path, device=dev) for dev in
               (DEV, torch.device("cpu"), torch.device("cpu"))]
    e = runners[2].weights.dec_embds
    e.mul_(1 + (torch.randint(0, 2, e.shape, generator=gen) * 2 - 1) * 2 ** -23)
    if per_matmul:
        if any(r.mega is not None for r in runners):
            raise AssertionError("small Dia must take the per-matmul route")
    elif any(r.mega is None or r.mega.persistent !=
             (hidden // heads in da.STEP_HEAD_SIZES) for r in runners):
        raise AssertionError("small Dia must take the K10 route (K11 at one "
                             "pair for heads other than 64 / 128)")
    return runners


def check_small_dia(tmp, hidden=256, heads=4, kv_heads=2,
                    name="dia-small.gguf", n_steps=48, per_matmul=False) -> None:
    """A small Q4_0 Dia: its encoder on the card against the CPU's (f32,
    1e-4 of the largest value); then greedy decoding on the CPU (plain
    versions) while the card (kernels) follows the same token history
    (teacher forcing) from the same cross K/V, float32 caches on both: the
    CFG-merged logits must match at every step, within 4x the CPU's own
    change when every decoder embedding moves by one ulp, or 1e-3 (the
    Parler check's rule). Then the CPU's codes vocoded on both. With
    `per_matmul` (TTS_TPU_MEGAKERNEL=0, or heads that are not a multiple of
    64) on the per-matmul route: K1 and K4 on the card, no step kernel. On
    the default GGUF the runtime switches follow (dia_switches)."""
    from tts_tpu_torch.models.dia import model as dmodel
    log(f"Reference: small Q4_0 Dia (decoder L=2, H={hidden}, {heads}/"
        f"{kv_heads} heads of {hidden // heads}; encoder L=1, H=128; "
        f"1024-byte window), f32 caches, {n_steps} steps, "
        f"{'per matmul' if per_matmul else 'K10'}, card kernels vs CPU "
        f"plain versions:")
    runners = dia_small_runners(tmp, hidden, heads, kv_heads, name, per_matmul)
    rg, rc, _ = runners
    cfg = rc.cfg
    ids = dmodel.tokenize_sentence(DIA_PROMPT, cfg)
    enc = [dmodel.encode_request(r.cfg, r.weights, ids) for r in (rg, rc)]
    enc_err = max(max_err(a.cpu(), b) / float(b.abs().max())
                  for a, b in zip(*enc))
    cross = dmodel.DiaCross(*dm.prep_dia_cross(*enc[1], len(ids)))
    crosses = [dmodel.DiaCross(*(t.to(DEV) for t in cross[:3]), cross.n_tail),
               cross, cross]
    kw = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
              repetition_penalty=1.0)
    states = []
    for r in runners:
        st = dmodel.init_state(cfg, n_steps + 1, r.device)
        states.append(st._replace(kv_k=st.kv_k.float(), kv_v=st.kv_v.float()))
    worst, sens, agree = 0.0, 0.0, 0
    zero_counts()
    with torch.no_grad():
        for _ in range(n_steps):
            lgs = []
            for r, st, cr in zip(runners, states, crosses):
                t_in, _, _ = dmodel.wind_down(cfg, st.tokens_in[None],
                                              st.delay_steps, st.pos, n_steps + 1)
                lgs.append(dmodel.step_logits(cfg, r.weights, t_in[0], st.pos,
                                              st.kv_k, st.kv_v, cr, r.mega))
            lg, lc, lp = lgs[0].cpu(), lgs[1], lgs[2]
            fin = torch.isfinite(lc)
            if not torch.equal(fin, torch.isfinite(lg)):
                raise AssertionError("card and CPU mask different tokens")
            scale = float(lc[fin].abs().max())
            worst = max(worst, max_err(lg[fin], lc[fin]) / scale)
            sens = max(sens, max_err(lp[fin], lc[fin]) / scale)
            agree += int((lg.argmax(-1) == lc.argmax(-1)).sum())
            new = [dmodel.decode_step(cfg, r.weights, st, cr, None,
                                      max_steps=n_steps + 1, mega=r.mega,
                                      logits=lgt.to(r.device), **kw)
                   for r, st, cr, lgt in zip(runners, states, crosses, lgs)]
            # the card and the perturbed run follow the CPU's history
            sc = new[1]
            states = [s._replace(tokens_in=sc.tokens_in.to(s.pos.device),
                                 delay_steps=sc.delay_steps.to(s.pos.device),
                                 done=sc.done.to(s.pos.device)) for s in new]
    tol = max(4 * sens, 1e-3)
    launched = route_counts(("quant_matmul", "decode_attention_batched"),
                            STEP_KERNELS) if per_matmul else \
        {n: c for n, c in read_counts().items() if c}
    log(f"  encoder cross K / V, max |card - cpu| / max: {enc_err:.3e} (tol "
        f"1e-4: f32, TF32 off); teacher-forced logits "
        f"({'per matmul' if per_matmul else 'K10'}, Sb "
        f"{cross.ck.shape[2]}, n_tail {cross.n_tail}): {worst:.3e}; the "
        f"CPU's own change under 1-ulp embedding changes: {sens:.3e}; tol "
        f"{tol:.3e}; argmax agreement {agree}/{n_steps * cfg.n_output_heads}; "
        f"launches {launched}")
    if enc_err > 1e-4 or worst > tol:
        raise AssertionError("small-model Dia differs between card and CPU")
    n = int(states[1].pos)
    codes = dmodel.adjust_output_tokens(states[1].out_tokens.cpu().numpy(), n, cfg)
    wa, wb = (r.dac.decode(codes) for r in (rg, rc))
    err = float(np.abs(wa - wb).max()) if codes.shape[0] else 0.0
    log(f"  {codes.shape[0]} frames vocoded on both: waveform max_abs_err "
        f"{err:.3e} (tol 1e-3: f32 convolutions, TF32 off, other sum order)")
    if codes.shape[0] != n - cfg.max_delay or wa.shape != (codes.shape[0] * 512,) \
            or wa.shape != wb.shape or err > 1e-3:
        raise AssertionError("small-model Dia waveform differs between card "
                             "and CPU")
    if name == "dia-small.gguf" and not per_matmul:
        dia_switches(tmp)


def dia_engine_vs_cpu(path, runner, prompts, label, n_steps=24) -> dict:
    """Greedy `prompts` through 2-slot Dia engines of the GGUF at `path` on
    the card (the runner's weights) and on the CPU (plain versions), one
    step at a time for n_steps, both from the CPU encoder's cross K/V and
    on float32 caches (TTS_TPU_KV_DTYPE=float32): after each step the card engine takes the CPU engine's token history
    (teacher forcing: the feed, wind-down, stop, positions and output
    rows), and the CFG-merged logits of every slot
    (batched_dia.cfg_logits, recorded) must match within 1e-3 of their
    largest (check_small_dia's floor, for a free-running greedy history
    parts at a near-tie). The engine reads the bucketed bf16 cross K/V with
    the tail fold, as the JAX engine does on this route. Returns the card
    run's launches."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime import batched_dia
    cpu_w = runner_from_file(path, device="cpu").weights
    encode = batched_dia.encode_request

    def cpu_encode(cfg, w, ids):
        # both engines decode from the CPU encoder's cross K/V: the card's
        # encoder is 1e-6 off it, which can move a bf16 element of the
        # bucketed cross K/V by one ulp (check_small_dia shares them too)
        return tuple(t.to(w.dec_embds.device) for t in encode(cfg, cpu_w, ids))

    engines = []
    batched_dia.encode_request = cpu_encode
    try:
        for w, dev in ((runner.weights, DEV), (cpu_w, torch.device("cpu"))):
            # float32 caches on both: on an H100 the card's default bf16
            # caches alone moved these logits by 5.0e-3 against the CPU's
            with env_set("TTS_TPU_KV_DTYPE", "float32"):
                eng = batched_dia.BatchedDiaEngine(runner.cfg, w, n_slots=2,
                                                   chunk=1, device=dev)
            if eng.state.kv_k.dtype != torch.float32:
                raise AssertionError(f"{label}: caches not float32")
            for p in prompts:
                eng.submit(p, GenerationConfig(sample=False))
            if any(r is None for r in eng.slot_req):
                raise AssertionError(f"{label}: a slot is idle")
            engines.append(eng)
    finally:
        batched_dia.encode_request = encode
    worst, agree, n = 0.0, 0, 0
    zero_counts()
    with recording(batched_dia, "cfg_logits") as seen:
        for _ in range(n_steps):
            for e in engines:
                e.state = batched_dia.batched_dia_decode_chunk(
                    e.cfg, e.weights, e.state, 1, e.generator, n_tail=e.n_tail,
                    mega=e.mega, scratch=e.scratch)
            lg, lc = seen[-2].cpu(), seen[-1]
            fin = torch.isfinite(lc)
            if not torch.equal(fin, torch.isfinite(lg)):
                raise AssertionError(f"{label}: card and CPU mask different "
                                     f"tokens")
            worst = max(worst, max_err(lg[fin], lc[fin]) /
                        float(lc[fin].abs().max()))
            agree += int((lg.argmax(-1) == lc.argmax(-1)).sum())
            n += lc.shape[0] * lc.shape[1]
            sc = engines[1].state
            engines[0].state = engines[0].state._replace(**{
                f: getattr(sc, f).to(DEV) for f in (
                    "tokens_in", "delay_steps", "done", "pos", "out_tokens")})
    torch.cuda.synchronize()
    launched = {k: c for k, c in read_counts().items() if c}
    log(f"  {label} (2 slots, {n_steps} steps teacher-forced): logits max "
        f"|card - cpu| / max|logit| {worst:.3e} (tol 1e-3); argmax agreement "
        f"{agree}/{n}; launches {launched}")
    if worst > 1e-3:
        raise AssertionError(f"{label}: logits differ between card and CPU")
    return launched


def dia_switches(tmp) -> None:
    """The small Dia (K10) under the JAX package's switches, on the card,
    2 prompts of 129-256 bytes (the runner's cross bucket is then the
    engine's). TTS_TPU_KV_DTYPE=float32: the runner's self-attention
    caches are float32 (its cross K/V stay packed bf16) on K10's route, and
    the engine's greedy codes (K11, its state float32) equal the runner's.
    TTS_TPU_MEGAKERNEL=0: the runner teacher-forced against the CPU on the
    per-matmul route (check_small_dia: K1 and K4 on the card, no step
    kernel); the engine (K1 and K4) reads the bucketed bf16 cross K/V where
    the runner reads the f32 window, as the JAX engine does, so it is held
    to the CPU engine, teacher-forced (dia_engine_vs_cpu)."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.dia import model as dmodel
    from tts_tpu_torch.models.dia.model import tokenize_sentence
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.batched_dia import BatchedDiaEngine
    greedy = GenerationConfig(sample=False)
    path = os.path.join(tmp, "dia-small.gguf")
    same = (lambda a, b: a.shape == b.shape and np.array_equal(a, b))
    log("Switches, small Dia: TTS_TPU_KV_DTYPE=float32")
    with env_set("TTS_TPU_KV_DTYPE", "float32"):
        r = runner_from_file(path)
        prompts = dia_prompts(n=2, lo=130, hi=250)
        if not all(128 < len(tokenize_sentence(p, r.cfg)) <= 256
                   for p in prompts):
            raise AssertionError("Dia prompts outside 129-256 bytes")
        zero_counts()
        with recording(dmodel, "kv_cache_dtype") as seen:
            want = {p: r.generate_codes(p, greedy) for p in prompts}
        want_f32(seen, "Dia runner")
        one = route_counts(("dia_megastep",), ("dia_megastep_batched",))
        eng = BatchedDiaEngine(r.cfg, r.weights, n_slots=2, chunk=32)
        if eng.state.kv_k.dtype != torch.float32:
            raise AssertionError("Dia engine: caches not float32")
        zero_counts()
        engine_parity("Dia f32 caches, K11", eng, prompts, want.get, same)
        many = route_counts(("dia_megastep_batched",), ("dia_megastep",))
        log(f"  runner, f32 caches: {one}; engine {many}")
    log("Switches, small Dia: TTS_TPU_MEGAKERNEL=0")
    with env_set("TTS_TPU_MEGAKERNEL", "0"):
        check_small_dia(tmp, name="dia-small-pm.gguf", n_steps=24,
                        per_matmul=True)
        r = runner_from_file(path)
        if r.mega is not None:
            raise AssertionError("TTS_TPU_MEGAKERNEL=0 left a fused route")
        launched = dia_engine_vs_cpu(path, r, prompts, "Dia per-matmul engine")
        for n in ("quant_matmul", "decode_attention_batched"):
            if not launched.get(n):
                raise AssertionError(f"Dia per-matmul engine: no {n} launch")
        if any(launched.get(n) for n in STEP_KERNELS):
            raise AssertionError(f"Dia per-matmul engine launched a step "
                                 f"kernel: {launched}")


# ---------------------------------------------------------------------------
# the Dia main path and Dia serving at Dia-1.6B width
# ---------------------------------------------------------------------------

DIA_PATH = ("quant_matmul", "dia_megastep")
DIA_KERNELS_PER_STEP = 95   # the Dia CLI's device trace may show at most
DIA_SERVING_PATH = ("quant_matmul", "decode_attention_batched",
                    "dia_megastep_batched", "dia_cross_attention_batched")
DIA_GREEDY_STEPS = 300   # the greedy parity check's generation window
# Dia serving's generation window, a depth cut that keeps the whole script
# in its time on slower hosts
DIA_SERVING_STEPS = 512
DIA_SAMPLE = dict(do_sample=True, temperature=1.0, top_k=50, top_p=1.0,
                  repetition_penalty=1.0)


def run_dia_main_path(tmp) -> tuple[dict, str]:
    """Dia-1.6B Q4_0 + DAC-44k text -> WAV through the port's CLI on the
    card (sampled, top-k 50, fixed seed, the 1024-step window); counters set
    to 0 just before, read just after: K1 and K10 must have risen, and
    neither K4 nor the cross-attention launched alone (K10 runs both
    inside its one launch). Then the same path timed stage by stage, and a
    device trace of 32 decode steps: exactly one K10 launch a step, at
    most DIA_KERNELS_PER_STEP kernels a step."""
    from tts_tpu_torch.apps import cli
    from tts_tpu_torch.audio.wav import read_audio_file
    from tts_tpu_torch.models.dia import model as dmodel
    from tts_tpu_torch.models.registry import runner_from_file
    path = os.path.join(tmp, "dia-1.6b-q4.gguf")
    t0 = time.perf_counter()
    write_dia(path, np.random.default_rng(SEED), dac_chans=(1536, 768, 384, 192, 96),
              **DIA)
    log(f"Dia main path: wrote {os.path.getsize(path) / 1e6:.1f} MB GGUF in "
        f"{time.perf_counter() - t0:.1f} s; prompt {DIA_PROMPT!r}")
    wav = os.path.join(tmp, "dia.wav")
    zero_counts()
    t0 = time.perf_counter()
    rc = cli.main(["-mp", path, "-p", DIA_PROMPT, "-sp", wav, "--seed", str(SEED)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts("Dia CLI")
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    audio, rate = read_audio_file(wav)
    log(f"  CLI wrote {wav} in {cli_s:.1f} s (load included): {audio.size} "
        f"samples at {rate} Hz; launches {launches}")
    if rate != 44100 or audio.size == 0 or audio.size % 512 or \
            not np.all(np.isfinite(audio)) or np.abs(audio).max() > 1.0:
        raise AssertionError("CLI output is not a valid waveform")
    for n in DIA_PATH:
        if launches[n] == 0:
            raise AssertionError(f"kernel {n} was not launched on the Dia path")
    for n in ("decode_attention_batched", "dia_cross_attention",
              "dia_megastep_batched"):
        if launches[n]:
            raise AssertionError(f"kernel {n} was launched on the Dia path")

    # the same path, stage by stage, synchronized
    t0 = time.perf_counter()
    r = runner_from_file(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg, w = r.cfg, r.weights
    ids = dmodel.tokenize_sentence(DIA_PROMPT, cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    cross = r.encode(ids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = {n: k.launches for n, k in KERNELS.items()}
    out, steps = dmodel.dia_generate_tokens_chunked(
        cfg, w, cross, gen, max_steps=cfg.max_generation_size, mega=r.mega,
        **DIA_SAMPLE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    per_step = {n: (k.launches - before[n]) / steps for n, k in KERNELS.items()}
    codes = dmodel.adjust_output_tokens(out.cpu().numpy(), steps, cfg)
    t3 = time.perf_counter()
    wav_np = r.dac.decode(codes)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    audio_s = wav_np.size / 44100.0
    stats = dict(prompt_bytes=len(ids), bucket=int(cross.ck.shape[2]),
                 n_tail=cross.n_tail, load_s=load_s, encode_ms=(t1 - t0) * 1e3,
                 decode_steps=steps, decode_ms_per_step=(t2 - t1) * 1e3 / steps,
                 vocode_ms=(t4 - t3) * 1e3, frames=int(codes.shape[0]),
                 audio_s=audio_s, audio_s_per_wall_s=audio_s / (t4 - t0),
                 decode_audio_s_per_wall_s=steps * 512 / 44100.0 / (t2 - t1),
                 launches_per_step=per_step)
    log(f"  timed: {json.dumps(stats)}")
    prefill_device(f"Dia encode ({len(ids)} bytes)", lambda: r.encode(ids))
    if steps != cfg.max_generation_size - 1 or \
            codes.shape[0] != steps - cfg.max_delay or \
            wav_np.size != codes.shape[0] * 512 or not np.all(np.isfinite(wav_np)):
        raise AssertionError("timed run produced the wrong shape")
    # a steady window of 32 decode steps from the start
    st = dmodel.init_state(cfg, cfg.max_generation_size, DEV)
    before = dm.KERNEL.launches
    st = device_trace(lambda: dmodel.decode_chunk(
        cfg, w, st, cross, 32, gen, max_steps=cfg.max_generation_size,
        mega=r.mega, **DIA_SAMPLE), "Dia decode (K10)", 32)
    if int(st.pos) != 32:
        raise AssertionError("traced decode window produced the wrong count")
    k10_per_step = (dm.KERNEL.launches - before) / 32
    if last_trace is None or k10_per_step != 1 or \
            last_trace["kernels"] > DIA_KERNELS_PER_STEP:
        raise AssertionError(f"Dia decode: {k10_per_step} K10 launches a "
                             f"step, device trace {last_trace}: want 1 and at "
                             f"most {DIA_KERNELS_PER_STEP} kernels a step")
    log(f"  Dia decode: {k10_per_step:.0f} K10 launch a step, "
        f"{last_trace['kernels']:.1f} kernels a step in the device trace "
        f"(at most {DIA_KERNELS_PER_STEP}): ok")
    # the runner's greedy stream (K10): its codes equal generate_codes', its
    # waveform the DAC's of them
    from tts_tpu_torch.common import GenerationConfig
    greedy = GenerationConfig(sample=False, seed=SEED)
    want = r.generate_codes(DIA_PROMPT, greedy)
    full = np.asarray(r.dac.decode(want), np.float32)
    with recording(dmodel, "adjust_output_tokens") as seen:
        chunks, first_s, total_s = timed_stream(r.generate_stream(DIA_PROMPT,
                                                                  greedy))
    if not np.array_equal(seen[-1], want):
        raise AssertionError("Dia stream: its codes differ from generate_codes'")
    hold_stream(f"Dia runner, K10, {want.shape[0]} frames", chunks, full,
                first_s, total_s, 44100)
    del r, st
    torch.cuda.empty_cache()
    return launches, path


def dia_prompts(n=12, lo=20, hi=200) -> list[str]:
    """n dialogue prompts with speaker tags whose byte counts (as the Dia
    tokenizer counts them) spread over [lo, hi]."""
    from tts_tpu_torch.models.dia.model import DiaConfig, tokenize_sentence
    cfg = DiaConfig()
    out = []
    for t in np.linspace(lo, hi, n).round().astype(int):
        k = next(k for k in range(5, len(DIALOGUE))
                 if len(tokenize_sentence(DIALOGUE[:k], cfg)) >= t)
        out.append(DIALOGUE[:k])
    return out


def run_dia_serving(path) -> dict:
    """The Dia serving path (`serving_burst` on dialogue prompts of 20-200
    bytes: K1, K4, K11 and its cross-attention must have been launched),
    then the engine's greedy codes against the single-stream runner's (K10)
    over DIA_GREEDY_STEPS steps, for prompts of 129-256 bytes (the runner's
    bucket then is the engine's, 256). Returns the launch counts of the 12
    requests."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.dia.model import tokenize_sentence
    from tts_tpu_torch.runtime.batched_dia import BatchedDiaEngine
    params = [dict(p, seed=i) for i, p in enumerate(serving_params())]
    runner, prompts, _, launches = serving_burst(
        path, BatchedDiaEngine, params, 44100, 512, DIA_SERVING_PATH, "Dia",
        prompts=dia_prompts())
    lens = [len(tokenize_sentence(p, runner.cfg)) for p in prompts]
    log(f"  Dia prompt bytes {lens}")
    cfg = dataclasses.replace(runner.cfg, max_generation_size=DIA_GREEDY_STEPS)
    single = copy.copy(runner)
    single.cfg = cfg
    eng = BatchedDiaEngine(cfg, runner.weights, n_slots=8, chunk=32)
    greedy = GenerationConfig(sample=False)
    picks = [i for i in range(len(prompts)) if 128 < lens[i] <= 256][-2:]
    rids = [eng.submit(prompts[i], greedy) for i in picks] + \
        [eng.submit(prompts[i], GenerationConfig(**params[i])) for i in (0, 4, 2, 6)]
    eng.run_until_done()
    for rid, i in zip(rids, picks):
        want = single.generate_codes(prompts[i], greedy)
        got = eng.results[rid]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"greedy codes of the engine differ from the "
                                 f"runner's for a {lens[i]}-byte prompt: "
                                 f"{got.shape} vs {want.shape}")
    log(f"  greedy parity: {len(picks)} greedy requests of "
        f"{[lens[i] for i in picks]} bytes among 4 sampled ones in 8 slots "
        f"give the single-stream runner's (K10's) codes exactly "
        f"({DIA_GREEDY_STEPS} steps, "
        f"{[eng.results[r].shape[0] for r in rids[:len(picks)]]} frames): ok")
    return launches


# ---------------------------------------------------------------------------
# slot groups: engines past the rows one batched launch takes
# ---------------------------------------------------------------------------

GROUP_STEPS = 48   # greedy steps (tokens for Orpheus) the parity checks run


@contextlib.contextmanager
def small_orpheus_prompt_ids():
    """The Orpheus prompt format's special ids (128000-128261) lie past a
    small model's 1000-token vocab: within the block they are in-vocab ids,
    as the port's CPU tests patch them."""
    from tts_tpu_torch.models.orpheus import model as omodel
    saved = omodel.PREPENDED_TOKENS, omodel.APPENDED_TOKENS
    omodel.PREPENDED_TOKENS, omodel.APPENDED_TOKENS = (1, 2), (3, 4, 5, 6)
    try:
        yield
    finally:
        omodel.PREPENDED_TOKENS, omodel.APPENDED_TOKENS = saved


def engine_parity(label, eng, prompts, want, same) -> None:
    """Greedy requests of `prompts`, one a slot, through the engine `eng`:
    each request's codes (tokens) must equal `want(prompt)`, the
    single-stream runner's, by `same`; logs the kernels launched."""
    from tts_tpu_torch.common import GenerationConfig
    rids = [eng.submit(p, GenerationConfig(sample=False)) for p in prompts]
    if any(r is None for r in eng.slot_req):
        raise AssertionError(f"{label}: a slot is idle")
    before = {n: k.launches for n, k in KERNELS.items()}
    eng.run_until_done()
    torch.cuda.synchronize()
    launched = {n: k.launches - before[n] for n, k in KERNELS.items()
                if k.launches != before[n]}
    for rid, p in zip(rids, prompts):
        if not same(eng.results[rid], want(p)):
            raise AssertionError(f"{label}: greedy codes of the engine "
                                 f"differ from the runner's for {p!r}")
    log(f"  {label}: {len(prompts)} greedy requests in {eng.n_slots} slots "
        f"give the single-stream runner's codes exactly; launches "
        f"{launched}: ok")


# head sizes other than 64 / 128, each family at (hidden, q heads, kv
# heads): 256 and 192 take the fused routes' launch sequences; 100 fails
# the gates' `head_size % 64` test and takes the per-matmul route (K1's K,
# 16 x 100, a multiple of 64)
HEAD_SIZE_MODELS = {256: (512, 2, 1), 192: (768, 4, 2), 100: (1600, 16, 4)}


def check_head_sizes(tmp) -> None:
    """Small Q4_0 Parler, Orpheus and Dia models with heads of 256, 192 and
    100 (decode attention on K3 / K4's generic path; the persistent steps
    take 64 and 128 only, so at 256 / 192 Orpheus's single stream takes K7
    / K9 at one slot and Dia's K11 at one pair; at 100 every family takes
    the per-matmul route, K1 and K3 / K4, as the JAX gates send it there):
    each through its runner on the card, teacher-forced against the CPU's
    plain versions (check_small_reference, check_small_orpheus,
    check_small_dia, fewer steps), then its engine on the card (2 slots)
    against the card runner's greedy codes (tokens), equal; on the
    per-matmul route Dia's engine reads the bucketed bf16 cross K/V where
    its runner reads the f32 window, so it is held to the CPU engine,
    teacher-forced (dia_engine_vs_cpu)."""
    from tts_tpu_torch.models.dia.model import tokenize_sentence
    from tts_tpu_torch.models.orpheus import model as omodel
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.batched_dia import BatchedDiaEngine
    from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine
    from tts_tpu_torch.runtime.batched_parler import BatchedParlerEngine
    from tts_tpu_torch.common import GenerationConfig
    greedy = GenerationConfig(sample=False)
    same_codes = (lambda a, b: a.shape == b.shape and np.array_equal(a, b))
    for d, (hidden, heads, kv) in HEAD_SIZE_MODELS.items():
        per_matmul = d % 64 != 0
        # Parler: K2 and K5 with K3 / K4 at heads of d (per matmul: K1)
        name = f"parler-d{d}.gguf"
        check_small_reference(tmp, hidden, heads, name, n_steps=12,
                              per_matmul=per_matmul)
        runner = runner_from_file(os.path.join(tmp, name))
        prompts = serving_prompts(runner.tokenizer, n=2, lo=3, hi=20)
        lens = [len(runner.tokenizer.tokenize(p)) + 1 for p in prompts]
        single = copy.copy(runner)
        single.cfg = dataclasses.replace(runner.cfg,
                                         max_generation_size=max(lens) + 24)
        engine_parity(f"Parler heads of {d}, {'K4' if per_matmul else 'K5'}",
                      BatchedParlerEngine(single.cfg, runner.weights,
                                          runner.tokenizer, n_slots=2, chunk=32),
                      prompts, lambda p: single.generate_codes(p, greedy),
                      same_codes)
        # Orpheus: K7 / K9 (the single stream at one slot), or per matmul
        check_small_orpheus(tmp, hidden, heads, kv, n_steps=12,
                            per_matmul=per_matmul)
        with small_orpheus_prompt_ids():
            route = "per-matmul" if per_matmul else "K6"
            runner = runner_from_file(os.path.join(
                tmp, f"orpheus-small-{route}-d{d}.gguf"))
            single = copy.copy(runner)
            single.cfg = dataclasses.replace(runner.cfg, max_generation_size=24)
            eng = BatchedLlamaEngine(single.cfg, runner.weights,
                                     runner.tokenizer, n_slots=2, chunk=32)
            # the engine takes K7 for heads that are a multiple of 128 and K9
            # (the head per matmul) for the others, as the JAX engine does;
            # the runner takes the engine's route here, at one slot
            single._mega, single._mega_ready = eng.mega, True
            if (single.mega is None) != per_matmul or \
                    (single.mega is not None and single.mega.persistent):
                raise AssertionError(f"heads of {d} took the wrong route")

            def want(p):
                out, n_out, _ = single.generate_tokens(p, greedy)
                return omodel.prepare_output_tokens(out, n_out)

            engine_parity(f"Orpheus heads of {d}, "
                          f"{'K4' if per_matmul else 'K7' if d % 128 == 0 else 'K9'}",
                          eng, ["hey?", "how are you doing?"], want,
                          lambda a, b: a == b)
        # Dia: K11 (the single stream at one pair), prompts of 129-256 bytes
        name = f"dia-d{d}.gguf"
        check_small_dia(tmp, hidden, heads, kv, name, n_steps=24,
                        per_matmul=per_matmul)
        runner = runner_from_file(os.path.join(tmp, name))
        prompts = dia_prompts(n=2, lo=130, hi=250)
        if not all(128 < len(tokenize_sentence(p, runner.cfg)) <= 256
                   for p in prompts):
            raise AssertionError("Dia prompts outside 129-256 bytes")
        if not per_matmul:
            engine_parity(f"Dia heads of {d}, K11", BatchedDiaEngine(
                runner.cfg, runner.weights, n_slots=2, chunk=32), prompts,
                lambda p: runner.generate_codes(p, greedy), same_codes)
            continue
        dia_engine_vs_cpu(os.path.join(tmp, name), runner, prompts,
                          f"Dia heads of {d}, per-matmul engine (K4)")


def check_slot_groups(tmp) -> None:
    """The batched engines past one launch's rows, on small models: a Parler
    engine with 20 slots and an Orpheus engine with 20 (K5 and K7 in two
    groups of 10), a Dia engine with 12 (K11 in two groups of 6 pairs),
    every slot busy with a greedy request; each request's codes equal the
    single-stream runner's (K2, K6, K10). Then the server with batch_slots
    12 on the small Dia GGUF reaches READY and answers a request."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.dia.model import tokenize_sentence
    from tts_tpu_torch.models.orpheus import model as omodel
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.batched_dia import BatchedDiaEngine
    from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine
    from tts_tpu_torch.runtime.batched_parler import BatchedParlerEngine
    greedy = GenerationConfig(sample=False)
    parity = engine_parity

    # Parler, 20 slots (K5 in groups of 10)
    runner = runner_from_file(os.path.join(tmp, "parler-small.gguf"))
    prompts = serving_prompts(runner.tokenizer, n=20, lo=3, hi=40)
    lens = [len(runner.tokenizer.tokenize(p)) + 1 for p in prompts]
    single = copy.copy(runner)
    single.cfg = dataclasses.replace(runner.cfg,
                                     max_generation_size=max(lens) + GROUP_STEPS)
    eng = BatchedParlerEngine(single.cfg, runner.weights, runner.tokenizer,
                              n_slots=20, chunk=32)
    parity("Parler small, K5", eng, prompts,
           lambda p: single.generate_codes(p, greedy),
           lambda a, b: a.shape == b.shape and np.array_equal(a, b))

    # Orpheus, 20 slots (K7 in groups of 10; heads of 128 so that the
    # engine takes K7 and the runner K6)
    path = os.path.join(tmp, "orpheus-small-d128.gguf")
    write_orpheus(path, np.random.default_rng(SEED + 4), n_layers=2,
                  hidden=256, heads=2, kv_heads=1, ffn=1024, vocab=1000,
                  q4_head=True, snac_dims=(64, 32, 16, 8, 4), snac_latent=32)
    with small_orpheus_prompt_ids():
        runner = runner_from_file(path)
        single = copy.copy(runner)
        single.cfg = dataclasses.replace(runner.cfg,
                                         max_generation_size=GROUP_STEPS)
        single._mega, single._mega_ready = runner.mega, True
        eng = BatchedLlamaEngine(single.cfg, runner.weights, runner.tokenizer,
                                 n_slots=20, chunk=32)
        if not isinstance(eng.mega.step, lf.LlamaFlat):
            raise AssertionError("the small Orpheus engine did not take K7")
        words = PROMPT.split()
        prompts = [" ".join(words[:1 + i % len(words)]) + "?" * (i // 6)
                   for i in range(20)]

        def want(p):
            out, n_out, _ = single.generate_tokens(p, greedy)
            return omodel.prepare_output_tokens(out, n_out)

        parity("Orpheus small, K7", eng, prompts, want, lambda a, b: a == b)

    # Dia, 12 slots (K11 in groups of 6 pairs), prompts of 129-256 bytes
    # (the runner's bucket is then the engine's, 256)
    runner = runner_from_file(os.path.join(tmp, "dia-small.gguf"))
    prompts = dia_prompts(n=12, lo=130, hi=250)
    if not all(128 < len(tokenize_sentence(p, runner.cfg)) <= 256
               for p in prompts):
        raise AssertionError("Dia prompts outside 129-256 bytes")
    eng = BatchedDiaEngine(runner.cfg, runner.weights, n_slots=12, chunk=32)
    parity("Dia small, K11", eng, prompts,
           lambda p: runner.generate_codes(p, greedy),
           lambda a, b: a.shape == b.shape and np.array_equal(a, b))

    # the server with 12 batch slots on a Dia GGUF
    srv, httpd, base = start_server(os.path.join(tmp, "dia-small.gguf"),
                                    GenerationConfig(top_k=50), 12)
    try:
        code, body, _ = _post(base, dict(input=prompts[0]))
    finally:
        httpd.shutdown()
    if code != 200:
        raise AssertionError(f"the server with 12 batch slots answered {code}: "
                             f"{body[:300]!r}")
    secs = check_wav(body)
    log(f"  server with batch_slots 12 on the small Dia GGUF: READY, one "
        f"request answered with {secs:.3f} s of audio: ok")


# ---------------------------------------------------------------------------
# Kokoro (phase 15): Kokoro-82M text -> WAV, plain PyTorch on the card
# ---------------------------------------------------------------------------

# Kokoro-82M (hexgrad/Kokoro-82M config.json): plbert hidden 768, 12 heads,
# FFN 2048, 512 positions, embedding 128, one shared layer run 12 times;
# vocab 178, hidden_dim 512, style_dim 128 (voice rows 256), 3 text-encoder
# convs of kernel 5, max_dur 50; iSTFTNet: upsample rates 10 / 6, kernels
# 20 / 12, initial channel 512, res-block kernels 3 / 7 / 11 with dilations
# (1, 3, 5), n_fft 20, hop 5, 8 harmonics; decoder blocks 1024 wide, the
# last 512 with a pool.
KOKORO = dict(vocab=178, ctx=512, emb=128, hidden=768, heads=12, ffn=2048,
              recurrence=12, dur_hidden=512, style=128, max_dur=50,
              te_kernel=5, n_conv=3, dec_hidden=1024, gen_ch=512,
              up_rates=(10, 6), up_kernels=(20, 12), res_kernels=(3, 7, 11),
              n_fft=20, hop=5, harmonics=8, voice_rows=510)
KOKORO_SEED = SEED + 14           # the phase's own draws: no earlier one moves
KOKORO_FRAMES_PER_TOKEN = 3.5     # the head's bias: ~3-4 frames a token at 40 frames a second
KOKORO_F0_HZ = 120.0              # the F0 head's bias: voiced speech
KOKORO_VOICES = ("af_heart", "bm_lewis")
KOKORO_SHORT = "hello, the world."
KOKORO_SENTENCE = "Hello world, the quick brown fox jumps over the lazy dog."
KOKORO_LONG = " ".join(
    ["The quick brown fox jumps over the lazy dog and the world says hello."] * 9)
KOKORO_RULES = dict(a="æ", b="b", c="k", d="d", e="ɛ", f="f", g="ɡ", h="h",
                    i="ɪ", j="ʤ", k="k", l="l", m="m", n="n", o="ɑ", p="p",
                    q="k", r="ɹ", s="s", t="t", u="ʌ", v="v", w="w", x="ks",
                    y="j", z="z")
KOKORO_DICT = {"the": "ðə", "hello": "həlˈoʊ", "world": "wˈɜːld", "a": "ɐ",
               "and": "ænd", "says": "sˈɛz", "quick": "kwˈɪk", "fox": "fˈɑks",
               "dog": "dˈɔɡ", "over": "ˈoʊvɚ", "lazy": "lˈeɪzi"}
KOKORO_CARD_TOL = 1e-3            # card vs CPU: of max(|CPU peak|, 1)
KOKORO_CARD_SHARE = 0.999         # ... for at least this share of samples


def kokoro_vocab() -> list[str]:
    """178 tokens as Kokoro's: '$' at 0 (BOS / EOS), the space at 16."""
    head = list("$;:,.!?¡¿—…\"«»“”") + [" "]
    ipa = ("ɑɐɒæβɔɕçɖðʤəɚɛɜɟɡɥɨɪʝɯɰŋɳɲɴøɸθœɹɾɻʁɽʂʃʈʧʊʋʌɣɤχʎʒʔˈˌːʰʲ↓→↗↘ᵻ"
           "ᵊɝʉʏ")
    out = head + [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"]
    out += [c for c in dict.fromkeys(ipa) if c not in out]
    out += [chr(0x2c60 + i) for i in range(KOKORO["vocab"] - len(out))]
    assert len(out) == KOKORO["vocab"] == len(set(out)) and out.index(" ") == 16
    return out


def kokoro_tensors(rng) -> dict:
    """Every tensor load_kokoro_weights reads, at Kokoro-82M width, random
    from `rng`: products scaled by 1/sqrt(fan-in), norms near identity, the
    style affines small; the duration head's bias set so that a token lasts
    KOKORO_FRAMES_PER_TOKEN frames on average, the F0 head's to
    KOKORO_F0_HZ."""
    K = KOKORO
    t = {}

    def mat(name, *shape, fan=None):
        fan = fan or int(np.prod(shape[1:]))
        t[name] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    def vec(name, n, scale=0.02, base=0.0):
        t[name] = (base + rng.standard_normal(n) * scale).astype(np.float32)

    def lstm(base, inp, hid):
        for kind in ("", "reverse_"):
            for g in range(4):
                mat(f"{base}.0.{kind}weights.{2 * g}", hid, inp)
                mat(f"{base}.0.{kind}weights.{2 * g + 1}", hid, hid)
                vec(f"{base}.0.{kind}biases.{2 * g}", hid)
                vec(f"{base}.0.{kind}biases.{2 * g + 1}", hid)

    def ada_ln(base, c, g="gamma_", b="beta_"):
        mat(f"{base}{g}weight", c, K["style"], fan=K["style"] * 25)
        vec(f"{base}{g}bias", c)
        mat(f"{base}{b}weight", c, K["style"], fan=K["style"] * 25)
        vec(f"{base}{b}bias", c)

    def ada_block(base, cin, cout, pool=False):
        ada_ln(f"{base}.norm1_", cin)
        mat(f"{base}.conv1_weight", cout, cin, 3)
        vec(f"{base}.conv1_bias", cout)
        ada_ln(f"{base}.norm2_", cout)
        mat(f"{base}.conv2_weight", cout, cout, 3)
        vec(f"{base}.conv2_bias", cout)
        if pool:
            mat(f"{base}.pool_weight", cin, 1, 3)
            vec(f"{base}.pool_bias", cin)
        if pool or cin != cout:
            mat(f"{base}.conv1x1_weight", cout, cin, 1)

    def gen_block(base, ch, k):
        for i in range(3):
            ada_ln(f"{base}.{i}.", ch, "gamma1_", "beta1_")
            ada_ln(f"{base}.{i}.", ch, "gamma2_", "beta2_")
            t[f"{base}.{i}.alpha1"] = np.ones((1, ch, 1), np.float32)
            t[f"{base}.{i}.alpha2"] = np.ones((1, ch, 1), np.float32)
            mat(f"{base}.{i}.convs1_weight", ch, ch, k)
            vec(f"{base}.{i}.convs1_bias", ch)
            mat(f"{base}.{i}.convs2_weight", ch, ch, k)
            vec(f"{base}.{i}.convs2_bias", ch)

    a = "kokoro.albert."
    mat(a + "token_embd", K["vocab"], K["emb"], fan=1)
    mat(a + "position_embd", K["ctx"], K["emb"], fan=1)
    vec(a + "token_type_embd", K["emb"], 1.0)
    vec(a + "norm", K["emb"], base=1.0)
    vec(a + "norm_bias", K["emb"])
    mat(a + "embd", K["hidden"], K["emb"])
    vec(a + "embd_bias", K["hidden"])
    b, H = a + "layer.0.", K["hidden"]
    for n in ("q", "k", "v", "o"):
        mat(b + n, H, H)
        vec(b + n + "_bias", H)
    for n in ("ffn_norm", "attn_norm"):
        vec(b + n, H, base=1.0)
        vec(b + n + "_bias", H)
    mat(b + "ffn", K["ffn"], H)
    vec(b + "ffn_bias", K["ffn"])
    mat(b + "ffn_out", H, K["ffn"])
    vec(b + "ffn_out_bias", H)

    d, dh, st = "kokoro.duration_predictor.", K["dur_hidden"], K["style"]
    mat(d + "encode", dh, H)
    vec(d + "encode_bias", dh)
    for i in range(3):
        lstm(f"{d}layers.{2 * i}.lstm", dh + st, dh // 2)
        ada_ln(f"{d}layers.{2 * i + 1}.", dh)
    lstm(d + "duration_lstm", dh + st, dh // 2)
    lstm(d + "shared_lstm", dh + st, dh // 2)
    mat(d + "duration_proj", K["max_dur"], dh)
    # a direction shared by the 50 outputs, so that tokens differ in length
    t[d + "duration_proj"] += (rng.standard_normal(dh) * 1.5 / np.sqrt(dh)
                               ).astype(np.float32)
    p = KOKORO_FRAMES_PER_TOKEN / K["max_dur"]
    vec(d + "duration_proj_bias", K["max_dur"], base=float(np.log(p / (1 - p))))
    for blocks in ("f0_blocks", "n_blocks"):
        ada_block(f"{d}{blocks}.0", dh, dh)
        ada_block(f"{d}{blocks}.1", dh, dh // 2, pool=True)
        ada_block(f"{d}{blocks}.2", dh // 2, dh // 2)
    mat(d + "f0_proj_kernel", 1, dh // 2, 1)
    vec(d + "f0_proj_bias", 1, 0.0, KOKORO_F0_HZ)
    mat(d + "n_proj_kernel", 1, dh // 2, 1)
    vec(d + "n_proj_bias", 1)

    te = "kokoro.text_encoder."
    mat(te + "embedding_weight", K["vocab"], dh, fan=1)
    for i in range(K["n_conv"]):
        vec(f"{te}layers.{i}.gamma", dh, base=1.0)
        vec(f"{te}layers.{i}.beta", dh)
        mat(f"{te}layers.{i}.weight", dh, dh, K["te_kernel"])
        vec(f"{te}layers.{i}.bias", dh)
    lstm(te + "lstm", dh, dh // 2)

    dd, dc, gc = "kokoro.decoder.", K["dec_hidden"], K["gen_ch"]
    mat(dd + "f0_conv_weight", 1, 1, 3)
    vec(dd + "f0_conv_bias", 1)
    mat(dd + "n_conv_weight", 1, 1, 3)
    vec(dd + "n_conv_bias", 1)
    mat(dd + "asr_conv_weight", 64, dh, 1)
    vec(dd + "asr_conv_bias", 64)
    ada_block(dd + "encoder_block", dh + 2, dc)
    for i in range(4):
        ada_block(f"{dd}decoder_blocks.{i}", dc + 66, dc if i < 3 else gc,
                  pool=i == 3)
    g = dd + "generator."
    mat(g + "m_source_weight", 1, K["harmonics"] + 1)
    vec(g + "m_source_bias", 1)
    bins = K["n_fft"] + 2
    for i, (r, k) in enumerate(zip(K["up_rates"], K["up_kernels"])):
        cin, cout = gc >> i, gc >> (i + 1)
        mat(f"{g}ups.{i}.weight", cin, cout, k, fan=cin * k // r)
        vec(f"{g}ups.{i}.bias", cout)
        nk = 2 * K["up_rates"][1] if i == 0 else 1
        mat(f"{g}noise_blocks.{i}.conv_weight", cout, bins, nk)
        vec(f"{g}noise_blocks.{i}.conv_bias", cout)
        gen_block(f"{g}noise_blocks.{i}.resblock", cout, 7 if i == 0 else 11)
        for j, rk in enumerate(K["res_kernels"]):
            gen_block(f"{g}resblocks.{3 * i + j}", cout, rk)
    mat(g + "conv_post_weight", bins, gc >> 2, 7)
    vec(g + "conv_post_bias", bins)
    return t


def write_kokoro(path, rng) -> int:
    """A Kokoro-82M-shaped F32 GGUF (the JAX package's converter layout and
    metadata) with two voices and a small rule-based phonemizer, written
    with the port's GGUF writer. Returns its parameter count (voices
    apart)."""
    K = KOKORO
    tensors = kokoro_tensors(rng)
    w = GGUFWriter(path, "kokoro")
    a = "kokoro.duration_predictor.albert"
    for key, v in (("context_length", K["ctx"]), ("hidden_size", K["hidden"]),
                   ("layers", 1), ("attn_heads", K["heads"]),
                   ("recurrence", K["recurrence"])):
        w.add_u32(f"{a}.{key}", v)
    w.add_u32("kokoro.duration_predictor.hidden_size", K["dur_hidden"])
    w.add_u32("kokoro.duration_predictor.f0_n_blocks", 3)
    w.add_u32("kokoro.duration_predictor.layers", 3)
    w.add_u32("kokoro.text_encoder.layers", K["n_conv"])
    g = "kokoro.decoder.generator"
    for key, v in (("kernels", 3), ("upsamples", 2), ("layers", 4),
                   ("padding", 3), ("n_fft", K["n_fft"]), ("hop", K["hop"]),
                   ("up_sampling_factor", 600)):
        w.add_u32(f"{g}.{key}", v)
    for i, (r, k) in enumerate(zip(K["up_rates"], K["up_kernels"])):
        w.add_u32(f"{g}.up_convs.{i}.stride", r)
        w.add_u32(f"{g}.up_convs.{i}.padding", (k - r) // 2)
    for i, (s, p, k) in enumerate(((6, 3, 7), (1, 0, 11))):
        w.add_u32(f"{g}.noise_blocks.{i}.stride", s)
        w.add_u32(f"{g}.noise_blocks.{i}.padding", p)
        for j, dil in enumerate((1, 3, 5)):
            w.add_u32(f"{g}.noise_blocks.{i}.res_block.{j}.dilation", dil)
            w.add_u32(f"{g}.noise_blocks.{i}.res_block.{j}.padding",
                      (k * dil - dil) // 2)
    for i in range(6):
        k = K["res_kernels"][i % 3]
        for j, dil in enumerate((1, 3, 5)):
            w.add_u32(f"{g}.res_blocks.{i}.{j}.dilation", dil)
            w.add_u32(f"{g}.res_blocks.{i}.{j}.padding", (k * dil - dil) // 2)
    w.add_array("tokenizer.ggml.tokens", kokoro_vocab())
    w.add_array("kokoro.voices", list(KOKORO_VOICES))
    w.add_u32("phonemizer.type", 0)
    w.add_array("phonemizer.graphemes", ["<unk>"] + sorted(KOKORO_RULES))
    w.add_array("phonemizer.rules.keys", sorted(KOKORO_RULES))
    w.add_array("phonemizer.rules.phonemes", [KOKORO_RULES[k] for k in sorted(KOKORO_RULES)])
    w.add_array("phonemizer.dictionary.keys", sorted(KOKORO_DICT))
    w.add_array("phonemizer.dictionary.values", [KOKORO_DICT[k] for k in sorted(KOKORO_DICT)])
    for name, arr in tensors.items():
        w.add_tensor(name, arr)
    for v in KOKORO_VOICES:
        w.add_tensor(f"kokoro.voice_tensors.{v}",
                     (rng.standard_normal((K["voice_rows"], 1, 2 * K["style"]))
                      * 0.3).astype(np.float32))
    w.write()
    return sum(a.size for a in tensors.values())


def duration_sums(r, hidden, n) -> torch.Tensor:
    """The duration head's sums before rounding (kokoro_duration's last
    lines), from the hidden states."""
    from tts_tpu_torch.models.kokoro import model as km
    pw = r.weights.prosody
    d = km.masked_bilstm(hidden, n, *pw.duration_lstm)
    return torch.sigmoid(d @ pw.duration_proj_w.T + pw.duration_proj_b).sum(-1)[:n]


def kokoro_tokens(r, text) -> list[int]:
    cfg = r.cfg
    ph = r.phonemizer.text_to_phonemes(text)
    missing = sorted(set(ph) - set(r.tokenizer.tokens))
    if missing:
        raise AssertionError(f"phonemes outside the vocab: {missing}")
    stripped = ph
    for ch in ".!?":
        stripped = stripped.replace(ch, "")
    return [cfg.bos_token_id] + r.tokenizer.tokenize(stripped.strip()) + \
        [cfg.eos_token_id]


def kokoro_generate_on(r, dev_in, n, dur, noise, f, f0=None):
    """The generation graph on runner `r` from `dev_in` = (tokens, style,
    style2, durations, hidden) with the given durations and noise; with
    `f0`, the generator takes that F0 curve in place of r's own. Returns
    (waveform, {"f0": r's F0 curve, "har": the STFT's input (the harmonic
    source), "spec": its output}), all on the host."""
    from tts_tpu_torch.models.kokoro import model as km
    from tts_tpu_torch.ops import dsp
    tt, s1, s2, _, hid = dev_in
    seen = {}
    stft, gen = dsp.stft, km._generator

    def kept_stft(x, *a, **k):
        seen["har"], seen["spec"] = x, stft(x, *a, **k)
        return seen["spec"]

    def kept_gen(cfg, gw, x, style, f0_curve, *a):
        seen["f0"] = f0_curve
        return gen(cfg, gw, x, style,
                   f0_curve if f0 is None else f0.to(f0_curve.device), *a)

    dsp.stft, km._generator = kept_stft, kept_gen
    try:
        wav, tot = km.kokoro_generate(r.cfg, r.weights, tt, n, dur.to(r.device),
                                      hid, s1, s2, noise.to(r.device), n_frames=f)
    finally:
        dsp.stft, km._generator = stft, gen
    if tot != int(dur.sum()):
        raise AssertionError(f"{tot} frames, want {int(dur.sum())}")
    return wav.cpu(), {k: v.cpu() for k, v in seen.items()}


def kokoro_share(got, ref) -> tuple[float, float, int]:
    """(share of samples within KOKORO_CARD_TOL of max(|ref peak|, 1), the
    largest error, the count outside)."""
    tol = KOKORO_CARD_TOL * max(float(ref.abs().max()), 1.0)
    err = (got - ref).abs()
    return float((err <= tol).float().mean()), float(err.max()), int((err > tol).sum())


def kokoro_card_vs_cpu(card, cpu) -> dict:
    """The duration graph and the generation graph on the card against the
    port's plain path on the CPU, on KOKORO_SHORT: hidden states within 1e-4
    of their largest magnitude, durations equal (a token whose CPU sum lies
    within 1e-3 of a half-integer is counted, not failed). The generation
    graph on the card from the CPU's durations and noise, KOKORO_CARD_SHARE
    of its samples within KOKORO_CARD_TOL of max(|CPU peak|, 1): with the
    F0 head's bias at 0 on both (unvoiced: the source is the noise), and
    with the file's voiced F0 head given the CPU's F0 curve. The harmonic
    source integrates F0 into its phase (2 pi x 300 x k a curve step), so
    the ulps by which the card's F0 curve differs drift the phase over the
    utterance: the voiced run from the card's own F0 curve is measured and
    logged, and its F0 curve held within 1e-4 of the CPU's. The STFT's
    angles at the real bins (DC, Nyquist, frame 0) equal the CPU's."""
    from tts_tpu_torch.models.kokoro import model as km
    from tts_tpu_torch.ops import dsp
    toks = kokoro_tokens(cpu, KOKORO_SHORT.replace(",", "--"))
    n = len(toks)
    if not 10 <= n <= 20:
        raise AssertionError(f"the short prompt has {n} tokens, not 10-20")
    p = cpu._bucket(n, cpu.token_buckets)
    t = torch.zeros(p, dtype=torch.long)
    t[:n] = torch.tensor(toks)
    voice = KOKORO_VOICES[0]
    out = {}
    for dev, r in (("cpu", cpu), ("card", card)):
        s1, s2 = r._style(voice, n)
        tt = t.to(r.device)
        dur, hid = km.kokoro_duration(r.cfg, r.weights, tt, n, s1)
        out[dev] = (tt, s1, s2, dur, hid)
    _, _, _, dur_c, hid_c = out["cpu"]
    _, _, _, dur_g, hid_g = out["card"]
    scale = float(hid_c[:n].abs().max())
    herr = float((hid_g[:n].cpu() - hid_c[:n]).abs().max())
    sums = duration_sums(cpu, hid_c, n)
    near = int(((sums - sums.floor() - 0.5).abs() <= 1e-3).sum())
    differ = torch.nonzero(dur_g[:n].cpu() != dur_c[:n]).flatten().tolist()
    log(f"  card vs CPU, duration graph on {n} tokens: hidden max error "
        f"{herr:.3e} of {scale:.3e} (bound 1e-4 relative), durations "
        f"{dur_c[:n].int().tolist()} ({int(dur_c.sum())} frames), differ at "
        f"{differ}; tokens within 1e-3 of a half-integer: {near}")
    if herr > 1e-4 * scale:
        raise AssertionError("card vs CPU: the duration graph's hidden states differ")
    bad = [i for i in differ if abs(float(sums[i] - sums[i].floor()) - 0.5) > 1e-3]
    if bad:
        raise AssertionError(f"card vs CPU: durations differ at tokens {bad}")
    total = int(dur_c.sum())
    f = cpu._bucket(total, cpu.frame_buckets)
    noise = cpu.noise((cpu.cfg.harmonic_num + 1, int(2 * f * cpu.cfg.upsample_scale)),
                      seed=KOKORO_SEED)
    args = (n, dur_c, noise, f)
    stats = dict(tokens=n, frames=total, frame_bucket=f, hidden_err=herr)
    # voiced: the file's F0 head
    ref, seen_c = kokoro_generate_on(cpu, out["cpu"], *args)
    own, seen_g = kokoro_generate_on(card, out["card"], *args)
    fed, _ = kokoro_generate_on(card, out["card"], *args, f0=seen_c["f0"])
    f0_err = float((seen_g["f0"] - seen_c["f0"]).abs().max())
    f0_peak = float(seen_c["f0"].abs().max())
    stats.update(voiced_peak=float(ref.abs().max()), f0_peak=f0_peak,
                 f0_err=f0_err, voiced_from_cpu_f0=kokoro_share(fed, ref),
                 voiced_own_f0=kokoro_share(own, ref))
    # unvoiced: the F0 head's bias at 0 on both runners
    biases = [r.weights.prosody.f0_proj_b.clone() for r in (cpu, card)]
    try:
        for r in (cpu, card):
            r.weights.prosody.f0_proj_b.zero_()
        uref, useen = kokoro_generate_on(cpu, out["cpu"], *args)
        uown, _ = kokoro_generate_on(card, out["card"], *args)
    finally:
        for r, b in zip((cpu, card), biases):
            r.weights.prosody.f0_proj_b.copy_(b)
    stats.update(unvoiced_peak=float(uref.abs().max()),
                 unvoiced_f0_peak=float(useen["f0"].abs().max()),
                 unvoiced_own_f0=kokoro_share(uown, uref))
    log(f"  card vs CPU, generation graph ({total} frames, bucket {f}; share "
        f"within {KOKORO_CARD_TOL} of the peak, max error, count outside): "
        f"{json.dumps(stats)}")
    for dev, w in (("unvoiced", uown), ("voiced", own), ("voiced, CPU F0", fed)):
        if not torch.isfinite(w).all():
            raise AssertionError(f"card: the {dev} waveform is not finite")
    if stats["unvoiced_own_f0"][0] < KOKORO_CARD_SHARE or \
            stats["voiced_from_cpu_f0"][0] < KOKORO_CARD_SHARE:
        raise AssertionError("card vs CPU: the generation graph's waveform differs")
    if f0_err > 1e-4 * f0_peak or stats["unvoiced_f0_peak"] >= cpu.cfg.voice_threshold:
        raise AssertionError("card vs CPU: the F0 curves differ, or the unvoiced "
                             "run is voiced")
    # the STFT on the card from the CPU's harmonic source: the real bins'
    # angles equal the CPU's (0 or +pi), where the real part is not ~0
    har, spec_c = seen_c["har"], seen_c["spec"]
    n_fft, hop = cpu.cfg.true_n_fft, cpu.cfg.stft_hop
    spec_g = dsp.stft(har.to(DEV), dsp.hann_window(n_fft, device=DEV), n_fft,
                      hop).cpu()
    real = torch.zeros(spec_c.shape[1:], dtype=torch.bool)
    real[0] = True
    real[:, 0] = real[:, n_fft // 2] = True
    re = dsp.stft(har, dsp.hann_window(n_fft), n_fft, hop, abs_and_angle=False)[0]
    firm = real & (re.abs() > 1e-6 * float(re.abs().max()))
    same = bool((spec_g[1][firm] == spec_c[1][firm]).all())
    log(f"  STFT on the card of the CPU's voiced source: {int(firm.sum())} "
        f"real-bin angles compared ({int((real & ~firm).sum())} with a real "
        f"part ~0, the masked tail's zero frames among them), equal {same}; "
        f"harmonic source card vs CPU max error "
        f"{float((seen_g['har'] - har).abs().max()):.3e}")
    if not same:
        raise AssertionError("card vs CPU: the STFT's DC / Nyquist / frame-0 "
                             "angles differ")
    return stats


def kokoro_timed(r) -> dict:
    """KOKORO_SENTENCE through the runner on the card: the duration graph,
    the generation graph and the LSTM scans by the host's clock
    (synchronized; the LSTMs timed inside both), the whole request traced
    (kernels and busy share)."""
    from tts_tpu_torch.models.kokoro import model as km
    toks = kokoro_tokens(r, KOKORO_SENTENCE.replace(",", "--"))
    n = len(toks)
    t = torch.zeros(r._bucket(n, r.token_buckets), dtype=torch.long)
    t[:n] = torch.tensor(toks)
    t = t.to(r.device)
    s1, s2 = r._style(KOKORO_VOICES[0], n)
    spent = {"lstm": 0.0}
    orig = km.masked_bilstm

    def timed_lstm(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        spent["lstm"] += time.perf_counter() - t0
        return out

    rows = []
    for _ in range(4):
        spent["lstm"] = 0.0
        km.masked_bilstm = timed_lstm
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dur, hid = km.kokoro_duration(r.cfg, r.weights, t, n, s1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lstm_dur = spent["lstm"]
            total = int(dur.sum())
            f = r._bucket(total, r.frame_buckets)
            noise = r.noise((r.cfg.harmonic_num + 1, int(2 * f * r.cfg.upsample_scale)),
                            seed=KOKORO_SEED)
            wav, _ = km.kokoro_generate(r.cfg, r.weights, t, n, dur, hid, s1, s2,
                                        noise, n_frames=f)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            km.masked_bilstm = orig
        rows.append((t1 - t0, t2 - t1, lstm_dur, spent["lstm"] - lstm_dur))
    d_s, g_s, l_d, l_g = (float(np.median([row[i] for row in rows[1:]]))
                          for i in range(4))
    audio_s = total * 600 / 24000
    # without the LSTM timer's synchronizations, and traced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.run_tokens(toks, KOKORO_VOICES[0], seed=KOKORO_SEED)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    device_trace(lambda: r.run_tokens(toks, KOKORO_VOICES[0], seed=KOKORO_SEED),
                 f"Kokoro-82M request ({n} tokens, {total} frames)", 1)
    stats = dict(tokens=n, frames=total, frame_bucket=f, audio_s=audio_s,
                 duration_graph_ms=d_s * 1e3, generation_graph_ms=g_s * 1e3,
                 lstm_ms_in_duration=l_d * 1e3, lstm_ms_in_generation=l_g * 1e3,
                 lstm_share=(l_d + l_g) / (d_s + g_s), request_ms=plain_s * 1e3,
                 audio_s_per_wall_s=audio_s / plain_s, trace=last_trace)
    log(f"  timed (median of 3 after a warm-up; the LSTMs timed inside with a "
        f"synchronization each): {json.dumps(stats)}")
    return stats


def kokoro_serving(path) -> dict:
    """The port's server in this process on the Kokoro GGUF with batch
    slots 8 (Kokoro takes the worker pool: no batched engine) answers 12
    concurrent requests (two voices, each its own seed), 2 of them
    streamed; each stream equal to the same request sent whole within 1
    LSB. Returns the aggregate audio-s per wall-s and the latencies."""
    from tts_tpu_torch.common import GenerationConfig
    srv, httpd, base = start_server(path, GenerationConfig(), 8)
    try:
        if srv.batched_workers:
            raise AssertionError("Kokoro got a batched worker")
        with urllib.request.urlopen(base + "/v1/audio/voices", timeout=60) as resp:
            voices = json.loads(resp.read())["voices"]
        if voices != {srv.default_model: list(KOKORO_VOICES)}:
            raise AssertionError(f"/v1/audio/voices: {voices}")
        words = KOKORO_LONG.split()
        prompts = [" ".join(words[: 4 + 3 * i]) + "." for i in range(12)]
        payloads = [dict(input=p, voice=KOKORO_VOICES[i % 2], seed=100 + i)
                    for i, p in enumerate(prompts)]
        streamed = (4, 9)
        results = [None] * 12

        def req(i):
            t0 = time.perf_counter()
            r = post_stream(base, payloads[i]) if i in streamed \
                else _post(base, payloads[i])
            results[i] = (r, time.perf_counter() - t0)

        threads = [threading.Thread(target=req, args=(i,)) for i in range(12)]
        zero_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = read_counts()
        secs = []
        for i, (res, _) in enumerate(results):
            if res[0] != 200:
                raise AssertionError(f"Kokoro request {i} answered {res[0]}")
            if i in streamed:
                if res[1] != "audio/pcm;rate=24000;encoding=signed-integer;bits=16":
                    raise AssertionError(f"Kokoro stream {i}: {res[1]!r}")
                secs.append(res[2].size / 24000)
            else:
                secs.append(check_wav(res[1], 24000, 600))
        stream_stats = {}
        for i in streamed:
            code, body, _ = _post(base, payloads[i])
            whole = wav_int16(body)
            pcm = results[i][0][2]
            if code != 200 or whole.shape != pcm.shape:
                raise AssertionError(f"Kokoro stream {i}: {pcm.size} samples, "
                                     f"whole {whole.size} ({code})")
            diff = np.abs(pcm.astype(np.int32) - whole.astype(np.int32))
            stream_stats[i] = dict(first_samples_s=results[i][0][3],
                                   latency_s=results[i][1],
                                   audio_s=whole.size / 24000,
                                   max_lsb=int(diff.max()))
            if diff.max() > 1:
                raise AssertionError(f"Kokoro stream {i} differs from the same "
                                     f"request sent whole: {stream_stats[i]}")
        STREAMS["Kokoro server"] = stream_stats
        m = srv.metrics_json()
    finally:
        httpd.shutdown()
    if any(launches.values()):
        raise AssertionError(f"a K1-K12 kernel was launched on Kokoro's path: "
                             f"{launches}")
    lat = sorted(t for _, t in results)
    stats = dict(requests=12, wall_s=wall, audio_s=sum(secs),
                 audio_s_per_wall_s=sum(secs) / wall,
                 latency_p50_s=lat[len(lat) // 2], latency_max_s=lat[-1],
                 metrics_requests=m["requests_total"],
                 metrics_failed=m["requests_failed"])
    log(f"  Kokoro serving (worker pool, batch_slots 8): {json.dumps(stats)}; "
        f"streams against the same request sent whole: {json.dumps(stream_stats)}")
    if m["requests_failed"] or m["streams_total"] < len(streamed):
        raise AssertionError("/metrics counts failed Kokoro requests or misses "
                             "the streams")
    return stats


def run_kokoro(tmp) -> None:
    """Phase 15: a Kokoro-82M GGUF (random weights from the phase's own
    seed) text -> WAV through the port's CLI (one sentence; a prompt of
    more than 510 phoneme characters, several chunks), no K1-K12 kernel
    launched; the graphs card vs CPU; the runner's stream against its
    generate; the stage timings; the server."""
    from tts_tpu_torch.apps import cli
    from tts_tpu_torch.audio.wav import read_audio_file
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.kokoro import model as km
    from tts_tpu_torch.models.registry import runner_from_file
    path = os.path.join(tmp, "kokoro-82m.gguf")
    t0 = time.perf_counter()
    n_params = write_kokoro(path, np.random.default_rng(KOKORO_SEED))
    log(f"Kokoro-82M: wrote {path} ({n_params / 1e6:.1f} M parameters, "
        f"{os.path.getsize(path) / 1e6:.0f} MB) in {time.perf_counter() - t0:.1f} s")
    for label, prompt in (("sentence", KOKORO_SENTENCE), ("long", KOKORO_LONG)):
        wav = os.path.join(tmp, f"kokoro-{label}.wav")
        zero_counts()
        with recording(km, "kokoro_generate") as chunks:
            t0 = time.perf_counter()
            rc = cli.main(["-mp", path, "-p", prompt, "-sp", wav, "-v",
                           KOKORO_VOICES[1], "--seed", str(KOKORO_SEED)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts()
        audio, rate = read_audio_file(wav)
        totals = [tot for _, tot in chunks]
        log(f"  CLI, {label} prompt ({len(prompt)} characters): {len(chunks)} "
            f"chunk(s) of {totals} frames, {audio.size} samples at {rate} Hz in "
            f"{wall:.2f} s with the model's load ({audio.size / rate / wall:.3f} "
            f"audio-s per wall-s)")
        if rc != 0 or rate != 24000 or audio.size != 600 * sum(totals) or \
                not np.all(np.isfinite(audio)) or not audio.any():
            raise AssertionError(f"Kokoro CLI ({label}) did not write a valid "
                                 f"24 kHz WAV of 600 samples a frame")
        if label == "long" and len(chunks) < 2:
            raise AssertionError("the long prompt did not split into chunks")
        if any(launches.values()):
            raise AssertionError(f"a K1-K12 kernel was launched on Kokoro's "
                                 f"path: {launches}")
    card = runner_from_file(path, device=DEV)
    cpu = runner_from_file(path, device="cpu")
    kokoro_card_vs_cpu(card, cpu)
    del cpu
    conf = GenerationConfig(voice=KOKORO_VOICES[0], seed=KOKORO_SEED)
    whole = card.generate(KOKORO_LONG, conf).audio
    with recording(km, "kokoro_generate") as chunks:
        parts, first, total = timed_stream(card.generate_stream(KOKORO_LONG, conf))
    sizes = [600 * tot for _, tot in chunks]
    stream = np.concatenate(parts)
    stats = dict(chunks=len(parts), first_chunk_s=first, total_s=total,
                 audio_s=stream.size / 24000,
                 bit_equal=bool(np.array_equal(stream, whole)),
                 max_abs_err=float(np.abs(stream - whole).max()) if
                 stream.shape == whole.shape else None)
    STREAMS["Kokoro runner"] = stats
    log(f"  Kokoro runner stream, long prompt: {json.dumps(stats)}")
    if [p.size for p in parts] != sizes or stream.shape != whole.shape or \
            stats["max_abs_err"] > 1e-5 * max(float(np.abs(whole).max()), 1.0):
        raise AssertionError("Kokoro's stream differs from its generate")
    kokoro_timed(card)
    del card
    torch.cuda.empty_cache()
    kokoro_serving(path)


# ---------------------------------------------------------------------------
# phase 16: parallelism on torch.distributed
# ---------------------------------------------------------------------------

TP_SEED = SEED + 16          # the phase's own generators: no earlier draw moves
TP_MODELS = ("parler", "orpheus", "dia")
TP_STEPS = 4
TP_POS = 1000                # the TP steps' positions: 1000-1003
TP_CTX = 2048                # the TP steps' cache rows
# Megatron TP against tp=1: f32 math (K1's f32 mode) in another order of
# partial sums (another K split per shard, the all-reduce), so each output
# is held within this share of its peak
TP_REL = 1e-4
RANK_TIMEOUT = 420           # seconds for the 4 ranks' whole run
DAC_FRAMES = 256
DPTP_SLOTS = (200, 250, 253, 255, 256, 300, 505, 700)   # prompt lengths: the 8
DPTP_STEPS = 8               # steps take slots across rows 256 and 512
DPTP_CTX = 1024


def tp_inputs(name):
    """One model's random weights and its TP steps' inputs, from a generator
    seeded for that model alone, so that every process (the NCCL world of
    one and each gloo rank) draws the same bits: (source layers, step
    keywords, TP_STEPS input rows (steps, rows, H), kv_k, kv_v (L, [2,] kv
    heads, TP_CTX, D) bf16, Dia's bucketed cross (ck, cv, vtail, n_tail) or
    None)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(TP_SEED + TP_MODELS.index(name))
    cross, lead = None, ()
    if name == "parler":
        lw = mini_layers(gen)
        L, H, nh, kvh = MINI["n_layers"], MINI["hidden"], MINI["heads"], MINI["heads"]
        kw = dict(n_heads=nh)
    elif name == "orpheus":
        lw, _, _, d, okw = orpheus_source_weights(gen)
        L, H, nh, kvh = (ORPHEUS["n_layers"], ORPHEUS["hidden"], ORPHEUS["heads"],
                         ORPHEUS["kv_heads"])
        kw = dict(n_heads=nh, n_kv=kvh, head_d=d, inv=okw["inv_freq"])
    else:
        lw, d = dia_source_weights(gen)
        L, H, nh, kvh = DIA["n_layers"], DIA["hidden"], DIA["heads"], DIA["kv_heads"]
        kw = dict(n_heads=nh, n_kv=kvh, head_d=d)
        ck, cv, vt = dia_cross(gen, (2,), 256)
        cross = (ck.flatten(1, 2), cv.flatten(1, 2), vt.flatten(1, 2),
                 DIA["tc"] - 256)
        lead = (2,)
    d = H // nh
    kv = [(torch.randn((L, *lead, kvh, TP_CTX, d), generator=gen, device=DEV)
           * 0.5).to(torch.bfloat16) for _ in range(2)]
    xs = torch.randn((TP_STEPS, 2 if name == "dia" else 1, H), generator=gen,
                     device=DEV)
    return lw, kw, xs, kv[0], kv[1], cross


def tp_prep(name, lw, kw, i, tp):
    """Rank i's (of tp) Megatron layers of one model."""
    from tts_tpu_torch.parallel import dia_tp, llama_tp, tp_megastep
    if name == "parler":
        return tp_megastep.shard_tp_layers(
            tp_megastep.prep_tp_layers(lw, tp)[0], i, tp)
    mod, prep, shard = ((llama_tp, "prep_llama_tp", "shard_llama_tp")
                        if name == "orpheus" else
                        (dia_tp, "prep_dia_tp", "shard_dia_tp"))
    tpl, _ = getattr(mod, prep)(lw, tp, n_heads=kw["n_heads"],
                                n_kv=kw["n_kv"], head_d=kw["head_d"])
    return getattr(mod, shard)(tpl, i, tp)


def kv_axis(name) -> int:
    return 2 if name == "dia" else 1


def tp_step(name, sh, kw, x, kk, vv, pos, cross, group):
    from tts_tpu_torch.parallel import dia_tp, llama_tp, tp_megastep
    if name == "parler":
        return tp_megastep.megastep_tp(sh, x, kk, vv, pos, group=group,
                                       use_cross=True, n_heads=kw["n_heads"])
    if name == "orpheus":
        return llama_tp.llama_megastep_tp(sh, x, kk, vv, pos, kw["inv"],
                                          group=group, n_heads=kw["n_heads"],
                                          n_kv=kw["n_kv"])
    return dia_tp.dia_megastep_tp(sh, x, kk, vv, pos, *cross, group=group,
                                  n_heads=kw["n_heads"], n_kv=kw["n_kv"])


def write_kv_rows(name, kk, vv, pos, k_rows, v_rows) -> None:
    """A TP step's k / v rows (L, [2,] kv heads * D) into cache row pos."""
    ax = kv_axis(name)
    for c, rows in ((kk, k_rows), (vv, v_rows)):
        idx = (slice(None),) * (ax + 1) + (pos,)
        c[idx] = rows.reshape(*c.shape[:ax + 1], c.shape[-1]).to(c.dtype)


def tp_run(name, i, tp, group, ref=None) -> dict:
    """TP_STEPS steps of one model on rank i of tp, each fed step s's input
    rows, run layer by layer: with `ref` (tp=1's run) each layer is fed
    tp=1's input to it and, after each step, cache row pos holds tp=1's k /
    v rows (this rank's heads), so that a layer's error is its own (on the
    card K1's f32 mode is within ~1e-5 of exact f32 a call, and a stack of
    18 layers carries that on); without `ref` each layer takes the one
    before's output (the whole step) and the step's own rows are written.
    Returns each layer's input, output and k / v rows by step, and the
    host-clock time of each step (synchronized around it)."""
    from tts_tpu_torch.parallel.dia_tp import shard_dia_cross
    from tts_tpu_torch.parallel.sharding import split_axis
    lw, kw, xs, kv_k, kv_v, cross = tp_inputs(name)
    sh = tp_prep(name, lw, kw, i, tp)
    del lw
    ax = kv_axis(name)
    kk, vv = split_axis(kv_k, ax, i, tp), split_axis(kv_v, ax, i, tp)
    del kv_k, kv_v
    if cross is not None:
        cross = (*shard_dia_cross(*cross[:3], i, tp), cross[3])
    n_layers = kk.shape[0]
    out = dict(x_in=[], x=[], k=[], v=[], ms=[])
    for s in range(TP_STEPS):
        pos = TP_POS + s
        x = xs[s]
        rows = dict(x_in=[], x=[], k=[], v=[])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for l in range(n_layers):
            if ref is not None:
                x = ref["x_in"][s][l]
            one = type(sh)(*[f[l:l + 1] for f in sh])
            cl = None if cross is None else (*[c[l:l + 1] for c in cross[:3]],
                                             cross[3])
            rows["x_in"].append(x)
            x, kn, vn = tp_step(name, one, kw, x, kk[l:l + 1], vv[l:l + 1],
                                pos, cl, group)
            for key, t in (("x", x), ("k", kn[0]), ("v", vn[0])):
                rows[key].append(t)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        kn, vn = torch.stack(rows["k"]), torch.stack(rows["v"])
        if ref is None:
            write_kv_rows(name, kk, vv, pos, kn, vn)
        else:
            nk = ref["k"][s][0].shape[-1] // tp
            write_kv_rows(name, kk, vv, pos,
                          torch.stack(ref["k"][s])[..., i * nk:(i + 1) * nk],
                          torch.stack(ref["v"][s])[..., i * nk:(i + 1) * nk])
        for key in rows:
            out[key].append(rows[key])
    return out


def dac44k_weights(gen):
    """A random DAC-44k decoder (latent 1024, 9 codebooks of dim 8,
    channels 1536 / 768 / 384 / 192 / 96, strides 8, 8, 4, 2), as add_dac
    writes one, straight on the card."""
    from tts_tpu_torch.models.codec.dac import (CodecLayerWeights,
                                                DACWeights,
                                                QuantizeLayerWeights,
                                                ResidualUnitWeights)
    chans = (1536, 768, 384, 192, 96)

    def r(*shape, scale=0.05):
        return torch.randn(shape, generator=gen, device=DEV) * scale

    def alpha(c):
        return r(c, 1).abs() + 0.5

    layers = []
    for i, s in enumerate((8, 8, 4, 2)):
        cin, cout = chans[i], chans[i + 1]
        units = [ResidualUnitWeights(alpha(cout), r(cout, cout, 7), r(cout),
                                     alpha(cout), r(cout, cout, 1), r(cout))
                 for _ in range(3)]
        layers.append(CodecLayerWeights(alpha(cin), r(cin, cout, 2 * s),
                                        r(cout), units))
    return DACWeights(
        quantizers=[QuantizeLayerWeights(r(1024, 8), r(1024, 8, 1), r(1024))
                    for _ in range(9)],
        in_w=r(chans[0], 1024, 7), in_b=r(chans[0]), layers=layers,
        final_alpha=alpha(chans[-1]), out_w=r(1, chans[-1], 7, scale=0.001),
        out_b=r(1))


def dptp_model():
    """The dp x tp check's Parler-Mini-width weights (Q4_0 projections and
    stacked heads with f32 scales: K1's f32 mode, so that the check's bound
    measures the order of sums alone), config and 8-slot state (bf16
    caches of DPTP_CTX rows, random up to each slot's prompt length), from
    a generator seeded for it."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.parler.model import ParlerConfig, ParlerWeights
    from tts_tpu_torch.runtime import batched_parler as pbp
    gen = torch.Generator(device=DEV)
    gen.manual_seed(TP_SEED + len(TP_MODELS))
    H, n_out, vocab = MINI["hidden"], MINI["n_out"], MINI["vocab"]
    cfg = ParlerConfig(
        n_output_heads=n_out, n_encode_length=MINI["enc_len"], hidden_size=H,
        max_ctx_length=DPTP_CTX, n_attn_heads=MINI["heads"],
        output_vocab_size=vocab, max_generation_size=DPTP_CTX,
        n_layers=MINI["n_layers"])
    lw = mini_layers(gen)
    lw = lw._replace(**{f: qm.QuantTensor(m.codes, m.scales.float(), m.qtype)
                        for f, m in lw._asdict().items()
                        if isinstance(m, qm.QuantTensor)})
    w = ParlerWeights(
        layers=lw,
        embds=torch.randn((n_out, 1090, H), generator=gen, device=DEV) * 0.05,
        prompt_embd=torch.randn((len(TOKENS), H), generator=gen, device=DEV),
        pos_embd=torch.randn((DPTP_CTX, H), generator=gen, device=DEV) * 0.1,
        final_ln_w=torch.randn((H,), generator=gen, device=DEV) * 0.1 + 1.0,
        final_ln_b=torch.randn((H,), generator=gen, device=DEV) * 0.1,
        heads=rand_quant(gen, n_out * vocab, H, quants.GGML_TYPE_Q4_0,
                         torch.float32))
    st = pbp.init_batched_state(cfg, len(DPTP_SLOTS), DEV)
    for c in (st.kv_k, st.kv_v):
        c.copy_(torch.randn(c.shape, generator=gen, device=DEV) * 0.5)
    for s, p in enumerate(DPTP_SLOTS):
        pbp.insert_request(cfg, st, s, p, GenerationConfig(sample=False))
    return cfg, w, st


def dptp_steps(cfg, w, st, steps, tp_group=None, forced=None):
    """`steps` greedy batched steps through the per-matmul path, one at a
    time: (the state after them, each step's logits (B, 9, vocab), each
    step's state before it). With `forced` (such a list of states, whole
    or this rank's slots), every step starts from the forced state's feed,
    positions and sampler state (teacher forcing)."""
    from tts_tpu_torch.runtime import batched_parler as pbp
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    logits, before = [], []
    with recording(pbp, "_logits_last") as seen:
        for s in range(steps):
            if forced is not None:
                f = forced[s]
                st = st._replace(pos=f.pos.clone(), step=f.step.clone(),
                                 tokens_in=f.tokens_in.clone(),
                                 eos_seen=f.eos_seen.clone(),
                                 sampler_state=type(f.sampler_state)(
                                     *[t.clone() for t in f.sampler_state]))
            before.append(st._replace(kv_k=None, kv_v=None, out_tokens=None))
            st = pbp.batched_decode_step(cfg, w, st, gen, use_cross=True,
                                         tp_group=tp_group)
            logits.append(seen[-1])
    return st, logits, before


def parallel_reference(tmp) -> dict:
    """Phase 16's unsharded references in this process: each model's TP
    steps at tp=1 under NCCL (a world of one, the production backend) and
    the dp x tp check's unsharded per-matmul chunk; K1 must have risen on
    each TP model's steps. Saved for the ranks."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl-world",
                            world_size=1, rank=0)
    ref = {}
    try:
        for name in TP_MODELS:
            zero_counts()
            out = tp_run(name, 0, 1, None)
            counts = read_counts(f"tp=1 {name}")
            if not counts["quant_matmul"]:
                raise AssertionError(f"tp=1 {name}: K1 was not launched")
            log(f"  {name} tp=1 (nccl, a world of one): {TP_STEPS} steps, "
                f"{np.mean(out['ms'][1:]):.3f} ms a step on the host clock "
                f"(steps 2-{TP_STEPS}; the first {out['ms'][0]:.1f} ms), "
                f"K1 {counts['quant_matmul']} launches")
            ref[name] = to_dev(out, "cpu")
            torch.cuda.empty_cache()
        cfg, w, st = dptp_model()
        zero_counts()
        st, logits, before = dptp_steps(cfg, w, st, DPTP_STEPS)
        read_counts("dp x tp unsharded")
        ref["dptp"] = to_dev(dict(tokens=st.out_tokens[:, :DPTP_STEPS],
                                  logits=torch.stack(logits), before=before),
                             "cpu")
    finally:
        dist.destroy_process_group()
    torch.save(ref, os.path.join(tmp, "parallel-ref.pt"))
    return ref


def to_dev(x, dev=None):
    """x's tensors (in lists, dicts and named tuples) on `dev` (DEV)."""
    dev = DEV if dev is None else dev
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_dev(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_dev(t, dev) for t in x])
    if isinstance(x, (list, tuple)):
        return type(x)(to_dev(t, dev) for t in x)
    return x


def rank_log(*a) -> None:
    import torch.distributed as dist
    print(f"[{dist.get_rank()}]", *a, flush=True)


def rank_tp(tmp, ref, mesh) -> dict:
    """16a: each model's TP steps at tp=2 against tp=1's, step by step."""
    import torch.distributed as dist
    g, i = mesh.get_group("tp"), mesh.get_local_rank("tp")
    res = {}
    for name in TP_MODELS:
        r1 = to_dev(ref[name])
        k1 = qm.KERNEL.launches
        out = tp_run(name, i, 2, g, r1)
        worst = {}
        for key in ("x", "k", "v"):
            errs = []
            for s in range(TP_STEPS):
                for l, got in enumerate(out[key][s]):
                    want = r1[key][s][l]
                    peak = float(want.abs().max())
                    if key != "x":
                        n = want.shape[-1] // 2
                        want = want[..., i * n:(i + 1) * n]
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{name} tp=2: {key} not finite")
                    errs.append(max_err(got, want) / peak)
            worst[key] = max(errs)
            if worst[key] > TP_REL:
                raise AssertionError(f"{name} tp=2 rank {dist.get_rank()}: "
                                     f"{key} off tp=1's by {worst[key]:.3e} of "
                                     f"its peak (bound {TP_REL})")
        launches = qm.KERNEL.launches - k1
        if not launches:
            raise AssertionError(f"{name} tp=2: K1 not launched in this rank")
        res[name] = dict(worst_rel=worst, ms=out["ms"], k1=launches)
        rank_log(f"{name} tp=2 (gloo, shared cuda:0): worst layer of "
                 f"{TP_STEPS} steps, share of tp=1's peak: x {worst['x']:.2e}, k "
                 f"{worst['k']:.2e}, v {worst['v']:.2e} (bound {TP_REL}); "
                 f"{np.mean(out['ms'][1:]):.3f} ms a step on the host clock; "
                 f"K1 {launches} launches")
        del out
        torch.cuda.empty_cache()
    return res


def rank_gather(mesh) -> dict:
    """16b: the weight-gather mode at tp=2 on Parler-Mini, bit for bit
    against K2 on the unsharded weights (cache writes too)."""
    from tts_tpu_torch.parallel.tp_megastep import (megastep_weight_gather,
                                                    shard_mega_gather)
    g, i = mesh.get_group("tp"), mesh.get_local_rank("tp")
    lw, kw, xs, kv_k, kv_v, _ = tp_inputs("parler")
    mega, qtype = pm.prep_mega_layers(lw)
    del lw
    shards = shard_mega_gather(mega, i, 2)
    step = dict(qtype=qtype, use_cross=True, n_heads=kw["n_heads"])
    pos = torch.tensor([TP_POS], dtype=torch.int32, device=DEV)
    ka, va, kb, vb = kv_k.clone(), kv_v.clone(), kv_k, kv_v
    k2 = pm.KERNEL.launches
    want = pm.parler_megastep(mega, xs[0], ka, va, pos, **step)
    got = megastep_weight_gather(shards, xs[0], kb, vb, pos, group=g, **step)
    equal = all(torch.equal(a, b) for a, b in zip((*got, kb, vb), (*want, ka, va)))
    if not equal or pm.KERNEL.launches - k2 <= 0:
        raise AssertionError("the gather mode is not bit-equal to K2 on the "
                             "unsharded weights")
    ms = {}
    for label, fn in (("K2 unsharded", lambda: pm.parler_megastep(
            mega, xs[0], ka, va, pos, **step)),
            ("gather tp=2", lambda: megastep_weight_gather(
                shards, xs[0], kb, vb, pos, group=g, **step))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) * 1e3 / 5
    held = tensor_bytes([getattr(shards, f) for f in
                         ("qkv_codes", "qkv_scales", "occ_codes", "occ_scales",
                          "fc1_codes", "fc1_scales", "fc2_codes", "fc2_scales")])
    rank_log(f"gather mode tp=2: bit-equal to K2 on the unsharded weights "
             f"(x, k, v, caches); this rank holds {held / 1e6:.1f} MB of the "
             f"{2 * held / 1e6:.1f} MB of tiles; host clock a step: "
             + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return dict(ms=ms, bytes=held)


def rank_dac(mesh) -> dict:
    """16c: sharded_dac_decode of DAC_FRAMES frames over the tp axis (sp=2)
    against the card's unsharded decode."""
    from tts_tpu_torch.models.codec.dac import DACConfig, dac_decode
    from tts_tpu_torch.parallel.seq_vocoder import sharded_dac_decode
    gen = torch.Generator(device=DEV)
    gen.manual_seed(TP_SEED + len(TP_MODELS) + 1)
    cfg, w = DACConfig(), dac44k_weights(gen)
    codes = torch.randint(0, 1024, (DAC_FRAMES, cfg.n_heads), generator=gen,
                          device=DEV)
    ms = {}
    outs = {}
    for label, fn in (("unsharded", lambda: dac_decode(cfg, w, codes)),
                      ("sp=2", lambda: sharded_dac_decode(cfg, w, codes, mesh,
                                                          axis="tp"))):
        outs[label] = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) * 1e3
    full, got = outs["unsharded"], outs["sp=2"]
    diff = (got - full).abs()
    stats = dict(bit_equal=bool(torch.equal(got, full)),
                 within_1e_4=float((diff <= 1e-4).float().mean()),
                 max_abs_err=float(diff.max()), samples=full.numel(), ms=ms)
    rank_log(f"sharded_dac_decode, DAC-44k, {DAC_FRAMES} frames over sp=2 "
             f"(margin 16): {json.dumps(stats)}")
    if got.shape != full.shape or not torch.isfinite(got).all() or \
            stats["within_1e_4"] < STREAM_CLOSE or stats["max_abs_err"] > STREAM_SEAM:
        raise AssertionError("the sequence-parallel DAC decode does not meet "
                             "the streams' criterion")
    return stats


def rank_dptp(ref, mesh) -> dict:
    """16d: the batched Parler chunk over the 2 x 2 mesh (this rank's slots
    and heads): teacher-forced logits against the unsharded chunk's within
    TP_REL of their peak, then a free greedy run whose tokens equal the
    unsharded ones wherever the unsharded logits' top-2 gap exceeds that
    bound (a slot whose tokens part at a closer call is not compared
    after it)."""
    import torch.distributed as dist
    from tts_tpu_torch.parallel.sharding import (shard_batched_state,
                                                 shard_parler_weights)
    g = mesh.get_group("tp")
    di = mesh.get_local_rank("dp")
    cfg, w, st0 = dptp_model()
    ws = shard_parler_weights(w, mesh)
    del w
    b = len(DPTP_SLOTS) // 2
    mine = slice(di * b, (di + 1) * b)
    u = to_dev(ref["dptp"])
    forced = [type(f)(*[t[mine] if torch.is_tensor(t) else
                        type(t)(*[x[mine] for x in t]) if isinstance(t, tuple)
                        else t for t in f]) for f in u["before"]]
    k1 = qm.KERNEL.launches
    _, logits, _ = dptp_steps(cfg, ws, shard_batched_state(st0, mesh),
                              DPTP_STEPS, g, forced)
    want = u["logits"][:, mine]
    got = torch.stack(logits)
    rel = max_err(got, want) / float(want.abs().max())
    if not torch.isfinite(got).all() or rel > TP_REL:
        raise AssertionError(f"dp x tp rank {dist.get_rank()}: teacher-forced "
                             f"logits off by {rel:.3e} of their peak")
    st, _, _ = dptp_steps(cfg, ws, shard_batched_state(st0, mesh), DPTP_STEPS, g)
    toks, ref_toks = st.out_tokens[:, :DPTP_STEPS], u["tokens"][mine]
    top2 = want.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).permute(1, 0, 2)     # (B, steps, 9)
    bound = TP_REL * float(want.abs().max())
    parted = 0
    for s in range(b):
        diff = (toks[s] != ref_toks[s]).nonzero()
        if len(diff):
            step, head = (int(t) for t in diff[0])
            if gap[s, step, head] > bound:
                raise AssertionError(f"dp x tp: slot {di * b + s} step {step} "
                                     f"head {head} took another token with a "
                                     f"top-2 gap of {float(gap[s, step, head]):.3e}")
            parted += 1
    launches = qm.KERNEL.launches - k1
    if not launches:
        raise AssertionError("dp x tp: K1 not launched in this rank")
    rank_log(f"dp x tp 2 x 2 (gloo, shared cuda:0), Parler-Mini width, slots "
             f"{list(DPTP_SLOTS[mine])}: teacher-forced logits within "
             f"{rel:.2e} of their peak over {DPTP_STEPS} steps (bound "
             f"{TP_REL}); greedy tokens equal the unsharded chunk's "
             f"({parted} slot(s) parted at a top-2 gap under the bound); K1 "
             f"{launches} launches")
    return dict(rel=rel, parted=parted, k1=launches)


def parallel_rank(tmp) -> None:
    """Phase 16 on one of 4 gloo ranks sharing cuda:0 (spawned by
    run_parallel). Ranks 0 and 1 (the mesh's first dp row) run 16a-16c
    while ranks 2 and 3 wait; all four run 16d. Every rank's launch
    counters and K1 shapes go to parallel-rank<r>.pt."""
    import torch.distributed as dist
    from tts_tpu_torch.parallel.mesh import make_mesh
    missing = [s for s in _build.SOURCES if not _build._lib_path(s).exists()]
    if missing:   # the parent builds every kernel in phase 1
        raise AssertionError(f"kernels not built before the ranks: {missing}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(os.path.join(tmp, "parallel-ref.pt"), weights_only=False)
    mesh = make_mesh(tp=2, dp=2)
    zero_counts()
    res = {}
    if mesh.get_local_rank("dp") == 0:
        res["tp"] = rank_tp(tmp, ref, mesh)
        res["tp_shapes"] = dict(qm.SHAPES)
        res["gather"] = rank_gather(mesh)
        res["dac"] = rank_dac(mesh)
    dist.barrier()
    qm.SHAPES.clear()
    res["dptp"] = rank_dptp(ref, mesh)
    res["dptp_shapes"] = dict(qm.SHAPES)
    res["counts"] = {n: k.launches for n, k in KERNELS.items()}
    torch.save(res, os.path.join(tmp, f"parallel-rank{dist.get_rank()}.pt"))


def run_parallel(tmp) -> None:
    """Phase 16: tp=1 under NCCL here, then 4 ranks over gloo on cuda:0
    (parallel_rank): 16a Megatron TP at tp=2 for Parler-Mini, Orpheus-3B and
    the Dia-1.6B decoder at full width against tp=1, 16b the gather mode,
    16c the sequence-parallel DAC, 16d dp x tp 2 x 2. A rank that fails or
    hangs fails the phase. Times on gloo go through the host and are not
    scaling figures; one card measures correctness and each shard's K1."""
    from tts_tpu_torch.parallel.spawn import run_ranks
    parallel_reference(tmp)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        logs = run_ranks("chip_smoke:parallel_rank", 4, args=(tmp,),
                         timeout=RANK_TIMEOUT, backend="gloo", device="cuda:0")
    except RuntimeError as e:
        log(str(e))
        raise
    log(f"  4 ranks, gloo on cuda:0 (named by the caller; NCCL refuses two "
        f"ranks on one card): {time.perf_counter() - t0:.1f} s with their start")
    for text in logs:
        for line in text.splitlines():
            if line.startswith("["):
                log(f"  rank {line}")
    res = [torch.load(os.path.join(tmp, f"parallel-rank{r}.pt"),
                      weights_only=False) for r in range(4)]
    for r in (0, 1):
        for name in TP_MODELS:
            if not res[r]["tp"][name]["k1"]:
                raise AssertionError(f"rank {r}: K1 did not rise on {name} tp=2")
    if not all(x["dptp"]["k1"] for x in res):
        raise AssertionError("dp x tp: K1 did not rise in every rank")
    merge = collections.Counter()
    for r in (0, 1):
        merge.update(res[r]["tp_shapes"])
    K1_CENSUS["tp=2 ranks"] = dict(merge)
    merge = collections.Counter()
    for x in res:
        merge.update(x["dptp_shapes"])
    K1_CENSUS["dp x tp ranks"] = dict(merge)
    for name in TP_MODELS:
        ms = [np.mean(res[r]["tp"][name]["ms"][1:]) for r in (0, 1)]
        log(f"  {name}: tp=2 {max(ms):.3f} ms a step (slower rank, host "
            f"clock, gloo through the host on one card: not a scaling figure)")


def check_k4_shards() -> None:
    """K4 at the dp x tp chunk's shapes (16d) against its plain version:
    one dp rank's 4 slots, one tp rank's 8 of 16 heads of 64, a bf16 cache
    of DPTP_CTX rows, at every position the 8 steps take in either dp
    rank (across rows 256 and 512); from a generator of its own."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(TP_SEED + len(TP_MODELS) + 2)
    b, heads = len(DPTP_SLOTS) // 2, MINI["heads"] // 2
    d = MINI["hidden"] // MINI["heads"]
    kc, vc = (torch.randn((b, heads, DPTP_CTX, d), generator=gen, device=DEV)
              .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((b, heads, d), generator=gen, device=DEV)
    worst = 0.0
    for half in range(2):
        for s in range(DPTP_STEPS):
            pos = torch.tensor([p + s for p in DPTP_SLOTS[half * b:(half + 1) * b]],
                               dtype=torch.int32, device=DEV)
            got = da.decode_attention_batched_cuda(q, kc, vc, pos)
            want = da.decode_attention_batched_plain(q, kc, vc, pos)
            rel = max_err(got, want) / float(want.abs().max())
            if not torch.isfinite(got).all() or rel > 1e-5:
                raise AssertionError(f"K4 at the dp x tp shard, pos "
                                     f"{pos.tolist()}: off its plain version "
                                     f"by {rel:.3e} of the largest output")
            worst = max(worst, rel)
    log(f"K4 at the dp x tp shard (B {b}, {heads} heads of {d}, bf16 cache of "
        f"{DPTP_CTX} rows, {2 * DPTP_STEPS} position sets from "
        f"{list(DPTP_SLOTS)}): within {worst:.2e} of the largest output of "
        f"its plain version (bound 1e-5): ok")


# ---------------------------------------------------------------------------
# phase 17: the perf battery and the trace
# ---------------------------------------------------------------------------

BATTERY_SENTENCES = 8     # Parler-Mini's battery: the first 8 sentences,
BATTERY_STEPS = 64        # each decoding at least this many steps


def run_batteries(tmp) -> None:
    """Phase 17: the port's perf battery (apps/perf_battery.py) as a user
    runs it on the Kokoro-82M GGUF of phase 15 (main: the 30 Harvard
    sentences after a warm-up; no K1-K12 kernel may rise), then run_battery
    on a Parler-Mini GGUF (8 sentences, K1-K3 must rise), both JSON blobs
    logged; one sentence under utils.profiling.trace, whose file must name
    K1's kernel."""
    import io
    from tts_tpu_torch.apps import perf_battery as pb
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.utils.profiling import trace
    out = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = pb.main(["-mp", os.path.join(tmp, "kokoro-82m.gguf"), "-v",
                      KOKORO_VOICES[0]])
    counts = read_counts()
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        log(f"  Kokoro-82M battery: {line}")
    blob = json.loads(lines[-1])
    log(f"  Kokoro-82M battery: {time.perf_counter() - t0:.1f} s with the load")
    if rc or blob["sentences"] != 30 or not blob["mean_generation_rtf"] > 0:
        raise AssertionError(f"the Kokoro battery failed: {blob}")
    if any(counts.values()):
        raise AssertionError(f"a K1-K12 kernel rose on Kokoro's battery: {counts}")
    sentences = pb.TEST_SENTENCES[:BATTERY_SENTENCES]
    longest = max(prompt_len(s) for s in sentences)
    path = os.path.join(tmp, "parler-mini-q4.gguf")
    write_parler(path, np.random.default_rng(SEED), n_layers=MINI["n_layers"],
                 hidden=MINI["hidden"], heads=MINI["heads"], ffn=MINI["ffn"],
                 n_out=MINI["n_out"], vocab=MINI["vocab"], ctx=MINI["ctx"],
                 enc_len=MINI["enc_len"],
                 max_generation=longest + BATTERY_STEPS,
                 dac_chans=(1536, 768, 384, 192, 96))
    runner = runner_from_file(path, device=DEV)
    config = GenerationConfig(top_k=50, seed=SEED)
    zero_counts()
    gen_ms, audio_ms = pb.run_battery(runner, config, sentences)
    counts = read_counts("battery parler")
    text, blob = pb.printout(runner.arch, gen_ms, audio_ms)
    for line in text.strip().splitlines():
        log(f"  Parler-Mini battery: {line}")
    log(f"  Parler-Mini battery: {json.dumps(blob)} ({BATTERY_SENTENCES} "
        f"sentences, at least {BATTERY_STEPS} decode steps each; per sentence "
        f"ms {[round(g, 1) for g in gen_ms]})")
    for n in SINGLE_PATH:
        if not counts[n]:
            raise AssertionError(f"kernel {n} did not rise on the Parler battery")
    if not blob["mean_generation_rtf"] > 0:
        raise AssertionError(f"the Parler battery made no audio: {blob}")
    where = os.path.join(tmp, "trace")
    with trace(where):
        runner.generate(sentences[0], config)
    files = os.listdir(where)
    with open(os.path.join(where, files[0])) as f:
        body = f.read()
    log(f"  trace of one sentence: {files[0]} ({len(body) / 1e6:.1f} MB), "
        f"{body.count('qmm_kernel')} mentions of K1's qmm_kernel")
    if "qmm_kernel" not in body:
        raise AssertionError("the trace does not name K1's kernel")
    os.remove(path)


def kernel_name(mangled: str) -> str:
    """The unqualified name in a mangled kernel symbol: the last
    length-prefixed identifier before the template arguments."""
    head = re.split(r"I(?:L|N|P)", mangled, maxsplit=1)[0]
    for i in range(len(head)):
        m = re.match(r"(\d+)(\D\w*)$", head[i:])
        if m and len(m.group(2)) == int(m.group(1)):
            return m.group(2)
    return head[-24:]


def ptxas_summary(src: str) -> list[str]:
    """nvcc's register and spill report for one source, by the last int of
    the kernels' template arguments where their names carry one (the
    n-tiles of the llama GEMV, the epilogue of the Parler GEMV)."""
    groups, name, spill = defaultdict(list), None, 0
    for line in _build.ptxas_report(src).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            ints = re.findall(r"Li(\d+)E", name)
            groups[f"{kernel_name(name)} {ints[-1] if ints else '-'}"].append(
                (int(m.group(1)), spill))
            name = None
    return [f"{key}: {len(v)} kernels, {min(r for r, _ in v)}-"
            f"{max(r for r, _ in v)} registers, spill stores up to "
            f"{max(sp for _, sp in v)} bytes ({sum(sp > 0 for _, sp in v)} "
            f"spill)" for key, v in sorted(groups.items())]


# the tensor-core GEMVs: K6-K9 and K11's, K2 / K5's, K12's and K10's
GEMV_SOURCES = ("llama_megastep", "dia_megastep", "parler_megastep",
                "parler_flat", "dia_flat")


def hmma_count(src: str) -> int:
    """Tensor-core (HMMA) instructions in the SASS of csrc/<src>.cu's
    library, read with the CUDA toolkit's cuobjdump (beside nvcc)."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(_build._lib_path(src))],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return sum("HMMA" in line for line in res.stdout.splitlines())


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# the run's time budget (its time limit is 1200 s): phases after the build,
# and the build and phases together
PHASE_BUDGET_S, TOTAL_BUDGET_S = 700, 900


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    t_start = t0 = time.perf_counter()
    times = _build.build()
    t_phases = time.perf_counter()
    log(f"built {sorted(times)} in {t_phases - t0:.1f} s "
        f"(per source {', '.join(f'{k} {v:.1f} s' for k, v in times.items())})")
    for src in _build.SOURCES:
        for line in ptxas_summary(src):
            log(f"  ptxas {src}: {line}")
    for src in GEMV_SOURCES:
        n = hmma_count(src)
        log(f"  SASS {src}: {n} HMMA instructions (the GEMV's tensor-core "
            f"products){'' if n else ': FAIL'}")
        if not n:
            raise AssertionError(f"{src}: no tensor-core instruction in its SASS")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"[{fn.__name__}: {time.perf_counter() - t:.1f} s]")
        return out

    mega, qtype = mini_mega(gen)
    rows = [phase(check_k1, gen), phase(check_k2, gen, mega, qtype),
            phase(check_k3, gen), phase(check_k4, gen),
            phase(check_k5, gen, mega, qtype),
            phase(check_k12, gen, mega, qtype)]
    phase(time_parler_gemv, mega, qtype)
    phase(check_other_head_sizes)
    del mega
    torch.cuda.empty_cache()
    lmega, flat, lkw = orpheus_kernel_weights(gen)
    rows += phase(check_llama, gen, lmega, flat, lkw)
    rows += phase(check_llama_batched, gen, lmega, flat, lkw)
    phase(check_yardstick_defects, lmega, lkw)
    del lmega, flat, lkw
    torch.cuda.empty_cache()
    dmega, dkw = dia_kernel_weights(gen)
    rows += [phase(check_dia, gen, dmega, dkw),
             phase(check_dia_batched, gen, dmega, dkw)]
    del dmega
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase(check_small_reference, tmp)
        launches, k12_launches, path = phase(run_main_path, tmp)
        torch.cuda.empty_cache()
        tool_row = phase(run_quantize_tool, tmp)
        torch.cuda.empty_cache()
        served = phase(run_serving, path)
        phase(run_conditional_prompt, tmp, path)
        os.remove(path)
        torch.cuda.empty_cache()
        phase(check_small_orpheus, tmp)
        orpheus, k8_route, k9_route = phase(run_orpheus_main_path, tmp)
        torch.cuda.empty_cache()
        set_gguf_u32(os.path.join(tmp, "orpheus-3b-q4.gguf"),
                     "orpheus.max_generation_size", ORPHEUS_SERVING_TOKENS)
        served_orpheus = phase(run_orpheus_serving,
                               os.path.join(tmp, "orpheus-3b-q4.gguf"))
        os.remove(os.path.join(tmp, "orpheus-3b-q4.gguf"))
        torch.cuda.empty_cache()
        phase(check_small_dia, tmp)
        phase(check_slot_groups, tmp)
        phase(check_head_sizes, tmp)
        dia, dia_path = phase(run_dia_main_path, tmp)
        set_gguf_u32(dia_path, "dia.decoder.max_generation_size",
                     DIA_SERVING_STEPS)
        served_dia = phase(run_dia_serving, dia_path)
    torch.cuda.empty_cache()
    k1_errs = [phase(time_k1_census)]
    with tempfile.TemporaryDirectory() as tmp:
        phase(run_kokoro, tmp)
        timed = set(K1_CENSUS)
        torch.cuda.empty_cache()
        phase(run_parallel, tmp)
        phase(check_k4_shards)
        phase(run_batteries, tmp)
    k1_errs.append(phase(time_k1_census, [p for p in K1_CENSUS if p not in timed]))
    # K1's error over check_k1's cases and every census shape
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], *k1_errs)
    # each kernel's launches on the path it belongs to: K1-K3 on the Parler
    # CLI's single stream, K12 on its K12 route, K4 and K5 on the server's
    # batched engine, K6 on
    # the Orpheus CLI's single stream, K8 on the Orpheus K8 route, K7 on
    # the Orpheus server's batched engine, K9 on the Orpheus K9 route, K10
    # on the Dia CLI's single stream, K11 on the Dia server's batched engine
    paths = {"parler_flat_megastep": k12_launches,
             "decode_attention_batched": served, "parler_megastep_batched": served,
             "llama_flat_megastep": orpheus, "llama_megastep": k8_route,
             "llama_flat_megastep_batched": served_orpheus,
             "llama_megastep_batched": k9_route, "dia_megastep": dia,
             "dia_megastep_batched": served_dia}
    for row in rows:
        row["launches"] = paths.get(row["name"], launches)[row["name"]]
    rows.append(tool_row)   # its launches: the tool's Q4_0 run (phase 4b)
    log("streams, time to the first chunk (runners) or samples (servers) and "
        f"their match: {json.dumps(STREAMS)}")
    t_end = time.perf_counter()
    log(f"chip_smoke phases took {t_end - t_phases:.1f} s (budget "
        f"{PHASE_BUDGET_S} s; the build {t_phases - t_start:.1f} s, "
        f"{t_end - t_start:.1f} s in all, budget {TOTAL_BUDGET_S} s)")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
