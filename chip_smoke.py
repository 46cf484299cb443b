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
   K2 on that slot's state, bit for bit. K7's check prints the L2 bytes
   its GEMVs read to stage their input rows beside its weight bytes (and
   fails unless they are fewer).
3. Reference: a small Q4_0 Parler on the card (kernels) and on the CPU
   (plain versions), float32 caches on both; the card follows the CPU's
   greedy token history and its logits must match at every step.
4. Main path: a Parler-Mini-shaped Q4_0 GGUF (24 layers, H 1024, 16 heads,
   F 4096, 9 heads x vocab 1088, DAC-44k vocoder; random weights from a
   seed) written with the port's GGUF writer, turned into a WAV by the
   port's CLI (sampled, fixed seed, 256 decode steps). Every kernel's
   launch counter is set to 0 just before and read just after; K1-K3 must
   have risen. The same CLI again on the K12 route (the runner's mega from
   maybe_prep_parler_flat): K12 must have risen, K2 and K3 not. Then both
   routes timed stage by stage in turns (K2, K12, K12, K2), a device trace
   of 32 decode steps on each (the card's busy share, device time by
   kernel), and their greedy codes over the 256 steps (equal).
5. Serving path: the port's HTTP server in this process (batch_slots 8,
   the same GGUF) answers 12 concurrent requests with mixed sampling
   parameters; counters set to 0 just before, read just after; K1, K4 and
   K5 must have risen. Then the batched decode step timed and traced, one
   request through batch_slots 0, and the engine's greedy codes against
   the single-stream runner's (equal).
6. Orpheus reference: a small Q4_0 Orpheus on both decode routes (Q4_0
   head: K6; F16 head: K8) on the card and on the CPU, teacher-forced
   logits compared at every step, and the tokens vocoded through SNAC on
   both.
7. Orpheus main path: an Orpheus-3B-shaped Q4_0 GGUF (28 layers, H 3072,
   24/8 heads of 128, F 8192, vocab 156,940, Q4_0 head, F16 embeddings,
   SNAC-24k; random weights from a seed) turned into a WAV by the port's
   CLI with a voice (sampled, fixed seed, up to 2100 tokens); counters set
   to 0 just before, read just after; K1, K3 and K6 must have risen. Then
   the path timed stage by stage and a device trace of 32 decode steps,
   the K8 route (the head swapped for an F16 one, 64 decode steps): K8
   must have risen, and the K9 route (the batched engine on those weights,
   8 slots, 64 batched steps): K9 must have risen, K7 not.
8. Orpheus serving: the port's HTTP server in this process (batch_slots 8,
   the Orpheus-3B GGUF) answers 12 concurrent requests with a voice and
   mixed sampling parameters; counters set to 0 just before, read just
   after; K1, K4 and K7 must have risen. Then the batched step timed and
   traced, one request through batch_slots 0, and the engine's greedy
   tokens against the single-stream runner's (K6's; equal).

9. Dia reference: a small Q4_0 Dia's encoder on the card against the CPU's,
   then its teacher-forced CFG-merged logits (K10) card vs CPU from the
   same cross K/V, and the codes vocoded on both.
10. Dia main path: a Dia-1.6B-shaped Q4_0 GGUF (encoder 12 layers of H
   1024, decoder 18 layers of H 2048, 16 q / 4 kv heads of 128, F 8192, 9
   codebooks of vocab 1028, DAC-44k; random weights from a seed; the
   generation window cut to 1024 steps) turned into a WAV by the port's
   CLI; counters set to 0 just before, read just after; K1 and K10 must
   have risen, K4 and the cross-attention entry not (K10 runs both inside
   its one launch). Then the path timed stage by stage and a device trace
   of 32 decode steps: one K10 launch a step, at most 95 kernels a step.
11. Dia serving: the port's HTTP server in this process (batch_slots 8, the
   Dia-1.6B GGUF) answers 12 concurrent dialogue requests of 20-200 bytes
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

Phase 2 also holds K12 (the one-launch Parler step) at Parler-Mini width
at positions 0-4095 with and without the cross block: bit for bit against
K2 on the same state, layer by layer against its plain version, and timed
beside K2 in turns; then it times each Parler GEMV launch alone (qkv, o,
cq, co, fc1, fc2 at 1, 8 and 16 rows) beside its weight bytes. It holds K8 and K6 at Orpheus-3B width against their plain
versions, layer by layer at positions around K3's pages, and times them;
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
24, K6-K9 4 of 28, K10 / K11 2 of 18; the llama and Dia steps'
dequantization done once per layer for all slots), to keep the run in its
time.

The last three lines of standard output are the card's name and power
limit, one JSON object describing each kernel, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import dataclasses
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
from tts_tpu_torch.ops import parler_flat as pf
from tts_tpu_torch.ops import parler_megastep as pm
from tts_tpu_torch.ops import quant_matmul as qm

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

def check_k1(gen) -> dict:
    log("K1 quant_matmul (csrc/quant_matmul.cu) vs quant_matmul_plain:")
    H, N = MINI["hidden"], MINI["n_out"] * 1280   # heads, per-head padded
    Q4, Q5, Q8 = (quants.GGML_TYPE_Q4_0, quants.GGML_TYPE_Q5_0,
                  quants.GGML_TYPE_Q8_0)
    bf16, f32 = torch.bfloat16, torch.float32
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
    errs = []
    for name, m, n, k, qt, sd, packed in cases:
        w = rand_quant(gen, n, k, qt, sd, packed)
        x = torch.randn((m, k), generator=gen, device=DEV)
        got = qm.quant_matmul_cuda(x, w)
        ref = qm.quant_matmul_plain(x, w)
        errs.append(check_close(name, got, ref, 1e-5,
                                "same rounding, f32 sums in another order"))
    # timed at the main path's per-step shape: the 9 stacked heads, cold in
    # L2 as in the decode step (copies rotate through > 50 MB)
    ws = [rand_quant(gen, N, H, Q4, bf16) for _ in range(12)]
    x = torch.randn((1, H), generator=gen, device=DEV)
    it = iter(range(1 << 30))

    def nxt():
        return ws[next(it) % len(ws)]

    ms = device_ms(lambda: qm.quant_matmul_cuda(x, nxt()), iters=50).ms
    plain_ms = device_ms(lambda: qm.quant_matmul_plain(x, nxt())).ms
    lib_ms = device_ms(lambda: x @ nxt().dense().T).ms
    b_ms, b_by = bound(tensor_bytes((ws[0].codes, ws[0].scales)) +
                       x.numel() * 4 + N * 4, 2 * N * H, "bf16")
    log(f"  heads 1x{N}x{H}, device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"dequant+matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="quant_matmul", route="cuda",
                source="tts_tpu_torch/csrc/quant_matmul.cu",
                replaces="tts_tpu/ops/quant_matmul.py:134",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


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
                 err, base, layers=None, alt=None) -> list[float]:
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

    With `alt` (a batched step's plain version summed in another order, on
    the card), each slot of the batch is a case of its own, and its
    yardstick is the larger of the two pairs' differences: a case shows
    a flipped bf16 rounding or none, so the pair of one case often shows
    none, and 8 slots of 4 layers give the yardstick 64 chances to show
    one."""
    names = ("x_out - x_in", "k_new", "v_new")
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
        if layers is None or l in layers:
            ref = run(plain, DEV)
            with dequant_once():
                host = run(plain, torch.device("cpu"))
            pairs = [host] + ([run(alt, DEV)] if alt is not None else [])
            for i, nm in enumerate(names):
                if alt is None:
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

            us = device_ms(launch).by_name["gemv_kernel"] * 1e3
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
            del k12, v12, k2, v2
            errs += layer_errors(
                lambda l: pm.MegaLayers(*(t[l:l + 1] for t in mega[:-1]),
                                        mega.cross_pos),
                L, x, kc, vc, pos, kw, k12_step, k12_plain, "K12", err, base,
                layers=K12_LAYERS)
        log(f"  use_cross {use_cross}: x_out, k_new, v_new and both caches "
            f"equal K2's bit for bit at pos {list(K12_POS)} (max_abs_err 0): ok")
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
        f"{9 * L - 1} grid barriers), K2 {times[0]:.4f} / {times[3]:.4f} ms/step "
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
LLAMA_POS = (0, 255, 256, 511, 512, 1000, 3000)  # around K3's 256-row pages
LLAMA_LAYERS = (0, 9, 18, 27)                    # compared at every position
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


def orpheus_source_weights(gen):
    """Random Orpheus-3B weights on the card before the steps' prep: the
    stacked OrpheusLayer (Q4_0 packed, f32 scales), the head (156,940 rows),
    the final norm's weight, the head size and the step's keyword arguments
    (RoPE inverse frequencies with the llama3 factors)."""
    from tts_tpu_torch.models.orpheus.model import OrpheusLayer
    from tts_tpu_torch.ops.attention import rope_freqs
    L, H, F = ORPHEUS["n_layers"], ORPHEUS["hidden"], ORPHEUS["ffn"]
    d = H // ORPHEUS["heads"]
    kvn, f32 = ORPHEUS["kv_heads"] * d, torch.float32

    def vec():
        return torch.randn((L, H), generator=gen, device=DEV) * 0.1 + 1.0

    lw = OrpheusLayer(vec(), stack_quant(gen, L, H, H, f32),
                      stack_quant(gen, L, kvn, H, f32),
                      stack_quant(gen, L, kvn, H, f32),
                      stack_quant(gen, L, H, H, f32), vec(),
                      stack_quant(gen, L, F, H, f32), stack_quant(gen, L, F, H, f32),
                      stack_quant(gen, L, H, F, f32))
    head = rand_quant(gen, ORPHEUS["vocab"], H, quants.GGML_TYPE_Q4_0, f32)
    inv = rope_freqs(d, ORPHEUS["theta"], torch.from_numpy(
        llama3_rope_factors(d, ORPHEUS["theta"])).to(DEV))
    return lw, head, vec()[0], d, dict(n_heads=ORPHEUS["heads"],
                                       n_kv=ORPHEUS["kv_heads"], inv_freq=inv)


def orpheus_kernel_weights(gen):
    """Random Orpheus-3B weights on the card as the two steps take them: K8's
    layers (Q4_0 packed, qkv scales f32, the others bf16), K6's (every scale
    bf16, the head padded from 156,940 to 157,184 rows), both tiled for the
    GEMV, and the step's keyword arguments."""
    lw, head, out_norm, d, kw = orpheus_source_weights(gen)
    mega, qtype = lm.prep_llama_mega(lw, d)
    del lw
    flat = lf.prep_llama_flat(mega, head, out_norm, qtype, kw["n_heads"],
                              kw["n_kv"])
    return mega, flat, dict(qtype=qtype, **kw)


def k6_layers(m, x, kc, vc, pos, *, qtype, n_heads, n_kv, inv_freq):
    """K6's layer sequence alone (its launch counter, no head)."""
    xo, kn, vn = lm.layers_cuda(lf.KERNEL, da.KERNEL, m, x, kc.unsqueeze(1),
                                vc.unsqueeze(1), pos, qtype=qtype,
                                n_heads=n_heads, inv_freq=inv_freq)
    return xo, kn[:, 0], vn[:, 0]


def k7_layers(m, x, kc, vc, pos, *, qtype, n_heads, n_kv, inv_freq):
    """K7's batched layer sequence alone (its launch counter, no head)."""
    return lm.layers_cuda(lf.KERNEL_BATCHED, da.KERNEL_BATCHED, m, x, kc, vc,
                          pos, qtype=qtype, n_heads=n_heads, inv_freq=inv_freq)


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


def check_llama(gen, mega, flat, kw) -> list[dict]:
    log("K8 llama_megastep and K6 llama_flat_megastep (csrc/llama_megastep.cu "
        "+ K3) vs their plain versions, Orpheus-3B width, bf16 cache of "
        f"{ORPHEUS['ctx']} rows, positions {list(LLAMA_POS)}:")
    L, H, vocab = ORPHEUS["n_layers"], ORPHEUS["hidden"], ORPHEUS["vocab"]
    nkv, d, ctx = ORPHEUS["kv_heads"], H // ORPHEUS["heads"], ORPHEUS["ctx"]
    shape = (L, nkv, ctx, d)
    kc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    vc = (torch.randn(shape, generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    x = torch.randn((1, H), generator=gen, device=DEV)
    steps = {  # label: (weights, kernel step, plain step, layer kernel, names)
        "K8": (mega, lm.llama_megastep_cuda, lm.llama_megastep_plain,
               lm.llama_megastep_cuda, ("x_out", "k_new", "v_new")),
        "K6": (flat, lf.llama_flat_megastep_cuda, lf.llama_flat_megastep_plain,
               k6_layers, ("logits", "k_new", "v_new"))}
    errs = {label: [] for label in steps}
    pooled = {label: (defaultdict(list), defaultdict(list)) for label in steps}
    whole = {label: (defaultdict(list), defaultdict(list)) for label in steps}
    agree = 0
    for p in LLAMA_POS:
        pos = torch.tensor([p], dtype=torch.int32, device=DEV)
        for label, (w, kern, plain, layer_kern, names) in steps.items():
            layers = w if label == "K8" else w.layers
            errs[label] += layer_errors(
                lambda l: lm.LlamaMegaLayers(*(t[l:l + 1] for t in layers)),
                L, x, kc, vc, pos, kw, layer_kern, lm.llama_megastep_plain,
                label, *pooled[label], layers=LLAMA_LAYERS)
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
        f"{agree}/{len(LLAMA_POS)} positions (a near-tie among 156,940 "
        f"random logits may part them)")
    for label in steps:
        judge_layers(*pooled[label], label, f"{label} layers "
                     f"{list(LLAMA_LAYERS)} at positions {list(LLAMA_POS)}, "
                     f"layer by layer, yardstick plain on the CPU vs plain "
                     f"on the card")
        judge_layers(*whole[label], label, f"{label} whole 28-layer step at "
                     f"positions {list(LLAMA_POS)}, yardstick plain vs plain "
                     f"summed in another order")
    rows = []
    p = 1000
    pos = torch.tensor([p], dtype=torch.int32, device=DEV)
    kv_bytes = 2 * L * nkv * (p + 1) * d * 2   # rows 0..pos, bf16
    for label, (w, kern, plain, _, _) in steps.items():
        ms = step_ms(lambda: kern(w, x, kc, vc, pos, **kw),
                     f"{label} step at pos {p}")
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
        gemv = 4 * L + (label == "K6")
        log(f"  {label} 28 layers{' + head' if label == 'K6' else ''}, pos "
            f"{p}: kernels (device time) {ms:.4f} ms/step ({gemv} gemv + {L} attention "
            f"launches), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{wbytes / 1e6:.1f} MB weights + {kv_bytes / 1e6:.1f} MB KV)")
        if label == "K6":
            device_trace(lambda: [kern(w, x, kc, vc, pos, **kw) for _ in range(5)],
                         f"K6 step alone, pos {p}", 5)
        rows.append(dict(
            name="llama_megastep" if label == "K8" else "llama_flat_megastep",
            route="cuda", source="tts_tpu_torch/csrc/llama_megastep.cu",
            replaces="tts_tpu/ops/llama_megastep.py:124" if label == "K8"
            else "tts_tpu/ops/llama_flat.py:381",
            max_abs_err=max(errs[label]), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
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
    """K9 and K7 at Orpheus-3B width, 8 slots at LLAMA_SLOTS: each slot bit
    for bit against K8 / K6 on its state (and at 16 slots on the
    LLAMA_LAYERS stack), layer by layer against the plain version (the
    yardstick of check_llama), K7's whole-step logits against the plain
    version's per slot, then timed."""
    log("K9 llama_megastep_batched and K7 llama_flat_megastep_batched "
        "(csrc/llama_megastep.cu + K4) vs K8 / K6 and their plain versions, "
        f"Orpheus-3B width, bf16 cache of {ORPHEUS['ctx']} rows, 8 slots at "
        f"positions {list(LLAMA_SLOTS)}:")
    L, H, vocab = ORPHEUS["n_layers"], ORPHEUS["hidden"], ORPHEUS["vocab"]
    nkv, d, ctx = ORPHEUS["kv_heads"], H // ORPHEUS["heads"], ORPHEUS["ctx"]
    b = len(LLAMA_SLOTS)
    pos = torch.tensor(LLAMA_SLOTS, dtype=torch.int32, device=DEV)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    staged, wbytes = k7_staging(flat, b, sms)
    ok = staged < wbytes
    log(f"  K7 at {b} slots, reckoned L2 reads to stage the GEMVs' input rows: "
        f"{staged / 1e9:.3f} GB per batched step against "
        f"{wbytes / 1e9:.3f} GB of weights: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K7 stages more bytes than its weights")
    llama_slots_equal_single(mega, flat, kw, pos, "28 layers")
    sub = list(LLAMA_LAYERS)
    mega4 = lm.LlamaMegaLayers(*(t[sub] for t in mega))
    flat4 = lf.LlamaFlat(lm.LlamaMegaLayers(*(t[sub] for t in flat.layers)),
                         flat.head, flat.out_norm)
    llama_slots_equal_single(mega4, flat4, kw, torch.tensor(
        LLAMA_SLOTS_16, dtype=torch.int32, device=DEV),
        f"layers {list(LLAMA_LAYERS)}")
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
            label, err, base, layers=LLAMA_LAYERS, alt=other_order_batched_plain)
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
    for label, (w, kern, plain, _) in steps.items():
        ms = step_ms(lambda: kern(w, x, kc, vc, pos, scratch=scratch, **kw),
                     f"{label} step at {b} slots")
        plain_ms = device_ms(lambda: plain(w, x, kc, vc, pos, **kw), iters=2,
                             warmup=1).ms
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
        gemv = 4 * L + (label == "K7")
        log(f"  {label} 28 layers{' + head' if label == 'K7' else ''}, 8 slots "
            f"at {list(LLAMA_SLOTS)}: kernels (device time) {ms:.4f} ms per batched step "
            f"({gemv} gemv + {L} K4 launches), plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {wbytes / 1e6:.1f} MB weights + "
            f"{kv_bytes / 1e6:.1f} MB KV), library none")
        if label == "K7":
            device_trace(lambda: [kern(w, x, kc, vc, pos, scratch=scratch, **kw)
                                  for _ in range(5)], "K7 step alone, 8 slots", 5)
        rows.append(dict(
            name="llama_megastep_batched" if label == "K9"
            else "llama_flat_megastep_batched",
            route="cuda", source="tts_tpu_torch/csrc/llama_megastep.cu",
            replaces="tts_tpu/ops/llama_megastep.py:395" if label == "K9"
            else "tts_tpu/ops/llama_flat.py:381",
            max_abs_err=max(errs[label]), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del kc, vc
    torch.cuda.empty_cache()
    return rows


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


def add_dac(w, rng, dac_chans, n_q) -> None:
    """A DAC decoder under `audio_encoder.` (tts_tpu bench.py build_dac_44k
    shapes when dac_chans is the 44 kHz model's 1536/768/384/192/96),
    latent 1024, n_q codebooks of dim 8, random from rng."""
    def f32(name, *shape, scale=0.02):
        w.add_tensor(name, rng.standard_normal(shape, dtype=np.float32) * scale)

    a = "audio_encoder."
    f32(a + "initial.weight", dac_chans[0], 1024, 7, scale=0.05)
    f32(a + "initial.bias", dac_chans[0], scale=0.05)
    for i, s in enumerate((8, 8, 4, 2)):
        cin, cout = dac_chans[i], dac_chans[i + 1]
        b = f"{a}decoder_block.{i + 1}."
        w.add_tensor(b + "final.alpha", np.abs(rng.standard_normal(
            (1, cin, 1), dtype=np.float32) * 0.05) + 0.5)
        f32(b + "final.weight", cin, cout, 2 * s, scale=0.05)
        f32(b + "final.bias", cout, scale=0.05)
        for j in range(3):
            ub = f"{b}residual_unit.{j}.res."
            for part, kk in (("initial", 7), ("final", 1)):
                w.add_tensor(ub + part + ".alpha", np.abs(rng.standard_normal(
                    (1, cout, 1), dtype=np.float32) * 0.05) + 0.5)
                f32(ub + part + ".weight", cout, cout, kk, scale=0.05)
                f32(ub + part + ".bias", cout, scale=0.05)
    w.add_tensor(a + "final.alpha", np.abs(rng.standard_normal(
        (1, dac_chans[-1], 1), dtype=np.float32) * 0.05) + 0.5)
    f32(a + "final.weight", 1, dac_chans[-1], 7, scale=0.001)
    f32(a + "final.bias", 1, scale=0.05)
    for i in range(n_q):
        b = f"{a}quantizers.{i}."
        f32(b + "codebook.weight", 1024, 8, scale=0.05)
        f32(b + "out_proj.weight", 1024, 8, 1, scale=0.05)
        f32(b + "out_proj.bias", 1024, scale=0.05)


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


def prompt_len() -> int:
    from tts_tpu_torch.text import UnigramTokenizer
    tok = UnigramTokenizer({t: i for i, t in enumerate(TOKENS)}, 0,
                           [-10.0] + [-1.0] * (len(TOKENS) - 1), 1)
    return len(tok.tokenize(PROMPT)) + 1   # + EOS


# ---------------------------------------------------------------------------
# phase 3: a small model, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def check_small_reference(tmp) -> None:
    """A small Q4_0 Parler decoded greedily on the CPU (plain versions); the
    card (kernels) follows the same token history (teacher forcing) and its
    logits must match at every step. Free-running greedy tokens are
    reported too, but not required to match: with 9 x 1088 random logits a
    near-tie flips on a last-bit difference, and the history then parts.
    The tolerance comes from the CPU's own sensitivity, measured alongside
    on a run whose positional embeddings moved by one ulp."""
    from tts_tpu_torch.models.parler import model as pmodel
    from tts_tpu_torch.models.registry import runner_from_file
    log("Reference: small Q4_0 Parler (L=2, H=256, 4 heads, 48 steps), f32 "
        "caches, card kernels vs CPU plain versions:")
    path = os.path.join(tmp, "parler-small.gguf")
    write_parler(path, np.random.default_rng(SEED + 1), n_layers=2, hidden=256,
                 heads=4, ffn=1024, n_out=9, vocab=1088, ctx=256, enc_len=16,
                 max_generation=prompt_len() + 48, dac_chans=(64, 32, 16, 8, 4))
    kw = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
              repetition_penalty=1.0)
    runners, states = [], []
    gen = torch.Generator().manual_seed(SEED)
    for dev, perturb in ((DEV, False), (torch.device("cpu"), False),
                         (torch.device("cpu"), True)):
        r = runner_from_file(path, device=dev)
        assert r.mega is not None, "small model must take the megastep path"
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
    with torch.no_grad():
        for _ in range(48):
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
    log(f"  teacher-forced logits, max |card - cpu| / max|logit|: {worst:.3e} "
        f"(step 0: {first:.3e}); the CPU's own change under 1-ulp input "
        f"changes: {sens:.3e}; tol {tol:.3e}; argmax agreement {agree}/{n}")
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
           "parler_flat_megastep": pf.KERNEL}
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


def cli_wav(path, wav) -> tuple[dict, np.ndarray]:
    """The port's CLI on `path` (sampled, top-k 50, seed SEED), every
    kernel's counter set to 0 just before and read just after; the WAV must
    be a valid waveform. Returns (launches, audio)."""
    from tts_tpu_torch.apps import cli
    from tts_tpu_torch.audio.wav import read_audio_file
    for k in KERNELS.values():
        k.launches = 0
    rc = cli.main(["-mp", path, "-p", PROMPT, "-sp", wav, "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in KERNELS.items()}
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


def run_main_path(tmp) -> tuple[dict, dict, str]:
    """The Parler CLI main path on K2's route (K1-K3 must have been
    launched), then on the K12 route (K12 must have been launched, K2 and
    K3 not); both routes timed stage by stage in turns (K2, K12, K12, K2)
    and traced; their greedy codes equal. Returns (the K2 route's launches,
    the K12 route's launches, the GGUF's path)."""
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
    launches, audio = cli_wav(path, os.path.join(tmp, "out.wav"))
    for n in SINGLE_PATH:
        if launches[n] == 0:
            raise AssertionError(f"kernel {n} was not launched on the main path")
    log("Main path, K12 route (the runner's mega from maybe_prep_parler_flat):")
    with k12_route():
        k12_launches, audio12 = cli_wav(path, os.path.join(tmp, "out-k12.wav"))
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
    (o2, n2), (o12, n12) = greedy_out(r, k2), greedy_out(r, flat)
    if n2 != n12 or not np.array_equal(o2, o12):
        raise AssertionError("greedy codes of the K12 route differ from the "
                             "K2 route's")
    log(f"  greedy codes of the two routes equal over {n2} steps: ok")
    return launches, k12_launches, path


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


def start_server(path, config, batch_slots):
    """The port's server in this process on 127.0.0.1, an ephemeral port;
    returns (server, httpd, base url) once it is READY (kernels built,
    model loaded), or raises."""
    from tts_tpu_torch.server.server import build_server, serve
    srv = build_server(path, config=config, batch_slots=batch_slots,
                       timeout=900.0, device=DEV)
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
                  prompts=None):
    """The port's server in this process (batch_slots 8, a sampled default
    config with top-k 50) answers 12 concurrent requests with the given
    per-request parameters; every response must be a WAV at `rate` of
    whole `frame`s with the right top-k cap header, /metrics must count 12
    requests and no failure, and each of `kernels` must have been launched
    (counters set to 0 just before, read just after). Then the batched
    decode step alone: an `engine_cls` engine with 8 live slots, a 32-step
    chunk timed (one host sync), a 32-step chunk traced; and one request
    through batch_slots 0. `prompts` default to `serving_prompts` of the
    runner's tokenizer. Returns (runner, prompts, stats, launches)."""
    from tts_tpu_torch.common import GenerationConfig
    log(f"{label} serving: the port's server, batch_slots 8, sampled default "
        f"config, 12 concurrent requests:")
    srv, httpd, base = start_server(path, GenerationConfig(top_k=50), 8)
    runner = srv.runners[srv.default_model]
    prompts = prompts or serving_prompts(runner.tokenizer)
    params = params[:len(prompts)]
    results = [None] * len(prompts)

    def req(i):
        t0 = time.perf_counter()
        r = _post(base, dict(input=prompts[i], **params[i]))
        results[i] = (r, time.perf_counter() - t0)

    threads = [threading.Thread(target=req, args=(i,)) for i in range(len(prompts))]
    torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in KERNELS.items()}
    httpd.shutdown()
    secs = []
    for i, ((code, body, headers), _) in enumerate(results):
        if code != 200:
            raise AssertionError(f"request {i} answered {code}: {body[:300]!r}")
        secs.append(check_wav(body, rate, frame))
        capped = headers.get("X-TTS-Top-K-Applied")
        if capped != ("256" if params[i]["top_k"] == 0 else None):
            raise AssertionError(f"request {i}: X-TTS-Top-K-Applied {capped!r}")
    m = srv.metrics_json()
    lat = sorted(t for _, t in results)
    log(f"  audio seconds per request {[round(x, 3) for x in secs]}; every "
        f"response a WAV, top-k cap headers right; /metrics requests "
        f"{m['requests_total']}, failed {m['requests_failed']}; launches "
        f"{launches}")
    if m["requests_total"] != len(prompts) or m["requests_failed"]:
        raise AssertionError("/metrics does not count 12 requests and 0 failures")
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
                  vocab, q4_head, snac_dims, snac_latent):
    """An Orpheus GGUF as `tts_tpu.apps.quantize -qt Q4_0` leaves one:
    Q4_0 projections (and with q4_head, as -qh gives it, a Q4_0 LM head;
    else F16), an F16 embed_tokens, F32 norms and llama3 RoPE factors, and
    a SNAC decoder in F32 under `snac.` (residual units depthwise)."""
    d = hidden // heads
    w = GGUFWriter(path, "orpheus")
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

def check_small_orpheus(tmp) -> None:
    """A small Q4_0 Orpheus on both decode routes (Q4_0 head: K6; F16 head:
    K8), decoded greedily on the CPU (plain versions); the card (kernels)
    follows the same token history (teacher forcing) and its logits must
    match at every step, within 4x the CPU's own change when every
    embedding moves by one ulp, or 1e-3 (the Parler check's rule). Then
    the CPU's tokens are vocoded on both (SNAC, 4 channel widths)."""
    from tts_tpu_torch.models.orpheus import model as omodel
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.ops.llama_flat import LlamaFlat
    n_steps = 48
    kw = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
              repetition_penalty=1.0, max_steps=n_steps + 1)
    for q4_head, route in ((True, "K6"), (False, "K8")):
        log(f"Reference: small Q4_0 Orpheus (L=2, H=256, 4/2 heads, F 1024, "
            f"{'Q4_0' if q4_head else 'F16'} head: {route}), f32 caches, "
            f"{n_steps} steps, card kernels vs CPU plain versions:")
        path = os.path.join(tmp, f"orpheus-small-{route}.gguf")
        write_orpheus(path, np.random.default_rng(SEED + 2), n_layers=2,
                      hidden=256, heads=4, kv_heads=2, ffn=1024, vocab=1000,
                      q4_head=q4_head, snac_dims=(64, 32, 16, 8, 4),
                      snac_latent=32)
        gen = torch.Generator().manual_seed(SEED)
        runs = []
        for dev, perturb in ((DEV, False), (torch.device("cpu"), False),
                             (torch.device("cpu"), True)):
            r = runner_from_file(path, device=dev)
            if (route == "K6") != isinstance(r.mega.step, LlamaFlat):
                raise AssertionError(f"small model did not take the {route} route")
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
        log(f"  prefill logits (K1) max |card - cpu| / max|logit| {pre:.3e}; "
            f"teacher-forced decode logits ({route}): {worst:.3e}; the CPU's own "
            f"change under 1-ulp embedding changes: {sens:.3e}; tol {tol:.3e}; "
            f"argmax agreement {agree}/{n_steps}")
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


# ---------------------------------------------------------------------------
# phase 7: the Orpheus main path at Orpheus-3B width, and the K8 route
# ---------------------------------------------------------------------------

ORPHEUS_PATH = ("quant_matmul", "decode_attention", "llama_flat_megastep")
K8_ROUTE_STEPS = 64
K9_ROUTE_STEPS = 64
TOKEN_AUDIO_S = 2048 / 7 / 24000   # 7 tokens -> 4 SNAC frames of 512 samples


def run_orpheus_main_path(tmp) -> tuple[dict, dict]:
    """Orpheus-3B Q4_0 (Q4_0 head) + SNAC-24k text -> WAV through the port's
    CLI on the card (sampled, top-k 50, fixed seed, up to 2100 tokens);
    counters set to 0 just before, read just after: K1, K3 and K6 must have
    risen. Then the same path timed stage by stage and traced, and the K8
    route: the loaded weights with the head swapped for an F16 one, 64
    decode steps through the runner's decode loop."""
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
                  snac_dims=SNAC_24K["dims"], snac_latent=SNAC_24K["latent"])
    log(f"Orpheus main path: wrote {os.path.getsize(path) / 1e6:.1f} MB GGUF in "
        f"{time.perf_counter() - t0:.1f} s; voice {VOICE!r}, prompt {PROMPT!r}")
    wav = os.path.join(tmp, "orpheus.wav")
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["-mp", path, "-p", PROMPT, "-v", VOICE, "-sp", wav,
                   "--seed", str(SEED)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in KERNELS.items()}
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
    if n_out != cfg.max_generation_size and out_np[n_out - 1] != cfg.stopping_token_id:
        raise AssertionError(f"generation stopped at {n_out} tokens without "
                             f"the stopping token")
    if wav_np.size != 4 * (n_out // 7) * 512 or not np.all(np.isfinite(wav_np)):
        raise AssertionError("timed run produced the wrong shape")
    if not ((out_np[:n_out] >= 0) & (out_np[:n_out] < cfg.vocab_size)).all():
        raise AssertionError("a token is out of the vocabulary")
    # a steady window of 32 decode steps, from the prompt's end again
    st = omodel.init_state(cfg, first, len(ids), kk, vv, cfg.max_generation_size)
    st = device_trace(lambda: omodel.decode_chunk(
        cfg, w, inv, st, 32, gen, mega=r.mega,
        max_steps=cfg.max_generation_size, **kw), "Orpheus decode (K6)", 32)
    if int(st.n_out) != 33:
        raise AssertionError("traced decode window produced the wrong count")

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
    if n8 != K8_ROUTE_STEPS + 1 or k8_launches["llama_megastep"] == 0 or \
            k8_launches["llama_flat_megastep"] or bool((toks < 0).any()) or \
            bool((toks >= cfg.vocab_size).any()):
        raise AssertionError("the K8 route did not decode through K8")
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
    if k9_launches["llama_megastep_batched"] == 0 or \
            k9_launches["llama_flat_megastep_batched"]:
        raise AssertionError("the K9 route did not decode through K9")
    return launches, k8_launches, k9_launches


# ---------------------------------------------------------------------------
# phase 8: serving Orpheus-3B, continuous batching through the HTTP server
# ---------------------------------------------------------------------------

ORPHEUS_SERVING_PATH = ("quant_matmul", "decode_attention_batched",
                        "llama_flat_megastep_batched")
GREEDY_TOKENS = 300   # the greedy parity check's generation window


def run_orpheus_serving(path) -> dict:
    """The Orpheus serving path (`serving_burst` with a voice on every
    request: K1, K4 and K7 must have been launched), then the engine's
    greedy tokens against the single-stream runner's (K6). Returns the
    launch counts of the 12 requests."""
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.models.orpheus import model as omodel
    from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine
    params = [dict(p, seed=i) for i, p in enumerate(serving_params(voice=VOICE))]
    runner, prompts, stats, launches = serving_burst(
        path, BatchedLlamaEngine, params, 24000, 2048, ORPHEUS_SERVING_PATH,
        "Orpheus")
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
# The one cut: max_generation_size 1024 of 3072 in the GGUF, so that the
# runs fit (the kernel checks keep the 3072-row cache).
DIA = dict(enc_layers=12, enc_hidden=1024, enc_heads=16, enc_ffn=4096,
           n_layers=18, hidden=2048, heads=16, kv_heads=4, ffn=8192, n_out=9,
           vocab=1028, tc=1024, max_gen=1024)
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
                                 alt=dia_step(other_order_dia_plain))
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
                            alt=dia_step(other_order_dia_batched_plain))
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


def dia_small_runners(tmp):
    """A small Q4_0 Dia (L=2, H=256, 4/2 heads of 64, F 1024; a 1-layer
    encoder of H 128; 9 codebooks of 1028; a 1024-byte window; a small DAC)
    loaded on the card, on the CPU, and on the CPU with every decoder
    embedding moved by one ulp."""
    from tts_tpu_torch.models.registry import runner_from_file
    path = os.path.join(tmp, "dia-small.gguf")
    write_dia(path, np.random.default_rng(SEED + 3), enc_layers=1,
              enc_hidden=128, enc_heads=2, enc_ffn=256, n_layers=2, hidden=256,
              heads=4, kv_heads=2, ffn=1024, n_out=9, vocab=1028, tc=1024,
              max_gen=64, dac_chans=(64, 32, 16, 8, 4))
    gen = torch.Generator().manual_seed(SEED)
    runners = [runner_from_file(path, device=dev) for dev in
               (DEV, torch.device("cpu"), torch.device("cpu"))]
    e = runners[2].weights.dec_embds
    e.mul_(1 + (torch.randint(0, 2, e.shape, generator=gen) * 2 - 1) * 2 ** -23)
    if any(r.mega is None for r in runners):
        raise AssertionError("small Dia must take the K10 route")
    return runners


def check_small_dia(tmp) -> None:
    """A small Q4_0 Dia: its encoder on the card against the CPU's (f32,
    1e-4 of the largest value); then greedy decoding on the CPU (plain
    versions) while the card (kernels) follows the same token history
    (teacher forcing) from the same cross K/V, float32 caches on both: the
    CFG-merged logits must match at every step, within 4x the CPU's own
    change when every decoder embedding moves by one ulp, or 1e-3 (the
    Parler check's rule). Then the CPU's codes vocoded on both."""
    from tts_tpu_torch.models.dia import model as dmodel
    n_steps = 48
    log(f"Reference: small Q4_0 Dia (decoder L=2, H=256, 4/2 heads; encoder "
        f"L=1, H=128; 1024-byte window), f32 caches, {n_steps} steps, card "
        f"kernels vs CPU plain versions:")
    runners = dia_small_runners(tmp)
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
    log(f"  encoder cross K / V, max |card - cpu| / max: {enc_err:.3e} (tol "
        f"1e-4: f32, TF32 off); teacher-forced logits (K10, Sb "
        f"{cross.ck.shape[2]}, n_tail {cross.n_tail}): {worst:.3e}; the "
        f"CPU's own change under 1-ulp embedding changes: {sens:.3e}; tol "
        f"{tol:.3e}; argmax agreement {agree}/{n_steps * cfg.n_output_heads}")
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


# ---------------------------------------------------------------------------
# the Dia main path and Dia serving at Dia-1.6B width
# ---------------------------------------------------------------------------

DIA_PATH = ("quant_matmul", "dia_megastep")
DIA_KERNELS_PER_STEP = 95   # the Dia CLI's device trace may show at most
DIA_SERVING_PATH = ("quant_matmul", "decode_attention_batched",
                    "dia_megastep_batched", "dia_cross_attention_batched")
DIA_GREEDY_STEPS = 300   # the greedy parity check's generation window
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
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["-mp", path, "-p", DIA_PROMPT, "-sp", wav, "--seed", str(SEED)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in KERNELS.items()}
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

    def parity(label, eng, prompts, want, same):
        rids = [eng.submit(p, greedy) for p in prompts]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    t_start = t0 = time.perf_counter()
    times = _build.build()
    log(f"built {sorted(times)} in {time.perf_counter() - t0:.1f} s "
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
    del mega
    torch.cuda.empty_cache()
    lmega, flat, lkw = orpheus_kernel_weights(gen)
    rows += phase(check_llama, gen, lmega, flat, lkw)
    rows += phase(check_llama_batched, gen, lmega, flat, lkw)
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
        served = phase(run_serving, path)
        os.remove(path)
        torch.cuda.empty_cache()
        phase(check_small_orpheus, tmp)
        orpheus, k8_route, k9_route = phase(run_orpheus_main_path, tmp)
        torch.cuda.empty_cache()
        served_orpheus = phase(run_orpheus_serving,
                               os.path.join(tmp, "orpheus-3b-q4.gguf"))
        os.remove(os.path.join(tmp, "orpheus-3b-q4.gguf"))
        torch.cuda.empty_cache()
        phase(check_small_dia, tmp)
        phase(check_slot_groups, tmp)
        dia, dia_path = phase(run_dia_main_path, tmp)
        served_dia = phase(run_dia_serving, dia_path)
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
    log(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s")
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
