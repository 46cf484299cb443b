#!/usr/bin/env python3
"""Compare other versions of the Orpheus GEMV (`tts_tpu_torch/csrc/
llama_megastep.cu` with the kernel of `csrc/gemv.cuh`, which K6-K9 drive)
with the committed one on one card, in turns.

    python3 gemv_ab.py OTHER.cu [OTHER2.cu ...]

Builds the committed source (through `ops/_build.py`) and each OTHER.cu
(the same nvcc flags and the committed headers, all at once; an OTHER.cu
that includes "gemv.cuh" reads a gemv.cuh beside it first, so a changed
kernel goes in a copy of the header there), then, at
Orpheus-3B width with random weights from a seed and bf16 caches of 3584
rows, times K8 and K6 at one slot and K9 and K7 at 8 and 16 slots (the
chip_smoke positions) with CUDA events: OTHER first, then the committed
source twice, then OTHER again. It prints whether the two versions'
outputs are bit-equal: a change that keeps each row's summation order
keeps them so. Needs a card and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
from tts_tpu_torch.ops import _build
from tts_tpu_torch.ops import llama_flat as lf
from tts_tpu_torch.ops import llama_megastep as lm

KERNELS = (lm.KERNEL, lf.KERNEL, lm.KERNEL_BATCHED, lf.KERNEL_BATCHED)


def build_others(srcs, out_dir: str) -> list:
    """Each source's tts_llama_gemv, the nvcc runs started together."""
    procs = []
    for i, src in enumerate(srcs):
        so = os.path.join(out_dir, f"other{i}.so")
        procs.append((so, subprocess.Popen(
            [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(_build.CSRC_DIR), "-o", so, src])))
    fns = []
    for so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {so}")
        fn = ctypes.CDLL(so).tts_llama_gemv
        fn.argtypes = lm.ARGS
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def use(fn) -> None:
    """Point every llama wrapper's C entry at `fn`."""
    for k in KERNELS:
        k.entry()
        k._fn = fn


def main(other_srcs) -> int:
    if not torch.cuda.is_available():
        print("gemv_ab: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    _build.build(["llama_megastep", "decode_attention"])
    ours = lm.KERNEL.entry()
    with tempfile.TemporaryDirectory() as tmp:
        others = build_others(other_srcs, tmp)
        gen = torch.Generator(device=cs.DEV)
        gen.manual_seed(cs.SEED)
        mega, flat, kw = cs.orpheus_kernel_weights(gen)
        L, H, ctx = cs.ORPHEUS["n_layers"], cs.ORPHEUS["hidden"], cs.ORPHEUS["ctx"]
        for b in (1, 8, 16):
            slots = cs.LLAMA_SLOTS_16 if b == 16 else cs.LLAMA_SLOTS
            pos = torch.tensor(slots[:b] if b > 1 else [1000], dtype=torch.int32,
                               device=cs.DEV)
            shape = (L, b, cs.ORPHEUS["kv_heads"], ctx, H // cs.ORPHEUS["heads"])
            kc = (torch.randn(shape, generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
            vc = (torch.randn(shape, generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
            x = torch.randn((b, H), generator=gen, device=cs.DEV)
            sc = lm.step_scratch(mega, b, cs.ORPHEUS["heads"], ctx, cs.DEV)
            if b == 1:
                steps = {"K8": lambda: lm.llama_megastep_cuda(
                             mega, x, kc[:, 0], vc[:, 0], pos, **kw),
                         "K6": lambda: lf.llama_flat_megastep_cuda(
                             flat, x, kc[:, 0], vc[:, 0], pos, **kw)}
            else:
                steps = {"K9": lambda: lm.llama_megastep_batched_cuda(
                             mega, x, kc, vc, pos, scratch=sc, **kw),
                         "K7": lambda: lf.llama_flat_megastep_batched_cuda(
                             flat, x, kc, vc, pos, scratch=sc, **kw)}
            for src, other in zip(other_srcs, others):
                for name, fn in steps.items():
                    times, outs = {"other": [], "ours": []}, {}
                    for tag, impl in (("other", other), ("ours", ours),
                                      ("ours", ours), ("other", other)):
                        use(impl)
                        times[tag].append(cs.cuda_ms(fn, iters=10, warmup=2))
                        outs[tag] = [t.clone() for t in fn()]
                    same = all(torch.equal(a, c) for a, c in
                               zip(outs["other"], outs["ours"]))
                    print(f"{name} at {b} slot(s): {os.path.basename(src)} "
                          f"{', '.join(f'{t:.4f}' for t in times['other'])} ms, "
                          f"committed "
                          f"{', '.join(f'{t:.4f}' for t in times['ours'])} ms; "
                          f"outputs bit-equal {same}", flush=True)
            del kc, vc
            torch.cuda.empty_cache()
        use(ours)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
