#!/usr/bin/env python3
"""Compare the port's decode-step kernels with other versions of their
sources on one card, in turns, by device time.

    python3 gemv_ab.py [--only attention|steps] [OTHER ...]

OTHER is another version of `tts_tpu_torch/csrc`: a directory that holds
its sources (for example a parent commit's, unpacked with `git archive`
into an ignored directory such as `chip_archive/`), or one .cu file of
such a version. Of each OTHER, `llama_megastep.cu` (the GEMV of K6-K9,
`csrc/gemv.cuh`), `dia_megastep.cu` (K10 / K11), `parler_megastep.cu` (the
gemv of K2 / K5) and `decode_attention.cu` (K3 / K4 and the Dia
cross-attention) are built where present, with the committed nvcc flags,
all at once; a source includes the headers of its own directory first,
then the committed ones. A version without one of them runs the
committed one in its place. An attention source whose
library lacks `tts_attention_abi` takes the older entry signature, without
the arrival counters' pointer.

With random weights from a seed, at Parler-Mini, Orpheus-3B and Dia-1.6B
widths, it measures in turns (OTHER, committed, committed, OTHER):
- attention: K3 at Parler's 16 heads of 64, Orpheus's 24 q / 8 kv heads of
  128 and Dia's 16 / 4 heads of 128 at pos 1000 (bf16 caches, 8 layers
  taken in turn so that the K/V rows come from device memory), and K4 at 8
  slots at mixed positions at the same shapes; PyTorch's
  scaled_dot_product_attention on the same inputs is timed beside them;
- the steps: K8 / K6 at one slot (pos 1000), K9 / K7 at 8 and 16 slots
  and K11 at 4 and 8 pairs at chip_smoke's mixed positions, K10 at one
  pair (pos 1000), K2 at pos 1000 and K5 at 8 slots, with the GEMV's and
  the attention's device time.
Times are device time per call or step from torch.profiler (the kernels a
call ran, summed over 20 calls; chip_smoke.device_ms). Each line says
whether the two versions' outputs are bit-equal. With no OTHER it measures
the committed sources alone; `--only` keeps one of the two parts. Needs a
card and nvcc.
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
from tts_tpu_torch.ops import decode_attention as da
from tts_tpu_torch.ops import dia_megastep as dm
from tts_tpu_torch.ops import llama_flat as lf
from tts_tpu_torch.ops import llama_megastep as lm
from tts_tpu_torch.ops import parler_megastep as pm

# (source, C entry, the wrappers that launch it)
ENTRIES = (
    ("llama_megastep", "tts_llama_gemv",
     (lm.KERNEL, lf.KERNEL, lm.KERNEL_BATCHED, lf.KERNEL_BATCHED)),
    ("dia_megastep", "tts_dia_gemv", (dm.KERNEL, dm.KERNEL_BATCHED)),
    ("parler_megastep", "tts_parler_gemv", (pm.KERNEL, pm.KERNEL_BATCHED)),
    ("decode_attention", "tts_decode_attention", (da.KERNEL, da.KERNEL_BATCHED)),
    ("decode_attention", "tts_cross_attention", (dm.CROSS, dm.CROSS_BATCHED)),
)
# where the arrival counters' pointer sits in the attention entries' argument
# lists; an older library takes the same arguments without it
ARRIVALS_ARG = {"tts_decode_attention": 7, "tts_cross_attention": 8}
SOURCES = sorted({src for src, _, _ in ENTRIES})
ATTN_LAYERS = 8
ATTN_SHAPES = (("parler", 16, 16, 64), ("orpheus", 24, 8, 128),
               ("dia", 16, 4, 128))   # name, q heads, kv heads, head size


def committed(sources=SOURCES) -> dict:
    """{C entry: function} of the committed `sources` (built if needed)."""
    return {sym: kernels[0].entry() for src, sym, kernels in ENTRIES
            if src in sources}


def has_arrivals(lib) -> bool:
    return hasattr(lib, "tts_attention_abi")


def build_others(paths, out_dir: str, sources=SOURCES) -> list:
    """Each OTHER as {C entry: function}, from its `sources`; the nvcc runs
    start together."""
    new_abi = has_arrivals(_build.load("decode_attention"))
    procs = []
    for i, path in enumerate(paths):
        srcs = [path] if path.endswith(".cu") else \
            [os.path.join(path, f"{s}.cu") for s in sources]
        for src in (s for s in srcs if os.path.exists(s)):
            name = os.path.basename(src)[:-3]
            if name not in SOURCES:
                raise ValueError(f"{src}: not one of {SOURCES}")
            so = os.path.join(out_dir, f"other{i}-{name}.so")
            procs.append((i, name, so, subprocess.Popen(
                [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.CSRC_DIR),
                 "-o", so, src])))
    versions = [committed(sources) for _ in paths]
    for i, name, so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu of {paths[i]}")
        lib = ctypes.CDLL(so)
        for src, sym, kernels in ENTRIES:
            if src != name:
                continue
            fn = getattr(lib, sym)
            argtypes = list(kernels[0].argtypes)
            drop = ARRIVALS_ARG.get(sym) if new_abi and not has_arrivals(lib) \
                else None
            if drop is not None:
                del argtypes[drop]
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            versions[i][sym] = fn if drop is None else \
                (lambda f, d: lambda *a: f(*a[:d], *a[d + 1:]))(fn, drop)
    return versions


def use(version: dict) -> None:
    """Point every wrapper's C entry at `version`'s."""
    for _, sym, kernels in ENTRIES:
        for k in kernels:
            if sym in version:
                k.entry()
                k._fn = version[sym]


def outputs(res):
    return [t.clone() for t in (res if isinstance(res, (tuple, list)) else (res,))]


def compare(label, fn, ours, others, paths, extra="") -> None:
    """Time fn() under each OTHER and the committed sources in turns (OTHER,
    committed, committed, OTHER) and print the device times, the GEMV's
    and the attention's part, and whether the outputs are bit-equal."""
    def run(version):
        use(version)
        dt = cs.device_ms(fn)
        gemv = sum(t for k, t in dt.by_name.items() if "gemv" in k)
        attn = sum(t for k, t in dt.by_name.items() if "attn" in k)
        return (dt.ms, gemv, attn), outputs(fn())

    def fmt(t):
        return f"{t[0]:.4f} (gemv {t[1]:.4f}, attention {t[2]:.4f})"

    if not others:
        t, _ = run(ours)
        print(f"{label}: {fmt(t)} ms{extra}", flush=True)
        return
    for path, other in zip(paths, others):
        times, outs = {"other": [], "ours": []}, {}
        for tag, version in (("other", other), ("ours", ours), ("ours", ours),
                             ("other", other)):
            t, outs[tag] = run(version)
            times[tag].append(t)
        same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["ours"]))
        print(f"{label}: {os.path.basename(os.path.normpath(path))} "
              f"{' / '.join(fmt(t) for t in times['other'])} ms; committed "
              f"{' / '.join(fmt(t) for t in times['ours'])} ms; outputs "
              f"bit-equal {same}{extra}", flush=True)
    use(ours)


def attention(ours, others, paths, gen) -> None:
    dev, ctx, p = cs.DEV, 4096, 1000
    for name, hq, hkv, d in ATTN_SHAPES:
        kc, vc = ((torch.randn((ATTN_LAYERS, hkv, ctx, d), generator=gen,
                               device=dev) * 0.5).to(torch.bfloat16)
                  for _ in range(2))
        q = torch.randn((hq, d), generator=gen, device=dev)
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        turn = iter(range(1 << 30))

        def k3():
            l = next(turn) % ATTN_LAYERS
            return da.decode_attention_cuda(q, kc[l], vc[l], pos)

        qb = q.to(torch.bfloat16)[None, :, None, :]

        def lib():
            l = next(turn) % ATTN_LAYERS
            return cs.sdpa(qb, kc[l, None, :, :p + 1], vc[l, None, :, :p + 1])

        lib_ms = cs.device_ms(lib).ms
        compare(f"K3 {name} {hq}/{hkv} heads of {d}, pos {p}", k3, ours, others,
                paths, f"; sdpa {lib_ms:.4f} ms")
        del kc, vc
        b = len(cs.MIXED_POS)
        kc, vc = ((torch.randn((b, hkv, ctx, d), generator=gen, device=dev)
                   * 0.5).to(torch.bfloat16) for _ in range(2))
        q = torch.randn((b, hq, d), generator=gen, device=dev)
        pos = torch.tensor(cs.MIXED_POS, dtype=torch.int32, device=dev)
        qb = q.to(torch.bfloat16)[:, :, None, :]
        mask = (torch.arange(ctx, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
        lib_ms = cs.device_ms(lambda: cs.sdpa(qb, kc, vc, mask)).ms
        compare(f"K4 {name} {hq}/{hkv} heads of {d}, {b} slots at "
                f"{list(cs.MIXED_POS)}", lambda: da.decode_attention_batched_cuda(
                    q, kc, vc, pos), ours, others, paths,
                f"; masked sdpa {lib_ms:.4f} ms")
        del kc, vc
        torch.cuda.empty_cache()


def llama_steps(ours, others, paths, gen) -> None:
    mega, flat, kw = cs.orpheus_kernel_weights(gen)
    L, H, ctx = cs.ORPHEUS["n_layers"], cs.ORPHEUS["hidden"], cs.ORPHEUS["ctx"]
    nkv, d = cs.ORPHEUS["kv_heads"], H // cs.ORPHEUS["heads"]
    dev = cs.DEV
    for b in (1, 8, 16):
        slots = cs.LLAMA_SLOTS_16 if b == 16 else cs.LLAMA_SLOTS
        pos = torch.tensor(slots[:b] if b > 1 else [1000], dtype=torch.int32,
                           device=dev)
        kc, vc = ((torch.randn((L, b, nkv, ctx, d), generator=gen, device=dev)
                   * 0.5).to(torch.bfloat16) for _ in range(2))
        x = torch.randn((b, H), generator=gen, device=dev)
        sc = lm.step_scratch(mega, b, cs.ORPHEUS["heads"], ctx, dev)
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
        where = "pos 1000" if b == 1 else f"{b} slots at {list(slots[:b])}"
        for name, fn in steps.items():
            compare(f"{name} {where}", fn, ours, others, paths)
        del kc, vc
        torch.cuda.empty_cache()
    del mega, flat
    torch.cuda.empty_cache()


def dia_steps(ours, others, paths, gen) -> None:
    mega, kw = cs.dia_kernel_weights(gen)
    L, H, nkv = cs.DIA["n_layers"], cs.DIA["hidden"], cs.DIA["kv_heads"]
    d, ctx, dev = H // cs.DIA["heads"], cs.DIA_CTX, cs.DEV
    for b in (1, 4, 8):
        slots = (1000,) if b == 1 else cs.DIA_SLOTS[b]
        pos = torch.tensor(slots, dtype=torch.int32, device=dev)
        kc, vc = ((torch.randn((L, b, 2, nkv, ctx, d), generator=gen,
                               device=dev) * 0.5).to(torch.bfloat16)
                  for _ in range(2))
        ck, cv, vt = cs.dia_cross(gen, (b, 2), 256)
        x = torch.randn((2 * b, H), generator=gen, device=dev)
        if b == 1:
            args = (kc[:, 0], vc[:, 0], pos,
                    *(t[:, 0].flatten(1, 2).contiguous() for t in (ck, cv, vt)))
            compare("K10 one pair, pos 1000, Sb 256", lambda: dm.dia_megastep_cuda(
                mega, x, *args, 768, **kw), ours, others, paths)
        else:
            sc = dm.step_scratch(mega, 2 * b, cs.DIA["heads"], ctx, 256, dev)
            compare(f"K11 {b} pairs at {list(slots)}, Sb 256",
                    lambda: dm.dia_megastep_batched_cuda(
                        mega, x, kc, vc, pos, ck, cv, vt, 768, scratch=sc, **kw),
                    ours, others, paths)
        del kc, vc, ck, cv, vt
        torch.cuda.empty_cache()


def parler_steps(ours, others, paths, gen) -> None:
    mega, qtype = cs.mini_mega(gen)
    L, heads, ctx = cs.MINI["n_layers"], cs.MINI["heads"], cs.MINI["ctx"]
    d, dev = cs.MINI["hidden"] // heads, cs.DEV
    kw = dict(qtype=qtype, use_cross=True, n_heads=heads)
    b = len(cs.MIXED_POS)
    kc, vc = ((torch.randn((L, b, heads, ctx, d), generator=gen, device=dev)
               * 0.5).to(torch.bfloat16) for _ in range(2))
    x = torch.randn((b, cs.MINI["hidden"]), generator=gen, device=dev)
    pos = torch.tensor([1000], dtype=torch.int32, device=dev)
    compare("K2 pos 1000", lambda: pm.parler_megastep_cuda(
        mega, x[:1], kc[:, 0], vc[:, 0], pos, **kw), ours, others, paths)
    pos = torch.tensor(cs.MIXED_POS, dtype=torch.int32, device=dev)
    sc = pm.step_scratch(mega, b, heads, ctx, dev)
    compare(f"K5 {b} slots at {list(cs.MIXED_POS)}",
            lambda: pm.parler_megastep_batched_cuda(
                mega, x, kc, vc, pos, scratch=sc, **kw), ours, others, paths)
    del kc, vc, mega
    torch.cuda.empty_cache()


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("attention", "steps"))
    ap.add_argument("paths", nargs="*", metavar="OTHER")
    args = ap.parse_args(argv)
    paths = args.paths
    if not torch.cuda.is_available():
        print("gemv_ab: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    sources = ["decode_attention"] if args.only == "attention" else SOURCES
    _build.build(sources)
    ours = committed(sources)
    with tempfile.TemporaryDirectory() as tmp:
        others = build_others(paths, tmp, sources)
        gen = torch.Generator(device=cs.DEV)
        gen.manual_seed(cs.SEED)
        if args.only != "steps":
            attention(ours, others, paths, gen)
        if args.only != "attention":
            llama_steps(ours, others, paths, gen)
            dia_steps(ours, others, paths, gen)
            parler_steps(ours, others, paths, gen)
        use(ours)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
