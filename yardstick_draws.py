#!/usr/bin/env python3
"""How often chip_smoke's K8 / K6 layer checks fail a correct kernel, by
yardstick, over several draws of their inputs, on one GPU.

    python3 yardstick_draws.py [--draws 6]

Builds the llama kernels, makes chip_smoke's Orpheus-3B weights (seed
chip_smoke.SEED), then for each draw (the cache and x of check_llama, drawn
from a generator seeded with the draw's number) runs K8 and K6 layer by
layer at chip_smoke.LLAMA_LAYER_POS and judges the same errors
(chip_smoke.judge_layers: 4x the yardstick's largest and mean difference,
or 1e-5) under three yardsticks:

- one pair: plain on the CPU vs plain on the card, at LLAMA_LAYERS;
- two pairs: the larger of that and plain summed in another order
  (chip_smoke.other_order), at LLAMA_LAYERS;
- three pairs, every layer (chip_smoke's): the largest of plain summed in
  another order, plain in the kernels' RMS order (chip_smoke.kernel_order)
  and, at LLAMA_LAYERS, plain on the CPU; every layer a case.

Prints each judge's lines and, last, the failures by yardstick and kernel.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict

import torch

import chip_smoke as cs

JUDGES = ("one pair", "two pairs", "three pairs, every layer")


def errors(kernel, w, x, kc, vc, pos, kw) -> dict:
    """Each layer's relative errors against plain on the card, for the
    kernel and for each other correct version: {version: [per layer
    [x_out - x_in, k_new, v_new]]} (None for the CPU away from
    LLAMA_LAYERS)."""
    versions = {"kernel": kernel, "other": cs.other_order_plain,
                "kernel order": cs.kernel_order_plain}
    out = defaultdict(list)
    xin = x
    for l in range(cs.ORPHEUS["n_layers"]):
        one = cs.lm.LlamaMegaLayers(*(t[l:l + 1] for t in w))

        def run(fn, dev):
            xl = xin.to(dev)
            kwd = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()}
            xo, k, v = fn(type(one)(*(t.to(dev) for t in one)), xl,
                          kc[l:l + 1].to(dev, copy=True),
                          vc[l:l + 1].to(dev, copy=True), pos.to(dev), **kwd)
            return [t.to(cs.DEV) for t in (xo - xl, k, v)]

        ref = run(cs.lm.llama_megastep_plain, cs.DEV)
        got = {name: run(fn, cs.DEV) for name, fn in versions.items()}
        if l in cs.LLAMA_LAYERS:
            with cs.dequant_once():
                got["cpu"] = run(cs.lm.llama_megastep_plain, torch.device("cpu"))
        for name in ("kernel", "other", "kernel order", "cpu"):
            out[name].append(None if name not in got else [
                cs.max_err(a, b) / float(b.abs().max()) for a, b in zip(got[name], ref)])
        xin = xin + got["kernel"][0]
    return out


def judged(cases) -> dict:
    """{judge: (err, base)} over the per-layer errors of every position."""
    names = ("x_out - x_in", "k_new", "v_new")
    res = {j: (defaultdict(list), defaultdict(list)) for j in JUDGES}
    for e in cases:
        for l, kern in enumerate(e["kernel"]):
            cpu = e["cpu"][l]
            pairs = {"one pair": [cpu] if cpu else [],
                     "two pairs": [cpu, e["other"][l]] if cpu else [],
                     "three pairs, every layer":
                         [e["other"][l], e["kernel order"][l]] + ([cpu] if cpu else [])}
            for j, ps in pairs.items():
                if not ps:
                    continue
                for i, nm in enumerate(names):
                    res[j][0][nm].append(kern[i])
                    res[j][1][nm].append(max(p[i] for p in ps))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("yardstick_draws: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    cs._build.build(["llama_flat", "llama_megastep", "decode_attention",
                     "quant_matmul"])
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    mega, flat, kw = cs.orpheus_kernel_weights(gen)
    o = cs.ORPHEUS
    H, nkv, d = o["hidden"], o["kv_heads"], o["hidden"] // o["heads"]
    fails = defaultdict(int)
    for draw in range(args.draws):
        t0 = time.perf_counter()
        gen.manual_seed(draw)
        shape = (o["n_layers"], nkv, o["ctx"], d)
        kc = (torch.randn(shape, generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
        vc = (torch.randn(shape, generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
        x = torch.randn((1, H), generator=gen, device=cs.DEV)
        for label, w, kernel in (("K8", mega, cs.lm.llama_megastep_cuda),
                                 ("K6", flat.layers, cs.k6_layers)):
            cases = [errors(kernel, w, x, kc, vc, torch.tensor(
                [p], dtype=torch.int32, device=cs.DEV), kw)
                for p in cs.LLAMA_LAYER_POS]
            for j, (err, base) in judged(cases).items():
                try:
                    cs.judge_layers(err, base, label, f"draw {draw} {label}, {j}")
                except AssertionError:
                    fails[(j, label)] += 1
        del kc, vc
        print(f"draw {draw}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"failures over {args.draws} draws: "
          + "; ".join(f"{j}: K8 {fails[(j, 'K8')]}, K6 {fails[(j, 'K6')]}"
                      for j in JUDGES), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
