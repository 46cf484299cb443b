#!/usr/bin/env python3
"""Compare the port's decode-step kernels with other versions of the port on
one card, in turns, by device time.

    python3 gemv_ab.py [--only attention|steps|dia] [OTHER ...]

OTHER is another version of the `tts_tpu_torch` package: its directory, or a
directory that holds it (for example a parent commit's, unpacked with `git
archive` into an ignored directory such as `chip_archive/`, or an edited
copy of the package there that holds a variant of a kernel). Each
version runs through its own Python wrappers, its own weight prep (so two
versions may lay their weights out differently) and its own kernels, built
with its own build script, all sources at once, before the timing starts.

With random weights from a seed, at Parler-Mini, Orpheus-3B and Dia-1.6B
widths, it measures in turns (OTHER, committed, committed, OTHER):
- attention: K3 at Parler's 16 heads of 64, Orpheus's 24 q / 8 kv heads of
  128 and Dia's 16 / 4 heads of 128 at pos 1000 (bf16 caches, 8 layers
  taken in turn so that the K/V rows come from device memory), and K4 at 8
  slots at mixed positions at the same shapes; PyTorch's
  scaled_dot_product_attention on the same inputs is timed beside them;
- the steps: K8 / K6 at one slot (pos 1000 and 3583, the cache's last
  row; one launch of csrc/llama_flat.cu, an older version's may be the
  launch sequence), K9 / K7 at 8 and 16 slots
  and K11 at 4 and 8 pairs at chip_smoke's mixed positions, K10 (one
  launch of csrc/dia_flat.cu; an older version's may be the launch
  sequence) at one pair (pos 1000), K2 and K12 at pos 1000 and K5 at 8 and 16 slots, with
  the GEMV's and the attention's device time; K9 at 16 slots against its
  plain version at every depth, beside the other-order yardstick
  (k9_by_depth); and K5 against its plain version per slot and layer,
  beside the plain version on the CPU (parler_by_slot);
- one row: each of K6's GEMV launches alone at Orpheus-3B width (qkv, o,
  gate / up, down, each layer in turn so that the weights come from device
  memory, and the head), its time per launch beside its weight bytes and
  the rate they stream at.
Times are device time per call or step from torch.profiler (the time the
device was busy with the kernels a call ran, over 20 calls, spans that
overlap counted once: programmatic dependent launch starts a GEMV while
the kernel before it runs; chip_smoke.device_ms). Each line says
whether the two versions' outputs are bit-equal, and where they are not,
the largest relative error between them (|a - b| over max |b|, for each
output, the largest). With no OTHER it measures the committed package
alone; `--only` keeps one of the two parts, or (dia) the Dia steps
alone. Needs a card and nvcc.
"""
from __future__ import annotations

import ctypes
import importlib
import importlib.util
import inspect
import os
import sys
from types import SimpleNamespace

import torch

import chip_smoke as cs
import tts_tpu_torch

ATTN_LAYERS = 8
ATTN_SHAPES = (("parler", 16, 16, 64), ("orpheus", 24, 8, 128),
               ("dia", 16, 4, 128))   # name, q heads, kv heads, head size
MODULES = dict(build="ops._build", da="ops.decode_attention",
               dm="ops.dia_megastep", lf="ops.llama_flat",
               lm="ops.llama_megastep", pm="ops.parler_megastep",
               pf="ops.parler_flat", qm="ops.quant_matmul",
               orpheus="models.orpheus.model", dia="models.dia.model",
               parler="models.parler.model")


def version(spec: str, index: int):
    """A version of the package as a namespace of its modules: the committed
    one for spec "", else the package at spec's path (or in it), loaded
    under a name of its own."""
    if not spec:
        name, label = "tts_tpu_torch", "committed"
    else:
        pkg = spec if os.path.exists(os.path.join(spec, "__init__.py")) else \
            os.path.join(spec, "tts_tpu_torch")
        name, label = f"gemv_ab_other{index}", os.path.basename(
            os.path.normpath(spec))
        loc = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(loc)
        sys.modules[name] = mod
        loc.loader.exec_module(mod)
    return SimpleNamespace(label=label, **{
        k: importlib.import_module(f"{name}.{m}") for k, m in MODULES.items()})


def rel_err(a, b) -> float:
    """|a - b| over max |b|, largest element."""
    return float((a.float() - b.float()).abs().max()) / \
        max(float(b.float().abs().max()), 1e-30)


def outputs(res):
    return [t.clone() for t in (res if isinstance(res, (tuple, list)) else (res,))]


def compare(label, fns, extra="", nbytes=None, rewind=None) -> None:
    """Time fns[i]() (version i's call; 0 is the committed version) against
    the committed one in turns (OTHER, committed, committed, OTHER) and
    print the device times, the GEMV's and the attention's part, whether
    the outputs are bit-equal and, where they are not, the largest
    relative error between them; with `nbytes`, the rate those bytes move
    at in each time. `rewind()`, where given, is called before the call
    whose outputs are kept (fns taking turns over weights), so that both
    versions' outputs come from the same turn."""
    def run(fn):
        dt = cs.device_ms(fn)
        gemv = sum(t for k, t in dt.by_name.items() if "gemv" in k)
        attn = sum(t for k, t in dt.by_name.items() if "attn" in k)
        if rewind is not None:
            rewind()
        return (dt.ms, gemv, attn), outputs(fn())

    def fmt(t):
        rate = "" if nbytes is None else f", {nbytes / t[0] / 1e9:.3f} TB/s"
        return f"{t[0]:.4f} (gemv {t[1]:.4f}, attention {t[2]:.4f}{rate})"

    (ver0, ours), others = fns[0], fns[1:]
    if not others:
        t, _ = run(ours)
        print(f"{label}: {fmt(t)} ms{extra}", flush=True)
        return
    for ver, other in others:
        times, outs = {"other": [], "ours": []}, {}
        for tag, fn in (("other", other), ("ours", ours), ("ours", ours),
                        ("other", other)):
            t, outs[tag] = run(fn)
            times[tag].append(t)
        same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["ours"]))
        diff = "" if same else ", largest relative error " + \
            f"{max(rel_err(a, b) for a, b in zip(outs['ours'], outs['other'])):.3e}"
        print(f"{label}: {ver.label} "
              f"{' / '.join(fmt(t) for t in times['other'])} ms; committed "
              f"{' / '.join(fmt(t) for t in times['ours'])} ms; outputs "
              f"bit-equal {same}{diff}{extra}", flush=True)


def attention(versions, gen) -> None:
    dev, ctx, p = cs.DEV, 4096, 1000
    for name, hq, hkv, d in ATTN_SHAPES:
        kc, vc = ((torch.randn((ATTN_LAYERS, hkv, ctx, d), generator=gen,
                               device=dev) * 0.5).to(torch.bfloat16)
                  for _ in range(2))
        q = torch.randn((hq, d), generator=gen, device=dev)
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        turn = iter(range(1 << 30))

        def k3(v):
            def fn():
                l = next(turn) % ATTN_LAYERS
                return v.da.decode_attention_cuda(q, kc[l], vc[l], pos)
            return fn

        qb = q.to(torch.bfloat16)[None, :, None, :]

        def lib():
            l = next(turn) % ATTN_LAYERS
            return cs.sdpa(qb, kc[l, None, :, :p + 1], vc[l, None, :, :p + 1])

        lib_ms = cs.device_ms(lib).ms
        compare(f"K3 {name} {hq}/{hkv} heads of {d}, pos {p}",
                [(v, k3(v)) for v in versions], f"; sdpa {lib_ms:.4f} ms")
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
                f"{list(cs.MIXED_POS)}",
                [(v, lambda v=v: v.da.decode_attention_batched_cuda(q, kc, vc, pos))
                 for v in versions], f"; masked sdpa {lib_ms:.4f} ms")
        del kc, vc
        torch.cuda.empty_cache()


def as_version(v, m):
    """m (a QuantTensor of the committed package) as version v's."""
    return v.qm.QuantTensor(m.codes, m.scales, m.qtype) \
        if isinstance(m, tts_tpu_torch.ops.quant_matmul.QuantTensor) else m


def prep(fn, layers, head_dim):
    """A version's megastep prep: the committed one takes the head size
    (it tiles RoPE's pairs), an older one may not."""
    if len(inspect.signature(fn).parameters) > 1:
        return fn(layers, head_dim)
    return fn(layers)


def llama_steps(versions, gen) -> None:
    lw, head, out_norm, d, skw = cs.orpheus_source_weights(gen)
    weights = {}
    for v in versions:
        layers = v.orpheus.OrpheusLayer(*(as_version(v, m) for m in lw))
        mega, qtype = prep(v.lm.prep_llama_mega, layers, d)
        flat = v.lf.prep_llama_flat(mega, as_version(v, head), out_norm, qtype,
                                    skw["n_heads"], skw["n_kv"])
        weights[v.label] = mega, flat
    del lw, head
    torch.cuda.empty_cache()
    kw = dict(qtype=qtype, **skw)
    L, H, ctx = cs.ORPHEUS["n_layers"], cs.ORPHEUS["hidden"], cs.ORPHEUS["ctx"]
    nkv = cs.ORPHEUS["kv_heads"]
    dev = cs.DEV
    for b, p1 in ((1, 1000), (1, ctx - 1), (8, None), (16, None)):
        slots = cs.LLAMA_SLOTS_16 if b == 16 else cs.LLAMA_SLOTS
        pos = torch.tensor(slots[:b] if b > 1 else [p1], dtype=torch.int32,
                           device=dev)
        kc, vc = ((torch.randn((L, b, nkv, ctx, d), generator=gen, device=dev)
                   * 0.5).to(torch.bfloat16) for _ in range(2))
        x = torch.randn((b, H), generator=gen, device=dev)

        def steps(v):
            mega, flat = weights[v.label]
            if b == 1:
                return {"K8": lambda: v.lm.llama_megastep_cuda(
                            mega, x, kc[:, 0], vc[:, 0], pos, **kw),
                        "K6": lambda: v.lf.llama_flat_megastep_cuda(
                            flat, x, kc[:, 0], vc[:, 0], pos, **kw)}
            sc = v.lm.step_scratch(mega, b, cs.ORPHEUS["heads"], ctx, dev)
            return {"K9": lambda: v.lm.llama_megastep_batched_cuda(
                        mega, x, kc, vc, pos, scratch=sc, **kw),
                    "K7": lambda: v.lf.llama_flat_megastep_batched_cuda(
                        flat, x, kc, vc, pos, scratch=sc, **kw)}

        where = f"pos {p1}" if b == 1 else f"{b} slots at {list(slots[:b])}"
        fns = {v.label: steps(v) for v in versions}
        for name in fns[versions[0].label]:
            compare(f"{name} {where}", [(v, fns[v.label][name]) for v in versions])
        if b == 16:
            k9_by_depth(versions, {k: w[0] for k, w in weights.items()}, x,
                        kc, vc, pos, kw)
        del kc, vc
        torch.cuda.empty_cache()
    one_row(versions, gen, {k: w[1] for k, w in weights.items()}, kw)
    del weights
    torch.cuda.empty_cache()


def k9_by_depth(versions, megas, x, kc, vc, pos, kw) -> None:
    """K9 at 16 slots against its plain version on the first l layers, for
    l = 1 .. L: each version's relative error per slot (|kernel - plain|
    over max |plain| of the slot's x_out, k_new and v_new, the largest of
    the three), beside the plain version summed in another order
    (chip_smoke.other_order, the yardstick of chip_smoke's layer checks).
    Printed for each version's worst slot and for the slot where the
    versions differ most at full depth: a fault shows from the layer it
    enters, a rounding that flipped grows from f32 noise as the
    yardstick's own difference does."""
    ours = megas[versions[0].label]
    L, b = ours.norms.shape[0], x.shape[0]

    def per_slot(a, r):
        return [max(rel_err(a[0][s], r[0][s]), rel_err(a[1][:, s], r[1][:, s]),
                    rel_err(a[2][:, s], r[2][:, s])) for s in range(b)]

    def cut(v, l):
        mega = megas[v.label]
        return type(mega)(*(t[:l] for t in mega))

    rows = []
    with cs.dequant_once():
        for l in range(1, L + 1):
            args = (x, kc[:l], vc[:l], pos)
            ref = outputs(cs.lm.llama_megastep_batched_plain(
                cut(versions[0], l), *args, **kw))
            got = {v.label: outputs(v.lm.llama_megastep_batched_cuda(
                cut(v, l), *args, **kw)) for v in versions}
            rows.append({k: per_slot(o, ref) for k, o in got.items()} | {
                "other order": per_slot(outputs(cs.other_order_batched_plain(
                    cut(versions[0], l), *args, **kw)), ref)} | {
                f"vs {v.label}": per_slot(got[versions[0].label], got[v.label])
                for v in versions[1:]})
    worst = max(range(b), key=lambda s: max(
        (rows[-1][f"vs {v.label}"][s] for v in versions[1:]), default=0.0))
    print(f"K9 16 slots against its plain version by depth (relative error "
          f"per slot; the slot where the versions differ most at depth {L}: "
          f"{worst}, pos {int(pos[worst])}):", flush=True)
    for l, row in enumerate(rows, 1):
        print(f"  depth {l}: " + "; ".join(
            f"{k} worst {max(e):.3e} (slot {e.index(max(e))}), slot {worst} "
            f"{e[worst]:.3e}" for k, e in row.items()), flush=True)


def one_row(versions, gen, flats, kw) -> None:
    """K6's GEMV launches one at a time at one row (pos 1000), through the
    GEMV's entry on K7's counter: each projection of layer l = 0, 1, ... in turn (the 28 layers'
    weights are far more than the 50 MB L2 holds), then the head; the
    time per launch beside the projection's weight bytes. Each version
    launches its own layout: tiles (one tensor for gate and up) or rows."""
    w0 = flats[versions[0].label].layers
    L, H = w0.norms.shape[0], w0.norms.shape[2]
    F = cs.ORPHEUS["ffn"]
    nkv, d = kw["n_kv"], H // kw["n_heads"]
    kvn, ctx, dev = H + 2 * nkv * d, cs.ORPHEUS["ctx"], cs.DEV
    kc, vc = ((torch.randn((nkv, ctx, d), generator=gen, device=dev) * 0.5)
              .to(torch.bfloat16) for _ in range(2))
    x = torch.randn((1, F), generator=gen, device=dev)
    res = torch.randn((1, H), generator=gen, device=dev)
    vocab = flats[versions[0].label].head.shape[0]
    out = torch.empty((1, max(vocab, 2 * F)), device=dev)
    pos = torch.tensor([1000], dtype=torch.int32, device=dev)
    vp, null = ctypes.c_void_p, ctypes.c_void_p(0)
    turn = [0]

    def rewind():
        turn[0] = 0
        out.zero_()

    def launcher(v):
        flat = flats[v.label]
        w, addr = flat.layers, v.build.addr
        tiled = hasattr(w, "gate_up_codes")
        packed = 1

        def ptrs(name, l):
            return (vp(addr(getattr(w, f"{name}_codes"), l)),
                    vp(addr(getattr(w, f"{name}_scales"), l)))

        def launch(a, bp, n, k, rms, epi, norm=null, kvh=0, resid=null,
                   cache=(null, null)):
            v.lf.KERNEL_BATCHED(vp(x.data_ptr()), norm, rms, *a, *bp, kw["qtype"],
                        packed, 1, 1, n, k, resid, vp(out.data_ptr()), epi,
                        vp(kw["inv_freq"].data_ptr()), vp(pos.data_ptr()), 1,
                        *cache, H, kvh, d, ctx, 1, 0, v.build.stream_ptr(dev))

        def proj(name):
            def fn():
                l = turn[0] % L
                turn[0] += 1
                if name == "qkv":
                    a = ptrs("qkv", l)
                    launch(a, a, kvn, H, 1, v.lm.EPI_ROPE_QKV, kvh=nkv * d,
                           norm=vp(addr(w.norms, l, 0)),
                           cache=(vp(kc.data_ptr()), vp(vc.data_ptr())))
                elif name == "gate":
                    a = ptrs("gate_up", l) if tiled else ptrs("gate", l)
                    bp = a if tiled else ptrs("up", l)
                    launch(a, bp, F, H, 1, v.lm.EPI_SILU_MUL,
                           norm=vp(addr(w.norms, l, 1)))
                else:
                    a = ptrs(name, l)
                    launch(a, a, H, F if name == "down" else H, 0,
                           v.lm.EPI_RESIDUAL, resid=vp(res.data_ptr()))
                return out
            return fn

        def head_fn():
            a = (vp(flat.head.codes.data_ptr()), vp(flat.head.scales.data_ptr()))
            launch(a, a, vocab, H, 1, v.lm.EPI_STORE,
                   norm=vp(flat.out_norm.data_ptr()))
            return out

        return {n: proj(n) for n in ("qkv", "o", "gate", "down")} | {"head": head_fn}

    fns = {v.label: launcher(v) for v in versions}

    def nbytes(names):
        return sum(cs.tensor_bytes([getattr(w0, f"{n}_{t}")[0]
                                    for t in ("codes", "scales")]) for n in names)

    for key, label, names in (("qkv", "qkv", ["qkv"]), ("o", "o", ["o"]),
                              ("gate", "gate / up", ["gate_up"]),
                              ("down", "down", ["down"])):
        b = nbytes(names)
        compare(f"one row, {label} ({b / 1e6:.2f} MB a launch, bound "
                f"{b / cs.HBM_BYTES_PER_S * 1e6:.2f} us)",
                [(v, fns[v.label][key]) for v in versions], nbytes=b,
                rewind=rewind)
    head = flats[versions[0].label].head
    b = cs.tensor_bytes([head.codes, head.scales])
    compare(f"one row, head ({b / 1e6:.2f} MB, bound "
            f"{b / cs.HBM_BYTES_PER_S * 1e6:.2f} us)",
            [(v, fns[v.label]["head"]) for v in versions], nbytes=b,
            rewind=rewind)


def dia_steps(versions, gen) -> None:
    lw, d = cs.dia_source_weights(gen)
    weights = {}
    for v in versions:
        layers = v.dia.DiaDecoderLayer(*(as_version(v, m) for m in lw))
        weights[v.label], qtype = prep(v.dm.prep_dia_mega, layers, d)
    del lw
    torch.cuda.empty_cache()
    kw = dict(qtype=qtype, n_heads=cs.DIA["heads"], n_kv=cs.DIA["kv_heads"])
    L, H, nkv = cs.DIA["n_layers"], cs.DIA["hidden"], cs.DIA["kv_heads"]
    ctx, dev = cs.DIA_CTX, cs.DEV
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
            compare("K10 one pair, pos 1000, Sb 256", [
                (v, lambda v=v: v.dm.dia_megastep_cuda(
                    weights[v.label], x, *args, 768, **kw)) for v in versions])
        else:
            def k11(v):
                sc = v.dm.step_scratch(weights[v.label], 2 * b, cs.DIA["heads"],
                                       ctx, 256, dev)
                return lambda: v.dm.dia_megastep_batched_cuda(
                    weights[v.label], x, kc, vc, pos, ck, cv, vt, 768,
                    scratch=sc, **kw)
            compare(f"K11 {b} pairs at {list(slots)}, Sb 256",
                    [(v, k11(v)) for v in versions])
        del kc, vc, ck, cv, vt
        torch.cuda.empty_cache()
    del weights
    torch.cuda.empty_cache()


def parler_steps(versions, gen) -> None:
    """K2 and K12 at pos 1000, K5 at 8 and 16 slots at chip_smoke's mixed
    positions, at Parler-Mini width: each version preps its own MegaLayers
    (and K12's) from the same source weights, so the layouts may differ."""
    lw = cs.mini_layers(gen)
    megas = {}
    for v in versions:
        layers = v.parler.ParlerLayerWeights(*(as_version(v, m) for m in lw))
        megas[v.label], qtype = v.pm.prep_mega_layers(layers)
    del lw
    torch.cuda.empty_cache()
    L, heads, ctx = cs.MINI["n_layers"], cs.MINI["heads"], cs.MINI["ctx"]
    d, dev = cs.MINI["hidden"] // heads, cs.DEV
    kw = dict(qtype=qtype, use_cross=True, n_heads=heads)
    slots = cs.MIXED_POS * 2
    kc, vc = ((torch.randn((L, len(slots), heads, ctx, d), generator=gen,
                           device=dev) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    x = torch.randn((len(slots), cs.MINI["hidden"]), generator=gen, device=dev)
    pos = torch.tensor([1000], dtype=torch.int32, device=dev)
    compare("K2 pos 1000", [(v, lambda v=v: v.pm.parler_megastep_cuda(
        megas[v.label], x[:1], kc[:, 0], vc[:, 0], pos, **kw)) for v in versions])

    k1, v1 = kc[:, 0].contiguous(), vc[:, 0].contiguous()   # K12's dense caches

    def k12(v):
        flat = v.pf.prep_parler_flat(megas[v.label], qtype, ctx)
        return lambda: v.pf.parler_flat_megastep_cuda(
            flat, x[:1], k1, v1, pos, qtype=qtype, n_heads=heads)
    compare("K12 pos 1000", [(v, k12(v)) for v in versions])
    for b in (8, 16):
        pos = torch.tensor(slots[:b], dtype=torch.int32, device=dev)

        def k5(v):
            sc = v.pm.step_scratch(megas[v.label], b, heads, ctx, dev)
            return lambda: v.pm.parler_megastep_batched_cuda(
                megas[v.label], x[:b], kc[:, :b], vc[:, :b], pos, scratch=sc,
                **kw)
        compare(f"K5 {b} slots at {list(slots[:b])}",
                [(v, k5(v)) for v in versions])
    parler_by_slot(versions, megas, x[:8], kc[:, :8], vc[:, :8], kw)
    del kc, vc, k1, v1, megas
    torch.cuda.empty_cache()


def parler_by_slot(versions, megas, x, kc, vc, kw) -> None:
    """K5 in chip_smoke's layer-check setting (8 slots at MIXED_POS, the
    24 layers run one at a time on the committed version's x chain): each
    version's x_out - x_in per (slot, layer) against the plain version on
    the card (|a - b| over the batch's max |b|), beside the plain version
    on the CPU (the check's yardstick). Prints, for each, how many of the
    192 slot-layers differ by more than 1e-5 and 1e-4 (a bf16 rounding
    that flipped) and the mean, and the check's statistic: the mean and
    largest of its 6 compared layers' largest slot error."""
    import numpy as np
    ours = versions[0]
    L = megas[ours.label].norms.shape[0]
    pos = torch.tensor(cs.MIXED_POS, dtype=torch.int32, device=cs.DEV)

    def layer(v, l):
        m = megas[v.label]
        return type(m)(*(t[l:l + 1] for t in m[:-1]), m.cross_pos)

    errs = {k: [] for k in [v.label for v in versions] + ["CPU plain"]}
    xin = x
    with cs.dequant_once():
        for l in range(L):
            caches = (kc[l:l + 1], vc[l:l + 1])
            outs = {v.label: v.pm.parler_megastep_batched_cuda(
                layer(v, l), xin, *(c.clone() for c in caches), pos, **kw)[0] - xin
                for v in versions}
            m = layer(ours, l)
            ref = ours.pm.parler_megastep_batched_plain(
                m, xin, *(c.clone() for c in caches), pos, **kw)[0] - xin
            outs["CPU plain"] = (ours.pm.parler_megastep_batched_plain(
                type(m)(*(t.cpu() for t in m)), xin.cpu(),
                *(c.cpu() for c in caches), pos.cpu(), **kw)[0] - xin.cpu()).to(cs.DEV)
            scale = float(ref.abs().max())
            for k, o in outs.items():
                errs[k].append([float((o[s] - ref[s]).abs().max()) / scale
                                for s in range(x.shape[0])])
            xin = xin + outs[ours.label]
    print(f"K5 by slot and layer against the plain version on the card "
          f"({L} layers x {x.shape[0]} slots at {list(cs.MIXED_POS)}):", flush=True)
    for k, e in errs.items():
        e = np.asarray(e)
        case = e.max(axis=1)[list(cs.K5_LAYERS)]
        print(f"  {k}: > 1e-5 in {int((e > 1e-5).sum())}, > 1e-4 in "
              f"{int((e > 1e-4).sum())} of {e.size}, mean {e.mean():.3e}; "
              f"layer-check cases (layers {list(cs.K5_LAYERS)}) mean "
              f"{case.mean():.3e}, max {case.max():.3e}", flush=True)


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("attention", "steps", "dia"))
    ap.add_argument("paths", nargs="*", metavar="OTHER")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemv_ab: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    versions = [version(spec, i) for i, spec in enumerate(["", *args.paths])]
    sources = {"attention": ["decode_attention"],
               "dia": ["decode_attention", "dia_megastep", "dia_flat"]}.get(args.only)
    for v in versions:   # each build starts its sources' nvcc runs together
        v.build.build([n for n in sources or v.build.SOURCES
                       if n in v.build.SOURCES])
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    if args.only in (None, "attention"):
        attention(versions, gen)
    if args.only in (None, "steps"):
        llama_steps(versions, gen)
    if args.only in (None, "steps", "dia"):
        dia_steps(versions, gen)
    if args.only in (None, "steps"):
        parler_steps(versions, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
