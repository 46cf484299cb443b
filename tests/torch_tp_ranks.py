"""Rank programs for the port's parallelism tests (tests/test_torch_port_
tp*.py, test_torch_port_parallel.py), run on spawned CPU ranks over gloo by
`tts_tpu_torch.parallel.spawn.run_ranks`. Torch only: each reads its inputs
from `<dir>/in.pt`, which the test wrote, and writes what it found to
`<dir>/out<rank>.pt` for the test to compare."""
import os

import torch
import torch.distributed as dist

from tts_tpu_torch.parallel.mesh import make_mesh


def _io(d):
    return torch.load(os.path.join(d, "in.pt"), weights_only=False)


def _save(d, out):
    torch.save(out, os.path.join(d, f"out{dist.get_rank()}.pt"))


def _gather_cat(t, group, dim):
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _tp_meshes():
    """(tp, mesh) for tp 2 (a 2 x 2 mesh: both dp rows run it) and 4."""
    return [(tp, make_mesh(tp=tp, dp=4 // tp)) for tp in (2, 4)]


def parler_tp(d):
    """megastep_tp at tp 2 and 4 at one position, then 4 steps at tp 4
    with this rank's cache rows written after each."""
    from tts_tpu_torch.parallel.sharding import shard_parler_kv
    from tts_tpu_torch.parallel.tp_megastep import (megastep_tp,
                                                    prep_tp_layers,
                                                    shard_tp_layers)
    a = _io(d)
    out = {}
    for tp, mesh in _tp_meshes():
        g, i = mesh.get_group("tp"), mesh.get_local_rank("tp")
        sh = shard_tp_layers(prep_tp_layers(a["layers"], tp)[0], i, tp)
        kk, vv = shard_parler_kv(a["kv_k"], a["kv_v"], mesh)
        xo, kn, vn = megastep_tp(sh, a["x"], kk, vv, a["pos"], group=g,
                                 use_cross=True, n_heads=a["n_heads"])
        out[tp] = (xo, _gather_cat(kn, g, 1), _gather_cat(vn, g, 1))
        if tp == 4:
            xs = []
            x = a["x"]
            L, nh_l = kk.shape[0], kk.shape[1]
            for s in range(4):
                p = a["pos0"] + s
                x, kn, vn = megastep_tp(sh, x, kk, vv, p, group=g,
                                        use_cross=True, n_heads=a["n_heads"])
                kk[:, :, p] = kn.reshape(L, nh_l, -1)
                vv[:, :, p] = vn.reshape(L, nh_l, -1)
                xs.append(x)
            out["steps"] = torch.cat(xs)
    _save(d, out)


def parler_gather(d):
    """megastep_weight_gather at tp 4 from this rank's quarter of the tiled
    weights; the whole cache on every rank, written in place."""
    from tts_tpu_torch.parallel.tp_megastep import (megastep_weight_gather,
                                                    shard_mega_gather)
    a = _io(d)
    shards = shard_mega_gather(a["mega"], dist.get_rank(), 4)
    kk, vv = a["kv_k"].clone(), a["kv_v"].clone()
    xo, kn, vn = megastep_weight_gather(
        shards, a["x"], kk, vv, a["pos"], qtype=a["qtype"], use_cross=True,
        n_heads=a["n_heads"])
    nbytes = sum(getattr(shards, f).numel() * getattr(shards, f).element_size()
                 for f in ("qkv_codes", "occ_codes", "fc1_codes", "fc2_codes"))
    _save(d, dict(x=xo, k=kn, v=vn, kv_k=kk, kv_v=vv, code_bytes=nbytes))


def llama_tp(d):
    """llama_megastep_tp at tp 2 and 4 (and tp 1 on every rank alone)."""
    from tts_tpu_torch.parallel.llama_tp import (llama_megastep_tp,
                                                 prep_llama_tp, shard_llama_tp)
    from tts_tpu_torch.parallel.sharding import split_axis
    a = _io(d)
    kw = dict(n_heads=a["n_heads"], n_kv=a["n_kv"])
    out = {}
    for pos in (a["pos"], 0):
        for tp, mesh in _tp_meshes():
            g, i = mesh.get_group("tp"), mesh.get_local_rank("tp")
            tpl, _ = prep_llama_tp(a["layers"], tp, head_d=a["d"], **kw)
            kk, vv = (split_axis(c, 1, i, tp) for c in (a["kv_k"], a["kv_v"]))
            xo, kn, vn = llama_megastep_tp(shard_llama_tp(tpl, i, tp), a["x"],
                                           kk, vv, pos, a["inv"], group=g, **kw)
            out[pos, tp] = (xo, _gather_cat(kn, g, 1), _gather_cat(vn, g, 1))
    _save(d, out)


def dia_tp(d):
    """dia_megastep_tp at tp 2 and 4."""
    from tts_tpu_torch.parallel.dia_tp import (dia_megastep_tp, prep_dia_tp,
                                               shard_dia_cross, shard_dia_tp)
    from tts_tpu_torch.parallel.sharding import split_axis
    a = _io(d)
    kw = dict(n_heads=a["n_heads"], n_kv=a["n_kv"])
    out = {}
    for tp, mesh in _tp_meshes():
        g, i = mesh.get_group("tp"), mesh.get_local_rank("tp")
        tpl, _ = prep_dia_tp(a["layers"], tp, head_d=a["d"], **kw)
        kk, vv = (split_axis(c, 2, i, tp) for c in (a["kv_k"], a["kv_v"]))
        ck, cv, vt = shard_dia_cross(a["ck"], a["cv"], a["vtail"], i, tp)
        xo, kn, vn = dia_megastep_tp(shard_dia_tp(tpl, i, tp), a["x"], kk, vv,
                                     a["pos"], ck, cv, vt, a["n_tail"],
                                     group=g, **kw)
        out[tp] = (xo, _gather_cat(kn, g, 2), _gather_cat(vn, g, 2))
    _save(d, out)


def dac_sp(d):
    """sharded_dac_decode over sp 2 (a 2 x 2 mesh's tp axis) and sp 4; and
    over sp 4 with the runner's bf16 convolution weights
    (TTS_TPU_DAC_DTYPE=bfloat16's `bf16_conv_weights`)."""
    from torch.distributed.device_mesh import DeviceMesh
    from tts_tpu_torch.gguf import GGUFReader
    from tts_tpu_torch.models.codec import dac
    from tts_tpu_torch.parallel.seq_vocoder import sharded_dac_decode
    a = _io(d)
    r = GGUFReader(a["path"])
    cfg = dac.DACConfig.from_gguf(r)
    w = dac.load_dac_weights(r, cfg, device="cpu")
    out = {}
    sp2 = make_mesh(tp=2, dp=2)
    sp4 = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("sp",))
    for n, mesh, axis in ((2, sp2, "tp"), (4, sp4, "sp")):
        out[n] = sharded_dac_decode(cfg, w, a["codes"], mesh, axis=axis,
                                    margin=a["margin"])
    out["bf16"] = sharded_dac_decode(cfg, dac.bf16_conv_weights(w), a["codes"],
                                     sp4, axis="sp", margin=a["margin"])
    _save(d, out)


def serving(d):
    """serving_mesh and host_slot_range on a world whose ranks sit on two
    hosts (GROUP_RANK set by the test)."""
    from tts_tpu_torch.parallel.distributed import (host_slot_range,
                                                    serving_mesh)
    mesh = serving_mesh()
    _save(d, dict(mesh=mesh.mesh.tolist(), names=mesh.mesh_dim_names,
                  world=list(host_slot_range(10)),
                  dp=list(host_slot_range(10, mesh.get_group("dp")))))


def dp_tp(d):
    """The batched Parler chunk on a 2 x 2 mesh: this rank's slots (dp) and
    heads (tp), greedy, for each (config, weights, state) the test wrote."""
    from tts_tpu_torch.parallel.sharding import (shard_batched_state,
                                                 shard_parler_weights)
    from tts_tpu_torch.runtime.batched_parler import batched_decode_chunk
    a = _io(d)
    mesh = make_mesh(tp=2, dp=2)
    out = {}
    for name, (cfg, w, st) in a["cases"].items():
        st = batched_decode_chunk(
            cfg, shard_parler_weights(w, mesh), shard_batched_state(st, mesh),
            a["steps"], torch.Generator().manual_seed(0), use_cross=True,
            tp_group=mesh.get_group("tp"))
        out[name] = st.out_tokens
    _save(d, out)
