"""PyTorch port: Megatron TP for the quantized llama (Orpheus) and Dia CFG
decode steps (tts_tpu_torch/parallel/{llama_tp,dia_tp}.py), on 4 CPU ranks
over gloo at tp 2 and 4, against the JAX package's `parallel/llama_tp.py`
and `parallel/dia_tp.py` on the conftest's CPU mesh, at the inputs of
`tests/test_llama_tp.py` / `tests/test_dia_tp.py` (L=2, H=256, 8 q / 4 kv
heads of 32, F=256, Q4_0)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from test_dia_tp import tiny as dia_tiny  # noqa: F401  (fixture)
from test_llama_tp import tiny_layers  # noqa: F401  (fixture)
from torch_tp_common import on_ranks
from tts_tpu.ops.dia_megastep import prep_dia_cross as jax_prep_dia_cross
from tts_tpu.ops.llama_megastep import _inv_freq_row
from tts_tpu.ops.quant_matmul import QuantTensor as JQT
from tts_tpu.parallel import dia_tp as jdia
from tts_tpu.parallel import llama_tp as jllama
from tts_tpu_torch.models.dia.model import DiaDecoderLayer
from tts_tpu_torch.models.orpheus.model import OrpheusLayer
from tts_tpu_torch.models.parler.convert import _leaf
from tts_tpu_torch.ops.attention import rope_freqs
from tts_tpu_torch.ops.dia_megastep import prep_dia_cross

NH, NKV, D = 8, 4, 32
# f32 math on both sides from the same f32-scale weights; only the order of
# the partial sums differs: 1e-4 of each output's peak (measured ~1e-6).
TP_REL = 1e-4


def port(layer_tuple, cls):
    """A JAX stacked layer NamedTuple as the port's, on the CPU."""
    def leaf(v):
        if isinstance(v, JQT):
            return _leaf((np.asarray(v.codes_t), np.asarray(v.scales_t),
                          v.qtype), "cpu")
        return _leaf(np.asarray(v), "cpu")
    return cls(*[leaf(v) for v in layer_tuple])


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TP_REL * np.abs(want).max(), err_msg=what)


def t(a):
    return torch.from_numpy(np.array(a))


def test_llama_tp_matches_jax(tiny_layers, tmp_path):  # noqa: F811
    """tp 2 and 4 at pos 5, and at pos 0 the gathered k_new in global kv-head
    order (test_llama_tp.py's head-order case: a wrong split permutes the
    cache), each head against the JAX TP step's."""
    layers, x, kv_k, kv_v = tiny_layers
    outs = on_ranks(tmp_path, "llama_tp", dict(
        layers=port(layers, OrpheusLayer), x=t(x), kv_k=t(kv_k), kv_v=t(kv_v),
        pos=5, n_heads=NH, n_kv=NKV, d=D, inv=rope_freqs(D, 10000.0)))
    inv = _inv_freq_row(D, 10000.0, None)
    for pos in (5, 0):
        for tp in (2, 4):
            mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
            tpl, qtype = jllama.prep_llama_tp(layers, tp, n_heads=NH, n_kv=NKV,
                                              head_d=D)
            want = jllama.llama_megastep_tp(
                jllama.shard_llama_tp(tpl, mesh), x, kv_k, kv_v,
                jnp.int32(pos), inv, mesh=mesh, qtype=qtype, n_heads=NH,
                n_kv=NKV, rope_base=10000.0)
            for r, o in enumerate(outs):
                got = o[pos, tp]
                close(got[0], want[0], f"pos {pos} tp {tp} rank {r} x")
                for h in range(NKV):
                    for g, w, what in ((got[1], want[1], "k"), (got[2], want[2], "v")):
                        close(g.reshape(2, NKV, D)[:, h],
                              np.asarray(w).reshape(2, NKV, D)[:, h],
                              f"pos {pos} tp {tp} rank {r} {what} head {h}")


def test_dia_tp_matches_jax(dia_tiny, tmp_path):  # noqa: F811
    """tp 2 and 4 at pos 5, cross K/V bucketed at 16 of 64 rows (48 folded
    into the pad tail)."""
    dec, x, kv_k, kv_v, ck_full, cv_full = dia_tiny
    ck, cv, vt, nt = prep_dia_cross(t(ck_full), t(cv_full), 11, buckets=(16, 64))
    jck, jcv, jvt, jnt = jax_prep_dia_cross(ck_full, cv_full, 11,
                                            buckets=(16, 64))
    assert nt == jnt == 48
    outs = on_ranks(tmp_path, "dia_tp", dict(
        layers=port(dec, DiaDecoderLayer), x=t(x), kv_k=t(kv_k), kv_v=t(kv_v),
        pos=5, ck=ck, cv=cv, vtail=vt, n_tail=nt, n_heads=NH, n_kv=NKV, d=D))
    for tp in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
        tpl, qtype = jdia.prep_dia_tp(dec, tp, n_heads=NH, n_kv=NKV, head_d=D)
        cks, cvs, vts = jdia.shard_dia_cross(jck, jcv, jvt, mesh)
        want = jdia.dia_megastep_tp(
            jdia.shard_dia_tp(tpl, mesh), x, kv_k, kv_v, jnp.int32(5), cks,
            cvs, vts, jnt, mesh=mesh, qtype=qtype, n_heads=NH, n_kv=NKV)
        for r, o in enumerate(outs):
            for got, ref, what in zip(o[tp], want, ("x", "k_new", "v_new")):
                close(got, ref, f"tp {tp} rank {r} {what}")


@pytest.mark.parametrize("tp", [3, 8])
def test_tp_refuses_what_does_not_divide(tiny_layers, dia_tiny, tp):  # noqa: F811
    """tp must divide the heads (Dia: its 4 kv heads)."""
    from tts_tpu_torch.parallel.dia_tp import prep_dia_tp
    from tts_tpu_torch.parallel.llama_tp import prep_llama_tp
    with pytest.raises(ValueError, match="must divide heads"):
        prep_llama_tp(port(tiny_layers[0], OrpheusLayer), tp, n_heads=NH,
                      n_kv=NKV, head_d=D)
    with pytest.raises(ValueError, match="must divide heads"):
        prep_dia_tp(port(dia_tiny[0], DiaDecoderLayer), tp, n_heads=NH,
                    n_kv=NKV, head_d=D)
