"""PyTorch port: import hygiene and the device rule, on the CPU.

Every module of tts_tpu_torch, and the root scripts that drive the port
(chip_smoke.py, gemv_ab.py), import without JAX and without the JAX
package; entry points never fall back to the CPU unasked.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import tts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tts_tpu_torch.__path__,
                                               "tts_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import gemv_ab
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "tts_tpu"
             or k.startswith("tts_tpu."))
assert {"tts_tpu_torch.runtime.batched_parler",
        "tts_tpu_torch.runtime.batched_llama",
        "tts_tpu_torch.server.server", "tts_tpu_torch.ops.llama_megastep",
        "tts_tpu_torch.ops.llama_flat", "tts_tpu_torch.models.codec.snac",
        "tts_tpu_torch.models.orpheus.model",
        "tts_tpu_torch.models.orpheus.loader",
        "tts_tpu_torch.models.orpheus.convert",
        "tts_tpu_torch.ops.dia_megastep", "tts_tpu_torch.models.dia.model",
        "tts_tpu_torch.models.dia.loader", "tts_tpu_torch.models.dia.convert",
        "tts_tpu_torch.runtime.batched_dia",
        "tts_tpu_torch.ops.parler_flat",
        "tts_tpu_torch.ops.dia_flat"} <= set(names), names
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_tts_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 37          # every module was walked
    assert bad == "[]", bad


def test_no_hidden_cpu_fallback(tmp_path):
    """Without device="cpu" the entry points ask for CUDA and raise when
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: there is nothing to refuse")
    from tts_tpu_torch.apps import cli
    from tts_tpu_torch.models.registry import runner_from_file
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner_from_file("test:dummy")
    path = str(tmp_path / "x.gguf")
    from tts_tpu_torch.gguf import GGUFWriter
    GGUFWriter(path, "parler-tts").write()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner_from_file(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-mp", "test:dummy", "-p", "hi", "-sp",
                  str(tmp_path / "o.wav")])
    assert runner_from_file("test:dummy", device="cpu").arch == "dummy"
    # the functions that make weights and state for a ParlerRunner built by
    # hand default to the card too
    from tts_tpu_torch.gguf.reader import GGUFReader
    from tts_tpu_torch.models.codec.dac import DACConfig, load_dac_weights
    from tts_tpu_torch.models.parler.convert import parler_weights_from_numpy
    from tts_tpu_torch.models.parler.model import ParlerConfig, load_parler_weights
    from tts_tpu_torch.common import GenerationConfig
    from tts_tpu_torch.ops import sampling
    from tts_tpu_torch.ops.quant_matmul import QuantTensor
    from tts_tpu_torch.server.server import TTSServer, build_server
    from tts_tpu_torch.models.codec.snac import SNACConfig, load_snac_weights
    from tts_tpu_torch.models.orpheus.convert import (
        llama_mega_from_numpy, orpheus_weights_from_numpy)
    from tts_tpu_torch.models.orpheus.loader import load_orpheus_runner
    from tts_tpu_torch.models.orpheus.model import (OrpheusConfig,
                                                    load_orpheus_weights)
    from tts_tpu_torch.models.dia.convert import (dia_mega_from_numpy,
                                                  dia_weights_from_numpy)
    from tts_tpu_torch.models.dia.loader import load_dia_runner
    from tts_tpu_torch.runtime.batched_dia import (BatchedDiaEngine,
                                                   init_batched_dia_state)
    from tts_tpu_torch.models.dia.model import (DiaConfig, DiaRunner,
                                                init_state, load_dia_weights)
    # a Dia runner (and the batched engine built from its weights) is built
    # from weights that these make, on the card unless asked
    dia = str(tmp_path / "dia.gguf")
    GGUFWriter(dia, "dia").write()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner_from_file(dia)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_dia_runner(GGUFReader(dia), GenerationConfig())
    # an Orpheus runner and its SNAC runner are built from weights that
    # these make, on the card unless asked
    orpheus = str(tmp_path / "o.gguf")
    GGUFWriter(orpheus, "orpheus").write()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner_from_file(orpheus)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_orpheus_runner(GGUFReader(orpheus), GenerationConfig())
    r = GGUFReader(path)
    try:
        for make in (lambda: load_orpheus_weights(r, OrpheusConfig()),
                     lambda: load_snac_weights(r, SNACConfig()),
                     lambda: orpheus_weights_from_numpy({}),
                     lambda: llama_mega_from_numpy({}, 2, 128),
                     lambda: load_dia_weights(r, DiaConfig()),
                     lambda: dia_weights_from_numpy({}),
                     lambda: dia_mega_from_numpy({}, 2, 128),
                     lambda: init_state(DiaConfig(), 8),
                     lambda: init_batched_dia_state(DiaConfig(), 2),
                     lambda: DiaRunner(DiaConfig(), None),
                     lambda: BatchedDiaEngine(DiaConfig(), None),
                     lambda: load_parler_weights(r, ParlerConfig()),
                     lambda: load_dac_weights(r, DACConfig()),
                     lambda: parler_weights_from_numpy({}),
                     lambda: QuantTensor.from_planar(
                         np.zeros((1, 32), np.uint8),
                         np.ones((1, 1), np.float16), 2),
                     lambda: sampling.init_state(9),
                     lambda: sampling.init_batched_state(2, 9),
                     lambda: TTSServer({"d": "test:dummy"}, "d",
                                       GenerationConfig()),
                     lambda: build_server("test:dummy")):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    finally:
        r.close()


def test_server_module_raises_without_a_card():
    """`python -m tts_tpu_torch.server.server` without a card and without
    --device cpu stops with the error; it does not serve from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: there is nothing to refuse")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "tts_tpu_torch.server.server", "-mp",
         "test:dummy", "--port", "0"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "listening" not in res.stdout


def test_cpu_tensors_take_the_plain_versions():
    """A CUDA launch path is never taken for CPU tensors: the dispatchers
    run the plain versions there without touching nvcc, and the launch
    counters stay at zero."""
    from tts_tpu_torch.ops import decode_attention as da
    from tts_tpu_torch.ops import llama_flat as lf
    from tts_tpu_torch.ops import llama_megastep as lm
    from tts_tpu_torch.ops import parler_flat as pf
    from tts_tpu_torch.ops import parler_megastep as pm
    from tts_tpu_torch.ops import quant_matmul as qm
    kernels = (qm.KERNEL, da.KERNEL, pm.KERNEL, da.KERNEL_BATCHED,
               pm.KERNEL_BATCHED, lf.KERNEL, lm.KERNEL, lf.KERNEL_BATCHED,
               lm.KERNEL_BATCHED, pf.KERNEL)
    before = [k.launches for k in kernels]
    q = torch.randn(4, 64)
    kv = torch.randn(4, 300, 64)
    da.decode_attention(q, kv, kv, torch.tensor([299], dtype=torch.int32))
    da.decode_attention_batched(q[None].expand(2, 4, 64), kv[None].expand(2, 4, 300, 64),
                                kv[None].expand(2, 4, 300, 64),
                                torch.tensor([0, 299], dtype=torch.int32))
    w = qm.QuantTensor(torch.randint(0, 16, (8, 64), dtype=torch.uint8),
                       torch.rand(8, 2), 2)
    qm.quant_matmul(torch.randn(1, 64), w)
    def c(n, k):
        return torch.randint(0, 16, (1, n, k // 2), dtype=torch.uint8)

    def s(n, k):
        return torch.rand(1, n, k // 32).to(torch.bfloat16)

    # one llama layer at H 256 (2 q / 1 kv heads of 128, F 512), tiled for
    # the GEMV by its prep, through K8 and K6
    from tts_tpu_torch.models.orpheus.model import OrpheusLayer

    def q4(n, k):
        return qm.QuantTensor(c(n, k), s(n, k), 2)

    one = torch.ones(1, 256)
    mega, _ = lm.prep_llama_mega(OrpheusLayer(
        one, q4(256, 256), q4(128, 256), q4(128, 256), q4(256, 256), one,
        q4(512, 256), q4(512, 256), q4(256, 512)), 128)
    head = qm.QuantTensor(c(70, 256)[0], torch.rand(70, 8), 2)
    flat = lf.prep_llama_flat(mega, head, torch.ones(256), 2, 2, 1)
    step = dict(qtype=2, n_heads=2, n_kv=1, inv_freq=torch.rand(64))
    kv = torch.zeros(1, 1, 40, 128)
    pos = torch.tensor([5], dtype=torch.int32)
    lm.llama_megastep(mega, torch.randn(1, 256), kv, kv.clone(), pos, **step)
    lg, _, _ = lf.llama_flat_megastep(flat, torch.randn(1, 256), kv, kv.clone(),
                                      pos, **step)
    assert lg.shape == (1, 256) and not lg[:, 70:].any()
    # and through K9 and K7 for two slots at different positions
    kv2 = torch.zeros(1, 2, 1, 40, 128)
    pos2 = torch.tensor([0, 39], dtype=torch.int32)
    lm.llama_megastep_batched(mega, torch.randn(2, 256), kv2, kv2.clone(), pos2,
                              **step)
    lg, _, _ = lf.llama_flat_megastep_batched(flat, torch.randn(2, 256), kv2,
                                              kv2.clone(), pos2, **step)
    assert lg.shape == (2, 256) and not lg[:, 70:].any()
    # one Parler layer at H 128 (two heads of 64, F 256), tiled for the
    # GEMV by its prep, through K12
    from tts_tpu_torch.models.parler.model import ParlerLayerWeights
    h, cross = torch.ones(1, 128), torch.randn(1, 2, 8, 64)
    pmega, _ = pm.prep_mega_layers(ParlerLayerWeights(
        h, h, q4(128, 128), q4(128, 128), q4(128, 128), q4(128, 128), h, h,
        q4(128, 128), q4(128, 128), cross, cross, h, h, q4(256, 128),
        q4(128, 256)))
    pflat = pf.prep_parler_flat(pmega, 2, 40)
    pkv = torch.zeros(1, 2, 40, 64)
    xo, kn, _ = pf.parler_flat_megastep(pflat, torch.randn(1, 128), pkv,
                                        pkv.clone(), pos, qtype=2, n_heads=2)
    assert xo.shape == (1, 128) and torch.equal(pkv[0, :, 5].reshape(-1), kn[0])
    assert [k.launches for k in kernels] == before
    assert all(k._fn is None for k in kernels)


def test_batched_llama_engine_names_no_device():
    """The batched Orpheus engine runs on its weights' device (the card
    unless the loader was given device="cpu"): the module names no device
    of its own to move work to (it asks only whether its own is the
    card)."""
    from tts_tpu_torch.runtime import batched_llama
    with open(batched_llama.__file__) as f:
        src = f.read()
    for name in ('"cpu"', "'cpu'", "device=None", "default_device"):
        assert name not in src, name

