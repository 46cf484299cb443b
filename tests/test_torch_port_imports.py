"""PyTorch port: import hygiene and the device rule, on the CPU.

Every module of tts_tpu_torch, and chip_smoke.py, imports without JAX and
without the JAX package; entry points never fall back to the CPU unasked.
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
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "tts_tpu"
             or k.startswith("tts_tpu."))
assert {"tts_tpu_torch.runtime.batched_parler",
        "tts_tpu_torch.server.server"} <= set(names), names
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_tts_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 24          # every module was walked
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
    r = GGUFReader(path)
    try:
        for make in (lambda: load_parler_weights(r, ParlerConfig()),
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
    from tts_tpu_torch.ops import parler_megastep as pm
    from tts_tpu_torch.ops import quant_matmul as qm
    kernels = (qm.KERNEL, da.KERNEL, pm.KERNEL, da.KERNEL_BATCHED,
               pm.KERNEL_BATCHED)
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
    assert [k.launches for k in kernels] == before
    assert all(k._fn is None for k in kernels)
