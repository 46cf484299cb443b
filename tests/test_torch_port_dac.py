"""PyTorch port: the DAC vocoder against the JAX package's, on the CPU, on
the tiny DAC of `tests/test_e2e_parler.py::make_tiny_parler_gguf` (2 layers,
3 quantizers, latent 8, 8 samples per frame)."""
import numpy as np
import pytest
import torch

from test_e2e_parler import make_tiny_parler_gguf
from tts_tpu.gguf import GGUFReader as JReader
from tts_tpu.models.codec import dac as jdac
from tts_tpu_torch.gguf import GGUFReader
from tts_tpu_torch.models.codec import dac


@pytest.fixture(scope="module")
def tiny_dac(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dac") / "parler-tiny.gguf")
    make_tiny_parler_gguf(path, np.random.default_rng(0))
    jr, pr = JReader(path), GGUFReader(path)
    jcfg = jdac.DACConfig.from_gguf(jr)
    jrun = jdac.DACRunner(jcfg, jdac.load_dac_weights(jr, jcfg))
    pcfg = dac.DACConfig.from_gguf(pr)
    prun = dac.DACRunner(pcfg, dac.load_dac_weights(pr, pcfg, device="cpu"))
    assert (pcfg.strides, pcfg.paddings, pcfg.up_sampling_factor) == \
        (jcfg.strides, jcfg.paddings, jcfg.up_sampling_factor)
    return jrun, prun


@pytest.mark.parametrize("t", [1, 13, 70])
def test_dac_decode_matches_jax(tiny_dac, t):
    """Exact-length decode vs JAX's bucket-padded, masked decode (70 frames
    crosses its 64-frame bucket). Both are float32 convolution stacks
    summed in different orders. The tiny net's random weights (scale 0.3)
    drive its activations to ~1.2e2 before the final tanh (measured), and
    tanh's slope is at most 1: so 1e-3 absolute, i.e. ~1e-5 of the
    pre-tanh scale (measured differences reach ~2e-6 of it)."""
    jrun, prun = tiny_dac
    codes = np.random.default_rng(t).integers(0, 10, (t, 3)).astype(np.int64)
    ref = jrun.decode(codes)
    out = prun.decode(codes)
    assert out.shape == ref.shape == (t * 8,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_dac_keeps_fp32_convolutions():
    """Building a runner turns TF32 off for cuDNN convolutions (on by
    default) and cuBLAS matmuls."""
    torch.backends.cudnn.allow_tf32 = True
    cfg = dac.DACConfig()
    w = dac.DACWeights([], torch.zeros(1), None, [], None, None, None)
    dac.DACRunner(cfg, w)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
