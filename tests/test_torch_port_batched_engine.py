"""PyTorch port: the continuous-batching Parler engine against the JAX
package's engine and against the port's own single-stream runner, on the
CPU, with tiny GGUFs loaded through both registries.

Greedy codes must be equal, request by request, on both decode paths: the
megastep path (H=256, Q4_0: kernel K5's plain version; the JAX side with
TTS_TPU_MEGAKERNEL=1, as tests/test_batched_decode.py runs it) and the
per-matmul path (H=32, F32: K4's plain version for the self-attention).
Five requests of mixed length go through two slots, so slots are reused
while others are mid-generation.
"""
import numpy as np
import pytest

from test_torch_port_parler import _gguf
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.gguf import quants
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.runtime.batched_parler import BatchedParlerEngine as JEngine
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.runtime.batched_parler import (MAX_PROMPT,
                                                  BatchedParlerEngine)

PROMPTS = ["hello world", "hello", "wor ld a b c", "a", "hello hello world"]


@pytest.mark.parametrize("H,qtype,mega", [(256, quants.GGML_TYPE_Q4_0, True),
                                          (32, None, False)])
def test_engine_greedy_matches_jax_engine_and_runner(tmp_path, monkeypatch, H,
                                                     qtype, mega):
    monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "1")
    path = _gguf(tmp_path, H, 4, qtype, False)
    jr = jax_runner_from_file(path)
    pr = runner_from_file(path, device="cpu")
    jeng = JEngine(jr.cfg, jr.weights, jr.tokenizer, n_slots=2, chunk=7)
    peng = BatchedParlerEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=2,
                               chunk=7)
    assert (jeng.mega is not None) == (peng.mega is not None) == mega
    assert peng.state.pos.shape == (2,)   # sized to n_slots, no padding
    jids = [jeng.submit(p, JConfig(sample=False, seed=0)) for p in PROMPTS]
    pids = [peng.submit(p, GenerationConfig(sample=False, seed=0)) for p in PROMPTS]
    jeng.run_until_done()
    peng.run_until_done()
    assert not peng.errors and all(r is None for r in peng.slot_req)
    for prompt, jid, pid in zip(PROMPTS, jids, pids):
        got = peng.results[pid]
        np.testing.assert_array_equal(got, jeng.results[jid])
        np.testing.assert_array_equal(
            got, pr.generate_codes(prompt, GenerationConfig(sample=False, seed=0)))


def test_engine_mixed_sampling_and_validation(tmp_path):
    """Per-slot sampling parameters in one batch (greedy, top-k, top-p,
    repetition penalty): every request finishes with codes in range; a
    greedy request among sampled ones still gives the runner's codes; an
    oversized prompt is refused before it is queued."""
    path = _gguf(tmp_path, 256, 4, quants.GGML_TYPE_Q4_0, False)
    pr = runner_from_file(path, device="cpu")
    eng = BatchedParlerEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=3,
                              chunk=6, seed=1)
    cfgs = [GenerationConfig(sample=False),
            GenerationConfig(temperature=1.5, top_k=4),
            GenerationConfig(top_p=0.8, repetition_penalty=1.1),
            GenerationConfig(temperature=0.7, top_k=0)]
    rids = [eng.submit("hello world", c) for c in cfgs]
    eng.run_until_done()
    for rid in rids:
        codes = eng.results[rid]
        assert codes.ndim == 2 and codes.shape[1] == 3
        assert ((codes >= 0) & (codes < pr.cfg.audio_vocab_size)).all()
    np.testing.assert_array_equal(
        eng.results[rids[0]],
        pr.generate_codes("hello world", GenerationConfig(sample=False)))
    with pytest.raises(ValueError, match=f"context window \\({MAX_PROMPT}\\)"):
        eng.submit("a " * MAX_PROMPT, GenerationConfig())
    assert not eng.pending
