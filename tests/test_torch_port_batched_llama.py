"""PyTorch port: the continuous-batching Orpheus engine against the JAX
package's engine and the port's own single-stream runner, on the CPU.

Tiny Orpheus GGUFs from tests/test_torch_port_orpheus.py, five prompts
through two slots (slots are reused while the other is mid-generation), on
each route: per matmul (F32), K9 (Q4_0 layers, F32 head) and K7 (Q4_0
layers and head, head_d 128): greedy tokens equal, request by request, to
the JAX engine's (per matmul and K9; the JAX side with
TTS_TPU_MEGAKERNEL=1) and to the port's `OrpheusRunner` (every route; on
K7 the runner's are the yardstick, since the JAX K7 rounds its page dots to
bf16). Then the engine's behaviour: per-slot sampling, refusals at submit,
a failing prefill, the device its state lies on. The kernels' plain
versions are held to the JAX package in
tests/test_torch_port_batched_llama_ops.py.
"""
import threading

import numpy as np
import pytest
import torch

from test_torch_port_orpheus import (MAX_CTX, MAX_GEN, VOCAB,  # noqa: F401
                                     small_prompt_ids, write_tiny_orpheus)
from tts_tpu.apps.quantize import QuantizationParams, quantize_gguf
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.gguf import quants
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.runtime.batched_llama import BatchedLlamaEngine as JEngine
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.orpheus import model as pmodel
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.ops.llama_flat import LlamaFlat
from tts_tpu_torch.ops.llama_megastep import LlamaMegaLayers
from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run many tiny torch ops: one intra-op thread keeps
    the CPU to the other test workers and JAX's compiles, which share it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPTS = [("abcd cab", "zoe"), ("ab", ""), ("dd cadd", "zoe"),
           ("abc abcd a b", ""), ("ca", "zoe")]


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """Tiny Orpheus GGUFs per route: F32 (per matmul), Q4_0 with its F32
    head (K9), and a head_d-128 variant quantized with -qh (K7)."""
    d = tmp_path_factory.mktemp("batched-orpheus")
    paths = {"f32": str(d / "f32.gguf"), "f32-d128": str(d / "f32-d128.gguf")}
    write_tiny_orpheus(paths["f32"], np.random.default_rng(0))
    write_tiny_orpheus(paths["f32-d128"], np.random.default_rng(1), heads=2,
                       kv=1)
    for name, src, q_heads in (("q4", "f32", False),
                               ("q4-head-d128", "f32-d128", True)):
        paths[name] = str(d / f"{name}.gguf")
        quantize_gguf(paths[src], paths[name], QuantizationParams(
            quants.GGML_TYPE_Q4_0, quantize_output_heads=q_heads),
            log=lambda *a: None)
    return paths


def _port_runner(path):
    r = runner_from_file(path, device="cpu")
    r.cfg.max_generation_size, r.cfg.max_context_length = MAX_GEN, MAX_CTX
    return r


def _greedy(voice):
    return dict(sample=False, seed=0, voice=voice)


@pytest.mark.parametrize("name,route,with_jax", [
    ("f32", None, True), ("q4", LlamaMegaLayers, True),
    ("q4-head-d128", LlamaFlat, False)])
def test_engine_greedy_matches_jax_engine_and_runner(ggufs, small_prompt_ids,
                                                     monkeypatch, name, route,
                                                     with_jax):
    """Five prompts of mixed length, with and without a voice, through two
    slots (slots are reused while the other is mid-generation): the SNAC
    head lists of every request equal the port runner's and, on the routes
    the JAX engine shares, the JAX engine's."""
    monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "1")
    pr = _port_runner(ggufs[name])
    eng = BatchedLlamaEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=2,
                             chunk=7)
    assert (route is None and eng.mega is None) or isinstance(eng.mega.step, route)
    assert eng.state.pos.shape == (2,)            # sized to n_slots
    assert eng.state.kv_k.shape[3] == pmodel.cache_ctx(pr.cfg)
    rids = [eng.submit(t, GenerationConfig(**_greedy(v))) for t, v in PROMPTS]
    eng.run_until_done()
    assert not eng.errors and all(r is None for r in eng.slot_req)
    for (text, voice), rid in zip(PROMPTS, rids):
        out, n_out, _ = pr.generate_tokens(text, GenerationConfig(**_greedy(voice)))
        assert n_out == MAX_GEN                   # the stop token never came
        assert eng.results[rid] == pmodel.prepare_output_tokens(out, n_out)
    if not with_jax:
        return
    jr = jax_runner_from_file(ggufs[name])
    jr.cfg.max_generation_size, jr.cfg.max_context_length = MAX_GEN, MAX_CTX
    jeng = JEngine(jr.cfg, jr.weights, jr.tokenizer, n_slots=2, chunk=7)
    assert (jeng.mega is None) == (route is None)
    jids = [jeng.submit(t, JConfig(**_greedy(v))) for t, v in PROMPTS]
    jeng.run_until_done()
    for rid, jid in zip(rids, jids):
        assert eng.results[rid] == jeng.results[jid]


def _raw_tokens(heads):
    """prepare_output_tokens undone: the 7-token groups' raw ids."""
    out = []
    for i in range(len(heads[0])):
        group = (heads[0][i], heads[1][2 * i], heads[2][4 * i],
                 heads[2][4 * i + 1], heads[1][2 * i + 1], heads[2][4 * i + 2],
                 heads[2][4 * i + 3])
        out += [t + 128266 + ii * 4096 for ii, t in enumerate(group)]
    return out


def test_engine_mixed_sampling_and_validation(ggufs, small_prompt_ids):
    """Per-slot sampling parameters in one batch (greedy, top-k, top-p,
    repetition penalty) on the K9 route: every request finishes with its
    tokens in the vocabulary; the greedy one among sampled ones still gives
    the runner's tokens; an oversized prompt and an unknown voice are
    refused at submit, before they are queued."""
    pr = _port_runner(ggufs["q4"])
    eng = BatchedLlamaEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=3,
                             chunk=6, seed=1)
    assert eng.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in eng.state[:8])
    cfgs = [GenerationConfig(sample=False, voice="zoe"),
            GenerationConfig(temperature=1.5, top_k=4, seed=3),
            GenerationConfig(top_p=0.8, repetition_penalty=1.1, seed=4),
            GenerationConfig(temperature=0.7, top_k=0, seed=5)]
    rids = [eng.submit("abcd cab", c) for c in cfgs]
    eng.run_until_done()
    for rid in rids:
        heads = eng.results[rid]
        assert len(heads[0]) == MAX_GEN // 7
        assert len(heads[1]) == 2 * len(heads[0])
        assert len(heads[2]) == 4 * len(heads[0])
        assert all(0 <= t < VOCAB for t in _raw_tokens(heads))
    out, n_out, _ = pr.generate_tokens("abcd cab", cfgs[0])
    assert eng.results[rids[0]] == pmodel.prepare_output_tokens(out, n_out)
    with pytest.raises(ValueError, match="too large for the context window"):
        eng.submit("a " * MAX_CTX, GenerationConfig())
    with pytest.raises(ValueError, match="not a valid Orpheus voice"):
        eng.submit("ab", GenerationConfig(voice="bob"))
    assert not eng.pending and not eng.errors


def test_failing_prefill_fails_only_itself(ggufs, small_prompt_ids,
                                           monkeypatch):
    """A request whose prefill raises is recorded in engine.errors; the
    requests around it, through the one slot, complete."""
    pr = _port_runner(ggufs["f32"])
    eng = BatchedLlamaEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=1,
                             chunk=8)
    real = eng._prefill

    def boom(slot, text, config):
        if "bad" in text:
            raise ValueError("synthetic prefill failure")
        return real(slot, text, config)

    monkeypatch.setattr(eng, "_prefill", boom)
    greedy = GenerationConfig(sample=False)
    good1, bad, good2 = (eng.submit(t, greedy) for t in ("ab", "bad", "ca"))
    eng.run_until_done()
    assert bad in eng.errors and "synthetic" in eng.errors[bad]
    assert good1 in eng.results and good2 in eng.results
    assert bad not in eng.results


def test_engine_state_stays_on_the_weights_device(ggufs, small_prompt_ids):
    """The engine steps from a worker thread as the server runs it: every
    tensor it makes lies on its weights' device (the CPU here, as the
    loader was asked), and nothing moves the step elsewhere."""
    pr = _port_runner(ggufs["q4-head-d128"])
    eng = BatchedLlamaEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=2,
                             chunk=4)
    assert eng.device == pr.weights.out_norm.device == torch.device("cpu")
    eng.submit("ab", GenerationConfig(sample=False))
    t = threading.Thread(target=eng.step)
    t.start()
    t.join()
    st = eng.state
    tensors = [*st[:8], *st.sampler_state, *st[9:], eng.inv_freq,
               eng.mega.step.out_norm, eng.mega.step.head.codes]
    assert all(x.device.type == "cpu" for x in tensors)
    assert eng.generator.device.type == "cpu"
    # slot 0 took 4 steps after its first token; the empty slot 1 froze
    assert st.n_out.tolist() == [5, 0] and int(st.pos[1]) == 0
