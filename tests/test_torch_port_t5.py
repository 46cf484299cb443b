"""PyTorch port: the T5 text encoder and Parler's conditional prompts
against the JAX package, on the CPU.

- `t5_relative_buckets`, `t5_position_bias` and `reference_pos_buckets`
  equal the JAX ones exactly.
- `t5_encode` on tiny T5 GGUFs (2 layers, hidden 32, 4 heads; the
  projections F32, Q4_0 or Q8_0; with and without the down projection;
  prompts inside the first length bucket and across it) through both
  packages' `text_encoder_from_file`: within 1e-4 of the largest output.
  The quantized products are K1's plain version in f32 mode here and the
  JAX package's XLA path there, f32 sums in other orders.
- Padding invariance: the same prompt padded to other buckets gives the
  same rows.
- `update_conditional_prompt` on a tiny Parler GGUF with the tiny T5 GGUF of
  tests/test_conditional_prompt.py: the cross K/V within the same tolerance
  of the JAX runner's, Tc the prompt's token count, and the greedy codes
  after the update equal; on K2's route (H 256, Q4_0) too, and the K12
  route stays K12.
- The entry points run on the card unless given device="cpu".
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_conditional_prompt import make_tiny_t5_gguf
from test_e2e_parler import make_tiny_parler_gguf
from test_torch_port_parler import _gguf, tpu_numerics  # noqa: F401
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.gguf import quants
from tts_tpu.gguf.writer import GGUFWriter
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.models.t5 import model as jt5
from tts_tpu.ops import attention as jattn
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.gguf.reader import GGUFReader
from tts_tpu_torch.models.parler.model import (Mega, maybe_prep_parler_flat)
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.models.t5 import model as pt5
from tts_tpu_torch.ops import attention as pattn
from tts_tpu_torch.ops.parler_flat import ParlerFlat

REL = 1e-4   # of the largest output: f32 sums in other orders


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("tq,tk,buckets,dist,bidir", [
    (1, 1, 32, 128, True), (7, 7, 32, 128, True), (64, 64, 32, 128, True),
    (300, 300, 32, 128, True), (40, 90, 16, 64, True), (50, 50, 32, 128, False)])
def test_relative_buckets_match_jax(tq, tk, buckets, dist, bidir):
    got = pattn.t5_relative_buckets(torch.arange(tq), torch.arange(tk),
                                    buckets, dist, bidir)
    want = jattn.t5_relative_buckets(jnp.arange(tq), jnp.arange(tk), buckets,
                                     dist, bidir)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    embed = np.random.default_rng(tq).standard_normal((buckets, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        pattn.t5_position_bias(torch.from_numpy(embed), tq, tk, buckets, dist).numpy(),
        np.asarray(jattn.t5_position_bias(jnp.asarray(embed), tq, tk, buckets, dist)))


@pytest.mark.parametrize("t", [1, 5, 17, 40])
def test_reference_pos_buckets_match_jax(t):
    np.testing.assert_array_equal(pt5.reference_pos_buckets(t),
                                  jt5.reference_pos_buckets(t))


def write_t5(path, rng, qtype=None, down=True, hidden=32, out_size=24):
    """A tiny T5 encoder GGUF as `tts_tpu.convert.write_t5_gguf` writes one,
    its projections stored as `qtype` (None: F32) and the down projection
    present or not."""
    def r(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.3

    w = GGUFWriter(path, "t5encoder")
    for k, v in (("embedding_length", hidden), ("block_count", 2),
                 ("attention.head_count", 4), ("vocab_size", 40),
                 ("output_size", out_size if down else hidden),
                 ("context_length", 512)):
        w.add_u32(f"t5encoder.{k}", v)
    w.add_str("tokenizer.ggml.model", "unigram")
    w.add_array("tokenizer.ggml.tokens", ["<pad>", "</s>", "<unk>", " ", "calm"])
    w.add_array("tokenizer.ggml.scores", np.asarray([-10, -1, -10, -1, -2], np.float32))
    w.add_u32("tokenizer.ggml.unknown_token_id", 2)
    w.add_u32("tokenizer.ggml.eos_token_id", 1)
    w.add_u32("tokenizer.ggml.bos_token_id", 0)

    def proj(name, n, k):
        w.add_tensor(name, r(n, k), qtype)

    for l in range(2):
        b = f"t5encoder.enc.blk.{l}."
        w.add_tensor(b + "attn_norm", r(hidden) * 0.1 + 1)
        for n in ("attn_q", "attn_k", "attn_v", "attn_o"):
            proj(b + n, hidden, hidden)
        if l == 0:
            w.add_tensor(b + "attn_rel_b", r(32, 4))
        w.add_tensor(b + "ffn_norm", r(hidden) * 0.1 + 1)
        proj(b + "ffn_up", 2 * hidden, hidden)
        proj(b + "ffn_gate", 2 * hidden, hidden)
        proj(b + "ffn_down", hidden, 2 * hidden)
    w.add_tensor("t5encoder.token_embd", r(40, hidden))
    w.add_tensor("t5encoder.enc.final_layer_norm", r(hidden) * 0.1 + 1)
    if down:
        proj("t5encoder.down_proj", out_size, hidden)
        w.add_tensor("t5encoder.down_proj_bias", r(out_size))
    w.write()


@pytest.mark.parametrize("qtype", [None, quants.GGML_TYPE_Q4_0,
                                   quants.GGML_TYPE_Q8_0])
@pytest.mark.parametrize("down", [True, False])
def test_t5_encode_matches_jax(tmp_path, qtype, down):
    path = str(tmp_path / "t5.gguf")
    write_t5(path, np.random.default_rng(3), qtype, down)
    jr = jt5.text_encoder_from_file(path)
    pr = pt5.text_encoder_from_file(path, device="cpu")
    assert pr.cfg.output_size == jr.cfg.output_size
    assert pr.weights.out_norm.device.type == "cpu"
    rng = np.random.default_rng(5)
    for t in (5, 31, 40):   # inside the 32-row bucket, at its edge, past it
        ids = rng.integers(0, 40, t).tolist()
        got = pr.encode_tokens(ids)
        assert got.shape == (t, 24 if down else 32)
        close(got.numpy(), jr.encode_tokens(ids))
    close(pr.generate("calm calm").numpy(), jr.generate("calm calm"))


def test_t5_padding_invariance(tmp_path):
    """The pad mask keeps bucket padding out of the real rows: a prompt
    padded to 32, 64 or 512 rows encodes to the same rows."""
    path = str(tmp_path / "t5.gguf")
    write_t5(path, np.random.default_rng(4), quants.GGML_TYPE_Q8_0)
    pr = pt5.text_encoder_from_file(path, device="cpu")
    ids = np.random.default_rng(6).integers(0, 40, 9).tolist()
    outs = []
    for buckets in ((32,), (64,), (512,)):
        pr.buckets = buckets
        outs.append(pr.encode_tokens(ids).numpy())
    for o in outs[1:]:
        close(o, outs[0], rel=1e-6)


def _cross(r):
    return [np.asarray(t) for t in (r.weights.layers.cross_k,
                                    r.weights.layers.cross_v)]


@pytest.mark.parametrize("route", ["per matmul", "K2"])
def test_update_conditional_prompt_matches_jax(tmp_path, tpu_numerics, route):
    if route == "K2":   # H 256, Q4_0: the megastep route on both sides
        model = _gguf(tmp_path, 256, 4, quants.GGML_TYPE_Q4_0, False)
        t5_out = 256
    else:
        model = str(tmp_path / "parler.gguf")
        make_tiny_parler_gguf(model, np.random.default_rng(0))
        t5_out = 32
    t5 = str(tmp_path / "t5.gguf")
    make_tiny_t5_gguf(t5, np.random.default_rng(1), out_size=t5_out)
    jr = jax_runner_from_file(model)
    pr = runner_from_file(model, device="cpu")
    assert isinstance(pr.mega, Mega) == (route == "K2") == (jr._mega is not None)
    assert pr.cross_kv_projs is not None and len(pr.cross_kv_projs[0]) == 2
    jr.update_conditional_prompt(t5, "calm voice")
    pr.update_conditional_prompt(t5, "calm voice")
    tc = jr.cfg.n_encode_length
    assert pr.cfg.n_encode_length == tc and tc != 6   # not the baked encoding
    for got, want in zip(_cross(pr), _cross(jr)):
        assert got.shape[2] == tc
        close(got, want)
    assert isinstance(pr.mega, Mega) == (route == "K2")
    if route == "K2":
        assert pr.mega.layers.cross_k.shape[2] == tc
    greedy = dict(sample=False, seed=0)
    for text in ("hello world", "hello"):
        np.testing.assert_array_equal(
            pr.generate_codes(text, GenerationConfig(**greedy)),
            jr.generate_codes(text, JConfig(**greedy)))


def test_update_keeps_the_k12_route(tmp_path):
    model = _gguf(tmp_path, 256, 4, quants.GGML_TYPE_Q4_0, False)
    t5 = str(tmp_path / "t5.gguf")
    make_tiny_t5_gguf(t5, np.random.default_rng(1), out_size=256)
    pr = runner_from_file(model, device="cpu")
    pr.mega = maybe_prep_parler_flat(pr.cfg, pr.weights)
    assert isinstance(pr.mega, ParlerFlat)
    pr.update_conditional_prompt(t5, "calm")
    assert isinstance(pr.mega, ParlerFlat)
    assert pr.mega.layers.cross_k.shape[2] == pr.cfg.n_encode_length
    codes = pr.generate_codes("hello world", GenerationConfig(sample=False))
    assert codes.ndim == 2 and codes.shape[1] == 3


def test_update_refused_without_cross_attention(tmp_path):
    model = str(tmp_path / "parler.gguf")
    make_tiny_parler_gguf(model, np.random.default_rng(0))
    t5 = str(tmp_path / "t5.gguf")
    make_tiny_t5_gguf(t5, np.random.default_rng(1))
    pr = runner_from_file(model, GenerationConfig(use_cross_attn=False),
                          device="cpu")
    with pytest.raises(RuntimeError, match="cross-attention disabled"):
        pr.update_conditional_prompt(t5, "calm")
    dummy = runner_from_file("test:dummy", device="cpu")
    with pytest.raises(NotImplementedError):
        dummy.update_conditional_prompt(t5, "calm")


def test_entry_points_need_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: there is nothing to refuse")
    path = str(tmp_path / "t5.gguf")
    write_t5(path, np.random.default_rng(3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt5.text_encoder_from_file(path)
    with GGUFReader(path) as r:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt5.load_t5_weights(r, pt5.T5Config.from_gguf(r))
