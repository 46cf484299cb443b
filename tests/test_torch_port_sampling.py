"""PyTorch port: the sampler against the JAX package's, on the CPU. The two
frameworks' generators differ, so the port's `select` is fed the very
uniforms JAX draws inside `sample` (jax.random.uniform(key, (h,)))."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tts_tpu.ops import sampling as js
from tts_tpu_torch.ops import sampling as ps

H, V = 9, 1088


def _logits(rng):
    return (rng.standard_normal((H, V)) * 3).astype(np.float32)


def test_greedy(rng):
    x = _logits(rng)
    x[2, 5] = x[2, 9] = x[2].max() + 1          # a tie takes the first index
    ref = np.asarray(js.greedy(jnp.asarray(x)))
    np.testing.assert_array_equal(ps.greedy(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("temperature,top_k,top_p,rp", [
    (1.0, 0, 1.0, 1.0),
    (0.7, 0, 1.0, 1.0),
    (1.0, 50, 1.0, 1.0),
    (1.0, 0, 0.9, 1.0),
    (0.8, 50, 0.8, 1.3),
    (1.0, 0, 1.0, 1.5),
])
def test_sample_tokens_equal(rng, temperature, top_k, top_p, rp):
    """Tokens must be equal over several steps, with the repetition state
    carried by each package (the last token's logit is boosted so repeats,
    and so the penalty, actually occur)."""
    js_state = js.init_state(H)
    ps_state = ps.init_state(H, device="cpu")
    key = jax.random.PRNGKey(3)
    prev = None
    for step in range(6):
        x = _logits(rng)
        if prev is not None:
            x[np.arange(H), prev] += 8.0
        key, sub = jax.random.split(key)
        ref, js_state = js.sample(sub, jnp.asarray(x), js_state, temperature,
                                  top_k, top_p, rp)
        u = torch.from_numpy(np.array(jax.random.uniform(sub, (H,))))
        out, ps_state = ps.select(torch.from_numpy(x), ps_state, u,
                                  temperature, top_k, top_p, rp)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(ps_state.repeat_count.numpy(),
                                      np.asarray(js_state.repeat_count))
        prev = out.numpy()


def test_draw_u_uses_the_generator():
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a, b = ps.draw_u(g1, H, "cpu"), ps.draw_u(g2, H, "cpu")
    assert torch.equal(a, b) and a.shape == (H,)
    assert bool(((a >= 0) & (a < 1)).all())
