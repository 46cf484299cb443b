"""PyTorch port: the perf battery (tts_tpu_torch/apps/perf_battery.py) and
the profiling utilities (tts_tpu_torch/utils/profiling.py) against the JAX
package's, on the CPU."""
import json
import math
import os

import numpy as np
import pytest
import torch

from test_torch_port_kokoro import kokoro_gguf  # noqa: F401  (fixture)
from tts_tpu.apps import perf_battery as jpb
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.utils import profiling as jprof
from tts_tpu_torch.apps import perf_battery as pb
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.utils import profiling as prof


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread, as test_torch_port_kokoro.py runs: beside five
    other test workers, torch's default thread pool oversubscribes the
    cores and the Kokoro runs slow down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("gen_ms,audio_ms", [
    ([120.0, 80.5, 99.25], [1000.0, 750.0, 512.0]),
    ([10.0, 20.0], [float("nan"), 0.0]),          # no audio: RTF is NaN
    ([33.3333], [123.456]),
])
def test_printout_matches_jax(gen_ms, audio_ms):
    text, blob = pb.printout("parler-tts", gen_ms, audio_ms)
    jtext, jblob = jpb.printout("parler-tts", gen_ms, audio_ms)
    assert text == jtext
    assert json.dumps(blob) == json.dumps(jblob)
    assert pb.TEST_SENTENCES == jpb.TEST_SENTENCES and len(pb.TEST_SENTENCES) == 30


def test_run_battery_through_both_registries(kokoro_gguf, monkeypatch):  # noqa: F811
    """The tiny Kokoro GGUF of test_torch_port_kokoro.py through each
    package's registry and run_battery: the same audio length sentence by
    sentence (Kokoro's durations decide it; its noise does not), and
    main()'s report with the port's --device flag (on the first two
    sentences: chip_smoke runs all 30 on the card)."""
    path = kokoro_gguf[0]
    sentences = pb.TEST_SENTENCES[:2]
    pgen, paudio = pb.run_battery(runner_from_file(path, device="cpu"),
                                  GenerationConfig(voice="af_heart"),
                                  sentences, warmup=False)
    jgen, jaudio = jpb.run_battery(jax_runner_from_file(path),
                                   JConfig(voice="af_heart"), sentences,
                                   warmup=False)
    assert len(pgen) == len(jgen) == 2 and all(g > 0 for g in pgen)
    assert all(a > 0 for a in paudio)
    np.testing.assert_array_equal(paudio, jaudio)
    monkeypatch.setattr(pb, "TEST_SENTENCES", sentences)
    assert pb.main(["-mp", path, "--device", "cpu", "-v", "af_heart"]) == 0


def test_perf_battery_needs_a_card_unless_told(kokoro_gguf):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: there is nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pb.main(["-mp", kokoro_gguf[0]])


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_stage_timer_matches_jax(monkeypatch):
    """Both timers under one fixed clock: the same report (sorted by total)
    and JSON."""
    clock = Clock()
    monkeypatch.setattr(jprof.time, "perf_counter", clock)
    monkeypatch.setattr(prof.time, "perf_counter", clock)
    timers = (prof.StageTimer(), jprof.StageTimer())
    for name, dt in (("decode", 0.25), ("vocode", 0.5), ("decode", 0.125)):
        for t in timers:
            with t.stage(name):
                clock.t += dt / 2
        clock.t += dt / 2
    for t in timers:
        t.record("tokenize", 0.01)
    clock.t += 1.0
    assert timers[0].report() == timers[1].report()
    assert timers[0].as_json() == timers[1].as_json()
    assert timers[0].report().splitlines()[1].startswith("  vocode")
    assert timers[0].counts == {"decode": 2, "vocode": 1, "tokenize": 1}
    assert math.isclose(json.loads(timers[0].as_json())["decode"], 187.5)


def test_trace_writes_a_file(tmp_path):
    with prof.trace(None):               # a no-op
        pass
    with prof.trace(str(tmp_path / "t")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "t" / files[0]) as f:
        assert "traceEvents" in json.load(f)
