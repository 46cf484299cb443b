"""Loader registry: architecture -> runner factory.

Parity: reference src/models/loaders.{h,cpp} (`runner_from_file`). The
`test:` filename prefix instantiates weight-free test runners
(loaders.cpp:37-44). The port supports every family the JAX package
serves: `parler-tts`, `kokoro`, `orpheus`, `dia`, and `test:dummy`.
"""
from __future__ import annotations

from typing import Optional

from ..common import GenerationConfig, default_device
from ..gguf.reader import GGUFReader
from .base import TTSRunner


def runner_from_file(fname: str, config: Optional[GenerationConfig] = None,
                     device=None, **kw) -> TTSRunner:
    """Load a model file (or `test:<arch>`) and return its runner on
    `device` (default `cuda`; raises when there is no card and the caller
    did not ask for `device="cpu"`)."""
    dev = default_device(device)
    config = config or GenerationConfig()
    if fname.startswith("test:"):
        name = fname[len("test:"):]
        if name != "dummy":
            raise ValueError(f"unknown test model {name!r}")
        from .dummy import DummyRunner
        return DummyRunner()
    reader = GGUFReader(fname)
    arch = reader.architecture
    if arch == "parler-tts":
        from .parler.loader import load_parler_runner
        return load_parler_runner(reader, config, device=dev, **kw)
    if arch == "orpheus":
        from .orpheus.loader import load_orpheus_runner
        return load_orpheus_runner(reader, config, device=dev, **kw)
    if arch == "dia":
        from .dia.loader import load_dia_runner
        return load_dia_runner(reader, config, device=dev, **kw)
    if arch == "kokoro":
        from .kokoro.loader import load_kokoro_runner
        return load_kokoro_runner(reader, config, device=dev, **kw)
    reader.close()
    raise ValueError(f"unsupported architecture {arch!r} in {fname} "
                     "(the port runs parler-tts, kokoro, orpheus and dia)")
