"""Offline converters: numpy weight dicts -> GGUF files."""
from .writers import (  # noqa: F401
    write_dia_gguf, write_kokoro_gguf, write_orpheus_gguf, write_parler_gguf,
    write_t5_gguf,
)
