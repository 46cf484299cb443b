from .tokenizer import BPETokenizer, UnigramTokenizer  # noqa: F401
