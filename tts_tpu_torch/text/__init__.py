from .tokenizer import BPETokenizer, SinglePassTokenizer, UnigramTokenizer  # noqa: F401
