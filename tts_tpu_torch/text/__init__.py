from .tokenizer import UnigramTokenizer  # noqa: F401
