"""SentencePiece-unigram tokenizer (Parler/T5).

A copy of the JAX package's `UnigramTokenizer` (parity: reference
src/tokenizer.cpp:49-127): whitespace-run collapse + leading-space normalize,
Viterbi max-score over a trie, unknown-token fallback per utf-8 step,
consecutive unknowns merged. Vocab comes from GGUF
`tokenizer.ggml.{tokens,scores,unknown_token_id,eos_token_id}` with '▁'
already replaced by ' ' at conversion time.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

_DUPED_SPACES = re.compile(r"\s{2,}")

_UTF8_LEN = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]


def _utf8_len(b: int) -> int:
    return _UTF8_LEN[b >> 4]


class UnigramTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: int,
                 scores: List[float], eos_token: int = 1,
                 dedupe_spaces: bool = True):
        self.vocab = vocab
        self.scores = scores
        self.unk_token = unk_token
        self.unk_token_score = scores[unk_token] if scores else 0.0
        self.eos_token = eos_token
        self.dedupe_spaces = dedupe_spaces
        # trie over byte strings
        self.trie: dict = {}
        for tok, tid in vocab.items():
            node = self.trie
            for b in tok.encode("utf-8"):
                node = node.setdefault(b, {})
            node[-1] = tid  # -1 marks terminal

    def tokenize(self, text: str) -> List[int]:
        if self.dedupe_spaces:
            text = " " + _DUPED_SPACES.sub(" ", text)
        data = text.encode("utf-8")
        n = len(data)
        NEG = float("-inf")
        # results[i] = (token, offset, score) best path ending at byte i
        results: List[Tuple[int, int, float]] = [(self.unk_token, 0, NEG)] * (n + 1)
        results[0] = (self.unk_token, 0, 0.0)
        offset = 0
        while offset < n:
            step = min(_utf8_len(data[offset]), n - offset)
            best_score = results[offset][2]
            found_unknown = True
            node = self.trie.get(data[offset])
            cur = offset + 1
            while node is not None:
                if -1 in node:
                    if cur - offset == step:
                        found_unknown = False
                    tid = node[-1]
                    score = best_score + self.scores[tid]
                    if score > results[cur][2]:
                        results[cur] = (tid, offset, score)
                if cur >= n:
                    break
                node = node.get(data[cur])
                cur += 1
            if found_unknown:
                cur = offset + step
                score = best_score + self.unk_token_score
                if score > results[cur][2]:
                    results[cur] = (self.unk_token, offset, score)
            offset += step
        # walk back from the end, merging consecutive unknowns
        # (tokenizer.cpp:112-127)
        tokens: List[int] = []
        i = n
        prev_unknown = False
        while True:
            tok, off, _ = results[i]
            is_unknown = tok == self.unk_token
            if not (prev_unknown and is_unknown):
                tokens.append(tok)
            if off == 0:
                break
            prev_unknown = is_unknown
            i = off
        tokens.reverse()
        return tokens

    @classmethod
    def from_gguf(cls, reader) -> "UnigramTokenizer":
        tokens = reader.metadata["tokenizer.ggml.tokens"]
        scores = [float(s) for s in reader.metadata["tokenizer.ggml.scores"]]
        unk = int(reader.metadata["tokenizer.ggml.unknown_token_id"])
        eos = int(reader.metadata.get("tokenizer.ggml.eos_token_id", 1))
        vocab = {t: i for i, t in enumerate(tokens)}
        return cls(vocab, unk, scores, eos)
