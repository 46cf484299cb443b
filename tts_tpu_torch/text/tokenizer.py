"""Text tokenizers: SentencePiece-unigram (Parler/T5), BPE (Orpheus) and
single-pass greedy (Kokoro IPA / phonemizer graphemes).

Copies of the JAX package's `UnigramTokenizer`, `BPETokenizer` and
`SinglePassTokenizer` (parity: reference src/tokenizer.cpp):

  * unigram: whitespace-run collapse + leading-space normalize, Viterbi
    max-score over a trie, unknown-token fallback per utf-8 step,
    consecutive unknowns merged (tokenizer.cpp:49-127). Vocab comes from
    GGUF `tokenizer.ggml.{tokens,scores,unknown_token_id,eos_token_id}`
    with '▁' already replaced by ' ' at conversion time.
  * BPE: rank-based merges with a priority queue keyed on (rank, left
    position) and stale-entry checks; text pre-split on spaces, 'Ġ' prefix
    for space-preceded chunks (tokenizer.cpp:209-289).
  * single-pass: greedy matching that tries shorter matches first, used
    both for ids and for plain splitting (tokenizer.cpp:159-194).
"""
from __future__ import annotations

import heapq
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


class BPETokenizer:
    def __init__(self, vocab: Dict[str, int], ranks: Dict[Tuple[str, str], int],
                 bos_token_id: int, eos_token_id: int):
        self.vocab = vocab
        self.ranks = ranks
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id

    def _bpe_word(self, word: str) -> List[str]:
        parts = list(word)  # python strings are utf-8-aware already
        if not parts:
            return []
        # heap of (rank, left_pos, left_idx, right_idx, joined_len)
        # mirrors the reference's priority queue + stale-entry check
        sizes = [len(p) for p in parts]
        nxt = list(range(1, len(parts))) + [-1]
        prv = [-1] + list(range(len(parts) - 1))
        pos = []
        acc = 0
        for p in parts:
            pos.append(acc)
            acc += len(p)
        heap: list = []

        def push(i, j):
            pair = (cur_str(i), cur_str(j))
            r = self.ranks.get(pair)
            if r is not None:
                heapq.heappush(heap, (r, pos[i], i, j, sizes[i] + sizes[j]))

        def cur_str(i):
            return word[pos[i]: pos[i] + sizes[i]]

        for i in range(len(parts) - 1):
            push(i, i + 1)
        while heap:
            r, _, i, j, new_size = heapq.heappop(heap)
            if sizes[i] <= 0 or sizes[j] <= 0 or new_size != sizes[i] + sizes[j]:
                continue
            # merge j into i
            sizes[i] += sizes[j]
            sizes[j] = -1
            nxt[i] = nxt[j]
            if nxt[i] != -1:
                prv[nxt[i]] = i
            if prv[i] != -1:
                push(prv[i], i)
            if nxt[i] != -1:
                push(i, nxt[i])
        out = []
        i = 0
        while i != -1:
            out.append(cur_str(i))
            i = nxt[i]
        return out

    def tokenize(self, text: str) -> List[int]:
        # Split keeping spaces; `space_prior` latches once set and is never
        # reset, and runs of spaces emit nothing — exact reference behavior
        # (tokenizer.cpp:265-275). Unknown pieces map to id 0.
        out: List[int] = []
        space_prior = False
        for chunk in re.split(r"( )", text):
            if chunk == "":
                continue
            if chunk == " ":
                space_prior = True
                continue
            word = ("Ġ" + chunk) if space_prior else chunk
            if word in self.vocab:
                out.append(self.vocab[word])
            else:
                for piece in self._bpe_word(word):
                    out.append(self.vocab.get(piece, 0))
        return out

    @classmethod
    def from_gguf(cls, reader, base: str = "tokenizer.ggml") -> "BPETokenizer":
        tokens = reader.metadata[f"{base}.tokens"]
        merges = reader.metadata[f"{base}.merges"]
        bos = int(reader.metadata[f"{base}.bos_token_id"])
        eos = int(reader.metadata[f"{base}.eos_token_id"])
        vocab = {t: i for i, t in enumerate(tokens)}
        ranks = {}
        for i, m in enumerate(merges):
            a, b = m.split(" ")
            ranks[(a, b)] = i
        return cls(vocab, ranks, bos, eos)


class SinglePassTokenizer:
    """Greedy tokenizer over a token set (Kokoro char-IPA / phonemizer
    graphemes)."""

    def __init__(self, tokens: List[str], unknown_id: int = 0):
        self.tokens = tokens
        # parity: the reference uses std::find, which returns the FIRST
        # occurrence, so a duplicated token keeps its lowest id
        self.index: Dict[str, int] = {}
        for i, t in enumerate(tokens):
            self.index.setdefault(t, i)
        self.vocab = set(tokens)
        self.max_size = max((len(t) for t in tokens), default=0)
        self.unknown_id = unknown_id

    def tokenize(self, text: str) -> List[int]:
        """Ids of `text`: at each position the SHORTEST token that matches
        (tokenizer.cpp:159-177); an unmatched character gives the unknown
        id and is skipped."""
        out: List[int] = []
        remaining = text
        while remaining:
            tid = self.unknown_id
            matched = 0
            for i in range(1, min(len(remaining), self.max_size) + 1):
                part = remaining[:i]
                if part in self.index:
                    tid = self.index[part]
                    matched = i
                    break
            remaining = remaining[matched or 1:]
            out.append(tid)
        return out

    def token_split(self, text: str) -> List[str]:
        """Greedy LONGEST-match split (tokenizer.cpp:179-194)."""
        out: List[str] = []
        remaining = text
        while remaining:
            token = remaining[:1]
            for i in range(1, len(remaining)):
                part = remaining[: i + 1]
                if part not in self.vocab:
                    break
                token = part
            out.append(token)
            remaining = remaining[len(token):]
        return out

    @classmethod
    def from_gguf(cls, reader, key: str = "phonemizer.graphemes") -> "SinglePassTokenizer":
        return cls(list(reader.metadata[key]))
