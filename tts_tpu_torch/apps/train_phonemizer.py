"""train_phonemizer — derive native-phonemizer rule GGUFs from a lexicon.

The port of the JAX package's `apps/train_phonemizer.py` (the counterpart
of the reference's phonemization_training/ tool), on the port's own
tokenizer, phonemizer and GGUF writer, on the host: given (word -> IPA)
pairs from an oracle (espeak-ng through the port's `EspeakPhonemizer`, a
pronunciation dictionary file, or any callable), it induces the
grapheme-rule trie the native phonemizer consumes (keys current -> [before,
after, word] with defaults at every level) plus an exception dictionary,
and writes the `phonemizer.*` GGUF keys.

    python -m tts_tpu_torch.apps.train_phonemizer --lexicon-json lex.json \
        --export-path phonemizer.gguf

Approach (same spirit as the reference: no statistics library, iterative
rule compilation): EM-style alignment of each word's phoneme string across
its grapheme split (DP scored by accumulated chunk counts), then a rule
hierarchy — grapheme default, before-context, before+after context, and
word-specific — such that every training word reproduces exactly.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from ..gguf.writer import GGUFWriter
from ..text.phonemizer import EspeakPhonemizer, WordPhonemizer
from ..text.tokenizer import SinglePassTokenizer

DEFAULT_GRAPHEMES = (
    [chr(c) for c in range(ord("a"), ord("z") + 1)] +
    ["ch", "sh", "th", "ph", "wh", "ck", "qu", "ng", "tion", "sion", "ough",
     "igh", "oo", "ee", "ea", "ai", "ay", "oy", "ow", "ou", "au", "aw", "'"]
)

MAX_CHUNK = 6  # longest phoneme chunk one grapheme may emit


class PhonemizationTrainer:
    def __init__(self, graphemes: Optional[List[str]] = None):
        self.graphemes = list(graphemes or DEFAULT_GRAPHEMES)
        self.tokenizer = SinglePassTokenizer(["<unk>"] + self.graphemes)
        # counts[(current, before, after)][chunk] -> n
        self.counts: Dict[Tuple[str, str, str], collections.Counter] = \
            collections.defaultdict(collections.Counter)
        self.rules: List[Tuple[List[str], str]] = []
        self.dictionary: Dict[str, str] = {}

    # -- alignment -----------------------------------------------------------
    def _split(self, word: str) -> List[str]:
        return self.tokenizer.token_split(word.lower())

    def _align(self, graphemes: List[str], phoneme: str) -> Optional[List[str]]:
        """Split `phoneme` into len(graphemes) contiguous chunks maximizing
        the accumulated chunk-count score (DP)."""
        n, m = len(graphemes), len(phoneme)
        NEG = float("-inf")
        best = [[NEG] * (m + 1) for _ in range(n + 1)]
        back = [[0] * (m + 1) for _ in range(n + 1)]
        best[0][0] = 0.0
        for i in range(n):
            g = graphemes[i]
            before = graphemes[i - 1] if i > 0 else "^"
            after = graphemes[i + 1] if i + 1 < n else "$"
            counter = self.counts.get((g, before, after))
            base = self.counts.get((g, "", ""))
            for j in range(m + 1):
                if best[i][j] == NEG:
                    continue
                for k in range(j, min(j + MAX_CHUNK, m) + 1):
                    chunk = phoneme[j:k]
                    score = best[i][j] + self._chunk_score(
                        g, chunk, counter, base)
                    if score > best[i + 1][k]:
                        best[i + 1][k] = score
                        back[i + 1][k] = j
        if best[n][m] == NEG:
            return None
        chunks = []
        j = m
        for i in range(n, 0, -1):
            pj = back[i][j]
            chunks.append(phoneme[pj:j])
            j = pj
        chunks.reverse()
        return chunks

    def _chunk_score(self, g: str, chunk: str, counter, base) -> float:
        s = 0.0
        if counter and chunk in counter:
            s += 2.0 * counter[chunk]
        if base and chunk in base:
            s += base[chunk]
        if not chunk:
            s -= 0.5                      # discourage empty emissions
        if len(chunk) > 3:
            s -= 0.2 * (len(chunk) - 3)
        if chunk and g and chunk[0] == g[0]:
            s += 0.25                     # weak same-initial prior
        return s

    # -- training ------------------------------------------------------------
    def train(self, lexicon: Dict[str, str], iters: int = 3) -> None:
        """Induce rules so every (word, ipa) pair reproduces exactly."""
        items = [(w.lower(), p) for w, p in lexicon.items() if w and p]
        aligned: Dict[str, Tuple[List[str], List[str]]] = {}
        for _ in range(iters):
            self.counts.clear()
            aligned.clear()
            for word, phoneme in items:
                gs = self._split(word)
                chunks = self._align(gs, phoneme)
                if chunks is None:
                    continue
                aligned[word] = (gs, chunks)
                for i, (g, c) in enumerate(zip(gs, chunks)):
                    before = gs[i - 1] if i > 0 else "^"
                    after = gs[i + 1] if i + 1 < len(gs) else "$"
                    self.counts[(g, before, after)][c] += 1
                    self.counts[(g, before, "")][c] += 1  # (g, before, *)
                    self.counts[(g, "", "")][c] += 1

        # rule hierarchy: default per grapheme, then context refinements,
        # then word-level exact rules for residual mismatches
        defaults: Dict[str, str] = {}
        for (g, b, a), counter in self.counts.items():
            if b == "" and a == "":
                defaults[g] = counter.most_common(1)[0][0]
        self.rules = [([g], ph) for g, ph in sorted(defaults.items())]
        ctx_rule: Dict[Tuple[str, str, str], str] = {}
        for (g, b, a), counter in self.counts.items():
            if b == "" and a == "":
                continue
            top = counter.most_common(1)[0][0]
            if top != defaults.get(g, ""):
                ctx_rule[(g, b, a)] = top
                self.rules.append(([g, b, a], top))
        # exact word rules for anything not yet reproduced
        wp = self._build(self.rules)
        mismatched = []
        for word, phoneme in items:
            if word not in aligned:
                self.dictionary[word] = phoneme
            elif wp.phonemize(word) != phoneme:
                mismatched.append(word)
        for word in mismatched:
            gs, chunks = aligned[word]
            for i, (g, c) in enumerate(zip(gs, chunks)):
                before = gs[i - 1] if i > 0 else "^"
                after = gs[i + 1] if i + 1 < len(gs) else "$"
                self.rules.append(([g, before, after, word], c))
        self._add_intermediate_defaults(defaults)
        wp = self._build(self.rules)
        for word, phoneme in items:
            if word in self.dictionary:
                continue
            if wp.phonemize(word) != phoneme:
                self.dictionary[word] = phoneme

    def _add_intermediate_defaults(self, defaults: Dict[str, str]) -> None:
        """The runtime trie lookup (text/phonemizer.PhonemizerRule, mirroring
        reference phonemizer.h:404-435) descends into a matching context
        child and returns THAT node's value when deeper keys miss — it does
        not backtrack. So every internal node a rule creates needs its own
        default, or unseen contexts that share a prefix with a trained rule
        phonemize to "". Emit the count-marginal top chunk for every [g, b]
        and [g, b, a] prefix of any deeper rule that lacks an explicit
        value."""
        explicit = {tuple(keys) for keys, _ in self.rules}
        prefixes = set()
        for keys, _ in self.rules:
            for plen in (2, 3):
                if len(keys) > plen:
                    prefixes.add(tuple(keys[:plen]))
        for pfx in sorted(prefixes):
            if pfx in explicit:
                continue
            g, b = pfx[0], pfx[1]
            a = pfx[2] if len(pfx) == 3 else ""
            counter = self.counts.get((g, b, a))
            top = counter.most_common(1)[0][0] if counter else \
                defaults.get(g, "")
            self.rules.append((list(pfx), top))

    def _build(self, rules):
        wp = WordPhonemizer(SinglePassTokenizer(["<unk>"] + self.graphemes))
        for keys, ph in rules:
            wp.add_rule(keys, ph)
        return wp

    def verify(self, lexicon: Dict[str, str]) -> float:
        """Fraction of lexicon reproduced exactly by rules + dictionary."""
        wp = self._build(self.rules)
        good = 0
        for word, phoneme in lexicon.items():
            w = word.lower()
            got = self.dictionary.get(w) or wp.phonemize(w)
            good += got == phoneme
        return good / max(1, len(lexicon))

    # -- export --------------------------------------------------------------
    def export_gguf(self, path: str) -> None:
        w = GGUFWriter(path, "phonemizer")
        w.add_u32("phonemizer.type", 0)
        w.add_u32("phonemizer.phoneme_type", 1)
        w.add_array("phonemizer.graphemes", ["<unk>"] + self.graphemes)
        w.add_array("phonemizer.rules.keys",
                    [".".join(keys) for keys, _ in self.rules])
        w.add_array("phonemizer.rules.phonemes",
                    [ph for _, ph in self.rules])
        w.add_array("phonemizer.dictionary.keys",
                    sorted(self.dictionary))
        w.add_array("phonemizer.dictionary.values",
                    [self.dictionary[k] for k in sorted(self.dictionary)])
        w.write()


def lexicon_from_espeak(words: Iterable[str], voice: str = "gmw/en-US") -> Dict[str, str]:
    ph = EspeakPhonemizer(voice=voice)
    return {w: ph.text_to_phonemes(w).strip() for w in words}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="train_phonemizer")
    p.add_argument("--export-path", required=True)
    p.add_argument("--lexicon-json", default="",
                   help="JSON file of {word: ipa}; if omitted, espeak-ng is "
                        "used over --words-file / the nltk corpus")
    p.add_argument("--words-file", default="")
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args(argv)
    if args.lexicon_json:
        lexicon = json.load(open(args.lexicon_json))
    else:
        if args.words_file:
            words = [w.strip() for w in open(args.words_file) if w.strip()]
        else:
            try:
                from nltk.corpus import words as nltk_words
                words = nltk_words.words()
            except Exception:
                print("no lexicon source: pass --lexicon-json or "
                      "--words-file (nltk corpus unavailable)", file=sys.stderr)
                return 1
        lexicon = lexicon_from_espeak(words)
    trainer = PhonemizationTrainer()
    trainer.train(lexicon, iters=args.iters)
    acc = trainer.verify(lexicon)
    trainer.export_gguf(args.export_path)
    print(f"trained on {len(lexicon)} words; exact reproduction {acc:.2%}; "
          f"{len(trainer.rules)} rules, {len(trainer.dictionary)} dictionary "
          f"entries -> {args.export_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
