"""Native rule-based text -> IPA phonemizer (pure Python).

A copy of the JAX package's `text/phonemizer.py`, kept in the port so that
the port imports nothing of that package; tests hold the two to the same
output. Behavior parity with the reference's self-contained lexer phonemizer
(src/models/kokoro/phonemizer.{h,cpp}): corpus look-ahead/behind, stateful
condition flags, dictionary lookup with match-context rules, grapheme-rule
fallback (`word_phonemizer` trie keyed on current/last/next grapheme), plus
handlers for contractions, possessives, acronyms, roman numerals, verbal
number expansion (to trillions, incl. decimal points), symbol replacement,
and letter spelling.

This implementation works on Python unicode strings where the reference
works on utf-8 bytes; counts map 1 char <-> 1 utf-8 char so the semantics
coincide.

Documented divergence: reference `corpus::last` (phonemizer.cpp:289-303)
drops the final byte of the previous character (so the previous-letter check
in possessives always falls through to the "ˈɛs" branch); we return the
actual previous character, which is the evident intent.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from . import phonemizer_data as D
from .tokenizer import SinglePassTokenizer


def replace_accents(word: str) -> str:
    out = []
    for ch in word:
        if ch in D.ACCENTED_A:
            out.append("a")
        elif ch in D.ACCENTED_C:
            out.append("c")
        elif ch in D.ACCENTED_E:
            out.append("e")
        elif ch in D.ACCENTED_I:
            out.append("i")
        elif ch in D.ACCENTED_N:
            out.append("n")
        elif ch in D.ACCENTED_O:
            out.append("o")
        elif ch in D.ACCENTED_U:
            out.append("u")
        else:
            out.append(ch)
    return "".join(out)


def is_roman_numeral(ch: str) -> bool:
    return ch in D.ROMAN_NUMERAL_CHARACTERS


def can_be_roman_numeral(word: str) -> bool:
    return len(word) > 0 and all(is_roman_numeral(c) for c in word)


def is_alphabetic(ch: str) -> bool:
    return ch in D.ALPHABET


def is_numeric(ch: str) -> bool:
    return "0" <= ch <= "9"


def is_all_upper(word: str) -> bool:
    return all(c.isupper() for c in word)  # matches C isupper on ASCII words


def upper_count(word: str) -> int:
    return sum(1 for c in word if c.isupper())


def build_subthousand_phoneme(value: int) -> str:
    hundreds = value // 100
    phoneme = (D.NUMBER_PHONEMES[hundreds] + " " + D.HUNDRED_PHONEME) if hundreds > 0 else ""
    value = value % 100
    if 0 < value < 20:
        phoneme += D.NUMBER_PHONEMES[value]
    elif value > 0:
        phoneme += D.SUB_HUNDRED_NUMBERS[(value // 10) - 2]
        value = value % 10
        if value > 0:
            phoneme += " " + D.NUMBER_PHONEMES[value]
    return phoneme


def build_number_phoneme(remainder: int) -> str:
    """Verbal expansion (reference phonemizer.cpp:463-523)."""
    phoneme = ""
    started = False
    for limit, name in ((D.TRILLION, D.TRILLION_PHONEME),
                        (D.BILLION, D.BILLION_PHONEME),
                        (D.MILLION, D.MILLION_PHONEME),
                        (1000, D.THOUSAND_PHONEME)):
        if remainder > limit:
            count = remainder // limit
            remainder = remainder % limit
            part = build_subthousand_phoneme(count) + " " + name
            if not started:
                phoneme += part + "," if remainder > 0 else part
            elif remainder == 0:
                phoneme += " " + part
            else:
                phoneme += " " + part + ","
            started = True
    if remainder > 0:
        phoneme += (" " if started else "") + build_subthousand_phoneme(remainder)
    return phoneme


class Corpus:
    """Char-wise look-ahead/behind window (reference corpus, phonemizer.h:376)."""

    def __init__(self, text: str):
        self.text = text
        self.location = 0

    def next(self, count: int = 1) -> str:
        return self.text[self.location: self.location + count]

    def last(self, count: int = 1) -> str:
        start = max(0, self.location - count)
        return self.text[start: self.location]

    def pop(self, count: int = 1) -> str:
        ret = self.next(count)
        self.location += len(ret)
        return ret

    def after(self, after: int = 1, count: int = 1) -> str:
        start = self.location + after
        return self.text[start: start + count]

    def size_pop(self, n: int) -> str:
        ret = self.text[self.location: self.location + n]
        self.location += len(ret)
        return ret

    def next_in(self, val: str, accent_flag: Optional[list] = None) -> str:
        n = 0
        while True:
            ch = self.after(n) if n else self.next()
            if ch == "" or ch not in val:
                break
            if accent_flag is not None and not accent_flag[0] and \
                    ch in D.COMMON_ACCENTED_CHARACTERS:
                accent_flag[0] = True
            n += 1
        return self.next(n)

    def pop_in(self, val: str) -> str:
        return self.size_pop(len(self.next_in(val)))

    def after_until(self, after: int, val: str) -> str:
        # NOTE: mirrors the reference exactly (phonemizer.cpp:363-371),
        # including its quirk of advancing `after(n)` rather than
        # `after(after + n)` inside the loop.
        n = 0
        nafter = self.after(after)
        while nafter != "" and nafter in val:
            n += 1
            nafter = self.after(n)
        return self.after(after, n)


class Conditions:
    """Stateful lexer flags (reference conditions, phonemizer.h:358-369)."""

    def __init__(self):
        self.hyphenated = False
        self.was_all_capitalized = False
        self.was_word = False
        self.was_punctuated_acronym = False
        self.was_number = False
        self.beginning_of_clause = True

    def reset_for_clause_end(self):
        self.hyphenated = False
        self.was_punctuated_acronym = False
        self.beginning_of_clause = True
        self.was_number = False

    def reset_for_space(self):
        self.hyphenated = False
        self.was_punctuated_acronym = False
        self.was_word = False

    def update_for_word(self, word: str, allow_for_upper_check: bool = True):
        if allow_for_upper_check and not is_all_upper(word):
            self.was_all_capitalized = False
        self.was_word = True
        self.beginning_of_clause = False
        self.hyphenated = False
        self.was_number = False


class PhonemizerRule:
    __slots__ = ("rules", "value")

    def __init__(self):
        self.rules: Dict[str, "PhonemizerRule"] = {}
        self.value = ""

    def lookup_rule(self, keys: List[str], index: int) -> str:
        if index >= len(keys):
            return self.value
        found_key = keys[index]
        match = None
        for k in self.rules:
            if k == found_key:
                match = k
                break
            if k and k[0] == "*" and found_key.endswith(k[1:]):
                match = k
                break
            if k and k[-1] == "*" and found_key.startswith(k[:-1]):
                match = k
                break
        if match is not None:
            return self.rules[match].lookup_rule(keys, index + 1)
        return self.value


class WordPhonemizer:
    """Grapheme-rule fallback (reference word_phonemizer, phonemizer.h:418)."""

    def __init__(self, tokenizer: SinglePassTokenizer):
        self.tokenizer = tokenizer
        self.rules: Dict[str, PhonemizerRule] = {}

    def add_rule(self, keys: List[str], phoneme: str) -> None:
        node = None
        for i, k in enumerate(keys):
            table = node.rules if node is not None else self.rules
            if k not in table:
                table[k] = PhonemizerRule()
            node = table[k]
        if node is not None:
            node.value = phoneme

    def _lookup(self, word, current, before, after) -> str:
        if current not in self.rules:
            return ""
        return self.rules[current].lookup_rule([before, after, word], 0)

    def phonemize(self, word: str) -> str:
        word = word.lower()
        graphemes = self.tokenizer.token_split(word)
        out = []
        for i, g in enumerate(graphemes):
            before = graphemes[i - 1] if i > 0 else "^"
            after = graphemes[i + 1] if i + 1 < len(graphemes) else "$"
            out.append(self._lookup(word, g, before, after))
        return "".join(out)

    @classmethod
    def from_gguf(cls, reader) -> "WordPhonemizer":
        tok = SinglePassTokenizer.from_gguf(reader, "phonemizer.graphemes")
        wp = cls(tok)
        keys = reader.metadata["phonemizer.rules.keys"]
        phonemes = reader.metadata["phonemizer.rules.phonemes"]
        for k, p in zip(keys, phonemes):
            wp.add_rule(k.split("."), p)
        return wp


SUCCESS = 100
SUCCESS_PARTIAL = 101
FAILURE_UNFOUND = 200
FAILURE_PHONETIC = 201


class DictionaryResponse:
    def __init__(self, code: int, value: str = ""):
        self.code = code
        self.value = value
        self.expects_to_be_proceeded_by_number = False
        self.not_at_clause_end = False
        self.not_at_clause_start = False
        self.after_match = ""

    def is_successful(self) -> bool:
        return self.code < 200

    def is_match(self, text: Corpus, flags: Conditions) -> bool:
        if self.not_at_clause_end:
            chunk = text.next_in(D.NON_CLAUSE_WORD_CHARACTERS)
            after = text.after(len(chunk))
            if after in ("!", ".", "?"):
                return False
        return (text.next(len(self.after_match)) == self.after_match and
                (not self.expects_to_be_proceeded_by_number or flags.was_number) and
                (not self.not_at_clause_start or not flags.beginning_of_clause))


def response_from_string(value: str, key: str) -> DictionaryResponse:
    parts = value.split(":")
    resp = DictionaryResponse(SUCCESS_PARTIAL if len(parts) > 1 else SUCCESS,
                              parts[0])
    if len(parts) > 1:
        resp.after_match = parts[1]
    resp.expects_to_be_proceeded_by_number = key.startswith("$")
    resp.not_at_clause_start = key.startswith("#")
    resp.not_at_clause_end = key.endswith("#")
    return resp


class PhonemeDictionary:
    def __init__(self):
        self.lookup_map: Dict[str, List[DictionaryResponse]] = {}
        self.not_found = DictionaryResponse(FAILURE_UNFOUND)
        self.phonetic_fallback = DictionaryResponse(FAILURE_PHONETIC)

    def lookup(self, text: Corpus, value: str, flags: Conditions) -> DictionaryResponse:
        if value not in self.lookup_map:
            return self.not_found
        for possible in self.lookup_map[value]:
            if possible.code == SUCCESS or (
                    possible.code == SUCCESS_PARTIAL and possible.is_match(text, flags)):
                return possible
        return self.phonetic_fallback

    @classmethod
    def from_gguf(cls, reader) -> "PhonemeDictionary":
        d = cls()
        keys = reader.metadata["phonemizer.dictionary.keys"]
        values = reader.metadata["phonemizer.dictionary.values"]
        for key, vals in zip(keys, values):
            out = [response_from_string(v, key) for v in vals.split(",")]
            if key[:1] in ("$", "#"):
                key = key[1:]
            if key.endswith("#"):
                key = key[:-1]
            d.lookup_map[key] = out
        return d


def _back(output: List[str]) -> str:
    return output[-1][-1] if output and output[-1] else "\0"


class Phonemizer:
    """Router lexer (reference phonemizer, phonemizer.h:485-527)."""

    def __init__(self, dictionary: PhonemeDictionary,
                 phonetic: WordPhonemizer, preserve_punctuation: bool = True):
        self.dict = dictionary
        self.phonetic = phonetic
        self.preserve_punctuation = preserve_punctuation

    # -- top level -----------------------------------------------------------
    def text_to_phonemes(self, text: str) -> str:
        corpus = Corpus(text)
        flags = Conditions()
        output: List[str] = []
        while self._route(corpus, output, flags):
            pass
        return "".join(output)

    def _route(self, text: Corpus, output, flags) -> bool:
        nxt = text.next()
        if nxt == "":
            return False
        if nxt in D.SPACE_CHARACTERS:
            return self._handle_space(text, output, flags)
        if is_numeric(nxt):
            return self._handle_numeric(text, output, flags)
        if is_alphabetic(nxt):
            return self._handle_word(text, output, flags)
        return self._handle_punctuation(text, nxt, output, flags)

    # -- handlers ------------------------------------------------------------
    def _handle_space(self, text, output, flags) -> bool:
        flags.reset_for_space()
        text.pop_in(" \n\f\t")
        if _back(output) != " ":
            output.append(" ")
        return True

    def _append_numeric_series(self, series, output, flags) -> None:
        if flags.was_word and _back(output) != " " and not flags.hyphenated:
            output.append(" ")
        digits = [D.NUMBER_PHONEMES[ord(c) - 48] for c in series]
        output.append(" ".join(digits))
        if series:
            flags.update_for_word(series)
            flags.was_number = True

    def _handle_numeric_series(self, text, output, flags) -> bool:
        series = text.pop_in(D.NUMBER_CHARACTERS)
        self._append_numeric_series(series, output, flags)
        return True

    def _handle_numeric(self, text, output, flags) -> bool:
        """Large-number parsing incl. space/comma/period separators
        (reference phonemizer.cpp:585-696)."""
        number = text.next_in(D.COMPATIBLE_NUMERICS).strip(",. ")
        large_sep = ""
        decimal_sep = ""
        last_break = ""
        invalid = False
        count_since_break = 0
        built = ""
        for c in number:
            if is_numeric(c):
                built += c
                count_since_break += 1
            elif last_break == "":
                if count_since_break > 3:
                    decimal_sep = c
                last_break = c
                built += c
                count_since_break = 0
            elif c != last_break:
                if c == " ":
                    break
                elif count_since_break == 3 and decimal_sep == "":
                    if large_sep == "":
                        large_sep = last_break
                    decimal_sep = c
                    built += c
                    count_since_break = 0
                    last_break = c
                elif count_since_break != 3:
                    if large_sep != "":
                        invalid = True
                    break
                else:
                    break
            else:  # c == last_break
                if decimal_sep != "":
                    break
                elif count_since_break != 3:
                    invalid = True
                    break
                else:
                    large_sep = c
                    built += c
                    count_since_break = 0

        if not invalid:
            if large_sep != "" and decimal_sep == "" and count_since_break != 3:
                invalid = True
            elif count_since_break == 3 and last_break != "" and \
                    decimal_sep == "" and large_sep == "":
                large_sep = last_break
            elif count_since_break != 3 and last_break != "" and \
                    decimal_sep == "" and large_sep == "":
                decimal_sep = last_break

        if invalid:
            return self._handle_numeric_series(text, output, flags)
        if large_sep:
            built = built.replace(large_sep, "")
        if decimal_sep == ",":
            built = built.replace(",", ".")
            decimal_sep_final = "."
        else:
            decimal_sep_final = decimal_sep
        # std::stoll stops at the decimal point (phonemizer.cpp:671)
        value = int(built.split(".")[0] or "0")
        if value >= D.LARGEST_PRONOUNCABLE_NUMBER:
            return self._handle_numeric_series(text, output, flags)
        text.size_pop(len(built))
        noutput = build_number_phoneme(value)
        if noutput:
            if flags.was_word and _back(output) != " " and not flags.hyphenated:
                output.append(" ")
            output.append(noutput)
            flags.update_for_word(built)
            flags.was_number = True
        if decimal_sep_final:
            parts = built.split(decimal_sep_final)
            if len(parts) > 1 and parts[1]:
                output.append(" " + D.POINT_PHONEME + " ")
                self._append_numeric_series(parts[1], output, flags)
        return True

    def _is_acronym_like(self, text, word, flags) -> bool:
        if "." in word:
            for part in word.split("."):
                if len(part) == 0:
                    return False
                if len(part) > 1:
                    if len(part) > 2 or not (part[0].isupper() and part[1].islower()):
                        return False
            return True
        if len(word) < 4:
            return word.lower() not in D.SMALL_ENGLISH_WORDS
        if is_all_upper(word):
            # is_all_upper("") is vacuously True — matches the reference
            if flags.was_all_capitalized or \
                    is_all_upper(text.after_until(len(word) + 1, " ")):
                flags.was_all_capitalized = True
                return False
            return True
        if not is_all_upper(word) and upper_count(word) > len(word) // 2:
            return True
        return False

    def _handle_roman_numeral(self, text, output, flags) -> bool:
        nxt = text.next().lower()
        total = 0
        last_value = 0
        running = ""
        while nxt and is_roman_numeral(nxt):
            found = False
            for size in range(4, 0, -1):
                chunk = text.after(len(running), size).lower()
                if chunk in D.ROMAN_NUMERALS:
                    found = True
                    v = D.ROMAN_NUMERALS[chunk]
                    if total == 0 or last_value > v:
                        total += v
                        last_value = v
                        running += chunk
                    else:
                        return False
            if found:
                nxt = text.after(len(running)).lower()
                continue
            return False
        noutput = build_number_phoneme(total)
        if flags.was_word and _back(output) != " " and not flags.hyphenated:
            output.append(" ")
        output.append(noutput)
        text.size_pop(len(running))
        flags.update_for_word(running, False)
        flags.was_number = True
        return True

    def _handle_acronym(self, text, word, output, flags) -> bool:
        out = []
        for c in word:
            if c == ".":
                flags.was_punctuated_acronym = True
                continue
            p = D.LETTER_PHONEMES.get(c.lower())
            if p:
                out.append(p)
        text.size_pop(len(word))
        if flags.was_word and _back(output) != " " and not flags.hyphenated:
            output.append(" ")
        output.append("".join(out))
        flags.update_for_word(word, False)
        return True

    def _handle_phonetic(self, text, word, output, flags) -> bool:
        if flags.was_word and _back(output) != " " and not flags.hyphenated:
            output.append(" ")
        output.append(self.phonetic.phonemize(word))
        text.size_pop(len(word))
        flags.update_for_word(word)
        return True

    def _process_word(self, text, output, word, flags, has_accent=False) -> bool:
        response = self.dict.lookup(text, word, flags)
        if has_accent and not response.is_successful():
            word = replace_accents(word)
            response = self.dict.lookup(text, word, flags)

        if response.is_successful():
            if flags.was_word and _back(output) != " " and not flags.hyphenated:
                output.append(" ")
            flags.update_for_word(word)
            if response.code != SUCCESS:
                word = word + response.after_match
            output.append(response.value)
            text.size_pop(len(word))
            return True
        if can_be_roman_numeral(word) and is_all_upper(word) and \
                word.lower() not in D.SMALL_ENGLISH_WORDS and \
                self._handle_roman_numeral(text, output, flags):
            return True
        if self._is_acronym_like(text, word, flags):
            return self._handle_acronym(text, word, output, flags)
        if "." in word:
            accent2 = [False]
            word_part = text.next_in(D.ALPHABET + D.COMMON_ACCENTED_CHARACTERS,
                                     accent2)
            self._process_word(text, output, word_part, flags, accent2[0])
            self._handle_punctuation(text, ".", output, flags)
            output.append(" ")
            flags.reset_for_space()
            return True
        return self._handle_phonetic(text, word, output, flags)

    def _handle_word(self, text, output, flags) -> bool:
        accent = [False]
        word = text.next_in(D.WORD_CHARACTERS, accent)
        while word and word[-1] == ".":
            word = word[:-1]
        return self._process_word(text, output, word, flags, accent[0])

    def _handle_replacement(self, text, nxt, output, flags) -> bool:
        if flags.was_word and _back(output) != " " and not flags.hyphenated:
            output.append(" ")
        output.append(D.REPLACEABLE[nxt])
        flags.update_for_word(nxt)
        text.pop()
        return True

    def _handle_possession_plural(self, text, output, flags) -> bool:
        if text.next(2) == "'s":
            last = text.last()
            if last and last.lower()[0] in D.VOWELS:
                output.append("z")
            elif last in ("s", "z"):
                output.append("ᵻz")
            elif last and is_alphabetic(last[0]):
                output.append("s")
            else:
                output.append("ˈɛs")
            text.pop(2)
        else:
            text.pop()
        return True

    def _handle_contraction(self, text, output, flags) -> bool:
        text.pop()
        nxt = text.next_in(D.ALPHABET).lower()
        if nxt in D.CONTRACTION_PHONEMES:
            output.append(D.CONTRACTION_PHONEMES[nxt])
            text.pop_in(D.ALPHABET)
        return True

    def _handle_punctuation(self, text, nxt, output, flags) -> bool:
        last = text.last()
        after = text.after()
        if nxt[0] == ".":
            if flags.was_punctuated_acronym:
                flags.was_punctuated_acronym = False
                output.append(nxt)
                text.pop()
                if text.after(1, 2) == "'s":
                    return self._handle_possession_plural(text, output, flags)
                return True
            chunk = text.next_in(".")
            output.append(chunk)
            text.size_pop(len(chunk))
            return True
        if nxt == "'":
            if flags.was_word and (after == "s" or not (after and is_alphabetic(after[0]))):
                return self._handle_possession_plural(text, output, flags)
            if flags.was_word and (after in D.CONTRACTION_PHONEMES or
                                   text.after(len(nxt), 2) in D.CONTRACTION_PHONEMES):
                return self._handle_contraction(text, output, flags)
            text.pop()
            return True
        if nxt[0] == "-":
            if last == " " and after == " ":
                text.pop(2)
                flags.reset_for_space()
                return True
            if after and after[0] == "-":
                text.pop(2)
                output.append(" ")
                flags.reset_for_space()
                return True
            if not flags.beginning_of_clause and flags.was_word and \
                    after and is_alphabetic(after[0]):
                flags.hyphenated = True
                text.pop()
                return True
            text.pop()
            return True
        if nxt in D.CLAUSE_BREAKS:
            output.append(nxt)
            flags.reset_for_clause_end()
            text.pop()
            return True
        if nxt in D.NOOP_BREAKS:
            output.append(nxt)
            text.pop()
            return True
        if nxt in D.REPLACEABLE:
            return self._handle_replacement(text, nxt, output, flags)
        text.pop()
        return True

    @classmethod
    def from_gguf(cls, reader) -> "Phonemizer":
        """Load dictionary + rules from GGUF metadata keys
        phonemizer.{type,graphemes,rules.*,dictionary.*}
        (reference phonemizer_from_gguf, phonemizer.cpp:1118-1150)."""
        return cls(PhonemeDictionary.from_gguf(reader),
                   WordPhonemizer.from_gguf(reader))


class EspeakPhonemizer:
    """Optional espeak-ng path (reference espeak_wrapper). Requires an
    espeak-ng installation exposed through the `espeakng`/ctypes binding;
    raises at construction if unavailable."""

    def __init__(self, voice: str = "gmw/en-US", use_espeak_phonemes: bool = False,
                 preserve_punctuation: bool = True):
        import ctypes.util
        lib = ctypes.util.find_library("espeak-ng") or ctypes.util.find_library("espeak")
        if lib is None:
            raise RuntimeError("espeak-ng shared library not found")
        import ctypes
        self._lib = ctypes.CDLL(lib)
        self._lib.espeak_Initialize(0x02, 0, None, 0)  # AUDIO_OUTPUT_SYNCHRONOUS
        self._lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
        self.phoneme_mode = 0x01 if use_espeak_phonemes else 0x02
        self.preserve_punctuation = preserve_punctuation
        self._voice = None
        self.set_voice(voice)

    def set_voice(self, voice: str) -> None:
        """Switch the espeak voice (reference update_voice)."""
        if voice == self._voice:
            return
        self._lib.espeak_SetVoiceByName(voice.encode())
        self._voice = voice

    def text_to_phonemes(self, text: str) -> str:
        import ctypes
        out = []
        # split on stopping tokens, preserving punctuation
        # (reference phonemizer.cpp:1001-1013)
        parts: List[str] = []
        cur = ""
        for ch in text:
            if ch in D.STOPPING_TOKENS:
                parts.extend([cur, ch])
                cur = ""
            else:
                cur += ch
        if cur:
            parts.append(cur)
        i = 0
        while i < len(parts):
            seg = parts[i]
            if seg and seg not in D.STOPPING_TOKENS:
                buf = ctypes.c_char_p(seg.encode("utf-8"))
                ptr = ctypes.cast(ctypes.byref(buf), ctypes.c_void_p)
                res = self._lib.espeak_TextToPhonemes(ptr, 1, self.phoneme_mode)
                if res:
                    out.append(res.decode("utf-8").strip())
            if self.preserve_punctuation and i + 1 < len(parts) and \
                    parts[i + 1] in D.STOPPING_TOKENS:
                out.append(parts[i + 1])
            i += 2 if i + 1 < len(parts) and parts[i + 1] in D.STOPPING_TOKENS else 1
        return "".join(out)
