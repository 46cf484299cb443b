"""Prompt texts: the Harvard sentences, Parler prompts of a given token
count, Dia dialogue scripts of a given byte count, and the Parler prompt
vocabulary.

The sentences are a copy of `tts_tpu_torch/apps/perf_battery.py`
`TEST_SENTENCES` (the reference's perf_battery set). Standard library
only: the load generator's child process imports this module.
"""
from __future__ import annotations

TEST_SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "A large size in stockings is hard to sell.",
    "The boy was there when the sun rose.",
    "A rod is used to catch pink salmon.",
    "The source of the huge river is the clear spring.",
    "Kick the ball straight and follow through.",
    "Help the woman get back to her feet.",
    "A pot of tea helps to pass the evening.",
    "Smoky fires lack flame and heat.",
    "The soft cushion broke the man's fall.",
    "The salt breeze came across from the sea.",
    "The girl at the booth sold fifty bonds.",
    "The small pup gnawed a hole in the sock.",
    "The fish twisted and turned on the bent hook.",
    "Press the pants and sew a button on the vest.",
    "The swan dive was far short of perfect.",
    "The beauty of the view stunned the young boy.",
    "Two blue fish swam in the tank.",
    "Her purse was full of useless trash.",
    "The colt reared and threw the tall rider.",
    "It snowed, rained, and hailed the same morning.",
    "Read verse out loud for pleasure.",
]

WORDS = " ".join(TEST_SENTENCES).split()


def parler_prompt(start: int, n_words: int) -> str:
    """`n_words` words of the sentences read in a ring from word `start`:
    with the vocabulary below, one token a word."""
    return " ".join(WORDS[(start + i) % len(WORDS)] for i in range(n_words))


def dia_script(start: int, n_bytes: int) -> str:
    """A two-speaker script, [S1] and [S2] taking turns a sentence each from
    sentence `start`, cut at a word so that it holds at most `n_bytes`
    bytes as Dia's tokenizer counts them (each tag one byte, a final "."
    added when missing) and at least `n_bytes` - 12."""
    out, turn, i = [], 0, start
    while True:
        tag = "[S1]" if turn % 2 == 0 else "[S2]"
        words = TEST_SENTENCES[i % len(TEST_SENTENCES)].split()
        for j, w in enumerate(words):
            piece = (f"{tag} {w}" if j == 0 else w)
            trial = " ".join(out + [piece])
            if dia_bytes(trial) > n_bytes:
                return " ".join(out)
            out.append(piece)
        turn += 1
        i += 1


def dia_bytes(text: str) -> int:
    """Bytes of `text` after Dia's tokenizer: tags one byte each, a leading
    [S1] when it starts without a tag, a final "." when missing."""
    t = text.strip()
    if not t.startswith("[S1]") and not t.startswith("[S2]"):
        t = "[S1] " + t
    if not t.endswith("."):
        t += "."
    return len(t.replace("[S1]", "\x01").replace("[S2]", "\x02").encode())


SPECIALS = ["<pad>", "</s>", "<unk>"]   # T5's ids 0, 1, 2


def parler_vocab(size: int) -> list:
    """`size` pieces in T5's id order (pad, EOS, unknown first): every
    printable ASCII character alone and after a space, every word of the
    sentences after a space (one piece a word, so the segmentation with
    the fewest pieces is unique), then `<extra_id_N>` pieces that no prompt
    contains, up to flan-t5's 32128."""
    pieces = list(SPECIALS)
    seen = set(pieces)
    chars = [chr(c) for c in range(33, 127)]
    for p in chars + [" " + c for c in chars] + [" "] + \
            sorted({" " + w for w in WORDS}):
        if p not in seen:
            seen.add(p)
            pieces.append(p)
    k = 0
    while len(pieces) < size:
        pieces.append(f"<extra_id_{k}>")
        k += 1
    if len(pieces) > size:
        raise ValueError(f"{len(pieces)} pieces do not fit a vocabulary of "
                         f"{size}")
    return pieces
