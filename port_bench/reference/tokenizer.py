"""The text front ends, written plainly.

Parler: a unigram tokenizer over the pieces the configuration's vocabulary
holds: the text is given a leading space and runs of whitespace become one
space; the segmentation of highest total score is taken (the vocabulary's
scores are all equal, so the one with the fewest pieces), an unknown
character scoring the unknown piece's score; consecutive unknowns merge.
Dia: bytes, [S1] / [S2] as bytes 1 / 2, a leading [S1] and a final "."
when missing.
"""
from __future__ import annotations

import re


def unigram(text: str, pieces: list, scores: list, unk: int) -> list:
    text = " " + re.sub(r"\s{2,}", " ", text)
    ids = {p: i for i, p in enumerate(pieces)}
    longest = max(len(p) for p in pieces)
    n = len(text)
    best = [(-float("inf"), None, None)] * (n + 1)   # (score, start, id)
    best[0] = (0.0, None, None)
    for end in range(1, n + 1):
        for start in range(max(0, end - longest), end):
            if best[start][0] == -float("inf"):
                continue
            piece = text[start:end]
            if piece in ids:
                s = best[start][0] + scores[ids[piece]]
            elif end - start == 1:
                s = best[start][0] + scores[unk]
            else:
                continue
            if s > best[end][0]:
                best[end] = (s, start, ids.get(piece, unk))
    out, end = [], n
    while end > 0:
        _, start, tid = best[end]
        if not (out and tid == unk and out[-1] == unk):
            out.append(tid)
        end = start
    return out[::-1]


def dia_bytes(text: str, max_len: int) -> list:
    t = text.strip()
    if not t.startswith("[S1]") and not t.startswith("[S2]"):
        t = "[S1] " + t
    if not t.endswith("."):
        t += "."
    data = t.replace("[S1]", "\x01").replace("[S2]", "\x02").encode("utf-8")
    if len(data) > max_len:
        raise ValueError(f"{len(data)} bytes exceed the encoder's {max_len}")
    return list(data)
