"""Plain reference of the memory layer's text arithmetic: the hashing
tokenizer, token counts and the hash embedding, in Python and NumPy.

Frozen copies of what `repro_torch/data/tokenizer.py` and
`repro_torch/core/embedder.py` compute (FNV-1a ids into the vocabulary,
word-level splitting, per-word Gaussian vectors seeded by the word's hash,
a mean, an L2 normalisation).  Nothing here imports the program.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np

SPLIT = re.compile(r"\w+|[^\w\s]")
N_SPECIAL = 8
VOCAB = 32768

SYNONYMS = {
    "job": ["work", "works", "working", "profession", "living", "occupation",
            "career", "trade", "employed"],
    "food": ["dish", "meal", "cuisine", "eat", "eats", "eating"],
    "like": ["likes", "love", "loves", "adore", "adores", "enjoy", "enjoys",
             "favorite", "favourite", "prefer", "prefers", "into"],
    "city": ["town", "live", "lives", "living", "based", "reside", "resides",
             "moved"],
    "buy": ["bought", "buys", "purchase", "purchased", "acquired", "got"],
    "travel": ["travelled", "traveled", "went", "trip", "visit", "visited",
               "journey", "vacation"],
    "learn": ["learning", "learns", "study", "studying", "studies",
              "practicing", "picking"],
    "pet": ["animal", "adopt", "adopted", "companion"],
    "name": ["named", "called", "call"],
    "color": ["colour", "shade"],
    "hobby": ["hobbies", "pastime", "interests", "interest"],
    "when": ["month", "year", "date", "time"],
}
CANON = {w: k for k, ws in SYNONYMS.items() for w in ws}


def stable_hash(text: str, mod: int) -> int:
    """FNV-1a over the UTF-8 bytes, reduced mod `mod`."""
    h = 2166136261
    for b in text.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h % mod


def words(text: str) -> List[str]:
    return SPLIT.findall(text)


def count(text: str) -> int:
    return len(words(text))


def encode(text: str, vocab: int = VOCAB) -> List[int]:
    return [N_SPECIAL + stable_hash(w.lower(), vocab - N_SPECIAL)
            for w in words(text)]


class Embedder:
    """The hash embedding of a text: the mean of its words' vectors (a
    word's synonym class shares one vector), L2-normalised, f32."""

    def __init__(self, dim: int = 256, seed: int = 0):
        self.dim = dim
        self.seed = seed
        self._cache: Dict[str, np.ndarray] = {}

    def word_vec(self, word: str) -> np.ndarray:
        w = word.lower()
        w = CANON.get(w, w)
        v = self._cache.get(w)
        if v is None:
            rng = np.random.default_rng(stable_hash(w, 2**31) + self.seed)
            v = rng.standard_normal(self.dim).astype(np.float32)
            self._cache[w] = v
        return v

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            ws = words(t)
            if not ws:
                continue
            v = np.mean([self.word_vec(w) for w in ws], axis=0)
            n = np.linalg.norm(v)
            out[i] = v / n if n > 0 else v
        return out
