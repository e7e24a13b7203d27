"""Embedding backend for triple/summary/query text.

HashEmbedder — deterministic random-projection bag-of-words embedding
(per-word Gaussian vectors keyed by the word's stable hash, idf-free mean,
L2-normalised).  Zero-training, reproducible across processes and
bit-identical to the reference package's HashEmbedder: the per-word numpy
generator, the mean and the normalisation run on the host exactly as there,
and the finished (n, dim) f32 block moves to the device in one copy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.common.utils import resolve_device, stable_hash
from repro_torch.data.tokenizer import HashTokenizer, default_tokenizer


# Small synonym lexicon: canonicalising through it is what gives the dense
# path *semantics* that the lexical BM25 path lacks (a stand-in for what a
# learned embedding model provides) — paraphrased queries match via dense
# retrieval while exact rare terms (names, objects) match via BM25, which is
# exactly the complementarity the paper's hybrid search exploits.
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
_CANON = {w: k for k, ws in SYNONYMS.items() for w in ws}


def canonicalize(word: str) -> str:
    w = word.lower()
    return _CANON.get(w, w)


class HashEmbedder:
    def __init__(self, dim: int = 256, seed: int = 0,
                 tokenizer: HashTokenizer | None = None,
                 device="cuda"):
        self.dim = dim
        self.seed = seed
        self.tokenizer = tokenizer or default_tokenizer()
        self.device = resolve_device(device)
        self._cache: dict[str, np.ndarray] = {}

    def _word_vec(self, word: str) -> np.ndarray:
        w = canonicalize(word)
        v = self._cache.get(w)
        if v is None:
            rng = np.random.default_rng(stable_hash(w, 2**31) + self.seed)
            v = rng.standard_normal(self.dim).astype(np.float32)
            self._cache[w] = v
        return v

    def embed_texts_np(self, texts: Sequence[str]) -> np.ndarray:
        """(n, dim) f32 host block — the reference's arithmetic, verbatim."""
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            words = self.tokenizer.words(t)
            if not words:
                continue
            v = np.mean([self._word_vec(w) for w in words], axis=0)
            n = np.linalg.norm(v)
            out[i] = v / n if n > 0 else v
        return out

    def embed_texts(self, texts: Sequence[str]) -> torch.Tensor:
        return torch.from_numpy(self.embed_texts_np(texts)).to(self.device)

    def embed_text(self, text: str) -> torch.Tensor:
        return self.embed_texts([text])[0]
