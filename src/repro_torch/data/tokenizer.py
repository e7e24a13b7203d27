"""Deterministic hashing tokenizer.

Word-level with punctuation splitting; token ids are FNV-1a hashes into the
vocab range, so tokenization is stable across runs/processes with no vocab
file (the offline container has none).  A reversible side-table supports
decode for text that has been seen by this instance (enough for tests,
examples and the synthetic benchmark; token *counting* — the paper's Table 2
metric — needs no decoding at all).
"""
from __future__ import annotations

import re
from typing import Iterable, List

from repro_torch.common.utils import stable_hash

_SPLIT = re.compile(r"\w+|[^\w\s]")

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
N_SPECIAL = 8


class HashTokenizer:
    def __init__(self, vocab_size: int = 32768):
        assert vocab_size > N_SPECIAL
        self.vocab_size = vocab_size
        self._reverse: dict[int, str] = {}

    # -- core ------------------------------------------------------------
    def word_id(self, word: str) -> int:
        wid = N_SPECIAL + stable_hash(word.lower(), self.vocab_size - N_SPECIAL)
        self._reverse.setdefault(wid, word.lower())
        return wid

    def words(self, text: str) -> List[str]:
        return _SPLIT.findall(text)

    def encode(self, text: str, *, bos: bool = False, eos: bool = False) -> List[int]:
        ids = [self.word_id(w) for w in self.words(text)]
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i in (PAD_ID, BOS_ID, EOS_ID):
                continue
            out.append(self._reverse.get(i, "<unk>"))
        return " ".join(out)

    def count(self, text: str) -> int:
        """Token count — the Table 2 cost metric."""
        return len(self.words(text))


_DEFAULT = HashTokenizer()


def default_tokenizer() -> HashTokenizer:
    return _DEFAULT


def count_tokens(text: str) -> int:
    return _DEFAULT.count(text)
