"""The one traffic generator: every mix is a data file of parameters
(`h100bench/traffic/<name>.json`) read by these draws, all from `--seed`.

- tenants: Zipf(`tenant_zipf`) popularity over the store's namespaces in
  its rank order (`memstore.Data.ranked`: by content, the same for every
  seed); the tenants of one batch are distinct;
- questions: uniform over the tenant's own questions.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

STREAMS = {"store": 1, "traffic": 2, "check": 4, "warmup": 5}


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one use of the seed (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 63), STREAMS[stream]])


class Tenants:
    def __init__(self, names: Sequence[str], zipf_s: float,
                 gen: np.random.Generator):
        self.names = list(names)          # by popularity rank
        w = 1.0 / np.arange(1, len(names) + 1, dtype=np.float64) ** zipf_s
        self.cdf = np.cumsum(w) / w.sum()
        self.gen = gen

    def draw(self, k: int) -> List[str]:
        """k distinct tenants, by popularity."""
        if k > len(self.names):
            raise ValueError(f"{k} tenants asked of {len(self.names)}")
        out, seen = [], set()
        while len(out) < k:
            idx = np.searchsorted(self.cdf, self.gen.random(2 * k),
                                  side="right")
            for i in idx:
                i = min(int(i), len(self.names) - 1)
                if i not in seen:
                    seen.add(i)
                    out.append(self.names[i])
                    if len(out) == k:
                        break
        return out


class Requests:
    """(tenant, question) draws from one mix."""

    def __init__(self, mix: dict, data, gen: np.random.Generator):
        self.mix = mix
        self.questions = data.questions()
        self.gen = gen
        self.tenants = Tenants(data.ranked(), float(mix["tenant_zipf"]), gen)

    def question(self, ns: str) -> str:
        qs = self.questions[ns]
        return qs[int(self.gen.integers(len(qs)))]

    def batch(self, k: int) -> List[tuple]:
        return [(ns, self.question(ns)) for ns in self.tenants.draw(k)]
