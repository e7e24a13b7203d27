"""The comparison that decides `correct`.

Retrieval, for a sample of the requests the window answered (drawn from
the seed):

- `dense_err`: how far the dense ranking the timed path produced (read at
  `VectorIndex.search_batch`, K1's entry) departs from the exact one: the
  larger of its gap (the largest ref_sorted[j] - ref[got[j]]) and its
  scores' error (the largest |score[j] - ref[got[j]]|), over positions
  and requests, on unit-vector cosine scores;
- `sparse_err`: the same for the BM25 ranking (read at
  `BM25Index.topk_batch_dev`), over each request's largest BM25 score;
- `wrong`: requests whose answer is missing, whose rankings are not a
  ranking of the tenant's own rows (a foreign, missing or repeated row, or
  rows of exactly equal score out of row order), or whose rendered context
  or token count differs from the reference's fusion, budget and render of
  those rankings.  The fusion stage follows the program's rankings (each
  judged above against the exact ones): that is what the reference can
  compare it with exactly.

The control (`--control 1`) puts the reference in the program's place, in
the precision below the configuration's: dense scores in TF32, BM25 in
bfloat16 (each ranking with the scores it gives).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from h100bench.reference import retrieval, text


class RetrievalJudge:
    def __init__(self, ref, cfg: dict, sparse: bool):
        self.ref = ref
        self.cfg = cfg
        self.sparse = sparse
        self.dense_err = 0.0
        self.sparse_err = 0.0
        self.wrong = 0
        self.checked = 0
        self.faults: List[str] = []      # what the first wrong requests were

    def _fault(self, what: str) -> None:
        self.wrong += 1
        if len(self.faults) < 4:
            self.faults.append(what[:400])

    def _ranking(self, ns: str, got, exact: np.ndarray, low, scale: float):
        """(tenant rows, error) of one ranking: the program's `got` (its
        (scores, global rows) or None), or under `control` the reference's
        own in lower precision (`low` scores)."""
        pool = int(self.cfg["pool"])
        if low is not None:
            rows = retrieval.ranking(low, pool)
            scores = low[rows]
        elif got is None:
            return None, None
        else:
            off = self.ref.offset[ns]
            keep = [j for j, g in enumerate(got[1]) if int(g) >= 0]
            rows = [int(got[1][j]) - off for j in keep]
            scores = [got[0][j] for j in keep]
        return rows, retrieval.ranking_error(exact, rows, scores, pool, scale)

    def judge(self, ns: str, query: str, answer, dense=None, sparse=None,
              control: bool = False) -> Optional[str]:
        """One request.  `answer` is the program's (context text, token
        count) or None; `dense` / `sparse` its rankings as (scores, global
        rows) lists (ignored under `control`, where the reference's lower
        precision answers).  Returns the checked context text, or None
        where the request is wrong."""
        self.checked += 1
        tenant = self.ref.tenant(ns)
        qvec = self.ref.embedder.embed([query])[0]
        exact = retrieval.dense_scores(tenant, qvec)
        low = retrieval.dense_scores(tenant, qvec, True) if control else None
        rows, err = self._ranking(ns, dense, exact, low, 1.0)
        rankings, weights = [rows], [self.cfg["dense_weight"]]
        bad = [] if err is not None else [f"dense {rows}"]
        self.dense_err = max(self.dense_err, err or 0.0)
        if self.sparse:
            exact = retrieval.bm25_scores(tenant, query)
            low = (retrieval.bm25_scores(tenant, query, True) if control
                   else None)
            top = float(exact.max()) if exact.size else 0.0
            rows, err = self._ranking(ns, sparse, exact, low,
                                      top if top > 0 else 1.0)
            if err is None:
                bad.append(f"sparse {rows}")
            self.sparse_err = max(self.sparse_err, err or 0.0)
            rankings.append(rows)
            weights.append(self.cfg["sparse_weight"])
        if bad:
            self._fault(f"{ns} {query!r} ({tenant.n} rows): not a ranking of "
                        f"the tenant's rows in the order of its scores: "
                        f"{'; '.join(bad)}")
            return None
        want = retrieval.context(tenant, rankings, weights,
                                 int(self.cfg["top_k"]),
                                 int(self.cfg["budget"]))
        if control:
            return want
        if answer is None:
            self._fault(f"{ns} {query!r}: no answer")
            return None
        if answer[0] != want or answer[1] != text.count(want):
            diff = next((f"line {i}: got {a!r} want {b!r}" for i, (a, b)
                         in enumerate(zip(answer[0].splitlines(),
                                          want.splitlines())) if a != b),
                        "lengths differ")
            self._fault(f"{ns} {query!r}: context differs ({diff}; tokens "
                        f"{answer[1]} vs {text.count(want)}; rankings "
                        f"{rankings})")
            return None
        return want

    def compared(self, limits: dict) -> List[dict]:
        out = [_entry("dense_err", self.dense_err, limits["dense_err"])]
        if self.sparse:
            out.append(_entry("sparse_err", self.sparse_err,
                              limits["sparse_err"]))
        out.append(_entry("wrong", self.wrong, 0))
        out.append(_entry("checked", self.checked, limits["min_checked"],
                          at_least=True))
        return out


def _entry(name: str, value, limit, at_least: bool = False) -> dict:
    ok = value >= limit if at_least else value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}


def sample(n_total: int, n: int, gen: np.random.Generator,
           must: Optional[List[int]] = None) -> List[int]:
    """n indices of n_total drawn from the seed, `must` among them."""
    must = list(must or [])
    chosen = set(must)
    rest = [i for i in range(n_total) if i not in chosen]
    take = max(0, min(n - len(must), len(rest)))
    picked = gen.choice(len(rest), size=take, replace=False) if take else []
    return sorted(set(must) | {rest[int(i)] for i in picked})
