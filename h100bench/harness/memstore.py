"""The multi-tenant store of a memory configuration, built through the
program, and the plain reference's view of the same tenants.

Set-up, as the port's own 2^20-row checks build it: `recorded`
conversations go through `MemoryService.enqueue` / `flush` (one namespace
each, `rec-<i>`), then `templates` conversations, extracted and embedded
once by the program's `RuleExtractor` and `HashEmbedder`, are committed
through the store's commit path (`MemoryStore._apply_flush`) one namespace
each (`fill-<t>-<copy>`), round-robin over the templates, until the bank
holds `rows` rows.  The conversations come from the benchmark's own
generator at the configuration's fixed seeds (`recorded_seed`,
`template_seed`), so every `--seed` stores the same tenants and does the
same work; the seed orders them (the recorded conversations' enqueue
order and the templates' round-robin order, hence every tenant's rows and
namespace id) and draws the traffic.

Popularity is by content, the same for every seed: `ranked()` lists the
namespaces in blocks, block b holding `rec-<b>` and the b-th copy of each
template, so a popularity rank always means the same conversation.

The reference sees the same tenants by working them out again from the
conversations (its own extraction and embedding) and the same order of
rows, so that a row id the program returns means one row of one tenant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from h100bench.harness import traffic
from h100bench.harness.locomo_synth import generate_conversation

# rows committed by one `_apply_flush` of the fill
FILL_BATCH_ROWS = 1 << 17


@dataclasses.dataclass
class Data:
    """What the benchmark generated: the conversations, the seed's order of
    placing them, and, in row order, each namespace with its content."""
    recorded: list                   # Conversation by content index
    templates: list
    rec_order: List[int]             # the enqueue order of `recorded`
    tpl_order: List[int]             # the fill's round-robin order
    layout: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list)        # (namespace, "rec" | "tpl", content)

    def conversation(self, kind: str, i: int):
        return (self.recorded if kind == "rec" else self.templates)[i]

    def questions(self) -> Dict[str, List[str]]:
        return {ns: [q.question for q in self.conversation(k, i).questions]
                for ns, k, i in self.layout}

    def ranked(self) -> List[str]:
        """The namespaces by popularity rank (see the module docstring)."""
        have = {ns for ns, _, _ in self.layout}
        blocks = max(len(self.recorded), 1 + max(
            (int(ns.rsplit("-", 1)[1]) for ns in have
             if ns.startswith("fill-")), default=0))
        return [ns for b in range(blocks)
                for ns in ([f"rec-{b}"] + [f"fill-{t}-{b}" for t in
                                           range(len(self.templates))])
                if ns in have]


def generate(cfg: dict, seed: int) -> Data:
    n_rec, n_tpl = int(cfg["recorded"]), int(cfg["templates"])
    gen = traffic.rng(seed, "store")
    return Data(
        recorded=[generate_conversation(seed=int(cfg["recorded_seed"]) + i)
                  for i in range(n_rec)],
        templates=[generate_conversation(seed=int(cfg["template_seed"]) + t)
                   for t in range(n_tpl)],
        rec_order=[int(i) for i in gen.permutation(n_rec)],
        tpl_order=[int(t) for t in gen.permutation(n_tpl)])


def build(cfg: dict, seed: int, device, clock):
    """-> (MemoryService, Data) with the bank filled to cfg["rows"]."""
    import torch
    from repro_torch.core import HashEmbedder, MemoryService
    from repro_torch.core.extraction import RuleExtractor

    with clock.part("generate"):
        data = generate(cfg, seed)
    with clock.part("record"):
        svc = MemoryService(HashEmbedder(dim=cfg["dim"], device=device),
                            device=device, dim=cfg["dim"],
                            budget=cfg["budget"], top_k=cfg["top_k"],
                            dense_weight=cfg["dense_weight"],
                            sparse_weight=cfg["sparse_weight"],
                            pool=cfg["pool"])
        for i in data.rec_order:
            ns = f"rec-{i}"
            for sid, msgs in data.recorded[i].sessions:
                svc.enqueue(ns, sid, msgs)
            data.layout.append((ns, "rec", i))
        svc.flush()
        # a first read puts the bank on the device, so the fill appends in
        # place
        first = data.layout[0]
        svc.retrieve(first[0],
                     data.recorded[first[2]].questions[0].question)
    with clock.part("templates"):
        ex = RuleExtractor()
        emb = HashEmbedder(dim=cfg["dim"], device=device)
        templates = []
        for conv in data.templates:
            sessions = [ex.extract(conv.conversation_id, sid, msgs)
                        for sid, msgs in conv.sessions]
            flat = [tr for trs, _ in sessions for tr in trs]
            templates.append(
                (sessions, emb.embed_texts_np([tr.text() for tr in flat])))
    with clock.part("fill"):
        rows = int(cfg["rows"])
        j = 0
        while svc.vindex.n < rows:
            sessions, vecs, n_batch = [], [], 0
            while n_batch < FILL_BATCH_ROWS and svc.vindex.n + n_batch < rows:
                t = data.tpl_order[j % len(templates)]
                tpl_sessions, tpl_vecs = templates[t]
                ns = f"fill-{t}-{j // len(templates)}"
                sessions += [(ns, summary, trs)
                             for trs, summary in tpl_sessions]
                vecs.append(tpl_vecs)
                data.layout.append((ns, "tpl", t))
                n_batch += tpl_vecs.shape[0]
                j += 1
            svc.store._apply_flush(sessions, np.concatenate(vecs))
        if device.type == "cuda":
            torch.cuda.synchronize()
    return svc, data


class ReferenceStore:
    """The reference's tenants, worked out from the conversations alone,
    and the first row of each namespace."""

    def __init__(self, data: Data, dim: int):
        from h100bench.reference import text
        self.data = data
        self.embedder = text.Embedder(dim=dim)
        self._tenants: Dict[tuple, object] = {}
        self.offset: Dict[str, int] = {}
        n = 0
        for ns, kind, i in data.layout:
            self.offset[ns] = n
            n += self.tenant(ns).n
        self.n_rows = n

    def tenant(self, ns: str):
        from h100bench.reference import retrieval
        kind, i = self._where(ns)
        key = (kind, i) if kind == "tpl" else (kind, i, ns)
        t = self._tenants.get(key)
        if t is None:
            conv = self.data.conversation(kind, i)
            # an enqueued session's conversation id is its namespace; a
            # template keeps its own
            cid = ns if kind == "rec" else conv.conversation_id
            t = retrieval.make_tenant(
                retrieval.extract_sessions(cid, conv.sessions),
                self.embedder, [q.question for q in conv.questions])
            self._tenants[key] = t
        return t

    def _where(self, ns: str):
        kind, idx = ns.split("-")[:2]
        return ("rec" if kind == "rec" else "tpl"), int(idx)
