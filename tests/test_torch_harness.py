"""The paper's harness on the port: the same synthetic LoCoMo conversations
through the JAX package's MemoriMemory, AdvancedAugmentation and
baselines (jnp search, no Pallas) and the port's (device="cpu") give the
same contexts byte for byte, the same token counts and the same judged
answers; the port's `eval.locomo.evaluate` reproduces
`benchmarks.common.evaluate` question by question, and at the paper's
defaults its accuracy and tokens per query."""
import dataclasses
import os
import sys

import pytest

from repro.core import MemoriMemory as JMemoriMemory
from repro.core.augmentation import AdvancedAugmentation as JAugmentation
from repro.core.baselines import FullContextMemory as JFullContext
from repro.core.baselines import RagChunkMemory as JRag
from repro.core.embedder import HashEmbedder as JHashEmbedder
from repro.core.extraction import Message as JMessage
from repro.data.locomo_synth import generate_conversation, judge, oracle_read
from repro_torch.core import (AdvancedAugmentation, HashEmbedder,
                              MemoriMemory)
from repro_torch.core.baselines import FullContextMemory, RagChunkMemory
from repro_torch.core.extraction import Message
from repro_torch.eval import locomo

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmarks import common as jcommon  # noqa: E402

REDUCED = dict(seeds=(0,), n_sessions=4, noise_turns=30,
               conversations_per_store=2)


@pytest.fixture(scope="module")
def conv():
    return generate_conversation(seed=7, n_sessions=8, noise_turns=30)


def _feed(mem, conv, message_cls):
    out = []
    for sid, msgs in conv.sessions:
        out.append(mem.record_session(
            conv.conversation_id, sid,
            [message_cls(m.speaker, m.text, m.timestamp) for m in msgs]))
    return out


def _plain(ctx):
    return (ctx.text, ctx.token_count,
            [dataclasses.asdict(t) for t in ctx.triples],
            [dataclasses.asdict(s) for s in ctx.summaries])


@pytest.fixture(scope="module")
def memori_pair(conv):
    jm = JMemoriMemory(JHashEmbedder(), use_kernel=False)
    tm = MemoriMemory(HashEmbedder(device="cpu"), device="cpu")
    jw, tw = _feed(jm, conv, JMessage), _feed(tm, conv, Message)
    assert [[dataclasses.asdict(t) for t in trs] for trs, _ in tw] == \
        [[dataclasses.asdict(t) for t in trs] for trs, _ in jw]
    return jm, tm


def test_memori_retrieve_and_prompt_match_the_reference(memori_pair, conv):
    jm, tm = memori_pair
    queries = [q.question for q in conv.questions] + ["", "zzz unknown"]
    for q in queries:
        assert _plain(tm.retrieve(q)) == _plain(jm.retrieve(q)), q
        assert _plain(tm.retrieve(q, top_k=3)) == \
            _plain(jm.retrieve(q, top_k=3)), q
    prompt_t, ctx_t = tm.answer_prompt(queries[0])
    prompt_j, ctx_j = jm.answer_prompt(queries[0])
    assert prompt_t == prompt_j and _plain(ctx_t) == _plain(ctx_j)
    assert tm.stats() == jm.stats()
    assert MemoriMemory.render(ctx_t.triples, ctx_t.summaries) == \
        JMemoriMemory.render(ctx_j.triples, ctx_j.summaries) == ctx_t.text


def test_memori_resolves_the_job_change_like_the_reference(memori_pair,
                                                           conv):
    """tests/test_locomo.py's recency case on both packages: after the job
    change, resolve() returns the new job."""
    jm, tm = memori_pair
    sp = conv.speakers[0]
    jobs = [q for q in conv.questions
            if q.category == "single_hop" and "work as now" in q.question
            and sp in q.question]
    assert jobs                      # seed 7 plants the job change
    got = tm.resolve(f"{sp} works as")
    assert got is not None and got.object == jobs[0].answer.lower()
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jm.resolve(f"{sp} works as"))
    for q in conv.questions[:10] + [None]:
        text = q.question if q else "nothing recorded matches this"
        a, b = tm.resolve(text), jm.resolve(text)
        assert (a and dataclasses.asdict(a)) == (b and dataclasses.asdict(b))


def test_augmentation_keeps_the_alignment_of_the_reference(conv):
    """Triple id == bank row == BM25 doc id, through enqueue +
    process_pending as through ingest."""
    ja = JAugmentation(JHashEmbedder(), use_kernel=False)
    ta = AdvancedAugmentation(HashEmbedder(device="cpu"), device="cpu")
    for aug, msg in ((ja, JMessage), (ta, Message)):
        (sid, msgs), rest = conv.sessions[0], conv.sessions[1:]
        aug.ingest(conv.conversation_id, sid,
                   [msg(m.speaker, m.text, m.timestamp) for m in msgs])
        for sid, msgs in rest:
            aug.enqueue(conv.conversation_id, sid,
                        [msg(m.speaker, m.text, m.timestamp) for m in msgs])
        assert aug.stats()["pending"] == len(rest)
        assert aug.process_pending() == len(rest)
    assert ta.stats() == ja.stats()
    n = ta.vindex.n
    assert n == len(ta.triples) == len(ta.bm25) > 0
    assert (ta.vindex.bank == ja.vindex.bank).all()
    for tid in range(n):
        tr = ta.triples.get(tid)
        assert dataclasses.asdict(tr) == \
            dataclasses.asdict(ja.triples.get(tid))
        assert ta.store.row_tid(tid) == tid
    assert [s.render() for s in ta.summaries.all()] == \
        [s.render() for s in ja.summaries.all()]


@pytest.mark.parametrize("kind", ["full-context", "rag"])
def test_baselines_match_the_reference(conv, kind):
    if kind == "rag":
        jb = JRag(JHashEmbedder(), use_kernel=False)
        tb = RagChunkMemory(HashEmbedder(device="cpu"), device="cpu")
    else:
        jb, tb = JFullContext(), FullContextMemory()
    _feed(jb, conv, JMessage)
    _feed(tb, conv, Message)
    for q in conv.questions:
        want, got = jb.retrieve(q.question), tb.retrieve(q.question)
        assert (got.text, got.token_count) == (want.text, want.token_count)
    assert want.text                          # not vacuous
    if kind == "rag":
        assert tb._chunks == jb._chunks
        assert tb.vindex.n == jb.vindex.n == len(tb.bm25)


def _reference_answers(name, *, seeds, n_sessions, noise_turns,
                       conversations_per_store, budget=1300):
    """benchmarks.common.evaluate's loop, keeping every question's context
    and verdict."""
    from repro.data.locomo_synth import NAMES
    out = []
    for seed in seeds:
        mem = jcommon.build_system(name, budget=budget)
        convs = []
        for c in range(conversations_per_store):
            pair = (NAMES[(2 * c) % len(NAMES)],
                    NAMES[(2 * c + 1) % len(NAMES)])
            cv = generate_conversation(
                seed=1000 * seed + c, n_sessions=n_sessions,
                noise_turns=noise_turns, name_pair=pair)
            convs.append(cv)
            for sid, msgs in cv.sessions:
                mem.record_session(cv.conversation_id, sid, msgs)
        for cv in convs:
            for q in cv.questions:
                ctx = mem.retrieve(q.question)
                ok = judge(q, oracle_read(q, ctx.text, salt=name))
                out.append(locomo.Answered(q.question, ctx.text,
                                           ctx.token_count, ok))
    return out


def _summary(r):
    return (r.name, r.per_category, r.overall, r.unweighted, r.mean_tokens,
            r.n_questions)


@pytest.mark.parametrize("name", locomo.SYSTEMS)
def test_evaluate_answers_every_question_like_the_reference(name):
    got = locomo.evaluate(name, device="cpu", **REDUCED)
    assert got.answered == _reference_answers(name, **REDUCED)
    assert _summary(got) == _summary(jcommon.evaluate(name, **REDUCED))
    assert got.n_questions == len(got.answered) > 0


def test_memori_at_the_paper_defaults_matches_the_reference():
    """The paper's configuration: seeds (0, 1), 10 sessions, 120 noise
    turns, budget 1300, 5 conversations a store (300 questions)."""
    got = locomo.evaluate("memori", device="cpu")
    want = jcommon.evaluate("memori")
    assert _summary(got) == _summary(want)
    assert got.n_questions == 300
    assert round(100 * got.overall, 2) == 94.64
    assert round(got.mean_tokens, 1) == 498.4


def test_tables_print_from_the_results():
    """Each table's lines from a small set of results (no evaluation at the
    defaults here: the cuda run of `run_all` is chip_smoke's)."""
    results = {n: locomo.evaluate(n, device="cpu", **REDUCED)
               for n in locomo.TABLE1_SYSTEMS}
    t1, t2 = locomo.table1(results), locomo.table2(results)
    assert len(t1) == 1 + len(locomo.TABLE1_SYSTEMS)
    assert t2[-1].startswith("memori vs full-context")
    assert f"{results['memori'].mean_tokens:12.1f}" in t2[1]
    t3 = locomo.table3()
    assert len(t3) == 1 + 4
    f2 = locomo.figure2([results["memori"], results["rag"]])
    assert f2[-1].startswith("overall")
