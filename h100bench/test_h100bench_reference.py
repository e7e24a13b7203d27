"""The plain reference against the port's CPU path: the frozen generator,
extraction, tokenizer, embedding, BM25 and fusion, on tiny inputs."""
import numpy as np
import pytest
import torch

from h100bench.harness.locomo_synth import generate_conversation
from h100bench.reference import retrieval, text

SEEDS = (0, 12345, (1 << 40) - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_is_the_programs(seed):
    from repro_torch.data import locomo_synth
    a = generate_conversation(seed=seed)
    b = locomo_synth.generate_conversation(seed=seed)
    assert a.conversation_id == b.conversation_id
    assert [(s, [(m.speaker, m.text, m.timestamp) for m in ms])
            for s, ms in a.sessions] == \
        [(s, [(m.speaker, m.text, m.timestamp) for m in ms])
         for s, ms in b.sessions]
    assert [(q.question, q.answer) for q in a.questions] == \
        [(q.question, q.answer) for q in b.questions]


@pytest.mark.parametrize("seed", SEEDS)
def test_extraction_tokens_and_embedding_are_the_programs(seed):
    from repro_torch.core import HashEmbedder
    from repro_torch.core.extraction import RuleExtractor
    from repro_torch.data.tokenizer import HashTokenizer
    conv = generate_conversation(seed=seed)
    ours = retrieval.extract_sessions("ns", conv.sessions)
    theirs = [RuleExtractor().extract("ns", s, m) for s, m in conv.sessions]
    for (t1, s1), (t2, s2) in zip(ours, theirs):
        assert [t.render() for t in t1] == [t.render() for t in t2]
        assert [t.text() for t in t1] == [t.text() for t in t2]
        assert s1.render() == s2.render()
    texts = [t.text() for trs, _ in ours for t in trs]
    assert np.array_equal(text.Embedder().embed(texts),
                          HashEmbedder(device="cpu").embed_texts_np(texts))
    tok = HashTokenizer()
    for t in texts[:20] + [conv.questions[0].question]:
        assert text.encode(t) == tok.encode(t)
        assert text.count(t) == tok.count(t)


def _tenant(seed=3):
    conv = generate_conversation(seed=seed)
    return conv, retrieval.make_tenant(
        retrieval.extract_sessions("ns", conv.sessions), text.Embedder(),
        [q.question for q in conv.questions])


def test_bm25_and_fusion_are_the_programs():
    from repro_torch.core.bm25 import BM25Index
    from repro_torch.core.hybrid import rrf_fuse
    conv, tenant = _tenant()
    bm = BM25Index(device="cpu")
    bm.add(["filler text of another tenant"] * 5, namespace=1)
    bm.add([t.text() for t in tenant.triples], namespace=0)
    for q in conv.questions[:10]:
        want = retrieval.bm25_scores(tenant, q.question)
        got = bm.scores(q.question, namespace=0).numpy()[5:]
        assert np.allclose(got, want, rtol=1e-5, atol=1e-6)
        dense = retrieval.ranking(
            retrieval.dense_scores(tenant, text.Embedder().embed(
                [q.question])[0]), 64)
        sparse = retrieval.ranking(want, 64)
        assert retrieval.rrf_fuse([dense, sparse], [1.0, 0.7]) == \
            rrf_fuse([dense, sparse], weights=[1.0, 0.7])


def test_lower_precision_rounds_as_tf32_and_bf16():
    x = np.asarray([1.0 + 2 ** -12, 1.0 + 2 ** -10, 3.14159265], np.float32)
    assert retrieval._tf32(x)[0] == 1.0
    assert retrieval._tf32(x)[1] == np.float32(1.0 + 2 ** -10)
    assert np.array_equal(retrieval._bf16(x),
                          torch.tensor(x).bfloat16().float().numpy())
