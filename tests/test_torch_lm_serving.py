"""The LM serving path of the port against the JAX package on the CPU, at
reduced size (`memori-agent` reduced to 2 layers, d_model 64, as
tests/test_serving.py): the continuous-batching `Engine` gives the JAX
engine's greedy tokens from the same weights; the three invariants of
tests/test_serving.py hold on the port; `LMEmbedder` matches the JAX
embedder; `MemoriClient.chat` over the port's service hands the LM the
same prompt as the JAX client over the JAX service and records the same
session; `LMExtractor` parses a generation identically."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import MemoriClient as JMemoriClient
from repro.core import MemoryService as JMemoryService
from repro.core.embedder import HashEmbedder as JHashEmbedder
from repro.core.embedder import LMEmbedder as JLMEmbedder
from repro.core.extraction import LMExtractor as JLMExtractor
from repro.core.extraction import Message as JMessage
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro.models.model_api import Model as JModel
from repro.serving.engine import Engine as JEngine
from repro.serving.requests import Request as JRequest
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro_torch.configs import get_config
from repro_torch.core import (HashEmbedder, LMEmbedder, LMExtractor,
                              MemoriClient, MemoryService, Message)
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.model_api import Model, params_from_numpy
from repro_torch.kernels import count_launch
from repro_torch.serving.engine import CountedGraph, Engine
from repro_torch.serving.requests import Request
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import ContinuousBatcher

PROMPTS = ["the quick brown fox jumps", "completely different words here",
           "yet another unrelated prompt", "where does the user live",
           "I adopted a hedgehog named Biscuit"]


@pytest.fixture(scope="module")
def models():
    """One set of reduced memori-agent weights in both packages."""
    jcfg = jget_config("memori-agent").reduced(layers=2, d_model=64)
    cfg = get_config("memori-agent").reduced(layers=2, d_model=64)
    jmodel = JModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = Model(cfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


def _tokenizers():
    # the reduced vocab (512): with the default 32768-id tokenizer every id
    # would clip to the last row and all prompts would look alike
    return JHashTokenizer(512), HashTokenizer(512)


def _engine(models, slots=3, max_len=48):
    _, _, model, params = models
    return Engine(model, params, max_len=max_len, slots=slots,
                  tokenizer=_tokenizers()[1])


def test_greedy_tokens_equal_the_jax_engine(models):
    jmodel, jparams, model, params = models
    jeng = JEngine(jmodel, jparams, max_len=48, slots=3,
                   tokenizer=_tokenizers()[0])
    eng = _engine(models)
    jreqs = [JRequest(jeng.tokenizer.encode(p), max_new_tokens=7)
             for p in PROMPTS]
    reqs = [Request(eng.tokenizer.encode(p), max_new_tokens=7)
            for p in PROMPTS]
    assert [r.prompt_tokens for r in reqs] == [r.prompt_tokens for r in jreqs]
    jout = JBatcher(jeng).run(jreqs)
    out = ContinuousBatcher(eng).run(reqs)
    got = [out[r.request_id].tokens for r in reqs]
    want = [jout[r.request_id].tokens for r in jreqs]
    assert got == want
    assert len({tuple(t) for t in got}) > 1     # the check discriminates
    assert eng.stats == jeng.stats


# prompts of 17-24 tokens: past the reduced recurrentgemma's 16-token local
# window, so its ring cache is prepared from S >= W and later S < W
ZOO_PROMPTS = ["I work as a translator and I live in Cusco with two cats and "
               "a parrot named Olive who sings",
               "the quick brown fox jumps over the lazy dog again and again "
               "until the farmer comes home late",
               "a short prompt here"]


@pytest.mark.parametrize("arch,window", [
    ("phi3.5-moe-42b-a6.6b", None), ("phi3.5-moe-42b-a6.6b", 8),
    ("deepseek-v3-671b", None), ("mamba2-2.7b", None),
    ("recurrentgemma-9b", None)])
def test_zoo_engine_greedy_tokens_equal_the_jax_engine(arch, window):
    """The continuous-batching engine over the rest of the zoo (MoE, MLA,
    SSM, the RG-LRU hybrid with its local-attention ring cache, phi3.5 with
    a decode window below max_len: the ring cache) gives the JAX engine's
    greedy tokens from the same weights, across slot reuse."""
    layers = 3 if arch == "recurrentgemma-9b" else 2   # (rglru, rglru, attn)
    jcfg = jget_config(arch).reduced(layers=layers, d_model=64)
    cfg = get_config(arch).reduced(layers=layers, d_model=64)
    jmodel = JModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(1))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jtok, tok = _tokenizers()
    jeng = JEngine(jmodel, jparams, max_len=48, slots=2, tokenizer=jtok,
                   window_override=window)
    eng = Engine(Model(cfg), params, max_len=48, slots=2, tokenizer=tok,
                 window_override=window)
    jreqs = [JRequest(jtok.encode(p), max_new_tokens=6) for p in ZOO_PROMPTS]
    reqs = [Request(tok.encode(p), max_new_tokens=6) for p in ZOO_PROMPTS]
    assert max(len(r.prompt_tokens) for r in reqs) > 16
    jout = JBatcher(jeng).run(jreqs)
    out = ContinuousBatcher(eng).run(reqs)
    got = [out[r.request_id].tokens for r in reqs]
    assert got == [jout[r.request_id].tokens for r in jreqs]
    assert eng.stats == jeng.stats
    layouts = set().union(*(set(c) for c in eng.caches))
    want = {"phi3.5-moe-42b-a6.6b": {"k", "v"} | ({"pos"} if window else set()),
            "deepseek-v3-671b": {"ckv", "k_rope"},
            "mamba2-2.7b": {"conv", "state"},
            "recurrentgemma-9b": {"conv", "h", "k", "v", "pos"}}[arch]
    assert layouts == want


def test_cpu_engine_builds_no_graph_and_gives_the_jax_tokens(models):
    """A CPU engine decodes eagerly through the same static input buffers
    as the CUDA one (which replays a graph of that decode) and captures
    nothing; its greedy tokens are the JAX engine's, across slot reuse."""
    jmodel, jparams, _, _ = models
    jeng = JEngine(jmodel, jparams, max_len=48, slots=2,
                   tokenizer=_tokenizers()[0])
    eng = _engine(models, slots=2)
    jreqs = [JRequest(jeng.tokenizer.encode(p), max_new_tokens=6)
             for p in PROMPTS[:3]]
    reqs = [Request(eng.tokenizer.encode(p), max_new_tokens=6)
            for p in PROMPTS[:3]]
    jout = JBatcher(jeng).run(jreqs)
    out = ContinuousBatcher(eng).run(reqs)
    assert eng.graph is None
    assert eng._inputs.device.type == "cpu"
    assert [out[r.request_id].tokens for r in reqs] == \
        [jout[r.request_id].tokens for r in jreqs]
    # the static buffers hold the last step's inputs: tokens, positions
    assert eng._inputs.dtype == torch.int32
    assert tuple(eng._inputs.shape) == (2, 2)


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: a replay runs the
    captured function's work again without its Python-side counting."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def _fake_capture(graph):
    yield graph


def test_graph_replays_count_the_captured_launches():
    """Capturing runs the step's Python once, so every kernel wrapper it
    calls counts launches that never ran: `CountedGraph` keeps them out of
    the counts and adds them on each replay — 12 K5 launches a replayed
    memori-agent step, as an eager step counts.  A launch that another
    thread makes during the capture counts once, as its own, and is not
    replayed."""
    import threading

    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import topk_mips as ttk
    kernels = (tda.decode_attention, tfa.flash_attention,
               ttk.topk_mips_masked)
    before = {f: f.launches for f in kernels}

    def step():                       # what a capture of the step records
        for _ in range(12):
            count_launch(tda.decode_attention)
        tick = threading.Thread(target=count_launch,
                                args=(ttk.topk_mips_masked,))
        tick.start()
        tick.join()
        return "logits"

    g = CountedGraph(step, graph=_FakeGraph(), capture=_fake_capture)
    assert {f: f.launches for f in kernels} == {
        **before, ttk.topk_mips_masked: before[ttk.topk_mips_masked] + 1}
    assert g.deltas == {tda.decode_attention: 12}
    for _ in range(3):
        assert g.replay() == "logits"
    assert g.graph.replays == 3
    assert tda.decode_attention.launches == before[tda.decode_attention] + 36
    assert tfa.flash_attention.launches == before[tfa.flash_attention]
    assert ttk.topk_mips_masked.launches == \
        before[ttk.topk_mips_masked] + 1
    tda.decode_attention.launches = before[tda.decode_attention]
    ttk.topk_mips_masked.launches = before[ttk.topk_mips_masked]

    def failing():
        count_launch(tda.decode_attention)
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        CountedGraph(failing, graph=_FakeGraph(), capture=_fake_capture)
    assert tda.decode_attention.launches == before[tda.decode_attention]
    count_launch(tda.decode_attention)    # the tally is closed again
    assert tda.decode_attention.launches == before[tda.decode_attention] + 1
    tda.decode_attention.launches = before[tda.decode_attention]


def test_launch_counts_add_up_across_threads():
    """Launches counted from several threads at once (a tick beside a
    capture, schedulerless frontend handlers) add up exactly."""
    import threading

    from repro_torch.kernels import topk_mips as ttk
    fn = ttk.topk_mips_masked
    before = fn.launches

    def launch():
        for _ in range(5000):
            count_launch(fn)

    threads = [threading.Thread(target=launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fn.launches == before + 40000
    fn.launches = before


def test_graph_capture_is_thread_local(monkeypatch):
    """The decode step is captured with `torch.cuda.graph` in thread-local
    mode: only the capturing thread's unsafe calls break the capture, so
    the memory layer's scheduler ticks and lifecycle daemon keep working on
    the device (on their own streams) beside it, with no lock."""
    seen = []

    @contextlib.contextmanager
    def graph(g, **kw):
        seen.append((g, kw))
        yield g

    monkeypatch.setattr(torch.cuda, "graph", graph)
    fake = _FakeGraph()
    CountedGraph(lambda: "logits", graph=fake)
    assert seen == [(fake, {"capture_error_mode": "thread_local"})]


def test_all_requests_finish(models):
    eng = _engine(models)
    reqs = [Request(eng.tokenizer.encode(f"prompt number {i}"),
                    max_new_tokens=5) for i in range(8)]
    out = ContinuousBatcher(eng).run(reqs)
    assert len(out) == 8
    assert all(len(out[r.request_id].tokens) <= 5 for r in reqs)


def test_batched_decode_matches_sequential(models):
    """Greedy decode of the same prompt must be identical whether the slot
    shares the batch with other requests or runs alone."""
    eng = _engine(models, slots=3)
    prompt = eng.tokenizer.encode(PROMPTS[0])
    solo = ContinuousBatcher(_engine(models, slots=1)).run(
        [Request(list(prompt), max_new_tokens=6)])
    solo_tokens = list(solo.values())[0].tokens
    reqs = [Request(eng.tokenizer.encode(PROMPTS[1]), max_new_tokens=6),
            Request(list(prompt), max_new_tokens=6),
            Request(eng.tokenizer.encode(PROMPTS[2]), max_new_tokens=6)]
    out = ContinuousBatcher(eng).run(reqs)
    assert out[reqs[1].request_id].tokens == solo_tokens


def test_slot_reuse_after_finish(models):
    eng = _engine(models, slots=2)
    reqs = [Request(eng.tokenizer.encode(f"req {i}"), max_new_tokens=3)
            for i in range(5)]
    out = ContinuousBatcher(eng).run(reqs)
    assert len(out) == 5
    assert eng.stats["admitted"] == 5
    assert not eng.slot_active.any()


def test_sampler_greedy_and_topk():
    logits = torch.tensor([[0.1, 2.0, -1.0, 0.5]])
    gen = torch.Generator().manual_seed(0)
    assert int(sample(logits, gen, SamplerConfig())[0]) == 1
    for _ in range(20):
        s = int(sample(logits, gen, SamplerConfig(temperature=1.0, top_k=2))[0])
        assert s in (1, 3)   # top-2 = {1, 3}
    # greedy takes the first of tied maxima, as jnp.argmax
    assert int(sample(torch.tensor([[1.0, 3.0, 3.0]]), gen,
                      SamplerConfig())[0]) == 1


def test_lm_embedder_matches_the_jax_embedder():
    jcfg = jget_config("memori-embedder").reduced(layers=2, d_model=64)
    cfg = get_config("memori-embedder").reduced(layers=2, d_model=64)
    jmodel = JModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(1))
    model = Model(cfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    texts = ["(priya; works as; botanist)", "(marco; lives in; porto)", "",
             " ".join(["word"] * 80)]                     # past max_len
    want = JLMEmbedder(jmodel, jparams, out_dim=32).embed_texts(texts)
    got = LMEmbedder(model, params, out_dim=32).embed_texts(texts)
    assert tuple(got.shape) == (4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


TURNS = ["Hi there! I am Priya.", "I work as a botanist and I live in Tallinn.",
         "I adopted a hedgehog named Biscuit."]


def test_memori_client_passes_the_same_prompt_and_records_the_same_session(
        models):
    jmodel, jparams, model, params = models
    jtok, tok = _tokenizers()
    jeng = JEngine(jmodel, jparams, max_len=160, slots=2, tokenizer=jtok)
    eng = Engine(model, params, max_len=160, slots=2, tokenizer=tok)
    seen = {"jax": [], "port": []}

    def llm(tag, engine):
        def call(prompt):
            seen[tag].append(prompt)
            return engine.generate([prompt[-300:]], max_new_tokens=4)[0]
        return call

    jsvc = JMemoryService(JHashEmbedder(), use_kernel=False)
    svc = MemoryService(HashEmbedder(device="cpu"), device="cpu")
    jclient = JMemoriClient(llm("jax", jeng), jsvc.namespace("priya/c0"),
                            user_name="Priya")
    client = MemoriClient(llm("port", eng), svc.namespace("priya/c0"),
                          user_name="Priya")
    for i, turn in enumerate(TURNS):
        assert client.chat(turn, timestamp=float(i)) == \
            jclient.chat(turn, timestamp=float(i))
    jclient.end_session(session_id="s0")
    client.end_session(session_id="s0")
    question = "What is the name of Priya's pet?"
    assert client.chat(question, timestamp=9.0) == \
        jclient.chat(question, timestamp=9.0)
    assert seen["port"] == seen["jax"]
    assert "biscuit" in seen["port"][-1]            # the recorded fact
    triples = [t.render() for t in svc.store.get("priya/c0").triples.all()]
    jtriples = [t.render() for t in jsvc.store.get("priya/c0").triples.all()]
    assert triples == jtriples and triples


def test_lm_extractor_parses_a_generation_identically():
    canned = ("(priya; works as; botanist)\n"
              "noise line (no triple here\n"
              "  (Priya ; lives in ;  Tallinn ) trailing\n"
              "SUMMARY: Priya is a botanist in Tallinn.\n"
              "(marco; likes; glass)")
    prompts = []

    def gen(prompt):
        prompts.append(prompt)
        return canned

    msgs = [("Priya", "I work as a botanist.", 3.0),
            ("assistant", "Nice!", 4.0)]
    triples, summary = LMExtractor(gen).extract(
        "c0", "s1", [Message(*m) for m in msgs])
    jtriples, jsummary = JLMExtractor(gen).extract(
        "c0", "s1", [JMessage(*m) for m in msgs])
    assert prompts[0] == prompts[1]
    assert [vars(t) for t in triples] == [vars(t) for t in jtriples]
    assert len(triples) == 3
    assert vars(summary) == vars(jsummary)
