"""The comparison sees `correct` come out false, with the harness's look
for a card skipped and the rest of a run driven on the CPU, when the timed
retrieve path is broken underneath: an answer altered where it is
rendered, half of the batch left out, rows of another tenant."""
import pytest

from h100bench.harness.tiny import run_tiny, tiny_cell

SEED = 2 ** 31 + 3


def _alter_render(monkeypatch):
    import repro_torch.core.service as service
    render, calls = service.render, [0]

    def altered(triples, summaries):
        calls[0] += 1
        text = render(triples, summaries)
        return text + " (altered)" if calls[0] % 5 == 0 else text
    monkeypatch.setattr(service, "render", altered)


def _half_the_batch(monkeypatch):
    from repro_torch.core.service import MemoryService
    execute = MemoryService.execute

    def half(self, requests, plan=None):
        out = execute(self, list(requests)[: max(1, len(requests) // 2)],
                      plan=plan)
        return out
    monkeypatch.setattr(MemoryService, "execute", half)


def _foreign_rows(monkeypatch):
    from repro_torch.core.vector_index import VectorIndex
    search = VectorIndex.search_batch

    def shifted(self, *a, **kw):
        s, i = search(self, *a, **kw)
        return s, (i + 1) % max(1, self.n)
    monkeypatch.setattr(VectorIndex, "search_batch", shifted)


@pytest.mark.parametrize("fault", [_alter_render, _half_the_batch,
                                   _foreign_rows])
@pytest.mark.parametrize("name", ["mem-hybrid-b64", "mem-dense-b64"])
def test_a_broken_retrieve_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    ok, run = run_tiny(tiny_cell(name), seed=SEED, seconds=0.5)
    assert not ok
