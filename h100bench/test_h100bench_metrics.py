"""The metric arithmetic: tails over every request, rates over the window,
the K1 bound, and the readers over a synthetic trace."""
import math
import statistics

import pytest

from h100bench.harness import bounds, readers, stats
from h100bench.harness.bench import Cell, Spans
from h100bench.harness.run import Run
from h100bench.harness.trace import DeviceTrace


def test_percentile_is_over_every_value():
    xs = list(range(1, 101))            # 1..100
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 50) == 50
    # one batch of 64 requests at 500 ms and 36 at 10 ms: a tail over the
    # requests, not over the batches
    lat = [500.0] * 64 + [10.0] * 36
    assert stats.percentile(lat, 95) == 500.0
    assert stats.percentile([10.0] * 95 + [900.0] * 5, 95) == 10.0
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_is_over_the_whole_window():
    assert stats.rate(1536, 10.4) == pytest.approx(147.6923, rel=1e-6)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_uses_pythons_quartiles():
    xs = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_k1_bound_on_the_served_shape():
    # 64 queries over 2^20 labelled rows, 64 tenants of 28 rows, k = 64
    ms = bounds.topk_bound_ms(Q=64, n_labels=1 << 20, D=256, k=64,
                              rows=64 * 28, pairs=64 * 28)
    nbytes = 4 * 64 * 256 + 4 * 256 * 64 * 28 + 4 * (64 + (1 << 20)) \
        + 8 * 64 * 64
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)   # bytes bound it
    assert 0.0017 < ms < 0.0019
    # a dense product: operations bound it
    ms = bounds.topk_bound_ms(Q=64, n_labels=1 << 20, D=256, k=64,
                              rows=1 << 20, pairs=64 << 20)
    assert ms == pytest.approx(2 * 256 * (64 << 20) / 67e12 * 1e3)


def _trace(kernels, marks, window):
    t = DeviceTrace(Spans(True))
    t.kernels, t.marks, t.window_s = sorted(kernels), sorted(marks), window
    return t


def test_trace_union_gaps_and_top_ops():
    t = _trace([(0.0, 1.0, "a"), (0.4, 2.0, "b"), (3.0, 3.5, "a"),
                (6.0, 6.5, "topk_scan_kernel<1>")],
               [(0.0, 7.0, "execute"), (2.2, 2.9, "flush")], 10.0)
    assert t.busy_s() == pytest.approx(3.0)
    assert t.idle_share() == pytest.approx(0.7)
    assert t.device_s(readers.K1_KERNELS) == pytest.approx(0.5)
    assert t.top_ops()[0] == ["b", pytest.approx(1.6)]
    gaps = t.idle_gaps()
    assert gaps[0] == ["execute", pytest.approx(2.5)]
    assert gaps[1] == ["flush", pytest.approx(1.0)]   # the innermost span


def test_memory_readers_on_a_synthetic_run():
    cell = Cell("mem-hybrid-b64")
    run = Run(cell, True)
    call = dict(Q=64, n_labels=1 << 21, D=256, k=64, rows=64 * 28,
                pairs=64 * 28)
    run.facts["k1_calls"] = [call, call]
    run.device_trace = _trace([(0.0, 1e-4, "topk_scan_kernel<1,0,8>"),
                               (2e-4, 3e-4, "topk_merge_lists_kernel"),
                               (0.5, 0.6, "index_elementwise_kernel")],
                              [], 1.0)
    run.program_spans = [({"plan.sparse": 0.3, "plan.budget": 0.02}, {}),
                         ({"plan.sparse": 0.5, "plan.budget": 0.04}, {}),
                         ({"plan.sparse": 9.0, "plan.budget": 9.0},
                          {"profiled": True})]
    assert cell.reader("k1_roofline").read(run) == pytest.approx(
        100 * 2 * bounds.topk_bound_ms(**call) / 1e3 / 2e-4)
    assert cell.reader("idle_share.mem").read(run) == pytest.approx(
        100 * (1 - 0.1002))
    # host stages: the mean over the executes outside the traced slice
    assert cell.reader("sparse_ms").read(run) == pytest.approx(400.0)
    assert cell.reader("budget_ms").read(run) == pytest.approx(30.0)


def test_dense_readers_read_as_the_hybrid_ones():
    """The dense cell's split metrics (they move `retrieve_p95_ms`) read
    what their namesakes read, and its rate is the window's."""
    hybrid, dense = Cell("mem-hybrid-b64"), Cell("mem-dense-b64")
    run = Run(dense, True)
    call = dict(Q=64, n_labels=1 << 21, D=256, k=64, rows=64 * 28,
                pairs=64 * 28)
    run.facts["k1_calls"] = [call]
    run.device_trace = _trace([(0.0, 1e-4, "topk_scan_kernel<1,0,8>"),
                               (0.5, 0.6, "index_elementwise_kernel")],
                              [], 1.0)
    run.program_spans = [({"plan.budget": 0.02}, {}),
                         ({"plan.budget": 9.0}, {"profiled": True})]
    run.e2e["retrieve_per_s"] = 1931.5
    for name, twin in (("budget_ms.dense", "budget_ms"),
                       ("k1_roofline.dense", "k1_roofline"),
                       ("idle_share.dense", "idle_share.mem")):
        assert dense.reader(name).read(run) == pytest.approx(
            hybrid.reader(twin).read(run))
    assert dense.reader("budget_ms.dense").read(run) == pytest.approx(20.0)
    assert dense.reader("retrieve_per_s.dense").read(run) == 1931.5
    assert "retrieve_per_s" not in [m["name"] for m in dense.end_to_end]


def test_readers_find_nothing_and_say_so():
    run = Run(Cell("mem-dense-b64"), True)
    for m in Cell("mem-dense-b64").per_layer:
        assert Cell("mem-dense-b64").reader(m["name"]).read(run) is None
    assert readers.share(0.0, 1.0) is None
    assert not math.isnan(readers.share(1.0, 2.0))
