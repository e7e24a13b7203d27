"""The control, the reference in the precision below the configuration's
put in the program's place, comes out not correct in every cell, on the
CPU, with the harness's look for a card skipped."""
import pytest

from h100bench.harness.tiny import run_tiny, tiny_cell

SEED = 2 ** 31 + 3


@pytest.mark.parametrize("name", ["mem-hybrid-b64", "mem-dense-b64"])
def test_the_control_is_not_correct(name):
    ok, run = run_tiny(tiny_cell(name), seed=SEED, seconds=0.5, control=True)
    assert not ok
    failing = {c["name"] for c in run.compared if not c["ok"]}
    assert "dense_err" in failing
