"""K1's share of its roofline (`core/vector_index.py` ->
`kernels/topk_mips.py`, `csrc/topk_mips.cu`): the least time of every
execute's masked top-k in the traced slice (`bounds.topk_bound_ms` of what
its inputs need) over the device time of K1's count, compact, scan and
merge kernels there."""
from h100bench.harness.readers import k1_share


def read(run):
    return k1_share(run)
