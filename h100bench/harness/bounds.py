"""The yardstick: the card's peaks and the least time a kernel could take.

A frozen copy of the bound arithmetic of the port's own checks
(`chip_smoke.py`'s `topk_bound_ms`): each input byte read once and each
output byte written once against the HBM rate, or the operations these
inputs need against the f32 compute rate, whichever is larger.  Peaks are
the published dense rates of one NVIDIA H100 SXM at its 700 W limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12                      # FP32 outside the tensor cores


def topk_bound_ms(Q: int, n_labels: int, D: int, k: int, rows: int,
                  pairs: int) -> float:
    """A namespace-masked top-k (K1) of Q f32 queries over a bank of
    `n_labels` labelled rows: both label vectors, the queries, each of the
    `rows` rows some query's label matches, and the (Q, k) scores and ids
    move once; 2*D flops per matching (query, row) pair."""
    bytes_moved = 4 * Q * D + 4 * D * rows + 4 * (Q + n_labels) + 8 * Q * k
    flops = 2.0 * D * pairs
    return max(bytes_moved / HBM_BYTES_PER_S,
               flops / F32_FLOPS) * 1e3
