"""Public entry points of the port's kernels, with the argument names of
the reference's `repro/kernels/ops.py`:

  topk_mips(queries, bank, k, *, n_valid)                            K3
  topk_mips_masked(queries, bank, q_ns, bank_ns, k, *, n_valid)       K1
  topk_mips_quant(queries, bank_i8, scales, k, *, n_valid)           K4
  topk_mips_quant_masked(queries, bank_i8, scales, q_ns, bank_ns, k,
                         *, n_valid)                                 K2
  flash_attention(q, k, v, *, causal, window, scale, prefix_len,
                  q_offset, kv_offset)                               K6
  decode_attention(q, k, v, kv_len, *, scale, window)                K5

A CPU tensor runs the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written CUDA kernel (csrc/) or the call raises.  The
reference's `block_*`/`interpret` knobs have no counterpart: the CUDA
kernels plan their own grid.
"""
from repro_torch.kernels.decode_attention import decode_attention  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.topk_mips import (topk_mips,  # noqa: F401
                                           topk_mips_masked, topk_mips_quant,
                                           topk_mips_quant_masked)
