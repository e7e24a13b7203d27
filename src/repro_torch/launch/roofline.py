"""Roofline machinery for the dry-run, as the reference's
`repro/launch/roofline.py`, with the H100 figures of `launch/mesh.py`.

The reference needs probes because XLA's cost analysis counts a scanned
layer once whatever its trip count.  Here torch counts every layer the
step runs, so the probes are not needed for correctness: they keep the
dry-run of a 61-layer model cheap.  Small probe configs (1-3 layers, or a
hybrid period, or the dense prefix plus one or two MoE layers) run under
the fake process group; each is a layer-kind composition vector, and

    metric(config) = intercept + sum over kinds of n_kind * coeff_kind

is solved by least squares and predicts the full config exactly (the
probes' compositions span the full config's vector).

Roofline terms per rank, computed from counts and datasheet figures, not
measured (H100 SXM5 80GB, 700 W):
    compute_s    = FLOPs per rank / 989e12 (bf16 dense; 67e12 for an f32
                   model)
    memory_s     = bytes per rank / 3.35e12
    collective_s = collective bytes per rank / 50e9 (InfiniBand NDR: every
                   production-mesh collective crosses nodes, launch/mesh.py)
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List

import numpy as np

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.config import ModelConfig


def probe_layer_plans(cfg: ModelConfig) -> List[Dict[str, int]]:
    """Probe configs: {'num_layers': L, 'encoder_layers': E} overrides."""
    if cfg.is_encoder_decoder:
        return [{"num_layers": 1, "encoder_layers": 1},
                {"num_layers": 2, "encoder_layers": 1},
                {"num_layers": 1, "encoder_layers": 2}]
    if cfg.hybrid_period > 0:
        p = cfg.hybrid_period
        return [{"num_layers": 1}, {"num_layers": p}, {"num_layers": 2 * p}]
    if cfg.first_k_dense > 0:
        k = cfg.first_k_dense
        return [{"num_layers": k}, {"num_layers": k + 1}, {"num_layers": k + 2}]
    return [{"num_layers": 1}, {"num_layers": 2}]


def composition_vector(cfg: ModelConfig, keys: List[str]) -> np.ndarray:
    counts = Counter(f"{m}/{f}" for m, f in cfg.layer_kinds())
    counts["_intercept"] = 1
    counts["_encoder"] = cfg.encoder_layers if cfg.is_encoder_decoder else 0
    return np.array([float(counts.get(k, 0)) for k in keys])


def composition_keys(cfg: ModelConfig) -> List[str]:
    kinds = sorted(set(f"{m}/{f}" for m, f in cfg.layer_kinds()))
    keys = ["_intercept"] + kinds
    if cfg.is_encoder_decoder:
        keys.append("_encoder")
    return keys


def probe_configs(cfg: ModelConfig) -> List[ModelConfig]:
    # mtp (deepseek) stays on: it is layer-count-constant, so it lands in
    # the intercept and the prediction includes it exactly once
    return [dataclasses.replace(cfg, **plan)
            for plan in probe_layer_plans(cfg)]


def extrapolate(cfg: ModelConfig, probe_cfgs: List[ModelConfig],
                probe_metrics: List[Dict[str, float]]) -> Dict[str, float]:
    """Least-squares solve + predict for every metric key."""
    keys = composition_keys(cfg)
    A = np.stack([composition_vector(c, keys) for c in probe_cfgs])
    target = composition_vector(cfg, keys)
    out = {}
    for name in probe_metrics[0]:
        y = np.array([m[name] for m in probe_metrics])
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        out[name] = float(max(0.0, target @ coef))
    return out


def roofline_terms(per_rank_flops: float, per_rank_bytes: float,
                   per_rank_coll_bytes: float,
                   compute_dtype: str = "bfloat16") -> Dict[str, float]:
    peak = (mesh_lib.PEAK_FLOPS_FP32 if compute_dtype == "float32"
            else mesh_lib.PEAK_FLOPS_BF16)
    terms = {"compute_s": per_rank_flops / peak,
             "memory_s": per_rank_bytes / mesh_lib.HBM_BW,
             "collective_s": per_rank_coll_bytes / mesh_lib.IB_BW}
    terms["dominant"] = max(terms, key=terms.get)
    terms["bound_s"] = max(terms["compute_s"], terms["memory_s"],
                           terms["collective_s"])
    terms["hardware"] = mesh_lib.H100_SXM5
    return terms
