"""Minimal functional module system.

Layers describe their parameters as trees of `ParamSpec` (shape + logical
axes + init law) — nested dicts, lists and tuples.  `materialize` turns a
spec tree into the same tree of tensors, drawing every random leaf from one
`torch.Generator` in tree order (dict insertion order, then list order), so
a seed fixes every weight.  The init laws are the reference's
(`repro/common/module.py`), the recurrent mixers' uniform laws included;
the random bits are torch's, not JAX's, so a test that compares the two
packages carries one set of weights across
(`models.model_api.params_from_numpy`) instead of seeding both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | scaled_normal
    scale: float = 0.02
    dtype: Optional[torch.dtype] = None   # overrides the model param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    """`fn` applied to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves_with_names(tree: PyTree, prefix=()):
    """[(path, leaf)] in tree order: dict keys in insertion order, list and
    tuple items in order; a path is the tuple of keys and indices."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves_with_names(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_names(v, prefix + (i,))]
    return [(prefix, tree)]


def unflatten(like: PyTree, leaves) -> PyTree:
    """A tree shaped like `like` whose leaves are `leaves`, in the order
    of `leaves_with_names`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def stack(spec_tree: PyTree, n: int) -> PyTree:
    """Prepend a stacked-layers dim to every spec in the tree."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(n, *s.shape), axes=("layers", *s.axes)), spec_tree)


def _init_leaf(gen: torch.Generator, spec: ParamSpec,
               default_dtype: torch.dtype) -> torch.Tensor:
    dtype = spec.dtype or default_dtype
    dev = gen.device
    shape = tuple(spec.shape)

    def normal():
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if spec.init == "scaled_normal":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(1, fan_in))
        return normal().mul_(std).to(dtype)     # in place: one f32 temporary
    if spec.init == "normal":
        return normal().mul_(spec.scale).to(dtype)

    def uniform(lo, hi):
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        return lo + (hi - lo) * u

    if spec.init == "rglru_lambda":
        # RG-LRU Λ: uniform such that a = sigmoid(Λ) lies in [0.9, 0.999]
        u = uniform(0.9, 0.999)
        return torch.log(u / (1.0 - u)).to(dtype)
    if spec.init == "ssm_alog":
        # Mamba2 A_log: A uniform in [1, 16], stored as log A
        return torch.log(uniform(1.0, 16.0)).to(dtype)
    if spec.init == "ssm_dt_bias":
        # dt bias such that softplus(dt_bias) lies in [1e-3, 1e-1]
        dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def materialize(generator: torch.Generator, spec_tree: PyTree,
                param_dtype: torch.dtype = torch.float32) -> PyTree:
    """Spec tree -> tensor tree on the generator's device."""
    return tree_map(lambda s: _init_leaf(generator, s, param_dtype),
                    spec_tree)


# ---------------------------------------------------------------------------
# Partitioning of spec trees (the reference's `axes_of`, `spec_tree_to_
# pspecs`, `shardings_of`, `abstract`)
# ---------------------------------------------------------------------------

def axes_of(spec_tree: PyTree) -> PyTree:
    return tree_map(lambda s: s.axes, spec_tree)


def spec_tree_to_pspecs(spec_tree: PyTree, rules) -> PyTree:
    """Spec tree -> tree of `rules.spec_for` mappings (divisibility-
    guarded), the reference's PartitionSpec tree."""
    return tree_map(lambda s: rules.spec_for(s.axes, s.shape), spec_tree)


def shardings_of(spec_tree: PyTree, rules) -> PyTree:
    """Spec tree -> tree of DTensor placements on `rules.mesh`."""
    return tree_map(lambda s: rules.placements_for(s.axes, s.shape),
                    spec_tree)


def abstract(spec_tree: PyTree, param_dtype: torch.dtype = torch.float32,
             device="meta") -> PyTree:
    """Spec tree -> tensors with no storage (the meta device), the
    reference's ShapeDtypeStruct tree."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or
                                          param_dtype, device=device),
                    spec_tree)
