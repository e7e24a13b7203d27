"""Logical-axis partitioning, as the reference's
`repro/common/partitioning.py`, over a torch `DeviceMesh`.

Params and activations are annotated with *logical* axis names ("vocab",
"heads", "ff", "experts", "batch", ...).  A `MeshRules` maps them to
physical mesh axes for a concrete mesh, with the reference's divisibility
guard: a logical axis shards only if its dimension divides the mesh axis
(else it is replicated — whisper's vocab 51865 on model = 16), heads that
do not divide fall back to sharding head_dim (`head_dim_fallback`), and a
physical axis used by an earlier dim is dropped from a later one.

`spec_for` returns the reference's per-dim mapping (a tuple with one entry
per tensor dim: None, a mesh axis name or a tuple of them), the same value
`jax.sharding.PartitionSpec` holds there.  `placements_for` turns it into
DTensor placements, one per mesh dim: `Shard(i)` where the mesh dim
carries tensor dim i, else `Replicate()`.  A dim sharded over several mesh
axes is split in mesh order, which is the order the rules list them in
(("pod", "data"), ("data", "model")), so chunk c of a dim lands on the rank
whose flattened coordinate is c, as `P(("data", "model"))` lays it out.

`MeshRules` reads only `mesh.shape` (a dict) and `mesh.axis_names`:
`mesh_axes(mesh)` gives both for a `DeviceMesh`, and `MeshShape(...)` for
a mesh that does not exist (the production meshes reasoned about with no
process group, as the reference's `FakeMesh` test does).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

PyTree = Any

# Logical axis vocabulary used across the model zoo.
LOGICAL_AXES = (
    "layers",      # stacked layers (the reference's scan axis) — never sharded
    "vocab",       # embedding/logits vocab dim
    "embed",       # d_model dim (FSDP shards this over the data axis)
    "heads",       # attention query heads
    "kv_heads",    # attention kv heads
    "head_dim",
    "ff",          # mlp hidden
    "experts",     # moe experts (expert parallel)
    "expert_cap",  # moe capacity dim
    "batch",       # global batch
    "seq",         # sequence dim (context parallel for long_500k)
    "state",       # ssm / rglru state channels
    "bank",        # memory-bank rows (retrieval)
    "topk",
    None,
)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    device_mesh: Any = None          # the DeviceMesh, when there is one

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def mesh_axes(mesh) -> MeshShape:
    """`MeshShape` of a `DeviceMesh` (or of a MeshShape / FakeMesh-like
    object with a `shape` dict and `axis_names`)."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                    # a torch DeviceMesh
        return MeshShape(dict(zip(names, tuple(mesh.shape))), tuple(names),
                         mesh)
    return MeshShape(dict(mesh.shape), tuple(mesh.axis_names))


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Maps logical axis names -> physical mesh axis (or None)."""

    mesh: Any                # anything with .shape (dict) and .axis_names
    rules: dict              # logical name -> physical axis | tuple | None
    # heads that don't divide the model axis fall back to sharding head_dim
    # (contraction parallelism).  Right for training; wrong for decode
    # caches (a head_dim-sharded cache is gathered every layer): the decode
    # rules of `kv_replicated` disable it and replicate.
    head_dim_fallback: bool = True

    def axis_size(self, phys) -> int:
        if phys is None:
            return 1
        if isinstance(phys, (tuple, list)):
            s = 1
            for a in phys:
                s *= self.mesh.shape[a]
            return s
        return self.mesh.shape[phys]

    def spec_for(self, logical_axes: Sequence[Optional[str]],
                 dim_sizes: Optional[Sequence[int]] = None) -> tuple:
        parts = []
        fallbacks = []   # phys of indivisible head shardings
        for i, name in enumerate(logical_axes):
            phys = self.rules.get(name) if name is not None else None
            if phys is not None and dim_sizes is not None:
                if dim_sizes[i] == 1 and self.axis_size(phys) == 1:
                    # a one-wide dim on a one-wide axis stays whole: the
                    # layout is the same, and DTensor's reshapes refuse a
                    # sharded one-wide dim (MQA's kv head on a (4, 1) mesh)
                    phys = None
                elif dim_sizes[i] % self.axis_size(phys) != 0:
                    # replicate instead of an uneven shard; heads fall back
                    # to head_dim below
                    if name in ("heads", "kv_heads"):
                        fallbacks.append(phys)
                    phys = None
            parts.append(phys)
        # split-within-head fallback: when the head count doesn't divide the
        # model axis (qwen2.5: 40 heads on model = 16; whisper: 12), shard
        # head_dim instead
        if fallbacks and not self.head_dim_fallback:
            fallbacks = []
        if fallbacks and dim_sizes is not None:
            for j, name in enumerate(logical_axes):
                if name == "head_dim" and parts[j] is None:
                    phys = fallbacks[0]
                    if dim_sizes[j] % self.axis_size(phys) == 0:
                        parts[j] = phys
                        break
        # a physical axis appears once; later dims lose
        seen: set = set()
        cleaned = []
        for phys in parts:
            flat = phys if isinstance(phys, (tuple, list)) else (phys,)
            if phys is not None and any(a in seen for a in flat):
                cleaned.append(None)
            else:
                cleaned.append(phys)
                if phys is not None:
                    seen.update(flat)
        return tuple(cleaned)

    def placements_for(self, logical_axes, dim_sizes=None):
        return placements_for(self.spec_for(logical_axes, dim_sizes),
                              self.mesh)


def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a `spec_for` mapping on `mesh`: per mesh dim,
    Shard(i) where it carries tensor dim i, else Replicate()."""
    axes = mesh_axes(mesh).axis_names
    owner = {}
    for i, phys in enumerate(spec):
        if phys is None:
            continue
        flat = tuple(phys) if isinstance(phys, (tuple, list)) else (phys,)
        order = [axes.index(a) for a in flat]
        if order != sorted(order):
            raise ValueError(f"{flat} is not in the mesh's axis order {axes}")
        for a in flat:
            owner[a] = i
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in axes)


def local_shape(spec: Sequence, shape: Sequence[int], mesh) -> tuple:
    """The shape of one rank's shard of a `shape` tensor laid out by
    `spec` (every sharded dim divides: `spec_for` guarantees it)."""
    m = mesh_axes(mesh)
    out = list(shape)
    for i, phys in enumerate(spec):
        if phys is None:
            continue
        flat = tuple(phys) if isinstance(phys, (tuple, list)) else (phys,)
        for a in flat:
            out[i] //= m.shape[a]
    return tuple(out)


def standard_rules(mesh, *, fsdp: bool = False) -> MeshRules:
    """The production mapping.

    data axis (+ pod, if present) carries batch; model axis carries tensor
    parallelism (heads / ff / experts / vocab).  With ``fsdp=True`` the
    ``embed`` axis of params additionally shards over data (ZeRO-3 style).
    """
    mesh = mesh_axes(mesh)
    axes = mesh.axis_names
    has_pod = "pod" in axes
    batch_axes = ("pod", "data") if has_pod else ("data",)
    rules = {
        "layers": None,
        "vocab": "model",
        "embed": (("pod", "data") if has_pod else "data") if fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "experts": "model",
        # the capacity dim shards over the batch axes: each data shard owns
        # its slice of every expert's buffer (GShard layout)
        "expert_cap": ("pod", "data") if has_pod else "data",
        "batch": batch_axes if len(batch_axes) > 1 else batch_axes[0],
        "seq": None,
        "state": "model",
        "bank": (("pod", "data", "model") if has_pod else ("data", "model")),
        "topk": None,
    }
    return MeshRules(mesh=mesh, rules=rules)


def long_context_rules(mesh) -> MeshRules:
    """Rules for decode at batch=1 over a 500k cache: the cache *sequence*
    shards over the data axis (context parallel)."""
    r = standard_rules(mesh)
    rules = dict(r.rules)
    rules["seq"] = "data"
    rules["batch"] = None
    return MeshRules(mesh=r.mesh, rules=rules)


def spec_tree_from_axes(axes_tree: PyTree, shapes_tree: PyTree,
                        rules: MeshRules) -> PyTree:
    """axes_tree mirrors a tree of tensors (or anything with `.shape`),
    with tuples of logical names at the leaves; returns the tree of
    `spec_for` mappings."""
    def is_axes(x):
        return isinstance(x, tuple) and (len(x) == 0 or x[0] is None
                                         or isinstance(x[0], str))

    def walk(ax, shp):
        if is_axes(ax):
            return rules.spec_for(ax, tuple(shp.shape))
        if isinstance(ax, dict):
            return {k: walk(ax[k], shp[k]) for k in ax}
        return type(ax)(walk(a, s) for a, s in zip(ax, shp))
    return walk(axes_tree, shapes_tree)


def shard_constraint(x, rules: MeshRules, *logical_axes):
    """The reference's with_sharding_constraint by logical names: a DTensor
    is redistributed to the rules' placements; a plain tensor is returned
    as it is (one device: nothing to constrain)."""
    if not isinstance(x, DTensor):
        return x
    want = placements_for(rules.spec_for(logical_axes, tuple(x.shape)),
                          x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


PATTERN_RULES: list = [
    # (regex on param path, logical axes per dim) — used by generic matchers
    (re.compile(r"embed/table$"), ("vocab", "embed")),
]


def gather_dims(x, *dims):
    """A DTensor with its tensor dims `dims` (negative allowed) replicated
    (each mesh dim that shards one of them all-gathers it); any other
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# DTensor helpers of the meshed model steps
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def replicated(x, mesh):
    """`x` as a DTensor on `mesh`: a plain tensor (the same on every rank)
    becomes a replicated one; a DTensor is returned as it is."""
    if isinstance(x, DTensor) or x is None:
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def seq_mesh_dims(x) -> tuple:
    """The mesh dims on which DTensor `x` shards its dim 1 (a cache's
    sequence: `long_context_rules`' context-parallel layout); () for a
    plain tensor."""
    if not isinstance(x, DTensor):
        return ()
    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == 1)


def attention_placements(q, kv, head_dim: int = 2):
    """(q's placements, the keys' placements, kv_slice) under which a local
    attention kernel may run on each rank's shard, per mesh dim: Shard(0)
    where q shards its batch dim; Shard(head_dim) where q and the keys both
    shard their heads (kv head k's group of query heads then sits on the
    same rank); q's heads sharded over keys every rank holds whole where a
    rank's query heads fall in whole kv-head groups or inside one (MQA's
    one head, MLA's absorbed latent, a kv-head count that does not divide
    `model`): kv_slice = (first kv head, count) of this rank's, else None;
    otherwise Replicate() — a head_dim-sharded operand (the rules' head
    fallback) is gathered first, where the reference's XLA lowers it to
    partial sums."""
    H, K = q.shape[head_dim], kv.shape[head_dim]
    coord = q.device_mesh.get_coordinate()
    qp, kp, kv_slice = [], [], None
    for i, (pq, pk) in enumerate(zip(q.placements, kv.placements)):
        heads_q = isinstance(pq, Shard) and pq.dim == head_dim
        if isinstance(pq, Shard) and pq.dim == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif heads_q and isinstance(pk, Shard) and pk.dim == head_dim:
            qp.append(Shard(head_dim))
            kp.append(Shard(head_dim))
        elif heads_q and kv_slice is None and _whole_groups(
                H // q.device_mesh.size(i), H // K):
            Hl, G = H // q.device_mesh.size(i), H // K
            kv_slice = (coord[i] * Hl // G, max(1, Hl // G))
            qp.append(Shard(head_dim))
            kp.append(Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    return tuple(qp), tuple(kp), kv_slice


def _whole_groups(local_heads: int, group: int) -> bool:
    return local_heads % group == 0 or group % local_heads == 0


def pad(x, pads, value: float = 0.0):
    """`F.pad(x, pads, value=value)`.  On a DTensor each rank pads its own
    shard under `local_map`, the padded dims gathered first and a Partial
    sum reduced: torch 2.11's DTensor mis-plans the pad of a sharded
    tensor."""
    import torch.nn.functional as F
    if not is_dtensor(x):
        return F.pad(x, pads, value=value)
    from torch.distributed.tensor.experimental import local_map
    padded = {x.dim() - 1 - i // 2 for i, n in enumerate(pads) if n}
    pl = [p if isinstance(p, Shard) and p.dim not in padded else Replicate()
          for p in x.placements]
    return local_map(lambda t: F.pad(t, pads, value=value),
                     out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh)(with_placements(x, pl))


def with_placements(x, placements):
    """DTensor `x` redistributed to `placements` (same mesh)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def batch_placements(placements):
    """The placements of a per-row companion tensor (kv_len, positions,
    slot positions): Shard(0) where `placements` shard the batch, else
    Replicate()."""
    return tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                 else Replicate() for p in placements)


def write_rows(dst, idx, value) -> None:
    """dst[b, idx[b]] = value[b] for every row b, in place: dst (B, T,
    ...), idx (B,) long, value (B, ...).  On a DTensor `dst` each rank
    writes its own shard: the rows of its batch slice, the positions of its
    sequence slice (a context-parallel cache) and its slice of the later
    dims, with `value` redistributed to match."""
    if not isinstance(dst, DTensor):
        rows = torch.arange(dst.shape[0], device=dst.device)
        dst[rows, idx] = value.to(dst.dtype)
        return
    mesh = dst.device_mesh
    if any(p.is_partial() for p in dst.placements):
        raise ValueError("write_rows: a Partial cache has no rows to write "
                         "(place the caches by the rules first)")
    vp = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
               else Shard(0) if isinstance(p, Shard) and p.dim == 0
               else Replicate() for p in dst.placements)
    v_local = with_placements(replicated(value, mesh), vp).to_local()
    i_local = with_placements(replicated(idx, mesh),
                              batch_placements(dst.placements)).to_local()
    local = dst.to_local()
    shape, offset = local_shape_and_offset(tuple(dst.shape), mesh,
                                           dst.placements)
    rows = torch.arange(shape[0], device=local.device)
    t = i_local - offset[1]
    if shape[1] == dst.shape[1]:
        local[rows, t] = v_local.to(local.dtype)
        return
    # a sequence-sharded cache: only the rank that holds the position writes
    ok = (t >= 0) & (t < shape[1])
    tc = t.clamp(0, shape[1] - 1)
    keep = local[rows, tc]
    okb = ok.view(-1, *([1] * (keep.dim() - 1)))
    local[rows, tc] = torch.where(okb, v_local.to(local.dtype), keep)


BATCH_AXES = ("pod", "data")


def batch_axes_placements(mesh, size: int, dim: int) -> list:
    """Placements that shard tensor dim `dim` (of `size`) over the mesh's
    batch axes ("pod", "data") where their product divides it, every
    other mesh dim replicated.  A one-wide dim stays whole (as
    `MeshRules.spec_for` keeps it)."""
    names = mesh.mesh_dim_names
    n = 1
    for i, name in enumerate(names):
        if name in BATCH_AXES:
            n *= mesh.size(i)
    ok = size % n == 0 and size > 1
    return [Shard(dim) if ok and name in BATCH_AXES else Replicate()
            for name in names]


def shard_local(x, mesh, placements):
    """Tensor `x`, the same on every rank, as a DTensor on `mesh` with
    `placements`: each rank keeps its own slice (no communication)."""
    shape, offset = local_shape_and_offset(tuple(x.shape), mesh, placements)
    local = x
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != x.shape[d]:
            local = local.narrow(d, o, n)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def local_shape_and_offset(shape, mesh, placements):
    """(local shape, global offset) of this rank's shard of a `shape`
    tensor laid out evenly by `placements` on `mesh` (a dim sharded over
    several mesh dims splits in mesh order).  Plain Python on the mesh's
    coordinate, so it also runs under FakeTensorMode."""
    coord = mesh.get_coordinate()
    size, off = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split evenly over {n} ranks")
            size[p.dim] //= n
            off[p.dim] += coord[i] * size[p.dim]
    return tuple(size), tuple(off)


def batch_only(x):
    """Activations between blocks, as tensor parallelism keeps them: a
    DTensor sharded on the batch axes over its leading dim (where they
    divide it), whole on every other mesh dim; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return with_placements(x, batch_axes_placements(x.device_mesh,
                                                    x.shape[0], 0))
