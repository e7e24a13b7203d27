"""Production meshes, as the reference's `repro/launch/mesh.py`, over a torch
process group.

Single pod: (data=16, model=16) = 256 GPUs.
Multi-pod:  (pod=2, data=16, model=16) = 512 GPUs; the pod axis carries pure
data parallelism.

These are the reference's shapes and axis names, so every partition spec
stays comparable with the reference's.  Each function makes an
`init_device_mesh` over the current process group (one process per
device: `torchrun`, or the spawned ranks of a test) and raises, naming the
world size it needs, when the group's does not match.  Defined as functions
(never module-level meshes) so importing this module touches no process
group.  `production_shape` gives the same axes with no process group, for
reasoning about the production layout on one host.

Roofline constants: the H100 SXM5 80GB datasheet (NVIDIA), at its 700 W
board power.  A 16-wide `model` axis spans two 8-GPU NVLink nodes (ranks
are laid out row-major: a model group is 16 consecutive ranks), and a
`data` group strides over 16 nodes, so every collective of the production
meshes crosses InfiniBand: the roofline charges collective bytes at the
InfiniBand rate (one 400 Gb/s NDR port a GPU), the slowest link of the
ring, and NVLink's rate is kept for collectives within one node.
"""
from __future__ import annotations

from repro_torch.common.partitioning import MeshShape

# H100 SXM5 80GB (datasheet, 700 W), per GPU
H100_SXM5 = "H100 SXM5 80GB, 700 W"
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, plain FP32
HBM_BW = 3.35e12                # B/s
HBM_BYTES = 80 * 10**9          # 80 GB
NVLINK_BW = 450e9               # B/s a direction (NVLink 4, within a node)
IB_BW = 50e9                    # B/s: 400 Gb/s InfiniBand NDR, between nodes
GPUS_PER_NODE = 8


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16},
                         ("pod", "data", "model"))
    return MeshShape({"data": 16, "model": 16}, ("data", "model"))


def _make_mesh(shape: MeshShape, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = shape.size
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {tuple(shape.shape.values())} mesh needs a process group of "
            f"{need} ranks (torchrun --nproc-per-node ..., or "
            "torch.distributed.init_process_group)")
    if dist.get_world_size() != need:
        raise ValueError(
            f"a {tuple(shape.shape.values())} mesh needs a world size of "
            f"{need}; the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type,
                            tuple(shape.shape[a] for a in shape.axis_names),
                            mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    return _make_mesh(production_shape(multi_pod=multi_pod), device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type="cuda"):
    """A small (data, model) mesh over the process group's ranks (tests,
    the host demo)."""
    return _make_mesh(MeshShape({"data": data, "model": model},
                                ("data", "model")), device_type)
