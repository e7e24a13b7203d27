"""The port's partitioning rules (`repro_torch.common.partitioning`) against
the reference's (`repro.common.partitioning`), with no devices: every
parameter leaf of every `ASSIGNED_ARCHS` arch at full size, and every
decode-cache entry at decode_32k, must map to the same per-dim mesh axes
on both production meshes — (16, 16) and (2, 16, 16) — under the standard
rules with FSDP off and on, the decode rules without the head_dim fallback
and the long-context rules.  The reference's meshes are its test's
`FakeMesh` (a shape dict and axis names); the port's are `MeshShape`.

The reference stacks each scanned segment's layers on a leading "layers"
axis (never sharded); the port keeps one dict per layer, so a stacked
reference leaf is compared with the same leaf of each of its layers, its
leading None dropped.  Also: the DTensor placements a mapping becomes, the
production meshes' refusal without a matching process group, and
the roofline's least-squares extrapolation against the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.common import partitioning as jpt
from repro.common.module import is_spec
from repro.configs import get_config as jget_config
from repro.models.model_api import Model as JModel
from repro_torch.common import partitioning as pt
from repro_torch.common.module import leaves_with_names
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models.config import INPUT_SHAPES, plan_segments
from repro_torch.models.model_api import Model

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """The reference test's stand-in: a shape dict and axis names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def rule_pairs(mesh_name):
    """(what, reference rules, port rules) for every rule set."""
    shape = MESHES[mesh_name]
    jm, tm = FakeMesh(shape), pt.MeshShape(dict(shape), tuple(shape))
    out = []
    for fsdp in (False, True):
        out.append((f"standard fsdp={fsdp}",
                    jpt.standard_rules(jm, fsdp=fsdp),
                    pt.standard_rules(tm, fsdp=fsdp)))
    out.append(("decode kv_replicated",
                dataclasses.replace(jpt.standard_rules(jm),
                                    head_dim_fallback=False),
                dataclasses.replace(pt.standard_rules(tm),
                                    head_dim_fallback=False)))
    out.append(("long_context", jpt.long_context_rules(jm),
                pt.long_context_rules(tm)))
    return out


def norm(spec, ndim):
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def layer_index(cfg, seg_i, blk_i, rep):
    """The port's layer number of block blk_i, repeat rep, of segment
    seg_i of the reference's plan."""
    start = 0
    for i, (period, repeats) in enumerate(plan_segments(cfg.layer_kinds())):
        if i == seg_i:
            return start + rep * len(period) + blk_i
        start += len(period) * repeats
    raise IndexError(seg_i)


def port_leaf(cfg, tree, path):
    """The port's counterpart(s) of a reference leaf path: [(leaf,
    stacked)]."""
    keys = list(path)
    if "segments" not in keys:
        node = tree
        for k in keys:
            node = node[k]
        return [(node, False)]
    i = keys.index("segments")
    seg_i, blk_i, rest = keys[i + 1], keys[i + 2], keys[i + 3:]
    owner = tree
    for k in keys[:i]:
        owner = owner[k]
    sub = cfg if i == 0 else _encoder(cfg)
    period, repeats = plan_segments(sub.layer_kinds())[seg_i]
    out = []
    for r in range(repeats):
        node = owner["layers"][layer_index(sub, seg_i, blk_i, r)]
        for k in rest:
            node = node[k]
        out.append((node, repeats > 1))
    return out


def _encoder(cfg):
    from repro_torch.models.model_api import encoder_cfg
    return encoder_cfg(cfg)


def _path_keys(path):
    out = []
    for p in path:
        out.append(p.key if hasattr(p, "key") else p.idx)
    return tuple(out)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    jspecs = JModel(jget_config(arch)).param_specs()
    cfg = get_config(arch)
    tspecs = Model(cfg).param_specs()
    jleaves = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=is_spec)[0]
    assert sum(len(port_leaf(cfg, tspecs, _path_keys(p)))
               for p, _ in jleaves) == len(leaves_with_names(tspecs))
    for what, jr, tr in rule_pairs(mesh_name):
        for path, js in jleaves:
            want = norm(jr.spec_for(js.axes, js.shape), len(js.shape))
            for ts, stacked in port_leaf(cfg, tspecs, _path_keys(path)):
                got = tr.spec_for(ts.axes, ts.shape)
                assert ((None,) + got if stacked else got) == want, (
                    arch, what, _path_keys(path))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_specs_at_decode_32k_equal_the_reference(arch, mesh_name):
    shape = INPUT_SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    cfg = get_config(arch)
    jmodel, tmodel = JModel(jget_config(arch)), Model(cfg)
    for what, jr, tr in rule_pairs(mesh_name):
        jc = jmodel.cache_pspecs(B, S, jr)
        tc = tmodel.cache_pspecs(B, S, tr)
        shapes = tmodel._cache_shape_specs(B, S, None)
        for seg_i, (period, repeats) in enumerate(
                plan_segments(cfg.layer_kinds())):
            for blk_i in range(len(period)):
                want = jc[seg_i][blk_i]
                for r in range(repeats):
                    li = layer_index(cfg, seg_i, blk_i, r)
                    assert set(tc[li]) == set(want), (arch, what, li)
                    for name, got in tc[li].items():
                        nd = len(shapes[li][name][0]) + (repeats > 1)
                        got = ((None,) + got) if repeats > 1 else got
                        assert got == norm(want[name], nd), (
                            arch, what, li, name)


def test_divisibility_guard_head_fallback_and_later_dims_lose():
    rules = pt.standard_rules(pt.MeshShape({"data": 16, "model": 16},
                                           ("data", "model")))
    # 40 heads do not divide 16: replicated, head_dim 128 takes `model`
    assert rules.spec_for(("embed", "heads", "head_dim"),
                          (5120, 40, 128)) == (None, None, "model")
    no_fb = dataclasses.replace(rules, head_dim_fallback=False)
    assert no_fb.spec_for(("embed", "heads", "head_dim"),
                          (5120, 40, 128)) == (None, None, None)
    # whisper's vocab 51865 replicates; experts then ff: ff loses `model`
    assert rules.spec_for(("vocab", "embed"), (51865, 768)) == (None, None)
    assert rules.spec_for(("experts", "embed", "ff"),
                          (16, 4096, 6400)) == ("model", None, None)
    assert rules.spec_for(("bank", None), (1 << 20, 256)) == (
        ("data", "model"), None)


def test_placements_and_local_shapes_of_a_mapping():
    from torch.distributed.tensor import Replicate, Shard
    mesh = pt.MeshShape({"pod": 2, "data": 16, "model": 16},
                        ("pod", "data", "model"))
    rules = pt.standard_rules(mesh, fsdp=True)
    spec = rules.spec_for(("embed", "heads", "head_dim"), (7168, 128, 192))
    assert spec == (("pod", "data"), "model", None)
    assert pt.placements_for(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    assert pt.local_shape(spec, (7168, 128, 192), mesh) == (224, 8, 192)
    bank = rules.spec_for(("bank",), (1 << 20,))
    assert pt.placements_for(bank, mesh) == (Shard(0),) * 3
    assert pt.placements_for((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        pt.placements_for((("model", "data"),), mesh)


def test_production_meshes_need_a_matching_process_group():
    from repro_torch.launch import mesh as mesh_lib
    assert mesh_lib.production_shape().size == 256
    assert mesh_lib.production_shape(multi_pod=True).axis_names == (
        "pod", "data", "model")
    with pytest.raises(RuntimeError, match="512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="4 ranks"):
        mesh_lib.make_host_mesh(2, 2, device_type="cpu")


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "recurrentgemma-9b",
                                  "whisper-small", "qwen3-8b"])
def test_roofline_probes_and_extrapolation_equal_the_reference(arch):
    from repro.launch import roofline as jrf
    from repro_torch.launch import roofline as trf
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert trf.probe_layer_plans(cfg) == jrf.probe_layer_plans(jcfg)
    assert trf.composition_keys(cfg) == jrf.composition_keys(jcfg)
    tp, jp = trf.probe_configs(cfg), jrf.probe_configs(jcfg)
    rng = np.random.default_rng(0)
    metrics = [{"flops": float(x), "bytes": float(y)}
               for x, y in rng.random((len(tp), 2)) * 1e12]
    got, want = trf.extrapolate(cfg, tp, metrics), jrf.extrapolate(
        jcfg, jp, metrics)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    terms = trf.roofline_terms(989e12, 3.35e12, 50e9)
    assert terms["compute_s"] == terms["memory_s"] == \
        terms["collective_s"] == 1.0


def test_spec_tree_helpers_agree_with_the_rules():
    from repro_torch.common.module import (abstract, axes_of,
                                           spec_tree_to_pspecs)
    cfg = get_config("deepseek-v3-671b")
    model = Model(cfg)
    mesh = pt.MeshShape(dict(MESHES["2x16x16"]), tuple(MESHES["2x16x16"]))
    rules = pt.standard_rules(mesh, fsdp=True)
    pspecs, places = model.param_pspecs(rules), model.param_shardings(rules)
    axes = axes_of(model.param_specs())
    tree = abstract(model.param_specs(), cfg.pdtype)
    assert spec_tree_to_pspecs(model.param_specs(), rules) == pspecs

    def at(t, path):
        for k in path:
            t = t[k]
        return t

    for path, s in leaves_with_names(model.param_specs()):
        p = at(pspecs, path)
        assert at(axes, path) == s.axes
        assert p == rules.spec_for(s.axes, s.shape)
        assert at(places, path) == pt.placements_for(p, mesh), path
        t = at(tree, path)
        assert t.device.type == "meta" and tuple(t.shape) == s.shape
        assert t.dtype == (s.dtype or cfg.pdtype)
