"""The port's sharding plan against the JAX package's rules.

``param_specs`` for every leaf of all ten architectures on the 16x16 and
2x16x16 meshes and with ``REPRO_DP_ONLY``'s ``__no_tp__`` axis;
``cache_specs`` and ``data_specs`` for every shape; ``batch_axes``;
``auto_microbatches`` with its environment overrides. Each is held against
``repro.sharding`` on ``tests/test_sharding.py``'s ``FakeMesh`` (a dict of
axis sizes), with no compile. A per-layer leaf of the port is held against
the reference's stacked leaf: the reference's spec is ``(None,)`` + the
port's. Also ``to_placements``' shard order, and ``constrain`` as a no-op
outside ``activation_rules`` and raising on a plain tensor inside.
"""
import os

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import steps as jsteps
from repro.sharding import batch_axes as j_batch_axes
from repro.sharding import cache_specs as j_cache_specs
from repro.sharding import data_specs as j_data_specs
from repro.sharding import param_specs as j_param_specs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.sharding import act, specs


def _reference_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices) when
    imported; the flags are put back at once so no JAX backend of this
    process starts with them."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": SINGLE, "multi": MULTI}
TPS = {"tp": "model", "dp_only": "__no_tp__"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(spec) -> tuple:
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _ref_leaves(tree) -> dict:
    """The reference's tree of specs (or shapes) -> '/'-joined path -> leaf."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in path): leaf
            for path, leaf in flat}


def _port_leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, path + (str(i),)))
        return out
    return {path: tree}


def _stacked_ref_key(path: tuple) -> tuple:
    """A port leaf's path -> (the reference's path, stacked?): a digit
    after the first component is a layer of a stack."""
    if len(path) > 1 and path[1].isdigit():
        return "/".join((path[0],) + path[2:]), True
    return "/".join(path), False


def test_arch_ids_match():
    assert list(ARCH_IDS) == list(J_ARCH_IDS) and len(ARCH_IDS) == 10
    assert list(SHAPES) == list(J_SHAPES)


@pytest.mark.parametrize("tp", sorted(TPS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_param_specs_equal_the_reference_for_every_leaf(arch, mesh, tp):
    m = MESHES[mesh]
    want = _ref_leaves(j_param_specs(jsteps.params_shape(j_get_config(arch)), m,
                                     tp=TPS[tp]))
    p_shape = steps.params_shape(get_config(arch))
    got = specs.param_specs(p_shape, m, tp=TPS[tp])
    assert list(got) == list(p_shape)
    seen = set()
    for name, spec in got.items():
        names = specs.rule_names(name)
        key = "/".join(names)
        stacked = names != name.split(".")
        ref = _norm(want[key])
        if stacked:
            assert ref[0] is None, (name, ref)
            ref = ref[1:]
        assert spec == ref, (name, spec, ref)
        seen.add(key)
    assert seen == set(want)


def test_param_specs_shard_what_the_reference_tests_name():
    got = specs.param_specs(steps.params_shape(get_config("tinyllama-1.1b")), SINGLE)
    assert got["layers.3.attn.wq.w"] == ("data", "model")
    assert got["layers.0.attn.wo.w"] == ("model", "data")
    assert got["embed.table"] == ("model", None)
    assert got["layers.0.ln1.scale"] == ()
    moe = specs.param_specs(steps.params_shape(get_config("qwen2-moe-a2.7b")), SINGLE)
    assert moe["layers.5.moe.w_gate"] == (None, "data", "model")
    assert moe["layers.5.moe.w_down"] == (None, "model", "data")
    assert moe["layers.5.moe.router.w"] == ("data", None)
    hyb = specs.param_specs(steps.params_shape(get_config("zamba2-2.7b")), SINGLE)
    assert hyb["shared_attn.attn.wq.w"] == ("data", "model")     # not stacked
    assert specs.rule_names("shared_attn.attn.wq.w") == ["shared_attn", "attn", "wq", "w"]
    assert specs.rule_names("enc_layers.3.mlp.fc1.w") == ["enc_layers", "mlp", "fc1", "w"]


def _decode_shapes():
    return [s for s in J_SHAPES if J_SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", _decode_shapes())
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, shape, mesh):
    m = MESHES[mesh]
    batch = J_SHAPES[shape].global_batch
    jspec = jsteps.input_specs(arch, shape, j_get_config(arch))
    want = _ref_leaves(j_cache_specs(jspec["cache"], m, batch))
    tspec = steps.input_specs(arch, shape, get_config(arch))
    got = _port_leaves(specs.cache_specs(tspec["cache"], m, batch))
    shapes = _port_leaves(tspec["cache"])
    ref_shapes = _ref_leaves(jspec["cache"])
    seen = set()
    for path, spec in got.items():
        key, stacked = _stacked_ref_key(path)
        ref = _norm(want[key])
        assert stacked and ref[0] is None, (path, ref)
        assert spec == ref[1:], (path, spec, ref)
        assert tuple(shapes[path].shape) == tuple(ref_shapes[key].shape)[1:]
        seen.add(key)
    assert seen == set(want)
    # data_specs of the token
    assert specs.data_specs(tspec["token"], m, batch) == \
        _norm(j_data_specs(jspec["token"], m, batch))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", [s for s in J_SHAPES if J_SHAPES[s].kind != "decode"])
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_data_specs_equal_the_reference(arch, shape, mesh):
    m = MESHES[mesh]
    batch = J_SHAPES[shape].global_batch
    want = j_data_specs(jsteps.input_specs(arch, shape, j_get_config(arch)), m, batch)
    got = specs.data_specs(steps.input_specs(arch, shape, get_config(arch)), m, batch)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == _norm(want[k]), k


def test_batch_axes_equal_the_reference():
    meshes = [SINGLE, MULTI, FakeMesh({"data": 4, "model": 2}),
              FakeMesh({"pod": 2, "data": 1, "model": 8}), FakeMesh({"model": 16})]
    for m in meshes:
        for b in (1, 2, 4, 8, 16, 24, 32, 64, 128, 256, 512, 1000):
            for inc in (False, True):
                assert specs.batch_axes(m, b, include_model=inc) == \
                    j_batch_axes(m, b, include_model=inc), (m.shape, b, inc)
    assert specs.batch_axes(SINGLE, 256) == ("data",)
    assert specs.batch_axes(MULTI, 256) == ("pod", "data")
    assert specs.batch_axes(SINGLE, 1) is None


ENV = ("REPRO_FORCE_MICRO", "REPRO_MOE_TRANSIENT_GB")


@pytest.mark.parametrize("env", [{}, {"REPRO_FORCE_MICRO": "4"},
                                 {"REPRO_MOE_TRANSIENT_GB": "0.1"},
                                 {"REPRO_MOE_TRANSIENT_GB": "4"}])
def test_auto_microbatches_equal_the_reference(env, monkeypatch):
    ref = _reference_dryrun()
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    meshes = [SINGLE, MULTI, FakeMesh({"data": 2, "model": 2})]
    for arch in J_ARCH_IDS:
        for name, shape in J_SHAPES.items():
            for m in meshes:
                got = dryrun.auto_microbatches(get_config(arch), SHAPES[name], m)
                want = ref.auto_microbatches(j_get_config(arch), shape, m)
                assert got == want, (arch, name, m.shape, env)


class _Named:
    """Enough of a DeviceMesh for ``to_placements``: its axis names."""

    def __init__(self, *names):
        self.mesh_dim_names = names


def test_to_placements_shard_order():
    multi = _Named("pod", "data", "model")
    assert specs.to_placements((("pod", "data"), None, "model"), multi) == \
        [Shard(0), Shard(0), Shard(2)]
    assert specs.to_placements(("model", "data"), _Named("data", "model")) == \
        [Shard(1), Shard(0)]
    assert specs.to_placements((), multi) == [Replicate()] * 3
    assert specs.to_placements((None, "data"), multi) == [Replicate(), Shard(1), Replicate()]
    # a dim over several axes shards pod-major, in the mesh's order; the
    # other order is not a layout DTensor's placements can say
    with pytest.raises(ValueError, match="order"):
        specs.to_placements((("data", "pod"),), multi)
    with pytest.raises(ValueError, match="twice"):
        specs.to_placements(("data", "data"), multi)
    tree = {"a": ("data", None), "b": [(None,), ("model",)]}
    named = specs.to_named(tree, _Named("data", "model"))
    assert named == {"a": [Shard(0), Replicate()],
                     "b": [[Replicate(), Replicate()], [Replicate(), Shard(0)]]}


def test_constrain_outside_rules_is_a_no_op_and_raises_on_plain_tensors_inside():
    x = torch.randn(4, 8, 16)
    assert act.constrain(x, "batch", "seq_tp", None) is x
    assert act._RULES.get() is None
    with act.activation_rules(batch="data", seq_tp="model"):
        assert act._RULES.get()["batch"] == "data"
        with pytest.raises(TypeError, match="DTensors"):
            act.constrain(x, "batch", "seq_tp", None)
    assert act._RULES.get() is None
    assert act.constrain(x, "batch") is x


def test_axes_fit_keeps_a_dividing_prefix():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert act._axes_fit(("pod", "data"), 64, sizes) == ("pod", "data")
    assert act._axes_fit(("pod", "data"), 8, sizes) == "pod"
    assert act._axes_fit("model", 6, sizes) is None
    assert act._axes_fit(None, 64, sizes) is None
    assert act._axes_fit(("data",), 32, {"data": 1}) is None


def test_split_dim_and_microbatch_on_plain_tensors_are_reshapes():
    x = torch.arange(2 * 3 * 12).reshape(2, 3, 12)
    assert torch.equal(act.split_last(x, 4, 3), x.reshape(2, 3, 4, 3))
    assert torch.equal(act.split_dim(x, 1, 3, 1), x.reshape(2, 3, 1, 12))
    b = torch.arange(8 * 5).reshape(8, 5)
    for i in range(4):
        assert torch.equal(act.microbatch(b, 4, i), b.reshape(4, 2, 5)[i])
    assert act.contiguous_stride((2, 3, 4)) == torch.empty(2, 3, 4).stride()
