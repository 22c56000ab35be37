"""The port's sharding inference (``repro_torch.launch.shardings``) and
``steps.input_specs`` against the JAX package's, shapes only.

For every leaf of all ten configs, at full width (the reference's
``jax.eval_shape`` of ``init_params`` against the port's ``meta`` init)
and at the smoke width, ``param_shardings`` at fsdp True and False gives
the reference's ``PartitionSpec`` entry for entry on duck-typed meshes of
(16, 16), (2, 16, 16), (2, 2) and (1, 4).  ``cache_shardings``,
``batch_shardings`` and ``serving_fsdp_needed`` are compared the same way
over every supported ``INPUT_SHAPES`` entry, and ``input_specs`` for
train, prefill and decode on (16, 16).  The reference's functions wrap
each spec in a ``NamedSharding``, which needs real devices: the tests
swap it, in the reference module's namespace only, for the bare spec.
Then the twins of ``tests/test_shardings_launch.py``'s policy tests and
of ``tests/test_substrate.py``'s two sharding-rule tests.
"""

import functools

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import all_configs as j_all_configs
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.launch import shardings as JSH
from repro.launch import steps as JST
from repro.models import model as JM
from repro_torch.configs import all_configs as t_all_configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as TST
from repro_torch.models import model as TM


class FakeMesh:
    """Duck-typed mesh: a shape mapping and axis names (all the spec
    functions read)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16),
          "2x2": FakeMesh(data=2, model=2),
          "1x4": FakeMesh(data=1, model=4)}
MESH = MESHES["16x16"]
NAMES = sorted(t_all_configs())


@pytest.fixture(autouse=True)
def bare_specs(monkeypatch):
    """The reference's shardings as bare specs (no devices needed)."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)


@functools.lru_cache(maxsize=None)
def _shapes(name: str, smoke: bool):
    """(reference params shapes, port ``meta`` params) of one config."""
    jcfg, tcfg = j_all_configs()[name], t_all_configs()[name]
    if smoke:
        jcfg, tcfg = jcfg.smoke_variant(), tcfg.smoke_variant()
    return (jax.eval_shape(functools.partial(JM.init_params, jcfg),
                           jax.random.PRNGKey(0)),
            TM.init_params(tcfg, None))


def _ref_leaves(tree) -> list:
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _port_leaves(specs, like) -> list:
    return SH.leaves_like(specs, like)


# ---------------------------------------------------------------------------
# Parity over every leaf of every config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_shardings_match_reference(name, mesh):
    """Full width and smoke width, fsdp True and False: every leaf's spec
    equals the reference's, and the shapes agree leaf for leaf."""
    m = MESHES[mesh]
    for smoke in (False, True):
        jshape, tshape = _shapes(name, smoke)
        assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(jshape)] \
            == [tuple(a.shape) for a in TM.pruning.flatten(tshape)]
        for fsdp in (True, False):
            want = _ref_leaves(JSH.param_shardings(jshape, m, fsdp=fsdp))
            got = _port_leaves(SH.param_shardings(tshape, m, fsdp=fsdp),
                               tshape)
            assert got == want, (name, mesh, smoke, fsdp)


@pytest.mark.parametrize("name", NAMES)
def test_cache_batch_and_serving_specs_match_reference(name):
    """Every supported input shape at full width on every mesh: the
    decode cache's and the batch's specs, and ``serving_fsdp_needed``."""
    jcfg, tcfg = j_all_configs()[name], t_all_configs()[name]
    jshape, tshape = _shapes(name, False)
    for key, shape in INPUT_SHAPES.items():
        if not TST.shape_supported(tcfg, shape):
            assert not JST.shape_supported(jcfg, J_SHAPES[key])
            continue
        jcache = JST.cache_specs(jcfg, J_SHAPES[key])
        tcache = TST.cache_specs(tcfg, shape)
        jbatch = JST.batch_specs(jcfg, J_SHAPES[key])
        tbatch = TST.batch_specs(tcfg, shape)
        for label, m in MESHES.items():
            assert _port_leaves(SH.cache_shardings(tcache, m), tcache) == \
                _ref_leaves(JSH.cache_shardings(jcache, m)), (key, label)
            assert _port_leaves(SH.batch_shardings(tbatch, m), tbatch) == \
                _ref_leaves(JSH.batch_shardings(jbatch, m)), (key, label)
            assert SH.serving_fsdp_needed(tshape, m) == \
                JSH.serving_fsdp_needed(jshape, m), (key, label)


@pytest.mark.parametrize("key", sorted(INPUT_SHAPES))
def test_input_specs_match_reference(key):
    """qwen2-7b at full width on (16, 16): the args' shapes and the in /
    out specs of ``input_specs`` equal the reference's (a train step's
    metrics replicated, prefill's outputs left to propagation)."""
    jcfg = j_all_configs()["qwen2-7b"]
    tcfg = t_all_configs()["qwen2-7b"]
    want = JST.input_specs(jcfg, J_SHAPES[key], MESH)
    got = TST.input_specs(tcfg, INPUT_SHAPES[key], MESH)
    assert callable(got["step"])
    jargs, targs = want["args"], got["args"]
    assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(jargs)] == \
        [tuple(a.shape) for a in TM.pruning.flatten(targs)]
    assert all(a.device.type == "meta" for a in TM.pruning.flatten(targs))
    for r, t, a in zip(want["in_shardings"], got["in_specs"], targs):
        assert _port_leaves(t, a) == _ref_leaves(r)
    if want["out_shardings"] is None:
        assert got["out_specs"] is None
        return
    (r_first, r_second), (t_first, t_second) = (want["out_shardings"],
                                                got["out_specs"])
    if INPUT_SHAPES[key].mode == "train":
        assert _port_leaves(t_first, targs[0]) == _ref_leaves(r_first)
        assert t_second == {k: tuple(v) for k, v in r_second.items()}
    else:
        assert r_first is None and t_first is None
        assert _port_leaves(t_second, targs[2]) == _ref_leaves(r_second)


def test_placements_reject_wrong_specs():
    """A name the mesh lacks, a mesh dim named twice, a tuple out of mesh
    order: each raises."""
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 2)

    assert SH.placements((("pod", "data"), "model"), Mesh())[0].dim == 0
    for bad in (("experts",), ("model", "model"), (("data", "pod"),)):
        with pytest.raises(ValueError):
            SH.placements(bad, Mesh())


# ---------------------------------------------------------------------------
# Twins of tests/test_shardings_launch.py and tests/test_substrate.py
# ---------------------------------------------------------------------------

def test_megatron_orientation_w_in():
    """(d, ff) with ff larger: ff -> model (column parallel)."""
    spec = SH.param_pspec("stages/0/b0/ffn/w_in/w", (3584, 18944), MESH)
    assert spec == ("data", "model")


def test_megatron_orientation_w_out():
    """(ff, d) with ff larger: ff -> model (row parallel)."""
    spec = SH.param_pspec("stages/0/b0/ffn/w_out/w", (18944, 3584), MESH)
    assert spec == ("model", "data")


def test_square_tie_keeps_data_model():
    spec = SH.param_pspec("stages/0/b0/attn/wq/w", (3584, 3584), MESH)
    assert spec == ("data", "model")


def test_embedding_vocab_over_model():
    spec = SH.param_pspec("embed/embedding", (152064, 3584), MESH)
    assert spec == ("model", "data")


def test_expert_parallel_when_divisible():
    """(L, E, d, f) with E % model == 0: experts over model, the layer
    dim never sharded, fsdp on the larger weight dim."""
    spec = SH.param_pspec("stages/0/b0/ffn/w_in", (16, 64, 2048, 1024), MESH)
    assert spec == (None, "model", "data", None)


def test_expert_fallback_when_indivisible():
    """grok: 8 experts on a 16 dim -> Megatron rule on the last two."""
    spec = SH.param_pspec("stages/0/b0/ffn/w_in", (64, 8, 6144, 32768), MESH)
    assert spec[1] is None and spec[-1] == "model"


def test_fsdp_false_drops_data_axis():
    spec = SH.param_pspec("stages/0/b0/ffn/w_out/w", (18944, 3584), MESH,
                          fsdp=False)
    assert spec == ("model", None)
    espec = SH.param_pspec("embed/embedding", (152064, 3584), MESH,
                           fsdp=False)
    assert espec == ("model", None)


def test_indivisible_dims_unsharded():
    assert SH.param_pspec("x/w", (9, 7), MESH) == (None, None)


def test_serving_fsdp_needed_thresholds():
    import torch
    small = {"w": torch.empty((1024, 1024), dtype=torch.bfloat16,
                              device="meta")}
    assert not SH.serving_fsdp_needed(small, MESH)
    # 314B bfloat16 / 16 = 39 GiB > the 12 GiB budget
    big = {"w": torch.empty((314_000, 1_000_000), dtype=torch.bfloat16,
                            device="meta")}
    assert SH.serving_fsdp_needed(big, MESH)


def test_param_pspec_rules():
    """On a 1 x 1 mesh every entry is None or a mesh dim."""
    spec = SH.param_pspec("stages/0/b0/attn/wq/w", (256, 512),
                          FakeMesh(data=1, model=1))
    assert all(s in (None, "data", "model") for s in spec)


def test_data_pspec_batch_dim():
    m = FakeMesh(data=1, model=1)
    assert len(SH.data_pspec((8, 128), m, batch_dim=0)) == 2
    assert SH.data_pspec((8, 128), MESH) == \
        tuple(JSH.data_pspec((8, 128), MESH))
