"""The port's sharding plans (visper_lm_tpu_torch/parallel/sharding.py) and
process grid (parallel/mesh.py, distributed.py) against the JAX package's,
leaf for leaf: `param_pspecs`, `zero_pspec` (with and without min_size, on
an already data-sharded spec), `opt_state_pspecs`, with zero_params and
zero_frozen, on tiny_test_vlm(distill=True) and on the Phi3-mini and
Llama-3-8B shapes (JAX's through jax.eval_shape, the port's on the meta
device: nothing allocated) at dp 2, 4 and 8; `model_shard_pspec`,
`batch_pspecs`; `make_mesh` and `local_batch_size`. The placements that
apply the specs to the port's per-layer tensors tile each tensor exactly
once over the ranks. All exact (specs are tuples of axis names).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.parallel import mesh as jmesh
from visper_lm_tpu.parallel import sharding as jshd
from visper_lm_tpu.train import optimizer as jopt

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models.vlm import VLM
from visper_lm_tpu_torch.parallel import distributed as tdist
from visper_lm_tpu_torch.parallel import mesh as tmesh
from visper_lm_tpu_torch.parallel import sharding as tshd
from visper_lm_tpu_torch.train import optimizer as topt

torch.set_num_threads(2)

PRESETS = {
    "tiny": ("tiny_test_vlm", True),
    "phi3": ("phi3_clip_vlm", False),
    "llama3": ("llama3_clip_vlm", False),
}


def _flat(tree, is_leaf=None):
    return {jopt._path_str(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _specs(tree):
    return {k: tuple(v) for k, v in _flat(tree, is_leaf=lambda x: isinstance(x, P)).items()}


@pytest.fixture(scope="module", params=list(PRESETS))
def model(request):
    """(name, JAX abstract params, JAX's {path: shape}, the port's
    parameters on the meta device)."""
    fn, distill = PRESETS[request.param]
    jcfg = getattr(jconfig, fn)(distill=distill)
    if request.param == "tiny":
        params = jvlm.init_vlm(jax.random.PRNGKey(0), jcfg)
    else:
        params = jax.eval_shape(lambda: jvlm.init_vlm(jax.random.PRNGKey(0), jcfg))
    with torch.device("meta"):
        named = dict(VLM(getattr(tconfig, fn)(distill=distill)).named_parameters())
    shapes = {k: tuple(v.shape) for k, v in _flat(params).items()}
    return request.param, params, shapes, named


def test_jax_shapes_are_the_jax_trees(model):
    _, _, shapes, named = model
    got = tshd.jax_shapes(named.items())
    assert got == shapes
    # the JAX tree's leaf order
    assert list(got) == list(shapes)


def test_param_pspecs_match_jax(model):
    _, params, shapes, _ = model
    assert tshd.param_pspecs(shapes) == _specs(jshd.param_pspecs(params))


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("min_size", [2 ** 16, 1024, 1])
def test_zero_pspec_matches_jax_on_every_leaf(model, dp, min_size):
    _, params, shapes, _ = model
    base = _specs(jshd.param_pspecs(params))
    for path, shape in shapes.items():
        want = tuple(jshd.zero_pspec(P(*base[path]), shape, dp, min_size=min_size))
        got = tshd.zero_pspec(base[path], shape, dp, min_size=min_size)
        assert got == want, (path, shape)
        # a spec that already holds 'data' stays as it is, in both
        assert tshd.zero_pspec(got, shape, dp, min_size=1) == tuple(
            jshd.zero_pspec(P(*want), shape, dp, min_size=1))


def test_zero_pspec_units():
    """tests/test_probe_and_sharding.py::test_zero_pspec_adds_data_axis's cases."""
    assert tshd.zero_pspec((None, None, "model"), (4, 512, 128), data_size=4) == (
        None, "data", "model")
    assert tshd.zero_pspec((), (64,), data_size=4) == ()
    assert tshd.zero_pspec((), (7, 13), data_size=4, min_size=1) == ()
    assert tshd.zero_pspec((("data", "model"), None), (1024, 1024), data_size=2) == (
        ("data", "model"), None)
    assert tshd.zero_pspec((), (1024, 1024), data_size=1) == ()


def _jax_plan(params, stage, dp, zero_params, zero_frozen, min_size):
    """JAX `plan_train_shardings`'s param and moment specs, by path."""
    mask = jopt.trainable_mask(params, stage)
    specs = _specs(jshd.param_pspecs(params))
    train = {k for k, m in _flat(mask).items() if m}
    for path, leaf in _flat(params).items():
        if (zero_params and path in train) or (zero_frozen and path not in train):
            specs[path] = tuple(jshd.zero_pspec(P(*specs[path]), leaf.shape, dp, min_size=min_size))
    from visper_lm_tpu.utils.param import partition_params

    trainable, _ = partition_params(params, mask)
    train_specs, _ = partition_params(jax.tree_util.tree_map(
        lambda leaf, s: P(*s), params, jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params), [specs[k] for k in _flat(params)])), mask)
    mesh = jmesh.make_mesh(dp=dp, tp=1, devices=jax.devices()[:dp])
    # every moment leaf has its trainable's shape: the trainable tree itself
    # stands for the optimizer state (opt_state_pspecs looks specs up by shape)
    moments = _specs(jshd.opt_state_pspecs(trainable, train_specs, mesh, trainable))
    return specs, moments


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("zero", ["moments", "zero_params", "zero_frozen"])
def test_plan_zero_matches_jax_plan_train_shardings(model, dp, zero):
    """The parameters' and the moments' specs of the port's `plan_zero`
    equal JAX's plan, the moments' shape lookup included (q_proj's
    moments take o_proj's spec where their shapes agree)."""
    name, params, shapes, named = model
    stage = "pretrain" if name == "tiny" else "finetune"
    min_size = 1024 if name == "tiny" else 2 ** 16
    kw = dict(zero_params=zero == "zero_params", zero_frozen=zero == "zero_frozen")
    want_specs, want_moments = _jax_plan(params, stage, dp, min_size=min_size, **kw)
    mask = topt.trainable_mask(named.items(), stage)
    _, _, specs, moments = tshd.plan_zero(named, mask, dp, zero_min_size=min_size, **kw)
    assert specs == want_specs
    assert moments == want_moments
    if name != "tiny" and zero == "moments":
        assert moments["decoder/blocks/q_proj/kernel"] == moments["decoder/blocks/o_proj/kernel"]


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_placements_tile_each_tensor_once(model, dp):
    """Every sharded per-layer tensor: the ranks' slices are disjoint and
    cover it (a split dim's ranges, or one owner holding it whole)."""
    name, _, _, named = model
    stage = "pretrain" if name == "tiny" else "finetune"
    mask = topt.trainable_mask(named.items(), stage)
    moments, params, _, _ = tshd.plan_zero(named, mask, dp, zero_params=True, zero_frozen=True,
                                           zero_min_size=1024)
    n_sharded = 0
    for plan in (moments, params):
        for n, pl in plan.items():
            shape = tuple(named[n].shape)
            if not pl.sharded:
                assert pl.local_shape(shape, 0) == shape
                continue
            n_sharded += 1
            spans = sorted(pl.bounds(shape, r) for r in range(dp))
            dims = {d for d, _, _ in spans}
            assert len(dims) == 1, n
            # the ranks' ranges along the split dim are disjoint and cover it
            nonempty = [(a, b) for _, a, b in spans if b > a]
            assert nonempty[0][0] == 0 and nonempty[-1][1] == shape[dims.pop()], n
            assert all(b == a2 for (_, b), (a2, _) in zip(nonempty, nonempty[1:])), n
            for r in range(dp):
                d, a, b = pl.bounds(shape, r)
                assert pl.local_shape(shape, r) == shape[:d] + (b - a,) + shape[d + 1:]
            if name == "tiny":
                # element by element on the small model
                index = torch.arange(int(np.prod(shape))).reshape(shape)
                covered = torch.zeros(index.numel(), dtype=torch.int32)
                for r in range(dp):
                    covered[pl.local(index, r).reshape(-1)] += 1
                assert (covered == 1).all(), n
    assert n_sharded > 0


def test_placement_of_a_leaf_split_along_its_layers():
    """Where JAX puts 'data' on a stacked leaf's layer axis, each layer's
    tensor is whole on one rank (L / dp layers a rank), empty on the others."""
    named = {f"decoder.blocks.{i}.attn_norm.scale": (3,) for i in range(4)}
    assert tshd.jax_shapes((n, torch.empty(s)) for n, s in named.items()) == {
        "decoder/blocks/attn_norm/scale": (4, 3)}
    assert tshd.zero_pspec((), (4, 3), 2, min_size=1) == ("data", None)
    pl = tshd.placements(named, {"decoder/blocks/attn_norm/scale": ("data", None)}, 2)
    assert [pl[f"decoder.blocks.{i}.attn_norm.scale"].owner for i in range(4)] == [0, 0, 1, 1]
    t = torch.arange(3.0)
    assert pl["decoder.blocks.2.attn_norm.scale"].local(t, 1).tolist() == [0.0, 1.0, 2.0]
    assert pl["decoder.blocks.2.attn_norm.scale"].local(t, 0).numel() == 0
    assert pl["decoder.blocks.2.attn_norm.scale"].local_shape((3,), 0) == (0,)


def test_kernels_split_the_port_layouts_dim():
    """A linear kernel's JAX dim k is nn.Linear's weight dim 1 - k; a conv's
    HWIO dim k is OIHW's (2, 3, 1, 0)[k]."""
    named = {"decoder.lm_head.weight": (512, 64), "vision_tower.patch_embed.weight": (32, 3, 14, 14)}
    specs = {"decoder/lm_head/kernel": ("data", "model"),
             "vision_tower/patch_embed/kernel": (None, None, None, "data")}
    pl = tshd.placements(named, specs, 2)
    assert pl["decoder.lm_head.weight"].dim == 1
    assert pl["vision_tower.patch_embed.weight"].dim == 0


def test_model_shard_and_batch_pspecs_match_jax(model):
    _, _, shapes, _ = model
    for tp in (1, 2, 4, 8):
        for shape in shapes.values():
            assert tshd.model_shard_pspec(shape, tp) == tuple(jshd.model_shard_pspec(shape, tp))
            assert tshd.model_shard_pspec(shape, tp, min_size=1) == tuple(
                jshd.model_shard_pspec(shape, tp, min_size=1))
    batch = {"labels": np.zeros((4, 8)), "images": np.zeros((4, 2, 2, 3)), "n": np.zeros(()),
             "lens": np.zeros((4,))}
    for accum in (False, True):
        want = {k: tuple(v) for k, v in jshd.batch_pspecs(batch, leading_accum=accum).items()}
        assert tshd.batch_pspecs(batch, leading_accum=accum) == want


def test_make_mesh_shapes_and_errors():
    m = tmesh.make_mesh(world=8)
    assert m.shape == {"data": 8, "model": 1} == dict(jmesh.make_mesh().shape)
    m = tmesh.make_mesh(dp=3, world=8)
    assert m.shape == dict(jmesh.make_mesh(dp=3).shape) and m.size == 3
    assert m.coords(2) == {"data": 2, "model": 0}
    assert m.data_group_ranks(1) == (0, 1, 2)
    with pytest.raises(AssertionError) as want:
        jmesh.make_mesh(dp=16)
    with pytest.raises(AssertionError) as got:
        tmesh.make_mesh(dp=16, world=8)
    assert str(got.value) == str(want.value)
    for kw, item in ((dict(tp=2), "A10b"), (dict(sp=2), "A10c"), (dict(pp=2), "A10c"),
                     (dict(ep=2), "A10d")):
        with pytest.raises(NotImplementedError, match=item):
            tmesh.make_mesh(world=8, **kw)
    assert tmesh.make_mesh().shape == {"data": 1, "model": 1}    # one process
    assert tmesh.single_device_mesh().size == 1


def test_local_batch_size_and_the_runtime_of_one_process():
    assert not tdist.is_initialized()
    tdist.init_distributed()                       # no VISPER_*: nothing to join
    assert not tdist.is_initialized()
    assert (tdist.process_index(), tdist.process_count(), tdist.is_coordinator()) == (0, 1, True)
    assert tdist.local_batch_size(8) == 8
    assert tdist.local_device("cuda") == torch.device("cuda")
    mesh = tdist.make_global_mesh()
    local = tdist.shard_batch_multihost({"labels": np.zeros((4, 8)), "x": np.zeros((4, 2))}, mesh)
    assert local.global_batch_size == 4 and local["labels"].shape == (4, 8)
    with pytest.raises(ValueError, match="rows"):
        tdist.shard_batch_multihost({"labels": np.zeros((4, 8)), "x": np.zeros((3, 2))}, mesh)
    with pytest.raises(ValueError, match="process's id"):
        tdist.init_distributed("localhost:1", num_processes=2)
