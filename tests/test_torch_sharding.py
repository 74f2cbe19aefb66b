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

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
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
from visper_lm_tpu_torch.parallel import tensor as T
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
    # the 'model' axis innermost, as JAX's: a tensor-parallel group is
    # consecutive ranks, a data group every tp-th
    for dp, tp in ((1, 2), (2, 2), (4, 2), (1, 4), (2, 4)):
        m = tmesh.make_mesh(dp=dp, tp=tp, world=8)
        assert m.shape == dict(jmesh.make_mesh(dp=dp, tp=tp).shape) == {"data": dp, "model": tp}
        assert (m.data_size, m.model_size, m.size) == (dp, tp, dp * tp)
        for r in range(dp * tp):
            assert m.coords(r) == {"data": r // tp, "model": r % tp}
            assert m.model_group_ranks(r) == tuple(range(r // tp * tp, r // tp * tp + tp))
            assert m.data_group_ranks(r) == tuple(range(r % tp, dp * tp, tp))
    # the 'seq', 'pipe' (A10c) and 'expert' (A10d) axes in JAX's order
    for kw in (dict(sp=2), dict(pp=2), dict(sp=2, pp=2, tp=2), dict(dp=2, pp=2, tp=2),
               dict(ep=2), dict(dp=2, ep=2, tp=2), dict(pp=2, ep=2, sp=2)):
        m = tmesh.make_mesh(world=8, **kw)
        assert m.shape == dict(jmesh.make_mesh(**kw).shape), kw
    m = tmesh.make_mesh(world=8, dp=2, ep=2, tp=2)
    assert m.expert_size == 2 and m.expert_group_ranks(1) == (1, 3)
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


# ---------------------------------------------------------------------------
# the 'model' axis: placements over two axes, the moments' layout, the
# teachers' slices and the offload plan at dp x tp
# ---------------------------------------------------------------------------

TP_MESHES = [(1, 2), (2, 2), (4, 2), (1, 4), (2, 4)]


@functools.lru_cache(maxsize=None)
def _tp_model(preset, tp):
    """The port's tp-local parameters (meta device) of model rank 0, the
    JAX abstract params and shapes."""
    fn, distill = PRESETS[preset]
    cfg = getattr(tconfig, fn)(distill=distill)
    with torch.device("meta"):
        model = VLM(cfg)
    jcfg = getattr(jconfig, fn)(distill=distill)
    params = jax.eval_shape(lambda: jvlm.init_vlm(jax.random.PRNGKey(0), jcfg))
    if cfg.decoder.num_kv_heads % tp:
        # trap 2: kv heads split in whole blocks only (tiny's 2 at tp 4); the
        # plans still tile the tensors' rows
        with pytest.raises(ValueError, match=f"num_kv_heads 2 does not divide by tp {tp}"):
            T.shard_model(model, T.TensorParallel(None, 0, tp))
        plan = T.tp_plan(model, tp)
        return {n: torch.empty(plan[n].model_local_shape(p.shape), device="meta")
                for n, p in model.named_parameters()}, params
    with torch.device("meta"):
        T.shard_model(model, T.TensorParallel(None, 0, tp))
    return dict(model.named_parameters()), params


def _disjoint_cover(boxes, shape, copies=1):
    """The ranks' boxes of a tensor's index space: the distinct non-empty
    ones disjoint, their volumes adding up to the tensor's, each held by
    `copies` ranks (the sizes of the axes it is replicated over)."""
    boxes = [box for box in boxes if all(b > a for a, b in box)]
    assert all(boxes.count(box) == copies for box in boxes)
    boxes = sorted(set(boxes))
    vol = [int(np.prod([b - a for a, b in box])) for box in boxes]
    assert sum(vol) == int(np.prod(shape or (1,)))
    for i, p in enumerate(boxes):
        for q in boxes[i + 1:]:
            assert any(min(b1, b2) <= max(a1, a2) for (a1, b1), (a2, b2) in zip(p, q)) or (
                0 in [b - a for a, b in p] + [b - a for a, b in q])


@pytest.mark.parametrize("dp, tp", TP_MESHES)
def test_two_axis_placements_tile_each_tensor_once(model, dp, tp):
    """Every parameter's and moment's placement at dp x tp: the ranks' pieces
    of the whole tensor (its tp slice, then its ZeRO slice of that) are
    disjoint and cover it, each the shape the rank holds; the parameters'
    specs are JAX's plan's; the Megatron leaves split the heads, the MLP
    and the vocabulary."""
    name = model[0]
    named, params = _tp_model(name, tp)
    stage = "pretrain" if name == "tiny" else "finetune"
    mask = topt.trainable_mask(named.items(), stage)
    moments, placed, specs, _ = tshd.plan_zero(named, mask, dp, zero_params=True,
                                               zero_frozen=True, zero_min_size=1024,
                                               model_size=tp)
    want, _ = _jax_plan(params, stage, dp, zero_params=True, zero_frozen=True, min_size=1024)
    assert specs == want
    split = 0
    for plan in (moments, placed):
        for n, pl in plan.items():
            local = tuple(named[n].shape)
            whole = pl.whole_shape(local)
            split += pl.model_sharded
            boxes = []
            for d in range(dp):
                for m in range(tp):
                    box = pl.box(whole, d, m)
                    assert tuple(b - a for a, b in box) == (
                        pl.local_shape(local, d) if whole else (1,)), (n, d, m)
                    boxes.append(box)
            _disjoint_cover(boxes, whole, (1 if pl.model_sharded else tp) *
                            (1 if pl.sharded else dp))
            if name == "tiny":
                index = torch.arange(int(np.prod(whole))).reshape(whole)
                covered = torch.zeros(index.numel(), dtype=torch.int32)
                for d in range(dp if pl.sharded else 1):
                    for m in range(tp if pl.model_sharded else 1):
                        covered[pl.tile(index, d, m).reshape(-1)] += 1
                assert (covered == 1).all(), n
    assert split > 0
    q, o = placed["decoder.blocks.0.q_proj.weight"], placed["decoder.blocks.0.o_proj.weight"]
    assert (q.model_dim, o.model_dim, placed["decoder.embed_tokens.weight"].model_dim) == (0, 1, 0)
    assert placed["decoder.blocks.0.attn_norm.scale"].model_dim is None


def _spec_bytes(shape, spec, sizes):
    """A leaf's bytes on one device under a spec (elements)."""
    parts = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            parts *= sizes.get(a, 1)
    return int(np.prod(shape)) // parts


@pytest.mark.parametrize("dp, tp", TP_MESHES)
def test_moments_in_their_parameters_tp_slice_hold_jaxs_bytes(model, dp, tp):
    """ROADMAP C, the moments' layout: JAX looks a moment's spec up by shape
    (q_proj's take o_proj's 'model' dim at Llama-3-8B, o_proj's k_proj's at
    Phi3-mini); the port keeps each moment in its parameter's own tp slice,
    with ZeRO's 'data' dim on that spec: the same elements a rank as JAX's
    `opt_state_pspecs`, leaf for leaf (the finetune stage: the decoder trains)."""
    name = model[0]
    named, params = _tp_model(name, tp)
    mask = topt.trainable_mask(named.items(), "finetune")
    moments, _, specs, moment_specs = tshd.plan_zero(named, mask, dp, model_size=tp)
    _, want = _jax_plan(params, "finetune", dp, zero_params=False, zero_frozen=False,
                        min_size=2 ** 16)
    shapes = dict(_flat(params))
    sizes = {"data": dp, "model": tp}
    got: dict = {}
    for n, pl in moments.items():
        path = topt.jax_path(n)
        got[path] = got.get(path, 0) + int(np.prod(pl.local_shape(named[n].shape, 0)))
    assert sorted(got) == sorted(want)
    for path, n_elems in got.items():
        assert n_elems == _spec_bytes(shapes[path].shape, want[path], sizes), path
    moved = [p for p in want if want[p] != moment_specs[p]]
    if name != "tiny":
        assert "decoder/blocks/q_proj/kernel" in moved or "decoder/blocks/o_proj/kernel" in moved
        for p in moved:
            assert tshd._axis_of(moment_specs[p], "model") == tshd._axis_of(specs[p], "model")


@pytest.mark.parametrize("tp", [2, 4])
def test_teacher_placements_are_model_shard_pspec(tp):
    """shard_teachers: each teacher tensor's 'model' slice is JAX's
    `model_shard_pspec` of its leaf in `init_teachers`' tree (stacked
    blocks; the mapping's paths and shapes are the tree's), and the ranks'
    slices tile it once."""
    from visper_lm_tpu.models.teachers import init_teachers as jinit_teachers
    from visper_lm_tpu_torch.models.teachers import build_teachers

    jcfg = jconfig.tiny_test_vlm(distill=True)
    tree = jax.eval_shape(lambda: jinit_teachers(jax.random.PRNGKey(7), jcfg))
    shapes = {k: tuple(v.shape) for k, v in _flat(tree).items()}
    with torch.device("meta"):
        teachers = build_teachers(tconfig.tiny_test_vlm(distill=True))
    leaves = tshd.teacher_leaves(teachers)
    assert sorted({path for path, *_ in leaves.values()}) == sorted(shapes)
    placed = tshd.teacher_placements(teachers, tp)
    n_split = 0
    for n, (path, shape, perm, stacked) in leaves.items():
        assert shape == shapes[path], n
        spec = tuple(jshd.model_shard_pspec(shapes[path], tp))
        pl = placed[n]
        if "model" not in spec:
            assert not pl.model_sharded, n
            continue
        n_split += 1
        assert perm[spec.index("model") - int(stacked)] == pl.model_dim, n
        whole = tuple(teachers.get_parameter(n).shape)
        _disjoint_cover([pl.box(whole, 0, m) for m in range(tp)], whole)
    assert n_split > 100


@pytest.mark.parametrize("dp, tp", TP_MESHES)
def test_plan_offload_layout_matches_jax_on_dp_tp_specs(dp, tp):
    """JAX `plan_offload_layout` with its `_covers_mesh` / `_axis0_unsharded`
    rules on make_mesh(dp, tp): Llama-3-8B's IFT moments (stacked leaves, the
    moments' specs of JAX's plan): offloaded where the spec covers every
    axis larger than 1, row blocks where dim 0 is free. The port's function
    gives the same placement and rows, leaf for leaf."""
    from jax.sharding import NamedSharding

    from visper_lm_tpu.train import staged_update as jsu
    from visper_lm_tpu_torch.train import staged_update as tsu

    _, params = _tp_model("llama3", tp)
    _, specs = _jax_plan(params, "finetune", dp, zero_params=False, zero_frozen=False,
                         min_size=2 ** 16)
    flat = dict(_flat(params))
    mesh = jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    shapes, named_specs, jshape, jns = {}, {}, {}, {}
    for path, spec in specs.items():
        for kind, dtype in (("mu", np.float32), ("nu", jnp.bfloat16)):
            key = f"{kind}/{path}"
            shapes[key] = (flat[path].shape, torch.float32 if kind == "mu" else torch.bfloat16)
            named_specs[key] = spec
            jshape[key] = jax.ShapeDtypeStruct(flat[path].shape, dtype)
            jns[key] = NamedSharding(mesh, P(*spec))
    out_s, out_n = jsu.plan_offload_layout(jshape, jns, mesh)
    want = {}
    for key in jshape:
        leaf = out_s[key]
        if isinstance(leaf, jsu.ChunkedHostArray):
            want[key] = tuple(leaf.row_ranges)
        elif getattr(out_n[key], "memory_kind", None) == "pinned_host":
            want[key] = ()
        else:
            want[key] = None
    got = tsu.plan_offload_layout(shapes, specs=named_specs, axis_sizes={"data": dp, "model": tp})
    assert got == want
    assert any(v is None for v in got.values()) and any(v is not None for v in got.values())


# (dp, sp, pp, tp): meshes with a 'seq' or a 'pipe' axis (8 CPU devices at most)
SP_PP_MESHES = [(2, 2, 1, 1), (2, 1, 2, 1), (1, 2, 2, 1), (1, 1, 2, 2), (2, 2, 1, 2), (1, 2, 2, 2)]


def _rank_zero_plan(named, dp, tp, sp=1, pp=1):
    """A ZeroPlan of data rank 0 (stage 0, seq rank 0) on Llama-3-8B's IFT
    trainables (tp-local under tp), with the mesh's groups as sizes only."""
    from visper_lm_tpu_torch.parallel.pipeline import PipeParallel
    from visper_lm_tpu_torch.parallel.sequence import SequenceParallel

    mask = topt.trainable_mask(named.items(), "finetune")
    moments, _, _, _ = tshd.plan_zero(named, mask, dp, model_size=tp)
    layers = tconfig.llama3_clip_vlm(distill=False).decoder.num_layers
    return tshd.ZeroPlan(
        None, 0, dp, moments, {}, tp=T.TensorParallel(None, 0, tp) if tp > 1 else None,
        seq=SequenceParallel(None, 0, sp) if sp > 1 else None,
        pipe=PipeParallel(None, 0, pp, layers) if pp > 1 else None)


@pytest.mark.parametrize("dp, sp, pp, tp", SP_PP_MESHES)
def test_offload_plan_matches_jax_on_seq_and_pipe_meshes(dp, sp, pp, tp):
    """ROADMAP C32. JAX `plan_offload_layout` on make_mesh(dp, tp, sp=, pp=)
    of Llama-3-8B's IFT moments (the moments' specs of JAX's plan): no spec
    names 'seq' or 'pipe' (JAX's parameter rules split nothing over them),
    so `_covers_mesh` keeps every leaf on the card. The port's
    `offload_shapes` of a rank's ZeroPlan (under pp the rank's stage's
    blocks) gives `plan_offload_layout` the same: every tensor the rank
    holds on the card. Without its seq and pipe axes the same plan would
    offload, as JAX's does on the mesh without them (the check can fail)."""
    from jax.sharding import NamedSharding

    from visper_lm_tpu.train import staged_update as jsu
    from visper_lm_tpu_torch.parallel.pipeline import PipeParallel
    from visper_lm_tpu_torch.train import staged_update as tsu

    if tp > 1:
        named, params = _tp_model("llama3", tp)
    else:
        params = jax.eval_shape(lambda: jvlm.init_vlm(jax.random.PRNGKey(0),
                                                      jconfig.llama3_clip_vlm(distill=False)))
        with torch.device("meta"):
            named = dict(VLM(tconfig.llama3_clip_vlm(distill=False)).named_parameters())
    _, specs = _jax_plan(params, "finetune", dp, zero_params=False, zero_frozen=False,
                         min_size=2 ** 16)
    flat = dict(_flat(params))

    def jax_plan(**axes):
        n = dp * tp * axes.get("sp", 1) * axes.get("pp", 1)
        mesh = jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:n], **axes)
        jshape, jns = {}, {}
        for path, spec in specs.items():
            for kind, dtype in (("mu", np.float32), ("nu", jnp.bfloat16)):
                jshape[f"{kind}/{path}"] = jax.ShapeDtypeStruct(flat[path].shape, dtype)
                jns[f"{kind}/{path}"] = NamedSharding(mesh, P(*spec))
        out_s, out_n = jsu.plan_offload_layout(jshape, jns, mesh)
        return {k: isinstance(out_s[k], jsu.ChunkedHostArray)
                or getattr(out_n[k], "memory_kind", None) == "pinned_host" for k in jshape}

    def port_plan(zero):
        pipe = zero.pipe or PipeParallel(None, 0, 1, 32)
        held = {n: p for n, p in named.items() if n in zero.moments
                and not (n.startswith("decoder.blocks.") and not pipe.owns(int(n.split(".")[2])))}
        shapes, pspecs, sizes = tsu.offload_shapes(held, torch.float32, False, zero)
        return tsu.plan_offload_layout(shapes, specs=pspecs, axis_sizes=sizes)

    want = jax_plan(sp=sp, pp=pp)
    got = port_plan(_rank_zero_plan(named, dp, tp, sp, pp))
    assert {int(k.split(".")[2]) for k in got if ".blocks." in k} == set(range(32 // pp))
    for key, placement in got.items():
        kind, n = key.split("/", 1)
        assert (placement is not None) == want[f"{kind}/{topt.jax_path(n)}"], key
    assert not any(want.values()) and all(v is None for v in got.values())
    # the control: the mesh without its seq and pipe axes offloads, in both
    assert any(jax_plan().values())
    assert any(v is not None for v in port_plan(_rank_zero_plan(named, dp, tp)).values())


# (dp, ep): meshes with an 'expert' axis (8 CPU devices at most)
EP_MESHES = [(1, 2), (2, 2), (1, 4), (4, 2)]


def _moe_phi3(mod):
    """Phi3-mini + CLIP-L with JAX's dry-run MoE (E 4, top-2) (mod: the JAX
    or the port's config module)."""
    import dataclasses

    cfg = mod.phi3_clip_vlm(distill=False)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, moe_experts=4,
                                                                moe_top_k=2))


@pytest.mark.parametrize("dp, ep", EP_MESHES)
def test_offload_plan_matches_jax_on_expert_meshes(dp, ep):
    """JAX `plan_offload_layout` on make_mesh(dp, ep=) of a MoE Phi3-mini's
    IFT moments (the moments' specs of JAX's plan): only a bank's spec
    names 'expert', so `_covers_mesh` offloads a bank's moments where their
    spec also names every other axis wider than 1, and keeps every dense
    moment on the card. The port's `offload_shapes` of a rank's ZeroPlan
    (its E/ep experts of each bank) gives `plan_offload_layout` the same,
    leaf for leaf. The control: without its 'expert' axis the port's plan
    differs (it would offload the dense moments too)."""
    from jax.sharding import NamedSharding

    from visper_lm_tpu.train import staged_update as jsu
    from visper_lm_tpu_torch.train import staged_update as tsu

    params = jax.eval_shape(lambda: jvlm.init_vlm(jax.random.PRNGKey(0), _moe_phi3(jconfig)))
    group = tdist.AxisGroup(None, 0, ep)
    with torch.device("meta"):
        named = dict(VLM(_moe_phi3(tconfig), ep=group).named_parameters())
    _, specs = _jax_plan(params, "finetune", dp, zero_params=False, zero_frozen=False,
                         min_size=2 ** 16)
    flat = dict(_flat(params))
    mesh = jmesh.make_mesh(dp=dp, ep=ep, devices=jax.devices()[:dp * ep])
    jshape, jns = {}, {}
    for path, spec in specs.items():
        for kind, dtype in (("mu", np.float32), ("nu", jnp.bfloat16)):
            jshape[f"{kind}/{path}"] = jax.ShapeDtypeStruct(flat[path].shape, dtype)
            jns[f"{kind}/{path}"] = NamedSharding(mesh, P(*spec))
    out_s, out_n = jsu.plan_offload_layout(jshape, jns, mesh)
    want = {k: isinstance(out_s[k], jsu.ChunkedHostArray)
            or getattr(out_n[k], "memory_kind", None) == "pinned_host" for k in jshape}

    mask = topt.trainable_mask(named.items(), "finetune")
    moments, _, _, _ = tshd.plan_zero(named, mask, dp, expert_size=ep)
    zero = tshd.ZeroPlan(None, 0, dp, moments, {}, ep=group)
    shapes, pspecs, sizes = tsu.offload_shapes({n: named[n] for n in moments}, torch.float32,
                                               False, zero)
    got = tsu.plan_offload_layout(shapes, specs=pspecs, axis_sizes=sizes)
    assert sizes["expert"] == ep
    for key, placement in got.items():
        kind, n = key.split("/", 1)
        assert (placement is not None) == want[f"{kind}/{topt.jax_path(n)}"], key
        if placement is not None:
            assert ".moe_" in n and placement == (), key     # a rank's slice, one block
    offloaded = {k.split("/", 1)[1] for k, v in got.items() if v is not None}
    banks = {n for n in moments if ".moe_gate." in n or ".moe_up." in n or ".moe_down." in n}
    assert offloaded == banks
    # the control: the same plan without the 'expert' axis
    del sizes["expert"]
    blind = tsu.plan_offload_layout(shapes, specs=pspecs, axis_sizes=sizes)
    assert {k for k, v in blind.items() if v is not None} != {k for k, v in got.items()
                                                              if v is not None}
