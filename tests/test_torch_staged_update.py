"""The port's offloaded AdamW state and blockwise staged update
(train/staged_update.py) and its AdamW (train/optimizer.py) against the JAX
package's `blockwise_staged_update`, `plan_offload_layout` and optax, on
JAX's own spec inputs (tests/test_staged_update.py): the same seeded numpy
trees, stacked (L, in, out) leaves kept as they are under their JAX paths.

On the CPU the "host" state is ordinary CPU tensors and the copies are
identities, so what is held here is the math and the layout. Tolerances are
JAX's own (f32: rtol 2e-5, atol 1e-7; bf16 with master weights: 1e-2);
where the port is bit-equal (its blocks against its whole tensors, either
block layout, its AdamW on bf16 against optax) the test says so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import staged_update as jsu
from visper_lm_tpu.utils.param import partition_params

from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import staged_update as tsu
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(2)


def _params(dtype):
    """JAX's spec tree (tests/test_staged_update.py `_params`)."""
    rng = np.random.default_rng(0)

    def arr(*shape):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(dtype)

    return {
        "decoder": {
            "blocks": {"q_proj": {"kernel": arr(4, 8, 8)}, "norm": {"scale": arr(4, 8)}},
            "w": arr(8, 8),
            "norm": {"scale": arr(8)},
        },
        "mm_projector": {"w": arr(8, 8), "bias": arr(8)},
        "vision_tower": {"w": arr(8, 8)},
    }


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)).astype(p.dtype), params)


def _trainable(params, cfg):
    return partition_params(params, jopt.trainable_mask(params, cfg.stage))[0]


def _flat(tree):
    """{port name: leaf}: the JAX path with '.' (`jax_path` gives it back)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = leaf
    return out


def _torch(leaf):
    """A copy of a JAX leaf (bf16 kept bf16)."""
    a = np.asarray(leaf)
    t = torch.tensor(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _port_params(trainable):
    return {n: torch.nn.Parameter(_torch(v)) for n, v in _flat(trainable).items()}


def _cfgs(**kw):
    return jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)


def _state_j(st):
    """optax's mu / nu / master leaves as {"mu/<name>": array, ...}."""
    out = {}
    for label, ms in st.inner_states.items():
        unpacked = jsu._label_state(ms)
        if unpacked is None:
            continue
        adam, _, master = unpacked
        for kind, tree in (("mu", adam.mu), ("nu", adam.nu), ("master", master)):
            if tree is None:
                continue
            for n, v in _flat(tree).items():
                if hasattr(v, "shape"):
                    out[f"{kind}/{n}"] = np.asarray(v)
    return out


def _close(got: torch.Tensor, want, rtol, atol, what):
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (what, got.dtype, want.dtype)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=rtol, atol=atol,
                               err_msg=what)


def _run(cfg_kw, dtype, *, steps=3, **offload_kw):
    """optax, JAX's blockwise update and the port's offloaded and on-card
    AdamW over `steps` updates of the same gradients."""
    cj, ct = _cfgs(**cfg_kw)
    trainable = _trainable(_params(dtype), cj)
    tx = jopt.make_optimizer(trainable, cj)
    p_ref = p_blk = trainable
    st_ref = st_blk = tx.init(trainable)
    off_params, card_params = _port_params(trainable), _port_params(trainable)
    off = tsu.OffloadedAdamW(off_params.items(), ct, **offload_kw)
    card = topt.AdamW(card_params.items(), ct)
    update = jax.jit(tx.update)
    for i in range(steps):
        g = _grads(trainable, seed=10 + i)
        upd, st_ref = update(g, st_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        p_blk, st_blk, _ = jsu.blockwise_staged_update(g, st_blk, p_blk, cj)
        gt = {n: _torch(v) for n, v in _flat(g).items()}
        off.step(gt)
        card.step(gt)
    return dict(p_ref=_flat(p_ref), st_ref=_state_j(st_ref), p_blk=_flat(p_blk),
                st_blk=_state_j(st_blk), off=off, off_params=off_params, card=card,
                card_params=card_params)


def _assert_port_bit_equal(r):
    """The offloaded update gives the on-card AdamW's bytes."""
    for n, p in r["off_params"].items():
        assert torch.equal(p, r["card_params"][n]), n
    card = r["card"].state_tensors()
    for k, t in r["off"].state_tensors().items():
        assert t.dtype == card[k].dtype and torch.equal(t, card[k]), k


@pytest.mark.parametrize("stage", ["finetune", "pretrain"])
def test_blockwise_matches_jax_and_optax_f32(stage):
    r = _run(dict(learning_rate=1e-3, stage=stage, weight_decay=0.01, total_steps=50),
             jnp.float32, block_bytes=256, min_bytes=0)
    assert all(v is not None for v in r["off"].plan.values())
    _assert_port_bit_equal(r)
    for ref in ("p_ref", "p_blk"):
        for n, p in r["off_params"].items():
            _close(p.detach(), r[ref][n], 2e-5, 1e-7, (ref, n))
    for ref in ("st_ref", "st_blk"):
        assert sorted(r[ref]) == sorted(r["off"].state_tensors())
        for k, t in r["off"].state_tensors().items():
            _close(t, r[ref][k], 2e-5, 1e-7, (ref, k))


def test_blockwise_matches_jax_and_optax_groups_and_master_bf16():
    """Per-group lrs and f32 master weights over bf16 parameters, at JAX's
    bf16 tolerances; the port's parameters and nu (bf16, the parameters'
    dtype, as optax keeps it) are bit-equal to optax's, and its f32 mu and
    masters lie within 1e-6 of the largest of optax's (f32 roundings: the
    port folds 1 / bc1 into the step and XLA fuses multiply-adds)."""
    r = _run(dict(learning_rate=1e-3, mm_projector_lr=2e-4, stage="finetune",
                  master_weights=True, total_steps=50),
             jnp.bfloat16, block_bytes=256, min_bytes=0)
    _assert_port_bit_equal(r)
    for ref in ("p_ref", "p_blk"):
        for n, p in r["off_params"].items():
            _close(p.detach(), r[ref][n], 1e-2, 1e-2, (ref, n))
    for ref in ("st_ref", "st_blk"):
        for k, t in r["off"].state_tensors().items():
            _close(t, r[ref][k], 1e-2, 1e-3, (ref, k))
    for n, p in r["off_params"].items():
        assert np.array_equal(p.detach().float().numpy(), np.asarray(r["p_ref"][n], np.float32)), n
    for k, t in r["off"].state_tensors().items():
        _near_or_equal(t, r["st_ref"][k], k)


def _near_or_equal(got: torch.Tensor, want, what):
    """A bf16 tensor bit-equal to optax's; an f32 one within 1e-6 of its
    largest magnitude (a moment that cancels towards 0 has few good ulps)."""
    want = np.asarray(want, np.float32)
    if got.dtype == torch.bfloat16:
        assert np.array_equal(got.float().numpy(), want), what
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                   err_msg=what)


@pytest.mark.parametrize("scan", [True, False])
def test_chunked_blocks_give_the_unchunked_bytes(scan):
    """A tiny block budget cuts the stacked leaves into row blocks (uniform
    ones with scan_chunks, as JAX's stacked layout); the parameters and the
    state are the bytes of the whole-tensor update, and of optax's within
    JAX's f32 tolerance."""
    kw = dict(learning_rate=1e-3, stage="finetune", master_weights=True, total_steps=50)
    chunked = _run(kw, jnp.float32, block_bytes=256, min_bytes=0, scan_chunks=scan)
    whole = _run(kw, jnp.float32, block_bytes=1 << 30, min_bytes=0)
    blocks = chunked["off"].plan["mu/decoder.blocks.q_proj.kernel"]
    assert len(blocks) > 1 and whole["off"].plan["mu/decoder.blocks.q_proj.kernel"] == ()
    if scan:
        assert len({e - s for s, e in blocks}) == 1
    for n, p in chunked["off_params"].items():
        assert torch.equal(p, whole["off_params"][n]), n
        _close(p.detach(), chunked["p_ref"][n], 2e-5, 1e-7, n)
    w = whole["off"].state_tensors()
    for k, t in chunked["off"].state_tensors().items():
        assert torch.equal(t, w[k]), k


def test_whole_tree_staging_gives_the_blockwise_bytes():
    kw = dict(learning_rate=1e-3, stage="finetune", master_weights=True, total_steps=50)
    whole = _run(kw, jnp.bfloat16, min_bytes=0, blockwise=False)
    blockwise = _run(kw, jnp.bfloat16, block_bytes=256, min_bytes=0)
    assert all(v == () for v in whole["off"].plan.values() if v is not None)
    _assert_port_bit_equal(whole)
    for n, p in whole["off_params"].items():
        assert torch.equal(p, blockwise["off_params"][n]), n


def test_init_opt_state_offloaded_is_tx_init():
    """Zeros (mu f32, nu in the parameters' dtype) and f32 master copies,
    equal to optax's init and to JAX's init_opt_state_offloaded, exactly."""
    cj, ct = _cfgs(learning_rate=1e-3, stage="finetune", master_weights=True, total_steps=50)
    trainable = _trainable(_params(jnp.bfloat16), cj)
    tx = jopt.make_optimizer(trainable, cj)
    shape = jax.eval_shape(tx.init, trainable)
    dev = jax.devices("cpu")[0]
    sh = jax.tree_util.tree_map(lambda _: jax.sharding.SingleDeviceSharding(dev), shape)
    ref_j = _state_j(jsu.init_opt_state_offloaded(tx, trainable, shape, sh))
    ref = _state_j(tx.init(trainable))
    off = tsu.OffloadedAdamW(_port_params(trainable).items(), ct, block_bytes=256, min_bytes=0)
    got = off.state_tensors()
    assert sorted(got) == sorted(ref) == sorted(ref_j)
    for k, t in got.items():
        _close(t, ref[k], 0, 0, k)
        _close(t, ref_j[k], 0, 0, k)


def _nodes(tree):
    """_flat, with JAX's chunked nodes as leaves."""
    is_node = lambda x: isinstance(x, (jsu.ChunkedHostArray, jsu.StackedHostArray))  # noqa: E731
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_node)[0]}


def _jax_plan(dtype, **kw):
    """JAX's plan on a 1x1 CPU mesh as {state key: placement}, and the port's shapes."""
    cj, _ = _cfgs(learning_rate=1e-3, stage="finetune", master_weights=True, total_steps=50)
    trainable = _trainable(_params(dtype), cj)
    tx = jopt.make_optimizer(trainable, cj)
    shape = jax.eval_shape(tx.init, trainable)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    ns = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()), shape)
    cshape, cns = jsu.plan_offload_layout(shape, ns, mesh, **kw)
    inner, inner_ns = cshape.inner_states["base"].inner_state, cns.inner_states["base"].inner_state
    out = {}
    for kind, tree, ntree in (("mu", inner[1][0].mu, inner_ns[1][0].mu),
                              ("nu", inner[1][0].nu, inner_ns[1][0].nu),
                              ("master", inner[2]["master"], inner_ns[2]["master"])):
        shardings = _nodes(ntree)
        for name, leaf in _nodes(tree).items():
            if isinstance(leaf, jsu.ChunkedHostArray):
                out[f"{kind}/{name}"] = tuple(leaf.row_ranges)
            elif isinstance(leaf, jsu.StackedHostArray):
                k, r = leaf.data.shape[:2]
                out[f"{kind}/{name}"] = tuple((i * r, (i + 1) * r) for i in range(k))
            elif getattr(shardings[name], "memory_kind", None) == "pinned_host":
                out[f"{kind}/{name}"] = ()
            else:
                out[f"{kind}/{name}"] = None
    shapes = {}
    for n, v in _flat(trainable).items():
        shapes[f"mu/{n}"] = (v.shape, torch.float32)
        shapes[f"nu/{n}"] = (v.shape, _torch(v).dtype)
        shapes[f"master/{n}"] = (v.shape, torch.float32)
    return out, shapes


@pytest.mark.parametrize("kw", [dict(block_bytes=256, min_bytes=0),
                                dict(block_bytes=256, min_bytes=0, scan_chunks=True),
                                dict(block_bytes=256, min_bytes=0, chunk=False),
                                dict(block_bytes=1000, min_bytes=100)],
                         ids=["chunked", "scan", "whole", "min_bytes"])
def test_plan_matches_jax_plan_offload_layout(kw):
    """The placement and row blocks of every mu / nu / master tensor are
    those of JAX's plan on a 1x1 CPU mesh (bf16 parameters: nu's bytes are
    half mu's, its blocks the same)."""
    want, shapes = _jax_plan(jnp.bfloat16, **kw)
    got = tsu.plan_offload_layout(shapes, **kw)
    assert got == want
    assert any(v for v in got.values()) or not kw.get("chunk", True)


class _Holder:
    """What CheckpointManager saves and restores (a TrainStep's interface)."""

    def __init__(self, params, opt):
        self.params, self.optimizer, self.step = params, opt, 0

    def state_tensors(self):
        out = {f"params/{n}": p for n, p in self.params.items()}
        out.update({f"opt/{k}": t for k, t in self.optimizer.state_tensors().items()})
        return out

    def load_state_tensors(self, tensors, step):
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(tensors[f"params/{n}"])
        self.optimizer.load_state_tensors(
            {k[4:]: v for k, v in tensors.items() if k.startswith("opt/")}, step)
        self.step = step


def test_chunked_state_round_trips_through_checkpoints_and_resumes_exactly(tmp_path):
    """chunk_state_like / unchunk_state give the state back; a checkpoint of
    the offloaded state has the on-card AdamW's names, dtypes and bytes; a
    run resumed from it takes the uninterrupted run's updates bit for bit;
    a checkpoint with an f32 second moment (written before nu followed the
    parameters' dtype) loads, cast to bf16."""
    cj, ct = _cfgs(learning_rate=1e-3, stage="finetune", master_weights=True, total_steps=50)
    trainable = _trainable(_params(jnp.bfloat16), cj)
    grads = [{n: _torch(v) for n, v in _flat(_grads(trainable, 10 + i)).items()} for i in range(4)]

    def holder(cls, **kw):
        params = _port_params(trainable)
        return _Holder(params, cls(params.items(), ct, **kw))

    off = holder(tsu.OffloadedAdamW, block_bytes=256, min_bytes=0)
    card = holder(topt.AdamW)
    for g in grads[:2]:
        off.optimizer.step(g)
        card.optimizer.step(g)
    state = off.optimizer.state_tensors()
    chunked = tsu.chunk_state_like(state, off.optimizer.plan)
    assert any(len(v) > 1 for v in chunked.values())
    for k, t in tsu.unchunk_state(chunked).items():
        assert torch.equal(t, state[k]), k
    mgr_off, mgr_card = CheckpointManager(str(tmp_path / "off")), CheckpointManager(str(tmp_path / "card"))
    mgr_off.save(2, off)
    mgr_card.save(2, card)
    a = torch.load(tmp_path / "off" / "2" / "state.pt", weights_only=True)["tensors"]
    b = torch.load(tmp_path / "card" / "2" / "state.pt", weights_only=True)["tensors"]
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for g in grads[2:]:
        off.optimizer.step(g)
    resumed = holder(tsu.OffloadedAdamW, block_bytes=256, min_bytes=0)
    mgr_off.restore(resumed)
    assert resumed.optimizer.count == 2
    for g in grads[2:]:
        resumed.optimizer.step(g)
    for n, p in off.params.items():
        assert torch.equal(p, resumed.params[n]), n
    final = off.optimizer.state_tensors()
    for k, t in resumed.optimizer.state_tensors().items():
        assert torch.equal(t, final[k]), k
    old = {k: (v.float() if k.startswith("opt/nu/") else v) for k, v in a.items()}
    legacy = holder(tsu.OffloadedAdamW, block_bytes=256, min_bytes=0)
    legacy.load_state_tensors(old, 2)
    for k, t in legacy.optimizer.state_tensors().items():
        assert t.dtype == a["opt/" + k].dtype and torch.equal(t, a["opt/" + k]), k


@pytest.mark.parametrize("mu_dtype,wd,gscale", [
    ("float32", 0.0, (0.01, 0.5)), ("float32", 0.1, (0.01, 0.5)),
    ("bfloat16", 0.0, (0.01, 0.5)), ("bfloat16", 0.1, (0.3,)),
])
def test_adamw_on_bf16_matches_optax_bit_for_bit(mu_dtype, wd, gscale):
    """C18: the AdamW keeps nu in the parameter's dtype (and mu in
    mu_dtype), as optax does, and computes in bf16 where optax's update
    does. A bf16 projector (64 x 48 kernel, 64 bias) and bf16 gradients, lr
    2e-3, stage pretrain, 10 updates (steps that clip and steps that do
    not, with and without weight decay): the parameters, nu and a bf16 mu
    are bit-equal to make_optimizer's, an f32 mu lies within 1e-6 of its
    largest (f32 roundings) (before the repair: 378 of 3072 kernel elements
    and 10 of 64 biases differed, by one bf16 ulp)."""
    rng = np.random.default_rng(0)
    w = rng.normal(scale=0.2, size=(64, 48)).astype(np.float32)
    b = rng.normal(scale=0.2, size=(64,)).astype(np.float32)
    params = {"mm_projector": {"layers": [{"kernel": jnp.asarray(w, jnp.bfloat16),
                                           "bias": jnp.asarray(b, jnp.bfloat16)}]}}
    cj, ct = _cfgs(learning_rate=2e-3, stage="pretrain", weight_decay=wd, mu_dtype=mu_dtype)
    tx = jopt.make_optimizer(params, cj)
    st = tx.init(params)
    update, apply = jax.jit(tx.update), jax.jit(optax.apply_updates)

    def port_view(tree):
        leaf = tree["mm_projector"]["layers"][0]
        return {"mm_projector.layers.0.weight": _torch(leaf["kernel"]).T.contiguous(),
                "mm_projector.layers.0.bias": _torch(leaf["bias"])}

    tp = {n: torch.nn.Parameter(t) for n, t in port_view(params).items()}
    opt = topt.AdamW(tp.items(), ct)
    assert opt.nu["mm_projector.layers.0.weight"].dtype == torch.bfloat16
    assert opt.mu["mm_projector.layers.0.weight"].dtype == getattr(torch, mu_dtype)
    p = params
    for i in range(10):
        r = np.random.default_rng(100 + i)
        s = gscale[i % len(gscale)]
        g = {"mm_projector": {"layers": [{
            "kernel": jnp.asarray(r.normal(scale=s, size=(64, 48)).astype(np.float32), jnp.bfloat16),
            "bias": jnp.asarray(r.normal(scale=s, size=(64,)).astype(np.float32), jnp.bfloat16)}]}}
        u, st = update(g, st, p)
        p = apply(p, u)
        gnorm = opt.step(port_view(g))
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(g)), rtol=1e-2)
    for n, t in port_view(p).items():
        assert torch.equal(tp[n].detach(), t), n
    adam = st.inner_states["base"].inner_state[1][0]
    for kind, tree in (("mu", adam.mu), ("nu", adam.nu)):
        for n, t in port_view(tree).items():
            got = getattr(opt, kind)[n]
            assert got.dtype == t.dtype, (kind, n)
            _near_or_equal(got, t.float().numpy(), (kind, n))
