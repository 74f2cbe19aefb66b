"""Quantized serving weights: the port's quantizers, QuantLinear and the w4
matmul's plain version vs the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the JAX side
runs as its own tests do (the Pallas w4 kernel in interpret mode).
Tolerances: quantized int8 arrays equal (bit for bit; the AWQ scale s comes
from log/exp, which XLA evaluates with its own approximations, so s may
differ in the last bit: scales rtol 1e-6); QuantLinear vs JAX `linear` rtol
1e-5 in f32; `w4_matmul_reference` vs the Pallas kernel 1e-4 x max|ref| in
f32 (group partials summed in another order) and 1e-2 in bf16 (the output's
rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm
from visper_lm_tpu.ops.quant_matmul import w4_matmul as j_w4_matmul
from visper_lm_tpu.ops.quant_matmul import w4_supported as j_w4_supported
from visper_lm_tpu.utils import param as jparam

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models.decoder import LINEAR_NAMES, quantize_decoder
from visper_lm_tpu_torch.ops import quant_matmul as tqm
from visper_lm_tpu_torch.utils import param as tparam
from visper_lm_tpu_torch.utils.param import QuantLinear
from visper_lm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_quant(kind, w, act_rms=None, group=128):
    """JAX's quantized leaves for one (din, dout) kernel."""
    if kind == "int8":
        return jparam.quantize_linear_weights({"p": {"kernel": w}})["p"]
    rms = None if act_rms is None else {"p": jnp.asarray(act_rms)}
    return jparam.quantize_linear_weights_int4({"p": {"kernel": w}}, group=group, act_rms=rms)["p"]


def _port_buffers(jq):
    """JAX leaves -> QuantLinear buffer names, as numpy."""
    names = {"kernel_q8": "weight_q8", "kernel_q4p": "weight_q4p"}
    return {names.get(k, k): np.asarray(v) for k, v in jq.items()}


QUANT_CASES = {
    "int8_f32": dict(kind="int8", din=256, dout=192),
    "int8_bf16": dict(kind="int8", din=256, dout=192, bf16=True),
    "int4": dict(kind="int4", din=512, dout=160),
    "int4_bf16": dict(kind="int4", din=384, dout=96, bf16=True),
    "int4_awq": dict(kind="int4", din=512, dout=160, awq=True),
    "int4_awq_bf16": dict(kind="int4", din=256, dout=128, bf16=True, awq=True),
    "int4_group_fallback_din64": dict(kind="int4", din=64, dout=48, awq=True),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantizers_match_jax(case):
    c = QUANT_CASES[case]
    rng = np.random.default_rng(0)
    w = (0.05 * rng.standard_normal((c["din"], c["dout"]))).astype(np.float32)
    if c.get("bf16"):
        w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    rms = np.exp(rng.uniform(-2, 2, size=c["din"])).astype(np.float32) if c.get("awq") else None
    dtype = jnp.bfloat16 if c.get("bf16") else jnp.float32
    ref = _port_buffers(_jax_quant(c["kind"], jnp.asarray(w, dtype), rms))
    wt = _t(w).to(torch.bfloat16 if c.get("bf16") else torch.float32)
    if c["kind"] == "int8":
        got = tparam.quantize_linear_int8(wt)
    else:
        got = tparam.quantize_linear_int4(wt, 128, None if rms is None else _t(rms))
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if r.dtype == np.int8:
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=0, err_msg=name)
    if case == "int4_group_fallback_din64":
        assert got["q4_scale"].shape == (1, 48)        # group 128 > din: one group of 64


def test_int4_stays_dense_when_no_group_divides_din():
    w = np.zeros((24, 8), np.float32)
    assert tparam.quantize_linear_int4(_t(w)) is None
    assert "kernel" in _jax_quant("int4", jnp.asarray(w))


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_awq"])
def test_quant_linear_cpu_branches_match_jax_linear(kind):
    """QuantLinear built from JAX's leaves vs JAX `linear` on the same x (f32):
    kernel_q8's scaled product, kernel_q4p's dequantized product (with the
    AWQ rescale of x)."""
    rng = np.random.default_rng(1)
    din, dout = 256, 96
    w = (0.05 * rng.standard_normal((din, dout))).astype(np.float32)
    x = rng.standard_normal((3, 5, din)).astype(np.float32)
    rms = np.exp(rng.uniform(-1, 1, size=din)).astype(np.float32) if kind == "int4_awq" else None
    jq = _jax_quant(kind[:4], jnp.asarray(w), rms)
    layer = QuantLinear(**{k: _t(v) for k, v in _port_buffers(jq).items()})
    got = layer(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jparam.linear(jq, x)), rtol=1e-5, atol=1e-6)


W4_CASES = [(512, 384, 16, 128), (256, 500, 8, 64), (1024, 320, 1, 128), (512, 256, 384, 128)]


@pytest.mark.parametrize("din,dout,m,group", W4_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4_reference_matches_pallas_interpret(din, dout, m, group, dtype):
    """The kernel's plain version vs the Pallas kernel (interpret mode) at
    tests/test_quant_matmul.py's four cases."""
    rng = np.random.default_rng(0)
    w = (0.05 * rng.standard_normal((din, dout))).astype(np.float32)
    jq = _jax_quant("int4", jnp.asarray(w), group=group)
    x = rng.standard_normal((m, din)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    ref = np.asarray(
        j_w4_matmul(xj, jq["kernel_q4p"], jq["q4_scale"], group=group, interpret=True), np.float32
    )
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    before = tqm.launches
    got = tqm.w4_matmul(xt, _t(jq["kernel_q4p"]), _t(jq["q4_scale"]), group)
    assert tqm.launches == before                     # CPU tensors: the plain version
    assert got.dtype == xt.dtype and tuple(got.shape) == (m, dout)
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert np.abs(got.float().numpy() - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize(
    "din,groups,x_din",
    [(256, 2, 256), (256, 32, 256), (256, 128, 256), (250, 50, 250), (256, 3, 256),
     (256, 2, 128), (256, 256, 256)],
)
def test_w4_gate_is_the_jax_gate(din, groups, x_din):
    """`w4_supported` sends a packed linear to the kernel exactly when JAX's
    gate would (groups 128, 8, 2 pass; 5, an uneven split, a din mismatch
    and group 1 do not)."""
    packed = np.zeros((din // 2, 8), np.int8)
    scales = np.ones((groups, 8), np.float32)
    x = np.zeros((3, x_din), np.float32)
    want = j_w4_supported({"kernel_q4p": packed, "q4_scale": scales}, jnp.asarray(x))
    assert tqm.w4_supported(_t(packed), _t(scales), _t(x)) == want


# (din, dout, group) of the serving path's linears (Phi3-mini) and of the card tests
W4_SERVING_SHAPES = [(3072, 3072, 128), (3072, 8192, 128), (8192, 3072, 128), (3072, 32064, 128)]
# Llama-3-8B's and Vicuna-7B's linears: q/o, k/v, gate/up, down, lm_head
W4_LLAMA_SHAPES = [(4096, 4096, 128), (4096, 1024, 128), (4096, 14336, 128), (14336, 4096, 128),
                   (4096, 128256, 128), (4096, 11008, 128), (11008, 4096, 128), (4096, 32000, 128)]
W4_CARD_SHAPES = [(512, 384, 128), (256, 500, 64), (1024, 320, 32), (384, 256, 16),
                  (512, 336, 128), (128, 256, 128), (256, 192, 128), (8192, 64, 128)]


@pytest.mark.parametrize("din,dout,group", W4_SERVING_SHAPES + W4_LLAMA_SHAPES + W4_CARD_SHAPES)
def test_w4_split_plan_covers_every_group_once(din, dout, group):
    """The split-K plan cuts K on group boundaries: the splits' group ranges,
    as the kernel derives them from (groups per split, splits), are disjoint,
    in order and cover every group; no split is empty; the cluster holds
    them; and the serving shapes get more CTAs than an H100 has SMs."""
    gps, splits = tqm.w4_split_plan(din, dout, group)
    groups = din // group
    ranges = [(s * gps, min(groups, (s + 1) * gps)) for s in range(splits)]
    assert all(lo < hi for lo, hi in ranges)
    assert [g for lo, hi in ranges for g in range(lo, hi)] == list(range(groups))
    assert 1 <= splits <= tqm.SPLITK_MAX_SPLITS
    if (din, dout, group) in W4_SERVING_SHAPES:
        assert -(-dout // tqm.SPLITK_TILE_N) * splits > 132


@pytest.mark.parametrize("m", [1, 8, 16, 17, 100, 256, 300, 6144])
@pytest.mark.parametrize("din,dout,group", W4_SERVING_SHAPES + W4_LLAMA_SHAPES + W4_CARD_SHAPES)
def test_w4_gate_names_a_kernel_for_every_shape(m, din, dout, group):
    """Every (M, din, dout, group) of the serving path and of the card tests
    goes to a named hand-written kernel whose constraints it meets."""
    name = tqm.w4_kernel_for(m, din, dout, group)
    assert name in tqm.KERNEL_IDS
    if name == "splitk":
        assert m <= tqm.SPLITK_MAX_M and tqm.w4_split_plan(din, dout, group) is not None
    elif name == "wgmma":
        assert m > tqm.SPLITK_MAX_M and group % 64 == 0 and dout % 16 == 0
    if (din, dout, group) in W4_SERVING_SHAPES + W4_LLAMA_SHAPES:
        assert name == ("splitk" if m <= 16 else "wgmma")


@pytest.mark.parametrize(
    "m,din,dout,group,want",
    [(8, 1024, 64, 1024, "mma_sync"),      # a group of more than eight 64-k chunks
     (8, 1152, 64, 144, "mma_sync"),       # 144 = 9 chunks of 16
     (300, 256, 500, 64, "mma_sync"),      # dout not a multiple of 16
     (300, 1024, 320, 32, "mma_sync"),     # group not a multiple of 64
     (300, 512, 336, 128, "wgmma"), (16, 512, 336, 128, "splitk")],
)
def test_w4_gate_remainder_goes_to_the_mma_sync_kernel(m, din, dout, group, want):
    assert tqm.w4_kernel_for(m, din, dout, group) == want


@pytest.mark.parametrize("din,group", [(256, 8), (256, 24), (250, 50), (256, 96), (256, 0)])
def test_w4_gate_raises_for_a_group_no_kernel_runs(din, group):
    """Never the plain version: a group that is no multiple of 16 dividing
    din raises, and the split-K plan has no answer for it."""
    for m in (8, 300):
        with pytest.raises(ValueError, match="group"):
            tqm.w4_kernel_for(m, din, 64, group)
    assert tqm.w4_split_plan(din, 64, group) is None


def test_unpack_matches_the_jax_layout():
    """Nibble unpack through int32: every packed byte value, both nibbles."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(128, 2)
    got = tqm.unpack_int4(_t(packed)).numpy()
    low = (packed.astype(np.int32) << 28) >> 28
    high = packed.astype(np.int32) >> 4
    np.testing.assert_array_equal(got, np.stack([low, high], axis=1).reshape(256, 2))
    assert got.min() == -8 and got.max() == 7


@pytest.fixture(scope="module")
def tiny_params():
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = jax.tree_util.tree_map(np.asarray, j_init_vlm(jax.random.PRNGKey(0), cfg_j))
    return cfg_t, params


@pytest.mark.parametrize("mode", ["int8", "int4", "int4_awq"])
def test_weights_from_jax_quantized_tree_match_the_port_quantizer(tiny_params, mode):
    """from_jax_params on a decoder quantized by JAX gives QuantLinears whose
    buffers equal quantize_decoder's on the same weights."""
    cfg_t, params = tiny_params
    d = cfg_t.decoder
    rms = None
    if mode == "int4_awq":
        rng = np.random.default_rng(2)
        rms = {n: np.exp(rng.uniform(-1, 1, size=(d.num_layers, d.mlp_dim if n == "down_proj" else d.hidden_size))).astype(np.float32)
               for n in LINEAR_NAMES}
        rms["lm_head"] = np.exp(rng.uniform(-1, 1, size=d.hidden_size)).astype(np.float32)
    if mode == "int8":
        qdec = jparam.quantize_linear_weights(params["decoder"])
    else:
        qdec = jparam.quantize_linear_weights_int4(
            params["decoder"], act_rms=None if rms is None else {k: jnp.asarray(v) for k, v in rms.items()}
        )
    qtree = {**params, "decoder": jax.tree_util.tree_map(np.asarray, qdec)}
    loaded = from_jax_params(qtree, tconfig.tiny_test_vlm(distill=True), device="cpu").decoder
    dense = from_jax_params(params, cfg_t, device="cpu").decoder
    ours = quantize_decoder(dense, mode[:4], act_rms=rms)
    layers = [(f"blocks.{i}.{n}", getattr(b, n), getattr(o, n))
              for i, (b, o) in enumerate(zip(loaded.blocks, ours.blocks)) for n in LINEAR_NAMES]
    layers.append(("lm_head", loaded.lm_head, ours.lm_head))
    for name, a, b in layers:
        assert isinstance(a, QuantLinear) and isinstance(b, QuantLinear), name
        bufs_a, bufs_b = dict(a.named_buffers()), dict(b.named_buffers())
        assert set(bufs_a) == set(bufs_b), name
        for k in bufs_a:
            if bufs_a[k].dtype == torch.int8:
                assert torch.equal(bufs_a[k], bufs_b[k]), (name, k)
            else:
                np.testing.assert_allclose(bufs_a[k].numpy(), bufs_b[k].numpy(), rtol=1e-6, err_msg=f"{name}.{k}")
    # the caller's decoder is untouched and shared only in the embedding/norms
    assert isinstance(dense.blocks[0].q_proj, torch.nn.Linear)
    assert ours.embed_tokens is dense.embed_tokens and ours.blocks[1].attn_norm is dense.blocks[1].attn_norm
