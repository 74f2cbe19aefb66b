"""The model's work, in floating-point operations of its matrix products and
attention, from a configuration file's `model` section. Frozen weights get
no weight gradient and recomputation (remat) is not charged: this is the
work the model needs, not the work a policy repeats. Products run on the
real (unpadded) tokens, attention on the real causal pairs; the heads read
the padded rows they are given."""

from __future__ import annotations

from typing import Sequence


def decoder_linear_params(d: dict) -> int:
    """Weights of one token's pass through the blocks (without the head)."""
    h, hd, m = d["hidden_size"], d["head_dim"], d["mlp_dim"]
    per = h * (d["num_heads"] + 2 * d["num_kv_heads"]) * hd + d["num_heads"] * hd * h + 3 * h * m
    return d["num_layers"] * per


def attn_pairs_causal(lengths: Sequence[int]) -> int:
    return sum(n * (n + 1) // 2 for n in lengths)


def vit_forward(v: dict, layers: int, final_tokens: int = 0) -> float:
    """One image through `layers` ViT blocks (patch embedding included)."""
    h, m = v["hidden_size"], v["mlp_dim"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + int(v.get("use_class_token", True))
    f = 2.0 * (n - int(v.get("use_class_token", True))) * 3 * v["patch_size"] ** 2 * h
    f += layers * (2.0 * n * (4 * h * h + 2 * h * m) + 4.0 * n * n * h)
    return f + 2.0 * final_tokens * h * v.get("projection_dim", 0)


def convnext_forward(c: dict) -> float:
    """One image through the ConvNeXt trunk: stem, downsamples, depthwise 7x7
    and the two 4x MLP products of every block."""
    side = c["image_size"] // 4
    dims = c["dims"]
    f = 2.0 * side * side * dims[0] * 3 * 16
    for s, (depth, d) in enumerate(zip(c["depths"], dims)):
        n = (c["image_size"] // (4 * 2 ** s)) ** 2
        if s:
            f += 2.0 * n * dims[s - 1] * d * 4
        f += depth * n * (2.0 * 49 * d + 16.0 * d * d)
    return f


def swin_forward(s: dict, image_size: int) -> float:
    side = image_size // s["patch_size"]
    ws = s["window_size"]
    f = 2.0 * side * side * 3 * s["patch_size"] ** 2 * s["embed_dim"]
    for st, depth in enumerate(s["depths"]):
        d = s["embed_dim"] * 2 ** st
        n = (side // 2 ** st) ** 2
        hid = int(d * s["mlp_ratio"])
        f += depth * (2.0 * n * (4 * d * d + 2 * d * hid) + 4.0 * n * ws * ws * d)
        if st < len(s["depths"]) - 1:
            f += 2.0 * (n // 4) * 4 * d * 2 * d
    return f


def tower_forward(m: dict) -> float:
    t = m["tower"]
    if t["kind"] == "convnext":
        return convnext_forward(t)
    return vit_forward(t, t["select_layer"] % t["num_layers"] + 1)


def projector_forward(m: dict, tokens: int) -> float:
    p = m["projector"]
    return 2.0 * tokens * (p["input_dim"] * p["output_dim"]
                           + (p["mlp_depth"] - 1) * p["output_dim"] ** 2)


def teachers_forward(m: dict) -> float:
    """One image through each teacher the tasks read."""
    t = m["teachers"]
    tasks = {task["task"] for task in m["distill"]["tasks"]}
    f = 0.0
    if "depth" in tasks:
        f += vit_forward(t["dinov2"], max(t["dinov2"]["layers"]) + 1)
    if "gen" in tasks:
        f += vit_forward(t["clip_h"], t["clip_h"]["num_layers"], final_tokens=1)
    if "seg" in tasks:
        f += swin_forward(t["swin"], t["swin"]["image_size"])
    return f


def heads_forward(m: dict, t_padded: int) -> float:
    """One row's distillation heads over a padded sequence of t_padded."""
    from benchmark.reference.spec import head_dims

    d = m["distill"]
    h = m["decoder"]["hidden_size"]
    n_tasks = len(d["tasks"])
    n_in = t_padded - d["num_task_tokens"] * (n_tasks - 1)
    f = 0.0
    for task in d["tasks"]:
        inner, od = head_dims(m, task)
        hd = task["head"]
        n_lat, ai = hd["num_tokens"], hd["dim_head"] * hd["num_heads"]
        lat_in = d["num_task_tokens"] if task["task"] == "gen" else n_lat
        one = 2.0 * (n_in + lat_in) * h * inner
        for _ in range(hd["depth"]):
            one += 2.0 * n_lat * inner * ai + 2.0 * (n_in + n_lat) * inner * 2 * ai
            one += 4.0 * n_lat * (n_in + n_lat) * ai + 2.0 * n_lat * ai * inner
            one += 4.0 * n_lat * inner * inner * hd["ff_mult"]
        one += 2.0 * n_lat * inner * od
        f += one * len(task["layer_indices"])
    return f


def train_step(m: dict, stage: str, lengths: Sequence[int], t_padded: int) -> float:
    """One micro-batch's model work: rows of the given real lengths, padded to
    t_padded. PT trains the projector, task tokens and heads (the decoder's
    weights are frozen: forward plus the input gradient, 4 x weights x
    tokens); IFT trains the decoder and projector (6 x)."""
    d = m["decoder"]
    rows, tokens = len(lengths), sum(lengths)
    head_w = d["vocab_size"] * d["hidden_size"]
    dec = decoder_linear_params(d) + head_w
    mult = 4.0 if stage == "pretrain" else 6.0
    f = mult * dec * tokens
    f += 12.0 * d["num_heads"] * d["head_dim"] * attn_pairs_causal(lengths) * d["num_layers"]
    n_img = m["num_image_tokens"]
    f += rows * tower_forward(m) + 3.0 * projector_forward(m, rows * n_img)
    if stage == "pretrain" and m.get("distill"):
        f += 3.0 * rows * heads_forward(m, t_padded) + rows * teachers_forward(m)
    return f


def served_request(m: dict, prompt: int, generated: int) -> float:
    """A served request: its image through the tower and projector, the
    prompt's prefill (one position's logits) and one decode step per token
    after the first, each over the cache it has."""
    d = m["decoder"]
    p = decoder_linear_params(d)
    head_w = d["vocab_size"] * d["hidden_size"]
    attn = 4.0 * d["num_heads"] * d["head_dim"] * d["num_layers"]
    f = tower_forward(m) + projector_forward(m, m["num_image_tokens"])
    f += 2.0 * p * prompt + attn * prompt * (prompt + 1) / 2 + 2.0 * head_w
    for j in range(1, generated):
        f += 2.0 * (p + head_w) + attn * (prompt + j)
    return f
