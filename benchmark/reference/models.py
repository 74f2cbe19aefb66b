"""Plain float32 forward passes of the benchmark's models.

Written from the models' published descriptions (LLaVA's splice, Phi-3's
pre-norm decoder with rotary positions and a SiLU-gated MLP, CLIP and DINOv2
ViTs, the OpenCLIP ConvNeXt trunk, the Swin backbone, the OLA-VLM
perceiver-resampler heads and losses). Every product runs in float32 with
TF32 off (`strict_float32`); `prec="fp8"` runs every linear layer and every
attention product as float8 training does (`matmul`: both operands in e4m3,
the incoming gradient in e5m2, each under a per-tensor scale), the precision
below the configurations' bfloat16 (the control of the output checks); norms,
softmax, convolutions and the losses stay float32.

Weights come from a `Weights` (reference/weights.py) under the names of
reference/spec.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE_INDEX = -100
SEG_PAD, SEG_TEXT, SEG_IMAGE, SEG_TASK = 0, 1, 2, 3


def strict_float32() -> None:
    """No TF32 in float32 products (cuBLAS and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def fp8_round(x: torch.Tensor, fmt: torch.dtype = E4M3) -> torch.Tensor:
    """x rounded to float8 `fmt` under a per-tensor scale (amax to the
    format's largest), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(fmt).max
    return (x / scale).to(fmt).to(torch.float32) * scale


class _MatmulFp8(torch.autograd.Function):
    """a @ b (the same batch dimensions) with both operands rounded to e4m3,
    and in the backward the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = fp8_round(g, E5M2)
        ga = torch.matmul(g8, b8.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        gb = torch.matmul(a8.transpose(-1, -2), g8) if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    return _MatmulFp8.apply(a, b) if prec == "fp8" else torch.matmul(a, b)


class Ctx:
    """A forward's weights and the precision of its products."""

    def __init__(self, W, prec: str = "f32"):
        self.W, self.prec = W, prec

    def lin(self, x: torch.Tensor, name: str, bias: bool = True) -> torch.Tensor:
        w = self.W[name + ".weight"]
        if self.prec == "fp8":
            y = matmul(x.reshape(-1, x.shape[-1]), w.t(), "fp8").reshape(*x.shape[:-1], w.shape[0])
        else:
            y = torch.matmul(x, w.t())
        b = self.W.get(name + ".bias") if bias else None
        return y if b is None else y + b

    def ln(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.W[name + ".scale"], self.W[name + ".bias"], eps)

    def rms(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * self.W[name + ".scale"]


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "silu":
        return F.silu(x)
    return F.gelu(x)


def attention(q, k, v, bias: Optional[torch.Tensor] = None, scale: Optional[float] = None,
              prec: str = "f32"):
    """q (B, N, T, H), k, v (B, N, S, H); bias broadcast to (B, N, T, S)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = matmul(q, k.transpose(-1, -2), prec) * scale
    if bias is not None:
        s = s + bias
    return matmul(torch.softmax(s, dim=-1), v, prec)


# ----------------------------------------------------------------- vision


def vit(c: Ctx, v: dict, prefix: str, images: torch.Tensor, taps: Sequence[int] = (),
        final: bool = False, layerscale: bool = False) -> Dict[str, object]:
    """A ViT on (B, H, W, 3) normalised pixels: {'taps': {layer: block output},
    'last' (final-normed) when final}. Patches flatten channel-major (c, ph, pw)."""
    b, hh, ww, _ = images.shape
    ps, h, nh = v["patch_size"], v["hidden_size"], v["num_heads"]
    eps = v["norm_eps"]
    x = images.float().reshape(b, hh // ps, ps, ww // ps, ps, 3).permute(0, 1, 3, 5, 2, 4)
    x = c.lin(x.reshape(b, -1, 3 * ps * ps), prefix + "patch_embed")
    if v.get("use_class_token", True):
        x = torch.cat([c.W[prefix + "cls_token"].expand(b, 1, h), x], dim=1)
    x = x + c.W[prefix + "pos_embed"]
    if v.get("use_pre_norm", True):
        x = c.ln(x, prefix + "pre_norm", eps)
    n_run = v["num_layers"] if final or not taps else max(taps) + 1
    out: Dict[int, torch.Tensor] = {}
    for i in range(n_run):
        p = f"{prefix}blocks.{i}."
        n = x.shape[1]
        qkv = c.lin(c.ln(x, p + "norm1", eps), p + "qkv").reshape(b, n, 3, nh, h // nh)
        q, k, vv = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        a = c.lin(attention(q, k, vv, prec=c.prec).transpose(1, 2).reshape(b, n, h), p + "proj")
        if layerscale:
            a = a * c.W[p + "ls1.gamma"]
        x = x + a
        y = c.lin(act(v["hidden_act"], c.lin(c.ln(x, p + "norm2", eps), p + "fc1")), p + "fc2")
        if layerscale:
            y = y * c.W[p + "ls2.gamma"]
        x = x + y
        if i in taps:
            out[i] = x
    res: Dict[str, object] = {"taps": out}
    if final:
        res["last"] = c.ln(x, prefix + "final_norm", eps)
    return res


def clip_features(c: Ctx, v: dict, images: torch.Tensor) -> torch.Tensor:
    """LLaVA's CLIP tower features: the select_layer block output, CLS dropped."""
    layer = v["select_layer"] % v["num_layers"]
    feats = vit(c, v, "vision_tower.", images, taps=(layer,))["taps"][layer]
    return feats[:, 1:] if v.get("use_class_token", True) else feats


def _conv(c: Ctx, x: torch.Tensor, name: str, stride: int, padding: int = 0, groups: int = 1):
    """NHWC in and out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), c.W[name + ".weight"], c.W[name + ".bias"],
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def convnext_features(c: Ctx, cn: dict, images: torch.Tensor) -> torch.Tensor:
    """The OpenCLIP ConvNeXt trunk: (B, H, W, 3) -> (B, (H/32)^2, C_last)."""
    eps, p = cn["norm_eps"], "vision_tower."
    x = c.ln(_conv(c, images.float(), p + "stem_conv", 4), p + "stem_norm", eps)
    for s, depth in enumerate(cn["depths"]):
        sp = f"{p}stages.{s}."
        if s:
            x = _conv(c, c.ln(x, sp + "downsample.norm", eps), sp + "downsample.conv", 2)
        for i in range(depth):
            bp = f"{sp}blocks.{i}."
            y = _conv(c, x, bp + "dwconv", 1, padding=3, groups=x.shape[-1])
            y = c.lin(F.gelu(c.lin(c.ln(y, bp + "norm", eps), bp + "fc1")), bp + "fc2")
            x = x + y * c.W[bp + "gamma"]
    x = c.ln(x, p + "norm_pre", eps)
    return x.reshape(x.shape[0], -1, x.shape[-1])


def tower_features(c: Ctx, m: dict, images: torch.Tensor) -> torch.Tensor:
    t = m["tower"]
    return convnext_features(c, t, images) if t["kind"] == "convnext" else clip_features(c, t, images)


def project(c: Ctx, m: dict, feats: torch.Tensor) -> torch.Tensor:
    y = c.lin(feats, "mm_projector.layers.0")
    for i in range(1, m["projector"]["mlp_depth"]):
        y = c.lin(F.gelu(y), f"mm_projector.layers.{i}")
    return y


# ----------------------------------------------------------------- teachers


def dinov2_target(c: Ctx, v: dict, images: torch.Tensor) -> torch.Tensor:
    """Depth-Anything-V2's DINOv2 features: the final-normed patch tokens of
    its intermediate layers, averaged -> (B, N, D)."""
    layers = v["layers"]
    taps = vit(c, v, "dinov2.", images, taps=layers, layerscale=True)["taps"]
    feats = [c.ln(taps[i], "dinov2.final_norm", v["norm_eps"])[:, 1:] for i in layers]
    return torch.stack(feats).mean(0)


def clip_h_target(c: Ctx, v: dict, images: torch.Tensor) -> torch.Tensor:
    """The unCLIP image embedding: CLIP-H's final-normed CLS through its
    visual projection -> (B, 1, P)."""
    last = vit(c, v, "clip_h.", images, final=True)["last"]
    return c.lin(last[:, 0], "clip_h.visual_projection", bias=False)[:, None]


def _rel_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N): -100 between positions of different regions after the roll."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)


def swin_target(c: Ctx, s: dict, images: torch.Tensor) -> torch.Tensor:
    """The Swin backbone's last stage, out-normed and flattened -> (B, N, C)."""
    p, eps, ws = "swin.", s["norm_eps"], s["window_size"]
    x = c.ln(_conv(c, images.float(), p + "patch_embed", s["patch_size"]), p + "patch_norm", eps)
    dev = x.device
    rel = torch.as_tensor(_rel_index(ws), device=dev).reshape(-1)
    n = ws * ws
    last = len(s["depths"]) - 1
    for st, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
        b, h, w, ch = x.shape
        shift = ws // 2 if min(h, w) > ws else 0
        mask = torch.as_tensor(_shift_mask(h, w, ws, shift), device=dev) if shift else None
        nw = (h // ws) * (w // ws)
        for i in range(depth):
            bp = f"{p}stages.{st}.blocks.{i}."
            sh = shift if i % 2 == 1 else 0
            y = c.ln(x, bp + "norm1", eps)
            if sh:
                y = torch.roll(y, shifts=(-sh, -sh), dims=(1, 2))
            y = y.reshape(b, h // ws, ws, w // ws, ws, ch).permute(0, 1, 3, 2, 4, 5).reshape(-1, n, ch)
            qkv = c.lin(y, bp + "qkv").reshape(-1, n, 3, heads, ch // heads)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            bias = c.W[bp + "rel_bias"][rel].reshape(n, n, heads).permute(2, 0, 1)[None]
            if sh:
                bias = (bias.reshape(1, 1, heads, n, n) + mask[None, :, None]).reshape(-1, heads, n, n)
                bias = bias.repeat(b, 1, 1, 1) if bias.shape[0] != b * nw else bias
                bias = bias.reshape(b * nw, heads, n, n)
            o = attention(q, k, v, bias, prec=c.prec).transpose(1, 2).reshape(-1, n, ch)
            o = c.lin(o, bp + "proj").reshape(b, h // ws, w // ws, ws, ws, ch)
            o = o.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, ch)
            if sh:
                o = torch.roll(o, shifts=(sh, sh), dims=(1, 2))
            x = x + o
            x = x + c.lin(F.gelu(c.lin(c.ln(x, bp + "norm2", eps), bp + "fc1")), bp + "fc2")
        if st == last:
            out = c.ln(x, f"{p}out_norms.{st}", eps)
            return out.reshape(b, h * w, ch)
        xr = x.reshape(b, h // 2, 2, w // 2, 2, ch)
        x = torch.cat([xr[:, :, 0, :, 0], xr[:, :, 1, :, 0], xr[:, :, 0, :, 1], xr[:, :, 1, :, 1]], -1)
        x = c.lin(c.ln(x, f"{p}stages.{st}.downsample.norm", eps), f"{p}stages.{st}.downsample.reduction",
                  bias=False)
    raise AssertionError("unreachable")


def teacher_targets(c: Ctx, m: dict, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    t = m["teachers"]
    tasks = {task["task"] for task in m["distill"]["tasks"]}
    out = {}
    with torch.no_grad():
        if "depth" in tasks:
            out["depth"] = dinov2_target(c, t["dinov2"], batch["depth_images"])
        if "gen" in tasks:
            out["gen"] = clip_h_target(c, t["clip_h"], batch["gen_images"])
        if "seg" in tasks:
            out["seg"] = swin_target(c, t["swin"], batch["seg_images"])
    return out


# ----------------------------------------------------------------- decoder


def rope(positions: torch.Tensor, hd: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (B, T, hd) for the half-rotation convention."""
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=positions.device) / half)
    ang = positions.double()[..., None] * inv
    ang = torch.cat([ang, ang], -1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rot(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def decoder_block(c: Ctx, d: dict, i: int, h: torch.Tensor, cos, sin, bias, kv_out=None):
    p = f"decoder.blocks.{i}."
    b, t, _ = h.shape
    nh, nkv, hd = d["num_heads"], d["num_kv_heads"], d["head_dim"]
    x = c.rms(h, p + "attn_norm", d["norm_eps"])
    cs, sn = cos[:, :, None], sin[:, :, None]
    q = _rot(c.lin(x, p + "q_proj", False).reshape(b, t, nh, hd), cs, sn).transpose(1, 2)
    k = _rot(c.lin(x, p + "k_proj", False).reshape(b, t, nkv, hd), cs, sn).transpose(1, 2)
    v = c.lin(x, p + "v_proj", False).reshape(b, t, nkv, hd).transpose(1, 2)
    if kv_out is not None:
        kv_out.append((k.transpose(1, 2), v.transpose(1, 2)))
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
    a = attention(q, k, v, bias, prec=c.prec).transpose(1, 2).reshape(b, t, nh * hd)
    h = h + c.lin(a, p + "o_proj", False)
    x = c.rms(h, p + "mlp_norm", d["norm_eps"])
    g = c.lin(x, p + "gate_proj", False)
    u = c.lin(x, p + "up_proj", False)
    return h + c.lin(F.silu(g) * u, p + "down_proj", False)


def decoder(c: Ctx, d: dict, embeds: torch.Tensor, kv_lengths: torch.Tensor,
            taps: Sequence[int] = (), remat: bool = False,
            positions: Optional[torch.Tensor] = None, kv_out=None) -> Dict[str, object]:
    """Causal decoder over right-padded rows (keys at or past a row's length
    masked): {'hidden' (final-normed), 'taps': [block outputs at taps]}.
    remat: each block checkpointed (the recompute is the same float32 math).
    kv_out: a list that gets each layer's (k after rotary, v), (B, T, Nkv, H)."""
    b, t, _ = embeds.shape
    dev = embeds.device
    pos = torch.arange(t, device=dev)[None].expand(b, t) if positions is None else positions
    cos, sin = rope(pos, d["head_dim"], d["rope_theta"])
    key = torch.arange(t, device=dev)
    allowed = (key[None, :] <= key[:, None])[None] & (key[None, None, :] < kv_lengths[:, None, None])
    bias = torch.where(allowed, 0.0, float("-inf"))[:, None].float()
    h = embeds
    tapped: List[torch.Tensor] = []
    for i in range(d["num_layers"]):
        if remat and torch.is_grad_enabled():
            h = checkpoint(decoder_block, c, d, i, h, cos, sin, bias, use_reentrant=False)
        else:
            h = decoder_block(c, d, i, h, cos, sin, bias, kv_out)
        if i in taps:
            tapped.append(h)
    return {"hidden": c.rms(h, "decoder.final_norm", d["norm_eps"]), "taps": tapped}


def logits(c: Ctx, m: dict, hidden: torch.Tensor) -> torch.Tensor:
    name = "decoder.embed_tokens" if m["decoder"].get("tie_embeddings") else "decoder.lm_head"
    return c.lin(hidden, name, bias=False)


# ----------------------------------------------------------------- assembly


def task_order(m: dict) -> List[str]:
    names = {t["task"] for t in m["distill"]["tasks"]}
    return [t for t in m["distill"]["mode"].split("-") if t in names]


def task_table(c: Ctx, m: dict) -> Optional[torch.Tensor]:
    d = m.get("distill")
    if not d or d["num_task_tokens"] == 0:
        return None
    nt, rows = d["num_task_tokens"], []
    for task in task_order(m):
        tok = c.W[f"special_tokens.{task}"]
        rows.append(tok if task == "gen" else tok.reshape(nt, -1, tok.shape[-1]).mean(1))
    return torch.cat(rows, 0)


def splice(c: Ctx, m: dict, text_ids, token_type, src_index, image_feats) -> torch.Tensor:
    """LLaVA's inputs_embeds from a splice plan: text embeddings, image
    feature rows, task-token rows, zeros at padding."""
    emb = c.W["decoder.embed_tokens.weight"][text_ids.long()]
    src = src_index.long()
    if image_feats is not None:
        idx = src.clamp(0, image_feats.shape[1] - 1)
        img = torch.gather(image_feats, 1, idx[..., None].expand(-1, -1, image_feats.shape[-1]))
        emb = torch.where((token_type == SEG_IMAGE)[..., None], img, emb)
    table = task_table(c, m)
    if table is not None:
        emb = torch.where((token_type == SEG_TASK)[..., None], table[src.clamp(0, table.shape[0] - 1)], emb)
    return torch.where((token_type == SEG_PAD)[..., None], torch.zeros_like(emb), emb)


# ----------------------------------------------------------------- heads and losses


def resampler(c: Ctx, m: dict, task: dict, j: int, x: torch.Tensor, latents: torch.Tensor):
    p = f"heads.{task['task']}.{j}.resampler."
    hd = task["head"]
    n_tok = hd["num_tokens"]
    b, mm = latents.shape[0], latents.shape[1]
    if mm != n_tok:
        if n_tok > 1 and n_tok % mm == 0:
            latents = latents.repeat(1, n_tok // mm, 1)
        else:
            latents = latents.mean(1, keepdim=True).expand(b, n_tok, latents.shape[-1])
    lat = c.lin(latents, p + "proj_in")
    x = c.lin(x, p + "proj_in")
    dh, nh = hd["dim_head"], hd["num_heads"]
    for k in range(hd["depth"]):
        lp = f"{p}layers.{k}."
        xa = c.ln(x, lp + "attn.norm1", 1e-5)
        la = c.ln(lat, lp + "attn.norm2", 1e-5)
        q = c.lin(la, lp + "attn.to_q", False)
        kv = c.lin(torch.cat([xa, la], 1), lp + "attn.to_kv", False)
        kk, vv = kv.chunk(2, dim=-1)

        def split(z):
            return z.reshape(b, z.shape[1], nh, dh).transpose(1, 2)

        s = dh ** -0.25
        w = torch.softmax(matmul(split(q) * s, (split(kk) * s).transpose(-1, -2), c.prec), -1)
        o = matmul(w, split(vv), c.prec).transpose(1, 2).reshape(b, n_tok, nh * dh)
        lat = c.lin(o, lp + "attn.to_out", False) + lat
        f = c.ln(lat, lp + "ff.norm", 1e-5)
        lat = c.lin(F.gelu(c.lin(f, lp + "ff.fc1", False)), lp + "ff.fc2", False) + lat
    return c.ln(c.lin(lat, p + "proj_out"), p + "norm_out", 1e-5)


def head_predictions(c: Ctx, m: dict, taps: Dict[int, torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
    d = m["distill"]
    ns, ni, nt = m["num_sys_tokens"], m["num_image_tokens"], d["num_task_tokens"]
    order = task_order(m)
    all_end = ns + ni + nt * len(order)
    preds: Dict[str, List[torch.Tensor]] = {}
    for task in d["tasks"]:
        name = task["task"]
        start = ns + ni + nt * order.index(name)
        out = []
        for j, layer in enumerate(task["layer_indices"]):
            st = taps[layer]
            parts = [st[:, : ns + ni], st[:, start:start + nt]]
            if d["pass_text_to_aux"]:
                parts.append(st[:, all_end:])
            inp = torch.cat(parts, 1)
            if name == "gen":
                lat = st[:, start:start + nt]
            else:
                tok = c.W[f"special_tokens.{name}"]
                lat = tok.expand(inp.shape[0], *tok.shape)
            out.append(resampler(c, m, task, j, inp, lat))
        preds[name] = out
    return preds


def ntp_loss(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lab = labels[:, 1:].long()
    valid = lab != IGNORE_INDEX
    nll = F.cross_entropy(lg[:, :-1].reshape(-1, lg.shape[-1]), torch.where(valid, lab, 0).reshape(-1),
                          reduction="none").reshape(lab.shape)
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def distill_loss(c: Ctx, m: dict, preds, targets, masks) -> torch.Tensor:
    d = m["distill"]
    total = torch.zeros((), device=next(iter(targets.values())).device)
    for task in d["tasks"]:
        name = task["task"]
        tgt = targets[name].float()
        mask = masks[name].float()
        for pred in preds[name]:
            diff = (pred - tgt).abs()
            sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
            term = (sl1 * mask.reshape(-1, *([1] * (sl1.ndim - 1)))).mean()
            if d["use_contrastive"]:
                b = pred.shape[0]
                pn = F.normalize(pred.reshape(b, -1), dim=-1, eps=1e-12)
                tn = F.normalize(tgt.reshape(b, -1), dim=-1, eps=1e-12)
                lg = (pn @ tn.t()) * c.W[f"logit_scales.{name}"].exp().clamp(max=100.0)
                cont = torch.logsumexp(lg, -1) - torch.diagonal(lg)
                term = term + (d["contrastive_loss_weight"] * cont * mask).mean()
            total = total + term * task["loss_weight"]
    return total


def vlm_loss(c: Ctx, m: dict, batch: Dict[str, torch.Tensor], targets=None,
             remat: bool = True) -> torch.Tensor:
    """One micro-batch's training loss: NTP, plus the distillation losses
    against `targets` when the model has heads."""
    with torch.no_grad():
        feats = tower_features(c, m, batch["images"])
    emb = splice(c, m, batch["text_ids"], batch["token_type"], batch["src_index"], project(c, m, feats))
    d = m.get("distill")
    taps = sorted({layer for t in d["tasks"] for layer in t["layer_indices"]}) if d and targets else []
    out = decoder(c, m["decoder"], emb, batch["seq_lengths"].long(), taps=taps, remat=remat)
    loss = ntp_loss(logits(c, m, out["hidden"]), batch["labels"])
    if d and targets:
        preds = head_predictions(c, m, dict(zip(taps, out["taps"])))
        masks = {t["task"]: batch.get(f"{t['task']}_mask",
                                      torch.ones(emb.shape[0], device=emb.device)) for t in d["tasks"]}
        loss = loss + distill_loss(c, m, preds, targets, masks)
    return loss
