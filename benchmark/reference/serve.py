"""The reference's reading of served tokens: a full float32 forward over each
prompt and the tokens the program served, and the gap by which each served
token's logit lies below the reference's best at its position."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference import models
from benchmark.reference.models import Ctx


def _sequence(m: dict, r: dict, device):
    toks = [int(t) for t in r["tokens"]]
    ids = torch.as_tensor(list(r["text_ids"]) + toks[:-1], device=device)[None]
    typ = torch.as_tensor(list(r["token_type"]) + [models.SEG_TEXT] * (len(toks) - 1), device=device)[None]
    src = torch.as_tensor(list(r["src_index"]) + [0] * (len(toks) - 1), device=device)[None]
    return ids, typ, src, torch.as_tensor(r["image"], device=device)[None]


@torch.no_grad()
def cache_error(m: dict, W, requests: Sequence[Dict[str, object]], device,
                prec: str = "f32", against: str = "program") -> float:
    """The widest relative (Frobenius) error, over requests, layers and K or V,
    of a KV cache against the float32 reference's keys (after rotary) and
    values for the same prompt and served tokens. Each request carries 'k',
    'v' (L, n, Nkv, H): the program's cache rows (against='program'), or
    none, and then the reference run at `prec` stands in for the program."""
    models.strict_float32()
    worst = 0.0
    for r in requests:
        ids, typ, src, img = _sequence(m, r, device)

        def kv(ctx):
            feats = models.project(ctx, m, models.tower_features(ctx, m, img))
            emb = models.splice(ctx, m, ids, typ, src, feats)
            out: list = []
            models.decoder(ctx, m["decoder"], emb, torch.tensor([ids.shape[1]], device=device),
                           kv_out=out)
            return torch.stack([k[0] for k, _ in out]), torch.stack([v[0] for _, v in out])

        rk, rv = kv(Ctx(W, "f32"))
        if against == "program":
            pk = torch.as_tensor(r["k"], device=device).float()
            pv = torch.as_tensor(r["v"], device=device).float()
        else:
            pk, pv = kv(Ctx(W, prec))
        for ref, got in ((rk, pk), (rv, pv)):
            err = (got - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1).clamp(min=1e-30)
            worst = max(worst, float(err.max()))
    return worst


@torch.no_grad()
def token_gaps(m: dict, W, requests: Sequence[Dict[str, object]], device,
               control: bool = False) -> List[Dict[str, float]]:
    """requests: {'text_ids', 'token_type', 'src_index' (the prompt's plan,
    length n), 'image' (H, W, 3) float32, 'tokens' (the served ids)}.
    Returns per request {'gap': the widest gap of a served token, 'tokens'};
    with control, also 'control_gap': the widest gap of the token that the
    float8 forward puts first at each of the same positions, and 'altered_gap':
    that of each served token plus one (a token altered where it is made)."""
    models.strict_float32()
    c = Ctx(W, "f32")
    c8 = Ctx(W, "fp8")
    out = []
    for r in requests:
        toks = [int(t) for t in r["tokens"]]
        n = len(r["text_ids"])
        ids = torch.as_tensor(list(r["text_ids"]) + toks[:-1], device=device)[None]
        typ = torch.as_tensor(list(r["token_type"]) + [models.SEG_TEXT] * (len(toks) - 1), device=device)[None]
        src = torch.as_tensor(list(r["src_index"]) + [0] * (len(toks) - 1), device=device)[None]
        img = torch.as_tensor(r["image"], device=device)[None]
        rows = slice(n - 1, n - 1 + len(toks))

        def read(ctx):
            feats = models.project(ctx, m, models.tower_features(ctx, m, img))
            emb = models.splice(ctx, m, ids, typ, src, feats)
            hid = models.decoder(ctx, m["decoder"], emb, torch.tensor([ids.shape[1]], device=device))
            return models.logits(ctx, m, hid["hidden"][:, rows])[0]

        lg = read(c)
        best = lg.max(-1).values
        tok = torch.as_tensor(toks, device=device)
        rec = {"gap": float((best - lg.gather(-1, tok[:, None])[:, 0]).max()), "tokens": len(toks)}
        if control:
            pick = read(c8).argmax(-1)
            rec["control_gap"] = float((best - lg.gather(-1, pick[:, None])[:, 0]).max())
            alt = (tok + 1) % lg.shape[-1]
            rec["altered_gap"] = float((best - lg.gather(-1, alt[:, None])[:, 0]).max())
        out.append(rec)
    return out
