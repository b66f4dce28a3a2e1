"""Mixture-of-Experts: top-k router + capacity-based GShard dispatch — the
port of ``repro.layers.moe``.

Serves the two MoE architectures:
  * arctic-480b   — 128 experts, top-2, plus a *dense residual* MLP in
                    parallel with the MoE output (added, not routed; see
                    ``models.lm``);
  * deepseek-v2   — 160 routed experts top-6 plus 2 *shared* experts that
                    process every token; first layer dense.

Dispatch is the einsum/capacity formulation: per sequence, each expert
accepts at most ``capacity = ceil(S * k / E * capacity_factor)`` tokens;
overflow tokens are dropped (their contribution is the identity residual).
At S == 1 (decode) every expert runs over the token batch and the results
are weighted by the gates (``_moe_decode_dense``), dropless.

Router numerics: fp32 logits, softmax-then-top-k, gates renormalised over
the selected experts.  Aux losses: Switch-style load-balance + router
z-loss, both returned as metrics for the loss to weight in.  The
reference's ``pshard`` sharding tags are identity off a mesh and have no
counterpart here (ROADMAP queue 1, item 14g).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.layers.common import act_fn
from repro_torch.layers.params import ParamSpec

__all__ = ["moe_schema", "moe_block", "capacity"]


def moe_schema(cfg) -> dict:
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    s = {
        "router": ParamSpec((d, e), ("embed", "expert"), dtype="float32"),
        "wi": ParamSpec((e, d, f), ("expert", "embed", "expert_mlp")),
        "wg": ParamSpec((e, d, f), ("expert", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        s["shared"] = {
            "wi": ParamSpec((d, fs), ("embed", "mlp")),
            "wg": ParamSpec((d, fs), ("embed", "mlp")),
            "wo": ParamSpec((fs, d), ("mlp", "embed")),
        }
    return s


def capacity(cfg, seq_len: int) -> int:
    cap = math.ceil(seq_len * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    return max(cap, cfg.experts_per_token)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties in index
    order (lower index first).  ``torch.topk`` does not promise that order,
    so this is a stable descending sort cut to k."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, cfg, x):
    """-> (probs (B,S,E) fp32, (gates, idx, onehot), aux metrics)."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, cfg.experts_per_token)  # (B,S,k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # Switch load-balance loss: E * sum_e f_e * P_e, f normalised by k so
    # perfectly balanced routing scores exactly 1.0
    e = cfg.num_experts
    onehot = F.one_hot(idx, e).float()  # (B,S,k,E)
    f_e = onehot.sum(dim=2).mean(dim=(0, 1)) / cfg.experts_per_token
    p_e = probs.mean(dim=(0, 1))
    aux = e * torch.sum(f_e * p_e)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    metrics = {"moe_aux_loss": aux, "moe_z_loss": z, "moe_expert_frac_max": f_e.max()}
    return probs, (gates, idx, onehot), metrics


def _shared(p, cfg, x):
    act = act_fn(cfg.mlp_act)
    sp = p["shared"]
    g = act(torch.einsum("bsd,df->bsf", x, sp["wg"].to(x.dtype)))
    h = g * torch.einsum("bsd,df->bsf", x, sp["wi"].to(x.dtype))
    return torch.einsum("bsf,fd->bsd", h, sp["wo"].to(x.dtype))


def _moe_decode_dense(p, cfg, x, gates, onehot):
    """Decode-time (S == 1) path: every expert runs over the (tiny) token
    batch and the results are weighted by the routing gates — dropless, no
    capacity buffers.  The expert products are ``matmul``s with the token
    batch broadcast over the expert dim, so each expert's weights are read
    in place (``torch.einsum("bsd,edf->ebsf")`` would permute and copy the
    whole expert stack to reach a single matmul)."""
    act = act_fn(cfg.mlp_act)
    B, S, d = x.shape
    # (B, S, E) combined gate per expert (0 for unrouted experts)
    gate_map = (onehot * gates.to(onehot.dtype)[..., None]).sum(dim=2).to(x.dtype)
    xt = x.reshape(1, B * S, d)
    h = act(torch.matmul(xt, p["wg"].to(x.dtype))) * torch.matmul(xt, p["wi"].to(x.dtype))
    out = torch.matmul(h, p["wo"].to(x.dtype)).reshape(-1, B, S, d)  # (E, B, S, d)
    return torch.einsum("ebsd,bse->bsd", out, gate_map)


def moe_block(p: dict, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """x (B,S,d) -> (y (B,S,d), aux metrics)."""
    B, S, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, S)
    act = act_fn(cfg.mlp_act)

    _, (gates, idx, onehot), metrics = _router(p, cfg, x)

    if S == 1:  # decode: masked dense path (see _moe_decode_dense)
        y = _moe_decode_dense(p, cfg, x, gates, onehot)
        if cfg.num_shared_experts:
            y = y + _shared(p, cfg, x)
        metrics["moe_dropped_frac"] = torch.zeros((), device=x.device)
        return y, metrics

    # Position of each (token, choice) in its expert's buffer; drop overflow.
    # pos[b,s,j] = number of earlier claims on expert idx[b,s,j] in sequence b,
    # claims counted in (token, choice) order
    claims = onehot.reshape(B, S * k, e)
    pos = (torch.cumsum(claims, dim=1) - claims).reshape(B, S, k, e)
    pos = (pos * onehot).sum(-1)  # (B,S,k) buffer slot for the chosen expert
    keep = pos < cap
    gates = gates * keep

    # combine[b,s,e,c]: gate if token (b,s) occupies slot c of expert e.
    # Contract k FIRST ('bske,bskc->bsec', a batched (E x k)@(k x C) matmul):
    # a 3-operand einsum would materialise a (B,S,k,E,C) intermediate.  The
    # slot mask compares against arange(cap) (jax.nn.one_hot's zero row for
    # an overflowed pos >= cap; F.one_hot would raise there).
    slot = (pos[..., None] == torch.arange(cap, device=x.device)).to(x.dtype) \
        * keep[..., None].to(x.dtype)
    gated = onehot.to(x.dtype) * gates.to(x.dtype)[..., None]
    combine = torch.einsum("bske,bskc->bsec", gated, slot)
    dispatch = (combine > 0).to(x.dtype)

    xin = torch.einsum("bsec,bsd->ebcd", dispatch, x)  # (E,B,cap,d)
    h = act(torch.einsum("ebcd,edf->ebcf", xin, p["wg"].to(x.dtype))) * torch.einsum(
        "ebcd,edf->ebcf", xin, p["wi"].to(x.dtype))
    xout = torch.einsum("ebcf,efd->ebcd", h, p["wo"].to(x.dtype))
    y = torch.einsum("bsec,ebcd->bsd", combine, xout)

    if cfg.num_shared_experts:
        y = y + _shared(p, cfg, x)

    metrics["moe_dropped_frac"] = 1.0 - keep.float().mean()
    return y, metrics
