"""Mamba2 block via SSD — state-space duality (arXiv:2405.21060), the port of
``repro.layers.ssd``.

The chunked SSD algorithm is the sequence-axis instance of the paper's
tilted-fusion insight: the sequence is cut into chunks ("column tiles");
within a chunk the quadratic dual form runs on its own; the only thing
carried between chunks is the per-head state ``(P, N)`` — the overlap
buffer of this dataflow.

Layers:
  * :func:`ssd_chunked`    — training/prefill: intra-chunk dual form +
                             inter-chunk state carry (the reference's
                             ``lax.scan``, here a loop over chunks);
                             returns the final state.
  * :func:`ssd_reference`  — naive recurrence (the numerical oracle).
  * :func:`ssd_decode_step`— O(1) cached decode.
  * :func:`mamba_block`    — full block: projections, causal conv, gating.

The block's cache (conv window, fp32 SSM state) is written **in place**,
as the port's KV caches are.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.layers.common import rmsnorm, silu
from repro_torch.layers.params import ParamSpec

__all__ = [
    "ssd_chunked",
    "ssd_reference",
    "ssd_decode_step",
    "mamba_schema",
    "mamba_block",
    "init_ssm_cache_spec",
]


# ----------------------------------------------------------------------
# SSD core
# ----------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) with [t, s] = sum_{r in (s, t]} x_r (t >= s).

    Each segment is summed on its own (a cumsum down the columns of the
    strictly lower triangle), not as the difference of two running sums as
    the reference does: those reach |cs| ~ 100 over a 128-step chunk, and
    their difference keeps only ~1e-5 of a short segment's sum, an error
    that a deep Mamba stack compounds past the fp32 tolerance between
    prefill and decode (the recurrence multiplies one step's decay at a
    time)."""
    q = x.shape[-1]
    strict = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device), -1)
    seg = torch.cumsum(torch.where(strict, x[..., :, None], 0.0), dim=-2)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)   (already softplus'd)
    A: torch.Tensor,  # (H,)        (negative)
    Bm: torch.Tensor,  # (B, S, H, N)  (groups pre-broadcast to heads)
    Cm: torch.Tensor,  # (B, S, H, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N) fp32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    S_out = S
    if pad:  # dt=0 padding steps are identity transitions (decay 1, input 0)
        zp = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        x, dt, Bm, Cm = zp(x), zp(dt), zp(Bm), zp(Cm)
        S = S + pad
    nc = S // Q
    f32 = torch.float32

    def r(t):  # (B,S,...) -> (B,nc,Q,...)
        return t.reshape((Bsz, nc, Q) + tuple(t.shape[2:]))

    xb = (x * dt[..., None]).to(f32)  # discretised input
    xc, dtc = r(xb), r(dt.to(f32))
    Bc, Cc = r(Bm.to(f32)), r(Cm.to(f32))
    dA = dtc * A.to(f32)  # (B,nc,Q,H)
    cs = torch.cumsum(dA, dim=2)  # (B,nc,Q,H)

    # ---- intra-chunk (dual / attention-like form) ----
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", Cc, Bc) * L
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", scores, xc)

    # ---- chunk-boundary states ----
    # exp(sum_{r in (s, Q)} dA_r), each tail summed from the chunk's end
    # (not cs[-1] - cs[s]: see _segsum)
    tail = torch.flip(torch.cumsum(torch.flip(dA, dims=(2,)), dim=2), dims=(2,))
    decay_to_end = torch.exp(F.pad(tail[:, :, 1:], (0, 0, 0, 1)))  # (B,nc,Q,H)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", Bc, decay_to_end, xc)

    # ---- inter-chunk recurrence (the "overlap buffer" carry) ----
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    h_starts = []
    for c in range(nc):
        h_starts.append(h)  # the state at chunk START
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_starts = torch.stack(h_starts, dim=1)  # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Cc, h_starts) * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)[:, :S_out]
    return y.to(x.dtype), h


def ssd_reference(x, dt, A, Bm, Cm, h0=None):
    """Naive per-step recurrence — oracle for ssd_chunked/decode."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    Af = A.to(f32)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].to(f32), dt[:, t].to(f32)
        Bt, Ct = Bm[:, t].to(f32), Cm[:, t].to(f32)
        dec = torch.exp(dtt * Af)
        h = h * dec[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dtt, Bt, xt)
        ys.append(torch.einsum("bhn,bhpn->bhp", Ct, h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """One token: h (B,H,P,N), x (B,H,P), dt (B,H), Bm/Cm (B,H,N)."""
    f32 = torch.float32
    dtf = dt.to(f32)
    dec = torch.exp(dtf * A.to(f32))
    h = h * dec[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dtf, Bm.to(f32), x.to(f32))
    y = torch.einsum("bhn,bhpn->bhp", Cm.to(f32), h)
    return h, y.to(x.dtype)


# ----------------------------------------------------------------------
# Full Mamba2 block
# ----------------------------------------------------------------------
def mamba_schema(cfg) -> dict:
    d = cfg.d_model
    din = cfg.ssm_d_inner
    H, N, G, W = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_conv_width
    conv_dim = din + 2 * G * N
    return {
        "wz": ParamSpec((d, din), ("embed", "mlp")),
        "wx": ParamSpec((d, din), ("embed", "mlp")),
        "wbc": ParamSpec((d, 2 * G * N), ("embed", None)),
        "wdt": ParamSpec((d, H), ("embed", "ssm_heads")),
        "conv_w": ParamSpec((W, conv_dim), (None, "mlp")),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), init="zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((din,), ("norm",), init="ones"),
        "wo": ParamSpec((din, d), ("mlp", "embed")),
    }


def init_ssm_cache_spec(cfg, batch: int):
    """Two caches per layer: conv window and SSM state."""
    din = cfg.ssm_d_inner
    G, N, W = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv_width
    conv_dim = din + 2 * G * N
    conv = ((batch, W - 1, conv_dim), ("batch", None, "mlp"))
    ssm = (
        (batch, cfg.ssm_heads, cfg.ssm_headdim, N),
        ("batch", "ssm_heads", None, None),
    )
    return conv, ssm


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 window: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. xbc (B,S,C), w (W,C). Returns (y, new_window)."""
    W = w.shape[0]
    if window is None:
        window = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]), dtype=xbc.dtype,
                             device=xbc.device)
    ext = torch.cat([window.to(xbc.dtype), xbc], dim=1)  # (B, S+W-1, C)
    S = xbc.shape[1]
    y = sum(ext[:, i:i + S, :] * w[i][None, None, :] for i in range(W)) + b
    new_window = ext[:, -(W - 1):, :] if W > 1 else window
    return y, new_window


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``); ``F.softplus`` returns x
    itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_block(
    p: dict,
    cfg,
    x: torch.Tensor,  # (B, S, d)
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (conv, ssm)
    mode: str = "train",
):
    """Returns (y (B,S,d), new_cache).  ``prefill`` and ``decode`` write the
    new conv window and SSM state into ``cache``'s two tensors in place and
    return them."""
    B, S, d = x.shape
    din, H, P = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["wdt"].to(x.dtype))
    z = torch.einsum("bsd,df->bsf", x, p["wz"].to(x.dtype))
    xs = torch.einsum("bsd,df->bsf", x, p["wx"].to(x.dtype))
    bc = torch.einsum("bsd,df->bsf", x, p["wbc"].to(x.dtype))
    xbc = torch.cat([xs, bc], dim=-1)

    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    conv_win = cache[0] if (cache is not None and mode != "train") else None
    xbc_c, new_conv = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                                   conv_win)
    xbc_c = silu(xbc_c)
    xs_c = xbc_c[..., :din].reshape(B, S, H, P)
    Bm = xbc_c[..., din:din + G * N].reshape(B, S, G, N)
    Cm = xbc_c[..., din + G * N:].reshape(B, S, G, N)
    # broadcast groups to heads (jnp.repeat: each group repeated in place)
    rep = H // G
    Bm = Bm.repeat_interleave(rep, dim=2)
    Cm = Cm.repeat_interleave(rep, dim=2)

    dt = _softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    h0 = cache[1] if (cache is not None and mode != "train") else None
    if mode in ("train", "prefill"):
        y, hT = ssd_chunked(xs_c, dt, A, Bm, Cm, cfg.ssm_chunk, h0)
    else:
        hT, y1 = ssd_decode_step(h0, xs_c[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y1[:, None]
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xs_c
    y = y.reshape(B, S, din)
    y = rmsnorm(y * silu(z), p["norm"], cfg.norm_eps)
    out = torch.einsum("bsf,fd->bsd", y, p["wo"].to(x.dtype))
    new_cache = None
    if mode in ("prefill", "decode"):
        conv_c, ssm_c = cache
        conv_c.copy_(new_conv)
        ssm_c.copy_(hT)
        new_cache = (conv_c, ssm_c)
    return out, new_cache
