"""Mamba2 SSD (state-space duality) layer [arXiv:2405.21060]; the port of
``repro.models.lm.ssm``.

Prefill uses the chunked SSD algorithm: the sequence is split into chunks
of length Q; within a chunk the quadratic "attention-like" form runs as
batched products, across chunks a linear recurrence carries the (H, P, N)
state in float32. Decode is the O(1) recurrent form:
S <- exp(dt·A)·S + dt·B⊗x, y = C·S.

Scalar-identity A per head, B/C shared across heads (single group), as
Mamba2's default. The intra-chunk decay matrix masks its exponent, not its
value (the reference's gradient is NaN once a chunk's decay passes e^88:
at full width within one 256-step chunk). The reference's three-operand einsums are written here
as a product and a contraction, so that no (b, q, n, h, p) outer product
is ever formed whatever path ``torch.einsum`` would pick.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)`` at
    every x (``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, L, C); w: (K, C); causal depthwise conv + silu."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def ssd_chunked(x, dt, a_log, B, C, D, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x:  (b, l, h, p)   inner activations, heads h, head dim p
    dt: (b, l, h)      positive step sizes (softplus already applied)
    a_log: (h,)        A = -exp(a_log) (negative decay rate per head)
    B, C: (b, l, n)    input/output projections (shared across heads)
    D:  (h,)           skip connection
    Returns (y: (b,l,h,p), final_state: (b,h,p,n) float32). Steps padded
    up to a whole chunk have dt = 0: they neither decay nor feed the
    state.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    A = -torch.exp(a_log.float())                               # (h,)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    S = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state)
    ys = []
    for start in range(0, x.shape[1], chunk):
        sl = slice(start, start + chunk)
        xq, dtq, Bq, Cq = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        cs = torch.cumsum(dtq.float() * A, dim=1)               # (b,q,h) <0
        # intra-chunk quadratic form
        seg = cs[:, :, None, :] - cs[:, None, :, :]             # (b,t,s,h)
        # the reference takes exp of every entry and then zeroes those
        # above the diagonal; there seg > 0, and past 88 exp is inf, whose
        # gradient times the zero from where is NaN. Masking seg first to
        # -inf gives the same values (exp(-inf) = 0) and finite gradients.
        Lmat = torch.exp(torch.where(tri[None, :, :, None], seg,
                                     float("-inf")))
        G = torch.einsum("btn,bsn->bts", Cq, Bq)                # (b,t,s)
        xdt = (xq * dtq[..., None]).float()                     # (b,q,h,p)
        y = torch.einsum("btsh,bshp->bthp", G.float()[..., None] * Lmat, xdt)
        # inter-chunk: contribution of the carried state
        y = y + (torch.einsum("btn,bhpn->bthp", Cq.float(), S)
                 * torch.exp(cs)[..., None])
        # new state
        decay_to_end = torch.exp(cs[:, -1:, :] - cs)            # (b,q,h)
        S = (torch.exp(cs[:, -1, :])[:, :, None, None] * S
             + torch.einsum("bqhp,bqn->bhpn", xdt * decay_to_end[..., None],
                            Bq.float()))
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :l]
    y = y + x[:, :l] * D[None, None, :, None]
    return y, S


def ssd_decode_step(S, x, dt, a_log, B, C, D):
    """One-token recurrence. x: (b,h,p); dt: (b,h); B,C: (b,n).
    Returns (y: (b,h,p), S_new: (b,h,p,n))."""
    A = -torch.exp(a_log.float())
    dt = dt.float()
    a = torch.exp(dt * A)                                       # (b,h)
    dBx = ((x.float() * dt[..., None])[..., None]
           * B.float()[:, None, None, :])                       # (b,h,p,n)
    S_new = a[:, :, None, None] * S + dBx
    y = torch.einsum("bn,bhpn->bhp", C.float(), S_new)
    y = y.to(x.dtype) + x * D[None, :, None]
    return y, S_new


# ---------------------------------------------------------------------------
# full mamba2 block (projections + conv + gate)
# ---------------------------------------------------------------------------

def mamba2_block(p: dict, x: torch.Tensor, cfg,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None,
                 decode: bool = False):
    """x: (B, L, d) (L==1 with decode=True).

    params: in_proj (d, 2*di) [z | x], bc_proj (d, 2n + h) [B | C | dt],
    conv_w (K, di), conv_b (di,), conv_bc_w (K, 2n), conv_bc_b (2n,),
    dt_bias (h,), a_log (h,), D (h,), out_proj (di, d).
    Returns (out, new_ssm_state, new_conv_state); conv state layout is
    (b, K-1, di + 2n): x channels then B|C.
    """
    b, l, _ = x.shape
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_head_dim
    zx = x @ p["in_proj"]                                       # (b,l,2di)
    z, xi_raw = zx[..., :di], zx[..., di:]
    bcdt = x @ p["bc_proj"]                                     # (b,l,2n+h)
    bc_raw = bcdt[..., :2 * n]
    dt = softplus(bcdt[..., 2 * n:] + p["dt_bias"])             # (b,l,h)

    if decode:
        hist_x = torch.cat([conv_state[..., :di], xi_raw], dim=1)
        hist_bc = torch.cat([conv_state[..., di:], bc_raw], dim=1)
        conv_x = F.silu(torch.einsum("bkc,kc->bc", hist_x, p["conv_w"])
                        + p["conv_b"])
        conv_bc = F.silu(torch.einsum("bkc,kc->bc", hist_bc, p["conv_bc_w"])
                         + p["conv_bc_b"])
        new_conv_state = torch.cat([hist_x[:, 1:], hist_bc[:, 1:]], dim=-1)
        xi = conv_x.reshape(b, h, pdim)
        Bv, Cv = conv_bc[:, :n], conv_bc[:, n:]
        y, new_S = ssd_decode_step(ssm_state, xi, dt[:, 0], p["a_log"],
                                   Bv, Cv, p["D"])
        y = y.reshape(b, 1, di)
        out = (y * F.silu(z)) @ p["out_proj"]
        return out, new_S, new_conv_state

    conv_x = _depthwise_causal_conv(xi_raw, p["conv_w"], p["conv_b"])
    conv_bc = _depthwise_causal_conv(bc_raw, p["conv_bc_w"], p["conv_bc_b"])
    xi = conv_x.reshape(b, l, h, pdim)
    Bv, Cv = conv_bc[..., :n], conv_bc[..., n:]
    y, S_final = ssd_chunked(xi, dt, p["a_log"], Bv, Cv, p["D"],
                             cfg.ssm_chunk, init_state=ssm_state)
    y = y.reshape(b, l, di)
    out = (y * F.silu(z)) @ p["out_proj"]
    km1 = cfg.ssm_conv - 1
    raw = torch.cat([xi_raw, bc_raw], dim=-1)
    new_conv_state = F.pad(raw, (0, 0, km1, 0))[:, -km1:, :]
    return out, S_final, new_conv_state
