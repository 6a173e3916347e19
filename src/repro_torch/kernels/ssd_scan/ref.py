"""Plain PyTorch versions of the Mamba2 SSD scan (``repro.kernels.ssd_scan.ref``).

The selective SSM

    h_t = exp(dt_t · A) h_{t-1} + dt_t · (B_t ⊗ x_t),   y_t = C_t · h_t

computed three ways, as in the JAX package: the literal O(S) recurrence
(ground truth), the chunked form the kernel computes (per chunk of Q steps
with L = cumsum(dt·A): a masked intra-chunk product, the chunk's state
summary, and the carried state's contribution), and one decode step. All
arithmetic is f32; outputs come back in ``x``'s dtype.

Shapes: x (Bt, S, H, P); dt (Bt, S, H); A (H,); B, C (Bt, S, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_reference_sequential(x, dt, A, B, C):
    """Literal recurrence over S steps -> y (Bt, S, H, P)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)[..., None, None]                       # (Bt,H,1,1)
        upd = dtf[:, t, :, None, None] * xf[:, t, :, :, None] * Bf[:, t, None, None, :]
        h = h * decay + upd
        ys.append(torch.sum(h * Cf[:, t, None, None, :], dim=-1))              # (Bt,H,P)
    return torch.stack(ys, dim=1).to(x.dtype)


def _segsum(la):
    """la (..., Q) log-decays -> (..., Q, Q): [i, j] = L_i - L_j for j <= i,
    -inf above the diagonal (selected before any exponential)."""
    Q = la.shape[-1]
    cs = torch.cumsum(la, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=la.device))
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def _pad_time(a, pad):
    """Zero-pad axis 1 (time) of a (Bt, S, ...) tensor by ``pad`` steps."""
    return F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])


def chunk_states(x, dt, A, B, chunk: int):
    """The carried-state half of the chunked scan, shared by ``ssd_chunked``
    and the model's terminal state (``models/ssm.py::_final_state``).

    S is zero-padded to a multiple of ``chunk``: dt = 0 on the pad gives
    decay 1 and update 0. The arithmetic is in ``promote_types(x.dtype,
    float32)``: f32 for bf16 or f32 inputs, f64 for f64 ones (a yardstick of
    the exact answer). Returns, with nc chunks of Q = ``chunk`` steps:
    ``la`` (Bt, nc, H, Q) the per-step log-decays dt·A, ``L`` their cumulative
    sum within each chunk, ``xdt`` (Bt, nc, Q, H, P) = dt·x, ``Bf`` (Bt, nc,
    Q, N), ``Hs`` (Bt, nc, H, N, P) the state BEFORE each chunk, and ``h``
    (Bt, H, N, P) the state after the last.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Q = chunk
    pad = (-S) % Q
    if pad:
        x, dt, B = (_pad_time(a, pad) for a in (x, dt, B))
    nc = x.shape[1] // Q
    ct = torch.promote_types(x.dtype, torch.float32)

    xf = x.reshape(Bt, nc, Q, H, P).to(ct)
    dtf = dt.reshape(Bt, nc, Q, H).to(ct)
    Bf = B.reshape(Bt, nc, Q, N).to(ct)
    la = (dtf * A.to(ct)).movedim(-1, 2)                          # (Bt, nc, H, Q)
    L = torch.cumsum(la, dim=-1)
    xdt = xf * dtf[..., None]                                     # (Bt, nc, Q, H, P)

    # chunk states
    dec_last = torch.exp(L[..., -1:] - L)                         # (Bt, nc, H, Q)
    states = torch.einsum("bchj,bcjn,bcjhp->bchnp", dec_last, Bf, xdt)  # (Bt, nc, H, N, P)

    # inter-chunk recurrence
    chunk_decay = torch.exp(L[..., -1])                           # (Bt, nc, H)
    h = torch.zeros((Bt, H, N, P), dtype=ct, device=x.device)
    before = []
    for c in range(nc):
        before.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    return la, L, xdt, Bf, torch.stack(before, dim=1), h


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD with chunk length ``chunk`` (``ref.py::ssd_chunked``).

    Padding and arithmetic type as in ``chunk_states``; the result comes back
    in ``x``'s dtype. Differentiable by autograd.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Q = chunk
    la, L, xdt, Bf, Hs, _ = chunk_states(x, dt, A, B, chunk)
    nc = L.shape[1]
    Cf = _pad_time(C, nc * Q - S).reshape(Bt, nc, Q, N).to(Bf.dtype)

    # intra-chunk
    seg = _segsum(la)                                             # (Bt, nc, H, Q, Q)
    CB = torch.einsum("bcin,bcjn->bcij", Cf, Bf)                  # (Bt, nc, Q, Q)
    att = CB[:, :, None] * torch.exp(seg)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", att, xdt)

    # the carried state's contribution
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", Cf, torch.exp(L.movedim(2, -1)), Hs)
    y = (y_intra + y_inter).reshape(Bt, nc * Q, H, P)[:, :S]
    return y.to(x.dtype)


def ssd_decode_step(h, x, dt, A, B, C):
    """One decode step. h (Bt, H, P, N) f32; x (Bt, H, P); dt (Bt, H); A (H,);
    B, C (Bt, N). Returns (y (Bt, H, P) in x's dtype, h_new f32)."""
    decay = torch.exp(dt.float() * A)[..., None, None]
    upd = dt[..., None, None] * x[..., None] * B[:, None, None, :]
    h = h * decay + upd.float()
    y = torch.sum(h * C[:, None, None, :], dim=-1)
    return y.to(x.dtype), h
