"""Plain PyTorch versions of the Mamba2 SSD scan (``repro.kernels.ssd_scan.ref``).

The selective SSM

    h_t = exp(dt_t · A) h_{t-1} + dt_t · (B_t ⊗ x_t),   y_t = C_t · h_t

computed three ways, as in the JAX package: the literal O(S) recurrence
(ground truth), the chunked form the kernel computes (per chunk of Q steps
with L = cumsum(dt·A): a masked intra-chunk product, the chunk's state
summary, and the carried state's contribution), and one decode step. All
arithmetic is f32; outputs come back in ``x``'s dtype. Beside them,
``ssd_chunked_bf16_model`` models what the bf16 kernel rounds.

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


def ssd_chunked_bf16_model(x, dt, A, B, C, chunk: int, *, rounded: bool = True):
    """Plain model of the bf16 kernel's arithmetic (``csrc/ssd_scan.cu``).

    Q = min(chunk, S) as the wrapper passes it. Per chunk, L is the f32
    value nearest the exact prefix of the f32 terms dt·A (summed in float64,
    rounded once); then the kernel's three phases, with what it rounds to
    bf16 before a tensor-core product (f32 accumulation throughout):

    1. chunk states S_c = Σ_j bf16(w_j B_j) x_jᵀ, w_j = dt_j exp(L_last − L_j);
    2. carried states H_1 = S_0, H_{c+1} = exp(L_last,c) H_c + S_c;
    3. y_i = exp(L_i) (C_i · bf16(H_c)) + Σ_{j≤i} bf16((C_i·B_j) exp(L_i − L_j) dt_j) x_j.

    With ``rounded=False`` nothing is rounded: the same arithmetic in f32, which
    the f32 kernel computes (and the tests hold against the Pallas kernel).
    Only the tests and ``chip_smoke.py`` use it. Returns y in x's dtype.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, max(S, 1))
    pad = (-S) % Q
    nc = (S + pad) // Q

    def rnd(t):
        return t.to(torch.bfloat16).float() if rounded else t

    def chunks(a, *tail):
        return _pad_time(a, pad).float().reshape(Bt, nc, Q, *tail)

    xf, dtf = chunks(x, H, P), chunks(dt, H)
    Bf, Cf = chunks(B, N), chunks(C, N)
    dth = dtf.movedim(-1, 2)                                       # (Bt, nc, H, Q)
    L = torch.cumsum((dth * A.float()[:, None]).double(), dim=-1).float()

    # 1. chunk states from w_j B_j rounded to bf16
    w = dth * torch.exp(L[..., -1:] - L)                           # (Bt, nc, H, Q)
    Bw = rnd(Bf[:, :, None] * w[..., None])                        # (Bt, nc, H, Q, N)
    states = torch.einsum("bchjn,bcjhp->bchnp", Bw, xf)            # (Bt, nc, H, N, P)

    # 2. carried states, H before each chunk
    decay = torch.exp(L[..., -1])                                  # (Bt, nc, H)
    h = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):
        before.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    Hs = rnd(torch.stack(before, dim=1))                           # (Bt, nc, H, N, P)

    # 3. outputs: the carried state's part, then the scaled score tile rounded
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cf, Hs) * torch.exp(L).movedim(2, -1)[..., None]
    CB = torch.einsum("bcin,bcjn->bcij", Cf, Bf)                   # (Bt, nc, Q, Q)
    diff = L[..., :, None] - L[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decayed = torch.exp(torch.where(mask, diff, torch.full_like(diff, float("-inf"))))
    att = rnd(CB[:, :, None] * decayed * dth[..., None, :])        # (Bt, nc, H, Q, Q)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", att, xf)
    y = (y_inter + y_intra).reshape(Bt, nc * Q, H, P)[:, :S]
    return y.to(x.dtype)


def ssd_decode_step(h, x, dt, A, B, C):
    """One decode step. h (Bt, H, P, N) f32; x (Bt, H, P); dt (Bt, H); A (H,);
    B, C (Bt, N). Returns (y (Bt, H, P) in x's dtype, h_new f32)."""
    decay = torch.exp(dt.float() * A)[..., None, None]
    upd = dt[..., None, None] * x[..., None] * B[:, None, None, :]
    h = h * decay + upd.float()
    y = torch.sum(h * C[:, None, None, :], dim=-1)
    return y.to(x.dtype), h
