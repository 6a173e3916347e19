"""Public wrappers of the Fisher-merge kernels (``repro.kernels.fisher_merge.ops``).

Two forms of paper Eq. 1:

  * ``fisher_merge``: materializing, takes the (K, ...) client stack;
  * ``fisher_fold``: streaming, folds ONE client's (θ, F, w) into running
    f32 (num, den) sums, so the server never holds a (K, ...) stack.

A tensor on the CPU takes the plain version in ``ref.py``. A tensor on a CUDA
device launches the hand-written kernel of ``csrc/fisher_merge.cu`` or
raises. ``<wrapper>.launches`` counts kernel launches (one per call).

``fisher_fold`` updates num and den in place on both devices (the JAX
package returns new arrays) and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fisher_merge import ref


def _check(what, *tensors):
    build.require_cuda(what, *tensors)
    for t in tensors:
        if t.dtype not in build.DTYPE_CODES:
            raise ValueError(f"{what}: dtype {t.dtype} not in {list(build.DTYPE_CODES)}")


def fisher_merge(theta, fisher, weights, *, eps: float = 1e-8):
    """theta/fisher (K, ...) stacked client leaves; weights (K,) f32.

    Returns the merged leaf of shape (...) in theta's dtype.
    """
    k = theta.shape[0]
    if fisher.shape != theta.shape or weights.shape != (k,):
        raise ValueError(f"fisher_merge: theta {tuple(theta.shape)} fisher "
                         f"{tuple(fisher.shape)} weights {tuple(weights.shape)} do not fit")
    if theta.device.type == "cpu":
        return ref.fisher_merge(theta, fisher, weights, eps=eps)
    t2, f2 = theta.reshape(k, -1), fisher.reshape(k, -1)
    _check("fisher_merge", t2, f2, weights)
    if weights.dtype != torch.float32 or f2.dtype != t2.dtype:
        raise ValueError(f"fisher_merge: weights must be float32 and fisher {f2.dtype} "
                         f"must match theta {t2.dtype}")
    out = torch.empty(theta.shape[1:], dtype=theta.dtype, device=theta.device)
    with torch.cuda.device(theta.device):
        err = build.library().repro_fisher_merge(
            t2.data_ptr(), f2.data_ptr(), weights.data_ptr(), out.data_ptr(), k,
            t2.shape[1], float(eps), build.DTYPE_CODES[theta.dtype], build.stream_of(theta))
    build.check(err, "fisher_merge")
    fisher_merge.launches += 1
    return out


fisher_merge.launches = 0


def fisher_fold(num, den, theta, fisher, w: float):
    """Streaming fold of one client leaf, in place: num += w·F·θ, den += w·F.

    num/den are float32 running sums shaped like the leaf; ``w`` a Python
    float. Returns (num, den).
    """
    if not (num.shape == den.shape == theta.shape == fisher.shape):
        raise ValueError("fisher_fold: num, den, theta and fisher must share one shape")
    if theta.device.type == "cpu":
        return ref.fisher_fold(num, den, theta, fisher, w)
    _check("fisher_fold", num, den, theta, fisher)
    if num.dtype != torch.float32 or den.dtype != torch.float32 or fisher.dtype != theta.dtype:
        raise ValueError(f"fisher_fold: num/den must be float32 ({num.dtype}/{den.dtype}) "
                         f"and fisher {fisher.dtype} must match theta {theta.dtype}")
    with torch.cuda.device(theta.device):
        err = build.library().repro_fisher_fold(
            num.data_ptr(), den.data_ptr(), theta.data_ptr(), fisher.data_ptr(), float(w),
            theta.numel(), build.DTYPE_CODES[theta.dtype], build.stream_of(theta))
    build.check(err, "fisher_fold")
    fisher_fold.launches += 1
    return num, den


fisher_fold.launches = 0
