"""Public wrappers of the Fisher-merge kernels (``repro.kernels.fisher_merge.ops``).

Two forms of paper Eq. 1, each for one leaf and for a whole adapter tree:

  * ``fisher_merge`` / ``fisher_merge_leaves``: materializing, over the K
    clients' leaves (a (K, ...) stack, or K lists of leaves read where they
    lie);
  * ``fisher_fold`` / ``fisher_fold_leaves``: streaming, folds ONE client's
    (θ, F, w) into running f32 (num, den) sums, so the server never holds
    K uploads at once.

A tensor on the CPU takes the plain version in ``ref.py``. A tensor on a CUDA
device launches the hand-written kernel of ``csrc/fisher_merge.cu`` or
raises: one launch for a whole tree (more only past the kernel's parameter
limit). ``fisher_merge.launches`` and ``fisher_fold.launches`` count the
kernel launches of both forms.

Weights are host floats (a sequence, numpy or a CPU tensor): they travel to
the kernel by value, so a call never waits for the card and a CUDA graph can
capture it. A CUDA weights tensor raises.

The folds update num and den in place on both devices (the JAX package
returns new arrays) and return them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fisher_merge import ref


def _host_weights(what, weights, k):
    if isinstance(weights, torch.Tensor) and weights.device.type != "cpu":
        raise ValueError(f"{what}: weights must be host floats (a sequence, numpy or a CPU "
                         f"tensor), got a tensor on {weights.device}: reading it would wait "
                         "on the card, and a CUDA graph capture cannot")
    w = ref.host_weights(weights)
    if w.shape != (k,):
        raise ValueError(f"{what}: {w.size} weights for {k} clients")
    return w


@functools.lru_cache(maxsize=None)
def max_clients() -> int:
    """The most clients one merge launch takes for one leaf (``csrc``'s kMaxPtrs)."""
    return build.library().repro_fisher_max_clients()


def _check_dtype(what, dtype):
    if dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what}: dtype {dtype} not in {list(build.DTYPE_CODES)}")


def _check_tree(what, like, groups, dtype, device):
    """Every leaf of every group: a contiguous ``dtype`` tensor on ``device``
    shaped like the same leaf of ``like``."""
    for group in groups:
        for t, s in zip(group, like):
            if (t.device != device or t.dtype != dtype or t.shape != s.shape
                    or not t.is_contiguous()):
                raise ValueError(f"{what}: leaves must be contiguous {dtype} tensors on "
                                 f"{device}, each leaf one shape ({tuple(s.shape)}), got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def fisher_merge(theta, fisher, weights, *, eps: float = 1e-8):
    """theta/fisher (K, ...) stacked client leaves; weights (K,) host floats.

    Returns the merged leaf of shape (...) in theta's dtype.
    """
    k = theta.shape[0]
    w = _host_weights("fisher_merge", weights, k)
    if fisher.shape != theta.shape:
        raise ValueError(f"fisher_merge: theta {tuple(theta.shape)} and fisher "
                         f"{tuple(fisher.shape)} differ")
    if theta.device.type == "cpu":
        return ref.fisher_merge(theta, fisher, w, eps=eps)
    build.require_cuda("fisher_merge", theta, fisher)
    _check_dtype("fisher_merge", theta.dtype)
    if fisher.dtype != theta.dtype:
        raise ValueError(f"fisher_merge: fisher {fisher.dtype} must match theta {theta.dtype}")
    if k > max_clients():
        raise ValueError(f"fisher_merge: {k} clients, the kernel takes at most {max_clients()}")
    out = torch.empty(theta.shape[1:], dtype=theta.dtype, device=theta.device)
    with torch.cuda.device(theta.device):
        err = build.library().repro_fisher_merge(
            theta.data_ptr(), fisher.data_ptr(), (ctypes.c_float * k)(*w.tolist()),
            out.data_ptr(), k, out.numel(), float(eps), build.DTYPE_CODES[theta.dtype],
            build.stream_of(theta))
    build.check(err, "fisher_merge")
    fisher_merge.launches += int(out.numel() > 0)
    return out


fisher_merge.launches = 0


def fisher_merge_leaves(thetas, fishers, weights, *, eps: float = 1e-8):
    """thetas[k] / fishers[k]: client k's list of L leaves (each leaf one
    shape across clients, every leaf one dtype); weights (K,) host floats.

    Returns the L merged leaves in the leaves' dtype, from one kernel launch.
    """
    k = len(thetas)
    if k == 0 or len(fishers) != k:
        raise ValueError(f"fisher_merge_leaves: {k} thetas and {len(fishers)} fishers")
    w = _host_weights("fisher_merge_leaves", weights, k)
    like = thetas[0]
    n_leaves = len(like)
    if any(len(g) != n_leaves for g in (*thetas, *fishers)):
        raise ValueError(f"fisher_merge_leaves: every client must give {n_leaves} leaves")
    if n_leaves == 0:
        return []
    if like[0].device.type == "cpu":
        return ref.fisher_merge_leaves(thetas, fishers, w, eps=eps)
    dev, dtype = like[0].device, like[0].dtype
    build.require_cuda("fisher_merge_leaves", like[0])
    _check_dtype("fisher_merge_leaves", dtype)
    _check_tree("fisher_merge_leaves", like, (*thetas, *fishers), dtype, dev)
    if k > max_clients():
        raise ValueError(f"fisher_merge_leaves: {k} clients, the kernel takes at most "
                         f"{max_clients()}")
    outs = [torch.empty_like(t) for t in like]
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = build.library().repro_fisher_merge_tree(
            _ptrs([t for g in thetas for t in g]), _ptrs([f for g in fishers for f in g]),
            _ptrs(outs), (ctypes.c_longlong * n_leaves)(*[t.numel() for t in like]), k,
            n_leaves, (ctypes.c_float * k)(*w.tolist()), float(eps), build.DTYPE_CODES[dtype],
            build.stream_of(like[0]), ctypes.byref(launches))
    build.check(err, "fisher_merge_leaves")
    fisher_merge.launches += launches.value
    return outs


def fisher_fold(num, den, theta, fisher, w: float):
    """Streaming fold of one client leaf, in place: num += w·F·θ, den += w·F.

    num/den are float32 running sums shaped like the leaf; ``w`` a Python
    float. Returns (num, den).
    """
    if not (num.shape == den.shape == theta.shape == fisher.shape):
        raise ValueError("fisher_fold: num, den, theta and fisher must share one shape")
    if theta.device.type == "cpu":
        return ref.fisher_fold(num, den, theta, fisher, w)
    build.require_cuda("fisher_fold", num, den, theta, fisher)
    _check_dtype("fisher_fold", theta.dtype)
    if num.dtype != torch.float32 or den.dtype != torch.float32 or fisher.dtype != theta.dtype:
        raise ValueError(f"fisher_fold: num/den must be float32 ({num.dtype}/{den.dtype}) "
                         f"and fisher {fisher.dtype} must match theta {theta.dtype}")
    with torch.cuda.device(theta.device):
        err = build.library().repro_fisher_fold(
            num.data_ptr(), den.data_ptr(), theta.data_ptr(), fisher.data_ptr(), float(w),
            theta.numel(), build.DTYPE_CODES[theta.dtype], build.stream_of(theta))
    build.check(err, "fisher_fold")
    fisher_fold.launches += int(theta.numel() > 0)
    return num, den


fisher_fold.launches = 0


def fisher_fold_leaves(nums, dens, thetas, fishers, w: float):
    """Fold one upload's L leaves (thetas, fishers: one dtype) into the
    float32 running sums nums/dens, in place, in one kernel launch.
    Returns (nums, dens)."""
    n_leaves = len(thetas)
    if not len(nums) == len(dens) == len(fishers) == n_leaves:
        raise ValueError("fisher_fold_leaves: nums, dens, thetas and fishers must hold one "
                         "leaf each")
    if n_leaves == 0:
        return nums, dens
    if thetas[0].device.type == "cpu":
        return ref.fisher_fold_leaves(nums, dens, thetas, fishers, w)
    dev, dtype = thetas[0].device, thetas[0].dtype
    build.require_cuda("fisher_fold_leaves", thetas[0])
    _check_dtype("fisher_fold_leaves", dtype)
    _check_tree("fisher_fold_leaves", thetas, (thetas, fishers), dtype, dev)
    _check_tree("fisher_fold_leaves", thetas, (nums, dens), torch.float32, dev)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = build.library().repro_fisher_fold_tree(
            _ptrs(nums), _ptrs(dens), _ptrs(thetas), _ptrs(fishers),
            (ctypes.c_longlong * n_leaves)(*[t.numel() for t in thetas]), n_leaves, float(w),
            build.DTYPE_CODES[dtype], build.stream_of(thetas[0]), ctypes.byref(launches))
    build.check(err, "fisher_fold_leaves")
    fisher_fold.launches += launches.value
    return nums, dens
