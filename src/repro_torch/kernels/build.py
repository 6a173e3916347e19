"""Build and load the port's CUDA kernels.

All sources under ``src/repro_torch/csrc/`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library is
built at first use into ``build/kernels/<digest>/`` at the root of the
checkout, keyed by a digest of the sources and flags, so an edited source
never loads a stale library. Each source compiles in its own ``nvcc``
process, all started together, and one more links them.

Every C entry point returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into a ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Must match csrc/common.cuh::DType.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, A, B, scratch, scratch_floats, out, T, D, r, scale, dtype, stream
    "repro_lora_residual": [_P, _P, _P, _P, _L, _P, _I, _I, _I, _F, _I, _P],
    # x, A, B, scratch, scratch_floats, out, K, T, D, r, scale, dtype, stream
    "repro_lora_residual_many": [_P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _F, _I, _P],
    # x, A, B, idx, scratch, scratch_floats, out, T, D, r, N, scale, dtype, stream
    "repro_grouped_lora_residual": [_P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, causal, window, softcap, scale, dtype, stream
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    # q, k, v, out, dout, lse, delta, lse2, dq, dk, dv, B, Sq, Sk, H, Hkv, D, causal, window,
    # softcap, scale, dtype, stream
    "repro_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _F, _I, _P],
    # theta, fisher, w (host), out, K, N, eps, dtype, stream
    "repro_fisher_merge": [_P, _P, _P, _P, _I, _L, _F, _I, _P],
    # num, den, theta, fisher, w, N, dtype, stream
    "repro_fisher_fold": [_P, _P, _P, _P, _F, _L, _I, _P],
    # theta[K*L], fisher[K*L], out[L], n[L], K, L, w[K] (host), eps, dtype, stream, launches
    "repro_fisher_merge_tree": [_P, _P, _P, _P, _I, _I, _P, _F, _I, _P, _P],
    # num[L], den[L], theta[L], fisher[L], n[L], L, w, dtype, stream, launches
    "repro_fisher_fold_tree": [_P, _P, _P, _P, _P, _I, _F, _I, _P, _P],
    "repro_fisher_max_clients": [],
    # x, dt, A, B, C, out, Bt, S, H, P, N, Q, x_sb, x_st, b_sb, b_st, c_sb, c_st, dtype, stream
    "repro_ssd_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _I, _P],
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the library unless this digest is built; return its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library in ``build.log``.
    """
    final = build_dir()
    if (final / LIB_NAME).exists():
        return final / LIB_NAME
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    compiler = nvcc()
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = [compiler, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
            *(str(obj) for _, obj, _ in procs)]
    res = subprocess.run(link, capture_output=True, text=True)
    log.append(f"== link\n{res.stdout}{res.stderr}")
    if res.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + "\n".join(log))
    (tmp / "build.log").write_text("\n".join(log))
    try:
        os.rename(tmp, final)
    except OSError:  # another process built the same digest first
        shutil.rmtree(tmp, ignore_errors=True)
    return final / LIB_NAME


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: tensors must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
