"""Checkpoints of the port: trees <-> npz with path-keyed entries
(``repro.checkpoint.io``).

An archive's entries are keyed by ``tree_flatten_with_path``: a dict key,
a sequence index or a NamedTuple field name, joined by ``/``, so the port
and the JAX package write the same keys for the same tree (``opt/mu/text/
down``, ``opt/step``). Restores take the reference structure and are
strict: a leaf whose shape or dtype differs raises, and so do keys missing
or (with ``strict``) extra. Restored leaves are tensors on the reference
leaf's device. Archives are read with ``np.load(allow_pickle=False)``, never
``torch.load``.

bfloat16: numpy has no bfloat16 of its own. The JAX package's ``np.savez``
writes an ``ml_dtypes`` bfloat16 leaf as its 16-bit pattern with the header
type ``'<V2'``; the port writes a bf16 tensor the same way, byte for byte,
and ``np.load`` gives either back as ``|V2``. Where the reference leaf is
bf16, a 2-byte void leaf is viewed back bit for bit. This is the one case
where the port's restore accepts what the JAX package's refuses (its strict
check sees ``|V2`` against bfloat16 and raises, so it cannot restore a bf16
leaf it saved itself); every other dtype mismatch raises as there.

``save_server_checkpoint`` / ``load_server_checkpoint`` carry a server's
backbone, global adapters, comm log, ServerOpt moments and seed
(``SERVER_CHECKPOINT_VERSION = 2``, ``meta.json`` written last). The
backbone is kept in the port's own layout (``layers/<i>/...``, a list of
layers), not the JAX package's stacked one, so a JAX server checkpoint's
adapters load in the port (``load_adapters``) but its backbone does not.
The seed goes where the JAX package keeps its PRNG key's data
(``rng_key``): ``seed_key(seed)``, uint32 (2,), as the JAX key is, with a
tag word the JAX key of a seed below 2**32 never has.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.utils import tree_flatten_with_path, tree_map_with_path

SERVER_CHECKPOINT_VERSION = 2
# First word of the port's ``rng_key`` entry ("torc"); a JAX key's first word
# is its seed's high word, 0 for a seed in [0, 2**32).
SEED_KEY_TAG = 0x746F7263


class CheckpointError(ValueError):
    """A checkpoint could not be restored (corrupt, incomplete, mismatched)."""


class CheckpointVersionError(CheckpointError):
    """The checkpoint's on-disk format version doesn't match this code."""


def seed_key(seed: int) -> np.ndarray:
    """A run's seed as its ``rng_key`` entry: uint32 [SEED_KEY_TAG, seed]."""
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return np.asarray([SEED_KEY_TAG, int(seed)], np.uint32)


def _is_bf16_pattern(arr: np.ndarray) -> bool:
    """A bfloat16 leaf as numpy holds it: 2-byte void (or ml_dtypes' bfloat16)."""
    return (arr.dtype.kind == "V" and arr.dtype.itemsize == 2 and arr.dtype.names is None) \
        or arr.dtype.name == "bfloat16"


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, ref):
    """``arr`` as a leaf like ``ref``: a tensor on ref's device, or numpy."""
    if not torch.is_tensor(ref):
        return np.array(arr)
    if ref.dtype == torch.bfloat16:
        bits = np.array(arr, order="C").view(np.int16)  # keeps 0-d leaves 0-d
        return torch.from_numpy(bits).view(torch.bfloat16).to(ref.device)
    return torch.from_numpy(np.array(arr)).to(ref.device)


def _expected_dtype(ref):
    return torch.empty((), dtype=ref.dtype).numpy().dtype if torch.is_tensor(ref) \
        else np.asarray(ref).dtype


def flatten_pytree(tree, *, prefix: str = "") -> Dict[str, np.ndarray]:
    """A tree as ``{path: np.ndarray}`` (the npz entry layout); bf16 leaves
    as their 16-bit pattern (2-byte void). A non-empty ``prefix`` namespaces
    the keys, so many trees share one archive; a bare leaf maps to
    ``prefix`` itself."""
    return {k: _to_numpy(v) for k, v in tree_flatten_with_path(tree, prefix)}


def unflatten_pytree(reference, data: Mapping[str, np.ndarray], *, prefix: str = "",
                     where: str = "checkpoint"):
    """Rebuild ``reference``'s structure from path-keyed arrays, shape and
    dtype of every leaf exactly the reference's (a bf16 reference leaf takes
    the 2-byte void pattern), on the reference leaf's device."""

    def restore(key, ref):
        if key not in data:
            raise CheckpointError(f"{where} missing key {key!r}")
        arr = data[key]
        want = tuple(ref.shape) if torch.is_tensor(ref) else np.shape(ref)
        if tuple(arr.shape) != want:
            raise CheckpointError(f"shape mismatch for {key}: {where} has {arr.shape}, "
                                  f"reference expects {want}")
        bf16 = torch.is_tensor(ref) and ref.dtype == torch.bfloat16
        if not (_is_bf16_pattern(arr) if bf16 else arr.dtype == _expected_dtype(ref)):
            raise CheckpointError(
                f"dtype mismatch for {key}: {where} holds {arr.dtype}, reference expects "
                f"{'bfloat16' if bf16 else _expected_dtype(ref)}; convert the checkpoint "
                "explicitly instead of relying on a silent cast")
        return _from_numpy(arr, ref)

    return tree_map_with_path(restore, reference, prefix)


def savez(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    """``np.savez(path, **arrays)``, except that a 2-byte void array (a bf16
    leaf) gets the header type ``'<V2'``, as ``ml_dtypes``' bfloat16 gets it
    from ``np.savez``: the JAX package's archive byte for byte."""
    if not path.endswith(".npz"):
        path += ".npz"
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            arr = np.asanyarray(arr)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if _is_bf16_pattern(arr):
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
                    f.write(arr.tobytes(order="C"))
                else:
                    np.lib.format.write_array(f, arr, allow_pickle=False)


def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    savez(path, flatten_pytree(tree))


def load_pytree(path: str, reference, *, strict: bool = True):
    """Restore into the structure of ``reference`` (shapes and dtypes
    enforced); ``strict`` also refuses keys the reference does not have."""
    with np.load(path, allow_pickle=False) as data:
        restored = unflatten_pytree(reference, data, where=os.path.basename(path))
        if strict:
            extra = sorted(set(data.files) - set(flatten_pytree(reference)))
            if extra:
                raise CheckpointError(
                    f"{os.path.basename(path)} carries keys not in the reference structure: "
                    f"{extra[:5]}{'...' if len(extra) > 5 else ''} (pass strict=False to "
                    "ignore)")
    return restored


def load_adapters(path: str, reference):
    """A NanoAdapter tree for serving: ``path`` is a bare ``.npz`` written by
    :func:`save_pytree`, or a :func:`save_server_checkpoint` directory, of
    which only ``global_adapters.npz`` is read (serving shares its own
    frozen backbone across tenants)."""
    if os.path.isdir(path):
        inner = os.path.join(path, "global_adapters.npz")
        if not os.path.exists(inner):
            raise CheckpointError(f"{path!r} is a directory without global_adapters.npz — not "
                                  "a server checkpoint")
        return load_pytree(inner, reference)
    if not os.path.exists(path):
        raise CheckpointError(f"no adapter checkpoint at {path!r}")
    return load_pytree(path, reference)


def save_server_checkpoint(dirpath: str, server, round_idx: int, *, server_opt_state=None,
                           seed=None) -> None:
    """Persist a server: backbone, global adapters, comm log, the ServerOpt
    moments and the seed (as ``rng_key``); ``meta.json`` last, so a save cut
    short leaves no readable checkpoint."""
    os.makedirs(dirpath, exist_ok=True)
    save_pytree(os.path.join(dirpath, "backbone.npz"), server.backbone)
    save_pytree(os.path.join(dirpath, "global_adapters.npz"), server.global_adapters)
    if server_opt_state is not None:
        save_pytree(os.path.join(dirpath, "server_opt_state.npz"), server_opt_state)
    if seed is not None:
        savez(os.path.join(dirpath, "rng_key.npz"), {"rng_key": seed_key(seed)})
    meta = {
        "format_version": SERVER_CHECKPOINT_VERSION,
        "round_idx": round_idx,
        "cfg_name": server.cfg.name,
        "server_round_idx": server.round_idx,
        "has_server_opt_state": server_opt_state is not None,
        "has_rng_key": seed is not None,
        "comm_rounds": server.comm.state_dict(),
    }
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_server_checkpoint(dirpath: str, server, *, server_opt_state=None):
    """-> (``server`` with the saved backbone, adapters, comm log and round,
    meta). ``server_opt_state`` is the reference structure of the moments
    (``server_opt.init(global_adapters)``); they come back under
    ``meta["server_opt_state"]``, the ``rng_key`` entry under
    ``meta["rng_key"]`` and, when the port wrote it, the seed under
    ``meta["seed"]``. Another format version raises
    :class:`CheckpointVersionError`."""
    from repro_torch.core.comm import CommLog

    meta_path = os.path.join(dirpath, "meta.json")
    if not os.path.exists(meta_path):
        raise CheckpointError(f"no checkpoint at {dirpath!r} (meta.json missing)")
    with open(meta_path) as f:
        meta = json.load(f)
    version = meta.get("format_version")
    if version != SERVER_CHECKPOINT_VERSION:
        raise CheckpointVersionError(
            f"checkpoint at {dirpath!r} has format_version={version!r}, this code reads "
            f"v{SERVER_CHECKPOINT_VERSION}; older checkpoints lack the ServerOpt moments / "
            "round RNG and cannot be resumed faithfully — re-save with the current code")
    backbone = load_pytree(os.path.join(dirpath, "backbone.npz"), server.backbone)
    adapters = load_pytree(os.path.join(dirpath, "global_adapters.npz"),
                           server.global_adapters)
    if meta.get("has_server_opt_state"):
        if server_opt_state is None:
            raise CheckpointError(
                f"checkpoint at {dirpath!r} carries ServerOpt moments; pass the reference "
                "structure via server_opt_state= (e.g. server_opt.init(global_adapters)) so "
                "they are not dropped")
        meta["server_opt_state"] = load_pytree(os.path.join(dirpath, "server_opt_state.npz"),
                                               server_opt_state)
    if meta.get("has_rng_key"):
        with np.load(os.path.join(dirpath, "rng_key.npz"), allow_pickle=False) as data:
            key = np.array(data["rng_key"])
        meta["rng_key"] = key
        if key.shape == (2,) and int(key[0]) == SEED_KEY_TAG:
            meta["seed"] = int(key[1])
    return dataclasses.replace(
        server, backbone=backbone, global_adapters=adapters,
        comm=CommLog.from_state_dict(meta.get("comm_rounds", [])),
        round_idx=meta.get("server_round_idx", meta["round_idx"])), meta
