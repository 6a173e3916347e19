"""The federated cohort's client mesh (``repro.sharding``'s ``CLIENT_AXIS``,
``client_mesh`` and ``pad_to_multiple``).

The JAX package partitions a stacked (K, ...) cohort over a 1-D
``("clients",)`` device mesh with ``shard_map``: one controller, K/D
clients on each device. The port does the same in one process: a
:class:`ClientMesh` is a list of ``torch.device``s, a stacked tree of W
rows (W a multiple of D) is cut into D contiguous row blocks, block d on
``devices[d]`` (:class:`Sharded`), and each block goes through the cohort
update on its own device. A mesh may repeat a device: on one card a mesh of
two ``cuda:0`` entries runs the two blocks one after the other there; on
the CPU ``client_mesh(n, device="cpu")`` gives n logical shards of the CPU
(the counterpart of ``--xla_force_host_platform_device_count``). Frozen
trees that every block reads (the backbone, the global adapters) are
placed once on each distinct device (:func:`replicate`).

Logical axes over a **layout** (``resolve_spec``, ``AXIS_ALIASES``): a
layout is an ordered dict of axis sizes, ``{"data": 16, "model": 16}`` or
``{"pod": 2, "data": 16, "model": 16}``, the shape of one of the JAX
package's production meshes. The launch layer's sharding rules resolve
their logical specs over it to count each card's bytes
(``launch/sharding_rules.py``). ``constrain``, ``use_mesh``,
``named_sharding`` and ``residual_spec`` place tensors for XLA; the port runs
one process and shards no model axis, so they have no counterpart.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.utils import tree_bytes, tree_leaves, tree_map, tree_unstack

AxisName = Union[None, str, Tuple[str, ...]]

# Logical-axis aliases: specs say "data" for the batch axis; on the multi-pod
# layout batch parallelism spans ("pod", "data"). The resolver expands the
# alias and then drops whatever axes the layout lacks.
AXIS_ALIASES = {"data": ("pod", "data")}


def _filter_axes(layout: Dict[str, int], dim_size: int,
                 axes: AxisName) -> Optional[Tuple[str, ...]]:
    """Expand aliases and drop axes absent from the layout, then the whole
    dimension if it does not divide evenly (``sharding.py:86-104``)."""
    if axes is None:
        return None
    expanded = []
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        expanded.extend(AXIS_ALIASES.get(a, (a,)))
    kept = tuple(a for a in dict.fromkeys(expanded) if a in layout)
    if not kept or dim_size % math.prod(layout[a] for a in kept):
        return None
    return kept


def resolve_spec(layout: Dict[str, int], shape: Sequence[int],
                 spec: Sequence[AxisName]) -> Tuple[Optional[Tuple[str, ...]], ...]:
    """Per-dimension axis tuples (None: replicated) of a logical ``spec`` over
    ``layout``: aliases expanded and de-duplicated in order, absent and
    non-dividing axes dropped, as JAX's ``resolve_spec`` does on a mesh (a
    single axis comes as a 1-tuple where JAX gives the bare name)."""
    if len(shape) != len(spec):
        raise ValueError(f"shape {tuple(shape)} and spec {tuple(spec)} differ in rank")
    return tuple(_filter_axes(layout, d, a) for d, a in zip(shape, spec))


# Axis name of the 1-D federated-cohort mesh: stacked per-client trees are cut
# along their leading (client) axis over it.
CLIENT_AXIS = "clients"


def _device(dev) -> torch.device:
    """``dev`` with its index filled in for CUDA (``cuda`` -> ``cuda:<current>``),
    so equal devices compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class ClientMesh:
    """A 1-D ``("clients",)`` mesh: shard d of a cohort runs on ``devices[d]``.
    Devices may repeat (several shards on one card, or logical CPU shards)."""

    devices: tuple

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a client mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_device(d) for d in devices))

    axis_names = (CLIENT_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> List[torch.device]:
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices))


def client_mesh(n_devices: Optional[int] = None, device="cuda") -> ClientMesh:
    """A ``("clients",)`` mesh over the first ``n_devices`` visible devices of
    ``device``'s kind (default: every visible card). On the CPU, n logical
    shards of the CPU (default 1). Asking for more cards than are visible
    raises ``ValueError``, as the JAX package does."""
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        visible = n
    else:
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"client_mesh needs >= 1 device, got {n}")
    if n > visible:
        raise ValueError(f"client_mesh(n_devices={n}) but only {visible} {kind} devices are "
                         "visible — a mesh may name one card more than once: "
                         "ClientMesh([torch.device('cuda:0')] * n)")
    if kind == "cpu":
        return ClientMesh([torch.device("cpu")] * n)
    return ClientMesh([torch.device(kind, i) for i in range(n)])


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (cohort padding width)."""
    if m < 1:
        raise ValueError(f"multiple must be >= 1, got {m}")
    return -(-n // m) * m


class Replicated:
    """A frozen tree placed once on each distinct device of a mesh."""

    def __init__(self, tree, mesh: ClientMesh):
        self.mesh = mesh
        self._on: Dict[torch.device, object] = {
            dev: tree_map(lambda t, dev=dev: t.to(dev), tree) for dev in mesh.distinct}

    def on(self, device):
        return self._on[_device(device)]


def replicate(tree, mesh: ClientMesh):
    """``tree`` on every distinct device of ``mesh`` (``to`` is a no-op where a
    leaf already lies); an already replicated tree passes through."""
    return tree if isinstance(tree, Replicated) else Replicated(tree, mesh)


@dataclass
class Sharded:
    """A stacked (W, ...) tree cut into the mesh's D contiguous row blocks:
    ``blocks[d]`` holds rows [d·W/D, (d+1)·W/D) on ``mesh.devices[d]``."""

    blocks: list
    mesh: ClientMesh

    @property
    def block_width(self) -> int:
        return tree_leaves(self.blocks[0])[0].shape[0]

    @property
    def width(self) -> int:
        return self.block_width * len(self.blocks)

    def row_bytes(self) -> int:
        """Bytes of one row (one client's tree)."""
        return tree_bytes(self.blocks[0]) // self.block_width

    def rows(self, k: int) -> list:
        """The first ``k`` rows as per-client trees on ``mesh.devices[0]``
        (views where a block already lies there)."""
        dev0 = self.mesh.devices[0]
        out = []
        for block in self.blocks:
            if len(out) >= k:
                break
            block = tree_map(lambda t: t.to(dev0), block)
            out.extend(tree_unstack(block, min(self.block_width, k - len(out))))
        return out

    def gather(self, k: Optional[int] = None):
        """The first ``k`` rows (default all) as one stacked tree on
        ``mesh.devices[0]``."""
        dev0 = self.mesh.devices[0]
        k = self.width if k is None else k
        return tree_map(lambda *bs: torch.cat([b.to(dev0) for b in bs])[:k], *self.blocks)


def shard(tree, mesh: ClientMesh) -> Sharded:
    """Cut a stacked (W, ...) tree (W a multiple of the mesh size) into the
    mesh's row blocks, block d moved to ``devices[d]``."""
    w = tree_leaves(tree)[0].shape[0] // mesh.size
    return Sharded([tree_map(lambda t, d=d, dev=dev: t[d * w:(d + 1) * w].to(dev), tree)
                    for d, dev in enumerate(mesh.devices)], mesh)
