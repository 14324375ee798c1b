"""Named device meshes over ``torch.distributed`` (counterpart of
flashattn_tpu/parallel/mesh.py).

JAX runs one program over a mesh of devices; the port runs one process per
rank, each holding its own shard.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions (the
JAX mesh's axis names), built over a process group that the caller has
initialised with world size ``prod(shape)`` (:func:`init_distributed`
does it, with the backend that follows the device: NCCL for CUDA, gloo
for the CPU).

A placement is a :class:`PartitionSpec`: a tuple with, for each tensor
dim, the mesh axis it is split over (``None`` = not split).  Where JAX
puts an array on the mesh (``jax.device_put(x, NamedSharding(mesh,
spec))``), the port takes this rank's slice (:func:`local_shard`); where
JAX reads a global array back, :func:`unshard` gathers the slices.
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

# every process group of the port waits at most this long on a peer
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry a tensor dim, a mesh axis name or
    None; trailing dims not listed are not split.  ``P() == ()`` is the
    replicated placement."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


P = PartitionSpec


def _backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def init_distributed(rank: int, world_size: int, init_method: str,
                     device: str = "cuda",
                     timeout: datetime.timedelta = GROUP_TIMEOUT) -> None:
    """Initialise the default process group for ``device`` ("cuda": NCCL,
    one card a rank, ``cuda:rank % device_count``; "cpu": gloo).  The
    backend follows the device asked for, never what is found: a CUDA
    group without a GPU raises.  ``init_method`` is a ``tcp://`` or
    ``file://`` URL."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group needs a GPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(_backend(device), init_method=init_method,
                            rank=rank, world_size=world_size, timeout=timeout)


def create_mesh(shape: Sequence[int], names: Sequence[str],
                devices: Optional[str] = None):
    """A named mesh over the initialised process group, whose world size
    must be ``prod(shape)``.  ``devices`` is the device type, "cuda" (the
    default) or "cpu"; the default group's backend must be the one that
    device takes (NCCL / gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if n != have:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {have}")
    device = "cuda" if devices is None else devices
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a GPU")
    backend = dist.get_backend()
    if backend != _backend(device):
        raise ValueError(f"a {device} mesh needs a {_backend(device)} "
                         f"process group, not {backend}")
    return init_device_mesh(device, shape, mesh_dim_names=tuple(names))


def default_mesh(n_devices: Optional[int] = None,
                 tp_size: Optional[int] = None, devices: Optional[str] = None):
    """A (data, model) mesh: TP over the minor axis, DP over the rest.
    ``tp_size`` defaults to the largest of 8, 4, 2 that divides the device
    count (else 1)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if tp_size is None:
        tp_size = 1
        for cand in (8, 4, 2):
            if cand <= n and n % cand == 0:
                tp_size = cand
                break
    assert n % tp_size == 0
    return create_mesh((n // tp_size, tp_size), (DATA_AXIS, MODEL_AXIS),
                       devices)


def batch_sharding(mesh, axis: str = DATA_AXIS) -> PartitionSpec:
    """The placement that splits the leading (batch) dim over ``axis``."""
    return P(axis)


def replicated(mesh) -> PartitionSpec:
    return P()


# -- axis helpers ---------------------------------------------------------------


def check_mesh(mesh) -> None:
    """Raise TypeError unless ``mesh`` is a device mesh (or None)."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a device mesh (parallel.create_mesh), got "
                        f"{type(mesh).__name__}")


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: Optional[str]) -> int:
    """The size of mesh axis ``name`` (1 for None or an axis the mesh does
    not have)."""
    if mesh is None or name is None or name not in axis_names(mesh):
        return 1
    return mesh.size(axis_names(mesh).index(name))


def axis_index(mesh, name: Optional[str]) -> int:
    """This rank's coordinate along mesh axis ``name`` (0 off the mesh)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh, name: Optional[str]):
    """The process group of this rank's line along axis ``name``, or None
    when the axis has size 1 (every collective over it is the identity)."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def _spec_dims(spec, ndim: int) -> list:
    """For each of ``ndim`` dims, the tuple of mesh axes ``spec`` splits it
    over, major to minor (JAX's ``P(("data", "model"))``); () for a whole
    dim."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec!r} has more entries than the tensor's "
                         f"{ndim} dims")
    entries = list(spec) + [None] * (ndim - len(spec))
    return [() if e is None else (e,) if isinstance(e, str) else tuple(e)
            for e in entries]


def local_shard(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` (a view;
    ``jax.device_put`` with a NamedSharding).  Every split dim must divide
    by the product of its axes' sizes."""
    for i, axes in enumerate(_spec_dims(spec, t.ndim)):
        n, index = 1, 0
        for name in axes:
            index = index * axis_size(mesh, name) + axis_index(mesh, name)
            n *= axis_size(mesh, name)
        if n == 1:
            continue
        if t.shape[i] % n:
            raise ValueError(f"dim {i} of size {t.shape[i]} does not split "
                             f"over mesh axes {axes} of size {n}")
        w = t.shape[i] // n
        t = t.narrow(i, index * w, w)
    return t


def unshard(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The global tensor whose block under ``spec`` this rank holds as
    ``t`` (an all-gather over each split dim's axis; no gradient)."""
    from .comm import all_gather

    t = t.detach()
    with torch.no_grad():
        for i, axes in enumerate(_spec_dims(spec, t.ndim)):
            for name in reversed(axes):     # minor axis first
                t = all_gather(t, axis_group(mesh, name), i)
    return t
