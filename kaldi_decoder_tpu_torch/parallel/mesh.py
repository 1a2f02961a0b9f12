"""Data-parallel scale-out over a ``torch.distributed`` device mesh.

The torch counterpart of ``kaldi_decoder_tpu/parallel/mesh.py``.  Where
the JAX package runs one controller over every chip, here each rank is a
process with its own device, and every rank runs the same program (SPMD).
A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dimensions: ``make_mesh(n)`` a 1-D ``("data",)`` mesh, ``make_mesh((2, 2),
("data", "model"))`` a 2-D one.  Decoders given a mesh split the batch over
its ``data`` dimension (:func:`batch_sharding`), each rank decoding its own
rows with the graph whole on every rank (:func:`replicated`) and no
collective in the frame loop, and gather the downloaded results so that
every rank holds all rows; :mod:`kaldi_decoder_tpu_torch.parallel.graph_shard`
also splits the graph's states over a ``model`` dimension.

Backends: NCCL for a ``cuda`` mesh, gloo for a ``cpu`` one
(:data:`BACKENDS`), unless the caller names one.  NCCL refuses two ranks
on one card; to exchange between two ranks that share ``cuda:0``, ask for
``initialize_distributed(backend="gloo", ...)`` and ``make_mesh(...,
device_type="cuda")``: the collectives below then stage each CUDA tensor
through the host (:func:`staged`), as gloo must.  Nothing here picks
another backend or device when the one asked for fails.

Every collective of the decoders goes through the helpers below, which
count their calls by kind in :data:`collective_calls`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# The backend of each mesh device type, unless the caller names one.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# Calls of each collective helper in this process (reset by the caller).
collective_calls: collections.Counter = collections.Counter()


def initialize_distributed(device_type: str = "cuda", **kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)``, a no-op if the
    default group exists.  Without ``backend`` it is the one of
    ``device_type`` (NCCL for ``cuda``, gloo for ``cpu``)."""
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", BACKENDS[device_type])
    dist.init_process_group(**kwargs)


def make_mesh(
    num_devices: Union[None, int, Sequence[int]] = None,
    axis_name: Union[str, Sequence[str]] = "data",
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over the first ranks of the default group: ``num_devices``
    ranks (every rank when None) on one dimension named ``axis_name``, or,
    with a shape and as many names, an N-D mesh (rank-major, the last
    dimension fastest).  Initializes the default group through
    :func:`initialize_distributed` when there is none (the ``env://``
    variables then say where the ranks meet)."""
    initialize_distributed(device_type)
    if num_devices is None:
        shape: Tuple[int, ...] = (dist.get_world_size(),)
    elif isinstance(num_devices, int):
        shape = (num_devices,)
    else:
        shape = tuple(int(n) for n in num_devices)
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if len(names) != len(shape):
        raise ValueError(f"mesh shape {shape} needs {len(shape)} axis names, got {names}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which rows of a batch-leading array this rank holds: the array is
    cut into ``parts`` equal slices along mesh dimension ``axis`` and this
    rank holds slice ``part`` (``axis`` None: the whole array, on every
    rank)."""

    mesh: DeviceMesh
    axis: Optional[str]
    part: int
    parts: int

    def rows(self, batch: int) -> slice:
        """This rank's rows of a batch of ``batch`` (a multiple of ``parts``)."""
        if batch % self.parts:
            raise ValueError(f"batch {batch} does not split into {self.parts} parts")
        n = batch // self.parts
        return slice(self.part * n, (self.part + 1) * n)

    @property
    def group(self):
        """The process group along ``axis`` (None when replicated)."""
        return None if self.axis is None else self.mesh.get_group(self.axis)


def _dim_size(mesh: DeviceMesh, axis_name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no dimension {axis_name!r} (its dimensions: {names})")
    return mesh.size(names.index(axis_name))


def batch_sharding(mesh: DeviceMesh, axis_name: str = "data") -> Sharding:
    """The leading (batch) axis split over the mesh dimension ``axis_name``."""
    parts = _dim_size(mesh, axis_name)
    return Sharding(mesh, axis_name, mesh.get_local_rank(axis_name), parts)


def replicated(mesh: DeviceMesh) -> Sharding:
    """The whole array on every rank of the mesh."""
    return Sharding(mesh, None, 0, 1)


def pad_batch(
    scores: np.ndarray, lengths: np.ndarray, multiple: int
) -> tuple:
    """Pad the batch axis to a multiple of the mesh size with empty
    (length-0) utterances; returns (scores, lengths, original_B)."""
    B = scores.shape[0]
    Bp = ((B + multiple - 1) // multiple) * multiple
    if Bp == B:
        return scores, lengths, B
    scores_p = np.zeros((Bp,) + scores.shape[1:], scores.dtype)
    scores_p[:B] = scores
    lengths_p = np.zeros((Bp,), lengths.dtype)
    lengths_p[:B] = lengths
    return scores_p, lengths_p, B


def local_batch(
    scores: np.ndarray,
    lengths: np.ndarray,
    num_frames: int,
    rows: Optional[Sharding],
    multiple: Optional[int] = None,
) -> tuple:
    """This rank's rows of a batch, time-major: ``scores`` (B, T, V) and
    ``lengths`` (B,) padded by :func:`pad_batch` to a multiple of
    ``multiple`` (``rows.parts`` when None), cut to ``rows``'s slice (every
    row when ``rows`` is None) and padded with zeros to ``num_frames``.
    Returns (scores (num_frames, Bl, V) float32, lengths (Bl,) int32)."""
    if rows is not None:
        scores, lengths, _ = pad_batch(scores, lengths, multiple or rows.parts)
        part = rows.rows(scores.shape[0])
        scores, lengths = scores[part], lengths[part]
    Bl, T, V = scores.shape
    scores_tm = np.zeros((num_frames, Bl, V), np.float32)
    scores_tm[:T] = scores.transpose(1, 0, 2)
    return scores_tm, np.ascontiguousarray(lengths, np.int32)


def check_device(mesh: DeviceMesh, device) -> torch.device:
    """``device`` as a torch.device, which must be of the mesh's type."""
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"device {device} is not of the mesh's type {mesh.device_type!r}")
    return device


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def staged(x: torch.Tensor, group) -> bool:
    """True when ``x`` crosses ``group`` through the host: a CUDA tensor
    on a gloo group (two ranks sharing one card)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced over ``group`` with ``op`` ("min", "max" or "sum"),
    a new tensor on ``x``'s device."""
    collective_calls[f"all_reduce_{op}"] += 1
    red = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
    y = x.cpu() if staged(x, group) else x.clone()
    dist.all_reduce(y, op=red, group=group)
    return y.to(x.device)


def all_gather_into(x: torch.Tensor, out: Optional[torch.Tensor], group) -> torch.Tensor:
    """Every rank's ``x`` (same shape) stacked in rank order of ``group``
    into ``out`` (P, *x.shape) on ``x``'s device (a new tensor when None),
    with no copy on the device but the host's staging over gloo."""
    collective_calls["all_gather"] += 1
    shape = (dist.get_world_size(group),) + tuple(x.shape)
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if dist.get_backend(group) != "gloo":
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    host = out if out.device.type == "cpu" else torch.empty(shape, dtype=x.dtype)
    dist.all_gather(list(host.unbind(0)), x.cpu().contiguous(), group=group)
    if host is not out:
        out.copy_(host)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (P, ...) with slice p sent to rank p of ``group``; returns
    (P, ...) with slice p received from rank p."""
    collective_calls["all_to_all"] += 1
    y = x.cpu().contiguous() if staged(x, group) else x.contiguous()
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y, group=group)
    return out.to(x.device)


def all_gather_object(obj, group) -> List:
    """Every rank's ``obj`` (picklable host data), in rank order of
    ``group``."""
    collective_calls["all_gather_object"] += 1
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def concat_parts(parts: Sequence[np.ndarray], axis: int, fill=-1) -> np.ndarray:
    """Arrays of the ranks concatenated along ``axis``; the other axes are
    padded with ``fill`` to the largest (survivor rows past a row's count
    are never read)."""
    parts = [np.asarray(p) for p in parts]
    shape = np.max([p.shape for p in parts], axis=0)
    padded = []
    for p in parts:
        want = [int(s) if i != axis else p.shape[i] for i, s in enumerate(shape)]
        if list(p.shape) != want:
            q = np.full(want, fill, p.dtype)
            q[tuple(slice(0, n) for n in p.shape)] = p
            p = q
        padded.append(p)
    return np.concatenate(padded, axis=axis)
