"""The sharded frame driver: a sharded chunk's frames on static buffers,
replayed on a card from one captured CUDA graph under NCCL.

The original runs a sharded chunk as one compiled device program, a jitted
``shard_map`` over a ``lax.scan`` of frames with the collectives inside
(``kaldi_decoder_tpu/parallel/graph_shard.py`` ``_build_sharded_chunk_fn``,
``_build_sharded_lattice_chunk_fn``), so the device never waits on the
host between frames.  Here a :class:`ShardDriver` runs one batch's sharded
frame (``graph_shard._sharded_frame`` or ``_sharded_lattice_frame``) on
buffers it keeps across decodes (``graph_shard._Bufs``: the slots of
``kernels.frame.ShardSlots``, the route buffers, the eps carry, K8's
buffers and each collective's output), so that nothing a frame's launches
name changes from one frame, decode or length to the next: K3's shard
mode reads ``t`` and the chunk's tensors from its table in device memory.

Which loop runs is decided from the backends of the groups the frame
exchanges over, when the driver is made, never by a failure:

- on a card where every group is NCCL, the frame is captured once into a
  ``torch.cuda.CUDAGraph`` and replayed once a frame for every decode and
  every length, by the unsharded frame driver's runner
  (``decoders.driver.GraphedFrame``): a driver's first frame runs eagerly
  before the capture, so that every kernel is loaded and sized and every
  NCCL communicator is made; a capture or replay that fails raises;
- over gloo (two ranks sharing one card: each exchange is staged through
  the host, ``mesh.staged``, which a graph cannot hold) and on the CPU
  (the plain versions of every kernel), the same frame runs from the host
  loop, frame after frame.

Within ``decoders.driver.eager_frames()`` the chunk runs the host loop on
every backend: the yardstick of the graph.

Counts: a capture launches and exchanges nothing, so the wrappers' launch
counts and ``mesh.collective_calls`` are put back after it, and each
replay adds the launches and collective calls the graph holds;
``decoders.driver.replays`` counts the frames replayed.

The kept drivers hold their graphs, and a graph holds its collectives'
NCCL communicators, which NCCL does not destroy while such a graph lives
(``ncclCommDestroy`` waits for the graphs that hold its communicator to
go): :func:`release` drops them.  ``mesh.shutdown_distributed`` calls it
before it destroys the groups, and a sharded decoder's ``close()`` (or
the end of its ``with`` block) drops its own drivers.  A plain ``torch.distributed.destroy_process_group()`` runs
no code of this package first: before it, close the decoders or call
:func:`release`.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from kaldi_decoder_tpu_torch.decoders import driver
from kaldi_decoder_tpu_torch.kernels.cutoff import global_cutoff_merge
from kaldi_decoder_tpu_torch.kernels.dedup import shard_reduce
from kaldi_decoder_tpu_torch.kernels.eps import eps_step_shard
from kaldi_decoder_tpu_torch.kernels.route import route_recv, route_send
from kaldi_decoder_tpu_torch.parallel.mesh import collective_calls

# The wrappers whose launches a captured sharded frame holds (the local
# values written by an emitting dedup call, ``shard_reduce``, beside them).
COUNTED = driver.COUNTED + (route_send, route_recv, eps_step_shard, shard_reduce,
                             global_cutoff_merge)

# Drivers kept (``decoders.driver.kept_driver``: at most ``MAX_DRIVERS``,
# each holding its static buffers, graph and graph pool).
_drivers: "collections.OrderedDict" = collections.OrderedDict()


class ShardDriver:
    """One batch's sharded frames: ``frame()`` runs one frame on ``bufs``
    (the driver's static buffers), exchanging over ``groups``, on
    ``device``; where every group is NCCL and the device a card, it is
    replayed through a ``decoders.driver.GraphedFrame`` (``batch`` rows of
    ``num_states`` states size its winner table)."""

    def __init__(self, frame: Callable[[], None], bufs, groups: Sequence, device, batch: int,
                 num_states: int):
        self.frame, self.bufs = frame, bufs
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:  # the wrappers key by the index
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.graphed: Optional[driver.GraphedFrame] = None
        if dev.type == "cuda" and all(dist.get_backend(g) == "nccl" for g in groups):
            self.graphed = driver.GraphedFrame(frame, dev, batch, num_states, COUNTED,
                                               collective_calls)

    @property
    def pool_bytes(self):
        """(allocated, reserved) bytes the capture kept, None before it."""
        return None if self.graphed is None else self.graphed.pool_bytes

    def run(self, frames: int) -> None:
        """The chunk begun on the slots (``kernels.frame.frame_start_shard``):
        its ``frames`` frames."""
        if self.graphed is None or driver._eager:
            for _ in range(frames):
                self.frame()
        else:
            self.graphed.run(frames)

    def release(self) -> None:
        """Wait for the card and destroy the graph (``GraphedFrame.release``)."""
        if self.graphed is not None:
            self.graphed.release()


# The launch and collective counts of a sharded frame, held and added per
# replay (``decoders.driver.held_counts``, ``add_replays``).
held_counts = functools.partial(driver.held_counts, counted=COUNTED, calls=collective_calls)
add_replays = functools.partial(driver.add_replays, counted=COUNTED, calls=collective_calls)


def driver_for(key, make: Callable[[], ShardDriver]) -> ShardDriver:
    """The kept sharded frame driver of ``key``, or ``make()``'s."""
    return driver.kept_driver(_drivers, key, make)


def release(where: Optional[Callable[[tuple], bool]] = None) -> None:
    """Drop the kept sharded frame drivers (those whose key ``where``
    holds true of, every one when None), each released: its card finished
    with it and its graph destroyed.  Call it before the groups go
    (``mesh.shutdown_distributed`` does): NCCL does not destroy a
    communicator while a graph holding its collectives lives."""
    if where is None:
        driver.release(_drivers)
        return
    for key in [k for k in _drivers if where(k)]:
        _drivers.pop(key).release()
