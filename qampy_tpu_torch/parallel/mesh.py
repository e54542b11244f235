"""Process groups and the collectives of time sharding (counterpart of ``qampy_tpu/parallel/mesh.py``).

One rank is one process, as in the reference's multi-controller runtime:
every rank runs the same program on its own shard. ``init_distributed``
starts ``torch.distributed`` (NCCL on the card, gloo on the CPU), and
``make_mesh`` wraps a process group in a :class:`Mesh`, the rank's view of
the group: its rank, the group's size, the device the rank computes on,
and the collectives the sharded receivers need.

Every exchange is made of ``all_reduce`` and ``broadcast`` alone, so that a
group runs on every backend: NCCL across cards, NCCL with one rank, gloo
with CUDA tensors for several ranks on one card (NCCL refuses two ranks on
one card, and gloo takes CUDA tensors in these two collectives only), and
gloo on CPU tensors. A gather is an ``all_reduce`` of a zeroed ``(size,
...)`` buffer in which each rank wrote its own slot: the sum is exact,
since every other slot is +0. A neighbour's halo is read from such a
gather, so the exchanges cost ``size`` times the halo, which at the
receivers' halo lengths (tens of samples, a few phases, a tap stack) is
nothing that matters. With one rank each collective still makes its call.
A refused collective raises; nothing takes another route.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from qampy_tpu_torch.utils import resolve_device

__all__ = ["TIME", "time_axis", "init_distributed", "make_mesh", "Mesh"]

#: the name of the time axis (the reference's mesh axis); one axis, the ranks' order
TIME = "t"


def time_axis():
    return TIME


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None, device=None):
    """Start this process's rank of a ``torch.distributed`` group.

    ``coordinator_address`` ("host:port", a port free on the host of rank
    0), ``num_processes`` and ``process_id`` name the group; without them
    ``torch.distributed`` reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` from the environment, as ``torchrun`` sets
    them. ``device`` is where the rank computes: None is the card, as in
    every entry of the port. ``backend=None`` is NCCL on the card and gloo
    on the CPU. On the card the rank takes card ``rank % device_count``.
    """
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(init_method="tcp://" + coordinator_address,
                      world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(backend, **kwargs)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_mesh(group=None, device=None):
    """The :class:`Mesh` of this rank in ``group`` (None: the default group).

    ``device``: where the rank's shards live and its receivers compute;
    None is the rank's card (the one ``init_distributed`` set), ``"cpu"``
    the CPU, as the tests run it.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, dev)


class Mesh:
    """A rank's view of its process group, with the collectives of the sharded receivers.

    ``rank`` and ``size`` are this rank's place in the group and the
    group's size; ``device`` where it computes. ``stats`` counts the
    collectives made (``calls``), the bytes each rank put into them
    (``bytes``), the bytes that went through host memory (``host_bytes``:
    gloo stages a CUDA tensor there) and, when ``timed`` is set, the host
    seconds spent in them (``seconds``, each collective between two device
    synchronisations: for measurement only, since it stalls the stream).
    """

    def __init__(self, group, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.device = torch.device(device)
        self.timed = False
        self.stats = dict(calls=0, bytes=0, host_bytes=0, seconds=0.0)

    def barrier(self):
        """Wait for every rank of the group (an uncounted ``all_reduce`` of one element, then a
        device synchronisation)."""
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.group)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def reset_stats(self):
        self.stats = dict(calls=0, bytes=0, host_bytes=0, seconds=0.0)

    def _global(self, rank):
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def _collective(self, fn, t):
        """Run ``fn`` on the real, contiguous tensor ``t`` in place, counted."""
        nbytes = t.numel() * t.element_size()
        self.stats["calls"] += 1
        self.stats["bytes"] += nbytes
        if self.backend == "gloo" and t.is_cuda:
            self.stats["host_bytes"] += nbytes
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        fn(t)
        if self.timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.stats["seconds"] += time.perf_counter() - t0

    @staticmethod
    def _real(t):
        """A real view of a contiguous copy of ``t`` (complex through ``view_as_real``)."""
        t = t.contiguous().clone()
        return (torch.view_as_real(t) if t.is_complex() else t), t

    def sum(self, t):
        """The sum of ``t`` over the ranks (the reference's ``psum``), on every rank."""
        r, out = self._real(t)
        self._collective(lambda x: dist.all_reduce(x, group=self.group), r)
        return out

    def mean(self, t):
        """The mean of ``t`` over the ranks (the reference's ``pmean``): the sum over ``size``."""
        return self.sum(t) / self.size

    def broadcast(self, t, src=0):
        """Rank ``src``'s ``t`` on every rank."""
        r, out = self._real(t)
        self._collective(lambda x: dist.broadcast(x, self._global(src), group=self.group), r)
        return out

    def all_gather(self, t):
        """(size, *t.shape): row d is rank d's ``t``, on every rank.

        Each rank writes its slot of a zeroed buffer and the buffer is summed
        over the ranks: exact, since the other slots are +0.
        """
        buf = torch.zeros((self.size, *t.shape), dtype=t.dtype, device=t.device)
        buf[self.rank] = t
        r = torch.view_as_real(buf) if buf.is_complex() else buf
        self._collective(lambda x: dist.all_reduce(x, group=self.group), r)
        return buf

    def halo_from_right(self, x, n):
        """``x`` with the first ``n`` samples of the right neighbour appended (circular)."""
        heads = self.all_gather(x[..., :n])
        return torch.cat([x, heads[(self.rank + 1) % self.size]], dim=-1)

    def halo_from_left(self, x, n):
        """``x`` with the last ``n`` samples of the left neighbour prepended (circular)."""
        tails = self.all_gather(x[..., x.shape[-1] - n:])
        return torch.cat([tails[(self.rank - 1) % self.size], x], dim=-1)

    def halos(self, x, n):
        """``x`` between the left neighbour's last and the right neighbour's first ``n``
        samples (circular), in one gather."""
        ends = self.all_gather(torch.stack([x[..., :n], x[..., x.shape[-1] - n:]]))
        return torch.cat([ends[(self.rank - 1) % self.size, 1], x,
                          ends[(self.rank + 1) % self.size, 0]], dim=-1)
