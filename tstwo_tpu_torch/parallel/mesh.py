"""The mesh of ranks a sharded prove runs on, over torch.distributed.

A `Mesh` is the process group of an initialised torch.distributed run with
its rank, size, `(hosts, chips)` shape, the rank's device and the backend,
and it carries the collectives the sharded prove needs: `all_to_all`,
`all_gather` and `broadcast`.  The point axis of a sharded column spans
every rank, hosts-major (rank = host * chips_per_host + chip), as the JAX
package's 2-D mesh lays it out.

The backend is the caller's choice:
  nccl  every rank owns one card, `cuda:<local rank>`; the collectives
        take CUDA tensors as they are.  Two ranks on one card raise.
  gloo  the collectives copy to the host and back, explicitly: this is the
        transport of the CPU tests and of several ranks that share one
        card, not a fallback of NCCL.  The device is the caller's (CUDA
        device 0 unless it names one; "cpu" for the CPU).

`init_distributed` starts the process group with a finite timeout, so that
a rank that dies fails the others instead of hanging them.  Each mesh
counts its collectives in `traffic`: per kind, the calls and the bytes
this rank sent (an all_to_all: the rows that leave the rank; an
all_gather: its part, once per other rank; a broadcast: the tensor, on
the source), and `sizes`, how many calls sent each number of bytes; and
in `leaf_rows` the (log size, columns, rows) of every column entry a
sharded Merkle commit took into this rank's subtrees.  `reset_counts`
clears both.
"""
from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 60.0


def init_distributed(backend: str, init_method: str, rank: int,
                     world_size: int,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """`torch.distributed.init_process_group` with a finite timeout:
    `init_method` is a `tcp://host:port` address or a `file://` store."""
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


class Mesh:
    """The ranks of one process group, shaped (hosts, chips)."""

    def __init__(self, group, rank: int, size: int, shape: Tuple[int, int],
                 device: torch.device, backend: str):
        log = size.bit_length() - 1
        if size < 1 or (1 << log) != size:
            raise ValueError(f"mesh size {size} must be a power of two")
        if shape[0] * shape[1] != size:
            raise ValueError(f"shape {shape} does not hold {size} ranks")
        self.group = group
        self.rank = rank
        self.size = size
        self.log_size = log
        self.shape = tuple(shape)
        self.device = torch.device(device)
        self.backend = backend
        self.traffic = {}
        self.leaf_rows = []
        self.reset_counts()

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"shape={self.shape}, device={self.device}, "
                f"backend={self.backend!r})")

    # -- the point axis ---------------------------------------------------

    def shards(self, log_n: int) -> bool:
        """Whether a column of 2^log_n points is point-sharded: the
        sharded CFFT applies and log_n >= 3, as in the JAX package;
        smaller columns stay replicated on every rank."""
        from .fft import sharded_fft_applicable

        return sharded_fft_applicable(self, log_n) and log_n >= 3

    def local_range(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's part of an axis of n points."""
        m = n // self.size
        return self.rank * m, (self.rank + 1) * m

    # -- collectives --------------------------------------------------------

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective takes: as it is for NCCL, a host copy
        for gloo."""
        t = t.contiguous()
        return t if self.backend == "nccl" else t.cpu()

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.backend == "nccl" else t.to(self.device)

    def reset_counts(self) -> None:
        self.traffic = {name: {"calls": 0, "bytes": 0, "sizes": {}}
                        for name in ("all_to_all", "all_gather", "broadcast")}
        self.leaf_rows = []

    def _count(self, name: str, sent: int) -> None:
        t = self.traffic[name]
        t["calls"] += 1
        t["bytes"] += sent
        t["sizes"][sent] = t["sizes"].get(sent, 0) + 1

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [size, ...]: row j goes to rank j; row j of the result came
        from rank j."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all needs {self.size} rows, got "
                             f"{tuple(x.shape)}")
        src = self._host(x)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        row = src.numel() // self.size * src.element_size()
        self._count("all_to_all", row * (self.size - 1))
        return self._back(out)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: row j is rank j's x."""
        src = self._host(x)
        self._count("all_gather",
                    src.numel() * src.element_size() * (self.size - 1))
        if self.backend == "nccl":
            out = torch.empty((self.size, *src.shape), dtype=src.dtype,
                              device=src.device)
            dist.all_gather_into_tensor(out, src, group=self.group)
            return out
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return self._back(torch.stack(parts))

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s x on every rank (the mesh is the whole process
        group, so its ranks are the global ones)."""
        buf = self._host(x).clone()
        dist.broadcast(buf, src, group=self.group)
        self._count("broadcast", buf.numel() * buf.element_size()
                    * (self.size - 1) if self.rank == src else 0)
        return self._back(buf)

    def barrier(self) -> None:
        self.all_gather(torch.zeros(1, dtype=torch.int32,
                                    device=self.device))


def _device_for(backend: str, local_rank: int, chips: int, device):
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if chips > n_cards:
            raise ValueError(
                f"NCCL needs a card of its own for each of the {chips} "
                f"ranks of a host, and this host has {n_cards}: give "
                f"ranks that share a card the gloo backend")
        own = torch.device("cuda", local_rank)
        if device is not None and torch.device(device) != own:
            raise ValueError(f"an NCCL rank runs on {own}, not {device}")
        torch.cuda.set_device(own)
        return own
    from ..utils import entry_device

    return entry_device(device)


def _world(n: Optional[int]):
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised "
                           "(see init_distributed)")
    size = dist.get_world_size()
    if n is not None and n != size:
        raise ValueError(f"requested {n} ranks, the process group has {size}")
    return dist.get_rank(), size, dist.get_backend()


def make_mesh(n: Optional[int] = None, device=None) -> Mesh:
    """A 1-D mesh over every rank of the initialised process group (one
    host); `n`, if given, must be its size."""
    rank, size, backend = _world(n)
    dev = _device_for(backend, rank, size, device)
    return Mesh(dist.group.WORLD, rank, size, (1, size), dev, backend)


def make_mesh2d(n_hosts: int, chips_per_host: int, device=None) -> Mesh:
    """A (hosts, chips) mesh over the initialised process group of
    n_hosts * chips_per_host ranks; the point axis spans both, hosts-major,
    and an NCCL rank takes card `rank % chips_per_host` of its host."""
    rank, size, backend = _world(n_hosts * chips_per_host)
    dev = _device_for(backend, rank % chips_per_host, chips_per_host, device)
    return Mesh(dist.group.WORLD, rank, size, (n_hosts, chips_per_host),
                dev, backend)
