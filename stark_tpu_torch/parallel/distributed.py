"""The prover's 1-D device mesh on `torch.distributed`.

Counterpart of `stark_tpu/parallel/distributed.py`. `DomainMesh` stands
where JAX's `Mesh` stands in `global_mesh_1d`: d ranks, one device a rank,
and rank r owns the contiguous chunk [r N/d, (r+1) N/d) of every
precision-domain column. JAX's `host_local_mesh` has no counterpart: a torch
rank owns one device, so a process holds one rank of the mesh (several
ranks may share a process, each with its own group and mesh object).

`initialize` takes every setting as an argument (rank, world size, a
`tcp://host:port` rendezvous, backend, device, timeout), or a ready
`ProcessGroup`. The backend is the caller's explicit choice and is fixed
when the mesh is built:

* "nccl" needs a card a rank: rank r runs on cuda:r, and a mesh with more
  ranks than the host has cards is refused;
* "gloo" runs on CPU tensors; with CUDA tensors every collective stages its
  operands through pinned host buffers (one code path, chosen here, never
  by catching an error). d ranks on one card can only take this path.

There is no automatic choice and no fallback between backends.

The collectives the sharded prover needs are the mesh's methods; each takes
and returns tensors on `mesh.device`, synchronises the device before and
after, and adds its calls, seconds and bytes (the size of the tensor it
returns) to `mesh.stats` under its kind. `run_ranks` starts d ranks as OS
processes (the counterpart of `scripts/multihost_dryrun.py`'s launcher).
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass, field
from urllib.parse import urlparse

import torch
import torch.distributed as dist

from stark_tpu_torch import device as devmod
from stark_tpu_torch.utils import tracing

BACKENDS = ("gloo", "nccl")
_STORE_PREFIX = "stark_tpu_torch.mesh"
_SHIFT_TAG = 17


@dataclass(eq=False)
class DomainMesh:
    """One rank's view of the 1-D mesh: its rank, the mesh's size, its
    device, the process group and the backend. `staged` is set where gloo
    carries CUDA tensors through pinned host buffers. Equality and hashing
    are by identity: every rank's mesh is its own object, and the stage
    cache keys on it."""

    rank: int
    size: int
    device: torch.device
    group: object
    backend: str
    staged: bool
    stats: dict = field(default_factory=dict)

    @property
    def key(self) -> tuple[int, int]:
        """(size, rank): what a cache of this rank's chunks keys on."""
        return (self.size, self.rank)

    def reset_stats(self) -> None:
        self.stats = {}

    # --- plumbing ---------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            tracing.count_sync()  # torch's sync debug mode does not flag it

    def _to_backend(self, x: torch.Tensor) -> torch.Tensor:
        """x as the backend takes it: contiguous, and on the host (pinned)
        where the mesh is staged."""
        if not self.staged:
            return x.contiguous()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host

    def _empty(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _from_backend(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, non_blocking=True) if self.staged else x

    def _timed(self, kind: str, run):
        self._sync()
        t0 = time.perf_counter()
        out = run()
        self._sync()
        rec = self.stats.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
        rec["calls"] += 1
        rec["bytes"] += out.numel() * out.element_size()
        rec["seconds"] += time.perf_counter() - t0
        return out

    # --- collectives --------------------------------------------------------

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(L, d, B) -> (L, d, B) with out[:, j] = rank j's x[:, self.rank]
        (`jax.lax.all_to_all` with split_axis = concat_axis = 1)."""
        if x.dim() != 3 or x.shape[1] != self.size:
            raise ValueError(f"all_to_all takes (L, {self.size}, B), got {tuple(x.shape)}")
        if self.size == 1:
            return x

        def run():
            inp = self._to_backend(x.transpose(0, 1))
            out = self._empty(inp.shape, inp.dtype)
            self.group.alltoall_base(out, inp, [], [], dist.AllToAllOptions()).wait()
            return self._from_backend(out).transpose(0, 1).contiguous()

        return self._timed("all_to_all", run)

    def all_gather_stack(self, x: torch.Tensor) -> torch.Tensor:
        """x -> (d, *x.shape): every rank's x, in rank order."""
        if self.size == 1:
            return x[None]

        def run():
            inp = self._to_backend(x)
            out = self._empty((self.size * x.shape[0],) + tuple(x.shape[1:]), x.dtype)
            self.group._allgather_base(out, inp).wait()
            return self._from_backend(out).reshape((self.size,) + tuple(x.shape))

        return self._timed("all_gather", run)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(R, m) -> (R, d m): the ranks' chunks side by side along axis 1
        (a tiled `jax.lax.all_gather`)."""
        g = self.all_gather_stack(x)
        return g.permute(1, 0, 2).reshape(x.shape[0], -1).contiguous()

    def shift(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """Send x to rank (r + k) mod d and return what rank (r - k) mod d
        sent (`jax.lax.ppermute` with the pairs (src, src + k))."""
        if k % self.size == 0:
            return x
        dst, src = (self.rank + k) % self.size, (self.rank - k) % self.size

        def run():
            inp = self._to_backend(x)
            out = self._empty(inp.shape, inp.dtype)
            works = [self.group.send([inp], dst, _SHIFT_TAG),
                     self.group.recv([out], src, _SHIFT_TAG)]
            for w in works:
                w.wait()
            return self._from_backend(out)

        return self._timed("shift", run)

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        """Elementwise OR over the ranks of an int32 flag tensor (the
        `psum` of the divisibility flags)."""
        if self.size == 1:
            return flags

        def run():
            t = self._to_backend(flags.to(torch.int32))
            opts = dist.AllreduceOptions()
            opts.reduceOp = dist.ReduceOp.MAX
            self.group.allreduce([t], opts).wait()
            return self._from_backend(t)

        return self._timed("any", run)


def _gloo_group(store, rank: int, world_size: int, host: str, timeout: float):
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=host)]
    return dist.ProcessGroupGloo(store, rank, world_size, opts)


def _nccl_group(store, rank: int, world_size: int, timeout: float):
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = datetime.timedelta(seconds=timeout)
    return dist.ProcessGroupNCCL(store, rank, world_size, opts)


def initialize(rank: int, world_size: int, init_method: str | None = None,
               backend: str = "gloo", device="cuda", timeout: float = 600.0,
               group=None) -> DomainMesh:
    """The caller's rank of a d-rank mesh. `init_method` is
    a `tcp://host:port` rendezvous that rank 0 serves; a ready `group` (a
    `ProcessGroup` of `world_size` ranks in which this one is `rank`) takes
    its place. A one-rank mesh needs neither."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a mesh of {world_size}")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"nccl needs a card a rank: {world_size} ranks, {cards} card(s); "
                "ranks that share a card take backend='gloo' (staged through "
                "host memory)"
            )
        if torch.device(device) != torch.device("cuda", rank):
            raise ValueError(f"nccl rank {rank} runs on cuda:{rank}, not on {device}")
    dev = devmod.resolve(device)
    if group is None and world_size > 1:
        if init_method is None:
            raise ValueError("a mesh of several ranks needs init_method or group")
        url = urlparse(init_method)
        if url.scheme != "tcp" or url.hostname is None or url.port is None:
            raise ValueError(f"init_method must be tcp://host:port, got {init_method!r}")
        store = dist.PrefixStore(_STORE_PREFIX, dist.TCPStore(
            url.hostname, url.port, world_size, rank == 0,
            datetime.timedelta(seconds=timeout)))
        group = (_gloo_group(store, rank, world_size, url.hostname, timeout)
                 if backend == "gloo" else _nccl_group(store, rank, world_size, timeout))
    if group is not None and (group.size() != world_size or group.rank() != rank):
        raise ValueError(
            f"the group is rank {group.rank()} of {group.size()}, not {rank} of {world_size}"
        )
    return DomainMesh(rank, world_size, dev, group, backend,
                      staged=backend == "gloo" and dev.type == "cuda")


def shard_cols(x: torch.Tensor, mesh: DomainMesh) -> torch.Tensor:
    """The rank's contiguous chunk of a replicated (L, N) tensor (the
    counterpart of `put_global` with P(None, "d"))."""
    n = x.shape[1]
    if n % mesh.size:
        raise ValueError(f"{n} columns do not split over {mesh.size} ranks")
    m = n // mesh.size
    return x[:, mesh.rank * m : (mesh.rank + 1) * m].contiguous()


# ---------------------------------------------------------------------------
# d ranks as OS processes
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world_size, device, backend, init_method, timeout, args, results):
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        mesh = initialize(rank, world_size, init_method, backend, device, timeout)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, device="cuda", backend: str = "gloo",
              timeout: float = 600.0, args=()) -> list:
    """Run fn(mesh, *args) on `world_size` ranks, each an OS process started
    with the `spawn` method (a forked child cannot use CUDA), over a
    `tcp://127.0.0.1` rendezvous. Returns the ranks' results in rank order;
    a rank's exception is raised here with its traceback, and a run that
    outlasts `timeout` (also every collective's timeout) raises
    `TimeoutError`. Every process is stopped before this returns. `fn` and
    its results must pickle. On "gloo" every rank runs on `device`; on
    "nccl" rank r runs on cuda:r. On a card the kernel library is built here
    first, so that the ranks load it."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = devmod.resolve(device)
    if dev.type == "cuda":
        from stark_tpu_torch.ops import build

        build.library_path()
    devices = ([f"cuda:{r}" for r in range(world_size)] if backend == "nccl"
               else [str(dev)] * world_size)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world_size, devices[r], backend, init_method,
                               timeout, tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue_mod.Empty:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(out))} gave no "
                    f"result within {timeout} s"
                ) from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
