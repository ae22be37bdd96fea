"""Mesh bring-up and row sharding for the distributed operators.

Counterpart of ``radix_sort_tpu/parallel/runtime.py``. The JAX package
runs its distributed bodies under ``shard_map`` over a device mesh; PyTorch
has no such transform, so the port spells the mesh out:

  * a :class:`Mesh` is an ordered list of P shard slots. Each slot is a
    ``torch.device`` owned by one process; a process owns a contiguous run
    of slots. Several slots may share one device: ``data_mesh(4)`` is four
    slots on one card (one card cannot host several NCCL ranks), which is
    how the port runs a 4-shard mesh on a single GPU;
  * a :class:`Sharded` column is one global column held as row blocks, one
    block per slot this process owns. :func:`shard_rows` cuts global rows
    into blocks; :func:`gather_rows` joins every slot's block (across
    processes too) into the JAX package's global padded layout, and
    :func:`valid_rows` joins each slot's valid prefix;
  * :func:`initialize_multihost` brings up ``torch.distributed`` (gloo for
    CPU slots, NCCL for CUDA slots) and :func:`run_local_cluster` launches
    a local cluster of such processes. The collectives that the
    distributed bodies call between their phases are in
    :mod:`.collectives`.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "Sharded",
    "data_mesh",
    "gather_rows",
    "initialize_multihost",
    "local_blocks",
    "run_local_cluster",
    "shard_rows",
    "valid_rows",
]

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Mesh:
    """P shard slots in order. ``owners[s]`` is the process (its
    ``torch.distributed`` rank) that owns slot s; ``local`` lists the slots
    this process owns and ``devices`` their devices, in the same order."""

    def __init__(self, owners, devices, rank: int = 0):
        self.owners = tuple(int(o) for o in owners)
        if list(self.owners) != sorted(self.owners):
            raise ValueError("each process must own a contiguous run of slots")
        self.rank = int(rank)
        self.local = tuple(s for s, o in enumerate(self.owners) if o == self.rank)
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.local or len(self.devices) != len(self.local):
            raise ValueError(f"process {rank} must own at least one slot and name a "
                             f"device for each ({len(self.local)} slots, "
                             f"{len(self.devices)} devices)")

    @property
    def size(self) -> int:
        """P, the number of shard slots."""
        return len(self.owners)

    @property
    def home(self) -> torch.device:
        """This process's first slot device: replicated results live here."""
        return self.devices[0]

    @property
    def num_processes(self) -> int:
        return self.owners[-1] + 1

    @property
    def multiprocess(self) -> bool:
        return self.num_processes > 1

    def __repr__(self):
        return (f"Mesh(size={self.size}, processes={self.num_processes}, rank={self.rank}, "
                f"devices={[str(d) for d in self.devices]})")


class Sharded:
    """One global column held as row blocks: ``blocks[i]`` belongs to slot
    ``mesh.local[i]``. Every slot's block has the same length, so the
    global column has ``mesh.size * len(block)`` rows."""

    __slots__ = ("mesh", "blocks")

    def __init__(self, mesh: Mesh, blocks):
        blocks = list(blocks)
        if len(blocks) != len(mesh.local):
            raise ValueError(f"{len(blocks)} blocks for {len(mesh.local)} local slots")
        if len({b.shape for b in blocks}) != 1:
            raise ValueError("all blocks of a sharded column must have one shape")
        self.mesh = mesh
        self.blocks = blocks

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def block_rows(self) -> int:
        return self.blocks[0].shape[0]

    @property
    def shape(self):
        """The global column's shape, as the JAX package's global array."""
        return (self.mesh.size * self.block_rows,)

    def __repr__(self):
        return f"Sharded({self.dtype}, {self.mesh.size} x {self.block_rows} rows)"


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         *, device: str = "cuda") -> None:
    """Bring up ``torch.distributed`` (idempotent; a no-op single-process).

    ``coordinator_address`` is ``host:port`` of process 0's store; the
    backend is gloo for CPU slots and NCCL for CUDA slots. Without
    arguments the launcher's environment decides (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` as ``torchrun`` sets them);
    where none is set it is the single-process no-op. When the caller asked
    for a cluster and bring-up fails, the error propagates: a failed
    bring-up never degrades to a local-only run (collectives would hang or
    compute on a fraction of the slots).
    """
    if dist.is_available() and dist.is_initialized():
        return
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if coordinator_address is None and num_processes in (None, 1):
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return  # single process: nothing to bring up
        dist.init_process_group(backend, init_method="env://")
        return
    if backend == "nccl" and process_id is not None:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{coordinator_address}" if coordinator_address is not None
                     else "env://"),
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=600),
    )


def data_mesh(shards: int | None = None, devices=None, device: str = "cuda") -> Mesh:
    """The row-sharding mesh.

    Single process: ``devices`` names every slot's device (several cards
    of one host, or one card several times); otherwise ``shards`` slots on
    ``device`` (default one slot per visible card for ``"cuda"``, one slot
    for ``"cpu"``): ``data_mesh(4)`` is four slots on the current card.

    Under ``torch.distributed`` every process calls it with the same
    ``shards`` (default 1) and owns that many slots on ``device`` (for
    ``"cuda"``, the card ``rank % device_count``, unless ``devices`` names
    them); slots are numbered process-major.
    """
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        rank, world = dist.get_rank(), dist.get_world_size()
        if devices is None:
            per = 1 if shards is None else int(shards)
            d = torch.device(device)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", rank % torch.cuda.device_count())
            devices = [d] * per
        devices = [torch.device(d) for d in devices]
        counts = torch.tensor([len(devices)], dtype=torch.int64,
                              device="cpu" if devices[0].type == "cpu" else devices[0])
        every = [torch.zeros_like(counts) for _ in range(world)]
        dist.all_gather(every, counts)
        every = [int(c) for c in every]
        owners = [r for r in range(world) for _ in range(every[r])]
        return Mesh(owners, devices, rank)
    if devices is None:
        d = _device(device)
        if shards is None:
            shards = torch.cuda.device_count() if d.type == "cuda" else 1
            devices = ([torch.device("cuda", i) for i in range(shards)] if d.type == "cuda"
                       else [d])
        else:
            devices = [d] * int(shards)
    devices = [_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one slot")
    return Mesh([0] * len(devices), devices, 0)


def local_blocks(mesh: Mesh, x):
    """This process's row blocks of ``x``: a :class:`Sharded` column on
    ``mesh`` or a global tensor, cut by :func:`shard_rows`."""
    if isinstance(x, Sharded):
        if x.mesh.owners != mesh.owners or x.mesh.rank != mesh.rank:
            raise ValueError("a sharded column must lie on the mesh it is used with")
        return x.blocks
    if torch.is_tensor(x):
        return shard_rows(mesh, x).blocks
    raise TypeError(f"expected a tensor or a Sharded column, got {type(x).__name__}")


def shard_rows(mesh: Mesh, *tensors):
    """Cut global rows into equal blocks, one per slot, and place this
    process's blocks on their slots' devices. Every process passes the same
    global tensors. Returns one :class:`Sharded` per tensor (the tensor's
    own when one is given)."""
    out = []
    for t in tensors:
        n = t.shape[0]
        if n % mesh.size:
            raise ValueError(f"{n} rows do not split into {mesh.size} equal blocks; pad upstream")
        per = n // mesh.size
        out.append(Sharded(mesh, [t[s * per:(s + 1) * per].to(dev)
                                  for s, dev in zip(mesh.local, mesh.devices)]))
    return out[0] if len(out) == 1 else tuple(out)


def gather_rows(x: Sharded) -> torch.Tensor:
    """Every slot's block in slot order, on ``mesh.home``: the JAX
    package's global layout ``(P * block_rows,)`` (across processes an
    all-gather)."""
    from radix_sort_tpu_torch.parallel import collectives

    return collectives.all_gather(x.mesh, x.blocks)


def valid_rows(x: Sharded, counts) -> torch.Tensor:
    """The concatenation of each slot's first ``counts[s]`` rows (the
    distributed result as one relation), on ``mesh.home``."""
    from radix_sort_tpu_torch.parallel import collectives

    whole = gather_rows(x)
    per = x.block_rows
    cnt = [int(c) for c in torch.as_tensor(counts).tolist()]
    return collectives.cat([whole[s * per:s * per + c] for s, c in enumerate(cnt)], whole.device)


def run_local_cluster(num_processes: int = 2, devices_per_process: int = 2,
                      device: str = "cuda",
                      module: str = "radix_sort_tpu_torch.parallel.mp_smoke",
                      extra_args: list[str] | None = None, timeout: float = 1800.0,
                      env_overrides: dict | None = None):
    """Launch ``num_processes`` local Python processes that each call
    :func:`initialize_multihost` against one coordinator and run
    ``module``'s CLI (default: the :mod:`.mp_smoke` engine smoke): a
    multi-host-shaped run of the distributed engine on one machine, with a
    real process boundary between the mesh's slot groups.

    Each child owns ``devices_per_process`` slots on ``device``: CPU slots
    talk over gloo, CUDA slots over NCCL with one card per process (so
    ``device="cuda"`` needs at least ``num_processes`` cards; it raises
    otherwise). Returns the list of per-process ``(returncode,
    stdout+stderr)``; raises if any process fails or the cluster hangs past
    ``timeout``.
    """
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < num_processes:
        raise RuntimeError(f"a local NCCL cluster of {num_processes} processes needs as many "
                           f"cards; this host has {torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    if torch.device(device).type == "cpu":
        # several CPU processes share the host's cores
        env.setdefault("OMP_NUM_THREADS", "1")
    env.update(env_overrides or {})
    procs = []
    for pid in range(num_processes):
        cmd = [sys.executable, "-m", module,
               "--coordinator", f"localhost:{port}",
               "--num-processes", str(num_processes),
               "--process-id", str(pid),
               "--devices-per-process", str(devices_per_process),
               "--device", device] + list(extra_args or [])
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    results, failed = [], []
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            results.append((p.returncode, out))
            if p.returncode != 0:
                failed.append(pid)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()  # exactly the processes started here
        for p in procs:
            p.communicate()
        raise RuntimeError(f"local cluster hung past {timeout}s "
                           f"({num_processes} processes x {devices_per_process} slots)")
    if failed:
        detail = "\n".join(f"--- process {pid} (rc={results[pid][0]}) ---\n"
                           + results[pid][1][-4000:] for pid in failed)
        raise RuntimeError(f"local cluster processes failed:\n{detail}")
    return results
