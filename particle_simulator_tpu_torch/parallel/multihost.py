"""Several processes over one global mesh: one process per card, or per host.

Counterpart of ``particle_simulator_tpu/parallel/multihost.py``. The JAX
package stitches every host's chips into one global device set with
``jax.distributed`` and moves the halo with collectives; here every process
holds its own shards of the global mesh (``parallel/domain.py``:
``DeviceMesh`` with an owner rank per shard) and the ring cells that cross
between processes travel by point-to-point sends over ``torch.distributed``:

- ``init_distributed`` reads the JAX package's ``PS_TPU_COORDINATOR`` /
  ``PS_TPU_NUM_PROCESSES`` / ``PS_TPU_PROCESS_ID`` variables (the
  coordinator is ``host:port``, or an init-method URL such as
  ``file:///path/store``); ``PS_TPU_DISTRIBUTED=1`` reads ``torchrun``'s
  variables instead (``init_method="env://"``). With neither it does
  nothing;
- the backend follows from where the ranks' cards are (``pick_backend``;
  every rank names its card's UUID through the rendezvous store): CPU
  tensors, or ranks that share a card, use gloo, and a message of CUDA
  blocks is staged through pinned host memory; ranks on cards of their own,
  on one host or several, use NCCL. Nothing falls back: NCCL that is needed
  and missing raises;
- the process's card is ``cuda:(LOCAL_RANK or rank) % device_count``, so
  ranks share a card only when the host has fewer cards than processes;
- process 0 owns the editor connection and the frame readback
  (``is_frame_owner``); the daemon's ``DistributedFrontend``
  (``engine/daemon.py``) broadcasts the editor's input, so every process
  makes the same calls in the same order.

The production entry point is ``scripts/torch_launch_multihost.sh``, one
invocation per process (the JAX ``scripts/launch_multihost.sh``'s
counterpart).
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from particle_simulator_tpu_torch.engine.state import ParticleState
from particle_simulator_tpu_torch.parallel.domain import (
    DeviceMesh,
    factor_mesh,
    gather_state,
    host_staged,
    make_mesh,
    shard_state,
    to_host,
)
from particle_simulator_tpu_torch.utils.log import foreign_modules  # noqa: F401

# A lost peer fails the collective that waits on it after this long rather
# than hanging the process.
TIMEOUT_S = 120.0


def card_identity(index: int) -> str:
    """The name of this host's card ``index`` that every process sees alike:
    its UUID (card numbers restart on every host and under
    ``CUDA_VISIBLE_DEVICES``, and hosts may share a name)."""
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else f"{socket.gethostname()}:{index}"


def exchange_cards(store, rank: int, world: int, card: str) -> list[str]:
    """Every rank's card (``card_identity``; "" for CPU tensors), through the
    rendezvous store, before the process group forms."""
    store.set(f"ps_tpu_card/{rank}", card)
    return [store.get(f"ps_tpu_card/{r}").decode() for r in range(world)]


def pick_backend(device_type: str, cards, nccl_available: bool) -> tuple[str, bool]:
    """(backend, host-staged) for processes whose tensors live on
    ``device_type``, ``cards`` naming every rank's card: CPU tensors use
    gloo; ranks that share a card (a name twice, whichever hosts they run
    on) use gloo with the ring staged through host memory; ranks on cards of
    their own use NCCL, which raises when it is missing."""
    if device_type == "cpu":
        return "gloo", False
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if len(set(cards)) < len(cards):
        return "gloo", True
    if not nccl_available:
        raise RuntimeError(f"{len(cards)} processes on cards of their own need NCCL, "
                           "and this torch build has none")
    return "nccl", False


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_frame_owner() -> bool:
    """Process 0 talks to the editor and reads frames back; the others only
    compute."""
    return process_index() == 0


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index()))


def process_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:(LOCAL_RANK or rank) % device_count``,
    or ``cpu:<rank>`` (a label; every CPU tensor lives on the one CPU)."""
    if device_type == "cpu":
        return torch.device("cpu", _local_rank())
    return torch.device("cuda", _local_rank() % max(1, torch.cuda.device_count()))


def init_distributed(device_type: str = "cuda") -> bool:
    """Join the process group the environment describes; False (and nothing
    done) when it describes none. ``device_type`` is where this process's
    blocks live. On CUDA the process's card is set first; every rank then
    names its card through the rendezvous store, and the backend follows
    from where the cards are (``pick_backend``), on one host or several. A
    barrier closes the init, so NCCL's first exchange finds every rank."""
    coord = os.environ.get("PS_TPU_COORDINATOR")
    if coord:
        init_method = coord if "://" in coord else f"tcp://{coord}"
        world = int(os.environ["PS_TPU_NUM_PROCESSES"])
        rank = int(os.environ["PS_TPU_PROCESS_ID"])
    elif os.environ.get("PS_TPU_DISTRIBUTED") == "1":
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    card = ""
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError("CUDA was asked for, but torch.cuda.device_count() is 0")
        index = int(os.environ.get("LOCAL_RANK", rank)) % count
        torch.cuda.set_device(index)
        card = card_identity(index)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store, rank, world = next(dist.rendezvous(init_method, rank, world, timeout=timeout))
    backend, _ = pick_backend(device_type, exchange_cards(store, rank, world, card),
                              dist.is_nccl_available())
    dist.init_process_group(backend, store=store, world_size=world, rank=rank, timeout=timeout)
    barrier(process_device(device_type))
    return True


def describe(device_type: str = "cuda") -> str:
    """``process <rank>/<world>, <backend>[ (host-staged ring)], <device>``:
    what the engine's startup line says of this process."""
    dev = process_device(device_type)
    staged = " (host-staged ring)" if host_staged(dev) else ""
    return f"process {process_index()}/{process_count()}, {dist.get_backend()}{staged}, {dev}"


def barrier(device: torch.device) -> None:
    """Every process waits here for the others (NCCL on ``device``'s card)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def all_sum(value: int, device: torch.device) -> int:
    """The sum of ``value`` over every process (a collective: every process
    calls it at the same point)."""
    on = device if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([value], dtype=torch.int64, device=on)
    dist.all_reduce(t)
    return int(t.item())


def global_mesh(n_shards: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """The (ny, nx) mesh (``factor_mesh``) of every shard of every process.
    Over several processes each holds ``n_shards / world`` consecutive shards
    (row-major) on its own device, one shard each by default, and the mesh
    names every shard's owner rank and device (gathered from the owners: a
    collective). In one process it is ``make_mesh`` over the visible cards
    (one shard a card by default) or, on the CPU, ``n_shards`` shards of one
    block."""
    world, rank = process_count(), process_index()
    if world == 1:
        if device_type == "cuda":
            return make_mesh(n_devices=n_shards)
        return make_mesh(devices=[torch.device("cpu", 0)] * (n_shards or 1))
    n = world if n_shards is None else n_shards
    if n < world or n % world:
        raise ValueError(f"{n} shards do not span {world} processes: the count must be a "
                         f"multiple of the world size, so that every process owns shards")
    per = n // world
    names: list = [None] * world
    dist.all_gather_object(names, str(process_device(device_type)))
    owners = [s // per for s in range(n)]
    devices = [torch.device(names[o]) for o in owners]
    ny, nx = factor_mesh(n)
    return DeviceMesh([devices[i * nx:(i + 1) * nx] for i in range(ny)],
                      [owners[i * nx:(i + 1) * nx] for i in range(ny)], rank)


# the JAX module's name: every process passes the same full grid (every
# process lays out the same broadcast frame bytes) and keeps its own shards
shard_state_global = shard_state


def gather_global(blocks, mesh: DeviceMesh) -> ParticleState | None:
    """The whole (BY, BX, CAP) grid, bit for bit, on rank 0's device; the
    other processes send their blocks and get None (a collective). The JAX
    package gathers onto every process (``process_allgather``), whose other
    processes only discard it; here only the frame owner receives."""
    if not mesh.multi_process:
        return gather_state(blocks, mesh)
    dev = blocks[0].x.device
    staged = host_staged(dev)
    dtypes = [a.dtype for a in blocks[0]]
    if mesh.rank != 0:
        msg = torch.stack([torch.cat([b[f] for b in blocks]).view(torch.int32)
                           for f in range(len(dtypes))])
        dist.send(to_host([msg])[0] if staged else msg, 0)
        return None
    ly, lx, cap = blocks[0].x.shape[-3:]
    inbox = {}
    for peer in sorted({o for o, _, _ in mesh.all_blocks} - {0}):
        n = sum(len(ids) for o, _, ids in mesh.all_blocks if o == peer)
        msg = torch.empty((len(dtypes), n, ly, lx, cap), dtype=torch.int32,
                          device="cpu" if staged else dev, pin_memory=staged)
        dist.recv(msg, peer)
        inbox[peer] = [msg.to(dev, non_blocking=True), 0]
    mine = iter(blocks)
    every = []
    for owner, _, ids in mesh.all_blocks:
        if owner == 0:
            every.append(next(mine))
            continue
        msg, at = inbox[owner]
        every.append(ParticleState(*(msg[f, at:at + len(ids)].view(dt)
                                     for f, dt in enumerate(dtypes))))
        inbox[owner][1] = at + len(ids)
    return gather_state(every, mesh)


