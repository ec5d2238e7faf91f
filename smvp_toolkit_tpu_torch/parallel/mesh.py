"""Process groups and meshes: one process per device on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX runs one
process per host and a ``Mesh`` over every chip it addresses; here each
process drives one device and a mesh is a process group, rank = shard:
NCCL between cards, gloo between CPU processes (``device="cpu"``).
``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` /
``MASTER_PORT``; without them, and without arguments, there is nothing to
join and the process stays single.

A ``Mesh`` with ``group=None`` and ``size > 1`` names one rank of a mesh
whose group is not in this process: the sharded functions' local parts
(``_local_*`` in the modules beside this one) take such a rank's shard,
so a test or the smoke script can launch every rank of a 4-shard plan in
turn on one card. The public sharded functions need the group whenever
``size > 1``.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from typing import Optional

import torch
import torch.distributed as dist

from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = ["Mesh", "make_mesh", "distributed_init", "device_count"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: ``size`` ranks, this process's ``rank``
    (-1 when this process is outside the mesh), its ``device`` and the
    process ``group`` of the mesh (None: no collective in this process)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> bool:
    """Join the process group; True when this process is in one.

    The world size and rank come from the arguments or from ``torchrun``'s
    ``WORLD_SIZE`` and ``RANK``; the rendezvous from
    ``coordinator_address`` (``host:port``, or a URL such as
    ``file:///path``) or ``MASTER_ADDR``/``MASTER_PORT``. With no world
    size given there is nothing to join: the process stays single and the
    call returns False, as the JAX function does outside a pod. On
    ``cuda`` (the default) the rank's card (``LOCAL_RANK``, else rank mod
    the card count) becomes the current device and the group is NCCL; on
    ``cpu`` it is gloo. A failure raises: NCCL never falls back to gloo. A
    second call in the process returns True and keeps the group.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    world = num_processes if num_processes is not None else env.get(
        "WORLD_SIZE")
    if world is None:
        return False
    world = int(world)
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None:
        if not ("MASTER_ADDR" in env and "MASTER_PORT" in env):
            raise ValueError(
                "no rendezvous: pass coordinator_address or set "
                "MASTER_ADDR and MASTER_PORT (torchrun sets both)"
            )
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kw["device_id"] = dev
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=world, rank=rank, **kw)
    return True


def _group_device() -> torch.device:
    """The device of this process's rank: its current card in an NCCL
    group, the CPU in a gloo one."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_count() -> int:
    """Devices of the process group (one per rank), 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, *, device=None) -> Mesh:
    """A 1-D mesh over the group's first ``n_devices`` ranks (default all).

    Without a group the mesh is this process alone, on ``device`` (cuda
    unless the CPU is asked for); in a group, on the rank's device (its
    card under NCCL, the CPU under gloo). More ranks than the group has
    raise, in
    the JAX function's words. A mesh over fewer ranks than the group makes
    a subgroup, which every rank of the group must create in turn; ranks
    outside it get ``rank == -1``.
    """
    if not dist.is_initialized():
        n = 1 if n_devices is None else int(n_devices)
        if n > 1:
            raise ValueError(f"requested {n} devices, only 1 present")
        return Mesh(1, 0, resolve_device(device), None)
    world, me = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} present")
    group = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    return Mesh(n, me if me < n else -1, _group_device(), group)


def _in_group(size: int, group, what: str) -> bool:
    """Whether a collective over ``group`` runs: yes with a group, no for
    one rank without one; a mesh of several ranks without its group
    raises."""
    if group is not None:
        return True
    if size > 1:
        raise ValueError(
            f"{what} over {size} ranks needs the mesh's process group "
            "(distributed_init, then make_mesh); without one, launch each "
            "rank's local part"
        )
    return False


def _member(mesh: Mesh) -> None:
    if mesh.rank < 0:
        raise ValueError(f"this process is outside the {mesh.size}-rank mesh")


def gather_rows(local: torch.Tensor, size: int, group) -> torch.Tensor:
    """The ranks' blocks stacked along dimension 0 in rank order (an
    all-gather); ``local`` alone on one rank without a group."""
    if not _in_group(size, group, "all_gather"):
        return local
    local = local.contiguous()
    out = local.new_empty((size * local.shape[0], *local.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, local, group=group)
    return out


def reduce_sum(t: torch.Tensor, size: int, group) -> torch.Tensor:
    """The sum of every rank's ``t`` on every rank (an all-reduce, in
    place); ``t`` itself on one rank without a group."""
    if _in_group(size, group, "all_reduce"):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t
