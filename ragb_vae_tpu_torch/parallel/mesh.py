"""Process groups and the axes they form: "data" and "model".

Counterpart of the process side of `ragb_vae_tpu/parallel/mesh.py`. The JAX
package runs one program over a device mesh; the port runs one process per
device under `torchrun` and a `torch.distributed` process group, the setup of
the reference (Accelerate / DeepSpeed). `Mesh` is a group seen as one axis:
its size, this process's rank in it, and the group itself (None: the default
group). Without a group it is an axis of size 1, and every collective below
returns its input untouched at size 1.

`create_training_mesh(tp, sp)` splits the world into a data axis, a model
axis and a sequence axis, as the JAX package's ("data", "model", "sp") mesh
does, sp innermost: global rank r has sequence rank r % sp, model rank
(r // sp) % tp and data rank r // (tp * sp), so the tp * sp ranks of one
data replica are consecutive and sit on one node.

Every group waits at most its timeout for a collective: `DEFAULT_TIMEOUT`,
or `RAGB_DIST_TIMEOUT_S` seconds when that is set, or what the caller of
`maybe_init_distributed` passes; the groups `create_training_mesh` builds
take the world's. `group_timeout` reads a group's back from its backend.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
TIMEOUT_ENV = "RAGB_DIST_TIMEOUT_S"

_joined_timeout: Optional[datetime.timedelta] = None     # the world's, when joined here


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis over a process group: `size` processes, this one `rank` in
    it; `group` None is the default group (the whole world)."""

    size: int = 1
    rank: int = 0
    group: Optional[Any] = dataclasses.field(default=None, compare=False)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def local_device(device) -> torch.device:
    """`cuda` -> `cuda:LOCAL_RANK` under torchrun (`cuda:0` without it); any
    other device, or a CUDA device with an index, as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    return device


def maybe_init_distributed(
    device="cuda",
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Join the process group that torchrun describes (`WORLD_SIZE`, `RANK`,
    `LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT`), or the one the arguments
    name (`init_method` such as `file://...` or `tcp://localhost:PORT`): NCCL
    for a CUDA `device`, which binds `cuda:LOCAL_RANK`, gloo for the CPU.
    `timeout` defaults to `RAGB_DIST_TIMEOUT_S` seconds, else
    `DEFAULT_TIMEOUT`. Returns whether a group exists afterwards; does
    nothing when one already does or when neither the environment nor the
    arguments name one."""
    global _joined_timeout
    if dist.is_initialized():
        return True
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if world_size is None:
        return False
    if world_size > 1 and init_method is None and not os.environ.get("MASTER_ADDR"):
        raise ValueError(f"WORLD_SIZE={world_size}: more than one process needs a rendezvous — run under "
                         "torchrun (it sets MASTER_ADDR / MASTER_PORT) or pass init_method=")
    rank = _env_int("RANK") if rank is None else rank
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if timeout is None:
        seconds = os.environ.get(TIMEOUT_ENV)
        timeout = datetime.timedelta(seconds=float(seconds)) if seconds else DEFAULT_TIMEOUT
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method or "env://", world_size=world_size, rank=rank or 0, timeout=timeout)
    _joined_timeout = timeout
    return True


def group_timeout(mesh: Mesh, device) -> datetime.timedelta:
    """How long a collective of `mesh`'s group on `device` may wait before
    the backend fails it (NCCL's watchdog aborts the process): the backend's
    own setting, else the world's as joined here, else `DEFAULT_TIMEOUT`."""
    if mesh.size > 1:
        group = mesh.group or dist.group.WORLD
        try:
            return group._get_backend(torch.device(device)).options._timeout
        except (AttributeError, RuntimeError):
            pass
    return _joined_timeout or DEFAULT_TIMEOUT


def create_mesh() -> Mesh:
    """The data axis over the default group, or of size 1 when none exists."""
    if dist.is_available() and dist.is_initialized():
        return Mesh(size=dist.get_world_size(), rank=dist.get_rank())
    return Mesh()


def create_training_mesh(tp: int = 1, sp: int = 1) -> Tuple[Mesh, Mesh, Mesh]:
    """(data axis, model axis, sequence axis) of the world: W processes as
    W / (tp * sp) data replicas of tp * sp consecutive ranks, sp innermost
    (JAX `create_training_mesh`'s axis order). Every rank builds every group,
    in one order, as `dist.new_group` requires; an axis of size 1 gets no
    group. At tp = sp = 1 it is (`create_mesh()`, size 1, size 1)."""
    tp, sp = int(tp), int(sp)
    if tp < 1 or sp < 1:
        raise ValueError(f"tensor_parallel={tp} and sequence_parallel={sp} must be >= 1")
    world = create_mesh()
    per = tp * sp
    if per == 1:
        return world, Mesh(), Mesh()
    if not (dist.is_available() and dist.is_initialized()):
        names = " x ".join(f"{n}={w}" for n, w in (("tensor_parallel", tp), ("sequence_parallel", sp)) if w > 1)
        raise ValueError(f"{names} needs a process group of {per} or more processes (run under torchrun)")
    if world.size % per:
        raise ValueError(f"tensor_parallel={tp} x sequence_parallel={sp} must divide {world.size} devices")
    n_data = world.size // per
    r = world.rank
    coords = (r // per, (r // sp) % tp, r % sp)        # (data, model, seq) rank

    def rank_of(d: int, m: int, s: int) -> int:
        return d * per + m * sp + s

    def axis(size: int, members, mine: int) -> Mesh:
        """One group per fixing of the other two coordinates, all built in
        one order on every rank; this rank's is kept."""
        if size == 1:
            return Mesh()
        kept = None
        for fixed, ranks in members:
            g = dist.new_group(ranks, timeout=_joined_timeout)
            if fixed:
                kept = g
        return Mesh(size, mine, kept)

    d0, m0, s0 = coords
    data = axis(n_data, [((m, s) == (m0, s0), [rank_of(d, m, s) for d in range(n_data)])
                         for m in range(tp) for s in range(sp)], d0)
    model = axis(tp, [((d, s) == (d0, s0), [rank_of(d, m, s) for m in range(tp)])
                      for d in range(n_data) for s in range(sp)], m0)
    seq = axis(sp, [((d, m) == (d0, m0), [rank_of(d, m, s) for s in range(sp)])
                    for d in range(n_data) for m in range(tp)], s0)
    return data, model, seq


def create_dp_tp_mesh(tp: int) -> Tuple[Mesh, Mesh]:
    """(data axis, model axis) of `create_training_mesh(tp=tp)`: the
    two-axis serving and training layout (JAX `create_dp_tp_mesh`)."""
    return create_training_mesh(tp=tp)[:2]


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main() -> bool:
    return process_index() == 0


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Wait for every process of the axis (nothing at size 1)."""
    mesh = mesh or create_mesh()
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


def pad_batch_to_mesh(batch_size: int, mesh: Mesh) -> int:
    """Smallest batch >= batch_size divisible by the data-axis size."""
    return -(-batch_size // mesh.size) * mesh.size


# ---------------------------------------------------------------------------
# Collectives over one axis (each returns its input at size 1)
# ---------------------------------------------------------------------------
def all_reduce(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place: the reduction of `t` over the axis."""
    if mesh.size > 1:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def broadcast(t: torch.Tensor, mesh: Mesh, src_rank: int = 0) -> torch.Tensor:
    """In place: the axis's rank `src_rank`'s `t` on every rank."""
    if mesh.size > 1:
        src = src_rank if mesh.group is None else dist.get_global_rank(mesh.group, src_rank)
        dist.broadcast(t, src, group=mesh.group)
    return t


def reduce_scatter(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the axis of `flat` (length a multiple of the size), of
    which this rank keeps its contiguous 1/size."""
    if mesh.size == 1:
        return flat
    out = flat.new_empty(flat.numel() // mesh.size)
    dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_gather(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `shard` end to end, in rank order."""
    if mesh.size == 1:
        return shard
    out = shard.new_empty(shard.numel() * mesh.size)
    dist.all_gather_into_tensor(out, shard.contiguous(), group=mesh.group)
    return out


def global_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of `t` (B, ...) end to end: (size * B, ...)."""
    if mesh.size == 1:
        return t
    return all_gather(t.reshape(-1), mesh).reshape((mesh.size * t.shape[0],) + tuple(t.shape[1:]))


def local_rows(t, mesh: Mesh):
    """This rank's contiguous 1/size of the rows of `t` (the global batch)."""
    per = t.shape[0] // mesh.size
    if per * mesh.size != t.shape[0]:
        raise ValueError(f"global batch {t.shape[0]} not divisible by {mesh.size} processes")
    return t[mesh.rank * per : (mesh.rank + 1) * per]


def randn_rows(shape, generator: Optional[torch.Generator], mesh: Mesh, *, device) -> torch.Tensor:
    """This rank's rows of a standard normal of the GLOBAL shape
    (size * shape[0], *shape[1:]), drawn from `generator`: every rank draws the
    whole batch's noise from the one seeded stream and keeps its own rows, so
    a run over N processes draws what the run over one draws. At size 1 it is
    one `randn(shape)`."""
    shape = tuple(shape)
    full = torch.randn((mesh.size * shape[0],) + shape[1:], generator=generator, device=device,
                       dtype=torch.float32)
    return local_rows(full, mesh)
