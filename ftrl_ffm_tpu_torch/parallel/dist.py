"""Process groups and the collectives of a mesh: the port's counterpart of
jax.distributed.initialize (ftrl_ffm_tpu/cli.py:184-195) and of
multihost_utils.process_allgather (ftrl_ffm_tpu/train.py:989-1002,
1457-1461, 1657-1661, 2428-2477).

One process drives one device.  On the card the backend is NCCL, on the
CPU gloo, chosen by the device the run asks for; card tensors never ride
gloo, and a mesh on the card without NCCL raises.  Every collective of the
sharded step goes through the counted wrappers here (`counts`, and the
counters of tracing.py's registry), so a run can show which collectives it
issued and how many bytes it handed them.
"""

from __future__ import annotations

import contextlib
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ftrl_ffm_tpu_torch import tracing

# Collectives issued since the counts were last set to 0, by kind.
counts = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}
# When set to a list, each collective appends (kind, bytes it sends).
trace: Optional[list] = None
# The kind of sharded step ("train", "eval") issuing collectives, or None.
_role: Optional[str] = None


def _count(kind: str, t: torch.Tensor) -> None:
    """Count a collective: `counts` and `trace`; in the registry
    collectives.<kind> (calls) and collectives.bytes.<kind> (the bytes of
    `t`, what this rank hands to it), and inside a step_role the bytes
    under mesh.<role>.bytes too."""
    nbytes = t.numel() * t.element_size()
    counts[kind] += 1
    if trace is not None:
        trace.append((kind, nbytes))
    tracing.count("collectives." + kind)
    tracing.count("collectives.bytes." + kind, nbytes)
    if _role is not None:
        tracing.count(f"mesh.{_role}.bytes", nbytes)


@contextlib.contextmanager
def step_role(role: str):
    """One sharded step of `role`: counted under mesh.<role>.steps, and
    the bytes of the collectives issued inside under mesh.<role>.bytes."""
    global _role
    tracing.count(f"mesh.{role}.steps")
    outer, _role = _role, role
    try:
        yield
    finally:
        _role = outer


def backend_for(device_type: str) -> str:
    """The backend for a device type: NCCL on the card, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def _pin_card(rank: int, device_type: str) -> None:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh on the card needs a CUDA device (pass --device cpu to "
                "run the ranks over gloo on the CPU)"
            )
        torch.cuda.set_device(rank % torch.cuda.device_count())


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device: str = "cuda") -> None:
    """Join the run's process group: rank `process_id` of `num_processes`,
    rendezvous at tcp://`coordinator_address` (host:port), the backend by
    `device` (backend_for).  On the card the rank's device is pinned first:
    card rank % device_count."""
    device_type = torch.device(device).type
    backend = backend_for(device_type)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a mesh on the card needs NCCL, which this PyTorch lacks")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    _pin_card(process_id, device_type)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def ensure_group(device: str) -> None:
    """The run's process group: the one the caller joined (initialize), or
    a group of one on a free local port, so that a single process asking
    for a mesh still runs its collectives through a group.  Raises when the
    group's backend cannot carry the device's tensors."""
    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        initialize(f"localhost:{port}", 1, 0, device)
    want = backend_for(torch.device(device).type)
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(
            f"the process group runs {have}, but {device} tensors need {want}: "
            f"gloo never carries card tensors"
        )


def world() -> tuple[int, int]:
    """(rank, world size) of the run's group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device: str) -> torch.device:
    """This rank's torch device for Config.device: "cuda" is card
    rank % device_count (the card initialize pinned), an explicit "cuda:N"
    stays N, and "cpu" is the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        _pin_card(world()[0], "cuda")
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _check(t: torch.Tensor, group) -> None:
    if t.is_cuda and dist.get_backend(group) != "nccl":
        raise RuntimeError("a card tensor in a collective of a non-NCCL group")


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over `group`, in place (every rank receives the same bits)."""
    _check(t, group)
    _count("all_reduce", t)
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """[size * t.shape[0], ...]: every rank's `t`, concatenated in rank
    order along dim 0."""
    _check(t, group)
    size = dist.get_world_size(group)
    out = t.new_empty((size * t.shape[0], *t.shape[1:]))
    _count("all_gather", t)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """Equal-split all-to-all over dim 0: block p of `t` goes to rank p of
    `group`, and block p of the result came from rank p (lax.all_to_all
    with tiled=True)."""
    _check(t, group)
    out = torch.empty_like(t)
    _count("all_to_all", t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def process_allgather(a, device: Optional[torch.device] = None) -> np.ndarray:
    """[world, *a.shape] host array: every rank's small array or tensor, in
    rank order (multihost_utils.process_allgather), through a tensor on
    `device` (the card under NCCL)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(a))
    t = t.reshape(1, *t.shape)
    if device is not None:
        t = t.to(device)
    return all_gather(t).cpu().numpy()


def destroy() -> None:
    """Leave the process group, if one was joined, once every rank is
    there (a barrier: no rank tears its connections down under a peer
    that still uses them)."""
    if dist.is_initialized():
        if dist.get_world_size() > 1:
            dist.barrier()
        dist.destroy_process_group()
