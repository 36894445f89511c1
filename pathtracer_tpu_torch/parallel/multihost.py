"""Joining a torch.distributed group, and the mesh over all its ranks.

Counterpart of pathtracer_tpu.parallel.multihost. Each rank is one
process on one device: the CPU when asked for, else cuda:(its rank among
the ranks of its host % the host's device count). The ranks learn where
each of them runs through the rendezvous's store, before the group and
before any use of the card. The backend is PT_DIST_BACKEND, else nccl on
the card and gloo on the CPU. NCCL takes one rank a device: where two
ranks of one host would share a card, every rank raises here, and none
falls back to gloo. Gloo carries CUDA tensors too, so
PT_DIST_BACKEND=gloo runs several ranks on one card.
"""
from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import RenderMesh, make_mesh

log = logging.getLogger("pathtracer_tpu_torch")


def dist_backend(device_type: str) -> str:
    """PT_DIST_BACKEND, else nccl for "cuda" and gloo for "cpu"."""
    return os.environ.get("PT_DIST_BACKEND") or (
        "nccl" if device_type == "cuda" else "gloo")


def rank_device(device_type: str, hosts: Sequence[Tuple[str, int]],
                rank: int, backend: str) -> torch.device:
    """The device of `rank`, from every rank's (host name, CUDA device
    count) in rank order: the CPU for "cpu", else cuda:(the rank's index
    among its host's ranks % that host's count). Every rank decides alike:
    RuntimeError where a host has no card, ValueError where NCCL would put
    two ranks of one host on one device."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r} is not cuda or cpu")
    for host, n_dev in hosts:
        if n_dev < 1:
            raise RuntimeError(
                f"no CUDA device on {host}; this renderer runs on the card "
                "(--device cpu runs the plain versions)")
        n_local = sum(h == host for h, _ in hosts)
        if backend == "nccl" and n_local > n_dev:
            raise ValueError(
                f"NCCL takes one rank a device, and {n_local} ranks on "
                f"{host} would share its {n_dev} CUDA device(s); run at most "
                f"{n_dev} ranks there, or set PT_DIST_BACKEND=gloo (which "
                "carries CUDA tensors, several ranks to a device)")
    host, n_dev = hosts[rank]
    local = sum(h == host for h, _ in hosts[:rank])
    return torch.device(f"cuda:{local % n_dev}")


def _placement(store, rank: int, n: int, device_type: str) -> list:
    """Every rank's (host name, CUDA device count), in rank order, through
    the rendezvous's store (each rank sets its own and reads the rest)."""
    n_dev = torch.cuda.device_count() if device_type == "cuda" else 0
    store.set(f"pt/placement/{rank}", f"{n_dev} {socket.gethostname()}")
    hosts = []
    for r in range(n):
        count, host = store.get(f"pt/placement/{r}").decode().split(" ", 1)
        hosts.append((host, int(count)))
    return hosts


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device_type: str = "cuda",
                         timeout_s: float = 600.0) -> torch.device:
    """Join the process group before any other use of the device, and
    return this rank's device (rank_device); the backend is
    dist_backend(device_type).

    coordinator_address "host:port" (the JAX package's argument) is the
    TCP rendezvous, tcp://host:port, of num_processes ranks, this one
    process_id; without it the group comes from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; env://)."""
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        init = f"tcp://{coordinator_address}"
        n, pid = int(num_processes), int(process_id)
    else:
        init = "env://"
        n = int(os.environ["WORLD_SIZE"])
        pid = int(os.environ["RANK"])
    backend = dist_backend(device_type)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, pid, n = next(dist.rendezvous(init, rank=pid, world_size=n,
                                         timeout=timeout))
    device = rank_device(device_type, _placement(store, pid, n, device_type),
                         pid, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, world_size=n, rank=pid,
                            timeout=timeout)
    log.info("distributed: rank %d/%d on %s over %s", pid, n, device,
             backend)
    return device


def global_render_mesh(shape: Optional[Tuple[int, int]] = None
                       ) -> RenderMesh:
    """The mesh over every rank of the group (initialize_multihost first):
    axes (pixels, spp)."""
    return make_mesh(shape)
