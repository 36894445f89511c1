"""The process mesh: ranks of a torch.distributed group on a (pixels, spp)
grid, and the collectives that join their shards.

Counterpart of pathtracer_tpu.parallel.mesh. The JAX mesh is one process
over many devices; here each rank is one process with one device, and rank
r sits at (r // spp, r % spp), where np.asarray(devices).reshape(shape)
puts device r. The random streams are keyed by these coordinates, so a
render depends on the mesh shape and not on how ranks map to hosts.

Sharded work is written as a plain function of the coordinate (pix_rank,
spp_rank) with no collective in it; the mesh applies it (local) and joins
the results (total, sum_all). RenderMesh applies it at this rank's
coordinate and joins over the process groups; LogicalMesh, one process
standing in for every rank, applies it at each coordinate and joins in
rank order. For two ranks on an axis the sums are the same floats either
way (a + b == b + a), so a one-process run reproduces a run of many ranks
bit for bit.

Each collective of a RenderMesh runs inside a span (spans.py):
"pt.collective.all_reduce" and "pt.collective.all_gather" around a join
of tensors with the syncs before and after it, "pt.collective.host"
around a vote, a broadcast of a host value or a barrier; and it adds to
the counters COLLECTIVE_S, COLLECTIVE_CALLS and COLLECTIVE_BYTES of its
kind.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import pickle
import time
from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..spans import span

# seconds this process spent in collectives, by kind: the joins of
# tensors (the device synchronised before each, so the time is the
# collective's and the wait for the slowest rank of its group) and the
# votes and broadcasts of host values (no sync; their wait for the slowest
# rank included)
COLLECTIVE_S = {"all_reduce": 0.0, "all_gather": 0.0, "host": 0.0}
# calls of torch.distributed's collectives this process made, by kind, and
# the bytes it handed them: this rank's tensors (a gather's input, not its
# output), a vote's flags, a broadcast value's pickle; none for a barrier
COLLECTIVE_CALLS = dict.fromkeys(COLLECTIVE_S, 0)
COLLECTIVE_BYTES = dict.fromkeys(COLLECTIVE_S, 0)


def reset_collective_time() -> None:
    """Zero COLLECTIVE_S, COLLECTIVE_CALLS and COLLECTIVE_BYTES."""
    for k in COLLECTIVE_S:
        COLLECTIVE_S[k] = 0.0
        COLLECTIVE_CALLS[k] = 0
        COLLECTIVE_BYTES[k] = 0


def _count(kind: str, nbytes: int) -> None:
    COLLECTIVE_CALLS[kind] += 1
    COLLECTIVE_BYTES[kind] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def mesh_shape_for(n_devices: int, spp_parallel: bool = True
                   ) -> Tuple[int, int]:
    """Factor n devices into (pixels, spp) axes: an spp axis of 2 when the
    count allows it, pixels otherwise."""
    if spp_parallel and n_devices % 2 == 0 and n_devices > 1:
        return (n_devices // 2, 2)
    return (n_devices, 1)


def shard_rows(t: torch.Tensor, index: int, n: int) -> torch.Tensor:
    """Slice `index` of n equal contiguous slices of t along dim 0: a pixel
    shard's rows."""
    k = t.shape[0] // n
    return t[index * k:(index + 1) * k]


def parse_mesh(text: str) -> Tuple[int, int]:
    """"PxS" -> (P, S); raises ValueError on anything else."""
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                  for p in parts):
        raise ValueError(f"mesh {text!r} is not PIXELSxSPP, e.g. 2x1")
    return int(parts[0]), int(parts[1])


@contextlib.contextmanager
def _timed(kind: str, tensors: Sequence[torch.Tensor] = ()):
    """Add the block's seconds to COLLECTIVE_S[kind], all of it in the
    span "pt.collective.<kind>"; the card synchronised before and after it
    where `tensors` lie on one."""
    cards = [t.device for t in tensors[:1] if t.device.type == "cuda"]

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)
    with span("pt.collective." + kind):
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        COLLECTIVE_S[kind] += time.perf_counter() - t0


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """This rank's place on the (pixels, spp) grid. `shape` maps the axis
    names to their sizes; `spp_group` holds the ranks of this pixel shard
    (the spp axis, over which sample partials are summed) and
    `pixels_group` the ranks of this spp slice (the pixels axis, over which
    the frame is gathered). A group is None where its axis has size 1.
    `host_group` is a gloo group over every rank (None where the default
    group is gloo), which carries the host values that the ranks agree on
    (any, share, barrier): no device work, so no wait for the card."""
    shape: dict
    pix_rank: int = 0
    spp_rank: int = 0
    spp_group: object = None
    pixels_group: object = None
    host_group: object = None

    @property
    def size(self) -> int:
        return self.shape["pixels"] * self.shape["spp"]

    @property
    def rank(self) -> int:
        return self.pix_rank * self.shape["spp"] + self.spp_rank

    @property
    def shape_tag(self) -> str:
        return "%dx%d" % (self.shape["pixels"], self.shape["spp"])

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes the files of a run (rank 0)."""
        return self.rank == 0

    def coords(self) -> Iterator[Tuple[int, int]]:
        """Every (pix_rank, spp_rank) of the grid, in rank order."""
        for r in range(self.size):
            yield divmod(r, self.shape["spp"])

    def local(self, shard: Callable[[int, int], torch.Tensor]
              ) -> torch.Tensor:
        """shard(pix_rank, spp_rank) at this rank's coordinate: this rank's
        partial sums, not yet added over the spp axis."""
        return shard(self.pix_rank, self.spp_rank)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The whole frame from local()'s partial sums (or a sum of them):
        added over the spp axis (all_reduce SUM), then the pixel shards of
        the pixels axis concatenated along dim 0 in pixel-rank order
        (all_gather); the same on every rank."""
        t = t.contiguous()
        if self.spp_group is not None:
            with _timed("all_reduce", [t]):
                dist.all_reduce(t, op=dist.ReduceOp.SUM,
                                group=self.spp_group)
            _count("all_reduce", _nbytes(t))
        if self.pixels_group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.shape["pixels"])]
        with _timed("all_gather", [t]):
            dist.all_gather(parts, t, group=self.pixels_group)
        _count("all_gather", _nbytes(t))
        return torch.cat(parts)

    def sum_all(self, shard: Callable[[int, int], Sequence[torch.Tensor]]
                ) -> list:
        """shard(pix_rank, spp_rank) (a sequence of tensors) at this rank's
        coordinate, summed over the pixels axis, then over the spp axis:
        the same sums on every rank."""
        ts = [t.contiguous() for t in shard(self.pix_rank, self.spp_rank)]
        for g in (self.pixels_group, self.spp_group):
            if g is not None:
                with _timed("all_reduce", ts):
                    for t in ts:
                        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
                for t in ts:
                    _count("all_reduce", _nbytes(t))
        return ts

    def any(self, *flags: bool) -> Tuple[bool, ...]:
        """Whether each flag holds on any rank (all_reduce MAX over every
        rank, on the host): decisions every rank takes alike."""
        if self.size == 1:
            return tuple(bool(f) for f in flags)
        t = torch.tensor([int(bool(f)) for f in flags])
        with _timed("host"):
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        _count("host", _nbytes(t))
        return tuple(bool(v) for v in t.tolist())

    def share(self, obj):
        """Rank 0's `obj` (any picklable value) on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        with _timed("host"):
            dist.broadcast_object_list(box, src=0, group=self.host_group)
        _count("host", len(pickle.dumps(box[0])))
        return box[0]

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing for a world of one)."""
        if self.size > 1:
            with _timed("host"):
                dist.barrier(group=self.host_group)
            _count("host", 0)


class LogicalMesh(RenderMesh):
    """One process playing every rank of a mesh: local() stacks the shard
    function's values at every coordinate ([size, ...], in rank order),
    total() and sum_all() add them in rank order, so the result is what a
    run of size ranks computes, with no process group. The test seam of the
    sharded paths and the reference that the card's checks hold a run of
    several ranks against."""

    def __init__(self, shape: Tuple[int, int]):
        super().__init__({"pixels": int(shape[0]), "spp": int(shape[1])})

    def local(self, shard):
        return torch.stack([shard(p, s) for p, s in self.coords()])

    def total(self, t):
        S = self.shape["spp"]
        parts = []
        for p in range(self.shape["pixels"]):
            acc = t[p * S]
            for s in range(1, S):
                acc = acc + t[p * S + s]
            parts.append(acc)
        return torch.cat(parts)

    def sum_all(self, shard):
        tot = None
        for s in range(self.shape["spp"]):
            acc = None
            for p in range(self.shape["pixels"]):
                ts = list(shard(p, s))
                acc = ts if acc is None else [a + t for a, t in zip(acc, ts)]
            tot = acc if tot is None else [a + t for a, t in zip(tot, acc)]
        return tot

    def any(self, *flags):
        return tuple(bool(f) for f in flags)

    def share(self, obj):
        return obj

    def barrier(self):
        pass


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              timeout: Optional[datetime.timedelta] = None) -> RenderMesh:
    """This rank's mesh over the default process group (a world of one
    without one). `shape` defaults to mesh_shape_for(world size); raises
    ValueError unless its product is the world size. With more than one
    rank every rank must call it, in the same order: it creates the axes'
    process groups (torch.distributed.new_group), each with `timeout`
    (None: torch.distributed's default for its backend, 10 minutes for
    NCCL and 30 for gloo, whatever the default group's own)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = tuple(shape) if shape is not None else mesh_shape_for(world)
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1 \
            or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} does not cover the world of "
                         f"{world} rank(s): pixels x spp must equal it")
    P, S = shape
    pix_rank, spp_rank = divmod(rank, S)
    spp_group = pixels_group = host_group = None
    if world > 1:
        # new_group is collective over the world: every rank creates every
        # group, in one order
        for p in range(P):
            g = dist.new_group([p * S + s for s in range(S)],
                               timeout=timeout)
            if p == pix_rank and S > 1:
                spp_group = g
        for s in range(S):
            g = dist.new_group([p * S + s for p in range(P)],
                               timeout=timeout)
            if s == spp_rank and P > 1:
                pixels_group = g
        if dist.get_backend() != "gloo":
            host_group = dist.new_group(backend="gloo", timeout=timeout)
    return RenderMesh({"pixels": P, "spp": S}, pix_rank, spp_rank,
                      spp_group, pixels_group, host_group)
