"""A one-axis device mesh: the port's counterpart of jax.sharding.Mesh,
jax.shard_map and lax.psum / pmax. The mesh has one axis, so it needs no
axis name.

A Mesh is an ordered list of shard devices. One device may appear several
times: N shards on one card are the counterpart of the JAX package's
virtual CPU devices. With a torch.distributed process group, each rank owns
a contiguous run of the shards (`local_shards`), as jax.local_devices()
does across processes.

shard_map becomes a loop over the local shards, each shard's work on its
own device. `psum` sums the local shards' partials in shard order on the
first local device (plain adds, no atomics), then, with a group, all-reduces
the sum over the group, so every rank holds the same bits. Replicated work
(the damped solve, the LM schedule, the CG scalars) runs once per process on
`device`. Every branch of the solvers reads a host scalar derived from
psummed values, so every rank takes the same one.

Work is enqueued on each device's current stream of the calling thread, so
the async backend's worker runs the solvers on its own side stream. Shards
that share a card run one after another on that card's stream. The group is
the caller's: gloo for CPU tensors and for several ranks on one card (gloo
all-reduces CUDA tensors), NCCL only with one card per rank.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device


class Mesh:
    """Shard devices, optionally split over the ranks of a process group.
    `collectives` counts the psum / pmax / gather calls made through this
    mesh."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        n = len(self.devices)
        if group is None:
            self.local_shards = list(range(n))
        else:
            world = dist.get_world_size(group)
            if n % world:
                raise ValueError(f"{n} shards do not split over {world} "
                                 f"ranks")
            per = n // world
            rank = dist.get_rank(group)
            self.local_shards = list(range(rank * per, (rank + 1) * per))
        self.device = self.devices[self.local_shards[0]]
        self.collectives = 0

    @classmethod
    def on_cards(cls, n: int, device="cuda", shared: bool = False,
                 group=None) -> "Mesh":
        """n shards placed by the one rule of the port: on the CPU all n on
        the CPU (the JAX package's virtual CPU devices); on cuda one per
        card, cuda:0 .. n-1, raising when the machine has fewer cards; or,
        with shared=True, dealt round-robin over the machine's cards, so
        that several shards may share one (the scaling harness, and a
        one-card machine running a multi-shard mesh)."""
        device = resolve_device(device)
        if device.type != "cuda":
            return cls([device] * n, group=group)
        have = torch.cuda.device_count()
        if not shared and have < n:
            raise RuntimeError(
                f"a mesh of {n} shards, one per card, needs {n} cards but "
                f"the machine has {have}; run on more cards, or on the CPU "
                f"with --device cpu")
        return cls([torch.device("cuda", s % have) for s in range(n)],
                   group=group)

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    def psum(self, parts):
        """The sum over every shard of the mesh of `parts` (one entry per
        local shard, in local_shards order; each a tensor or a tuple of
        tensors), on `device`. A tuple travels as one flat buffer, so it
        costs one all-reduce."""
        if len(parts) != len(self.local_shards):
            raise ValueError(f"{len(parts)} partials for "
                             f"{len(self.local_shards)} local shards")
        self.collectives += 1
        single = isinstance(parts[0], torch.Tensor)
        flat = []
        for part in parts:
            ts = (part,) if single else tuple(part)
            flat.append(torch.cat([t.reshape(-1).to(self.device)
                                   for t in ts]))
        acc = flat[0]
        for f in flat[1:]:
            acc = acc + f
        if self.group is not None:
            acc = acc.contiguous()
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=self.group)
        ref = (parts[0],) if single else tuple(parts[0])
        out, at = [], 0
        for t in ref:
            out.append(acc[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out[0] if single else tuple(out)

    def pmax(self, parts):
        """The max over every shard of the mesh of the 0-d tensors `parts`
        (one per local shard), on `device`."""
        self.collectives += 1
        acc = torch.stack([p.to(self.device) for p in parts]).amax()[None]
        if self.group is not None:
            dist.all_reduce(acc, op=dist.ReduceOp.MAX, group=self.group)
        return acc[0]

    def gather(self, parts):
        """The local shards' blocks `parts` (equal shapes, shard order)
        concatenated with every other rank's along dim 0, on `device`: the
        global array of all `size` blocks."""
        self.collectives += 1
        local = torch.cat([p.to(self.device) for p in parts])
        if self.group is None:
            return local
        out = [torch.empty_like(local)
               for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(out, local.contiguous(), group=self.group)
        return torch.cat(out)

    def on(self, s: int):
        """A context for shard s's kernel launches: its card current (the
        kernel wrappers launch on the current device's stream)."""
        d = self.devices[s]
        if d.type == "cuda":
            return torch.cuda.device(d)
        return contextlib.nullcontext()

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}"
                f"{', group' if self.group is not None else ''})")
