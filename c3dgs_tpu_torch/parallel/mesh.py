"""Device mesh over an initialised torch.distributed world (port of
c3dgs_tpu/parallel/mesh.py). Axis conventions, as in the JAX package:

- "dp"    data parallel over cameras: each dp row trains its own view, and
          parameter gradients are summed over the whole mesh;
- "tiles" the render tile grid is sharded over this axis (each rank
          composites a slice of the image), Gaussians replicated.

Rank = dp_index * tiles + tile_index, so a `tiles` group is consecutive
ranks: as node-local as torchrun's rank order makes it, the counterpart of
the JAX mesh keeping `tiles` on ICI and `dp` across hosts.

The package starts no processes: callers start the ranks (torchrun or
torch.multiprocessing) and call torch.distributed.init_process_group with
the backend of their choice, named explicitly: NCCL with one rank per card,
or gloo (several ranks may then share one card; parallel/collectives.py
stages CUDA tensors through the host for it). Nothing here switches
backends on an error.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from . import collectives


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank: its size, this rank's index on
    it, the process group of the ranks that share this rank's other
    coordinate, and whether collectives stage CUDA tensors through the
    host (the gloo backend)."""

    name: str
    size: int
    index: int
    group: object
    stage: bool

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.all_gather(x, self)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.psum(x, self)

    def sum_grads(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.sum_grads(x, self)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.all_to_all(x, self)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tiles) layout of the ranks of one process group."""

    dp: Axis
    tiles: Axis
    world: Axis  # every rank of the mesh (the JAX psum over ("dp", "tiles"))
    backend: str

    @property
    def shape(self) -> dict:
        return {"dp": self.dp.size, "tiles": self.tiles.size}


def make_mesh(dp: Optional[int] = None, tiles: Optional[int] = None, group=None) -> Optional[Mesh]:
    """Lay the ranks of `group` (default: the world) out as a dp x tiles
    mesh. Every rank of the world calls it, in the same order as its other
    torch.distributed.new_group calls (new_group is collective); a rank
    outside `group` gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    group = dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if dp is None and tiles is None:
        dp, tiles = 1, n
    elif dp is None:
        dp = n // tiles
    elif tiles is None:
        tiles = n // dp
    if dp * tiles != n:
        raise ValueError(f"{dp}x{tiles} != {n} ranks")
    backend = dist.get_backend(group)
    stage = backend == "gloo"
    tile_groups = [dist.new_group([ranks[i * tiles + j] for j in range(tiles)]) for i in range(dp)]
    dp_groups = [dist.new_group([ranks[i * tiles + j] for i in range(dp)]) for j in range(tiles)]
    me = dist.get_rank(group)
    if me < 0:
        return None
    dp_index, tile_index = divmod(me, tiles)
    return Mesh(
        dp=Axis("dp", dp, dp_index, dp_groups[tile_index], stage),
        tiles=Axis("tiles", tiles, tile_index, tile_groups[dp_index], stage),
        world=Axis("world", n, me, group, stage),
        backend=backend,
    )
