"""Rasterization settings (port of c3dgs_tpu/render/types.py).

Static render geometry as a frozen dataclass of python numbers; camera
tensors travel separately, so one settings object serves every frame of a
resolution.
"""
from __future__ import annotations

import dataclasses
import os as _os
from typing import Tuple

# Tile shape: 32x16 by default (PIX = 512 pixels per tile); the system this
# repo ports uses 16x16 (its config.h:16-17). C3DGS_TILE_X/Y override it,
# read once at import, so set them before the first import of this
# package. The plain versions take any shape; the CUDA kernels are built
# for the shape of these constants (kernels.py passes them to nvcc) and
# cover the shapes kernel_shape_problem accepts.
TILE_X = int(_os.environ.get("C3DGS_TILE_X", 32))  # pixels per tile, x
TILE_Y = int(_os.environ.get("C3DGS_TILE_Y", 16))  # pixels per tile, y
MAX_KERNEL_PIX = 2048  # 2 pixels per thread, at most 1024 threads per CTA
# binning slot-domain ceiling: presort slots ride f32 staged-field rows and
# must be exactly representable (2^24)
MAX_BINNING_CAP = (1 << 24) - (1 << 20)


def kernel_shape_problem(tx: int, ty: int) -> str:
    """Why the CUDA kernels cannot take tx x ty tiles ('' when they can).

    Their layout (csrc/tiles_common.cuh) covers a tile with 8x4-pixel
    blocks, one 32-lane warp slice each, 2 pixels (two blocks) per thread:
    tx % 8 == 0, ty % 4 == 0, an even number of blocks (PIX % 64 == 0) and
    at most 1024 threads (PIX <= 2048)."""
    if tx <= 0 or ty <= 0 or tx % 8 or ty % 4:
        return f"{tx}x{ty}: the width must be a multiple of 8 and the height a multiple of 4"
    if (tx * ty) % 64:
        return f"{tx}x{ty}: {tx * ty} pixels are an odd number of 8x4 blocks (a warp takes two)"
    if tx * ty > MAX_KERNEL_PIX:
        return f"{tx}x{ty}: {tx * ty} pixels need more than 1024 threads per tile (2 pixels each)"
    return ""


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Static render configuration (hashable)."""

    width: int
    height: int
    tanfovx: float
    tanfovy: float
    sh_degree: int = 3
    scale_modifier: float = 1.0
    clamp_color: bool = True
    # capacity of the (gaussian, tile) instance list; overflow is counted
    # and reported. 0 => auto: 8 * num_gaussians
    instance_capacity: int = 0
    # cap on tiles a single gaussian may occupy; 0 => the full tile grid
    # (binning additionally caps it to fit the packed (gid, j) payload)
    max_tiles_per_gaussian: int = 0
    # per-instance gradient buffer capacity; in packed mode it doubles as
    # the EXECUTION capacity of the forward kernel. 0 => the slot domain
    grad_capacity: int = 0
    # the reduction after the backward kernel takes float32 prefix
    # differences; off, it sums exactly (float64 segment sums after a
    # training binning, compensated prefixes otherwise). The kernels
    # compute in fp32 in both modes
    fast_grad: bool = True
    # packed-chunk kernels (render/tiles_packed.py, K1/K2); False selects
    # the per-tile kernel family (render/tiles.py, K3/K4), whose grad
    # buffer is grad_capacity rows (cap + 2*128*num_tiles when 0)
    packed: bool = True
    # serving: binning reads tile ranges from a sentinel position sort and
    # skips the gaussian-major permutation; ends/starts values are identical
    # either way, and a backward still runs (it reduces by pre-sort slot keys)
    inference: bool = False

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tanfovy)

    @property
    def tiles_x(self) -> int:
        return (self.width + TILE_X - 1) // TILE_X

    @property
    def tiles_y(self) -> int:
        return (self.height + TILE_Y - 1) // TILE_Y

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def resolve_caps(self, num_gaussians: int) -> Tuple[int, int]:
        inst = self.instance_capacity
        if not inst:
            inst = min(max(1024, 8 * num_gaussians), MAX_BINNING_CAP)
        # 128-chunk grain: the staged fields are read in aligned chunks
        inst = (inst + 127) // 128 * 128
        if inst + self.num_tiles >= (1 << 24):
            raise ValueError(
                "instance_capacity + num_tiles must stay below 2^24 (presort "
                f"slots ride exact f32); got {inst}"
            )
        mtpg = self.max_tiles_per_gaussian or self.num_tiles
        return inst, mtpg

    def resolve_grad_cap(self, num_gaussians: int) -> int:
        if self.packed:
            cap, _ = self.resolve_caps(num_gaussians)
            if self.grad_capacity:
                return min((self.grad_capacity + 127) // 128 * 128, cap)
            return cap
        if self.grad_capacity:
            return (self.grad_capacity + 127) // 128 * 128
        cap, _ = self.resolve_caps(num_gaussians)
        return cap + 2 * 128 * self.num_tiles


def settings_from_intrinsic(intrinsic, **kw) -> RasterSettings:
    """Build RasterSettings from the fork's 3x3 FoV-radian intrinsic."""
    from ..ops.camera_math import intrinsic_geometry

    w, h, tx, ty, _, _ = intrinsic_geometry(intrinsic)
    return RasterSettings(width=w, height=h, tanfovx=tx, tanfovy=ty, **kw)
