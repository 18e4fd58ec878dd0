"""Constants shared by the compositing kernels (c3dgs_tpu/render/tiles.py
:71-81). The per-tile kernel family of that module (K3 forward, K4
backward) comes with a later slice."""
from __future__ import annotations

import math

from .types import TILE_X, TILE_Y

PIX = TILE_X * TILE_Y  # 512 pixels per tile at the default 32x16
STOP_T = 1e-4  # a contribution lands while T * (1 - alpha) >= STOP_T
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.99
OUT_ROWS = 8  # per-tile output block rows
# per-tile freeze once every pixel's transmittance is below EXIT_T;
# stricter than STOP_T so the skipped work is provably invisible
EXIT_T = 1e-6
LOG_EXIT_T = math.log(EXIT_T)  # the forward's carry lives in log domain
LOG_STOP_T = math.log(STOP_T)  # the backward's live check in log domain
