from .mesh import make_mesh  # noqa: F401
from .sharded import make_hybrid_train_step, render_tile_sharded  # noqa: F401
