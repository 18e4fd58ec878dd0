"""A cell at a size the CPU runs in seconds: the same files, fewer splats,
a smaller image, fewer cameras."""
import copy

from benchmark import harness


def small_spec(name: str, splats: int = 2000, width: int = 64, height: int = 48) -> dict:
    spec = copy.deepcopy(harness.load_cell(name))
    cfg, traffic = spec["cfg"], spec["traffic"]
    cfg["scene"]["splats"] = splats
    cfg["camera"].update(width=width, height=height, poses=16, path_poses=8, target_grid=[3, 4])
    if cfg.get("compression"):
        cfg["compression"].update(color_codebook=64, shape_codebook=64)
    traffic.update(trace_steps=2, warmup_views=1, check_views=2)
    return spec
