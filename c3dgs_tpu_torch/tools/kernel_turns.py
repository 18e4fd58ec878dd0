"""K1-K4 of one checkout at chip_smoke.py's bench frame: output hashes and
times, for comparing two checkouts on one card.

    python3 c3dgs_tpu_torch/tools/kernel_turns.py <checkout root> [reps]

Imports c3dgs_tpu_torch and chip_smoke.py from the given checkout (its
kernels build under <root>/build/), stages the 300k-splat 1920x1080 bench
frame with probe-exact buckets in both kernel families as chip_smoke.py's
phases 3, 7, 10 and 11 do, runs K1-K4 once each and hashes their outputs
(sha256 of K1's and K3's blocks, of K2's and K4's gradient rows, for L1
cotangents), then times each kernel (CUDA events, median of `reps`, 20 by
default). The last line of its output is one JSON object. Run it on each
checkout in turns (A B B A) in one call, on one card: equal hashes say the
outputs are bitwise equal.
"""
import dataclasses
import hashlib
import json
import statistics
import sys
from pathlib import Path


def sha256(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def main(root: str, reps: int = 20) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs
    from c3dgs_tpu_torch.render import tiles, tiles_packed
    from c3dgs_tpu_torch.render.binning import bin_gaussians
    from c3dgs_tpu_torch.render.capacity import CapacityPolicy
    from c3dgs_tpu_torch.render.preprocess import preprocess
    from c3dgs_tpu_torch.train import trainer

    assert Path(cs.__file__).resolve().parent == Path(root).resolve(), cs.__file__
    scene, _ = cs.bench_scene("cuda", cs.BENCH_N)
    ev = torch.tensor(cs.EV_ID, dtype=torch.float32, device="cuda")
    bg = torch.zeros(3, device="cuda")

    def staged(settings):
        deg = trainer.settings_with_degree(settings, scene.active_sh_degree)
        prep = preprocess(scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0], ev, deg,
                          scene.get_features())
        return deg, prep, bin_gaussians(prep, deg)

    out = {"root": str(root)}
    settings = cs.bench_settings(scene)
    with torch.no_grad():
        deg, prep, b = staged(settings)
        args, complete = cs.k1_args(prep, b, deg, scene.capacity)
        blocks = tiles_packed.forward(*args)
    g = cs.l1_cotangent(blocks, deg, complete)
    rows = tiles_packed.backward(*args, blocks, g)
    fields, _, meta, starts, ends = args
    k1_out, k2_out = torch.empty_like(blocks), torch.zeros_like(rows)
    timed = {
        "K1": (blocks, lambda: tiles_packed.launch(fields, meta, starts, ends, k1_out)),
        "K2": (rows, lambda: tiles_packed.launch_backward(fields, meta, starts, ends, blocks, g, k2_out)),
    }
    # the per-tile frame: phase 10's probe-exact buckets
    base = dataclasses.replace(settings, packed=False, grad_capacity=0)
    with torch.no_grad():
        probe = trainer.render_scene(scene, ev, base, bg, device="cuda")
        policy = CapacityPolicy(initial=int(probe["num_instances"]) + base.num_tiles,
                                grad_initial=int(probe["grad_total"]))
        deg_pt, prep, b = staged(policy.apply(base))
        args_pt, grad_base = cs.per_tile_args(prep, b, deg_pt)
        tx, grad_cap = deg_pt.tiles_x, deg_pt.resolve_grad_cap(scene.capacity)
        blocks_pt = tiles.forward(*args_pt, tx)
    g_pt = cs.l1_cotangent(blocks_pt, deg_pt, None)
    rows_pt = tiles.backward(*args_pt, grad_base, blocks_pt, g_pt, tx, grad_cap)
    k3_out, k4_out = torch.empty_like(blocks_pt), torch.zeros_like(rows_pt)
    timed["K3"] = (blocks_pt, lambda: tiles.launch(*args_pt, tx, k3_out))
    timed["K4"] = (rows_pt, lambda: tiles.launch_backward(*args_pt, grad_base, blocks_pt, g_pt, tx, k4_out))
    torch.cuda.synchronize()
    for name, (result, launch) in timed.items():
        ms = cs.cuda_ms(launch, reps=reps)
        out[name] = {"sha256": sha256(result), "ms": statistics.median(ms), "min_ms": min(ms)}
    out["card"] = cs.smi("name,power.limit")
    return out


if __name__ == "__main__":
    print(json.dumps(main(*sys.argv[1:2], *(int(a) for a in sys.argv[2:3]))), flush=True)
