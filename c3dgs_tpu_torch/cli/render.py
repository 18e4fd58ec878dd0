"""Render CLI (port of the JAX package's render.py): dump renders/ + gt/
PNG pairs of the train and test splits.

    python -m c3dgs_tpu_torch.cli.render -m <model dir> [-s <dataset>]

Parity: render.py render_sets (:29-64). Writes
<model>/<split>/ours_<iteration>/{renders,gt}/<image name>.png; flags not
given are taken from the model dir's cfg_args.json.
"""
import argparse
import os

import numpy as np

from ..config import ModelParams, load_combined_args
from ..data import Scene
from ..device import resolve_device
from ..eval import metrics


def render_sets(model_p, iteration, skip_train, skip_test):
    """Returns {split: render_and_eval's results} of the splits rendered."""
    dev = resolve_device(model_p.data_device)
    scene = Scene(
        source_path=model_p.source_path,
        model_path=model_p.model_path,
        load_iteration=iteration,
        resolution=model_p.resolution,
        eval_split=model_p.eval,
        white_background=model_p.white_background,
        max_sh_degree=model_p.sh_degree,
        shuffle=False,
        device=dev,
    )
    bg = np.asarray([1.0] * 3 if model_p.white_background else [0.0] * 3)
    out = {}
    for split, cams, skip in (
        ("train", scene.get_train_cameras(), skip_train),
        ("test", scene.get_test_cameras(), skip_test),
    ):
        if skip or not cams:
            continue
        dump = os.path.join(model_p.model_path, split, f"ours_{scene.loaded_iter}")
        out[split] = metrics.render_and_eval(scene.gaussians, cams, bg=bg, dump_dir=dump, device=dev)
        print(split, {k: v for k, v in out[split].items() if k != "per_view"})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="c3dgs_tpu_torch render")
    ModelParams.add_to_parser(parser, "model", fill_none=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    args = load_combined_args(parser, argv)
    return render_sets(ModelParams.extract(args).post_extract(), args.iteration, args.skip_train, args.skip_test)


if __name__ == "__main__":
    main()
