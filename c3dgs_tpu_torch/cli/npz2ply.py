"""npz -> ply converter (port of the JAX package's npz2ply.py): de-indexes
the codebooks to dense attributes.

    python -m c3dgs_tpu_torch.cli.npz2ply <input.npz> <output.ply> [--sh_degree 3]

Parity: npz2ply.py:1-21. --data_device (default cuda) picks the device the
scene is loaded on, and a missing card is an error.
"""
import argparse

from ..device import resolve_device
from ..models import io_npz, io_ply


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input", type=str, help="compressed .npz")
    parser.add_argument("output", type=str, help="output .ply")
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--data_device", type=str, default="cuda")
    args = parser.parse_args(argv)

    scene = io_npz.load_npz(args.input, max_sh_degree=args.sh_degree, override_quantization=True,
                            device=resolve_device(args.data_device))
    scene = scene.to_unindexed()
    io_ply.save_gaussians_ply(scene, args.output)
    print(f"wrote {args.output} ({scene.capacity} splats)")
    return scene


if __name__ == "__main__":
    main()
