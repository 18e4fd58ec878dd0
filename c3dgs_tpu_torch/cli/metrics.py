"""Metrics CLI (port of the JAX package's metrics.py): score the dumped
renders/ + gt/ PNG pairs again with SSIM / PSNR.

    python -m c3dgs_tpu_torch.cli.metrics -m <model dir> [<model dir> ...]

Parity: metrics.py evaluate (:38-117) -> results.json / per_view.json in
each model dir. LPIPS is computed when converted weights are at
eval/lpips.py's default path, and written as null with the reason
otherwise, as the JAX CLI does. --data_device (default cuda) picks the
device the scores are computed on.
"""
import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..eval import lpips as lpips_mod
from ..ops import losses as L


def evaluate(model_paths, lpips_net="vgg", device=None):
    from PIL import Image

    dev = resolve_device(device)
    if lpips_mod.available(net_type=lpips_net):
        lpips_fn = lpips_mod.LPIPS(net_type=lpips_net, device=dev)
    else:
        lpips_fn = None
        print(lpips_mod.unavailable_hint(lpips_net))

    def read(p):
        arr = np.asarray(Image.open(p)).astype(np.float32) / 255.0
        return torch.as_tensor(arr[:, :, :3].transpose(2, 0, 1).copy(), device=dev)

    for model_path in model_paths:
        print("Scene:", model_path)
        full = {"ours": {}}
        for method_dir in sorted(Path(model_path).glob("*/ours_*")):
            renders_dir = method_dir / "renders"
            gt_dir = method_dir / "gt"
            if not renders_dir.exists():
                continue
            ssims, psnrs, lpipss, per_view = [], [], [], {}
            for img_path in sorted(renders_dir.iterdir()):
                gt_path = gt_dir / img_path.name
                if not gt_path.exists():
                    continue
                render, gt = read(img_path), read(gt_path)
                p = float(L.psnr(render, gt)[0, 0])
                s = float(L.ssim(render, gt))
                psnrs.append(p)
                ssims.append(s)
                per_view[img_path.name] = {"psnr": p, "ssim": s}
                if lpips_fn is not None:
                    lp = float(lpips_fn(render, gt))
                    lpipss.append(lp)
                    per_view[img_path.name]["lpips"] = lp
            name = str(method_dir.relative_to(model_path))
            result = {
                "SSIM": float(np.mean(ssims)) if ssims else None,
                "PSNR": float(np.mean(psnrs)) if psnrs else None,
                "LPIPS": float(np.mean(lpipss)) if lpipss else None,
            }
            if lpips_fn is None:
                result["LPIPS_reason"] = lpips_mod.UNAVAILABLE_REASON
            full[name] = result
            print(f"  {name}: {result}")
            with open(os.path.join(model_path, "per_view.json"), "w") as f:
                json.dump(per_view, f, indent=2)
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_paths", "-m", required=True, nargs="+", type=str)
    parser.add_argument(
        "--lpips_net",
        choices=["vgg", "alex"],
        default="vgg",
        help="LPIPS backbone (reference networks.py:12-20; used when converted weights are present)",
    )
    parser.add_argument("--data_device", type=str, default="cuda")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, lpips_net=args.lpips_net, device=args.data_device)


if __name__ == "__main__":
    main()
