"""The readings that the limits in checks/<cell>.json are set from, on the
card at the cell's own size, in one process:

    python3 benchmark/control.py --workload <name> --program-seeds 1,2,... --control-seeds 7,8,9

For each program seed, one run of the cell with a short window (its
`numbers`: the timed path against the reference); for each control seed,
the control's numbers: the reference computed with TF32 allowed in its
matrix products and convolutions (the nearest precision below the
configuration's float32), put in the program's place and judged against
the float32 reference exactly as the program is. Prints one JSON line per
reading. The benchmark's own runs do not run this.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def planted(mode: str):
    """A fault planted in the reference, which then stands in the
    program's place: "half", the loss over the image's top half only;
    "altered", one field's gradient (features_dc) scaled by 1.5 where the
    backward produces it; "tf32", the control."""
    from benchmark.reference import splat

    orig_loss, orig_grads = splat.photometric_loss, splat.Scene.loss_and_grads

    def half(img, gt, lam):
        h = img.shape[-2] // 2
        return orig_loss(img[..., :h, :], gt[..., :h, :], lam)

    def altered(self, *a, **k):
        loss, grads = orig_grads(self, *a, **k)
        grads["features_dc"] = grads["features_dc"] * 1.5
        return loss, grads

    if mode == "half":
        splat.photometric_loss = half
    elif mode == "altered":
        splat.Scene.loss_and_grads = altered
    try:
        with splat.precision("tf32" if mode == "tf32" else "float32"):
            yield
    finally:
        splat.photometric_loss, splat.Scene.loss_and_grads = orig_loss, orig_grads


def control_numbers(spec: dict, seed: int, dev, modes=("tf32",)) -> dict:
    """{mode: numbers} of each mode put in the program's place against the
    float32 reference, on the cell's inputs from `seed`; the cell's loop
    (loops/<loop>.py) says what is compared."""
    from benchmark import harness

    return harness.load_loop(spec["traffic"]["loop"]).control_numbers(spec, seed, dev, modes, planted)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--modes", default="tf32", help="tf32 (the control), half, altered")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (here, ROOT)]
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the control runs on the card (TF32)", file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    for seed in seeds(args.program_seeds):
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, "cuda", t, spec)
        print(json.dumps(dict(kind="program", workload=args.workload, seed=seed, correct=r["correct"],
                              numbers={k: v["value"] for k, v in r["checks"].items()},
                              metrics={k: v["value"] for k, v in r["metrics"].items()},
                              seconds=time.perf_counter() - t)), flush=True)
        torch.cuda.empty_cache()
    for seed in seeds(args.control_seeds):
        t = time.perf_counter()
        n = control_numbers(spec, seed, torch.device("cuda"), args.modes.split(","))
        for mode, numbers in n.items():
            print(json.dumps(dict(kind=mode, workload=args.workload, seed=seed, numbers=numbers,
                                  seconds=time.perf_counter() - t)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
