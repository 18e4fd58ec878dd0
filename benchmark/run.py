"""The benchmark of `c3dgs_tpu_torch` on NVIDIA H100s: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (see benchmark/README.md), the compared numbers beside
their limits as the last lines of standard error. Exits with another code
than 0, and prints no result, without enough CUDA devices or if the
process holds JAX or the JAX package once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # the checkout's root in place of this script's folder, whose module
    # names (trace, scene, ...) would shadow others
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (here, ROOT)]
    import torch

    from benchmark import harness

    spec = harness.load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0, spec)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"the process holds {', '.join(bad)}: the benchmark measures c3dgs_tpu_torch alone", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
