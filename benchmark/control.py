"""The control of the comparison that decides ``correct``: a cell run with
its configuration's ``control`` overrides, the precision below each one the
configuration states on the program's own paths (TF32 at the sweep's
``mxu_precision`` sites for its float32 products; the refinement's float32
Gauss-Newton iterations for its float64 ones).  The comparison has to call
it not correct; its numbers are the upper readings the limits are set
below.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

One process runs every seed (set-up once per seed, the import once) and
prints one JSON line per seed with the compared numbers.  The benchmark's
own runs never run it.  Needs a CUDA device; exits 2 without one.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             variant="control")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": "control", "correct": r["correct"],
                          "compared": r["compared"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()}},
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
