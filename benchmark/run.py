"""Run one cell of the benchmark once on one CUDA card and print its
result as the last line of standard output.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout (the program, `splatslam_tpu_torch`, and
the shipped checkpoint are read from there). `--trace 0` measures the
cell's end-to-end metrics; `--trace 1` its per-layer metrics, under the
profiler. Either way the window's stages are checked against the plain
reference (`correct`), and each number compared is printed beside its
limit, as the last lines of standard error and under `checks`, last in
the result. `--control 1` also reads the control (the reference one
precision below the configuration's, in the program's place), judges its
numbers against the same limits and prints them under `control`, with
`control_correct` (false where the control fails a limit, as it should);
the cells' limits were set from such runs.

The process keeps to one host thread for the program's CPU operators
(OMP, MKL and torch's intra- and inter-op pools): the program is bound by
the launches of its main thread, and idle pool threads that spin on the
same cores slow it by however the host schedules them.

Without a CUDA card the run exits 2 and prints no result: it never runs
on the CPU.
"""

import time

T_PROCESS = time.time()

import os  # noqa: E402
import sys  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

# the checkout's root, not this folder, leads the import path: the
# benchmark is the package `benchmark`, beside the program
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "splatslam_tpu")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs only on a CUDA card",
              file=sys.stderr)
        return 2
    from benchmark import harness
    device = torch.device("cuda", 0)
    with contextlib.redirect_stdout(sys.stderr):
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), device, root=ROOT,
                             t_process=T_PROCESS,
                             control=bool(args.control))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"modules that the program may not load are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
