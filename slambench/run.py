"""The benchmark of ``supereight_tpu_torch``: one run of one cell.

    python3 slambench/run.py --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object) and
the check's numbers with their limits as the last lines of standard error.
Exits with another code than 0, and prints no result, without a CUDA card,
when the port cannot be loaded, or when a module of JAX or of the JAX
package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from slambench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    cpus = harness.pin_cpus(device)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_PROCESS, cpus=cpus)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules loaded that the run may not load: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
