"""The check's readings: the program's numbers and the control's, per seed.

    python3 -m svbench.control --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, in one process: build the cell, warm it, run it for
``--seconds`` at its own load, free the program's state, then compare
(a) what the program produced with the float32 reference (the lower
reading of each number) and (b) the control, the same reference computed
in bfloat16, the precision below the float32 the configurations state,
put in the program's place (the upper reading).  Prints one JSON line a
seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from svbench import cells


def readings(workload: str, seed: int, seconds: float, device="cuda",
             bench=None, overrides=None, root=cells.ROOT) -> dict:
    spec = cells.resolve(bench or cells.load_benchmark(), workload,
                         overrides=overrides, root=root)
    cell = spec.driver.Cell(spec.config, spec.traffic, seed,
                            torch.device(device))
    cell.warm()
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        cell.tick()
    cell.release()
    program = cell.check(torch.float32)
    control = cell.check(torch.float32, stand_in=torch.bfloat16)
    return {"workload": workload, "seed": seed, "frames": cell.frames,
            "program": {k: v for k, (v, _lim) in program.items()},
            "control": {k: v for k, (v, _lim) in control.items()},
            "limits": {k: lim for k, (_v, lim) in program.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
