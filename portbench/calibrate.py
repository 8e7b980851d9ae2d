#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 1]
        [--seconds S] [--faults a,b] [--out FILE]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` (0: one call or step), then the program's readings, and with
``--control 1`` the readings of the configuration's control (the reference
in the precision below the configuration's, in the program's place), and
with ``--faults`` the readings of the program broken on purpose by each
named fault of the kind (``Kind.FAULTS``). One JSON line a seed (and
fault) on standard output, and in ``--out``. The benchmark's own runs do
not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ps = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ps.add_argument("--workload", required=True)
    ps.add_argument("--seeds", required=True)
    ps.add_argument("--seconds", type=float, default=0.0)
    ps.add_argument("--control", type=int, default=0)
    ps.add_argument("--faults", default="")
    ps.add_argument("--out", default=None)
    args = ps.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    cell = harness.workload(args.workload)
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in [None] + faults:
            run = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                     trace=0)
            ctx = harness.Context(run, cell, harness.config(cell["config"]),
                                  harness.traffic(cell["traffic"]), harness.Tracer(False))
            ctx.device = torch.device("cuda:0")
            mod = harness.kind_module(ctx.mix["kind"])
            kind = mod.Kind(ctx, mod.FAULTS[fault] if fault else {})
            kind.setup()
            kind.window()
            kind.release()
            t0 = time.perf_counter()
            line = {"workload": args.workload, "seed": seed, "fault": fault,
                    "program": kind.check(), "reference_s": time.perf_counter() - t0}
            if args.control and fault is None:
                line["control"] = kind.control()
            line["card"] = torch.cuda.get_device_name(0)
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            del kind
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
