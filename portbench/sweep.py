#!/usr/bin/env python3
"""Find the highest arrival rate a serving cell sustains, on the card.

    python3 portbench/sweep.py --workload <cell> --rates 10,20,40 [--seconds S] [--seed N]

One set-up of the cell, then a window of ``--seconds`` at each rate in
turn, each printed as a JSON line: the offered and completed rates, the
client's p50 and p95 (ms), the batcher's mean batch, and the backlog's
drift (the median latency of the window's last quarter of requests over
its first quarter's; a queue that grows all through the window reads well
above 1). The benchmark's own runs do not run this: a cell's rate is fixed
in its traffic file.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ps = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ps.add_argument("--workload", required=True)
    ps.add_argument("--rates", required=True)
    ps.add_argument("--seconds", type=float, default=20.0)
    ps.add_argument("--seed", type=int, default=1)
    args = ps.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.workload(args.workload)
    run = argparse.Namespace(workload=args.workload, seed=args.seed, seconds=args.seconds, trace=0)
    ctx = harness.Context(run, cell, harness.config(cell["config"]),
                          harness.traffic(cell["traffic"]), harness.Tracer(False))
    ctx.device = torch.device("cuda:0")
    kind = harness.kind_module(ctx.mix["kind"]).Kind(ctx, {})
    kind.setup()
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            kind.rate = rate
            e2e = kind.window()
            lat = np.array([1e3 * (r["done"] - r["due"]) for r in kind.recs
                            if r.get("status") == 200])
            q = max(1, len(lat) // 4)
            st = kind.stats
            print(json.dumps({
                "rate_offered": rate, "requests": len(kind.reqs), "failed": kind.failed,
                "rate_completed": len(lat) / kind.wall_s, **e2e,
                "drift": float(np.median(lat[-q:]) / np.median(lat[:q])) if len(lat) else None,
                "mean_batch": st["n_requests"] / st["n_batches"] if st["n_batches"] else None,
                "device_call_ms": 1e3 * st["device_seconds"] / max(st["n_batches"], 1),
                "generator_late_ms": kind.late_ms,
                "card": torch.cuda.get_device_name(0)}), flush=True)
    finally:
        kind.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
