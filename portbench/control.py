#!/usr/bin/env python3
"""The control of the check, at a cell's own size: the plain reference with
k-mer codes keyed by a `--key-bits`-bit hash (32 by default) put in the
program's place, judged by the same comparison as a run (reference/
check.py).  Reads the numbers on each seed; a sound control reads not
correct on every one.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] [--key-bits 32]

Host only (NumPy, the LCB stage on forked workers, one a core up to 8);
the benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--key-bits", type=int, default=32)
    args = ap.parse_args(argv)

    from portbench.lib import genomes, registry
    from portbench.reference import check

    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    for seed in args.seeds:
        t0 = time.time()
        gs = genomes.generate(traffic, seed)
        seqs = [s for g in gs for _, s in g]
        names = [n for g in gs for n, _ in g]
        workers = check.workers_here()
        ref = check.reference(seqs, names, cfg, workers=workers)
        numbers = check.compare(check.control(seqs, names, cfg, args.key_bits, workers), ref)
        correct = all(v <= check.LIMITS[k] for k, v in numbers.items())
        print(json.dumps({"workload": args.workload, "seed": seed, "key_bits": args.key_bits,
                          "correct": correct, "check": numbers,
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
