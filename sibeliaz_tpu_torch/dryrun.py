"""The multi-device dry run: the graph and POA stages of the JAX package's
__graft_entry__.dryrun_multichip, over a device list.

    python -m sibeliaz_tpu_torch.dryrun                         # every CUDA card
    python -m sibeliaz_tpu_torch.dryrun --devices cuda:0,cuda:0  # one card, two shards
    python -m sibeliaz_tpu_torch.dryrun --devices cpu,cpu        # the plain versions

Stage 1: the sharded graph stage (one shard a device) against the
monolithic stage on the first device, on the JAX dry run's seeded pair
(16,384 bp and a 1% mutant with an inversion, k=15).  Stage 2, the fused
LCB engine with its lanes over the devices, is not ported (ROADMAP item
A9): the run says so.  Stage 3: the device POA engine with each dispatch
spread over the devices against poa_ref.poa_msa on the dry run's seeded
blocks (two a device, 96 bp and up).  Exits 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sibeliaz_tpu_torch.align import device_poa, poa_ref
from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.graph import construct
from sibeliaz_tpu_torch.parallel import sharded


def dryrun_inputs(n_devices: int):
    """The JAX dry run's seeded inputs: the pair of stage 1, then the
    blocks of stage 3 from the same generator."""
    rng = np.random.default_rng(1)
    base = alphabet.decode(rng.integers(0, 4, size=16384).astype(np.uint8))
    mut = base.copy()
    for p in np.flatnonzero(rng.random(len(mut)) < 0.01):
        mut[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    mut[6000:8000] = alphabet.reverse_complement(mut[6000:8000])
    blocks = []
    for b in range(2 * n_devices):
        src = alphabet.decode(rng.integers(0, 4, size=96 + 8 * b).astype(np.uint8))
        rows = []
        for _ in range(3 + (b % 2)):
            r = src.copy()
            for p in np.flatnonzero(rng.random(len(r)) < 0.04):
                r[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
            rows.append(r)
        blocks.append(rows)
    return [base, mut], blocks


def dryrun(devices) -> bool:
    """Stages 1 and 3 over `devices`; True when both pass."""
    n = len(devices)
    seqs, blocks = dryrun_inputs(n)
    k = 15
    multi = sharded.build_junctions_sharded(seqs, k, devices=devices)
    single = construct.build_junctions(seqs, k, devices[0])
    graph_ok = len(multi) == len(single) and all(
        np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)
        for a, b in zip(single, multi))
    n_junc = sum(len(r.pos) for r in single)
    print(f"[dryrun] {'PASS' if graph_ok else 'FAIL'} stage1 junctions: {n}-shard sharded "
          f"construction {'==' if graph_ok else '!='} monolithic ({n_junc} junctions)",
          flush=True)
    print("[dryrun] NOT PORTED stage2 LCB: the fused device LCB engine with its lanes over "
          "the devices waits on ROADMAP item A9", flush=True)
    got = device_poa.poa_msa_batch_tpu(blocks, devices=devices)
    poa_ok = all(msa is not None and msa == poa_ref.poa_msa(rows)
                 for rows, msa in zip(blocks, got))
    print(f"[dryrun] {'PASS' if poa_ok else 'FAIL'} stage3 POA: device MSAs spread over {n} "
          f"devices {'equal' if poa_ok else 'differ from'} the host reference on "
          f"{len(blocks)} blocks", flush=True)
    return graph_ok and poa_ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sibeliaz_tpu_torch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", help="comma-separated devices, one shard each "
                    "(default: every CUDA card)")
    args = ap.parse_args(argv)
    if args.devices:
        devices = args.devices.split(",")
    elif torch.cuda.is_available():
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        print("dryrun: no CUDA card; pass --devices (e.g. cpu,cpu)", file=sys.stderr)
        return 2
    ok = dryrun(devices)
    print(f"[dryrun] stages 1 and 3 {'PASS' if ok else 'FAIL'} on {len(devices)} devices; "
          "stage 2 waits on A9", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
