"""The multi-device dry run: every stage of the JAX package's
__graft_entry__.dryrun_multichip over a device list, and its entry().

    python -m sibeliaz_tpu_torch.dryrun                         # every CUDA card
    python -m sibeliaz_tpu_torch.dryrun --devices cuda:0,cuda:0  # one card, two shards
    python -m sibeliaz_tpu_torch.dryrun --devices cpu,cpu        # the plain versions

Stage 1: the sharded graph stage (one shard a device) against the
monolithic stage on the first device, on the JAX dry run's seeded pair
(16,384 bp and a 1% mutant with an inversion, k=15).  Stage 2: the whole
LCB protocol (LcbEngine.run's phases and serial commit, phase_size 32)
with the fused engine's lanes over the devices (lcb/fused.py, `devices=`)
on stage 1's records, through trim and GFF: more than 64 bundles, the GFF
byte-equal to the host oracle's and to the fused engine's on the first
device alone.  Stage 2b: the same at the production phase_size 256 on the
JAX dry run's second pair (26,624 bp and a 7% mutant, k=15): more than 512
bundles, the GFF byte-equal to the host oracle's.  Stage 3: the device POA
engine with each dispatch spread over the devices against poa_ref.poa_msa
on the dry run's seeded blocks (two a device, 96 bp and up).  Each stage
prints PASS or FAIL with its seconds; the exit code is 1 when one fails.

entry(device) returns (fn, args) as __graft_entry__.entry() does: fn is
graph/construct.junction_analysis at k=25, args the seeded 2^16-base code
tensor on `device`.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch

from sibeliaz_tpu_torch.align import device_poa, poa_ref
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.graph import construct
from sibeliaz_tpu_torch.junctions.table import JunctionTable
from sibeliaz_tpu_torch.lcb.fused import process_phase_fused
from sibeliaz_tpu_torch.lcb.oracle import LcbEngine
from sibeliaz_tpu_torch.output import gff, trim
from sibeliaz_tpu_torch.parallel import sharded

K = 15


def _mutant(rng, base, rate):
    mut = base.copy()
    for p in np.flatnonzero(rng.random(len(mut)) < rate):
        mut[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    return mut


def dryrun_inputs(n_devices: int):
    """The JAX dry run's seeded inputs: the pair of stages 1 and 2, then
    the blocks of stage 3 from the same generator."""
    rng = np.random.default_rng(1)
    base = alphabet.decode(rng.integers(0, 4, size=16384).astype(np.uint8))
    mut = _mutant(rng, base, 0.01)
    mut[6000:8000] = alphabet.reverse_complement(mut[6000:8000])
    blocks = []
    for b in range(2 * n_devices):
        src = alphabet.decode(rng.integers(0, 4, size=96 + 8 * b).astype(np.uint8))
        blocks.append([_mutant(rng, src, 0.04) for _ in range(3 + (b % 2))])
    return [base, mut], blocks


def dryrun_pair_256():
    """Stage 2b's pair: 26,624 bp at 7% divergence, no inversion (dense
    junctions: more than 512 bundles with short walks)."""
    rng = np.random.default_rng(7)
    base = alphabet.decode(rng.integers(0, 4, size=26624).astype(np.uint8))
    return [base, _mutant(rng, base, 0.07)]


def full_lcb(records, seqs, names, batch_fn, phase_size: int):
    """The LCB protocol from the records through trim and GFF, on a fresh
    table (the `used` flags live there); returns (bundles, GFF text).
    batch_fn None: the host oracle."""
    cfg = Config(k=K)
    table = JunctionTable.build(records, seqs, names, K, cfg.abundance_threshold)
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking)
    n_bundles = len(eng.make_bundles())
    raw = eng.run(process_batch_fn=batch_fn, phase_size=phase_size)
    lengths = [len(s) for s in seqs]
    blocks, _ = trim.trim_blocks(raw, lengths, cfg.min_block_size)
    return n_bundles, gff.render_gff(blocks, names, lengths)


def _report(ok: bool, stage: str, what: str, t0: float) -> bool:
    print(f"[dryrun] {'PASS' if ok else 'FAIL'} {stage}: {what} in "
          f"{time.time() - t0:.2f} s", flush=True)
    return ok


def dryrun(devices) -> bool:
    """Every stage over `devices`; True when all pass."""
    n = len(devices)
    seqs, blocks = dryrun_inputs(n)
    lanes = functools.partial(process_phase_fused, devices=devices)
    ok = []

    t0 = time.time()
    multi = sharded.build_junctions_sharded(seqs, K, devices=devices)
    single = construct.build_junctions(seqs, K, devices[0])
    same = len(multi) == len(single) and all(
        np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)
        for a, b in zip(single, multi))
    ok.append(_report(same, "stage1 junctions", f"{n}-shard sharded construction "
                      f"{'==' if same else '!='} monolithic "
                      f"({sum(len(r.pos) for r in single)} junctions)", t0))

    t0 = time.time()
    names = ["g0", "g1"]
    n_bundles, got = full_lcb(single, seqs, names, lanes, 32)
    _, host = full_lcb(single, seqs, names, None, 32)
    _, one = full_lcb(single, seqs, names,
                      functools.partial(process_phase_fused, device=devices[0]), 32)
    n_lines = got.count("\n")
    good = n_bundles > 2 * 32 and n_lines > 10 and got == host == one
    ok.append(_report(good, "stage2 LCB", f"fused lanes over {n} devices, GFF "
                      f"{'byte-equal to' if got == host == one else 'differs from'} the host "
                      f"oracle's and the one-device run's ({n_bundles} bundles, phase_size 32, "
                      f"{n_lines} GFF lines)", t0))

    t0 = time.time()
    seqs2, names2 = dryrun_pair_256(), ["h0", "h1"]
    records2 = construct.build_junctions(seqs2, K, devices[0])
    n_bundles2, got2 = full_lcb(records2, seqs2, names2, lanes, 256)
    _, host2 = full_lcb(records2, seqs2, names2, None, 256)
    good = n_bundles2 > 2 * 256 and got2 == host2
    ok.append(_report(good, "stage2b LCB-256", f"fused lanes over {n} devices at the "
                      f"production phase_size 256 ({n_bundles2} bundles across "
                      f"{-(-n_bundles2 // 256)} phases), GFF "
                      f"{'byte-equal to' if got2 == host2 else 'differs from'} the host "
                      f"oracle's ({got2.count(chr(10))} GFF lines)", t0))

    t0 = time.time()
    msas = device_poa.poa_msa_batch_tpu(blocks, devices=devices)
    same = all(msa is not None and msa == poa_ref.poa_msa(rows)
               for rows, msa in zip(blocks, msas))
    ok.append(_report(same, "stage3 POA", f"device MSAs spread over {n} devices "
                      f"{'equal' if same else 'differ from'} the host reference on "
                      f"{len(blocks)} blocks", t0))
    return all(ok)


def entry(device="cuda"):
    """(fn, args) as __graft_entry__.entry(): fn is junction_analysis at
    k=25, args the default_rng(0) 2^16-base code tensor on `device`."""
    rng = np.random.default_rng(0)
    seq = alphabet.decode(rng.integers(0, 4, size=1 << 16).astype(np.uint8))
    codes = torch.from_numpy(alphabet.encode(seq)).to(device)
    return functools.partial(construct.junction_analysis, k=25), (codes,)


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
    print(f"[dryrun] {'ALL STAGES PASS' if ok else 'A STAGE FAILED'} on {len(devices)} "
          "devices", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
