"""Command-line interface, flag-compatible with the JAX package's
(`python -m sibeliaz_tpu_torch [-k -b -m -a -t -f -o -n] <fasta...>`), plus
`--device {cuda,cpu}`.

The port runs FASTA -> GFF, and then, unless `-n` is given, the alignment
stage -> MAF.  On `--device` (the card by default; under `--device cpu`
the kernels' plain PyTorch versions and the torch ops run on the host):
the graph stage; the device LCB engines, `--lcb-engine tpu-fused` (the
fused state machine, its vote memory bounded by `-f`) and `--lcb-engine
tpu` (the resident lanes with a host protocol a lane); and the device POA
engine, `--align-engine tpu` (the batched DP).  On the host: the native
LCB engine (the default), the oracle LCB engine (`--lcb-engine oracle`:
the LCB stage's executable specification, in Python, for small inputs)
and the native POA engine (the default).  Every LCB engine writes the same
GFF, every POA engine the same MAF; the engine names are the JAX
package's, so that the same command lines run on both.  An input whose
monolithic graph stage does not fit the card (or the `-f` budget), or that
has 2^31 positions or more, runs the streamed graph stage, in rounds
resident on the card, with the same records, up to 2^51 positions; a
vertex class that outgrows every round finishes in host-bucketed rounds,
as in the JAX package.  It refuses, and never falls back, where the
default `--device cuda` finds no CUDA card.  k is odd, 3 to 61, as in the
JAX package.  The post-processing tools run as `python -m
sibeliaz_tpu_torch.tools`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from sibeliaz_tpu_torch.config import Config


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-k", type=int, default=25, help="k-mer (vertex) size, odd, 3 to 61")
    p.add_argument("-b", type=int, default=200, help="maximum bubble branch size")
    p.add_argument("-m", type=int, default=50, help="minimum LCB size")
    p.add_argument("-a", type=int, default=150, help="maximum junction abundance")
    p.add_argument("-t", type=int, default=0, help="worker threads (0 = all cores)")
    p.add_argument(
        "-f", type=int, default=0,
        help="device-memory budget in GB for the graph stage (an input "
        "whose monolithic stage does not fit it runs the streamed stage, in "
        "rounds), the tpu-fused engine's votes and the device POA engine's "
        "scratch (default: the card's free memory; half of it for the POA)",
    )
    p.add_argument("-o", dest="outdir", default="./sibeliaz_out", help="output directory")
    p.add_argument("-n", dest="noalign", action="store_true", help="skip the alignment stage")
    p.add_argument("--graph", default=None, help="load junctions from a .dbg file instead of running graph construction")
    p.add_argument("--dump-graph", default=None, help="write the junction stream to this .dbg file (checkpoint)")
    p.add_argument(
        "--legacy-chunks", type=int, default=0, metavar="N",
        help="also emit reference-format <i>.tmp chunk files (N chunks) for "
        "external alignment tooling",
    )
    p.add_argument(
        "--align-engine", choices=("native", "tpu"), default="native",
        help="POA engine for the alignment stage (tpu = the batched "
        "device DP on the card, or its plain version under --device cpu, "
        "with native fallback; identical output)",
    )
    p.add_argument(
        "--poa-ties", choices=("first", "last"), default="first",
        help="POA tie-break policy: 'last' is the spoa-envelope analysis "
        "mode (opposite still-optimal tie preferences via the executable "
        "spec; spec-speed)",
    )
    p.add_argument(
        "--lcb-engine", choices=("native", "oracle", "tpu", "tpu-fused"),
        default="native",
        help="LCB exploration engine (native and oracle on the host; on "
        "--device, tpu-fused = the fused state machine, tpu = the resident "
        "lanes with a host protocol a lane; identical output)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="device of the graph stage, the tpu and tpu-fused LCB engines "
        "and the device POA engine; cpu runs the kernels' plain PyTorch versions",
    )
    p.add_argument("fastas", nargs="+", help="FASTA files with genomes")


def make_config(args) -> Config:
    threads = args.t if args.t > 0 else min(os.cpu_count() or 1, 32)
    return Config(
        k=args.k,
        max_branch_size=args.b,
        min_block_size=args.m,
        abundance_threshold=args.a,
        threads=threads,
        no_align=args.noalign,
        out_dir=args.outdir,
        memory_budget_bytes=(args.f << 30) if args.f > 0 else None,
    )


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="sibeliaz-tpu-torch",
        description="Whole-genome LCB construction and alignment on a CUDA card",
    )
    _add_common(ap)
    args = ap.parse_args(argv)
    cfg = make_config(args)

    import numpy as np
    import torch

    from sibeliaz_tpu_torch import pipeline
    from sibeliaz_tpu_torch.io import dbg as dbg_io
    from sibeliaz_tpu_torch.io import fasta as fasta_io
    from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "sibeliaz-tpu-torch: --device cuda, but no CUDA device is "
            "visible; pass --device cpu to run the plain PyTorch path"
        )

    os.makedirs(cfg.out_dir, exist_ok=True)
    records_in = fasta_io.read_many(args.fastas)
    seqs = [r.seq for r in records_in]
    names = [r.name for r in records_in]

    t0 = time.time()
    if args.graph:
        print("Loading the graph...")
        records = dbg_io.read_dbg(args.graph)
        while len(records) < len(seqs):
            records.append(
                dbg_io.JunctionChr(
                    pos=np.zeros(0, np.uint32), ids=np.zeros(0, np.int64)
                )
            )
    else:
        print("Constructing the graph...")
        from sibeliaz_tpu_torch.graph import construct

        records = construct.build_junctions(
            seqs, cfg.k, args.device, cfg.memory_budget_bytes
        )
    t_graph = time.time()
    if args.dump_graph:
        dbg_io.write_dbg(args.dump_graph, records)

    print("Analyzing the graph...")
    res = pipeline.find_blocks(
        seqs, names, cfg, records=records, engine=args.lcb_engine,
        device=args.device,
    )
    t_lcb = time.time()

    print("Generating the output...")
    with open(os.path.join(cfg.out_dir, "blocks_coords.gff"), "w") as f:
        f.write(res.gff)
    print(f"Blocks found: {res.blocks_found}")
    print(f"Coverage: {res.coverage:.2f}")

    if args.legacy_chunks:
        from sibeliaz_tpu_torch.output import chunks as chunks_mod

        chunks_mod.write_chunks(
            res.blocks, seqs, names, cfg.out_dir, chunks=args.legacy_chunks
        )
    t_out = time.time()

    if not cfg.no_align:
        print("Performing global alignment..")
        from sibeliaz_tpu_torch.align import msa as msa_mod

        with metrics.stage("align", engine=args.align_engine):
            msa_mod.align_blocks_to_maf(
                res.blocks, seqs, names, os.path.join(cfg.out_dir, "alignment.maf"),
                cmd=" ".join(argv if argv is not None else sys.argv[1:]),
                chunks=cfg.chunks, threads=cfg.threads,
                engine=args.align_engine,
                budget_bytes=cfg.memory_budget_bytes,
                tie_policy=args.poa_ties,
                device=args.device,
            )
    t_end = time.time()
    print(
        f"Timings: graph {t_graph - t0:.2f}s, lcb {t_lcb - t_graph:.2f}s, "
        f"align {t_end - t_out:.2f}s, total {t_end - t0:.2f}s"
    )
    metrics.dump(os.path.join(cfg.out_dir, "metrics.json"))
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
