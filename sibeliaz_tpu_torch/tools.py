"""Command-line wrappers for the post-processing tools.

A copy of sibeliaz_tpu/tools.py; it differs in its imports, its program
name (sibeliaz-tpu-torch-tools) and the usage lines below.

Usage:
  python -m sibeliaz_tpu_torch.tools maf2gfa  <alignment.maf> <genomes.fa...>   > out.gfa
  python -m sibeliaz_tpu_torch.tools glue     <graph.gfa>                       > genomes.txt
  python -m sibeliaz_tpu_torch.tools maf2xmfa < alignment.maf  (or path arg)    > out.xmfa
  python -m sibeliaz_tpu_torch.tools synteny  <blocks_coords.gff|alignment.maf> -o outdir -b 5000 [...]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sibeliaz-tpu-torch-tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("maf2gfa", help="convert MAF + genomes to GFA1")
    p.add_argument("maf")
    p.add_argument("fasta", nargs="+")

    p = sub.add_parser("glue", help="reconstruct genomes from a GFA1 graph")
    p.add_argument("gfa")

    p = sub.add_parser("maf2xmfa", help="convert MAF to XMFA (Mauve)")
    p.add_argument("maf", nargs="?", default=None)

    p = sub.add_parser(
        "synteny",
        help="merge LCBs into coarse synteny blocks",
        description=(
            "maf2synteny-equivalent: iterative A-Bruijn simplification "
            "(path compression + bulge removal to a fixpoint) over "
            "(min_block, max_gap) stages of increasing scale."
        ),
        epilog=(
            "Schedule provenance: the built-in 'fine' stages "
            "(30,10) (100,100) (500,1000) (1000,5000) (5000,15000) and the "
            "'loose' extension (10000,50000) (50000,500000) follow the "
            "published Sibelia/maf2synteny multi-scale shape (Minkin et "
            "al., WABI 2013; maf2synteny -s parameter-file format).  The "
            "exact built-in constants of the reference binary could not be "
            "byte-verified (the submodule is pinned but unmounted, "
            "reference CMakeLists.txt:14-15); override with -s <file> to "
            "match a specific maf2synteny build.  Behavior is pinned by "
            "property tests (fixpoint idempotence, stage monotonicity, "
            "strand symmetry — tests/test_synteny_properties.py)."
        ),
    )
    p.add_argument("input", help="blocks_coords.gff or alignment.maf")
    p.add_argument("-o", dest="outdir", default="synteny_out")
    p.add_argument("-b", dest="sizes", type=int, nargs="+", default=[5000])
    p.add_argument(
        "-s", dest="simpl", default="fine",
        help="simplification schedule: 'fine' (default), 'loose', or a "
        "parameter file with one '<min_block> <max_gap>' pair per line",
    )

    args = ap.parse_args(argv)

    if args.cmd == "maf2gfa":
        from sibeliaz_tpu_torch.io import fasta as fasta_io
        from sibeliaz_tpu_torch.postprocess import gfa

        seqs = {r.name: r.seq for r in fasta_io.read_many(args.fasta)}
        gfa.maf_to_gfa(args.maf, seqs, sys.stdout)
    elif args.cmd == "glue":
        from sibeliaz_tpu_torch.postprocess import gfa

        for name, seq in gfa.glue(args.gfa).items():
            sys.stdout.write(f">{name}\n{seq}\n")
    elif args.cmd == "maf2xmfa":
        import tempfile

        from sibeliaz_tpu_torch.postprocess import xmfa

        path = args.maf
        if path is None:
            with tempfile.NamedTemporaryFile(
                "w", suffix=".maf", delete=False
            ) as tmp:
                tmp.write(sys.stdin.read())
                path = tmp.name
        xmfa.maf_to_xmfa(path, sys.stdout)
    elif args.cmd == "synteny":
        from sibeliaz_tpu_torch.postprocess import synteny

        synteny.run(
            args.input, args.outdir, args.sizes,
            stages=synteny.parse_stages(args.simpl),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
