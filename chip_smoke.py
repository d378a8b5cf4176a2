"""On-card smoke run of the PyTorch/CUDA port (sibeliaz_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card

Phases, in order; any failure raises and the exit code is non-zero:
  1. device: the card's name and power limit;
  2. build: compile the CUDA kernels from csrc/ (printing nvcc's register,
     shared-memory and spill report) and the native LCB and POA engines;
  3. kernels: K1 front_half and K2 class_analysis against their plain
     PyTorch versions on the card, exact, with CUDA-event times beside the
     plain versions' and the sort's;
  4. POA kernel: K3 poa_dp_tb against its plain version on three seeded
     buckets (unbanded, banded, tie-heavy; tests/torch_cases.py's
     generators), exact, with times and shapes;
  5. small graphs: build_junctions on the card against the brute-force
     oracle on the graph tests' fixture shapes;
  6. goldens: the CLI with -n on examples/ (k=15) and on the regenerated
     reference-scale examples/large pair (k=25), byte-equal to the committed
     GFFs; the large run is the main-path run whose K1 and K2 launches
     count;
  7. golden MAFs: the CLI without -n on examples/ with the native and the
     device POA engine, both byte-equal to the committed MAF; the device run
     is the main-path run whose K3 launches count, and K3 is then held
     against its plain version on that run's own dispatch;
  8. examples/large alignment at the CLI's budget: the device engine's MSAs
     against the native engine's on every block of the large pair, and K3
     against its plain version on the run's largest dispatch;
  9. timed pass: the CLI on the 16 x 1 Mbp strain workload (k=15), with the
     graph stage's steps, LCB and total seconds, input Mbp/s and the peak
     device bytes per position.
The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.  It imports neither jax nor sibeliaz_tpu.
"""

import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(REPO, "examples")
LARGE_SHA = {  # tests/test_examples_dir.py LARGE_SHA
    "genome1.fa": "f44bc27bba29089c1f142796f0a4631131a8668908d83fb149aac67868e0c6cc",
    "genome2.fa": "ea148275a6a76583ddd7eff23a66fb1d48c33a4d8110d51aa770de11f2d52a89",
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(title):
    print(f"\n== {title} ==", flush=True)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of `fn` on the card, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---- inputs, rebuilt from the seeds the repo's own generators use -------


def random_genomes(alphabet, rng, n_chr, lo, hi, n_prob=0.0):
    """tests/test_graph.py::random_genomes."""
    seqs = []
    for _ in range(n_chr):
        L = int(rng.integers(lo, hi))
        seq = alphabet.decode(rng.integers(0, 4, size=L).astype(np.uint8))
        if n_prob:
            seq[rng.random(L) < n_prob] = ord("N")
        seqs.append(seq)
    return seqs


def mutate(alphabet, rng, seq, rate):
    """tests/test_graph.py::mutate."""
    seq = seq.copy()
    for p in np.flatnonzero(rng.random(len(seq)) < rate):
        seq[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    return seq


def build_large(alphabet, fasta):
    """examples/large/make_large_example.py::build (seed 33, 2 x 4 x 1.5 Mbp)."""
    rng = np.random.default_rng(33)
    ancestors = [
        alphabet.decode(rng.integers(0, 4, size=1_500_000).astype(np.uint8))
        for _ in range(4)
    ]
    genomes = []
    for g in range(2):
        recs = []
        for c, anc in enumerate(ancestors):
            s = anc.copy()
            pos = np.flatnonzero(rng.random(len(s)) < 0.04)
            s[pos] = alphabet.decode(
                rng.integers(0, 4, size=len(pos)).astype(np.uint8)
            )
            for _ in range(10):
                lo = int(rng.integers(0, len(s) - 20000))
                hi = lo + int(rng.integers(2000, 20000))
                s[lo:hi] = alphabet.reverse_complement(s[lo:hi])
            if g == 1:
                cuts = sorted(rng.integers(0, len(s), size=8))
                parts, last = [], 0
                for ct in cuts:
                    parts.append(s[last:ct])
                    last = ct + int(rng.integers(200, 2000))
                parts.append(s[last:] if last < len(s) else s[:0])
                s = np.concatenate(parts)
            recs.append(fasta.FastaRecord(f"genome{g + 1}.chr{c + 1}", s))
        genomes.append(recs)
    return genomes


def bench_strains(alphabet, fasta):
    """bench.py::make_input: 16 strains x 1 Mbp, ~1% divergence, inversions."""
    length = 1_000_000
    rng = np.random.default_rng(2024)
    base = alphabet.decode(rng.integers(0, 4, size=length).astype(np.uint8))
    recs = []
    for g in range(16):
        s = base.copy()
        for p in np.flatnonzero(rng.random(length) < 0.01):
            s[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
        if g % 3 == 1:
            lo = int(rng.integers(0, length // 2))
            hi = lo + int(rng.integers(length // 8, length // 4))
            s[lo:hi] = alphabet.reverse_complement(s[lo:hi])
        recs.append(fasta.FastaRecord(f"Strain{g + 1}.Chr1", s))
    return recs


def compare_kernels(torch, dev, alphabet, construct, kernels):
    """Phase 3 at 2^24 positions: each kernel equal to its plain version;
    returns (K1 max abs error, K2 max abs error, {name: ms})."""
    n = 1 << 24
    rng = np.random.default_rng(1)
    k1_err, k2_err, times = 0, 0, {}
    for k in (15, 25, 31):
        codes = rng.integers(0, 4, size=n).astype(np.uint8)
        for lo in rng.integers(0, n, size=2000):
            codes[lo : lo + int(rng.integers(1, 500))] = alphabet.BAD_CODE
        pk_h, nm_h = construct.pack_codes_host(codes)
        codes2 = torch.from_numpy(pk_h).to(dev)
        nmask = torch.from_numpy(nm_h).to(dev)
        key, packed = kernels.front_half(codes2, nmask, n, k)
        torch.cuda.synchronize()
        key_p, packed_p = kernels.front_half_plain(codes2, nmask, n, k)
        torch.cuda.synchronize()
        err = max(int((key - key_p).abs().max()), int((packed - packed_p).abs().max()))
        k1_err = max(k1_err, err)
        check(err == 0, f"front_half differs from its plain version at k={k}")
        ms = cuda_ms(torch, lambda: kernels.front_half(codes2, nmask, n, k), 20)
        plain_ms = cuda_ms(torch, lambda: kernels.front_half_plain(codes2, nmask, n, k), 3)
        print(f"front_half k={k}: equal | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms")
        if k == 25:
            times["front_half"] = (ms, plain_ms)
            k25 = (key, packed)

    def sorted_rows(key, packed):
        key_s, order = torch.sort(key, stable=True)
        return key_s, packed[order], order.to(torch.int32)

    sort_ms = cuda_ms(torch, lambda: torch.sort(k25[0], stable=True), 10)
    print(f"torch.sort(stable) of 2^24 int64 keys: {sort_ms:.4f} ms")
    times["sort"] = sort_ms
    poly = rng.integers(0, 4, size=n).astype(np.uint8)
    poly[1000 : 1000 + 1_000_000] = 0  # poly-A: one class of ~10^6 rows
    poly[5_000_000 : 5_000_000 + 100_000] = 1  # poly-C
    poly[9_000_000 : 9_000_000 + 300_000] = alphabet.BAD_CODE
    pk_h, nm_h = construct.pack_codes_host(poly)
    k_poly = kernels.front_half(
        torch.from_numpy(pk_h).to(dev), torch.from_numpy(nm_h).to(dev), n, 25
    )
    for label_k2, (key, packed) in (("k=25 random", k25), ("poly-A stress", k_poly)):
        rows = sorted_rows(key, packed)
        got = kernels.class_analysis(*rows)
        torch.cuda.synchronize()
        want = kernels.class_analysis_plain(*rows)
        torch.cuda.synchronize()
        err = max(int((got[0].int() - want[0].int()).abs().max()),
                  int((got[1] - want[1]).abs().max()))
        k2_err = max(k2_err, err)
        check(err == 0, f"class_analysis differs from its plain version ({label_k2})")
        ms = cuda_ms(torch, lambda: kernels.class_analysis(*rows), 20)
        plain_ms = cuda_ms(torch, lambda: kernels.class_analysis_plain(*rows), 3)
        print(f"class_analysis {label_k2}: equal, {int(got[0].sum())} junction rows | "
              f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms")
        if label_k2 == "k=25 random":
            times["class_analysis"] = (ms, plain_ms)
    return k1_err, k2_err, times


def poa_blocks(cases, kind, rng):
    """Seeded POA blocks of one K3 bucket: (blocks, planner keywords)."""
    if kind == "unbanded":  # L = 1024, full-width windows
        return [cases.rand_block(rng, int(rng.integers(700, 1000)), 3, mut=0.05)
                for _ in range(16)], {"band": False}
    if kind == "banded":  # L = 4096, banded windows
        return [cases.rand_block(rng, int(rng.integers(3000, 4000)), 3, mut=0.03)
                for _ in range(8)], {"band_min": 64}
    # low complexity, L = 4096: ties everywhere
    return [cases.tie_heavy_block(rng, 300) for _ in range(8)], {"band_min": 64}


def k3_vs_plain(torch, align_kernels, args, label):
    """K3 against its plain version on one dispatch's arguments, exact;
    returns (max abs error, kernel ms, plain ms)."""
    check(args is not None, f"no K3 dispatch to check ({label})")
    seq0p, n_max, W, pred_ok = args[0], args[6], args[7], args[4]
    got = align_kernels.poa_dp_tb(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = align_kernels.poa_dp_tb_plain(*args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    check(err == 0, f"poa_dp_tb differs from its plain version ({label})")
    ms = cuda_ms(torch, lambda: align_kernels.poa_dp_tb(*args), 3)
    cols = -(-W // 1024)  # columns per thread: K3 runs at most 1024 threads
    ranks = int(align_kernels._ranks_used(pred_ok).max())
    print(f"poa_dp_tb {label}: equal | B {seq0p.shape[0]} L {seq0p.shape[1] - 1 - W} "
          f"n_max {n_max} W {W} cols {cols} ranks used {ranks} | "
          f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def compare_poa(torch, dev, cases, device_poa, poa_ref, align_kernels):
    """Phase 4: K3 against its plain version on three seeded buckets, each
    block's last copy aligned to the graph of the others, assembled by the
    engine's own device_poa.assemble_round; returns the max abs error."""
    rng = np.random.default_rng(21)
    err = 0
    for kind in ("unbanded", "banded", "tie_heavy"):
        blocks, plan_kw = poa_blocks(cases, kind, rng)
        plan = functools.partial(device_poa._plan_windows, **plan_kw)
        arrays, n_max, W, P, s0s = cases.poa_round(
            blocks, poa_ref.PoaGraph, device_poa._extract_arrays, plan)
        banded = sum(s is not None for s in s0s)
        if kind != "tie_heavy":
            check(banded == (0 if kind == "unbanded" else len(blocks)),
                  f"{kind}: {banded} of {len(blocks)} blocks banded")
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        err = max(err, k3_vs_plain(torch, align_kernels, (*t[:6], n_max, W, P, t[6]),
                                   kind)[0])
    return err


class LargestDispatch:
    """While active, wraps the K3 wrapper that the device engine calls and
    keeps the arguments of the run's largest dispatch (by n_max, then W),
    so that K3 can be held against its plain version at the main path's own
    shapes afterwards.  The wrapper it calls still counts each launch."""

    def __init__(self, align_kernels):
        self.mod, self.args = align_kernels, None

    def __enter__(self):
        real = self.real = self.mod.poa_dp_tb

        def record(*args):
            out = real(*args)
            if self.args is None or args[6:8] > self.args[6:8]:
                self.args = args
            return out

        self.mod.poa_dp_tb = record
        return self

    def __exit__(self, *exc):
        self.mod.poa_dp_tb = self.real


def maf_body(path):
    with open(path) as f:
        return [l for l in f.read().splitlines() if not l.startswith("# cmd=")]


def align_counts(metrics):
    """The alignment stage's counters: dispatches, blocks, re-runs, native
    routing, and the device engine's seconds per phase (poa_*_s)."""
    keys = ("poa_dispatches", "poa_blocks_dispatched", "poa_band_pass2",
            "poa_band_full", "poa_native_routed", "poa_native_redo")
    counts = {k: int(metrics.counters.get(k, 0)) for k in keys}
    counts.update(sorted((k, v) for k, v in metrics.counters.items()
                         if k.startswith("poa_") and k.endswith("_s")))
    return counts


def golden_mafs(torch, cli, metrics, align_kernels, out_dir):
    """Phase 7: returns K3's launches in the device-engine run and
    k3_vs_plain's result on that run's dispatch."""
    golden = maf_body(os.path.join(EXAMPLES, "sibeliaz_out", "alignment.maf"))
    fas = [os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")]
    launches = 0
    for engine in ("native", "tpu"):
        out = os.path.join(out_dir, engine)
        metrics.timings.clear()
        metrics.counters.clear()
        align_kernels.reset_launches()
        with LargestDispatch(align_kernels) as rec:
            wall = run_cli(cli, ["-k", "15", "--align-engine", engine, "-o", out, *fas])
        launches = align_kernels.LAUNCHES["poa_dp_tb"]
        align_s = {t["stage"]: t["seconds"] for t in metrics.timings}["align"]
        counts = align_counts(metrics)
        check(maf_body(os.path.join(out, "alignment.maf")) == golden,
              f"examples/ MAF ({engine} engine) differs from the golden")
        if engine == "tpu":
            check(launches > 0, "poa_dp_tb was not launched on the CLI path")
            check(counts["poa_blocks_dispatched"] == 11 and counts["poa_native_redo"] == 0
                  and counts["poa_native_routed"] == 0,
                  f"not every examples/ block went through the card: {counts}")
        print(f"examples/ --align-engine {engine}: MAF byte-equal to the golden | align "
              f"{align_s:.4f} s | CLI wall {wall:.4f} s | poa_dp_tb launches {launches} | {counts}")
    return launches, k3_vs_plain(torch, align_kernels, rec.args, "examples/ dispatch")


def large_alignment(torch, large_fa, fasta, pipeline, Config, msa, metrics, align_kernels,
                    out_dir):
    """Phase 8: both POA engines on every block of examples/large (k=25) at
    the CLI's budget (no -f), MSAs compared through the MAF they write;
    returns k3_vs_plain's result on the device run's largest dispatch."""
    recs = fasta.read_many(large_fa)
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    threads = os.cpu_count() or 1
    res = pipeline.find_blocks(seqs, names, Config(k=25, threads=4), device="cuda")
    os.makedirs(out_dir, exist_ok=True)
    bodies = {}
    for engine in ("native", "tpu"):
        metrics.counters.clear()
        align_kernels.reset_launches()
        path = os.path.join(out_dir, f"{engine}.maf")
        t0 = time.time()
        with LargestDispatch(align_kernels) as rec:
            overflow = msa.align_blocks_to_maf(res.blocks, seqs, names, path, threads=threads,
                                               engine=engine, device="cuda")
        secs = time.time() - t0
        check(not overflow, f"{engine} engine overflowed blocks {overflow[:10]}")
        bodies[engine] = maf_body(path)
        print(f"examples/large --align-engine {engine}: {res.blocks_found} blocks | align "
              f"{secs:.4f} s | poa_dp_tb launches {align_kernels.LAUNCHES['poa_dp_tb']} | "
              f"{align_counts(metrics)}")
    check(bodies["native"] == bodies["tpu"],
          "examples/large: device-engine MSAs differ from the native engine's")
    print(f"examples/large: the device engine's MSAs equal the native engine's on all "
          f"{res.blocks_found} blocks")
    return k3_vs_plain(torch, align_kernels, rec.args, "examples/large largest dispatch")


def run_cli(cli, argv):
    t0 = time.time()
    rc = cli.run(argv)
    check(rc == 0, f"CLI {argv} returned {rc}")
    return time.time() - t0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_cases
    from sibeliaz_tpu_torch import cli, pipeline
    from sibeliaz_tpu_torch.align import device_poa, msa, poa_ref
    from sibeliaz_tpu_torch.align import kernels as align_kernels
    from sibeliaz_tpu_torch.config import Config
    from sibeliaz_tpu_torch.core import alphabet
    from sibeliaz_tpu_torch.graph import construct, kernels, oracle
    from sibeliaz_tpu_torch.io import fasta
    from sibeliaz_tpu_torch.lcb import engine
    from sibeliaz_tpu_torch.utils import cudabuild
    from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory()

    phase("1 device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {name} | {smi}")
    label = f"({smi})"

    phase("2 build")
    t0 = time.time()
    lib_path, ptxas = cudabuild.build()
    print(f"kernels built in {time.time() - t0:.1f} s: {os.path.relpath(lib_path, REPO)}")
    for line in ptxas.splitlines():
        if "ptxas info" in line or "spill" in line:
            print("  " + line.strip())
    t0 = time.time()
    engine.ensure_built()
    print(f"native LCB engine built in {time.time() - t0:.1f} s")
    t0 = time.time()
    msa.ensure_built()
    print(f"native POA engine built in {time.time() - t0:.1f} s")

    phase(f"3 kernels vs plain versions, n = 2^24 {label}")
    k1_err, k2_err, times = compare_kernels(torch, dev, alphabet, construct, kernels)

    phase(f"4 POA kernel vs its plain version {label}")
    k3_err = compare_poa(torch, dev, torch_cases, device_poa, poa_ref, align_kernels)

    phase("5 small graphs vs the oracle")
    cases = 0
    for seed, n_prob in ((0, 0.0), (1, 0.02), (2, 0.0), (3, 0.01), (4, 0.0), (5, 0.05)):
        for k in (3, 9, 15, 25, 31):
            seqs = random_genomes(alphabet, np.random.default_rng(seed), 3, 50, 400, n_prob)
            got = construct.build_junctions(seqs, k, dev)
            want = oracle.enumerate_junctions(seqs, k)
            for a, b in zip(got, want):
                check(np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids),
                      f"graph differs from the oracle: seed {seed}, k={k}")
            cases += 1
    rng = np.random.default_rng(7)
    base = random_genomes(alphabet, rng, 2, 500, 800)[0]
    related = [base, mutate(alphabet, rng, base, 0.01),
               alphabet.reverse_complement(mutate(alphabet, rng, base, 0.005))]
    rng = np.random.default_rng(11)
    unit = alphabet.decode(rng.integers(0, 4, size=40).astype(np.uint8))
    repeat = [np.concatenate([unit] * 6 + [alphabet.reverse_complement(unit)] * 2)]
    for seqs, k in ((related, 11), (repeat, 9)):
        for a, b in zip(construct.build_junctions(seqs, k, dev),
                        oracle.enumerate_junctions(seqs, k)):
            check(np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids),
                  f"graph differs from the oracle at k={k}")
        cases += 1
    print(f"{cases} graphs equal to the oracle")

    phase(f"6 golden GFFs through the CLI {label}")
    ex_out = os.path.join(tmp.name, "examples")
    run_cli(cli, ["-k", "15", "-n", "-o", ex_out,
                  os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")])
    with open(os.path.join(ex_out, "blocks_coords.gff"), "rb") as f, open(
        os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff"), "rb"
    ) as g:
        check(f.read() == g.read(), "examples/ GFF differs from the golden")
    print("examples/ k=15: GFF byte-equal to the golden (11 blocks)")

    large_fa = []
    for g, recs in enumerate(build_large(alphabet, fasta), start=1):
        path = os.path.join(tmp.name, f"genome{g}.fa")
        fasta.write_fasta(path, recs)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        check(digest == LARGE_SHA[f"genome{g}.fa"], f"genome{g}.fa digest {digest}")
        large_fa.append(path)
    print("examples/large inputs regenerated; SHA-256 digests match")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    large_out = os.path.join(tmp.name, "large")
    secs = run_cli(cli, ["-k", "25", "-n", "-t", "4", "-o", large_out, *large_fa])
    launches = dict(kernels.LAUNCHES)
    large_peak = (torch.cuda.max_memory_allocated() - mem0) / metrics.counters["graph_positions"]
    with open(os.path.join(large_out, "blocks_coords.gff"), "rb") as f, open(
        os.path.join(EXAMPLES, "large", "sibeliaz_out", "blocks_coords.gff"), "rb"
    ) as g:
        check(f.read() == g.read(), "examples/large GFF differs from the golden")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    print(f"examples/large k=25: GFF byte-equal to the golden (1256 blocks) in "
          f"{secs:.2f} s | launches {launches} | peak {large_peak:.1f} B/position {label}")

    phase(f"7 golden MAFs through the CLI, both POA engines {label}")
    k3_launches, k3_main = golden_mafs(torch, cli, metrics, align_kernels,
                                       os.path.join(tmp.name, "maf"))

    phase(f"8 examples/large alignment: device engine vs native {label}")
    k3_large = large_alignment(torch, large_fa, fasta, pipeline, Config, msa, metrics,
                               align_kernels, os.path.join(tmp.name, "large_maf"))

    phase(f"9 timed pass: 16 x 1 Mbp strains, k=15 {label}")
    strains = bench_strains(alphabet, fasta)
    bench_fa = os.path.join(tmp.name, "strains.fa")
    fasta.write_fasta(bench_fa, strains)
    mbp = sum(len(r.seq) for r in strains) / 1e6
    for p in (1, 2):
        metrics.timings.clear()
        metrics.counters.clear()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        wall = run_cli(cli, ["-k", "15", "-n", "-o", os.path.join(tmp.name, f"bench{p}"), bench_fa])
        peak = (torch.cuda.max_memory_allocated() - mem0) / metrics.counters["graph_positions"]
        st = {t["stage"]: t["seconds"] for t in metrics.timings}
        graph = sum(v for s, v in st.items() if s.startswith("graph_"))
        lcb = st["junction_table"] + st["lcb_engine"] + st["trim_and_render"]
        check(all(v > 0 for v in kernels.LAUNCHES.values()),
              f"a kernel was not launched: {kernels.LAUNCHES}")
        print(f"pass {p}: " + " | ".join(f"{s} {v:.4f} s" for s, v in st.items()))
        print(f"pass {p}: graph {graph:.4f} s | lcb+out {lcb:.4f} s | graph+lcb "
              f"{graph + lcb:.4f} s | CLI wall {wall:.4f} s | {mbp / wall:.3f} input Mbp/s | "
              f"junctions {int(metrics.counters['graph_junctions'])} | "
              f"blocks {int(metrics.counters['blocks_found'])} | peak {peak:.1f} B/position | "
              f"launches {kernels.LAUNCHES} {label}")
    tmp.cleanup()

    src = "sibeliaz_tpu_torch/csrc/"
    summary = {"kernels": [
        {"name": "front_half", "route": "cuda", "source": src + "front_half.cu",
         "replaces": "sibeliaz_tpu/graph/pallas_kernels.py:170",
         "launches": launches["front_half"], "max_abs_err": k1_err,
         "ms": times["front_half"][0], "plain_ms": times["front_half"][1]},
        {"name": "class_analysis", "route": "cuda", "source": src + "class_analysis.cu",
         "replaces": "sibeliaz_tpu/graph/construct.py:450",
         "launches": launches["class_analysis"], "max_abs_err": k2_err,
         "ms": times["class_analysis"][0], "plain_ms": times["class_analysis"][1]},
        {"name": "poa_dp_tb", "route": "cuda", "source": src + "poa_dp_tb.cu",
         "replaces": "sibeliaz_tpu/align/tpu_poa.py:206",
         "launches": k3_launches, "max_abs_err": max(k3_err, k3_main[0], k3_large[0]),
         "ms": k3_main[1], "plain_ms": k3_main[2]},
    ]}
    print()
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
