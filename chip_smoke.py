"""On-card smoke run of the PyTorch/CUDA port (sibeliaz_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card

Phases, in order; any failure raises and the exit code is non-zero:
  1. device: the card's name and power limit;
  2. build: compile the CUDA kernels from csrc/ (printing nvcc's register,
     shared-memory and spill report) and the native LCB engine;
  3. kernels: K1 front_half and K2 class_analysis against their plain
     PyTorch versions on the card, exact, with CUDA-event times beside the
     plain versions' and the sort's;
  4. small graphs: build_junctions on the card against the brute-force
     oracle on the graph tests' fixture shapes;
  5. goldens: the CLI on examples/ (k=15) and on the regenerated
     reference-scale examples/large pair (k=25), byte-equal to the committed
     GFFs; the large run is the main-path run whose kernel launches count;
  6. timed pass: the CLI on the 16 x 1 Mbp strain workload (k=15), with the
     graph stage's steps, LCB and total seconds, input Mbp/s and the peak
     device bytes per position.
The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.  It imports neither jax nor sibeliaz_tpu.
"""

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
    from sibeliaz_tpu_torch import cli
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

    phase(f"3 kernels vs plain versions, n = 2^24 {label}")
    k1_err, k2_err, times = compare_kernels(torch, dev, alphabet, construct, kernels)

    phase("4 small graphs vs the oracle")
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

    phase(f"5 golden GFFs through the CLI {label}")
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

    phase(f"6 timed pass: 16 x 1 Mbp strains, k=15 {label}")
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
    ]}
    print()
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
