"""On-card smoke run of the PyTorch/CUDA port (sibeliaz_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card
    python3 chip_smoke.py --k3-replay DIR    # K3's development loop, see k3_replay
    python3 chip_smoke.py --k3-time KINDS    # K3's wrapper alone, see k3_time
    python3 chip_smoke.py --k2-time          # K2's wrapper alone, see k2_vs_plain
    python3 chip_smoke.py --k1-time          # K1's wrapper alone, see k1_vs_plain
    python3 chip_smoke.py --k4-time [OLDER.cu]  # K4's wrapper (and an older one), see k4_time
    python3 chip_smoke.py --sharded          # phase 12 alone, see sharded_phase
    python3 chip_smoke.py --fused            # phase 13 alone, see fused_phase
    python3 chip_smoke.py --dryrun           # phase 14 alone, see devices_phase
    python3 chip_smoke.py --resident         # phase 15 alone, see resident_phase
    python3 chip_smoke.py --walk             # phase 16 alone, see walk_phase
    python3 chip_smoke.py --k5-time [OLDER.cu]  # K5 (and an older one) timed, see k5_time
    python3 chip_smoke.py --vote [OLDER.py]  # phase 17 alone (an older lcb/kernels.py's
                                             # K5 wrapper timed beside), see vote_phase
    python3 chip_smoke.py --step [OLDER_DIR]  # phase 18 alone with the split of a step
                                             # (and an older K7 timed beside), see step_phase
    python3 chip_smoke.py --seed             # K8 lcb_seed timed, see seed_phase

Phases, in order; any failure raises and the exit code is non-zero:
  1. device: the card's name and power limit, and the peak rates the
     kernels' bounds are taken against;
  2. build: compile the CUDA kernels from csrc/ (printing nvcc's register,
     shared-memory and spill report) and the native LCB and POA engines;
  3. kernels: K1 front_half and K2 class_analysis against their plain
     PyTorch versions on the card, exact, with CUDA-event times beside the
     plain versions', the sorts' (one pass, and two passes for two-limb
     keys) and each kernel's roofline bound; K1 on ten full-size input sets
     (2^24 random positions at k=15, 25, 31 and, two limbs, 33, 45, 61, the
     strains workload's positions, an N every other position at k=25 and
     61, random bytes as codes), K2 on ten full-size row sets (k=25
     random, poly-A stress, one class, all distinct, the strains workload's
     own rows; two limbs: k=33 and 61 random, the k=33 classes with hi
     equal throughout and with lo equal throughout, poly-A stress at
     k=45), each launched twice in a row;
  4. POA kernel: K3 poa_dp_tb against its plain version on eight seeded
     buckets (unbanded, banded, tie-heavy, a far predecessor, seven
     predecessor slots, an odd window of 4097, a window of 8192, a window
     of 16384 that runs in two chunks; tests/torch_cases.py's generators),
     exact, with times, the split into pre-pass, DP and traceback, the
     bound and the chain floor; three of them again cut into small chunks;
  5. small graphs: build_junctions on the card against the brute-force
     oracle on the graph tests' fixture shapes, k 3 to 61;
  6. goldens: the CLI with -n on examples/ (k=15) and on the regenerated
     reference-scale examples/large pair (k=25), byte-equal to the committed
     GFFs, and on examples/large at k=33 (two-limb keys), whose GFF's
     SHA-256 must be the JAX package's (LARGE_K33_GFF_SHA); each large run
     is a main-path run whose K1, K2 and K3 launches count (K3: none, the
     runs stop before the alignment);
  7. golden MAFs: the CLI without -n on examples/ with the native and the
     device POA engine, both byte-equal to the committed MAF; the device run
     is the main-path run whose K1, K2 and K3 launches count, and K3 is
     then held against its plain version on that run's own dispatch;
  8. examples/large alignment at the CLI's budget: the device engine's MSAs
     against the native engine's on every block of the large pair, and K3
     against its plain version on the run's largest dispatch;
  9. timed pass: the CLI on the 16 x 1 Mbp strain workload (k=15, twice;
     then once at k=33), with the graph stage's steps, LCB and total
     seconds, input Mbp/s and the peak device bytes per position;
 10. streamed graph stage: (a) K4 round_append against its plain version,
     exact, on hand-laid chunks (tests/torch_cases.py's round_rows, every
     kind, one and two limbs, G 1, 8 and 64) and on
     K1's outputs for 2^22-position chunks (one and two limbs; G = 1 and 8
     of 8, and the main paths' shapes at their plans' caps: G = 2 of 8 and
     4 of 4), with times and bounds; (b) examples/large through the pipeline
     at a budget that cuts it into 8 rounds, 2 a pass, at k=25 and k=33,
     each GFF held to its golden, the peak to the budget and one round's
     epilogue to its per-row constant; (c) the CLI with -k 33 -n -f 1 on
     the strains, whose 1 GB budget routes them to the streamed stage: the
     GFF equal to phase 9's k=33 GFF; (d) full size through
     construct.build_junctions: 2 x 512 Mbp at k=25 streamed (a budget of
     4 passes) against monolithic, and 2 x 1.1 Gbp at k=25 (2.2e9
     positions, past 2^31), which routes to the streamed stage by itself,
     each with its stage seconds, passes, rounds, junctions and peak bytes
     per position; (e) past 2^32 positions: examples/large's eight
     chromosomes, one of 2^32 N and the eight again (4.32e9 positions)
     through construct.build_junctions, which routes them to the resident
     rounds, both copies' records equal to the monolithic records of
     examples/large alone (the ids keep their ranks: every class's first
     occurrence stays in the first copy) and the filler's empty, with the
     host's available memory; (f) a class that outgrows every round:
     examples/large and a 24 Mbp (CATTC)n array at k=25, through the
     resident rounds from 8 rounds, which overflow up to 512 and hand over
     to the host-bucketed rounds, and through the host-bucketed rounds
     alone at 512 (K4 not launched), both equal to the monolithic records;
 11. the host LCB oracle engine, the bundle list and the tools: (a) the CLI
     with --lcb-engine oracle -n on examples/ (k=15), byte-equal to the
     golden GFF, a main-path run whose K1 and K2 launches count, with the
     lcb_engine seconds; (b) on examples/ (k=15) and examples/large (k=25),
     make_bundles_device's list with its sort on the card equal to its CPU
     run's and to LcbEngine.make_bundles, field by field and in order, the
     rows sorted, the sort's ms and each route's seconds, and on examples/
     LcbEngine.run on the card's list giving the golden GFF; (c) the tools
     on phase 7's MAF: maf2gfa then glue giving the input genomes, maf2xmfa
     one section per block, synteny -b 5000 on examples/' GFF writing its
     files;
 12. the sharded graph stage (parallel/sharded.py, parallel/multihost.py):
     examples/large at k=25 and 33, the strains at k=15 and 2 x 256 Mbp at
     k=25, each through 4 in-process shards on cuda:0 and through an NCCL
     group of world size 1 (the card's machine has one card: no traffic
     between cards runs), records equal to the monolithic stage's of the
     same run, the peak within the memory guard's bound, the stage seconds
     beside the monolithic stage's; the examples/large GFFs through the
     native LCB engine from the sharded records equal to the goldens; the
     device POA engine with each dispatch spread over ["cuda:0",
     "cuda:0"] on examples/' blocks, MSAs equal to its one-device run's and
     the native engine's.  `--sharded` runs phases 1, 2 and 12 alone;
 13. the fused LCB engine (lcb/fused.py): (a) the CLI with --lcb-engine
     tpu-fused -n on examples/ (k=15), byte-equal to the golden GFF, a
     main-path run whose K1 and K2 launches count (once each) and whose
     lanes step in K7 alone (one launch a run, no K5 or K6 launch, one
     read a run, one K8 launch a run seeding it), with its lcb_engine
     seconds beside the native engine's, its runs, outer steps, reads a
     run and counters; (b) examples/' first phase (256 bundles)
     on the card equal to the same on the CPU and to eng.process, bundle by
     bundle; (c) examples/large at k=25, its first four phases (1,024
     bundles) on the card through LcbEngine.run's commit loop, each bundle
     equal to eng.process, with the seconds of each phase and the
     extrapolated full run.  `--fused` runs phases 1, 2 and 13 alone;
 14. the fused lanes over a device list, the dry run and entry(): (a)
     examples/' first phase with the lanes over ["cuda:0", "cuda:0"]
     beside the one-device run, both equal to eng.process, bundle by
     bundle, with each run's seconds and counters; (b) the dry run on
     cuda:0,cuda:0 (sharded graph stage, the LCB protocol with the fused
     lanes over both at phase_size 32 and 256, the POA spread), every
     stage passing, with its seconds: a main-path run whose launches
     count; (c) entry() on the card equal to its CPU run, a main path of
     one K1 and one K2 launch, and junction_analysis on the strains at
     k=15 and 33 equal to build_junctions' records.  `--dryrun` runs
     phases 1, 2 and 14 alone;
 15. the resident LCB engine (lcb/resident.py) and device_trace: (a) the
     CLI with --lcb-engine tpu -n on examples/ (k=15), byte-equal to the
     golden GFF, a main-path run whose K1 and K2 launches count (once
     each), with its lcb_engine seconds beside the native engine's and
     phase 13a's tpu-fused seconds, its rounds, host syncs per round and
     counters; (b) examples/' first phase (256 bundles) on the card through
     process_phase_resident, equal to eng.process and to
     process_phase_fused (13b's run, where phase 13 ran), bundle by
     bundle, then (under `--resident`) once
     more inside utils/metrics.device_trace: the device time summed from
     the profiler's events against the wall time, the card's busy share of
     one LCB phase; (c) build_junctions on examples/large at k=25
     inside device_trace, K1's and K2's device time from key_averages()
     and the card's busy share from the profiler's events (CUDA events,
     said on a line of its own, where the profiler shows no device time
     for K1 or K2), records equal to the untraced run's.  `--resident` runs
     phases 1, 2 and 15 alone;
 16. K5 lcb_walk (lcb/kernels.py), which phase 15 ran end to end (its
     lcb_walk launches printed): examples/' first phase through the fused
     engine (by the host loop, K6 and K5 a step: HostLoopRoute) and the
     resident engine with K5's calls recorded, the calls with the
     most pushes and the longest rows of each engine and slab width
     replayed through K5 and its plain version on the card, then the stress
     set (a repeat of 300 copies, walks cut at 2 pushes, lanes outgrowing a
     64-instance slab mid-walk, sentinel rows and lane L-1 in each): every
     output exact, the state walked in place with no allocation but the
     results, the kernel's card time (each launch from the restored state)
     beside the whole call, the plain version, the bound and the chain
     floors of this step and of the first design's; the walk blocks an SM
     holds.  `--walk` runs phases 1, 2 and 16 alone;
 17. K6 lcb_vote (lcb/kernels.py), which phase 15 ran end to end (its
     lcb_vote launches printed and held to the engine's vote calls):
     examples/' first phase through the fused engine (by the host loop)
     and the resident engine with K6's calls recorded,
     the heaviest of each engine and tier replayed through K6 and its plain
     version on the card, then the stress set (tests/torch_cases.py's
     VOTE_CASES, each without and with the used-retry; the spill cases'
     valid rows through the workspace, 16 of them taking its 8 slices in
     turn, and again with one slice; no other row): every output exact,
     the kernel's card time, the whole call, the plain version, the bound;
     the wrappers' host costs (K5's and K6's, queueing and synchronised,
     the tables checked every call and once a DeviceTables object), and
     K6's chain floor (one vote of one window round, the "vote" probe).
     `--vote` runs phases 1, 2 and 17 alone;
 18. K7 lcb_step (lcb/kernels.py), which phases 13 and 14 ran end to end
     (their lcb_step launches held to the runs): examples/' first phase
     through the fused engine with K7's calls recorded, each run (every
     tier) held to the host loop on the card from the same carry (K6 and
     K5 a step) and the heaviest to the plain version on the CPU, then
     tests/torch_cases.py's STEP_CASES (a spilling vote, a vote cap
     overflow, a slab overflow, walks of many chunks, a step limit)
     against the plain version: every tensor of the carry and the lanes'
     counts exact; the kernel's card time (each launch from the restored
     carry) and the whole call, the host loop's and the plain version's
     time, the bound and the chain floor (the longest lane's occurrence
     steps and outer steps over the "warp" and "vote" probes); the step
     blocks an SM in both shared-memory layouts.  `--step [OLDER_DIR]`
     runs phases 1, 2 and 18 alone, and adds the split of a step: the
     stamped build's K7 (csrc/step_stamps.cuh) on both runs, exact, with the
     longest lane's parts in microseconds a step; and, where OLDER_DIR holds
     an older K7's sources (lcb_step.cu, lcb_vote.cu and the three headers
     of the same C interface), that K7 built apart and timed beside this one
     on both runs, in turns.
`--seed` runs phases 1 and 2, then K8 lcb_seed (lcb/kernels.py) on
examples/large's first phase (k=25, 256 lanes) at the fused engine's two
slab widths (IC 64, PC 128 and IC 512, PC 1024): equal to its plain version
on the card, exact; its card time alone (CUDA events over many launches
into buffers that together pass the L2 cache, the card spun ahead), its
bound (bytes) and its share of it; the host wall of the seeding it
replaced (the ops, the overflow read, the active flags' upload, seed_state
and init_carry, synchronised) and of K8's copy, launch and wrapper (to its
return, and synchronised).
The last two lines are a JSON summary of the kernels (time, plain time,
bound, launches per main path; K1's and K2's "ms" are their one-limb
instances' and "by_limbs" holds both instances'; K4's "ms" is its shape on
the examples/large streamed passes, named in "shape", and "by_shape" holds
its eight timed shapes; K5's is the recorded call with the longest row,
named in "call"; K6's the recorded call with the largest bound, named in
"call", with the host costs in "host_ms" and its chain floor; K7's the
heaviest run of examples/' first phase, named in "call", with its whole
call, host loop and chain floor) and {"ok": true, "device":
{...}}.  It
imports neither jax nor sibeliaz_tpu.
"""

import contextlib
import ctypes
import functools
import gc
import hashlib
import io
import json
import os
import re
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
# SHA-256 of the JAX package's blocks_coords.gff at k=33 on examples/large
# (5,262 blocks): `python -m sibeliaz_tpu -k 33 -n -o OUT
# examples/large/genome1.fa examples/large/genome2.fa` after
# examples/large/make_large_example.py, on the CPU backend
LARGE_K33_GFF_SHA = "a5e711b8685569b9322b15e0e964ba578b86df6fd96619adf92204ca50120f08"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# the graph stage's measured peaks on examples/large (k=25, and k=33 with
# two-limb keys); not to rise
PEAK_B_PER_POSITION = 52.2
PEAK_B_PER_POSITION_WIDE = 68.2
SMS, INT32_LANES_PER_SM = 132, 64  # H100 SXM: 64 int32 lanes on each of 132 SMs
# What K4's function needs per row: the round hash (a 64-bit multiply as
# three 32-bit multiply-adds; two limbs: two and an XOR), its shift and
# mask (2), the modulo by n_rounds (about 12 as a multiply by the inverse
# and a correction) and the keep test (4); per kept row: its rank among its
# round's rows (a match and a population count, 4) and the payload (3).
K4_OPS_PER_ROW = 21
K4_OPS_PER_ROW_WIDE = 29
K4_OPS_PER_KEPT_ROW = 7
# clocks the card spins before K4's timed calls (cuda_ms's `ahead`): ~10 ms
AHEAD_CYCLES = 20_000_000
# the full-size pairs of phase 10d: bases per copy
PAIR_512M, PAIR_1100M = 512_000_000, 1_100_000_000
# phase 10e: the all-N chromosome between the two copies of examples/large
FILLER_N = 1 << 32
# phase 10f: the satellite array after examples/large, (CATTC)n like the
# human satellite III, and the round count its resident rounds start from
SATELLITE_UNIT, SATELLITE_BP, SATELLITE_ROUNDS = b"CATTC", 24_000_000, 8


# phase 12: the shards of the in-process sharded runs (all on cuda:0), the
# chromosome-scale pair's bases per copy, and its seed
SHARDS, PAIR_256M, PAIR_256M_SEED = 4, 256_000_000, 12


# phase 13c: the phases of examples/large run on the card
FUSED_LARGE_PHASES = 4


# the graph kernels of the monolithic stage's path (K4 runs on the streamed
# stage's alone)
MONOLITHIC_KERNELS = ("front_half", "class_analysis")


# phase 16: the recorded K5 calls kept per (engine, slab width) and
# criterion (the most pushes, the longest row's occurrence steps), and the
# most replayed; the lanes of the stress set's cases and its repeat's copies
WALK_KEEP, WALK_REPLAY_MAX, WALK_LANES, WALK_REPEAT_COPIES = 8, 64, 32, 300
# What K5's function reads besides the lane slabs, bytes: a push's edge and
# occurrence range (junction ids, positions and sequence offsets twice each,
# occurrence offsets twice, a sequence byte); an occurrence step's
# (occurrence, chromosome offsets, junction ids four times, used prefix
# twice, positions up to five times, chromosome length, sequence offsets
# twice, two sequence bytes, a used flag); a live good instance's score
# terms each push (a chromosome offset, two positions). A lane slab row:
# nine int64 and two bool instance fields a column, pvid and pdist a path
# column, nine registers.
K5_PUSH_BYTES, K5_STEP_BYTES, K5_SCORE_BYTES = 73, 147, 24
K5_INSTANCE_BYTES, K5_PATH_BYTES, K5_REGISTER_BYTES = 74, 16, 72
# its operations: an occurrence step's two binary searches (<= 21 probes
# of ~4 operations) and ~60 compares and selects; a score term's ~12
K5_OPS_PER_STEP, K5_OPS_PER_SCORE_TERM = 150, 12
# per row: the arguments in (five int64, three bools), the results out (ten int64)
K5_ROW_BYTES = 5 * 8 + 3 + 10 * 8
# per walking row, each way: its best score (int64) and snapshot flag (bool)
K5_BEST_BYTES = 8 + 1


# phase 17: the recorded K6 calls kept per (engine, CAP, W).  What K6's
# function moves, bytes: a row's arguments (idx and three bools) and six
# int64 outputs; a valid row's n, pn and rv or lv; a live column's six
# instance fields; a voting instance's chromosome offset and end junction
# id, and for one at the path end three positions and a chromosome length;
# an evaluated window slot's position, junction id and used flag; and of
# a row's pvid row, the 32-byte sectors its path searches probe.  Its
# operations: a slot's pvid search (up to ten probes of ~4) and ~30
# compares and selects; an alive entry's hash insert, ~20.
VOTE_KEEP = 4
K6_ROW_BYTES, K6_REGISTER_BYTES, K6_COLUMN_BYTES = 8 + 3 + 6 * 8, 3 * 8, 6 * 8
K6_END_BYTES, K6_WINDOW_BYTES, K6_SLOT_BYTES = 2 * 8, 4 * 8, 8 + 8 + 1
K6_OPS_PER_SLOT, K6_OPS_PER_ENTRY = 70, 20


# --seed: what K8 reads a lane (its origin's two occurrence offsets, its
# two arguments) and an occurrence in its window (the occurrence's
# chromosome and index, a chromosome offset, a junction id, a used flag and
# an annotation char), bytes; the bytes its timed launches write in all
# (their buffers, taken in turn, pass the 50 MB L2 cache)
K8_LANE_BYTES, K8_OCC_BYTES, K8_TIMED_BYTES = 2 * 8 + 2 * 8, 4 * 8 + 2, 150_000_000


# phase 18: what K7 moves besides the slabs and the tables its steps read,
# bytes: a lane's 13 registers (seven int64, six bools), in and out, and
# its eleven int64 results out (lcb_kernels.STEP_ROWS: its steps, pushes,
# occurrence steps, spill flag and the work its steps did)
K7_REGISTER_BYTES, K7_RESULT_BYTES = 7 * 8 + 6, 11 * 8


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(title):
    print(f"\n== {title} ==", flush=True)


def cuda_ms(torch, fn, reps, ahead=False, quiet=False, setup=None):
    """Mean milliseconds per call of `fn` on the card, after one warm-up.
    With `ahead`, the card first spins for AHEAD_CYCLES clocks (`ahead`
    times that where it is a number) (torch.cuda._sleep) while the host
    enqueues every call, so that the time
    is the card's alone and not the host's rate of enqueueing calls shorter
    than its own overhead; the host's microseconds a call are printed beside
    it (unless `quiet`), and a host that did not finish its enqueueing
    within the spin fails the check.  With `setup`, each call is preceded
    by setup() outside its own pair of events (say, restoring what the
    call writes in place), and the calls' times are summed."""
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps if setup else 1)]
    spin = torch.cuda.Event(enable_timing=True)
    if ahead:
        spin.record()
        torch.cuda._sleep(AHEAD_CYCLES * int(ahead))
    t0 = time.perf_counter()
    if setup:
        for start, end in pairs:
            setup()
            start.record()
            fn()
            end.record()
    else:
        pairs[0][0].record()
        for _ in range(reps):
            fn()
        pairs[0][1].record()
    host = time.perf_counter() - t0
    pairs[-1][1].synchronize()
    if ahead:
        spun = spin.elapsed_time(pairs[0][0])
        check(host * 1e3 < spun, f"the host took {host * 1e3:.3f} ms to enqueue {reps} calls, "
                                 f"longer than the card's spin of {spun:.3f} ms")
        if not quiet:
            print(f"  (host {host / reps * 1e6:.1f} us a call, card spun {spun:.3f} ms ahead)")
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


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


# What K1's function needs per position, whatever k: a window's 2k bits lie
# side by side in the packed stream, so the forward code is a funnel shift
# of two 64-bit words and a mask (8 32-bit operations), the reverse
# complement its complement with the bit pairs reversed (two bit reversals,
# a pair swap and a shift, 10), the canonical choice a 64-bit compare and
# select (4), validity a funnel shift and a population count of the validity
# map (4), the extension and boundary bits 4.  This is the function's need,
# not the kernel's instruction count: front_half.cu takes each window that
# way, with no step per base, plus the staging and masking it needs.
K1_OPS_PER_POSITION = 30
# Two limbs (k >= 32): each limb of fwd and of rc is its own funnel shift and
# mask (16) or bit-pair reversal (10 each, two), the canonical choice a
# two-limb compare and two selects (8), validity two runs (8), the
# extension and boundary bits 4: about 60, still far below the bytes.
K1_OPS_PER_POSITION_WIDE = 60


def bound_ms(nbytes, ops, peak_ops):
    """The roofline bound: the larger of bytes over the card's memory rate
    and operations over its peak rate; (ms, which)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=1)
def strains_codes(alphabet, fasta):
    """The strains workload's chromosomes joined with one N, encoded: the
    positions the graph stage takes on the timed pass (16,000,015)."""
    sep = np.array([ord("N")], np.uint8)
    return alphabet.encode(np.concatenate(
        [x for r in bench_strains(alphabet, fasta) for x in (r.seq, sep)][:-1]))


def k1_sets(torch, dev, alphabet, construct, fasta):
    """K1's input sets, each at full size: 2^24 random positions with 2,000
    N runs at k = 15, 25 and 31 and, two limbs, 33, 45 and 61; the strains
    workload's joined positions at k=15; an N every other position (k=25
    and 61); random bytes as codes2 (code bits set under N) over the k=25
    set's validity map.  {label: (codes2, nmask, n, k)} on the card."""
    n = 1 << 24
    rng = np.random.default_rng(1)

    def up(codes):
        pk_h, nm_h = construct.pack_codes_host(codes)
        return torch.from_numpy(pk_h).to(dev), torch.from_numpy(nm_h).to(dev)

    sets = {}
    for k in (15, 25, 31, 33, 45, 61):
        codes = rng.integers(0, 4, size=n).astype(np.uint8)
        for lo in rng.integers(0, n, size=2000):
            codes[lo : lo + int(rng.integers(1, 500))] = alphabet.BAD_CODE
        sets[f"k={k} random"] = (*up(codes), n, k)
    joined = strains_codes(alphabet, fasta)
    sets["strains k=15"] = (*up(joined), len(joined), 15)
    dense = rng.integers(0, 4, size=n).astype(np.uint8)
    dense[1::2] = alphabet.BAD_CODE
    sets["N every other k=25"] = (*up(dense), n, 25)
    sets["N every other k=61"] = (*sets["N every other k=25"][:2], n, 61)
    garbage = torch.from_numpy(rng.integers(0, 256, size=n // 4).astype(np.uint8)).to(dev)
    sets["random bytes k=25"] = (garbage, sets["k=25 random"][1], n, 25)
    return sets


def k1_vs_plain(torch, kernels, sets, peak_ops):
    """K1 against its plain version on each input set, launched twice in a
    row, exact, with its time, the plain version's, its bound (the packed
    codes and the validity map in, one or two int64 key limbs and an int32
    word out per position, each once, against K1_OPS_PER_POSITION(_WIDE)
    operations) and the time the card takes to write those outputs alone
    (torch's fill of tensors of their size).  A copy of this script put into an older
    checkout times that checkout's kernel on the same inputs.  Returns
    {label: dict of err, ms, plain_ms, bound_ms, bound_by}."""
    out = {}
    for label, (codes2, nmask, n, k) in sets.items():
        want = kernels.front_half_plain(codes2, nmask, n, k)
        want = (*want[0], want[1])
        limbs = 1 if k <= kernels.ONE_LIMB_MAX_K else 2
        check(len(want) == limbs + 1, f"front_half_plain gave {len(want) - 1} limbs ({label})")
        err = 0
        for _twice in range(2):
            got = kernels.front_half(codes2, nmask, n, k)
            got = (*got[0], got[1])
            torch.cuda.synchronize()
            check(len(got) == len(want), f"front_half gave {len(got) - 1} limbs ({label})")
            err = max(err, *(int((a - b).abs().max()) for a, b in zip(got, want)))
        check(err == 0, f"front_half differs from its plain version ({label})")
        ms = cuda_ms(torch, lambda: kernels.front_half(codes2, nmask, n, k), 20)
        plain_ms = cuda_ms(torch, lambda: kernels.front_half_plain(codes2, nmask, n, k), 3)
        fill_ms = cuda_ms(torch, lambda: [t.fill_(1) for t in got], 20)
        ops = K1_OPS_PER_POSITION if limbs == 1 else K1_OPS_PER_POSITION_WIDE
        bound, by = bound_ms(-(-n // 4) + -(-n // 8) + (8 * limbs + 4) * n, ops * n, peak_ops)
        print(f"front_half {label}: equal, {limbs} key limb(s), {n} positions, "
              f"{int((want[0] != kernels.INVALID_CANON).sum())} valid windows | "
              f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound:.4f} ms by {by} "
              f"= {100 * bound / ms:.4f}% of the kernel's time | outputs' fill alone "
              f"{fill_ms:.4f} ms")
        out[label] = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by}
        del want, got
    return out


def compare_kernels(torch, dev, alphabet, construct, kernels, fasta, peak_ops):
    """Phase 3's K1 part: K1 equal to its plain version on its ten input
    sets, and the graph stage's sort of the k=25 set's keys (one stable
    pass) and of the k=33 set's (two stable passes, construct.sort_keys).
    Returns k1_vs_plain's results."""
    sets = k1_sets(torch, dev, alphabet, construct, fasta)
    k1 = k1_vs_plain(torch, kernels, sets, peak_ops)
    for k in (25, 33):
        codes2, nmask, n, _k = sets[f"k={k} random"]
        keys = kernels.front_half(codes2, nmask, n, k)[0]
        sort_ms = cuda_ms(torch, lambda: construct.sort_keys(list(keys)), 10)
        print(f"graph sort of 2^24 keys at k={k}: {len(keys)} stable torch.sort pass(es) "
              f"{sort_ms:.4f} ms")
    return k1


def sorted_rows(torch, construct, keys, packed):
    """K2's input: the rows sorted by key (stable, lexicographic over the
    limbs), as the graph stage has them."""
    keys_s, order = construct.sort_keys(list(keys))
    return keys_s, packed[order], order.to(torch.int32)


def k2_row_sets(torch, dev, alphabet, construct, kernels, fasta):
    """K2's row sets, each at full size: k=25 rows of 2^24 random positions
    with N runs; the poly-A stress (one class of ~10^6 rows, spanning
    hundreds of tiles, and a poly-C and an N stretch); the first set's words
    and positions as one class and as 2^24 distinct keys; the strains
    workload's own rows (16 x 1 Mbp joined with N, k=15); and with two-limb
    keys: the random positions' rows at k=33 and 61, the k=33 rows' classes
    keyed with hi equal throughout (classes split on lo alone) and with lo
    equal throughout (on hi alone), and the poly-A stress at k=45.
    {label: rows}."""
    n = 1 << 24
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for lo in rng.integers(0, n, size=2000):
        codes[lo : lo + int(rng.integers(1, 500))] = alphabet.BAD_CODE
    poly = rng.integers(0, 4, size=n).astype(np.uint8)
    poly[1000 : 1000 + 1_000_000] = 0  # poly-A: one class of ~10^6 rows
    poly[5_000_000 : 5_000_000 + 100_000] = 1  # poly-C
    poly[9_000_000 : 9_000_000 + 300_000] = alphabet.BAD_CODE
    joined = strains_codes(alphabet, fasta)

    def rows_of(c, k):
        pk_h, nm_h = construct.pack_codes_host(c)
        keys, packed = kernels.front_half(torch.from_numpy(pk_h).to(dev),
                                          torch.from_numpy(nm_h).to(dev), len(c), k)
        return sorted_rows(torch, construct, keys, packed)

    sets = {"k=25 random": rows_of(codes, 25), "poly-A stress": rows_of(poly, 25)}
    _keys_s, packed_s, pos_s = sets["k=25 random"]
    sets["one class"] = ((torch.zeros(n, dtype=torch.int64, device=dev),), packed_s, pos_s)
    sets["all distinct"] = ((torch.arange(n, dtype=torch.int64, device=dev),), packed_s, pos_s)
    sets["strains k=15"] = rows_of(joined, 15)
    sets["k=33 random"] = rows_of(codes, 33)
    sets["k=61 random"] = rows_of(codes, 61)
    (hi_s, lo_s), packed_s, pos_s = sets["k=33 random"]
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    cls = torch.cumsum(start, 0) - 1  # each row's class, dense
    zero = torch.zeros_like(cls)
    sets["k=33 classes, hi equal"] = ((zero, cls), packed_s, pos_s)
    sets["k=33 classes, lo equal"] = ((cls, zero), packed_s, pos_s)
    sets["poly-A stress k=45"] = rows_of(poly, 45)
    return sets


def k2_vs_plain(torch, kernels, sets, peak_ops):
    """K2 against its plain version on each row set, launched twice in a row,
    exact, with its time, the plain version's and its bound (21 B per row:
    key 8 + word 4 + position 4 in, flag 1 + first 4 out, each once; 29 B
    with a second key limb).  A
    copy of this script put into an older checkout times that checkout's
    kernel on the same rows.  Returns {label: dict of err, ms, plain_ms,
    bound_ms, bound_by}."""
    out = {}
    for label, rows in sets.items():
        n, limbs = rows[1].shape[0], len(rows[0])
        want = kernels.class_analysis_plain(*rows)
        err = 0
        for _twice in range(2):
            got = kernels.class_analysis(*rows)
            torch.cuda.synchronize()
            err = max(err, int((got[0].int() - want[0].int()).abs().max()),
                      int((got[1] - want[1]).abs().max()))
        check(err == 0, f"class_analysis differs from its plain version ({label})")
        ms = cuda_ms(torch, lambda: kernels.class_analysis(*rows), 20)
        plain_ms = cuda_ms(torch, lambda: kernels.class_analysis_plain(*rows), 3)
        bound, by = bound_ms((13 + 8 * limbs) * n, 0, peak_ops)
        print(f"class_analysis {label}: equal, {limbs} key limb(s), {n} rows, "
              f"{int(want[0].sum())} junction rows | "
              f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound:.4f} ms by {by} "
              f"= {100 * bound / ms:.4f}% of the kernel's time")
        out[label] = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by}
    return out


def poa_blocks(cases, kind, rng):
    """Seeded POA blocks of one K3 bucket: (blocks, planner keywords)."""
    if kind == "unbanded":  # L = 1024, full-width windows
        return [cases.rand_block(rng, int(rng.integers(700, 1000)), 3, mut=0.05)
                for _ in range(16)], {"band": False}
    if kind == "banded":  # L = 4096, banded windows
        return [cases.rand_block(rng, int(rng.integers(3000, 4000)), 3, mut=0.03)
                for _ in range(8)], {"band_min": 64}
    if kind == "tie_heavy":  # low complexity, L = 4096: ties everywhere
        return [cases.tie_heavy_block(rng, 300) for _ in range(8)], {"band_min": 64}
    if kind in ("wide", "wider"):
        # B 1, unbanded, each from its own seed: L = W = 8192, eight columns
        # per thread; L = W = 16384, two chunks of 8192 columns
        n = 8100 if kind == "wide" else 8300
        return [cases.rand_block(np.random.default_rng(n), n, 2, mut=0.03)], {"band": False}
    # far_pred (a predecessor 2,400 ranks back), many_preds (seven slots),
    # odd_w (B 1, W = L + 1 = 4097, few ranks): tests/torch_cases.py's cases
    blocks, band_min = cases.poa_case(kind, 16 if kind == "odd_w" else 8)
    return blocks, {"band_min": band_min}


K3_BUCKETS = ("unbanded", "banded", "tie_heavy", "far_pred", "many_preds", "odd_w", "wide",
              "wider")


def k3_work(torch, align_kernels, args):
    """What one K3 dispatch has to do: (ranks in use per block, cells,
    32-bit integer operations, bytes).  Cells are ranks in use x W; a cell
    costs 4 operations per valid predecessor slot (two window compares, two
    steps of the running first arg-max) and 12 more (substitution compare
    and select, diagonal add, gap add, match compare and select, three scan
    steps, insertion compare, two direction-byte selects); bytes are the
    seven inputs and the four outputs once each (H and dirs are scratch)."""
    seq0p, seq_len, node_char, pred_idx, pred_ok, sink_mask, n_max, W, P, off = args
    B = seq0p.shape[0]
    used = align_kernels._ranks_used(pred_ok)
    in_use = torch.arange(n_max, device=used.device)[None, :] < used[:, None]
    slots = int((pred_ok.sum(dim=2) * in_use).sum())
    ranks = int(used.sum())
    ops = W * (4 * slots + 12 * ranks)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (seq0p, seq_len, node_char, pred_idx, pred_ok, sink_mask, off))
    nbytes += 2 * B * P * 4 + 2 * B * 4
    return used, ranks * W, ops, nbytes


def ring_hit_share(torch, align_kernels, args, depth):
    """Share of the dispatch's predecessor-row reads (ranks in use, real
    predecessors) that lie at most `depth` ranks back: what K3's
    shared-memory ring of that depth serves."""
    pred_idx, pred_ok, n_max = args[3], args[4], args[6]
    used = align_kernels._ranks_used(pred_ok)
    ranks = torch.arange(n_max, device=used.device)
    real = pred_ok & (pred_idx < n_max) & (ranks[None, :] < used[:, None])[:, :, None]
    back = ranks[None, :, None] - pred_idx
    return float((real & (back <= depth)).sum()) / max(1, int(real.sum()))


def k3_sweep(torch, align_kernels, args, want):
    """K3 at every number of columns per thread that fits the dispatch's
    window, and at the chosen one with the ring off and at 1 and 4 rows,
    each exact against `want`: one line per launch shape."""
    W = args[7]
    chosen = align_kernels.launch_config(W)
    shapes = [align_kernels.launch_config(W, cols) for cols in (1, 2, 4, 8)
              if W <= cols * align_kernels.MAX_THREADS]
    if chosen["depth"] > 0:  # the ring off, and at other depths
        shapes += [{**chosen, "depth": depth} for depth in (0, 1, 4)]
    for cfg in shapes:
        for _warm_then_timed in range(2):
            parts = []
            got = align_kernels.poa_dp_tb(*args, split_ms=parts, config=cfg)
        same = all(bool((a == b).all()) for a, b in zip(got, want))
        check(same, f"poa_dp_tb differs from its plain version at {cfg}")
        print(f"  sweep {cfg}: equal | pre-pass {parts[0]:.4f} | DP {parts[1]:.4f} | "
              f"traceback {parts[2]:.4f} ms")


def k3_vs_plain(torch, align_kernels, args, label, peak_ops, want=None, reps=3):
    """K3 against its plain version on one dispatch's arguments, exact
    (`want`: the plain version's outputs where they were kept from an
    earlier run), with its time, its parts, its bound and its chain floor;
    returns a dict with the max abs error, the kernel's ms, the plain ms
    (None with `want`) and the bound."""
    check(args is not None, f"no K3 dispatch to check ({label})")
    seq0p, n_max, W = args[0], args[6], args[7]
    got = align_kernels.poa_dp_tb(*args)
    torch.cuda.synchronize()
    plain_ms = None
    if want is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = align_kernels.poa_dp_tb_plain(*args)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    check(err == 0, f"poa_dp_tb differs from its plain version ({label})")
    ms = cuda_ms(torch, lambda: align_kernels.poa_dp_tb(*args), reps)
    parts = []
    align_kernels.poa_dp_tb(*args, split_ms=parts)
    used, cells, ops, nbytes = k3_work(torch, align_kernels, args)
    bound, by = bound_ms(nbytes, ops, peak_ops)
    cfg = align_kernels.launch_config(W)
    ranks, steps = int(used.max()), int(want[2].max())
    share = ring_hit_share(torch, align_kernels, args, cfg["depth"])
    plain = "kept from the recording" if plain_ms is None else f"{plain_ms:.4f} ms"
    print(f"poa_dp_tb {label}: equal | B {seq0p.shape[0]} L {seq0p.shape[1] - 1 - W} "
          f"n_max {n_max} W {W} {cfg} ranks used {ranks} | kernel {ms:.4f} ms | plain {plain}")
    print(f"  parts: pre-pass {parts[0]:.4f} ms | DP {parts[1]:.4f} ms = "
          f"{parts[1] * 1e3 / ranks:.4f} us per rank in use | traceback {parts[2]:.4f} ms = "
          f"{parts[2] * 1e3 / max(1, steps):.4f} us per step ({steps} steps) | whole "
          f"{ms * 1e3 / ranks:.4f} us per rank | ring depth {cfg['depth']} serves "
          f"{100 * share:.4f}% of predecessor reads")
    print(f"  bound {bound:.4f} ms by {by} ({cells} cells, {ops} int32 operations, "
          f"{nbytes} bytes) = {100 * bound / ms:.4f}% of the kernel's time")
    step_us = cuda_ms(torch, lambda: align_kernels.chain_probe(cfg["threads"], 20000), 3) / 20
    print(f"  chain floor {ranks * step_us / 1e3:.4f} ms = {ranks} ranks x {step_us:.4f} us (one "
          f"shared-memory round trip and one barrier of {cfg['threads']} threads) = "
          f"{100 * ranks * step_us / 1e3 / ms:.4f}% of the kernel's time")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def bucket_args(torch, dev, cases, device_poa, poa_ref, kind, rng):
    """K3's arguments on the card for one seeded bucket: each block's last
    copy aligned to the graph of the others, assembled by the engine's own
    device_poa.assemble_round."""
    blocks, plan_kw = poa_blocks(cases, kind, rng)
    plan = functools.partial(device_poa._plan_windows, **plan_kw)
    arrays, n_max, W, P, s0s = cases.poa_round(
        blocks, poa_ref.PoaGraph, device_poa._extract_arrays, plan)
    banded = sum(s is not None for s in s0s)
    if kind in ("unbanded", "banded", "odd_w", "wide", "wider"):
        check(banded == (len(blocks) if kind == "banded" else 0),
              f"{kind}: {banded} of {len(blocks)} blocks banded")
    if kind in ("wide", "wider"):
        check(W == (8192 if kind == "wide" else 16384), f"{kind}: W {W}")
    if kind == "odd_w":
        check(W % 2 == 1 and len(blocks) == 1, f"odd_w: W {W}, B {len(blocks)}")
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    return (*t[:6], n_max, W, P, t[6])


def compare_poa(torch, dev, cases, device_poa, poa_ref, align_kernels, peak_ops,
                kinds=K3_BUCKETS, sweep=False):
    """Phase 4: K3 against its plain version on the seeded buckets; returns
    the max abs error.  With `sweep`, each bucket also runs at the other
    launch shapes."""
    rng = np.random.default_rng(21)
    err = 0
    for kind in kinds:
        args = bucket_args(torch, dev, cases, device_poa, poa_ref, kind, rng)
        if kind == "wider":
            check(align_kernels.launch_config(args[7])["depth"] == 0,
                  "wider: the window does not run in chunks")
        err = max(err, k3_vs_plain(torch, align_kernels, args, kind, peak_ops)["err"])
        if kind in ("tie_heavy", "many_preds", "odd_w"):
            # the same bucket with the window cut into chunks of 96 columns
            chunked = {"cols": 1, "threads": 96, "depth": 0}
            want = align_kernels.poa_dp_tb(*args)
            got = align_kernels.poa_dp_tb(*args, config=chunked)
            check(all(bool((a == b).all()) for a, b in zip(got, want)),
                  f"poa_dp_tb in chunks differs ({kind})")
            print(f"  in chunks {chunked}: equal")
        if sweep:
            k3_sweep(torch, align_kernels, args, align_kernels.poa_dp_tb(*args))
    return err


def k3_time(torch, dev, cases, device_poa, poa_ref, align_kernels, kinds):
    """--k3-time KIND[,KIND...]: K3's wrapper alone on seeded buckets that
    have a seed of their own (K3_BUCKETS[3:]), exact against the plain
    version, with its ms and us per rank in use.  It passes the wrapper
    its positional arguments and nothing else, so a copy of this script put
    into an older checkout times that checkout's kernel on the same inputs."""
    for kind in kinds:
        check(kind in K3_BUCKETS[3:], f"--k3-time takes {K3_BUCKETS[3:]}, not {kind!r}")
        args = bucket_args(torch, dev, cases, device_poa, poa_ref, kind, None)
        got = align_kernels.poa_dp_tb(*args)
        want = align_kernels.poa_dp_tb_plain(*args)
        check(all(bool((a == b).all()) for a, b in zip(got, want)),
              f"poa_dp_tb differs from its plain version ({kind})")
        ms = cuda_ms(torch, lambda: align_kernels.poa_dp_tb(*args), 3)
        ranks = int(align_kernels._ranks_used(args[4]).max())
        print(f"poa_dp_tb {kind}: equal | B {args[0].shape[0]} n_max {args[6]} W {args[7]} "
              f"ranks used {ranks} | kernel {ms:.4f} ms = {ms * 1e3 / ranks:.4f} us per rank")


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


def golden_mafs(torch, cli, metrics, kernels, align_kernels, out_dir):
    """Phase 7: returns the launches of K1, K2 and K3 in the device-engine
    run and the arguments of that run's K3 dispatch."""
    golden = maf_body(os.path.join(EXAMPLES, "sibeliaz_out", "alignment.maf"))
    fas = [os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")]
    launches = 0
    for engine in ("native", "tpu"):
        out = os.path.join(out_dir, engine)
        metrics.timings.clear()
        metrics.counters.clear()
        kernels.reset_launches()
        align_kernels.reset_launches()
        with LargestDispatch(align_kernels) as rec:
            wall = run_cli(cli, ["-k", "15", "--align-engine", engine, "-o", out, *fas])
        launches = {**kernels.LAUNCHES, **align_kernels.LAUNCHES}
        align_s = {t["stage"]: t["seconds"] for t in metrics.timings}["align"]
        counts = align_counts(metrics)
        check(maf_body(os.path.join(out, "alignment.maf")) == golden,
              f"examples/ MAF ({engine} engine) differs from the golden")
        if engine == "tpu":
            check(all(launches[name] > 0 for name in MONOLITHIC_KERNELS + ("poa_dp_tb",)),
                  f"a kernel was not launched on the CLI path: {launches}")
            check(counts["poa_blocks_dispatched"] == 11 and counts["poa_native_redo"] == 0
                  and counts["poa_native_routed"] == 0,
                  f"not every examples/ block went through the card: {counts}")
        print(f"examples/ --align-engine {engine}: MAF byte-equal to the golden | align "
              f"{align_s:.4f} s | CLI wall {wall:.4f} s | launches {launches} | {counts}")
    return launches, rec.args


def large_alignment(torch, large_fa, fasta, pipeline, Config, msa, metrics, kernels,
                    align_kernels, out_dir, engines=("native", "tpu")):
    """Phase 8: the POA engines on every block of examples/large (k=25) at
    the CLI's budget (no -f), MSAs compared through the MAF they write;
    returns the launches of K1 and K2 (finding the blocks) and K3 (the
    device engine's run) and the arguments of K3's largest dispatch."""
    recs = fasta.read_many(large_fa)
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    threads = os.cpu_count() or 1
    kernels.reset_launches()
    res = pipeline.find_blocks(seqs, names, Config(k=25, threads=4), device="cuda")
    graph_launches = dict(kernels.LAUNCHES)
    os.makedirs(out_dir, exist_ok=True)
    bodies = {}
    for engine in engines:
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
    if len(engines) == 2:
        check(bodies["native"] == bodies["tpu"],
              "examples/large: device-engine MSAs differ from the native engine's")
        print(f"examples/large: the device engine's MSAs equal the native engine's on all "
              f"{res.blocks_found} blocks")
    return {**graph_launches, **align_kernels.LAUNCHES}, rec.args


def run_cli(cli, argv):
    t0 = time.time()
    rc = cli.run(argv)
    check(rc == 0, f"CLI {argv} returned {rc}")
    return time.time() - t0


def print_ptxas(report):
    """One line per kernel of nvcc's -Xptxas -v report: registers, shared
    memory, stack and spills."""
    kernel = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"\d+([a-z_]+_kernel)((?:L[ib]\d+E|I)*)", mangled)
            args = re.findall(r"L[ib](\d+)E", m.group(2)) if m else []
            if m is None:
                kernel = mangled
            elif m.group(1) == "poa_dp_kernel" and len(args) == 3:
                shape = {"10": "chunked", "01": "whole", "00": "ragged"}
                kernel = f"{m.group(1)}<{args[0]}, {shape[args[1] + args[2]]}>"
            elif m.group(1) == "round_append_kernel" and len(args) == 1:
                kernel = f"{m.group(1)}<{args[0]} key limb(s)>"
            elif m.group(1) in ("class_tile_kernel", "front_half_kernel") and len(args) == 2:
                loads = {"class_tile_kernel": "16-byte", "front_half_kernel": "word"}[m.group(1)]
                kernel = (f"{m.group(1)}<{args[0]} key limb(s), "
                          f"{loads if args[1] == '1' else 'byte'} loads>")
            else:
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            spill = ""
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used" in line and kernel:
            print(f"  {kernel}: {line.split(':', 1)[1].strip()} | {spill}")
            kernel = None


def regenerate_large(alphabet, fasta, out_dir):
    """examples/large's two FASTA files, rebuilt from the seed and checked."""
    large_fa = []
    for g, recs in enumerate(build_large(alphabet, fasta), start=1):
        path = os.path.join(out_dir, f"genome{g}.fa")
        fasta.write_fasta(path, recs)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        check(digest == LARGE_SHA[f"genome{g}.fa"], f"genome{g}.fa digest {digest}")
        large_fa.append(path)
    print("examples/large inputs regenerated; SHA-256 digests match")
    return large_fa


def synth_pair(alphabet, seed, length):
    """benchmarks/run_configs.py::synth's recipe for two genomes of one
    chromosome each (chromosome-k25-1g's shape: a random ancestor, each copy
    with 1% substitutions, no inversion), drawn as uint8 with the
    substitution sites by count, so that the host holds O(length) bytes and
    no float per position."""
    rng = np.random.default_rng(seed)
    ancestor = alphabet.decode(rng.integers(0, 4, size=length, dtype=np.uint8))
    seqs = []
    for _g in range(2):
        s = ancestor.copy()
        sites = rng.integers(0, length, size=int(rng.binomial(length, 0.01)))
        s[sites] = alphabet.decode(rng.integers(0, 4, size=len(sites), dtype=np.uint8))
        seqs.append(s)
    return seqs


def round_append_vs_plain(torch, kernels, chunks, r0, n_rounds, G, cap, kernel=None):
    """K4 (or `kernel`, a function of K4's arguments) and its plain version
    over the same chunks ((keys, packed, gpos0) on the card, appended in
    turn), each into its own G x cap buffers filled with -7, one run after
    the other: the max abs difference over the buffers, cursors and flag,
    and K4's cursors.  Only the first R rows of each round (R: K4's largest
    cursor, at most cap) are kept for the comparison; a run that wrote a row
    past them fails the check (its error is the written value's distance
    from -7), so that buffers of a full-size plan's cap need not be held
    twice."""
    limbs, dev = len(chunks[0][0]), chunks[0][1].device
    runs, err = [], 0
    for fn in (kernel or kernels.round_append, kernels.round_append_plain):
        bufs = [torch.full((G, cap), -7, dtype=torch.int64, device=dev) for _ in range(limbs + 1)]
        cursors = torch.zeros(G, dtype=torch.int64, device=dev)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        for keys, packed, gpos0 in chunks:
            fn(keys, packed, gpos0, r0, n_rounds, tuple(bufs[:limbs]), bufs[limbs], cursors,
               overflow)
        torch.cuda.synchronize()
        if not runs:
            rows = min(cap, int(cursors.max()))
        for b in bufs:
            tail = b[:, rows:]
            if bool((tail != -7).any()):
                err = max(err, int((tail[tail != -7] + 7).abs().max()))
        runs.append(([b[:, :rows].clone() for b in bufs], cursors, overflow.long()))
        del bufs
    (heads_a, *rest_a), (heads_b, *rest_b) = runs
    err = max(err, *(int((a - b).abs().max()) for a, b in zip(heads_a + rest_a,
                                                                heads_b + rest_b)
                     if a.numel()))
    return err, runs[0][1]


def k4_hand_laid(torch, dev, kernels, cases):
    """K4 against its plain version on hand-laid chunks of T - 1, 3T, T + 5
    and 11T + 3 rows (T = the kernel's tile): every kind of round_rows, one
    and two limbs, one round of one, G = 8 of 8 and 64 of 100 (the kinds
    that lay a round out by tiles lay the pass's first round).  Returns the
    max abs error."""
    T = kernels.K4_TILE_ROWS
    err = 0
    for kind in cases.ROUND_ROW_KINDS:
        for limbs in (1, 2):
            for r0, n_rounds, G in ((0, 1, 1), (0, 8, 8), (30, 100, 64)):
                chunks, gpos0 = [], 1
                for c, m in enumerate((T - 1, 3 * T, T + 5, 11 * T + 3)):
                    keys, packed = cases.round_rows(kind, m, limbs, seed=c, hot=r0, tile=T)
                    chunks.append((tuple(torch.from_numpy(x).to(dev) for x in keys),
                                   torch.from_numpy(packed).to(dev), gpos0))
                    gpos0 += m
                e, _cur = round_append_vs_plain(torch, kernels, chunks, r0, n_rounds, G, gpos0)
                check(e == 0, f"round_append differs from its plain version ({kind}, "
                              f"{limbs} limb(s), G={G})")
                err = max(err, e)
    print(f"round_append on hand-laid chunks: equal ({len(cases.ROUND_ROW_KINDS)} kinds x one "
          f"and two limbs x G 1, 8, 64)")
    return err


# K4's timed shapes (r0, n_rounds, G): G=1 (round 3 of 8), G=8 of 8, G=2 of
# 8 from round 2 (the shape of examples/large's streamed passes) and G=4 of
# 4 (the 2 x 1.1 Gbp pass at one limb, the strains' -f 1 pass at two)
K4_SHAPES = ((3, 8, 1), (0, 8, 8), (2, 8, 2), (0, 4, 4))
def k4_inputs(torch, dev, alphabet, construct, kernels):
    """K4's full-size input: K1's outputs for a 2^22-position chunk of random
    codes with N runs (k=25: one limb; k=33: two), as the streamed stage
    hands them over (window offsets 1..2^22).  {limbs: (keys, packed)}."""
    m = 1 << 22
    rng = np.random.default_rng(4)
    out = {}
    for limbs, k in ((1, 25), (2, 33)):
        codes = rng.integers(0, 4, size=m + k + 2).astype(np.uint8)
        for lo in rng.integers(0, m, size=500):
            codes[lo : lo + int(rng.integers(1, 500))] = alphabet.BAD_CODE
        pk_h, nm_h = construct.pack_codes_host(codes)
        keys, packed = kernels.front_half(torch.from_numpy(pk_h).to(dev),
                                          torch.from_numpy(nm_h).to(dev), m + k + 2, k)
        out[limbs] = (tuple(x[1 : m + 1] for x in keys), packed[1 : m + 1])
    return out


def k4_bound(m, kept, limbs, peak_ops):
    """K4's bound: every row's keys read once, each kept row's word read and
    its keys and payload written once; operations: the hash, modulo and keep
    test a row, the rank and payload a kept row.  (ms, which)."""
    ops = (K4_OPS_PER_ROW if limbs == 1 else K4_OPS_PER_ROW_WIDE) * m + K4_OPS_PER_KEPT_ROW * kept
    return bound_ms(m * 8 * limbs + kept * (8 * limbs + 12), ops, peak_ops)


def k4_timing_buffers(torch, dev, G, limbs, per_launch, reps):
    """Round buffers with room for a warm-up and `reps` launches that keep at
    most `per_launch` rows a round, and zeroed cursors and flag."""
    room = int((reps + 2) * per_launch * 1.05)
    bufs = [torch.empty((G, room), dtype=torch.int64, device=dev) for _ in range(limbs + 1)]
    return bufs, torch.zeros(G, dtype=torch.int64, device=dev), \
        torch.zeros(1, dtype=torch.int32, device=dev)


def k4_full_size(torch, dev, alphabet, construct, streamed, kernels, peak_ops, ns):
    """K4 on k4_inputs' chunks in the four K4_SHAPES, G=1 and G=8 of 8 into
    buffers with room for two chunks, G=2 of 8 (examples/large's streamed
    passes) and G=4 of 4 (2 x 1.1 Gbp at one limb, the strains' -f 1 pass at
    two) each with the cap that streamed.plan gives that run (ns: its
    positions).  Exact against the plain version over two chunks in a row;
    then its time over 20 launches into buffers with room for all of them,
    the plain version's, and the bound (k4_bound).  Returns {label: dict}."""
    m = 1 << 22
    out = {}
    torch.cuda.empty_cache()
    for limbs, (keys, packed) in k4_inputs(torch, dev, alphabet, construct, kernels).items():
        k = 25 if limbs == 1 else 33
        g4_path = "2 x 1.1 Gbp" if limbs == 1 else "strains -k 33 -n -f 1"
        paths = (None, None, f"examples/large streamed k={k}", g4_path)
        for (r0, n_rounds, G), path in zip(K4_SHAPES, paths):
            label = f"{limbs} limb(s) G={G} of {n_rounds}"
            cap = 2 * m if path is None else streamed.plan(ns[path], k, 1 << 22, 1.25, None,
                                                           n_rounds).cap
            err, cursors = round_append_vs_plain(
                torch, kernels, [(keys, packed, 1), (keys, packed, 1 + m)], r0, n_rounds, G, cap)
            check(err == 0, f"round_append differs from its plain version ({label}, cap {cap})")
            kept = int(cursors.sum()) // 2
            reps = 20
            bufs, cur, ovf = k4_timing_buffers(torch, dev, G, limbs, int(cursors.max()) // 2, reps)
            ms = cuda_ms(torch, lambda: kernels.round_append(
                keys, packed, 1, r0, n_rounds, tuple(bufs[:limbs]), bufs[limbs], cur, ovf), reps,
                ahead=True)
            check(int(ovf) == 0, f"round_append timing overflowed ({label})")
            del bufs
            pbufs = [torch.empty((G, m), dtype=torch.int64, device=dev)
                     for _ in range(limbs + 1)]
            plain_ms = cuda_ms(torch, lambda: (cur.zero_(), kernels.round_append_plain(
                keys, packed, 1, r0, n_rounds, tuple(pbufs[:limbs]), pbufs[limbs], cur, ovf)), 3)
            del pbufs
            bound, by = k4_bound(m, kept, limbs, peak_ops)
            print(f"round_append {label} (round {r0} on, cap {cap}"
                  f"{'' if path is None else ': ' + path}), 2^22 rows of K1's k={k} outputs: "
                  f"equal, {kept} kept | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound "
                  f"{bound:.4f} ms by {by} = {100 * bound / ms:.4f}% of the kernel's time")
            out[label] = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": by, "kept": kept, "r0": r0, "cap": cap, "path": path}
    return out


def build_older_k4(cudabuild, kernels, out_dir, older):
    """An older version of csrc/round_append.cu (with the same C interface),
    built alone into a shared library with nvcc and bound as the port's
    library is; its -Xptxas -v report printed.  A function of K4's
    arguments that launches its kernel."""
    lib = os.path.join(out_dir, "k4_older.so")
    proc = subprocess.run([cudabuild._nvcc(), *cudabuild.NVCC_FLAGS, "-shared", "-o", lib, older],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"K4 {older} did not build:\n{proc.stderr}")
    print(f"K4 {older}:")
    print_ptxas(proc.stderr)
    bound = cudabuild.bind(ctypes.CDLL(lib), ("sz_round_scratch_bytes", "sz_round_append"))
    return functools.partial(kernels.round_append_launch, bound)


def k4_time(torch, dev, alphabet, construct, kernels, cudabuild, peak_ops, out_dir, older):
    """--k4-time [OLDER.cu]: K4's wrapper (and an older version of
    csrc/round_append.cu, where given) against the plain version, exact,
    over two of k4_inputs' chunks in a row, in the four K4_SHAPES and at
    G = 64 of 64, one and two limbs; then in each shape their times over 20
    launches, in turns: older, wrapper, wrapper, older."""
    print("K4 (the port's library):")
    print_ptxas(cudabuild.build()[1])
    fns = {"wrapper": kernels.round_append}
    if older:
        fns[f"older kernel {older}"] = build_older_k4(cudabuild, kernels, out_dir, older)
    order = [*fns][::-1] + [*fns]
    m, reps = 1 << 22, 20
    for limbs, (keys, packed) in k4_inputs(torch, dev, alphabet, construct, kernels).items():
        for r0, n_rounds, G in K4_SHAPES + ((0, 64, 64),):
            label = f"{limbs} limb(s) G={G} of {n_rounds}"
            chunks = [(keys, packed, 1), (keys, packed, 1 + m)]
            cap = min(2 * m, 4 * m // G)
            cursors = None
            for name, fn in fns.items():
                e, cur = round_append_vs_plain(torch, kernels, chunks, r0, n_rounds, G, cap,
                                               kernel=fn)
                check(e == 0, f"K4 {name} differs from the plain version ({label})")
                cursors = cur if cursors is None else cursors
            kept = int(cursors.sum()) // 2
            times = {}
            for name in order:
                fn = fns[name]
                bufs, cur, ovf = k4_timing_buffers(torch, dev, G, limbs,
                                                   int(cursors.max()) // 2, reps)
                times.setdefault(name, []).append(cuda_ms(torch, lambda: fn(
                    keys, packed, 1, r0, n_rounds, tuple(bufs[:limbs]), bufs[limbs], cur, ovf),
                    reps, ahead=True))
                check(int(ovf) == 0, f"K4 {name} timing overflowed ({label})")
                del bufs
            bound, by = k4_bound(m, kept, limbs, peak_ops)
            print(f"round_append {label} (round {r0} on), 2^22 rows, {kept} kept, every build "
                  f"equal to the plain version | bound {bound:.4f} ms by {by} | "
                  + " | ".join(f"{name} " + " / ".join(f"{t:.4f}" for t in ts) + " ms = "
                               + " / ".join(f"{100 * bound / t:.2f}" for t in ts) + "%"
                               for name, ts in times.items()))


def streamed_counts(metrics, kernels):
    """The streamed stage's passes, rounds, rounds a pass, retries and stage
    seconds, and the launches of the run."""
    c = metrics.counters
    stages = {}
    for t in metrics.timings:
        if t["stage"].startswith("graph_"):
            stages[t["stage"]] = stages.get(t["stage"], 0.0) + t["seconds"]
    return ({key: int(c.get(key, -1)) for key in ("graph_passes", "graph_rounds",
                                                  "graph_rounds_per_pass", "graph_round_retries",
                                                  "graph_host_rounds", "graph_positions",
                                                  "graph_junctions")},
            stages, dict(kernels.LAUNCHES))


def fresh_run(torch, metrics, kernels):
    """Counts and peaks to zero before a main-path run; returns the bytes
    allocated at its start."""
    metrics.timings.clear()
    metrics.counters.clear()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def all_launched(launches, label):
    check(all(launches[name] > 0 for name in ("front_half", "class_analysis", "round_append")),
          f"a kernel of the streamed stage was not launched ({label}): {launches}")


def epilogue_peak(torch, streamed, seqs, k):
    """One round's epilogue on the card (round 0 of 8, one buffer): its peak
    allocated bytes over the live rows, against the constant the plan uses."""
    n = 1 + sum(len(s) + 1 for s in seqs)
    p = streamed.plan(n, k, 1 << 22, 1.25, None, 8)
    codes2, nmask = streamed._upload(seqs, n, k, p.chunk, torch.device("cuda"))
    buf_keys, buf_payload, live, overflowed = streamed._scan_pass(codes2, nmask, n, k, p, 0, 1)
    check(not overflowed, "epilogue measurement: round 0 overflowed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    streamed._junction_rows([buf[0, : live[0]] for buf in buf_keys], buf_payload[0, : live[0]])
    per_row = (torch.cuda.max_memory_allocated() - before) / live[0]
    limit = p.epilogue_bytes
    check(per_row <= limit, f"epilogue peak {per_row:.2f} B/row at k={k}, above {limit}")
    print(f"one round's epilogue at k={k}: {live[0]} live rows, peak {per_row:.2f} B/row "
          f"(plan's constant {limit})")
    return per_row


def joined_positions(recs):
    """Positions of the streamed stage's joined genome: a leading N, one
    after each sequence."""
    return 1 + sum(len(r.seq) + 1 for r in recs)


def streamed_large(torch, recs, pipeline, Config, streamed, kernels, metrics, goldens, label):
    """Phase 10b: examples/large (its records) through the pipeline at a
    budget that holds 2 of its 8 round buffers (4 passes), at k=25 and
    k=33.  Returns the launches per k."""
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    n = joined_positions(recs)
    launches = {}
    for k, golden in goldens.items():
        p8 = streamed.plan(n, k, 1 << 22, 1.25, None, 8)
        budget = p8.fixed_bytes + p8.cap * (p8.epilogue_bytes + 2 * p8.row_bytes)
        p = streamed.plan(n, k, 1 << 22, 1.25, budget)
        check((p.n_rounds, p.G) == (8, 2), f"examples/large k={k}: plan {p}")
        mem0 = fresh_run(torch, metrics, kernels)
        t0 = time.time()
        res = pipeline.find_blocks(seqs, names, Config(k=k, threads=4,
                                                       memory_budget_bytes=budget),
                                   device="cuda")
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        counts, stages, launched = streamed_counts(metrics, kernels)
        digest = hashlib.sha256(res.gff.encode()).hexdigest()
        check(digest == golden, f"examples/large k={k} streamed GFF SHA-256 {digest}")
        check(counts["graph_passes"] == 4 and counts["graph_rounds"] == 8
              and counts["graph_round_retries"] == 0, f"examples/large k={k}: {counts}")
        all_launched(launched, f"examples/large k={k}")
        check(peak <= budget, f"examples/large k={k}: peak {peak} B over the budget {budget}")
        print(f"examples/large k={k} streamed, budget {budget} B: GFF SHA-256 equal to the "
              f"golden ({res.blocks_found} blocks) in {secs:.2f} s | {counts} | peak {peak} B "
              f"= {peak / n:.2f} B/position | launches {launched} | "
              + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
        launches[k] = launched
        epilogue_peak(torch, streamed, seqs, k)
    return launches


def streamed_cli_strains(torch, cli, metrics, kernels, bench_fa, monolithic_gff, out_dir,
                         label):
    """Phase 10c: the strains with -k 33 -n -f 1 (82 B/position x 16 Mbp
    over 1 GB): the streamed stage, and phase 9's monolithic GFF."""
    fresh_run(torch, metrics, kernels)
    wall = run_cli(cli, ["-k", "33", "-n", "-f", "1", "-o", out_dir, bench_fa])
    counts, stages, launched = streamed_counts(metrics, kernels)
    check("graph_scan" in stages, "-f 1 did not route the strains to the streamed stage")
    check(counts["graph_rounds"] == 4 and counts["graph_rounds_per_pass"] == 4,
          f"strains -k 33 -n -f 1: {counts}, not the G=4 of 4 shape K4 was timed at")
    all_launched(launched, "strains -k 33 -n -f 1")
    with open(os.path.join(out_dir, "blocks_coords.gff"), "rb") as f, \
            open(monolithic_gff, "rb") as g:
        check(f.read() == g.read(), "strains -k 33 -f 1: GFF differs from the monolithic run's")
    print(f"strains -k 33 -n -f 1: GFF byte-equal to the monolithic run's | CLI wall "
          f"{wall:.4f} s | {counts} | launches {launched} | "
          + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
    return launched


def streamed_full_size(torch, alphabet, construct, streamed, kernels, metrics, label):
    """Phase 10d: 2 x 512 Mbp at k=25 streamed (a budget of 8 rounds, 2 a
    pass) against the monolithic stage at the card's free memory; then
    2 x 1.1 Gbp at k=25, past 2^31 positions, at the card's free memory.
    Returns the launches of both streamed runs."""
    launches = {}
    seqs = synth_pair(alphabet, 8, PAIR_512M)
    n = 1 + sum(len(s) + 1 for s in seqs)
    torch.cuda.empty_cache()
    mem0 = fresh_run(torch, metrics, kernels)
    t0 = time.time()
    mono = construct.build_junctions(seqs, 25, "cuda")
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    _counts, stages, _launched = streamed_counts(metrics, kernels)
    check("graph_scan" not in stages,
          "2 x 512 Mbp did not run the monolithic stage at the card's free memory")
    print(f"2 x 512 Mbp k=25 monolithic: {secs:.2f} s | junctions "
          f"{sum(len(r.pos) for r in mono)} | peak {peak / (n - 2):.2f} B/position | "
          + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
    p8 = streamed.plan(n, 25, 1 << 22, 1.25, None, 8)
    budget = p8.fixed_bytes + p8.cap * (p8.epilogue_bytes + 2 * p8.row_bytes)
    for name, seqs_, budget_ in (("2 x 512 Mbp", seqs, budget), ("2 x 1.1 Gbp", None, None)):
        if seqs_ is None:
            del seqs, mono
            seqs_ = synth_pair(alphabet, 11, PAIR_1100M)
            n = 1 + sum(len(s) + 1 for s in seqs_)
            check(n > 1 << 31, f"{name}: {n} positions")
        torch.cuda.empty_cache()
        mem0 = fresh_run(torch, metrics, kernels)
        t0 = time.time()
        got = construct.build_junctions(seqs_, 25, "cuda", memory_budget_bytes=budget_)
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        counts, stages, launched = streamed_counts(metrics, kernels)
        check("graph_scan" in stages and counts["graph_round_retries"] == 0,
              f"{name}: {counts}")
        all_launched(launched, name)
        if budget_ is not None:
            check(counts["graph_passes"] == 4, f"{name}: {counts}")
            check(peak <= budget_, f"{name}: peak {peak} B over the budget {budget_}")
            for a, b in zip(mono, got):
                check(np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids),
                      f"{name}: streamed records differ from the monolithic ones")
            same = "records equal to the monolithic ones"
        else:
            # no monolithic run holds 2.2e9 positions: the records' own
            # invariants, and both copies of the ancestor with junctions
            per_chr = [len(r.pos) for r in got]
            ids = np.abs(np.concatenate([r.ids for r in got]))
            check(all(bool((np.diff(r.pos.astype(np.int64)) > 0).all()) for r in got)
                  and ids.min() == 1 and ids.max() == len(np.unique(ids)),
                  f"{name}: records out of order or ids not dense")
            check(min(per_chr) > 0.9 * max(per_chr), f"{name}: junctions per copy {per_chr}")
            del ids
            same = f"junctions per copy {per_chr}"
        print(f"{name} k=25 streamed{'' if budget_ is None else f', budget {budget_} B'}: "
              f"{same} in {secs:.2f} s | {counts} | peak {peak} B = {peak / n:.4f} B/position | "
              f"launches {launched} | " + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items())
              + f" {label}")
        launches[name] = launched
        del got
    return launches


def host_available_gb():
    """The host's available memory, GB (/proc/meminfo's MemAvailable)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 1e6
    raise RuntimeError("chip_smoke: no MemAvailable in /proc/meminfo")


def same_records(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x.pos, y.pos) and np.array_equal(x.ids, y.ids) for x, y in zip(a, b))


def streamed_past_2_32(torch, construct, kernels, metrics, seqs, label):
    """Phase 10e: examples/large's eight chromosomes, one of 2^32 N and the
    eight again (4.32e9 positions, the second copy wholly past 2^32) through
    construct.build_junctions, which routes them to the resident rounds.
    Doubling every occurrence keeps each class's extension sets and boundary
    bits, each class's first occurrence stays in the first copy (so the ids
    keep their ranks), and the N chromosome has no valid window: both
    copies' records must equal the monolithic records of examples/large
    alone, and the filler's must be empty.  Returns the launches."""
    name = "examples/large, 2^32 N, examples/large"
    mono = construct.build_junctions(seqs, 25, "cuda")
    big = [*seqs, np.full(FILLER_N, ord("N"), np.uint8), *seqs]
    n = 1 + sum(len(s) + 1 for s in big)
    second = 1 + sum(len(s) + 1 for s in big[: len(seqs) + 1])  # the second copy's start
    check(second > 1 << 32, f"{name}: the second copy starts at {second}")
    avail = host_available_gb()
    torch.cuda.empty_cache()
    mem0 = fresh_run(torch, metrics, kernels)
    t0 = time.time()
    got = construct.build_junctions(big, 25, "cuda")
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    counts, stages, launched = streamed_counts(metrics, kernels)
    check("graph_scan" in stages and counts["graph_positions"] == n
          and counts["graph_round_retries"] == 0 and counts["graph_host_rounds"] == -1,
          f"{name}: {counts}")
    all_launched(launched, name)
    check(same_records(got[: len(seqs)], mono) and same_records(got[len(seqs) + 1 :], mono)
          and len(got[len(seqs)].pos) == 0,
          f"{name}: the copies' records differ from the monolithic examples/large records")
    print(f"{name} k=25: {n} positions (second copy from {second}), both copies' records "
          f"equal to the monolithic ones ({sum(len(r.pos) for r in mono)} junctions a copy), "
          f"the filler's empty, in {secs:.2f} s | host memory available before: {avail:.1f} GB "
          f"| {counts} | peak {peak} B = {peak / n:.4f} B/position | launches {launched} | "
          + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
    return launched


def streamed_outgrown_class(torch, construct, streamed, kernels, metrics, seqs, label):
    """Phase 10f: examples/large and a 24 Mbp (CATTC)n array as a ninth
    chromosome, k=25.  Each of the array's five classes holds ~4.8 M rows,
    more than a round's floor of min(chunk, n // 8) = 4,194,304, so the
    resident rounds from 8 overflow up to 512 and hand over to the
    host-bucketed rounds; then the host-bucketed rounds alone at 512 rounds
    (K4 not launched).  Both against the monolithic records of the same
    input.  Returns the launches of both."""
    unit = SATELLITE_UNIT
    seqs = [*seqs, np.frombuffer(unit * (SATELLITE_BP // len(unit)), np.uint8).copy()]
    mono = construct.build_junctions(seqs, 25, "cuda")
    grown = SATELLITE_ROUNDS * streamed.MAX_ROUND_GROWTH
    launches = {}
    for name, run in (
            ("class outgrowing every round", lambda: streamed.build_junctions_streamed_resident(
                seqs, 25, "cuda", n_rounds=SATELLITE_ROUNDS)),
            ("host-bucketed rounds", lambda: streamed.build_junctions_streamed(
                seqs, 25, "cuda", n_rounds=grown))):
        torch.cuda.empty_cache()
        mem0 = fresh_run(torch, metrics, kernels)
        t0 = time.time()
        got = run()
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        counts, stages, launched = streamed_counts(metrics, kernels)
        n = counts["graph_positions"]
        check(counts["graph_host_rounds"] == grown
              and launched["front_half"] > 0 and launched["class_analysis"] > 0,
              f"{name}: {counts}, launches {launched}")
        if name == "host-bucketed rounds":
            check(launched["round_append"] == 0 and "graph_scan" not in stages,
                  f"{name}: the resident rounds ran: launches {launched}")
        else:
            check(launched["round_append"] > 0 and counts["graph_round_retries"] == 6,
                  f"{name}: {counts}, launches {launched}")
        check(same_records(got, mono), f"{name}: records differ from the monolithic ones")
        print(f"examples/large + {SATELLITE_BP // 10**6} Mbp ({unit.decode()})n k=25, {name}: "
              f"records equal to the monolithic ones ({sum(len(r.pos) for r in got)} "
              f"junctions) in {secs:.2f} s | {counts} | peak {peak} B = {peak / n:.4f} "
              f"B/position | launches {launched} | "
              + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
        launches[name] = launched
    return launches


def streamed_phase(torch, dev, mods, tmp_dir, large_fa, large_golden, bench_fa, mono_k33_gff,
                   peak_ops, label):
    """Phase 10: returns K4's max abs error on the hand-laid chunks, its
    full-size results, and the launches of each streamed main path."""
    (cases, cli, pipeline, _device_poa, _msa, _poa_ref, kernels, _align_kernels, Config,
     alphabet, fasta, metrics) = mods
    from sibeliaz_tpu_torch.graph import construct, streamed

    phase(f"10 streamed graph stage {label}")
    large_recs = fasta.read_many(large_fa)
    ns = {"examples/large streamed k=25": joined_positions(large_recs),
          "examples/large streamed k=33": joined_positions(large_recs),
          "strains -k 33 -n -f 1": joined_positions(fasta.read_many([bench_fa])),
          "2 x 1.1 Gbp": 1 + 2 * (PAIR_1100M + 1)}
    k4_err = k4_hand_laid(torch, dev, kernels, cases)
    k4 = k4_full_size(torch, dev, alphabet, construct, streamed, kernels, peak_ops, ns)
    large = streamed_large(torch, large_recs, pipeline, Config, streamed, kernels, metrics,
                           {25: large_golden, 33: LARGE_K33_GFF_SHA}, label)
    strains = streamed_cli_strains(torch, cli, metrics, kernels, bench_fa, mono_k33_gff,
                                   os.path.join(tmp_dir, "strains_f1"), label)
    full = streamed_full_size(torch, alphabet, construct, streamed, kernels, metrics, label)
    large_seqs = [r.seq for r in large_recs]
    past = streamed_past_2_32(torch, construct, kernels, metrics, large_seqs, label)
    outgrown = streamed_outgrown_class(torch, construct, streamed, kernels, metrics, large_seqs,
                                       label)
    return k4_err, k4, {"examples/large streamed k=25": large[25],
                        "examples/large streamed k=33": large[33],
                        "strains -k 33 -n -f 1": strains,
                        "2 x 512 Mbp streamed": full["2 x 512 Mbp"],
                        "2 x 1.1 Gbp streamed": full["2 x 1.1 Gbp"],
                        "past 2^32 positions": past,
                        "class outgrowing every round": outgrown["class outgrowing every round"],
                        "host-bucketed rounds": outgrown["host-bucketed rounds"]}


def tool_output(tools, argv):
    """`python -m sibeliaz_tpu_torch.tools ARGV`'s standard output."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        check(tools.main(argv) == 0, f"tools {argv} failed")
    return out.getvalue()


def lcb_phase(torch, mods, maf_path, large_fa, out_dir, label):
    """Phase 11: (a) the oracle LCB engine through the CLI on examples/,
    (b) the bundle list with its sort on the card against the CPU's and the
    oracle's, and the oracle's run on the card's list, (c) the tools on
    phase 7's MAF.  Returns the launches of K1 and K2 in the CLI run."""
    (cases, cli, pipeline, _device_poa, _msa, _poa_ref, kernels, align_kernels, Config,
     alphabet, fasta, metrics) = mods
    from sibeliaz_tpu_torch import tools
    from sibeliaz_tpu_torch.lcb import device_bundles
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine
    from sibeliaz_tpu_torch.output import gff, trim

    fas = [os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")]
    with open(os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff")) as f:
        golden = f.read()

    phase(f"11a the oracle LCB engine through the CLI, examples/ k=15 {label}")
    metrics.timings.clear()
    metrics.counters.clear()
    kernels.reset_launches()
    align_kernels.reset_launches()
    wall = run_cli(cli, ["-k", "15", "-n", "--lcb-engine", "oracle", "-o",
                         os.path.join(out_dir, "oracle"), *fas])
    launches = {**kernels.LAUNCHES, **align_kernels.LAUNCHES}
    with open(os.path.join(out_dir, "oracle", "blocks_coords.gff")) as f:
        check(f.read() == golden, "examples/ GFF of --lcb-engine oracle differs from the golden")
    check(all(launches[name] > 0 for name in MONOLITHIC_KERNELS)
          and launches["round_append"] == 0 and launches["poa_dp_tb"] == 0,
          f"launches of the --lcb-engine oracle -n run: {launches}")
    stages = {t["stage"]: t["seconds"] for t in metrics.timings}
    print(f"examples/ --lcb-engine oracle -n: GFF byte-equal to the golden | lcb_engine "
          f"{stages['lcb_engine']:.4f} s | CLI wall {wall:.4f} s | launches {launches} {label}")

    phase(f"11b the bundle list with its sort on the card {label}")
    for where, paths, k in (("examples/", fas, 15), ("examples/large", large_fa, 25)):
        recs = fasta.read_many(paths)
        seqs, names = [r.seq for r in recs], [r.name for r in recs]
        cfg = Config(k=k)
        table = pipeline.build_table(seqs, names, cfg, device="cuda")
        t0 = time.perf_counter()
        got = device_bundles.make_bundles_device(table, "cuda")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = device_bundles.make_bundles_device(table, "cpu")
        cpu_s = time.perf_counter() - t0
        check(cases.bundle_fields(got) == cases.bundle_fields(on_cpu),
              f"{where}: the card's bundle list differs from the CPU's")
        t0 = time.perf_counter()
        eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking,
                        cfg.looking_depth)
        host = eng.make_bundles()
        host_s = time.perf_counter() - t0
        check(cases.bundle_fields(got) == cases.bundle_fields(host),
              f"{where}: the card's bundle list differs from LcbEngine.make_bundles")
        rows = torch.from_numpy(device_bundles.bundle_rows(table)).to("cuda")
        sort_ms = cuda_ms(torch, lambda: device_bundles.sort_rows(rows), 20)
        del rows
        print(f"{where} k={k}: {len(got)} bundles equal to the CPU's and to "
              f"LcbEngine.make_bundles | rows sorted {2 * len(table.occ_chr)} | sort + gather "
              f"{sort_ms:.4f} ms | make_bundles_device {card_s:.4f} s on the card, "
              f"{cpu_s:.4f} s on the CPU | LcbEngine.make_bundles {host_s:.4f} s {label}")
        if where == "examples/":
            lengths = [len(x) for x in seqs]
            blocks, _ = trim.trim_blocks(eng.run(bundles=got), lengths, cfg.min_block_size)
            check(gff.render_gff(blocks, names, lengths) == golden,
                  "examples/: LcbEngine.run on the card's bundle list misses the golden GFF")
            print("examples/: LcbEngine.run(bundles=<the card's list>) gives the golden GFF")

    phase("11c the tools on phase 7's MAF")
    graph = os.path.join(out_dir, "examples.gfa")
    with open(graph, "w") as f:
        f.write(tool_output(tools, ["maf2gfa", maf_path, *fas]))
    glued = tool_output(tools, ["glue", graph])
    want = "".join(f">{r.name}\n{alphabet.seq_to_str(r.seq)}\n" for r in fasta.read_many(fas))
    check(glued == want, "glue on maf2gfa's GFA does not give the input genomes")
    with open(maf_path) as f:
        n_blocks = sum(line.rstrip("\n") == "a" for line in f)
    xmfa = tool_output(tools, ["maf2xmfa", maf_path])
    sections = xmfa.count("=\n")
    check(xmfa.startswith("#FormatVersion Mauve1\n") and sections == n_blocks,
          f"maf2xmfa wrote {sections} sections for {n_blocks} blocks")
    syn = os.path.join(out_dir, "synteny")
    tool_output(tools, ["synteny", os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff"),
                        "-o", syn, "-b", "5000"])
    written = sorted(os.listdir(os.path.join(syn, "5000")))
    check(written == ["blocks_coords.txt", "coverage_report.txt", "genomes_permutations.txt"],
          f"synteny wrote {written}")
    print(f"maf2gfa + glue: the genomes round-trip | maf2xmfa: {n_blocks} sections | "
          f"synteny -b 5000: {written}")
    return launches


def sharded_run(torch, metrics, kernels, mono, run, n, need, what, label):
    """One sharded graph stage run on the card, held to the monolithic
    records `mono` and its peak to the memory guard's bound `need`; prints
    its stage seconds and returns (records, launches)."""
    torch.cuda.empty_cache()
    mem0 = fresh_run(torch, metrics, kernels)
    t0 = time.time()
    got = run()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    _counts, stages, launched = streamed_counts(metrics, kernels)
    check(same_records(got, mono), f"{what}: records differ from the monolithic stage's")
    check(launched["front_half"] > 0 and launched["class_analysis"] > 0
          and launched["round_append"] == 0, f"{what}: launches {launched}")
    check(peak <= need, f"{what}: peak {peak} B above the memory guard's {need} B")
    print(f"{what}: records equal to the monolithic stage's in {secs:.4f} s | peak {peak} B = "
          f"{peak / n:.4f} B/position (guard {need / n:.2f}) | launches {launched} | "
          + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
    return got, launched


def sharded_phase(torch, mods, tmp_dir, large_fa, large_golden, bench_fa, label):
    """Phase 12: (a) the sharded graph stage on examples/large at k=25 and
    33, the strains at k=15 and 2 x 256 Mbp at k=25, each through SHARDS
    in-process shards on cuda:0 and through an NCCL group of world size 1,
    records equal to the monolithic stage's of the same run, the
    examples/large GFFs through the native LCB engine from the sharded
    records equal to the goldens; (b) the device POA engine with each
    dispatch spread over ["cuda:0", "cuda:0"] on examples/' blocks, MSAs
    equal to its one-device run's and the native engine's.  Returns the
    launches of each run."""
    (_cases, _cli, pipeline, device_poa, msa, _poa_ref, kernels, align_kernels, Config,
     alphabet, fasta, metrics) = mods
    import torch.distributed as dist
    from sibeliaz_tpu_torch.graph import construct
    from sibeliaz_tpu_torch.parallel import multihost, sharded

    phase(f"12 sharded graph stage, NCCL world size 1, the POA spread {label}")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp_dir, "nccl"), 1),
                            world_size=1, rank=0)
    launches = {}
    try:
        large = fasta.read_many(large_fa)
        inputs = (("examples/large", [r.seq for r in large], [r.name for r in large],
                   {25: large_golden, 33: LARGE_K33_GFF_SHA}),
                  ("strains", [r.seq for r in fasta.read_many([bench_fa])], None, {15: None}),
                  ("2 x 256 Mbp", synth_pair(alphabet, PAIR_256M_SEED, PAIR_256M), None,
                   {25: None}))
        for name, seqs, names, goldens in inputs:
            n = 1 + sum(len(s) + 1 for s in seqs)
            bounds = sharded.shard_bounds(n, SHARDS)
            local = [bounds[s + 1] - bounds[s] for s in range(SHARDS)]
            for k, golden in goldens.items():
                torch.cuda.empty_cache()
                mem0 = fresh_run(torch, metrics, kernels)
                t0 = time.time()
                mono = construct.build_junctions(seqs, k, "cuda")
                secs = time.time() - t0
                peak = torch.cuda.max_memory_allocated() - mem0
                _counts, stages, _launched = streamed_counts(metrics, kernels)
                check("graph_scan" not in stages, f"{name} k={k}: the monolithic stage streamed")
                print(f"{name} k={k} monolithic: {sum(len(r.pos) for r in mono)} junctions in "
                      f"{secs:.4f} s | peak {peak / (n - 2):.4f} B/position | "
                      + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
                runs = (
                    (f"{SHARDS} in-process shards on cuda:0",
                     lambda: sharded.build_junctions_sharded(seqs, k, ["cuda:0"] * SHARDS),
                     sharded.need_bytes([x + k + 2 for x in local], n, k)),
                    ("NCCL world size 1",
                     lambda: multihost.build_junctions_multihost(seqs, k, device="cuda:0"),
                     sharded.need_bytes([n + k + 2], n, k)))
                for how, run, need in runs:
                    what = f"{name} k={k} sharded, {how}"
                    got, launches[f"{name} k={k} {how}"] = sharded_run(
                        torch, metrics, kernels, mono, run, n, need, what, label)
                    if golden is not None and how != "NCCL world size 1":
                        res = pipeline.find_blocks(seqs, names, Config(k=k, threads=4),
                                                   records=got)
                        digest = hashlib.sha256(res.gff.encode()).hexdigest()
                        check(digest == golden, f"{what}: GFF SHA-256 {digest}, not the golden")
                        print(f"{what}: GFF through the native LCB engine equal to the golden "
                              f"({res.blocks_found} blocks)")
                    del got
                del mono
    finally:
        dist.destroy_process_group()

    fas = [os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")]
    recs = fasta.read_many(fas)
    seqs = [r.seq for r in recs]
    res = pipeline.find_blocks(seqs, [r.name for r in recs], Config(k=15), device="cuda")
    blocks_seqs = [[msa.copy_sequence(b, seqs) for b in grp]
                   for _bid, grp in msa.block_copies(res.blocks)]
    t0 = time.time()
    one = device_poa.poa_msa_batch_tpu(blocks_seqs, device="cuda")
    secs_one = time.time() - t0
    metrics.counters.clear()
    align_kernels.reset_launches()
    t0 = time.time()
    spread = device_poa.poa_msa_batch_tpu(blocks_seqs, devices=["cuda:0", "cuda:0"])
    secs = time.time() - t0
    counts = align_counts(metrics)
    slices = int(metrics.counters["poa_device_slices"])
    launched = dict(align_kernels.LAUNCHES)
    native = msa.poa_msa_batch(blocks_seqs, threads=os.cpu_count() or 1)
    check(all(m is not None for m in spread), "the POA spread fell back on an examples/ block")
    check(spread == one, "the POA spread's MSAs differ from the one-device run's")
    check(spread == native, "the POA spread's MSAs differ from the native engine's")
    check(launched["poa_dp_tb"] == slices > counts["poa_dispatches"],
          f"the POA spread: {slices} slices, {counts}, launches {launched}")
    print(f"examples/ POA over [cuda:0, cuda:0]: MSAs of all {len(blocks_seqs)} blocks equal "
          f"the one-device run's ({secs_one:.4f} s) and the native engine's in {secs:.4f} s | "
          f"{slices} slices | "
          f"launches {launched} | {counts} {label}")
    launches["examples/ POA spread over 2 devices"] = launched
    return launches


def fused_counters(metrics):
    """The fused LCB engine's counters of the last run, as ints or seconds."""
    return {k: (round(v, 4) if k.endswith("_s") else int(v))
            for k, v in sorted(metrics.counters.items()) if k.startswith("fused_")}


def instance_keys(results):
    return [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
            for insts in results]


def fused_phase(torch, mods, tmp_dir, large_fa, label):
    """Phase 13: (a) the CLI with --lcb-engine tpu-fused -n on examples/
    (k=15), byte-equal to the golden GFF, beside the native engine's run;
    (b) examples/' first phase on the card, on the CPU and through
    eng.process, bundle by bundle; (c) examples/large at k=25, the first
    FUSED_LARGE_PHASES phases on the card through LcbEngine.run's commit
    loop, each bundle equal to eng.process.  Returns the launches of the
    CLI run and {"lcb_s": its lcb_engine seconds, "first_phase": (b)'s
    instances on the card}."""
    (_cases, cli, pipeline, _device_poa, _msa, _poa_ref, kernels, align_kernels, Config,
     _alphabet, fasta, metrics) = mods
    from sibeliaz_tpu_torch.lcb import fused
    from sibeliaz_tpu_torch.lcb import kernels as lcb_kernels
    from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

    fas = [os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")]
    with open(os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff")) as f:
        golden = f.read()

    phase(f"13a --lcb-engine tpu-fused through the CLI, examples/ k=15 {label}")
    lcb_s = {}
    for engine in ("native", "tpu-fused"):
        metrics.timings.clear()
        metrics.counters.clear()
        kernels.reset_launches()
        align_kernels.reset_launches()
        lcb_kernels.reset_launches()
        out = os.path.join(tmp_dir, f"fused_cli_{engine}")
        wall = run_cli(cli, ["-k", "15", "-n", "--lcb-engine", engine, "-o", out, *fas])
        with open(os.path.join(out, "blocks_coords.gff")) as f:
            check(f.read() == golden, f"examples/ GFF of --lcb-engine {engine} differs from the "
                  "golden")
        lcb_s[engine] = {t["stage"]: t["seconds"] for t in metrics.timings}["lcb_engine"]
    launches = {**kernels.LAUNCHES, **align_kernels.LAUNCHES, **lcb_kernels.LAUNCHES}
    counters = fused_counters(metrics)
    check(launches["front_half"] == 1 and launches["class_analysis"] == 1
          and launches["round_append"] == 0 and launches["poa_dp_tb"] == 0
          and launches["lcb_walk"] == 0 and launches["lcb_vote"] == 0
          and launches["lcb_step"] > 0,
          f"launches of the --lcb-engine tpu-fused -n run (K7 alone steps the lanes): "
          f"{launches}")
    check(counters.get("fused_phases", 0) > 0, f"the fused engine did not run: {counters}")
    steps = sum(v for k, v in counters.items() if k.startswith("fused_steps_tier"))
    runs = counters["fused_runs"]
    check(launches["lcb_step"] == runs, f"{launches['lcb_step']} lcb_step launches for {runs} "
          "runs: a run went past K7")
    check(counters["fused_host_syncs"] == runs == launches["lcb_seed"]
          == metrics.counters["k8_launches"],
          f"{counters['fused_host_syncs']} reads and {launches['lcb_seed']} K8 launches for "
          f"{runs} runs: not one of each a run")
    print(f"examples/ --lcb-engine tpu-fused -n: GFF byte-equal to the golden | lcb_engine "
          f"{lcb_s['tpu-fused']:.4f} s (native {lcb_s['native']:.4f} s) | CLI wall {wall:.4f} s "
          f"| runs {runs} | outer steps (each run's longest lane) {steps} | reads a run "
          f"{counters['fused_host_syncs'] / runs:.2f} (the decode's "
          f"{counters.get('fused_decode_reads', 0)} apart) | {counters} | launches "
          f"{launches} {label}")

    phase(f"13b examples/' first phase: the card, the CPU and eng.process {label}")
    recs = fasta.read_many(fas)
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    cfg = Config(k=15)
    table = pipeline.build_table(seqs, names, cfg, device="cuda")
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking,
                    cfg.looking_depth)
    bundles = make_bundles_device(table, "cuda")[:256]
    runs = {}
    for dev in ("cuda", "cpu"):
        metrics.counters.clear()
        lcb_kernels.reset_launches()
        t0 = time.time()
        runs[dev] = instance_keys(fused.process_phase_fused(eng, bundles, device=dev))
        print(f"examples/ phase 1 on {dev}: {time.time() - t0:.4f} s | "
              f"{fused_counters(metrics)} | launches {lcb_kernels.LAUNCHES} {label}")
    t0 = time.time()
    oracle = instance_keys(eng.process(b) for b in bundles)
    check(runs["cuda"] == runs["cpu"], "examples/ phase 1: the card's instances differ from "
          "the CPU's")
    check(runs["cuda"] == oracle, "examples/ phase 1: the card's instances differ from "
          "eng.process's")
    print(f"examples/ phase 1: {len(bundles)} bundles equal on the card, the CPU and "
          f"eng.process ({time.time() - t0:.4f} s), {sum(len(r) > 1 for r in oracle)} with "
          f"two instances or more")

    phase(f"13c examples/large k=25, the first {FUSED_LARGE_PHASES} phases on the card {label}")
    recs = fasta.read_many(large_fa)
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    cfg = Config(k=25)
    table = pipeline.build_table(seqs, names, cfg, device="cuda")
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking,
                    cfg.looking_depth)
    bundles = make_bundles_device(table, "cuda")
    per_phase = []

    large_launches = {"lcb_walk": 0, "lcb_vote": 0, "lcb_step": 0}

    def checked_phase(eng, batch):
        metrics.counters.clear()
        lcb_kernels.reset_launches()
        t0 = time.time()
        got = fused.process_phase_fused(eng, batch, device="cuda")
        secs = time.time() - t0
        for kernel in large_launches:
            large_launches[kernel] += lcb_kernels.LAUNCHES[kernel]
        counters = fused_counters(metrics)
        counters["lcb_step launches"] = lcb_kernels.LAUNCHES["lcb_step"]
        check(lcb_kernels.LAUNCHES["lcb_step"] == counters["fused_runs"]
              and lcb_kernels.LAUNCHES["lcb_walk"] == lcb_kernels.LAUNCHES["lcb_vote"] == 0,
              f"examples/large phase {len(per_phase) + 1}: launches {lcb_kernels.LAUNCHES} for "
              f"{counters['fused_runs']} runs")
        t0 = time.time()
        want = [eng.process(b) for b in batch]
        check(instance_keys(got) == instance_keys(want),
              f"examples/large phase {len(per_phase) + 1}: instances differ from eng.process's")
        per_phase.append(secs)
        print(f"examples/large phase {len(per_phase)}: {len(batch)} bundles equal to "
              f"eng.process ({time.time() - t0:.4f} s) | card {secs:.4f} s | {counters} {label}")
        return got

    n_phases = -(-len(bundles) // 256)
    eng.run(process_batch_fn=checked_phase, bundles=bundles[:256 * FUSED_LARGE_PHASES])
    mean = sum(per_phase) / len(per_phase)
    print(f"examples/large k=25: {len(bundles)} bundles, {n_phases} phases | the first "
          f"{len(per_phase)} on the card {sum(per_phase):.4f} s ({mean:.4f} s a phase) | "
          f"extrapolated full run {mean * n_phases:.1f} s | launches {large_launches} "
          f"{label}")
    check(large_launches["lcb_step"] > 0 and not large_launches["lcb_walk"]
          and not large_launches["lcb_vote"], f"examples/large: launches {large_launches}")
    return launches, {"lcb_s": lcb_s["tpu-fused"], "first_phase": runs["cuda"],
                      "large_launches": large_launches}


def resident_counters(metrics):
    """The resident LCB engine's counters of the last run, as ints or seconds."""
    return {k: (round(v, 4) if k.endswith("_s") else int(v))
            for k, v in sorted(metrics.counters.items()) if k.startswith("resident_")}


def kernel_rows(prof, part):
    """The rows of the profiler's `key_averages()` whose name holds `part`
    and that have device time: [(name, device us, calls)].  A kernel that
    the port's own library launches has no torch op to hang from, so its
    row is found by its name, not by its device type."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if part in e.key and us > 0:
            rows.append((e.key, us, e.count))
    return rows


def device_busy(torch, prof):
    """(seconds of device activity, device events, all events) of a
    profile, summed over its raw events: key_averages() builds a Python
    object and a tree over every event, far slower over the millions of
    events of one LCB phase."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    busy = [e.duration_ns() for e in events if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", lambda: False)()]
    return sum(busy) / 1e9, len(busy), len(events)


def resident_phase(torch, mods, tmp_dir, large_fa, fused13, traced_phase, label):
    """Phase 15: (a) the CLI with --lcb-engine tpu -n on examples/ (k=15),
    byte-equal to the golden GFF, beside the native engine's run (and phase
    13a's tpu-fused seconds, where that phase ran: `fused13`, what
    fused_phase returns, else None); (b) examples/' first phase through
    process_phase_resident on the card, equal to eng.process and to
    process_phase_fused (phase 13b's run of the same bundles, where it
    ran), then, where `traced_phase`, once more inside device_trace: the
    card's busy share of one LCB phase; (c) build_junctions on
    examples/large at k=25 inside device_trace, K1's and K2's device time
    from key_averages() (CUDA events where the profiler shows none), the
    card's busy share from the profiler's events.  Returns the launches of
    the CLI run."""
    (_cases, cli, pipeline, _device_poa, _msa, _poa_ref, kernels, align_kernels, Config,
     _alphabet, fasta, metrics) = mods
    from sibeliaz_tpu_torch.graph import construct
    from sibeliaz_tpu_torch.lcb import fused, resident
    from sibeliaz_tpu_torch.lcb import kernels as lcb_kernels
    from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine
    from sibeliaz_tpu_torch.utils.metrics import device_trace

    fas = [os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")]
    with open(os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff")) as f:
        golden = f.read()

    phase(f"15a --lcb-engine tpu through the CLI, examples/ k=15 {label}")
    lcb_s = {}
    for engine in ("native", "tpu"):
        metrics.timings.clear()
        metrics.counters.clear()
        kernels.reset_launches()
        align_kernels.reset_launches()
        lcb_kernels.reset_launches()
        out = os.path.join(tmp_dir, f"resident_cli_{engine}")
        wall = run_cli(cli, ["-k", "15", "-n", "--lcb-engine", engine, "-o", out, *fas])
        with open(os.path.join(out, "blocks_coords.gff")) as f:
            check(f.read() == golden, f"examples/ GFF of --lcb-engine {engine} differs from the "
                  "golden")
        lcb_s[engine] = {t["stage"]: t["seconds"] for t in metrics.timings}["lcb_engine"]
    launches = {**kernels.LAUNCHES, **align_kernels.LAUNCHES, **lcb_kernels.LAUNCHES}
    counters = resident_counters(metrics)
    check({k: v for k, v in launches.items() if k not in ("lcb_walk", "lcb_vote")} == {
        "front_half": 1, "class_analysis": 1, "round_append": 0, "poa_dp_tb": 0, "lcb_step": 0}
        and launches["lcb_walk"] > 0, f"launches of the --lcb-engine tpu -n run: {launches}")
    check(counters.get("resident_phases", 0) > 0, f"the resident engine did not run: {counters}")
    check(launches["lcb_vote"] == counters["resident_vote_calls"],
          f"{launches['lcb_vote']} lcb_vote launches for {counters['resident_vote_calls']} vote "
          "calls: a vote went past K6")
    rounds = counters["resident_rounds"]
    fused_s = "not run in this mode" if fused13 is None else f"{fused13['lcb_s']:.4f} s"
    print(f"examples/ --lcb-engine tpu -n: GFF byte-equal to the golden | lcb_engine "
          f"{lcb_s['tpu']:.4f} s (native {lcb_s['native']:.4f} s; tpu-fused in 13a {fused_s}) "
          f"| CLI wall {wall:.4f} s | rounds {rounds} | host syncs per round "
          f"{counters['resident_host_syncs'] / max(1, rounds):.2f} | {counters} | launches "
          f"{launches} {label}")

    phase(f"15b examples/' first phase: the resident engine on the card, the fused engine, "
          f"eng.process; the card's busy share {label}")
    recs = fasta.read_many(fas)
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    cfg = Config(k=15)
    table = pipeline.build_table(seqs, names, cfg, device="cuda")
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking,
                    cfg.looking_depth)
    bundles = make_bundles_device(table, "cuda")[:256]
    runs, secs = {}, {}
    if fused13 is not None:
        runs["fused"] = fused13["first_phase"]
        print(f"examples/ phase 1, fused engine on the card: phase 13b's run {label}")
    for how, fn in (("resident", resident.process_phase_resident),
                    ("fused", fused.process_phase_fused)):
        if how in runs:
            continue
        metrics.counters.clear()
        lcb_kernels.reset_launches()
        t0 = time.time()
        runs[how] = instance_keys(fn(eng, bundles, device="cuda"))
        secs[how] = time.time() - t0
        print(f"examples/ phase 1, {how} engine on the card: {secs[how]:.4f} s | "
              f"{resident_counters(metrics) if how == 'resident' else fused_counters(metrics)} "
              f"| lcb_walk launches {lcb_kernels.LAUNCHES['lcb_walk']}, lcb_vote "
              f"{lcb_kernels.LAUNCHES['lcb_vote']} {label}")
    oracle = instance_keys(eng.process(b) for b in bundles)
    check(runs["resident"] == oracle, "examples/ phase 1: the resident engine's instances "
          "differ from eng.process's")
    check(runs["resident"] == runs["fused"], "examples/ phase 1: the resident engine's "
          "instances differ from the fused engine's")
    print(f"examples/ phase 1: {len(bundles)} bundles equal through the resident engine, the "
          f"fused engine and eng.process")
    os.environ["SIBELIAZ_TPU_PROFILE"] = os.path.join(tmp_dir, "trace")
    if traced_phase:
        metrics.counters.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        with device_trace("resident_phase") as prof:
            again = instance_keys(resident.process_phase_resident(eng, bundles, device="cuda"))
            torch.cuda.synchronize()
            run_s = time.time() - t0
        traced = time.time() - t0
        check(again == oracle, "examples/ phase 1, traced: instances differ from eng.process's")
        t0 = time.time()
        busy, n_device, n_events = device_busy(torch, prof)
        if not busy:
            print(f"examples/ phase 1: the profiler recorded no device time in {n_events} "
                  f"events; the busy share is not measured {label}")
        print(f"examples/ phase 1, resident engine inside device_trace: {run_s:.4f} s traced "
              f"({secs['resident']:.4f} s untraced; the trace written in {traced - run_s:.4f} s, "
              f"read in {time.time() - t0:.4f} s) | device busy {busy:.4f} s over {n_device} "
              f"device events of {n_events}: busy share {busy / run_s:.4f} of the traced run, "
              f"{busy / secs['resident']:.4f} of the untraced | syncs "
              f"{int(metrics.counters['resident_host_syncs'])} {label}")
    else:
        print("examples/ phase 1 inside device_trace: run by `python3 chip_smoke.py "
              "--resident` alone (its trace holds millions of events)")

    phase(f"15c build_junctions on examples/large k=25 inside device_trace {label}")
    large = [r.seq for r in fasta.read_many(large_fa)]
    want = construct.build_junctions(large, 25, "cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    with device_trace("graph_k25") as prof:
        got = construct.build_junctions(large, 25, "cuda")
        torch.cuda.synchronize()
    wall = time.time() - t0
    check(same_records(got, want),
          "examples/large k=25: the traced run's records differ from the untraced run's")
    check(kernels.LAUNCHES["front_half"] == 1 and kernels.LAUNCHES["class_analysis"] == 1,
          f"examples/large k=25 traced: launches {kernels.LAUNCHES}")
    by_kernel = {k: kernel_rows(prof, part) for k, part in
                 (("front_half", "front_half_kernel"), ("class_analysis", "class_"))}
    busy, n_device, _ = device_busy(torch, prof)
    if all(by_kernel.values()):
        print(f"examples/large k=25 inside device_trace: wall {wall:.4f} s | device busy "
              f"{busy:.4f} s over {n_device} device events, share {busy / wall:.4f} | "
              + " | ".join(f"{k}: " + ", ".join(f"{name[:70]} {us / 1e3:.4f} ms x{c}"
                                                 for name, us, c in v)
                           for k, v in by_kernel.items())
              + f" {label}")
    else:
        print(f"examples/large k=25: the profiler's key_averages() show no device time for "
              f"K1 or K2 ({by_kernel}); timed with CUDA events instead {label}")
        ms = cuda_ms(torch, lambda: construct.build_junctions(large, 25, "cuda"), 3)
        print(f"examples/large k=25: build_junctions {ms:.4f} ms a call by CUDA events {label}")
    os.environ.pop("SIBELIAZ_TPU_PROFILE")
    return launches


class HostLoopRoute:
    """While active, the fused engine's lcb_step calls take the host loop
    (lcb/step.py's lcb_step_plain on the card's tensors: one K6 and one K5
    launch an outer step, the route before K7), so that K5's and K6's
    calls from the fused engine can be recorded (phases 16 and 17) and K7
    held to that route (phase 18)."""

    def __init__(self, lcb_kernels):
        self.mod = lcb_kernels

    def __enter__(self):
        from sibeliaz_tpu_torch.lcb import step

        self.real, self.mod.lcb_step = self.mod.lcb_step, step.lcb_step_plain
        return self

    def __exit__(self, *exc):
        self.mod.lcb_step = self.real


class WalkRecorder:
    """While active, wraps K5's wrapper, which both device LCB engines call,
    and keeps the arguments of the calls with the most pushes and with the
    longest row (its occurrence steps), WALK_KEEP of each per (engine, slab
    width), so that K5 can be held against its plain version at the main
    path's own shapes afterwards: each with a copy of the state as it was
    before the call, which the walk writes in place.  Each call is read
    once for its counts (a read the engines do not make).  The wrapper it
    calls still counts each launch."""

    def __init__(self, torch, lcb_kernels):
        self.torch, self.mod, self.kept, self.engine, self.calls = torch, lcb_kernels, {}, None, 0

    def __enter__(self):
        from sibeliaz_tpu_torch.lcb.batched_push_device import (_state_from_leaves,
                                                                _state_leaves)

        real = self.real = self.mod.lcb_walk

        def record(*args):
            # the walk writes the state in place: keep a copy as it was
            before = _state_from_leaves([x.clone() for x in _state_leaves(args[1])])
            w = real(*args)
            args = (args[0], before) + args[2:]
            pushes, occ = self.torch.stack([w.pushes.max(), w.occ_steps.max()]).tolist()
            self.calls += 1
            kept = self.kept.setdefault((self.engine, args[1].ln.chr.shape[1]), [])
            kept.append((pushes, occ, self.calls, args))
            if len(kept) > 4 * WALK_KEEP:
                kept[:] = self.best(kept)
            return w

        self.mod.lcb_walk = record
        return self

    @staticmethod
    def best(kept):
        """The WALK_KEEP calls with the most pushes and the WALK_KEEP with
        the longest row, earlier calls first on ties, in call order."""
        chosen = {c[2]: c for key in (lambda c: (-c[0], c[2]), lambda c: (-c[1], c[2]))
                  for c in sorted(kept, key=key)[:WALK_KEEP]}
        return [chosen[n] for n in sorted(chosen)]

    def __exit__(self, *exc):
        self.mod.lcb_walk = self.real

    def calls_to_replay(self):
        """[(label, arguments)]: each group's best calls, at most
        WALK_REPLAY_MAX in all."""
        out = []
        for (engine, width), kept in sorted(self.kept.items()):
            for pushes, occ, n, args in self.best(kept):
                out.append((f"{engine} IC {width} call {n} ({pushes} pushes, longest row "
                            f"{occ} occurrence steps)", args))
        return out[:WALK_REPLAY_MAX]


def k5_bound(args, w, IC, PC, peak_ops):
    """K5's roofline bound on one call's data, as the kernel must move it:
    each walking row's live slab, best score and snapshot flag read once and
    written once; one rewind slab written for each row whose forward walk
    raised its best score, one result slab for each row whose raised best
    score is above 0 (the kernel reads neither of those slabs); every
    row's arguments and results; the table words its pushes and
    occurrence steps read and each push's score terms (the final instance
    count's), against the operations of those steps and terms;
    (ms, which, bytes)."""
    st, rows, fwd = args[1], args[2], args[6]  # st: the state before the walk
    L = st.best_score.shape[0]
    old, new = st.best_score, w.st.best_score
    if rows is not None:
        take = rows.clamp(max=L - 1)
        old, new = old[take], new[take]
    walked = w.pushes > 0
    raised = walked & (new > old)
    rewinds, results = int((raised & fwd).sum()), int((raised & (new > 0)).sum())
    slab = IC * K5_INSTANCE_BYTES + PC * K5_PATH_BYTES + K5_REGISTER_BYTES
    terms = int((w.pushes * w.n).sum())
    steps, pushes = int(w.occ_steps.sum()), int(w.pushes.sum())
    nbytes = (2 * (slab + K5_BEST_BYTES) * int(walked.sum()) + slab * (rewinds + results)
              + K5_ROW_BYTES * w.pushes.shape[0] + K5_PUSH_BYTES * pushes
              + K5_STEP_BYTES * steps + K5_SCORE_BYTES * terms)
    ms, by = bound_ms(nbytes, K5_OPS_PER_STEP * steps + K5_OPS_PER_SCORE_TERM * terms,
                      peak_ops)
    return ms, by, nbytes, rewinds, results


def chain_step_us(torch, lcb_kernels):
    """One dependent step of a chain, in microseconds, by each chain probe:
    {"warp": one load from L2 and a __syncwarp of warp 0 (K5's occurrence
    step), "block": four dependent loads and a barrier of 256 threads (the
    step of K5's first design, thread 0 alone), "vote": one K6 vote whose
    windows end in their first round (K6's chain floor a call, and K7's a
    step)}."""
    n = 1 << 20
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(16))
    table = torch.empty(n, dtype=torch.int64)
    table[perm] = perm.roll(-1)  # one cycle through every entry
    table = table.cuda()
    iters = 20000
    return {step: cuda_ms(torch, lambda: lcb_kernels.chain_probe(table, iters, step), 3) * 1e3
            / iters for step in ("warp", "block", "vote")}


def k5_vs_plain(torch, lcb_kernels, label, args, peak_ops, step_us):
    """K5 against its plain version on one call's arguments on the card
    (args[1]: the state before the walk, left as it is): every output
    exact, the state walked in place (the call returns the tensors it was
    given) and the call's only allocation its results; the kernel's card
    time alone, each launch from the restored state (the restore untimed),
    the wrapper's whole call (host included, from the restored state), the
    plain version's time, the bound and both chain floors.  Returns a
    dict."""
    from sibeliaz_tpu_torch.lcb.batched_push_device import _state_from_leaves, _state_leaves

    st0 = args[1]
    leaves0 = _state_leaves(st0)
    st = _state_from_leaves([x.clone() for x in leaves0])
    leaves = _state_leaves(st)
    walk_args = (args[0], st) + args[2:]

    def restore():
        for x, y in zip(leaves, leaves0):
            x.copy_(y)

    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    got = lcb_kernels.lcb_walk(*walk_args)
    grew = torch.cuda.memory_allocated() - allocated
    torch.cuda.synchronize()
    A = args[3].shape[0]
    check(grew <= -(-10 * A * 8 // 512) * 512,
          f"lcb_walk allocated {grew} bytes beside its results ({label})")
    check(all(x is y for x, y in zip(_state_leaves(got.st), leaves)),
          f"lcb_walk returned other tensors than the state it walked ({label})")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = lcb_kernels.lcb_walk_plain(*args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    pairs = list(zip(leaves, _state_leaves(want.st))) + list(zip(got[1:], want[1:]))
    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in pairs)
    check(err == 0, f"lcb_walk differs from its plain version ({label}): max abs err {err}")
    res = torch.empty((10, A), dtype=torch.int64, device="cuda")
    # the restore is 68 copies a launch: the card spins 8 x AHEAD_CYCLES
    ms = cuda_ms(torch, lambda: lcb_kernels.launch_into(*walk_args, res), 10, ahead=8,
                 quiet=True, setup=restore)
    call_s = 0.0
    for _ in range(10):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcb_kernels.lcb_walk(*walk_args)
        torch.cuda.synchronize()
        call_s += time.perf_counter() - t0
    call_ms = call_s * 1e3 / 10
    IC, PC = st.ln.chr.shape[1], st.ln.pvid.shape[1]
    bound, by, nbytes, rewinds, results = k5_bound(args, want, IC, PC, peak_ops)
    longest = int(want.occ_steps.max())
    floor, floor_block = (longest * step_us[step] / 1e3 for step in ("warp", "block"))
    print(f"lcb_walk {label}: equal, walked in place | rows {want.pushes.shape[0]} "
          f"(walking {int((want.pushes > 0).sum())}), IC {IC} PC {PC}, pushes "
          f"{int(want.pushes.sum())} (most {int(want.pushes.max())}), occurrence steps "
          f"{int(want.occ_steps.sum())} (longest row {longest}) | kernel {ms:.4f} ms, whole "
          f"call {call_ms:.4f} ms (host included) | plain {plain_ms:.4f} ms | bound "
          f"{bound:.4f} ms by {by} ({nbytes} bytes; {rewinds} rewind and {results} result "
          f"slabs written) = {100 * bound / ms:.4f}% | chain floor {floor:.4f} ms = {longest} x "
          f"{step_us['warp']:.4f} us = {100 * floor / ms:.4f}% (the first design's step, "
          f"no floor of this one: {floor_block:.4f} ms = {longest} x "
          f"{step_us['block']:.4f} us)")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "call_ms": call_ms, "chain_floor_ms": floor, "chain_floor_block_ms": floor_block,
            "occ": longest, "walk": want}


def walk_stress(torch, pipeline, Config, cases):
    """The stress set: [(label, K5 arguments)], each with sentinel rows
    among the rows and lane L-1 beside one: a repeat of WALK_REPEAT_COPIES
    copies (pushes of vertices with hundreds of occurrences), walks cut at
    a limit of 2 pushes, and lanes that outgrow a narrow slab mid-walk
    (tests/torch_cases.py's walk_genomes)."""
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

    out = []
    for label, (seqs, names), (IC, PC), limit in (
            (f"stress: a repeat of {WALK_REPEAT_COPIES} copies",
             cases.repeat_genomes(3, WALK_REPEAT_COPIES), (512, 1024), 2048),
            ("stress: walks cut at 2 pushes",
             cases.related_genomes(520, length=1200, mut=0.03, rearrange=True), (64, 128), 2),
            ("stress: lanes outgrowing IC 64 mid-walk", cases.walk_genomes(3), (64, 128), 16)):
        cfg = Config(k=15, abundance_threshold=1000)
        table = pipeline.build_table(seqs, names, cfg, device="cuda")
        eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking)
        tb, st, n_lanes = cases.walk_lanes(eng, WALK_LANES, IC, PC, "cuda", apart=True)
        rng = np.random.default_rng(11)
        walks = cases.walk_args(eng, st, n_lanes, rng)
        rows, c, i, s, fwd, tvid = cases.walk_tensors(
            cases.with_sentinel_rows(walks, WALK_LANES, rng), "cuda")
        on = torch.ones_like(fwd)
        out.append((label + ", sentinel rows and lane L-1",
                    (tb, st, rows, c, i, s, fwd, tvid, on, ~on, eng.m, eng.b, eng.flank, limit)))
    return out


def recorded_walk_calls(torch, mods, lcb_kernels):
    """examples/' first phase (256 bundles, k=15) through the fused engine
    (by the host loop: HostLoopRoute) and the resident engine on the card,
    each equal to eng.process, with K5's calls recorded: the
    WalkRecorder."""
    (_cases, _cli, pipeline, _device_poa, _msa, _poa_ref, _kernels, _align_kernels, Config,
     _alphabet, fasta, metrics) = mods
    from sibeliaz_tpu_torch.lcb import fused, resident
    from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

    recs = fasta.read_many([os.path.join(EXAMPLES, "genome1.fa"),
                            os.path.join(EXAMPLES, "genome2.fa")])
    cfg = Config(k=15)
    table = pipeline.build_table([r.seq for r in recs], [r.name for r in recs], cfg,
                                 device="cuda")
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking,
                    cfg.looking_depth)
    bundles = make_bundles_device(table, "cuda")[:256]
    oracle = instance_keys(eng.process(b) for b in bundles)
    with WalkRecorder(torch, lcb_kernels) as rec:
        for engine, fn in (("fused", fused.process_phase_fused),
                           ("resident", resident.process_phase_resident)):
            rec.engine = engine
            metrics.counters.clear()
            t0 = time.time()
            with HostLoopRoute(lcb_kernels) if engine == "fused" else contextlib.nullcontext():
                got = instance_keys(fn(eng, bundles, device="cuda"))
            check(got == oracle, f"examples/ phase 1 through the {rec.engine} engine, "
                                 "recorded: instances differ from eng.process's")
            print(f"examples/ phase 1, {rec.engine} engine, recorded: {time.time() - t0:.4f} s"
                  f" (each walk call read once for its counts), equal to eng.process")
    return rec


def build_older_k5(cudabuild, lcb_kernels, out_dir, older):
    """An older csrc/lcb_walk.cu with the first design's C interface (the
    state's 68 input pointers, then 68 output pointers whose tensors start
    as copies of the inputs), built alone with nvcc; its -Xptxas -v report
    printed.  A function (K5's arguments, the output leaves, [10, A]
    results) that launches it."""
    lib = os.path.join(out_dir, "k5_older.so")
    proc = subprocess.run([cudabuild._nvcc(), *cudabuild.NVCC_FLAGS, "-shared", "-o", lib, older],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"K5 {older} did not build:\n{proc.stderr}")
    print(f"K5 {older}:")
    print_ptxas(proc.stderr)
    walk = ctypes.CDLL(lib).sz_lcb_walk
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    walk.argtypes = [vp] * 6 + [i64, i64, i32, i32] + [i64] * 4 + [i32, vp]
    walk.restype = ctypes.c_int

    def launch(torch, args, out, res):
        from sibeliaz_tpu_torch.lcb.batched_push_device import _state_leaves

        tb, st, rows, c, i, s, fwd, tvid, active, last, m, b, flank, limit = args
        tables = [getattr(tb, f) for f in lcb_kernels.TABLE_FIELDS]
        lens = [tb.chr_off.shape[0], tb.chr_len.shape[0], tb.jid.shape[0],
                tb.used_pfx.shape[0], tb.used.shape[0], tb.seq_off.shape[0], tb.seq.shape[0],
                tb.occ_off.shape[0], tb.occ_chr.shape[0]]
        arrays = [lcb_kernels._array([x.data_ptr() for x in group])
                  for group in (_state_leaves(st), out, tables)]
        arrays += [lcb_kernels._array(lens), lcb_kernels._array(
            [0 if rows is None else rows.data_ptr()]
            + [x.data_ptr() for x in (c, i, s, fwd, tvid, active, last)])]
        status = walk(*(ctypes.cast(a, ctypes.c_void_p) for a in arrays),
                      ctypes.c_void_p(res.data_ptr()), st.ln.chr.shape[0], res.shape[1],
                      st.ln.chr.shape[1], st.ln.pvid.shape[1], tb.k, m, b, flank, limit,
                      ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        check(status == 0, f"K5 {older}: CUDA error {status}")

    return launch


def k5_time(torch, mods, peak_ops, cudabuild, out_dir, older):
    """--k5-time [OLDER.cu]: K5 (and an older csrc/lcb_walk.cu of the first
    design's C interface, where given) on the recorded call with the largest
    bound of each engine and slab width (recorded_walk_calls) and on the
    stress set's repeat: each exact against the plain version, then timed
    over 10 launches, each from the restored state, in turns (older, K5, K5,
    older), with the restore untimed and, the second time, the card's L2
    flushed after it by a read of 192 MB (untimed), so that no launch
    stores over the restore's dirty lines."""
    from sibeliaz_tpu_torch.lcb import kernels as lcb_kernels
    from sibeliaz_tpu_torch.lcb.batched_push_device import _state_from_leaves, _state_leaves

    cases, pipeline, Config = mods[0], mods[2], mods[8]
    print("K5 (the port's library):")
    print_ptxas(cudabuild.build()[1])
    older_launch = build_older_k5(cudabuild, lcb_kernels, out_dir, older) if older else None
    rec = recorded_walk_calls(torch, mods, lcb_kernels)
    heaviest = {}
    for name, args in rec.calls_to_replay():
        want = lcb_kernels.lcb_walk_plain(*args)
        IC, PC = args[1].ln.chr.shape[1], args[1].ln.pvid.shape[1]
        bound = k5_bound(args, want, IC, PC, peak_ops)[0]
        group = " ".join(name.split()[:3])
        if group not in heaviest or bound > heaviest[group][0]:
            heaviest[group] = (bound, name, args, want)
    repeat = walk_stress(torch, pipeline, Config, cases)[0]
    calls = list(heaviest.values()) + [(None, *repeat, lcb_kernels.lcb_walk_plain(*repeat[1]))]
    flush = torch.ones(24 << 20, dtype=torch.int64, device="cuda")
    for bound, name, args, want in calls:
        leaves0 = _state_leaves(args[1])
        A = args[3].shape[0]
        st = _state_from_leaves([x.clone() for x in leaves0])
        kernels_ = {"K5": (st, lambda res: lcb_kernels.launch_into(args[0], st, *args[2:], res))}
        if older_launch:
            out = [x.clone() for x in leaves0]
            kernels_["older"] = (_state_from_leaves(out),
                                 lambda res: older_launch(torch, args, out, res))
        times = {}
        for who in ["older", "K5", "K5", "older"]:
            if who not in kernels_:
                continue
            state, launch = kernels_[who]
            res = torch.empty((10, A), dtype=torch.int64, device="cuda")
            for flushed in (False, True):
                def restore():
                    for x, y in zip(_state_leaves(state), leaves0):
                        x.copy_(y)
                    if flushed:
                        flush.sum()

                times.setdefault((who, flushed), []).append(cuda_ms(
                    torch, lambda: launch(res), 10, ahead=8, quiet=True, setup=restore))
            pairs = list(zip(_state_leaves(state), _state_leaves(want.st)))
            pairs += [(res[q][:A], w) for q, w in enumerate(want[1:])] if who == "older" else [
                (res[q].view(torch.uint8)[:A] if w.dtype == torch.bool else res[q], w)
                for q, w in enumerate(want[1:])]
            err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                      for a, b in pairs)
            check(err == 0, f"K5 ({who}) differs from the plain version ({name})")
        if bound is None:
            IC, PC = args[1].ln.chr.shape[1], args[1].ln.pvid.shape[1]
            bound = k5_bound(args, want, IC, PC, peak_ops)[0]
        print(f"k5 {name}: exact | bound {bound:.4f} ms | " + " | ".join(
            f"{who} {'restored + L2 flushed' if fl else 'restored'} "
            + " / ".join(f"{t:.4f}" for t in ts) + " ms"
            + f" ({100 * bound / min(ts):.1f}%)" for (who, fl), ts in times.items()))


def walk_phase(torch, mods, peak_ops, label):
    """Phase 16: K5 lcb_walk against its plain version on the card.  The
    walk calls of examples/' first phase (256 bundles, k=15) through the
    fused and the resident engine are recorded (WalkRecorder), and the
    calls with the most pushes and the longest rows of each engine and slab
    width replayed; then the stress set.  Each exact and walked in place,
    with times, bound and chain floors.  Returns the summary of the heaviest
    recorded call (the longest row) and the largest error of all."""
    cases, pipeline, Config = mods[0], mods[2], mods[8]
    from sibeliaz_tpu_torch.lcb import kernels as lcb_kernels

    phase(f"16 K5 lcb_walk against its plain version {label}")
    t_phase = time.time()
    rec = recorded_walk_calls(torch, mods, lcb_kernels)
    calls = rec.calls_to_replay()
    print(f"recorded {rec.calls} walk calls; replaying {len(calls)}")
    step_us = chain_step_us(torch, lcb_kernels)
    print(f"chain probes: {step_us['warp']:.4f} us a step (one L2 load, a __syncwarp), "
          f"{step_us['block']:.4f} us (four L2 loads, a barrier of 256 threads) | walk blocks "
          f"an SM: {lcb_kernels.blocks_per_sm(512, 1024)} at IC 512 PC 1024, "
          f"{lcb_kernels.blocks_per_sm(64, 128)} at IC 64 PC 128")
    results = [(name, k5_vs_plain(torch, lcb_kernels, name, args, peak_ops, step_us))
               for name, args in calls]
    stress = [(name, k5_vs_plain(torch, lcb_kernels, name, args, peak_ops, step_us))
              for name, args in walk_stress(torch, pipeline, Config, cases)]
    repeat, bounded, outgrown = (r["walk"] for _, r in stress)
    check(int(repeat.occ_steps[repeat.pushes == 1].max()) >= 200,
          "stress: no push of a vertex with hundreds of occurrences")
    check(bool(((bounded.pushes == 2) & ~bounded.at_target).any()),
          "stress: no walk cut at its limit")
    check(bool((outgrown.overflow & (outgrown.pushes > 0)).any()),
          "stress: no lane outgrew its slab mid-walk")
    err = max(r["err"] for _, r in results + stress)
    heaviest_name, heaviest = max(results, key=lambda x: (x[1]["occ"], x[1]["ms"]))
    for group in ("fused IC 64", "fused IC 512", "resident IC 512"):
        times = [r["ms"] for name, r in results if name.startswith(group)]
        if times:
            print(f"{group}: {len(times)} calls, kernel {min(times):.4f}-{max(times):.4f} ms "
                  f"(median {sorted(times)[len(times) // 2]:.4f})")
    print(f"heaviest recorded call: {heaviest_name} | phase 16 in {time.time() - t_phase:.4f} s "
          f"{label}")
    summary = {k: heaviest[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "call_ms",
                                        "chain_floor_ms", "chain_floor_block_ms")}
    summary["call"] = heaviest_name
    return summary, err


class VoteRecorder:
    """While active, wraps K6's wrapper, which both device LCB engines call
    (once a vote call of the resident engine, once an outer step of the
    fused engine), and keeps the VOTE_KEEP heaviest calls per (engine, CAP,
    W) as called (the tier), heaviest by the elements the call votes over
    (its valid rows' live columns, summed, times W; one read of the card a
    call, which the engines do not make), each with a copy of the lane
    columns the vote reads (the walk writes the lanes in place afterwards),
    so that K6 can be held against its plain version at the main path's own
    shapes afterwards.  The wrapper it calls still counts each launch."""

    def __init__(self, torch, lcb_kernels):
        self.torch, self.mod, self.kept, self.engine, self.calls = torch, lcb_kernels, {}, None, 0

    def __enter__(self):
        import dataclasses

        from sibeliaz_tpu_torch.lcb.vote import vote_columns

        real = self.real = self.mod.lcb_vote
        fields = self.mod.VOTE_LANE_FIELDS

        def record(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max=None,
                   retry=False, spilled=None):
            CAPx = vote_columns(CAP, ln.chr.shape[1], n_max)
            live = self.torch.where(valid, ln.n.index_select(0, idx).clamp(max=CAPx), 0)
            weight = int(live.sum()) * W
            self.calls += 1
            kept = self.kept.setdefault((self.engine, CAP, W), [])
            if len(kept) < VOTE_KEEP or weight > kept[-1][0]:
                copy = dataclasses.replace(ln, **{f: getattr(ln, f).clone() for f in fields})
                args = (CAP, W, tb, copy, idx.clone(), valid.clone(), forward.clone(),
                        try_used.clone(), depth, b, n_max, retry)
                kept.append((weight, self.calls, args))
                kept.sort(key=lambda c: (-c[0], c[1]))
                del kept[VOTE_KEEP:]
            return real(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max,
                        retry=retry, spilled=spilled)

        self.mod.lcb_vote = record
        return self

    def __exit__(self, *exc):
        self.mod.lcb_vote = self.real

    def calls_to_replay(self):
        """[(label, arguments)]: each group's kept calls, heaviest first."""
        return [(f"{engine} CAP {CAP} W {W} call {n} ({weight} elements)", args)
                for (engine, CAP, W), kept in sorted(self.kept.items())
                for weight, n, args in kept]


def vote_plain_of(args):
    """The plain version of a recorded or stress K6 call, on its tensors'
    device."""
    from sibeliaz_tpu_torch.lcb import vote

    *call, retry = args
    return (vote.vote_retry_plain if retry else vote.vote_plain)(*call)


def path_sectors(torch, pvid, vid, searched):
    """[A]: the distinct 32-byte sectors of each row's pvid row ([A, PC]
    int64) that the binary searches of its searched slots probe, replayed
    on the host as torch.searchsorted (left, over the whole row) and K6
    run them."""
    A, PC = pvid.shape
    pvid, vid, searched = pvid.cpu(), vid.reshape(A, -1).cpu(), searched.reshape(A, -1).cpu()
    r, q = searched.nonzero(as_tuple=True)
    v = vid[r, q]
    lo, hi = torch.zeros_like(v), torch.full_like(v, PC)
    per_row = PC // 4 + 1
    probes = []
    while True:
        go = lo < hi
        if not bool(go.any()):
            break
        mid = lo + (hi - lo) // 2
        probes.append((r * per_row + mid // 4)[go])
        below = pvid[r, mid.clamp(max=PC - 1)] < v
        lo = torch.where(go & below, mid + 1, lo)
        hi = torch.where(go & ~below, mid, hi)
    if not probes:
        return torch.zeros(A, dtype=torch.int64)
    return torch.bincount(torch.cat(probes).unique() // per_row, minlength=A)


def k6_bound(torch, args, peak_ops):
    """K6's roofline bound on one call's data, as the function must move it
    (counted from vote.window_lengths and vote.searched_slots, the plain
    version's windows): each row's arguments and outputs; each valid row's
    three registers and its live columns' six instance fields; each voting
    instance's end words (chromosome offset, junction id), and for one at
    the lane's path end three positions and a chromosome length more; each
    evaluated window slot's position, junction id and used flag (a window's
    alive length and the slot that ends it, at most W; with the retry, the
    longer of the two votes'); of each row's path row the 32-byte sectors
    its searches probe (path_sectors; with the retry, both votes'); against
    the slots' and the alive entries' operations.  (ms, which, bytes, slots,
    alive entries, path bytes, table bytes)."""
    from sibeliaz_tpu_torch.lcb.vote import vote_columns, searched_slots

    CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max, retry = args
    lens, need = vote_lens(torch, args)
    vid, searched = searched_slots(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b,
                                   n_max)
    if retry:
        # the retry's windows meet the same vids further on: its searched
        # slots join the first vote's
        searched = searched | (need[:, None, None] & searched_slots(
            CAP, W, tb, ln, idx, need, forward, need, depth, b, n_max)[1])
    CAPx = vote_columns(CAP, ln.chr.shape[1], n_max)
    live = int((ln.n.index_select(0, idx).clamp(max=CAPx) * valid).sum())
    windows = lens >= 0
    slots = int((lens + 1).clamp(max=W)[windows].sum())
    entries = int(lens[windows].sum())
    path = 32 * int(path_sectors(torch, ln.pvid.index_select(0, idx), vid, searched).sum())
    tables = k6_table_bytes(int((lens != -1).sum()), int(windows.sum()), slots)
    nbytes = (idx.shape[0] * K6_ROW_BYTES + int(valid.sum()) * K6_REGISTER_BYTES
              + live * K6_COLUMN_BYTES + path + tables)
    ms, by = bound_ms(nbytes, k6_ops(slots, entries), peak_ops)
    return ms, by, nbytes, slots, entries, path, tables


def vote_lens(torch, args):
    """([A, CAPx] window lengths as vote.window_lengths gives them, the
    retried rows or None): with the used-retry, each retried row's longer
    of its two votes' windows."""
    from sibeliaz_tpu_torch.lcb.vote import window_lengths

    CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max, retry = args
    lens = window_lengths(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max)
    if not retry:
        return lens, None
    first = vote_plain_of(args[:-1] + (False,))
    need = valid & forward & (first[0] == 0) & (first[5] == 0)
    again = window_lengths(CAP, W, tb, ln, idx, need, forward, need, depth, b, n_max)
    return torch.where(need[:, None], lens.maximum(again), lens), need


def k6_table_bytes(voters, windows, slots):
    """The table words a vote reads: each voting instance's end words, each
    window's more at the lane's path end, each evaluated slot's."""
    return voters * K6_END_BYTES + windows * K6_WINDOW_BYTES + slots * K6_SLOT_BYTES


def k6_ops(slots, entries):
    return K6_OPS_PER_SLOT * slots + K6_OPS_PER_ENTRY * entries


def k6_vs_plain(torch, lcb_kernels, label, args, peak_ops):
    """K6 against its plain version on one call's arguments on the card:
    best_vid, best_cnt and overflow exact in every row, the origin columns
    where a winner exists; the kernel's card time (the card spun ahead,
    20 launches: the vote reads and writes nothing of its inputs), the
    wrapper's whole call synchronised, the plain version's time and the
    bound.  Returns a dict (with the rows that took the workspace)."""
    from sibeliaz_tpu_torch.lcb.vote import vote_columns

    CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max, retry = args
    A = idx.shape[0]
    spilled = torch.zeros(A, dtype=torch.int64, device="cuda")
    got = lcb_kernels.lcb_vote(*args[:-1], retry=retry, spilled=spilled)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = vote_plain_of(args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    win = want[0] != 0
    err = max(int((a - w).abs().max()) if A else 0
              for a, w in zip(got[:2] + got[5:], want[:2] + want[5:]))
    err = max([err] + [int((a[win] - w[win]).abs().max()) for a, w in zip(got[2:5], want[2:5])
                       if bool(win.any())])
    check(err == 0, f"lcb_vote differs from its plain version ({label}): max abs err {err}")
    out = torch.empty((6, A), dtype=torch.int64, device="cuda")
    tcheck = lcb_kernels._table_check(tb, True)
    CAPx = vote_columns(CAP, ln.chr.shape[1], n_max)
    ms = cuda_ms(torch, lambda: lcb_kernels._launch_vote(
        tcheck, ln, idx, valid, forward, try_used, CAPx, W, tb.k, depth, b, retry, out), 20,
        ahead=True, quiet=True)
    call_s = 0.0
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcb_kernels.lcb_vote(*args[:-1], retry=retry)
        torch.cuda.synchronize()
        call_s += time.perf_counter() - t0
    call_ms = call_s * 1e3 / 10
    bound, by, nbytes, slots, entries, path, _ = k6_bound(torch, args, peak_ops)
    n_spilled = int(spilled.sum())
    print(f"lcb_vote {label}: exact | rows {A} ({int(valid.sum())} valid, {int(win.sum())} "
          f"winners, {int(want[5].sum())} overflows, {n_spilled} through the workspace), CAP "
          f"{CAPx} W {W}{' retry' if retry else ''} | kernel {ms:.4f} ms, whole call "
          f"{call_ms:.4f} ms (host included) | plain {plain_ms:.4f} ms | bound {bound:.6f} ms "
          f"by {by} ({nbytes} bytes, {path} of them path sectors, {slots} window slots, "
          f"{entries} alive entries) = "
          f"{100 * bound / ms:.2f}%")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "call_ms": call_ms, "spilled": spilled.cpu().numpy(), "slots": slots}


def recorded_vote_calls(torch, mods, lcb_kernels):
    """examples/' first phase (256 bundles, k=15) through the fused engine
    (by the host loop: HostLoopRoute) and the resident engine on the card,
    each equal to eng.process, with K6's calls recorded (VoteRecorder) and
    its launches equal to the engines' vote calls."""
    (_cases, _cli, pipeline, _device_poa, _msa, _poa_ref, _kernels, _align_kernels, Config,
     _alphabet, fasta, metrics) = mods
    from sibeliaz_tpu_torch.lcb import fused, resident
    from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

    recs = fasta.read_many([os.path.join(EXAMPLES, "genome1.fa"),
                            os.path.join(EXAMPLES, "genome2.fa")])
    cfg = Config(k=15)
    table = pipeline.build_table([r.seq for r in recs], [r.name for r in recs], cfg,
                                 device="cuda")
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking,
                    cfg.looking_depth)
    bundles = make_bundles_device(table, "cuda")[:256]
    oracle = instance_keys(eng.process(b) for b in bundles)
    with VoteRecorder(torch, lcb_kernels) as rec:
        for engine, fn, counter in (("fused", fused.process_phase_fused, "fused_steps_tier"),
                                    ("resident", resident.process_phase_resident,
                                     "resident_vote_calls")):
            rec.engine = engine
            metrics.counters.clear()
            lcb_kernels.reset_launches()
            t0 = time.time()
            with HostLoopRoute(lcb_kernels) if engine == "fused" else contextlib.nullcontext():
                got = instance_keys(fn(eng, bundles, device="cuda"))
            check(got == oracle, f"examples/ phase 1 through the {engine} engine, recorded: "
                                 "instances differ from eng.process's")
            calls = int(sum(v for k, v in metrics.counters.items() if k.startswith(counter)))
            check(lcb_kernels.LAUNCHES["lcb_vote"] == calls > 0,
                  f"examples/ phase 1, {engine} engine: {lcb_kernels.LAUNCHES['lcb_vote']} "
                  f"lcb_vote launches for {calls} vote calls")
            print(f"examples/ phase 1, {engine} engine, recorded: {time.time() - t0:.4f} s "
                  f"(each vote call read once for its weight), equal to eng.process | "
                  f"{calls} vote calls, {lcb_kernels.LAUNCHES['lcb_vote']} lcb_vote launches")
    return rec


def vote_stress(torch, cases, names=None):
    """The stress set: [(label, K6 arguments)], tests/torch_cases.py's
    VOTE_CASES on the card (mid-phase lanes over a (CAP, W) grid with
    window overflows and lanes past CAP, rows repeated, out of order and
    invalid; hand-laid tie-breaks, path rows, used slots and the table's
    end; rows through the workspace, 16 of them for its 8 slices; the
    300-copy repeat at CAP 512, W 256), or those of `names`, each without
    and with the used-retry."""
    out = []
    for name in names or cases.VOTE_CASES:
        tb, ln, rows, CAP, W, depth, b, n_max = cases.vote_case(name, "cuda")
        for retry in (False, True):
            out.append((f"stress: {name}", (CAP, W, tb, ln, *rows, depth, b, n_max, retry)))
    return out


def host_time(torch, call, setup, sync, reps=20):
    """Host milliseconds a call of `call` (setup() before each, untimed and
    synchronised): to its return (the host's queueing), or with `sync` to
    the card's end of it too."""
    total = 0.0
    for _ in range(reps):
        setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        if sync:
            torch.cuda.synchronize()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e3 / reps


def host_costs(torch, mods, lcb_kernels, vote_args, older):
    """The wrappers' host cost on the card's machine: K6's on `vote_args`
    (a recorded call) and K5's on the stress set's walks cut at 2 pushes
    (every lane a row, a restored state before each call), queueing alone
    and synchronised; each with the tables' checks run every call (their
    cache on the DeviceTables object cleared first: every check each
    call, as before that cache) and once (the cache kept); and,
    where `older` names an older lcb/kernels.py, that module's K5 wrapper
    on the same calls, in turns (older, this, this, older).  Returns
    {name: ms}."""
    import importlib.util

    from sibeliaz_tpu_torch.lcb.batched_push_device import _state_from_leaves, _state_leaves

    cases, pipeline, Config = mods[0], mods[2], mods[8]
    tb, st, *rest = walk_stress(torch, pipeline, Config, cases)[1][1]
    leaves0 = _state_leaves(st)
    st = _state_from_leaves([x.clone() for x in leaves0])

    def restore():
        for x, y in zip(_state_leaves(st), leaves0):
            x.copy_(y)

    wrappers = {"K5": lcb_kernels}
    if older:
        spec = importlib.util.spec_from_file_location("sz_older_lcb_kernels", older)
        wrappers["K5 older"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(wrappers["K5 older"])
    vtb = vote_args[2]
    out = {}
    for who in (["K5 older", "K5", "K5", "K5 older"] if older else ["K5", "K5"]):
        for cold in (True, False):
            def setup():
                restore()
                if cold:
                    tb.__dict__.pop("_kernel_tables", None)

            for sync in (False, True):
                key = f"{who} {'synchronised' if sync else 'queueing'}" + (
                    "" if who == "K5 older" else ", tables every call" if cold else "")
                ms = host_time(torch, lambda: wrappers[who].lcb_walk(tb, st, *rest), setup, sync)
                out[key] = min(ms, out.get(key, ms))
    for cold in (True, False):
        for sync in (False, True):
            def setup():
                if cold:
                    vtb.__dict__.pop("_kernel_tables", None)

            key = (f"K6 {'synchronised' if sync else 'queueing'}"
                   + (", tables every call" if cold else ""))
            out[key] = host_time(torch, lambda: lcb_kernels.lcb_vote(
                *vote_args[:-1], retry=vote_args[-1]), setup, sync)
    print("host cost a call, ms (min of two rounds for K5): " + " | ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    return out


def vote_phase(torch, mods, peak_ops, label, older=None):
    """Phase 17: K6 lcb_vote against its plain version on the card.  The
    vote calls of examples/' first phase (256 bundles, k=15) through the
    fused and the resident engine are recorded (VoteRecorder), and the
    heaviest of each engine and tier replayed; then the stress set, a row
    of which spills to the workspace.  Each exact, with kernel, whole-call
    and plain ms and the bound; the wrappers' host costs (host_costs, with
    an older lcb/kernels.py where given).  Returns the summary of the
    heaviest recorded call (by its bound) and the largest error of all."""
    cases = mods[0]
    from sibeliaz_tpu_torch.lcb import kernels as lcb_kernels

    phase(f"17 K6 lcb_vote against its plain version {label}")
    t_phase = time.time()
    rec = recorded_vote_calls(torch, mods, lcb_kernels)
    calls = rec.calls_to_replay()
    print(f"recorded {rec.calls} vote calls; replaying {len(calls)} | vote blocks an SM: "
          f"{lcb_kernels.vote_blocks_per_sm(1024, 512, 256)} at PC 1024 CAP 512 W 256, "
          f"{lcb_kernels.vote_blocks_per_sm(128, 64, 16)} at PC 128 CAP 64 W 16")
    results = [(name, args, k6_vs_plain(torch, lcb_kernels, name, args, peak_ops))
               for name, args in calls]
    stress = [(name, args, k6_vs_plain(torch, lcb_kernels, name, args, peak_ops))
              for name, args in vote_stress(torch, cases)]
    # the workspace cut to one slice: the spilling rows take it in turn
    pool, lcb_kernels.VOTE_POOL = lcb_kernels.VOTE_POOL, 1
    try:
        crowd = [name for name in cases.VOTE_CASES if name.startswith("spill: 16")]
        stress += [(name + ", one slice", args, k6_vs_plain(
            torch, lcb_kernels, name + ", one slice", args, peak_ops))
            for name, args in vote_stress(torch, cases, crowd)]
    finally:
        lcb_kernels.VOTE_POOL = pool
    spill = [r for name, _, r in stress if name.startswith("stress: spill")]
    check(len(spill) == 6 and all(list(r["spilled"]) == [1, 1, 0] * (len(r["spilled"]) // 3)
                                  for r in spill),
          f"stress: the spill rows did not take the workspace: {[r['spilled'] for r in spill]}")
    held = {str(dev): ws.numel() * 8 for dev, ws in lcb_kernels._WORKSPACE.items()}
    print(f"vote workspace held after phase 17: {held} bytes ({lcb_kernels.VOTE_POOL} slices "
          f"and {lcb_kernels._VOTE_LOCKS} lock words; the largest slice of the calls above)")
    check(not any(r["spilled"].any() for name, _, r in results + stress
                  if not name.startswith("stress: spill")),
          "a row outside the spill case took the workspace")
    err = max(r["err"] for _, _, r in results + stress)
    for group in sorted({" ".join(name.split()[:5]) for name, _, _ in results}):
        times = [r["ms"] for name, _, r in results if name.startswith(group + " ")]
        print(f"{group}: {len(times)} calls, kernel {min(times):.4f}-{max(times):.4f} ms")
    name, args, heaviest = max(results, key=lambda x: (x[2]["bound_ms"], x[2]["ms"]))
    costs = host_costs(torch, mods, lcb_kernels, args, older)
    vote_us = chain_step_us(torch, lcb_kernels)["vote"]
    print(f"heaviest recorded call: {name} | chain floor (one vote of one window round: "
          f"lcb_vote_probe_kernel) {vote_us:.4f} us = {100 * vote_us / 1e3 / heaviest['ms']:.2f}% "
          f"of its kernel time | phase 17 in {time.time() - t_phase:.4f} s {label}")
    summary = {k: heaviest[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "call_ms")}
    summary["call"] = name
    summary["host_ms"] = costs
    summary["chain_floor_ms"] = vote_us / 1e3
    return summary, err


class StepRecorder:
    """While active, wraps K7's wrapper (the fused engine's one call a run)
    and keeps each call's arguments, with a copy of the carry as it was
    before the call (K7 steps it in place), and a copy of what it
    returned.  The wrapper it calls still counts each launch."""

    def __init__(self, lcb_kernels):
        self.mod, self.calls = lcb_kernels, []

    def __enter__(self):
        from sibeliaz_tpu_torch.lcb import step

        real = self.real = self.mod.lcb_step

        def record(CAP, W, slab_max, tb, carry, *rest):
            before = step.carry_map(lambda x: x.clone(), carry)
            out = real(CAP, W, slab_max, tb, carry, *rest)
            got = self.mod.LaneSteps(step.carry_map(lambda x: x.clone(), out.carry),
                                     *(x.clone() for x in out[1:]))
            self.calls.append(((CAP, W, slab_max, tb, before) + tuple(rest), got))
            return out

        self.mod.lcb_step = record
        return self

    def __exit__(self, *exc):
        self.mod.lcb_step = self.real


class LoopTerms:
    """While active, wraps K5's and K6's wrappers (the host loop's calls)
    and sums, on the card, what K7's bound counts of them: K5's pushes,
    occurrence steps and score terms (a push's live instances); K6's voting
    instances, windows at the path end, evaluated slots and alive entries
    (vote_lens, as k6_bound counts them)."""

    def __init__(self, torch, lcb_kernels):
        self.torch, self.mod = torch, lcb_kernels
        self.walk = torch.zeros(3, dtype=torch.int64, device="cuda")
        self.vote = torch.zeros(4, dtype=torch.int64, device="cuda")

    def __enter__(self):
        torch = self.torch
        walk, vote = self.real = self.mod.lcb_walk, self.mod.lcb_vote

        def walked(*args):
            w = walk(*args)
            self.walk = self.walk + torch.stack([w.pushes.sum(), w.occ_steps.sum(),
                                                 (w.pushes * w.n).sum()])
            return w

        def voted(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max=None,
                  retry=False, spilled=None):
            lens, _ = vote_lens(torch, (CAP, W, tb, ln, idx, valid, forward, try_used, depth, b,
                                        n_max, retry))
            windows = lens >= 0
            self.vote = self.vote + torch.stack([
                (lens != -1).sum(), windows.sum(),
                torch.where(windows, (lens + 1).clamp(max=W), 0).sum(),
                torch.where(windows, lens, 0).sum()])
            return vote(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max,
                        retry=retry, spilled=spilled)

        self.mod.lcb_walk, self.mod.lcb_vote = walked, voted
        return self

    def __exit__(self, *exc):
        self.mod.lcb_walk, self.mod.lcb_vote = self.real

    def totals(self):
        """((pushes, occurrence steps, score terms), (voting instances,
        windows, slots, alive entries)) as ints."""
        return tuple(self.walk.tolist()), tuple(self.vote.tolist())


def lane_steps_err(a, b, rows=None):
    """The largest difference between two LaneSteps: every tensor of the
    carry and the lanes' `rows` (by default every row but the spill flag,
    which only the card has)."""
    from sibeliaz_tpu_torch.lcb import step

    rows = rows or [r for r in a._fields[1:] if r != "spilled"]
    pairs = list(zip(step.leaves(a.carry), step.leaves(b.carry))) + [
        (getattr(a, r), getattr(b, r)) for r in rows]
    return max(int((x.long().cpu() - y.long().cpu()).abs().max()) if x.numel() else 0
               for x, y in pairs)


def k7_bound(args, got, walk, vote, peak_ops):
    """K7's roofline bound on one run, as the function must move it: each
    lane that steps has its live slab, best score and snapshot flag and its
    13 registers read once and written once; every lane its four results
    written; one rewind slab written for each lane whose best score rose
    and one result slab for each whose best score rose above 0; and every
    step's table words, the walks' (K5's a push, an occurrence step and a
    score term) and the votes' (k6_table_bytes), as the host loop's calls
    count them (LoopTerms), none of the slab's re-reads; against those
    steps' operations.  (ms, which, bytes)."""
    before = args[4]
    st0, st1 = before["st"], got.carry["st"]
    L, IC = st0.ln.chr.shape
    PC = st0.ln.pvid.shape[1]
    stepped = got.steps > 0
    raised = stepped & (st1.best_score > st0.best_score)
    rewinds, results = int(raised.sum()), int((raised & (st1.best_score > 0)).sum())
    slab = IC * K5_INSTANCE_BYTES + PC * K5_PATH_BYTES + K5_REGISTER_BYTES
    pushes, occ, terms = walk
    voters, windows, slots, entries = vote
    nbytes = (2 * (slab + K5_BEST_BYTES + K7_REGISTER_BYTES) * int(stepped.sum())
              + K7_RESULT_BYTES * L + slab * (rewinds + results)
              + K5_PUSH_BYTES * pushes + K5_STEP_BYTES * occ + K5_SCORE_BYTES * terms
              + k6_table_bytes(voters, windows, slots))
    ops = K5_OPS_PER_STEP * occ + K5_OPS_PER_SCORE_TERM * terms + k6_ops(slots, entries)
    ms, by = bound_ms(nbytes, ops, peak_ops)
    return ms, by, nbytes


def k7_chain_floor(got, step_us):
    """The chain floor of a run: over its lanes, the largest of a lane's
    occurrence steps x K5's step (the "warp" probe) plus its outer steps x
    one vote of one window round (the "vote" probe), in ms; and that lane."""
    us = got.occ_steps.double() * step_us["warp"] + got.steps.double() * step_us["vote"]
    lane = int(us.argmax())
    return float(us[lane]) / 1e3, lane


def restorer(work, before):
    """A function that copies the carry `before` over `work` (the timed
    runs' restore, 81 copies)."""
    from sibeliaz_tpu_torch.lcb import step

    pairs = list(zip(step.leaves(work), step.leaves(before)))

    def restore():
        for x, y in pairs:
            x.copy_(y)

    return restore


def k7_time(torch, lcb_kernels, args, reps=5):
    """K7 on one run's arguments from its carry as it was, restored before
    each launch (untimed): the kernel's card time and the whole call
    (wrapper and launch, synchronised), ms."""
    from sibeliaz_tpu_torch.lcb import step

    CAP, W, slab_max, tb, before, *rest = args
    work = step.carry_map(lambda x: x.clone(), before)
    restore = restorer(work, before)
    out = torch.empty((lcb_kernels.STEP_ROWS, before["active"].shape[0]), dtype=torch.int64,
                      device="cuda")
    ms = cuda_ms(torch, lambda: lcb_kernels.step_launch_into(tb, work, CAP, W, slab_max,
                                                             *rest[:-1], out),
                 reps, ahead=8, quiet=True, setup=restore)
    call_s = 0.0
    for _ in range(reps):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcb_kernels.lcb_step(CAP, W, slab_max, tb, work, *rest)
        torch.cuda.synchronize()
        call_s += time.perf_counter() - t0
    return ms, call_s * 1e3 / reps


def k7_vs_loop(torch, lcb_kernels, label, args, got, peak_ops, step_us):
    """K7's recorded run against the host-loop route on the card from the
    same carry (lcb_step_plain on the card's tensors: K6 and K5 a step),
    every tensor of the carry and the lanes' counts exact; the kernel and
    whole-call times (k7_time), the host loop's (synchronised, alone), the
    bound (its terms counted from a second run of the host loop's calls)
    and the chain floor.  Returns a dict."""
    from sibeliaz_tpu_torch.lcb import step

    CAP, W, slab_max, tb, before, *rest = args
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = step.lcb_step_plain(CAP, W, slab_max, tb, step.carry_map(lambda x: x.clone(), before),
                               *rest)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    with LoopTerms(torch, lcb_kernels) as terms:
        step.lcb_step_plain(CAP, W, slab_max, tb, step.carry_map(lambda x: x.clone(), before),
                            *rest)
    walk, vote = terms.totals()
    err = lane_steps_err(got, loop)
    check(err == 0, f"lcb_step differs from the host loop ({label}): max abs err {err}")
    counted = tuple(int(getattr(got, r).sum()) for r in ("pushes", "occ_steps", "score_terms",
                                                         "voters", "windows", "slots",
                                                         "entries"))
    check(counted == walk + vote, f"lcb_step's counts of its work ({label}) {counted} differ "
          f"from the host loop's calls' {walk + vote}")
    ms, call_ms = k7_time(torch, lcb_kernels, args)
    bound, by, nbytes = k7_bound(args, got, walk, vote, peak_ops)
    floor, lane = k7_chain_floor(got, step_us)
    L = before["active"].shape[0]
    print(f"lcb_step {label}: equal to the host loop | lanes {L} (stepping "
          f"{int((got.steps > 0).sum())}), CAP {CAP} W {W} IC {before['st'].ln.chr.shape[1]} | "
          f"steps {int(got.steps.sum())} (longest lane {int(got.steps.max())}), pushes "
          f"{walk[0]}, occurrence steps {walk[1]}, spilled lanes {int(got.spilled.sum())} | "
          f"kernel {ms:.4f} ms, whole call {call_ms:.4f} ms (host included) | host loop (K6 + K5 "
          f"a step) {loop_ms:.4f} ms | bound {bound:.6f} ms by {by} ({nbytes} bytes; {vote[2]} "
          f"vote slots) = {100 * bound / ms:.4f}% | chain floor {floor:.4f} ms (lane {lane}: "
          f"{int(got.occ_steps[lane])} occurrence steps x {step_us['warp']:.4f} us + "
          f"{int(got.steps[lane])} steps x {step_us['vote']:.4f} us) = {100 * floor / ms:.2f}%")
    return {"err": err, "ms": ms, "call_ms": call_ms, "loop_ms": loop_ms, "bound_ms": bound,
            "bound_by": by, "chain_floor_ms": floor}


def to_cpu(tb, carry):
    """A run's tables and carry, copied to the host."""
    from sibeliaz_tpu_torch.lcb import step

    fields = {f: getattr(tb, f) for f in type(tb).__dataclass_fields__}
    tables = type(tb)(**{f: v.cpu() if hasattr(v, "cpu") else v for f, v in fields.items()})
    return tables, step.carry_map(lambda x: x.cpu(), carry)


def k7_split(torch, lcb_kernels, label, args, got):
    """The split of one run's steps: the stamped build's K7
    (csrc/step_stamps.cuh, built on first use beside the default library)
    from the restored carry, exact against the run; for the lane of the
    most cycles, each part in microseconds a step of that lane (its cycles
    over the clock that lane's total and the stamped launch's time give)
    and the counts a step.  Returns {part: us a step} with "clock_mhz"."""
    from sibeliaz_tpu_torch.lcb import step

    CAP, W, slab_max, tb, before, *rest = args
    work = step.carry_map(lambda x: x.clone(), before)
    restore = restorer(work, before)
    L = before["active"].shape[0]
    out = torch.empty((lcb_kernels.STEP_ROWS, L), dtype=torch.int64, device="cuda")
    parts = lcb_kernels.STAMP_PARTS
    stamps = torch.zeros((len(parts), L), dtype=torch.int64, device="cuda")
    ms = cuda_ms(torch, lambda: lcb_kernels.step_launch_into(
        tb, work, CAP, W, slab_max, *rest[:-1], out, stamps=stamps), 3, quiet=True,
                 setup=restore)
    err = lane_steps_err(got, lcb_kernels.LaneSteps(work, *out))
    check(err == 0, f"the stamped lcb_step differs from the run ({label}): {err}")
    sums = stamps.cpu()
    at = {p: q for q, p in enumerate(parts)}
    lane = int(sums[at["total"]].argmax())
    steps = int(out[0, lane])
    start, end = sums[at["ns_start"]], sums[at["ns_end"]]
    lane_ns = float(end[lane] - start[lane])
    mhz = float(sums[at["total"], lane]) / lane_ns * 1e3
    timed = parts[:at["total"] + 1]
    us = {p: float(sums[at[p], lane]) / mhz / steps for p in timed}
    us["other"] = us["total"] - sum(us[p] for p in timed[:-1])
    per = {p: float(sums[at[p], lane]) / steps for p in parts[at["total"] + 1:at["walk_waits"]]}
    for p in ("walk_waits", "walk_occ", "walk_issue"):  # within the pushes and stores
        us[p] = float(sums[at[p], lane]) / mhz / steps
    for p in ("inserts", "block_shifts"):
        per[p] = float(sums[at[p], lane]) / steps
    stepped = out[0].cpu() > 0
    late = int(((start - start.min()) > int(0.5 * lane_ns))[stepped].sum())
    print(f"lcb_step split {label}: stamped kernel {ms:.4f} ms, exact | lane {lane}: {steps} "
          f"steps, {float(sums[at['total'], lane]):.0f} cycles in {lane_ns / 1e6:.4f} ms = "
          f"{mhz:.1f} MHz; blocks span {float(end.max() - start.min()) / 1e6:.4f} ms, the lane "
          f"starts at {float(start[lane] - start.min()) / 1e6:.4f} ms, {late} of "
          f"{int(stepped.sum())} stepping lanes start past half its time | us a step: "
          + ", ".join(f"{p} {v:.4f}" for p, v in us.items()) + " | a step: "
          + ", ".join(f"{p} {v:.4f}" for p, v in per.items())
          + f" | voters a vote {per['voters'] / max(per['votes'], 1e-9):.2f}")
    t0 = start.min()
    ends = sorted(range(L), key=lambda q: -int(end[q]))[:6]
    print("  the last blocks to end (lane: SM, steps, start-end ms, its cycles as ms): " + "; ".join(
        f"{q}: {int(sums[at['sm'], q])}, {int(out[0, q])}, {float(start[q] - t0) / 1e6:.3f}-"
        f"{float(end[q] - t0) / 1e6:.3f}, {float(sums[at['total'], q]) / mhz / 1e3:.3f}"
        for q in ends) + f" | SMs used {len(set(sums[at['sm']].tolist()))}")
    return dict(us, clock_mhz=mhz)


def build_older_k7(cudabuild, lcb_kernels, out_dir, older):
    """An older K7 of the same C interface (sz_lcb_step with the stamps
    pointer, given null) whose out rows are the first four of LaneSteps', from
    the directory `older` holding its lcb_step.cu, lcb_vote.cu,
    lcb_vote.cuh, lcb_walk.cuh and step_stamps.cuh, built alone with nvcc;
    its -Xptxas -v report printed.  A function (tables, carry, CAP, W,
    slab_max, depth, m, b, flank, min_run, steps_limit, walk_chunk, out)
    that launches it on a carry lcb_step has checked."""
    lib = os.path.join(out_dir, "k7_older.so")
    sources = [os.path.join(older, f) for f in ("lcb_step.cu", "lcb_vote.cu")]
    proc = subprocess.run([cudabuild._nvcc(), *cudabuild.NVCC_FLAGS, "-shared", "-o", lib,
                           *sources], capture_output=True, text=True)
    check(proc.returncode == 0, f"K7 {older} did not build:\n{proc.stderr}")
    print(f"K7 {older}:")
    print_ptxas(proc.stderr)
    cdll = ctypes.CDLL(lib)
    fn, words_of = cdll.sz_lcb_step, cdll.sz_lcb_step_workspace_words
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([vp] * 6 + [i32, i64, i32, i32, i64, i32] + [i64] * 6
                   + [i32, i64, i64, i32, vp, vp])
    fn.restype = ctypes.c_int
    words_of.argtypes, words_of.restype = [i32] * 4, i64

    def launch(tb, carry, CAP, W, slab_max, depth, m, b, flank, min_run, steps_limit,
               walk_chunk, out):
        import torch
        from sibeliaz_tpu_torch.lcb.batched_push_device import _state_leaves

        st = carry["st"]
        L, IC = st.ln.chr.shape
        PC = st.ln.pvid.shape[1]
        words = words_of(IC, PC, CAP, W)
        pool = min(lcb_kernels.VOTE_POOL, L)
        ws = lcb_kernels._vote_workspace(st.ln.chr.device, words * pool) if words else None
        tcheck = lcb_kernels._table_check(tb, True)
        lens = tcheck.lens
        arrays = [lcb_kernels._array([x.data_ptr() for x in _state_leaves(st)]),
                  lcb_kernels._array([carry[r].data_ptr() for r in lcb_kernels.CARRY_REGISTERS]),
                  tcheck.ptrs, lcb_kernels._array(lens[:3] + lens[4:10])]
        status = fn(*(ctypes.cast(a, ctypes.c_void_p) for a in arrays),
                    ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(0 if ws is None else ws.data_ptr()), pool, L, IC, PC, CAP,
                    W, tb.k, depth, m, b, flank, min_run, int(slab_max), carry["steps"],
                    steps_limit, walk_chunk, ctypes.c_void_p(0),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        check(status == 0, f"K7 {older}: CUDA error {status}")

    return launch


def k7_older_vs_new(torch, lcb_kernels, label, args, got, older_launch, reps=5):
    """The older K7 and this one on one run's arguments, each launch from
    the restored carry (the restore untimed), in turns (older, new, new,
    older), each exact against the run.  Returns {"older": [ms, ms],
    "new": [ms, ms]}."""
    from sibeliaz_tpu_torch.lcb import step

    CAP, W, slab_max, tb, before, *rest = args
    work = step.carry_map(lambda x: x.clone(), before)
    restore = restorer(work, before)
    out = torch.empty((lcb_kernels.STEP_ROWS, before["active"].shape[0]), dtype=torch.int64,
                      device="cuda")
    launches = {"new": lambda: lcb_kernels.step_launch_into(tb, work, CAP, W, slab_max,
                                                            *rest[:-1], out),
                "older": lambda: older_launch(tb, work, CAP, W, slab_max, *rest[:-1], out)}
    times = {}
    for who in ("older", "new", "new", "older"):
        times.setdefault(who, []).append(cuda_ms(torch, launches[who], reps, ahead=8, quiet=True,
                                                 setup=restore))
        # the older K7 writes the first four rows
        err = lane_steps_err(got, lcb_kernels.LaneSteps(work, *out),
                             ("steps", "pushes", "occ_steps"))
        check(err == 0, f"K7 ({who}) differs from the run ({label}): {err}")
    print(f"lcb_step {label}, older / this K7 in turns (older, this, this, older), exact: "
          + " | ".join(f"{who} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                       for who, ts in times.items())
          + f" | {min(times['older']) / min(times['new']):.2f}x")
    return times


def step_hand_laid(torch, lcb_kernels, cases):
    """K7 on tests/torch_cases.py's STEP_CASES against the plain version
    on the CPU from the same carry, exact, and what each case is laid for;
    the largest error."""
    err = 0
    for name in cases.STEP_CASES:
        tb, carry, a = cases.step_case(name, "cuda")
        tb_cpu, carry_cpu, _ = cases.step_case(name, "cpu")
        args = (a["CAP"], a["W"], a["slab_max"])
        rest = (a["depth"], a["m"], a["b"], a["flank"], a["min_run"], a["steps_limit"],
                a["walk_chunk"], a["compact_min"])
        before = lcb_kernels.LAUNCHES["lcb_step"]
        got = lcb_kernels.lcb_step(*args, tb, carry, *rest)
        check(lcb_kernels.LAUNCHES["lcb_step"] == before + 1, f"K7 {name}: not one launch")
        want = lcb_kernels.lcb_step(*args, tb_cpu, carry_cpu, *rest)
        e = lane_steps_err(got, want)
        check(e == 0, f"lcb_step differs from the plain version (hand-laid {name}): {e}")
        c = got.carry
        laid = {"spill": lambda: int(got.spilled[0]) == 1,
                "cap_overflow": lambda: bool(c["retier"].any()),
                "slab_overflow": lambda: bool(c["hostfb"].any()),
                "long_walks": lambda: int(got.pushes.max()) > 2 * a["walk_chunk"],
                "step_limit": lambda: int(got.steps.max()) == 3 and bool(c["active"].any()),
                "wide": lambda: (c["st"].ln.chr.shape[1], c["st"].ln.pvid.shape[1]) == (512, 1024)
                and not bool(c["active"].any()) and int(got.pushes.sum()) > 0}
        check(laid[name](), f"K7 hand-laid {name}: not what it is laid for")
        print(f"lcb_step hand-laid {name}: equal to the plain version | steps "
              f"{int(got.steps.sum())} (longest {int(got.steps.max())}), pushes "
              f"{int(got.pushes.sum())} (most {int(got.pushes.max())}), spilled "
              f"{int(got.spilled.sum())}, retier {int(c['retier'].sum())}, hostfb "
              f"{int(c['hostfb'].sum())}, still active {int(c['active'].sum())}")
        err = max(err, e)
    return err


def step_phase(torch, mods, peak_ops, label, split=False, older=None, out_dir=None):
    """Phase 18: K7 lcb_step on the card.  examples/' first phase (256
    bundles, k=15) through the fused engine with K7's calls recorded
    (StepRecorder), equal to eng.process; each recorded run (every tier)
    held to the host-loop route from the same carry (K6 and K5 a step,
    k7_vs_loop) with its times, bound and chain floor; the heaviest run
    held to the plain version on the CPU, timed; the hand-laid set; the
    step blocks an SM in both shared-memory layouts.  With `split`, each
    run's split from the stamped build (k7_split) and, with `older` (a
    directory of an older K7's sources), that K7 timed beside this one
    (build_older_k7, k7_older_vs_new).  Returns the summary of the
    heaviest run and the largest error."""
    (cases, _cli, pipeline, _device_poa, _msa, _poa_ref, _kernels, _align_kernels, Config,
     _alphabet, fasta, metrics) = mods
    from sibeliaz_tpu_torch.lcb import fused
    from sibeliaz_tpu_torch.lcb import kernels as lcb_kernels
    from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

    phase(f"18 K7 lcb_step against the host loop and its plain version {label}")
    t_phase = time.time()
    from sibeliaz_tpu_torch.utils import cudabuild

    check(cudabuild.load().sz_lcb_step_stamp_parts() == 0, "the default build carries stamps")
    for IC, PC, CAP, W in ((64, 128, 64, 32), (512, 1024, 512, 32), (512, 1024, 512, 256)):
        print(f"step blocks an SM at IC {IC} PC {PC} CAP {CAP} W {W}: " + ", ".join(
            "{} ({} shared bytes) {}".format(*lcb_kernels.step_blocks_per_sm(IC, PC, CAP, W, lay),
                                            what)
            for lay, what in ((1, "the slab resident beside the vote's region, the kernel's"),
                              (0, "PR 20's layout, the vote's region and the slab in turn"))))
    recs = fasta.read_many([os.path.join(EXAMPLES, "genome1.fa"),
                            os.path.join(EXAMPLES, "genome2.fa")])
    cfg = Config(k=15)
    table = pipeline.build_table([r.seq for r in recs], [r.name for r in recs], cfg,
                                 device="cuda")
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking,
                    cfg.looking_depth)
    bundles = make_bundles_device(table, "cuda")[:256]
    oracle = instance_keys(eng.process(b) for b in bundles)
    metrics.counters.clear()
    lcb_kernels.reset_launches()
    with StepRecorder(lcb_kernels) as rec:
        got = instance_keys(fused.process_phase_fused(eng, bundles, device="cuda"))
    check(got == oracle, "examples/ phase 1, recorded: instances differ from eng.process's")
    check(lcb_kernels.LAUNCHES["lcb_step"] == len(rec.calls) == metrics.counters["fused_runs"],
          f"examples/ phase 1: launches {lcb_kernels.LAUNCHES} for {len(rec.calls)} runs")
    print(f"examples/ phase 1, recorded: {len(rec.calls)} K7 runs, equal to eng.process | "
          f"{fused_counters(metrics)}")
    step_us = chain_step_us(torch, lcb_kernels)
    print(f"chain probes: {step_us['warp']:.4f} us a walk's occurrence step, "
          f"{step_us['vote']:.4f} us a vote of one window round")
    results = []
    for q, (args, run) in enumerate(rec.calls):
        name = (f"run {q + 1} (CAP {args[0]} W {args[1]}, {int(run.carry['active'].numel())} "
                "lanes)")
        results.append((name, args, run, k7_vs_loop(torch, lcb_kernels, name, args, run,
                                                    peak_ops, step_us)))
    if split:
        older_launch = (build_older_k7(cudabuild, lcb_kernels, out_dir, older) if older
                        else None)
        for name, args, run, _ in results:
            k7_split(torch, lcb_kernels, name, args, run)
            if older_launch:
                k7_older_vs_new(torch, lcb_kernels, name, args, run, older_launch)
    name, args, run, heaviest = max(results, key=lambda x: x[3]["ms"])
    tb_cpu, carry_cpu = to_cpu(args[3], args[4])
    t0 = time.perf_counter()
    plain = lcb_kernels.lcb_step(*args[:3], tb_cpu, carry_cpu, *args[5:])
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = lane_steps_err(run, plain)
    check(err == 0, f"lcb_step differs from its plain version on the CPU ({name}): {err}")
    print(f"lcb_step {name}: equal to the plain version on the CPU ({plain_ms:.4f} ms)")
    err = max([err, step_hand_laid(torch, lcb_kernels, cases)]
              + [r["err"] for _, _, _, r in results])
    print(f"heaviest run: {name} | phase 18 in {time.time() - t_phase:.4f} s {label}")
    summary = {k: heaviest[k] for k in ("ms", "bound_ms", "bound_by", "call_ms", "loop_ms",
                                        "chain_floor_ms")}
    summary.update(plain_ms=plain_ms, call=name)
    return summary, err


def seed_phase(torch, mods, peak_ops, label):
    """`--seed`: K8 lcb_seed on examples/large's first phase (256 lanes,
    k=25) at IC 64, PC 128 and IC 512, PC 1024: equal to its plain version
    on the card; its card time alone, its bound and share; the host wall
    of the seeding it replaced and of K8's whole call.  Returns {shape:
    summary}."""
    cases = mods[0]
    from sibeliaz_tpu_torch.lcb import fused, resident, step
    from sibeliaz_tpu_torch.lcb import kernels as lcb_kernels

    phase(f"K8 lcb_seed on examples/large's first phase, 256 lanes {label}")
    out = {}
    for name in ("large_narrow", "large_wide"):
        eng, bundles, L, IC, PC, seeds = cases.seed_case(name, "cuda")
        tb = resident._device_tables(eng, "cuda")
        nb = len(seeds)
        carry, ovf = lcb_kernels.lcb_seed(tb, seeds, L, IC, PC)
        lanes = torch.zeros((2, L), dtype=torch.int64)
        lanes[:, :nb] = torch.from_numpy(seeds.T)
        want, want_ovf = step.lcb_seed_plain(tb, lanes.cuda(), nb, IC, PC)
        torch.cuda.synchronize()
        diff = cases.state_diff(carry, want)
        check(not diff and torch.equal(ovf, want_ovf),
              f"lcb_seed differs from its plain version at IC {IC}: {diff[:4]}")
        plan = lcb_kernels.seed_plan(L, IC, PC)
        bufs = [lcb_kernels.SeedOutputs(L, IC, PC, "cuda")
                for _ in range(max(2, -(-K8_TIMED_BYTES // plan.nbytes)))]
        for buf in bufs:
            buf.args.copy_(lanes.view(-1))
        turn = iter(range(1 << 30))

        def launch():
            lcb_kernels.seed_launch_into(tb, bufs[next(turn) % len(bufs)], nb)

        gc.disable()  # a full collection (the table's and bundles' objects) outlasts the spin
        try:
            ms = cuda_ms(torch, launch, 10 * len(bufs), ahead=2)
        finally:
            gc.enable()
        count = np.diff(eng.t.occ_off)[np.abs(seeds[:, 0])]
        span = int(np.minimum(count, IC).sum())
        written = plan.nbytes - 16 * L
        nbytes = written + L * K8_LANE_BYTES + span * K8_OCC_BYTES
        bound, by = bound_ms(nbytes, 0, peak_ops)

        def old():
            ln, _, ovf_t = resident._seed_lanes_device(tb, bundles, L, IC, PC)
            seed_ovf = ovf_t.cpu().numpy()
            active0 = (np.arange(L) < nb) & ~seed_ovf
            fused._init_carry(resident.seed_state(ln), torch.from_numpy(active0).cuda(), L)

        def k8():
            lcb_kernels.lcb_seed(tb, seeds, L, IC, PC)

        def k8_kept():
            lcb_kernels.lcb_seed(tb, seeds, L, IC, PC, into=bufs[0])

        def outputs():
            lcb_kernels.SeedOutputs(L, IC, PC, "cuda")

        def refresh():
            resident._device_tables(eng, "cuda")

        host = {}
        for traced in (False, True):
            with seed_profiler(torch, traced):
                for what, fn, sync in (("replaced", old, True), ("k8", k8, False),
                                       ("k8_sync", k8, True), ("k8_kept", k8_kept, False),
                                       ("k8_kept_sync", k8_kept, True),
                                       ("outputs", outputs, False), ("refresh", refresh, True)):
                    host[what + ("_traced" if traced else "")] = host_median(torch, fn, sync)
        shape = f"IC {IC} PC {PC}"
        out[shape] = dict(ms=ms, bound_ms=bound, share=bound / ms, bytes=nbytes,
                          written=written, host_ms=host)
        print(f"lcb_seed {shape}, {L} lanes ({nb} bundles, {int(ovf.sum())} past IC, "
              f"{span} window occurrences): equal to the plain version | card "
              f"{ms:.4f} ms ({len(bufs)} buffers in turn) | bound {bound:.4f} ms by {by} "
              f"({nbytes:,} B: {written:,} written, {span * K8_OCC_BYTES + L * K8_LANE_BYTES:,} "
              f"read) = {100 * bound / ms:.2f}% {label}")
        print("  host ms, medians (untraced / under a torch.profiler of CPU and CUDA "
              "activity, as portbench's traced runs): the seeding it replaced, synchronised "
              f"{host['replaced']:.4f} / {host['replaced_traced']:.4f}; K8's copy, launch and "
              f"wrapper into new outputs, to its return {host['k8']:.4f} / "
              f"{host['k8_traced']:.4f}, synchronised {host['k8_sync']:.4f} / "
              f"{host['k8_sync_traced']:.4f} (of it the outputs' allocation and views "
              f"{host['outputs']:.4f} / {host['outputs_traced']:.4f}); into kept outputs (the "
              f"engine's), to its return {host['k8_kept']:.4f} / {host['k8_kept_traced']:.4f}, "
              f"synchronised {host['k8_kept_sync']:.4f} / {host['k8_kept_sync_traced']:.4f}; a "
              f"phase's table refresh, synchronised {host['refresh']:.4f} / "
              f"{host['refresh_traced']:.4f}")
    return out


@contextlib.contextmanager
def seed_profiler(torch, on):
    """A torch.profiler of CPU and CUDA activity where `on` (portbench's
    traced runs' settings), else nothing."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        yield


def host_median(torch, fn, sync, reps=41):
    """The median host milliseconds of a call of `fn` (after a warm-up
    call; the card idle before each), to its return or with `sync` to the
    card's end of it too."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times[1:])[reps // 2] * 1e3


def joined_junction_positions(seqs, recs):
    """The records' junction positions in the joined genome (one N between
    chromosomes), and the sign of each position's id."""
    off = np.cumsum([0] + [len(x) + 1 for x in seqs[:-1]])
    pos = np.concatenate([o + r.pos.astype(np.int64) for o, r in zip(off, recs)])
    return pos, np.concatenate([r.ids for r in recs]) > 0


def devices_phase(torch, mods, label):
    """Phase 14: (a) examples/' first phase (256 bundles, k=15) with the
    fused lanes over ["cuda:0", "cuda:0"] beside the one-device run on the
    card, both equal to eng.process, bundle by bundle; (b) the dry run
    (sibeliaz_tpu_torch.dryrun) on cuda:0,cuda:0, every stage passing;
    (c) entry() on the card equal to its CPU run, launching K1 and K2 once
    each, and junction_analysis on the strains' 16,000,015 positions at
    k=15 and 33 equal to build_junctions' records (the junction positions
    and the sign of each position's id).  Returns the launches of the dry
    run and of entry()."""
    (_cases, _cli, pipeline, _device_poa, _msa, _poa_ref, kernels, align_kernels, Config,
     alphabet, fasta, metrics) = mods
    from sibeliaz_tpu_torch import dryrun
    from sibeliaz_tpu_torch.graph import construct
    from sibeliaz_tpu_torch.lcb import fused
    from sibeliaz_tpu_torch.lcb import kernels as lcb_kernels
    from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

    def reset():
        kernels.reset_launches()
        align_kernels.reset_launches()
        lcb_kernels.reset_launches()

    phase(f"14a examples/' first phase, the fused lanes over [cuda:0, cuda:0] {label}")
    recs = fasta.read_many([os.path.join(EXAMPLES, "genome1.fa"),
                            os.path.join(EXAMPLES, "genome2.fa")])
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    cfg = Config(k=15)
    table = pipeline.build_table(seqs, names, cfg, device="cuda")
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking,
                    cfg.looking_depth)
    bundles = make_bundles_device(table, "cuda")[:256]
    runs = {}
    for how, where in (("one device", {"device": "cuda"}),
                       ("two slices", {"devices": ["cuda:0", "cuda:0"]})):
        metrics.counters.clear()
        reset()
        t0 = time.time()
        runs[how] = instance_keys(fused.process_phase_fused(eng, bundles, **where))
        print(f"examples/ phase 1, {how} {where}: {time.time() - t0:.4f} s | "
              f"{fused_counters(metrics)} | launches {lcb_kernels.LAUNCHES} {label}")
    slices_launches = dict(lcb_kernels.LAUNCHES)
    check(slices_launches["lcb_step"] == metrics.counters["fused_runs"] > 0,
          f"examples/ phase 1 over two slices: launches {slices_launches}")
    check(runs["two slices"] == runs["one device"], "examples/ phase 1: the two slices' "
          "instances differ from the one-device run's")
    check(runs["two slices"] == instance_keys(eng.process(b) for b in bundles),
          "examples/ phase 1: the two slices' instances differ from eng.process's")
    check(list(eng._fused_tb) == [torch.device("cuda", 0)],
          f"examples/ phase 1: the tables are cached for {list(eng._fused_tb)}, not once for cuda:0")
    print(f"examples/ phase 1: {len(bundles)} bundles equal over two slices, on one device and "
          "through eng.process")

    phase(f"14b the dry run on cuda:0,cuda:0 {label}")
    reset()
    t0 = time.time()
    check(dryrun.dryrun(["cuda:0", "cuda:0"]), "the dry run on cuda:0,cuda:0: a stage failed")
    launches = {"examples/ phase 1 over [cuda:0, cuda:0]": slices_launches,
                "dry run on cuda:0,cuda:0": {**kernels.LAUNCHES, **align_kernels.LAUNCHES,
                                             **lcb_kernels.LAUNCHES}}
    check(launches["dry run on cuda:0,cuda:0"]["lcb_step"] > 0,
          f"the dry run: launches {launches['dry run on cuda:0,cuda:0']}")
    print(f"the dry run on cuda:0,cuda:0: every stage passes in {time.time() - t0:.4f} s | "
          f"launches {launches['dry run on cuda:0,cuda:0']} {label}")

    phase(f"14c entry() and junction_analysis on the card {label}")
    fn, args = dryrun.entry("cuda")
    fn(*args)
    torch.cuda.synchronize()
    reset()
    t0 = time.time()
    got = fn(*args)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launched = {**kernels.LAUNCHES, **align_kernels.LAUNCHES}
    check(launched == {"front_half": 1, "class_analysis": 1, "round_append": 0,
                       "poa_dp_tb": 0}, f"entry(): launches {launched}")
    launches["entry()"] = launched
    cfn, cargs = dryrun.entry("cpu")
    want = cfn(*cargs)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
          "entry(): the card's flags or first indices differ from the CPU run's")
    print(f"entry(): junction_analysis of 65,536 positions at k=25 on the card in {secs:.4f} s "
          f"(warm), equal to its CPU run | {int(got[0].sum())} junctions | launches {launched} "
          f"{label}")
    strains = [r.seq for r in bench_strains(alphabet, fasta)]
    codes = torch.from_numpy(strains_codes(alphabet, fasta)).cuda()
    for k in (15, 33):
        want_pos, want_sign = joined_junction_positions(
            strains, construct.build_junctions(strains, k, "cuda"))
        torch.cuda.synchronize()
        t0 = time.time()
        isj, positive, first = construct.junction_analysis(codes, k)
        torch.cuda.synchronize()
        secs = time.time() - t0
        jpos = torch.nonzero(isj).squeeze(1)
        check(np.array_equal(jpos.cpu().numpy(), want_pos),
              f"strains k={k}: junction_analysis's junctions differ from build_junctions'")
        check(np.array_equal(positive[jpos].cpu().numpy(), want_sign),
              f"strains k={k}: junction_analysis's orientations differ from the ids' signs")
        print(f"strains k={k}: junction_analysis of {codes.shape[0]} positions in {secs:.4f} s, "
              f"{len(want_pos)} junctions and their orientations equal to build_junctions' "
              f"records {label}")
    return launches


def int32_peak():
    """The card's peak 32-bit integer rate, operations per second: 132 SMs x
    64 int32 lanes x the highest SM clock nvidia-smi reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    print(f"int32 peak: {SMS} SMs x {INT32_LANES_PER_SM} lanes x {mhz:.0f} MHz = "
          f"{SMS * INT32_LANES_PER_SM * mhz * 1e6 / 1e12:.4f} T operations/s; "
          f"device memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return SMS * INT32_LANES_PER_SM * mhz * 1e6


K3_ARG_NAMES = ("seq0p", "seq_len", "node_char", "pred_idx", "pred_ok", "sink_mask", "off")
K3_OUT_NAMES = ("out_r", "out_i", "tcount", "best_sc")


def k3_replay(torch, dev, mods, directory, peak_ops, tmp_dir):
    """The development loop of K3 (--k3-replay DIR): hold the kernel against
    the plain version's outputs on the two main-path dispatches and time it,
    without the minutes of host Python and plain DP that produce them.  The
    first run records both dispatches and the plain outputs into DIR as
    .npz files; later runs load them.  Both, and the smaller seeded
    buckets, also run at every other launch shape (columns per thread, ring
    depth), which is how launch_config's choices were made."""
    (cases, cli, pipeline, device_poa, msa, poa_ref, kernels, align_kernels, Config,
     alphabet, fasta, metrics) = mods
    os.makedirs(directory, exist_ok=True)
    paths = {n: os.path.join(directory, n + ".npz") for n in ("examples", "large")}
    if not all(os.path.exists(q) for q in paths.values()):
        phase("recording the main path's K3 dispatches")
        _n, ex_args = golden_mafs(torch, cli, metrics, kernels, align_kernels,
                                  os.path.join(tmp_dir, "maf"))
        large_fa = regenerate_large(alphabet, fasta, tmp_dir)
        _n, large_args = large_alignment(
            torch, large_fa, fasta, pipeline, Config, msa, metrics, kernels,
            align_kernels, os.path.join(tmp_dir, "large_maf"), engines=("tpu",))
        for name, args in (("examples", ex_args), ("large", large_args)):
            want = align_kernels.poa_dp_tb_plain(*args)
            arrays = dict(zip(K3_ARG_NAMES, (*args[:6], args[9])))
            arrays.update(zip(K3_OUT_NAMES, want))
            np.savez_compressed(paths[name], dims=np.asarray(args[6:9]),
                                **{k: v.cpu().numpy() for k, v in arrays.items()})
            print(f"recorded {paths[name]}: {os.path.getsize(paths[name])} bytes")
    phase("K3 on the recorded main-path dispatches")
    for name, path in paths.items():
        z = np.load(path)
        t = {k: torch.from_numpy(z[k]).to(dev) for k in K3_ARG_NAMES + K3_OUT_NAMES}
        n_max, W, P = (int(x) for x in z["dims"])
        args = (*(t[k] for k in K3_ARG_NAMES[:6]), n_max, W, P, t["off"])
        want = [t[k] for k in K3_OUT_NAMES]
        k3_vs_plain(torch, align_kernels, args, f"recorded {name} dispatch", peak_ops,
                    want=want, reps=5)
        for depth in (1, 2, 4, 8, 16):
            print(f"  a ring of depth {depth} would serve "
                  f"{100 * ring_hit_share(torch, align_kernels, args, depth):.4f}%")
        k3_sweep(torch, align_kernels, args, want)
    phase("K3 on the seeded buckets")
    compare_poa(torch, dev, cases, device_poa, poa_ref, align_kernels, peak_ops,
                kinds=K3_BUCKETS[:6], sweep=True)


def main(argv):
    import torch

    replay_dir = time_kinds = None
    k2_time = argv == ["--k2-time"]
    k1_time = argv == ["--k1-time"]
    k4_time_args = argv[1:] if argv[:1] == ["--k4-time"] and len(argv) <= 2 else None
    k5_time_args = argv[1:] if argv[:1] == ["--k5-time"] and len(argv) <= 2 else None
    sharded_only = argv == ["--sharded"]
    fused_only = argv == ["--fused"]
    dryrun_only = argv == ["--dryrun"]
    resident_only = argv == ["--resident"]
    walk_only = argv == ["--walk"]
    vote_args = argv[1:] if argv[:1] == ["--vote"] and len(argv) <= 2 else None
    step_args = argv[1:] if argv[:1] == ["--step"] and len(argv) <= 2 else None
    seed_only = argv == ["--seed"]
    if argv[:1] == ["--k3-replay"] and len(argv) == 2:
        replay_dir = argv[1]
    elif argv[:1] == ["--k3-time"] and len(argv) == 2:
        time_kinds = argv[1].split(",")
    elif argv and not (k2_time or k1_time or sharded_only or fused_only or dryrun_only
                       or resident_only or walk_only or seed_only or step_args is not None
                       or k4_time_args is not None
                       or k5_time_args is not None or vote_args is not None):
        print("usage: python3 chip_smoke.py [--k3-replay DIR | --k3-time KIND[,KIND...] | "
              "--k2-time | --k1-time | --k4-time [OLDER_ROUND_APPEND.cu] | --sharded | "
              "--fused | --dryrun | --resident | --walk | --k5-time [OLDER_LCB_WALK.cu] | "
              "--vote [OLDER_LCB_KERNELS.py] | --step [OLDER_K7_DIR] | --seed]",
              file=sys.stderr)
        return 2
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
    peak_ops = int32_peak()

    if time_kinds is not None:
        k3_time(torch, dev, torch_cases, device_poa, poa_ref, align_kernels, time_kinds)
        print(smi)
        return 0
    if k1_time:
        sets = k1_sets(torch, dev, alphabet, construct, fasta)
        k1_vs_plain(torch, kernels, sets, peak_ops)
        print(smi)
        return 0
    if k2_time:
        k2_vs_plain(torch, kernels, k2_row_sets(torch, dev, alphabet, construct, kernels, fasta),
                    peak_ops)
        print(smi)
        return 0
    if k4_time_args is not None:
        k4_time(torch, dev, alphabet, construct, kernels, cudabuild, peak_ops, tmp.name,
                k4_time_args[0] if k4_time_args else None)
        tmp.cleanup()
        print(smi)
        return 0

    phase("2 build")
    t0 = time.time()
    lib_path, ptxas = cudabuild.build()
    print(f"kernels built in {time.time() - t0:.1f} s: {os.path.relpath(lib_path, REPO)}")
    print_ptxas(ptxas)
    t0 = time.time()
    engine.ensure_built()
    print(f"native LCB engine built in {time.time() - t0:.1f} s")
    t0 = time.time()
    msa.ensure_built()
    print(f"native POA engine built in {time.time() - t0:.1f} s")

    mods = (torch_cases, cli, pipeline, device_poa, msa, poa_ref, kernels, align_kernels, Config,
            alphabet, fasta, metrics)
    if replay_dir is not None:
        k3_replay(torch, dev, mods, replay_dir, peak_ops, tmp.name)
        tmp.cleanup()
        print(smi)
        return 0
    if sharded_only:
        large_fa = regenerate_large(alphabet, fasta, tmp.name)
        with open(os.path.join(EXAMPLES, "large", "sibeliaz_out", "blocks_coords.gff"),
                  "rb") as g:
            large_golden = hashlib.sha256(g.read()).hexdigest()
        bench_fa = os.path.join(tmp.name, "strains.fa")
        fasta.write_fasta(bench_fa, bench_strains(alphabet, fasta))
        sharded_phase(torch, mods, tmp.name, large_fa, large_golden, bench_fa, label)
        tmp.cleanup()
        print(smi)
        return 0
    if fused_only:
        fused_phase(torch, mods, tmp.name, regenerate_large(alphabet, fasta, tmp.name), label)
        tmp.cleanup()
        print(smi)
        return 0
    if dryrun_only:
        devices_phase(torch, mods, label)
        tmp.cleanup()
        print(smi)
        return 0
    if resident_only:
        resident_phase(torch, mods, tmp.name, regenerate_large(alphabet, fasta, tmp.name), None,
                       True, label)
        tmp.cleanup()
        print(smi)
        return 0
    if walk_only:
        walk_phase(torch, mods, peak_ops, label)
        tmp.cleanup()
        print(smi)
        return 0
    if k5_time_args is not None:
        k5_time(torch, mods, peak_ops, cudabuild, tmp.name,
                k5_time_args[0] if k5_time_args else None)
        tmp.cleanup()
        print(smi)
        return 0
    if vote_args is not None:
        vote_phase(torch, mods, peak_ops, label, vote_args[0] if vote_args else None)
        tmp.cleanup()
        print(smi)
        return 0
    if seed_only:
        print(json.dumps({"lcb_seed": seed_phase(torch, mods, peak_ops, label)}))
        tmp.cleanup()
        print(smi)
        return 0
    if step_args is not None:
        step_phase(torch, mods, peak_ops, label, split=True,
                   older=step_args[0] if step_args else None, out_dir=tmp.name)
        tmp.cleanup()
        print(smi)
        return 0
    phase(f"3 kernels vs plain versions, n = 2^24 {label}")
    k1 = compare_kernels(torch, dev, alphabet, construct, kernels, fasta, peak_ops)
    k2 = k2_vs_plain(torch, kernels, k2_row_sets(torch, dev, alphabet, construct, kernels,
                                                 fasta), peak_ops)

    phase(f"4 POA kernel vs its plain version {label}")
    k3_err = compare_poa(torch, dev, torch_cases, device_poa, poa_ref, align_kernels,
                         peak_ops)
    phase("5 small graphs vs the oracle")
    cases = 0
    for seed, n_prob in ((0, 0.0), (1, 0.02), (2, 0.0), (3, 0.01), (4, 0.0), (5, 0.05)):
        for k in (3, 9, 15, 25, 31, 33, 45, 61):
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

    phase(f"6 golden GFFs through the CLI, k=15, 25 and 33 {label}")
    ex_out = os.path.join(tmp.name, "examples")
    run_cli(cli, ["-k", "15", "-n", "-o", ex_out,
                  os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")])
    with open(os.path.join(ex_out, "blocks_coords.gff"), "rb") as f, open(
        os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff"), "rb"
    ) as g:
        check(f.read() == g.read(), "examples/ GFF differs from the golden")
    print("examples/ k=15: GFF byte-equal to the golden (11 blocks)")

    large_fa = regenerate_large(alphabet, fasta, tmp.name)
    with open(os.path.join(EXAMPLES, "large", "sibeliaz_out", "blocks_coords.gff"), "rb") as g:
        large_golden = hashlib.sha256(g.read()).hexdigest()
    # k=25 against the committed golden; k=33 (two-limb keys through both
    # kernels and the two-pass sort) against the JAX package's GFF
    large_launches_by_k = {}
    for k, golden, whose, peak_limit in (
            (25, large_golden, "the committed golden's", PEAK_B_PER_POSITION),
            (33, LARGE_K33_GFF_SHA, "the JAX package's", PEAK_B_PER_POSITION_WIDE)):
        metrics.timings.clear()
        metrics.counters.clear()
        kernels.reset_launches()
        align_kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        out = os.path.join(tmp.name, f"large_k{k}")
        secs = run_cli(cli, ["-k", str(k), "-n", "-t", "4", "-o", out, *large_fa])
        counts = {**kernels.LAUNCHES, **align_kernels.LAUNCHES}
        peak = (torch.cuda.max_memory_allocated() - mem0) / metrics.counters["graph_positions"]
        with open(os.path.join(out, "blocks_coords.gff"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        check(digest == golden, f"examples/large k={k} GFF SHA-256 {digest}, not {whose}")
        check(counts["front_half"] > 0 and counts["class_analysis"] > 0
              and counts["poa_dp_tb"] == 0 and counts["round_append"] == 0,
              f"launches of the -k {k} -n run: {counts}")
        check(round(peak, 1) <= peak_limit,
              f"peak {peak:.1f} B/position at k={k}, above {peak_limit}")
        stages = {t["stage"]: t["seconds"] for t in metrics.timings}
        print(f"examples/large k={k}: GFF SHA-256 equal to {whose} "
              f"({int(metrics.counters['blocks_found'])} blocks) in {secs:.2f} s | launches "
              f"{counts} | peak {peak:.1f} B/position (limit {peak_limit}) | "
              + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items() if s.startswith("graph_"))
              + f" {label}")
        large_launches_by_k[k] = counts

    phase(f"7 golden MAFs through the CLI, both POA engines {label}")
    maf_launches, ex_args = golden_mafs(torch, cli, metrics, kernels, align_kernels,
                                        os.path.join(tmp.name, "maf"))
    k3_main = k3_vs_plain(torch, align_kernels, ex_args, "examples/ dispatch", peak_ops)

    phase(f"8 examples/large alignment: device engine vs native {label}")
    large_launches, large_args = large_alignment(
        torch, large_fa, fasta, pipeline, Config, msa, metrics, kernels, align_kernels,
        os.path.join(tmp.name, "large_maf"))
    k3_large = k3_vs_plain(torch, align_kernels, large_args,
                           "examples/large largest dispatch", peak_ops)
    del ex_args, large_args

    phase(f"9 timed pass: 16 x 1 Mbp strains, k=15 twice, then k=33 {label}")
    strains = bench_strains(alphabet, fasta)
    bench_fa = os.path.join(tmp.name, "strains.fa")
    fasta.write_fasta(bench_fa, strains)
    mbp = sum(len(r.seq) for r in strains) / 1e6
    for p, k in ((1, 15), (2, 15), (3, 33)):  # pass 3: two-limb keys, two sort passes
        metrics.timings.clear()
        metrics.counters.clear()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        wall = run_cli(cli, ["-k", str(k), "-n", "-o", os.path.join(tmp.name, f"bench{p}"),
                             bench_fa])
        peak = (torch.cuda.max_memory_allocated() - mem0) / metrics.counters["graph_positions"]
        st = {t["stage"]: t["seconds"] for t in metrics.timings}
        graph = sum(v for s, v in st.items() if s.startswith("graph_"))
        lcb = st["junction_table"] + st["lcb_engine"] + st["trim_and_render"]
        check(all(kernels.LAUNCHES[name] > 0 for name in MONOLITHIC_KERNELS),
              f"a kernel was not launched: {kernels.LAUNCHES}")
        print(f"pass {p}, k={k}: " + " | ".join(f"{s} {v:.4f} s" for s, v in st.items()))
        print(f"pass {p}, k={k}: graph {graph:.4f} s | lcb+out {lcb:.4f} s | graph+lcb "
              f"{graph + lcb:.4f} s | CLI wall {wall:.4f} s | {mbp / wall:.3f} input Mbp/s | "
              f"junctions {int(metrics.counters['graph_junctions'])} | "
              f"blocks {int(metrics.counters['blocks_found'])} | peak {peak:.1f} B/position | "
              f"launches {kernels.LAUNCHES} {label}")

    k4_err, k4, stream_paths = streamed_phase(
        torch, dev, mods, tmp.name, large_fa, large_golden, bench_fa,
        os.path.join(tmp.name, "bench3", "blocks_coords.gff"), peak_ops, label)
    oracle_launches = lcb_phase(torch, mods, os.path.join(tmp.name, "maf", "tpu", "alignment.maf"),
                                large_fa, os.path.join(tmp.name, "lcb"), label)
    shard_paths = sharded_phase(torch, mods, tmp.name, large_fa, large_golden, bench_fa, label)
    fused_launches, fused13 = fused_phase(torch, mods, tmp.name, large_fa, label)
    devices_paths = devices_phase(torch, mods, label)
    resident_launches = resident_phase(torch, mods, tmp.name, large_fa, fused13, False, label)
    k5, k5_err = walk_phase(torch, mods, peak_ops, label)
    k6, k6_err = vote_phase(torch, mods, peak_ops, label)
    k7, k7_err = step_phase(torch, mods, peak_ops, label)
    tmp.cleanup()

    src = "sibeliaz_tpu_torch/csrc/"
    # launches per main path: the -n CLI runs (examples/large at k=25 and
    # k=33, phase 6), the default CLI run with the device POA engine on
    # examples/ (phase 7), and the same two stages on examples/large through
    # the library (phase 8)
    # and the streamed stage's (phase 10): examples/large through the
    # pipeline at k=25 and k=33, the strains' -k 33 -n -f 1 CLI run, the
    # two full-size inputs, the input past 2^32 positions, and the class
    # that outgrows every round (the hand-over, and the host-bucketed
    # rounds alone), and the oracle LCB engine's CLI run (phase 11), and
    # the sharded graph stage's runs and the POA spread (phase 12), and the
    # tpu-fused LCB engine's CLI run and examples/large's first phases
    # (phase 13), examples/' first phase over two slices, the dry run on
    # cuda:0,cuda:0 and entry() (phase 14), and the resident LCB engine's
    # CLI run (phase 15)
    paths = {"examples/large -n": large_launches_by_k[25],
             "examples/large -k 33 -n": large_launches_by_k[33],
             "examples/ --align-engine tpu": maf_launches,
             "examples/large --align-engine tpu": large_launches,
             **stream_paths,
             "examples/ --lcb-engine oracle -n": oracle_launches,
             **shard_paths,
             "examples/ --lcb-engine tpu-fused -n": fused_launches,
             f"examples/large k=25 phases 1-{FUSED_LARGE_PHASES} tpu-fused":
                 fused13["large_launches"],
             **devices_paths,
             "examples/ --lcb-engine tpu -n": resident_launches}

    def by_path(kernel):
        return {path: counts.get(kernel, 0) for path, counts in paths.items()}

    def by_limbs(results):
        """The times of K1's or K2's one-limb instance (the k=25 path's) and
        its two-limb instance (the k=33 path's), on 2^24 random positions."""
        return {str(limbs): {"set": s, **{key: results[s][key] for key in
                                          ("ms", "plain_ms", "bound_ms", "bound_by")}}
                for limbs, s in ((1, "k=25 random"), (2, "k=33 random"))}

    k1_main, k2_main = k1["k=25 random"], k2["k=25 random"]
    # K4's "ms": the shape of the examples/large streamed passes (G=2 of 8)
    k4_shape = "1 limb(s) G=2 of 8"
    k4_main = k4[k4_shape]

    summary = {"kernels": [
        {"name": "front_half", "route": "cuda", "source": src + "front_half.cu",
         "replaces": "sibeliaz_tpu/graph/pallas_kernels.py:170",
         "launches": paths["examples/large -n"]["front_half"],
         "launches_by_path": by_path("front_half"),
         "max_abs_err": max(r["err"] for r in k1.values()),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "by_limbs": by_limbs(k1), "library_ms": None},
        {"name": "class_analysis", "route": "cuda", "source": src + "class_analysis.cu",
         "replaces": "sibeliaz_tpu/graph/construct.py:450",
         "launches": paths["examples/large -n"]["class_analysis"],
         "launches_by_path": by_path("class_analysis"),
         "max_abs_err": max(r["err"] for r in k2.values()),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "by_limbs": by_limbs(k2), "library_ms": None},
        {"name": "poa_dp_tb", "route": "cuda", "source": src + "poa_dp_tb.cu",
         "replaces": "sibeliaz_tpu/align/tpu_poa.py:206",
         "launches": maf_launches["poa_dp_tb"],
         "launches_by_path": by_path("poa_dp_tb"),
         "max_abs_err": max(k3_err, k3_main["err"], k3_large["err"]),
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
         "library_ms": None},
        {"name": "round_append", "route": "cuda", "source": src + "round_append.cu",
         "replaces": "sibeliaz_tpu/graph/streamed.py:331",
         "launches": paths["examples/large streamed k=25"]["round_append"],
         "launches_by_path": by_path("round_append"),
         "max_abs_err": max(k4_err, *(r["err"] for r in k4.values())),
         "ms": k4_main["ms"], "plain_ms": k4_main["plain_ms"],
         "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
         "shape": k4_shape, "by_shape": k4, "library_ms": None},
        {"name": "lcb_walk", "route": "cuda", "source": src + "lcb_walk.cu",
         "replaces": "sibeliaz_tpu/lcb/resident.py:138 and sibeliaz_tpu/lcb/fused.py:128",
         "launches": paths["examples/ --lcb-engine tpu -n"]["lcb_walk"],
         "launches_by_path": by_path("lcb_walk"), "max_abs_err": k5_err,
         **{key: k5[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "call": k5["call"], "call_ms": k5["call_ms"], "chain_floor_ms": k5["chain_floor_ms"],
         "chain_floor_block_ms": k5["chain_floor_block_ms"], "library_ms": None},
        {"name": "lcb_vote", "route": "cuda", "source": src + "lcb_vote.cu",
         "replaces": "sibeliaz_tpu/lcb/resident.py:214 and sibeliaz_tpu/lcb/fused.py:241",
         "launches": paths["examples/ --lcb-engine tpu -n"]["lcb_vote"],
         "launches_by_path": by_path("lcb_vote"), "max_abs_err": k6_err,
         **{key: k6[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "call": k6["call"], "call_ms": k6["call_ms"], "host_ms": k6["host_ms"],
         "chain_floor_ms": k6["chain_floor_ms"], "library_ms": None},
        {"name": "lcb_step", "route": "cuda", "source": src + "lcb_step.cu",
         "replaces": "sibeliaz_tpu/lcb/fused.py:326",
         "launches": paths["examples/ --lcb-engine tpu-fused -n"]["lcb_step"],
         "launches_by_path": by_path("lcb_step"), "max_abs_err": k7_err,
         **{key: k7[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "call": k7["call"], "call_ms": k7["call_ms"], "loop_ms": k7["loop_ms"],
         "chain_floor_ms": k7["chain_floor_ms"], "library_ms": None},
    ]}
    print()
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
