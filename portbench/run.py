#!/usr/bin/env python3
"""The port's benchmark: FASTA -> GFF through sibeliaz_tpu_torch on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One run is one process:

- set-up (`setup_s`, from the start of this script to the first timed
  pass): read the cell's files (registry.py), generate its genomes from
  the seed (genomes.py) and write them as FASTA under TMPDIR, load the
  port's kernel library (built into the package's `_build/` by the first
  run in a checkout; that build's seconds are `build_s` on standard error
  and in the result line), and one warm-up pass through the same entry and
  flags over the first `warmup_bp` bases of each genome's first sequence;
- the window: `sibeliaz_tpu_torch.cli.run` over the whole input, pass
  after pass, for `--seconds` (the last pass that starts before the
  deadline runs to its end and counts), each pass into a directory of its
  own, writing `blocks_coords.gff` and its graph (`--dump-graph`, as the
  upstream pipeline writes TwoPaCo's graph between its two stages); the
  program's stage timings and counters are reset before each pass and
  read after it; with `--trace 1` a torch.profiler session spans the
  window and the per-layer metrics are read (portbench/metrics/);
- the check, once the window has closed and the device peak is read
  (reference/check.py, in a process of its own): every pass's two files
  equal one pass's, drawn from the seed, and that pass's graph, table and
  whole GFF equal the plain reference's.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the last key of
that object.  The run refuses (exit 1, no result) without a CUDA card, and
if JAX or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "sibeliaz_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package
    (compared whole: sibeliaz_tpu_torch is not sibeliaz_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def program_argv(cfg, fastas, outdir, graph_file, device):
    return ["-k", str(cfg["k"]), "-a", str(cfg["a"]), "-b", str(cfg["b"]),
            "-m", str(cfg["m"]), "-t", str(cfg["t"]), "-n",
            "--lcb-engine", cfg["lcb_engine"], "--device", device,
            "-o", outdir, "--dump-graph", graph_file, *fastas]


def note(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def write_inputs(genomes, workdir: str, prefix: str, warmup_bp=None):
    from portbench.lib import genomes as gen

    paths = []
    for g, genome in enumerate(genomes):
        recs = genome if warmup_bp is None else [(genome[0][0], genome[0][1][:warmup_bp])]
        path = os.path.join(workdir, f"{prefix}{g + 1}.fa")
        gen.write_fasta(path, recs)
        paths.append(path)
    return paths


def measure(workload: str, cfg, traffic, seed: int, seconds: float, trace: bool,
            device: str, chips: int, per_layer, workdir: str, t_start: float):
    """One run of a cell on `device` ("cuda"; "cpu" in the CPU tests): set-up,
    window, check.  Returns the result object."""
    import torch

    from portbench.lib import devtrace, genomes as gen, registry, window
    from portbench.reference import check

    genomes = gen.generate(traffic, seed)
    seqs = [s for g in genomes for _, s in g]
    bases = int(sum(len(s) for s in seqs))
    fastas = write_inputs(genomes, workdir, "genome")
    warm = write_inputs(genomes, workdir, "warmup", cfg["warmup_bp"])

    from sibeliaz_tpu_torch import cli
    from sibeliaz_tpu_torch.utils import metrics as pm

    t_build = time.time()
    if device == "cuda":
        from sibeliaz_tpu_torch.utils import cudabuild

        cudabuild.load()
    build_s = time.time() - t_build

    def run_cli(inputs, outdir):
        os.makedirs(outdir, exist_ok=True)
        argv = program_argv(cfg, inputs, outdir, os.path.join(outdir, "graph.dbg"), device)
        with contextlib.redirect_stdout(io.StringIO()):
            cli.run(argv)

    def run_pass(i):
        pm.GLOBAL.timings = window.StampedTimings()
        pm.GLOBAL.counters = {}
        out = {"dir": os.path.join(workdir, f"pass{i}")}
        try:
            run_cli(fastas, out["dir"])
        except Exception:  # a failed pass counts; the window goes on
            traceback.print_exc(file=sys.stderr)
            out["failed"] = True
        out["spans"] = pm.GLOBAL.timings.spans()
        out["span_s"] = window.span_seconds(pm.GLOBAL.timings)
        out["counters"] = dict(pm.GLOBAL.counters)
        note(f"pass {i}: spans {json.dumps(out['span_s'])} counters {json.dumps(out['counters'])}")
        return out

    note(f"set-up: genomes and kernels ready at {time.time() - t_start:.2f} s "
         f"(kernel library loaded or built in build_s {build_s:.4f} s)")
    run_cli(warm, os.path.join(workdir, "warmup"))
    note(f"set-up: warm-up pass done at {time.time() - t_start:.2f} s")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function("portbench_window"):
                t_anchor = time.time()
                passes = window.run_window(run_pass, seconds)
    else:
        passes = window.run_window(run_pass, seconds)
    setup_s = passes[0]["start"] - t_start
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    failed = sum(1 for p in passes if p.get("failed"))

    result = {"correct": False, "attempted": len(passes), "failed": failed}
    metrics = {}
    breakdown = None
    if trace:
        dev_events, anchors = devtrace.device_events(prof)
        anchor = anchors.get("portbench_window")
        del prof
        to_ns = (lambda t: anchor + int((t - t_anchor) * 1e9)) if anchor else (lambda t: int(t * 1e9))
        red = devtrace.reduce(dev_events, to_ns, passes)
        del dev_events
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        ctx = {"passes": [p for p in passes if not p.get("failed")], "trace": red, "cfg": cfg}
        for i, p in enumerate(passes):
            p["trace"] = red["passes"][i]
        for m in per_layer:
            value = registry.reader(m["name"])(ctx) if ctx["passes"] else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics["gff_mbp_s"] = {"value": window.rate_mbp_s(passes, bases), "unit": "Mbp/s"}
        metrics["peak_dev_B_per_bp"] = {"value": peak / bases, "unit": "B/bp"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # the check: the program's state is freed first; the reference runs on the host
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    numbers = judge(passes, fastas, cfg, seed, workdir, t_start)
    check_s = time.time() - t0
    result["correct"] = failed == 0 and all(v <= check.LIMITS[k] for k, v in numbers.items())
    result["metrics"] = metrics
    result["device"] = dev
    result["build_s"] = build_s
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}
    print(f"portbench: {workload} seed {seed}: {len(passes)} passes of {bases} bases, "
          f"set-up {setup_s:.4f} s (build_s {build_s:.4f}), check {check_s:.4f} s, "
          f"{power_limit()}; pass walls "
          + " ".join(f"{p['end'] - p['start']:.4f}" for p in passes[:20]), file=sys.stderr)
    return result


def judge(passes, fastas, cfg, seed, workdir, t_start, limit_s=345.0):
    """The numbers compared: passes whose files differ from the drawn
    pass's, then that pass against the reference (check.judge_job, in a
    process of its own that ends before the run's `limit_s`)."""
    import numpy as np

    from portbench.reference import check

    done = [p for p in passes if not p.get("failed")]
    numbers = {"passes_differ": len(passes) - len(done)}
    unjudged = dict(graph_diff=1, table_diff=1, lcb_diff=1)
    if not done:
        return {**numbers, **unjudged}
    pick = done[int(np.random.default_rng([seed, 2]).integers(len(done)))]
    files = ("blocks_coords.gff", "graph.dbg")

    def sums(p):
        return tuple(digest(os.path.join(p["dir"], f)) if os.path.exists(os.path.join(p["dir"], f))
                     else None for f in files)

    want = sums(pick)
    numbers["passes_differ"] += sum(None in got or got != want for got in map(sums, done))
    if None in want:
        return {**numbers, **unjudged}
    job = {"fastas": fastas, "cfg": cfg, "counters": pick["counters"],
           "gff": os.path.join(pick["dir"], "blocks_coords.gff"),
           "dbg": os.path.join(pick["dir"], "graph.dbg"), "workers": check.workers_here()}
    job_path = os.path.join(workdir, "check_job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    timeout = max(30.0, limit_s - (time.time() - t_start))
    # a session of its own, so that its forked explorers end with it
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "reference", "check.py"), job_path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        note(f"the reference did not end within {timeout:.0f} s")
        return {**numbers, **unjudged}
    sys.stderr.write(stderr[-4000:])
    if proc.returncode != 0 or not stdout.strip():
        note(f"the reference exited with {proc.returncode}")
        return {**numbers, **unjudged}
    got = json.loads(stdout.strip().splitlines()[-1])
    numbers.update(got["numbers"])
    note(f"reference {json.dumps(got['about'])}")
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib import registry

    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    per_layer = registry.per_layer_of(bench, args.workload) if args.trace else []

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        result = measure(args.workload, cfg, traffic, args.seed, args.seconds, bool(args.trace),
                         "cuda", cell["chips"], per_layer, workdir, T_START)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}; the benchmark measures the port alone",
              file=sys.stderr)
        return 1
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
