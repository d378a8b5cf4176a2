"""The resident LCB engine (lcb/resident.py, `--lcb-engine tpu`) against the
JAX package's and the host oracle, on the CPU: a phase's instance lists
equal to the JAX package's `process_phase_resident` and to `eng.process`,
bundle by bundle, through vote-tier escalation and lanes killed to the
oracle; the walk and the rewind equal to the JAX functions field for
field from one state, sentinel rows included; GFFs byte-equal to the JAX
package's `run_resident` and to the native engine, and through the CLI."""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sibeliaz_tpu.lcb import resident as jax_resident
from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.cli import run
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.io import fasta
from sibeliaz_tpu_torch.lcb import resident
from sibeliaz_tpu_torch.lcb.batched_push_device import BIG, I_CAP
from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from reference_oracle import random_related_genomes
from test_torch_fused import gff_of, inst_key
from test_torch_fused_parts import engines, related
from torch_cases import state_arrays, state_diff

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
L = 32  # lanes of the walk and rewind cases


@pytest.fixture(autouse=True)
def one_thread():
    """Lane tensors here are small: one intra-op thread a test process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def phase_case():
    """(port engine, every bundle of the related genomes (44), the JAX
    package's process_phase_resident on them at its defaults).  The JAX
    engine takes ~110 s on the CPU for tests/test_resident_lcb.py's 64
    bundles of 2,500 bp genomes, ~20 s here."""
    eng, jeng = related()
    bundles = make_bundles_device(eng.t, "cpu")
    assert len(bundles) == 44
    return eng, bundles, jax_resident.process_phase_resident(jeng, bundles)


@pytest.mark.parametrize("kind,tiers", [
    ("related", None),
    ("escalate", ((64, 2), (I_CAP, 2), (I_CAP, 256))),
    ("kill", ((64, 14), (I_CAP, 14), (I_CAP, 14))),
])
def test_process_phase_matches_jax_and_oracle(monkeypatch, kind, tiers):
    """process_phase_resident per bundle, equal to the JAX package's and to
    eng.process: at the default vote tiers; with the first two tiers'
    windows cut to 2, so that votes overflow and retry at the last tier;
    with every window cut to 14, so that most lanes overflow the last tier
    and go to eng.process while the others finish on the device.  The JAX
    package's results do not depend on the tiers (tests/test_resident_lcb.py
    holds them to the oracle), so it runs at its defaults."""
    if tiers:
        monkeypatch.setattr(resident, "VOTE_TIERS", tiers)
    eng, bundles, want = phase_case()
    metrics.counters.clear()
    got = resident.process_phase_resident(eng, bundles, device="cpu")
    for b, bundle in enumerate(bundles):
        assert inst_key(got[b]) == inst_key(want[b]) == inst_key(eng.process(bundle)), b
    counters = metrics.counters
    assert counters["resident_phases"] == 1
    assert counters["resident_host_syncs"] > counters["resident_rounds"] > 0
    assert counters["resident_pushes"] >= counters["resident_walk_calls"] > 0
    if kind == "escalate":
        assert counters["resident_vote_retries"] > 0 and counters["resident_oracle_lanes"] == 0
    elif kind == "kill":
        assert 0 < counters["resident_oracle_lanes"] < len(bundles)
    else:
        assert counters["resident_oracle_lanes"] == 0
    assert sum(len(r) > 1 for r in got) >= 8


def nested(jst):
    """A JAX ResidentState as the mapping resident.state_from_numpy takes."""
    out = {"ln": {}, "rw": {}, "sn": {}}
    for path, a in state_arrays(jst).items():
        head, _, field = path.partition(".")
        if field:
            out[head][field] = a
        else:
            out[head] = a
    return out


def seeded(eng, jeng):
    """Both packages' tables and the JAX package's seeded state of the
    first L bundles."""
    bundles = make_bundles_device(eng.t, "cpu")[:L]
    assert len(bundles) == L
    jtb = jax_resident._device_tables(jeng)
    ln, _, ovf = jax_resident._seed_lanes_device(jtb, bundles, L)
    assert not np.asarray(ovf).any()
    jst = jax_resident.ResidentState(ln=ln, rw=ln, sn=ln, best_score=jnp.zeros(L, jnp.int64),
                                     has_snap=jnp.zeros(L, bool))
    return resident._device_tables(eng, "cpu"), jtb, jst


def jax_walk(jeng, jtb, jst, args, fn=None):
    return (fn or jax_resident._walk_device)(
        jtb, jst, *(jnp.asarray(a) for a in args), jnp.int64(jeng.m), jnp.int64(jeng.b),
        jnp.int64(jeng.flank))


def port_walk(eng, tb, jst, args):
    return resident._walk_device(tb, resident.state_from_numpy(nested(jst), "cpu"),
                                 *(torch.from_numpy(np.asarray(a)) for a in args),
                                 eng.m, eng.b, eng.flank)


def vote_walks(jeng, jtb, jst, fwd):
    """The JAX package's vote for every lane in direction fwd[l]: the walk
    arguments (rows, c, i, s, fwd, tvid) of the lanes with a winner and no
    window overflow."""
    out = [np.asarray(x) for x in jax_resident._vote_round(
        I_CAP, 16, jtb, jst.ln, jnp.arange(L), jnp.ones(L, bool), jnp.asarray(fwd),
        jnp.zeros(L, bool), jnp.int64(jeng.depth), jnp.int64(jeng.b))]
    bvid, _, ochr, oidx, ostr, ovf = out
    rows = np.flatnonzero((bvid != 0) & (ovf == 0))
    return [rows, ochr[rows], oidx[rows], ostr[rows], fwd[rows], bvid[rows]]


def with_sentinels(args, rng):
    """The walk arguments shuffled, with sentinel rows (as the JAX driver
    pads them) among them and one right after lane L-1's row."""
    rows = args[0]
    assert L - 1 in rows
    pad = [L, 0, 0, 1, False, BIG]
    order = list(rng.permutation(len(rows)))
    at = order.index(int(np.flatnonzero(rows == L - 1)[0]))
    order[at + 1:at + 1] = [-1]
    order[:0] = [-1]
    order.append(-1)
    return [np.array([a[q] if q >= 0 else p for q in order], dtype=np.asarray(a).dtype)
            for a, p in zip(args, pad)]


def long_walks(eng, jst, fwd, rng):
    """Walk arguments for every lane from its first instance, to the vertex
    1 to 4 junctions on in direction fwd[l] (where the chromosome holds
    it): walks of several pushes, which the protocol's votes rarely make."""
    t = eng.t
    chr_, idx, strand = (np.asarray(getattr(jst.ln, f))[:, 0] for f in ("chr", "bi", "s"))
    n = np.asarray(jst.ln.n)
    out = []
    for lane in np.flatnonzero(n > 0):
        c, i, s = int(chr_[lane]), int(idx[lane]), int(strand[lane])
        step = s if fwd[lane] else -s
        for d in rng.permutation([4, 3, 2, 1]):
            j = i + step * d
            if 0 <= j < t.chr_off[c + 1] - t.chr_off[c]:
                out.append((lane, c, i, s, fwd[lane], s * int(t.jid_flat[t.chr_off[c] + j])))
                break
    return [np.array(col, dtype=np.bool_ if q == 4 else np.int64)
            for q, col in enumerate(zip(*out))]


def assert_walks_equal(got, want):
    assert not state_diff(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a.numpy(), np.asarray(b))


def row_changed(a, b, row):
    """Whether two states differ in lane `row`."""
    fa, fb = state_arrays(a), state_arrays(b)
    return any(not np.array_equal(fa[key][row], fb[key][row]) for key in fa)


@pytest.mark.parametrize("kind", ["protocol", "long", "bounded"])
def test_walk_matches_jax(monkeypatch, kind):
    """_walk_device from one state, port and JAX package, field for field:
    mixed directions, rows out of order with sentinel rows among them and
    lane L-1 walking beside one.  `protocol`: the state after a round of
    forward votes and walks, then the winners of votes in mixed
    directions; `long`: from the seeded state, to vertices up to four
    junctions on; `bounded`: the same at _MAX_WALK 2 in both packages (the
    JAX function run unjitted, so that it reads the patched bound)."""
    eng, jeng = related()
    tb, jtb, jst = seeded(eng, jeng)
    rng = np.random.default_rng(7)
    if kind == "protocol":
        jst = jax_walk(jeng, jtb, jst, vote_walks(jeng, jtb, jst, np.ones(L, bool)))[0]
        fwd = rng.random(L) < 0.5
        args = vote_walks(jeng, jtb, jst, fwd)
        if L - 1 not in args[0]:
            fwd[L - 1] = not fwd[L - 1]
            args = vote_walks(jeng, jtb, jst, fwd)
    else:
        args = long_walks(eng, jst, rng.random(L) < 0.5, rng)
    args = with_sentinels(args, rng)
    fn = None
    if kind == "bounded":
        full = port_walk(eng, tb, jst, args)
        monkeypatch.setattr(resident, "_MAX_WALK", 2)
        monkeypatch.setattr(jax_resident, "_MAX_WALK", 2)
        fn = jax_resident._walk_device.__wrapped__
    metrics.counters.clear()
    got = port_walk(eng, tb, jst, args)
    want = jax_walk(jeng, jtb, jst, args, fn)
    assert_walks_equal(got, want)
    assert row_changed(want[0], jst, L - 1)
    pushes = metrics.counters["resident_pushes"]
    if kind == "protocol":
        assert int(np.asarray(want[1]).sum()) >= 8
    elif kind == "long":
        assert pushes == 4
    else:
        assert pushes == 2 and state_diff(got[0], full[0])


def test_rewind_matches_jax():
    """_rewind_rows from the state after a round of forward votes and
    walks and a round of backward walks (every lane's rewind slab apart
    from its live lanes), rows out of order with sentinel rows among them
    and lane L-1 not among them (a sentinel's row, clipped to L-1 for the
    gather, must not be written back)."""
    eng, jeng = related()
    tb, jtb, jst = seeded(eng, jeng)
    jst = jax_walk(jeng, jtb, jst, vote_walks(jeng, jtb, jst, np.ones(L, bool)))[0]
    jst = jax_walk(jeng, jtb, jst, long_walks(eng, jst, np.zeros(L, bool),
                                              np.random.default_rng(3)))[0]
    rows = np.random.default_rng(5).permutation(L - 1)[:L // 2]
    rows = np.concatenate([[L], rows[:5], [L, L], rows[5:], [L]]).astype(np.int64)
    st = resident.state_from_numpy(nested(jst), "cpu")
    got = resident._rewind_rows(st, torch.from_numpy(rows))
    want = jax_resident._rewind_rows(jst, jnp.asarray(rows))
    assert not state_diff(got, want)
    assert state_diff(got, st) and state_diff(got.ln, got.rw)
    assert row_changed(st.ln, st.rw, L - 1) and not row_changed(got.ln, st.ln, L - 1)


@pytest.mark.parametrize("k", [15, 33])
def test_run_resident_gff_matches_jax_and_native(k):
    """run_resident's GFF byte-equal to the JAX package's run_resident and
    to the native engine (tests/test_fused_lcb.py's genomes)."""
    seqs, names = random_related_genomes(521, length=1200, mut=0.03, rearrange=True)
    eng, jeng = engines(seqs, names, k=k)
    metrics.counters.clear()
    got = gff_of(seqs, names, k, resident.run_resident(eng, device="cpu"))
    assert metrics.counters["resident_phases"] >= 1
    assert got == gff_of(seqs, names, k, jax_resident.run_resident(jeng))
    native = pipeline.find_blocks(seqs, names, Config(k=k), device="cpu")
    assert got == native.gff and native.blocks_found > 0


def test_cli_tpu_matches_native(tmp_path):
    """`-n --lcb-engine tpu --device cpu` writes the native engine's GFF,
    byte for byte, and counts its phases."""
    seqs, names = random_related_genomes(64, length=2000, mut=0.02, rearrange=True)
    fa = tmp_path / "genomes.fa"
    fasta.write_fasta(str(fa), [fasta.FastaRecord(n, s) for n, s in zip(names, seqs)])
    common = ["-k", "15", "-n", "--device", "cpu"]
    assert run(common + ["--lcb-engine", "native", "-o", str(tmp_path / "native"), str(fa)]) == 0
    metrics.counters.clear()
    assert run(common + ["--lcb-engine", "tpu", "-o", str(tmp_path / "tpu"), str(fa)]) == 0
    want = (tmp_path / "native" / "blocks_coords.gff").read_bytes()
    assert (tmp_path / "tpu" / "blocks_coords.gff").read_bytes() == want
    assert want.count(b"\n") > 5
    assert metrics.counters["resident_phases"] >= 1


def test_resident_refuses_cuda_without_card(tmp_path):
    """No card: the CLI's default --device cuda and run_resident's default
    device raise, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(SystemExit, match="no CUDA device"):
        run(["-k", "15", "-n", "--lcb-engine", "tpu", "-o", str(tmp_path),
             os.path.join(EXAMPLES, "genome1.fa")])
    eng, _ = related()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resident.run_resident(eng)
    assert not eng.blocks


def test_walk_calls_get_a_state_apart(monkeypatch):
    """Every K5 call of a phase of 44 bundles (votes, walks and rewinds)
    gets a state whose 68 tensors overlap neither each other nor the
    call's other inputs, as K5 on the card needs (it walks the state in
    place): `seed_state` seeds the three slabs apart, and the rewinds'
    scatters make tensors of their own."""
    from sibeliaz_tpu_torch.lcb import kernels

    eng, bundles, _ = phase_case()
    seen = []
    real = kernels.lcb_walk

    def checked(tb, st, rows, *rest):
        per_row = [x for x in (rows, *rest[:7]) if x is not None]
        tables = [getattr(tb, f) for f in kernels.TABLE_FIELDS]
        seen.append(kernels.overlapping(resident._state_leaves(st), per_row + tables))
        return real(tb, st, rows, *rest)

    monkeypatch.setattr(kernels, "lcb_walk", checked)
    metrics.counters.clear()
    resident.process_phase_resident(eng, bundles, device="cpu")
    assert metrics.counters["resident_rewind_s"] > 0
    assert len(seen) == metrics.counters["resident_walk_calls"] > 10
    assert seen == [None] * len(seen)
