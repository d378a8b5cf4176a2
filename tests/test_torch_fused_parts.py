"""The fused LCB engine's parts (lcb/batched_push_device.py, lcb/resident.py)
and its phase step (lcb/fused.py) against the JAX package's, on the CPU:
the same tables and lane states in both (the port's through lcb/fused.py's
numpy bridge), every output compared exactly.  The carry of the phase
state machine is held to the JAX package's field by field after 1, 2, 5
and 20 outer steps and at the phase's end."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sibeliaz_tpu import pipeline as jax_pipeline
from sibeliaz_tpu.config import Config as JaxConfig
from sibeliaz_tpu.lcb import batched_push_device as jax_bpd
from sibeliaz_tpu.lcb import fused as jax_fused
from sibeliaz_tpu.lcb import resident as jax_resident
from sibeliaz_tpu.lcb.oracle import LcbEngine as JaxLcbEngine
from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.lcb import batched_push_device as bpd
from sibeliaz_tpu_torch.lcb import fused, resident
from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

from reference_oracle import random_related_genomes
from torch_cases import repeat_genomes, state_arrays, state_diff

NARROW, WIDE = (64, 32, 64, 128), (512, 16, 512, 1024)


@pytest.fixture(autouse=True)
def one_thread():
    """Lane tensors here are small: one intra-op thread a test process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def engines(seqs, names, k=15, abundance=150):
    """The port's engine and the JAX package's on the same genomes."""
    cfg = Config(k=k, abundance_threshold=abundance)
    table = pipeline.build_table(seqs, names, cfg, device="cpu")
    jax_table = jax_pipeline.build_table(seqs, names, JaxConfig(k=k, abundance_threshold=abundance))
    args = (cfg.min_block_size, cfg.max_branch_size, cfg.flanking)
    return LcbEngine(table, *args), JaxLcbEngine(jax_table, *args)


def related(seed=520, k=15):
    return engines(*random_related_genomes(seed, length=1200, mut=0.03, rearrange=True), k=k)


def jax_seed(jax_tb, bundles, L, IC, PC):
    ln, _, ovf = jax_resident._seed_lanes_device(jax_tb, bundles, L, IC, PC)
    return ln, np.asarray(ovf)


def jax_carry_after(eng, jeng, tier, L, steps, n_bundles=32):
    """The JAX package's seeded state for the first n_bundles bundles at
    `tier`, run `steps` outer steps; returns (its carry, the bundles)."""
    CAP, W, IC, PC = tier
    bundles = make_bundles_device(eng.t, "cpu")[:n_bundles]
    jtb = jax_resident._device_tables(jeng)
    ln, ovf = jax_seed(jtb, bundles, L, IC, PC)
    st = jax_resident.ResidentState(ln=ln, rw=ln, sn=ln, best_score=jnp.zeros(L, jnp.int64),
                                    has_snap=jnp.zeros(L, bool))
    carry = jax_fused._init_carry(st, jnp.asarray((np.arange(L) < len(bundles)) & ~ovf), L)
    if steps:
        carry, _ = jax_fused._phase_fused_seg(
            CAP, W, IC >= bpd.I_CAP, jtb, carry, jnp.int64(jeng.depth), jnp.int64(jeng.m),
            jnp.int64(jeng.b), jnp.int64(jeng.flank), jnp.int64(jeng.b * 2), jnp.int64(steps))
    return carry, bundles


def nested(carry):
    """A JAX carry as the mapping fused.carry_from_numpy takes."""
    arrays = state_arrays(carry)
    out = {"st": {"ln": {}, "rw": {}, "sn": {}}}
    for path, a in arrays.items():
        parts = path.split(".")
        if parts[0] == "st" and len(parts) == 3:
            out["st"][parts[1]][parts[2]] = a
        elif parts[0] == "st":
            out["st"][parts[1]] = a
        else:
            out[parts[0]] = a
    return out


@pytest.mark.parametrize("case", ["related", "repeat"])
def test_device_tables_match_jax(case):
    """DeviceTables field by field, pads included, as built and after a
    commit changes `used` (the cached tables' refresh, whose used prefix
    is one longer than a fresh build's in both packages), and through the
    numpy bridge."""
    eng, jeng = related() if case == "related" else engines(*repeat_genomes(3, 80))
    assert not state_diff(resident._device_tables(eng, "cpu"), jax_resident._device_tables(jeng))
    rng = np.random.default_rng(5)
    mark = rng.random(len(eng.t.used_flat)) < 0.1
    assert mark.any()
    eng.t.used_flat[mark] = 1
    jeng.t.used_flat[mark] = 1
    refreshed = resident._device_tables(eng, "cpu")
    assert int(refreshed.used_pfx[-1]) == int(mark.sum())
    assert not state_diff(refreshed, jax_resident._device_tables(jeng))
    fresh = bpd.DeviceTables.build(eng.t, "cpu")
    assert state_diff(refreshed, fresh) == ["used_pfx"]
    assert torch.equal(refreshed.used_pfx[:len(fresh.used_pfx)], fresh.used_pfx)
    bridged = fused.tables_from_numpy(state_arrays(jax_resident._device_tables(jeng)), eng.t.k,
                                      "cpu")
    assert not state_diff(bridged, refreshed)


@pytest.mark.parametrize("IC,PC", [(64, 128), (512, 1024)])
@pytest.mark.parametrize("case", ["related", "repeat_80", "repeat_520"])
def test_seeding_matches_jax(case, IC, PC):
    """Device seeding at both slab widths: inert padded lanes past the
    bundles, a bundle over the slab width flagged (its occurrence count
    past IC), used junctions filtered out."""
    if case == "related":
        eng, jeng = related()
    else:
        copies = int(case.split("_")[1])
        eng, jeng = engines(*repeat_genomes(3, copies), abundance=1000)
    bundles = make_bundles_device(eng.t, "cpu")[:40]
    eng.t.used_flat[::5] = 1
    jeng.t.used_flat[::5] = 1
    tb = bpd.DeviceTables.build(eng.t, "cpu")
    jtb = jax_resident._device_tables(jeng)
    L = 64
    ln, n, ovf = resident._seed_lanes_device(tb, bundles, L, IC, PC)
    jln, jn, jovf = jax_resident._seed_lanes_device(jtb, bundles, L, IC, PC)
    assert not state_diff(ln, jln)
    assert np.array_equal(n.numpy(), jn) and np.array_equal(ovf.numpy(), jovf)
    assert (n.numpy()[len(bundles):] == 0).all() and (ln.pn.numpy()[len(bundles):] == 0).all()
    want_ovf = max(b.count for b in bundles) > IC
    assert ovf.numpy().any() == want_ovf
    assert want_ovf == (case == "repeat_520" or (case == "repeat_80" and IC == 64))


@pytest.mark.parametrize("k", [15, 33])
def test_edge_of_matches_jax(k):
    """edge_of at every (chromosome, index, strand, direction) of a table,
    the chromosome ends included (their neighbour indices clip)."""
    eng, jeng = related(k=k)
    tb = resident._device_tables(eng, "cpu")
    jtb = jax_resident._device_tables(jeng)
    grid = np.array([(c, i, s, f) for c in range(eng.t.n_chr) for i in range(len(eng.t.jpos[c]))
                     for s in (1, -1) for f in (True, False)], np.int64)
    c, i, s, f = (grid[:, q] for q in range(4))
    got = bpd.edge_of(tb, *(torch.from_numpy(x) for x in (c, i, s)),
                      torch.from_numpy(f.astype(bool)))
    want = jax_bpd.edge_of(jtb, *(jnp.asarray(x) for x in (c, i, s)), jnp.asarray(f.astype(bool)))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("CAP,W", [(64, 32), (2, 4), (16, 256)])
def test_vote_matches_jax(CAP, W):
    """_vote_gathered on a mid-phase lane state (after 12 JAX steps): mixed
    forward/try_used, gathered rows out of order and repeated, invalid
    rows; W=4 overflows the window and CAP=2 leaves lanes with n > CAP.
    The origin columns are compared where a winner exists (elsewhere both
    packages leave them unspecified)."""
    eng, jeng = related()
    carry, _ = jax_carry_after(eng, jeng, NARROW, 32, 12)
    jln = carry["st"].ln
    ln = resident.lanes_from_numpy(nested(carry)["st"]["ln"], "cpu")
    assert not state_diff(ln, jln)
    tb = resident._device_tables(eng, "cpu")
    jtb = jax_resident._device_tables(jeng)
    rng = np.random.default_rng(CAP + W)
    idx = rng.integers(0, 32, size=48)
    valid = rng.random(48) < 0.8
    forward = rng.random(48) < 0.5
    try_used = rng.random(48) < 0.5
    got = resident._vote_gathered(CAP, W, tb, ln, *(torch.from_numpy(x) for x in
                                                     (idx, valid, forward, try_used)),
                                  eng.depth, eng.b)
    want = jax_resident._vote_gathered(CAP, W, jtb, jln, *(jnp.asarray(x) for x in
                                                           (idx, valid, forward, try_used)),
                                       jnp.int64(jeng.depth), jnp.int64(jeng.b))
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    for a, b in zip(got[:2] + got[5:], want[:2] + want[5:]):
        assert np.array_equal(a, b)
    win = want[0] != 0
    assert win.sum() >= 8
    for a, b in zip(got[2:5], want[2:5]):
        assert np.array_equal(a[win], b[win])
    if W == 4:
        assert want[5].any()
    if CAP == 2:
        assert (ln.n.numpy()[idx[valid]] > CAP).any()


def test_push_score_snap_matches_jax():
    """One mixed-direction push + score + snapshot on a mid-phase state,
    the edges taken at each lane's path end by edge_of; the state, the
    success flags, the scores and the improvement flags equal."""
    eng, jeng = related()
    carry, _ = jax_carry_after(eng, jeng, NARROW, 32, 6)
    st = fused.carry_from_numpy(nested(carry), "cpu")["st"]
    tb = resident._device_tables(eng, "cpu")
    jtb = jax_resident._device_tables(jeng)
    L = 32
    rng = np.random.default_rng(11)
    fwd = rng.random(L) < 0.5
    valid = rng.random(L) < 0.9
    # each lane's instance in slot 0, one junction on in its direction
    c, i, s = (getattr(st.ln, f)[:, 0].numpy() for f in ("chr", "bi", "s"))
    edge = [x.numpy() for x in bpd.edge_of(tb, *(torch.from_numpy(x) for x in (c, i, s)),
                                            torch.from_numpy(fwd))]
    vtx = np.where(fwd, edge[1], edge[0])
    occ = np.diff(eng.t.occ_off)[np.clip(np.abs(vtx), 0, len(eng.t.occ_off) - 2)]
    mo = int(occ[valid].max())
    args = [edge[0], edge[1], edge[2], edge[4], valid]
    got = resident._push_score_snap(mo, torch.from_numpy(fwd), tb, st,
                                    *(torch.from_numpy(x) for x in args),
                                    eng.m, eng.b, eng.flank)
    want = jax_resident._push_score_snap(jnp.int64(mo), jnp.asarray(fwd), jtb, carry["st"],
                                         *(jnp.asarray(x) for x in args), jnp.int64(jeng.m),
                                         jnp.int64(jeng.b), jnp.int64(jeng.flank))
    assert not state_diff(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert got[1].numpy().any()


def test_compact_decode_matches_snapshot_decode():
    """The compact fetch and the full-slab fetch decode the same Instance
    lists, equal to the JAX package's compact decode."""
    eng, jeng = related()
    carry, _ = jax_carry_after(eng, jeng, NARROW, 32, 4096)
    sn = resident.lanes_from_numpy(nested(carry)["st"]["sn"], "cpu")
    rows = [j for j in range(32) if bool(carry["st"].has_snap[j])]
    assert len(rows) >= 8
    comp = resident.instances_from_compact(sn, rows, 32)
    h = resident.snapshot_to_host(sn)
    want = jax_resident.instances_from_compact(carry["st"].sn, rows, 32)

    def key(insts):
        return [(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]

    for j in rows:
        assert key(comp[j]) == key(resident.instances_from_snapshot(h, j)) == key(want[j])
        assert comp[j]


@pytest.mark.parametrize("tier,steps", [(NARROW, 1), (NARROW, 2), (NARROW, 5), (NARROW, 20),
                                        (NARROW, "end"), (WIDE, 5), (WIDE, "end")])
def test_carry_matches_jax(tier, steps):
    """The port's phase steps from the JAX package's seeded carry (bridged)
    equal the JAX package's steps: the votes, walks, pushes, scores,
    snapshots and protocol registers of every lane."""
    eng, jeng = related()
    limit = fused.MAX_STEPS if steps == "end" else steps
    start, _ = jax_carry_after(eng, jeng, tier, 32, 0)
    want, _ = jax_carry_after(eng, jeng, tier, 32, limit)
    CAP, W, IC, PC = tier
    carry = fused.carry_from_numpy(nested(start), "cpu")
    assert not state_diff(carry, start)
    got, (n_active, _) = fused._phase_fused_seg(
        CAP, W, IC >= fused.I_CAP, resident._device_tables(eng, "cpu"), carry, eng.depth, eng.m,
        eng.b, eng.flank, eng.b * 2, limit)
    assert not state_diff(got, want)
    assert got["steps"] == int(want["steps"])
    if steps == "end":
        assert n_active == 0 and got["steps"] > 20
    else:
        assert n_active > 0 and got["steps"] == steps
