"""The fused LCB engine's lanes over a device list (lcb/fused.py `devices=`)
against the JAX package on the CPU.

Host seeding (`batched.seed_batch`, `resident._seed_lanes`) equal to the JAX
package's and, at full width, to the device seeding; a phase's instance
lists over 2, 3 and 8 CPU devices equal to the JAX package's
`process_phase_fused(mesh=)` on as many of conftest's host devices and to
`eng.process`, bundle by bundle; the edges (slices of padding alone,
escalation, step-bound lanes, compaction inside a slice, walks spanning
steps) equal to the one-device run; `run_fused` over two devices at the
native engine's GFF across several phases; and the refusals."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sibeliaz_tpu.lcb import batched as jax_batched
from sibeliaz_tpu.lcb import fused as jax_fused
from sibeliaz_tpu.lcb import resident as jax_resident
from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.lcb import batched, fused, resident
from sibeliaz_tpu_torch.lcb import batched_push_device as bpd
from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
from sibeliaz_tpu_torch.lcb.oracle import LcbEngine
from sibeliaz_tpu_torch.output import gff, trim
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from reference_oracle import random_related_genomes
from test_torch_fused_parts import engines, related
from torch_cases import repeat_genomes, state_diff


@pytest.fixture(autouse=True)
def one_thread():
    """Lane tensors here are small: one intra-op thread a test process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inst_key(results):
    return [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
            for insts in results]


# ---- host seeding ----------------------------------------------------------


@pytest.mark.parametrize("case", ["related", "repeat_520"])
def test_host_seeding_matches_jax_and_device_seeding(case):
    """seed_batch and _seed_lanes equal the JAX package's on one table,
    padded lanes past the bundles included; at full width the lanes equal
    _seed_lanes_device's wherever neither flags an overflow.  The repeat's
    520-copy bundle seeds more than I_CAP instances: flagged by both."""
    if case == "related":
        eng, jeng = related()
        mark = slice(None, None, 5)  # some used junctions filtered out
    else:
        eng, jeng = engines(*repeat_genomes(3, 520), abundance=1000)
        mark = slice(0, 0)
    eng.t.used_flat[mark] = 1
    jeng.t.used_flat[mark] = 1
    bundles = make_bundles_device(eng.t, "cpu")[:40]

    sb, jsb = batched.seed_batch(eng.t, bundles), jax_batched.seed_batch(jeng.t, bundles)
    for f in ("chr", "idx", "strand", "n"):
        a, b = getattr(sb, f), getattr(jsb, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert batched.seed_batch(eng.t, []).chr.shape == (0, 0)

    L = 64
    ln, n, ovf = resident._seed_lanes(eng.t, bundles, L, "cpu")
    jln, jn, jovf = jax_resident._seed_lanes(jeng.t, bundles, L)
    assert not state_diff(ln, jln)
    assert np.array_equal(n, jn) and np.array_equal(ovf, jovf)
    assert (n[len(bundles):] == 0).all() and (ln.pn.numpy()[len(bundles):] == 0).all()
    assert ovf.any() == (case == "repeat_520")

    tb = bpd.DeviceTables.build(eng.t, "cpu")
    dln, dn, dovf = resident._seed_lanes_device(tb, bundles, L, bpd.I_CAP, bpd.P_CAP)
    dovf = dovf.numpy()
    assert not (ovf & ~dovf).any()  # seeded past I_CAP: more occurrences too
    keep = ~dovf
    assert np.array_equal(n[keep], dn.numpy()[keep])
    for f in bpd.LANE_FIELDS:
        assert torch.equal(getattr(ln, f)[keep], getattr(dln, f)[keep]), f


# ---- a phase over a device list --------------------------------------------


@functools.lru_cache(maxsize=None)
def mesh_case():
    """The port's engine, the JAX package's and the 32 bundles of the JAX
    package's test_fused_phase_sharded_over_mesh, with eng.process's
    instances."""
    eng, jeng = engines(*random_related_genomes(522, length=1200, mut=0.03, rearrange=True))
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    return eng, jeng, bundles, inst_key(eng.process(b) for b in bundles)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_phase_over_devices_matches_jax_mesh(n):
    """process_phase_fused over n CPU devices, per bundle, equal to the JAX
    package's process_phase_fused over an n-device mesh and to
    eng.process; at n=3 the lanes pad to 33."""
    eng, jeng, bundles, want = mesh_case()
    metrics.counters.clear()
    got = inst_key(fused.process_phase_fused(eng, bundles, devices=["cpu"] * n))
    assert metrics.counters["fused_slices"] == n
    assert metrics.counters["fused_lanes_tier0"] == len(bundles)
    mesh = Mesh(np.array(jax.devices()[:n]), ("lanes",))
    assert got == inst_key(jax_fused.process_phase_fused(jeng, bundles, mesh=mesh)) == want
    assert any(got)


@functools.lru_cache(maxsize=None)
def edge_case():
    eng, _ = related()
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    return eng, bundles, inst_key(fused.process_phase_fused(eng, bundles, device="cpu"))


@pytest.mark.parametrize("kind", ["padding_slices", "escalate", "step_bound", "compaction",
                                  "walk_chunk"])
def test_phase_over_devices_edges(monkeypatch, kind):
    """Over three CPU devices (eight for the padding slices), per bundle,
    equal to the one-device run and to eng.process: 5 bundles over 8
    devices (lanes 32, slices of 4: six slices of padding alone, not run),
    escalation (a 3-instance vote cap and a tiny vote budget), step-bound
    lanes to the oracle (MAX_STEPS 4: every lane of every slice),
    compaction inside a slice (COMPACT_MIN 8, slices of 11 lanes) and
    walks spanning outer steps (WALK_CHUNK 2)."""
    patch = {"escalate": {"SMALL_CAP": 3, "VOTE_BUDGET": 1 << 14},
             "step_bound": {"MAX_STEPS": 4}, "walk_chunk": {"WALK_CHUNK": 2},
             "compaction": {"COMPACT_MIN": 8}}.get(kind, {})
    eng, bundles, one = edge_case()
    devices = ["cpu"] * 3
    if kind == "padding_slices":
        bundles, one, devices = bundles[:5], one[:5], ["cpu"] * 8
    for name, value in patch.items():
        monkeypatch.setattr(fused, name, value)
    metrics.counters.clear()
    got = inst_key(fused.process_phase_fused(eng, bundles, devices=devices))
    assert got == one == inst_key(eng.process(b) for b in bundles)
    counters = metrics.counters
    if kind == "padding_slices":
        assert counters["fused_slices"] == 2
    if kind == "escalate":
        assert counters["fused_lanes_tier1"] > 0 and counters["fused_steps_tier1"] > 0
    if kind == "step_bound":
        assert counters["fused_oracle_lanes"] == len(bundles)
        assert counters["fused_steps_tier0"] == 4
    else:
        assert counters["fused_oracle_lanes"] == 0
    if kind == "compaction":
        assert counters.get("fused_compactions", 0) > 0
    assert any(got)


@pytest.mark.parametrize("k", [15, 33])
def test_run_fused_over_devices_gff_matches_native(monkeypatch, k):
    """run_fused over ["cpu", "cpu"] with a phase size of 4 (three phases
    and more, each refreshing the tables' `used`): the native engine's
    GFF."""
    seqs, names = random_related_genomes(521, length=1200, mut=0.03, rearrange=True)
    cfg = Config(k=k)
    eng = LcbEngine(pipeline.build_table(seqs, names, cfg, device="cpu"), cfg.min_block_size,
                    cfg.max_branch_size, cfg.flanking)
    phases = []
    original = LcbEngine.run

    def run(self, process_batch_fn=None, phase_size=256, bundles=None):
        phases.append(-(-len(bundles) // 4))
        return original(self, process_batch_fn, 4, bundles)

    monkeypatch.setattr(LcbEngine, "run", run)
    raw = fused.run_fused(eng, devices=["cpu", "cpu"])
    assert phases[0] >= 3
    lengths = [len(s) for s in seqs]
    blocks, _ = trim.trim_blocks(raw, lengths, cfg.min_block_size)
    native = pipeline.find_blocks(seqs, names, cfg, device="cpu")
    assert gff.render_gff(blocks, names, lengths) == native.gff and native.blocks_found > 0


def test_device_lists_refused():
    """A list that mixes cpu and cuda, an empty list, and (without a card)
    a cuda list raise; nothing falls back to one device or the CPU."""
    eng, bundles, _ = edge_case()
    metrics.counters.clear()
    for devices in (["cpu", "cuda"], ["cuda:0", "cpu"], []):
        with pytest.raises(ValueError, match="one kind of device"):
            fused.process_phase_fused(eng, bundles, devices=devices)
        with pytest.raises(ValueError, match="one kind of device"):
            fused.run_fused(eng, devices=devices)
    if not torch.cuda.is_available():
        for devices in (["cuda"], ["cuda:0", "cuda:0"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fused.process_phase_fused(eng, bundles, devices=devices)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fused.run_fused(eng, devices=devices)
    assert "fused_phases" not in metrics.counters and not eng.blocks
