"""K8 lcb_seed (lcb/kernels.py) on the CPU, through its plain version
(lcb/step.py's lcb_seed_plain): the carry and the seed-overflow row equal
to the fused engine's seeding before K8 (resident._seed_lanes_device,
seed_state, init_carry) on tests/torch_cases.py's SEED_CASES; the one
allocation the card's route carves its outputs from; the wrapper's
refusals; and a fused pass that reads the card once a lane set.  The
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py --seed)."""

import dataclasses

import numpy as np
import pytest
import torch

from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.lcb import fused, kernels, resident
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from torch_cases import SEED_CASES, related_genomes, seed_case, state_diff


@pytest.fixture(autouse=True)
def one_thread():
    """Lane tensors here are small: one intra-op thread a test process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(SEED_CASES))
def test_lcb_seed_is_the_seeding_it_replaces(name):
    """kernels.lcb_seed on CPU tables equals init_carry(seed_state(
    _seed_lanes_device(...)), active0, L) field for field, with steps 0;
    its overflow row is _seed_lanes_device's flags and `active` the lanes
    that hold a bundle and do not overflow.  Each case shows what it is
    laid for: padding lanes inert, minus-strand instances, lanes past IC
    64, slots the used filter took."""
    eng, bundles, L, IC, PC, seeds = seed_case(name)
    tb = resident._device_tables(eng, "cpu")
    carry, ovf = kernels.lcb_seed(tb, seeds, L, IC, PC)
    ln, n, want_ovf = resident._seed_lanes_device(tb, bundles, L, IC, PC)
    active0 = (torch.arange(L) < len(bundles)) & ~want_ovf
    assert not state_diff(carry, fused._init_carry(resident.seed_state(ln), active0, L))
    assert carry["steps"] == 0
    assert torch.equal(ovf, want_ovf)
    assert torch.equal(carry["active"], (torch.arange(L) < len(seeds)) & ~ovf)
    live = carry["st"].ln
    assert not bool(live.n[len(bundles):].any()) and not bool(live.pn[len(bundles):].any())
    assert bool((live.n[:len(bundles)] > 0).any())
    if name == "lanes32":
        assert bool((live.s == -1).any())  # minus-strand instances
    if name in ("overflow", "lanes200"):
        assert bool(ovf.any()) and not bool(carry["active"][ovf].any())
    if name == "used":  # the committed blocks' slots cut some lanes' windows
        fresh = resident._seed_lanes_device(resident._device_tables(
            seed_case("lanes8")[0], "cpu"), bundles, L, IC, PC)[1]
        assert int(eng.t.used_flat.sum()) > 0 and bool((n < fresh).any())


def test_seed_outputs_are_disjoint_views_of_one_allocation():
    """The card's route: SeedOutputs' allocation (seed_plan's layout) holds
    the lanes' [2, L] arguments, then the carry's 81 tensors and the
    overflow row, each of its spec's type and shape, contiguous, every row
    on 16 bytes; no two overlap (kernels.overlapping, K7's check), and the
    allocation holds no more than the three slabs and the registers (each
    region aligned)."""
    for L, IC, PC in ((256, 64, 128), (256, 512, 1024), (8, 64, 128), (200, 64, 128)):
        out = kernels.SeedOutputs(L, IC, PC, "cpu")
        plan, buf, carry, ovf = out.plan, out.buf, out.carry, out.ovf
        assert out.args.data_ptr() == buf.data_ptr() and out.args.shape == (2 * L,)
        outs = kernels._state_leaves(carry["st"]) + [carry[r] for r in kernels.CARRY_REGISTERS]
        specs = kernels._step_specs(L, IC, PC)
        for t, (dtype, shape, name) in zip(outs, specs):
            assert t.dtype == dtype and t.shape == shape and t.is_contiguous(), name
            at = t.data_ptr() - buf.data_ptr()
            assert at % t.element_size() == 0, name
            if t.dim() == 2:  # each lane's row on 16 bytes: K8's and K7's wide copies
                assert at % 16 == 0 and t.shape[1] * t.element_size() % 16 == 0, name
        assert ovf.dtype == torch.bool and ovf.shape == (L,)
        assert carry["steps"] == 0
        outs.append(ovf)
        assert kernels.overlapping(outs) is None
        assert all(t.untyped_storage().data_ptr() == buf.data_ptr() for t in outs)
        need = 16 * L + sum(t.numel() * t.element_size() for t in outs)
        assert min(t.data_ptr() for t in outs) - buf.data_ptr() >= 16 * L
        assert need <= plan.nbytes <= need + 5 * 256
        assert [plan.offsets[q] for q in range(len(outs))] == [
            t.data_ptr() - buf.data_ptr() for t in outs]


def test_lcb_seed_refusals(monkeypatch):
    """lcb_seed takes at most L seeds; tables on two devices, or on a
    device other than the CPU and a card, raise, and so do outputs to
    write again on the CPU route; on the card's route (routed there by a
    stub, the kernel library a stub: no card here) outputs of another
    shape, and an instance-slab width whose window the block's shared
    memory cannot hold, raise ValueError before anything is allocated or
    launched."""
    eng, bundles, L, IC, PC, seeds = seed_case("lanes8")
    tb = resident._device_tables(eng, "cpu")
    with pytest.raises(ValueError, match="at most L seeds"):
        kernels.lcb_seed(tb, np.zeros((9, 2), np.int64), 8, IC, PC)
    with pytest.raises(ValueError, match="writes no SeedOutputs"):
        kernels.lcb_seed(tb, seeds, L, IC, PC, into=kernels.SeedOutputs(L, IC, PC, "cpu"))
    split = dataclasses.replace(tb, used=tb.used.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        kernels.lcb_seed(split, seeds, L, IC, PC)
    meta = dataclasses.replace(tb, **{f: getattr(tb, f).to("meta")
                                      for f in kernels.SEED_TABLE_FIELDS})
    with pytest.raises(ValueError, match="no kernel for device type 'meta'"):
        kernels.lcb_seed(meta, seeds, L, IC, PC)

    asked = []

    class Library:  # the kernel library refusing the width
        def sz_lcb_seed_smem(self, ic):
            asked.append(ic)
            return -1

    def launched(*args):
        raise AssertionError("launched")

    card = kernels._SeedTables((), torch.device("cuda"))
    monkeypatch.setattr(kernels, "_seed_tables", lambda tb_: card)
    monkeypatch.setattr(kernels.cudabuild, "load", lambda defines=(): Library())
    monkeypatch.setattr(kernels, "_launch_seed", launched)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="a block may opt in to"):
        kernels.lcb_seed(tb, seeds, L, 1 << 14, PC)
    with pytest.raises(ValueError, match=r"not \(8, 64, 128\)"):
        kernels.lcb_seed(tb, seeds, L, IC, PC, into=kernels.SeedOutputs(L, IC, 256, "cpu"))
    assert asked == [1 << 14] and kernels.LAUNCHES == before


@pytest.mark.parametrize("patch", [{"VOTE_BUDGET": 1 << 12},
                                   {"SMALL_CAP": 3, "VOTE_BUDGET": 1 << 12}])
def test_fused_pass_reads_once_a_lane_set(monkeypatch, patch):
    """A tpu-fused pass on the CPU, its lane sets cut small (and with the
    narrow tier overflowing into the wide one): outside K7's plain host loop, whose reads a step
    are the CPU route's own (K7 on the card reads nothing), the engine
    reads the device once a lane set, the run's read, which brings the
    seed-overflow flags back with the run's; every lane set is seeded by
    one lcb_seed call; the GFF is the native engine's."""
    for name, value in patch.items():
        monkeypatch.setattr(fused, name, value)
    real_step, real_seed = kernels.lcb_step, kernels.lcb_seed
    seeded = []

    def step_unread(*args):
        before = metrics.counters.get("fused_host_syncs", 0)
        out = real_step(*args)
        metrics.counters["fused_host_syncs"] = before
        return out

    def seed(*args, **kwargs):
        seeded.append(args[2])
        return real_seed(*args, **kwargs)

    monkeypatch.setattr(kernels, "lcb_step", step_unread)
    monkeypatch.setattr(kernels, "lcb_seed", seed)
    seqs, names = related_genomes(520, length=1200, mut=0.03, rearrange=True)
    metrics.counters.clear()
    got = pipeline.find_blocks(seqs, names, Config(k=15), engine="tpu-fused", device="cpu")
    counters = dict(metrics.counters)
    want = pipeline.find_blocks(seqs, names, Config(k=15), device="cpu")
    assert got.gff == want.gff and got.blocks_found > 0
    runs = counters["fused_runs"]
    assert counters["fused_host_syncs"] == runs == len(seeded) > 1
    if "SMALL_CAP" in patch:
        assert counters.get("fused_lanes_tier1", 0) > 0
