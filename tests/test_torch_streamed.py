"""The port's streamed graph stage (CPU path: K1's and K4's plain versions)
against the JAX package's build_junctions_streamed_resident on the resident
cases of tests/test_streamed.py, with the same seeds and arguments; K4's
plain version and the round hash against the JAX package's and a per-row
spec; the routing from build_junctions and the refusals that name ROADMAP.md
queue A item 4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibeliaz_tpu.graph import streamed as jax_streamed
from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.graph import construct, kernels, streamed
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from torch_cases import ROUND_ROW_KINDS, round_rows


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.pos.dtype == y.pos.dtype and x.ids.dtype == y.ids.dtype
        assert np.array_equal(x.pos, y.pos)
        assert np.array_equal(x.ids, y.ids)


def mutated(rng, base, rate):
    out = base.copy()
    idx = np.flatnonzero(rng.random(len(out)) < rate)
    out[idx] = alphabet.decode(rng.integers(0, 4, size=len(idx)).astype(np.uint8))
    return out


def resident_seqs():
    """tests/test_streamed.py::test_resident_rounds_bit_equal's input."""
    rng = np.random.default_rng(41)
    base = alphabet.decode(rng.integers(0, 4, size=20000).astype(np.uint8))
    mut = mutated(rng, base, 0.01)
    for p in rng.integers(0, len(mut), size=4):
        mut[p] = ord("N")
    return [base, mut, alphabet.reverse_complement(base)]


def wide_payload_seqs():
    """::test_resident_rounds_wide_payload_bit_equal's input."""
    rng = np.random.default_rng(47)
    base = alphabet.decode(rng.integers(0, 4, size=15000).astype(np.uint8))
    mut = mutated(rng, base, 0.01)
    return [base, mut, alphabet.reverse_complement(base)[:7000]]


def wide_k_seqs():
    """::test_streamed_wide_k_two_limb_bit_equal's input."""
    rng = np.random.default_rng(51)
    base = alphabet.decode(rng.integers(0, 4, size=12000).astype(np.uint8))
    mut = mutated(rng, base, 0.01)
    for p in rng.integers(0, len(mut), size=4):
        mut[p] = ord("N")
    return [base, mut, alphabet.reverse_complement(base)[:5000]]


def wide_k_payload_seqs():
    """::test_streamed_wide_k_wide_payload's input."""
    rng = np.random.default_rng(53)
    base = alphabet.decode(rng.integers(0, 4, size=9000).astype(np.uint8))
    return [base, mutated(rng, base, 0.02)]


def port(seqs, k, **kw):
    metrics.counters.clear()
    return streamed.build_junctions_streamed_resident(seqs, k, "cpu", **kw)


@pytest.mark.parametrize("n_rounds", [1, 3])
def test_resident_rounds_equal_jax(n_rounds):
    seqs = resident_seqs()
    want = jax_streamed.build_junctions_streamed_resident(
        seqs, 15, chunk_size=4096, n_rounds=n_rounds)
    assert_same(want, port(seqs, 15, chunk_size=4096, n_rounds=n_rounds))
    assert metrics.counters["graph_rounds"] == n_rounds


@pytest.mark.parametrize("n_rounds", [1, 2])
def test_resident_rounds_equal_jax_wide_payload(n_rounds):
    """The JAX package's wide payload (force_wide) against the port's one
    int64 payload."""
    seqs = wide_payload_seqs()
    want = jax_streamed.build_junctions_streamed_resident(
        seqs, 15, chunk_size=4096, n_rounds=n_rounds, force_wide=True)
    assert_same(want, port(seqs, 15, chunk_size=4096, n_rounds=n_rounds))


def test_resident_rounds_overflow_retry_equal_jax():
    """slack 0.2: the first rounds overflow; n_rounds doubles until a round
    holds its rows."""
    rng = np.random.default_rng(43)
    base = alphabet.decode(rng.integers(0, 4, size=6000).astype(np.uint8))
    seqs = [base, base.copy()]
    want = jax_streamed.build_junctions_streamed_resident(
        seqs, 15, chunk_size=1024, n_rounds=2, round_slack=0.2)
    got = port(seqs, 15, chunk_size=1024, n_rounds=2, round_slack=0.2)
    assert_same(want, got)
    assert metrics.counters["graph_round_retries"] > 0
    assert metrics.counters["graph_rounds"] == 2 << int(metrics.counters["graph_round_retries"])


@pytest.mark.parametrize("k", [33, 61])
def test_resident_rounds_two_limbs_equal_jax(k):
    seqs = wide_k_seqs()
    want = jax_streamed.build_junctions_streamed_resident(seqs, k, chunk_size=4096, n_rounds=3)
    assert sum(len(w.pos) for w in want) > 0
    assert_same(want, port(seqs, k, chunk_size=4096, n_rounds=3))


def test_resident_rounds_two_limbs_wide_payload_equal_jax():
    seqs = wide_k_payload_seqs()
    want = jax_streamed.build_junctions_streamed_resident(
        seqs, 33, chunk_size=2048, n_rounds=2, force_wide=True)
    assert_same(want, port(seqs, 33, chunk_size=2048, n_rounds=2))


@pytest.mark.parametrize("k", [15, 33, 61])
def test_several_passes_equal_monolithic(k):
    """A budget that holds fewer round buffers than rounds: G < n_rounds, so
    the stream is scanned once per G rounds."""
    seqs = wide_k_seqs()
    n = 1 + sum(len(s) + 1 for s in seqs)
    p = streamed.plan(n, k, 1024, 1.25, None, 8)
    budget = p.fixed_bytes + p.cap * (p.epilogue_bytes + 3 * p.row_bytes)
    got = port(seqs, k, chunk_size=1024, memory_budget_bytes=budget)
    assert metrics.counters["graph_rounds"] == 8
    assert metrics.counters["graph_rounds_per_pass"] == 3
    assert metrics.counters["graph_passes"] == 3
    assert_same(construct.build_junctions(seqs, k, "cpu"), got)


@pytest.mark.parametrize("k", [25, 33])
def test_round_bucket_equals_jax_and_is_balanced(k):
    """tests/test_streamed.py::test_round_bucket_balance_power_of_two's
    canons: the plain hash equals _round_bucket / _round_bucket2 bit for bit
    and keeps max/mean under 1.2 for 8 and 16 rounds."""
    rng = np.random.default_rng(7)
    seq = alphabet.decode(rng.integers(0, 4, size=200_000).astype(np.uint8))
    codes = np.concatenate([[ord("N")], seq, [ord("N")]]).astype(np.uint8)
    if k == 25:
        canon, _, _ = jax_streamed._chunk_scan(
            jnp.asarray(alphabet.encode(codes)[: (1 << 17) + 27]), 25)
        keys = (np.asarray(canon),)
    else:
        ch, cl, _, _ = jax_streamed._chunk_scan2(
            jnp.asarray(alphabet.encode(codes)[: (1 << 17) + 43]), 33)
        keys = (np.asarray(ch), np.asarray(cl))
    valid = keys[0] != kernels.INVALID_CANON
    keys = tuple(x[valid] for x in keys)
    for R in (8, 16):
        if k == 25:
            want = np.asarray(jax_streamed._round_bucket(jnp.asarray(keys[0]), R))
        else:
            want = np.asarray(jax_streamed._round_bucket2(
                jnp.asarray(keys[0]), jnp.asarray(keys[1]), R))
        got = kernels.round_bucket(tuple(torch.from_numpy(x) for x in keys), R).numpy()
        assert np.array_equal(got, want)
        cnt = np.bincount(got, minlength=R)
        assert cnt.max() / cnt.mean() < 1.2, (R, cnt.tolist())


def spec_rounds(chunks, r0, n_rounds, G):
    """Per round, the (global position, key limbs, word) of every kept row of
    `chunks` ((keys, packed, gpos0) each) in genome order, row by row."""
    out = [[] for _ in range(G)]
    for keys, packed, gpos0 in chunks:
        rnd = kernels.round_bucket(tuple(torch.from_numpy(x) for x in keys), n_rounds).numpy()
        for i in range(len(packed)):
            g = int(rnd[i]) - r0
            if keys[0][i] != kernels.INVALID_CANON and 0 <= g < G:
                out[g].append((gpos0 + i, *(int(x[i]) for x in keys), int(packed[i]) & 0xFFF))
    return out


def append_all(chunks, r0, n_rounds, G, cap, start=0):
    limbs = len(chunks[0][0])
    buf_keys = tuple(torch.full((G, cap), -7, dtype=torch.int64) for _ in range(limbs))
    buf_payload = torch.full((G, cap), -7, dtype=torch.int64)
    cursors = torch.full((G,), start, dtype=torch.int64)
    overflow = torch.zeros(1, dtype=torch.int32)
    for keys, packed, gpos0 in chunks:
        kernels.round_append(tuple(torch.from_numpy(x) for x in keys), torch.from_numpy(packed),
                             gpos0, r0, n_rounds, buf_keys, buf_payload, cursors, overflow)
    return buf_keys, buf_payload, cursors, overflow


@pytest.mark.parametrize("limbs", [1, 2])
@pytest.mark.parametrize("kind", ROUND_ROW_KINDS)
@pytest.mark.parametrize("r0,n_rounds,G", [(0, 1, 1), (0, 5, 5), (2, 7, 3), (6, 7, 1)])
def test_round_append_plain_keeps_genome_order(kind, limbs, r0, n_rounds, G):
    """Three hand-laid chunks, one of them not a tile multiple: each round
    holds its kept rows in ascending global position, exactly the rows the
    per-row spec keeps (the kinds that lay a round out by tiles lay the
    pass's first round)."""
    T = kernels.K4_TILE_ROWS
    chunks, gpos0 = [], 1
    for c, m in enumerate((3 * T, T + 5, 2 * T)):
        keys, packed = round_rows(kind, m, limbs, seed=c, hot=r0, tile=T)
        chunks.append((keys, packed, gpos0))
        gpos0 += m
    want = spec_rounds(chunks, r0, n_rounds, G)
    cap = 6 * T + 5
    buf_keys, buf_payload, cursors, overflow = append_all(chunks, r0, n_rounds, G, cap)
    assert int(overflow) == 0
    assert cursors.tolist() == [len(w) for w in want]
    for g in range(G):
        live = len(want[g])
        got = list(zip((buf_payload[g, :live] >> 12).tolist(),
                       *(b[g, :live].tolist() for b in buf_keys),
                       (buf_payload[g, :live] & 0xFFF).tolist()))
        assert got == want[g]
        assert (buf_payload[g, live:] == -7).all()
    if kind == "all_invalid":
        assert cursors.sum() == 0


@pytest.mark.parametrize("limbs", [1, 2])
def test_round_append_plain_overflow_writes_nothing_past_the_cap(limbs):
    """Cursors just under the cap: the flag is set, the rows that fit are
    written, none past the cap, and the cursors advance by every kept row."""
    keys, packed = round_rows("repeats", 3000, limbs)
    chunks = [(keys, packed, 100)]
    want = spec_rounds(chunks, 0, 4, 4)
    cap = 1000
    start = cap - 5
    buf_keys, buf_payload, cursors, overflow = append_all(chunks, 0, 4, 4, cap, start=start)
    assert int(overflow) == 1
    assert cursors.tolist() == [start + len(w) for w in want]
    for g in range(4):
        fit = min(5, len(want[g]))
        assert (buf_payload[g, :start] == -7).all()
        assert (buf_payload[g, start : start + fit] >> 12).tolist() == [w[0] for w in want[g][:5]]
        assert (buf_payload[g, start + fit :] == -7).all()
    # a cursor that ends exactly at the cap is no overflow
    want = spec_rounds(chunks, 0, 1, 1)
    _, _, cursors, overflow = append_all(chunks, 0, 1, 1, len(want[0]))
    assert int(overflow) == 0 and cursors.tolist() == [len(want[0])]


def test_round_append_refuses_what_the_kernel_does_not_take():
    keys, packed = round_rows("random", 100, 1)
    key = (torch.from_numpy(keys[0]),)
    word = torch.from_numpy(packed)
    G = kernels.MAX_ROUNDS_PER_LAUNCH + 1
    buf = torch.zeros((G, 10), dtype=torch.int64)
    with pytest.raises(ValueError, match="rounds"):
        kernels.round_append(key, word, 0, 0, G, (buf,), buf.clone(),
                             torch.zeros(G, dtype=torch.int64), torch.zeros(1, dtype=torch.int32))
    buf = torch.zeros((2, 10), dtype=torch.int64)
    with pytest.raises(ValueError, match="name no round"):
        kernels.round_append(key, word, 0, 4, 4, (buf,), buf.clone(),
                             torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="one buffer per key limb"):
        kernels.round_append(key, word, 0, 0, 4, (buf, buf), buf.clone(),
                             torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("k", [15, 33])
def test_build_junctions_routes_to_the_streamed_stage(k):
    """A budget one byte under the monolithic stage's peak runs the streamed
    stage, with the same records."""
    seqs = wide_k_seqs()
    n = sum(len(s) for s in seqs) + len(seqs) - 1
    per_pos = construct.PEAK_BYTES_PER_POS if k <= 31 else construct.PEAK_BYTES_PER_POS_WIDE
    want = construct.build_junctions(seqs, k, "cpu")
    metrics.timings.clear()
    got = construct.build_junctions(seqs, k, "cpu", memory_budget_bytes=n * per_pos - 1)
    assert "graph_scan" in {t["stage"] for t in metrics.timings}
    assert_same(want, got)


def test_positions_past_the_resident_rounds_are_queue_a4():
    """2^32 - chunk positions and more go to the JAX package's host-bucketed
    path; the port refuses them before it reads a byte (the sequence is a
    zero-stride view)."""
    big = np.broadcast_to(np.uint8(ord("A")), (1 << 32,))
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        streamed.build_junctions_streamed_resident([big], 25, "cpu")
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        construct.build_junctions([big[: (1 << 32) - (1 << 21)], big[:100]], 25, "cpu")


def test_rounds_that_keep_overflowing_are_queue_a4():
    """One class of ~5,000 rows (a poly-A run) outgrows every round (slack
    0.5, floor 1,000 rows): after 64 times the initial rounds the stage
    refuses."""
    rng = np.random.default_rng(3)
    seq = alphabet.decode(rng.integers(0, 4, size=3000).astype(np.uint8))
    seq = np.concatenate([seq, np.full(5000, ord("A"), np.uint8)])
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        port([seq], 15, chunk_size=1024, n_rounds=1, round_slack=0.5)
    assert metrics.counters["graph_passes"] == 7  # 1, 2, 4, ..., 64 rounds


def test_chunk_size_must_be_a_multiple_of_8():
    with pytest.raises(ValueError, match="multiple of 8"):
        port(resident_seqs(), 15, chunk_size=4097)


def test_plan_fits_the_budget():
    """n_rounds is the least power of two whose round fits; G fills the rest
    of the budget; a budget that holds no round is a MemoryError."""
    n, k, chunk = 10_000_000, 25, 1 << 20
    p = streamed.plan(n, k, chunk, 1.25, None)
    assert (p.n_rounds, p.G, p.cap) == (1, 1, 12_500_000)
    budget = 300 << 20
    p = streamed.plan(n, k, chunk, 1.25, budget)
    assert p.peak_bytes <= budget and 1 <= p.G <= p.n_rounds
    q = streamed.plan(n, k, chunk, 1.25, None, p.n_rounds // 2)
    assert q.fixed_bytes + q.cap * (q.row_bytes + q.epilogue_bytes) > budget
    with pytest.raises(MemoryError):
        streamed.plan(n, k, chunk, 1.25, 1 << 20)
    with pytest.raises(ValueError, match="rows a round"):
        streamed.plan(3 << 30, k, chunk, 1.25, None, 1)
