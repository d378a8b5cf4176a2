"""The port's streamed graph stage (CPU path: K1's, K2's and K4's plain
versions) against the JAX package: the resident rounds against its
build_junctions_streamed_resident on the resident cases of
tests/test_streamed.py, the host-bucketed rounds against its
build_junctions_streamed on that file's host-path cases, and a class that
outgrows every round through both packages' hand-over, with the same seeds
and arguments; K4's plain version and the round hash against the JAX
package's and a per-row spec; positions past 2^32 (plan, K4's payload, the
epilogue) without scanning them; the routing from build_junctions."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibeliaz_tpu.graph import streamed as jax_streamed
from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.graph import construct, kernels, streamed
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from torch_cases import ROUND_ROW_KINDS, round_rows

BEYOND_2_32 = (1 << 32) + 10**6


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


class Uploaded(Exception):
    pass


@pytest.mark.parametrize("route", ["resident", "host", "build_junctions"])
def test_inputs_past_2_32_positions_reach_the_upload(monkeypatch, route):
    """A zero-stride view of 2^32 bases (never read): each route takes it,
    plans it and reaches the upload with every position, where a stub stops
    it; build_junctions routes its two sequences to the resident rounds."""
    seen = []

    def stub(seqs, n, k, chunk, device):
        seen.append(n)
        raise Uploaded

    monkeypatch.setattr(streamed, "_upload", stub)
    big = np.broadcast_to(np.uint8(ord("A")), (1 << 32,))
    with pytest.raises(Uploaded):
        if route == "resident":
            streamed.build_junctions_streamed_resident([big], 25, "cpu")
        elif route == "host":
            streamed.build_junctions_streamed([big], 25, "cpu")
        else:
            construct.build_junctions([big[: (1 << 32) - (1 << 21)], big[:100]], 25, "cpu")
    want = (1 << 32) + 2 if route != "build_junctions" else (1 << 32) - (1 << 21) + 103
    assert seen == [want]


@pytest.mark.parametrize("k", [25, 33])
@pytest.mark.parametrize("budget", [None, 80 << 30])
def test_plan_past_2_32_positions(k, budget):
    """n = 2^32 + 10^6: the least power of two of rounds whose rows K2 takes
    (and whose buffers and epilogue fit the budget), the uploaded stream
    holding the last chunk's window, the stream counted in the fixed
    bytes."""
    n, chunk = BEYOND_2_32, 1 << 22
    p = streamed.plan(n, k, chunk, 1.25, budget)
    assert p.chunk == chunk and p.cap == math.ceil(n * 1.25 / p.n_rounds)
    assert p.cap <= streamed.MAX_ROUND_ROWS
    if budget is None:
        assert (p.n_rounds, p.G) == (4, 4)
        assert math.ceil(n * 1.25 / 2) > streamed.MAX_ROUND_ROWS
    else:
        assert p.n_rounds == 8 and 1 <= p.G < 8 and p.peak_bytes <= budget
        half = streamed.plan(n, k, chunk, 1.25, None, 4)
        assert half.fixed_bytes + half.cap * (half.row_bytes + half.epilogue_bytes) > budget
    padded = streamed._padded(n, k, chunk)
    last = (n - 3) // chunk * chunk  # the last chunk's window starts here
    assert padded % 8 == 0 and last + chunk + k + 2 <= padded < n + chunk + k + 10
    assert padded * 3 // 8 < p.fixed_bytes < padded * 3 // 8 + (200 << 20)


@pytest.mark.parametrize("limbs", [1, 2])
def test_round_append_and_epilogue_past_2_32(limbs):
    """A chunk whose rows straddle 2^32: K4's plain payloads equal the
    per-row spec with every bit of the position, and each round's junction
    rows (the epilogue) equal those of the same rows at position 1, shifted
    by the base."""
    m = 3 * kernels.K4_TILE_ROWS + 5
    keys, packed = round_rows("repeats", m, limbs)
    base = (1 << 32) - m // 2
    junctions = {}
    for gpos0 in (1, base):
        chunks = [(keys, packed, gpos0)]
        want = spec_rounds(chunks, 0, 3, 3)
        buf_keys, buf_payload, cursors, overflow = append_all(chunks, 0, 3, 3, m)
        assert int(overflow) == 0 and cursors.tolist() == [len(w) for w in want]
        junctions[gpos0] = []
        for g in range(3):
            live = len(want[g])
            got = list(zip((buf_payload[g, :live] >> 12).tolist(),
                           *(b[g, :live].tolist() for b in buf_keys),
                           (buf_payload[g, :live] & 0xFFF).tolist()))
            assert got == want[g]
            junctions[gpos0].append(streamed._junction_rows(
                [b[g, :live] for b in buf_keys], buf_payload[g, :live]))
    high = np.concatenate([j[0] for j in junctions[base]])
    assert high.min() < 1 << 32 <= high.max()
    for (g1, f1, o1), (g2, f2, o2) in zip(junctions[1], junctions[base]):
        assert len(g1) > 0
        assert np.array_equal(g2, g1 + base - 1) and np.array_equal(f2, f1 + base - 1)
        assert np.array_equal(o2, o1)


@pytest.mark.parametrize("k", [15, 33])
def test_bucket_pass_holds_each_rounds_rows_in_genome_order(k):
    """Pass 1 of the host-bucketed rounds against K1 on the whole stream at
    once: each round's bucket holds exactly the valid rows whose key hashes
    to it, in ascending position, with their key limbs and 12-bit words,
    and the rows per round count them."""
    seqs = resident_seqs()
    n = 1 + sum(len(s) + 1 for s in seqs)
    chunk, n_rounds = 4096, 5
    codes2, nmask = streamed._upload(seqs, n, k, chunk, "cpu")
    buckets, sizes = streamed._bucket_pass(codes2, nmask, n, k, chunk, n_rounds)
    keys, packed = kernels.front_half(codes2, nmask, n, k)
    valid = keys[0] != kernels.INVALID_CANON
    rnd = kernels.round_bucket(keys, n_rounds)
    for r in range(n_rounds):
        rows = torch.nonzero(valid & (rnd == r)).squeeze(1)
        block = np.concatenate(buckets[r], axis=1)
        assert sizes[r] == len(rows) == block.shape[1]
        assert np.array_equal(block[-1] >> 12, rows.numpy())
        assert np.array_equal(block[-1] & 0xFFF, (packed[rows] & 0xFFF).numpy())
        for got, key in zip(block[:-1], keys):
            assert np.array_equal(got, key[rows].numpy())


def test_host_rounds_refuse_what_k2_does_not_take(monkeypatch):
    """A host-bucketed round of 2^31 rows (a stub's count: no row is made)
    holds more than K2's int32 ranks: a ValueError that names n_rounds; one
    row fewer runs.  n_rounds must be at least 1."""
    sizes = np.array([5, 1 << 31, 0, 7])
    monkeypatch.setattr(streamed, "_bucket_pass", lambda *a: ([[] for _ in sizes], sizes))
    with pytest.raises(ValueError, match="n_rounds"):
        streamed.build_junctions_streamed(resident_seqs(), 15, "cpu", n_rounds=4)
    sizes[1] = streamed.MAX_ROUND_ROWS
    got = streamed.build_junctions_streamed(resident_seqs(), 15, "cpu", n_rounds=4)
    assert [len(r.pos) for r in got] == [0, 0, 0]
    with pytest.raises(ValueError, match="n_rounds"):
        streamed.build_junctions_streamed(resident_seqs(), 15, "cpu", n_rounds=0)


def genomes(seed, n_chr=3, lo=500, hi=3000, n_prob=0.0):
    """tests/test_streamed.py::genomes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_chr):
        L = int(rng.integers(lo, hi))
        s = alphabet.decode(rng.integers(0, 4, size=L).astype(np.uint8))
        if n_prob:
            s[rng.random(L) < n_prob] = ord("N")
        out.append(s)
    return out


def host(seqs, k, **kw):
    metrics.counters.clear()
    return streamed.build_junctions_streamed(seqs, k, "cpu", **kw)


@pytest.mark.parametrize("seed,k,chunk,rounds", [
    (0, 15, 1 << 10, 4),
    (1, 11, 777, 3),
    (2, 7, 1 << 12, 1),
    (3, 15, 1 << 9, 8),
])
def test_host_rounds_equal_jax(seed, k, chunk, rounds):
    """tests/test_streamed.py::test_streamed_matches_monolithic's cases:
    the host-bucketed rounds against the JAX package's, with the same
    arguments, but for the port's chunks, which start on a byte of the
    validity bitmap: 777 runs as 776 (still no power of two, chunks still
    crossing chromosomes)."""
    seqs = genomes(seed, n_prob=0.01 if seed % 2 else 0.0)
    want = jax_streamed.build_junctions_streamed(seqs, k, chunk_size=chunk, n_rounds=rounds)
    assert_same(want, host(seqs, k, chunk_size=chunk - chunk % 8, n_rounds=rounds))
    assert metrics.counters["graph_host_rounds"] == rounds


def test_host_rounds_related_equal_jax():
    """::test_streamed_related's genomes: a base, a 1% mutant and the
    base's reverse complement."""
    rng = np.random.default_rng(9)
    base = alphabet.decode(rng.integers(0, 4, size=4000).astype(np.uint8))
    g2 = base.copy()
    for p in np.flatnonzero(rng.random(len(g2)) < 0.01):
        g2[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    seqs = [base, g2, alphabet.reverse_complement(base)]
    want = jax_streamed.build_junctions_streamed(seqs, 15, chunk_size=1000, n_rounds=5)
    assert sum(len(w.pos) for w in want) > 0
    assert_same(want, host(seqs, 15, chunk_size=1000, n_rounds=5))


@pytest.mark.parametrize("k", [33, 61])
def test_host_rounds_two_limbs_equal_jax(k):
    """::test_streamed_wide_k_two_limb_bit_equal's host-path half."""
    seqs = wide_k_seqs()
    want = jax_streamed.build_junctions_streamed(seqs, k, chunk_size=4096, n_rounds=3)
    assert sum(len(w.pos) for w in want) > 0
    assert_same(want, host(seqs, k, chunk_size=4096, n_rounds=3))


def test_class_that_outgrows_every_round_equal_jax():
    """One class of ~5,000 rows (a poly-A run) outgrows every round (slack
    0.5, floor 1,000 rows): after 64 times the initial rounds the resident
    rounds hand over to the host-bucketed rounds, as the JAX package's do,
    with the same records."""
    rng = np.random.default_rng(3)
    seq = alphabet.decode(rng.integers(0, 4, size=3000).astype(np.uint8))
    seq = np.concatenate([seq, np.full(5000, ord("A"), np.uint8)])
    want = jax_streamed.build_junctions_streamed_resident(
        [seq], 15, chunk_size=1024, n_rounds=1, round_slack=0.5)
    assert_same(want, port([seq], 15, chunk_size=1024, n_rounds=1, round_slack=0.5))
    assert metrics.counters["graph_passes"] == 7  # 1, 2, 4, ..., 64 rounds
    assert metrics.counters["graph_round_retries"] == 6
    assert metrics.counters["graph_host_rounds"] == 64


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
