"""K1 front_half (plain PyTorch path) against the JAX package's front half:
the jitted construct._prepare_packed (one key limb for k <= 31, two for
32 <= k <= 61), and the Pallas canon_packed kernel in interpret mode.  All
comparisons are exact integer equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibeliaz_tpu.graph import construct as jax_construct
from sibeliaz_tpu.graph import pallas_kernels as pk
from sibeliaz_tpu_torch.graph import construct, kernels

from torch_cases import K1_KINDS, codes_with_n_runs, k1_case, k1_codes

_prepare_packed = jax.jit(jax_construct._prepare_packed, static_argnums=(1,))


def port_front_half(codes, k):
    pk_host, nm_host = construct.pack_codes_host(codes)
    keys, packed = kernels.front_half(
        torch.from_numpy(pk_host), torch.from_numpy(nm_host), len(codes), k
    )
    return [key.numpy() for key in keys], packed.numpy()


def assert_same_keys(got, want):
    """Every key limb equal: one for k <= 31, (hi, lo) above."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


# k <= 2: no inner window; 32: the first two-limb k (one base in hi)
@pytest.mark.parametrize("k", [1, 2, 3, 9, 15, 25, 31, 32, 33, 45, 61])
@pytest.mark.parametrize("n_at_ends", [False, True])
def test_plain_matches_prepare_packed(k, n_at_ends):
    codes = codes_with_n_runs(k, 3001, 12, n_at_ends)
    (keys, packed, _) = _prepare_packed(jnp.asarray(codes), k)
    got_keys, got_packed = port_front_half(codes, k)
    assert_same_keys(got_keys, keys)
    assert np.array_equal(got_packed, np.asarray(packed))


@pytest.mark.parametrize("n", [31, 32, 40])
def test_plain_matches_prepare_packed_tiny(n):
    """Inputs barely longer than the window: every window touches an end."""
    codes = codes_with_n_runs(n, n, 0)
    (keys, packed, _) = _prepare_packed(jnp.asarray(codes), 31)
    got_keys, got_packed = port_front_half(codes, 31)
    assert_same_keys(got_keys, keys)
    assert np.array_equal(got_packed, np.asarray(packed))


def assert_plain_matches_prepare_packed(codes2, nmask, n, k):
    (keys, packed, _) = _prepare_packed(jnp.asarray(k1_codes(codes2, nmask, n)), k)
    got_keys, got_packed = kernels.front_half(
        torch.from_numpy(codes2), torch.from_numpy(nmask), n, k)
    assert_same_keys([key.numpy() for key in got_keys], keys)
    assert np.array_equal(got_packed.numpy(), np.asarray(packed))


@pytest.mark.parametrize("k,n", [(k, n) for k in (1, 2, 3, 8, 16, 31)
                                 for n in (k - 1, k, k + 1) if n >= 1]
                         + [(k, n) for k in (33, 61) for n in (1, k - 1, k, k + 1)])
def test_plain_matches_prepare_packed_at_window_length(k, n):
    """n around k: every window wraps (more than once where n < k / 2) or
    touches an end."""
    codes2, nmask = k1_case("random_bytes", n, 64, seed=k)
    assert_plain_matches_prepare_packed(codes2, nmask, n, k)


@pytest.mark.parametrize("k", [2, 15, 31, 61])
@pytest.mark.parametrize("kind", K1_KINDS)
def test_plain_matches_prepare_packed_on_k1_cases(kind, k):
    """Inputs the engine never makes: N runs on tile edges, all N, no N,
    an N every other position, code bits set under N, garbage past n."""
    n = 3 * kernels.K1_TILE_POSITIONS + 5
    assert_plain_matches_prepare_packed(*k1_case(kind, n, kernels.K1_TILE_POSITIONS), n, k)


@pytest.mark.parametrize("k", [1, 15, 31])
@pytest.mark.parametrize("kind", ["random_bytes", "long_tail"])
def test_plain_ignores_code_bits_under_n(kind, k):
    n = 2000 + k
    codes2, nmask = k1_case(kind, n, kernels.K1_TILE_POSITIONS)
    codes = k1_codes(codes2, nmask, n)
    clean = construct.pack_codes_host(codes)[0]  # zero code bits under N
    assert not np.array_equal(clean, codes2[: len(clean)])
    (got_key,), got_packed = kernels.front_half(
        torch.from_numpy(codes2), torch.from_numpy(nmask), n, k)
    (want_key,), want_packed = kernels.front_half(
        torch.from_numpy(clean), torch.from_numpy(nmask), n, k)
    assert torch.equal(got_key, want_key) and torch.equal(got_packed, want_packed)


@pytest.mark.parametrize("k", [15, 31])
def test_plain_matches_pallas_canon_packed(k, monkeypatch):
    """canon_packed (interpret mode, one TILE) emits the key as hi/lo int32
    halves and reads past the end as N, not cyclically, so the windows that
    run past the end (the last k - 1) are left out of the packed check."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(orig, interpret=True)
    )
    codes = codes_with_n_runs(100 + k, pk.TILE, 40)
    hi, lo, want_packed = (
        np.asarray(x) for x in pk.canon_packed.__wrapped__(jnp.asarray(codes), k)
    )
    (key,), packed = port_front_half(codes, k)
    valid = ((want_packed >> 12) & 1) > 0
    assert np.array_equal(valid, key != kernels.INVALID_CANON)
    b = min(k, 16)
    canon = (hi.astype(np.int64) << (2 * b)) | (
        lo.astype(np.int64) & ((1 << (2 * b)) - 1)
    )
    assert np.array_equal(key[valid], canon[valid])
    interior = len(codes) - k + 1
    assert np.array_equal(packed[:interior], want_packed[:interior] & 0xFFF)


def test_wrapper_routes_by_device():
    codes2 = torch.zeros(8, dtype=torch.uint8)
    nmask = torch.zeros(4, dtype=torch.uint8)
    before = dict(kernels.LAUNCHES)
    kernels.front_half(codes2, nmask, 32, 5)
    assert kernels.LAUNCHES == before  # the plain path launches nothing
    with pytest.raises(ValueError):
        kernels.front_half(codes2.to("meta"), nmask.to("meta"), 32, 5)
    with pytest.raises(ValueError):
        kernels.front_half(codes2, nmask, 32, kernels.MAX_K + 1)
    with pytest.raises(ValueError):
        kernels.front_half(codes2[:4], nmask, 32, 5)
