"""K1 front_half (plain PyTorch path) against the JAX package's front half:
the jitted construct._prepare_packed, and the Pallas canon_packed kernel in
interpret mode.  All comparisons are exact integer equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibeliaz_tpu.graph import construct as jax_construct
from sibeliaz_tpu.graph import pallas_kernels as pk
from sibeliaz_tpu_torch.graph import construct, kernels

from torch_cases import codes_with_n_runs

_prepare_packed = jax.jit(jax_construct._prepare_packed, static_argnums=(1,))


def port_front_half(codes, k):
    pk_host, nm_host = construct.pack_codes_host(codes)
    key, packed = kernels.front_half(
        torch.from_numpy(pk_host), torch.from_numpy(nm_host), len(codes), k
    )
    return key.numpy(), packed.numpy()


@pytest.mark.parametrize("k", [3, 9, 15, 25, 31])
@pytest.mark.parametrize("n_at_ends", [False, True])
def test_plain_matches_prepare_packed(k, n_at_ends):
    codes = codes_with_n_runs(k, 3001, 12, n_at_ends)
    (keys, packed, _) = _prepare_packed(jnp.asarray(codes), k)
    key, got_packed = port_front_half(codes, k)
    assert np.array_equal(key, np.asarray(keys[0]))
    assert np.array_equal(got_packed, np.asarray(packed))


@pytest.mark.parametrize("n", [31, 32, 40])
def test_plain_matches_prepare_packed_tiny(n):
    """Inputs barely longer than the window: every window touches an end."""
    codes = codes_with_n_runs(n, n, 0)
    (keys, packed, _) = _prepare_packed(jnp.asarray(codes), 31)
    key, got_packed = port_front_half(codes, 31)
    assert np.array_equal(key, np.asarray(keys[0]))
    assert np.array_equal(got_packed, np.asarray(packed))


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
    key, packed = port_front_half(codes, k)
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
        kernels.front_half(codes2, nmask, 32, 33)
    with pytest.raises(ValueError):
        kernels.front_half(codes2[:4], nmask, 32, 5)
