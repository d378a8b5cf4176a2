"""K2 class_analysis (plain PyTorch path) against the JAX package's
production class-analysis core, construct._v7_core_cummax2, on the same
sorted rows.  All comparisons are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibeliaz_tpu.graph import construct as jax_construct
from sibeliaz_tpu_torch.graph import construct, kernels

from torch_cases import class_case

_core = jax.jit(jax_construct._v7_core_cummax2, static_argnums=(1,))


def port_core(codes, k):
    pk_host, nm_host = construct.pack_codes_host(codes)
    key, packed = kernels.front_half(
        torch.from_numpy(pk_host), torch.from_numpy(nm_host), len(codes), k
    )
    key_s, order = torch.sort(key, stable=True)
    packed_s = packed[order]
    pos_s = order.to(torch.int32)
    junction_s, first_s = kernels.class_analysis(key_s, packed_s, pos_s)
    return junction_s.numpy(), first_s.numpy(), pos_s.numpy(), packed_s.numpy()


@pytest.mark.parametrize("case", ["repeat_heavy", "poly_a", "n_separated"])
@pytest.mark.parametrize("k", [9, 15, 25])
def test_plain_matches_cummax2(case, k):
    codes = class_case(case)
    want_j, want_first, want_idx, want_packed, _ = (
        np.asarray(x) for x in _core(jnp.asarray(codes), k)
    )
    got_j, got_first, got_pos, got_packed = port_core(codes, k)
    assert np.array_equal(got_pos, want_idx)
    assert np.array_equal(got_packed, want_packed)
    assert np.array_equal(got_j, want_j)
    assert np.array_equal(got_first, want_first)
    assert got_j.any()


def test_hot_class_is_one_junction_class():
    """A poly-A run folds into one class whose rows share one first
    position; with distinct flanks it is a junction."""
    codes = class_case("poly_a")
    got_j, got_first, got_pos, _ = port_core(codes, 15)
    hot = got_pos == 600  # a row inside the poly-A run
    cls_first = got_first[hot][0]
    members = got_first == cls_first
    assert members.sum() > 3000
    assert got_j[members].all()


def test_wrapper_checks_inputs():
    key = torch.zeros(4, dtype=torch.int64)
    packed = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.class_analysis(key, packed, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        kernels.class_analysis(key, packed, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.class_analysis(key.to("meta"), packed.to("meta"),
                               torch.zeros(4, dtype=torch.int32, device="meta"))
