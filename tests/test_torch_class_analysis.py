"""K2 class_analysis (plain PyTorch path) against the JAX package's
production class-analysis core, construct._v7_core_cummax2, on the same
sorted rows (one key limb for k <= 31, two above), and against a numpy
per-run oracle on hand-laid runs.  All comparisons are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibeliaz_tpu.graph import construct as jax_construct
from sibeliaz_tpu_torch.graph import construct, kernels

from torch_cases import CLASS_RUN_KINDS, LIMB_SPLITS, class_case, class_runs, split_limbs

_core = jax.jit(jax_construct._v7_core_cummax2, static_argnums=(1,))


def port_core(codes, k):
    pk_host, nm_host = construct.pack_codes_host(codes)
    keys, packed = kernels.front_half(
        torch.from_numpy(pk_host), torch.from_numpy(nm_host), len(codes), k
    )
    keys_s, order = construct.sort_keys(list(keys))
    packed_s = packed[order]
    pos_s = order.to(torch.int32)
    junction_s, first_s = kernels.class_analysis(keys_s, packed_s, pos_s)
    return junction_s.numpy(), first_s.numpy(), pos_s.numpy(), packed_s.numpy()


@pytest.mark.parametrize("case", ["repeat_heavy", "poly_a", "n_separated"])
@pytest.mark.parametrize("k", [9, 15, 25, 33, 45])
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


@pytest.mark.parametrize("rows", [-1, 0, 1])
def test_port_matches_cummax2_when_the_hot_class_fills_a_tile(rows):
    """The poly-A/poly-T class (key 0, rows 0..) has exactly T - 1, T and
    T + 1 rows, T the kernel's tile."""
    rows += kernels.K2_TILE_ROWS
    codes = class_case("poly_a_rows", rows=rows, k=15)
    want_j, want_first, want_idx, _, _ = (
        np.asarray(x) for x in _core(jnp.asarray(codes), 15)
    )
    got_j, got_first, got_pos, _ = port_core(codes, 15)
    assert np.array_equal(got_pos, want_idx)
    assert np.array_equal(got_j, want_j)
    assert np.array_equal(got_first, want_first)
    hot = got_first == got_first[0]
    assert hot.sum() == rows and hot[:rows].all() and got_j[:rows].all()


def run_oracle(key, packed, pos):
    """K2 by runs, in numpy: a class is a run of equal adjacent keys."""
    start = np.ones(len(key), bool)
    start[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(start)
    valid = key != kernels.INVALID_CANON
    cls_or = np.bitwise_or.reduceat(np.where(valid, packed & 0x5EF, 0), starts)
    pop = np.array([bin(v).count("1") for v in range(16)])
    verdict = ((pop[cls_or & 0xF] > 1) | (pop[(cls_or >> 5) & 0xF] > 1)
               | ((cls_or >> 10) & 1 > 0))
    cls = np.cumsum(start) - 1
    return verdict[cls] & valid, pos[starts][cls]


@pytest.mark.parametrize("extra", [1, 2 * kernels.K2_TILE_ROWS + 5])
@pytest.mark.parametrize("kind", CLASS_RUN_KINDS)
def test_plain_matches_run_oracle_on_hand_laid_runs(kind, extra):
    n = kernels.K2_TILE_ROWS + extra
    key, packed, pos = class_runs(kind, n, kernels.K2_TILE_ROWS)
    got_j, got_first = kernels.class_analysis(
        (torch.from_numpy(key),), torch.from_numpy(packed), torch.from_numpy(pos))
    want_j, want_first = run_oracle(key, packed, pos)
    assert np.array_equal(got_j.numpy(), want_j)
    assert np.array_equal(got_first.numpy(), want_first)
    if kind in ("tile_edges", "tile_start"):
        assert want_j.any() and not want_j.all()
    if kind.startswith("one_run"):
        assert want_j.all() == (kind == "one_run") and (want_first == pos[0]).all()


@pytest.mark.parametrize("split", LIMB_SPLITS)
@pytest.mark.parametrize("kind", CLASS_RUN_KINDS)
def test_plain_matches_run_oracle_on_two_limb_runs(kind, split):
    """The hand-laid runs with their keys split over two limbs: run
    boundaries on the high limb only, on the low limb only, or on both."""
    n = 3 * kernels.K2_TILE_ROWS + 5
    key, packed, pos = class_runs(kind, n, kernels.K2_TILE_ROWS)
    hi, lo = split_limbs(key, split)
    got_j, got_first = kernels.class_analysis(
        (torch.from_numpy(hi), torch.from_numpy(lo)), torch.from_numpy(packed),
        torch.from_numpy(pos))
    want_j, want_first = run_oracle(key, packed, pos)
    assert np.array_equal(got_j.numpy(), want_j)
    assert np.array_equal(got_first.numpy(), want_first)


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
    pos = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.class_analysis((key,), packed, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        kernels.class_analysis((key,), packed, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.class_analysis((key.to("meta"),), packed.to("meta"),
                               torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):  # keys are a tuple of limbs
        kernels.class_analysis(key, packed, pos)
    with pytest.raises(ValueError):
        kernels.class_analysis((key, key, key), packed, pos)
    with pytest.raises(ValueError):
        kernels.class_analysis((key, key[:3]), packed, pos)
