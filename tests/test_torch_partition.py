"""The port's vectorised partitioner against the JAX package's builder.

Both build the ELL interior, the compact boundary block, the send
selectors and the halo plan from the same scipy CSR matrix; the port's
arrays must equal the reference's byte for byte (dtype and values). The
main pytest process runs JAX in float32 (its ``jnp.asarray`` casts float64
data down), so the comparison builds in float32, which is exact for the
stencil values; ``tests/test_torch_solve.py`` compares float64 partitions
through a subprocess.
"""

import numpy as np
import pytest
import torch

from repro.core import partition as jp
from repro.matrices.poisson import cube, poisson_scipy
from repro_torch.core import partition as tp

_MATS = {}


def _matrix(stencil, side):
    key = (stencil, side)
    if key not in _MATS:
        _MATS[key] = poisson_scipy(cube(side, stencil))
    return _MATS[key]


def _leaves(m):
    return {
        "data": m.interior.data, "col": m.interior.col,
        "data_ext": m.data_ext, "col_ext": m.col_ext,
        "bnd_rows": m.bnd_rows, "send_sel": m.send_sel,
    }


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _plan(p):
    return (p.mode, p.shifts, p.widths, p.n_own_pad, p.n_shards)


@pytest.mark.parametrize("allgather", [False, True], ids=["ring", "allgather"])
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_partition_matches_reference_bytes(stencil, S, allgather):
    a = _matrix(stencil, 12)
    ref = jp.partition_csr(a, S, dtype=np.float32, force_allgather=allgather)
    got = tp.partition_csr(a, S, dtype=np.float32, force_allgather=allgather)
    for name, r in _leaves(ref).items():
        g = _np(_leaves(got)[name])
        r = np.asarray(r)
        assert g.dtype == r.dtype, name
        assert g.shape == r.shape, name
        assert np.array_equal(g, r), name
    assert _plan(got.plan) == _plan(ref.plan)
    assert got.n_bnd == ref.n_bnd
    assert got.row_starts == ref.row_starts
    assert got.n_global == ref.n_global
    assert got.stored_bytes() == ref.stored_bytes()
    assert got.interior_stored_bytes() == ref.interior_stored_bytes()
    assert got.nnz_stored == ref.nnz_stored


@pytest.mark.parametrize("S", [3, 5])
def test_uneven_shards_and_custom_partition(S):
    """Row counts that do not divide evenly, an explicit (uneven) row
    partition with an empty shard, and a wider ring reach."""
    a = _matrix("7pt", 10)
    ref = jp.partition_csr(a, S, dtype=np.float32)
    got = tp.partition_csr(a, S, dtype=np.float32)
    for name, r in _leaves(ref).items():
        assert np.array_equal(_np(_leaves(got)[name]), np.asarray(r)), name
    starts = (0, 0, 130, 700, 1000)
    part_r = jp.RowPartition(1000, starts)
    part_t = tp.RowPartition(1000, starts)
    ref = jp.partition_csr(a, 4, dtype=np.float32, partition=part_r, max_ring=1)
    got = tp.partition_csr(a, 4, dtype=np.float32, partition=part_t, max_ring=1)
    assert _plan(got.plan) == _plan(ref.plan)
    for name, r in _leaves(ref).items():
        assert np.array_equal(_np(_leaves(got)[name]), np.asarray(r)), name


def test_pad_unpad_and_distmat_from_numpy():
    a = _matrix("7pt", 12)
    ref = jp.partition_csr(a, 4, dtype=np.float32)
    got = tp.partition_csr(a, 4, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(a.shape[0])
    np.testing.assert_array_equal(tp.pad_vector(x, got), jp.pad_vector(x, ref))
    xp = jp.pad_vector(x, ref)
    np.testing.assert_array_equal(tp.unpad_vector(torch.from_numpy(xp), got), x)
    carried = tp.distmat_from_numpy(
        **{k: np.asarray(v) for k, v in _leaves(ref).items()},
        mode=ref.plan.mode, shifts=ref.plan.shifts, widths=ref.plan.widths,
        n_own_pad=ref.plan.n_own_pad, n_shards=ref.plan.n_shards,
        n_global=ref.n_global, row_starts=ref.row_starts, n_bnd=ref.n_bnd,
    )
    for name, g in _leaves(got).items():
        assert torch.equal(_leaves(carried)[name], g), name
    assert _plan(carried.plan) == _plan(got.plan)


def test_unported_layouts_raise():
    a = _matrix("7pt", 12)
    # the 2-D process grid is ported: a 2 x 2 grid plans per-dimension
    # (di, dj) halos, equal to the reference's plan
    mat = tp.partition_csr(a, 4, grid=(2, 2), dtype=np.float32)
    ref = jp.partition_csr(a, 4, grid=(2, 2), dtype=np.float32)
    assert mat.plan.mode == "grid" and mat.plan.grid == (2, 2)
    assert (mat.plan.shifts, mat.plan.widths) == (ref.plan.shifts, ref.plan.widths)
    with pytest.raises(ValueError, match="does not cover"):
        tp.partition_csr(a, 4, grid=(2, 3))
    # the interior formats are ported: HYB partitions like the others
    assert tp.partition_csr(a, 4, fmt="hyb").fmt == "hyb"
    # deep halos are ported: halo_depth=2 builds two-deep ghost zones
    deep = tp.partition_csr(a, 4, halo_depth=2)
    assert deep.halo_depth == 2 and deep.n_ghost_rows > 0
