"""The port's padded-ELL SparseCells against the reference's, on the same
ELL planes.

Tolerance: rtol 1e-6, atol 1e-6 — float32 reduction order.  The counts
are integers, and ``spmm``/``spmm_t`` are fed multiples of 1/8, so
those sums are exact in any order; the moments divide by n and differ
only in the last bits."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sctools_tpu.data import sparse as ref_sparse
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu_torch.carry import cells_from_numpy
from sctools_tpu_torch.data import sparse as port_sparse
from sctools_tpu_torch.data.synthetic import synthetic_counts

torch.set_num_threads(2)

RTOL = ATOL = 1e-6


@pytest.fixture(scope="module")
def pair():
    """(reference SparseCells, port SparseCells) over one CSR matrix;
    the port's is built from the reference's ELL planes."""
    ds = ref_counts(600, 800, density=0.05, n_clusters=3, seed=1)
    ref = ref_sparse.SparseCells.from_scipy_csr(ds.X)
    port = cells_from_numpy(np.asarray(ref.indices), np.asarray(ref.data),
                            ref.n_cells, ref.n_genes).X
    return ref, port


def test_synthetic_counts_identical_to_reference():
    a = ref_counts(300, 200, density=0.1, n_clusters=4, seed=7)
    b = synthetic_counts(300, 200, density=0.1, n_clusters=4, seed=7)
    assert (a.X != b.X).nnz == 0
    assert a.X.dtype == b.X.dtype
    for key in ("gene_name", "mito"):
        np.testing.assert_array_equal(a.var[key], b.var[key])
    np.testing.assert_array_equal(a.obs["cluster_true"],
                                  b.obs["cluster_true"])


@pytest.mark.parametrize("n_cells,n_genes,density", [
    (600, 800, 0.05), (37, 1000, 0.3), (1, 5, 0.5)])
def test_scipy_round_trip_exact_and_same_planes(n_cells, n_genes, density):
    X = synthetic_counts(n_cells, n_genes, density=density, seed=3).X
    port = port_sparse.SparseCells.from_scipy_csr(X)
    back = port.to_scipy_csr()
    assert back.shape == X.shape
    assert (back != X).nnz == 0
    np.testing.assert_array_equal(back.indptr, X.indptr)
    ref = ref_sparse.SparseCells.from_scipy_csr(X)
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    assert port.capacity % 128 == 0 and port.rows_padded % 8 == 0


def test_to_dense_matches_scipy(pair):
    _, port = pair
    np.testing.assert_array_equal(port.to_dense().numpy(),
                                  port.to_scipy_csr().toarray())


def test_row_sum(pair):
    ref, port = pair
    np.testing.assert_allclose(port_sparse.row_sum(port).numpy(),
                               np.asarray(ref_sparse.row_sum(ref)),
                               rtol=RTOL, atol=ATOL)


def test_gene_stats(pair):
    ref, port = pair
    for a, b in zip(port_sparse.gene_stats(port),
                    ref_sparse.gene_stats(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)


def test_gene_moments(pair):
    ref, port = pair
    for a, b in zip(port_sparse.gene_moments(port),
                    ref_sparse.gene_moments(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)


def _dyadic(rng, shape):
    return (rng.integers(-32, 33, size=shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("block", [2048, 128])
def test_spmm(pair, block):
    ref, port = pair
    v = _dyadic(np.random.default_rng(0), (ref.n_genes, 12))
    got = port_sparse.spmm(port, torch.from_numpy(v), block=block)
    want = ref_sparse.spmm(ref, v, block=block)
    assert got.shape == (ref.rows_padded, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block", [2048, 128])
def test_spmm_t(pair, block):
    ref, port = pair
    w = _dyadic(np.random.default_rng(1), (ref.rows_padded, 9))
    w[ref.n_cells:] = 0.0
    got = port_sparse.spmm_t(port, torch.from_numpy(w), block=block)
    want = ref_sparse.spmm_t(ref, w, block=block)
    assert got.shape == (ref.n_genes, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_spmm_t_row_chunks_without_stored_slots():
    """``spmm_t`` leaves sentinel slots out before its scatter; a row
    chunk with no stored slot at all (empty cells, padding rows) adds
    nothing.  Against the dense float64 product; dyadic values, so
    exact."""
    X = synthetic_counts(300, 90, density=0.2, seed=5).X.tolil()
    X[128:256] = 0
    x = port_sparse.SparseCells.from_scipy_csr(X.tocsr())
    w = _dyadic(np.random.default_rng(2), (x.rows_padded, 5))
    w[x.n_cells:] = 0.0
    got = port_sparse.spmm_t(x, torch.from_numpy(w), block=128)
    want = X.toarray().astype(np.float64).T @ w[: x.n_cells]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cells_from_numpy_rejects_bad_planes(pair):
    ref, _ = pair
    ind = np.asarray(ref.indices).copy()
    dat = np.asarray(ref.data).copy()
    dat[ind == ref.n_genes] = 1.0
    with pytest.raises(ValueError, match="padding"):
        cells_from_numpy(ind, dat, ref.n_cells, ref.n_genes)
    with pytest.raises(ValueError, match="capacity"):
        cells_from_numpy(ind[:, :100], np.asarray(ref.data)[:, :100],
                         ref.n_cells, ref.n_genes)
    with pytest.raises(TypeError):
        port_sparse.SparseCells.from_scipy_csr(np.zeros((3, 3)))
    with pytest.raises(ValueError, match="capacity"):
        port_sparse.SparseCells.from_scipy_csr(
            sp.csr_matrix(np.ones((2, 200), np.float32)), capacity=128)


@pytest.mark.parametrize("seg_rows", [None, 32, 8, 5])
@pytest.mark.parametrize("block", [7, 64, 2048])
def test_segment_reduce_is_fixed_order(pair, block, seg_rows, monkeypatch):
    """The gene sums add in one order on every device (per gene within
    blocks of ``seg_rows`` rows by a stable sort, then over the blocks;
    no atomics; None: the CPU's one block a chunk, the card's 32 rows
    forced here through ``_gene_segment_sum``): within float32
    reordering of the float64 sums and of the reference's, the same
    bits in a second call, and padding rows and sentinel slots add
    nothing."""
    ref, port = pair
    fixed = port_sparse._gene_segment_sum
    monkeypatch.setattr(port_sparse, "_gene_segment_sum",
                        lambda ind, vals, n: fixed(ind, vals, n, seg_rows))

    def sums(x):
        return port_sparse.segment_reduce(
            x, lambda ind, dat, r0: torch.stack([dat, dat * dat], dim=2), 2,
            block=block)

    got = sums(port)
    ind = port.indices.numpy().reshape(-1)
    dat = port.data.numpy().astype(np.float64).reshape(-1)
    want = np.zeros((port.n_genes + 1, 2))
    np.add.at(want, ind, np.stack([dat, dat * dat], axis=1))
    np.testing.assert_allclose(got.numpy(), want[:-1], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[:, 0].numpy(),
                               np.asarray(ref_sparse.gene_stats(ref)[0]),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(sums(port), got)
    assert torch.equal(sums(port.pad_rows_to(port.rows_padded + 40)), got)
