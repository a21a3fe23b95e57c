"""``score.genes`` and ``score.cell_cycle`` of the port against the JAX
reference on the same inputs.

Both packages start from the reference's ``synthetic_counts(600, 800,
n_clusters=4)`` after its own library-size and log1p steps (the
padded-ELL planes carried by ``carry.cells_from_numpy``), and a dense
copy of that X; the reference runs ``backend="tpu"`` on the CPU and its
scipy oracle ``backend="cpu"``.  Tolerances:

* per-gene means: equal to the reference's (the same slots summed in
  the same order on the CPU; numpy's mean of a dense X);
* control genes: identical (numpy's ``default_rng`` on the same means);
* scores: rtol 1e-6, atol 5e-7 (a score is the difference of two
  float32 means of order 1, each a product of the cell's slots with a
  (n_genes, 2) table summed in another order: an ulp of either is
  1.2e-7); against the float64 scipy oracle atol 1e-6;
* phases: equal where S and G2M differ from 0 and from each other by
  more than that atol.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops import score as rscore
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import cells_from_numpy
from sctools_tpu_torch.ops import score as pscore

torch.set_num_threads(2)

N_CELLS, N_GENES = 600, 800
TOL = dict(rtol=1e-6, atol=5e-7)
ORACLE_ATOL = 1e-6
SETS = [np.arange(5), np.arange(100, 160, 3), np.array([7, 790, 400, 401])]


@pytest.fixture(scope="module")
def both():
    host = ref_counts(N_CELLS, N_GENES, density=0.05, n_clusters=4, seed=3)
    ref = sct.Pipeline([("normalize.library_size", {}),
                        ("normalize.log1p", {})]).run(host.device_put(),
                                                      backend="tpu")
    port = cells_from_numpy(np.asarray(ref.X.indices),
                            np.asarray(ref.X.data), ref.n_cells,
                            ref.n_genes, var=host.var)
    return ref, port


@pytest.fixture(scope="module")
def dense(both):
    ref, port = both
    Xd = np.asarray(ref.X.to_dense())
    return (ref.replace(X=jnp.asarray(Xd)),
            port.replace(X=torch.from_numpy(Xd.copy())))


@pytest.fixture(params=["sparse", "dense"])
def pair(request, both, dense):
    return both if request.param == "sparse" else dense


def _trim(v, n=N_CELLS):
    v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return v[:n]


def test_gene_means_and_controls_match_the_reference(pair):
    ref, port = pair
    got = pscore._gene_means_host(port.X)
    want = rscore._gene_means_host(ref)
    np.testing.assert_array_equal(got, np.asarray(want, got.dtype))
    for seed, genes in enumerate(SETS):
        for ctrl_size, n_bins in ((50, 25), (10, 5), (200, 40)):
            a = pscore._control_indices(got, genes, ctrl_size, n_bins, seed)
            b = rscore._control_indices(want, genes, ctrl_size, n_bins, seed)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("genes", range(len(SETS)))
def test_score_genes_matches_the_reference(pair, genes):
    ref, port = pair
    kw = dict(genes=SETS[genes], score_name="s", seed=genes, ctrl_size=30)
    got = _trim(sctt.apply("score.genes", port, device="cpu",
                           **kw).obs["s"])
    want = _trim(sct.apply("score.genes", ref, backend="tpu", **kw).obs["s"])
    np.testing.assert_allclose(got, want, **TOL)
    oracle = sct.apply("score.genes", ref.to_host(), backend="cpu", **kw)
    np.testing.assert_allclose(got, _trim(oracle.obs["s"]), rtol=0,
                               atol=ORACLE_ATOL)


def test_score_genes_by_name_and_the_missing_gene_warning(both):
    ref, port = both
    names = list(np.asarray(port.var["gene_name"])[[3, 9, 27]])
    with pytest.warns(UserWarning, match="1/4 genes not in"):
        got = sctt.apply("score.genes", port, device="cpu",
                         genes=names + ["NOT_A_GENE"])
    by_id = sctt.apply("score.genes", port, device="cpu",
                       genes=np.array([3, 9, 27]))
    assert torch.equal(got.obs["score"], by_id.obs["score"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = sct.apply("score.genes", ref, backend="tpu",
                         genes=names + ["NOT_A_GENE"])
    np.testing.assert_allclose(_trim(got.obs["score"]),
                               _trim(want.obs["score"]), **TOL)
    assert got.obs["score"].shape[0] == port.X.rows_padded


def test_cell_cycle_matches_the_reference(pair):
    ref, port = pair
    kw = dict(s_genes=np.arange(0, 40), g2m_genes=np.arange(300, 340),
              seed=4)
    got = sctt.apply("score.cell_cycle", port, device="cpu", **kw)
    want = sct.apply("score.cell_cycle", ref, backend="tpu", **kw)
    for key in ("S_score", "G2M_score"):
        np.testing.assert_allclose(_trim(got.obs[key]),
                                   _trim(want.obs[key]), **TOL)
    s, g = _trim(got.obs["S_score"]), _trim(got.obs["G2M_score"])
    clear = ((np.abs(s) > ORACLE_ATOL) & (np.abs(g) > ORACLE_ATOL)
             & (np.abs(s - g) > ORACLE_ATOL))
    phase, ref_phase = _trim(got.obs["phase"]), _trim(want.obs["phase"])
    np.testing.assert_array_equal(phase[clear], ref_phase[clear])
    assert set(np.unique(phase)) == {"G1", "S", "G2M"}
    full = np.asarray(got.obs["phase"])
    assert len(full) == len(np.asarray(want.obs["phase"]))
    assert (full[N_CELLS:] == "").all()


def test_errors(both):
    port = both[1]
    with pytest.raises(ValueError, match="needs a gene list"):
        sctt.apply("score.genes", port, device="cpu")
    with pytest.raises(ValueError, match="none of the given genes"):
        sctt.apply("score.genes", port, device="cpu", genes=["nope"])
    with pytest.raises(KeyError, match="gene_name"):
        sctt.apply("score.genes", port.replace(var={}), device="cpu",
                   genes=["GENE3"])
    with pytest.raises(ValueError, match="s_genes and g2m_genes"):
        sctt.apply("score.cell_cycle", port, device="cpu",
                   s_genes=np.arange(3))
    with pytest.raises(ValueError, match="control pool is empty"):
        pscore._control_indices(np.arange(4.0), np.arange(4), 5, 2, 0)
