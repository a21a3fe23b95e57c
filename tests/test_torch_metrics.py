"""``metrics.morans_i`` and ``metrics.gearys_c`` of the port against the
JAX reference on the same inputs and the same graph.

Both packages start from the reference's ``synthetic_counts(600, 800,
n_clusters=4)`` after its library-size (kept as layer ``scaled``),
log1p, 20-PC PCA, 15-NN and ``graph.connectivities`` steps: the port
gets its X and layer planes
(``carry.cells_from_numpy``), kNN arrays (``carry.graph_from_numpy``),
connectivities and PCA as they are.  The reference runs
``backend="tpu"`` on the CPU and its float64 oracle ``backend="cpu"``.
Tolerances: rtol 1e-5 against the ``tpu`` path (float32 sums over the
cells in another order), rtol 1e-4 against the oracle, each with atol
1e-6 (values of order 1; Geary's numerator is a difference of sums of
that size).  The reference's two-blob fixture
(``tests/test_metrics.py``) holds the separation gates and its dense
oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import cells_from_numpy, graph_from_numpy
from sctools_tpu_torch.data.dataset import CellData
from sctools_tpu_torch.ops import metrics as pmetrics

torch.set_num_threads(2)

N_CELLS, N_GENES, K = 600, 800, 15
REF_TOL = dict(rtol=1e-5, atol=1e-6)
ORACLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPS = (("metrics.morans_i", "morans_i"), ("metrics.gearys_c", "gearys_c"))


def _port_graph(port, ref):
    port = graph_from_numpy(port, np.asarray(ref.obsp["knn_indices"]),
                            np.asarray(ref.obsp["knn_distances"]), knn_k=K)
    return port.with_obsp(connectivities=torch.from_numpy(
        np.array(ref.obsp["connectivities"], np.float32)))


@pytest.fixture(scope="module")
def both():
    host = ref_counts(N_CELLS, N_GENES, density=0.05, n_clusters=4, seed=3)
    ref = sct.Pipeline([
        ("normalize.library_size", {}),
        ("util.snapshot_layer", {"layer": "scaled"}),
        ("normalize.log1p", {}),
        ("pca.randomized", {"n_components": 20}),
        ("neighbors.knn", {"k": K, "metric": "cosine"}),
        ("graph.connectivities", {})]).run(host.device_put(),
                                           backend="tpu")
    port = cells_from_numpy(np.asarray(ref.X.indices),
                            np.asarray(ref.X.data), ref.n_cells,
                            ref.n_genes, var=host.var)
    lay = ref.layers["scaled"]
    port = port.with_layers(scaled=cells_from_numpy(
        np.asarray(lay.indices), np.asarray(lay.data), ref.n_cells,
        ref.n_genes).X).with_obsm(X_pca=torch.from_numpy(
            np.array(ref.obsm["X_pca"])[:N_CELLS]))
    return ref, _port_graph(port, ref)


@pytest.fixture(scope="module")
def dense(both):
    ref, port = both
    Xd = np.asarray(ref.X.to_dense())
    return (ref.replace(X=jnp.asarray(Xd)),
            port.replace(X=torch.from_numpy(Xd.copy())))


@pytest.fixture(params=["sparse", "dense"])
def pair(request, both, dense):
    return both if request.param == "sparse" else dense


def _port(op, data, **kw):
    return sctt.apply(op, data, device="cpu", **kw)


@pytest.mark.parametrize("op,key", OPS)
def test_matches_the_reference(pair, op, key):
    ref, port = pair
    got = np.asarray(_port(op, port).var[key])
    assert got.dtype == np.float32 and got.shape == (N_GENES,)
    want = np.asarray(sct.apply(op, ref, backend="tpu").var[key])
    np.testing.assert_allclose(got, want, **REF_TOL)
    oracle = np.asarray(sct.apply(op, ref.to_host(), backend="cpu").var[key])
    np.testing.assert_allclose(got, oracle, **ORACLE_TOL)


@pytest.mark.parametrize("op,key", OPS)
@pytest.mark.parametrize("rep", ["scaled", "X_pca"])
def test_on_a_layer_and_an_obsm_basis(both, op, key, rep):
    ref, port = both
    got = _port(op, port, use_rep=rep)
    want = sct.apply(op, ref, backend="tpu", use_rep=rep)
    if rep == "scaled":
        a, b = got.var[key], want.var[key]
    else:
        a, b = got.uns[f"{key}_{rep}"], want.uns[f"{key}_{rep}"]
        assert np.asarray(a).dtype == np.float64 and a.shape == (20,)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **REF_TOL)


@pytest.mark.parametrize("op,key", OPS)
def test_unit_weights_without_connectivities(both, op, key):
    ref, port = both
    ref = ref.replace(obsp={k: v for k, v in ref.obsp.items()
                            if k != "connectivities"})
    port = port.replace(obsp={k: v for k, v in port.obsp.items()
                              if k != "connectivities"})
    np.testing.assert_allclose(
        np.asarray(_port(op, port).var[key]),
        np.asarray(sct.apply(op, ref, backend="tpu").var[key]), **REF_TOL)


def test_two_products_a_block_of_256_genes(both, monkeypatch):
    """Each 256-gene block costs two graph products (the graph_matvec
    kernel on the card): ceil(800 / 256) = 4 blocks, 8 products, the
    last block 32 genes wide."""
    widths = []
    real = pmetrics.knn_matvec

    def counted(idx, w, x):
        widths.append(x.shape[1])
        return real(idx, w, x)

    monkeypatch.setattr(pmetrics, "knn_matvec", counted)
    _port("metrics.morans_i", both[1])
    assert widths == [256, 256, 256, 256, 256, 256, 32, 32]


@pytest.fixture(scope="module")
def blobs():
    """tests/test_metrics.py's fixture: two blobs; gene 0 separates them,
    gene 1 is noise, gene 2 follows the first coordinate."""
    rng = np.random.default_rng(0)
    n = 300
    pos = np.vstack([rng.normal(0, 1, (150, 5)),
                     rng.normal(6, 1, (150, 5))]).astype(np.float32)
    X = np.zeros((n, 3), np.float32)
    X[:, 0] = np.concatenate([np.zeros(150), np.ones(150)]) \
        + rng.normal(0, 0.1, n)
    X[:, 1] = rng.normal(0, 1, n)
    X[:, 2] = pos[:, 0] * 0.5 + rng.normal(0, 0.2, n)
    ref = RefCellData(X, obsm={"X_pca": pos})
    ref = sct.apply("neighbors.knn", ref, backend="cpu", k=10,
                    metric="euclidean")
    ref = sct.apply("graph.connectivities", ref, backend="cpu")
    port = _port_graph(CellData(torch.from_numpy(X),
                                obsm={"X_pca": torch.from_numpy(pos)}), ref)
    return ref, port


def test_blobs_separate_signal_from_noise(blobs):
    ref, port = blobs
    out = _port("metrics.gearys_c", _port("metrics.morans_i", port))
    I, C = np.asarray(out.var["morans_i"]), np.asarray(out.var["gearys_c"])
    assert I[0] > 0.8 and abs(I[1]) < 0.15
    assert C[0] < 0.3 and 0.7 < C[1] < 1.3
    for op, key in OPS:
        want = sct.apply(op, ref, backend="cpu").var[key]
        np.testing.assert_allclose(np.asarray(out.var[key]),
                                   np.asarray(want), **ORACLE_TOL)
    pos = _port("metrics.morans_i", port, use_rep="X_pca")
    assert pos.uns["morans_i_X_pca"][0] > 0.9


def test_errors(both):
    port = both[1]
    with pytest.raises(KeyError, match="neighbors.knn"):
        _port("metrics.morans_i", port.replace(obsp={}))
    with pytest.raises(KeyError, match="no layer/obsm"):
        _port("metrics.gearys_c", port, use_rep="nope")
