"""qc / normalize / hvg of the port against the JAX reference on the
same ELL planes.

Tolerances: integer QC columns exact; float columns and the normalised
values rtol 1e-6, atol 1e-6 (float32 reduction order, and the two
libraries' log1p differing by an ulp); the HVG set identical and its
means/variances within rtol 1e-5 (two-pass moments over a different
summation order)."""

import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu_torch import Pipeline
from sctools_tpu_torch.carry import cells_from_numpy
from sctools_tpu_torch.registry import apply

torch.set_num_threads(2)

N_CELLS, N_GENES, N_TOP = 600, 800, 200


@pytest.fixture(scope="module")
def both():
    host = ref_counts(N_CELLS, N_GENES, density=0.05, n_clusters=3, seed=2)
    ref = host.device_put()
    port = cells_from_numpy(np.asarray(ref.X.indices),
                            np.asarray(ref.X.data), ref.n_cells,
                            ref.n_genes, obs=host.obs, var=host.var)
    return ref, port


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("percent_top", [(), (5, 50)])
def test_per_cell_metrics(both, percent_top):
    ref, port = both
    r = sct.apply("qc.per_cell_metrics", ref, backend="tpu",
                  percent_top=percent_top)
    p = apply("qc.per_cell_metrics", port, device="cpu",
              percent_top=percent_top)
    assert p.obs["n_genes"].dtype == torch.int32
    np.testing.assert_array_equal(_np(p.obs["n_genes"]),
                                  _np(r.obs["n_genes"]))
    keys = ["total_counts", "pct_counts_mt"] + [
        f"pct_counts_in_top_{n}_genes" for n in percent_top]
    for key in keys:
        np.testing.assert_allclose(_np(p.obs[key]), _np(r.obs[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("kw", [
    dict(target_sum=1e4), dict(target_sum=None),
    dict(target_sum=1e4, exclude_highly_expressed=True, max_fraction=0.1)])
def test_library_size_and_log1p(both, kw):
    ref, port = both
    r = sct.Pipeline([("normalize.library_size", kw),
                      ("normalize.log1p", {})]).run(ref, backend="tpu")
    p = Pipeline([("normalize.library_size", kw),
                  ("normalize.log1p", {})]).run(port, device="cpu")
    np.testing.assert_array_equal(_np(p.X.indices), _np(r.X.indices))
    np.testing.assert_allclose(_np(p.X.data), _np(r.X.data),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(p.obs["library_size"]),
                               _np(r.obs["library_size"]),
                               rtol=1e-6, atol=1e-6)
    if kw.get("exclude_highly_expressed"):
        he = _np(r.var["highly_expressed"])
        assert he.any()
        np.testing.assert_array_equal(_np(p.var["highly_expressed"]), he)


@pytest.mark.parametrize("normalized", [False, True])
def test_hvg_seurat_v3(both, normalized):
    ref, port = both
    pre = [("normalize.library_size", {"target_sum": 1e4}),
           ("normalize.log1p", {})] if normalized else []
    step = ("hvg.select", {"n_top": N_TOP, "subset": False})
    r = sct.Pipeline(pre + [step]).run(ref, backend="tpu")
    p = Pipeline(pre + [step]).run(port, device="cpu")
    np.testing.assert_array_equal(_np(p.var["highly_variable"]),
                                  _np(r.var["highly_variable"]))
    assert _np(p.var["highly_variable"]).sum() == N_TOP
    for key in ("means", "variances"):
        np.testing.assert_allclose(_np(p.var[key]), _np(r.var[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(_np(p.var["hvg_score"]),
                               _np(r.var["hvg_score"]), rtol=1e-4,
                               atol=1e-6)


def test_hvg_subset_compacts_like_the_reference(both):
    ref, port = both
    step = [("hvg.select", {"n_top": N_TOP, "subset": True})]
    r = sct.Pipeline(step).run(ref, backend="tpu")
    p = Pipeline(step).run(port, device="cpu")
    assert p.n_genes == r.n_genes == N_TOP
    assert p.X.capacity == r.X.capacity
    np.testing.assert_array_equal(_np(p.X.indices), _np(r.X.indices))
    np.testing.assert_array_equal(_np(p.X.data), _np(r.X.data))
    np.testing.assert_array_equal(p.var["gene_name"],
                                  np.asarray(r.var["gene_name"]))
    assert (p.to_host().X != r.to_host().X).nnz == 0


def test_hvg_unported_options_raise(both):
    _, port = both
    with pytest.raises(NotImplementedError):
        apply("hvg.select", port, device="cpu", flavor="cell_ranger")
    with pytest.raises(NotImplementedError):
        apply("hvg.select", port, device="cpu", batch_key="b")
