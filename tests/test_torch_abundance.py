"""``da.neighborhoods`` of the port against the JAX reference.

Fixtures rebuilt from ``tests/test_abundance.py``: two blobs with
condition A dominating the first, and replicated designs (8 samples,
half in each condition) with and without a consistent effect.  Both
packages take the reference's kNN graph (``carry.graph_from_numpy``).
The neighbourhood counts are exact integers on both sides and must be
equal; the scores, FDRs and log fold changes are float64 host
arithmetic on equal counts, held within 1e-6 (rtol and atol) of the
reference's ``tpu`` and ``cpu`` backends.
"""

import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.ops import abundance as rda
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import graph_from_numpy
from sctools_tpu_torch.data.dataset import CellData
from sctools_tpu_torch.ops import abundance as pda

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)
KEYS = ("da_score", "da_fdr", "da_logfc")


def _pair(pos, obs, k):
    ref = RefCellData(np.zeros((len(pos), 1), np.float32),
                      obsm={"X_pca": pos}, obs=obs)
    ref = sct.apply("neighbors.knn", ref, backend="cpu", k=k,
                    metric="euclidean")
    port = graph_from_numpy(CellData(torch.zeros((len(pos), 1)), obs=obs),
                            np.asarray(ref.obsp["knn_indices"]),
                            np.asarray(ref.obsp["knn_distances"]))
    return ref, port


@pytest.fixture(scope="module")
def conditioned():
    rng = np.random.default_rng(0)
    n = 400
    pos = np.vstack([rng.normal(0, 1, (200, 6)),
                     rng.normal(8, 1, (200, 6))]).astype(np.float32)
    cond = np.empty(n, dtype=object)
    cond[:200] = rng.choice(["A", "B"], 200, p=[0.95, 0.05])
    cond[200:] = rng.choice(["A", "B"], 200, p=[0.42, 0.58])
    return _pair(pos, {"condition": cond.astype(str)}, 15)


def _replicated(f_blob1, seed=3, k=50, per=150):
    rng = np.random.default_rng(seed)
    S = len(f_blob1)
    pos, cond, samp = [], [], []
    for s in range(S):
        n1 = int(round(f_blob1[s] * per))
        pos.append(np.vstack([rng.normal(0, 1, (n1, 6)),
                              rng.normal(8, 1, (per - n1, 6))]))
        cond += ["A" if s < S // 2 else "B"] * per
        samp += [f"s{s}"] * per
    return _pair(np.vstack(pos).astype(np.float32),
                 {"condition": np.array(cond), "sample": np.array(samp)}, k)


F_NULL = [0.80, 0.70, 0.25, 0.25, 0.25, 0.30, 0.30, 0.40]
F_TRUE = [0.75, 0.72, 0.78, 0.70, 0.32, 0.28, 0.30, 0.35]


def _check(ref_out, port_out):
    for key in KEYS:
        want = np.asarray(ref_out.obs[key], np.float64)
        got = port_out.obs[key].numpy().astype(np.float64)
        assert port_out.obs[key].dtype == torch.float32
        np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
    for key in ("da_conditions", "da_method", "da_samples"):
        assert port_out.uns.get(key) == ref_out.uns.get(key)
    np.testing.assert_array_equal(port_out.uns["da_index_cells"],
                                  ref_out.uns["da_index_cells"])


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("kw", [dict(), dict(prop=0.25, seed=3),
                                dict(groups=["B", "A"])])
def test_binomial_mode_matches_reference(conditioned, backend, kw):
    ref, port = conditioned
    _check(sct.apply("da.neighborhoods", ref, backend=backend, **kw),
           sctt.apply("da.neighborhoods", port, device="cpu", **kw))


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("f,seed", [(F_NULL, 3), (F_TRUE, 4)])
def test_replicate_mode_matches_reference(backend, f, seed):
    ref, port = _replicated(f, seed=seed)
    r_in = ref.device_put() if backend == "tpu" else ref
    _check(sct.apply("da.neighborhoods", r_in, backend=backend,
                     sample_key="sample"),
           sctt.apply("da.neighborhoods", port, device="cpu",
                      sample_key="sample"))


def test_neighbourhood_counts_are_exact(conditioned):
    """The device counts (self first, one flag pass a sample) against
    the reference's host bincount."""
    ref, port = conditioned
    n = ref.n_cells
    idx = np.asarray(ref.obsp["knn_indices"])[:n]
    idx = np.concatenate([np.arange(n)[:, None].astype(idx.dtype), idx], 1)
    idx[::7, 3] = -1  # padding slots count nothing
    codes = np.random.default_rng(1).integers(0, 5, n)
    want = rda._nbhd_sample_counts(idx, codes, 5, device=False)
    got = pda._nbhd_sample_counts(torch.from_numpy(idx), codes, 5)
    np.testing.assert_array_equal(got, want)
    flags = codes == 2
    np.testing.assert_array_equal(
        pda.nbhd_counts(torch.from_numpy(idx),
                        torch.from_numpy(flags)).numpy(),
        rda._nbhd_counts(idx, flags, device=False))


def test_da_localises_enrichment(conditioned):
    _, port = conditioned
    out = sctt.apply("da.neighborhoods", port, device="cpu")
    z = out.obs["da_score"].numpy()
    assert z[:200].mean() > 1.5 and z[200:].mean() < -1.5
    assert 0.05 < (out.obs["da_fdr"].numpy() < 0.1).mean() < 0.95


def test_da_replicate_validates():
    _, port = _replicated([0.5, 0.5, 0.5, 0.5], per=80)
    bad = port.with_obs(sample=np.array(["s0"] * port.n_cells))
    with pytest.raises(ValueError, match="exactly one"):
        sctt.apply("da.neighborhoods", bad, device="cpu",
                   sample_key="sample")
    two = port.with_obs(sample=np.asarray(port.obs["condition"]).copy())
    with pytest.raises(ValueError, match=">=2 samples"):
        sctt.apply("da.neighborhoods", two, device="cpu",
                   sample_key="sample")
    with pytest.raises(KeyError, match="missing_key"):
        sctt.apply("da.neighborhoods", port, device="cpu",
                   sample_key="missing_key")


def test_da_validates(conditioned):
    _, port = conditioned
    with pytest.raises(KeyError, match="nope"):
        sctt.apply("da.neighborhoods", port, device="cpu",
                   condition_key="nope")
    three = port.with_obs(condition=np.array((["A", "B", "C"] * 134)[:400]))
    with pytest.raises(ValueError, match="exactly 2"):
        sctt.apply("da.neighborhoods", three, device="cpu")
    bare = CellData(torch.zeros((5, 1)),
                    obs={"condition": np.array(["A"] * 5)})
    with pytest.raises(KeyError, match="neighbors.knn"):
        sctt.apply("da.neighborhoods", bare, device="cpu")
    with pytest.raises(ValueError, match="prop"):
        sctt.apply("da.neighborhoods", port, device="cpu", prop=0.0)
