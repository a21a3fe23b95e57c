"""``integrate.combat`` and ``integrate.harmony`` of the port against the
JAX reference on the same inputs, and the multi-sample slice as a whole
(``concat`` → the main path → harmony → mnn → ingest).

The reference runs ``backend="tpu"`` on the CPU and, for ComBat, its
float64 oracle ``backend="cpu"``.  Tolerances, and why:

* ComBat: within rtol 1e-5 of the reference's ``combat_arrays``, with
  an atol of 1e-5 × max|X| for entries near zero (the pooled variance
  is a float32 sum over the cells, which XLA adds in another order:
  the two standard deviations differ in the last bits, 2e-6 of the
  scale at most here); within ``test_combat_backend_parity``'s 2e-3 of
  the float64 oracle.
* Harmony from the reference's own start (its ``jax.random`` k-means
  draw patched in for the port's seeded ``kmeans_init``): the ridge
  systems are near-singular by design (the intercept column is the sum
  of the batch columns; only the ridge on the batch coefficients makes
  them invertible), so a float32 solve loses ~2 digits, and both
  packages already sit ~1e-5 of the scale from a float64 evaluation of
  the same steps after one round.  Held: after ``n_rounds=1,
  n_cluster_iter=1`` the port within 1e-4 of the scale of the
  reference, and no farther from the float64 evaluation than twice the
  reference's own distance or 2e-5 of the scale, and within 2e-6 of
  the scale of it (the reference solves in float32 from separately
  summed rows and lands 3.5e-6 to 3.3e-5 from it; the port builds the
  intercept row from the batch rows and solves in float64, 3e-7); at
  the reference
  test's settings (8 clusters, 5 rounds) within 1e-4 of the scale,
  with the reference's mixing and ARI gates
  (``tests/test_integrate.py:39-59``).  With the port's own seeded
  start the gates alone (other centroids, the same quality).
* The slice (three runs of one process, each with a per-gene factor
  exp(N(0, 1)) on its counts): concat equal; the HVG set equal; PCA
  (the reference's sketch carried in, each component's free sign
  matched) within 1e-4 of the scale; harmony within 1e-3 of the scale
  (the PCA's float32 differences pass through the near-singular solves
  ten times) and raising the batch mixing by > 0.05; MNN with the
  reference's merge order and a batch mixing within 0.02 of the
  reference's (X_mnn is compared element by element in
  ``test_torch_mnn.py``: here most cells are anchors, and the
  reference's bandwidth is then a float32 self-distance's rounding
  noise); ingest's labels equal on ≥ 0.99 of the query (a near-tie of
  a vote may flip) and as accurate as the reference's.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.data.synthetic import gaussian_blobs
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops import integrate as ref_integrate
from sctools_tpu.ops.cluster import adjusted_rand_index, kmeans_cpu
from sctools_tpu.ops.pca import _sketch_omega
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import cells_from_numpy, pca_omega_from_numpy
from sctools_tpu_torch.ops import integrate as port_integrate

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_integrate import _batched_data, _local_batch_mix  # noqa: E402
from test_torch_cluster import _ref_init_draw  # noqa: E402

torch.set_num_threads(2)

COMBAT_RTOL = 1e-5
ORACLE_TOL = 2e-3
HARMONY_TOL = 1e-4  # of the scale, max |ref|
SLICE_TOL = 1e-3  # of the scale, after the PCA


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _ref_start(points, n_clusters, seed=0):
    """The reference's k-means++-lite draw for ``PRNGKey(seed)``, in
    place of the port's seeded ``kmeans_init``."""
    return torch.from_numpy(np.array(_ref_init_draw(
        jnp.asarray(_np(points)), jax.random.PRNGKey(seed), n_clusters)))


@pytest.fixture
def ref_draws(monkeypatch):
    monkeypatch.setattr(port_integrate, "kmeans_init", _ref_start)


def _scaled_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} × {scale}"
    return err / scale


# ---------------------------------------------------------------- combat


def _combat_pair(seed, sparse):
    """The reference test's batched data (dense), or log-normalised
    counts in 3 batches (padded ELL, the same planes in both
    packages)."""
    if not sparse:
        d = _batched_data(seed=seed)
        return d, sctt.CellData(torch.from_numpy(np.asarray(d.X).copy()),
                                obs=dict(d.obs))
    host = ref_counts(300, 60, density=0.3, n_clusters=3, seed=seed)
    batch = np.array([f"b{i % 3}" for i in range(300)])
    X = host.X.tocsr().astype(np.float32)
    X.data = np.log1p(X.data * (1.0 + (np.arange(300) % 3)[
        np.repeat(np.arange(300), np.diff(X.indptr))]))
    ref = RefCellData(X, obs={"batch": batch}).device_put()
    port = cells_from_numpy(np.asarray(ref.X.indices), np.asarray(ref.X.data),
                            300, 60, obs={"batch": batch})
    return ref, port


@pytest.mark.parametrize("seed,sparse", [(11, False), (12, False),
                                         (5, True)])
def test_combat_matches_the_reference(seed, sparse):
    ref, port = _combat_pair(seed, sparse)
    t = sct.apply("integrate.combat", ref, backend="tpu")
    p = sctt.apply("integrate.combat", port, device="cpu")
    got, want = _np(p.X), np.asarray(t.X)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=COMBAT_RTOL,
                               atol=COMBAT_RTOL * np.abs(want).max())
    assert list(p.uns["combat_batches"]) == list(t.uns["combat_batches"])
    c = sct.apply("integrate.combat", ref.to_host() if sparse else ref,
                  backend="cpu")
    np.testing.assert_allclose(got, np.asarray(c.X), rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)


def test_combat_arrays_match_the_reference_s():
    d = _batched_data(seed=13)
    X = np.asarray(d.X)
    onehot, _, codes = ref_integrate._batch_onehot(d.obs["batch"])
    for n_iter in (1, 7, 100):
        want = np.asarray(ref_integrate.combat_arrays(
            jnp.asarray(X), jnp.asarray(codes), jnp.asarray(onehot.sum(0)),
            n_iter=n_iter))
        got = port_integrate.combat_arrays(
            torch.from_numpy(X), torch.from_numpy(codes),
            torch.from_numpy(onehot.sum(0)), n_iter=n_iter)
        np.testing.assert_allclose(_np(got), want, rtol=COMBAT_RTOL,
                                   atol=COMBAT_RTOL * np.abs(want).max())


def test_combat_per_batch_sums_are_the_reference_s_bits():
    """The per-batch sums add each batch's rows in index order, as the
    reference's ``segment_sum`` does on the CPU: the batch means equal
    the reference's bit for bit."""
    from sctools_tpu_torch.ops.cluster import _segment_sum, segment_order

    d = _batched_data(seed=14)
    X = np.asarray(d.X)
    _, _, codes = ref_integrate._batch_onehot(d.obs["batch"])
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(X),
                                          jnp.asarray(codes),
                                          num_segments=3))
    c = torch.from_numpy(codes).long()
    got = _segment_sum(torch.from_numpy(X), None, 3,
                       order=segment_order(c, 3))
    np.testing.assert_array_equal(_np(got), want)


def test_combat_removes_the_batch_effect():
    d = _batched_data()
    out = sctt.apply("integrate.combat", sctt.CellData(
        torch.from_numpy(np.asarray(d.X).copy()), obs=dict(d.obs)),
        device="cpu")
    X = _np(out.X)
    batch = np.arange(600) % 3
    means = np.stack([X[batch == b].mean(0) for b in range(3)])
    assert np.max(np.abs(means - means.mean(0))) < 0.15


def test_combat_validation():
    d = sctt.CellData(torch.zeros((10, 4)), obs={"batch": np.array(["a"] * 10)})
    with pytest.raises(ValueError, match="2 batches"):
        sctt.apply("integrate.combat", d, device="cpu")
    with pytest.raises(KeyError, match="nope"):
        sctt.apply("integrate.combat", d, device="cpu", batch_key="nope")


# --------------------------------------------------------------- harmony


@pytest.fixture(scope="module")
def batched_blobs():
    """``tests/test_integrate.py``'s fixture: two batches of the same 4
    clusters, batch 1 shifted by a constant vector."""
    rng = np.random.default_rng(4)
    pts, labels = gaussian_blobs(600, 20, n_clusters=4, spread=0.25,
                                 seed=17)
    batch = (rng.random(len(pts)) < 0.5).astype(np.int32)
    shift = rng.normal(size=20).astype(np.float32)
    shift = shift / np.linalg.norm(shift) * 2.0
    pts = (pts + batch[:, None] * shift[None, :]).astype(np.float32)
    return pts, batch, labels


def _harmony_f64(Z, phi, C0, theta=2.0, sigma=0.1, lamb=1.0, n_rounds=10,
                 n_cluster_iter=10):
    """The reference's ``harmony_arrays`` steps in float64 from the
    start centroids ``C0`` (the same blocks; padding rows contribute
    nothing, so there are none)."""
    Z, phi = Z.astype(np.float64), phi.astype(np.float64)
    n, B = phi.shape

    def norm(z):
        return z / np.maximum(np.linalg.norm(z, axis=1, keepdims=True),
                              1e-12)

    def softmax(x):
        e = np.exp(x - x.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    G = np.concatenate([np.ones((n, 1)), phi], axis=1)
    ridge = lamb * np.diag(np.concatenate([[0.0], np.ones(B)]))
    bs = -(-n // max(1, min(20, -(-n // 128))))
    R = softmax(-2.0 * (1.0 - norm(Z) @ norm(C0.astype(np.float64)).T)
                / sigma)
    Zc = Z
    for _ in range(n_rounds):
        Zn = norm(Zc)
        for _ in range(n_cluster_iter):
            C = norm(R.T @ Zn)
            O = R.T @ phi
            Rn = np.empty_like(R)
            for lo in range(0, n, bs):
                sl = slice(lo, lo + bs)
                O = O - R[sl].T @ phi[sl]
                E = np.outer(O.sum(1), O.sum(0)) / max(O.sum(), 1.0)
                pen = theta * np.log((E + 1.0) / (O + 1.0))
                Rn[sl] = softmax(-2.0 * (1.0 - Zn[sl] @ C.T) / sigma
                                 + phi[sl] @ pen.T)
                O = O + Rn[sl].T @ phi[sl]
            R = Rn
        corr = np.zeros_like(Z)
        for k in range(R.shape[1]):
            rg = G * R[:, k:k + 1]
            W = np.linalg.solve(rg.T @ G + ridge, rg.T @ Z)
            W[0] = 0.0
            corr += rg @ W
        Zc = Z - corr
    return Zc


@pytest.mark.parametrize("n_clusters", [8, 20])
def test_harmony_arrays_one_round_from_the_reference_start(
        batched_blobs, ref_draws, n_clusters):
    from sctools_tpu.ops.cluster import kmeans_arrays

    pts, batch, _ = batched_blobs
    onehot, _, _ = ref_integrate._batch_onehot(batch)
    kw = dict(n_clusters=n_clusters, n_rounds=1, n_cluster_iter=1)
    want = np.asarray(ref_integrate.harmony_arrays(
        jnp.asarray(pts), jnp.asarray(onehot), jax.random.PRNGKey(0), **kw))
    got = _np(port_integrate.harmony_arrays(
        torch.from_numpy(pts), torch.from_numpy(onehot), seed=0, **kw))
    assert got.dtype == np.float32 and got.shape == pts.shape
    _scaled_close(got, want, HARMONY_TOL, "port against the reference")
    _, C0, _ = kmeans_arrays(ref_integrate._l2norm(jnp.asarray(pts)),
                             jax.random.PRNGKey(0), n_clusters=n_clusters,
                             n_iter=10)
    exact = _harmony_f64(pts, onehot, np.asarray(C0), n_rounds=1,
                         n_cluster_iter=1)
    scale = np.abs(exact).max()
    ref_err = np.abs(want - exact).max()
    port_err = np.abs(got - exact).max()
    assert port_err <= max(2.0 * ref_err, 2e-5 * scale), (port_err, ref_err)
    assert port_err <= 2e-6 * scale, (port_err, scale)


def test_harmony_op_from_the_reference_start(batched_blobs, ref_draws):
    pts, batch, labels = batched_blobs
    ref = RefCellData(pts, obs={"batch": batch}, obsm={"X_pca": pts})
    port = sctt.CellData(torch.from_numpy(pts), obs={"batch": batch},
                         obsm={"X_pca": torch.from_numpy(pts)})
    kw = dict(n_clusters=8, n_rounds=5, seed=0)
    r = sct.apply("integrate.harmony", ref.device_put(), backend="tpu", **kw)
    p = sctt.apply("integrate.harmony", port, device="cpu", **kw)
    Z = _np(p.obsm["X_harmony"])
    _scaled_close(Z, np.asarray(r.obsm["X_harmony"]), HARMONY_TOL,
                  "X_harmony")
    assert list(p.uns["harmony_batches"]) == list(r.uns["harmony_batches"])
    assert p.uns["harmony_n_clusters"] == r.uns["harmony_n_clusters"] == 8
    _assert_harmony_quality(Z, pts, batch, labels)


def _assert_harmony_quality(Z, pts, batch, labels):
    """``tests/test_integrate.py``'s gates: batches mix, clusters stay."""
    assert np.isfinite(Z).all()
    before = _local_batch_mix(pts, batch)
    after = _local_batch_mix(Z, batch)
    assert after > max(before + 0.1, 0.35), (before, after)
    km = kmeans_cpu(RefCellData(Z, obsm={"X_pca": Z}), n_clusters=4, seed=1)
    assert adjusted_rand_index(np.asarray(km.obs["kmeans"]), labels) > 0.8


def test_harmony_with_its_own_seeded_start(batched_blobs):
    pts, batch, labels = batched_blobs
    port = sctt.CellData(torch.from_numpy(pts), obs={"batch": batch},
                         obsm={"X_pca": torch.from_numpy(pts)})
    a = sctt.apply("integrate.harmony", port, device="cpu", n_clusters=8,
                   n_rounds=5, seed=3)
    b = sctt.apply("integrate.harmony", port, device="cpu", n_clusters=8,
                   n_rounds=5, seed=3)
    assert torch.equal(a.obsm["X_harmony"], b.obsm["X_harmony"])
    _assert_harmony_quality(_np(a.obsm["X_harmony"]), pts, batch, labels)


def test_harmony_default_cluster_count(batched_blobs):
    pts, batch, _ = batched_blobs
    port = sctt.CellData(torch.from_numpy(pts[:90]), obs={
        "b": np.where(batch[:90] == 1, "x", "y")},
        obsm={"X_pca": torch.from_numpy(pts[:90])})
    out = sctt.apply("integrate.harmony", port, device="cpu", batch_key="b",
                     n_rounds=1)
    assert out.uns["harmony_n_clusters"] == 3  # round(90 / 30)
    assert list(out.uns["harmony_batches"]) == ["x", "y"]


def test_harmony_validates_inputs(batched_blobs):
    pts, batch, _ = batched_blobs
    port = sctt.CellData(torch.from_numpy(pts), obs={"batch": batch},
                         obsm={"X_pca": torch.from_numpy(pts)})
    with pytest.raises(ValueError, match="batch_key"):
        sctt.apply("integrate.harmony", port, device="cpu", batch_key="nope")
    with pytest.raises(ValueError, match="use_rep"):
        sctt.apply("integrate.harmony", port.replace(obsm={}), device="cpu")


def test_harmony_correction_does_not_hang_on_the_order_of_its_sums():
    """The ridge correction of 8,192 cells in 4 batches with 8
    concentrated clusters (masses ~1,000, so the systems are
    near-singular), once as given and once with the rows permuted,
    which sums the normal equations in another order, as another device
    or thread count does: within 2e-7 of the scale (a few ulps).  A
    float32 solve of separately summed rows lands ~2e-6 apart here and
    carries that through the rounds."""
    rng = np.random.default_rng(5)
    n, d, B, K = 8192, 50, 4, 8
    Z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32) * 3)
    phi = torch.from_numpy(np.eye(B, dtype=np.float32)[rng.integers(0, B, n)])
    R = torch.softmax(torch.from_numpy(
        rng.standard_normal((n, K)).astype(np.float32) * 10), dim=1)
    ridge = torch.diag(torch.tensor([0.0] + [1.0] * B))
    perm = torch.from_numpy(rng.permutation(n))
    from sctools_tpu_torch.config import true_f32

    with true_f32():
        a = port_integrate._correct(Z, phi, R, ridge)
        b = port_integrate._correct(Z[perm], phi[perm], R[perm], ridge)
    b = b[torch.argsort(perm)]
    _scaled_close(_np(a), _np(b), 2e-7, "row order")


# ------------------------------------------------------------- the slice


N_SLICE, SLICE_GENES, SLICE_HVG, SLICE_PCS = 480, 300, 120, 12


@pytest.fixture(scope="module")
def samples():
    """Three runs of one generative process (the reference's
    ``synthetic_counts``), each with its own per-gene factor
    exp(0.5·N(0, 1)) on its counts; the third is the ingest query."""
    full = ref_counts(N_SLICE, SLICE_GENES, density=0.15, n_clusters=3,
                      seed=9)
    X = full.X.tocsr()
    rng = np.random.default_rng(19)
    runs = []
    for s in np.array_split(np.arange(N_SLICE), 3):
        Xs = X[s].multiply(np.exp(rng.standard_normal(SLICE_GENES))
                           [None, :]).tocsr().astype(np.float32)
        # the label as a category: a numeric column would be averaged
        obs = {"cluster": np.array([f"c{c}" for c in
                                    full.obs["cluster_true"][s]])}
        runs.append((RefCellData(Xs, obs=dict(obs), var=dict(full.var)),
                     sctt.CellData(Xs.copy(), obs=dict(obs),
                                   var=dict(full.var))))
    return runs


def _main_path(ref_host, port_host):
    """Library size → log1p → seurat_v3 HVG (subset) → PCA with the
    reference's sketch carried into the port."""
    steps = [("normalize.library_size", {}), ("normalize.log1p", {}),
             ("hvg.select", {"n_top": SLICE_HVG, "subset": True})]
    r = sct.Pipeline(steps).run(ref_host.device_put(), backend="tpu")
    p = sctt.Pipeline(steps).run(port_host, device="cpu")
    assert list(p.var["gene_name"]) == list(np.asarray(r.var["gene_name"]))
    r = sct.apply("pca.randomized", r, backend="tpu", n_components=SLICE_PCS)
    L = min(SLICE_PCS + 10, SLICE_HVG, r.n_cells)
    omega = _sketch_omega(jax.random.PRNGKey(0), SLICE_HVG, L, jnp.float32)
    p = sctt.apply("pca.randomized", p, device="cpu", n_components=SLICE_PCS,
                   omega=pca_omega_from_numpy(np.asarray(omega)))
    # a component's sign is free (the two SVDs pick either); the steps
    # after it do not depend on it
    want = np.asarray(r.obsm["X_pca"])[: r.n_cells]
    sign = np.sign((_np(p.obsm["X_pca"])[: p.n_cells] * want).sum(axis=0))
    sign = torch.from_numpy(sign.astype(np.float32))
    p = p.with_obsm(X_pca=p.obsm["X_pca"] * sign).with_varm(
        PCs=p.varm["PCs"] * sign)
    _scaled_close(_np(p.obsm["X_pca"])[: p.n_cells], want, 1e-4, "X_pca")
    _scaled_close(_np(p.varm["PCs"]), np.asarray(r.varm["PCs"]), 1e-4, "PCs")
    return r, p


def test_the_slice_against_the_reference(samples, ref_draws):
    keys = ["s0", "s1", "s2"]
    ref_m = sct.concat([r for r, _ in samples], label="batch", keys=keys)
    port_m = sctt.concat([p for _, p in samples], label="batch", keys=keys)
    np.testing.assert_array_equal(port_m.X.toarray(), ref_m.X.toarray())
    assert list(port_m.obs["batch"]) == list(ref_m.obs["batch"])
    r, p = _main_path(ref_m, port_m)

    # harmony and mnn on the PCA (the reference's k-means draw for both)
    r = sct.apply("integrate.harmony", r, backend="tpu")
    p = sctt.apply("integrate.harmony", p, device="cpu")
    _scaled_close(_np(p.obsm["X_harmony"]), np.asarray(r.obsm["X_harmony"]),
                  SLICE_TOL, "X_harmony")
    r = sct.apply("integrate.mnn", r, backend="tpu")
    p = sctt.apply("integrate.mnn", p, device="cpu")
    assert p.uns["mnn_merge_order"] == r.uns["mnn_merge_order"]
    mix = [_local_batch_mix(np.asarray(e, np.float64)[:N_SLICE],
                            np.asarray(ref_m.obs["batch"]))
           for e in (_np(p.obsm["X_pca"]), _np(p.obsm["X_harmony"]),
                     _np(p.obsm["X_mnn"]), np.asarray(r.obsm["X_mnn"]))]
    assert mix[1] > mix[0] + 0.05, mix
    # MNN's bandwidth is a self-distance here (most cells are anchors),
    # which the reference takes from float32 rounding noise
    # (``ops/mnn.py``): its X_mnn is compared where that cannot matter,
    # in tests/test_torch_mnn.py; here the mixing must match its own
    assert abs(mix[2] - mix[3]) <= 0.02, mix

    # ingest: the third run onto the first two
    ref_r, ref_p = _main_path(
        sct.concat([r for r, _ in samples[:2]]),
        sctt.concat([p for _, p in samples[:2]]))
    genes = list(np.asarray(ref_r.var["gene_name"]))
    q_steps = [("normalize.library_size", {}), ("normalize.log1p", {})]
    q_r = sct.Pipeline(q_steps).run(samples[2][0].device_put(), backend="tpu")
    q_p = sctt.Pipeline(q_steps).run(samples[2][1], device="cpu")
    q_r, q_p = q_r[:, genes], q_p[:, genes]
    kw = dict(obs=("cluster",), embeddings=())
    got = sctt.apply("integrate.ingest", q_p, device="cpu", ref=ref_p, **kw)
    want = sct.apply("integrate.ingest", q_r, backend="tpu", ref=ref_r, **kw)
    n_q = q_p.n_cells
    a = np.asarray(got.obs["cluster"])[:n_q]
    b = np.asarray(want.obs["cluster"])[:n_q]
    truth = np.asarray(samples[2][1].obs["cluster"])
    assert (a == b).mean() >= 0.99
    assert (a == truth).mean() >= (b == truth).mean() - 0.01
    assert (a == truth).mean() >= 0.6  # 3 clusters: chance is 1/3
