"""The streamed path on a mesh: ``ShardSource.with_mesh`` and
``stream_pipeline(mesh=)`` of the port on 8 CPU shards
(``make_mesh(devices=["cpu"] * 8)``) against the reference's
``stream_pipeline(mesh=make_mesh(8))`` on the 8 virtual host devices of
``tests/conftest.py``, and against the port's own single-device pass.

The fixture is the reference's (``tests/test_stream_mesh.py``):
``synthetic_counts(1200, 400, density=0.1, n_clusters=4, seed=8)`` in
512-row shards (8 devices × sublane 8 × 8).  The reference's sketch is
carried into the port (``_sketch_omega`` → ``carry.pca_omega_from_numpy``
→ ``omega=``).  Tolerances: against the reference, ``total_counts`` rtol
1e-5, the HVG genes equal, kNN recall > 0.99 of the reference mesh's
ids; against the port's single device, obs bit for bit (row-local),
per-gene moments rtol 1e-5 (the same float32 sums of up to 512 rows
added in another order: 64-row blocks, then the 8 partials; the
largest difference seen is 2.1e-6 relative, in raw_gene_var's centred
sums, so 1e-6 would fail on rounding alone),
the HVG genes equal, explained variance rtol 1e-4, recall ≥ 0.99; two
mesh runs, and a resumed meshed stats pass against an uninterrupted
one, bit for bit."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctools_tpu.data import stream as ref_stream
from sctools_tpu.data.synthetic import synthetic_counts
from sctools_tpu.ops.pca import _sketch_omega
from sctools_tpu.parallel import make_mesh as ref_make_mesh
from sctools_tpu_torch.carry import pca_omega_from_numpy
from sctools_tpu_torch.data import stream as S
from sctools_tpu_torch.data.sharded import ShardedRows
from sctools_tpu_torch.ops.knn import recall_at_k
from sctools_tpu_torch.parallel import make_mesh
from sctools_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)

N_TOP, N_PCS, K = 200, 20, 10
KW = dict(n_top=N_TOP, n_components=N_PCS, k=K, refine=32)
MOMENTS = ("gene_mean", "gene_var", "raw_gene_mean", "raw_gene_var",
           "gene_nnz")


@pytest.fixture(scope="module")
def counts():
    return synthetic_counts(1200, 400, density=0.1, n_clusters=4, seed=8)


@pytest.fixture(scope="module")
def mito(counts):
    return np.asarray(counts.var["mito"])


@pytest.fixture(scope="module")
def src(counts):
    return S.ShardSource.from_scipy(counts.X, shard_rows=512, device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def ref_mesh_run(counts, mito):
    ref_src = ref_stream.ShardSource.from_scipy(counts.X, shard_rows=512)
    return ref_stream.stream_pipeline(ref_src, mito_mask=mito,
                                      mesh=ref_make_mesh(8), **KW)


@pytest.fixture(scope="module")
def omega(ref_mesh_run):
    g_sub = len(ref_mesh_run["hvg_genes"])
    om = _sketch_omega(jax.random.PRNGKey(0), g_sub, N_PCS + 10,
                       jnp.float32)
    return pca_omega_from_numpy(np.asarray(om))


@pytest.fixture(scope="module")
def mesh_run(src, mesh, mito, omega):
    return S.stream_pipeline(src, mito_mask=mito, mesh=mesh, omega=omega,
                             device="cpu", **KW)


@pytest.fixture(scope="module")
def single_run(src, mito, omega):
    return S.stream_pipeline(src, mito_mask=mito, omega=omega,
                             device="cpu", **KW)


def test_with_mesh_requires_divisible_shards(counts, mesh):
    odd = S.ShardSource.from_scipy(counts.X, shard_rows=264, device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        odd.with_mesh(mesh)


def test_with_mesh_refuses_a_mesh_of_another_kind(src):
    cuda_mesh = Mesh((torch.device("cuda", 0),) * 8)
    with pytest.raises(ValueError, match="cuda devices"):
        src.with_mesh(cuda_mesh)


@pytest.mark.parametrize("prefetch", [False, True])
def test_mesh_shards_are_placed_in_blocks(src, mesh, prefetch):
    msrc = dataclasses.replace(src, prefetch=prefetch).with_mesh(mesh)
    assert msrc.mesh is mesh and msrc.n_shards == 3
    shards = list(msrc)
    assert [o for o, _ in shards] == [0, 512, 1024]
    for (_, sh), (_, flat) in zip(shards, src):
        assert isinstance(sh, ShardedRows) and len(sh.blocks) == 8
        assert sh.rows_padded % 64 == 0 and sh.n_cells == flat.n_cells
        assert all(b.device == d for b, d in zip(sh.blocks, mesh.devices))
        m = sh.block_rows
        assert [b.n_cells for b in sh.blocks] == [
            max(0, min(m, flat.n_cells - d * m)) for d in range(8)]
        back = sh.gather()
        rows = flat.rows_padded
        assert torch.equal(back.indices[:rows], flat.indices)
        assert torch.equal(back.data[:rows], flat.data)
        assert bool((back.indices[rows:] == flat.n_genes).all())
    # the last shard (176 cells) is padded to 192 rows: 8 blocks of 24
    assert shards[-1][1].block_rows == 24
    if not prefetch:  # blocks of a shard already there are views of it
        ptrs = {b.indices.untyped_storage().data_ptr()
                for b in shards[0][1].blocks}
        assert len(ptrs) == 1


def test_stream_pipeline_mesh_matches_reference(mesh_run, ref_mesh_run):
    np.testing.assert_allclose(mesh_run["obs"]["total_counts"],
                               np.asarray(ref_mesh_run["obs"]
                                          ["total_counts"]), rtol=1e-5)
    assert np.array_equal(mesh_run["hvg_genes"],
                          np.asarray(ref_mesh_run["hvg_genes"]))
    idx = mesh_run["knn_indices"].numpy()[:1200]
    ref = np.asarray(ref_mesh_run["knn_indices"])[:1200]
    assert recall_at_k(idx, ref) > 0.99


def test_stream_pipeline_mesh_matches_single_device(mesh_run, single_run,
                                                    src, mesh, mito):
    for key in ("total_counts", "n_genes", "pct_counts_mt"):
        assert np.array_equal(mesh_run["obs"][key], single_run["obs"][key])
    one = S.stream_stats(src, mito_mask=mito)
    many = S.stream_stats(src.with_mesh(mesh), mito_mask=mito)
    for key in MOMENTS:
        np.testing.assert_allclose(many[key], one[key], rtol=1e-5,
                                   err_msg=key)
    assert np.array_equal(mesh_run["hvg_genes"], single_run["hvg_genes"])
    np.testing.assert_allclose(
        mesh_run["pca_explained_variance"].numpy(),
        single_run["pca_explained_variance"].numpy(), rtol=1e-4)
    idx = mesh_run["knn_indices"]
    # the ring's padded rows: 8 shards of round_up(150, 8) = 152
    assert tuple(idx.shape) == (1216, K)
    assert bool((idx[1200:] == -1).all())
    assert recall_at_k(idx.numpy()[:1200],
                       single_run["knn_indices"].numpy()[:1200]) >= 0.99
    assert tuple(mesh_run["X_pca"].shape) == (1200, N_PCS)


def test_mesh_scores_come_back_in_row_order(src, mesh, mito, omega,
                                            single_run):
    """stream_pca on a meshed source: per-device blocks whose pieces put
    the rows in order, equal up to float32 rounding to the single
    device's scores."""
    msrc = src.with_mesh(mesh)
    stats = S.stream_stats(msrc, mito_mask=mito)
    scores, _, _ = S.stream_pca(msrc, single_run["hvg_genes"],
                                stats["gene_mean"], n_components=N_PCS,
                                omega=omega)
    assert isinstance(scores, ShardedRows) and len(scores.blocks) == 8
    got = scores.gather().numpy()
    want = single_run["X_pca"].numpy()
    assert got.shape == want.shape
    for j in range(N_PCS):
        a, b = got[:, j], want[:, j]
        sign = np.sign(a @ b)
        assert np.max(np.abs(a - sign * b)) <= 1e-3 * np.linalg.norm(b), j


def test_one_device_mesh_is_the_single_device_path(src, mito, omega,
                                                   single_run):
    """A mesh of one device cuts each shard into one block, and the
    streamed passes' block code is then the single-device code step for
    step: stats and PCA give the same bits."""
    msrc = src.with_mesh(make_mesh(devices=["cpu"]))
    stats = S.stream_stats(msrc, mito_mask=mito)
    flat = S.stream_stats(src, mito_mask=mito)
    for key in flat:
        assert np.array_equal(np.asarray(stats[key]),
                              np.asarray(flat[key])), key
    args = (single_run["hvg_genes"], flat["gene_mean"])
    got = S.stream_pca(msrc, *args, n_components=N_PCS, omega=omega)
    want = S.stream_pca(src, *args, n_components=N_PCS, omega=omega)
    assert torch.equal(got[0].gather(), want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)

def test_two_mesh_runs_are_bit_for_bit(mesh_run, src, mesh, mito, omega):
    again = S.stream_pipeline(src, mito_mask=mito, mesh=mesh, omega=omega,
                              device="cpu", **KW)
    for key in mesh_run["obs"]:
        assert np.array_equal(again["obs"][key], mesh_run["obs"][key])
    assert np.array_equal(again["hvg_genes"], mesh_run["hvg_genes"])
    for key in ("X_pca", "pca_components", "pca_explained_variance",
                "knn_indices", "knn_distances"):
        assert torch.equal(again[key], mesh_run[key]), key


def test_mesh_checkpoint_resume_is_bit_for_bit(src, mesh, mito, tmp_path):
    """with_mesh wraps factory_from too: a meshed stats pass that
    crashes at shard 1 resumes from its checkpoint and gives the bits
    of an uninterrupted meshed pass."""
    msrc = src.with_mesh(mesh)
    want = S.stream_stats(msrc, mito_mask=mito)
    ck = str(tmp_path / "mesh_ck.npz")
    base_from = msrc.factory_from
    attempt = [0]

    def crashing_from(k):
        for i, s in enumerate(base_from(k), start=k):
            if attempt[0] == 0 and i == 1:
                attempt[0] = 1
                raise RuntimeError("boom")
            yield s

    crashing = dataclasses.replace(msrc, factory=lambda: crashing_from(0),
                                   factory_from=crashing_from)
    with pytest.raises(RuntimeError, match="boom"):
        S.stream_stats(crashing, mito_mask=mito, checkpoint=ck)
    assert os.path.exists(ck)
    got = S.stream_stats(crashing, mito_mask=mito, checkpoint=ck)
    for key in ("total_counts", "n_genes", "pct_counts_mt") + MOMENTS:
        assert np.array_equal(got[key], want[key]), key
    assert not os.path.exists(ck)


def test_median_target_on_a_mesh_is_the_shards(src, mesh, mito):
    """target_sum=None: each block scales to the whole shard's median
    total (gathered), as the single device does."""
    one = S.stream_stats(src, mito_mask=mito, target_sum=None)
    many = S.stream_stats(src.with_mesh(mesh), mito_mask=mito,
                          target_sum=None)
    for key in ("gene_mean", "gene_var"):
        np.testing.assert_allclose(many[key], one[key], rtol=1e-5)


@pytest.mark.parametrize("flavor", ["pearson_residuals", "dispersion"])
def test_other_flavors_on_a_mesh(src, mesh, mito, flavor):
    one = S.stream_stats(src, mito_mask=mito)
    msrc = src.with_mesh(mesh)
    many = S.stream_stats(msrc, mito_mask=mito)
    a = S.stream_hvg_scores(one, flavor=flavor, src=src)
    b = S.stream_hvg_scores(many, flavor=flavor, src=msrc)
    # dispersion z-scores the moments' ulps within bins: atol 1e-4 of
    # scores of order 1
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)


def test_mesh_argument_errors(src, mesh):
    with pytest.raises(ValueError, match="knn_chunk"):
        S.stream_pipeline(src, mesh=mesh, knn_chunk=256, device="cpu")
    with pytest.raises(ValueError, match="lie on cpu"):
        S.stream_pipeline(src, mesh=mesh, device="meta")
    cuda_mesh = Mesh((torch.device("cuda", 0),) * 8)
    with pytest.raises(ValueError, match="first device"):
        S.stream_pipeline(src, mesh=cuda_mesh, device="cpu")
