"""The port's graph kernels (``sctools_tpu_torch/ops/graph_kernels.py``)
against the reference's Pallas kernels, run in interpret mode under
``configure(graph_impl="pallas")`` as tests/test_pallas_graph.py runs
them, and against the reference's blocked-XLA twins.

On the CPU each wrapper runs its kernel's plain version.  Tolerances:

* ``matvec``: rtol 1e-5, atol 1e-6 — float32 sums over the k slots in
  another order than the Pallas window sweep (pallas_graph.py:46-52);
  the plain version against the XLA twin, the same (einsum order);
* ``rmatvec``: rtol 1e-5, atol 1e-6 against the Pallas kernel and the
  segment sum, on graphs with -1 ids, repeated ids, destinations without
  edges, a hub with more than k incoming edges and rectangular n (the
  same float32 terms summed in another order); adjointness ``<P x, y> =
  <x, Pᵀ y>`` with both inner products summed in float64, within 1e-5
  of the sum of the terms' magnitudes (the reference holds 5e-3
  absolute, tests/test_pallas_graph.py:92-104);
* ``jaccard``: exact — integer counts and one IEEE division, on graphs
  with -1 padding and duplicate ids;
* ``tsne_repulsion``: forces rtol 1e-5 with atol 1e-6·max_i |y_i|·Σ_j
  w_ij², Z rtol 1e-5 — float32 sums over all pairs in another order.
  The force is the difference of two sums of that magnitude, so its
  float32 error scales with them, not with |F| (on the 300 × 2 fixture
  the reference's own error against float64 is 8.5e-6 for max|F| =
  5.1 and sums of 36);
* ``gather_rows``: exact (a gather)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctools_tpu.config import configure as ref_configure
from sctools_tpu.ops import graph as ref_graph
from sctools_tpu.ops import pallas_graph as PG
from sctools_tpu_torch.config import configure
from sctools_tpu_torch.ops import graph as port_graph
from sctools_tpu_torch.ops import graph_kernels as GK

torch.set_num_threads(2)

MATVEC = dict(rtol=1e-5, atol=1e-6)


def _graph(n=384, k=11, d=23, seed=0, frac_missing=0.06):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[rng.random((n, k)) < frac_missing] = -1
    w = rng.random((n, k)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return idx, w, x


def _banded_graph(n=512, k=9, d=7, band=60, seed=1):
    rng = np.random.default_rng(seed)
    rows = np.arange(n)[:, None]
    idx = rows + rng.integers(-band, band + 1, (n, k))
    idx = np.where((idx >= 0) & (idx < n), idx, -1).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return idx, w, x, band


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------- matvec


def test_matvec_full_sweep_matches_pallas_kernel():
    idx, w, x = _graph()
    with ref_configure(graph_impl="pallas"):
        ref = np.asarray(PG.matvec(jnp.asarray(idx), jnp.asarray(w),
                                   jnp.asarray(x), block=128))
    out = GK.matvec(*_t(idx, w, x)).numpy()
    np.testing.assert_allclose(out, ref, **MATVEC)


def test_matvec_banded_after_reorder_matches_pallas_kernel():
    """A banded graph permuted by the port's RCM pass: the reference's
    banded sweep over the recorded bandwidth, against the port's matvec
    (which takes the band and needs none)."""
    idx, w, x, _ = _banded_graph()
    perm = port_graph.reorder_permutation(idx)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    r_idx = np.where(idx < 0, -1, inv[np.where(idx < 0, 0, idx)])[perm]
    r_idx = r_idx.astype(np.int32)
    r_w, r_x = w[perm], x[perm]
    band = port_graph.graph_bandwidth(r_idx)
    assert band < len(idx) // 2
    with ref_configure(graph_impl="pallas"):
        ref = np.asarray(PG.matvec(jnp.asarray(r_idx), jnp.asarray(r_w),
                                   jnp.asarray(r_x), band_rows=band,
                                   block=64))
    out = GK.matvec(*_t(r_idx, r_w, r_x), band_rows=band).numpy()
    np.testing.assert_allclose(out, ref, **MATVEC)


@pytest.mark.parametrize("block", [2048, 100])
def test_matvec_plain_matches_blocked_xla_twin(block):
    idx, w, x = _graph(n=500, seed=3)
    with ref_configure(graph_impl="xla"):
        ref = np.asarray(PG.matvec(jnp.asarray(idx), jnp.asarray(w),
                                   jnp.asarray(x)))
    out = GK.matvec_plain(*_t(idx, w, x), block=block).numpy()
    np.testing.assert_allclose(out, ref, **MATVEC)


def test_knn_matvec_goes_through_the_wrapper():
    idx, w, x = _graph(n=200, k=5, d=3, seed=4)
    a = port_graph.knn_matvec(*_t(idx, w, x))
    b = GK.matvec_plain(*_t(idx, w, x))
    assert torch.equal(a, b)


# ------------------------------------------------------------ rmatvec


def _rmatvec_graph(n=384, k=11, d=7, seed=10):
    """-1 ids, a repeated id inside lists, destinations without edges
    (ids only below n - 40) and a hub (id 3) with ~n/2 incoming edges,
    far more than k."""
    idx, w, x = _graph(n=n, k=k, d=d, seed=seed)
    idx = np.where(idx >= n - 40, idx - 40, idx).astype(np.int32)
    idx[::2, 0] = 3
    idx[::5, 2] = idx[::5, 1]
    return idx, w, x


def test_rmatvec_matches_pallas_kernel():
    idx, w, x = _rmatvec_graph()
    with ref_configure(graph_impl="pallas"):
        ref = np.asarray(PG.rmatvec(jnp.asarray(idx), jnp.asarray(w),
                                    jnp.asarray(x), block=128))
    out = GK.rmatvec(*_t(idx, w, x)).numpy()
    np.testing.assert_allclose(out, ref, **MATVEC)
    assert (out[-40:] == 0).all()  # no incoming edges
    assert (idx == 3).sum() > idx.shape[1]


@pytest.mark.parametrize("n", [384, 500, 300])
def test_rmatvec_matches_segment_sum(n):
    """Square and rectangular: more outputs than rows (the extra ones
    get zeros) and fewer (ids >= n add nothing)."""
    idx, w, x = _rmatvec_graph()
    ref = np.asarray(ref_graph._knn_rmatvec_segsum(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(x), n=n))
    out = port_graph.knn_rmatvec(*_t(idx, w, x), n=n).numpy()
    assert out.shape == (n, x.shape[1])
    np.testing.assert_allclose(out, ref, **MATVEC)
    np.testing.assert_allclose(
        GK.rmatvec_plain(*_t(idx, w, x), n=n, block=100).numpy(), ref,
        **MATVEC)


def test_rmatvec_is_the_adjoint_of_matvec():
    idx, w, x = _rmatvec_graph(d=5)
    y = np.random.default_rng(11).standard_normal(x.shape).astype(
        np.float32)
    px = GK.matvec(*_t(idx, w, x)).numpy().astype(np.float64)
    pty = GK.rmatvec(*_t(idx, w, y)).numpy().astype(np.float64)
    lhs = (px * y).sum()
    rhs = (x.astype(np.float64) * pty).sum()
    scale = (np.abs(px) * np.abs(y)).sum() + (np.abs(x) * np.abs(pty)).sum()
    assert abs(lhs - rhs) <= 1e-5 * scale


# The widths at which the CUDA kernels take their lane-group, scalar,
# float2 and float4 column paths; on the CPU the wrappers run the plain
# versions, held here against the Pallas kernels at each width.
WIDTHS = [1, 2, 10, 21, 33, 130]


@pytest.mark.parametrize("d", WIDTHS)
def test_matvec_at_each_width_matches_pallas_kernel(d):
    idx, w, x = _graph(n=256, d=d, seed=20 + d)
    with ref_configure(graph_impl="pallas"):
        ref = np.asarray(PG.matvec(jnp.asarray(idx), jnp.asarray(w),
                                   jnp.asarray(x), block=128))
    out = GK.matvec(*_t(idx, w, x)).numpy()
    assert out.shape == (256, d)
    np.testing.assert_allclose(out, ref, **MATVEC)


@pytest.mark.parametrize("d", WIDTHS)
def test_rmatvec_at_each_width_matches_pallas_kernel(d):
    idx, w, x = _rmatvec_graph(n=256, d=d, seed=40 + d)
    with ref_configure(graph_impl="pallas"):
        ref = np.asarray(PG.rmatvec(jnp.asarray(idx), jnp.asarray(w),
                                    jnp.asarray(x), block=128))
    out = GK.rmatvec(*_t(idx, w, x)).numpy()
    assert out.shape == (256, d)
    np.testing.assert_allclose(out, ref, **MATVEC)
    assert (out[-40:] == 0).all()  # no incoming edges


def test_rmatvec_order_is_stable_by_destination():
    idx, _, _ = _rmatvec_graph(n=200, k=6)
    edges, offsets = GK.rmatvec_order(torch.from_numpy(idx), n=150)
    flat = idx.reshape(-1)
    keep = (flat >= 0) & (flat < 150)
    assert edges.dtype == offsets.dtype == torch.int32
    assert offsets.shape == (151,) and int(offsets[-1]) == keep.sum()
    e = edges.numpy()
    np.testing.assert_array_equal(flat[e], np.sort(flat[keep],
                                                   kind="stable"))
    for c in (3, 7, 149):  # each run ascending in (r, t)
        run = e[offsets[c]:offsets[c + 1]]
        np.testing.assert_array_equal(run, np.flatnonzero(flat == c))


# ------------------------------------------------------------- jaccard


def _dup_graph(n=300, k=10, seed=5):
    """Neighbour lists with -1 padding and repeated ids."""
    idx, _, _ = _graph(n=n, k=k, seed=seed, frac_missing=0.1)
    idx[::7, 1] = idx[::7, 0]  # duplicates inside a list
    idx[::11, :] = -1  # rows without edges
    return idx


@pytest.mark.parametrize("fixture", ["random", "duplicates"])
def test_jaccard_exactly_equals_pallas_kernel(fixture):
    idx = _graph(n=320, k=10)[0] if fixture == "random" else _dup_graph()
    with ref_configure(graph_impl="pallas"):
        ref = np.asarray(PG.jaccard(jnp.asarray(idx), block=64))
    out = GK.jaccard(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[idx < 0] == 0).all()


@pytest.mark.parametrize("impl", ["xla", "gather"])
def test_jaccard_plain_exactly_equals_xla_twins(impl):
    idx = _dup_graph(n=400, seed=6)
    with ref_configure(graph_impl=impl):
        ref = np.asarray(PG.jaccard(jnp.asarray(idx)))
    t = torch.from_numpy(idx)
    np.testing.assert_array_equal(GK.jaccard_plain(t, block=128).numpy(),
                                  ref)
    np.testing.assert_array_equal(
        port_graph.jaccard_arrays(t, block=96).numpy(), ref)


def test_jaccard_counts_duplicates_as_the_reference_does():
    """Rows 0 and 2 list id 1 twice.  The reference counts matching
    pairs of slots and counts every valid slot, which differs from a
    set oracle where a list repeats an id."""
    idx = np.array([[1, 1, 2], [0, 2, -1], [0, 1, 1]], np.int32)
    ref = np.asarray(ref_graph.jaccard_arrays(jnp.asarray(idx)))
    out = GK.jaccard(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, ref)
    # slot (2, 1): inter = #{(s,u): N(1)[s] == N(2)[u]} = 1 (id 0), vi =
    # 3, vj = 2 → 1/4; a set oracle would give 1/3
    assert out[2, 1] == np.float32(0.25)


@pytest.mark.parametrize("n,k", [(301, 1), (301, 16), (300, 17),
                                 (129, 32)])
def test_jaccard_at_each_kernel_width_matches_pallas_kernel(n, k):
    """The widths where the kernel changes its layout: k = 1 and 16 (a
    half-warp a row, odd n so that the last warp holds one row), 17 and
    32 (a warp a row); lists with -1 padding, repeated ids and rows
    without edges, against the reference's Pallas kernel bit for bit."""
    rng = np.random.default_rng(k)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.1] = -1
    if k > 1:
        idx[::7, 1] = idx[::7, 0]  # duplicates inside a list
        idx[::5, -1] = idx[::5, 0]
    idx[::11, :] = -1  # rows without edges
    with ref_configure(graph_impl="pallas"):
        ref = np.asarray(PG.jaccard(jnp.asarray(idx), block=64))
    out = GK.jaccard(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[idx < 0] == 0).all()


@pytest.mark.parametrize("op", ["matvec", "rmatvec"])
def test_gathers_past_the_former_cap_match_pallas_kernel(op):
    """k = 300 slots a row, past the former cap of 256 (the reference
    sets none): both gathers against the reference's Pallas kernels,
    each output within 1e-5 of the sum of its terms' magnitudes (float32
    sums of 300 terms in another order; 1e-6 absolute, as at k = 11,
    is below their rounding)."""
    idx, w, x = _graph(n=320, k=300, d=8, seed=30)
    with ref_configure(graph_impl="pallas"):
        ref = np.asarray(getattr(PG, op)(jnp.asarray(idx), jnp.asarray(w),
                                         jnp.asarray(x), block=64))
    out = getattr(GK, op)(*_t(idx, w, x)).numpy()
    scale = getattr(GK, op + "_plain")(*_t(idx, np.abs(w), np.abs(x)))
    assert out.shape == (320, 8)
    assert (np.abs(out - ref) <= 1e-5 * scale.numpy() + 1e-7).all()


def test_jaccard_past_the_former_cap_matches_reference():
    """k = 260, past the former cap of 256 (the kernel then reads a
    row's own list where it lies), with padding and duplicates, against
    the reference's ``jaccard(block=8)`` on the CPU (its blocked-XLA
    twin; the Pallas kernel in interpret mode takes minutes at this k)
    bit for bit."""
    n, k = 300, 260
    rng = np.random.default_rng(k)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.1] = -1
    idx[::7, 1] = idx[::7, 0]
    idx[::11, :] = -1
    ref = np.asarray(PG.jaccard(jnp.asarray(idx), block=8))
    out = GK.jaccard(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, ref)


# ----------------------------------------------------- t-SNE repulsion


def _rep_ok(y, f, z, f_ref, z_ref):
    f_ref = np.asarray(f_ref)
    yd = y.astype(np.float64)
    w = 1.0 / (1.0 + ((yd[:, None, :] - yd[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(w, 0.0)
    terms = (np.abs(yd) * (w * w).sum(1)[:, None]).max()
    np.testing.assert_allclose(f, f_ref, rtol=1e-5, atol=1e-6 * terms)
    np.testing.assert_allclose(float(z), float(z_ref), rtol=1e-5)


@pytest.mark.parametrize("n,dim", [(300, 2), (200, 3), (1, 2), (2, 2),
                                   (257, 1), (513, 4)])
def test_tsne_repulsion_matches_pallas_kernel(n, dim):
    rng = np.random.default_rng(n)
    y = (rng.standard_normal((n, dim)) * 3.0).astype(np.float32)
    with ref_configure(graph_impl="pallas"):
        f_ref, z_ref = PG.tsne_repulsion(jnp.asarray(y), n, block=128)
    f, z = GK.tsne_repulsion(torch.from_numpy(y), n)
    assert f.shape == (n, dim)
    _rep_ok(y, f.numpy(), z, f_ref, z_ref)


def test_tsne_repulsion_plain_blocks_and_padding_rows():
    """Rows past ``n`` are ignored; the row block does not change the
    result beyond float32 order; against a float64 dense oracle."""
    rng = np.random.default_rng(7)
    n = 250
    y = (rng.standard_normal((n + 6, 2)) * 2.0).astype(np.float32)
    f, z = GK.tsne_repulsion_plain(torch.from_numpy(y), n, block=64)
    yd = y[:n].astype(np.float64)
    d2 = ((yd[:, None, :] - yd[None, :, :]) ** 2).sum(-1)
    wm = 1.0 / (1.0 + d2)
    np.fill_diagonal(wm, 0.0)
    w2 = wm * wm
    f_ref = yd * w2.sum(1)[:, None] - w2 @ yd
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(f_ref).max())
    np.testing.assert_allclose(float(z), wm.sum(), rtol=1e-5)


# ---------------------------------------------------------- gather_rows


def test_gather_rows_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((500, 6)).astype(np.float32)
    idx = rng.integers(0, 500, (500, 9))
    ref = np.asarray(PG.gather_rows(jnp.asarray(x), jnp.asarray(idx)))
    out = GK.gather_rows(torch.from_numpy(x), torch.from_numpy(idx),
                         block=128)
    np.testing.assert_array_equal(out.numpy(), ref)


# ------------------------------------------------------------ wrappers


def _calls():
    idx, w, x = _graph(n=64, k=4, d=3, seed=9)
    ti, tw, tx = _t(idx, w, x)
    y = torch.from_numpy(x[:, :2].copy())
    return {
        "matvec": (GK.matvec, lambda t=ti: GK.matvec(t, tw, tx)),
        "rmatvec": (GK.rmatvec, lambda t=ti: GK.rmatvec(t, tw, tx)),
        "jaccard": (GK.jaccard, lambda t=ti: GK.jaccard(t)),
        "tsne_repulsion": (GK.tsne_repulsion,
                           lambda t=y: GK.tsne_repulsion(t, 64)),
    }


@pytest.mark.parametrize("name", ["matvec", "rmatvec", "jaccard",
                                  "tsne_repulsion"])
def test_cpu_tensor_runs_the_plain_version_and_counts_no_launch(name):
    wrapper, call = _calls()[name]
    before = wrapper.launches
    call()
    assert wrapper.launches == before


def test_wrappers_raise_on_other_devices_and_impls():
    idx, w, x = _t(*_graph(n=16, k=3, d=2))
    meta = [t.to("meta") for t in (idx, w, x)]
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        GK.matvec(*meta)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        GK.rmatvec(*meta)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        GK.jaccard(meta[0])
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        GK.tsne_repulsion(meta[2], 16)
    with configure(graph_impl="pallas"), pytest.raises(ValueError):
        GK.matvec(idx, w, x)
    with configure(graph_impl="xla"), pytest.raises(ValueError):
        GK.jaccard(idx)


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(dim=0),
    dict(idx_dtype=torch.float32), dict(w_shape=(8, 2))])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    k = bad.get("k", 3)
    idx = torch.zeros((8, k), dtype=bad.get("idx_dtype", torch.int32))
    w = torch.zeros(bad.get("w_shape", (8, k)))
    with pytest.raises(ValueError):
        if "dim" in bad:
            GK.tsne_repulsion(torch.zeros((8, bad["dim"])), 8)
        elif "k" in bad:
            GK.jaccard(idx)
        else:
            GK.matvec(idx, w, torch.zeros((8, 2)))
