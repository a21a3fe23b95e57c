"""The port's ``model.scvi`` and ``model.scanvi``
(``sctools_tpu_torch/models/scvi.py``) against the JAX package's
(``sctools_tpu/models/scvi.py``), on the CPU.

The reference misses its own quality thresholds on this tree
(tests/test_scvi.py), so the port is held to its values, on fixed inputs
and weights: the reference's ``jax.random`` initial weights come in
through ``carry.scvi_params_from_numpy`` and its ``jax.random.normal``
noise as ``eps`` (the ops patch ``initial_model`` and ``epoch_noise``);
the minibatch order is the same numpy draws in both.  Tolerances:

* ``nb_logpmf``, ``enc_input``, ``kl_gauss``: rtol 1e-5 (atol 1e-4 on
  the log-pmf, whose lgamma terms of size ~100 cancel);
* the objectives' values rtol 1e-5, their gradients within 1e-4 of each
  parameter's largest gradient (float32 sums over 64–160 cells and 160
  genes in another order);
* one Adam step: rtol 1e-6 (elementwise, the same operations);
* 20 training steps and the ops over 2–3 epochs: parameters, latents,
  dispersions and decoded fractions within 2e-4 of their scale, the
  ELBO histories rtol 1e-5; predictions equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.models import scvi as R
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import scvi_params_from_numpy
from sctools_tpu_torch.models import scvi as P
from sctools_tpu_torch.parallel import make_mesh
from sctools_tpu_torch.utils.optim import adam_step_all, bias_corrections

torch.set_num_threads(2)

N, G, L, H = 400, 160, 6, 32
GRAD_TOL = 1e-4  # of each parameter's largest gradient
STATE_TOL = 2e-4  # of each compared array's largest value


def _poisson_blocks(n=N, g=G, seed=0):
    """tests/test_scvi.py's data at a smaller size: three clusters with
    hot gene blocks and per-cell library variation."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 3, n)
    prof = np.tile(rng.uniform(0.5, 2, g), (3, 1))
    block = g // 3
    for c in range(3):
        prof[c, c * block:(c + 1) * block] *= 8.0
    lib = rng.uniform(0.5, 2.0, n)
    X = rng.poisson(prof[truth] * lib[:, None] * 2).astype(np.float32)
    return X, truth


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _ref_params(seed, n_batches=0, n_classes=0, y_decoder=False):
    """The reference's initial parameters for ``seed`` (its ops' key
    order) and the key its epochs split from."""
    key = jax.random.PRNGKey(seed)
    if not n_classes:
        key, ki = jax.random.split(key)
        return R.init_params(ki, G, n_batches, L, H), key
    key, ki, kc, kd = jax.random.split(key, 4)
    params = R.init_params(ki, G, n_batches, L, H)
    params["clf"] = R._init_mlp(kc, (L, H // 2, n_classes))
    if y_decoder:
        params["dec"] = R._init_mlp(kd, (L + n_classes + n_batches, H, G))
        params["prior_mu"] = jnp.zeros((n_classes, L))
    return params, key


def _ref_epoch_noise(key, epochs, n_steps, rows):
    """The reference's noise of each epoch (``_train_epoch``'s key
    chain), (n_steps, rows, L) each."""
    out = []
    for _ in range(epochs):
        key, ke = jax.random.split(key)
        steps = []
        for _ in range(n_steps):
            ke, ks = jax.random.split(ke)
            steps.append(np.asarray(jax.random.normal(ks, (rows, L))))
        out.append(torch.from_numpy(np.stack(steps)))
    return out


def _grad_tree(model):
    """The model's ``.grad``s in the reference's tree layout (each
    weight's transposed to (in, out))."""
    def mlp(m):
        return [{"w": lyr.weight.grad.numpy().T, "b": lyr.bias.grad.numpy()}
                for lyr in m.layers]

    out = {"enc": mlp(model.enc), "dec": mlp(model.dec),
           "log_theta": model.log_theta.grad.numpy()}
    if model.clf is not None:
        out["clf"] = mlp(model.clf)
    if model.prior_mu is not None:
        out["prior_mu"] = model.prior_mu.grad.numpy()
    return out


def _close_trees(got, want, tol):
    """Each leaf within ``tol`` of the reference leaf's largest value."""
    g = jax.tree_util.tree_leaves_with_path(got)
    w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(g) == len(w)
    for path, a in g:
        b = np.asarray(w[path])
        assert a.shape == b.shape, path
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(np.asarray(a) - b).max())
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.fixture(scope="module")
def blocks():
    return _poisson_blocks()


def _labels(truth, frac=0.3, seed=0):
    rng = np.random.default_rng(seed)
    labels = np.array([f"type_{c}" for c in truth], dtype=object)
    labels[rng.random(len(truth)) > frac] = "Unknown"
    return labels.astype(str)


# ------------------------------------------------------ the objective


def test_nb_logpmf_enc_input_kl_match_reference(blocks):
    X, _ = blocks
    rng = np.random.default_rng(1)
    mean = rng.uniform(0.01, 30, X.shape).astype(np.float32)
    theta = rng.uniform(0.1, 20, (G,)).astype(np.float32)
    want = np.asarray(R._nb_logpmf(jnp.asarray(X), jnp.asarray(mean),
                                   jnp.asarray(theta)[None]))
    got = P.nb_logpmf(torch.from_numpy(X), torch.from_numpy(mean),
                      torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    oh = np.eye(2, dtype=np.float32)[rng.integers(0, 2, N)]
    X0 = X.copy()
    X0[3] = 0.0  # an empty cell: the library clamps at 1
    np.testing.assert_allclose(
        P.enc_input(torch.from_numpy(X0), torch.from_numpy(oh)).numpy(),
        np.asarray(R._enc_input(jnp.asarray(X0), jnp.asarray(oh))),
        rtol=1e-5)
    mu = rng.normal(size=(N, L)).astype(np.float32)
    lv = rng.normal(size=(N, L)).astype(np.float32)
    pm = rng.normal(size=(1, L)).astype(np.float32)
    np.testing.assert_allclose(
        P.kl_gauss(*map(torch.from_numpy, (mu, lv, pm))).numpy(),
        np.asarray(R._kl_gauss(*map(jnp.asarray, (mu, lv, pm)))),
        rtol=1e-5)


@pytest.mark.parametrize("which", ["elbo", "semi_elbo", "semi_elbo_y"])
def test_objective_and_gradients_match_reference(blocks, which):
    """Each objective's value and gradients against
    ``jax.value_and_grad`` of the reference's, the reference's weights
    carried in and its noise passed as ``eps``; a batch covariate and
    30 % labelled cells."""
    X, truth = blocks
    B = 96
    rng = np.random.default_rng(2)
    oh = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    xb = X[:B]
    y = truth[:B].astype(np.int32)
    has = (rng.random(B) < 0.3).astype(np.float32)
    ref, _ = _ref_params(5, n_batches=2,
                         n_classes=0 if which == "elbo" else 3,
                         y_decoder=which == "semi_elbo_y")
    key = jax.random.PRNGKey(9)
    eps = np.array(jax.random.normal(key, (B, L)))
    klw = 0.3
    if which == "elbo":
        val, grads = jax.value_and_grad(R.elbo_fn)(
            ref, jnp.asarray(xb), jnp.asarray(oh), key, klw)
    else:
        fn = R.semi_elbo_fn if which == "semi_elbo" else R.semi_elbo_y_fn
        val, grads = jax.value_and_grad(fn)(
            ref, jnp.asarray(xb), jnp.asarray(oh), jnp.asarray(y),
            jnp.asarray(has), key, klw)
    model = scvi_params_from_numpy(_tree_np(ref))
    args = [torch.from_numpy(xb), torch.from_numpy(oh)]
    if which != "elbo":
        args += [torch.from_numpy(y.astype(np.int64)), torch.from_numpy(has)]
    got = getattr(P, which)(model, *args, torch.from_numpy(eps), klw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(val), rtol=1e-5)
    _close_trees(_grad_tree(model), _tree_np(grads), GRAD_TOL)


def test_adam_step_matches_optax():
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in
              ((7, 5), (5,), (3,))]
    grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
    tx = optax.adam(1e-3)
    state = tx.init([jnp.asarray(p) for p in params])
    want = [jnp.asarray(p) for p in params]
    for _ in range(3):
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, want)
        want = optax.apply_updates(want, upd)
    got = [torch.from_numpy(p.copy()) for p in params]
    ms = [torch.zeros_like(p) for p in got]
    vs = [torch.zeros_like(p) for p in got]
    for t in range(1, 4):
        adam_step_all(got, [torch.from_numpy(g) for g in grads], ms, vs,
                      bias_corrections(t), 1e-3)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6)


def test_twenty_steps_match_reference_train_epoch(blocks):
    """20 minibatch steps of the reference's ``_train_epoch`` (its perm,
    its per-step keys) against the port's ``Trainer`` on the same rows
    and noise."""
    X, _ = blocks
    B, steps = 64, 20
    ref, _ = _ref_params(0)
    perm = np.random.default_rng(4).integers(0, N, steps * B).astype(
        np.int32)
    key = jax.random.PRNGKey(7)
    oh = np.zeros((N, 0), np.float32)
    tx = optax.adam(1e-3)
    want, _, loss = R._train_epoch(ref, tx.init(ref), jnp.asarray(X),
                                   jnp.asarray(oh), jnp.asarray(perm), key,
                                   jnp.float32(0.5), n_steps=steps,
                                   batch_size=B)
    noise = _ref_epoch_noise_from(key, steps, B)
    model = scvi_params_from_numpy(_tree_np(ref))
    trainer = P.Trainer(model)
    Xt, oht = torch.from_numpy(X), torch.from_numpy(oh)
    losses = []
    for i in range(steps):
        rows = torch.from_numpy(perm[i * B:(i + 1) * B].astype(np.int64))
        losses.append(trainer.step(P.elbo, [Xt[rows], oht[rows]], noise[i],
                                   0.5, bias_corrections(i + 1)))
    np.testing.assert_allclose(torch.stack(losses).mean().item(),
                               float(loss), rtol=1e-5)
    _close_trees(model.tree(), _tree_np(want), STATE_TOL)


def _ref_epoch_noise_from(key, n_steps, rows):
    """``_train_epoch``'s noise when it is given ``key`` itself."""
    steps = []
    for _ in range(n_steps):
        key, ks = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(ks, (rows, L))))
    return torch.from_numpy(np.stack(steps))


# ------------------------------------------------------------ the ops


@pytest.fixture
def carried(monkeypatch):
    """Patch the port's initial weights and epoch noise with the
    reference's; returns a setter taking (params, noise list)."""
    def use(ref_params, noise):
        it = iter(noise)
        monkeypatch.setattr(P, "initial_model", lambda *a, **k:
                            scvi_params_from_numpy(_tree_np(ref_params)))
        monkeypatch.setattr(P, "epoch_noise", lambda *a, **k: next(it))
    return use


def test_scvi_op_matches_reference(blocks, carried):
    """``model.scvi`` over 3 epochs (3 steps each), a batch covariate,
    the normalised expression kept: the reference's X_scvi, dispersion,
    ELBO history and scvi_normalized."""
    X, _ = blocks
    batch = np.where(np.arange(N) % 3 == 0, "a", "b")
    kw = dict(n_latent=L, n_hidden=H, epochs=3, batch_size=128, seed=4,
              batch_key="sample", store_normalized=True)
    ref_in = RefCellData(X).with_obs(sample=batch)
    want = sct.apply("model.scvi", ref_in, backend="cpu", **kw)
    params, key = _ref_params(4, n_batches=2)
    carried(params, _ref_epoch_noise(key, 3, 3, 128))
    got = sctt.apply("model.scvi", sctt.CellData(X).with_obs(sample=batch),
                     device="cpu", **kw)
    np.testing.assert_allclose(got.uns["scvi_elbo_history"],
                               want.uns["scvi_elbo_history"], rtol=1e-5)
    for a, b in ((got.obsm["X_scvi"], want.obsm["X_scvi"]),
                 (got.var["scvi_dispersion"], want.var["scvi_dispersion"]),
                 (got.layers["scvi_normalized"],
                  want.layers["scvi_normalized"])):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= STATE_TOL * np.abs(b).max()


@pytest.mark.parametrize("classifier_only", [False, True])
def test_scanvi_op_matches_reference(blocks, carried, classifier_only):
    """``model.scanvi`` over 2 epochs with 30 % of the cells labelled:
    the reference's X_scanvi, predictions, confidences, history, class
    profiles and scanvi_normalized."""
    X, truth = blocks
    labels = _labels(truth)
    kw = dict(n_latent=L, n_hidden=H, epochs=2, batch_size=128, seed=1,
              classifier_only=classifier_only, store_normalized=True)
    want = sct.apply("model.scanvi", RefCellData(X).with_obs(
        cell_type=labels), backend="cpu", **kw)
    params, key = _ref_params(1, n_classes=3,
                              y_decoder=not classifier_only)
    carried(params, _ref_epoch_noise(key, 2, 3, 128))
    got = sctt.apply("model.scanvi", sctt.CellData(X).with_obs(
        cell_type=labels), device="cpu", **kw)
    np.testing.assert_allclose(got.uns["scanvi_elbo_history"],
                               want.uns["scanvi_elbo_history"], rtol=1e-5)
    np.testing.assert_array_equal(got.obs["scanvi_prediction"],
                                  np.asarray(want.obs["scanvi_prediction"]))
    pairs = [(got.obsm["X_scanvi"], want.obsm["X_scanvi"]),
             (got.obs["scanvi_confidence"], want.obs["scanvi_confidence"]),
             (got.layers["scanvi_normalized"],
              want.layers["scanvi_normalized"])]
    if classifier_only:
        assert "scanvi_class_profiles" not in got.uns
    else:
        pairs.append((got.uns["scanvi_class_profiles"],
                      want.uns["scanvi_class_profiles"]))
    for a, b in pairs:
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= STATE_TOL * np.abs(b).max()


def test_data_parallel_step_equals_one_device_step(blocks):
    """One step over a 4-shard CPU mesh (each shard its own 32 rows and
    noise, the gradients added in mesh order and divided by 4) against
    one step on the concatenated 128 rows: the same parameters within
    1e-6 of their scale, and equal on every replica."""
    X, _ = blocks
    gen = torch.Generator().manual_seed(0)
    model = P.initial_model(gen, G, 0, L, H)
    one = P.Trainer(P.SCVIModel.from_tree(model.tree()))
    mesh = make_mesh(devices=["cpu"] * 4)
    dp = P.Trainer(P.SCVIModel.from_tree(model.tree()), mesh.devices)
    rows = torch.from_numpy(np.random.default_rng(5).permutation(N)[:128])
    eps = torch.randn((128, L), generator=gen)
    Xt, oh = torch.from_numpy(X), torch.zeros((N, 0))
    l1 = one.step(P.elbo, [Xt[rows], oh[rows]], eps, 1.0,
                  bias_corrections(1))
    parts = rows.reshape(4, 32)
    ld = dp.mesh_step(P.elbo, [[Xt[r], oh[r]] for r in parts],
                      list(eps.reshape(4, 32, L)), 1.0, bias_corrections(1))
    np.testing.assert_allclose(ld.item(), l1.item(), rtol=1e-6)
    _close_trees(dp.model.tree(), one.model.tree(), 1e-6)
    for rep in dp.replicas[1:]:
        for a, b in zip(rep.parameters(), dp.model.parameters()):
            assert torch.equal(a, b)


def test_scvi_trains_over_a_cpu_mesh(blocks):
    """``n_devices=4`` on a CPU device: 4 CPU shards, the reference's
    per-device row draws; the ELBO falls and the outputs are finite."""
    X, _ = blocks
    out = sctt.apply("model.scvi", sctt.CellData(X), device="cpu",
                     n_latent=L, n_hidden=H, epochs=3, batch_size=128,
                     n_devices=4)
    h = out.uns["scvi_elbo_history"]
    assert len(h) == 3 and h[-1] < h[0]
    assert torch.isfinite(out.obsm["X_scvi"]).all()


# ------------------------------------------------------- the artifact


def test_artifact_loads_across_packages(blocks, tmp_path):
    """A file the port writes loads in the reference, and one the
    reference writes loads in the port, bit for bit (scANVI's shape:
    classifier head and class anchors)."""
    ref, _ = _ref_params(2, n_batches=1, n_classes=3, y_decoder=True)
    model = scvi_params_from_numpy(_tree_np(ref))
    p1 = str(tmp_path / "port.npz")
    P.save_model(model, p1, meta={"n_genes": G})
    got, meta = R.load_model(p1)
    assert int(meta["n_genes"]) == G
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(_tree_np(got)),
            jax.tree_util.tree_leaves_with_path(_tree_np(ref))):
        assert pa == pb and np.array_equal(a, b)
    p2 = str(tmp_path / "ref.npz")
    R.save_model(ref, p2, meta={"n_latent": L})
    tree, meta = P.load_model(p2)
    assert int(meta["n_latent"]) == L
    back = P.SCVIModel.from_tree(tree)
    for a, b in zip(back.parameters(), model.parameters()):
        assert torch.equal(a, b)
    assert P.flatten_params(back).keys() == R.flatten_params(ref).keys()


def test_scvi_op_saves_a_model_that_reloads(blocks, tmp_path):
    X, _ = blocks
    path = str(tmp_path / "m.npz")
    out = sctt.apply("model.scvi", sctt.CellData(X), device="cpu",
                     n_latent=L, n_hidden=H, epochs=1, batch_size=128,
                     save_model_path=path)
    tree, meta = P.load_model(path)
    model = P.SCVIModel.from_tree(tree)
    with torch.no_grad():
        z = P.encode(model, torch.from_numpy(X), torch.zeros((N, 0)))
    assert torch.equal(z, out.obsm["X_scvi"])
    assert int(meta["n_genes"]) == G and int(meta["seed"]) == 0


# ------------------------------------------------------- validation


def test_scanvi_validates():
    X, _ = _poisson_blocks(n=100, g=50, seed=7)
    d = sctt.CellData(X)
    with pytest.raises(KeyError, match="cell_type"):
        sctt.apply("model.scanvi", d, device="cpu", epochs=1)
    one = d.with_obs(cell_type=np.array(["a"] * 100))
    with pytest.raises(ValueError, match=">=2"):
        sctt.apply("model.scanvi", one, device="cpu", epochs=1)
    with pytest.raises(KeyError, match="sample"):
        sctt.apply("model.scvi", d, device="cpu", epochs=1,
                   batch_key="sample")
