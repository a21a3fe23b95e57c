"""``model.scvi`` and ``model.scanvi``: the negative-binomial VAE of raw
counts (scVI) and its semi-supervised form (scANVI), trained on the
card.

Counterpart of ``sctools_tpu/models/scvi.py``, with its generative model

    z ~ N(0, I)                        (n_latent)
    rho = softmax(decoder(z, batch))   (expression fractions)
    x_g ~ NB(mean = l * rho_g, inverse dispersion theta_g)

(l the cell's observed library size), its objectives, its Adam, its
minibatch order, its outputs and its artifact on disk.

* The model is ``nn.Module``s (:class:`SCVIModel`: the encoder and
  decoder MLPs and ``log_theta``; scANVI's ``clf`` head and
  ``prior_mu``).  The objective is plain functions on tensors
  (:func:`nb_logpmf` … :func:`elbo`, :func:`semi_elbo`,
  :func:`semi_elbo_y`), whose gradients ``torch.autograd`` takes.  The
  dense products are ``nn.Linear`` in true float32 (TF32 off), as the
  reference's CPU computes them: no Pallas kernel is on the reference's
  path, so none is ported.
* Randomness.  The minibatch order is the reference's numpy draws
  (``default_rng(seed)``: ``permutation`` on one device, ``integers``
  per device on a mesh), so the port visits the rows the reference
  visits.  The initial weights and each epoch's reparameterisation noise
  come from one seeded CPU ``torch.Generator`` (:func:`initial_model`,
  :func:`epoch_noise`), not from ``jax.random``: they are drawn on the
  host and copied to the device in one transfer, so the card and the
  CPU see the same draws.  Streamed training (``models/train_stream.py``)
  draws each shard's noise from :func:`shard_noise`, seeded by a pure
  function of (seed, epoch, position).  Tests carry the reference's
  draws in by patching those functions.
* An epoch's steps run with no host sync; the loss is read once an
  epoch (once a shard in streamed training, :class:`ShardSteps`).
* ``n_devices > 1`` trains data-parallel on the port's ``Mesh``: the
  rows wrap-padded and split, each device drawing its own rows and
  noise, the per-device gradients added in mesh order
  (``data.sharded.reduce_sum``) and divided by the device count (the
  reference's ``pmean``), and one Adam step copied to every replica, so
  the parameters stay equal on every device.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sharded import reduce_sum
from ..data.sparse import SparseCells
from ..registry import register
from ..utils.optim import adam_step_all, bias_corrections

#: identity fingerprint of the on-disk parameter artifact, the
#: reference's: a file written by either package loads in the other
MODEL_FINGERPRINT = "scvi-model-v1"
_LR = 1e-3  # optax.adam(1e-3)


# ----------------------------------------------------------------------
# the artifact
# ----------------------------------------------------------------------


def flatten_params(params, prefix: str = "param") -> dict:
    """Flatten a parameter tree (nested dicts and lists of arrays, or an
    :class:`SCVIModel`, taken as its :meth:`SCVIModel.tree`) into
    ``{"<prefix>/enc/000/w": ndarray, ...}``: the reference's key
    layout, dict keys sorted, list items numbered ``%03d``."""
    if isinstance(params, SCVIModel):
        params = params.tree()
    out: dict = {}

    def rec(v, key):
        if isinstance(v, dict):
            for k in sorted(v):
                rec(v[k], f"{key}/{k}")
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                rec(x, f"{key}/{i:03d}")
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)

    rec(params, prefix)
    return out


def unflatten_params(arrays: dict, prefix: str = "param") -> dict:
    """The tree :func:`flatten_params` encoded, as numpy arrays: all-
    numeric key segments become list indices, the rest dict keys."""
    root: dict = {}
    for key in arrays:
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arrays[key]

    def build(node):
        if not isinstance(node, dict):
            return np.asarray(node)
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [build(node[k]) for k in sorted(keys, key=int)]
        return {k: build(node[k]) for k in sorted(keys)}

    if not root:
        raise ValueError(
            f"unflatten_params: no {prefix!r}-prefixed keys — not a "
            f"flatten_params() encoding")
    return build(root)


def save_model(params, path: str, *, meta: dict | None = None) -> str:
    """Write a trained model (or its tree) as a verified,
    generation-rotated artifact: :func:`flatten_params` keys plus
    ``meta/<k>`` scalars, through ``checkpoint.save_npz_generations``
    (content digest, :data:`MODEL_FINGERPRINT`, atomic rename, the
    previous generation kept as ``.prev``).  Returns the digest."""
    from ..utils.checkpoint import save_npz_generations

    arrays = flatten_params(params)
    for k, v in (meta or {}).items():
        arrays[f"meta/{k}"] = np.asarray(v)
    return save_npz_generations(path, fingerprint=MODEL_FINGERPRINT,
                                **arrays)


def load_model(path: str):
    """Verify, then load a :func:`save_model` artifact (of either
    package): ``(tree, meta)``, the tree as numpy arrays
    (:meth:`SCVIModel.from_tree` builds the module).  Any damage raises
    ``checkpoint.CheckpointCorruptError``."""
    from ..utils.checkpoint import load_npz_verified

    arrays = load_npz_verified(path, expect_fingerprint=MODEL_FINGERPRINT,
                               require_digest=True)
    meta = {k[len("meta/"):]: arrays[k]
            for k in arrays if k.startswith("meta/")}
    return unflatten_params(arrays), meta


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------


class MLP(nn.Module):
    """``nn.Linear`` layers of ``sizes`` with ReLU between them, the
    last layer linear.  Built without drawing an initialisation (the
    weights are set by :func:`initial_model` or a tree)."""

    def __init__(self, sizes):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b)
            for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        for i, lyr in enumerate(self.layers):
            x = lyr(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class SCVIModel(nn.Module):
    """The encoder (n_genes + n_batches → n_hidden → 2·n_latent), the
    decoder (n_latent [+ n_classes] + n_batches → n_hidden → n_genes)
    and ``log_theta`` (n_genes); with ``n_classes`` the classifier head
    ``clf`` (n_latent → n_hidden // 2 → n_classes), and with
    ``y_decoder`` (scANVI's default model) the class one-hot in the
    decoder's input and the class anchors ``prior_mu`` (n_classes,
    n_latent)."""

    def __init__(self, n_genes: int, n_batches: int, n_latent: int = 10,
                 n_hidden: int = 128, n_classes: int = 0,
                 y_decoder: bool = False):
        super().__init__()
        c_in = n_classes if y_decoder else 0
        self.enc = MLP((n_genes + n_batches, n_hidden, 2 * n_latent))
        self.dec = MLP((n_latent + c_in + n_batches, n_hidden, n_genes))
        self.log_theta = nn.Parameter(torch.full((n_genes,), 2.0))
        self.clf = (MLP((n_latent, n_hidden // 2, n_classes))
                    if n_classes else None)
        self.prior_mu = (nn.Parameter(torch.zeros((n_classes, n_latent)))
                         if y_decoder else None)

    def tree(self) -> dict:
        """The reference's parameter tree, as numpy arrays: each layer
        ``{"w": (in, out), "b": (out,)}`` — ``w`` is the transpose of
        ``nn.Linear.weight`` (out, in)."""
        def mlp(m):
            return [{"w": lyr.weight.detach().cpu().numpy().T.copy(),
                     "b": lyr.bias.detach().cpu().numpy().copy()}
                    for lyr in m.layers]

        out = {"enc": mlp(self.enc), "dec": mlp(self.dec),
               "log_theta": self.log_theta.detach().cpu().numpy().copy()}
        if self.clf is not None:
            out["clf"] = mlp(self.clf)
        if self.prior_mu is not None:
            out["prior_mu"] = self.prior_mu.detach().cpu().numpy().copy()
        return out

    @classmethod
    def from_tree(cls, tree, device="cpu") -> "SCVIModel":
        """The module holding ``tree`` (the reference's layout: a
        :func:`unflatten_params` result or its pytree as numpy), sizes
        read from the shapes; each ``w`` (in, out) is transposed into
        ``nn.Linear.weight`` (out, in)."""
        enc, dec = tree["enc"], tree["dec"]
        n_genes = np.shape(tree["log_theta"])[0]
        n_hidden = np.shape(enc[0]["w"])[1]
        n_latent = np.shape(enc[-1]["w"])[1] // 2
        n_batches = np.shape(enc[0]["w"])[0] - n_genes
        n_classes = np.shape(tree["clf"][-1]["w"])[1] if "clf" in tree \
            else 0
        model = cls(n_genes, n_batches, n_latent, n_hidden, n_classes,
                    y_decoder="prior_mu" in tree)
        with torch.no_grad():
            for name in ("enc", "dec", "clf"):
                if name not in tree:
                    continue
                for lyr, p in zip(getattr(model, name).layers, tree[name]):
                    lyr.weight.copy_(torch.tensor(
                        np.asarray(p["w"], np.float32)).T)
                    lyr.bias.copy_(torch.tensor(
                        np.asarray(p["b"], np.float32)))
            model.log_theta.copy_(torch.tensor(
                np.asarray(tree["log_theta"], np.float32)))
            if model.prior_mu is not None:
                model.prior_mu.copy_(torch.tensor(
                    np.asarray(tree["prior_mu"], np.float32)))
        return model.to(device)


def initial_model(gen: torch.Generator, n_genes: int, n_batches: int,
                  n_latent: int, n_hidden: int, n_classes: int = 0,
                  y_decoder: bool = False) -> SCVIModel:
    """The model's start on the CPU, drawn from ``gen``: each weight He
    normal (``N(0, 1) · √(2 / fan_in)``), in the order encoder, decoder,
    classifier, layer by layer; biases and ``prior_mu`` zero,
    ``log_theta`` 2.0 (``sctools_tpu/models/scvi.py:142-172``)."""
    model = SCVIModel(n_genes, n_batches, n_latent, n_hidden, n_classes,
                      y_decoder)
    with torch.no_grad():
        for m in (model.enc, model.dec, model.clf):
            if m is None:
                continue
            for lyr in m.layers:
                fan_in = lyr.in_features
                w = torch.randn((fan_in, lyr.out_features), generator=gen)
                lyr.weight.copy_((w * math.sqrt(2.0 / fan_in)).T)
                lyr.bias.zero_()
    return model


def epoch_noise(gen: torch.Generator, n_steps: int, rows: int,
                n_latent: int) -> torch.Tensor:
    """An epoch's reparameterisation noise, N(0, 1) of shape (n_steps,
    rows, n_latent), drawn on the CPU from ``gen``."""
    return torch.randn((n_steps, rows, n_latent), generator=gen)


def shard_noise(seed: int, epoch: int, pos: int, n_steps: int, rows: int,
                n_latent: int) -> torch.Tensor:
    """The reparameterisation noise of the shard at position ``pos`` of
    ``epoch`` in streamed training, N(0, 1) of shape (n_steps, rows,
    n_latent), drawn on the CPU from a generator seeded by a pure
    function of (seed, epoch, pos): a resumed run draws what the
    uninterrupted run drew there."""
    state = np.random.SeedSequence(
        [int(seed) & 0x7FFFFFFF, int(epoch), int(pos), 0x5CA1E]
    ).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state))
    return torch.randn((n_steps, rows, n_latent), generator=gen)


# ----------------------------------------------------------------------
# the objective
# ----------------------------------------------------------------------


def nb_logpmf(x, mean, theta):
    """Negative binomial log-pmf, mean / inverse-dispersion form."""
    eps = 1e-8
    log_theta_mu = torch.log(theta + mean + eps)
    return (torch.lgamma(x + theta)
            - torch.lgamma(theta)
            - torch.lgamma(x + 1.0)
            + theta * (torch.log(theta + eps) - log_theta_mu)
            + x * (torch.log(mean + eps) - log_theta_mu))


def enc_input(x, batch_oh):
    """The encoder's input: library-normalised ``log1p`` counts (at
    1e4; the library is the decoder's observed offset) and the batch
    one-hot."""
    lib = x.sum(dim=1, keepdim=True)
    # a true division, as the reference's (a Python scalar over a tensor
    # would be a reciprocal times the scalar)
    scale = torch.full_like(lib, 1e4) / torch.clamp(lib, min=1.0)
    return torch.cat([torch.log1p(x * scale), batch_oh], dim=1)


def enc_z(model, x, batch_oh, eps):
    """The encoder: ``(z, mu, logvar)``, logvar clipped to ±10 and ``z
    = mu + exp(logvar / 2) · eps`` for the given noise ``eps``."""
    mu, logvar = model.enc(enc_input(x, batch_oh)).chunk(2, dim=1)
    logvar = torch.clamp(logvar, -10.0, 10.0)
    return mu + torch.exp(0.5 * logvar) * eps, mu, logvar


def kl_gauss(mu, logvar, prior_mu=0.0):
    """KL(N(mu, e^logvar) ‖ N(prior_mu, I)), summed over the last axis."""
    return 0.5 * torch.sum(torch.exp(logvar) + (mu - prior_mu) ** 2
                           - 1.0 - logvar, dim=-1)


def nb_ll(model, x, lib, dec_in):
    """NB log-likelihood of the counts ``x`` given decoder inputs
    (any leading axes before the cell's), summed over the genes."""
    rho = torch.softmax(model.dec(dec_in), dim=-1)
    theta = torch.exp(torch.clamp(model.log_theta, -10.0, 10.0))
    return torch.sum(nb_logpmf(x, lib * rho, theta), dim=-1)


def vae_terms(model, x, batch_oh, eps):
    """Per cell: (log-likelihood, KL, sampled z)."""
    lib = x.sum(dim=1, keepdim=True)
    z, mu, logvar = enc_z(model, x, batch_oh, eps)
    ll = nb_ll(model, x, lib, torch.cat([z, batch_oh], dim=1))
    return ll, kl_gauss(mu, logvar), z


def elbo(model, x, batch_oh, eps, kl_weight=1.0):
    """The mean per-cell negative ELBO of a (B, G) count slab."""
    ll, kl, _ = vae_terms(model, x, batch_oh, eps)
    return -torch.mean(ll - kl_weight * kl)


def _label_ce(logq, y, has_label):
    """The labelled cells' cross-entropies (0 elsewhere) and their
    count (at least 1)."""
    ce = -logq.gather(1, y[:, None])[:, 0]
    ce = torch.where(has_label > 0, ce, 0.0)
    return ce, torch.clamp(has_label.sum(), min=1.0)


def semi_elbo(model, x, batch_oh, y, has_label, eps, kl_weight=1.0,
              alpha=50.0):
    """scANVI's ``classifier_only`` objective: the negative ELBO plus
    alpha × the labelled cells' mean cross-entropy of the classifier on
    z; the decoder does not see y."""
    ll, kl, z = vae_terms(model, x, batch_oh, eps)
    ce, n_lab = _label_ce(torch.log_softmax(model.clf(z), dim=1), y,
                          has_label)
    return -torch.mean(ll - kl_weight * kl) + alpha * ce.sum() / n_lab


def semi_elbo_y(model, x, batch_oh, y, has_label, eps, kl_weight=1.0,
                alpha=50.0):
    """scANVI's default objective: the decoder sees the class one-hot and
    the prior is N(prior_mu[y], I).  Labelled cells take their y;
    unlabelled ones marginalise the reconstruction and the KL over
    q(y | z) and add its entropy; plus alpha × the labelled cells' mean
    cross-entropy.  The C classes' decoder passes are one batched pass
    over a (C, B, ·) input; the sums over the classes run over that
    axis in class order."""
    lib = x.sum(dim=1, keepdim=True)
    z, mu, logvar = enc_z(model, x, batch_oh, eps)
    logq = torch.log_softmax(model.clf(z), dim=1)
    B, C = logq.shape
    eye = torch.eye(C, dtype=z.dtype, device=z.device)
    dec_in = torch.cat([z.expand(C, B, z.shape[1]),
                        eye[:, None, :].expand(C, B, C),
                        batch_oh.expand(C, B, batch_oh.shape[1])], dim=2)
    ll_all = nb_ll(model, x, lib, dec_in)  # (C, B)
    kl_all = kl_gauss(mu[None], logvar[None], model.prior_mu[:, None, :])
    elbo_all = ll_all - kl_weight * kl_all
    elbo_obs = elbo_all.gather(0, y[None, :])[0]
    q = torch.exp(logq)
    elbo_marg = torch.sum(q * elbo_all.T, dim=1)
    ent = -torch.sum(q * logq, dim=1)
    per_cell = torch.where(has_label > 0, -elbo_obs, -(elbo_marg + ent))
    ce, n_lab = _label_ce(logq, y, has_label)
    return torch.mean(per_cell) + alpha * ce.sum() / n_lab


def encode(model, x, batch_oh):
    """The posterior mean latent."""
    return model.enc(enc_input(x, batch_oh)).chunk(2, dim=1)[0]


def decode_rho(model, z, batch_oh):
    """The decoded expression fractions (scVI's normalised expression)."""
    return torch.softmax(model.dec(torch.cat([z, batch_oh], dim=1)), dim=1)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------


class Trainer:
    """``model``'s parameters and their Adam moments; :meth:`step`
    takes one ``optax.adam(1e-3)`` step of ``loss(model, *batch, eps,
    kl_weight)`` on one device, :meth:`mesh_step` on every device of a
    mesh, each replica on its device (``replicas[0]`` is ``model``).
    Each step takes its Adam bias corrections ``corr``
    (``utils.optim.bias_corrections`` of its step number, or 0-dim
    tensors holding them, which a recorded graph reads from device
    memory)."""

    def __init__(self, model: SCVIModel, devices=None):
        self.model = model
        devices = list(devices or [])
        self.replicas = [model] + [copy.deepcopy(model).to(d)
                                   for d in devices[1:]]
        self.params = [list(m.parameters()) for m in self.replicas]
        self.m = [torch.zeros_like(p) for p in self.params[0]]
        self.v = [torch.zeros_like(p) for p in self.params[0]]

    def _update(self, grads, corr) -> None:
        with torch.no_grad():
            adam_step_all(self.params[0], list(grads), self.m, self.v,
                          corr, _LR)
            for ps in self.params[1:]:
                torch._foreach_copy_(ps, [p.to(q.device) for p, q in
                                          zip(self.params[0], ps)])

    def step(self, loss, batch, eps, kl_weight, corr) -> torch.Tensor:
        """One step on ``batch`` (the minibatch's tensors) and noise
        ``eps``; returns the loss (on the device, not synced)."""
        value = loss(self.model, *batch, eps, kl_weight)
        self._update(torch.autograd.grad(value, self.params[0]), corr)
        return value.detach()

    def mesh_step(self, loss, batches, eps, kl_weight,
                  corr) -> torch.Tensor:
        """One data-parallel step: replica j's loss and gradients on
        ``batches[j]`` and ``eps[j]``, the gradients added in mesh order
        and divided by the device count on ``replicas[0]``'s device, one
        Adam step there, copied to every replica.  Returns the mean
        loss."""
        dev = self.params[0][0].device
        values, grads = [], []
        for rep, ps, b, e in zip(self.replicas, self.params, batches, eps):
            value = loss(rep, *b, e, kl_weight)
            grads.append(torch.autograd.grad(value, ps))
            values.append(value.detach())
        nd = len(self.replicas)
        self._update([reduce_sum(list(g), dev) / nd for g in zip(*grads)],
                     corr)
        return reduce_sum(values, dev) / nd


class _Epochs:
    """The steps of an epoch over device buffers that each epoch fills:
    its rows (n_steps, rows) and noise (n_steps, rows, n_latent), its KL
    weight, each step's Adam bias corrections; each step's loss lands in
    a buffer.  On a CPU the steps run as they are.  On a card they are
    recorded once as a CUDA graph and replayed each epoch: one launch
    for the ~150 kernels a step, whose dispatch from the host, not the
    card, bounds an eager step at 512 cells.  The first epoch runs
    eagerly on a side stream, which warms the libraries before the
    recording.  A mesh of several cards runs eagerly.  ``shards`` holds
    each device's columns (counts, one-hot, extras); each step's rows
    are split over the devices in mesh order."""

    def __init__(self, trainer: Trainer, loss, shards, n_steps: int,
                 rows: int, n_latent: int, dev):
        self.trainer, self.loss, self.shards = trainer, loss, shards
        self.n_steps, self.dev = n_steps, dev
        self.perm = torch.zeros((n_steps, rows), dtype=torch.int64,
                                device=dev)
        self.eps = torch.zeros((n_steps, rows, n_latent), device=dev)
        self.corr = torch.ones((n_steps, 2), device=dev)
        self.klw = torch.zeros((), device=dev)
        self.loss_buf = torch.zeros((n_steps,), device=dev)
        # recorded only when every shard lies on ``dev``: a graph holds
        # one device's work
        self.graphed = dev.type == "cuda" and all(
            c.device == dev for shard in shards for c in shard)
        self.graph = None
        self.done = 0  # epochs run

    def _steps(self) -> None:
        nd = len(self.shards)
        b = self.perm.shape[1] // nd
        for i in range(self.n_steps):
            corr = (self.corr[i, 0], self.corr[i, 1])
            if nd == 1:
                rows = self.perm[i]
                value = self.trainer.step(
                    self.loss, [c.index_select(0, rows)
                                for c in self.shards[0]],
                    self.eps[i], self.klw, corr)
            else:
                batches = [[c.index_select(0, self.perm[i, j * b:(j + 1) * b]
                                           .to(c.device)) for c in shard]
                           for j, shard in enumerate(self.shards)]
                eps = [self.eps[i, j * b:(j + 1) * b].to(shard[0].device)
                       for j, shard in enumerate(self.shards)]
                value = self.trainer.mesh_step(self.loss, batches, eps,
                                               self.klw, corr)
            self.loss_buf[i].copy_(value)

    def run(self, perm, eps, klw: float, t0: int) -> float:
        """One epoch: ``perm`` and ``eps`` (host tensors), the KL weight,
        ``t0`` Adam steps before it.  Returns the mean loss (one read)."""
        corr = torch.tensor([bias_corrections(t0 + i + 1)
                             for i in range(self.n_steps)])
        for buf, v in ((self.perm, perm), (self.eps, eps),
                       (self.corr, corr)):
            buf.copy_(v, non_blocking=True)
        self.klw.fill_(klw)
        if not self.graphed:
            self._steps()
        elif self.done == 0:
            side = torch.cuda.Stream(self.dev)
            side.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(side):
                self._steps()
            torch.cuda.current_stream(self.dev).wait_stream(side)
        else:
            if self.graph is None:
                self.graph = torch.cuda.CUDAGraph()
                # thread-local: in streamed training the prefetch worker
                # pins and copies the next shard during a recording
                with torch.cuda.graph(self.graph,
                                      capture_error_mode="thread_local"):
                    self._steps()
            self.graph.replay()
        self.done += 1
        return float(self.loss_buf.mean())


class ShardSteps:
    """The steps of streamed training (``models/train_stream.py``),
    one shard at a time, over shards that change every call.  Each
    shard is copied into a feed buffer of its shape, one buffer and one
    :class:`_Epochs` a (rows, steps, batch) shape, and the steps read
    only the buffer: on a card a shape's first shard runs eagerly, its
    second is recorded as a CUDA graph, and every later one replays it,
    so a shape seen once (the short last shard of a one-epoch run)
    never pays for a recording."""

    def __init__(self, trainer: Trainer, loss, n_latent: int):
        self.trainer, self.loss, self.n_latent = trainer, loss, n_latent
        self._shapes: dict = {}  # (rows, n_steps, batch) -> (feed, _Epochs)

    def run(self, X: torch.Tensor, perm, eps, klw: float, t0: int) -> float:
        """Train on the dense shard ``X`` (rows, G) on the device: the
        steps' rows ``perm`` (n_steps, batch) and noise ``eps`` (host
        tensors), the KL weight, ``t0`` Adam steps before.  Returns the
        shard's mean loss."""
        key = (X.shape[0], perm.shape[0], perm.shape[1])
        if key not in self._shapes:
            # X's own device (cuda:0, not "cuda"): _Epochs records a graph
            # only when every buffer lies on the device it is given
            feed = torch.empty_like(X)
            oh = torch.zeros((X.shape[0], 0), device=X.device)
            self._shapes[key] = (feed, _Epochs(
                self.trainer, self.loss, [[feed, oh]], perm.shape[0],
                perm.shape[1], self.n_latent, X.device))
        feed, epochs = self._shapes[key]
        feed.copy_(X)
        return epochs.run(perm, eps, klw, t0)


def _train(model: SCVIModel, X, oh, extras, loss, *, epochs: int,
           batch_size: int, seed: int, kl_warmup: int,
           gen: torch.Generator, n_latent: int, mesh=None) -> list:
    """Train ``model`` in place on the (n, G) counts ``X``, batch
    one-hot ``oh`` and per-cell ``extras`` (scANVI's labels and label
    mask), the reference's schedule: ``min(batch_size, n)`` rows a step
    (a multiple of the device count on a mesh), ``max(n // batch_size,
    1)`` steps an epoch, the KL weight ``min(1, (epoch + 1) /
    kl_warmup)``.  Returns the mean loss of each epoch."""
    n, dev = X.shape[0], X.device
    batch_size = min(batch_size, n)
    nd = mesh.size if mesh is not None else 1
    batch_size = max(batch_size // nd, 1) * nd
    n_steps = max(n // batch_size, 1)
    rng = np.random.default_rng(seed)
    cols = (X, oh, *extras)
    if mesh is None:
        trainer, shards = Trainer(model), [cols]
    else:
        # wrap-pad, so that every device's shard holds real cells
        n_local = -(-n // nd)
        pad = torch.from_numpy(np.arange(n_local * nd - n) % n).to(dev)
        padded = [torch.cat([c, c[pad]]) for c in cols]
        shards = [[c[j * n_local:(j + 1) * n_local].to(d) for c in padded]
                  for j, d in enumerate(mesh.devices)]
        trainer = Trainer(model, mesh.devices)
    epochs_run = _Epochs(trainer, loss, shards, n_steps, batch_size,
                         n_latent, dev)
    history = []
    for ep in range(epochs):
        if mesh is None:
            perm = rng.permutation(n)[:n_steps * batch_size]
        else:
            # each device's local rows, device blocks side by side
            perm = rng.integers(0, n_local, size=(n_steps, batch_size))
        perm = torch.from_numpy(perm.astype(np.int64).reshape(n_steps, -1))
        eps = epoch_noise(gen, n_steps, batch_size, n_latent)
        history.append(epochs_run.run(
            perm, eps, min(1.0, (ep + 1) / max(kl_warmup, 1)),
            ep * n_steps))
    return history


def _counts_dense(data: CellData, dev) -> torch.Tensor:
    """Raw counts as a dense (n, G) float32 tensor on ``dev``:
    ``layers["counts"]`` when the pipeline kept them, else X."""
    M = data.layers.get("counts", data.X)
    n = data.n_cells
    if isinstance(M, SparseCells):
        return M.to(dev).to_dense()[:n].float()
    if hasattr(M, "toarray"):
        return torch.from_numpy(np.asarray(M.toarray(), np.float32)).to(dev)
    if isinstance(M, torch.Tensor):
        return M[:n].to(dev, torch.float32)
    return torch.from_numpy(np.asarray(M, np.float32)[:n]).to(dev)


def _host_values(v, n: int) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v)[:n]


def _batch_onehot(data: CellData, batch_key, n: int, opname: str,
                  dev) -> torch.Tensor:
    """(n, n_batches) one-hot of ``obs[batch_key]``; (n, 0) when None."""
    if batch_key is None:
        return torch.zeros((n, 0), dtype=torch.float32, device=dev)
    if batch_key not in data.obs:
        raise KeyError(f"{opname}: obs has no {batch_key!r}")
    levels, codes = np.unique(_host_values(data.obs[batch_key], n),
                              return_inverse=True)
    return torch.nn.functional.one_hot(
        torch.from_numpy(codes.reshape(-1)), len(levels)).float().to(dev)


def _mesh_for(n_devices, mesh, dev):
    """The data-parallel mesh: ``mesh`` when given; else, for
    ``n_devices > 1``, that many CPU shards on a CPU ``device`` and the
    first ``n_devices`` cards otherwise; else none."""
    if mesh is not None:
        return mesh
    if n_devices is None or n_devices <= 1:
        return None
    from ..parallel.mesh import make_mesh

    return (make_mesh(devices=["cpu"] * n_devices) if dev.type == "cpu"
            else make_mesh(n_devices))


@register("model.scvi")
def scvi(data: CellData, n_latent: int = 10, n_hidden: int = 128,
         epochs: int = 40, batch_size: int = 512,
         batch_key: str | None = None, seed: int = 0,
         kl_warmup: int = 10, n_devices: int | None = None,
         store_normalized: bool = False,
         save_model_path: str | None = None, mesh=None,
         device=None) -> CellData:
    """Train the NB-VAE on the raw counts (``layers["counts"]`` or X)
    and embed every cell.  Adds obsm ``X_scvi`` (the posterior mean
    latent), var ``scvi_dispersion`` (theta) and uns
    ``scvi_elbo_history`` (the negative ELBO of each epoch); with
    ``store_normalized`` layers ``scvi_normalized`` (n, G) dense; with
    ``save_model_path`` the trained parameters as a verified artifact
    (:func:`save_model`).  ``n_devices > 1`` (or ``mesh=``) trains
    data-parallel (module docstring).  Runs on ``device`` (``None``: the
    card, raising without one)."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    mesh = _mesh_for(n_devices, mesh, dev)
    n = data.n_cells
    X = _counts_dense(data, dev)
    oh = _batch_onehot(data, batch_key, n, "model.scvi", dev)
    gen = torch.Generator().manual_seed(seed)
    model = initial_model(gen, data.n_genes, oh.shape[1], n_latent,
                          n_hidden).to(dev)
    with true_f32():
        history = _train(model, X, oh, (), elbo, epochs=epochs,
                         batch_size=batch_size, seed=seed,
                         kl_warmup=kl_warmup, gen=gen, n_latent=n_latent,
                         mesh=mesh)
        with torch.no_grad():
            latent = encode(model, X, oh)
            rho = decode_rho(model, latent, oh) if store_normalized \
                else None
    if save_model_path:
        save_model(model, save_model_path,
                   meta=dict(n_genes=data.n_genes, n_batches=oh.shape[1],
                             n_latent=n_latent, n_hidden=n_hidden,
                             seed=seed))
    theta = torch.exp(torch.clamp(model.log_theta.detach(), -10.0, 10.0))
    out = (data.with_obsm(X_scvi=latent)
           .with_var(scvi_dispersion=theta)
           .with_uns(scvi_elbo_history=np.asarray(history)))
    if rho is not None:
        out = out.with_layers(scvi_normalized=rho)
    return out


@register("model.scanvi")
def scanvi(data: CellData, labels_key: str = "cell_type",
           unlabeled_category: str = "Unknown", n_latent: int = 10,
           n_hidden: int = 128, epochs: int = 40, batch_size: int = 512,
           batch_key: str | None = None, seed: int = 0,
           kl_warmup: int = 10, alpha: float = 50.0,
           classifier_only: bool = False, n_devices: int | None = None,
           store_normalized: bool = False, mesh=None,
           device=None) -> CellData:
    """Semi-supervised scVI: cells whose ``obs[labels_key]`` is
    ``unlabeled_category`` (or "" / "nan") are unlabelled, the rest
    supervise the classifier head.  Adds obsm ``X_scanvi``, obs
    ``scanvi_prediction`` and ``scanvi_confidence``, uns
    ``scanvi_elbo_history`` and (default model) uns
    ``scanvi_class_profiles``: each class's anchor decoded under its own
    label at the dataset's mean batch composition.  The default is the
    published scANVI model (:func:`semi_elbo_y`); ``classifier_only``
    the classifier-head variant (:func:`semi_elbo`).  With
    ``store_normalized`` layers ``scanvi_normalized``: each cell decoded
    under its label (the predicted one where unlabelled).
    ``n_devices``, ``mesh`` and ``device`` as for :func:`scvi`."""
    dev = resolve_device(device)
    n = data.n_cells
    if labels_key not in data.obs:
        raise KeyError(f"model.scanvi: obs has no {labels_key!r}")
    raw = _host_values(data.obs[labels_key], n).astype(str)
    unl = (raw == str(unlabeled_category)) | (raw == "") | (raw == "nan")
    levels = np.unique(raw[~unl])
    if len(levels) < 2:
        raise ValueError("model.scanvi: need >=2 labelled categories")
    lut = {lv: i for i, lv in enumerate(levels)}
    y = torch.from_numpy(np.array([lut.get(v, 0) for v in raw],
                                  np.int64)).to(dev)
    has_label = torch.from_numpy((~unl).astype(np.float32)).to(dev)
    data = data.to_device(dev)
    mesh = _mesh_for(n_devices, mesh, dev)
    X = _counts_dense(data, dev)
    oh = _batch_onehot(data, batch_key, n, "model.scanvi", dev)
    C = len(levels)
    gen = torch.Generator().manual_seed(seed)
    model = initial_model(gen, data.n_genes, oh.shape[1], n_latent,
                          n_hidden, n_classes=C,
                          y_decoder=not classifier_only).to(dev)
    objective = semi_elbo if classifier_only else semi_elbo_y

    def loss(m, xb, bb, yb, hb, eps, klw):
        return objective(m, xb, bb, yb, hb, eps, klw, alpha)

    with true_f32():
        history = _train(model, X, oh, (y, has_label), loss, epochs=epochs,
                         batch_size=batch_size, seed=seed,
                         kl_warmup=kl_warmup, gen=gen, n_latent=n_latent,
                         mesh=mesh)
        with torch.no_grad():
            Z = encode(model, X, oh)
            probs = torch.softmax(model.clf(Z), dim=1)
            uns = {"scanvi_elbo_history": np.asarray(history)}
            if not classifier_only:
                bmean = oh.mean(dim=0, keepdim=True)
                eye = torch.eye(C, dtype=Z.dtype, device=dev)
                uns["scanvi_class_profiles"] = torch.softmax(model.dec(
                    torch.cat([model.prior_mu, eye,
                               bmean.expand(C, bmean.shape[1])], dim=1)),
                    dim=1)
            layers = {}
            if store_normalized:
                y_use = torch.where(has_label > 0, y, probs.argmax(dim=1))
                parts = [Z] if classifier_only else [
                    Z, torch.nn.functional.one_hot(y_use, C).float()]
                layers["scanvi_normalized"] = torch.softmax(
                    model.dec(torch.cat(parts + [oh], dim=1)), dim=1)
    pred = probs.argmax(dim=1)
    conf = probs.gather(1, pred[:, None])[:, 0]
    out = (data.with_obsm(X_scanvi=Z)
           .with_obs(scanvi_prediction=levels[pred.cpu().numpy()],
                     scanvi_confidence=conf)
           .with_uns(**uns))
    if layers:
        out = out.with_layers(**layers)
    return out
