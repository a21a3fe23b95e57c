"""``embed.phate``: the potential-distance embedding (PHATE, Moon et al.
2019).

Counterpart of ``sctools_tpu/ops/phate.py``:

1. an adaptive-bandwidth kernel on the kNN graph (bandwidth = distance
   to the ``ka``-th neighbour), symmetrised, row-normalised to the
   diffusion operator P, dense (n, n): built by an accumulate-scatter
   (``index_add_``; each row's ids are distinct and padding adds 0, so
   the sums are exact and repeat bit for bit);
2. Pᵗ by ``t`` true-float32 ``torch.matmul``s (a plain matrix product,
   as the reference leaves it to XLA), and the potential
   U = −log(Pᵗ + 1e-7), centred;
3. classical MDS of U: the top eigenvectors of Uc Ucᵀ by subspace
   iteration from a Gaussian sketch, then one SVD.  Each iterate is
   orthonormalised by the port's ``cholesky_qr`` in float64 (the
   reference's runs in float32): the potential's spectrum falls so fast
   that the float32 Gram matrix of the iterate stops being positive
   definite (the reference's gives NaN on its own test curve at three
   components, the port's float32 Cholesky raised at two with other
   sketches).

``t=None`` picks the diffusion time at the knee of the von Neumann
entropy of P's spectrum (``eigvalsh`` of the symmetrised P in float64,
the entropy curve on the host).  The sketch is ``sketch=`` when given
(``carry.phate_sketch_from_numpy`` carries the reference's
``jax.random.normal`` draw), else a ``torch.Generator`` seeded with
``seed``.  Exact PHATE is O(n²) in memory and O(t·n³) in work: it is
meant for up to a few tens of thousands of cells (after metacells or
subsampling), the regime of the published method.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..registry import register
from .pca import cholesky_qr

_EPS = 1e-7


def kernel_matrix(idx: torch.Tensor, dist: torch.Tensor, ka: int,
                  alpha: float = 2.0) -> torch.Tensor:
    """The dense diffusion operator P (n, n) in ``dist``'s dtype: the
    decay kernel exp(−(d/σ_i)^α) on the kNN edges (σ_i the distance to
    row i's ``ka``-th neighbour), symmetrised by the average and
    row-normalised.  α = 2 (Gaussian) by default, as in the reference
    (its α ≈ 40 of the paper disconnects noisy kNN neighbourhoods)."""
    n, k = idx.shape
    ka = min(ka, k - 1)
    sigma = torch.clamp(dist[:, ka], min=1e-12)
    w = torch.exp(-((dist / sigma[:, None]) ** alpha))
    safe = torch.where(idx < 0, 0, idx).long()
    rows = torch.arange(n, device=idx.device)[:, None]
    W = torch.zeros((n * n,), dtype=dist.dtype, device=idx.device)
    W.index_add_(0, (rows * n + safe).reshape(-1),
                 torch.where(idx < 0, 0.0, w).reshape(-1))
    W = W.reshape(n, n)
    W = 0.5 * (W + W.T)
    return W / torch.clamp(W.sum(dim=1, keepdim=True), min=1e-12)


def von_neumann_t(P: torch.Tensor, max_t: int = 100) -> int:
    """PHATE's automatic t: the knee of the von Neumann entropy curve of
    Pᵗ's spectrum (float64 eigenvalues of the symmetrised P), the t
    furthest from the chord joining the curve's ends on normalised
    axes."""
    evals = torch.linalg.eigvalsh(0.5 * (P + P.T).double()).cpu().numpy()
    lam = np.clip(np.abs(evals), 1e-12, 1.0)
    ts = np.arange(1, max_t + 1)
    ent = []
    for t in ts:
        p = lam ** t
        p = p / p.sum()
        # 0·log 0 = 0: small eigenvalues underflow to 0 at large t
        plogp = np.where(p > 0, p * np.log(np.maximum(p, 1e-300)), 0.0)
        ent.append(float(-plogp.sum()))
    ent = np.asarray(ent)
    x = (ts - ts[0]) / max(ts[-1] - ts[0], 1)
    y = (ent - ent[-1]) / max(ent[0] - ent[-1], 1e-12)
    return max(int(ts[int(np.argmax(np.abs(y - (1.0 - x))))]), 2)


def phate_arrays(P: torch.Tensor, t: int, n_components: int,
                 sketch: torch.Tensor, n_iter: int = 4) -> torch.Tensor:
    """The embedding (n, n_components) of the operator ``P`` (n, n)
    float32 after ``t`` steps: U = −log(Pᵗ + 1e-7) centred by column,
    then subspace iteration on Uc Ucᵀ from ``sketch`` (n, n_components
    + 8) and one SVD, the products in true float32, each iterate
    orthonormalised in float64."""
    n = P.shape[0]
    with true_f32():
        M = torch.eye(n, dtype=torch.float32, device=P.device)
        for _ in range(t):
            M = P @ M
        U = -torch.log(M + _EPS)
        del M
        Uc = U - U.mean(dim=0, keepdim=True)
        del U
        Q = sketch
        for _ in range(n_iter + 1):
            Q = cholesky_qr((Uc @ (Uc.T @ Q)).double()).float()
        B = Q.T @ Uc
        U_b, S, _ = torch.linalg.svd(B, full_matrices=False)
        V = Q @ U_b
    return V[:, :n_components] * S[:n_components]


@register("embed.phate")
def phate(data: CellData, n_components: int = 2, t: int | None = None,
          ka: int = 5, alpha: float = 2.0, seed: int = 0, sketch=None,
          device=None) -> CellData:
    """Adds obsm ``X_phate`` (n, n_components) and uns ``phate_t``.
    ``t=None`` picks the diffusion time by the von Neumann entropy knee.
    ``sketch`` (n, n_components + 8) is the subspace iteration's start
    (default: drawn from ``seed``).  O(n²) memory: see the module
    docstring.  Requires ``neighbors.knn``."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    if "knn_indices" not in data.obsp:
        raise KeyError("embed.phate: run neighbors.knn first")
    n = data.n_cells
    idx = data.obsp["knn_indices"][:n]
    dist = data.obsp["knn_distances"][:n]
    if t is None:
        t = von_neumann_t(kernel_matrix(idx, dist.double(), ka, alpha))
    L = n_components + 8
    if sketch is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        sketch = torch.randn((n, L), generator=gen, device=dev)
    else:
        sketch = torch.as_tensor(sketch).to(dev, torch.float32)
        if tuple(sketch.shape) != (n, L):
            raise ValueError(f"sketch has shape {tuple(sketch.shape)}, "
                             f"expected {(n, L)}")
    P = kernel_matrix(idx, dist.float(), ka, alpha)
    emb = phate_arrays(P, int(t), n_components, sketch)
    return data.with_obsm(X_phate=emb).with_uns(phate_t=int(t))
