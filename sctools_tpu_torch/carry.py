"""Carry state over from the JAX package as plain numpy arrays.

The port never imports the reference; a caller that has both hands
over the reference's arrays through numpy:

* ``cells_from_numpy`` builds the port's ``CellData`` from the padded-ELL
  planes of a reference ``SparseCells`` (``np.asarray(x.indices)``,
  ``np.asarray(x.data)``) — the same layout, so both packages then
  reduce over identical slots;
* ``pca_omega_from_numpy`` turns the reference's PCA sketch (drawn with
  ``jax.random``, which torch cannot reproduce) into the ``omega=`` of
  ``pca.randomized``, so both packages compute the same PCA;
* ``graph_from_numpy`` attaches the reference's kNN graph, so both
  packages run the graph tail on the same edges;
* ``spectral_v0_from_numpy`` turns the reference's start block of the
  diffusion-map subspace iteration (``jax.random`` again) into the
  ``v0=`` of ``embed.spectral``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import config
from .data.dataset import CellData
from .data.sparse import SparseCells


def cells_from_numpy(indices, data, n_cells: int, n_genes: int, *,
                     obs: dict | None = None, var: dict | None = None,
                     device="cpu") -> CellData:
    """``CellData`` whose X is the padded-ELL matrix given by its
    ``indices`` (rows_padded, capacity) int32 and ``data`` float32
    planes (sentinel ``n_genes`` with value 0 in padding slots)."""
    # copies: the planes may be read-only views of another library's
    # buffers
    indices = np.array(indices, dtype=np.int32)
    data = np.array(data, dtype=np.float32)
    if indices.shape != data.shape or indices.ndim != 2:
        raise ValueError(
            f"indices {indices.shape} and data {data.shape} must be one "
            "(rows_padded, capacity) shape")
    if indices.shape[0] < n_cells:
        raise ValueError(
            f"{indices.shape[0]} rows cannot hold n_cells={n_cells}")
    if indices.shape[1] % config.capacity_multiple:
        raise ValueError(
            f"capacity {indices.shape[1]} is not a multiple of "
            f"{config.capacity_multiple}")
    if indices.size and (indices.min() < 0 or indices.max() > n_genes):
        raise ValueError(f"gene ids outside 0..{n_genes} (the sentinel)")
    if np.any(data[indices == n_genes] != 0):
        raise ValueError("padding slots must hold 0")
    X = SparseCells(torch.from_numpy(indices), torch.from_numpy(data),
                    int(n_cells), int(n_genes))
    return CellData(X, obs=dict(obs or {}),
                    var=dict(var or {})).to_device(device)


def pca_omega_from_numpy(omega) -> torch.Tensor:
    """The reference's (G, L) sketch as the float32 tensor that
    ``pca.randomized(..., omega=)`` takes."""
    omega = np.array(omega, dtype=np.float32)
    if omega.ndim != 2:
        raise ValueError(f"omega must be (G, L), got {omega.shape}")
    return torch.from_numpy(omega)


def spectral_v0_from_numpy(v0) -> torch.Tensor:
    """The reference's (n, n_comps + 5) start block of
    ``diffusion_eigs`` as the float32 tensor that ``embed.spectral(...,
    v0=)`` takes."""
    v0 = np.array(v0, dtype=np.float32)
    if v0.ndim != 2:
        raise ValueError(f"v0 must be (n, width), got {v0.shape}")
    return torch.from_numpy(v0)


def graph_from_numpy(data: CellData, knn_indices, knn_distances,
                     **uns) -> CellData:
    """``data`` with a kNN graph computed elsewhere (e.g. by the
    reference's ``neighbors.knn``, as numpy): obsp ``knn_indices``
    (rows ≥ n_cells, k) int32 with -1 padding and ``knn_distances`` of
    the same shape float32, on the device that holds ``data.X``, and
    ``uns`` entries such as ``knn_k=15, knn_metric="cosine"``.  Lets
    two packages start from one identical graph: their own searches may
    order near-ties differently."""
    idx = np.array(knn_indices, dtype=np.int32)
    dist = np.array(knn_distances, dtype=np.float32)
    n = data.n_cells
    if idx.ndim != 2 or idx.shape != dist.shape:
        raise ValueError(
            f"knn_indices {idx.shape} and knn_distances {dist.shape} must "
            "be one (rows, k) shape")
    if idx.shape[0] < n:
        raise ValueError(f"{idx.shape[0]} rows cannot hold n_cells={n}")
    if idx.size and (idx.min() < -1 or idx.max() >= n):
        raise ValueError(f"neighbour ids outside -1..{n - 1}")
    X = data.X
    device = X.device if isinstance(X, (SparseCells, torch.Tensor)) \
        else torch.device("cpu")
    return data.with_obsp(
        knn_indices=torch.from_numpy(idx).to(device),
        knn_distances=torch.from_numpy(dist).to(device)).with_uns(**uns)
