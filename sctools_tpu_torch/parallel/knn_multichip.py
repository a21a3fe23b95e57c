"""Multi-device kNN graph construction: ``neighbors.knn_multichip``.

Counterpart of ``sctools_tpu/parallel/knn_multichip.py`` (BASELINE
configs[4]).  The rows are prepared once (normalised for cosine, cast to
the matmul dtype: the bits ``neighbors.knn`` searches), padded to
``P × block`` rows and cut into P shards of ``m`` rows on the mesh's
devices.  Each shard's queries stay resident, and its ``(m, k)`` top k
is merged from one ``knn_select`` search per candidate chunk: the
port's hand kernel on the card, its plain version on the CPU.

* ``strategy="ring"`` (the default): the chunks circulate
  (``mesh.ring``); at step t shard i holds the chunk that started on
  shard ``(i − t) mod P``, whose rows begin at global id
  ``((i − t) mod P) · m``.  P² searches of m × m.
* ``strategy="all_gather"``: every shard gathers all rows and searches
  them at once.  P searches of m × P·m.

Each search's ids are shifted by its chunk's global offset.  A shard's
lists are then put in chunk order (ring steps arrive rotated) and
merged by ``knn_merge_plain``, the plain version of the kernel's own
split merge: (score descending, lower chunk first), so ties go to the
lower id and the result equals one search of all rows, as in
``neighbors.knn``.  Padding rows are never searched: each search takes
only the chunk's rows below ``n_valid``.
"""

from __future__ import annotations

import torch

from ..config import config, resolve_device, round_up
from ..data.dataset import CellData
from ..ops.knn import _get_rep, _prep, _to_dist
from ..ops.knn_kernel import knn_merge_plain, knn_select
from ..registry import register
from .mesh import all_gather, make_mesh, pad_rows, ring, split_rows

STRATEGIES = ("ring", "all_gather")


def knn_multichip_arrays(points: torch.Tensor, *, k: int = 15,
                         metric: str = "cosine", mesh=None,
                         n_valid: int | None = None,
                         block: int | None = None,
                         exclude_self: bool = False,
                         strategy: str = "ring"):
    """Exact kNN of the first ``n_valid`` rows of ``points`` against
    themselves over the devices of ``mesh`` (every CUDA device by
    default).  Returns ``(indices (rows, k) int32, distances (rows, k)
    float32)`` on ``mesh.devices[0]``, ``rows`` the padded row count
    ``round_up(n, P · block)``; rows at or past ``n_valid`` hold id -1
    and distance 0.  ``block`` defaults to the reference's rule,
    ``min(row_block, max(8, round_up(ceil(n / P), 8)))``.
    ``exclude_self`` drops each row's own id: in the ring at step 0,
    where the chunk is the shard's own and local ids are global ids
    less one offset; under all_gather by searching k + 1 and dropping
    the row's own id (or the last entry where it is absent)."""
    if metric not in ("cosine", "euclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} (use 'ring' or "
                         "'all_gather')")
    mesh = mesh or make_mesh()
    p = mesh.size
    n = points.shape[0]
    n_valid = n if n_valid is None else min(int(n_valid), n)
    if block is None:
        block = min(config.row_block, max(8, round_up(-(-n // p), 8)))
    rows = round_up(n, p * block)
    m = rows // p
    x = pad_rows(_prep(points[:n_valid].to(mesh.devices[0]), metric,
                       config.matmul_torch_dtype()), rows)
    shards = split_rows(x, mesh)
    valid = [max(0, min(m, n_valid - s * m)) for s in range(p)]
    kq = k + 1 if exclude_self and strategy == "all_gather" else k

    def search(i, cand, offset, exclude):
        """Shard i's valid queries against ``cand``, ids made global."""
        v, ids = knn_select(shards[i][:valid[i]], cand, k=kq,
                            metric=metric, exclude_self=exclude)
        return v, torch.where(ids >= 0, ids + offset, ids)

    lists = [{} for _ in range(p)]  # shard -> {chunk: (values, ids)}
    if strategy == "ring":
        def step(t, i, src, chunk):
            if valid[i] and valid[src]:
                lists[i][src] = search(i, chunk[:valid[src]], src * m,
                                       exclude_self and t == 0)

        ring(mesh, shards, step)
    else:
        # every gather before any search: a copy from a device runs on
        # that device's current stream, behind a search queued there
        gathered = [all_gather(shards, dev)[:n_valid] if valid[i] else None
                    for i, dev in enumerate(mesh.devices)]
        for i, full in enumerate(gathered):
            if full is not None:
                v, ids = search(i, full, 0, False)
                if exclude_self:
                    v, ids = _drop_self(v, ids, i * m, k)
                lists[i][0] = (v, ids)

    dev0 = mesh.devices[0]
    out_i = torch.full((rows, k), -1, dtype=torch.int32, device=dev0)
    out_d = torch.zeros((rows, k), dtype=torch.float32, device=dev0)
    for i, by_chunk in enumerate(lists):
        if not by_chunk:
            continue
        parts = [by_chunk[src] for src in sorted(by_chunk)]
        v, ids = knn_merge_plain(torch.stack([a for a, _ in parts]),
                                 torch.stack([b for _, b in parts]))
        out_i[i * m:i * m + valid[i]] = ids.to(dev0)
        out_d[i * m:i * m + valid[i]] = _to_dist(v, metric).to(dev0)
    return out_i, out_d


def _drop_self(v: torch.Tensor, ids: torch.Tensor, offset: int, k: int):
    """From ``k + 1`` entries a row, the ``k`` without the row's own
    global id ``offset + row`` (the last entry where it is absent)."""
    own = offset + torch.arange(ids.shape[0], device=ids.device)[:, None]
    hit = ids == own
    drop = torch.where(hit.any(dim=1), hit.int().argmax(dim=1),
                       ids.shape[1] - 1)
    keep = torch.arange(ids.shape[1], device=ids.device)[None, :] \
        != drop[:, None]
    rows = ids.shape[0]
    return v[keep].reshape(rows, k), ids[keep].reshape(rows, k)


@register("neighbors.knn_multichip", sharding="cells", collective=True)
def knn_multichip(data: CellData, k: int = 15, metric: str = "cosine",
                  use_rep: str = "X_pca", n_devices: int | None = None,
                  block: int | None = None, exclude_self: bool = False,
                  strategy: str = "ring", mesh=None,
                  device=None) -> CellData:
    """Multi-device kNN over ``mesh`` (default: ``make_mesh(n_devices)``,
    every CUDA device; on a CPU ``device``, ``n_devices`` (1) shards of
    the CPU).  Adds the obsp and uns fields of
    ``neighbors.knn``, with the rows padded as
    :func:`knn_multichip_arrays` pads them; the result lies on
    ``device`` (``None``: the card, raising without one)."""
    from ..ops.graph import invalidate_graph_layout_stats

    dev = resolve_device(device)
    data = data.to_device(dev)
    rep = _get_rep(data, use_rep)
    if mesh is None:
        mesh = (make_mesh(devices=["cpu"] * (n_devices or 1))
                if dev.type == "cpu" else make_mesh(n_devices))
    idx, dist = knn_multichip_arrays(
        rep, k=k, metric=metric, mesh=mesh,
        n_valid=data.n_cells, block=block, exclude_self=exclude_self,
        strategy=strategy)
    data = invalidate_graph_layout_stats(data)
    return data.with_obsp(knn_indices=idx.to(rep.device),
                          knn_distances=dist.to(rep.device)).with_uns(
        knn_k=k, knn_metric=metric)
