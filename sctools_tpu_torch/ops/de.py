"""Differential expression: ``de.rank_genes_groups`` and
``de.filter_rank_genes_groups``.

Counterpart of ``sctools_tpu/ops/de.py`` (scanpy's
``tl.rank_genes_groups`` / ``pp.filter_rank_genes_groups``), with its
methods and ``uns`` layout:

* ``t-test`` / ``t-test_overestim_var`` (Welch): per-group gene sums
  and sums of squares from one pass over the stored slots of X
  (``data/sparse.py:gene_slots_sum``, the fixed order of
  ``segment_reduce``) or, for a dense X, one sum over cells in index
  order (``cluster._segment_sum``); no atomics, so the card repeats its
  bits;
* ``wilcoxon`` (Mann-Whitney U, normal approximation, tie-corrected):
  per block of 2,048 genes (densified alone, ``dense_gene_block``) one
  stable sort along the cells, each value's run of ties bounded by a
  running max / min of the run starts / ends, the average ranks (halves
  below 2²⁴: exact in float32) and the tie term Σ t³ − t, then the
  centred rank sums by group in cell order.  The tie term and the rank
  sums are added in float64, where they are exact integers and halves;
* ``logreg``: multinomial logistic regression, 300 full-batch Adam
  steps (the reference's ``optax.adam`` defaults) on softmax
  cross-entropy + L2, the logits by ``spmm``, the gradient in closed
  form, ``Xᵀ (softmax − onehot) / n + 2·l2·W``, with ``Xᵀ ·`` on the
  stored slots in the fixed order.

The p-values (t and normal survival functions) and the BH adjustment
are small (groups × genes) and stay on the host with scipy, as in the
reference.

One departure: the reference draws logreg's start from
``jax.random.normal``, which torch cannot reproduce; the port draws
``logreg_w0`` from a seeded CPU ``torch.Generator``, so one seed gives
another start (and other coefficients of the same quality).
``carry.logreg_w0_from_numpy`` carries the reference's draw.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import (SparseCells, dense_gene_block, gene_slots,
                           gene_slots_sum, spmm)
from ..registry import register
from ..utils.optim import adam_step_all, bias_corrections
from .cluster import _segment_sum, segment_order
from .graph import _host
from .qc import _matrix_X

METHODS = ("t-test", "t-test_overestim_var", "wilcoxon", "logreg")
_GENE_BLOCK = 2048


# ----------------------------------------------------------------------
# labels and host statistics (the reference's, in numpy)
# ----------------------------------------------------------------------


def _group_codes(data: CellData, groupby: str):
    """(codes int32 (n_cells,), level names list[str], n_cells)."""
    if groupby not in data.obs:
        raise KeyError(f"rank_genes_groups: obs has no key {groupby!r}; "
                       f"available: {sorted(data.obs)}")
    # per-cell obs arrays may carry padded rows: trim before computing
    # levels, or padding values become a bogus group
    v = _host(data.obs[groupby])[: data.n_cells]
    levels, codes = np.unique(v, return_inverse=True)
    return codes.astype(np.int32), [str(l) for l in levels], v.shape[0]


def _selected(levels, groups, groupby: str, skip=None) -> list[int]:
    """Positions of the levels ``groups`` names (all when None), but
    ``skip``; raises on unknown names or an empty selection."""
    want = None if groups is None else {str(g) for g in groups}
    if want is not None:
        unknown = want - set(levels)
        if unknown:
            raise ValueError(
                f"rank_genes_groups: groups {sorted(unknown)} are not "
                f"levels of obs[{groupby!r}] ({levels})")
    keep = [i for i, l in enumerate(levels)
            if (want is None or l in want) and i != skip]
    if not keep:
        raise ValueError(f"rank_genes_groups: groups={groups!r} selects no "
                         f"level of {levels}")
    return keep


def _bh_adjust(p: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg along the last axis."""
    n = p.shape[-1]
    order = np.argsort(p, axis=-1)
    ranked = np.take_along_axis(p, order, axis=-1)
    q = ranked * n / np.arange(1, n + 1)
    q = np.minimum.accumulate(q[..., ::-1], axis=-1)[..., ::-1]
    out = np.empty_like(q)
    np.put_along_axis(out, order, np.clip(q, 0, 1), axis=-1)
    return out


def _logfoldchange(mean_g, mean_rest, base: float = 2.0):
    """scanpy's logFC: undo log1p, ratio the pseudo-counted expm1
    means, re-log in base 2."""
    return (np.log(np.expm1(mean_g) + 1e-9)
            - np.log(np.expm1(mean_rest) + 1e-9)) / np.log(base)


def _group_means(s, cnt):
    """Per-group and rest means from group sums and counts alone."""
    s, cnt = np.asarray(s, np.float64), np.asarray(cnt, np.float64)
    tot_s, tot_n = s.sum(0), cnt.sum()
    n1 = np.maximum(cnt, 1.0)[:, None]
    n2 = np.maximum(tot_n - cnt, 1.0)[:, None]
    return s / n1, (tot_s[None, :] - s) / n2


def _welch_stats(s, ss, cnt, overestim_var=False, ref=None):
    """Per group against the rest (or the group ``ref``): Welch t
    statistics, dfs and both means, float64.  ``overestim_var`` divides
    the rest's variance by the group's size (scanpy's
    ``t-test_overestim_var``)."""
    s, ss, cnt = (np.asarray(a, np.float64) for a in (s, ss, cnt))
    tot_s, tot_ss, tot_n = s.sum(0), ss.sum(0), cnt.sum()
    t_stats, dfs, m_g, m_r = [], [], [], []
    for g in range(s.shape[0]):
        n1 = max(cnt[g], 1.0)
        if ref is None:
            n2 = max(tot_n - cnt[g], 1.0)
            s2, ss2 = tot_s - s[g], tot_ss - ss[g]
        else:
            n2 = max(cnt[ref], 1.0)
            s2, ss2 = s[ref], ss[ref]
        m1 = s[g] / n1
        m2 = s2 / n2
        v1 = np.maximum((ss[g] - n1 * m1**2) / max(n1 - 1, 1.0), 0.0)
        v2 = np.maximum((ss2 - n2 * m2**2) / max(n2 - 1, 1.0), 0.0)
        n2_eff = n1 if overestim_var else n2
        se2_1, se2_2 = v1 / n1, v2 / n2_eff
        denom = np.sqrt(se2_1 + se2_2)
        t = (m1 - m2) / np.maximum(denom, 1e-30)
        df = (se2_1 + se2_2) ** 2 / np.maximum(
            se2_1**2 / max(n1 - 1, 1.0)
            + se2_2**2 / max(n2_eff - 1, 1.0), 1e-300)
        t_stats.append(t)
        dfs.append(df)
        m_g.append(m1)
        m_r.append(m2)
    return (np.stack(t_stats), np.stack(dfs), np.stack(m_g), np.stack(m_r))


def _wilcoxon_z(centered_rank_sums, cnt, ties, n, tie_correct):
    """z from centred per-group rank sums (null mean already zero)."""
    rs = np.asarray(centered_rank_sums, np.float64)
    cnt = np.asarray(cnt, np.float64)
    ties = np.asarray(ties, np.float64)
    zs = []
    for g in range(rs.shape[0]):
        n1 = cnt[g]
        n2 = n - n1
        var = n1 * n2 * (n + 1) / 12.0
        if tie_correct:
            var = var * (1.0 - ties / max(n**3 - n, 1.0))
        zs.append(rs[g] / np.sqrt(np.maximum(var, 1e-30)))
    return np.stack(zs)


# ----------------------------------------------------------------------
# group sums on the device, in a fixed order
# ----------------------------------------------------------------------


class _Groups:
    """One call's grouping on the device: the one-hot table, the cell
    order of ``_segment_sum`` and, for a sparse X, its stored slots in
    gene-major order (sorted once, summed over by every pass)."""

    def __init__(self, X, codes: np.ndarray, n_groups: int, n: int):
        self.n, self.n_groups = n, n_groups
        codes = torch.from_numpy(codes[:n].astype(np.int64)).to(X.device)
        self.onehot = torch.nn.functional.one_hot(codes, n_groups).float()
        self.order = segment_order(codes, n_groups)
        self.cnt = self.order[1].float()
        self.sparse = isinstance(X, SparseCells)
        self.slots = gene_slots(X) if self.sparse else None
        self.dense = None if self.sparse else X[:n].float()

    def slot_sums(self, table: torch.Tensor, fn, d: int) -> torch.Tensor:
        """For a sparse X: per-gene sums over the stored slots of
        ``fn(value (m, 1), table[cell]) -> (m, d)``, (d, n_genes)."""
        return gene_slots_sum(
            self.slots, lambda rows, dat: fn(dat[:, None], table[rows]),
            d).T

    def cell_sums(self, values: torch.Tensor) -> torch.Tensor:
        """For a dense X: per-group sums of ``values`` (n, genes) over
        the cells, in index order, (G, genes)."""
        return _segment_sum(values, None, self.n_groups, order=self.order)

    def moments(self, need_ss: bool = True):
        """(s, ss, cnt): per-group gene sums and sums of squares
        (G, n_genes) and cell counts (G,), host numpy."""
        G = self.n_groups
        if self.sparse and need_ss:
            out = self.slot_sums(self.onehot, lambda v, oh: torch.cat(
                [v * oh, v * v * oh], 1), 2 * G)
            s, ss = out[:G], out[G:]
        elif self.sparse:  # the squares' pass is skipped
            s = self.slot_sums(self.onehot, lambda v, oh: v * oh, G)
            ss = torch.zeros_like(s)
        else:  # dense moments cost one pass either way
            s = self.cell_sums(self.dense)
            ss = self.cell_sums(self.dense * self.dense)
        return _host(s), _host(ss), _host(self.cnt)

    def expressing(self) -> np.ndarray:
        """(G, n_genes) cells of each group with the gene above zero."""
        if self.sparse:
            return _host(self.slot_sums(
                self.onehot, lambda v, oh: (v > 0).float() * oh,
                self.n_groups))
        return _host(self.cell_sums((self.dense > 0).float()))


# ----------------------------------------------------------------------
# wilcoxon ranks
# ----------------------------------------------------------------------


def _average_ranks(X: torch.Tensor):
    """Column-wise average ranks (1-based, ties averaged) of X (n, w),
    as (w, n) float32 (a row per column of X), and each column's tie
    term Σ (t³ − t) over its runs of equal values, (w,) float64
    (exact): one stable sort along the cells of the transposed block,
    whose rows are contiguous (on the CPU 3–5× faster to sort and scan
    than columns); a sorted position's run starts at the running
    maximum of the run starts before it and ends at the running minimum
    of the run ends after it."""
    n, w = X.shape
    xs, order = torch.sort(X.T.contiguous(), dim=1, stable=True)
    step = xs[:, 1:] != xs[:, :-1]  # a new run starts at the next position
    edge = torch.ones((w, 1), dtype=torch.bool, device=X.device)
    first = torch.cat([edge, step], dim=1)
    last = torch.cat([step, edge], dim=1)
    del xs, step
    pos = torch.arange(n, dtype=torch.int32, device=X.device)[None, :]
    lo = torch.cummax(torch.where(first, pos, 0), dim=1).values
    hi = torch.cummin(torch.where(last, pos + 1, n).flip(1),
                      dim=1).values.flip(1)
    ranks_sorted = 0.5 * (lo + hi + 1).float()
    t = (hi - lo).double()
    ties = torch.where(first, t * t * t - t, 0.0).sum(dim=1)
    del lo, hi, t, first, last
    ranks = torch.empty_like(ranks_sorted).scatter_(1, order, ranks_sorted)
    return ranks, ties


def _group_rank_sums(ranks: torch.Tensor, order, n_groups: int
                     ) -> torch.Tensor:
    """Per-group sums of the centred ranks ``rank − (n + 1)/2`` of
    ``ranks`` (w, n), (G, w) float64, each group's cells added in index
    order (``order`` is ``segment_order`` of the codes).  Halves summed
    in float64: exact, where the reference's float32 sums round past
    2²⁴."""
    n = ranks.shape[1]
    cells, lengths = order
    centered = ranks.double()[:, cells] - 0.5 * (n + 1)
    return torch.segment_reduce(
        centered, "sum", axis=1,
        lengths=lengths.expand(ranks.shape[0], -1).contiguous()).T


def _blocked_rank_sums(X, n: int, n_genes: int, grp: _Groups):
    """(ties (n_genes,), cnt (G,), centred rank sums (G, n_genes)), host
    float64, over gene blocks of ``_GENE_BLOCK`` columns."""
    rs, ties = [], []
    for lo in range(0, n_genes, _GENE_BLOCK):
        width = min(_GENE_BLOCK, n_genes - lo)
        blk = (dense_gene_block(X, lo, width) if isinstance(X, SparseCells)
               else X[:n, lo:lo + width].float())
        ranks, t = _average_ranks(blk)
        del blk
        rs.append(_group_rank_sums(ranks, grp.order, grp.n_groups))
        ties.append(t)
        del ranks
    return (_host(torch.cat(ties)), _host(grp.cnt),
            _host(torch.cat(rs, dim=1)))


# ----------------------------------------------------------------------
# logreg
# ----------------------------------------------------------------------


def logreg_w0(n_genes: int, n_groups: int, seed: int, device
              ) -> torch.Tensor:
    """logreg's start, 1e-3 · N(0, 1) of shape (n_genes, n_groups), from
    a CPU ``torch.Generator`` seeded with ``seed`` (the same bits on
    every device)."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((n_genes, n_groups), generator=gen)
    return (1e-3 * w).to(device)


_LOGREG_L2, _LOGREG_LR = 1e-4, 0.1  # the reference's defaults


def _logreg_scores(X, grp: _Groups, n_genes: int, n_steps: int = 300,
                   w0: torch.Tensor | None = None) -> np.ndarray:
    """Multinomial logistic-regression coefficients (scanpy's
    ``method="logreg"`` scores), (n_groups, n_genes): softmax
    cross-entropy + l2·ΣW², ``n_steps`` full-batch Adam steps from
    ``w0`` (default ``logreg_w0`` with seed 0).  Logits by ``spmm`` (a
    sparse X is never densified); the gradient in closed form on the
    stored slots."""
    n, G = grp.n, grp.n_groups
    dev = grp.onehot.device
    # updated in place: a copy, never the caller's w0
    W = (logreg_w0(n_genes, G, 0, dev) if w0 is None
         else w0.to(dev, torch.float32).clone())
    b = torch.zeros((G,), dtype=torch.float32, device=dev)
    mW, vW = torch.zeros_like(W), torch.zeros_like(W)
    mb, vb = torch.zeros_like(b), torch.zeros_like(b)
    for t in range(1, n_steps + 1):
        with true_f32():
            logits = (spmm(X, W)[:n] if grp.sparse else grp.dense @ W) + b
            # d(mean CE)/d logits
            R = (torch.softmax(logits, dim=1) - grp.onehot) / n
            gW = (grp.slot_sums(R, lambda v, r: v * r, G).T if grp.sparse
                  else grp.dense.T @ R)
        gW = gW + 2.0 * _LOGREG_L2 * W
        gb = R.sum(dim=0)
        adam_step_all([W, b], [gW, gb], [mW, mb], [vW, vb],
                      bias_corrections(t), _LOGREG_LR)
    return _host(W).T


# ----------------------------------------------------------------------
# de.rank_genes_groups
# ----------------------------------------------------------------------


def _finalise(data, scores, pvals, lfc, levels, method, n_top,
              pts_pair=None, reference="rest"):
    """Sort per group, BH-adjust, store the scanpy-shaped uns entry.
    ``pts_pair``: per-group expressing fractions (n_groups, n_genes),
    stored unsorted (indexed by gene id) as ``pts`` / ``pts_rest``."""
    padj = _bh_adjust(pvals)
    order = np.argsort(-scores, axis=1)
    if n_top is not None:
        order = order[:, :n_top]
    gene_names = None
    if "gene_name" in data.var:
        gene_names = _host(data.var["gene_name"]).astype(str)

    def take(a):
        return np.take_along_axis(a, order, axis=1)

    result = {
        "method": method,
        "reference": reference,
        "groups": levels,
        "indices": order,
        "names": (gene_names[order] if gene_names is not None else order),
        "scores": take(scores),
        "pvals": take(pvals),
        "pvals_adj": take(padj),
        "logfoldchanges": take(lfc),
    }
    if pts_pair is not None:
        result["pts"], result["pts_rest"] = (np.asarray(p) for p in pts_pair)
    return data.with_uns(rank_genes_groups=result)


def _expression_fractions(grp: _Groups, codes, n_groups: int):
    """(n_groups, n_genes) fractions of cells expressing each gene, in
    the group and out of it."""
    n = grp.n
    n_per = np.bincount(codes, minlength=n_groups).astype(np.float64)
    nnz_gj = grp.expressing()
    total = nnz_gj.sum(axis=0, keepdims=True)
    frac_in = nnz_gj / np.maximum(n_per[:, None], 1.0)
    frac_out = (total - nnz_gj) / np.maximum((n - n_per)[:, None], 1.0)
    return frac_in, frac_out


def _versus_reference(data, groupby, levels, n_obs, n_top, tie_correct,
                      pts, groups, reference, dev):
    """wilcoxon against a named group: scanpy ranks only the pair, so
    each selected group runs as a two-level comparison on its cells and
    the reference's, where group-vs-rest is group-vs-reference; the rows
    are stacked."""
    v = _host(data.obs[groupby])[:n_obs].astype(str)
    ref = str(reference)
    sel = [levels[i] for i in _selected(levels, groups, groupby,
                                        skip=levels.index(ref))]
    parts = []
    for level in sel:
        sub = data[(v == level) | (v == ref)]
        r = rank_genes_groups(sub, groupby=groupby, method="wilcoxon",
                              n_top=n_top, tie_correct=tie_correct,
                              groups=[level], pts=pts, device=dev)
        parts.append(r.uns["rank_genes_groups"])
    result = {"method": "wilcoxon", "reference": reference, "groups": sel}
    keys = ("indices", "names", "scores", "pvals", "pvals_adj",
            "logfoldchanges") + (("pts", "pts_rest") if pts else ())
    for key in keys:
        result[key] = np.concatenate([p[key] for p in parts])
    return data.with_uns(rank_genes_groups=result)


@register("de.rank_genes_groups")
def rank_genes_groups(data: CellData, groupby: str = "label",
                      method: str = "t-test", n_top: int | None = None,
                      tie_correct: bool = True, pts: bool = False,
                      groups=None, reference: str = "rest",
                      device=None) -> CellData:
    """Rank the genes that characterise each level of ``obs[groupby]``
    against the rest (or against the level ``reference``), scanpy's
    ``tl.rank_genes_groups``.  ``method``: ``t-test``,
    ``t-test_overestim_var``, ``wilcoxon`` or ``logreg`` (no p-values).
    ``groups`` restricts the rows to those levels; ``pts`` adds the
    expressing fractions.  Adds ``uns["rank_genes_groups"]`` (host
    numpy): names / indices, scores (t, z or coefficients), pvals,
    BH-adjusted pvals and log2 fold changes, each (groups × n_top or
    all genes), by descending score."""
    from scipy import stats as sps

    dev = resolve_device(device)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; use 't-test', "
                         "'t-test_overestim_var', 'wilcoxon' or 'logreg'")
    data = data.to_device(dev)
    X = _matrix_X(data)
    codes, levels, n_obs = _group_codes(data, groupby)
    n_groups = len(levels)
    ref_idx = None
    if reference != "rest":
        if str(reference) not in levels:
            raise ValueError(
                f"rank_genes_groups: reference {reference!r} is not a "
                f"level of obs[{groupby!r}] ({levels})")
        if method == "logreg":
            raise ValueError(
                "rank_genes_groups: reference= other than 'rest' is not "
                "defined for method='logreg' (multinomial over all "
                "groups); use a t-test or wilcoxon")
        ref_idx = levels.index(str(reference))
        if method == "wilcoxon":
            return _versus_reference(data, groupby, levels, n_obs, n_top,
                                     tie_correct, pts, groups, reference,
                                     dev)
    keep = (_selected(levels, groups, groupby, skip=ref_idx)
            if groups is not None or ref_idx is not None else None)

    grp = _Groups(X, codes, n_groups, n_obs)
    if method == "logreg":
        scores = _logreg_scores(X, grp, data.n_genes)
        pvals = np.full_like(scores, np.nan)  # scanpy: no p-values
        s, _, cnt = grp.moments(need_ss=False)
        m_g, m_r = _group_means(s, cnt)
    elif method == "wilcoxon":
        ties, cnt, rank_sums = _blocked_rank_sums(X, n_obs, data.n_genes,
                                                  grp)
        scores = _wilcoxon_z(rank_sums, cnt, ties, n_obs, tie_correct)
        pvals = 2.0 * sps.norm.sf(np.abs(scores))
        s, _, cnt = grp.moments(need_ss=False)
        m_g, m_r = _group_means(s, cnt)
    else:
        s, ss, cnt = grp.moments(need_ss=True)
        scores, df, m_g, m_r = _welch_stats(
            s, ss, cnt, overestim_var=(method == "t-test_overestim_var"),
            ref=ref_idx)
        pvals = 2.0 * sps.t.sf(np.abs(scores), np.maximum(df, 1.0))
    lfc = _logfoldchange(m_g, m_r)
    pts_pair = _expression_fractions(grp, codes, n_groups) if pts else None
    if keep is not None:
        if pts_pair is not None:
            frac_in, frac_out = pts_pair
            if ref_idx is not None:
                # against a named reference the "rest" column is that
                # group's own expressing fraction (scanpy's
                # pct_nz_reference)
                frac_out = np.broadcast_to(frac_in[ref_idx],
                                           frac_in.shape).copy()
            pts_pair = (frac_in[keep], frac_out[keep])
        scores, pvals, lfc = scores[keep], pvals[keep], lfc[keep]
        levels = [levels[i] for i in keep]
    return _finalise(data, scores, pvals, lfc, levels, method, n_top,
                     pts_pair=pts_pair, reference=reference)


# ----------------------------------------------------------------------
# de.filter_rank_genes_groups
# ----------------------------------------------------------------------


@register("de.filter_rank_genes_groups")
def filter_rank_genes_groups(data: CellData, groupby: str = "label",
                             key: str = "rank_genes_groups",
                             min_in_group_fraction: float = 0.25,
                             max_out_group_fraction: float = 0.5,
                             min_fold_change: float = 1.0,
                             device=None) -> CellData:
    """Filter an existing ``de.rank_genes_groups`` result by in-group
    and out-group expressing fractions and by fold change (scanpy's
    ``pp.filter_rank_genes_groups``).  Adds ``uns[key + "_filtered"]``:
    the ranking with ``names_filtered`` (failing entries None), the
    boolean ``kept`` mask and both fractions at the ranked genes."""
    dev = resolve_device(device)
    if key not in data.uns:
        raise KeyError(
            f"filter_rank_genes_groups: uns has no {key!r} — run "
            "de.rank_genes_groups first")
    data = data.to_device(dev)
    res = data.uns[key]
    codes, levels, n_obs = _group_codes(data, groupby)
    if list(res["groups"]) != list(levels):
        raise ValueError(
            f"filter_rank_genes_groups: obs[{groupby!r}] levels {levels} "
            f"do not match the ranking's groups {list(res['groups'])}")
    grp = _Groups(_matrix_X(data), codes, len(levels), n_obs)
    frac_in, frac_out = _expression_fractions(grp, codes, len(levels))
    idx = np.asarray(res["indices"])  # (groups, m) gene ids, ranked
    rows = np.arange(len(levels))[:, None]
    ok = ((frac_in[rows, idx] >= min_in_group_fraction)
          & (frac_out[rows, idx] <= max_out_group_fraction)
          & (np.asarray(res["logfoldchanges"]) >= np.log2(min_fold_change)))
    names = np.asarray(res["names"]).astype(object)
    names[~ok] = None  # scanpy: filtered entries become NaN / None
    out = dict(res)
    out["names_filtered"] = names
    out["kept"] = ok
    out["frac_in_group"] = frac_in[rows, idx]
    out["frac_out_group"] = frac_out[rows, idx]
    return data.with_uns(**{f"{key}_filtered": out})
