"""Preprocessing recipes, scanpy's ``pp.recipe_*``, as the port's
``Pipeline`` objects: ``recipe_pipeline(name, **kw)`` builds the named
recipe's ``Pipeline``, as ``sctools_tpu/recipes.py`` does, under the
same names and defaults (``zheng17``, ``seurat``, ``pearson_residuals``,
``atlas_knn``, ``annotation_reference``, ``graph_tail``).  The one-call
ops ``recipe.zheng17``, ``recipe.seurat``, ``recipe.pearson_residuals``
and ``recipe.weinreb17`` snapshot the raw counts into
``layers["counts"]`` first and run their steps one by one: the
reference's run them fused, and fused pipelines are not ported
(ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .data.dataset import CellData
from .registry import Pipeline, apply, register

PIPELINES: dict = {}


def _pipeline_recipe(name: str):
    def deco(factory):
        PIPELINES[name] = factory
        return factory

    return deco


def recipe_pipeline(name: str, **kw) -> Pipeline:
    """Build the named recipe's ``Pipeline`` with the factory's keyword
    arguments."""
    try:
        factory = PIPELINES[name]
    except KeyError:
        raise KeyError(
            f"no pipeline-shaped recipe named {name!r}; known: "
            f"{sorted(PIPELINES)} (weinreb17 is one-call only: its gene "
            "filter thresholds moments mid-recipe)") from None
    return factory(**kw)


def run_recipe(name: str, data: CellData, **kw):
    """The reference's resilient form of a recipe (retries, breakers,
    checkpoints) needs ``runner``, not ported yet."""
    raise NotImplementedError(
        "run_recipe needs runner.ResilientRunner, which is not ported yet "
        "(ROADMAP.md Queue 1 item 13); use recipe_pipeline(name).run(data)")


def submit_recipe(scheduler, name: str, data: CellData, **kw):
    """The reference's multi-tenant form of a recipe needs
    ``scheduler``, not ported yet."""
    raise NotImplementedError(
        "submit_recipe needs scheduler.RunScheduler, which is not ported "
        "yet (ROADMAP.md Queue 1 item 13)")


@_pipeline_recipe("zheng17")
def zheng17_pipeline(n_top_genes: int = 1000) -> Pipeline:
    """Zheng et al. 2017 (the 10x 1.3M-cell paper): gene filter → count
    normalise (to the median) → cell_ranger HVG subset → renormalise →
    log1p → scale (no clip)."""
    return Pipeline([
        ("util.snapshot_layer", {"layer": "counts"}),
        ("qc.filter_genes", {"min_cells": 1}),
        ("normalize.library_size", {"target_sum": None}),
        ("hvg.select", {"n_top": n_top_genes, "flavor": "cell_ranger",
                        "subset": True}),
        ("normalize.library_size", {"target_sum": None}),
        ("normalize.log1p", {}),
        ("normalize.scale", {"max_value": None}),
    ])


@_pipeline_recipe("seurat")
def seurat_pipeline(n_top_genes: int = 2000, min_genes: int = 200,
                    min_cells: int = 3, target_sum: float = 1e4
                    ) -> Pipeline:
    """The classic Seurat workflow: cell filter → gene filter →
    library-size normalise → log1p → dispersion HVG subset → scale
    clipped at 10."""
    return Pipeline([
        ("util.snapshot_layer", {"layer": "counts"}),
        ("qc.per_cell_metrics", {}),  # filter_cells reads its columns
        ("qc.filter_cells", {"min_genes": min_genes}),
        ("qc.filter_genes", {"min_cells": min_cells}),
        ("normalize.library_size", {"target_sum": target_sum}),
        ("normalize.log1p", {}),
        ("hvg.select", {"n_top": n_top_genes, "flavor": "dispersion",
                        "subset": True}),
        ("normalize.scale", {"max_value": 10.0}),
    ])


@_pipeline_recipe("pearson_residuals")
def pearson_residuals_pipeline(n_top_genes: int = 2000,
                               theta: float = 100.0,
                               n_components: int = 50, min_cells: int = 5
                               ) -> Pipeline:
    """scanpy's ``experimental.pp.recipe_pearson_residuals``: gene filter
    → pearson-residual HVG subset (of the raw counts) → analytic
    Pearson residuals → randomized PCA (4 power iterations: the
    residuals are standardised, so the spectrum's tail is flat)."""
    return Pipeline([
        ("util.snapshot_layer", {"layer": "counts"}),
        ("qc.filter_genes", {"min_cells": min_cells}),
        ("hvg.select", {"n_top": n_top_genes,
                        "flavor": "pearson_residuals", "theta": theta,
                        "subset": True}),
        ("normalize.pearson_residuals", {"theta": theta}),
        ("pca.randomized", {"n_components": n_components, "n_iter": 4}),
    ])


@_pipeline_recipe("atlas_knn")
def atlas_knn_pipeline(n_top_genes: int = 2000, n_components: int = 50,
                       k: int = 15, metric: str = "cosine",
                       target_sum: float = 1e4,
                       knn_strategy: str = "ring") -> Pipeline:
    """The atlas tail as one pipeline: count normalise → log1p →
    seurat_v3 HVG scores (no subset: every gene is scaled) → scale
    clipped at 10 → randomized PCA → multi-device kNN
    (``neighbors.knn_multichip`` over every card, or one CPU shard on
    the CPU)."""
    return Pipeline([
        ("normalize.library_size", {"target_sum": target_sum}),
        ("normalize.log1p", {}),
        ("hvg.select", {"n_top": n_top_genes, "flavor": "seurat_v3"}),
        ("normalize.scale", {"max_value": 10.0}),
        ("pca.randomized", {"n_components": n_components}),
        ("neighbors.knn_multichip", {"k": k, "metric": metric,
                                     "strategy": knn_strategy}),
    ])


@_pipeline_recipe("annotation_reference")
def annotation_reference_pipeline(n_components: int = 50,
                                  target_sum: float = 1e4) -> Pipeline:
    """A reference atlas for annotation: snapshot the raw counts →
    library-size normalise → log1p → randomized PCA, with no HVG subset
    and no scaling, so that the gene space stays that of raw-count
    queries."""
    return Pipeline([
        ("util.snapshot_layer", {"layer": "counts"}),
        ("normalize.library_size", {"target_sum": target_sum}),
        ("normalize.log1p", {}),
        ("pca.randomized", {"n_components": n_components}),
    ])


@_pipeline_recipe("graph_tail")
def graph_tail_pipeline(t: int = 3, mode: str = "umap",
                        reorder: bool = True,
                        jaccard: bool = False) -> Pipeline:
    """The post-kNN graph tail as one pipeline: [locality reorder] →
    connectivities → [jaccard] → diffusion operator → MAGIC imputation
    → [restore order].  With ``reorder`` the graph is RCM-permuted
    first, so the gathers of the graph kernels hit nearby rows, and the
    inverse permutation is applied at the end: results leave in the
    caller's row order.  Requires ``neighbors.knn``."""
    steps: list = []
    if reorder:
        steps.append(("graph.reorder", {}))
    steps.append(("graph.connectivities", {"mode": mode}))
    if jaccard:
        steps.append(("graph.jaccard", {}))
    steps.append(("graph.diffusion_operator", {}))
    steps.append(("impute.magic", {"t": t}))
    if reorder:
        steps.append(("graph.restore_order", {}))
    return Pipeline(steps)


# ----------------------------------------------------------------------
# One-call recipe ops
# ----------------------------------------------------------------------


@register("recipe.zheng17")
def recipe_zheng17(data: CellData, n_top_genes: int = 1000,
                   device=None) -> CellData:
    """One-call Zheng et al. 2017 preprocessing (``zheng17_pipeline``)."""
    return zheng17_pipeline(n_top_genes).run(data, device=device)


@register("recipe.seurat")
def recipe_seurat(data: CellData, n_top_genes: int = 2000,
                  min_genes: int = 200, min_cells: int = 3,
                  target_sum: float = 1e4, device=None) -> CellData:
    """One-call classic-Seurat preprocessing (``seurat_pipeline``)."""
    return seurat_pipeline(n_top_genes, min_genes, min_cells,
                           target_sum).run(data, device=device)


@register("recipe.pearson_residuals")
def recipe_pearson_residuals(data: CellData, n_top_genes: int = 2000,
                             theta: float = 100.0, n_components: int = 50,
                             device=None) -> CellData:
    """One-call Pearson-residuals workflow
    (``pearson_residuals_pipeline``)."""
    return pearson_residuals_pipeline(n_top_genes, theta,
                                      n_components).run(data, device=device)


@register("recipe.weinreb17")
def recipe_weinreb17(data: CellData, log: bool = True,
                     mean_threshold: float = 0.01,
                     cv_threshold: float = 2.0, n_comps: int = 50,
                     device=None) -> CellData:
    """One-call Weinreb et al. 2017 (SPRING) preprocessing: snapshot the
    counts → count normalise (to the median) → keep the genes with
    mean ≥ ``mean_threshold`` and coefficient of variation ≥
    ``cv_threshold`` on the normalised, unlogged counts → log1p (with
    ``log``) → z-score → randomized PCA (4 power iterations).  The
    moments and thresholds stay on the device; the keep mask is read on
    the host once (the subset's shape depends on it)."""
    from .ops.hvg import _gene_moments, select_genes_device
    from .ops.qc import _matrix_X

    dev = resolve_device(device)
    d = apply("util.snapshot_layer", data, layer="counts", device=dev)
    d = apply("normalize.library_size", d, target_sum=None, device=dev)
    mu, var, _ = _gene_moments(_matrix_X(d))
    cv = torch.sqrt(torch.clamp(var, min=0.0)) / torch.clamp(mu, min=1e-12)
    keep = ((mu >= mean_threshold) & (cv >= cv_threshold)).cpu().numpy()
    if not keep.any():
        raise ValueError(
            f"recipe.weinreb17: no gene passes mean>={mean_threshold} and "
            f"cv>={cv_threshold}; loosen the thresholds")
    d = select_genes_device(d, np.flatnonzero(keep), compact=True)
    if log:
        d = apply("normalize.log1p", d, device=dev)
    d = apply("normalize.scale", d, max_value=None, device=dev)
    return apply("pca.randomized", d, n_components=n_comps, n_iter=4,
                 device=dev)
