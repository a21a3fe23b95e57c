"""Pipeline-shaped recipes: ``recipe_pipeline(name, **kw)`` builds the
named recipe's ``Pipeline``, as ``sctools_tpu/recipes.py`` does.

Ported so far: ``graph_tail``.  The others (``seurat``, ``zheng17``,
``pearson_residuals``, ``atlas_knn``, ``annotation_reference``) and the
one-call ``recipe.*`` ops wait in ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

from .registry import Pipeline

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
            f"no pipeline-shaped recipe named {name!r} in the port; "
            f"ported: {sorted(PIPELINES)} (the others wait in ROADMAP.md "
            "Queue 1 item 8)") from None
    return factory(**kw)


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
