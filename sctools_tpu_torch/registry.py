"""The port's ``Transform`` operator registry.

Same surface as ``sctools_tpu/registry.py`` (``register``, ``get``,
``apply``, ``Transform``, ``Pipeline``) and the same dotted op names
(``"normalize.log1p"``), with one backend, ``"cuda"``: PyTorch on the
device the caller names.  It is a registry of its own; nothing here
registers into the reference's.

Every op takes ``device=``.  ``None`` means the card, and without a
card the op raises (``config.resolve_device``) instead of running on
the CPU; tests pass ``device="cpu"``.

``fusable=``, ``mem_cost=``, ``mask_aware=``, ``sharding=`` and
``collective=`` are accepted and recorded so that ops declare what the
reference's do, but nothing reads them yet: plans and buckets are not
ported.
"""

from __future__ import annotations

from typing import Callable

from .config import resolve_device

_REGISTRY: dict[str, dict[str, Callable]] = {}
_META: dict[str, dict[str, dict]] = {}

DEFAULT_BACKEND = "cuda"


class UnknownTransformError(KeyError):
    pass


class UnknownBackendError(KeyError):
    pass


def register(name: str, backend: str = DEFAULT_BACKEND, fusable=False,
             mem_cost=None, mask_aware=False, sharding=None,
             collective=False) -> Callable[[Callable], Callable]:
    """Decorator: register ``fn`` as the implementation of ``name`` for
    ``backend``.  ``fusable``, ``mem_cost``, ``mask_aware``,
    ``sharding`` and ``collective`` are recorded as declared (see
    ``sctools_tpu/registry.py:register`` for their meaning) and have no
    effect in this port yet."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(name, {})[backend] = fn
        _META.setdefault(name, {})[backend] = {
            "fusable": fusable, "mem_cost": mem_cost,
            "mask_aware": mask_aware, "sharding": sharding,
            "collective": collective}
        return fn

    return deco


def get(name: str, backend: str = DEFAULT_BACKEND) -> Callable:
    try:
        impls = _REGISTRY[name]
    except KeyError:
        raise UnknownTransformError(
            f"no transform named {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
    try:
        return impls[backend]
    except KeyError:
        raise UnknownBackendError(
            f"transform {name!r} has no {backend!r} backend; "
            f"available: {sorted(impls)}"
        ) from None


def names(backend: str | None = None) -> list[str]:
    if backend is None:
        return sorted(_REGISTRY)
    return sorted(n for n, impls in _REGISTRY.items() if backend in impls)


def metadata(name: str, backend: str = DEFAULT_BACKEND) -> dict:
    """The declarations ``register`` recorded for ``(name, backend)``."""
    get(name, backend)
    return dict(_META[name][backend])


def apply(name: str, data, *args, backend: str = DEFAULT_BACKEND,
          device=None, **kw):
    """Apply a registered transform to ``data`` and return the result."""
    return get(name, backend)(data, *args, device=device, **kw)


class Transform:
    """A named operator bound to a backend and fixed parameters.

    >>> t = Transform("normalize.library_size", target_sum=1e4)
    >>> out = t(celldata, device="cuda")
    """

    def __init__(self, name: str, backend: str = DEFAULT_BACKEND,
                 **params):
        self.name = name
        self.backend = backend
        self.params = params
        self._fn = get(name, backend)  # fail fast on unknown name/backend

    def __call__(self, data, device=None, **overrides):
        return self._fn(data, device=device, **{**self.params, **overrides})

    def with_backend(self, backend: str) -> "Transform":
        return Transform(self.name, backend=backend, **self.params)

    def __repr__(self):
        ps = ", ".join(f"{k}={v!r}" for k, v in self.params.items())
        return (f"Transform({self.name!r}, backend={self.backend!r}"
                f"{', ' + ps if ps else ''})")


class Pipeline:
    """An ordered chain of transforms applied to a dataset.  Steps are
    ``(name, params)`` tuples, names, or ``Transform`` objects."""

    def __init__(self, steps, backend: str | None = None):
        self.steps: list[Transform] = []
        for step in steps:
            if isinstance(step, Transform):
                self.steps.append(step)
            elif isinstance(step, str):
                self.steps.append(
                    Transform(step, backend=backend or DEFAULT_BACKEND))
            else:
                name, params = step
                self.steps.append(Transform(
                    name, backend=backend or DEFAULT_BACKEND, **params))

    def run(self, data, backend: str | None = DEFAULT_BACKEND, device=None,
            fuse: bool = False):
        """Run all steps on ``device`` (``None``: the card; raises when
        there is none).  The data moves to the device first and stays
        there between steps.  ``fuse=True`` (fused stages) is not
        ported yet."""
        if fuse:
            raise NotImplementedError(
                "fused pipelines are not ported to sctools_tpu_torch yet")
        device = resolve_device(device)
        data = data.to_device(device)
        for t in self.steps:
            if backend is not None and backend != t.backend:
                t = t.with_backend(backend)
            data = t(data, device=device)
        return data

    def __iter__(self):
        return iter(self.steps)

    def __repr__(self):
        return ("Pipeline([\n  " + ",\n  ".join(map(repr, self.steps))
                + "\n])")
