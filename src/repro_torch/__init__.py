"""PyTorch + CUDA port of the Scope serving stack for one NVIDIA H100.

``repro`` (JAX) is the reference; this package imports nothing of it and no
JAX.  Entry points take a ``device`` that defaults to ``"cuda"`` and raise
when CUDA is missing; the CPU runs only when asked for (``device="cpu"``).

The front door is :mod:`repro_torch.api`, exported lazily as
``repro_torch.scope`` (as ``repro.scope`` in the JAX package)::

    from repro_torch import scope

    solution = scope.solve(scope.problem("resnet50", "mcm64"))
"""
from importlib import import_module

from .device import resolve_device  # noqa: F401

__all__ = ["scope", "api", "serving", "solve", "problem", "Problem", "Solution",
           "resolve_device"]

_API_NAMES = {
    "solve", "problem", "Problem", "Solution", "Deployment",
    "WorkloadSpec", "PackageSpec", "SearchOptions", "SolutionCache",
    "register_strategy", "available_strategies", "solve_many",
}


def __getattr__(name):
    if name in ("scope", "api"):
        mod = import_module(".api", __name__)
        globals()["scope"] = globals()["api"] = mod
        return mod
    if name == "serving":
        mod = import_module(".serving", __name__)
        globals()["serving"] = mod
        return mod
    if name in _API_NAMES:
        value = getattr(import_module(".api", __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _API_NAMES | {"scope", "api", "serving"})
