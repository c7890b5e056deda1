"""Helpers for the parity tests of the port against the JAX package: a
structural form of results built from two packages' classes, so that
``canon(port_value) == canon(reference_value)`` compares them field for
field (floats with ``==``)."""
import dataclasses
import enum
import math

import numpy as np

# The one wall-clock field of a result: the host seconds a solve took, which
# differ between any two runs, not between the packages.
TIMING_KEYS = frozenset({"dse_s"})


def canon(x):
    """``x`` as nested tuples of plain values: a dataclass by its class name
    and fields, another object by its class name and attributes, a dict by
    its sorted items, an enum by its value; the ``TIMING_KEYS`` are left out
    at every depth."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, canon(getattr(x, f.name)))
            for f in dataclasses.fields(x) if f.name not in TIMING_KEYS))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, dict):
        items = [(canon(k), canon(v)) for k, v in x.items() if k not in TIMING_KEYS]
        return ("dict", tuple(sorted(items, key=repr)))
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted((canon(v) for v in x), key=repr)))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return canon(x.item())
    if isinstance(x, float) and math.isnan(x):
        return ("float", "nan")
    if x is None or isinstance(x, (str, int, float, bool)):
        return x
    slots = [s for c in type(x).__mro__ for s in getattr(c, "__slots__", ())]
    if hasattr(x, "__dict__") or slots:   # e.g. MetricsRegistry, Histogram
        attrs = dict(getattr(x, "__dict__", {}))
        attrs.update((s, getattr(x, s)) for s in slots if hasattr(x, s))
        return (type(x).__name__, canon(attrs))
    raise TypeError(f"no canonical form for {type(x).__name__}")
