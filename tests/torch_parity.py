"""Helpers for the parity tests of the port against the JAX package: a
structural form of results built from two packages' classes, so that
``canon(port_value) == canon(reference_value)`` compares them field for
field (floats with ``==``)."""
import dataclasses
import enum
import math

import numpy as np
import torch

# Torch's intra-op threads in each test worker: the tier-1 run has 6
# workers on 8 cores, and at torch's default (one thread a core) they
# oversubscribe the cores.  Every worker imports this module while it
# collects the test files, so this sets it once for the whole run.  With 2,
# tests/test_faults.py and the largest port files ran side by side under
# -n 6 in 326 s against 673 s at the default, on an 8-core host.
torch.set_num_threads(2)

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


# ------------------------------------------------------------------ ranks
# What a rank of tests/test_torch_multirank.py runs.  It lives here, in a
# module that imports no JAX, because each rank is a process that imports
# the module its function comes from.

AXES = ("data", "model")


def _caches(caches):
    from repro_torch.convert import to_torch

    return tuple({n: to_torch(a, "cpu") for n, a in slot.items()} for slot in caches)


def serve_on_rank(mesh, payload, plans, max_len):
    """Every plan's prefill step and decode steps of every arch of
    ``payload`` (``{arch: (params, tokens, caches, decode tokens)}``, the
    reference's numpy arrays) on this rank: the gathered logits and the
    collectives each step recorded."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step
    from repro_torch.runtime.sharding import ShardPlan, gather_logits, shard_caches, shard_model

    out = {}
    for arch, (params, tokens, caches, dtoks) in payload.items():
        cfg = get_smoke_config(arch)
        whole = params_from_jax(cfg, params, "cpu")
        B, S = tokens.shape
        for name, kw in plans.items():
            plan = ShardPlan(AXES, **kw)
            model = shard_model(whole, plan, mesh)
            prefill = build_prefill_step(cfg, plan, "cpu", mesh)
            mesh.comm.reset()
            local = prefill(model, torch.from_numpy(tokens))
            res = {"local_shape": tuple(local.shape), "calls": dict(mesh.comm.calls),
                   "logits": gather_logits(local, model.shard).numpy()}
            decode = build_decode_step(cfg, plan, B, max_len, "cpu", mesh)
            state = shard_caches(_caches(caches), model.shard)
            dec = []
            for t, tok in enumerate(dtoks):
                mesh.comm.reset()
                lg, state = decode(model, torch.from_numpy(tok), torch.full((B,), S + t), state)
                if t == 0:
                    res["decode_calls"] = dict(mesh.comm.calls)
                dec.append(gather_logits(lg, model.shard).numpy())
            res["decode"] = np.stack(dec)
            out[(arch, name)] = res
    return out


def serve_rows_on_rank(mesh, arch, params, tokens, caches, dtoks, max_len):
    """One arch's prefill and decode steps on a data-only mesh: the
    collectives the prefill recorded, the gathered prefill and decode
    logits."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step
    from repro_torch.runtime.sharding import ShardPlan, gather_logits, shard_caches, shard_model

    cfg = get_smoke_config(arch)
    plan = ShardPlan(AXES)
    B, S = tokens.shape
    model = shard_model(params_from_jax(cfg, params, "cpu"), plan, mesh)
    mesh.comm.reset()
    logits = build_prefill_step(cfg, plan, "cpu", mesh)(model, torch.from_numpy(tokens))
    calls = dict(mesh.comm.calls)
    state = shard_caches(_caches(caches), model.shard)
    decode = build_decode_step(cfg, plan, B, max_len, "cpu", mesh)
    dec = []
    for t, tok in enumerate(dtoks):
        lg, state = decode(model, torch.from_numpy(tok), torch.full((B,), S + t), state)
        dec.append(gather_logits(lg, model.shard).numpy())
    return calls, gather_logits(logits, model.shard).numpy(), np.stack(dec)
