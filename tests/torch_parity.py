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


def serve_cases_on_rank(mesh, payload, plans, max_len):
    """The prefill step and decode steps of every case of ``payload``
    (``{name: (arch, config overrides, params, tokens or None, frontend
    embeddings or None, caches, decode tokens, plan names)}``, the
    reference's numpy arrays) under each of its plans (``plans``: ``{plan
    name: ShardPlan keywords}``) on this rank.  Returns per (name, plan) the
    rank's logits shape, the gathered prefill and decode logits, the
    collectives of the prefill and of the first decode step, and the rank's
    cache shapes."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step
    from repro_torch.runtime.sharding import ShardPlan, gather_logits, shard_caches, shard_model

    def tensor(a):
        return None if a is None else torch.from_numpy(a)

    out = {}
    for name, (arch, over, params, tokens, femb, caches, dtoks, names) in payload.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        whole = params_from_jax(cfg, params, "cpu")
        B = dtoks.shape[1]
        S = femb.shape[1] if cfg.frontend == "audio_stub" else (
            tokens.shape[1] + (0 if femb is None else femb.shape[1]))
        for plan_name in names:
            plan = ShardPlan(AXES, **plans[plan_name])
            model = shard_model(whole, plan, mesh)
            prefill = build_prefill_step(cfg, plan, "cpu", mesh)
            args = {"none": (tensor(tokens),), "audio_stub": (tensor(femb),),
                    "vision_stub": (tensor(tokens), tensor(femb))}[cfg.frontend]
            mesh.comm.reset()
            local = prefill(model, *args)
            res = {"local_shape": tuple(local.shape), "calls": dict(mesh.comm.calls),
                   "logits": gather_logits(local, model.shard).numpy()}
            decode = build_decode_step(cfg, plan, B, max_len, "cpu", mesh)
            state = shard_caches(_caches(caches), model.shard)
            res["cache_shapes"] = [{n: tuple(t.shape) for n, t in slot.items()} for slot in state]
            res["init_shapes"] = [{n: tuple(t.shape) for n, t in slot.items()}
                                  for slot in model.init_kv_cache(B, max_len, torch.float32)]
            dec = []
            for t, tok in enumerate(dtoks):
                mesh.comm.reset()
                lg, state = decode(model, torch.from_numpy(tok), torch.full((B,), S + t), state)
                if t == 0:
                    res["decode_calls"] = dict(mesh.comm.calls)
                dec.append(gather_logits(lg, model.shard).numpy())
            res["decode"] = np.stack(dec)
            out[(name, plan_name)] = res
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


def moe_cases_on_rank(mesh, payload, plans, max_len):
    """The prefill step and the first decode step of every MoE case of
    ``payload`` (``{name: (arch, MoE config overrides, params, tokens,
    caches, decode tokens, plan names)}``, the reference's numpy arrays)
    under each of its plans on this rank.  Returns per (name, plan) what
    ``serve_cases_on_rank`` returns for those steps, the routing each
    step's MoE layers chose on this rank (``models.moe.routing_log``) and
    the shapes of the rank's pieces of the first MoE block's leaves."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models.moe import routing_log
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step
    from repro_torch.runtime.sharding import ShardPlan, gather_logits, shard_caches, shard_model

    def log(records):
        return [(tag, first, v.numpy(), i.numpy()) for tag, first, v, i in records]

    out = {}
    for name, (arch, moe_over, params, tokens, caches, dtoks, names) in payload.items():
        cfg = get_smoke_config(arch)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
        whole = params_from_jax(cfg, params, "cpu")
        B, S = tokens.shape
        for plan_name in names:
            plan = ShardPlan(AXES, **plans[plan_name])
            model = shard_model(whole, plan, mesh)
            prefill = build_prefill_step(cfg, plan, "cpu", mesh)
            mesh.comm.reset()
            with routing_log() as records:
                local = prefill(model, torch.from_numpy(tokens))
            res = {"local_shape": tuple(local.shape), "calls": dict(mesh.comm.calls),
                   "logits": gather_logits(local, model.shard).numpy(),
                   "routing": log(records)}
            blk = next(b for b in model.blocks if getattr(b, "moe", None) is not None)
            res["expert_shapes"] = {n: tuple(t.shape) for n, t in blk.moe.items()}
            decode = build_decode_step(cfg, plan, B, max_len, "cpu", mesh)
            state = shard_caches(_caches(caches), model.shard)
            mesh.comm.reset()
            with routing_log() as records:
                lg, state = decode(model, torch.from_numpy(dtoks[0]), torch.full((B,), S), state)
            res["decode_calls"] = dict(mesh.comm.calls)
            res["decode_routing"] = log(records)
            res["decode"] = gather_logits(lg, model.shard).numpy()
            out[(name, plan_name)] = res
    return out


# What a rank of tests/test_torch_pipeline.py runs: the merged pipeline on a
# (stage, data) mesh.

def stage_params(model) -> dict:
    """A StageModel's parameters as numpy: ``{"embed", "final_ln"[,
    "lm_head"], "layers": {layer: {dotted name: array}}}``."""
    out = {n: getattr(model, n).detach().numpy().copy()
           for n in ("embed", "final_ln", "lm_head") if getattr(model, n) is not None}
    out["layers"] = {li: {n: p.detach().numpy().copy() for n, p in blk.named_parameters()}
                     for li, blk in zip(model.layers, model.blocks)}
    return out


def pipeline_on_rank(mesh, payload, lr, psum_inputs):
    """On this rank of a (stage, data) mesh: for every arch of ``payload``
    (``{arch: (n_layers, params, tokens, labels, steps)}``, the reference's
    numpy arrays), the pipelined forward (this rank's logits, the gathered
    ones, the collectives it recorded) and ``steps`` SGD steps (the losses,
    the stage's parameters after the first and the last, the first step's
    collectives); then ``psum_compressed`` on this
    rank's data row of ``psum_inputs``, ``(gradients [rounds, n_data, ...],
    first residuals [n_data, ...])``, each round's residual the last one's
    result."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.runtime.compression import psum_compressed
    from repro_torch.runtime.pipeline import (StageModel, build_pipeline_train_step,
                                              gather_pipeline_logits, pipeline_forward)

    ns = mesh.shape["stage"]
    out = {}
    for arch, (n_layers, params, tokens, labels, n_steps) in payload.items():
        cfg = dataclasses.replace(get_smoke_config(arch), n_layers=n_layers, remat=False)
        model = StageModel(params_from_jax(cfg, params, "cpu"), ns, mesh.index("stage"))
        mesh.comm.reset()
        local = pipeline_forward(model, torch.from_numpy(tokens), mesh, ns)
        res = {"local_shape": tuple(local.shape), "calls": dict(mesh.comm.calls),
               "logits": gather_pipeline_logits(local, mesh).numpy()}
        if n_steps:
            step = build_pipeline_train_step(cfg, mesh, ns, tokens.shape[0], lr)
            batch = {"tokens": tokens, "labels": labels}
            losses = []
            for i in range(n_steps):
                mesh.comm.reset()
                model, loss = step(model, batch)
                losses.append(loss.item())
                if i == 0:
                    res["step_calls"] = dict(mesh.comm.calls)
                    res["params_1"] = stage_params(model)
            res["losses"] = losses
            res["params_n"] = stage_params(model)
        out[arch] = res
    mesh.comm.reset()
    gs, r0 = psum_inputs
    r = torch.from_numpy(r0[mesh.index("data")])
    rounds = []
    for g in gs:
        mean, r = psum_compressed(torch.from_numpy(g[mesh.index("data")]), r, "data", mesh.comm)
        rounds.append((mean.numpy(), r.numpy()))
    out["psum"] = {"rounds": rounds, "calls": dict(mesh.comm.calls)}
    return out


def prefill_on_rank(mesh, arch, params, tokens):
    """The smoke ``arch``'s prefill step on this rank under the default
    (ISP) plan over the mesh's own axes: the rank's logits and the
    collectives it recorded."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.runtime.serve import build_prefill_step
    from repro_torch.runtime.sharding import ShardPlan, shard_model

    cfg = get_smoke_config(arch)
    plan = ShardPlan(mesh.axis_names)
    model = shard_model(params_from_jax(cfg, params, "cpu"), plan, mesh)
    mesh.comm.reset()
    logits = build_prefill_step(cfg, plan, "cpu", mesh)(model, torch.from_numpy(tokens))
    return logits.numpy(), dict(mesh.comm.calls)


# What a rank of tests/test_torch_train_mesh.py runs: the train step on a
# (data, model) mesh.

def train_on_rank(mesh, payload, cases, steps, hyper, resync=None, save=None):
    """For each ``(name, arch, plan keywords, config overrides)`` of
    ``cases``: ``steps`` train steps of the smoke ``arch`` on this rank
    from the reference's weights (``payload[arch]``: (params, batches) as
    numpy), AdamW from zero moments.  ``resync[name][s]``: whole (params,
    m, v) leaves (in order) the rank's state is cut from before step ``s``.
    ``save[name]``: a directory the state after the last step is
    checkpointed into.  Returns per case the losses, grad norms, the whole
    parameters and moments after each step (gathered), the rank's moment
    piece shapes and the first step's recorded collectives."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.sharding import (ShardPlan, shard_model, shard_opt_state,
                                              train_layout)
    from repro_torch.runtime.train import build_train_step

    out = {}
    for name, arch, plan_kw, over in cases:
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        params, batches = payload[arch]
        whole = params_from_jax(cfg, params, "cpu")
        plan = ShardPlan(AXES, **plan_kw)
        model = shard_model(whole, plan, mesh).train_params()
        opt = shard_opt_state(adamw_init(whole.param_tree()), model)
        step = build_train_step(cfg, plan, device="cpu", mesh=mesh, **hyper)
        layout = train_layout(model)
        res = {"losses": [], "grad_norms": [], "params": [], "m": [], "v": [],
               "piece_shapes": [tuple(t.shape) for t in tree.leaves(opt.m)]}
        for s in range(steps):
            if s in (resync or {}).get(name, {}):
                ps, ms, vs = resync[name][s]
                layout.load_params(model, lambda _, it=iter(ps): torch.from_numpy(next(it)))
                layout.load_moments(opt.m, lambda _, it=iter(ms): torch.from_numpy(next(it)))
                layout.load_moments(opt.v, lambda _, it=iter(vs): torch.from_numpy(next(it)))
            mesh.comm.reset()
            model, opt, met = step(model, opt, batches[s])
            if s == 0:
                res["calls"] = dict(mesh.comm.calls)
            res["losses"].append(float(met["loss"]))
            res["grad_norms"].append(float(met["grad_norm"]))
            res["params"].append([t.detach().numpy().copy() for _, t in
                                  layout.whole_params(model)])
            res["m"].append([t.numpy().copy() for _, t in layout.whole_moments(opt.m)])
            res["v"].append([t.numpy().copy() for _, t in layout.whole_moments(opt.v)])
            res["step"] = int(opt.step)
        if name in (save or {}):
            from repro_torch.ckpt import save_checkpoint

            save_checkpoint(save[name], steps, (model, opt))
        out[name] = res
    return out


def restore_on_rank(mesh, arch, plan_kw, directory, step):
    """A fresh shard of the smoke ``arch`` and zero AdamW pieces on this
    rank, restored from the checkpoint of ``step`` in ``directory``;
    returns its whole parameters, moments (m, v) and step count."""
    import torch

    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.runtime.sharding import ShardPlan, shard_model, train_layout

    cfg = get_smoke_config(arch)
    model = shard_model(init_params(cfg, torch.Generator().manual_seed(1), "cpu"),
                        ShardPlan(AXES, **plan_kw), mesh).train_params()
    layout = train_layout(model)
    opt = layout.zero_moments("cpu")
    restore_checkpoint(directory, step, (model, opt))
    return ([t.detach().numpy().copy() for _, t in layout.whole_params(model)],
            [t.numpy().copy() for _, t in layout.whole_moments(opt.m)],
            [t.numpy().copy() for _, t in layout.whole_moments(opt.v)], int(opt.step))


def ckpt_on_rank(mesh, arch, dirs, steps, fail_at, every):
    """The smoke ``arch`` trained on this rank of a (data, model) mesh through
    ``ResilientTrainer`` (the data pipeline's batches, AdamW from zero
    pieces): uninterrupted into ``dirs["plain"]``, and with a failure
    injected at step ``fail_at`` into ``dirs["restart"]`` (checkpoints every
    ``every``); then the state restored from ``dirs["one_rank"]`` (a one-rank
    checkpoint of step ``steps``).  Returns the three states gathered whole
    (numpy, in flattening order) and the two runs' histories."""
    import torch

    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.ft import ResilientTrainer
    from repro_torch.models import init_params
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.sharding import shard_model, train_layout
    from repro_torch.runtime.train import build_train_step

    cfg = get_smoke_config(arch)
    plan = plan_for_cell(cfg, 16, 4, AXES, mesh.shape["model"], kind="train", use_dse=False)
    step = build_train_step(cfg, plan, base_lr=5e-3, warmup=2, device="cpu", mesh=mesh)

    def fresh():
        model = shard_model(init_params(cfg, torch.Generator().manual_seed(0), "cpu"), plan,
                            mesh).train_params()
        return model, train_layout(model).zero_moments("cpu")

    def state(model, opt):
        layout = train_layout(model)
        return ([t.numpy().copy() for _, t in layout.whole_params(model)]
                + [t.numpy().copy() for _, t in layout.whole_moments(opt.m)]
                + [t.numpy().copy() for _, t in layout.whole_moments(opt.v)] + [int(opt.step)])

    def batch_fn(s, it=make_batch_iterator(cfg, batch=4, seq=16, seed=0), seen={}):
        while s not in seen:
            i, b = next(it)
            seen[i] = b
        return seen[s]

    out = {}
    for name, fail in (("plain", None), ("restart", fail_at)):
        fired = []

        def injector(s):
            if s == fail and not fired:
                fired.append(s)
                raise RuntimeError("injected failure")

        trainer = ResilientTrainer(train_step=step, batch_fn=batch_fn, ckpt_dir=dirs[name],
                                   ckpt_every=every)
        model, opt, hist = trainer.run(*fresh(), n_steps=steps, failure_injector=injector)
        out[name] = (state(model, opt), [h["loss"] for h in hist], [h["step"] for h in hist])
    model, opt = fresh()
    restore_checkpoint(dirs["one_rank"], steps, (model, opt))
    out["one_rank"] = state(model, opt)
    return out
