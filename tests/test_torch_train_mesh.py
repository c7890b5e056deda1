"""The train step on a (data, model) mesh of ranks against the reference's.

The reference side runs in subprocesses of this file run as a script with 4
fake CPU devices (``XLA_FLAGS``): its ``build_train_step`` on meshes of
those devices, GSPMD placing the state by its specs.  Meanwhile the port's
ranks run as gloo processes on the CPU (``launch.mesh.run_ranks``), each its
shard (``shard_model``) and its optimizer pieces (``shard_opt_state``).  The
smoke granite-3-8b and gemma2-9b (fp32) take 2 AdamW steps on (2, 2) and
(1, 4) under ISP, WSP and a mixed plan (WSP then ISP from repeat 1), at
B=4 x S=13 (which neither model axis divides), on the reference's weights
and ``SyntheticLM`` batches; rwkv6-3b on a data-only (2, 1) mesh (its
second step from the reference's state after the first: ``RESYNC``; run
again unsynced, against the port's one-rank steps), and one
``accum_steps=2`` case on (2, 2).

Held, at ``tests/test_torch_train.py``'s bounds: the losses and grad norms
(2e-6 relative), the parameters after each step (0.05 lr) and the moments
(1e-4 of each leaf's largest), gathered whole; each rank's moment pieces
against the reference's ``shardings["opt"]`` shard shapes; the collectives
of a step against a count from the shapes (the forward, remat's recompute,
the backward, the sums over ``model`` and ``data``, the norm, the ZeRO
gather); the dry-run's (2, 4) train cell of granite-3-8b counting the same.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticLM
from repro.models import init_params as jax_init_params

from repro_torch import tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.runtime.sharding import ShardPlan, _block, _spec_leaves, train_specs
from torch_parity import train_on_rank

AXES = ("data", "model")
B, S, STEPS = 4, 13, 2
LR, WARMUP, TOTAL = 1e-3, 2, 10             # tests/test_torch_train.py's
HYPER = dict(base_lr=LR, warmup=WARMUP, total_steps=TOTAL)
LOSS_RTOL, STATE_TOL, PARAM_TOL = 2e-6, 1e-4, 0.05
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x1": (2, 1)}
PLANS = {"isp": {}, "wsp": dict(p1="WSP", p2="WSP"),
         "mixed": dict(p1="WSP", p2="ISP", transition_repeat=1)}
# name -> (arch, mesh, plan, config overrides)
CASES = {f"{a}/{m}/{p}": (a, m, p, {}) for a in ("granite-3-8b", "gemma2-9b")
         for m in ("2x2", "1x4") for p in PLANS}
CASES["granite-3-8b/2x2/mixed/accum2"] = ("granite-3-8b", "2x2", "mixed", {"accum_steps": 2})
CASES["rwkv6-3b/2x1/isp"] = ("rwkv6-3b", "2x1", "isp", {})
# the reference's work, one subprocess a group, side by side
GROUPS = [[n for n in CASES if n.startswith("granite-3-8b/2x2")],
          [n for n in CASES if n.startswith("granite-3-8b/1x4")],
          [n for n in CASES if n.startswith("gemma2-9b/2x2")],
          [n for n in CASES if n.startswith("gemma2-9b/1x4")],
          [n for n in CASES if n.startswith("rwkv")]]
# Cases whose second step starts from the reference's state after the first.
# rwkv6-3b at S=13: the first AdamW update moves wk's elements whose gradient
# is within rounding of zero by up to +-lr, as rounding decides (0.034 lr
# between the reference and the port's one-rank step), and the second step's
# grad norm then differs by 8.8e-6 between those two one-rank steps, over
# the 2e-6 bound.  Re-synced, each step is held from the same state.  Each
# also runs unsynced (``<name>/unsynced``), its steps held to the port's own
# one-rank steps (``test_unsynced_steps_match_the_one_rank_step``): the
# difference is the one-rank step's, not the mesh's.
RESYNC = ("rwkv6-3b/2x1/isp",)


def _batches(vocab):
    data = SyntheticLM(vocab, seed=0)
    return [data.batch(s, B, S) for s in range(STEPS)]


def _in_spec(spec, axis) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e) for e in spec)


# ------------------------------------------------------------ the reference

def _reference_main(out_path: str, names: list[str]) -> None:
    """The reference's steps of ``names`` on 4 fake devices, saved to
    ``out_path``: per step the loss, grad norm, parameters and moments
    (leaves in order), and each moment leaf's shard shape and spec."""
    import jax.numpy as jnp
    from repro.launch.mesh import make_mesh as jax_make_mesh
    from repro.optim import make_optimizer
    from repro.runtime.sharding import ShardPlan as JaxPlan
    from repro.runtime.train import build_train_step

    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    for name in names:
        arch, mesh_name, plan_name, over = CASES[name]
        cfg = dataclasses.replace(jax_smoke_config(arch), **over)
        mesh = jax_make_mesh(MESHES[mesh_name], AXES)
        step, shardings = build_train_step(cfg, mesh, JaxPlan(AXES, **PLANS[plan_name]), **HYPER)
        params = jax_init_params(cfg, jax.random.PRNGKey(0))
        opt = make_optimizer(cfg.optimizer)[0](params)
        for i, (sh, leaf) in enumerate(zip(jax.tree.leaves(shardings["opt"].m),
                                           jax.tree.leaves(opt.m), strict=True)):
            out[f"{name}/shard/{i}"] = np.asarray(sh.shard_shape(leaf.shape))
            out[f"{name}/data/{i}"] = np.asarray(_in_spec(sh.spec, "data"))
        params = jax.device_put(params, shardings["params"])
        opt = jax.device_put(opt, shardings["opt"])
        for s, b in enumerate(_batches(cfg.vocab)):
            params, opt, met = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
            out[f"{name}/loss/{s}"] = np.asarray(met["loss"])
            out[f"{name}/grad_norm/{s}"] = np.asarray(met["grad_norm"])
            for what, tree_ in (("params", params), ("m", opt.m), ("v", opt.v)):
                for i, leaf in enumerate(jax.tree.leaves(tree_)):
                    out[f"{name}/{what}/{s}/{i}"] = np.asarray(leaf, np.float32)
    np.savez(out_path, **out)


def _start_reference(tmp_dir) -> list:
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join([src, os.path.dirname(__file__)])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for i, names in enumerate(GROUPS):
        path = os.path.join(tmp_dir, f"reference_{i}")
        with open(f"{path}.log", "w") as log:
            procs.append((path, subprocess.Popen([sys.executable, __file__, f"{path}.npz", *names],
                                                 env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, {case name: rank 0's results, every rank's})."""
    procs = _start_reference(str(tmp_path_factory.mktemp("train_mesh_reference")))
    try:
        payload = {}
        for arch in {a for a, *_ in CASES.values()}:
            cfg = jax_smoke_config(arch)
            params = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
            payload[arch] = (params, _batches(cfg.vocab))
        ranks, ref = {}, {}

        def run(mesh_name, resync=None):
            mine = [(n, a, PLANS[p], o) for n, (a, m, p, o) in CASES.items() if m == mesh_name]
            mine += [(f"{n}/unsynced", a, PLANS[p], o) for n, (a, m, p, o) in CASES.items()
                     if m == mesh_name and n in RESYNC]
            per_rank = run_ranks(train_on_rank, MESHES[mesh_name], AXES,
                                 {a: payload[a] for _, a, _, _ in mine}, mine, STEPS, HYPER,
                                 resync, device="cpu", verbose=False)
            for name, *_ in mine:
                ranks[name] = [r[name] for r in per_rank]

        def collect(path, proc):
            proc.wait(timeout=600)
            with open(f"{path}.log") as log:
                assert proc.returncode == 0, log.read()
            with np.load(f"{path}.npz") as f:
                ref.update(f)

        run("2x2")
        collect(*procs[-1])                  # the re-synced cases' reference
        resync = {}
        for name in RESYNC:
            n = _leaf_count(ref, name)
            resync[name] = {s + 1: tuple([ref[f"{name}/{w}/{s}/{i}"] for i in range(n)]
                                         for w in ("params", "m", "v"))
                            for s in range(STEPS - 1)}
        run("2x1", resync)
        one = {name: _one_rank_steps(CASES[name], payload[CASES[name][0]]) for name in RESYNC}
        run("1x4")
        for path, proc in procs[:-1]:
            collect(path, proc)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ref, ranks, one


def _one_rank_steps(case, payload):
    """The port's one-rank steps of ``case`` from the reference's weights, on
    one thread as each rank runs: the losses, grad norms, and the whole
    parameters and moments after each step (leaves in order, numpy)."""
    import torch

    from repro_torch.convert import params_from_jax
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train import build_train_step

    arch, _, plan_name, over = case
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    params, batches = payload
    model = params_from_jax(cfg, params, "cpu").train_params()
    opt = adamw_init(model.param_tree())
    step = build_train_step(cfg, ShardPlan(AXES, **PLANS[plan_name]), device="cpu", **HYPER)

    def whole(t):
        t = torch.stack(t.layers) if isinstance(t, tree.Stacked) else t
        return t.detach().numpy().copy()

    out = {"losses": [], "grad_norms": [], "params": [], "m": [], "v": []}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for b in batches:
            model, opt, met = step(model, opt, b)
            out["losses"].append(float(met["loss"]))
            out["grad_norms"].append(float(met["grad_norm"]))
            for what, tree_ in (("params", model.param_tree()), ("m", opt.m), ("v", opt.v)):
                out[what].append([whole(t) for t in tree.leaves(tree_)])
    finally:
        torch.set_num_threads(threads)
    return out


def _leaf_count(ref, name):
    return sum(1 for k in ref if k.startswith(f"{name}/shard/"))


# ------------------------------------------------------------ the results

@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_and_grad_norms_match_reference(runs, name):
    ref, ranks, _ = runs
    for res in ranks[name]:
        for s in range(STEPS):
            assert res["losses"][s] == pytest.approx(float(ref[f"{name}/loss/{s}"]),
                                                     rel=LOSS_RTOL), s
            assert res["grad_norms"][s] == pytest.approx(float(ref[f"{name}/grad_norm/{s}"]),
                                                         rel=LOSS_RTOL), s
        assert res["step"] == STEPS


@pytest.mark.parametrize("name", sorted(CASES))
def test_parameters_and_moments_match_reference(runs, name):
    """Every rank's parameters after each step within 0.05 lr, and its
    moments (gathered from the ranks' pieces) within 1e-4 of each leaf's
    largest entry."""
    ref, ranks, _ = runs
    n = _leaf_count(ref, name)
    for res in ranks[name]:
        for s in range(STEPS):
            for i in range(n):
                want = ref[f"{name}/params/{s}/{i}"]
                assert np.abs(res["params"][s][i] - want).max() <= PARAM_TOL * LR, (s, i)
                for what in ("m", "v"):
                    want = ref[f"{name}/{what}/{s}/{i}"]
                    err = np.abs(res[what][s][i] - want).max()
                    assert err <= STATE_TOL * (np.abs(want).max() or 1.0), (what, s, i, err)


@pytest.mark.parametrize("name", RESYNC)
def test_unsynced_steps_match_the_one_rank_step(runs, name):
    """A re-synced case run without re-syncing: every rank's losses, grad
    norms, parameters and moments after each step held to the port's own
    one-rank steps at the bounds above, so the data reduction and the ZeRO
    gather agree with one rank, step 2 included."""
    _, ranks, one = runs
    want = one[name]
    for res in ranks[f"{name}/unsynced"]:
        for s in range(STEPS):
            assert res["losses"][s] == pytest.approx(want["losses"][s], rel=LOSS_RTOL), s
            assert res["grad_norms"][s] == pytest.approx(want["grad_norms"][s], rel=LOSS_RTOL), s
            for i, w in enumerate(want["params"][s]):
                assert res["params"][s][i].shape == w.shape, (s, i)
                assert np.abs(res["params"][s][i] - w).max() <= PARAM_TOL * LR, (s, i)
            for what in ("m", "v"):
                for i, w in enumerate(want[what][s]):
                    assert res[what][s][i].shape == w.shape, (what, s, i)
                    err = np.abs(res[what][s][i] - w).max()
                    assert err <= STATE_TOL * (np.abs(w).max() or 1.0), (what, s, i, err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moment_pieces_have_the_reference_shard_shapes(runs, name):
    ref, ranks, _ = runs
    want = [tuple(ref[f"{name}/shard/{i}"]) for i in range(_leaf_count(ref, name))]
    for res in ranks[name]:
        assert res["piece_shapes"] == want


# ------------------------------------------------------------ collectives

def _partition(cfg, plan, layer):
    t = plan.transition_repeat
    return plan.p1 if t is None or layer // len(cfg.expanded_pattern) < t else plan.p2


def expected_train_calls(cfg, plan, shape, batch, seq, leaves, dt):
    """{(kind, axis, tag): [calls, bytes]} of one rank's train step, counted
    from the shapes.  ``leaves``: per parameter leaf in order, (its moment
    piece shape, whether its moments split over ``data``, the bytes of an
    element of its gradient and of its parameter).  ``dt``: the bytes of an
    activation element."""
    D, m = shape
    d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    A = cfg.accum_steps
    Bl = batch // A // D
    Sl = -(-seq // m)
    Sp = Sl * m
    kvl = KV // m if m <= KV else 1
    calls = {}

    def add(kind, axis, tag, nbytes, n=1):
        c = calls.setdefault((kind, axis, tag), [0, 0])
        c[0] += n
        c[1] += n * nbytes

    if m > 1:
        for _ in range(A):
            cur = plan.p1
            if cur == "ISP":
                add("all-reduce", "model", "embed", Bl * seq * d * dt)
            else:
                add("reduce-scatter", "model", "embed", Bl * Sl * d * dt)
                add("all-gather", "model", "embed:grad", Bl * Sp * d * dt)
            for layer in range(cfg.n_layers):
                part = _partition(cfg, plan, layer)
                if part != cur:
                    if cur == "WSP":
                        add("all-gather", "model", "transition", Bl * Sp * d * dt)
                    else:
                        add("all-gather", "model", "transition:grad", Bl * Sp * d * dt)
                    cur = part
                tag = f"blk{layer}"
                if part == "ISP":            # forward and remat's recompute, then backward
                    add("all-reduce", "model", f"{tag}:attn", Bl * seq * d * 4, 2)
                    add("all-reduce", "model", f"{tag}:ffn", Bl * seq * d * 4, 2)
                    add("all-reduce", "model", f"{tag}:attn_in:grad", Bl * seq * d * dt)
                    add("all-reduce", "model", f"{tag}:ffn_in:grad", Bl * seq * d * dt)
                    continue
                ws = {"wq": (d * H * hd, d * H * hd // m), "wk": (m * d * kvl * hd, d * kvl * hd),
                      "wv": (m * d * kvl * hd, d * kvl * hd),
                      "kv": (2 * Bl * Sp * KV * hd, 2 * Bl * Sl * KV * hd),
                      "wo": (H * hd * d, H * hd * d // m), "w1": (d * ff, d * ff // m),
                      "w2": (d * ff, d * ff // m)}
                if cfg.ffn_gated:
                    ws["w3"] = (d * ff, d * ff // m)
                for w, (gathered, block) in ws.items():
                    add("all-gather", "model", f"{tag}:{w}", gathered * dt, 2)
                    add("reduce-scatter", "model", f"{tag}:{w}:grad", block * dt)
            if cur == "WSP":
                add("all-gather", "model", "logits", Bl * Sp * d * dt)
                add("reduce-scatter", "model", "logits:grad", Bl * Sl * d * dt)
            else:
                add("all-reduce", "model", "head_in:grad", Bl * seq * d * dt)
            add("all-reduce", "model", "loss:max", Bl * seq * 4)
            add("all-reduce", "model", "loss", 2 * Bl * seq * 4)
        shared = m > KV
        partial = sum(2 * d for layer in range(cfg.n_layers) if _partition(cfg, plan, layer) == "WSP")
        partial += d if _partition(cfg, plan, cfg.n_layers - 1) == "WSP" else 0
        partial += 2 * KV * d * hd * cfg.n_layers if shared else 0
        if partial:
            add("all-reduce", "model", "grad:model", partial * 4)
        add("all-reduce", "model", "grad_norm", 8)
        if shared:
            R = cfg.pattern_repeats
            for _ in range(2 * len(cfg.expanded_pattern)):
                add("all-gather", "model", "zero", R * d * KV * hd * dt)
    if D > 1:
        add("all-reduce", "data", "loss", 4)
        add("all-reduce", "data", "grad_norm", 8)
        for piece, split, g_bytes, p_bytes in leaves:
            n = math.prod(piece)
            add("reduce-scatter" if split else "all-reduce", "data", "grad", n * g_bytes)
            if split:
                add("all-gather", "data", "zero", n * D * p_bytes)
    return calls


def _smoke_leaves(ref, name):
    """The reference's moment pieces of a smoke case (fp32: gradients and
    parameters 4 bytes an element)."""
    return [(tuple(ref[f"{name}/shard/{i}"]), bool(ref[f"{name}/data/{i}"]), 4, 4)
            for i in range(_leaf_count(ref, name))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_counted_from_shapes(runs, name):
    ref, ranks, _ = runs
    arch, mesh_name, plan_name, over = CASES[name]
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    want = expected_train_calls(cfg, ShardPlan(AXES, **PLANS[plan_name]), MESHES[mesh_name], B,
                                S, _smoke_leaves(ref, name), 4)
    for res in ranks[name]:
        assert res["calls"] == want


def _port_leaves(cfg, plan, mesh):
    """The moment pieces of the rank at ``mesh``'s coordinates by the port's
    spec functions, as ``expected_train_calls`` takes them."""
    shapes, o_specs = train_specs(cfg, plan, mesh)
    out = []
    for (_, spec), leaf in zip(_spec_leaves(o_specs.m), tree.leaves(shapes), strict=True):
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        piece = tuple(hi - lo for lo, hi in (_block(n, e, mesh)
                                             for n, e in zip(leaf.shape, entries)))
        size = leaf.dtype.itemsize
        out.append((piece, "data" in entries, size, size))
    return out


def test_dryrun_mesh_train_cell_counts_the_collectives():
    """A (2, 4) rank of granite-3-8b's train_4k cell traced on meta: the
    recorded collectives are the count from the shapes, and the flash
    forward and backward run once a layer (twice the forward: remat)."""
    res = dryrun.run_cell("granite-3-8b", "train_4k", mesh_shape=(2, 4))
    cfg = dataclasses.replace(get_config("granite-3-8b"), accum_steps=1)
    seq, batch, _ = dryrun.SHAPES["train_4k"]
    plan = ShardPlan(AXES, p1=res["plan"]["p1"], p2=res["plan"]["p2"],
                     transition_repeat=res["plan"]["transition_repeat"])
    mesh = make_mesh((2, 4), AXES, meta=True)
    want = expected_train_calls(cfg, plan, (2, 4), batch, seq, _port_leaves(cfg, plan, mesh), 2)
    by_kind = {}
    for (k, _, _), (n, b) in want.items():
        by_kind.setdefault(k, [0, 0])
        by_kind[k][0] += n
        by_kind[k][1] += b
    coll = res["collectives"]
    assert coll["bytes_by_kind"] == {k: b for k, (_, b) in by_kind.items()}
    assert coll["count_by_kind"] == {k: n for k, (n, _) in by_kind.items()}
    assert res["kernel_calls"]["flash_attention_kernel"] == 2 * cfg.n_layers
    assert res["kernel_calls"]["flash_attention_bwd_kernel"] == cfg.n_layers


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2:])
