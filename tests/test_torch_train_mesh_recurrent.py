"""The train step of the recurrent blocks and a frontend stub on a (data,
model) mesh of ranks against the reference's.

As ``tests/test_torch_train_mesh.py`` (whose bounds, batches and
hyperparameters these are): the reference's ``build_train_step`` runs in
subprocesses of this file run as a script with 4 fake CPU devices, the
port's ranks as gloo processes on the CPU.  The smoke rwkv6-3b and jamba
(``moe=None``: a dense FFN on every layer) take 2 AdamW steps on (2, 2)
and (1, 4) under ISP, WSP and a mixed plan (WSP then ISP from repeat 1),
and paligemma-3b (the vision stub's patches ahead of the tokens, one kv
head that every rank's query heads read) on (2, 2) mixed, at B=4 x S=13.
Every rwkv6-3b and jamba case's second step starts from the reference's
state after the first (``RESYNC``: their first AdamW update is sensitive to
rounding, ROADMAP C).  From that state rwkv6-3b's second step is
ill-conditioned in fp32: from the (1, 4) WSP case's state the grad norm
reads 8.823310 (the reference's mesh step), 8.823347 (its one-device
step), 8.823332 (the port's one-rank step) and 8.823375 (the port's mesh
step, ISP or WSP), a spread of 7.4e-6 relative, with layer 0's gradients
moving ~1e-5 together; so rwkv6-3b's later steps hold loss and grad norm
to ``SPREAD_RTOL`` (1e-5), its first step to 2e-6 as every other case.

Held: losses and grad norms (2e-6 relative), parameters after each step
(0.05 lr), moments (1e-4 of each leaf's largest), gathered whole; each
rank's moment pieces against the reference's shard shapes (mamba's
``in_proj`` piece is the rank's columns of its x half and z half, the
reference's shard shape); the collectives of a step against a count from
the shapes.
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

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.runtime.sharding import ShardPlan
from test_torch_train_mesh import (AXES, B, HYPER, LOSS_RTOL, LR, MESHES, PARAM_TOL, PLANS, S,
                                   STATE_TOL, STEPS, _in_spec, _leaf_count, _smoke_leaves)
from torch_parity import train_on_rank

# name -> (arch, config overrides on both packages' smoke configs, mesh, plan)
CASES = {f"{a}/{m}/{p}": (a, over, m, p) for a, over in (("rwkv6-3b", {}),
                                                         ("jamba-v0.1-52b", {"moe": None}))
         for m in ("2x2", "1x4") for p in PLANS}
CASES["paligemma-3b/2x2/mixed"] = ("paligemma-3b", {}, "2x2", "mixed")
# the reference's work, one subprocess a group, side by side (the re-synced
# cases' first: the port's steps start from their results)
GROUPS = [[n for n in CASES if n.startswith(g)]
          for g in ("rwkv6-3b/2x2", "rwkv6-3b/1x4", "jamba-v0.1-52b/2x2", "jamba-v0.1-52b/1x4",
                    "paligemma")]
RESYNC = tuple(n for n in CASES if not n.startswith("paligemma"))
# cases whose later steps are held to the spread of fp32 implementations
SPREAD = tuple(n for n in CASES if n.startswith("rwkv6-3b"))
SPREAD_RTOL = 1e-5


def _cfg(name, jax_side=False):
    arch, over, _, _ = CASES[name]
    return dataclasses.replace((jax_smoke_config if jax_side else get_smoke_config)(arch), **over)


def _batches(cfg):
    """``SyntheticLM``'s batches, and for the vision stub its patches ahead
    of the tokens (``frontend_batch``, as the data pipeline gives them)."""
    data = SyntheticLM(cfg.vocab, seed=0)
    if cfg.frontend == "none":
        return [data.batch(s, B, S) for s in range(STEPS)]
    return [data.frontend_batch(s, B, S, cfg.d_model, cfg.frontend_tokens) for s in range(STEPS)]


# ------------------------------------------------------------ the reference

def _reference_main(out_path: str, names: list[str]) -> None:
    """The reference's steps of ``names`` on 4 fake devices, saved to
    ``out_path`` as ``tests/test_torch_train_mesh.py``'s are."""
    import jax.numpy as jnp
    from repro.launch.mesh import make_mesh as jax_make_mesh
    from repro.optim import make_optimizer
    from repro.runtime.sharding import ShardPlan as JaxPlan
    from repro.runtime.train import build_train_step

    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    for name in names:
        _, _, mesh_name, plan_name = CASES[name]
        cfg = _cfg(name, jax_side=True)
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
        for s, b in enumerate(_batches(cfg)):
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
    """(the reference's arrays, {case name: every rank's results})."""
    procs = _start_reference(str(tmp_path_factory.mktemp("train_mesh_recurrent_reference")))
    try:
        payload = {}                             # by arch: each takes one config here
        for name, (arch, *_) in CASES.items():
            cfg = _cfg(name, jax_side=True)
            params = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
            payload[arch] = (params, _batches(cfg))
        ref = {}

        def collect(path, proc):
            proc.wait(timeout=600)
            with open(f"{path}.log") as log:
                assert proc.returncode == 0, log.read()
            with np.load(f"{path}.npz") as f:
                ref.update(f)

        for path, proc in procs[:4]:             # the re-synced cases
            collect(path, proc)
        resync = {}
        for name in RESYNC:
            n = _leaf_count(ref, name)
            resync[name] = {s + 1: tuple([ref[f"{name}/{w}/{s}/{i}"] for i in range(n)]
                                         for w in ("params", "m", "v"))
                            for s in range(STEPS - 1)}
        ranks = {}
        for mesh_name in ("2x2", "1x4"):
            mine = [(n, a, PLANS[p], o) for n, (a, o, m, p) in CASES.items() if m == mesh_name]
            per_rank = run_ranks(train_on_rank, MESHES[mesh_name], AXES,
                                 {a: payload[a] for _, a, _, _ in mine}, mine, STEPS, HYPER, resync,
                                 device="cpu", verbose=False)
            for name, *_ in mine:
                ranks[name] = [r[name] for r in per_rank]
        collect(*procs[4])
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ref, ranks


# ------------------------------------------------------------ the results

@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_and_grad_norms_match_reference(runs, name):
    ref, ranks = runs
    for res in ranks[name]:
        for s in range(STEPS):
            rtol = SPREAD_RTOL if s and name in SPREAD else LOSS_RTOL
            for what, got in (("loss", res["losses"][s]), ("grad_norm", res["grad_norms"][s])):
                assert got == pytest.approx(float(ref[f"{name}/{what}/{s}"]), rel=rtol), (what, s)
        assert res["step"] == STEPS


@pytest.mark.parametrize("name", sorted(CASES))
def test_parameters_and_moments_match_reference(runs, name):
    """Every rank's moments (gathered from the ranks' pieces) within 1e-4 of
    each leaf's largest entry, and its parameters after each step within
    0.05 lr wherever that moment bound fixes the update's sign: AdamW's
    first step from zero moments moves an element by lr m / sqrt(v) = +-lr
    whatever its gradient's size, so where the first moment lies within
    the bound of zero (a gradient within rounding of zero: rwkv6-3b's wk,
    jamba's FFN, ROADMAP C) rounding picks the sign, and such an element is
    held to the 2 lr (+ weight decay) two opposite steps apart."""
    ref, ranks = runs
    n = _leaf_count(ref, name)
    for res in ranks[name]:
        for s in range(STEPS):
            for i in range(n):
                m = ref[f"{name}/m/{s}/{i}"]
                for what in ("m", "v"):
                    want = ref[f"{name}/{what}/{s}/{i}"]
                    err = np.abs(res[what][s][i] - want).max()
                    assert err <= STATE_TOL * (np.abs(want).max() or 1.0), (what, s, i, err)
                want = ref[f"{name}/params/{s}/{i}"]
                err = np.abs(res["params"][s][i] - want)
                fixed = np.abs(m) > STATE_TOL * (np.abs(m).max() or 1.0)
                assert err[fixed].max(initial=0.0) <= PARAM_TOL * LR, (s, i)
                assert err.max() <= 2.1 * LR, (s, i)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moment_pieces_have_the_reference_shard_shapes(runs, name):
    ref, ranks = runs
    want = [tuple(ref[f"{name}/shard/{i}"]) for i in range(_leaf_count(ref, name))]
    for res in ranks[name]:
        assert res["piece_shapes"] == want


# ------------------------------------------------------------ collectives

def _partition(cfg, plan, layer):
    t = plan.transition_repeat
    return plan.p1 if t is None or layer // len(cfg.expanded_pattern) < t else plan.p2


def expected_train_calls(cfg, plan, shape, batch, seq, leaves, dt):
    """{(kind, axis, tag): [calls, bytes]} of one rank's train step of any
    block kind (no accumulation), counted from the shapes: each forward
    collective twice (the forward and remat's recompute) and its transpose
    once (``runtime/collectives.py``), as ``tests/test_torch_train_mesh.py``
    counts attention and the FFN; the recurrent mixers' as
    ``tests/test_torch_multirank_recurrent.py`` counts their forward; then
    the sums over ``model`` (rwkv's whole leaves among them) and ``data``,
    the norm and the ZeRO gathers.  ``seq``: every position (the vision
    stub's patches included)."""
    D, m = shape
    d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    Bl = batch // D
    Sl = -(-seq // m)
    Sp = Sl * m
    kvl = KV // m if m <= KV else 1
    R, N = max(1, d // 16), cfg.mamba_d_state
    kinds = cfg.block_kinds()
    calls = {}

    def add(kind, axis, tag, nbytes, n=1):
        c = calls.setdefault((kind, axis, tag), [0, 0])
        c[0] += n
        c[1] += n * nbytes

    def twice(kind, tag, nbytes, grad_kind, grad_bytes):
        add(kind, "model", tag, nbytes, 2)
        if grad_kind:
            add(grad_kind, "model", f"{tag}:grad", grad_bytes)

    if m > 1:
        cur = plan.p1
        if cfg.frontend != "audio_stub":
            P = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
            if cur == "ISP":
                add("all-reduce", "model", "embed", Bl * (seq - P) * d * dt)
            else:
                add("reduce-scatter", "model", "embed", Bl * Sl * d * dt)
                add("all-gather", "model", "embed:grad", Bl * Sp * d * dt)
        for layer, kind in enumerate(kinds):
            part = _partition(cfg, plan, layer)
            if part != cur:
                if cur == "WSP":
                    add("all-gather", "model", "transition", Bl * Sp * d * dt)
                else:
                    add("all-gather", "model", "transition:grad", Bl * Sp * d * dt)
                cur = part
            tag = f"blk{layer}"
            wsp = part == "WSP"
            if kind in ("attn", "local"):
                if not wsp:
                    twice("all-reduce", f"{tag}:attn", Bl * seq * d * 4, None, 0)
                    add("all-reduce", "model", f"{tag}:attn_in:grad", Bl * seq * d * dt)
                else:
                    for w, (gathered, block) in {
                            "wq": (d * H * hd, d * H * hd // m),
                            "wk": (m * d * kvl * hd, d * kvl * hd),
                            "wv": (m * d * kvl * hd, d * kvl * hd),
                            "kv": (2 * Bl * Sp * KV * hd, 2 * Bl * Sl * KV * hd),
                            "wo": (H * hd * d, H * hd * d // m)}.items():
                        twice("all-gather", f"{tag}:{w}", gathered * dt, "reduce-scatter",
                              block * dt)
            elif kind == "rwkv":
                for mix in ("tm_in", "cm_in"):
                    if wsp:
                        twice("all-gather", f"{tag}:{mix}", Bl * Sp * d * dt, "reduce-scatter",
                              Bl * Sl * d * dt)
                    else:
                        add("all-reduce", "model", f"{tag}:{mix}:grad", Bl * seq * d * dt)
                if wsp:
                    twice("reduce-scatter", f"{tag}:tm", Bl * Sl * d * 4, "all-gather",
                          Bl * Sp * d * 4)
                else:
                    twice("all-reduce", f"{tag}:tm", Bl * seq * d * 4, None, 0)
                twice("reduce-scatter", f"{tag}:cm_v", Bl * seq * d // m * 4, "all-gather",
                      Bl * seq * d * 4)
                twice("all-gather", f"{tag}:cm", Bl * seq * d * dt,
                      "reduce-scatter" if wsp else None, Bl * seq * d // m * dt)
                continue
            else:                                    # mamba
                if wsp:
                    twice("all-gather", f"{tag}:mamba_in", Bl * Sp * d * dt, "reduce-scatter",
                          Bl * Sl * d * dt)
                    twice("reduce-scatter", f"{tag}:mamba", Bl * Sl * d * 4, "all-gather",
                          Bl * Sp * d * 4)
                else:
                    add("all-reduce", "model", f"{tag}:mamba_in:grad", Bl * seq * d * dt)
                    twice("all-reduce", f"{tag}:mamba", Bl * seq * d * 4, None, 0)
                twice("all-reduce", f"{tag}:x_proj", Bl * seq * (R + 2 * N) * 4, "all-reduce",
                      Bl * seq * (R + 2 * N) * 4)
            if not wsp:
                twice("all-reduce", f"{tag}:ffn", Bl * seq * d * 4, None, 0)
                add("all-reduce", "model", f"{tag}:ffn_in:grad", Bl * seq * d * dt)
            else:
                for w in ("w1", "w2", "w3")[:3 if cfg.ffn_gated else 2]:
                    twice("all-gather", f"{tag}:{w}", d * ff * dt, "reduce-scatter",
                          d * ff // m * dt)
        if cur == "WSP":
            add("all-gather", "model", "logits", Bl * Sp * d * dt)
            add("reduce-scatter", "model", "logits:grad", Bl * Sl * d * dt)
        else:
            add("all-reduce", "model", "head_in:grad", Bl * seq * d * dt)
        add("all-reduce", "model", "loss:max", Bl * seq * 4)     # labels cover every position
        add("all-reduce", "model", "loss", 2 * Bl * seq * 4)
        shared = m > KV and any(k in ("attn", "local") for k in kinds)
        partial = sum(2 * d for layer in range(cfg.n_layers)
                      if _partition(cfg, plan, layer) == "WSP")
        partial += d if _partition(cfg, plan, cfg.n_layers - 1) == "WSP" else 0
        partial += sum(2 * KV * d * hd for k in kinds if k in ("attn", "local")) if shared else 0
        partial += sum((5 + 1 + 64 + 1) * d for k in kinds if k == "rwkv")   # mu, w0, w_lora_a, ln_x
        if partial:
            add("all-reduce", "model", "grad:model", partial * 4)
        add("all-reduce", "model", "grad_norm", 8)
        if shared:
            Rp = cfg.pattern_repeats
            for k in cfg.expanded_pattern:
                if k in ("attn", "local"):
                    add("all-gather", "model", "zero", Rp * d * KV * hd * dt, 2)
    if D > 1:
        add("all-reduce", "data", "loss", 4)
        add("all-reduce", "data", "grad_norm", 8)
        for piece, split, g_bytes, p_bytes in leaves:
            n = math.prod(piece)
            add("reduce-scatter" if split else "all-reduce", "data", "grad", n * g_bytes)
            if split:
                add("all-gather", "data", "zero", n * D * p_bytes)
    return calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_counted_from_shapes(runs, name):
    ref, ranks = runs
    _, _, mesh_name, plan_name = CASES[name]
    want = expected_train_calls(_cfg(name), ShardPlan(AXES, **PLANS[plan_name]),
                                MESHES[mesh_name], B, S, _smoke_leaves(ref, name), 4)
    for res in ranks[name]:
        assert res["calls"] == want


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2:])
