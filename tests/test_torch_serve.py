"""The port's serving slice against the JAX reference on the CPU.

Prefill step, prompt ingest through the decode step and 8 greedy tokens on
the same converted weights, the reference on a 1x1 mesh.  Prefill logits at
1e-4 (same math, another summation order); greedy tokens identical.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.mesh import single_device_mesh
from repro.models import init_kv_cache as jax_init_kv_cache
from repro.models import init_params as jax_init_params
from repro.runtime import serve as jserve
from repro.runtime.planner import plan_for_cell as jax_plan_for_cell
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_kv_cache, init_params
from repro_torch.runtime import serve as tserve
from repro_torch.runtime.planner import plan_for_cell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_greedy(cfg, params, prompt, steps):
    mesh = single_device_mesh()
    B, S = prompt.shape
    plan = jax_plan_for_cell(cfg, S + steps, B, ("data", "model"), 1, kind="decode")
    dstep, _ = jserve.build_decode_step(cfg, mesh, plan, batch=B, max_len=S + steps)
    caches = jax_init_kv_cache(cfg, B, S + steps, jnp.float32)
    for t in range(S):
        logits, caches = dstep(params, jnp.asarray(prompt[:, t:t + 1]),
                               jnp.full((B,), t, jnp.int32), caches)
    toks, _ = jserve.greedy_generate(cfg, params, dstep, caches,
                                     jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None],
                                     S, steps)
    return np.asarray(toks)


def _torch_greedy(cfg, model, prompt, steps):
    B, S = prompt.shape
    plan = plan_for_cell(cfg, S + steps, B, ("data", "model"), 1, kind="decode")
    dstep = tserve.build_decode_step(cfg, plan, batch=B, max_len=S + steps, device="cpu")
    caches = init_kv_cache(cfg, B, S + steps, torch.float32, "cpu")
    for t in range(S):
        logits, caches = dstep(model, torch.from_numpy(prompt[:, t:t + 1]),
                               torch.full((B,), t), caches)
    toks, _ = tserve.greedy_generate(cfg, model, dstep, caches,
                                     torch.argmax(logits[:, -1], -1)[:, None], S, 8)
    return toks.numpy()


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-9b", "rwkv6-3b", "jamba-v0.1-52b",
                                  "granite-moe-1b-a400m"])
def test_prefill_and_greedy_decode_match_jax(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 12))

    jplan = jax_plan_for_cell(jcfg, 12, 2, ("data", "model"), 1, kind="prefill", use_dse=False)
    jpf, _ = jserve.build_prefill_step(jcfg, single_device_mesh(), jplan)
    tplan = plan_for_cell(tcfg, 12, 2, ("data", "model"), 1, kind="prefill", use_dse=False)
    assert (tplan.p1, tplan.p2, tplan.transition_repeat, tplan.dp) == \
        (jplan.p1, jplan.p2, jplan.transition_repeat, jplan.dp)
    tpf = tserve.build_prefill_step(tcfg, tplan, device="cpu")
    np.testing.assert_allclose(tpf(model, torch.from_numpy(prompt)).numpy(),
                               np.asarray(jpf(jparams, jnp.asarray(prompt))),
                               rtol=1e-4, atol=1e-4)

    np.testing.assert_array_equal(_torch_greedy(tcfg, model, prompt, 8),
                                  _jax_greedy(jcfg, jparams, prompt, 8))


def test_multimodel_steps_cover_each_model():
    cfgs = [get_smoke_config("granite-3-8b"), get_smoke_config("gemma2-9b")]
    plans = {c.name: plan_for_cell(c, 16, 2, ("data", "model"), 1, kind="decode") for c in cfgs}
    fleet = tserve.build_multimodel_steps(cfgs, plans, batch=2, max_len=16, device="cpu")
    assert set(fleet) == {c.name for c in cfgs}
    for cfg in cfgs:
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        logits = fleet[cfg.name]["prefill"](model, torch.zeros(2, 5, dtype=torch.int64))
        assert logits.shape == (2, 5, cfg.padded_vocab) and torch.isfinite(logits).all()
        caches = init_kv_cache(cfg, 2, 16, torch.float32, "cpu")
        logits, _ = fleet[cfg.name]["decode"](model, torch.zeros(2, 1, dtype=torch.int64),
                                              torch.zeros(2, dtype=torch.int64), caches)
        assert logits.shape == (2, 1, cfg.padded_vocab)
        with pytest.raises(ValueError):      # cache of the wrong size
            fleet[cfg.name]["decode"](model, torch.zeros(2, 1, dtype=torch.int64),
                                      torch.zeros(2, dtype=torch.int64),
                                      init_kv_cache(cfg, 2, 8, torch.float32, "cpu"))


def test_planner_dse_branch_not_ported():
    cfg = get_smoke_config("granite-3-8b")
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        plan_for_cell(cfg, 32, 2, ("data", "model"), 1, kind="prefill")


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite-3-8b",
         "--smoke", "--device", "cpu", "--tokens", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "generated (4, 4)" in res.stdout


def test_launcher_runs_rwkv_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "rwkv6-3b",
         "--smoke", "--device", "cpu", "--tokens", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "generated (4, 4)" in res.stdout


def test_rwkv_decode_step_checks_batch_not_length():
    """An rwkv state has no sequence axis: the step checks its batch only."""
    cfg = get_smoke_config("rwkv6-3b")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = plan_for_cell(cfg, 16, 2, ("data", "model"), 1, kind="decode")
    step = tserve.build_decode_step(cfg, plan, batch=2, max_len=16, device="cpu")
    tok, pos = torch.zeros(2, 1, dtype=torch.int64), torch.zeros(2, dtype=torch.int64)
    caches = init_kv_cache(cfg, 2, 5, torch.float32, "cpu")
    logits, out = step(model, tok, pos, caches)
    assert out is caches and logits.shape == (2, 1, cfg.padded_vocab)
    assert caches[0]["S"].abs().sum() > 0              # state written in place
    with pytest.raises(ValueError, match="batch"):
        step(model, tok, pos, init_kv_cache(cfg, 3, 16, torch.float32, "cpu"))


def test_launcher_runs_jamba_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "jamba-v0.1-52b",
         "--smoke", "--device", "cpu", "--tokens", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "generated (4, 4)" in res.stdout


def test_mamba_decode_step_checks_batch_not_length():
    """A mamba state (h, conv) has no sequence axis: the step checks its
    batch only, and writes the state in place."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = plan_for_cell(cfg, 16, 2, ("data", "model"), 1, kind="decode")
    step = tserve.build_decode_step(cfg, plan, batch=2, max_len=16, device="cpu")
    tok, pos = torch.zeros(2, 1, dtype=torch.int64), torch.zeros(2, dtype=torch.int64)
    caches = init_kv_cache(cfg, 2, 16, torch.float32, "cpu")
    mamba = [c for c in caches if "h" in c]
    assert len(mamba) == 7 and all(set(c) == {"h", "conv"} for c in mamba)
    assert mamba[0]["h"].shape == (cfg.pattern_repeats, 2, 2 * cfg.d_model, cfg.mamba_d_state)
    assert mamba[0]["conv"].shape == (cfg.pattern_repeats, 2, cfg.mamba_d_conv - 1,
                                      2 * cfg.d_model)
    logits, out = step(model, tok, pos, caches)
    assert out is caches and logits.shape == (2, 1, cfg.padded_vocab)
    assert all(c["h"].abs().sum() > 0 and c["conv"].abs().sum() > 0 for c in mamba)
    with pytest.raises(ValueError, match="batch"):
        step(model, tok, pos, init_kv_cache(cfg, 3, 16, torch.float32, "cpu"))


def test_launcher_refuses_weights_larger_than_the_card(monkeypatch):
    """jamba-v0.1-52b at full depth (95.8 GiB of bf16 weights) is refused
    before anything is allocated, naming its bytes against the card's."""
    class Props:
        total_memory = 80 * 10 ** 9

    def no_alloc(*args, **kwargs):
        raise AssertionError("weights allocated before the fit check")

    monkeypatch.setattr(launch_serve, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props())
    monkeypatch.setattr(launch_serve, "init_params", no_alloc)
    with pytest.raises(RuntimeError, match=r"95\.8 GiB.*74\.5 GiB"):
        launch_serve.main(["--arch", "jamba-v0.1-52b"])
    cut = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=16)
    launch_serve.check_weights_fit(cut, Props.total_memory)          # 48.4 GiB fits
    with pytest.raises(RuntimeError, match="granite-moe"):
        launch_serve.check_weights_fit(get_config("granite-moe-1b-a400m"), 2 * 2 ** 30)


def test_launcher_flow_in_process():
    cfg = get_smoke_config("gemma2-9b")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    res = launch_serve.serve(cfg, model, batch=2, prompt_len=5, tokens=3,
                             cache_dtype=torch.float32)
    assert res["tokens"].shape == (2, 3)
    assert int(res["tokens"].max()) < cfg.padded_vocab


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cfg = get_smoke_config("granite-3-8b")
    plan = plan_for_cell(cfg, 16, 2, ("data", "model"), 1, kind="decode")
    calls = [
        lambda: tserve.build_prefill_step(cfg, plan),
        lambda: tserve.build_decode_step(cfg, plan),
        lambda: tserve.build_multimodel_steps([cfg], {cfg.name: plan}),
        lambda: init_params(cfg, torch.Generator()),
        lambda: init_kv_cache(cfg, 2, 16),
        lambda: params_from_jax(cfg, {}),
        lambda: launch_serve.main(["--arch", "granite-3-8b", "--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
