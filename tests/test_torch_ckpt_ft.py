"""Checkpoints, the fault-tolerant runner and the data pipeline of the port.

The reference's ``tests/test_ckpt_ft.py`` cases on the port's modules, then
checkpoints across the packages (a reference checkpoint restored into the
port and the other way round, fp32 and bf16: the same keys, shapes, dtypes
and sha256 layout), then ``tests/test_system.py``'s story on the port:
plan -> train -> injected failure -> restart from checkpoint -> decode.
Last, the launcher and the checkpoints on a (data, model) mesh of gloo
ranks: the 2 x 2 launcher's losses are the one-rank run's, a restart on
2 x 2 is the uninterrupted run bit for bit, and a checkpoint of either
restores on the other.
"""
import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as ref_restore
from repro.ckpt import save_checkpoint as ref_save
from repro.configs import get_smoke_config as ref_smoke
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch.mesh import single_device_mesh
from repro.models import init_params as ref_init
from repro.optim import OptState as RefOptState
from repro.optim import make_optimizer as ref_make_optimizer
from repro.runtime.planner import plan_for_cell as ref_plan
from repro.runtime.train import build_train_step as ref_build_train_step

from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import prune_checkpoints
from repro_torch.configs import get_smoke_config
from repro_torch.convert import opt_state_to_jax, params_to_jax
from repro_torch.core.hw import get_hw
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.ft import ResilientTrainer, StragglerMonitor
from repro_torch.models import init_kv_cache, init_params
from repro_torch.optim import make_optimizer
from repro_torch.runtime.planner import plan_for_cell
from repro_torch.runtime.serve import build_decode_step, greedy_generate
from repro_torch.runtime.train import build_train_step
from repro_torch.serving.faults import FaultInjector
from torch_parity import ckpt_on_rank


def small_tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones(5, dtype=torch.bfloat16), "d": torch.zeros((), dtype=torch.int32)},
    }


def _leaves(tree):
    from repro_torch import tree as pytree

    return pytree.leaves(tree)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = small_tree()
        save_checkpoint(str(tmp_path), 7, tree, meta={"note": "x"})
        assert latest_step(str(tmp_path)) == 7
        target = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.bfloat16),
                                                "d": torch.ones((), dtype=torch.int32)}}
        restored, manifest = restore_checkpoint(str(tmp_path), 7, target)
        assert manifest["step"] == 7 and manifest["meta"] == {"note": "x"}
        assert restored is target
        for a, b in zip(_leaves(tree), _leaves(target), strict=True):
            assert torch.equal(a, b)

    def test_corruption_detected(self, tmp_path):
        tree = small_tree()
        path = save_checkpoint(str(tmp_path), 1, tree)
        victim = os.path.join(path, "leaf_00000.npy")
        with open(victim, "r+b") as f:
            f.seek(64)
            f.write(b"\xff\xff\xff")
        with pytest.raises(IOError, match="corruption"):
            restore_checkpoint(str(tmp_path), 1, small_tree())

    def test_prune_keeps_latest(self, tmp_path):
        tree = small_tree()
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(str(tmp_path), s, tree)
        prune_checkpoints(str(tmp_path), keep=2)
        assert latest_step(str(tmp_path)) == 5
        assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [4, 5]

    def test_shape_and_dtype_mismatch_raise(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, small_tree())
        bad = small_tree()
        bad["a"] = torch.zeros(4, 3)
        with pytest.raises(ValueError, match="a"):
            restore_checkpoint(str(tmp_path), 1, bad)
        bad = small_tree()
        bad["b"]["c"] = torch.zeros(5)
        with pytest.raises(ValueError, match="bfloat16"):
            restore_checkpoint(str(tmp_path), 1, bad)


class TestResilientTrainer:
    def _mini_problem(self, tmp_path):
        """Quadratic 'training': params -> params - lr * grad."""
        def train_step(params, opt, batch):
            loss = torch.mean((params["w"] - batch["target"]) ** 2)
            params = {"w": params["w"] - 0.1 * 2 * (params["w"] - batch["target"])}
            return params, opt, {"loss": loss}

        def batch_fn(step):
            return {"target": torch.ones(4) * 2.0}

        return ResilientTrainer(train_step=train_step, batch_fn=batch_fn,
                                ckpt_dir=str(tmp_path), ckpt_every=5)

    def test_runs_and_checkpoints(self, tmp_path):
        tr = self._mini_problem(tmp_path)
        params, opt, hist = tr.run({"w": torch.zeros(4)}, {}, n_steps=12)
        assert len(hist) == 12
        assert hist[-1]["loss"] < hist[0]["loss"]
        assert latest_step(str(tmp_path)) == 10

    def test_restart_from_failure(self, tmp_path):
        tr = self._mini_problem(tmp_path)
        fired = []

        def injector(step):
            if step == 7 and step not in fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        params, opt, hist = tr.run({"w": torch.zeros(4)}, {}, n_steps=12,
                                   failure_injector=injector)
        # failed at 7 -> restored to checkpoint 5 -> replayed to the end
        steps = [h["step"] for h in hist]
        assert steps.count(6) == 2 and steps.count(7) == 2
        assert steps[-1] == 12

    def test_poison_step_aborts(self, tmp_path):
        tr = self._mini_problem(tmp_path)

        def injector(step):
            if step == 3:
                raise RuntimeError("always fails")

        with pytest.raises(RuntimeError, match="failed"):
            tr.run({"w": torch.zeros(4)}, {}, n_steps=12, failure_injector=injector)

    def test_trainer_accepts_fault_injector(self, tmp_path):
        """The port's serving FaultInjector drives the runner through its
        ``step_hook`` (1 step = 1 simulated second)."""
        inj = FaultInjector(get_hw("mcm16_hetero"), scripted=(("zone:little", 7.0, 8.0),))
        params, _, hist = self._mini_problem(tmp_path).run(
            {"w": torch.zeros(4)}, {}, n_steps=12, failure_injector=inj)
        steps = [h["step"] for h in hist]
        assert steps.count(7) == 2 and steps[-1] == 12


class TestStraggler:
    def test_flags_outlier(self):
        mon = StragglerMonitor(threshold=2.0)
        for i in range(10):
            assert not mon.observe(i, 0.1)
        assert mon.observe(10, 0.5)
        assert mon.flagged and mon.flagged[0][0] == 10


class TestSyntheticData:
    def test_deterministic(self):
        src = SyntheticLM(vocab=101, seed=3)
        np.testing.assert_array_equal(src.batch(5, 4, 16)["tokens"], src.batch(5, 4, 16)["tokens"])

    def test_labels_shift(self):
        d = SyntheticLM(vocab=101, seed=3, noise=0.0).batch(0, 2, 8)
        np.testing.assert_array_equal(d["labels"], (31 * d["tokens"] + 7) % 101)

    def test_learnable_structure(self):
        d = SyntheticLM(vocab=101, seed=0, noise=0.1).batch(1, 8, 128)
        assert (d["labels"] == (31 * d["tokens"] + 7) % 101).mean() > 0.8

    def test_same_stream_as_reference(self):
        cfg = get_smoke_config("granite-3-8b")
        it = make_batch_iterator(cfg, batch=4, seq=16, seed=2, start_step=3)
        for step in (3, 4):
            i, got = next(it)
            want = RefSyntheticLM(cfg.vocab, seed=2).batch(step, 4, 16)
            assert i == step
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])


    @pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-medium"])
    def test_frontend_batches(self, arch):
        """The stubs' batches: vision ``frontend_tokens`` patches ahead of
        S - frontend_tokens tokens, the reference's stream; audio a frame at
        each of S positions and no tokens (the reference's iterator gives
        the audio smoke config 4 frames: ROADMAP C-ref-7).  Labels cover S."""
        cfg = get_smoke_config(arch)
        _, got = next(make_batch_iterator(cfg, batch=4, seq=16, seed=2))
        assert got["labels"].shape == (4, 16)
        if cfg.frontend == "vision_stub":
            P = cfg.frontend_tokens
            assert got["tokens"].shape == (4, 16 - P)
            assert got["frontend_embeds"].shape == (4, P, cfg.d_model)
            want = RefSyntheticLM(cfg.vocab, seed=2).frontend_batch(0, 4, 16, cfg.d_model, P)
            for k in ("tokens", "labels", "frontend_embeds"):
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert "tokens" not in got
            assert got["frontend_embeds"].shape == (4, 16, cfg.d_model)


# ------------------------------------------------- checkpoints across packages

B, S, LR = 4, 32, 1e-3


def _ref_side(jc):
    """Reference params / opt after one reference train step, and its step fn."""
    plan = ref_plan(jc, S, B, ("data", "model"), 1, kind="train", use_dse=False)
    step, shardings = ref_build_train_step(jc, single_device_mesh(), plan, base_lr=LR,
                                           warmup=2, total_steps=10)
    params = jax.device_put(ref_init(jc, jax.random.PRNGKey(0)), shardings["params"])
    opt = jax.device_put(ref_make_optimizer(jc.optimizer)[0](params), shardings["opt"])
    data = RefSyntheticLM(jc.vocab, seed=0)
    params, opt, _ = step(params, opt, {k: jnp.asarray(v) for k, v in data.batch(0, B, S).items()})
    return params, opt, step, data


def _port_side(tc):
    """A port model and optimizer state (from another seed than the
    reference's), and the port's step."""
    plan = plan_for_cell(tc, S, B, ("data", "model"), 1, kind="train", use_dse=False)
    step = build_train_step(tc, plan, base_lr=LR, warmup=2, total_steps=10, device="cpu")
    model = init_params(tc, torch.Generator().manual_seed(7), "cpu").train_params()
    opt = make_optimizer(tc.optimizer)[0](model.param_tree())
    return model, opt, step


def _assert_trees_equal(got, want):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, dtype):
    """The reference's save_checkpoint of (params, OptState) after one step
    restores into the port bit for bit, and one more port step then matches
    one more reference step (fp32: the train-step tolerances of
    test_torch_train.py; bf16: loss 1e-4 relative, grad norm 1e-3, moments 3e-2
    of each leaf's largest entry -- bf16 gradients round at other places in
    the two frameworks, measured 5e-5 / 5e-4 / 2.3e-2)."""
    jc, tc = replace(ref_smoke("granite-3-8b"), param_dtype=dtype), \
        replace(get_smoke_config("granite-3-8b"), param_dtype=dtype)
    jparams, jopt, jstep, data = _ref_side(jc)
    ref_save(str(tmp_path), 1, (jparams, jopt), meta={"loss": 1.0})
    model, opt, tstep = _port_side(tc)
    (model, opt), manifest = restore_checkpoint(str(tmp_path), 1, (model, opt))
    assert manifest["step"] == 1 and int(opt.step) == 1
    _assert_trees_equal(params_to_jax(model), jparams)
    _assert_trees_equal(opt_state_to_jax(opt), jopt)

    b = data.batch(1, B, S)
    jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
    model, opt, tm = tstep(model, opt, b)
    loss_tol, norm_tol, state_tol = (2e-6, 2e-6, 1e-4) if dtype == "float32" else (1e-4, 1e-3, 3e-2)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=loss_tol)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=norm_tol)
    for got, want in ((opt_state_to_jax(opt).m, jopt.m), (opt_state_to_jax(opt).v, jopt.v)):
        for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
            w = np.asarray(w)
            assert np.abs(np.asarray(a) - w).max() <= state_tol * np.abs(w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, dtype):
    """The port's checkpoint after one port step restores through the
    reference's restore_checkpoint into its (params, OptState) bit for bit,
    with the manifest the reference writes for the same pytree: the same
    keys in the same order, shapes, dtypes and file layout."""
    jc, tc = replace(ref_smoke("granite-3-8b"), param_dtype=dtype), \
        replace(get_smoke_config("granite-3-8b"), param_dtype=dtype)
    model, opt, tstep = _port_side(tc)
    model, opt, _ = tstep(model, opt, RefSyntheticLM(jc.vocab, seed=0).batch(0, B, S))
    save_checkpoint(str(tmp_path / "port"), 1, (model, opt), meta={"loss": 1.0})

    template = ref_init(jc, jax.random.PRNGKey(1))
    jtemplate = (template, ref_make_optimizer(jc.optimizer)[0](template))
    (jparams, jopt), manifest = ref_restore(str(tmp_path / "port"), 1, jtemplate)
    assert isinstance(jopt, RefOptState) and int(jopt.step) == 1
    _assert_trees_equal(jparams, params_to_jax(model))
    _assert_trees_equal(RefOptState(*opt_state_to_jax(opt)), jopt)

    ref_save(str(tmp_path / "ref"), 1, (jparams, jopt), meta={"loss": 1.0})
    with open(tmp_path / "port" / "step_00000001" / "manifest.json") as f:
        port_manifest = json.load(f)
    with open(tmp_path / "ref" / "step_00000001" / "manifest.json") as f:
        ref_manifest = json.load(f)
    assert port_manifest == ref_manifest          # keys, files, shapes, dtypes, sha256
    assert any(e["dtype"] == dtype for e in port_manifest["leaves"])


# ------------------------------------------------------------ the system story

def test_train_ckpt_restart_serve_on_the_port(tmp_path):
    """tests/test_system.py's story on the port: plan -> train steps ->
    injected failure -> restart from checkpoint -> greedy decoding from the
    trained model, with the loss dropping (learning the Markov chain)."""
    cfg = get_smoke_config("granite-3-8b")
    plan = plan_for_cell(cfg, 32, 8, ("data", "model"), 1, kind="train", use_dse=False)
    step = build_train_step(cfg, plan, base_lr=5e-3, warmup=5, device="cpu")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").train_params()
    opt = make_optimizer(cfg.optimizer)[0](model.param_tree())

    it = make_batch_iterator(cfg, batch=8, seq=32, seed=0)
    batches = {}

    def batch_fn(s):
        while s not in batches:
            i, b = next(it)
            batches[i] = b
        return batches[s]

    def injector(s):
        if s == 12 and not getattr(injector, "fired", False):
            injector.fired = True
            raise RuntimeError("injected failure")

    trainer = ResilientTrainer(train_step=step, batch_fn=batch_fn, ckpt_dir=str(tmp_path),
                               ckpt_every=5)
    model, opt, hist = trainer.run(model, opt, n_steps=20, failure_injector=injector)
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0], losses
    assert injector.fired and [h["step"] for h in hist].count(11) == 2
    assert int(opt.step) == 20 and latest_step(str(tmp_path)) == 20

    dplan = plan_for_cell(cfg, 16, 4, ("data", "model"), 1, kind="decode")
    dstep = build_decode_step(cfg, dplan, batch=4, max_len=16, device="cpu")
    caches = init_kv_cache(cfg, 4, 16, torch.float32, "cpu")
    toks, _ = greedy_generate(cfg, model, dstep, caches,
                              prompt_last_token=torch.ones(4, 1, dtype=torch.int64),
                              start_pos=0, steps=4)
    assert toks.shape == (4, 4)
    assert int(toks.max()) < cfg.padded_vocab


# ------------------------------------------------------------ the launcher

def test_train_launcher_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    hist = main(["--arch", "granite-3-8b", "--smoke", "--device", "cpu", "--steps", "6",
                 "--batch", "4", "--seq", "16", "--ckpt-every", "3",
                 "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [1, 2, 3, 4, 5, 6]
    assert latest_step(str(tmp_path)) == 6
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-medium"])
def test_train_launcher_trains_the_frontend_stubs(tmp_path, arch):
    """The data pipeline's embeddings reach the step: finite losses and
    grad norms; and on the pipeline's next batch every per-layer gradient
    is finite and non-zero (:func:`check_gradients`), the audio stub's
    embedding table, which its prefill does not use, left out."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch.train import check_gradients, main
    from repro_torch.models import init_params

    hist = main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
                 "--seq", "16", "--ckpt-every", "100", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    cfg = get_smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").train_params()
    _, batch = next(make_batch_iterator(cfg, batch=4, seq=16))
    n_unused = 1 if arch == "musicgen-medium" else 0
    assert check_gradients(model, batch, torch.device("cpu")) == \
        len(model.flat_params()) - n_unused


def test_train_launcher_refuses_what_one_card_cannot_hold(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import check_training_fits, main, training_bytes

    cfg = get_config("granite-3-8b")
    assert training_bytes(cfg) == cfg.n_params * 12      # bf16 weights, grads + AdamW
    with pytest.raises(RuntimeError, match="fewer layers"):
        check_training_fits(cfg, 80 * 10**9)
    check_training_fits(replace(cfg, n_layers=16), 80 * 10**9)
    hist = main(["--arch", "granite-3-8b", "--smoke", "--device", "cpu", "--mesh", "2x1",
                 "--steps", "2", "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [1, 2]


# ------------------------------------------------------------ on a mesh

def test_train_launcher_on_a_mesh_gives_the_one_rank_losses(tmp_path):
    """``--mesh 2x2`` on the CPU: 4 gloo ranks, each its shard and optimizer
    pieces; the losses and grad norms are the one-rank run's (2e-6
    relative, tests/test_torch_train.py's bound: the same sums in another
    order)."""
    from repro_torch.launch.train import main

    flags = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu", "--steps", "3",
             "--batch", "4", "--seq", "16", "--ckpt-every", "100"]
    one = main(flags + ["--ckpt-dir", str(tmp_path / "one")])
    mesh = main(flags + ["--mesh", "2x2", "--ckpt-dir", str(tmp_path / "mesh")])
    assert [h["step"] for h in mesh] == [1, 2, 3]
    for a, b in zip(mesh, one, strict=True):
        assert a["loss"] == pytest.approx(b["loss"], rel=2e-6)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=2e-6)


def _one_rank_state(model, opt):
    from repro_torch import tree as pytree

    whole = [(torch.stack(x.layers) if isinstance(x, pytree.Stacked) else x).detach().numpy()
             for x in pytree.leaves(model.param_tree())]
    return (whole + [t.numpy() for t in pytree.leaves(opt.m)]
            + [t.numpy() for t in pytree.leaves(opt.v)] + [int(opt.step)])


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_mesh_checkpoints_restart_and_restore_across_meshes(tmp_path):
    """On (2, 2), checkpoints every 3 steps: a run with a failure injected at
    step 4 restarts from step 3 and ends bit for bit where the
    uninterrupted run ends; a one-rank checkpoint restores on the mesh, and
    the mesh's on one rank, each equal to the state that wrote it."""
    from repro_torch.launch.mesh import run_ranks

    arch, steps, every = "granite-3-8b", 6, 3
    cfg = get_smoke_config(arch)
    plan = plan_for_cell(cfg, 16, 4, ("data", "model"), 1, kind="train", use_dse=False)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").train_params()
    opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
    step = build_train_step(cfg, plan, base_lr=5e-3, warmup=2, device="cpu")
    it = make_batch_iterator(cfg, batch=4, seq=16, seed=0)
    model, opt, hist = ResilientTrainer(train_step=step, batch_fn=lambda s: next(it)[1],
                                        ckpt_dir=str(tmp_path / "one_rank"),
                                        ckpt_every=every).run(model, opt, n_steps=steps)
    one_rank = _one_rank_state(model, opt)
    dirs = {k: str(tmp_path / k) for k in ("plain", "restart", "one_rank")}
    ranks = run_ranks(ckpt_on_rank, (2, 2), ("data", "model"), arch, dirs, steps, 4, every,
                      device="cpu", verbose=False)
    for res in ranks:
        plain, restart = res["plain"], res["restart"]
        assert restart[2] == [1, 2, 3, 4, 4, 5, 6]    # step 4 failed, then replayed
        assert restart[1][-2:] == plain[1][-2:]
        _assert_same(restart[0], plain[0])
        _assert_same(res["one_rank"], one_rank)
    model = init_params(cfg, torch.Generator().manual_seed(1), "cpu").train_params()
    opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
    restore_checkpoint(dirs["plain"], steps, (model, opt))
    _assert_same(_one_rank_state(model, opt), ranks[0]["plain"][0])
