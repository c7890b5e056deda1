"""The merged pipeline (``repro_torch.runtime.pipeline``) against the reference's.

The reference side runs once, in subprocesses of this file run as a script
with 8 fake CPU devices (``XLA_FLAGS``), one per group of configs so that
they run side by side: its ``pipeline_forward``, its plain ``forward`` one
microbatch at a time, 5 steps of ``build_pipeline_train_step`` (lr 5e-2)
and ``psum_compressed`` under ``shard_map`` over ``data``, saved to an
``.npz``.  Meanwhile the port's ranks run as gloo processes on the CPU
(``launch.mesh.run_ranks``) on (stage 4, data 2) and (stage 2, data 1),
smoke configs in fp32 at ``n_layers = 4 x`` the pattern length with the
reference's weights (``convert.params_from_jax``) and the reference's
``n_micro, mb, S = 4, 4, 16``.

Held: the logits to both references at ``tests/test_torch_model.py``'s
1e-4 (granite-3-8b and gemma2-9b on both meshes; rwkv6-3b, jamba and
granite-moe on (2, 1)); the losses at ``tests/test_torch_train.py``'s 2e-6
relative; the parameters after 1 and 5 steps within ``PARAM_TOL`` (the two
frameworks sum the gradients in another order), granite-moe's too, and
rwkv6-3b's and jamba's after one step (``ONE_STEP``); each rank's
``psum_compressed`` mean and residual exactly; the collectives each rank
recorded against a count from the shapes; the schedule's beats; and a
repeat count the stages do not divide raises.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh, make_pipeline_mesh, run_ranks
from repro_torch.models.model import forward, init_params
from repro_torch.runtime.pipeline import (StageModel, gpipe_beats, pipeline_forward,
                                          stage_layers)
from torch_parity import pipeline_on_rank

TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_torch_model.py's
LOSS_RTOL = 2e-6                        # tests/test_torch_train.py's
# Parameters after 1 and 5 SGD steps at lr 5e-2 (fp32): the gradients are
# the same sums in another order (microbatches accumulated one by one,
# data ranks summed by gloo).  The largest difference read on the CPU: 3.0e-8
# after one step, 6.0e-8 after five (two fp32 ulps of the weights' 0.1-0.3).
PARAM_TOL = dict(rtol=0, atol=5e-7)
N_MICRO, MB, S = 4, 4, 16
LR, N_STEPS = 5e-2, 5
MESHES = {"4x2": (4, 2), "2x1": (2, 1)}
FORWARD = {"granite-3-8b": ("4x2", "2x1"), "gemma2-9b": ("4x2", "2x1"),
           "rwkv6-3b": ("2x1",), "jamba-v0.1-52b": ("2x1",),
           "granite-moe-1b-a400m": ("2x1",)}
TRAIN = ("granite-3-8b", "gemma2-9b",        # untied head; tied, pattern of two
         "granite-moe-1b-a400m")              # MoE layers
# Held after one step only: rwkv6-3b and jamba's smoke configs are
# ill-conditioned in fp32 (ROADMAP C): their losses drift from the
# reference's past the bound by step 5 (rwkv6-3b 3.9 %, jamba 1.8e-5)
# while each step's parameters agree within a few fp32 ulps.
ONE_STEP = ("rwkv6-3b", "jamba-v0.1-52b")
# rwkv6-3b's fp32 gradients sit up to 6.3e-3 of a leaf's scale from float64
# in either package (ROADMAP C), so after its one step each parameter leaf is
# held within 1e-2 of the leaf's largest update (read on the CPU: 1.2e-3 of
# a gradient at lr 5e-2 on the head), not within PARAM_TOL.
RWKV_UPDATE_RTOL = 1e-2
# the reference's work, one subprocess a group
GROUPS = (("granite-3-8b", "psum"), ("gemma2-9b",), ("jamba-v0.1-52b",),
          ("rwkv6-3b", "granite-moe-1b-a400m"))
PSUM_SHAPE, PSUM_ROUNDS = (8, 33), 2


def _cfg(jax_side: bool, arch: str):
    base = (jax_smoke_config if jax_side else get_smoke_config)(arch)
    return dataclasses.replace(base, n_layers=4 * len(base.expanded_pattern), remat=False)


def _batch(cfg):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (N_MICRO, MB, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (N_MICRO, MB, S)).astype(np.int32)
    return tokens, labels


def _psum_inputs():
    """Gradients [rounds, n_data, ...] whose scales differ by data rank, and
    the first residuals [n_data, ...]."""
    rng = np.random.default_rng(3)
    nd = MESHES["4x2"][1]
    scale = np.arange(1, nd + 1, dtype=np.float32).reshape(1, nd, 1, 1)
    g = (rng.standard_normal((PSUM_ROUNDS, nd, *PSUM_SHAPE)) * scale).astype(np.float32)
    r = (0.01 * rng.standard_normal((nd, *PSUM_SHAPE))).astype(np.float32)
    return g, r


def _steps(arch) -> int:
    """The SGD steps ``arch`` takes: ``N_STEPS`` (``TRAIN``), 1 (``ONE_STEP``) or none."""
    return N_STEPS if arch in TRAIN else int(arch in ONE_STEP)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _flat(t, f"{prefix}{n}/").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


# ------------------------------------------------------------ the reference

def _reference_main(out_path: str, names: list[str]) -> None:
    """The reference's side of the tests for ``names`` (archs, "psum"), on
    8 fake devices; saved to ``out_path``."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as JP
    from repro.launch.mesh import make_pipeline_mesh as jax_pipeline_mesh
    from repro.runtime.compression import psum_compressed as jax_psum_compressed
    from repro.runtime.pipeline import build_pipeline_train_step, pipeline_forward as jax_pf

    assert len(jax.devices()) == 8, jax.devices()
    out = {}
    for name in names:
        if name == "psum":
            mesh = jax_pipeline_mesh(*MESHES["4x2"])

            def body(g, r):
                mean, res = jax_psum_compressed(g[0], r[0], "data")
                return mean[None], res[None]

            f = jax.jit(shard_map(body, mesh=mesh, in_specs=(JP("data"), JP("data")),
                                  out_specs=(JP("data"), JP("data")), check_rep=False))
            gs, r = _psum_inputs()
            for i, g in enumerate(gs):
                mean, r = f(g, r)
                out[f"psum/{i}/mean"], out[f"psum/{i}/res"] = np.asarray(mean), np.asarray(r)
            continue
        cfg = _cfg(True, name)
        params = jax_init_params(cfg, jax.random.PRNGKey(0))
        tokens, labels = _batch(cfg)
        plain = jax.jit(lambda p, t, cfg=cfg: jax_forward(p, cfg, t)[0])
        out[f"{name}/plain"] = np.stack([np.asarray(plain(params, tokens[i]))
                                         for i in range(N_MICRO)])
        for mesh_name in FORWARD[name]:
            ns, nd = MESHES[mesh_name]
            mesh = jax_pipeline_mesh(ns, nd)
            key = f"{name}/{mesh_name}"
            out[f"{key}/logits"] = np.asarray(jax_pf(params, cfg, tokens, mesh, ns))
            if not _steps(name):
                continue
            step = build_pipeline_train_step(cfg, mesh, ns, N_MICRO, lr=LR)
            p, losses = params, []
            for i in range(_steps(name)):
                p, loss = step(p, {"tokens": tokens, "labels": labels})
                losses.append(float(loss))
                if i == 0:
                    out.update({f"{key}/params_1/{k}": v for k, v in _flat(p).items()})
            if name in TRAIN:
                out.update({f"{key}/params_n/{k}": v for k, v in _flat(p).items()})
            out[f"{key}/losses"] = np.asarray(losses)
    np.savez(out_path, **out)


def _start_reference(tmp_dir) -> list:
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join([src, os.path.dirname(__file__)])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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
    """(the reference's arrays, {mesh name: each rank's results})."""
    procs = _start_reference(str(tmp_path_factory.mktemp("pipeline_reference")))
    try:
        payload = {}
        for arch in FORWARD:
            cfg = _cfg(True, arch)
            params = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
            payload[arch] = (cfg.n_layers, params, *_batch(cfg))
        ranks = {}
        for mesh_name, shape in MESHES.items():
            mine = {a: (*v, _steps(a)) for a, v in payload.items() if mesh_name in FORWARD[a]}
            ranks[mesh_name] = run_ranks(pipeline_on_rank, shape, ("stage", "data"), mine,
                                         LR, _psum_inputs(), device="cpu", verbose=False)
        ref = {}
        for path, proc in procs:
            proc.wait(timeout=600)
            with open(f"{path}.log") as log:
                assert proc.returncode == 0, log.read()
            with np.load(f"{path}.npz") as f:
                ref.update(f)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ref, ranks


FORWARD_CASES = [(a, m) for a, meshes in FORWARD.items() for m in meshes]
TRAIN_CASES = [(a, m) for a in TRAIN + ONE_STEP for m in FORWARD[a]]


@pytest.mark.parametrize("arch,mesh_name", FORWARD_CASES)
def test_forward_logits_match_reference(runs, arch, mesh_name):
    ref, ranks = runs
    ns, nd = MESHES[mesh_name]
    cfg = get_smoke_config(arch)
    for res in ranks[mesh_name]:
        got = res[arch]
        assert got["local_shape"] == (N_MICRO, MB // nd, S, cfg.padded_vocab)
        np.testing.assert_allclose(got["logits"], ref[f"{arch}/{mesh_name}/logits"], **TOL)
        np.testing.assert_allclose(got["logits"], ref[f"{arch}/plain"], **TOL)


@pytest.mark.parametrize("arch,mesh_name", TRAIN_CASES)
def test_losses_match_reference(runs, arch, mesh_name):
    ref, ranks = runs
    want = ref[f"{arch}/{mesh_name}/losses"]
    assert len(want) == _steps(arch) and (len(want) == 1 or want[-1] < want[0])
    for res in ranks[mesh_name]:
        np.testing.assert_allclose(res[arch]["losses"], want, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("arch,mesh_name,after",
                         [(a, m, after) for a, m in TRAIN_CASES
                          for after in ("params_1", "params_n")[:2 if a in TRAIN else 1]])
def test_parameters_match_reference(runs, arch, mesh_name, after):
    """Every rank's stage blocks and replicated leaves against the
    reference's parameters after the step (the stage-replicated embedding
    and head included: counted once, not once a stage)."""
    ref, ranks = runs
    cfg = _cfg(False, arch)
    P = len(cfg.expanded_pattern)
    key = f"{arch}/{mesh_name}/{after}"
    init = _flat(jax_init_params(_cfg(True, arch), jax.random.PRNGKey(0)))

    def close(got, path, r=None):
        want = ref[path] if r is None else ref[path][r]
        tol = PARAM_TOL
        if arch == "rwkv6-3b":
            start = init[path.split("/", 3)[3]]
            step = np.abs(want - (start if r is None else start[r])).max()
            tol = dict(rtol=0, atol=RWKV_UPDATE_RTOL * step)
        np.testing.assert_allclose(got, want, **tol, err_msg=path)

    seen = set()
    for res in ranks[mesh_name]:
        got = res[arch][after]
        for leaf in ("embed", "final_ln", "lm_head"):
            if leaf in got:
                close(got[leaf], f"{key}/{leaf}")
        assert ("lm_head" in got) == (not cfg.tie_embeddings)
        for li, named in got["layers"].items():
            r, pi = divmod(li, P)
            for name, value in named.items():
                close(value, f"{key}/blocks/{pi}/{name.replace('.', '/')}", r)
            seen.add(li)
    assert seen == set(range(cfg.n_layers))


def test_psum_compressed_matches_reference_exactly(runs):
    """Each rank's mean and residual, bit for bit, over two rounds; the two
    data ranks' scales differ, so their means do too (the reference
    dequantizes the sum with each rank's own scale)."""
    ref, ranks = runs
    nd = MESHES["4x2"][1]
    n = int(np.prod(PSUM_SHAPE))
    for rank, res in enumerate(ranks["4x2"]):
        d = rank % nd
        for i, (mean, resid) in enumerate(res["psum"]["rounds"]):
            np.testing.assert_array_equal(mean, ref[f"psum/{i}/mean"][d])
            np.testing.assert_array_equal(resid, ref[f"psum/{i}/res"][d])
        assert res["psum"]["calls"] == {("all-reduce", "data", "psum_compressed"):
                                        [PSUM_ROUNDS, PSUM_ROUNDS * n * 4]}
    assert not np.array_equal(ref["psum/0/mean"][0], ref["psum/0/mean"][1])


# --------------------------------------------------------- the collectives

def _layer_elements(params_np, cfg, layers) -> tuple[int, int]:
    """(leaves, elements) of the block parameters of ``layers``."""
    P = len(cfg.expanded_pattern)
    n_leaves = n_el = 0
    for li in layers:
        for v in _flat(params_np["blocks"][li % P]).values():
            n_leaves += 1
            n_el += int(np.prod(v.shape[1:]))
    return n_leaves, n_el


def expected_calls(cfg, params_np, shape, stage, train, dt=4):
    """{(kind, axis, tag): [calls, bytes]} of one rank's pipelined forward or
    first train step, counted from the shapes: ``n_micro`` edges a stage
    boundary each way, the hidden states' all-reduce over ``stage``, and in
    training the gradients' all-reduces (blocks over ``data``; the lookup's
    part of the embedding over ``data`` on stage 0, then over ``stage``;
    the head's over ``data``)."""
    ns, nd = shape
    act = (MB // nd) * S * cfg.d_model * dt
    calls = {}
    if stage > 0:
        calls[("collective-permute", "stage", "fwd")] = [N_MICRO, N_MICRO * act]
    if ns > 1:
        calls[("all-reduce", "stage", "hidden")] = [1, N_MICRO * act]
    if not train:
        return calls
    if stage < ns - 1:
        calls[("collective-permute", "stage", "bwd")] = [N_MICRO, N_MICRO * act]
    table = cfg.padded_vocab * cfg.d_model * dt
    if nd > 1:
        leaves, elements = _layer_elements(params_np, cfg, stage_layers(cfg, ns, stage))
        heads = [cfg.d_model] + ([] if cfg.tie_embeddings else [cfg.d_model * cfg.padded_vocab])
        n = leaves + len(heads) + (stage == 0) + cfg.tie_embeddings
        nbytes = (elements + sum(heads)) * dt + table * ((stage == 0) + cfg.tie_embeddings)
        calls[("all-reduce", "data", "grad")] = [n, nbytes]
        calls[("all-reduce", "data", "loss")] = [1, 4]
    if ns > 1:
        calls[("all-reduce", "stage", "grad")] = [1, table]
    return calls


@pytest.mark.parametrize("arch,mesh_name", FORWARD_CASES)
def test_collectives_counted_from_shapes(runs, arch, mesh_name):
    _, ranks = runs
    shape = MESHES[mesh_name]
    cfg = _cfg(False, arch)
    params = jax.tree.map(np.asarray, jax_init_params(_cfg(True, arch), jax.random.PRNGKey(0)))
    for rank, res in enumerate(ranks[mesh_name]):
        stage = rank // shape[1]
        assert res[arch]["calls"] == expected_calls(cfg, params, shape, stage, False)
        if _steps(arch):
            assert res[arch]["step_calls"] == expected_calls(cfg, params, shape, stage, True)


# -------------------------------------------------------------- schedule

@pytest.mark.parametrize("n_micro,n_stages", [(4, 4), (4, 2), (8, 4), (1, 3), (3, 1)])
def test_schedule_beats(n_micro, n_stages):
    """n_micro + n_stages - 1 beats (paper Eq. 2); stage s works on
    microbatch m at beat s + m, once."""
    beats = gpipe_beats(n_micro, n_stages)
    assert len(beats) == n_micro + n_stages - 1
    work = [(t, s, m) for t, beat in enumerate(beats) for s, m in beat]
    assert sorted((s, m) for _, s, m in work) == [(s, m) for s in range(n_stages)
                                                  for m in range(n_micro)]
    assert all(t == s + m for t, s, m in work)


@pytest.mark.parametrize("arch,n_stages", [("granite-3-8b", 3), ("gemma2-9b", 3),
                                           ("jamba-v0.1-52b", 8)])
def test_stages_that_do_not_divide_the_repeats_raise(arch, n_stages):
    cfg = _cfg(False, arch)
    with pytest.raises(ValueError, match=f"{cfg.pattern_repeats} pattern repeats .* "
                                         f"{n_stages} pipeline stages"):
        stage_layers(cfg, n_stages, 0)
    with pytest.raises(ValueError, match="pipeline stages"):
        StageModel(init_params(cfg, None, "meta"), n_stages, 0)


def test_stages_cut_by_repeat():
    """gemma2's (local, global) pattern: each stage holds whole repeats, its
    first layer a local one."""
    cfg = _cfg(False, "gemma2-9b")
    kinds = cfg.block_kinds()
    cuts = [stage_layers(cfg, 4, s) for s in range(4)]
    assert [list(c) for c in cuts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert all(kinds[c[0]] == "local" and kinds[c[1]] == "attn" for c in cuts)


def test_one_stage_is_the_plain_forward():
    """On a (1, 1) mesh the pipeline is the model's forward, microbatch by
    microbatch, bit for bit."""
    cfg = _cfg(False, "gemma2-9b")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_batch(cfg)[0]).long()
    got = pipeline_forward(model, tokens, make_pipeline_mesh(1, 1, "cpu"), 1)
    with torch.inference_mode():
        want = torch.stack([forward(model, t)[0] for t in tokens])
    assert torch.equal(got, want)


def test_pipeline_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pipeline_mesh(1, 1)


def test_permute_meta_route_records_the_receiver():
    x = torch.empty(2, 8, dtype=torch.bfloat16, device="meta")
    pairs = [(0, 1), (1, 2), (2, 3)]
    recorded = []
    for coord in range(4):
        mesh = make_mesh((4, 1), ("stage", "data"), meta=True, coords=(coord, 0))
        got = mesh.comm.permute(x, "stage", pairs, tag="fwd")
        assert (got is None) == (coord == 0)
        recorded.append(dict(mesh.comm.calls))
    assert recorded[0] == {}
    assert recorded[1:] == [{("collective-permute", "stage", "fwd"): [1, 32]}] * 3
    with pytest.raises(ValueError, match="at most once"):
        mesh.comm.permute(x, "stage", [(0, 1), (0, 2)])
    with pytest.raises(ValueError, match="at most once"):
        mesh.comm.permute(x, "stage", [(0, 4)])


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2:])
