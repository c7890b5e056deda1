"""The port's copy of the serving simulator (``repro_torch.serving``) and
``Solution.serve``, on the CPU against the JAX package.

Seeded traffic must give the same arrivals, not close ones, and the
executor the same ``ServingReport`` field for field (every latency,
percentile, queue series and waterfall ``==``) for partitioned, time-mux and
merged co-schedules, under injected faults and with autoscale; the
token-level executor the same report on the smoke LM pair; and both
executors the same report when handed the same service laws.

C-ref-4: the reference's ``serve(measure=True)`` times its models and then
drops the measurements (it keys them by ``cfg.name``, the executor looks them
up by the lm-graph name), so its report equals ``measure=False``'s; the
port's runs every server on its measured law.
"""
import pytest

from repro import scope as jax_scope
from repro import serving as jax_serving
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.hw import tpu_v5e as jax_tpu_v5e
from repro_torch import scope, serving
from repro_torch.configs import get_smoke_config
from repro_torch.core.hw import tpu_v5e
from torch_parity import canon

MIX = "resnet50:2,resnet18:1"


def _both(fn):
    """``fn(scope)`` for the port and the reference."""
    return fn(scope), fn(jax_scope)


def _same_report(got, want):
    assert got.conserved and want.conserved
    assert canon(got) == canon(want)
    assert canon(got.explain()) == canon(want.explain())


@pytest.fixture(scope="module")
def solutions():
    """The mix solved by each package in each co-schedule mode."""
    out = {}
    for mode, opts in (("partitioned", dict(include_merged=False, include_time_mux=False)),
                       ("time_mux", dict(strategy="time-mux")),
                       ("merged", dict(include_time_mux=False))):
        got, want = _both(lambda s: s.solve(s.problem(MIX, "mcm16", m_samples=16, **opts)))
        assert got.multi.mode == want.multi.mode == mode
        out[mode] = (got, want)
    return out


def test_request_trace_arrivals_match_reference():
    traffic = {"a": 40.0, "b": serving.MMPP(20.0, 80.0, 0.5, 0.2)}
    jtraffic = {"a": 40.0, "b": jax_serving.MMPP(20.0, 80.0, 0.5, 0.2)}
    got = serving.request_trace(traffic, 10.0, seed=3,
                                lengths=serving.TokenLengths())
    want = jax_serving.request_trace(jtraffic, 10.0, seed=3,
                                     lengths=jax_serving.TokenLengths())
    assert len(got) > 100
    assert canon(got) == canon(want)
    phases = [({"a": 50.0, "b": 5.0}, 0.5), ({"a": 5.0, "b": 50.0}, 0.5)]
    assert canon(serving.phased_trace(phases, seed=1)) == canon(
        jax_serving.phased_trace(phases, seed=1))


@pytest.mark.parametrize("mode", ["partitioned", "time_mux", "merged"])
def test_serving_report_matches_reference(solutions, mode):
    sol, jsol = solutions[mode]
    _same_report(sol.serve(n_requests=400, seed=0), jsol.serve(n_requests=400, seed=0))


def test_serving_report_under_faults_matches_reference():
    """A zone of little chips fails at 2 s and is repaired at 6 s; the
    degraded package is re-solved through the cache, in both packages."""
    sol, jsol = _both(lambda s: s.solve(s.problem("alexnet:1,resnet18:1", "mcm16_hetero",
                                                  m_samples=16)))
    got = sol.serve(n_requests=400, seed=0, faults="zone:little@2:6")
    want = jsol.serve(n_requests=400, seed=0, faults="zone:little@2:6")
    assert got.faults["events"]
    _same_report(got, want)


def test_serving_report_with_autoscale_matches_reference():
    """tests/test_serving.py's drift trace: the mix flips three times and
    the autoscaler re-solves through a shared cache."""
    def run(s, srv):
        policy = srv.AutoscalePolicy(window_s=0.05, check_every_s=0.01, drift_threshold=0.5,
                                     min_requests=12, min_dwell_s=0.02, weight_quantum=0.25)
        cache = s.SolutionCache()
        sol = cache.solve(s.problem("alexnet:1,resnet18:1", "mcm16", m_samples=16))
        lam = sol.multi.mix_rate * 0.6
        total = lam * sum(a.weight for a in sol.multi.assignments)
        a_name, b_name = sorted(a.model for a in sol.multi.assignments)
        phases = [({a_name: total * x, b_name: total * (1 - x)}, 0.12)
                  for x in (0.85, 0.15, 0.85, 0.15)]
        trace = srv.phased_trace(phases, seed=0)
        return sol.serve(trace=trace, autoscale=policy, cache=cache, max_delay_s=5e-4)

    got, want = run(scope, serving), run(jax_scope, jax_serving)
    assert len(got.autoscale["events"]) >= 2
    _same_report(got, want)


def test_token_level_serving_matches_reference():
    """``_serve_llm``: the llm-phase solve of the smoke pair, then
    continuous batching over prefill and decode."""
    def run(s, smoke):
        cfgs = [smoke("granite-3-8b"), smoke("gemma2-9b")]
        sol = s.solve(s.problem(s.WorkloadSpec.lm(cfgs, 64, [1, 2]), "mcm16",
                                strategy="llm-phase"))
        return sol.serve(n_requests=300, seed=0)

    got, want = run(scope, get_smoke_config), run(jax_scope, jax_smoke_config)
    assert got.total_completed > 0
    assert canon(got) == canon(want)


def test_executors_given_the_same_service_laws_match(solutions):
    """Both executors on one trace with the same (correctly keyed) service
    laws: identical reports."""
    sol, jsol = solutions["partitioned"]
    laws = {a.model: (0.002 + 0.001 * i, 0.0005) for i, a in enumerate(sol.multi.assignments)}
    traffic, horizon = sol.offered_traffic(0.8, 400)
    trace = serving.request_trace(traffic, horizon, seed=0)
    jtrace = jax_serving.request_trace(traffic, horizon, seed=0)
    got = serving.ServingExecutor(
        sol.multi, sol.hw, batching=serving.BatchingPolicy(max_batch=16),
        service_override={m: serving.ServiceModel(beat=b, overhead_s=o)
                          for m, (b, o) in laws.items()}).run(trace, horizon_s=horizon)
    want = jax_serving.ServingExecutor(
        jsol.multi, jsol.hw, batching=jax_serving.BatchingPolicy(max_batch=16),
        service_override={m: jax_serving.ServiceModel(beat=b, overhead_s=o)
                          for m, (b, o) in laws.items()}).run(jtrace, horizon_s=horizon)
    _same_report(got, want)
    assert got.goodput != sol.serve(trace=trace).goodput


def _lm_solve(s, smoke, tpu):
    cfgs = [smoke("granite-3-8b"), smoke("gemma2-9b")]
    return s.solve(s.problem(s.WorkloadSpec.lm(cfgs, 64, [1, 2]), tpu(8, (1, 8))))


def test_c_ref_4_reference_drops_measurements_port_serves_them():
    """The reference's measured serve equals its modeled one to the last
    bit; the port's (timed on the CPU) runs every server on its measured
    law and gives a different report on the same trace."""
    jsol = _lm_solve(jax_scope, jax_smoke_config, jax_tpu_v5e)
    j_modeled = jsol.serve(n_requests=300, seed=0)
    j_measured = jsol.serve(n_requests=300, seed=0, measure=True, seq_len=64)
    assert canon(j_measured) == canon(j_modeled)

    sol = _lm_solve(scope, get_smoke_config, tpu_v5e)
    modeled = sol.serve(n_requests=300, seed=0)
    assert canon(modeled) == canon(j_modeled)
    measured = sol.serve(n_requests=300, seed=0, measure=True, seq_len=64, device="cpu")
    names = {a.model for a in sol.multi.assignments}
    assert names == {f"{c}-smoke@prefill64" for c in ("granite-3-8b", "gemma2-9b")}
    assert measured.meta["service_source"] == {n: "measured" for n in names}
    for name, law in measured.meta["service"].items():
        timed = measured.meta["measured_s"][name]
        assert law.stages == 1 and law.beat == max(1e-12, (timed[4] - timed[1]) / 3)
    assert measured.conserved and measured.total_arrived == modeled.total_arrived
    assert (measured.goodput, measured.latency_p95_s) != (modeled.goodput, modeled.latency_p95_s)


def test_measure_service_models_keys_and_fit_on_the_cpu():
    """The laws are keyed by ``cfg.name``, as the reference's, and each is
    the two-point fit of the timed seconds it reports."""
    sol = _lm_solve(scope, get_smoke_config, tpu_v5e)
    dep = sol.deploy(global_batch=4)
    timings = {}
    laws = serving.measure_service_models(dep, seq_len=16, batches=(1, 3), iters=1,
                                          device="cpu", timings=timings)
    assert set(laws) == set(timings) == {c.name for c in dep.cfgs}
    for name, law in laws.items():
        t1, t3 = timings[name][1], timings[name][3]
        assert law.beat == max(1e-12, (t3 - t1) / 2)
        assert law.overhead_s == max(0.0, t1 - law.beat)
    with pytest.raises(ValueError, match="b_lo < b_hi"):
        serving.measure_service_models(dep, batches=(4, 1), device="cpu")


def test_measured_path_defaults_to_the_card():
    """``device`` defaults to CUDA, and the CPU is used only when asked for:
    without a card the measured serve raises instead of moving to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    sol = _lm_solve(scope, get_smoke_config, tpu_v5e)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sol.serve(n_requests=50, seed=0, measure=True, seq_len=16)
