"""The ``repro_torch`` CLI: one front door over the Scope solver facade.

A copy of the JAX package's ``__main__.py`` over the port's facade
(:mod:`repro_torch.api`): the same commands, flags, text and ``--json``.

    PYTHONPATH=src python -m repro_torch solve --mix resnet50:2,alexnet:1 --hw mcm64
    PYTHONPATH=src python -m repro_torch solve --mix resnet50 --hw mcm64_hetero --json
    PYTHONPATH=src python -m repro_torch serve --mix resnet50:1,alexnet:1 --hw mcm16 \
        --requests 1000 --baselines --json
    PYTHONPATH=src python -m repro_torch strategies

``solve`` accepts any preset from ``repro_torch.core.hw`` (``--hw``) and a
``net[:weight[:slo_ms]]`` mix (``--mix``); a single-entry mix is a
single-model DSE (strategy auto-selection picks ``scope`` /
``scope-mixed`` / ``coschedule`` by problem shape -- override with
``--strategy``).  ``serve`` solves and then *runs* the deployment under
synthetic traffic (:mod:`repro_torch.serving`): seeded open-loop arrivals,
per-model batching queues, quota/slice enforcement, and a serving report
(goodput, latency percentiles, SLO attainment); ``--baselines`` replays
the exact same trace against the equal-split and time-mux deployments.
"""
from __future__ import annotations

import argparse
import json
import sys

from .api import SearchOptions, available_strategies, problem, solve


def _build_solve_parser(sub) -> argparse.ArgumentParser:
    ap = sub.add_parser(
        "solve", help="run the declarative Scope DSE (Problem -> Solution)",
        description="Solve a workload x package DSE through repro_torch.scope.",
    )
    ap.add_argument("--mix", "--workload", dest="mix", required=True,
                    help="comma list of net[:weight], e.g. resnet50:2,alexnet:1 "
                         "(a single entry is a single-model DSE)")
    ap.add_argument("--hw", default="mcm64", help="hardware preset name")
    ap.add_argument("--strategy", default="auto",
                    help=f"one of {', '.join(available_strategies())} "
                         "(default: auto-select by problem shape)")
    ap.add_argument("--mode", default="free", choices=("free", "uniform"),
                    help="region allocation mode (uniform = TPU SPMD)")
    ap.add_argument("--m-samples", type=int, default=16)
    ap.add_argument("--engine", default="fast", choices=("fast", "reference"))
    ap.add_argument("--paper-strict", action="store_true",
                    help="literal Algorithm 1 rebalance semantics")
    ap.add_argument("--step", type=int, default=1,
                    help="quota grid step (1 = exhaustive)")
    ap.add_argument("--refine", action="store_true",
                    help="coarse-to-fine curves (1D and mixed 2D): re-sample "
                         "at step 1 around each coarse argmax")
    ap.add_argument("--no-mixed", action="store_true",
                    help="disable mixed-flavor (spanning) quotas / "
                         "per-cluster flavors on heterogeneous packages")
    ap.add_argument("--mixed-step", type=int, default=None,
                    help="budget grid step of the mixed-flavor curves "
                         "(default: quarter of the smaller flavor)")
    ap.add_argument("--switch-cost", action="store_true",
                    help="charge time-mux slices for per-slice weight "
                         "re-deployment")
    ap.add_argument("--switch-period-s", type=float, default=1.0)
    ap.add_argument("--samples", type=int, default=10_000,
                    help="sample count for --strategy random")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baselines", action="store_true",
                    help="also report the equal-split and time-mux baselines")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the solve "
                         "(open in Perfetto / chrome://tracing; .jsonl for "
                         "one event per line)")
    ap.add_argument("--dashboard", default=None, metavar="PATH",
                    help="write a self-contained HTML dashboard: per-stage "
                         "cost attribution tables plus the solve timeline "
                         "(no external assets)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit a machine-readable JSON summary")
    return ap


def _build_serve_parser(sub) -> argparse.ArgumentParser:
    ap = sub.add_parser(
        "serve",
        help="solve, then run the deployment under synthetic traffic",
        description="Solve a workload x package DSE and simulate serving "
                    "it (repro_torch.serving).",
    )
    ap.add_argument("--mix", "--workload", dest="mix", default=None,
                    help="comma list of net[:weight[:slo_ms]]")
    ap.add_argument("--llm", default=None, metavar="ARCHS",
                    help="token-level LLM mix: comma list of arch[:weight] "
                         "from the LM registry (e.g. gemma2-9b:2,"
                         "granite-3-8b:1); solves with strategy llm-phase "
                         "and runs the TokenExecutor (exclusive with --mix)")
    ap.add_argument("--llm-smoke", action="store_true",
                    help="use the reduced smoke configs for --llm archs")
    ap.add_argument("--seq-len", type=int, default=128,
                    help="prompt length the LLM phase DSE plans for")
    ap.add_argument("--output-tokens", type=float, default=64.0,
                    help="expected decode tokens per request (LLM DSE)")
    ap.add_argument("--phase-mode", default="auto",
                    choices=("auto", "disaggregated", "colocated"),
                    help="LLM phase deployment mode to search")
    ap.add_argument("--ttft-slo-ms", type=float, default=None,
                    help="time-to-first-token SLO (gates token goodput)")
    ap.add_argument("--tpot-slo-ms", type=float, default=None,
                    help="time-per-output-token SLO (gates token goodput)")
    ap.add_argument("--queue-policy", default="fifo",
                    choices=("fifo", "edf"),
                    help="LLM prefill queue order / coloc arbitration")
    ap.add_argument("--hw", default="mcm64", help="hardware preset name")
    ap.add_argument("--strategy", default="auto",
                    help="solver strategy (default: auto-select)")
    ap.add_argument("--m-samples", type=int, default=16)
    ap.add_argument("--step", type=int, default=1)
    ap.add_argument("--switch-cost", action="store_true",
                    help="charge time-mux slices for weight re-deployment")
    ap.add_argument("--requests", type=int, default=1000,
                    help="approximate number of simulated requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate-scale", type=float, default=0.8,
                    help="offered load as a fraction of solved capacity")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="batcher size cap (default: the DSE batch)")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="batcher queue-delay cap")
    ap.add_argument("--autoscale", action="store_true",
                    help="enable the online re-solve hook")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="scripted fault scenario: ';'-separated "
                         "target@t0[:t1] with chip:R,C / zone:FLAVOR / "
                         "seam:A+B targets; times in seconds or %% of the "
                         "horizon (e.g. 'zone:little@35%%:65%%')")
    ap.add_argument("--fault-seed", type=int, default=None, metavar="N",
                    help="random chaos: seed a FaultInjector on top of any "
                         "--faults script (uses --chip-mtbf etc.)")
    ap.add_argument("--chip-mtbf", type=float, default=None, metavar="S",
                    help="per-chip mean time between failures (random chaos)")
    ap.add_argument("--chip-mttr", type=float, default=1.0, metavar="S")
    ap.add_argument("--zone-mtbf", type=float, default=None, metavar="S")
    ap.add_argument("--zone-mttr", type=float, default=2.0, metavar="S")
    ap.add_argument("--fault-static", action="store_true",
                    help="disable the degraded re-solve: down servers stay "
                         "down until repair (the static-degraded baseline)")
    ap.add_argument("--baselines", action="store_true",
                    help="replay the same trace on equal-split and time-mux "
                         "(--mix) or the static whole-request deployments "
                         "(--llm)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the whole run "
                         "(solver spans + server lanes + queue/fault "
                         "timeline; open in Perfetto)")
    ap.add_argument("--dashboard", default=None, metavar="PATH",
                    help="write a self-contained HTML dashboard: cost "
                         "attribution + latency waterfall tables, the run "
                         "timeline with fault/recovery windows, and "
                         "queue/KV counter sparklines")
    ap.add_argument("--json", action="store_true", dest="as_json")
    return ap


def _cmd_serve(args) -> None:
    if args.mix and args.llm:
        raise SystemExit("pass --mix or --llm, not both")
    if args.llm:
        _cmd_serve_llm(args)
        return
    if not args.mix:
        raise SystemExit("serve needs --mix or --llm")
    # one Tracer spans the whole command: the primary solve's spans, every
    # baseline solve, the executor's sim-time lanes, and any mid-run
    # re-solves all land on one timeline
    obs_tracer = None
    if args.trace or args.dashboard:
        from .obs import Tracer

        obs_tracer = Tracer()
    options = SearchOptions(
        strategy=args.strategy, m_samples=args.m_samples, step=args.step,
        switch_cost=args.switch_cost, trace=obs_tracer,
    )
    prob = problem(args.mix, args.hw, options=options)
    # One SolutionCache for the primary solve, the baselines and any
    # autoscale re-solves: every DSE shares one evaluation-engine memo.
    from .api import SolutionCache

    cache = SolutionCache()
    sol = cache.solve(prob)
    if not sol.feasible:
        raise SystemExit(f"no feasible solution for {args.mix} on {args.hw}")
    # One trace for every deployment: the offered load is fixed by the
    # primary solution's capacity, so --baselines replays are like-for-like.
    from .serving import request_trace

    traffic, horizon = sol.offered_traffic(args.rate_scale, args.requests)
    trace = request_trace(traffic, horizon, seed=args.seed)
    serve_kw = dict(
        trace=trace, horizon_s=horizon, seed=args.seed,
        max_delay_s=args.max_delay_ms / 1e3, max_batch=args.max_batch,
    )
    faults = None
    if args.faults or args.fault_seed is not None:
        # scripted specs may use %-of-horizon times, so build the schedule
        # here where the horizon is known
        from .serving import FaultInjector, parse_faults

        scripted = (parse_faults(args.faults, sol.hw, horizon)
                    if args.faults else ())
        if args.fault_seed is not None:
            faults = FaultInjector(
                sol.hw, seed=args.fault_seed,
                chip_mtbf_s=args.chip_mtbf, chip_mttr_s=args.chip_mttr,
                zone_mtbf_s=args.zone_mtbf, zone_mttr_s=args.zone_mttr,
                scripted=scripted, horizon_hint_s=horizon,
            )
        else:
            faults = scripted
    report = sol.serve(autoscale=args.autoscale, cache=cache,
                       faults=faults,
                       fault_recovery=not args.fault_static,
                       tracer=obs_tracer, **serve_kw)
    out = {"solution": sol.to_json(), "serving": report.to_json()}
    if args.baselines:
        out["baselines"] = {}
        for name in ("equal-split", "time-mux"):
            b = cache.solve(prob.with_options(strategy=name))
            if not b.feasible:
                out["baselines"][name] = None
                continue
            out["baselines"][name] = b.serve(**serve_kw).to_json()
    if obs_tracer is not None and args.trace:
        obs_tracer.write(args.trace)
    if args.dashboard:
        from .obs import write_dashboard

        write_dashboard(
            args.dashboard, title=f"Scope Lens: serve {args.mix}",
            solution_explain=sol.explain(),
            serving_explain=report.explain(),
            tracer=obs_tracer,
            meta={"hw": args.hw, "strategy": sol.strategy,
                  "requests": report.total_arrived,
                  "faults": args.faults or "-"},
        )
        print(f"dashboard written to {args.dashboard}", file=sys.stderr)
    if args.as_json:
        print(json.dumps(out, indent=1))
        return
    for line in sol.describe():
        print(line)
    print()
    for line in report.describe():
        print(line)
    if obs_tracer is not None:
        print()
        print(obs_tracer.summary())
        if args.trace:
            print(f"trace written to {args.trace} (open in Perfetto)")
    for name, rep in out.get("baselines", {}).items():
        if rep is None:
            print(f"{name}: infeasible")
        else:
            print(f"{name}: goodput {rep['goodput']:.1f}/s "
                  f"(vs {report.goodput:.1f}), p95 "
                  f"{rep['latency_p95_s'] * 1e3:.2f}ms "
                  f"(vs {report.latency_p95_s * 1e3:.2f})")


def _cmd_serve_llm(args) -> None:
    """Token-level serving: llm-phase DSE + TokenExecutor replay, with the
    static whole-request deployments as --baselines on the same trace."""
    from .api import SolutionCache, WorkloadSpec
    from .configs import get_config, get_smoke_config
    from .serving import TokenLengths, request_trace

    obs_tracer = None
    if args.trace or args.dashboard:
        from .obs import Tracer

        obs_tracer = Tracer()
    names, weights = [], []
    for entry in args.llm.split(","):
        parts = entry.strip().split(":")
        names.append(parts[0])
        weights.append(float(parts[1]) if len(parts) > 1 else 1.0)
    get = get_smoke_config if args.llm_smoke else get_config
    wl = WorkloadSpec.lm([get(n) for n in names], args.seq_len, weights)
    options = SearchOptions(
        strategy="llm-phase", m_samples=args.m_samples, step=args.step,
        output_tokens=args.output_tokens, phase_mode=args.phase_mode,
        trace=obs_tracer,
    )
    prob = problem(wl, args.hw, options=options)
    cache = SolutionCache()
    sol = cache.solve(prob)
    if not sol.feasible:
        raise SystemExit(f"no feasible LLM plan for {args.llm} on {args.hw}")
    # one token trace (arrivals + prompt/output lengths) shared by the
    # chosen deployment and every --baselines replay
    traffic, horizon = sol.offered_traffic(args.rate_scale, args.requests)
    lengths = TokenLengths(prompt_mean=float(args.seq_len),
                           output_mean=float(args.output_tokens))
    trace = request_trace(traffic, horizon, seed=args.seed, lengths=lengths)
    ttft = args.ttft_slo_ms / 1e3 if args.ttft_slo_ms is not None else None
    tpot = args.tpot_slo_ms / 1e3 if args.tpot_slo_ms is not None else None
    serve_kw = dict(trace=trace, horizon_s=horizon, seed=args.seed,
                    max_delay_s=args.max_delay_ms / 1e3,
                    max_batch=args.max_batch,
                    queue_policy=args.queue_policy,
                    ttft_slo=ttft, tpot_slo=tpot)
    report = sol.serve(tracer=obs_tracer, **serve_kw)
    out = {"solution": sol.to_json(), "serving": report.to_json()}
    if args.baselines:
        out["baselines"] = {}
        for mode, alt in sol.diagnostics.get("plans", {}).items():
            if alt is None:
                out["baselines"][f"{mode}-static"] = None
                continue
            b = sol.serve(plan=alt, static_batching=True, **serve_kw)
            out["baselines"][f"{mode}-static"] = b.to_json()
    if obs_tracer is not None and args.trace:
        obs_tracer.write(args.trace)
    if args.dashboard:
        from .obs import write_dashboard

        write_dashboard(
            args.dashboard, title=f"Scope Lens: serve --llm {args.llm}",
            solution_explain=sol.explain(),
            serving_explain=report.explain(),
            serving_title="Token-level latency waterfalls",
            tracer=obs_tracer,
            meta={"hw": args.hw, "mode": report.mode,
                  "requests": report.total_arrived},
        )
        print(f"dashboard written to {args.dashboard}", file=sys.stderr)
    if args.as_json:
        print(json.dumps(out, indent=1))
        return
    for line in sol.describe():
        print(line)
    print()
    for line in report.describe():
        print(line)
    if obs_tracer is not None:
        print()
        print(obs_tracer.summary())
        if args.trace:
            print(f"trace written to {args.trace} (open in Perfetto)")
    for name, rep in out.get("baselines", {}).items():
        if rep is None:
            print(f"{name}: infeasible")
        else:
            ratio = (report.token_goodput / rep["token_goodput"]
                     if rep["token_goodput"] else float("inf"))
            print(f"{name}: token goodput {rep['token_goodput']:.1f} tok/s "
                  f"({ratio:.2f}x vs solution), TTFT p95 "
                  f"{rep['ttft_p95_s'] * 1e3:.2f}ms")


def _cmd_solve(args) -> None:
    trace_arg = args.trace
    if args.dashboard and trace_arg is None:
        # the dashboard wants a timeline even when no trace file was asked for
        from .obs import Tracer

        trace_arg = Tracer()
    options = SearchOptions(
        strategy=args.strategy,
        mode=args.mode,
        m_samples=args.m_samples,
        engine=args.engine,
        paper_strict=args.paper_strict,
        step=args.step,
        refine=args.refine,
        mixed=not args.no_mixed,
        mixed_step=args.mixed_step,
        switch_cost=args.switch_cost,
        switch_period_s=args.switch_period_s,
        samples=args.samples,
        seed=args.seed,
        trace=trace_arg,
    )
    prob = problem(args.mix, args.hw, options=options)
    sol = solve(prob)
    if not sol.feasible and sol.strategy != "random":
        if args.as_json:
            print(json.dumps(sol.to_json(), indent=1))
        raise SystemExit(
            f"no feasible {sol.strategy} solution for {args.mix} on {args.hw}"
        )
    if args.dashboard:
        from .obs import write_dashboard

        write_dashboard(
            args.dashboard, title=f"Scope Lens: solve {args.mix}",
            solution_explain=sol.explain(),
            tracer=sol.diagnostics.get("trace"),
            meta={"hw": args.hw, "strategy": sol.strategy,
                  "mode": args.mode},
        )
        print(f"dashboard written to {args.dashboard}", file=sys.stderr)

    if args.as_json:
        out = sol.to_json()
        if args.baselines:
            out["baselines"] = _baseline_rates(prob, sol)
        print(json.dumps(out, indent=1))
        return

    for line in sol.describe():
        print(line)
    tr = sol.diagnostics.get("trace")
    if tr is not None:
        print()
        print(tr.summary())
        if args.trace:
            print(f"trace written to {args.trace} (open in Perfetto)")
    if args.baselines:
        for name, tp in _baseline_rates(prob, sol).items():
            if tp is None:
                print(f"{name}: infeasible")
            else:
                ratio = (sol.weighted_throughput / tp) if tp else float("inf")
                print(f"{name}: weighted throughput {tp:.1f} samples/s "
                      f"({ratio:.2f}x vs solution)")


def _baseline_rates(prob, sol) -> dict:
    """Weighted throughput of the static baselines, through the facade
    (sharing nothing with the solution's engine so numbers stay honest)."""
    out = {}
    for name in ("equal-split", "time-mux"):
        b = solve(prob.with_options(strategy=name))
        out[name] = b.weighted_throughput if b.feasible else None
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="command")
    _build_solve_parser(sub)
    _build_serve_parser(sub)
    sub.add_parser("strategies", help="list registered solver strategies")
    args = ap.parse_args(argv)
    if args.command == "solve":
        _cmd_solve(args)
    elif args.command == "serve":
        _cmd_serve(args)
    elif args.command == "strategies":
        for name in available_strategies():
            print(name)
    else:
        ap.print_help()
        sys.exit(2)


if __name__ == "__main__":
    main()
