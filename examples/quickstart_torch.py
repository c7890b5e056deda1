"""Quickstart: schedule a network with Scope and inspect the result.

The PyTorch port's copy of ``examples/quickstart.py``: the same facade, the
same output, from ``repro_torch`` (the DSE runs on the host; no device).

Everything goes through the solver facade (``repro_torch.scope``): build a
declarative Problem, ``solve()`` it (the paper's full DSE, Algorithm 1),
compare against the three baseline schedulers by just switching the
strategy, and print the chosen segments / clusters / regions / partitions
-- the paper's Table I variables.

    PYTHONPATH=src python examples/quickstart_torch.py
"""
from repro_torch import scope

NET, CHIPS = "resnet50", 64

prob = scope.problem(NET, f"mcm{CHIPS}")
graph = prob.workload.graph
print(f"{NET}: {len(graph)} layers, {graph.total_flops / 1e9:.1f} GFLOPs, "
      f"{graph.total_weight_bytes / 1e6:.1f} MB weights on {CHIPS} chiplets\n")

solutions = {}
for name in ("sequential", "full_pipeline", "segmented", "scope"):
    sol = scope.solve(prob.with_options(strategy=name))
    solutions[name] = sol if sol.feasible else None
    print(f"{name:14s} "
          f"{'%8.3f ms' % (sol.latency * 1e3) if sol.feasible else '  invalid'}"
          f"   {sol.throughput:8.1f} samples/s")

best = solutions["scope"]
sched = best.schedule
print(f"\nScope schedule ({sched.meta['n_segments']} segments, "
      f"searched in {best.diagnostics['dse_s']:.2f}s):")
for i, seg in enumerate(sched.segments):
    print(f"  segment {i}: {seg.n_clusters} clusters")
    for cl, t in zip(seg.clusters, seg.cluster_times):
        kinds = {p for p in cl.partitions}
        print(f"    layers[{cl.layer_lo:3d}:{cl.layer_hi:3d}] "
              f"region={cl.region_chips:3d} chips  P={'/'.join(sorted(kinds))}"
              f"  beat={t * 1e6:7.1f} us")

speedup = solutions["segmented"].latency / best.latency
print(f"\nScope vs segmented pipeline: {speedup:.2f}x")
