"""Multi-model co-scheduling walkthrough: mixed traffic on one MCM package.

The PyTorch port's copy of ``examples/multimodel_serve.py``.  The solve,
the baselines and the serving simulation run on the host as in the JAX
example; the last part builds the deployment's serving steps on one card
(``--device``, default ``cuda``; ``--device cpu`` runs it on the CPU).

Everything goes through the solver facade (``repro_torch.scope``): schedule a
3-model mix (weighted traffic) onto a 64-chiplet package
(``solve`` auto-selects the ``coschedule`` strategy), compare it against
the two static baselines by switching the strategy, then show the same
subsystem on a heterogeneous big/little package -- including mixed-flavor
quotas, where one model's pipeline spans both flavors -- and finally drive
a mixed-flavor plan end to end through the runtime bridge
(``Solution.deploy`` -> ``Deployment.build_steps``) on the device.

    PYTHONPATH=src python examples/multimodel_serve_torch.py [--device cpu]
"""
import argparse

from repro_torch import scope

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# Traffic mix: resnet50 gets 2x the request rate of the small models.
MIX = "resnet50:2,resnet18:1,alexnet:1"

prob = scope.problem(MIX, "mcm64", m_samples=16)
print(f"mix {MIX} on mcm64\n")
co = scope.solve(prob)
for line in co.describe():
    print(line)
print(f"  modes searched: "
      f"{ {k: round(v) for k, v in co.diagnostics['mode_rates'].items()} }")

print("\nstatic baselines:")
for name in ("equal-split", "time-mux"):
    b = scope.solve(prob.with_options(strategy=name))
    print(f"  {name:12s} {b.weighted_throughput:9.1f} samples/s "
          f"({co.weighted_throughput / b.weighted_throughput:.2f}x behind)")

# --- serving: run the deployment under load ------------------------------
# The serving executor replays a seeded open-loop trace against the solved
# schedule: per-model queues + batching, quota sub-meshes enforced, service
# times from the solved cost model.  Offered load is 90% of solved
# capacity; bursty (MMPP) traffic for resnet50.
from repro_torch.serving import MMPP, Poisson

mm = co.as_multimodel()
lam = mm.mix_rate * 0.9
traffic = {
    a.model: (MMPP(rate_low=0.5 * lam * a.weight,
                   rate_high=2.0 * lam * a.weight)
              if a.model == "resnet50" else Poisson(lam * a.weight))
    for a in mm.assignments
}
report = co.serve(traffic=traffic, horizon_s=0.5, seed=0)
print("\nserving the co-schedule (90% load, resnet50 bursty):")
for line in report.describe():
    print(line)

# --- heterogeneous package: quotas are drawn per chip flavor -------------
# Mixed-flavor quotas are searched too: a model's pipeline may start on big
# chips and finish on little ones, crossing the flavor seam
# (hw.seam_link_bw) exactly once -- look for `quota=AxBig+BxLittle` below,
# and the validator's seam accounting in the diagnostics.
co2 = scope.solve(scope.problem("resnet50:4,resnet18:1", "mcm64_hetero"))
print(f"\nmix resnet50:4,resnet18:1 on {co2.hw.name} "
      f"({', '.join(f'{t.chips}x{t.name}' for t in co2.hw.region_types)})")
for line in co2.describe():
    print(line)
print(f"  modes searched: "
      f"{ {k: round(v) for k, v in co2.diagnostics['mode_rates'].items()} }")
print(f"  seam crossings per model: {co2.diagnostics['seam_crossings']}")

# --- runtime bridge: a mixed-flavor plan end to end ----------------------
# Co-schedule two tiny LM configs onto a heterogeneous 8-chip model axis,
# then build their serving steps on the device.  The workload carries the
# ModelConfigs, so solve -> deploy is two lines; each plan records which
# chip flavor serves which pipeline stage (plan.stage_chip_types); a
# mixed-flavor assignment itemizes its per-flavor chips in
# meta["chip_quota"].  One card runs every model's steps in turn.
from dataclasses import replace

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.hw import ChipType, tpu_v5e
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.models import init_params

MODEL_AXIS = 8
hw3 = replace(
    tpu_v5e(MODEL_AXIS, (1, MODEL_AXIS)),
    name=f"tpu_v5e_{MODEL_AXIS}_hetero",
    region_types=(
        ChipType("big", 4),
        ChipType("little", 4, flops_scale=0.5, nop_bw_scale=0.75),
    ),
)
dev = resolve_device(args.device)
cfgs = [get_smoke_config("granite-3-8b"), get_smoke_config("granite-20b")]
if dev.type == "cuda":
    # the smoke configs' d_head 16 has no flash kernel instantiation
    cfgs = [replace(c, d_head=min(HEAD_DIMS)) for c in cfgs]
sol = scope.solve(scope.problem(
    scope.WorkloadSpec.lm(cfgs, seq_len=64, weights=[2.0, 1.0]), hw3,
    m_samples=8, include_merged=False,
))
dep = sol.deploy(global_batch=8, mesh_axes=("data", "model"))
print(f"\nruntime bridge on {hw3.name} (4xbig + 4xlittle):")
for line in sol.describe():
    print(line)
for name, plan in dep.plans.items():
    print(f"  {name}: p1={plan.p1} p2={plan.p2} "
          f"stages={[(lo, hi, t, c) for lo, hi, t, c in plan.stage_chip_types]}")

fleet = dep.build_steps(with_decode=False, device=dev)
for cfg in cfgs:
    prefill = fleet[cfg.name]["prefill"]
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.ones((2, 16), dtype=torch.int64, device=dev)
    logits = prefill(model, toks)
    print(f"  {cfg.name}: prefill logits {tuple(logits.shape)} on {dev}")
