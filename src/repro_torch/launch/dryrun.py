"""Dry-run on the meta device: trace every (arch x shape) cell's step once
on one card's worth of shapes, with no card (port of
``repro/launch/dryrun.py``).

For each cell this shows, without hardware:
  * that the step runs: the cell's parameters, optimizer state and inputs
    (or caches) are built on the ``meta`` device and its real step --
    ``build_train_step``, ``build_prefill_step`` or ``build_decode_step`` --
    runs once, every hand kernel through its wrapper's meta route;
  * whether it fits one card (``memory_analysis``): a storage tracker adds
    each new storage's bytes, rounded up as the CUDA caching allocator
    rounds with expandable segments, and takes them off when the storage
    dies; ``fits`` holds its peak, grown by what the allocator reserves
    above it, against what a process can allocate on the card;
  * the roofline inputs (``cost_analysis``): the aten products' flops from
    ``torch.utils.flop_counter.FlopCounterMode``, the unfused bytes of every
    aten operation's inputs and outputs, and each hand kernel's own count
    (``kernels/cost.py``), with ``kernel_calls`` per kernel.  The compute
    term takes the aten products at the bf16 peak (the cells' weights are
    bf16) and each kernel's operations at the peak of its own unit.

The reference lowers once with ``scan_unroll=2`` to correct XLA's count of a
scan body; the port runs every layer in Python, so every layer is counted
and there is no ``corrected`` block.  ``lower_s`` / ``compile_s`` become
``trace_s``.  One card has no mesh: ``--multi-pod`` and any mesh but 1 x 1
raise (ROADMAP A13).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import tree
from ..configs import ARCHS, SHAPES, get_config
from ..configs.registry import cells
from ..kernels import cost as kernel_cost
from ..kernels.cost import nbytes
from ..models.config import ModelConfig
from ..models.model import init_kv_cache, init_params
from ..optim import make_optimizer
from ..runtime.planner import plan_for_cell
from ..runtime.serve import build_decode_step, build_prefill_step
from ..runtime.train import build_train_step
from .hlo_analysis import (CARD_NAME, CARD_TOTAL_MEMORY, CARD_USABLE_MEMORY,
                           RESERVED_MARGIN, HwConstants, kernel_bound, roofline_terms,
                           unit_peak)

MESH_AXES = ("data", "model")
ALLOC_ROUND = 512            # the CUDA caching allocator's block size unit
OUT_DIR = "dryrun_out"

# aten operations that write nothing (an uninitialised allocation) or alias
# their input (a view): no bytes move
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _bmm_flops(a_shape, b_shape, *_, **__) -> int:
    """``bmm`` of [b, m, k] by [b, k, n], its ``out_dtype`` overload (the MoE
    experts' fp32 products) included, which the stock formula does not take."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class StorageTracker(TorchDispatchMode):
    """Bytes held on the meta device by the storages created inside the mode.

    Each new storage adds its bytes rounded up to ``ALLOC_ROUND`` (as the
    CUDA caching allocator rounds a block; an empty one adds 0) and takes
    them off when it dies.  ``peak`` is the most held at once since the last
    :meth:`reset_peak`.  ``bytes_accessed`` sums, over every aten operation
    that moves data (not an allocation, not a view), the bytes of its inputs
    and outputs on meta: the traffic of an unfused run.
    """

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0
        self._refs: dict[int, weakref.ref] = {}

    @staticmethod
    def rounded(n: int) -> int:
        return -(-n // ALLOC_ROUND) * ALLOC_ROUND

    def _free(self, key: int, size: int, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= size

    def track(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        size = self.rounded(st.nbytes())
        self._refs[key] = weakref.ref(st, lambda r, k=key, s=size: self._free(k, s, r))
        self.live += size
        self.peak = max(self.peak, self.live)

    def reset_peak(self) -> None:
        self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in _tensors(out) if t.device.type == "meta"]
        for t in outs:
            self.track(t)
        if func._overloadpacket.__name__ not in _NO_TRAFFIC and not _is_view(func):
            ins = [t for t in _tensors((args, kwargs)) if t.device.type == "meta"]
            self.bytes_accessed += nbytes(*ins, *outs)
        return out


def cell_inputs(cfg: ModelConfig, S: int, B: int, kind: str, device="meta") -> dict:
    """Every model input of the cell, as the reference's ``input_specs``:
    int32 token ids and labels, bf16 frontend embeddings, and for decode
    one token, its write position and the caches of S positions."""
    i32 = dict(dtype=torch.int32, device=device)
    if kind in ("train", "prefill"):
        batch = {}
        if cfg.frontend == "audio_stub":
            batch["frontend_embeds"] = torch.empty(B, S, cfg.d_model, dtype=torch.bfloat16,
                                                   device=device)
        elif cfg.frontend == "vision_stub":
            batch["tokens"] = torch.empty(B, S - cfg.frontend_tokens, **i32)
            batch["frontend_embeds"] = torch.empty(B, cfg.frontend_tokens, cfg.d_model,
                                                   dtype=torch.bfloat16, device=device)
        else:
            batch["tokens"] = torch.empty(B, S, **i32)
        if kind == "train":
            batch["labels"] = torch.empty(B, S, **i32)
        return batch
    return {"token": torch.empty(B, 1, **i32), "position": torch.empty(B, **i32),
            "caches": init_kv_cache(cfg, B, S, torch.bfloat16, device)}


def cell_arguments(cfg: ModelConfig, S: int, B: int, kind: str, device="meta"):
    """(model, optimizer state or None, inputs) of the cell on ``device``,
    the model with no values drawn (``init_params(cfg, None, "meta")``)."""
    model = init_params(cfg, None, device)
    opt = None
    if kind == "train":
        model.train_params()
        opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
    return model, opt, cell_inputs(cfg, S, B, kind, device)


def argument_tensors(model, opt, inputs) -> list[torch.Tensor]:
    """Every tensor the step takes: parameters, optimizer state (the step
    count included, on the host), inputs or caches."""
    out = [*model.parameters(), *_tensors(inputs)]
    if opt is not None:
        out += [t for leaf in tree.leaves(opt) for t in tree.leaf_layers(leaf)]
    return out


def run_step(cfg, plan, kind, S, B, model, opt, inputs, device):
    if kind == "train":
        step = build_train_step(cfg, plan, device=device)
        return step(model, opt, inputs)
    if kind == "prefill":
        step = build_prefill_step(cfg, plan, device)
        if cfg.frontend == "audio_stub":
            return step(model, inputs["frontend_embeds"])
        if cfg.frontend == "vision_stub":
            return step(model, inputs["tokens"], inputs["frontend_embeds"])
        return step(model, inputs["tokens"])
    step = build_decode_step(cfg, plan, batch=B, max_len=S, device=device)
    return step(model, inputs["token"], inputs["position"], inputs["caches"])


def trace_step(cfg: ModelConfig, S: int, B: int, kind: str, plan) -> dict:
    """Build the cell's arguments on meta and run its step once under the
    storage tracker and the flop counter; the memory, cost, kernel-call and
    roofline figures of the run."""
    tracker = StorageTracker()
    with tracker:
        model, opt, inputs = cell_arguments(cfg, S, B, kind)
    arg_tensors = argument_tensors(model, opt, inputs)
    arg_storages = {t.untyped_storage()._cdata for t in arg_tensors if t.device.type == "meta"}
    tracker.reset_peak()
    held = tracker.live
    flops = FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flops})
    t0 = time.perf_counter()
    with kernel_cost.tally() as calls, flops, tracker:
        out = run_step(cfg, plan, kind, S, B, model, opt, inputs, "meta")
    trace_s = time.perf_counter() - t0
    new_out = {t.untyped_storage()._cdata: t for t in _tensors(out)
               if t.device.type == "meta" and t.untyped_storage()._cdata not in arg_storages}
    kernel_calls: dict[str, int] = {}
    kernels: dict[str, dict] = {}
    for name, c in calls:
        kernel_calls[name] = kernel_calls.get(name, 0) + 1
        k = kernels.setdefault(name, {"flops": 0.0, "bytes": 0.0, "compute_s": 0.0,
                                      "bound_s": 0.0})
        k["flops"] += c.flops
        k["bytes"] += c.bytes
        k["compute_s"] += c.flops / unit_peak(c.unit)
        k["bound_s"] += kernel_bound(c)[0]
    aten_flops = float(flops.get_total_flops())
    k_flops = sum(k["flops"] for k in kernels.values())
    k_bytes = sum(k["bytes"] for k in kernels.values())
    k_compute_s = sum(k["compute_s"] for k in kernels.values())
    total_bytes = float(tracker.bytes_accessed) + k_bytes
    return {
        "trace_s": trace_s,
        "memory_analysis": {
            "argument_size_bytes": nbytes(*arg_tensors),
            "output_size_bytes": nbytes(*new_out.values()),
            "temp_size_bytes": tracker.peak - held,       # the most held above the arguments
            "peak_bytes": tracker.peak,
            "allocator": "expandable_segments",          # the rule peak_bytes follows
            "reserved_margin": RESERVED_MARGIN,           # reserved above it, either allocator
            "card": CARD_NAME,
            "card_total_memory": CARD_TOTAL_MEMORY,
            "card_usable_memory": CARD_USABLE_MEMORY,
            "fits": tracker.peak * (1 + RESERVED_MARGIN) <= CARD_USABLE_MEMORY,
        },
        "cost_analysis": {"flops": aten_flops + k_flops, "bytes accessed": total_bytes,
                          "aten_flops": aten_flops, "kernel_flops": k_flops,
                          "kernel_bytes": k_bytes},
        "kernel_calls": kernel_calls,
        "kernels": kernels,
        # the kernels' time at their own units' peaks, as flops at the bf16 peak
        "roofline": roofline_terms(aten_flops + k_compute_s * HwConstants().peak_flops,
                                   total_bytes, 0.0, 1),
    }


def run_cell(arch: str, shape: str, multi_pod: bool = False, use_dse: bool = True) -> dict:
    """The reference's ``run_cell`` on one card: the cell's plan from
    ``plan_for_cell`` at model axis 1, then :func:`trace_step`."""
    if multi_pod:
        raise NotImplementedError("a multi-pod mesh needs the multi-card runtime (ROADMAP A13)")
    # per full batch, as the reference lowers it (accumulation only trades
    # temporary memory for steps)
    cfg = dataclasses.replace(get_config(arch), accum_steps=1)
    S, B, kind = SHAPES[shape]
    plan = plan_for_cell(cfg, S, B, MESH_AXES, model_axis=1, kind=kind, use_dse=use_dse)
    result = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": {"axes": list(MESH_AXES), "shape": [1, 1], "chips": 1},
        "plan": {"p1": plan.p1, "p2": plan.p2, "transition_repeat": plan.transition_repeat,
                 "dse_meta": dict(plan.meta)},
    }
    result.update(trace_step(cfg, S, B, kind, plan))
    return result


def summary(res: dict) -> str:
    """One line: peak GiB, fits, the dominant roofline term and its seconds."""
    mem, r = res["memory_analysis"], res["roofline"]
    return (f"peak {mem['peak_bytes'] / 2**30:.2f} GiB fits={mem['fits']} "
            f"dominant={r['dominant']} {r[r['dominant'] + '_s']:.4g} s "
            f"(trace {res['trace_s']:.1f} s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-dse", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError("--multi-pod needs the multi-card runtime (ROADMAP A13)")

    if args.all:
        todo = cells()
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        todo = [(args.arch, args.shape)]

    os.makedirs(args.out_dir, exist_ok=True)
    failures = []
    for arch, shape in todo:
        tag = f"{arch}__{shape}__card1"
        print(f"=== {tag}", flush=True)
        try:
            res = run_cell(arch, shape, use_dse=not args.no_dse)
            with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
            print(f"    ok: {summary(res)}", flush=True)
        except Exception as e:  # noqa: BLE001
            failures.append((tag, str(e)))
            traceback.print_exc()
    if failures:
        print(f"FAILED {len(failures)} cells:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print("all cells passed")


if __name__ == "__main__":
    main()
