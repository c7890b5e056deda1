"""Fault-tolerant training loop (port of ``repro/ft/runner.py`` over the
port's checkpoints; the policy code is the reference's).

At 1000+ nodes, *something* is always failing; the framework treats failure
as the normal path:

* **checkpoint/restart** -- atomic checkpoints every ``ckpt_every`` steps;
  on any step exception the trainer restores the latest checkpoint and
  replays (the data pipeline is (seed, step)-deterministic, so replays are
  bit-consistent).
* **bounded retries** -- repeated failure of the same step aborts rather
  than loops (poison-step detection).
* **straggler mitigation** -- per-step wall times feed a rolling median;
  steps slower than ``k x median`` are flagged; the policy hook decides
  (log / re-dispatch / drop the slow replica from the next allocation).
  On a real cluster this drives the scheduler; here the policy is pluggable
  and unit-tested with injected delays.
* **restore in place** -- the port's train step and checkpoint restore
  update the model and optimizer state in place (the reference's
  ``shardings`` argument is gone: on a mesh each rank passes its shard and
  optimizer pieces, and the checkpoints hold whole leaves, gathered by the
  ranks and cut back into each rank's pieces on restore, so a run restarts
  on another mesh); a step that fails before its update leaves both as
  they were, which the "no checkpoint, retrying" branch relies on.  A step
  that fails on one rank of a mesh leaves the others waiting in a
  collective (ROADMAP).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from statistics import median

from ..ckpt import latest_step, restore_checkpoint, save_checkpoint
from ..ckpt.checkpoint import prune_checkpoints

log = logging.getLogger("repro_torch.ft")


@dataclass
class StragglerMonitor:
    threshold: float = 2.0       # k x median => straggler
    window: int = 32
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 5:
            med = median(self.times)
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))
                return True
        return False


@dataclass
class ResilientTrainer:
    train_step: callable         # (model, opt, batch) -> (model, opt, metrics)
    batch_fn: callable           # step -> batch  (deterministic)
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_retries_per_step: int = 3
    straggler: StragglerMonitor = field(default_factory=StragglerMonitor)
    on_straggler: callable = None

    def run(self, params, opt_state, n_steps: int, start_step: int = 0,
            failure_injector=None):
        """Runs to ``n_steps``; returns (params, opt_state, history): per step
        its ``loss``, ``grad_norm`` (``None`` where the step reports none) and
        wall ``time``.

        ``failure_injector`` is either a ``(step) -> None`` callable that
        raises to simulate a failure, or a
        :class:`repro_torch.serving.faults.FaultInjector` -- the serving
        simulator's seeded chaos source -- whose failure windows are
        mapped onto step indices (1 step = 1 simulated second), so the
        trainer and the serving executor share one deterministic fault
        vocabulary.
        """
        if failure_injector is not None and hasattr(failure_injector,
                                                    "step_hook"):
            failure_injector = failure_injector.step_hook(n_steps=n_steps)
        step = start_step
        # resume if a checkpoint exists
        last = latest_step(self.ckpt_dir)
        if last is not None and last > step:
            (params, opt_state), manifest = restore_checkpoint(
                self.ckpt_dir, last, (params, opt_state)
            )
            step = manifest["step"]
            log.info("resumed from checkpoint step %d", step)
        history = []
        # Retries are tracked per step index: after a restore, failures on
        # *different* replayed steps are distinct incidents, not one poison
        # step -- a single shared counter would abort N transient faults on
        # N distinct steps as a false poison step.
        retries: dict[int, int] = {}
        while step < n_steps:
            batch = self.batch_fn(step)
            t0 = time.monotonic()
            try:
                if failure_injector is not None:
                    failure_injector(step)
                params, opt_state, metrics = self.train_step(params, opt_state, batch)
                loss = float(metrics["loss"])
                grad_norm = float(metrics["grad_norm"]) if "grad_norm" in metrics else None
            except Exception as exc:  # noqa: BLE001 -- restart-on-anything
                failed = step
                retries[failed] = retries.get(failed, 0) + 1
                if retries[failed] > self.max_retries_per_step:
                    raise RuntimeError(
                        f"step {failed} failed {retries[failed]}x"
                    ) from exc
                last = latest_step(self.ckpt_dir)
                if last is not None:
                    (params, opt_state), manifest = restore_checkpoint(
                        self.ckpt_dir, last, (params, opt_state)
                    )
                    step = manifest["step"]
                    log.warning("step failed (%s); restored step %d", exc, step)
                else:
                    log.warning("step failed (%s); no checkpoint, retrying", exc)
                continue
            dt = time.monotonic() - t0
            if self.straggler.observe(step, dt) and self.on_straggler:
                self.on_straggler(step, dt)
            retries.pop(step, None)
            step += 1
            history.append({"step": step, "loss": loss, "grad_norm": grad_norm, "time": dt})
            if step % self.ckpt_every == 0:
                save_checkpoint(self.ckpt_dir, step, (params, opt_state),
                                meta={"loss": loss})
                prune_checkpoints(self.ckpt_dir, self.keep)
        return params, opt_state, history
