"""Fault tolerance: preemption checkpointing, straggler watchdog, retries,
elastic rescale.

Port of `repro.train.fault`.  Components (all host-side; the step itself
stays a function of its inputs, `train.train_step`):

* `Supervisor.run` — the restartable training loop: restores the newest
  valid checkpoint, steps, checkpoints every `ckpt_every` (async), retries
  transient step failures up to `max_retries` by restoring the last
  checkpoint, and drains a final sync checkpoint on preemption (SIGTERM).
  A step's time is taken after its loss reaches the host (`.item()`),
  which waits for the card.  A restore keeps the placement of the state
  it restores into: DTensor leaves come back on their mesh, laid out as
  they were.

* `StragglerWatchdog` — per-step deadline monitor: records a step past its
  deadline and calls the injectable policy hook.

* `elastic_restore` — restore a checkpoint saved under any mesh onto the
  current mesh (each rank keeps its slice of every leaf:
  checkpoint.restore_checkpoint with target shardings).

* Deterministic data-pipeline replay: the batch function is a pure
  function of (seed, step), so a restore at step k reproduces the exact
  stream — no data is lost or duplicated across restarts.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

from ..parallel.sharding import named_shardings
from . import checkpoint as ckpt


@dataclasses.dataclass
class StragglerWatchdog:
    deadline_s: float
    on_straggler: Optional[Callable[[int, float], None]] = None
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, duration_s: float):
        if duration_s > self.deadline_s:
            self.events.append((step, duration_s))
            if self.on_straggler is not None:
                self.on_straggler(step, duration_s)


@dataclasses.dataclass
class Supervisor:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 3
    step_deadline_s: float = 600.0

    def run(self, *, state, train_step, batch_fn, num_steps: int,
            log_every: int = 10, log=print):
        """state: dict with 'params', 'opt', 'step' (int).  batch_fn(step)
        must be deterministic.  Returns (the final state, the watchdog)."""
        watchdog = StragglerWatchdog(self.step_deadline_s)
        preempted = {"flag": False}

        def _sigterm(signum, frame):
            preempted["flag"] = True

        old = signal.signal(signal.SIGTERM, _sigterm)
        try:
            restored = self._try_restore(state)
            if restored is not None:
                state = restored
                log(f"[supervisor] restored step {state['step']}")
            retries = 0
            while state["step"] < num_steps:
                step = state["step"]
                t0 = time.perf_counter()
                try:
                    batch = batch_fn(step)
                    params, opt, metrics = train_step(
                        state["params"], state["opt"], batch, step)
                    loss = metrics["loss"].item()
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # transient failure path
                    retries += 1
                    log(f"[supervisor] step {step} failed ({e!r}); "
                        f"retry {retries}/{self.max_retries}")
                    if retries > self.max_retries:
                        raise
                    restored = self._try_restore(state)
                    if restored is not None:
                        state = restored
                    continue
                retries = 0
                dt = time.perf_counter() - t0
                watchdog.observe(step, dt)
                state = {"params": params, "opt": opt, "step": step + 1}
                if log_every and (step % log_every == 0):
                    log(f"[step {step}] loss={loss:.4f} "
                        f"gnorm={float(metrics['grad_norm']):.3f} "
                        f"lr={float(metrics['lr']):.2e} {dt * 1e3:.0f}ms")
                if (step + 1) % self.ckpt_every == 0 or preempted["flag"]:
                    self._save(state, wait=preempted["flag"])
                    ckpt.keep_last(self.ckpt_dir, self.keep)
                if preempted["flag"]:
                    log(f"[supervisor] preempted at step {state['step']}; "
                        "final checkpoint written")
                    break
            self._save(state, wait=True)
            return state, watchdog
        finally:
            signal.signal(signal.SIGTERM, old)

    # ------------------------------------------------------------------
    def _save(self, state, wait: bool):
        ckpt.save_checkpoint(self.ckpt_dir, state["step"],
                             {"params": state["params"], "opt": state["opt"]},
                             wait=wait)

    def _try_restore(self, state):
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return None
        like = {"params": state["params"], "opt": state["opt"]}
        tree, step = ckpt.restore_checkpoint(self.ckpt_dir, like)
        return {"params": tree["params"], "opt": tree["opt"], "step": step}


def elastic_restore(ckpt_dir: str, like, mesh, pspec_fn):
    """Restore the newest checkpoint under `ckpt_dir` into the structure
    of `like`, onto `mesh` with the shardings of the specs
    `pspec_fn(like, mesh)` gives (`parallel.sharding.validated_pspecs`),
    whatever mesh saved it.  -> (tree, step)."""
    shardings = named_shardings(like, pspec_fn(like, mesh), mesh)
    return ckpt.restore_checkpoint(ckpt_dir, like, shardings=shardings)
