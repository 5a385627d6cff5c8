"""Training loop with checkpoint/restart, straggler monitoring, and metrics
(PyTorch port of ``repro.train.loop``).

Drives a train step built by :func:`repro_torch.train.state.make_train_step`.
A SIGTERM or a crash at any point resumes from the last committed
checkpoint (restore-on-start). Checkpoints hold the state in the JAX
package's layout — ``TrainState(params, AdamWState(step, m, v))`` with
``params["layers"]`` (and m's and v's) stacked on a leading axis — so the
reference's ``TrainLoop`` restores the port's files and the port restores
the reference's. ``batch_fn(step)`` returns numpy arrays (or tensors);
they go to the state's device before the step.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config.base import TrainConfig
from repro_torch.distrib.fault import StragglerMonitor
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.state import TrainState, load_stacked, stack_layers


@dataclass
class LoopMetrics:
    steps: List[int] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)

    def log(self, step: int, loss: float, dt: float) -> None:
        self.steps.append(step)
        self.losses.append(loss)
        self.step_times.append(dt)


class TrainLoop:
    def __init__(self, step_fn: Callable, state: TrainState,
                 batch_fn: Callable[[int], tuple], tcfg: TrainConfig,
                 log_every: int = 10, print_fn=print):
        self.tcfg = tcfg
        self.batch_fn = batch_fn
        self.step_fn = step_fn
        self.ckpt = Checkpointer(tcfg.checkpoint_dir,
                                 keep=tcfg.keep_checkpoints)
        self.metrics = LoopMetrics()
        self.monitor = StragglerMonitor()
        self.log_every = log_every
        self.print = print_fn
        self._stop = False
        self.device = tree_leaves(state.params)[0].device

        # restore-on-start (fault tolerance drill)
        latest = self.ckpt.latest_step()
        if latest is not None:
            tree, step = self.ckpt.restore(stack_layers(state, values=False))
            load_stacked(state, tree)
            self.start_step = step + 1
            self.print(f"[loop] restored checkpoint step {step}")
        else:
            self.start_step = 0
        self.state = state

    def request_stop(self, *_):
        self._stop = True

    def _save(self, step: int) -> None:
        self.ckpt.save(step, stack_layers(self.state))

    def run(self, n_steps: Optional[int] = None) -> LoopMetrics:
        total = n_steps if n_steps is not None else self.tcfg.total_steps
        end = self.start_step + total
        prev = signal.signal(signal.SIGTERM, self.request_stop)
        try:
            for step in range(self.start_step, end):
                if self._stop:
                    self.print(f"[loop] SIGTERM — checkpointing at {step}")
                    break
                batch = tuple(torch.as_tensor(x, device=self.device)
                              for x in self.batch_fn(step))
                t0 = time.perf_counter()
                self.state, m = self.step_fn(self.state, *batch)
                loss = float(m["loss"])
                dt = time.perf_counter() - t0
                self.metrics.log(step, loss, dt)
                self.monitor.record(0, dt)
                if step % self.log_every == 0:
                    self.print(f"[loop] step {step} loss {loss:.4f} "
                               f"({dt*1e3:.0f} ms)")
                if (step + 1) % self.tcfg.checkpoint_every == 0:
                    self._save(step)
            else:
                step = end - 1
            self._save(step)
            self.ckpt.wait()
        finally:
            signal.signal(signal.SIGTERM, prev)
        return self.metrics
