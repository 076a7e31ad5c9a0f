"""The ``train`` mix: the trainer's own epoch entry, closed loop.

Set-up builds one trainer, model and Adam from the seed, and drives them
through the ``checked_steps`` first steps by the window's own call
(``run_epoch`` with an ``order`` slice): step 1 alone, so Adam's state
gives the first gradient, then the rest in one call.  Those steps are
also the warm-up: every kernel of a step has run once before the window.
The window then calls ``run_epoch`` with ``steps_per_call`` full batches
at a time until ``--seconds`` have passed, and ends on a step boundary.
Batches come from a seeded permutation of the split's links, epoch after
epoch; an epoch uses its full batches only.  ``attempted`` counts steps;
``failed`` those that raised or gave a non-finite loss.

``check()`` runs the reference over the checked steps once the program
is freed: the loss of each step, the first gradient by leaf and the
parameters' change after the checked steps by leaf.
"""

from __future__ import annotations

import time

import torch

from benchmark.drivers import common
from benchmark.inputs.graphs import stream
from benchmark.reference import check
from benchmark.trace import span


def call_seed(seed: int, call: int) -> int:
    """The ``run_epoch`` seed of the run's call number ``call`` (it seeds
    the call's dropout masks)."""
    return (int(seed) * 0x2545F4914F6CDD1D + call * 7919 + 1) % (1 << 63)


class Driver:
    kind = "train"

    def __init__(self, cell, seed: int, device, log=print):
        self.cell, self.seed, self.device, self.log = cell, seed, device, log
        self.conf, self.mix = cell.config, cell.mix
        if self.mix["loop"] != "closed":
            raise ValueError("the train driver runs a closed loop of steps")

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from subgraph_sketching_tpu_torch.train.loops import make_optimizer
        self.inputs = common.Inputs(self.conf, self.seed, self.device)
        (self.cfg, _, self.trainer, self.model,
         self.weights) = common.build_program(self.conf, self.inputs,
                                              self.seed, self.device)
        self.opt = make_optimizer(self.cfg, self.model.parameters())
        self.batch = self.cfg.batch_size
        self.num_links = len(self.inputs.pos) + len(self.inputs.neg)
        self.steps_per_epoch = self.num_links // self.batch
        if self.steps_per_epoch < 1:
            raise ValueError("the split holds less than one batch")
        self._perms = {}
        self.step, self.call = 0, 0
        self.shape = common.model_shape(self.conf, self.trainer)
        k = self.mix["checked_steps"]
        self.checked = {"orders": [], "seeds": [], "losses": []}
        self._run(1, checked=True)
        # the first gradient as Adam got it: its first moment after one
        # step is (1 - beta1) g (zero where the step left no state)
        beta1 = self.opt.defaults["betas"][0]
        self.checked["grad"] = {
            n: self.opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            / (1 - beta1) for n, p in self.model.named_parameters()}
        if k > 1:
            self._run(k - 1, checked=True)
        self.checked["after"] = {n: p.detach().clone()
                                 for n, p in self.model.named_parameters()}

    def _order(self, steps: int) -> torch.Tensor:
        """The link indices of the next ``steps`` batches."""
        rows = []
        for t in range(self.step, self.step + steps):
            epoch, j = divmod(t, self.steps_per_epoch)
            if epoch not in self._perms:
                self._perms = {epoch: torch.randperm(
                    self.num_links, device=self.device,
                    generator=stream(self.seed, f"order{epoch}",
                                     self.device))}
            rows.append(self._perms[epoch][j * self.batch:
                                           (j + 1) * self.batch])
        return torch.cat(rows)

    def _run(self, steps: int, checked: bool = False) -> torch.Tensor:
        order = self._order(steps)
        seed = call_seed(self.seed, self.call)
        losses = self.trainer.run_epoch(self.model, self.opt, seed,
                                        order=order)
        if checked:
            self.checked["orders"].append(order.clone())
            self.checked["seeds"].append(seed)
            self.checked["losses"].extend(losses.detach().cpu().tolist())
        self.step += steps
        self.call += 1
        return losses

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float, tracer=None, trace_seconds: float = 0):
        """Closed loop of ``run_epoch`` calls; with ``tracer`` one call
        warms the profiler, then a slice of calls lasting
        ``trace_seconds`` is traced (counted in the window too)."""
        k = self.conf["train"]["steps_per_call"]
        steps = failed = 0
        self.slice = None

        def one_call():
            nonlocal steps, failed
            try:
                with span("train.run_epoch", tracer is not None):
                    losses = self._run(k)
                with span("train.read_losses", tracer is not None):
                    loss = losses.cpu()
                failed += int((~torch.isfinite(loss)).sum())
            except Exception as exc:   # counted, and the run goes on
                self.log(f"step failed: {exc!r}")
                failed += k
            steps += k

        t0 = time.perf_counter()
        if tracer is not None:
            one_call()
            k1_before, s_before = common.k1_launches(), steps

            def body():
                t = time.perf_counter()
                while True:
                    one_call()
                    if time.perf_counter() - t >= trace_seconds:
                        break
            tracer.slice(body)
            k1 = common.k1_launches()
            self.slice = {"steps": steps - s_before,
                          "k1_launches": {n: k1[n] - k1_before[n]
                                          for n in k1}}
        while time.perf_counter() - t0 < seconds:
            one_call()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        return {"attempted": steps, "failed": failed,
                "metrics": {"train_links_per_s":
                            (steps - failed) * self.batch / elapsed}}

    def layer_summary(self) -> dict:
        """What the per-layer readers read besides the trace."""
        s = dict(self.slice or {})
        s.update(shape=self.shape, batch=self.batch,
                 links=s.get("steps", 0) * self.batch, train=True)
        data = self.trainer._data["train"]
        plan = data.get("plan")
        if plan is not None and hasattr(plan, "fwd"):
            s["plan"] = {"fwd_subruns": plan.fwd.num_subruns,
                         "bwd_subruns": plan.bwd.num_subruns,
                         "nodes": plan.num_nodes}
        return s

    def measure_context(self) -> dict:
        """The program's objects a reader may time (``measure(ctx)``)."""
        data = self.trainer._data["train"]
        return {"device": self.device, "plan": data.get("plan"),
                "shape": self.shape}

    # -- correctness --------------------------------------------------------
    def free(self) -> None:
        del self.trainer, self.model, self.opt
        self._perms = {}

    def check(self) -> dict:
        """The compared numbers: program against the reference."""
        ref = check.reference_train(self.conf, self.inputs, self.weights,
                                    self.checked, self.device)
        return check.train_gaps(self.checked, ref)
