"""Traffic driver: pipelined training epochs with evaluation, as the port's
training drivers run them (``main_qm9``: the EMA model on the val split,
the test split where val improved; ``main_rna_puzzles``: SmoothL1 on the
train and val splits).

Set-up builds each split from the seed (the traffic's ``generator``,
``gen/<generator>.py``, at the configuration's ``<split>_split`` sizes),
the loaders, the model with the seed's weights, the optimizer (and EMA),
stages the evaluation splits once (``StackedEval``), and drives the first
three steps through the window's own call and feed (``run_epoch`` over
``GraphLoader.prefetch``) on the first three batches of the first
permutation: the readings the check compares.  The window then runs whole
epochs back to back, each followed by its evaluation, and ends at the end
of the first evaluation that finishes after ``seconds`` (an evaluation
ends in its own host read).  The last evaluation's predictions, and the
weights it read, are kept for the check.

The configuration's ``train`` names the recipe: ``drop_last``, and under
``evaluate`` the ``model`` evaluated ("ema" or "live"), the ``metric`` (a
function of ``pamnet_tpu_torch.train.loop``: "mae", "smooth_l1"), the
``splits`` in order and ``gate`` (the splits after the first only where
the first improved).  The traffic's ``eval_sample`` caps the predictions
compared.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import steps as ref_steps

SPLITS = ("train", "val", "test")


def _params(model) -> dict:
    return dict(model.named_parameters())


class Cell:
    def __init__(self, cell: dict, cfg: dict, seed: int, device, traced: bool):
        self.cell, self.cfg, self.seed = cell, dict(cfg), seed
        self.device, self.traced = torch.device(device), traced
        self.spans: list = []  # (label, start_ns, end_ns) of the host's work
        self.idle_label = "train step issue (run_epoch)"
        self.facts: dict = {}
        self.recipe = cfg["train"]["evaluate"]
        self.best = None  # the gate's best reading of the first split
        self.passes = {split: 0 for split in self.recipe["splits"]}  # in the window

    # ---- data -------------------------------------------------------------
    def _splits(self) -> dict[str, list]:
        t = self.cell["traffic"]
        gen = importlib.import_module(f"benchmark.gen.{t['generator']}")
        return {split: gen.molecules(t, self.seed, self.cfg[f"{split}_split"], 10 + k)
                for k, split in enumerate(SPLITS) if self.cfg.get(f"{split}_split")}

    def setup(self) -> None:
        from pamnet_tpu_torch.config import PAMNetConfig, set_matmul_precision
        from pamnet_tpu_torch.data.loader import GraphLoader
        from pamnet_tpu_torch.models.pamnet import PAMNet
        from pamnet_tpu_torch.train import loop
        from pamnet_tpu_torch.train.ema import ema_init
        from pamnet_tpu_torch.train.schedules import constant, warmup_exponential

        cfg, t, dev = self.cfg, self.cfg["train"], self.device
        parts, last = {}, [time.monotonic()]

        def lap(name: str) -> None:
            now = time.monotonic()
            parts[name], last[0] = now - last[0], now

        self.facts["setup_parts"] = parts
        if dev.type == "cuda":
            set_matmul_precision()
        self.mols = self._splits()
        self.train_mols = self.mols["train"]
        lap("data_s")
        self.pcfg = PAMNetConfig(dataset=cfg["dataset"], dim=cfg["dim"], n_layer=cfg["n_layer"],
                                 cutoff_l=cfg["cutoff_l"], cutoff_g=cfg["cutoff_g"],
                                 flow=cfg["flow"], variant=cfg["variant"],
                                 compute_dtype=cfg["compute_dtype"])
        if self.pcfg.folds() != cfg["folded"]:
            raise RuntimeError(f"the program folds={self.pcfg.folds()}, the configuration "
                               f"states folded={cfg['folded']}")
        common = dict(dataset_kind=self.pcfg.dataset_kind, cutoff_l=cfg["cutoff_l"],
                      cutoff_g=cfg["cutoff_g"], batch_size=t["batch_size"],
                      variant=cfg["variant"])
        self.train_loader = GraphLoader(self.train_mols, shuffle=True, seed=self.seed % (1 << 63),
                                        drop_last=t["drop_last"], build_perms=True,
                                        wire_geometry="derive", **common)
        loaders = {split: self.train_loader if split == "train" else
                   GraphLoader(self.mols[split], **common) for split in self.recipe["splits"]}
        lap("loaders_s")

        class Kept(loop.StackedEval):
            """The program's ``StackedEval``, keeping the predictions of its
            last ``predict`` (the host array it returns) for the check."""

            def predict(self, model):
                out = super().predict(model)
                self.kept = out[0]
                return out

        self.evals, self.orders = [], []
        for split in self.recipe["splits"]:
            ld = loaders[split]
            state = ld.rng_state()  # a shuffled loader draws its order here
            ev = loop.StackedEval(ld, dev, verbose=False)
            ev.__class__ = Kept
            now = ld.rng_state()
            ld.set_rng_state(state)
            self.orders.append([i for idxs in ld.batches() for i in idxs])
            ld.set_rng_state(now)
            self.evals.append(ev)
        del loaders
        lap("stage_evals_s")

        spec = ref_steps.model_of(cfg).param_spec(cfg)
        self.model = PAMNet(self.pcfg).to(dev)
        lap("model_s")
        self.model.load_state_dict(weights.seeded_state(spec, self.seed, dev), strict=True)
        lap("weights_s")
        steps = len(self.train_loader)
        if t["schedule"] == "warmup_exponential":
            frac = len(self.train_mols) / t["batch_size"]
            schedule = warmup_exponential(t["lr"], steps, frac_steps_per_epoch=frac)
            self.cfg["train"] = dict(t, steps_per_epoch=steps, frac_steps=frac)
        else:
            schedule = constant(t["lr"])
        self.optimizer = loop.Optimizer(self.model.parameters(), schedule,
                                        clip_norm=t["clip_norm"])
        self.ema = ema_init(self.model.state_dict()) if t["ema_decay"] else None
        self.ema_model = PAMNet(self.pcfg).to(dev) if self.recipe["model"] == "ema" else None
        lap("optimizer_s")
        self._first_steps()
        lap("first_steps_s")
        self._evaluate(warm=True)  # every evaluation shape, before the window
        self._counts()
        lap("warm_eval_s")

    def _first_steps(self) -> None:
        """Steps 1-3 through ``run_epoch`` over the loader's prefetch, with the
        readings the check compares (module docstring)."""
        from pamnet_tpu_torch.train.loop import run_epoch

        kind = self.cfg["train"]["loss"]
        params = _params(self.model)
        start = {k: v.detach().clone() for k, v in params.items()}
        order = self.train_loader.batches()[:3]
        feed = lambda idxs: self.train_loader.prefetch(2, order=idxs)  # noqa: E731
        _, _, first, _ = run_epoch(self.model, self.optimizer, self.ema, feed(order[:1]),
                                   self.device, kind)
        state = self.optimizer.adam.state
        grads = {k: state.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach() / 0.1
                 for k, p in params.items()}
        _, _, rest, _ = run_epoch(self.model, self.optimizer, self.ema, feed(order[1:]),
                                  self.device, kind)
        self.readings = {
            "losses": [float(v) for v in first + rest],
            "grads": {k: g.clone() for k, g in grads.items()},
            "change": {k: params[k].detach() - start[k] for k in params},
        }
        if self.ema is not None:
            self.readings["ema_change"] = {k: self.ema[k].detach() - start[k] for k in params}
        self.check_steps = [[self.train_mols[i] for i in idxs] for idxs in order]

    def _evaluate(self, warm: bool = False) -> None:
        """One evaluation: the recipe's model on its splits, each through the
        program's metric (which ends in its host read)."""
        from pamnet_tpu_torch.train import loop

        t0 = time.time_ns()
        model = self.model
        if self.recipe["model"] == "ema":
            self.ema_model.load_state_dict(self.ema)
            model = self.ema_model
        metric = getattr(loop, self.recipe["metric"])
        first = metric(model, self.evals[0], self.device)
        done = [0]
        if warm or not self.recipe["gate"] or self.best is None or first <= self.best:
            for k in range(1, len(self.evals)):
                metric(model, self.evals[k], self.device)
                done.append(k)
            self.best = None if warm else first
        if not warm:
            for k in done:
                self.passes[self.recipe["splits"][k]] += 1
            self.spans.append(("evaluation", t0, time.time_ns()))
        self.last_eval = (model, done)

    def _counts(self) -> None:
        """Valid row counts of an epoch's training batches and of each
        evaluation split (for the FLOP and byte counts)."""
        from pamnet_tpu_torch.data.batch import structure_counts

        keys = ("n", "eg", "el", "t2", "t1")
        c = np.array([structure_counts(s) for s in self.train_loader.structs]).sum(0)
        self.epoch_counts = dict(zip(keys, map(int, c)))
        self.eval_counts = [dict(zip(keys, map(int, np.sum(
            [[gb.valid[k] for k in keys] for gb in ev.batches], 0)))) for ev in self.evals]

    # ---- the window ---------------------------------------------------------
    def window(self, seconds: float) -> None:
        from pamnet_tpu_torch.train.loop import run_epoch

        kind = self.cfg["train"]["loss"]
        stats, graphs, epochs, steps, failed = {}, 0, 0, 0, 0
        epoch_s, eval_s = [], []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0, w0 = time.time_ns(), time.perf_counter()
        self.window_start = time.monotonic()
        while True:
            e0 = time.perf_counter()
            loss_sum, ng, losses, n_steps = run_epoch(
                self.model, self.optimizer, self.ema, self.train_loader, self.device, kind,
                stats=stats)  # the loss sum is read back: the epoch's steps have ended
            failed += int((~torch.isfinite(torch.stack(losses))).sum())
            graphs, epochs, steps = graphs + ng, epochs + 1, steps + n_steps
            e1 = time.perf_counter()
            self._evaluate()
            epoch_s.append(e1 - e0)
            eval_s.append(time.perf_counter() - e1)
            if time.perf_counter() - w0 >= seconds:
                break
        w1, t1 = time.perf_counter(), time.time_ns()
        self.t_ns = (t0, t1)
        self.facts.update(window_s=w1 - w0, graphs=graphs, epochs=epochs, steps=steps,
                          attempted=steps, failed=failed,
                          queue_wait_s=stats.get("queue_wait_s", 0.0),
                          eval_s=sum((b - a) / 1e9 for _, a, b in self.spans),
                          eval_passes=sum(self.passes.values()),
                          epoch_s=epoch_s, each_eval_s=eval_s)
        self._keep_last_evaluation()

    def _keep_last_evaluation(self) -> None:
        """The weights the last evaluation read, and a seeded sample of the
        predictions it made with the molecules they belong to."""
        model, done = self.last_eval
        names = {name for name, _, _ in ref_steps.model_of(self.cfg).param_spec(self.cfg)}
        self.eval_state = {k: v.detach().clone() for k, v in model.state_dict().items()
                           if k in names}
        pool = [(k, i) for k in done for i in range(len(self.evals[k].kept))]
        rng = np.random.default_rng([self.seed % (1 << 63), 7])
        count = min(self.cell["traffic"].get("eval_sample", len(pool)), len(pool))
        picked = [pool[i] for i in sorted(rng.choice(len(pool), count, replace=False))]
        split = self.recipe["splits"]
        self.eval_mols = [self.mols[split[k]][self.orders[k][i]] for k, i in picked]
        self.eval_got = [float(self.evals[k].kept[i]) for k, i in picked]
        self.last_eval = None

    def work(self, counts_module) -> dict:
        """The window's model FLOPs and message-passing bytes."""
        cfg = self.cfg
        epochs = self.facts["epochs"]
        flops = counts_module.STEP_FACTOR * counts_module.forward_flops(cfg, self.epoch_counts)
        nbytes = counts_module.mp_bytes(cfg, self.epoch_counts, backward=True)
        flops, nbytes = flops * epochs, nbytes * epochs
        for c, split in zip(self.eval_counts, self.recipe["splits"]):
            flops += self.passes[split] * counts_module.forward_flops(cfg, c)
            nbytes += self.passes[split] * counts_module.mp_bytes(cfg, c)
        return {"flops": flops, "mp_bytes": nbytes}

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("model", "ema_model", "ema", "optimizer", "evals", "train_loader"):
            setattr(self, name, None)

    # ---- the check ----------------------------------------------------------
    def reference(self, precision: str = "float32", drop_half: bool = False) -> dict:
        """The reference's first three steps from the seed's weights, and its
        predictions of the last evaluation's sample with the weights that
        evaluation read."""
        from benchmark import check

        spec = ref_steps.model_of(self.cfg).param_spec(self.cfg)
        state = weights.seeded_state(spec, self.seed, self.device)
        with check.precision(precision) as quant:
            steps = ref_steps.train_steps(state, self.check_steps, self.cfg, self.device,
                                          quant, drop_half=drop_half)
            preds = ref_steps.scores(self.eval_state, self.eval_mols, self.cfg, self.device,
                                     quant, block=self.cell["traffic"].get("eval_block", 4))
        return dict(steps, eval=preds)

    def compare(self, ref: dict) -> dict:
        from benchmark import check

        return dict(check.train_gaps(self.readings, ref),
                    **check.eval_gaps(self.eval_got, ref["eval"]))

    def close(self) -> None:
        pass
