"""Jitted train/eval loops (SURVEY.md §2.1 C8/C9).

The reference's per-batch Python loop (zero-grad → forward → backward →
Adam step, SURVEY.md §3.1) becomes one jitted ``train_step`` —
value_and_grad + optax Adam update with donated param/opt-state buffers —
executed over the static-shape batches of :class:`~ggnn.data.BatchLoader`."""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import jax
import numpy as np
import optax

from ggnn.data.babi import BabiDataset, TASKS
from ggnn.data.generators import generate_all
from ggnn.data.loader import BatchLoader
from ggnn.graph import PaddingSpec
from ggnn.models import init_params, loss_and_metrics
from ggnn.train.checkpoint import load_checkpoint, save_checkpoint
from ggnn.train.config import TrainConfig
from ggnn.train.metrics import MetricsLogger


def make_train_step(model_cfg, n_graphs: int, optimizer):
    if getattr(model_cfg, "quantized_table", False):
        # The int8 serving table rounds its values: its gradient is zero
        # almost everywhere, so training through it would learn nothing.
        # Fail loudly here instead.
        raise ValueError(
            "quantized_table=True is a SERVING mode (forward-only int8 "
            "table); train with quantized_table=False and quantize the "
            "trained weights for serving")

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, arrays, scatter_layout=None):
        def loss_fn(p):
            return loss_and_metrics(p, model_cfg, arrays, n_graphs,
                                    scatter_layout=scatter_layout)
        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state_new = optimizer.update(grads, opt_state, params)
        params_new = optax.apply_updates(params, updates)
        return params_new, opt_state_new, metrics
    return train_step


def make_eval_step(model_cfg, n_graphs: int):
    @jax.jit
    def eval_step(params, arrays, scatter_layout=None):
        _, metrics = loss_and_metrics(params, model_cfg, arrays, n_graphs,
                                      scatter_layout=scatter_layout)
        return metrics
    return eval_step


class Trainer:
    """End-to-end experiment driver for one registered config.

    Usage::

        t = Trainer(build_config("babi4"))
        result = t.run()          # trains, evals, checkpoints, logs
        result["test_accuracy"]
    """

    def __init__(self, cfg: TrainConfig, logger: Optional[MetricsLogger] = None):
        self.cfg = cfg
        self.logger = logger or MetricsLogger(cfg.metrics_path)
        task = TASKS[cfg.task_id]

        train_path = os.path.join(cfg.data_root, f"processed_{cfg.fold}",
                                  "train", f"{cfg.task_id}_graphs.txt")
        if not os.path.exists(train_path):
            if not cfg.generate_if_missing:
                raise FileNotFoundError(train_path)
            generate_all(cfg.data_root, tasks=(cfg.task_id,), folds=(cfg.fold,),
                         n_train=max(cfg.n_train * task.n_question_types, 50),
                         n_test=max(cfg.n_test * task.n_question_types, 50),
                         seed=cfg.seed)

        self.train_ds = BabiDataset(cfg.data_root, cfg.task_id, "train",
                                    cfg.fold, cfg.question_id, cfg.n_train)
        self.test_ds = BabiDataset(cfg.data_root, cfg.task_id, "test",
                                   cfg.fold, cfg.question_id, cfg.n_test)

        # one static spec covering both splits (jit compiles once)
        max_nodes = max(self.train_ds.max_nodes, self.test_ds.max_nodes)
        max_edges = max(self.train_ds.max_edges, self.test_ds.max_edges)
        self.spec = PaddingSpec(
            n_graphs=cfg.batch_size,
            n_pad=cfg.batch_size * max_nodes,
            e_pad=cfg.batch_size * max_edges * 2,
            n_edge_types=task.n_edge_types,
            annotation_dim=task.annotation_dim).round_up()

        pads = self.train_ds.target_pads()
        self.train_loader = BatchLoader(self.train_ds.graphs, self.spec, pads,
                                        shuffle=True, seed=cfg.seed)
        self.test_loader = BatchLoader(self.test_ds.graphs, self.spec, pads,
                                       shuffle=False)

        self.params = init_params(jax.random.PRNGKey(cfg.seed), cfg.model)
        self.optimizer = (optax.adamw(cfg.lr, weight_decay=cfg.weight_decay)
                          if cfg.weight_decay > 0 else optax.adam(cfg.lr))
        self.opt_state = self.optimizer.init(self.params)
        self.train_step = make_train_step(cfg.model, cfg.batch_size,
                                          self.optimizer)
        self.eval_step = make_eval_step(cfg.model, cfg.batch_size)
        self.step = 0
        self.epoch = 0
        self._eval_cache = None

    def _layout(self, batch):
        """Static-budget scatter layout for the onehot backend (shapes are a
        pure function of the PaddingSpec — the jitted step compiles once)."""
        if self.cfg.model.backend != "onehot":
            return None
        from ggnn.ops.onehot import layout_for_batch
        return layout_for_batch(batch)

    # -- checkpointing ----------------------------------------------------
    def _ckpt_tree(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def save(self, path: str) -> None:
        save_checkpoint(path, self._ckpt_tree(), step=self.step,
                        epoch=self.epoch, extra={"config": self.cfg.name})

    def restore(self, path: str) -> None:
        tree, meta = load_checkpoint(path, self._ckpt_tree())
        self.params = tree["params"]
        self.opt_state = tree["opt_state"]
        self.step = meta["step"]
        self.epoch = meta["epoch"]
        self.train_loader.epoch = self.epoch

    # -- loops ------------------------------------------------------------
    def train_epoch(self) -> dict:
        sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        edges = 0.0
        t0 = time.perf_counter()
        for batch in self.train_loader.epoch_batches(self.epoch):
            self.params, self.opt_state, m = self.train_step(
                self.params, self.opt_state, batch.arrays,
                self._layout(batch))
            self.step += 1
            edges += float(batch.edge_mask.sum())
            for k in sums:
                sums[k] += float(m[k])
        dt = time.perf_counter() - t0
        self.epoch += 1
        n = max(sums["count"], 1.0)
        # propagated edge-messages per second (directed edges × T steps)
        eps = edges * self.cfg.model.n_steps / max(dt, 1e-9)
        return {"split": "train", "epoch": self.epoch, "step": self.step,
                "loss": sums["loss_sum"] / n, "accuracy": sums["correct"] / n,
                "epoch_time_s": dt, "edges_per_sec": eps}

    def evaluate(self) -> dict:
        sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        if self._eval_cache is None:
            # test topologies are fixed (no shuffle): build layouts once,
            # without the grad sub-layout eval never uses
            self._eval_cache = [
                (b, self._layout(b))
                for b in self.test_loader.epoch_batches(0)]
        for batch, layout in self._eval_cache:
            m = self.eval_step(self.params, batch.arrays, layout)
            for k in sums:
                sums[k] += float(m[k])
        n = max(sums["count"], 1.0)
        return {"split": "test", "epoch": self.epoch, "step": self.step,
                "loss": sums["loss_sum"] / n, "accuracy": sums["correct"] / n}

    def run(self) -> dict:
        cfg = self.cfg
        best = 0.0
        for _ in range(cfg.epochs - self.epoch):
            tr = self.train_epoch()
            if self.epoch % cfg.eval_every == 0 or self.epoch == cfg.epochs:
                ev = self.evaluate()
                best = max(best, ev["accuracy"])
                self.logger.log({**tr, "test_loss": ev["loss"],
                                 "test_accuracy": ev["accuracy"]})
            if cfg.checkpoint_every and cfg.checkpoint_dir and \
                    self.epoch % cfg.checkpoint_every == 0:
                self.save(os.path.join(cfg.checkpoint_dir,
                                       f"{cfg.name}_ep{self.epoch}.npz"))
        ev = self.evaluate()
        best = max(best, ev["accuracy"])
        if cfg.checkpoint_dir:
            self.save(os.path.join(cfg.checkpoint_dir, f"{cfg.name}_final.npz"))
        result = {"config": cfg.name, "epochs": self.epoch,
                  "test_accuracy": ev["accuracy"], "best_accuracy": best,
                  "test_loss": ev["loss"]}
        self.logger.log(result)
        return result
