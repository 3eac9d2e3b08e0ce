"""Inference / serving API: load a checkpoint, jit once, predict on graphs.

The reference has no inference path beyond the eval loop (SURVEY.md §3.3);
this is the framework's serving surface: static-shape padded batching with
a fixed spec (compile once), task-appropriate decoding (argmax node /
class / GGS-NN token sequence until the end token)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ggnn.data.babi import TASKS
from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, forward, init_params
from ggnn.train.checkpoint import load_checkpoint


class Predictor:
    """Batched predictor over a fixed padding spec.

    ``predict(graphs)`` takes per-graph dicts (``n_nodes/edges/annotations``)
    and returns task-level predictions:

    - node_select → predicted node id per graph
    - per_node    → [n_nodes] class ids per graph
    - graph_gated → class id per graph
    - ggsnn       → list of token ids per graph (end token stripped)
    """

    def __init__(self, cfg: ModelConfig, spec: PaddingSpec,
                 params=None, checkpoint_path: str | None = None):
        self.cfg = cfg
        self.spec = spec
        if params is None:
            params = init_params(jax.random.PRNGKey(0), cfg)
            if checkpoint_path:
                tree, _ = load_checkpoint(checkpoint_path, {"params": params})
                params = tree["params"]
        self.params = params
        n_graphs = spec.n_graphs

        # production backends need a host-built per-batch layout; static
        # budgets keep its shapes fixed so this jit compiles once
        if cfg.backend == "onehot":
            from ggnn.ops.onehot import layout_for_batch
            self._layout = layout_for_batch
        elif cfg.backend == "window":
            from ggnn.ops.window import window_layout_for_batch
            self._layout = window_layout_for_batch
        else:
            self._layout = lambda b: None

        @jax.jit
        def _fwd(params, arrays, layout):
            return forward(params, cfg, arrays, n_graphs,
                           scatter_layout=layout)

        self._fwd = _fwd

    @classmethod
    def for_task(cls, task_id: int, checkpoint_path: str | None = None,
                 batch_size: int = 10, max_nodes: int = 16,
                 max_edges: int = 40, **model_kw) -> "Predictor":
        from ggnn.models.config import model_config_for_task
        task = TASKS[task_id]
        cfg = model_config_for_task(task, **model_kw)
        spec = PaddingSpec(
            n_graphs=batch_size, n_pad=batch_size * max_nodes,
            e_pad=batch_size * max_edges * 2,
            n_edge_types=task.n_edge_types,
            annotation_dim=task.annotation_dim).round_up()
        return cls(cfg, spec, checkpoint_path=checkpoint_path)

    def predict(self, graphs: list[dict]) -> list:
        out = []
        B = self.spec.n_graphs
        for i in range(0, len(graphs), B):
            chunk = graphs[i:i + B]
            batch = batch_graphs(chunk, self.spec)
            arrays = jax.tree.map(jnp.asarray, batch.arrays)
            res = np.asarray(self._fwd(self.params, arrays,
                                       self._layout(batch)))
            out.extend(self._decode(res, batch, len(chunk)))
        return out

    def _decode(self, res, batch, n_real):
        cfg = self.cfg
        offs = np.concatenate([[0], np.cumsum(batch.n_nodes)])[:-1]
        decoded = []
        for gi in range(n_real):
            n = int(batch.n_nodes[gi])
            if cfg.head == "node_select":
                decoded.append(int(np.argmax(res[offs[gi]:offs[gi] + n])))
            elif cfg.head == "per_node":
                decoded.append(np.argmax(res[offs[gi]:offs[gi] + n], axis=-1))
            elif cfg.head == "graph_gated":
                decoded.append(int(np.argmax(res[gi])))
            elif cfg.head == "ggsnn":
                if cfg.ggsnn_output == "node":
                    # node-selection variant: the k-th output is the
                    # selected next path node (local id); no end token —
                    # sequence length is task-determined (n_rounds)
                    decoded.append([
                        int(np.argmax(res[k, offs[gi]:offs[gi] + n]))
                        for k in range(res.shape[0])])
                else:
                    toks = []
                    end = cfg.n_classes - 1
                    for k in range(res.shape[0]):
                        t = int(np.argmax(res[k, gi]))
                        if t == end:
                            break
                        toks.append(t)
                    decoded.append(toks)
        return decoded
