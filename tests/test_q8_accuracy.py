"""q8 serving accuracy story: quantization error on
TRAINED weights, not random init.

A D=128 per-node-classification model is trained bf16 on a synthetic
community graph against labels produced by a fixed random teacher GGNN
(guarantees the task is expressible; the student's trained weight
distribution is what q8 will see in production).  The trained model is
then served three ways on the SAME graph:

  - xla bf16 (the exact reference),
  - window fused bf16 (the production serving step, bit-comparable),
  - window fused q8 (int8 table, power-of-2 per-window scales).

Pinned acceptance budget (docs/DESIGN.md "q8 accuracy budget"):
  - argmax agreement q8 vs bf16 ≥ 99% of nodes at T=5,
  - trained-task accuracy delta ≤ 1%,
  - state error rel-L2 ≤ 2% at T=5 and ≤ 4% at T=8.

The GRU's gating is contractive for the per-step quantization noise, so
the error does not accumulate with serving depth; the budget leaves
headroom at T=5 and more at T=8.  Runs on CPU in about a minute."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ggnn.models import ModelConfig, init_params
from ggnn.models.ggnn import init_state, propagate
from ggnn.models.heads import per_node_logits, per_node_loss
from ggnn.ops.window import build_window_layout

N, E, D, A, ETYPES, CLASSES = 512, 6000, 128, 8, 4, 4


@functools.lru_cache(maxsize=1)
def _setup():
    """Graph, teacher labels, TRAINED student params (cached per run)."""
    from ggnn.data.synthetic import synthetic_batch
    batch = synthetic_batch(N, E, ETYPES, annotation_dim=A, seed=7,
                            node_mult=128, n_communities=8, p_intra=0.9)
    ops = dict(edge_src=jnp.asarray(batch.edge_src),
               edge_dst=jnp.asarray(batch.edge_dst),
               edge_type=jnp.asarray(batch.edge_type),
               edge_mask=jnp.asarray(batch.edge_mask))
    ann = jnp.asarray(batch.annotations)

    cfg = ModelConfig(state_dim=D, annotation_dim=A, n_edge_types=ETYPES,
                      n_steps=5, head="per_node", n_classes=CLASSES,
                      compute_dtype="bfloat16", backend="xla")
    # teacher: fixed random model defines the labels
    teacher = init_params(jax.random.PRNGKey(100), cfg)
    h_t = propagate(teacher["prop"], cfg, ann, **ops)
    labels = jnp.argmax(per_node_logits(teacher["head"], h_t, ann), axis=-1)

    # student: train bf16 on the teacher labels
    params = init_params(jax.random.PRNGKey(0), cfg)
    optimizer = optax.adam(3e-3)
    opt_state = optimizer.init(params)
    mask = jnp.ones((N,), jnp.float32)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            h = propagate(p["prop"], cfg, ann, **ops)
            logits = per_node_logits(p["head"], h, ann)
            return per_node_loss(logits, labels, mask)[0]
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for _ in range(150):
        params, opt_state, loss = step(params, opt_state)

    return batch, ops, ann, cfg, labels, params


def _accuracy(logits, labels):
    return float(jnp.mean((jnp.argmax(logits, -1) == labels)))


def _window_layout(batch):
    return build_window_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        batch.spec.n_pad, window=256, n_message_types=2 * ETYPES,
        block_rows=128, row_major="block")


def test_q8_trained_model_accuracy():
    batch, ops, ann, cfg, labels, params = _setup()
    h_ref = propagate(params["prop"], cfg, ann, **ops)
    logits_ref = per_node_logits(params["head"], h_ref, ann)
    acc_ref = _accuracy(logits_ref, labels)
    # the student must actually have learned — otherwise the agreement
    # numbers below are vacuous
    assert acc_ref >= 0.9, f"student failed to train: acc={acc_ref}"

    lay = _window_layout(batch)
    kw = dict(state_dim=D, annotation_dim=A, n_edge_types=ETYPES,
              n_steps=5, head="per_node", n_classes=CLASSES,
              compute_dtype="bfloat16", backend="window", fuse_gru=True)
    cfg_w = ModelConfig(**kw)
    cfg_q8 = ModelConfig(**kw, quantized_table=True)
    h_w = propagate(params["prop"], cfg_w, ann, scatter_layout=lay, **ops)
    h_q8 = propagate(params["prop"], cfg_q8, ann, scatter_layout=lay, **ops)

    logits_w = per_node_logits(params["head"], h_w, ann)
    logits_q8 = per_node_logits(params["head"], h_q8, ann)
    agree = float(jnp.mean(
        (jnp.argmax(logits_q8, -1) == jnp.argmax(logits_w, -1))))
    acc_w = _accuracy(logits_w, labels)
    acc_q8 = _accuracy(logits_q8, labels)
    print(f"\nacc xla={acc_ref:.4f} window_bf16={acc_w:.4f} "
          f"q8={acc_q8:.4f} argmax_agreement={agree:.4f}")

    # budget (docs/DESIGN.md "q8 accuracy budget")
    assert agree >= 0.99, f"argmax agreement {agree} < 0.99"
    assert abs(acc_q8 - acc_w) <= 0.01, (acc_q8, acc_w)
    # the bf16 window fused path itself must track the xla reference
    assert abs(acc_w - acc_ref) <= 0.01, (acc_w, acc_ref)


def test_q8_error_growth_vs_steps():
    """State error accumulates roughly linearly in T (each step adds one
    quantized aggregation); the budget bounds it at the serving horizon
    and at 1.6x the horizon to catch super-linear blowup."""
    batch, ops, ann, cfg, labels, params = _setup()
    lay = _window_layout(batch)
    errs = {}
    for T in (1, 3, 5, 8):
        kw = dict(state_dim=D, annotation_dim=A, n_edge_types=ETYPES,
                  n_steps=T, head="per_node", n_classes=CLASSES,
                  compute_dtype="bfloat16", backend="window", fuse_gru=True)
        h_w = propagate(params["prop"], ModelConfig(**kw), ann,
                        scatter_layout=lay, **ops)
        h_q8 = propagate(params["prop"],
                         ModelConfig(**kw, quantized_table=True), ann,
                         scatter_layout=lay, **ops)
        num = float(jnp.linalg.norm(h_q8.astype(jnp.float32)
                                    - h_w.astype(jnp.float32)))
        den = float(jnp.linalg.norm(h_w.astype(jnp.float32)))
        errs[T] = num / den
    print(f"\nq8 rel-L2 state error vs T: "
          + "  ".join(f"T={t}: {e:.4f}" for t, e in errs.items()))
    assert errs[5] <= 0.02, errs
    assert errs[8] <= 0.04, errs
    # sub-quadratic growth: doubling-ish steps must not square the error
    assert errs[8] <= 4 * max(errs[3], 1e-6), errs


def test_q8_grads_training_accuracy():
    """int8 GRADIENTS: training the fused window step with the quantized
    backward (per-block power-of-2 scales on the a-bar cotangent,
    int8×int8→int32 transposed count product) must track exact-bf16
    training.  Two trajectories under different
    rounding decorrelate pointwise once the loss is small (measured:
    final 0.080 vs 0.127 on this task with BOTH at ~0.97+ accuracy), so
    the budget is trajectory agreement EARLY + task-level equivalence at
    the end: median relative loss gap over the first 20 steps <= 5%,
    final accuracy delta <= 2% with both >= 0.9, q8 final loss <= 2.5x
    exact (the task is learned, not diverged)."""
    batch, ops, ann, cfg, labels, params0 = _setup()
    kw = dict(window=256, n_message_types=2 * ETYPES, block_rows=128,
              row_major="block")
    lay = build_window_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        batch.spec.n_pad, **kw)
    lay_q = build_window_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        batch.spec.n_pad, **kw, grad_quant=True)
    assert lay_q.grad_quant and not lay.grad_quant
    cfg_w = ModelConfig(state_dim=D, annotation_dim=A,
                        n_edge_types=ETYPES, n_steps=5, head="per_node",
                        n_classes=CLASSES, compute_dtype="bfloat16",
                        backend="window", fuse_gru=True)
    mask = jnp.ones((N,), jnp.float32)

    def train(lay, steps=60):
        params = init_params(jax.random.PRNGKey(0), cfg_w)
        optimizer = optax.adam(3e-3)
        opt_state = optimizer.init(params)

        @jax.jit
        def step(params, opt_state):
            def loss_fn(p):
                h = propagate(p["prop"], cfg_w, ann, scatter_layout=lay,
                              **ops)
                logits = per_node_logits(p["head"], h, ann)
                return per_node_loss(logits, labels, mask)[0]
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        losses = []
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state)
            losses.append(float(loss))
        h = propagate(params["prop"], cfg_w, ann, scatter_layout=lay,
                      **ops)
        acc = _accuracy(per_node_logits(params["head"], h, ann), labels)
        return np.asarray(losses), acc

    losses_e, acc_e = train(lay)
    losses_q, acc_q = train(lay_q)
    gap = np.abs(losses_q - losses_e) / (np.abs(losses_e) + 1e-6)
    print(f"\nexact acc={acc_e:.4f} q8grad acc={acc_q:.4f} "
          f"early median loss gap={np.median(gap[:20]):.4f} "
          f"final losses {losses_e[-1]:.4f}/{losses_q[-1]:.4f}")
    assert acc_e >= 0.9, f"exact-grad training failed to learn: {acc_e}"
    assert acc_q >= 0.9, f"q8-grad training failed to learn: {acc_q}"
    assert abs(acc_q - acc_e) <= 0.02, (acc_q, acc_e)
    assert np.median(gap[:20]) <= 0.05, np.median(gap[:20])
    assert losses_q[-1] <= 2.5 * losses_e[-1] + 1e-3, (losses_q[-1],
                                                       losses_e[-1])
