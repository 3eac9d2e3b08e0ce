"""Parameter initialization.

Uniform U(-1/√fan_in, 1/√fan_in) for every weight and bias — the reference
family's (PyTorch ``nn.Linear`` default) scheme, which the paper accuracies
were obtained with (SURVEY.md §7.2.4: match init ranges for parity)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ggnn.models.config import ModelConfig


def _uniform(key, shape, fan_in, dtype):
    bound = 1.0 / (fan_in ** 0.5)
    return jax.random.uniform(key, shape, dtype, -bound, bound)


def _linear(key, d_in, d_out, dtype):
    kw, kb = jax.random.split(key)
    return (_uniform(kw, (d_in, d_out), d_in, dtype),
            _uniform(kb, (d_out,), d_in, dtype))


def init_prop(key, cfg: ModelConfig, dtype) -> dict:
    D, T2 = cfg.state_dim, cfg.n_message_types
    keys = jax.random.split(key, 8)
    msg_w = _uniform(keys[0], (T2, D, D), D, dtype)
    msg_b = _uniform(keys[1], (T2, D), D, dtype)
    gru = {}
    for i, g in enumerate(("z", "r", "h")):
        kw, ku, kb = jax.random.split(keys[2 + i], 3)
        gru[f"w{g}"] = _uniform(kw, (D, D), D, dtype)
        gru[f"u{g}"] = _uniform(ku, (D, D), D, dtype)
        gru[f"b{g}"] = _uniform(kb, (D,), D, dtype)
    prop = {"msg_w": msg_w, "msg_b": msg_b, "gru": gru}
    if cfg.edge_gates:
        G = cfg.gate_dim or D
        prop["gate_p"] = _uniform(keys[5], (D, G), D, dtype)
        prop["gate_q"] = _uniform(keys[6], (D, G), D, dtype)
    return prop


def init_mlp_head(key, cfg: ModelConfig, n_out: int, dtype) -> dict:
    d_in = cfg.state_dim + cfg.annotation_dim
    H = cfg.head_hidden
    k1, k2 = jax.random.split(key)
    w1, b1 = _linear(k1, d_in, H, dtype)
    w2, b2 = _linear(k2, H, n_out, dtype)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}


def init_gated_head(key, cfg: ModelConfig, n_out: int, dtype) -> dict:
    d_in = cfg.state_dim + cfg.annotation_dim
    G = cfg.readout_dim
    ki, kj, k1, k2 = jax.random.split(key, 4)
    gi_w, gi_b = _linear(ki, d_in, G, dtype)
    gj_w, gj_b = _linear(kj, d_in, G, dtype)
    c1, c1b = _linear(k1, G, G, dtype)
    c2, c2b = _linear(k2, G, n_out, dtype)
    return {"gi_w": gi_w, "gi_b": gi_b, "gj_w": gj_w, "gj_b": gj_b,
            "c1": c1, "c1b": c1b, "c2": c2, "c2b": c2b}


def init_annotation_net(key, cfg: ModelConfig, dtype) -> dict:
    d_in = cfg.state_dim + cfg.annotation_dim
    H = cfg.head_hidden
    k1, k2 = jax.random.split(key)
    a1, a1b = _linear(k1, d_in, H, dtype)
    a2, a2b = _linear(k2, H, cfg.annotation_dim, dtype)
    return {"a1": a1, "a1b": a1b, "a2": a2, "a2b": a2b}


def init_params(key: jax.Array, cfg: ModelConfig) -> dict:
    """Full parameter pytree for the configured head (oracle layout)."""
    dtype = jnp.dtype(cfg.param_dtype)
    kp, kh, ka = jax.random.split(key, 3)
    params = {"prop": init_prop(kp, cfg, dtype)}
    if cfg.head == "node_select":
        params["head"] = init_mlp_head(kh, cfg, 1, dtype)
    elif cfg.head == "per_node":
        params["head"] = init_mlp_head(kh, cfg, cfg.n_classes, dtype)
    elif cfg.head == "graph_gated":
        params["head"] = init_gated_head(kh, cfg, cfg.n_classes, dtype)
    elif cfg.head == "ggsnn":
        def out_head(k):
            if cfg.ggsnn_output == "node":
                return init_mlp_head(k, cfg, 1, dtype)
            return init_gated_head(k, cfg, cfg.n_classes, dtype)
        if cfg.share_round_nets:
            params["out"] = out_head(kh)
            params["ann"] = init_annotation_net(ka, cfg, dtype)
        else:
            # per-round output/annotation nets F_o^{(k)}, F_x^{(k)}
            # (paper §4 non-shared option): stacked leading-K params
            kout = jax.random.split(kh, cfg.n_rounds)
            kann = jax.random.split(ka, cfg.n_rounds)
            outs = [out_head(k) for k in kout]
            anns = [init_annotation_net(k, cfg, dtype) for k in kann]
            params["out"] = jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
            params["ann"] = jax.tree.map(lambda *xs: jnp.stack(xs), *anns)
    else:
        raise ValueError(f"unknown head {cfg.head!r}")
    return params
