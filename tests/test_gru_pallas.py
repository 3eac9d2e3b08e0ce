"""The GRU cell (``_gru_core``, the jnp cell with a minimal-residual custom
VJP) against a plain reference: the same forward math differentiated by
JAX's autodiff, and the full-f32 cell."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ggnn.models.ggnn import _gru_core, _gru_fwd_math, fuse_gru, gru_update
from ggnn.models import ModelConfig, init_params


@pytest.fixture
def setup():
    N, D = 1024, 128
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    gru = params["prop"]["gru"]
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    a = jax.random.normal(jax.random.PRNGKey(2), (N, D)) * 2.0
    return gru, h, a


def _plain(mdt, gru, h, a):
    """Reference cell: the forward math with no custom VJP."""
    return _gru_fwd_math(mdt, *fuse_gru(gru), gru["uh"], h, a)[0]


def _assert_grads_close(g_got, g_ref):
    """Per leaf: rel-L2 error < 1e-2 and max error < 1e-2 of the leaf's
    largest entry — the custom VJP keeps z, r, h̃ in bf16 (relative
    rounding 3.9e-3), the autodiff reference keeps them in f32."""
    for pr, pp in zip(jax.tree_util.tree_leaves(g_ref),
                      jax.tree_util.tree_leaves(g_got)):
        pr, pp = np.asarray(pr, np.float64), np.asarray(pp, np.float64)
        scale = np.max(np.abs(pr)) + 1e-6
        assert np.linalg.norm(pp - pr) <= 1e-2 * np.linalg.norm(pr) + 1e-9
        assert np.max(np.abs(pp - pr)) <= 1e-2 * scale


def test_gru_forward_matches_plain_cell(setup):
    gru, h, a = setup
    got = gru_update(gru, h, a, matmul_dtype=jnp.bfloat16)
    ref = _plain("bfloat16", gru, h, a)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


def test_gru_custom_vjp_matches_autodiff(setup):
    """The custom VJP (bf16 residuals z, r, h̃) tracks autodiff of the
    plain cell within bf16 noise, for the weights, h and a."""
    gru, h, a = setup

    def loss_ref(gru, h, a):
        return jnp.sum(_plain("bfloat16", gru, h, a) ** 2)

    def loss_got(gru, h, a):
        return jnp.sum(gru_update(gru, h, a,
                                  matmul_dtype=jnp.bfloat16) ** 2)

    _assert_grads_close(jax.grad(loss_got, argnums=(0, 1, 2))(gru, h, a),
                        jax.grad(loss_ref, argnums=(0, 1, 2))(gru, h, a))


@pytest.mark.parametrize("n", [128, 384, 768])
def test_gru_aligned_sizes(setup, n):
    """N % 128 == 0 at several sizes (the sharded halo path's shard
    sizes): forward AND grad parity with the plain cell."""
    gru, h, a = setup
    h, a = h[:n], a[:n]
    got = gru_update(gru, h, a, matmul_dtype=jnp.bfloat16)
    ref = _plain("bfloat16", gru, h, a)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)

    def loss_ref(gru):
        return jnp.sum(_plain("bfloat16", gru, h, a) ** 2)

    def loss_got(gru):
        return jnp.sum(gru_update(gru, h, a, matmul_dtype=jnp.bfloat16) ** 2)

    _assert_grads_close(jax.grad(loss_got)(gru), jax.grad(loss_ref)(gru))


def test_gru_unaligned_n(setup):
    """N not a multiple of 128 runs the same cell — same answer."""
    gru, h, a = setup
    h, a = h[:200], a[:200]
    got = gru_update(gru, h, a, matmul_dtype=jnp.bfloat16)
    w_a, b_all, u_zr = fuse_gru(gru)
    ref = _gru_core("bfloat16", w_a, b_all, u_zr, gru["uh"], h, a)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(_plain("bfloat16", gru, h, a)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [256, 1024])
def test_gru_bf16_vs_f32_reference(setup, n):
    """The bf16-matmul cell at N % 128 == 0, D = 128 tracks the full-f32
    cell within bf16 noise (mean |Δ| < 5e-3, max |Δ| < 5e-2)."""
    gru, h, a = setup
    h, a = h[:n], a[:n]
    ref = gru_update(gru, h, a)
    got = gru_update(gru, h, a, matmul_dtype=jnp.bfloat16)
    err = jnp.abs(got - ref)
    assert float(jnp.mean(err)) < 5e-3
    assert float(jnp.max(err)) < 5e-2
