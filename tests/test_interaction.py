"""Interaction-op oracle tests: every optimized implementation is checked —
forward AND backward — against the obvious reference over randomized sizes
(the reference's dual-implementation pattern, test/model/interact.jl)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dlrm_tpu.ops import interaction_triton
from dlrm_tpu.ops.interaction import (dot_interaction,
                                      dot_interaction_pairwise,
                                      stack_features, tril_flat_indices)


def fused_interpret(x, feats, pad_to=1):
    """The GPU kernel run by the Pallas interpreter (no card here)."""
    return interaction_triton.fused_dot_interaction(x, feats, pad_to,
                                                    interpret=True)


def _oracle(x, feats, pad_to=1):
    """Obvious O(F^2 D) reference: explicit loops over pairs."""
    x = np.asarray(x)
    t = np.asarray(stack_features(jnp.asarray(x), jnp.asarray(feats)))
    b, f, d = t.shape
    pairs = []
    for i in range(1, f):
        for j in range(i):
            pairs.append(np.sum(t[:, i, :] * t[:, j, :], axis=-1))
    out = np.concatenate([x, np.stack(pairs, axis=1)], axis=1)
    width = out.shape[1]
    padded = pad_to * ((width + pad_to - 1) // pad_to)
    if padded != width:
        out = np.pad(out, ((0, 0), (0, padded - width)))
    return out


IMPLS = {
    "gram": dot_interaction,
    "pairwise": dot_interaction_pairwise,
}


def test_tril_order():
    # DLRM pair order: (1,0), (2,0), (2,1), (3,0), ...
    idx = tril_flat_indices(4)
    expected = [1 * 4 + 0, 2 * 4 + 0, 2 * 4 + 1, 3 * 4 + 0, 3 * 4 + 1,
                3 * 4 + 2]
    np.testing.assert_array_equal(idx, expected)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("shape", [
    (16, 4, 8, 1),     # b, tables, d, pad_to
    (32, 7, 16, 1),
    (8, 26, 16, 1),
    (16, 3, 8, 128),   # padded output width
])
def test_forward_matches_oracle(impl, shape, rng):
    b, t, d, pad_to = shape
    x = rng.normal(size=(b, d)).astype(np.float32)
    feats = rng.normal(size=(b, t, d)).astype(np.float32)
    got = IMPLS[impl](jnp.asarray(x), jnp.asarray(feats), pad_to)
    np.testing.assert_allclose(np.asarray(got), _oracle(x, feats, pad_to),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("pad_to", [1, 64])
def test_backward_matches_oracle(impl, pad_to, rng):
    """Pullback parity: compare VJPs against the gram implementation's
    autodiff (itself verified against finite differences below)."""
    b, t, d = 16, 5, 8
    x = rng.normal(size=(b, d)).astype(np.float32)
    feats = rng.normal(size=(b, t, d)).astype(np.float32)
    cot = rng.normal(
        size=np.asarray(_oracle(x, feats, pad_to)).shape).astype(np.float32)

    def run(fn):
        _, vjp = jax.vjp(lambda a, f: fn(a, f, pad_to), jnp.asarray(x),
                         jnp.asarray(feats))
        return vjp(jnp.asarray(cot))

    ref_dx, ref_df = run(dot_interaction)
    got_dx, got_df = run(IMPLS[impl])
    np.testing.assert_allclose(np.asarray(got_dx), np.asarray(ref_dx),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_df), np.asarray(ref_df),
                               atol=1e-4, rtol=1e-4)


def test_gram_grad_matches_finite_differences(rng):
    b, t, d = 4, 3, 4
    x = rng.normal(size=(b, d)).astype(np.float64)
    feats = rng.normal(size=(b, t, d)).astype(np.float64)

    def scalar_loss(xv, fv):
        out = dot_interaction(xv, fv, 1)
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(out.shape)))

    gx, gf = jax.grad(scalar_loss, argnums=(0, 1))(jnp.asarray(x,
                                                               jnp.float32),
                                                   jnp.asarray(feats,
                                                               jnp.float32))
    eps = 1e-3
    for _ in range(5):
        i = tuple(rng.integers(0, s) for s in x.shape)
        xp = x.copy(); xp[i] += eps
        xm = x.copy(); xm[i] -= eps
        fd = (float(scalar_loss(jnp.asarray(xp, jnp.float32),
                                jnp.asarray(feats, jnp.float32)))
              - float(scalar_loss(jnp.asarray(xm, jnp.float32),
                                  jnp.asarray(feats, jnp.float32)))) / (
                                      2 * eps)
        np.testing.assert_allclose(float(gx[i]), fd, atol=1e-2, rtol=1e-2)


# -- the fused GPU kernel (ops/interaction_triton.py), interpret mode ------
# Its width must be a power of two >= 16, so it has its own shapes: the
# Kaggle widths (26 tables, D=16 and D=128) and small odd cases.

FUSED_SHAPES = [
    (4, 26, 16, 1),    # Kaggle fs=16: F=27, D=16
    (2, 26, 128, 1),   # Kaggle fs=128: F=27, D=128
    (5, 3, 16, 1),
    (3, 7, 32, 64),    # padded output width
]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_forward_matches_oracle(shape, rng):
    b, t, d, pad_to = shape
    x = rng.normal(size=(b, d)).astype(np.float32)
    feats = rng.normal(size=(b, t, d)).astype(np.float32)
    got = fused_interpret(jnp.asarray(x), jnp.asarray(feats), pad_to)
    np.testing.assert_allclose(np.asarray(got), _oracle(x, feats, pad_to),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_backward_matches_gram(shape, rng):
    b, t, d, pad_to = shape
    x = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    feats = jnp.asarray(rng.normal(size=(b, t, d)).astype(np.float32))
    cot = jnp.asarray(rng.normal(
        size=dot_interaction(x, feats, pad_to).shape).astype(np.float32))

    def vjp(fn):
        return jax.vjp(lambda a, f: fn(a, f, pad_to), x, feats)[1](cot)

    for got, want in zip(vjp(fused_interpret), vjp(dot_interaction)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("batch", [1, 7, 13])  # one program per example
def test_fused_odd_batches(batch, rng):
    x = rng.normal(size=(batch, 16)).astype(np.float32)
    feats = rng.normal(size=(batch, 3, 16)).astype(np.float32)
    got = fused_interpret(jnp.asarray(x), jnp.asarray(feats))
    np.testing.assert_allclose(np.asarray(got), _oracle(x, feats, 1),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("f,d,ok", [
    (27, 16, True), (27, 128, True), (64, 16, True),
    (27, 8, False),    # below the smallest Triton dot tile
    (27, 24, False),   # not a power of two
    (65, 16, False),   # too many rows for one register tile
])
def test_fused_supported_shapes(f, d, ok):
    assert interaction_triton.supported(f, d) is ok


def test_fused_refuses_unsupported_width():
    x = jnp.zeros((2, 8), jnp.float32)
    with pytest.raises(ValueError, match="power-of-two D"):
        fused_interpret(x, jnp.zeros((2, 3, 8), jnp.float32))


def test_fused_byte_floor_at_kaggle_fs128():
    """The least traffic a fused kernel moves at Kaggle fs=128, B=32768:
    T = 453 MB, output 63 MB; forward T + out, backward 2T + out."""
    mb = interaction_triton.min_bytes(32768, 27, 128)
    t, out = 32768 * 27 * 128 * 4, 32768 * (128 + 351) * 4
    assert mb == {"forward": t + out, "backward": 2 * t + out,
                  "total": 3 * t + 2 * out}
    assert round(mb["total"] / 1e9, 2) == 1.48
