"""The port's threefry draws and masked sampling against ``jax.random``
and ``coda_tpu.ops.masked`` on the CPU.

``fold_in``, ``randint`` and the sampled indices of ``categorical`` and
``masked_categorical`` are bitwise equal over seeds 0-63, with ``(S, 2)``
key batches equal to ``jax.vmap`` of the single-key call. The Gumbel
noise is the same uniform bits through ``-log(-log(u))``; the two
packages' ``log`` differ in the last bit, so its values agree within 4 ulp
of ``max(|g|, 1)`` (near g = 0 the value is a difference of two logs
whose absolute error is what an ulp of 1 measures).
``masked_categorical``'s probability agrees at rtol 1e-6: the two packages
sum the weights in different orders.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.ops import masked as tmasked

SEEDS = np.arange(64)
NS = (7, 899, 50_000)
GUMBEL_ULPS = 4


def _jkeys():
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(SEEDS, jnp.uint32))


def _tkeys():
    return torch.stack([trandom.PRNGKey(int(s)) for s in SEEDS])


def _logits(N):
    """64 rows of logits, some entries -inf (masked out)."""
    rng = np.random.default_rng(N)
    x = rng.normal(size=(len(SEEDS), N)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = -np.inf
    x[:, 0] = 0.0                           # every row has a finite entry
    return x


def test_fold_in_bitwise():
    data = [0, 1, 5, 77, 2 ** 31 + 9, 2 ** 32 - 1]
    jk, tk = _jkeys(), _tkeys()
    for d in data:
        want = np.asarray(jax.vmap(
            lambda k: jax.random.fold_in(k, np.uint32(d)))(jk))
        got = trandom.fold_in(tk, d).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        for s in (0, 17, 63):
            np.testing.assert_array_equal(
                trandom.fold_in(tk[s], d).numpy(), want[s])
    # a tensor of data words against one key batch, as fold_in over steps
    steps = torch.arange(len(SEEDS))
    want = np.asarray(jax.vmap(jax.random.fold_in)(
        jk, jnp.asarray(SEEDS, jnp.uint32)))
    np.testing.assert_array_equal(trandom.fold_in(tk, steps).numpy(), want)


@pytest.mark.parametrize("H", [1, 7, 1000, 2 ** 20 + 3])
def test_randint_bitwise(H):
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, H))(_jkeys()))
    tk = _tkeys()
    np.testing.assert_array_equal(trandom.randint(tk, (), 0, H).numpy(),
                                  want)
    got = [int(trandom.randint(tk[s], (), 0, H)) for s in range(len(SEEDS))]
    np.testing.assert_array_equal(got, want)
    assert ((want >= 0) & (want < H)).all()
    # a shaped draw and a non-zero minval
    np.testing.assert_array_equal(
        trandom.randint(tk[3], (5, 2), -4, H).numpy(),
        np.asarray(jax.random.randint(_jkeys()[3], (5, 2), -4, H)))


@pytest.mark.parametrize("N", NS)
def test_gumbel_and_categorical_match_jax(N):
    jk, tk = _jkeys(), _tkeys()
    logits = _logits(N)
    g_want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (N,)))(jk))
    g_got = trandom.gumbel(tk, (N,)).numpy()
    assert np.isfinite(g_got).all()
    scale = np.maximum(np.abs(g_want), 1.0) * np.spacing(np.float32(1.0))
    assert (np.abs(g_got - g_want) <= GUMBEL_ULPS * scale).all()
    want = np.asarray(jax.vmap(jax.random.categorical)(jk,
                                                       jnp.asarray(logits)))
    got = trandom.categorical(tk, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    for s in (0, 31, 63):
        assert int(trandom.categorical(tk[s], torch.from_numpy(
            logits[s]))) == int(want[s])
        np.testing.assert_array_equal(trandom.gumbel(tk[s], (N,)).numpy(),
                                      g_got[s])
    assert np.isfinite(logits[np.arange(len(SEEDS)), want]).all()


@pytest.mark.parametrize("N", NS)
def test_masked_categorical_matches_reference(N):
    from coda_tpu.ops.masked import masked_categorical

    rng = np.random.default_rng(N + 1)
    weights = rng.random((len(SEEDS), N)).astype(np.float32)
    weights[:, ::5] = 0.0
    masks = rng.random((len(SEEDS), N)) < 0.6
    masks[:, 1] = True
    # two degenerate rows: all-zero weights under the mask (uniform
    # fallback) and a single candidate
    weights[1] = 0.0
    masks[2] = False
    masks[2, 4] = True
    idx_w, prob_w = jax.vmap(masked_categorical)(
        _jkeys(), jnp.asarray(weights), jnp.asarray(masks))
    idx_w, prob_w = np.asarray(idx_w), np.asarray(prob_w)
    tk = _tkeys()
    for s in range(len(SEEDS)):
        idx, prob = tmasked.masked_categorical(
            tk[s], torch.from_numpy(weights[s]), torch.from_numpy(masks[s]))
        assert int(idx) == int(idx_w[s]), s
        np.testing.assert_allclose(float(prob), prob_w[s], rtol=1e-6)
    assert masks[np.arange(len(SEEDS)), idx_w].all()
    assert idx_w[2] == 4 and prob_w[2] == 1.0


def test_masked_argmin_tiebreak_matches_reference():
    from coda_tpu.ops.masked import masked_argmin_tiebreak

    rng = np.random.default_rng(5)
    for s in range(16):
        scores = rng.integers(0, 4, size=40).astype(np.float32)
        mask = rng.random(40) < 0.7
        mask[0] = True
        i_w, n_w = masked_argmin_tiebreak(jax.random.PRNGKey(s),
                                          jnp.asarray(scores),
                                          jnp.asarray(mask))
        i_g, n_g = tmasked.masked_argmin_tiebreak(
            trandom.PRNGKey(s), torch.from_numpy(scores),
            torch.from_numpy(mask))
        assert (int(i_g), int(n_g)) == (int(i_w), int(n_w))
