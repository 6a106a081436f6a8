"""Kernels 4 and 5's class-chunk split (``csrc/eig_score.cu``): the rule
that picks the chunk count for S replicas, the CPU dispatch of the batched
wrappers, the wrappers with a forced count against the reference's batched
Pallas kernels, and on the card the split bitwise the single batched
launch and kernels 1 and 2 per replica.

The rule is a pure function of the shape, the replica count, the entropy
flavour and the card's SM count (132 on an H100), so it is held here on
the CPU: at one replica it is kernels 1 and 2's rule at every shape of
``tests/test_torch_score_split.py``; five replicas of the imagenet_sparse
pool ``(1000, 256, 500)`` split, five of the headline do not, and no
batch whose S x N reaches 32 items an SM does. The reference comparison
runs the JAX side as its own tests run it (interpret mode), with JAX
imported inside that test, so on a machine without JAX the card test runs
with ``python -m pytest tests/test_torch_batched_split.py -m gpu
--noconftest``.

Tolerances: scores rtol 1e-4 (the reference's own,
``tests/test_pallas_eig.py:298,312``, as in ``tests/test_torch_batched.py``)
and atol ``4 * sqrt(H) * 2^-24 * log2(H)`` (``chip_smoke.score_atol``):
the reference's atol 1e-6 was set at H = 10, and at this file's H = 64
each score is a difference of 6-bit entropies, each a sum of 64 fp32 terms
that two summation orders round about sqrt(H) ulps apart (1.9e-6 seen);
the refreshed cache bitwise; on the card every decomposition
``torch.equal``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from coda_tpu_torch.ops import eig_kernels as ek

H100_SMS = 132
F32, BF16 = torch.float32, torch.bfloat16
FLAVOURS = [("float32", False), ("float32", True), ("bfloat16", False),
            ("bfloat16", True)]


def score_tol(H: int) -> dict:
    return dict(rtol=1e-4, atol=4 * H ** 0.5 * 2.0 ** -24 * np.log2(H))


# the rows in flight at which the single launch fills the H100
FULL = ek.SPLIT_ITEMS_PER_SM * H100_SMS


# kernels 1 and 2's cases (tests/test_torch_score_split.py), with PR 19's
# chunk counts
@pytest.mark.parametrize("C,N,H,approx,want", [
    (10, 50_000, 1000, False, 1), (10, 50_000, 1000, True, 1),
    (10, 25_000, 1000, False, 1), (10, 25_000, 1000, True, 1),
    (10, 50_000, 500, False, 1), (10, 50_000, 250, True, 1),
    (1000, 256, 500, False, 1000), (1000, 256, 500, True, 250),
    (1000, 256, 250, False, 1000), (1000, 128, 500, True, 250),
    (126, 2048, 500, False, 126), (126, 2048, 500, True, 32),
    (10, 8192, 1000, False, 1), (10, 8192, 1000, True, 1),
    (10, 899, 80, False, 1), (10, 899, 14, True, 1), (3, 105, 14, False, 1),
])
def test_one_replica_is_kernels_1_and_2s_rule(C, N, H, approx, want):
    assert ek.choose_class_chunks(C, N, H, approx, H100_SMS, S=1) == want
    assert ek.choose_class_chunks(C, N, H, approx, H100_SMS) == want


@pytest.mark.parametrize("C,N,H,approx,want", [
    # five seeds on the imagenet_sparse pool, and its ranks' blocks: one
    # class a chunk (exact), four (approx), as at one replica
    (1000, 256, 500, False, 1000), (1000, 256, 500, True, 250),
    (1000, 256, 250, False, 1000), (1000, 128, 500, True, 250),
    # five seeds at the headline and at the smoke's ragged N
    (10, 50_000, 1000, False, 1), (10, 50_000, 1000, True, 1),
    (10, 50_001, 1000, False, 1),
    # DomainNet126's classes at N = 2048: 10,240 rows in flight already
    (126, 2048, 500, False, 1), (126, 2048, 500, True, 1),
    # digits_h80: a warp's walk over the classes is short
    (10, 899, 80, False, 1),
])
def test_five_replicas(C, N, H, approx, want):
    got = ek.choose_class_chunks(C, N, H, approx, H100_SMS, S=5)
    assert got == want
    assert len(ek.chunk_bounds(C, got)) == got
    if got > 1:
        per = ek.chunk_bounds(C, got)[0][1]
        assert per == (ek.EXACT_ROWS if approx else 1)


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 16, 64])
@pytest.mark.parametrize("approx", [False, True])
def test_rows_in_flight_decide(S, approx):
    """At S x N at or above 32 items an SM the single launch stays; one
    item fewer a replica splits (at a class width that splits)."""
    C, H = 1000, 500
    at = -(-FULL // S)               # the fewest items a replica that fill
    assert ek.choose_class_chunks(C, at, H, approx, H100_SMS, S=S) == 1
    assert ek.choose_class_chunks(C, 4 * at, H, approx, H100_SMS, S=S) == 1
    below = at - 1
    if below >= 1:
        assert S * below < FULL
        assert ek.choose_class_chunks(C, below, H, approx, H100_SMS,
                                      S=S) > 1
    # a narrow class width keeps the single launch at any S
    assert ek.choose_class_chunks(10, 1, 80, approx, H100_SMS, S=S) == 1


# -- the CPU path -----------------------------------------------------------

def _simplex(rng, *shape):
    x = rng.uniform(0.1, 1.1, size=shape).astype(np.float32)
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _batched_cache(seed, S, C, N, H):
    """numpy (rows, hyp, pi, pi_xi, hyp_t, cls) with a leading replica axis
    S, from a seed; every replica gets its own values and class."""
    rng = np.random.default_rng(seed)
    rows, hyp = _simplex(rng, S, C, H), _simplex(rng, S, C, N, H)
    pi_xi, hyp_t = _simplex(rng, S, N, C), _simplex(rng, S, N, H)
    pi = pi_xi.mean(1)
    pi = (pi / pi.sum(-1, keepdims=True)).astype(np.float32)
    cls = (np.arange(S, dtype=np.int32) * 3 + 1) % C
    return rows, hyp, pi, pi_xi, hyp_t, cls


def _bits(x) -> np.ndarray:
    """A cache as comparable bits: its int16 (bf16) or int32 view."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == BF16 else torch.int32).numpy()
    return np.asarray(x).view(np.int16 if x.dtype.itemsize == 2
                              else np.int32)


@pytest.mark.parametrize("k", [None, 1, 2, 5, 6])
def test_cpu_takes_the_plain_versions_at_any_chunk_count(k):
    """On the CPU a valid ``class_chunks`` goes no further than its
    check: the batched wrappers take the plain versions, and no launch is
    counted on either path."""
    S, C, N, H = 3, 6, 40, 12
    rows, hyp, pi, pi_xi, hyp_t, cls = (torch.from_numpy(a) for a in
                                        _batched_cache(7, S, C, N, H))
    before = (dict(ek.launch_counts), dict(ek.split_counts))
    want = ek.eig_scores_from_cache_batched(rows, hyp, pi, pi_xi)
    assert torch.equal(ek.eig_scores_cache_batched(
        rows, hyp, pi, pi_xi, class_chunks=k), want)
    want2, hyp_p = ek.eig_scores_refresh_batched_plain(
        rows, hyp.clone(), hyp_t, cls, pi, pi_xi)
    got2, hyp_k = ek.eig_scores_refresh_batched(
        rows, hyp.clone(), hyp_t, cls, pi, pi_xi, class_chunks=k)
    assert torch.equal(got2, want2) and torch.equal(hyp_k, hyp_p)
    assert (ek.launch_counts, ek.split_counts) == before


@pytest.mark.parametrize("k", [0, -1, 7, 65536, 2.0, "3"])
def test_a_count_outside_the_classes_is_refused(k):
    """A forced count must be an int in [1, min(C, 65535)] (C = 6 here),
    on the CPU too, for kernels 4 and 5 as for kernels 1 and 2."""
    S, C, N, H = 2, 6, 9, 5
    rows, hyp, pi, pi_xi, hyp_t, cls = (torch.from_numpy(a) for a in
                                        _batched_cache(3, S, C, N, H))
    with pytest.raises(ValueError, match="class_chunks"):
        ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi, class_chunks=k)
    with pytest.raises(ValueError, match="class_chunks"):
        ek.eig_scores_refresh_batched(rows, hyp.clone(), hyp_t, cls, pi,
                                      pi_xi, class_chunks=k)
    with pytest.raises(ValueError, match="class_chunks"):
        ek.eig_scores_cache(rows[0], hyp[0], pi[0], pi_xi[0],
                            class_chunks=k)
    with pytest.raises(ValueError, match="class_chunks"):
        ek.eig_scores_refresh(rows[0], hyp[0].clone(), hyp_t[0], cls[0],
                              pi[0], pi_xi[0], class_chunks=k)


@pytest.mark.parametrize("dtype,approx", FLAVOURS)
def test_forced_split_matches_the_pallas_kernels(dtype, approx):
    """At a short-axis shape (S, C, N, H) = (3, 37, 33, 64), the batched
    wrappers with a forced chunk count against
    eig_scores_cache_pallas_batched and eig_scores_refresh_pallas_batched
    in interpret mode: scores within the reference's tolerance, the
    refreshed cache bitwise, each replica's own class row refreshed."""
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_eig import (
        eig_scores_cache_pallas_batched,
        eig_scores_refresh_pallas_batched,
    )

    S, C, N, H, blk = 3, 37, 33, 64, 16
    rows, hyp, pi, pi_xi, hyp_t, cls = _batched_cache(2024, S, C, N, H)
    j = [jnp.asarray(a) for a in (rows, hyp, pi, pi_xi, hyp_t, cls)]
    jhyp = j[1].astype(dtype)
    t = [torch.from_numpy(a.copy()) for a in (rows, hyp, pi, pi_xi, hyp_t,
                                               cls)]
    tdt = getattr(torch, dtype)
    thyp = t[1].to(tdt)

    ref = np.asarray(eig_scores_cache_pallas_batched(
        j[0], jhyp, j[2], j[3], block=blk, interpret=True, approx=approx))
    got = ek.eig_scores_cache_batched(t[0], thyp, t[2], t[3], chunk=blk,
                                      approx=approx, class_chunks=5)
    assert got.shape == (S, N) and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), ref, **score_tol(H))

    s_ref, h_ref = eig_scores_refresh_pallas_batched(
        j[0], jhyp, j[4], j[5], j[2], j[3], block=blk, interpret=True,
        approx=approx)
    s, h = ek.eig_scores_refresh_batched(t[0], thyp, t[4], t[5], t[2], t[3],
                                         chunk=blk, approx=approx,
                                         class_chunks=C)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref),
                               **score_tol(H))
    assert h is thyp and h.dtype == tdt
    np.testing.assert_array_equal(_bits(h), _bits(h_ref))
    want = hyp.copy()
    want[np.arange(S), cls] = hyp_t
    np.testing.assert_array_equal(_bits(h),
                                  _bits(torch.from_numpy(want).to(tdt)))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("S,C,N,H", [(3, 37, 301, 64), (4, 9, 130, 37)])
def test_split_is_bitwise_the_single_launch_on_card(cuda, dtype, approx, S,
                                                    C, N, H):
    """Every forced chunk count gives the single batched launch's scores
    and (kernel 5) cache bitwise, and so kernels 1 and 2's per replica, on
    the 16-byte path (H = 64) and the scalar one (H = 37). A class out of
    range in one replica gives NaN scores there only and leaves its cache
    untouched; the other replicas stay bitwise. One launch is counted a
    call, and one split launch a split call."""
    gen = torch.Generator(device=cuda).manual_seed(S * C + N)

    def simplex(*shape):
        x = torch.rand(shape, generator=gen, device=cuda) + 0.1
        return x / x.sum(-1, keepdim=True)

    rows, pi_xi, hyp_t = simplex(S, C, H), simplex(S, N, C), simplex(S, N, H)
    hyp = simplex(S, C, N, H).to(dtype)
    pi = pi_xi.mean(1)
    cls = torch.tensor([(2 * s + 1) % C for s in range(S)],
                       dtype=torch.int32, device=cuda)
    name4 = ek.flavour("eig_score_batched", dtype, approx)
    name5 = ek.flavour("eig_refresh_score_batched", dtype, approx)
    one = ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi, approx=approx,
                                      class_chunks=1)
    hyp1 = hyp.clone()
    one5, _ = ek.eig_scores_refresh_batched(rows, hyp1, hyp_t, cls, pi,
                                            pi_xi, approx=approx,
                                            class_chunks=1)
    per = torch.stack([ek.eig_scores_cache(rows[s], hyp[s], pi[s], pi_xi[s],
                                           approx=approx, class_chunks=1)
                       for s in range(S)])
    hyp_q = hyp.clone()
    per5 = torch.stack([ek.eig_scores_refresh(
        rows[s], hyp_q[s], hyp_t[s], cls[s], pi[s], pi_xi[s], approx=approx,
        class_chunks=1)[0] for s in range(S)])
    torch.cuda.synchronize()
    assert torch.equal(one, per) and torch.equal(one5, per5)
    assert torch.equal(hyp1, hyp_q)
    torch.testing.assert_close(one, ek.eig_scores_from_cache_batched(
        rows, hyp, pi, pi_xi, approx=approx), **score_tol(H))
    bad = cls.clone()
    bad[1] = C                        # replica 1's class is out of range
    for k in (2, 3, C // 2, C):
        n4, s4 = ek.launch_counts.get(name4, 0), ek.split_counts.get(name4, 0)
        n5, s5 = ek.launch_counts.get(name5, 0), ek.split_counts.get(name5, 0)
        got = ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi,
                                          approx=approx, class_chunks=k)
        hyp_k = hyp.clone()
        got5, _ = ek.eig_scores_refresh_batched(rows, hyp_k, hyp_t, cls, pi,
                                                pi_xi, approx=approx,
                                                class_chunks=k)
        torch.cuda.synchronize()
        assert torch.equal(got, one), k
        assert torch.equal(got5, one5) and torch.equal(hyp_k, hyp1), k
        assert (ek.launch_counts[name4], ek.split_counts[name4]) == (n4 + 1,
                                                                     s4 + 1)
        assert (ek.launch_counts[name5], ek.split_counts[name5]) == (n5 + 1,
                                                                     s5 + 1)
        hyp_b = hyp.clone()
        nan, _ = ek.eig_scores_refresh_batched(rows, hyp_b, hyp_t, bad, pi,
                                               pi_xi, approx=approx,
                                               class_chunks=k)
        torch.cuda.synchronize()
        assert torch.isnan(nan[1]).all() and torch.equal(hyp_b[1], hyp[1])
        others = [s for s in range(S) if s != 1]
        assert torch.equal(nan[others], one5[others]), k
        assert torch.equal(hyp_b[others], hyp1[others]), k
