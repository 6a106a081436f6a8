"""Kernels 1 and 2's class-chunk split (``csrc/eig_score.cu``): the rule
that picks the chunk count, the chunks it cuts, the CPU dispatch, and on
the card the split path bitwise the single launch.

The rule is a pure function of the shape, the entropy flavour and the
card's SM count (132 on an H100), so it is held here on the CPU at the
shapes the port runs: the headline ``(10, 50000, 1000)``, a data=2 rank's block of it
and the headline's widths at N = 8192 keep the single launch; the
imagenet_sparse pool ``(1000, 256, 500)``, its ranks' blocks and
DomainNet126's class count at a small domain's N = 2048 split; the small
tasks of ``data/`` do not. The card
tests (marked ``gpu``) skip here; on the card they run with
``python -m pytest tests/test_torch_score_split.py -m gpu --noconftest``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from coda_tpu_torch.ops import eig_kernels as ek

H100_SMS = 132
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("C,N,H,approx,want", [
    # the headline and a data=2 rank's block
    (10, 50_000, 1000, False, 1),
    (10, 50_000, 1000, True, 1),
    (10, 25_000, 1000, False, 1),
    (10, 25_000, 1000, True, 1),
    # model=2 and model=4 blocks of the headline
    (10, 50_000, 500, False, 1),
    (10, 50_000, 250, True, 1),
    # the imagenet_sparse pool, a model=2 and a data=2 rank's block: one
    # class a chunk (exact), four (approx)
    (1000, 256, 500, False, 1000),
    (1000, 256, 500, True, 250),
    (1000, 256, 250, False, 1000),
    (1000, 128, 500, True, 250),
    # DomainNet126's classes at N = 2048
    (126, 2048, 500, False, 126),
    (126, 2048, 500, True, 32),
    # the headline's widths at N = 8192: the single launch already holds
    # enough rows in flight, and no chunk count measured faster
    (10, 8192, 1000, False, 1),
    (10, 8192, 1000, True, 1),
    # digits_h80, digits, iris: a warp's walk over the classes is short
    (10, 899, 80, False, 1),
    (10, 899, 14, True, 1),
    (3, 105, 14, False, 1),
])
def test_rule_picks_the_chunks(C, N, H, approx, want):
    got = ek.choose_class_chunks(C, N, H, approx, H100_SMS)
    assert got == want
    # the count is the kernel's own: as many chunks as it cuts
    assert len(ek.chunk_bounds(C, got)) == got
    if got > 1:
        assert N < ek.SPLIT_ITEMS_PER_SM * H100_SMS
        assert C * H >= ek.SPLIT_MIN_CLASS_VALUES
        # four rows a warp: one class of four items, or four of one
        per = ek.chunk_bounds(C, got)[0][1]
        assert per == (ek.EXACT_ROWS if approx else 1)


@pytest.mark.parametrize("C", [1, 2, 3, 10, 126, 1000, 1001])
def test_chunks_cover_the_classes_in_order(C):
    for k in sorted({1, 2, 3, 7, 16, 63, C} & set(range(1, C + 1))):
        bounds = ek.chunk_bounds(C, k)
        assert bounds[0][0] == 0 and bounds[-1][1] == C
        assert all(a < b for a, b in bounds)
        assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
        assert len(bounds) <= k
    for sms in (1, 66, 132, 1000):
        for N in (1, 31, 256, 4096, 1 << 20):
            for approx in (False, True):
                k = ek.choose_class_chunks(C, N, 500, approx, sms)
                assert 1 <= k <= C and len(ek.chunk_bounds(C, k)) == k


def test_cpu_takes_the_plain_versions_at_any_chunk_count():
    """On the CPU ``class_chunks`` is not read: the wrappers take the plain
    versions, and no launch is counted on either path."""
    rng = np.random.default_rng(5)

    def simplex(*shape):
        x = rng.uniform(0.1, 1.1, size=shape).astype(np.float32)
        return torch.from_numpy(x / x.sum(-1, keepdims=True))

    C, N, H = 6, 40, 12
    rows, hyp, pi_xi, hyp_t = (simplex(C, H), simplex(C, N, H),
                               simplex(N, C), simplex(N, H))
    pi = pi_xi.mean(0)
    before = (dict(ek.launch_counts), dict(ek.split_counts))
    want = ek.eig_scores_from_cache(rows, hyp, pi, pi_xi)
    for k in (None, 1, 3):
        assert torch.equal(ek.eig_scores_cache(rows, hyp, pi, pi_xi,
                                               class_chunks=k), want)
    c = torch.tensor(2)
    want2, hyp_p = ek.eig_scores_refresh_plain(rows, hyp.clone(), hyp_t, c,
                                               pi, pi_xi)
    got2, hyp_k = ek.eig_scores_refresh(rows, hyp.clone(), hyp_t, c, pi,
                                        pi_xi, class_chunks=3)
    assert torch.equal(got2, want2) and torch.equal(hyp_k, hyp_p)
    assert (ek.launch_counts, ek.split_counts) == before


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("C,N,H", [(37, 301, 64), (9, 130, 37)])
def test_split_is_bitwise_the_single_launch_on_card(cuda, dtype, approx, C,
                                                    N, H):
    """At a small shape, every forced chunk count gives the single launch's
    scores and (kernel 2) cache bitwise, on the 16-byte path (H = 64) and
    the scalar one (H = 37); an out-of-range class gives NaN scores and
    leaves the cache untouched on both paths. One launch is counted a
    call, whichever path ran."""
    gen = torch.Generator(device=cuda).manual_seed(C + N)

    def simplex(*shape):
        x = torch.rand(shape, generator=gen, device=cuda) + 0.1
        return x / x.sum(-1, keepdim=True)

    rows, pi_xi, hyp_t = simplex(C, H), simplex(N, C), simplex(N, H)
    hyp = simplex(C, N, H).to(dtype)
    pi = pi_xi.mean(0)
    name1 = ek.flavour("eig_score", dtype, approx)
    name2 = ek.flavour("eig_refresh_score", dtype, approx)
    one = ek.eig_scores_cache(rows, hyp, pi, pi_xi, approx=approx,
                              class_chunks=1)
    c = torch.tensor(C // 2, dtype=torch.int32, device=cuda)
    one2, hyp1 = ek.eig_scores_refresh(rows, hyp.clone(), hyp_t, c, pi,
                                       pi_xi, approx=approx, class_chunks=1)
    tol = dict(rtol=1e-4, atol=4 * H ** 0.5 * 2.0 ** -24 * np.log2(H))
    torch.testing.assert_close(one, ek.eig_scores_from_cache(
        rows, hyp, pi, pi_xi, approx=approx), **tol)
    bad = torch.tensor(C, dtype=torch.int32, device=cuda)
    for k in (2, 3, C // 2, C):
        n1, s1 = ek.launch_counts.get(name1, 0), ek.split_counts.get(name1,
                                                                     0)
        got = ek.eig_scores_cache(rows, hyp, pi, pi_xi, approx=approx,
                                  class_chunks=k)
        got2, hyp_k = ek.eig_scores_refresh(rows, hyp.clone(), hyp_t, c, pi,
                                            pi_xi, approx=approx,
                                            class_chunks=k)
        torch.cuda.synchronize()
        assert torch.equal(got, one), k
        assert torch.equal(got2, one2) and torch.equal(hyp_k, hyp1), k
        assert ek.launch_counts[name1] == n1 + 1
        assert ek.split_counts[name1] == s1 + 1
        untouched = hyp.clone()
        nan, _ = ek.eig_scores_refresh(rows, untouched, hyp_t, bad, pi,
                                       pi_xi, approx=approx, class_chunks=k)
        assert torch.isnan(nan).all() and torch.equal(untouched, hyp)
    assert ek.split_counts[name2] >= 8
