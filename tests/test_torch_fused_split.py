"""Kernel 6's short-item-axis decompositions (``csrc/eig_refresh_compute.cu``):
its scoring launch's class-chunk split and its row launch's model-chunk
split. On the CPU: the plain version against the reference's Pallas kernel
at a short item axis and a wide C, the wrapper's ``class_chunks`` and
``row_split`` checked and then not read (the plain version runs at every
count), and the two rules at the shapes the port runs. On the card (marked
``gpu``, skipped here): every decomposition bitwise the single path.

The reference runs as its own tests run it: the Pallas entry in interpret
mode, with JAX imported inside that test, so on a machine without JAX the
card tests run with ``python -m pytest tests/test_torch_fused_split.py -m
gpu --noconftest``.

Tolerances, as in ``tests/test_torch_fused.py`` (each the reference's own
for the comparison, ``tests/test_pallas_eig.py:408-411``): scores rtol
1e-3, atol 2e-5; the refreshed fp32 row rtol 2e-5, atol 2e-6; a bf16 row
one bf16 ulp at most, and only where the two fp32 rows it was rounded from
straddle a rounding boundary; the other rows bitwise. On the card every
path is ``torch.equal`` to the single one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from coda_tpu_torch.ops import eig_kernels as ek

H100_SMS = 132
FLAVOURS = [("float32", False), ("float32", True), ("bfloat16", False),
            ("bfloat16", True)]
# a short item axis at a wide C: 24 items, 64 classes, 40 models
N, C, H, CLS = 24, 64, 40, 5


def _inputs(seed, n, c_count, h, c):
    """numpy inputs of kernel 6 from a seed: the labelled class's Beta
    marginals (of 10-entry Dirichlet rows, as at the headline), hard
    predictions, and a cache, pi-hat and P(best) rows with row ``c``
    already refreshed."""
    from coda_tpu_torch.ops.pbest import compute_pbest

    rng = np.random.default_rng(seed)
    d = (rng.uniform(0, 1, (h, 10)) * 3 + 0.5).astype(np.float32)
    a_t = d[:, 0].copy()
    b_t = (d.sum(-1) - a_t).astype(np.float32)

    def simplex(*shape):
        x = rng.uniform(0.1, 1.1, size=shape).astype(np.float32)
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)

    rows = simplex(c_count, h)
    rows[c] = compute_pbest(torch.from_numpy(a_t),
                            torch.from_numpy(b_t)).numpy()
    pi_xi = simplex(n, c_count)
    pi = pi_xi.mean(0)
    return dict(rows=rows, hyp=simplex(c_count, n, h), a_t=a_t, b_t=b_t,
                hard=rng.integers(0, c_count, (n, h)).astype(np.int32),
                pi=(pi / pi.sum()).astype(np.float32), pi_xi=pi_xi)


def _torch(inp, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in inp.items()}


def _call(t, dtype, approx, cls, plain=False, **kw):
    """Kernel 6's wrapper (or its plain version) on a fresh copy of the
    cache at ``dtype``: ``(scores, cache)``."""
    hyp = t["hyp"].to(getattr(torch, dtype))
    fn = (ek.eig_scores_refresh_compute_plain if plain
          else ek.eig_scores_refresh_compute)
    return fn(t["rows"], hyp, t["a_t"], t["b_t"], t["hard"],
              torch.tensor(cls, dtype=torch.int32, device=hyp.device),
              t["pi"], t["pi_xi"], approx=approx, **kw)


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


# -- the plain version against the reference at a short item axis -------------

@pytest.mark.parametrize("dtype,approx", FLAVOURS)
def test_plain_matches_pallas_at_a_short_item_axis(dtype, approx):
    """At (N, C, H) = (24, 64, 40) the plain version's scores and refreshed
    row agree with the Pallas kernel (interpret mode) at the stated
    tolerances, and every other row is bitwise untouched."""
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_eig import eig_scores_refresh_compute_pallas

    inp = _inputs(21, N, C, H, CLS)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    s_ref, h_ref = eig_scores_refresh_compute_pallas(
        j["rows"], j["hyp"].astype(dtype), j["a_t"], j["b_t"], j["hard"],
        jnp.int32(CLS), j["pi"], j["pi_xi"], block=8, interpret=True,
        approx=approx)
    scores, hyp = _call(_torch(inp), dtype, approx, CLS)
    np.testing.assert_allclose(scores.numpy(), np.asarray(s_ref),
                               rtol=1e-3, atol=2e-5)
    others = [i for i in range(C) if i != CLS]
    if dtype == "float32":
        got, want = hyp.numpy(), np.asarray(h_ref)
        np.testing.assert_allclose(got[CLS], want[CLS], rtol=2e-5, atol=2e-6)
        np.testing.assert_array_equal(got[others], inp["hyp"][others])
        np.testing.assert_array_equal(want[others], inp["hyp"][others])
        return
    got_bits, want_bits = _bf16_bits(hyp), _bf16_bits(h_ref)
    np.testing.assert_array_equal(got_bits[others], want_bits[others])
    # the fp32 rows each side rounded from, for the boundary rule
    _, hyp32 = _call(_torch(inp), "float32", approx, CLS)
    _, ref32 = eig_scores_refresh_compute_pallas(
        j["rows"], j["hyp"], j["a_t"], j["b_t"], j["hard"], jnp.int32(CLS),
        j["pi"], j["pi_xi"], block=8, interpret=True, approx=approx)
    differ = got_bits[CLS] != want_bits[CLS]
    straddle = (_bf16_bits(hyp32[CLS].to(torch.bfloat16))
                != _bf16_bits(torch.from_numpy(np.array(ref32)[CLS])
                              .to(torch.bfloat16)))
    assert not (differ & ~straddle).any(), "bf16 row differs off a boundary"
    gap = np.abs(got_bits[CLS].astype(np.int32)
                 - want_bits[CLS].astype(np.int32))
    assert (gap[differ] == 1).all(), "bf16 row differs by more than one ulp"


# -- the wrapper's knobs on the CPU -------------------------------------------

@pytest.mark.parametrize("k", [0, -1, C + 1, 70_000, 2.0, "3"])
def test_a_count_outside_the_classes_is_refused(k):
    """A forced ``class_chunks`` outside ``[1, min(C, 65535)]``, or not an
    int, is refused on the CPU too, before the plain version runs."""
    t = _torch(_inputs(4, N, C, H, CLS))
    before = dict(ek.launch_counts)
    with pytest.raises(ValueError, match="class_chunks"):
        _call(t, "float32", False, CLS, class_chunks=k)
    assert ek.launch_counts == before


@pytest.mark.parametrize("rs", [1, 0, "on"])
def test_a_row_split_that_is_not_a_bool_is_refused(rs):
    t = _torch(_inputs(4, N, C, H, CLS))
    with pytest.raises(ValueError, match="row_split"):
        _call(t, "float32", False, CLS, row_split=rs)


@pytest.mark.parametrize("k,rs", [(None, None), (1, False), (1, True),
                                  (3, None), (C, True), (64, False)])
def test_cpu_takes_the_plain_version_at_any_count(k, rs):
    """On the CPU the wrapper is its plain version, bitwise, whatever
    ``class_chunks`` and ``row_split`` say, and counts no launch."""
    t = _torch(_inputs(9, N, C, H, CLS))
    before = (dict(ek.launch_counts), dict(ek.split_counts))
    want, hyp_p = _call(t, "float32", False, CLS, plain=True)
    got, hyp_k = _call(t, "float32", False, CLS, class_chunks=k,
                       row_split=rs)
    assert torch.equal(got, want) and torch.equal(hyp_k, hyp_p)
    assert (ek.launch_counts, ek.split_counts) == before


# -- the rules ----------------------------------------------------------------

@pytest.mark.parametrize("C_,N_,H_,approx,chunks,rows", [
    # the imagenet_sparse pool and a data=2 rank's block: both launches
    # split (4 x 4 and 2 x 4 row blocks)
    (1000, 256, 500, False, 1000, True),
    (1000, 256, 500, True, 250, True),
    (1000, 128, 500, False, 1000, True),
    # DomainNet126's classes at a small domain's N = 2048 (32 x 4 blocks)
    (126, 2048, 500, False, 126, True),
    # the headline: both launches as they are (391 tiles x 8 chunks take
    # 24 rounds of 132 blocks, as 8 chunks of 3 tiles a block do); a
    # data=2 rank's block: the row launch splits (196 x 8 in 12 rounds
    # against 16)
    (10, 50_000, 1000, False, 1, False),
    (10, 50_000, 1000, True, 1, False),
    (10, 25_000, 1000, False, 1, True),
    # the headline's widths at short item axes: the scoring launch splits
    # below 32 items an SM, the row launch wherever its 8 model chunks
    # take fewer rounds split (16, 32, 64 tiles: 1, 2, 4 rounds against 8)
    (10, 2048, 1000, False, 10, True),
    (10, 4096, 1000, False, 10, True),
    (10, 8192, 1000, False, 1, True),
    # one model chunk: nothing to split over the grid
    (1000, 256, 128, False, 1000, False),
    # digits_h80: a warp's walk over its 10 classes is short
    (10, 899, 80, False, 1, False),
])
def test_rules_pick_the_decompositions(C_, N_, H_, approx, chunks, rows):
    """Kernel 6's scoring launch takes kernels 1 and 2's class-chunk rule
    unchanged; its row launch splits where H spans more than one model
    chunk and its (128-item tile, chunk) work items, at 1.2 times a round,
    take fewer rounds of one block an SM than the single path's tiles."""
    assert ek.choose_class_chunks(C_, N_, H_, approx, H100_SMS) == chunks
    assert ek.choose_row_split(N_, H_, H100_SMS) is rows


def test_row_rule_is_one_wave_of_the_split_blocks():
    """The persistent row grid (132 blocks, one an SM): 99 tiles of 128
    items x 4 model chunks (H = 500) take 3 rounds split, 3 x 1.2 < 4
    single; a 100th tile takes a 4th round, no faster than the single
    path's 4 chunks of one tile a block."""
    full = 99 * 2 * ek.ROW_ITEMS
    assert ek.ROW_BLOCKS_PER_SM == 1
    assert ek.choose_row_split(full, 500, H100_SMS)
    assert not ek.choose_row_split(full + 1, 500, H100_SMS)  # a 100th tile
    assert not ek.choose_row_split(64, ek.ROW_MODELS, H100_SMS)
    assert ek.choose_row_split(64, ek.ROW_MODELS + 1, H100_SMS)
    # a card that holds two blocks an SM takes twice the tiles a round
    assert ek.choose_row_split(2 * full, 500, H100_SMS, 2)
    assert not ek.choose_row_split(2 * full + 1, 500, H100_SMS, 2)
    # tiles of one warpgroup's 64 items count twice the work items
    assert not ek.choose_row_split(full + 1, 500, H100_SMS, 2,
                                   ek.ROW_ITEMS)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,approx", FLAVOURS)
@pytest.mark.parametrize("n,c_count,h", [(301, 37, 264), (130, 9, 37)])
def test_every_path_is_bitwise_the_single_path_on_card(cuda, dtype, approx,
                                                       n, c_count, h):
    """Every class chunk count, with the row split on and off, gives the
    single path's scores and cache bitwise, on the 16-byte path (H = 264,
    three model chunks) and the scalar one (H = 37); an out-of-range
    class gives NaN scores and writes nothing on every path. The single
    path holds to the plain version. One launch is counted a call, and a
    split one as split."""
    cls = c_count // 2
    t = _torch(_inputs(n + c_count, n, c_count, h, cls), cuda)
    name = ek.flavour("eig_refresh_compute_score", getattr(torch, dtype),
                      approx)
    one, hyp1 = _call(t, dtype, approx, cls, class_chunks=1,
                      row_split=False)
    want, _ = _call(t, dtype, approx, cls, plain=True)
    torch.testing.assert_close(one, want, rtol=1e-3, atol=2e-5)
    hyp0 = t["hyp"].to(getattr(torch, dtype))
    for k in sorted({1, 2, 3, c_count // 2, c_count}):
        for rs in (False, True):
            before = (ek.launch_counts.get(name, 0),
                      ek.split_counts.get(name, 0))
            got, hyp_k = _call(t, dtype, approx, cls, class_chunks=k,
                               row_split=rs)
            assert torch.equal(got, one) and torch.equal(hyp_k, hyp1), \
                (k, rs)
            bad, hyp_b = _call(t, dtype, approx, c_count, class_chunks=k,
                               row_split=rs)
            assert bad.isnan().all() and torch.equal(hyp_b, hyp0), (k, rs)
            split = k > 1 or rs
            assert (ek.launch_counts[name], ek.split_counts.get(name, 0)) \
                == (before[0] + 2, before[1] + 2 * split)
