"""Kernel 6's Hopper design (``csrc/eig_refresh_compute.cu``): the tables'
TF32 planes, the 3xTF32 products in the kernel's term order, the row
block's shared-memory layout, and, marked ``gpu``, the kernel on the card.

On the CPU: :func:`ek.split_tf32` / :func:`ek.split_tables` (the plain
versions of the split launch) keep only TF32's bits in the high part and
give x back from hi + lo within 2^-21 relative (2^-136 absolute where the
rest x - hi is subnormal, whose kept bits are fixed-point); the plain emulation
of the row launch (:func:`_row_3xtf32`) holds the JAX
``_refresh_compute_score_kernel`` (Pallas, interpret mode, as the JAX
package's own tests run it) at the reference's row tolerance, rtol 2e-5 and
atol 2e-6 (``tests/test_pallas_eig.py:408-411``); the layout's H limit and
its refusal; the warpgroup rule and the check of a forced count. JAX is imported inside the test that compares with it, so the
card tests run with ``python -m pytest tests/test_torch_fused_wgmma.py -m
gpu --noconftest`` on a machine without JAX.

On the card: the kernel against its plain version in all four flavours
(scores rtol 1e-3, atol 2e-5 + the H-scaled summation term, in bf16 against
the plain scoring of the row the kernel stored; the fp32 row at the
reference's row tolerance; the bf16 row equal but for one-ulp boundary
elements; other rows bitwise untouched), the split launch bitwise
its plain version, and the decompositions (one or two consumer warpgroups,
row split, class chunks) ``torch.equal`` to one another.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from coda_tpu_torch.ops import eig_kernels as ek
from coda_tpu_torch.ops.beta import dirichlet_to_beta
from coda_tpu_torch.ops.pbest import compute_pbest, refresh_tables

FLAVOURS = [("float32", False), ("float32", True), ("bfloat16", False),
            ("bfloat16", True)]
ROW_RTOL, ROW_ATOL = 2e-5, 2e-6


def _inputs(seed, N, C, H, c):
    """numpy inputs of kernel 6 from a seed (as tests/test_torch_fused.py
    makes them)."""
    rng = np.random.default_rng(seed)
    d = (rng.uniform(0, 1, (H, C, C)) * 3 + 0.5).astype(np.float32)
    hard = rng.integers(0, C, (N, H)).astype(np.int32)
    a, b = dirichlet_to_beta(torch.from_numpy(d))
    a_t, b_t = a[:, c].contiguous(), b[:, c].contiguous()
    rows = compute_pbest(a.T, b.T)
    rows[c] = compute_pbest(a_t, b_t)

    def simplex(*shape):
        x = rng.uniform(0.1, 1.1, size=shape).astype(np.float32)
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)

    hyp, pi_xi = simplex(C, N, H), simplex(N, C)
    pi = pi_xi.mean(0)
    return dict(rows=rows.numpy(), hyp=hyp, a_t=a_t.numpy(),
                b_t=b_t.numpy(), hard=hard,
                pi=(pi / pi.sum()).astype(np.float32), pi_xi=pi_xi)


def _row_3xtf32(S0, dlogcdf, F_u, dF, w_trapz, eq) -> torch.Tensor:
    """A plain emulation of kernel 6's row launch: the unnormalised
    ``(N, H)`` rows from one class's tables and the ``(N, H)`` bool mask
    ``eq``, with S summed in ascending h and the two products in
    3xTF32 as the kernel runs them: per 8-point k step, in ascending k,
    lo(w)·hi(B), then hi(w)·lo(B), then hi(w)·hi(B), fp32 sums (the
    tensor core's order inside a k step is its own)."""
    S = S0 + eq.to(torch.float32) @ dlogcdf
    w = w_trapz * torch.exp(S - S.max(-1, keepdim=True).values)
    wh, wl = ek.split_tf32(w)
    planes = ek.split_tables(F_u, dF)
    G = w.shape[-1]
    base = torch.zeros(eq.shape, dtype=torch.float32)
    diff = torch.zeros(eq.shape, dtype=torch.float32)
    for k in range(0, G, ek.ROW_POINTS):
        ks = slice(k, min(G, k + ek.ROW_POINTS))
        for a, (pb, pd) in ((wl[:, ks], (0, 1)), (wh[:, ks], (2, 3)),
                            (wh[:, ks], (0, 1))):
            base += a @ planes[pb, :, ks].T
            diff += a @ planes[pd, :, ks].T
    return torch.where(eq, base + diff, base)


# -- on the CPU --------------------------------------------------------------

def test_split_tf32_keeps_tf32_bits_and_gives_x_back():
    rng = np.random.default_rng(0)
    normal = np.concatenate([
        rng.uniform(-1, 1, 4096), 10.0 ** rng.uniform(-30, 5, 4096),
        -(10.0 ** rng.uniform(-30, 5, 4096)),
        [np.finfo(np.float32).tiny, 1.0, -1.0, 3.0e38]]).astype(np.float32)
    # the real range: a class's Beta grid tables at two widths
    a = torch.from_numpy(rng.uniform(0.5, 40, 300).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0.5, 40, 300).astype(np.float32))
    _, _, F_u, dF, _ = refresh_tables(a, b, 1.0, 256)
    x = torch.cat([torch.from_numpy(normal), F_u.flatten(), dF.flatten()])
    x = x[x != 0]
    hi, lo = ek.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = ((hi.double() + lo.double()) - x.double()).abs()
    # where x - hi is subnormal (|x| below about 2^-105) TF32's cut of the
    # rest is fixed-point: 2^-136 absolute
    assert (err <= torch.clamp_min(2.0 ** -21 * x.double().abs(),
                                   2.0 ** -136)).all()
    assert (err[x.abs() >= 2.0 ** -105]
            <= 2.0 ** -21 * x[x.abs() >= 2.0 ** -105].double().abs()).all()
    # zeros keep their sign in hi; subnormals give x back within 2^-136
    z = torch.tensor([0.0, -0.0])
    zh, zl = ek.split_tf32(z)
    assert torch.equal(zh.view(torch.int32), z.view(torch.int32))
    assert not zl.any()
    sub = torch.from_numpy(np.concatenate([
        rng.integers(1, 1 << 23, 512), -rng.integers(1, 1 << 23, 512)])
        .astype(np.float64) * 2.0 ** -149).to(torch.float32)
    assert (sub != 0).all() and (sub.abs() < 2.0 ** -126).all()
    sh, sl = ek.split_tf32(sub)
    assert not (sh.view(torch.int32) & 0x1FFF).any()
    assert ((sh.double() + sl.double() - sub.double()).abs()
            <= 2.0 ** -136).all()


def test_split_tables_planes_and_padding():
    """The plain split's planes: hi(F_u), hi(dF), lo(F_u), lo(dF), padded
    in G to the 8-point k step with zeros."""
    rng = np.random.default_rng(1)
    F_u = torch.from_numpy(rng.normal(size=(7, 50)).astype(np.float32))
    dF = torch.from_numpy(rng.normal(size=(7, 50)).astype(np.float32))
    planes = ek.split_tables(F_u, dF)
    assert planes.shape == (4, 7, 56) and planes.dtype == torch.float32
    assert not planes[:, :, 50:].any()
    for k, (t, part) in enumerate([(F_u, 0), (dF, 0), (F_u, 1), (dF, 1)]):
        assert torch.equal(planes[k, :, :50], ek.split_tf32(t)[part])
    with pytest.raises(ValueError, match="one .H, G. shape"):
        ek.split_tables(F_u, dF[:, :49])


@pytest.mark.parametrize("N,C,H,G,c", [(48, 4, 20, 256, 1),
                                       (33, 3, 150, 64, 2)])
def test_plain_3xtf32_row_matches_pallas_kernel(N, C, H, G, c):
    """The kernel's arithmetic on the CPU: the unnormalised rows of the
    3xTF32 emulation, normalised, against the reference kernel's refreshed
    fp32 row."""
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_eig import eig_scores_refresh_compute_pallas

    inp = _inputs(N * H + G, N, C, H, c)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    _, hyp = eig_scores_refresh_compute_pallas(
        j["rows"], j["hyp"], j["a_t"], j["b_t"], j["hard"], jnp.int32(c),
        j["pi"], j["pi_xi"], num_points=G, interpret=True)
    want = np.asarray(hyp)[c]
    S0, dlogcdf, F_u, dF, w_trapz = refresh_tables(
        torch.from_numpy(inp["a_t"]), torch.from_numpy(inp["b_t"]), 1.0, G)
    eq = torch.from_numpy(inp["hard"]) == c
    u = _row_3xtf32(S0, dlogcdf, F_u, dF, w_trapz, eq)
    row = u / u.sum(-1, keepdim=True).clamp_min(1e-30)
    np.testing.assert_allclose(row.numpy(), want, rtol=ROW_RTOL,
                               atol=ROW_ATOL)


def test_row_layout_limit_and_refusal():
    """H reaches 16,384 models at G = 256 (two ring stages), past the
    first design's 16,224; one more model is refused before launch, with
    the limit and the largest H in the message."""
    lay = ek.row_layout(1000)
    assert lay["ring_stages"] == ek.ROW_STAGES
    h_max = ek.row_layout(1000)["max_models"]
    assert h_max >= 16_224
    top = ek.row_layout(h_max)
    assert top["ring_stages"] == ek.ROW_MIN_STAGES
    assert top["smem_bytes"] <= 232_448 < \
        ek.row_layout(h_max + 1)["smem_bytes"]
    assert ek.check_row_layout(10, h_max)["max_models"] == h_max
    with pytest.raises(ValueError, match=f"232448.*H up to {h_max}"):
        ek.check_row_layout(10, h_max + 1)


H100_SMS = 132


@pytest.mark.parametrize("N,H,row_split,nwg", [
    (50_000, 1000, False, 2), (16_000, 1000, False, 2),
    (8449, 1000, False, 2), (8448, 1000, False, 1), (1797, 80, False, 1),
    (2048, 1000, True, 2), (1024, 1000, True, 1), (256, 500, True, 1),
    (2048, 500, True, 1)])
def test_warpgroup_rule(N, H, row_split, nwg):
    """One consumer warpgroup (64-item tiles) where the launch's work
    items at that tile fit one round of the H100's 132 SMs at one block
    an SM, two (128-item tiles) past it."""
    assert ek.choose_row_warpgroups(N, H, row_split, H100_SMS) == nwg


def test_forced_warpgroups_is_checked_on_the_cpu():
    inp = _inputs(3, 8, 3, 5, 1)
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}

    def call(wg):
        return ek.eig_scores_refresh_compute(
            t["rows"], t["hyp"].clone(), t["a_t"], t["b_t"], t["hard"],
            torch.tensor(1, dtype=torch.int32), t["pi"], t["pi_xi"],
            warpgroups=wg)[0]

    for bad in (0, 3, True, 2.0):
        with pytest.raises(ValueError, match="warpgroups"):
            call(bad)
    # the CPU reads a valid count no further: the plain version's scores
    assert torch.equal(call(1), call(None)) and torch.equal(call(2),
                                                            call(None))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _score_atol(H):
    return 2e-5 + 4 * H ** 0.5 * 2.0 ** -24 * np.log2(H)


def _run(inp, c, dtype, approx, dev, plain=False, hyp=None, **kw):
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in inp.items()}
    cache = (t["hyp"].to(getattr(torch, dtype)) if hyp is None
             else hyp.clone())
    fn = (ek.eig_scores_refresh_compute_plain if plain
          else ek.eig_scores_refresh_compute)
    return fn(t["rows"], cache, t["a_t"], t["b_t"], t["hard"],
              torch.tensor(c, dtype=torch.int32, device=dev), t["pi"],
              t["pi_xi"], approx=approx, **kw)


def _boundary_only(row_k, row_p, r32_k, r32_p):
    bk, bp = row_k.view(torch.int16), row_p.view(torch.int16)
    differ = bk != bp
    straddle = (r32_k.to(torch.bfloat16).view(torch.int16)
                != r32_p.to(torch.bfloat16).view(torch.int16))
    assert not (differ & ~straddle).any()
    assert ((bk.int() - bp.int()).abs()[differ] == 1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,approx", FLAVOURS)
@pytest.mark.parametrize("N,C,H,G", [(1000, 10, 100, 256), (1001, 3, 37, 256),
                                     (200, 3, 40, 300), (130, 3, 4000, 256)])
def test_kernel_matches_plain_on_card(cuda, dtype, approx, N, C, H, G):
    c = C - 1
    inp = _inputs(N + H + G, N, C, H, c)
    s_k, h_k = _run(inp, c, dtype, approx, cuda, num_points=G)
    s_p, h_p = _run(inp, c, dtype, approx, cuda, plain=True, num_points=G)
    torch.cuda.synchronize()
    if dtype == "float32":
        torch.testing.assert_close(s_k, s_p, rtol=1e-3, atol=_score_atol(H))
    else:
        # a bf16 row element one ulp off at a rounding boundary moves its
        # item's score by more than the fp32 tolerance: the scores are held
        # to the plain scoring of the row the kernel stored
        t = {k: torch.from_numpy(np.array(v)).to(cuda)
             for k, v in inp.items()}
        want = ek.eig_scores_from_cache(t["rows"], h_k, t["pi"], t["pi_xi"],
                                        approx=approx)
        torch.testing.assert_close(s_k, want, rtol=1e-3,
                                   atol=_score_atol(H))
    others = [i for i in range(C) if i != c]
    hyp0 = torch.from_numpy(inp["hyp"]).to(cuda).to(getattr(torch, dtype))
    assert torch.equal(h_k[others], hyp0[others])
    if dtype == "float32":
        torch.testing.assert_close(h_k[c], h_p[c], rtol=ROW_RTOL,
                                   atol=ROW_RTOL / H)
    else:
        _, r32_k = _run(inp, c, "float32", approx, cuda, num_points=G)
        _, r32_p = _run(inp, c, "float32", approx, cuda, plain=True,
                        num_points=G)
        _boundary_only(h_k[c], h_p[c], r32_k[c], r32_p[c])


@pytest.mark.gpu
@pytest.mark.parametrize("H,G", [(100, 256), (37, 300)])
def test_split_launch_is_bitwise_its_plain_version(cuda, H, G):
    rng = np.random.default_rng(H)
    F_u = torch.from_numpy(rng.normal(size=(H, G)).astype(np.float32))
    dF = torch.from_numpy(rng.normal(size=(H, G)).astype(np.float32))
    got = ek.split_tables(F_u.to(cuda), dF.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ek.split_tables(F_u, dF))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,approx", [("float32", False),
                                          ("bfloat16", True)])
@pytest.mark.parametrize("N,C,H", [(1000, 10, 300), (256, 40, 500)])
def test_decompositions_are_bitwise_equal(cuda, dtype, approx, N, C, H):
    """One and two consumer warpgroups, the row split on and off and three
    class-chunk counts: the same scores, row and cache bits."""
    c = C // 2
    inp = _inputs(N * C + H, N, C, H, c)
    first = None
    for wg in (1, 2):
        for row_split in (False, True):
            for k in (1, 3, C):
                s, h = _run(inp, c, dtype, approx, cuda, warpgroups=wg,
                            row_split=row_split, class_chunks=k)
                torch.cuda.synchronize()
                if first is None:
                    first = (s, h)
                assert torch.equal(s, first[0]), (wg, row_split, k)
                assert torch.equal(h, first[1]), (wg, row_split, k)


@pytest.mark.gpu
@pytest.mark.parametrize("warpgroups,row_split", [(2, False), (1, True),
                                                  (2, True)])
def test_out_of_range_class_gives_nan_and_writes_nothing(cuda, warpgroups,
                                                         row_split):
    C = 4
    inp = _inputs(7, 300, C, 200, 1)
    hyp = torch.from_numpy(inp["hyp"]).to(cuda)
    for bad in (C, -1):
        s, h = _run(inp, bad, "float32", False, cuda, hyp=hyp,
                    warpgroups=warpgroups, row_split=row_split)
        torch.cuda.synchronize()
        assert torch.isnan(s).all() and torch.equal(h, hyp)
