"""The port's kernel modules: each kernel's plain version against the JAX
Pallas kernel run as ``tests/test_pallas_eig.py`` / ``test_pallas_gather.py``
run it (interpret mode on the CPU), the CPU dispatch of the wrappers, and
the build plumbing. The kernels themselves run only on the card: the tests
marked ``gpu`` hold them to their plain versions there and skip elsewhere.
JAX is imported inside the tests that compare with it, so on a machine
without JAX the card tests run with
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``.

Tolerances: scores rtol 1e-4, atol 1e-6 (the reference's own Pallas-vs-jnp
bound: the same fp32 chain with another reduction order over H); the
refreshed cache row and every untouched row bitwise; the gather rtol 1e-6
(the same H fp32 adds, sequential vs PyTorch's summation order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from coda_tpu_torch.ops import eig_kernels as ek
from coda_tpu_torch.ops import gather_kernels as gk

SCORE_TOL = dict(rtol=1e-4, atol=1e-6)


def _cache(seed, N, C, H):
    """Random normalised (rows, hyp, pi, pi_xi, hyp_t) from a numpy seed."""
    rng = np.random.default_rng(seed)

    def simplex(*shape):
        x = rng.uniform(0.1, 1.1, size=shape).astype(np.float32)
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)

    rows, hyp, pi_xi, hyp_t = simplex(C, H), simplex(C, N, H), \
        simplex(N, C), simplex(N, H)
    pi = pi_xi.mean(0)
    return rows, hyp, (pi / pi.sum()).astype(np.float32), pi_xi, hyp_t


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrs]


# -- kernel 1: scoring -------------------------------------------------------

@pytest.mark.parametrize("N,C,H,blk", [(300, 5, 12, 64), (77, 4, 9, 32),
                                       (129, 3, 16, 40)])
def test_score_plain_matches_pallas_kernel(N, C, H, blk):
    from coda_tpu.ops.pallas_eig import eig_scores_cache_pallas

    rows, hyp, pi, pi_xi, _ = _cache(N + H, N, C, H)
    ref = np.asarray(eig_scores_cache_pallas(*_j(rows, hyp, pi, pi_xi),
                                             block=blk, interpret=True))
    before = dict(ek.launch_counts)
    out = ek.eig_scores_cache(*_t(rows, hyp, pi, pi_xi), chunk=blk)
    assert out.shape == (N,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **SCORE_TOL)
    assert int(out.argmax()) == int(ref.argmax())
    # a CPU tensor takes the plain version: no launch is counted
    assert ek.launch_counts == before


def test_score_plain_is_chunk_invariant():
    rows, hyp, pi, pi_xi, _ = _cache(3, 90, 4, 10)
    args = _t(rows, hyp, pi, pi_xi)
    whole = ek.eig_scores_from_cache(*args, chunk=90)
    for chunk in (1, 7, 32, 1000):
        np.testing.assert_array_equal(
            ek.eig_scores_from_cache(*args, chunk=chunk).numpy(),
            whole.numpy())


# -- kernel 2: refresh + score -----------------------------------------------

@pytest.mark.parametrize("N,C,H,blk,c", [(300, 5, 12, 64, 4),
                                         (77, 4, 9, 32, 0),
                                         (200, 7, 11, 48, 3)])
def test_refresh_plain_matches_pallas_kernel(N, C, H, blk, c):
    """Scores match the Pallas refresh kernel; the returned cache holds
    hyp_t in row c and every other row bitwise untouched; the update is
    in place on the tensor passed in."""
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_eig import eig_scores_refresh_pallas

    rows, hyp, pi, pi_xi, hyp_t = _cache(N * C + c, N, C, H)
    s_ref, hyp_ref = eig_scores_refresh_pallas(
        *_j(rows, hyp, hyp_t), jnp.int32(c), *_j(pi, pi_xi), block=blk,
        interpret=True)
    rows_t, hyp_tt, hyp_t_t, pi_t, pi_xi_t = _t(rows, hyp, hyp_t, pi, pi_xi)
    scores, hyp_out = ek.eig_scores_refresh(
        rows_t, hyp_tt, hyp_t_t, torch.tensor(c, dtype=torch.int32), pi_t,
        pi_xi_t, chunk=blk)
    np.testing.assert_allclose(scores.numpy(), np.asarray(s_ref), **SCORE_TOL)
    assert hyp_out is hyp_tt                      # written in place
    out = hyp_out.numpy()
    np.testing.assert_array_equal(out, np.asarray(hyp_ref))
    np.testing.assert_array_equal(out[c], hyp_t)
    others = [i for i in range(C) if i != c]
    np.testing.assert_array_equal(out[others], hyp[others])


def test_refresh_equals_write_then_score():
    rows, hyp, pi, pi_xi, hyp_t = _cache(11, 50, 3, 8)
    hyp2 = hyp.copy()
    hyp2[1] = hyp_t
    want = ek.eig_scores_from_cache(*_t(rows, hyp2, pi, pi_xi))
    got, _ = ek.eig_scores_refresh_plain(*_t(rows, hyp, hyp_t),
                                         torch.tensor(1), *_t(pi, pi_xi))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_mixture_stats_match_reference():
    from coda_tpu.ops.pallas_eig import _mixture_stats

    rows, _, pi, _, _ = _cache(5, 4, 6, 20)
    m_ref, h_ref = _mixture_stats(*_j(rows, pi))
    m, h = ek.mixture_stats(*_t(rows, pi))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref)[0, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(float(h), float(np.asarray(h_ref)[0, 0]),
                               rtol=1e-6)


# -- kernel 3: row gather ----------------------------------------------------

@pytest.mark.parametrize("C,H,N", [(4, 12, 256), (10, 37, 1000), (3, 8, 129),
                                   (5, 9, 300)])
def test_gather_plain_matches_pallas_kernel(C, H, N):
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_gather import (
        gather_rows_sum_prepped,
        prep_gather_layout,
    )

    rng = np.random.default_rng(C * H + N)
    preds = rng.dirichlet(np.ones(C), size=(H, N)).astype(np.float32)
    s = rng.integers(0, C, size=H).astype(np.int32)
    pbc_j = jnp.transpose(jnp.asarray(preds), (2, 0, 1))
    ref = np.asarray(gather_rows_sum_prepped(prep_gather_layout(pbc_j),
                                             jnp.asarray(s), N,
                                             interpret=True))
    pbc = gk.prep_gather_layout(torch.from_numpy(preds))
    assert pbc.shape == (C, H, N) and pbc.is_contiguous()
    np.testing.assert_array_equal(pbc.numpy(), np.asarray(pbc_j))
    before = dict(gk.launch_counts)
    out = gk.gather_rows_sum(pbc, torch.from_numpy(s))
    assert out.shape == (N,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    assert gk.launch_counts == before


@pytest.mark.parametrize("C,H,N", [(4, 12, 256), (10, 37, 1000), (3, 8, 129),
                                   (5, 9, 300)])
def test_gather_inorder_equals_pallas_kernel_bitwise(C, H, N):
    """The in-order plain version (the sum kernel 3 takes on the card) is
    bitwise the Pallas kernel's fp32 accumulator over h, for one replica
    and, row by row, for a batch of replicas."""
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_gather import (
        gather_rows_sum_prepped,
        prep_gather_layout,
    )

    rng = np.random.default_rng(C * H + N)
    preds = rng.dirichlet(np.ones(C), size=(H, N)).astype(np.float32)
    s = rng.integers(0, C, size=(3, H)).astype(np.int32)
    flat = prep_gather_layout(jnp.transpose(jnp.asarray(preds), (2, 0, 1)))
    refs = [np.asarray(gather_rows_sum_prepped(flat, jnp.asarray(row), N,
                                               interpret=True))
            for row in s]
    pbc = gk.prep_gather_layout(torch.from_numpy(preds))
    np.testing.assert_array_equal(
        gk.gather_rows_sum_inorder(pbc, torch.from_numpy(s[0])).numpy(),
        refs[0])
    batched = gk.gather_rows_sum_inorder(pbc, torch.from_numpy(s))
    assert batched.shape == (3, N)
    np.testing.assert_array_equal(batched.numpy(), np.stack(refs))


def test_gather_path_choice():
    """Kernel 3's ring of 16-byte copies only when every row segment starts
    16-byte aligned; its 4-byte path otherwise."""
    pbc = torch.zeros(2, 3, 260)
    assert gk._aligned(pbc)
    assert not gk._aligned(torch.zeros(2, 3, 259))
    assert not gk._aligned(pbc.view(-1)[1:1 + 2 * 3 * 256].view(2, 3, 256))


def test_plogp_error_units():
    """The exact flavour's contract as the card's sweep measures it: the
    correctly rounded term is within a quarter of a unit; for p <= 1/2
    (where |t| >= p) a term 8 ulps off is not within one."""
    p = torch.tensor([1e-12, 3e-7, 0.001, 0.0625, 0.3, 0.5, 0.999, 1.0],
                     dtype=torch.float32)
    p64 = p.double()
    t = (p64 * torch.log2(p64)).float()
    assert float(ek.plogp_error_units(p, t).max()) <= 0.25
    off = t + 8 * torch.finfo(torch.float32).eps * t.abs()
    assert float(ek.plogp_error_units(p[:6], off[:6]).min()) > 1.0
    # on the CPU every form is the plain versions' term
    assert torch.equal(ek.plogp_terms(p), p * (torch.log(p) * ek._LOG2E))


# -- wrappers: no silent fallback --------------------------------------------

def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never routed to the plain version."""
    C, N, H = 3, 16, 8
    meta = dict(device="meta", dtype=torch.float32)
    rows, hyp = torch.empty(C, H, **meta), torch.empty(C, N, H, **meta)
    pi, pi_xi = torch.empty(C, **meta), torch.empty(N, C, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        ek.eig_scores_cache(rows, hyp, pi, pi_xi)
    with pytest.raises(ValueError, match="CUDA"):
        ek.eig_scores_refresh(rows, hyp, torch.empty(N, H, **meta),
                              torch.zeros((), dtype=torch.int32,
                                          device="meta"), pi, pi_xi)
    with pytest.raises(ValueError, match="CUDA"):
        gk.gather_rows_sum(torch.empty(C, H, N, **meta),
                           torch.zeros(H, dtype=torch.int32, device="meta"))


def test_build_plumbing(monkeypatch, tmp_path):
    """Libraries are keyed by a hash of source + flags, target sm_90a,
    and a missing toolkit raises instead of falling back."""
    from coda_tpu_torch.ops import build

    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    for name in build.SOURCES:
        assert (build.SRC_DIR / f"{name}.cu").exists()
        p = build.library_path(name)
        assert p.parent == build.BUILD_DIR and p.name.startswith(name + "-")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    (tmp_path / "eig_score.cu").write_text("// one\n")
    p1 = build.library_path("eig_score")
    (tmp_path / "eig_score.cu").write_text("// two\n")
    assert build.library_path("eig_score") != p1
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N,C,H", [(1000, 10, 100), (1001, 3, 37)])
def test_score_kernels_match_plain_on_card(cuda, N, C, H):
    rows, hyp, pi, pi_xi, hyp_t = (t.to(cuda) for t in
                                   _t(*_cache(N, N, C, H)))
    n0 = dict(ek.launch_counts)
    # two fp32 summation orders of an H-term entropy differ by about
    # sqrt(H) ulps of log2(H): the card's tolerance scales with H
    tol = dict(rtol=1e-4, atol=4 * H ** 0.5 * 2.0 ** -24 * np.log2(H))
    got = ek.eig_scores_cache(rows, hyp, pi, pi_xi)
    want = ek.eig_scores_from_cache(rows, hyp, pi, pi_xi)
    torch.testing.assert_close(got, want, **tol)
    c = torch.tensor(C - 1, dtype=torch.int32, device=cuda)
    hyp_k, hyp_p = hyp.clone(), hyp.clone()
    s_k, _ = ek.eig_scores_refresh(rows, hyp_k, hyp_t, c, pi, pi_xi)
    s_p, _ = ek.eig_scores_refresh_plain(rows, hyp_p, hyp_t, c, pi, pi_xi)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k, s_p, **tol)
    assert torch.equal(hyp_k, hyp_p)
    assert ek.launch_counts["eig_score"] == n0["eig_score"] + 1
    assert ek.launch_counts["eig_refresh_score"] == \
        n0["eig_refresh_score"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,N", [(10, 100, 5000), (3, 37, 1001)])
def test_gather_kernel_matches_plain_on_card(cuda, C, H, N):
    rng = np.random.default_rng(N)
    pbc = torch.from_numpy(rng.uniform(0, 1, (C, H, N)).astype(
        np.float32)).to(cuda)
    s = torch.from_numpy(rng.integers(0, C, H).astype(np.int32)).to(cuda)
    got = gk.gather_rows_sum(pbc, s)
    # H positive fp32 adds in two orders: |diff| <= H * 2^-24 * |sum|
    torch.testing.assert_close(got, gk.gather_rows_sum_plain(pbc, s),
                               rtol=H * 2.0 ** -24, atol=0)
    bad = s.clone()
    bad[0] = C
    assert torch.isnan(gk.gather_rows_sum(pbc, bad)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,N", [(10, 1000, 5000), (3, 37, 1001),
                                   (4, 13, 130)])
def test_gather_kernel_sums_in_order_on_card(cuda, C, H, N):
    """Kernel 3 and its batched form are bitwise the in-order fp32 sum over
    h (16-byte copies at N % 4 == 0, 4-byte copies otherwise)."""
    rng = np.random.default_rng(H + N)
    pbc = torch.from_numpy(rng.uniform(0, 1, (C, H, N)).astype(
        np.float32)).to(cuda)
    s = torch.from_numpy(rng.integers(0, C, (3, H)).astype(np.int32)).to(cuda)
    assert torch.equal(gk.gather_rows_sum(pbc, s[0]),
                       gk.gather_rows_sum_inorder(pbc, s[0]))
    assert torch.equal(gk.gather_rows_sum_batched(pbc, s),
                       gk.gather_rows_sum_inorder(pbc, s))


@pytest.mark.gpu
def test_plogp_exact_term_meets_contract_on_card(cuda):
    """The exact flavour's log term on a strided subset of the fp32 p in
    [1e-12, 1] (chip_smoke.py sweeps all of them), with the ends and the
    p = 1/16 switch: within its contract."""
    lo, hi, wide = (int(np.float32(x).view(np.int32))
                    for x in (1e-12, 1.0, 0.0625))
    bits = torch.cat([
        torch.arange(lo, hi + 1, 997, dtype=torch.int32),
        torch.arange(wide - 64, wide + 64, dtype=torch.int32),
        torch.arange(hi - 4096, hi + 1, dtype=torch.int32),
        torch.tensor([lo, hi], dtype=torch.int32)]).to(cuda)
    p = bits.view(torch.float32)
    units = ek.plogp_error_units(p, ek.plogp_terms(p))
    assert float(units.max()) <= 1.0, float(p[units.argmax()])
