"""The sparse top-K posterior (``posterior='sparse:K'``) in the port
against the JAX reference on the CPU: ``ops/sparse_rows`` one function at
a time (ties included), the parity layout ``sparse:K>=C`` bitwise dense,
the truncated posterior's trajectories on the imagenet_sparse pool's
``--small`` shape (20, 256, 40) with K = 8 (``scripts/imagenet_sparse.py``),
the fused refresh and the exact pi-hat column over a sparse posterior,
state conversion, and the records' triage.

Tolerances: the compact leaves of :func:`sparsify` and
:func:`scatter_row` bitwise the reference's (the same float operations),
but for :func:`sparsify`'s residual, a difference of row sums taken in
another order, within 4e-6 (four ulps of a row sum near 10); the Beta
reduction and the rebuilt rows within ``rtol=1e-6, atol=1e-6`` (the
reference's own bound against the dense reduction, summation order);
``sparse:K>=C`` bitwise the dense run; trajectories triaged at the
cross-backend score contract 2.34e-4, as ``tests/test_torch_tiers.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from coda_tpu_torch.ops import sparse_rows as tsr
from coda_tpu_torch.selectors import coda as tcoda

CONTRACT = 2.34e-4
SMALL_POOL = (20, 256, 40)      # scripts/imagenet_sparse.py --small
SMALL_K, SMALL_CHUNK = 8, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one PyTorch thread, restored after: when pytest-xdist
    workers share the cores, the port's many small operations on several
    threads each wait on the other workers' spinning threads (tens of
    times slower than on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dirichlets(seed, H, C, ties=False):
    rng = np.random.default_rng(seed)
    d = (rng.uniform(0.05, 1.0, (H, C, C)) + 3.0 * np.eye(C)).astype(
        np.float32)
    if ties:
        # every row's off-diagonal values drawn from three levels: the
        # top-K boundary falls inside a run of equal values
        d = np.where(np.eye(C, dtype=bool), d,
                     rng.choice(np.float32([0.25, 0.5, 0.75]), d.shape))
    return d.astype(np.float32)


def _jax_sparse(s):
    from coda_tpu.ops.sparse_rows import SparseRows as JSparse
    import jax.numpy as jnp

    return JSparse(*(jnp.asarray(x.numpy()) for x in s))


def _assert_leaves_equal(t, j, resid_tol=False):
    """Leaves bitwise equal; with ``resid_tol`` the residual (row sum
    minus diagonal minus tracked values, the sums reduced in another order
    by XLA) within 4e-6, four ulps of a row sum near 10."""
    for name, a, b in zip(tsr.SparseRows._fields, t, j):
        if resid_tol and name == "resid":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=4e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


def test_parse_posterior_and_nbytes_match_reference():
    from coda_tpu.ops import sparse_rows as jsr

    for spec in ("dense", "sparse:32", "sparse:1", "sparse:1000"):
        assert tsr.parse_posterior(spec) == jsr.parse_posterior(spec)
    for bad in ("Sparse:32", "sparse:0", "sparse:-1", "sparse:x", "sparse",
                "topk:4"):
        with pytest.raises(ValueError) as want:
            jsr.parse_posterior(bad)
        with pytest.raises(ValueError) as got:
            tsr.parse_posterior(bad)
        assert str(got.value) == str(want.value)
    for H, C, k in ((500, 1000, 32), (500, 1000, None), (20, 40, 80)):
        assert tsr.posterior_nbytes(H, C, k) == jsr.posterior_nbytes(H, C, k)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 3, 8, 11, 12, 20])
def test_sparsify_matches_reference(k, ties):
    """The compact leaves, the Beta reduction and the dense rebuild, with
    equal off-diagonal values ordered lower column first (``lax.top_k``);
    K >= C is the parity layout."""
    import jax.numpy as jnp

    from coda_tpu.ops import sparse_rows as jsr

    H, C = 6, 12
    d = _dirichlets(3, H, C, ties)
    j = jsr.sparsify(jnp.asarray(d), k)
    t = tsr.sparsify(torch.from_numpy(d), k)
    _assert_leaves_equal(t, j, resid_tol=True)
    assert t.full == j.full == (k >= C)
    for tt, jj in zip(tsr.to_beta(t), jsr.to_beta(j)):
        np.testing.assert_allclose(tt.numpy(), np.asarray(jj), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tsr.densify(t).numpy(),
                               np.asarray(jsr.densify(j)), rtol=1e-6,
                               atol=1e-6)
    assert tsr.state_nbytes(t) == jsr.state_nbytes(j)


@pytest.mark.parametrize("k", [3, 12])
@pytest.mark.parametrize("ties", [False, True])
def test_scatter_row_matches_reference(k, ties):
    """200 labels through the sparse scatter (evictions into the residual,
    heavy untracked columns, ties at the eviction's argmin), both packages
    from the reference's compact state: every leaf bitwise the reference's
    after every label, and row_beta / densify_row of the touched row
    within the reduction tolerance."""
    import jax
    import jax.numpy as jnp

    from coda_tpu.ops import sparse_rows as jsr

    H, C, lr = 5, 12, 0.05
    d = _dirichlets(4, H, C, ties)
    j = jsr.sparsify(jnp.asarray(d), k)
    t = tsr.SparseRows(*(torch.from_numpy(np.array(x)) for x in j))
    scatter = jax.jit(jsr.scatter_row, static_argnames=("lr",))
    rng = np.random.default_rng(5)
    for step in range(200):
        c = int(rng.integers(0, C))
        # a few columns take most of the labels, so untracked ones grow
        preds = rng.choice([1, 2, 7, int(rng.integers(0, C))], H).astype(
            np.int32)
        j = scatter(j, jnp.asarray(c), jnp.asarray(preds), lr=lr)
        t = tsr.scatter_row(t, torch.tensor(c), torch.from_numpy(preds), lr)
        _assert_leaves_equal(t, j)
        if step % 40 == 0:
            for tt, jj in zip(tsr.row_beta(t, torch.tensor(c)),
                              jsr.row_beta(j, jnp.asarray(c))):
                np.testing.assert_allclose(tt.numpy(), np.asarray(jj),
                                           rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(
                tsr.densify_row(t, torch.tensor(c)).numpy(),
                np.asarray(jsr.densify_row(j, jnp.asarray(c))), rtol=1e-6,
                atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 12])
def test_scatter_row_on_card_is_bitwise_host(k):
    """The sparse scatter and densify_row on a CUDA device, bitwise their
    CPU run after every one of 200 labels (evictions, residual growth):
    the even residual share is one IEEE division on both devices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, C, lr = 5, 12, 0.05
    host = tsr.sparsify(torch.from_numpy(_dirichlets(4, H, C, True)), k)
    card = tsr.SparseRows(*(x.cuda() for x in host))
    rng = np.random.default_rng(5)
    for _ in range(200):
        c = int(rng.integers(0, C))
        preds = torch.from_numpy(rng.choice(
            [1, 2, 7, int(rng.integers(0, C))], H).astype(np.int32))
        tsr.scatter_row(host, torch.tensor(c), preds, lr)
        tsr.scatter_row(card, torch.tensor(c).cuda(), preds.cuda(), lr)
        for a, b in zip(card, host):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(tsr.densify_row(card, torch.tensor(c).cuda()).cpu(),
                           tsr.densify_row(host, torch.tensor(c)))


def test_batched_sparse_ops_equal_per_replica():
    """With a leading replica axis each replica takes its own class:
    scatter_row, row_beta and densify_row equal the one-replica calls
    bitwise."""
    H, C, K, S = 5, 12, 3, 3
    ds = np.stack([_dirichlets(10 + s, H, C) for s in range(S)])
    tb = tsr.sparsify(torch.from_numpy(ds), K)
    singles = [tsr.sparsify(torch.from_numpy(ds[s]), K) for s in range(S)]
    rng = np.random.default_rng(6)
    for _ in range(30):
        cs = torch.from_numpy(rng.integers(0, C, S))
        preds = torch.from_numpy(rng.integers(0, C, (S, H)).astype(np.int32))
        tsr.scatter_row(tb, cs, preds, 0.05)
        for s in range(S):
            tsr.scatter_row(singles[s], cs[s], preds[s], 0.05)
    for s in range(S):
        for a, b in zip(tb, singles[s]):
            assert torch.equal(a[s], b)
    cs = torch.tensor([0, 5, 11])
    for a, b in ((tsr.row_beta(tb, cs), None),):
        for s in range(S):
            one = tsr.row_beta(singles[s], cs[s])
            assert torch.equal(a[0][s], one[0]) and torch.equal(a[1][s],
                                                                one[1])
    rows = tsr.densify_row(tb, cs)
    for s in range(S):
        assert torch.equal(rows[s], tsr.densify_row(singles[s], cs[s]))


# -- the selector -------------------------------------------------------------

def _task(shape, seed=5):
    from coda_tpu_torch.data import make_synthetic_arrays

    H, N, C = shape
    return make_synthetic_arrays(seed=seed, H=H, N=N, C=C)


def _record(result, aux):
    from coda_tpu_torch.telemetry.recorder import RunRecord

    return RunRecord.from_result(result, aux, {}, {})


def _port_run(preds, labels, iters, seeds, sequential=False, **kw):
    from coda_tpu_torch.engine import run_seeds_recorded

    hp = tcoda.CODAHyperparams(n_parallel=1 if sequential else seeds, **kw)

    def factory(p):
        sel = tcoda.make_coda(p, hp, device="cpu")
        return dataclasses.replace(sel, batched=None) if sequential else sel

    return _record(*run_seeds_recorded(factory, preds, labels, iters=iters,
                                       seeds=seeds, device="cpu"))


def _reference_run(preds, labels, iters, seeds, **kw):
    import jax.numpy as jnp

    from coda_tpu.engine import run_seeds_recorded
    from coda_tpu.selectors import CODAHyperparams, make_coda

    hp = CODAHyperparams(n_parallel=seeds, **kw)
    return _record(*run_seeds_recorded(lambda p: make_coda(p, hp),
                                       jnp.asarray(preds),
                                       jnp.asarray(labels), iters=iters,
                                       seeds=seeds))


def _assert_triaged(got, ref):
    from coda_tpu_torch.engine.replay import compare_records

    report = compare_records(got, ref, score_tol=CONTRACT)
    for s in report.seeds:
        if s.parity:
            continue
        gap = float(ref.arrays["runner_up_gap"][s.seed,
                                                s.first_divergent_round])
        assert s.classification == "tie-break-flip", s.to_dict()
        assert abs(gap) <= CONTRACT, (s.to_dict(), gap)


def _assert_same(a, b):
    for f, arr in a.arrays.items():
        np.testing.assert_array_equal(arr, b.arrays[f], err_msg=f)


@pytest.mark.parametrize("extra", [{}, dict(pi_update="exact"),
                                   dict(eig_refresh="fused")])
def test_untruncated_sparse_is_bitwise_dense(extra):
    """sparse:K>=C (the parity layout) on digits: the same trajectories,
    scores and posterior digests as the dense posterior, bit for bit —
    batched (3 seeds x 30 rounds), or one seed after another under the
    fused refresh."""
    d = np.load("data/digits.npz")
    preds, labels = d["preds"].astype(np.float32), d["labels"]
    C = preds.shape[-1]
    seq = extra.get("eig_refresh") == "fused"
    kw = dict(eig_chunk=1024, **extra)
    dense = _port_run(preds, labels, 30, 3, sequential=seq, **kw)
    for k in ((C, C + 7) if not extra else (C,)):
        _assert_same(_port_run(preds, labels, 30, 3, sequential=seq,
                               posterior=f"sparse:{k}", **kw), dense)


@pytest.mark.parametrize("extra", [{}, dict(pi_update="exact")])
def test_truncated_sparse_matches_vmapped_reference(extra):
    """sparse:8 on the small imagenet_sparse pool, 3 seeds x 30 rounds:
    the port's batched run against the reference's vmapped one, and
    against the dense posterior under the score contract."""
    preds, labels = _task(SMALL_POOL)
    kw = dict(eig_mode="incremental", eig_chunk=SMALL_CHUNK,
              posterior=f"sparse:{SMALL_K}", **extra)
    got = _port_run(preds, labels, 30, 3, **kw)
    _assert_triaged(got, _reference_run(preds, labels, 30, 3, **kw))
    dense = _port_run(preds, labels, 30, 3,
                      **dict(kw, posterior="dense"))
    _assert_triaged(got, dense)
    worst = max(float(np.max(np.abs(got.arrays[q] - dense.arrays[q])))
                for q in ("topk_score", "chosen_score"))
    assert worst <= CONTRACT, worst


def test_truncated_sparse_fused_refresh_triages():
    """The fused refresh reads the labelled row's Betas from the sparse
    row (kernel 6's a_t, b_t): one seed, 30 rounds, triaged against the
    precomputed refresh over the same sparse posterior."""
    preds, labels = _task(SMALL_POOL)
    kw = dict(eig_mode="incremental", eig_chunk=SMALL_CHUNK,
              posterior=f"sparse:{SMALL_K}")
    _assert_triaged(_port_run(preds, labels, 30, 1, eig_refresh="fused",
                              **kw),
                    _port_run(preds, labels, 30, 1, **kw))


def test_sparse_state_carries_no_dense_posterior():
    preds, _ = _task(SMALL_POOL)
    sel = tcoda.make_coda(preds, tcoda.CODAHyperparams(
        eig_mode="incremental", posterior="sparse:8"), device="cpu")
    st = sel.init(None)
    assert st.dirichlets is None and st.sparse.vals.shape == (20, 40, 8)
    b = sel.batched.init(3)
    assert b.dirichlets is None and b.sparse.idx.shape == (3, 20, 40, 8)


def test_convert_sparse_state_then_step_matches_reference():
    """A reference mid-run state with a sparse posterior crosses into the
    port: one select + update in each package gives the same pick and
    leaves, the scores within 4e-6 (see below)."""
    import jax
    import jax.numpy as jnp

    from coda_tpu.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.convert import state_from_numpy, state_to_numpy

    preds, labels = _task(SMALL_POOL)
    hp = dict(eig_mode="incremental", eig_chunk=SMALL_CHUNK,
              posterior=f"sparse:{SMALL_K}")
    jsel = make_coda(jnp.asarray(preds), CODAHyperparams(**hp))
    select, update = jax.jit(jsel.select), jax.jit(jsel.update)
    state = jax.jit(jsel.init)(jax.random.PRNGKey(0))
    for r in range(4):
        res = select(state, jax.random.PRNGKey(100 + r))
        state = update(state, res.idx, labels[int(res.idx)], res.prob)
    fields = {k: (None if v is None else
                  tuple(map(np.asarray, v)) if k == "sparse"
                  else np.asarray(v))
              for k, v in state._asdict().items()}
    tstate = state_from_numpy(fields, device="cpu")
    assert tstate.dirichlets is None and tstate.pbest_hyp is not None
    key = jax.random.PRNGKey(77)
    jres = select(state, key)
    jnext = update(state, jres.idx, labels[int(jres.idx)], jres.prob)
    tsel = tcoda.make_coda(preds, tcoda.CODAHyperparams(**hp), device="cpu")
    tres = tsel.select(tstate, trandom.PRNGKey(77))
    assert int(tres.idx) == int(jres.idx)
    tnext = tsel.update(tstate, tres.idx, torch.tensor(labels[int(
        tres.idx)]), tres.prob)
    got = state_to_numpy(tnext)
    for a, b in zip(got["sparse"], jnext.sparse):
        np.testing.assert_array_equal(a, np.asarray(b))
    # scores are differences of entropies near log2(H) = 4.3 bits, summed
    # over C = 40 class terms: within 4e-6, eight ulps of 4.3
    np.testing.assert_allclose(got["eig_scores_cached"],
                               np.asarray(jnext.eig_scores_cached),
                               rtol=1e-4, atol=4e-6)


def test_sparse_records_triage_under_the_score_contract(tmp_path):
    """Records that differ in ``posterior`` (and ``eig_pbest``) compare
    under the cross-backend contract, as the reference's auto tolerance
    does, and name the knob difference."""
    from coda_tpu_torch.engine import replay as treplay
    from coda_tpu_torch.telemetry.recorder import (
        CROSS_BACKEND_SCORE_TOL,
        RunRecord,
    )

    preds, labels = _task(SMALL_POOL)
    recs = {}
    for spec in ("dense", f"sparse:{SMALL_K}"):
        r = _port_run(preds, labels, 10, 1, eig_mode="incremental",
                      eig_chunk=SMALL_CHUNK, posterior=spec)
        r = RunRecord(meta=dict(r.meta, fingerprint={
            "backend": "torch-cpu", "knobs": {"posterior": spec}}),
            arrays=r.arrays)
        recs[spec] = r
    a, b = recs["dense"], recs[f"sparse:{SMALL_K}"]
    tol = treplay._auto_tol(a, {}, against=b)
    assert tol == CROSS_BACKEND_SCORE_TOL == CONTRACT
    assert treplay._auto_tol(a, {}, against=a) == 0.0
    report = treplay.compare_records(a, b, score_tol=tol)
    assert report.meta["knob_diff"] == {"posterior": ["dense",
                                                      f"sparse:{SMALL_K}"]}
    for s in report.seeds:
        assert s.parity or s.classification == "tie-break-flip"
    c = RunRecord(meta=dict(a.meta, fingerprint={
        "backend": "torch-cpu", "knobs": {"eig_pbest": "amortized"}}),
        arrays=a.arrays)
    assert treplay._auto_tol(a, {}, against=c) == CONTRACT
