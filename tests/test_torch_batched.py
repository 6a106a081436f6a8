"""The port's seed-batched engine against the JAX reference on the CPU:
S seeds in one round loop through kernels 4 and 5 (``eig_scores_cache_
batched``, ``eig_scores_refresh_batched``) and the batched kernel 3.

The JAX side runs as its own tests run it: the batched Pallas entries in
interpret mode, and ``run_seeds_compiled`` with ``n_parallel`` seeds under
``vmap`` and ``eig_backend='pallas'`` (whose ``custom_vmap`` rules reach
the batched kernels). JAX is imported inside the tests that compare with
it, so on a machine without JAX the card tests run with
``python -m pytest tests/test_torch_batched.py -m gpu --noconftest``.

Tolerances (each the reference's own for the same comparison): batched
scores rtol 1e-4, atol 1e-6 (``tests/test_pallas_eig.py:298,312``), the
refreshed cache bitwise; keys and tie-break draws bitwise; trajectories
identical in chosen item, true class, best model and regret, with
``select_prob`` within 1e-5 (``tests/test_torch_coda.py``'s
``PROB_ATOL``). On the card, kernels 4, 5 and the batched gather are held
to kernels 1, 2 and 3 launched per replica bitwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.ops import eig_kernels as ek
from coda_tpu_torch.ops import gather_kernels as gk
from coda_tpu_torch.selectors import coda as tcoda

FLAVOURS = [("float32", False), ("float32", True), ("bfloat16", False),
            ("bfloat16", True)]
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)
PROB_ATOL = 1e-5
TRAJECTORY = ("chosen_idx", "true_class", "best_model", "regret")


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
    """A cache as comparable bits: bf16 through its int16 view."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# -- random keys and the tie-break --------------------------------------------

def test_batched_keys_match_jax_vmap():
    """split and uniform over (S, 2) and (T, S, 2) keys equal
    jax.vmap(jax.random.split) / jax.vmap(jax.random.uniform) bit for bit,
    and row s equals the single-key call on key s."""
    import jax

    import coda_tpu  # noqa: F401 — sets jax_threefry_partitionable

    keys_j = jax.vmap(jax.random.PRNGKey)(np.array([0, 1, 7, 2**31 - 1]))
    keys_t = torch.from_numpy(np.asarray(keys_j).astype(np.int64))
    for n in (2, 3, 10):
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, n))(keys_j))
        got = trandom.split(keys_t, n)
        assert got.shape == (4, n, 2)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        for s in range(4):
            assert torch.equal(got[s], trandom.split(keys_t[s], n))
    nested_j = jax.vmap(lambda k: jax.random.split(k, 5))(keys_j)   # (4,5,2)
    nested_t = trandom.split(keys_t, 5)
    np.testing.assert_array_equal(
        trandom.split(nested_t).numpy(),
        np.asarray(jax.vmap(jax.vmap(jax.random.split))(nested_j)).astype(
            np.int64))
    for shape in ((13,), (3, 7)):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
            keys_j))
        got = trandom.uniform(keys_t, shape)
        assert got.shape == (4, *shape) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
        for s in range(4):
            assert torch.equal(got[s], trandom.uniform(keys_t[s], shape))


@pytest.mark.parametrize("case", ["unique", "ties", "isclose_ties"])
def test_batched_tiebreak_matches_vmapped_reference(case):
    """(S, N) scores with (S, 2) keys: the same (idx, tie count) as the
    reference's masked_argmax_tiebreak under jax.vmap, row by row."""
    import jax
    import jax.numpy as jnp

    from coda_tpu.ops.masked import masked_argmax_tiebreak as jtie
    from coda_tpu_torch.ops.masked import masked_argmax_tiebreak

    S, N = 5, 40
    rng = np.random.default_rng(21)
    scores = rng.uniform(0, 1, (S, N)).astype(np.float32)
    mask = rng.uniform(size=(S, N)) < 0.7
    if case != "unique":
        top = scores.max(-1, keepdims=True)
        tied = rng.uniform(size=(S, N)) < 0.3
        scores = np.where(tied, top + (1e-9 if case == "isclose_ties"
                                       else 0.0), scores).astype(np.float32)
        mask |= tied
    kw = dict(rtol=1e-8, atol=1e-8) if case == "isclose_ties" else {}
    keys_j = jax.random.split(jax.random.PRNGKey(3), S)
    idx_j, n_j = jax.vmap(lambda k, sc, m: jtie(k, sc, m, **kw))(
        keys_j, jnp.asarray(scores), jnp.asarray(mask))
    keys_t = torch.from_numpy(np.asarray(keys_j).astype(np.int64))
    idx, n = masked_argmax_tiebreak(keys_t, torch.from_numpy(scores),
                                    torch.from_numpy(mask), **kw)
    assert idx.shape == (S,) and n.shape == (S,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    if case != "unique":
        assert (n.numpy() > 1).all()


# -- kernels 4 and 5: the plain versions against the batched Pallas kernels ---

@pytest.mark.parametrize("dtype,approx", FLAVOURS)
@pytest.mark.parametrize("S,C,N,H,blk", [(3, 4, 40, 10, 16),
                                         (5, 3, 41, 9, 16)])
def test_batched_plain_matches_pallas_kernels(dtype, approx, S, C, N, H,
                                              blk):
    """Kernels 4 and 5's plain versions (what the wrappers take for CPU
    tensors) against eig_scores_cache_pallas_batched and
    eig_scores_refresh_pallas_batched in interpret mode, at (S, C, N, H) =
    (3, 4, 40, 10) and a ragged N. The refreshed caches are equal; the
    refresh is in place on the tensor passed in."""
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_eig import (
        eig_scores_cache_pallas_batched,
        eig_scores_refresh_pallas_batched,
    )

    rows, hyp, pi, pi_xi, hyp_t, cls = _batched_cache(S * N + H, S, C, N, H)
    j = [jnp.asarray(a) for a in (rows, hyp, pi, pi_xi, hyp_t, cls)]
    jhyp = j[1].astype(dtype)
    t = [torch.from_numpy(a.copy()) for a in (rows, hyp, pi, pi_xi, hyp_t,
                                               cls)]
    thyp = t[1].to(getattr(torch, dtype))
    before = dict(ek.launch_counts)

    ref = np.asarray(eig_scores_cache_pallas_batched(
        j[0], jhyp, j[2], j[3], block=blk, interpret=True, approx=approx))
    got = ek.eig_scores_cache_batched(t[0], thyp, t[2], t[3], chunk=blk,
                                      approx=approx)
    assert got.shape == (S, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **SCORE_TOL)

    s_ref, h_ref = eig_scores_refresh_pallas_batched(
        j[0], jhyp, j[4], j[5], j[2], j[3], block=blk, interpret=True,
        approx=approx)
    s, h = ek.eig_scores_refresh_batched(t[0], thyp, t[4], t[5], t[2], t[3],
                                         chunk=blk, approx=approx)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **SCORE_TOL)
    assert h is thyp and h.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(h), _bits(h_ref))
    # each replica refreshed its own class row, and only that row
    want = hyp.copy()
    want[np.arange(S), cls] = hyp_t
    np.testing.assert_array_equal(
        _bits(h), _bits(torch.from_numpy(want).to(getattr(torch, dtype))))
    assert ek.launch_counts == before    # the CPU takes the plain versions


def test_batched_plain_equals_single_replica_plain():
    """Row s of kernels 4/5's plain versions is bitwise kernels 1/2's plain
    version on replica s (the plain versions loop over replicas)."""
    S, C, N, H = 3, 4, 33, 8
    rows, hyp, pi, pi_xi, hyp_t, cls = (torch.from_numpy(a) for a in
                                        _batched_cache(5, S, C, N, H))
    got = ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi)
    hyp_b = hyp.clone()
    s_b, _ = ek.eig_scores_refresh_batched(rows, hyp_b, hyp_t, cls, pi, pi_xi)
    for s in range(S):
        assert torch.equal(got[s], ek.eig_scores_cache(rows[s], hyp[s], pi[s],
                                                       pi_xi[s]))
        hyp_s = hyp[s].clone()
        s_1, _ = ek.eig_scores_refresh(rows[s], hyp_s, hyp_t[s], cls[s],
                                       pi[s], pi_xi[s])
        assert torch.equal(s_b[s], s_1) and torch.equal(hyp_b[s], hyp_s)


def test_batched_mixture_stats_match_vmapped_reference():
    import jax
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_eig import _mixture_stats

    rows, _, pi, _, _, _ = _batched_cache(8, 4, 5, 3, 20)
    for approx in (False, True):
        m_ref, h_ref = jax.vmap(lambda r, p: _mixture_stats(
            r, p, approx=approx))(jnp.asarray(rows), jnp.asarray(pi))
        m, h = ek.mixture_stats(torch.from_numpy(rows), torch.from_numpy(pi),
                                approx=approx)
        assert m.shape == (4, 20) and h.shape == (4,)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_ref)[:, 0, 0],
                                   rtol=1e-6)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref)[:, 0, 0],
                                   rtol=1e-6)


def test_batched_gather_plain_matches_reference_rows():
    """The batched kernel 3's plain version: row s is the reference's XLA
    gather (its lowering under vmap) on replica s's classes."""
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_gather import gather_rows_sum_xla

    rng = np.random.default_rng(4)
    S, C, H, N = 4, 5, 9, 70
    preds = rng.dirichlet(np.ones(C), size=(H, N)).astype(np.float32)
    s = rng.integers(0, C, (S, H)).astype(np.int32)
    pbc = gk.prep_gather_layout(torch.from_numpy(preds))
    before = dict(gk.launch_counts)
    got = gk.gather_rows_sum_batched(pbc, torch.from_numpy(s))
    assert got.shape == (S, N) and gk.launch_counts == before
    pbc_j = jnp.transpose(jnp.asarray(preds), (2, 0, 1))
    for r in range(S):
        np.testing.assert_allclose(
            got[r].numpy(), np.asarray(gather_rows_sum_xla(
                pbc_j, jnp.asarray(s[r]))), rtol=1e-6)
        np.testing.assert_allclose(
            got[r].numpy(), gk.gather_rows_sum(pbc, torch.from_numpy(s[r]))
            .numpy(), rtol=1e-6)


def test_batched_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    routed to the plain versions."""
    S, C, N, H = 2, 3, 16, 8
    meta = dict(device="meta", dtype=torch.float32)
    rows, hyp = torch.empty(S, C, H, **meta), torch.empty(S, C, N, H, **meta)
    pi, pi_xi = torch.empty(S, C, **meta), torch.empty(S, N, C, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi)
    with pytest.raises(ValueError, match="CUDA"):
        ek.eig_scores_refresh_batched(
            rows, hyp, torch.empty(S, N, H, **meta),
            torch.zeros(S, dtype=torch.int32, device="meta"), pi, pi_xi)
    with pytest.raises(ValueError, match="CUDA"):
        gk.gather_rows_sum_batched(
            torch.empty(C, H, N, **meta),
            torch.zeros(S, H, dtype=torch.int32, device="meta"))


# -- the slice as a whole -----------------------------------------------------

def _port_run(preds, labels, iters, seeds, sequential=False, **hp):
    from coda_tpu_torch.engine import run_seeds_compiled

    def factory(p):
        sel = tcoda.make_coda(p, tcoda.CODAHyperparams(**hp), device="cpu")
        # a selector without its batched form runs seeds one after another
        return dataclasses.replace(sel, batched=None) if sequential else sel

    return run_seeds_compiled(factory, np.asarray(preds), np.asarray(labels),
                              iters=iters, seeds=seeds, device="cpu")


def _assert_same_trajectory(port, ref, seeds):
    for f in TRAJECTORY:
        np.testing.assert_array_equal(np.asarray(getattr(port, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(np.asarray(port.select_prob),
                               np.asarray(ref.select_prob), rtol=0,
                               atol=PROB_ATOL)
    assert np.asarray(port.chosen_idx).shape[0] == seeds


def _twinned(task):
    """The task with every item twice: each score has an exact twin, so
    every round breaks a tie with the seed's own key and the seeds' runs
    differ."""
    return (np.concatenate([task.preds] * 2, axis=1),
            np.concatenate([task.labels] * 2))


@pytest.mark.parametrize("twins", [False, True])
def test_batched_trajectory_matches_vmapped_reference(twins):
    """The port's batched run_seeds_compiled (3 seeds x 10 rounds, synthetic
    (6, 64, 4), and the same task with every item twice) against the
    reference's run_seeds_compiled with eig_backend='pallas' and
    n_parallel=3: its vmap over seeds reaches the batched Pallas refresh
    kernel (interpret mode)."""
    import jax.numpy as jnp

    from coda_tpu.data import make_synthetic_task
    from coda_tpu.engine import run_seeds_compiled
    from coda_tpu.selectors import CODAHyperparams, make_coda

    task = make_synthetic_task(seed=4, H=6, N=64 // (1 + twins), C=4)
    preds, labels = _twinned(task) if twins else (task.preds, task.labels)
    hp = CODAHyperparams(eig_mode="incremental", eig_backend="pallas",
                         n_parallel=3)
    ref = run_seeds_compiled(lambda p: make_coda(p, hp), jnp.asarray(preds),
                             jnp.asarray(labels), iters=10, seeds=3)
    counts = dict(ek.launch_counts)
    port = _port_run(preds, labels, 10, 3, eig_mode="incremental",
                     n_parallel=3)
    assert ek.launch_counts == counts
    _assert_same_trajectory(port, ref, 3)
    np.testing.assert_array_equal(port.regret_at_0.numpy(),
                                  np.asarray(ref.regret_at_0))
    np.testing.assert_array_equal(port.stochastic.numpy(),
                                  np.asarray(ref.stochastic))
    if twins:   # the seeds' tie-breaks differ, and both packages agree
        assert port.stochastic.all()
        assert not torch.equal(port.chosen_idx[0], port.chosen_idx[1])


@pytest.mark.parametrize("knobs", [{}, dict(eig_cache_dtype="bfloat16",
                                            eig_entropy="approx")])
def test_batched_equals_sequential(knobs):
    """Batched and one-after-another runs of the port give the same
    trajectories, on a task whose seeds meet exact ties every round (so
    the per-seed tie-break keys matter)."""
    from coda_tpu_torch.data import make_synthetic_task

    preds, labels = _twinned(make_synthetic_task(3, H=6, N=40, C=3,
                                                 device="cpu"))
    b = _port_run(preds, labels, 12, 4, **knobs)
    q = _port_run(preds, labels, 12, 4, sequential=True, **knobs)
    _assert_same_trajectory(b, q, 4)
    assert torch.equal(b.stochastic, q.stochastic) and b.stochastic.all()
    assert torch.equal(b.regret_at_0, q.regret_at_0)


def test_batched_update_equals_single_replica_updates():
    """One batched round from a batched state equals the single-replica
    select + update on each replica: the same choice and the same next
    state, replica by replica (each with its own class)."""
    from coda_tpu_torch.data import make_synthetic_task

    t = make_synthetic_task(2, H=5, N=48, C=3, device="cpu")
    sel = tcoda.make_coda(t.preds, device="cpu")
    bsel, S = sel.batched, 3
    state = bsel.init(S)
    single = [sel.init() for _ in range(S)]
    fields = [f for f in tcoda.CODAState._fields
              if getattr(state, f) is not None]       # dense: no sparse rows
    for s in range(S):
        for f in fields:
            assert torch.equal(getattr(state, f)[s], getattr(single[s], f)), f
    keys = trandom.split(trandom.PRNGKey(9), S)
    for r in range(3):
        keys = trandom.split(keys, 2)[:, 1]
        res = bsel.select(state, bsel.select_keys(keys))
        labels = t.labels.take(res.idx)
        state = bsel.update(state, res.idx, labels, res.prob)
        b_best, _ = bsel.best(state)
        for s in range(S):
            one = sel.select(single[s], keys[s])
            assert int(one.idx) == int(res.idx[s])
            single[s] = sel.update(single[s], one.idx, labels[s], one.prob)
            assert int(sel.best(single[s])[0]) == int(b_best[s])
    for s in range(S):
        for f in fields:
            torch.testing.assert_close(getattr(state, f)[s],
                                       getattr(single[s], f), rtol=1e-6,
                                       atol=1e-7, msg=f)


def test_fused_has_no_batched_form():
    """eig_refresh='fused' has no seed-batched form (the reference refuses
    it under vmap), so the engine runs its seeds one after another."""
    t = torch.full((3, 20, 2), 0.5)
    assert tcoda.make_coda(t, tcoda.CODAHyperparams(eig_refresh="fused"),
                           device="cpu").batched is None
    assert tcoda.make_coda(t, device="cpu").batched is not None
    assert not tcoda.batches_seeds(tcoda.CODAHyperparams(eig_refresh="fused"))


def test_convert_batched_state_round_trip_then_step():
    """A vmapped reference state (3 replicas, 3 rounds in, eig_backend=
    'pallas') crosses to the port and back bitwise; one batched round in
    each package then gives the same choices and the same next state."""
    import jax

    from coda_tpu.data import make_synthetic_task
    from coda_tpu.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.convert import state_from_numpy, state_to_numpy

    S = 3
    task = make_synthetic_task(seed=4, H=6, N=64, C=4)
    jsel = make_coda(task.preds, CODAHyperparams(
        eig_mode="incremental", eig_backend="pallas", n_parallel=S))
    select = jax.jit(jax.vmap(jsel.select))
    update = jax.jit(jax.vmap(jsel.update))
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    jstate = jax.jit(jax.vmap(jsel.init))(keys)
    for r in range(3):
        keys = jax.vmap(jax.random.split)(keys)[:, 1]
        res = select(jstate, keys)
        jstate = update(jstate, res.idx, task.labels[res.idx], res.prob)
    fields = {k: (None if v is None else np.asarray(v))
              for k, v in jstate._asdict().items()}
    assert fields["pbest_hyp"].shape == (S, 4, 64, 6)
    tstate = state_from_numpy(fields, device="cpu")
    for f, v in state_to_numpy(tstate).items():
        np.testing.assert_array_equal(v, fields[f], err_msg=f)

    keys = jax.vmap(jax.random.split)(keys)[:, 1]
    jres = select(jstate, keys)
    jnext = update(jstate, jres.idx, task.labels[jres.idx], jres.prob)
    bsel = tcoda.make_coda(torch.from_numpy(np.array(task.preds)),
                           device="cpu").batched
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    tres = bsel.select(tstate, bsel.select_keys(tkeys))
    np.testing.assert_array_equal(tres.idx.numpy(), np.asarray(jres.idx))
    labels = torch.from_numpy(np.array(task.labels))
    got = state_to_numpy(bsel.update(tstate, tres.idx,
                                     labels.take(tres.idx), tres.prob))
    for f in ("unlabeled", "dirichlets"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jnext, f)),
                                      err_msg=f)
    for f in ("pi_hat_xi", "pi_hat", "pi_xi_unnorm", "pbest_rows"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jnext, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(got["pbest_hyp"], np.asarray(jnext.pbest_hyp),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["eig_scores_cached"],
                               np.asarray(jnext.eig_scores_cached),
                               **SCORE_TOL)


# -- the CLI --------------------------------------------------------------------

def test_cli_batches_seeds(capsys):
    """--seeds 3 --eig-backend pallas prints three seed lines and takes the
    batched engine, with n_parallel = 3 for the auto tier's budget."""
    from coda_tpu_torch.cli import hyperparams, main, parse_args

    argv = ["--synthetic", "6,60,3", "--iters", "4", "--seeds", "3",
            "--device", "cpu", "--eig-backend", "pallas", "--method", "coda",
            "--no-mlflow"]
    assert hyperparams(parse_args(argv)).n_parallel == 3
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "seeds run as one batch" in out
    for s in range(3):
        assert f"seed {s}: regret@4=" in out
    fused = parse_args(argv + ["--eig-refresh", "fused"])
    assert hyperparams(fused).n_parallel == 1     # one after another
    assert hyperparams(parse_args(argv[:4] + ["--seeds", "1"])).n_parallel \
        == 1


def test_cli_headline_five_seeds_needs_incremental():
    """--synthetic 1000,50000,10 --seeds 5: auto resolves past the
    incremental budget over the five replicas (5 x 4.0 GB > 4 GiB) to the
    factored tier, as the reference does; --eig-mode incremental keeps the
    incremental tier, and so does one seed. Checked through
    resolve_eig_mode, no allocation."""
    from coda_tpu.selectors import CODAHyperparams
    from coda_tpu.selectors.coda import resolve_eig_mode
    from coda_tpu_torch.cli import hyperparams, parse_args

    shape = (1000, 50_000, 10)
    argv = ["--synthetic", ",".join(map(str, shape)), "--seeds", "5"]
    hp = hyperparams(parse_args(argv))
    assert hp.n_parallel == 5 and hp.eig_mode == "auto"
    assert tcoda.resolve_eig_mode(hp, *shape) == "factored" == \
        resolve_eig_mode(CODAHyperparams(n_parallel=5), *shape)
    hp1 = hyperparams(parse_args(argv[:2] + ["--seeds", "1"]))
    assert tcoda.resolve_eig_mode(hp1, *shape) == "incremental"
    hpi = hyperparams(parse_args(argv + ["--eig-mode", "incremental"]))
    assert tcoda.resolve_eig_mode(hpi, *shape) == "incremental"


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,approx", FLAVOURS)
@pytest.mark.parametrize("S,C,N,H", [(3, 10, 1000, 96), (5, 3, 1001, 37)])
def test_batched_kernels_equal_single_kernels_on_card(cuda, dtype, approx, S,
                                                      C, N, H):
    """Kernels 4 and 5 equal kernels 1 and 2 launched per replica, bitwise
    (scores and refreshed cache), and their plain versions within the
    card's score tolerance; each counts one launch."""
    rows, hyp, pi, pi_xi, hyp_t, cls = (torch.from_numpy(a).to(cuda) for a in
                                        _batched_cache(N, S, C, N, H))
    hyp = hyp.to(getattr(torch, dtype))
    tol = dict(rtol=1e-4, atol=4 * H ** 0.5 * 2.0 ** -24 * np.log2(H))
    n4 = ek.flavour("eig_score_batched", hyp.dtype, approx)
    n5 = ek.flavour("eig_refresh_score_batched", hyp.dtype, approx)
    c4, c5 = ek.launch_counts.get(n4, 0), ek.launch_counts.get(n5, 0)
    got = ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi, approx=approx)
    hyp_k, hyp_q, hyp_p = hyp.clone(), hyp.clone(), hyp.clone()
    s_k, _ = ek.eig_scores_refresh_batched(rows, hyp_k, hyp_t, cls, pi, pi_xi,
                                           approx=approx)
    s_p, _ = ek.eig_scores_refresh_batched_plain(rows, hyp_p, hyp_t, cls, pi,
                                                 pi_xi, approx=approx)
    torch.cuda.synchronize()
    assert (ek.launch_counts[n4], ek.launch_counts[n5]) == (c4 + 1, c5 + 1)
    torch.testing.assert_close(got, ek.eig_scores_from_cache_batched(
        rows, hyp, pi, pi_xi, approx=approx), **tol)
    torch.testing.assert_close(s_k, s_p, **tol)
    assert torch.equal(hyp_k, hyp_p)
    for s in range(S):
        assert torch.equal(got[s], ek.eig_scores_cache(
            rows[s], hyp[s], pi[s], pi_xi[s], approx=approx))
        s_1, _ = ek.eig_scores_refresh(rows[s], hyp_q[s], hyp_t[s], cls[s],
                                       pi[s], pi_xi[s], approx=approx)
        assert torch.equal(s_k[s], s_1)
    torch.cuda.synchronize()
    assert torch.equal(hyp_k, hyp_q)
    # an out-of-range class: NaN scores for that replica only, no write
    bad = cls.clone()
    bad[0] = C
    before = hyp_k.clone()
    s_bad, _ = ek.eig_scores_refresh_batched(rows, hyp_k, hyp_t, bad, pi,
                                             pi_xi, approx=approx)
    torch.cuda.synchronize()
    assert torch.isnan(s_bad[0]).all() and not torch.isnan(s_bad[1:]).any()
    assert torch.equal(hyp_k[0], before[0])


@pytest.mark.gpu
@pytest.mark.parametrize("S,C,H,N", [(5, 10, 100, 5000), (3, 3, 37, 1001)])
def test_batched_gather_equals_single_gather_on_card(cuda, S, C, H, N):
    rng = np.random.default_rng(N)
    pbc = torch.from_numpy(rng.uniform(0, 1, (C, H, N)).astype(
        np.float32)).to(cuda)
    s = torch.from_numpy(rng.integers(0, C, (S, H)).astype(np.int32)).to(cuda)
    n0 = gk.launch_counts["row_gather_batched"]
    got = gk.gather_rows_sum_batched(pbc, s)
    assert gk.launch_counts["row_gather_batched"] == n0 + 1
    for r in range(S):
        assert torch.equal(got[r], gk.gather_rows_sum(pbc, s[r]))
    torch.testing.assert_close(got, gk.gather_rows_sum_batched_plain(pbc, s),
                               rtol=H * 2.0 ** -24, atol=0)
    bad = s.clone()
    bad[1, 0] = C
    out = gk.gather_rows_sum_batched(pbc, bad)
    assert torch.isnan(out[1]).all() and not torch.isnan(out[0]).any()
