"""The port's headline-speed configuration against the JAX reference:
``eig_refresh='fused'`` (kernel 6), the bfloat16 cache and the approx
entropy, in the kernels' plain versions on the CPU and, marked ``gpu``, in
the CUDA kernels on the card.

The JAX side runs as its own tests run it: the Pallas entries in interpret
mode. JAX is imported inside the tests that compare with it, so on a
machine without JAX the card tests run with
``python -m pytest tests/test_torch_fused.py -m gpu --noconftest``.

Tolerances (each the reference's own for the same comparison):
  * kernel 6's refreshed fp32 row rtol 2e-5, atol 2e-6 and its scores
    rtol 1e-3, atol 2e-5 (``tests/test_pallas_eig.py:408-411``): the three
    products are summed in other orders, and ``exp(S - max S)`` amplifies
    that on near-degenerate Beta rows;
  * a bfloat16 row may differ by one bf16 ulp, and only where the two fp32
    values it was rounded from straddle a rounding boundary;
  * kernels 1 and 2 in the approx and bf16 flavours: scores rtol 1e-4,
    atol 1e-6 (``tests/test_fast_entropy.py:151,173``), the cache bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from coda_tpu_torch.ops import eig_kernels as ek
from coda_tpu_torch.ops.beta import dirichlet_to_beta
from coda_tpu_torch.ops.pbest import compute_pbest
from coda_tpu_torch.selectors import coda as tcoda

FLAVOURS = [("float32", False), ("float32", True), ("bfloat16", False),
            ("bfloat16", True)]


def _simplex(rng, *shape, floor_frac=0.0):
    x = rng.uniform(0.1, 1.1, size=shape).astype(np.float32)
    if floor_frac:  # zero entries: the 1e-12 entropy floor engages
        x[rng.uniform(size=shape) < floor_frac] = 0.0
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _fused_inputs(seed, N, C, H, c):
    """numpy inputs of kernel 6 from a seed: random Dirichlet rows, hard
    predictions, and a cache, pi-hat and P(best) rows with row ``c``
    already refreshed."""
    rng = np.random.default_rng(seed)
    d = (rng.uniform(0, 1, (H, C, C)) * 3 + 0.5).astype(np.float32)
    hard = rng.integers(0, C, (N, H)).astype(np.int32)
    a, b = dirichlet_to_beta(torch.from_numpy(d))
    a_t, b_t = a[:, c].contiguous(), b[:, c].contiguous()
    rows = compute_pbest(a.T, b.T)
    rows[c] = compute_pbest(a_t, b_t)
    hyp, pi_xi = _simplex(rng, C, N, H), _simplex(rng, N, C)
    pi = pi_xi.mean(0)
    return dict(rows=rows.numpy(), hyp=hyp, a_t=a_t.numpy(),
                b_t=b_t.numpy(), hard=hard, pi=(pi / pi.sum()).astype(
                    np.float32), pi_xi=pi_xi)


def _port_fused(inp, c, dtype, approx, device="cpu", plain=False, **kw):
    """Kernel 6's wrapper (or, with ``plain``, its plain version) on a
    fresh copy of the cache at ``dtype``."""
    t = {k: torch.from_numpy(np.array(v)).to(device) for k, v in inp.items()}
    hyp = t["hyp"].to(getattr(torch, dtype))
    fn = (ek.eig_scores_refresh_compute_plain if plain
          else ek.eig_scores_refresh_compute)
    return fn(t["rows"], hyp, t["a_t"], t["b_t"], t["hard"],
              torch.tensor(c, dtype=torch.int32, device=device), t["pi"],
              t["pi_xi"], approx=approx, **kw)


def _jax_fused(inp, c, dtype, approx, block):
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_eig import eig_scores_refresh_compute_pallas

    j = {k: jnp.asarray(v) for k, v in inp.items()}
    s, h = eig_scores_refresh_compute_pallas(
        j["rows"], j["hyp"].astype(dtype), j["a_t"], j["b_t"], j["hard"],
        jnp.int32(c), j["pi"], j["pi_xi"], block=block, interpret=True,
        approx=approx)
    return np.asarray(s), h


def _bf16_bits(x) -> np.ndarray:
    """bf16 values (torch or JAX) as their int16 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _bf16_round_bits(x32: np.ndarray) -> np.ndarray:
    return _bf16_bits(torch.from_numpy(np.array(x32, np.float32)).to(
        torch.bfloat16))


def _assert_bf16_ulp_rule(got_bits, want_bits, got32, want32) -> int:
    """Where two bf16 tensors differ, the difference is one ulp and the two
    fp32 values they were rounded from round differently. Returns the
    number of such boundary elements."""
    differ = got_bits != want_bits
    straddle = _bf16_round_bits(got32) != _bf16_round_bits(want32)
    assert not (differ & ~straddle).any(), "bf16 differs off a boundary"
    gap = np.abs(got_bits.astype(np.int32) - want_bits.astype(np.int32))
    assert (gap[differ] == 1).all(), "bf16 differs by more than one ulp"
    return int(differ.sum())


# -- kernel 6: refresh-compute-score -----------------------------------------

@pytest.mark.parametrize("dtype,approx", FLAVOURS)
def test_refresh_compute_plain_matches_pallas_kernel(dtype, approx):
    """Kernel 6's plain version against the Pallas kernel at (N, C, H) =
    (77, 4, 10) with a ragged final block (77 = 2 x 32 + 13). Row c holds
    the refreshed row at the storage type; every other row is bitwise
    untouched; the update is in place on the tensor passed in."""
    N, C, H, c = 77, 4, 10, 2
    inp = _fused_inputs(3, N, C, H, c)
    s_ref, h_ref = _jax_fused(inp, c, dtype, approx, block=32)
    before = dict(ek.launch_counts)
    t_hyp = torch.from_numpy(inp["hyp"].copy()).to(getattr(torch, dtype))
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    scores, h_out = ek.eig_scores_refresh_compute(
        t["rows"], t_hyp, t["a_t"], t["b_t"], t["hard"], torch.tensor(c),
        t["pi"], t["pi_xi"], approx=approx)
    assert h_out is t_hyp and h_out.dtype == getattr(torch, dtype)
    assert ek.launch_counts == before      # the CPU takes the plain version
    np.testing.assert_allclose(scores.numpy(), s_ref, rtol=1e-3, atol=2e-5)
    others = [i for i in range(C) if i != c]
    if dtype == "float32":
        got, want = h_out.numpy(), np.asarray(h_ref)
        np.testing.assert_allclose(got[c], want[c], rtol=2e-5, atol=2e-6)
        np.testing.assert_array_equal(got[others], inp["hyp"][others])
        np.testing.assert_array_equal(want[others], inp["hyp"][others])
        return
    got_bits, want_bits = _bf16_bits(h_out), _bf16_bits(h_ref)
    np.testing.assert_array_equal(got_bits[others], want_bits[others])
    np.testing.assert_array_equal(
        got_bits[others], _bf16_round_bits(inp["hyp"][others]))
    # the fp32 rows both sides rounded: the same call with an fp32 cache
    _, h32_ref = _jax_fused(inp, c, "float32", approx, block=32)
    _, h32 = _port_fused(inp, c, "float32", approx)
    n_boundary = _assert_bf16_ulp_rule(got_bits[c], want_bits[c],
                                       h32[c].numpy(), np.asarray(h32_ref)[c])
    # measured: 0 of the 770 elements straddle a boundary here (jax 0.9.0,
    # torch 2.13 on the CPU)
    assert n_boundary <= 2, n_boundary


def test_refresh_compute_plain_equals_precomputed_refresh():
    """The plain version is the precomputed path's arithmetic: the same
    tables and products, then kernel 2's plain version — bitwise."""
    N, C, H, c = 50, 3, 7, 1
    inp = _fused_inputs(9, N, C, H, c)
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    s_f, h_f = _port_fused(inp, c, "float32", False)
    hyp_t = tcoda._pbest_hyp_row(t["a_t"], t["b_t"], t["hard"] == c, 1.0, 256)
    s_p, h_p = ek.eig_scores_refresh_plain(
        t["rows"], t["hyp"].clone(), hyp_t, torch.tensor(c), t["pi"],
        t["pi_xi"])
    assert torch.equal(s_f, s_p) and torch.equal(h_f, h_p)


# -- kernels 1 and 2: the bf16 and approx flavours ---------------------------

def _cache_inputs(seed, N, C, H):
    rng = np.random.default_rng(seed)
    rows, hyp = _simplex(rng, C, H), _simplex(rng, C, N, H, floor_frac=0.2)
    pi_xi, hyp_t = _simplex(rng, N, C), _simplex(rng, N, H)
    pi = pi_xi.mean(0)
    return rows, hyp, (pi / pi.sum()).astype(np.float32), pi_xi, hyp_t


@pytest.mark.parametrize("dtype,approx", FLAVOURS[1:])
@pytest.mark.parametrize("N,C,H,blk,c", [(300, 5, 12, 64, 4),
                                         (77, 4, 9, 32, 0)])
def test_score_and_refresh_flavours_match_pallas(dtype, approx, N, C, H, blk,
                                                 c):
    import jax.numpy as jnp

    from coda_tpu.ops.pallas_eig import (
        eig_scores_cache_pallas,
        eig_scores_refresh_pallas,
    )

    rows, hyp, pi, pi_xi, hyp_t = _cache_inputs(N + H + c, N, C, H)
    j = [jnp.asarray(a) for a in (rows, hyp, pi, pi_xi, hyp_t)]
    jhyp = j[1].astype(dtype)
    t = [torch.from_numpy(a.copy()) for a in (rows, hyp, pi, pi_xi, hyp_t)]
    thyp = t[1].to(getattr(torch, dtype))

    ref = np.asarray(eig_scores_cache_pallas(
        j[0], jhyp, j[2], j[3], block=blk, interpret=True, approx=approx))
    got = ek.eig_scores_cache(t[0], thyp, t[2], t[3], chunk=blk,
                              approx=approx)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)

    s_ref, h_ref = eig_scores_refresh_pallas(
        j[0], jhyp, j[4], jnp.int32(c), j[2], j[3], block=blk,
        interpret=True, approx=approx)
    s, h = ek.eig_scores_refresh(t[0], thyp, t[4], torch.tensor(c), t[2],
                                 t[3], chunk=blk, approx=approx)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-4,
                               atol=1e-6)
    assert h is thyp and h.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_bf16_bits(h), _bf16_bits(h_ref))
    else:
        np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))


def test_mixture_stats_approx_matches_reference():
    from coda_tpu.ops.pallas_eig import _mixture_stats

    import jax.numpy as jnp

    rows, _, pi, _, _ = _cache_inputs(5, 4, 6, 20)
    m_ref, h_ref = _mixture_stats(jnp.asarray(rows), jnp.asarray(pi),
                                  approx=True)
    m, h = ek.mixture_stats(torch.from_numpy(rows), torch.from_numpy(pi),
                            approx=True)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref)[0, 0], rtol=1e-6)
    np.testing.assert_allclose(float(h), float(np.asarray(h_ref)[0, 0]),
                               rtol=1e-6)
    from coda_tpu_torch.ops.masked import entropy2

    assert torch.equal(h, entropy2(m, approx=True))  # h_before's flavour


# -- the selector's scoring chain --------------------------------------------

def test_build_eig_cache_bf16_matches_reference():
    import jax.numpy as jnp

    from coda_tpu.selectors import coda as jcoda

    rng = np.random.default_rng(12)
    H, N, C = 7, 90, 4
    d = (rng.uniform(0.05, 1.0, (H, C, C)) + 2 * np.eye(C)).astype(np.float32)
    hard = rng.integers(0, C, (N, H)).astype(np.int32)
    rows_j, hyp_j = jcoda.build_eig_cache(jnp.asarray(d), jnp.asarray(hard),
                                          chunk=32,
                                          cache_dtype=jnp.bfloat16)
    _, hyp32_j = jcoda.build_eig_cache(jnp.asarray(d), jnp.asarray(hard),
                                       chunk=32)
    rows_t, hyp_t = tcoda.build_eig_cache(torch.from_numpy(d),
                                          torch.from_numpy(hard), chunk=32,
                                          cache_dtype=torch.bfloat16)
    _, hyp32_t = tcoda.build_eig_cache(torch.from_numpy(d),
                                       torch.from_numpy(hard), chunk=32)
    assert hyp_t.dtype == torch.bfloat16 and rows_t.dtype == torch.float32
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), rtol=1e-5,
                               atol=1e-7)
    # the storage is the fp32 cache rounded to nearest even
    np.testing.assert_array_equal(_bf16_bits(hyp_t),
                                  _bf16_round_bits(hyp32_t.numpy()))
    n = _assert_bf16_ulp_rule(_bf16_bits(hyp_t), _bf16_bits(hyp_j),
                              hyp32_t.numpy(), np.asarray(hyp32_j))
    # measured: 0 of the 2520 elements straddle a boundary here
    assert n <= 4, n


def test_resolve_eig_mode_charges_the_cache_itemsize():
    """A shape whose fp32 cache is past the incremental tier's budget but
    whose bf16 cache fits: both packages keep bf16 incremental, and both
    take the factored tier for the fp32 cache."""
    from coda_tpu.selectors import CODAHyperparams
    from coda_tpu.selectors.coda import resolve_eig_mode

    H, N, C = 1000, 60_000, 10
    hp16 = tcoda.CODAHyperparams(eig_cache_dtype="bfloat16")
    assert tcoda.resolve_eig_mode(hp16, H, N, C) == "incremental"
    assert resolve_eig_mode(CODAHyperparams(eig_cache_dtype="bfloat16"),
                            H, N, C) == "incremental"
    assert resolve_eig_mode(CODAHyperparams(), H, N, C) == "factored"
    assert tcoda.resolve_eig_mode(tcoda.CODAHyperparams(), H, N, C) == \
        "factored"


# -- whole trajectories ------------------------------------------------------

def _port_run(preds, labels, iters, **hp):
    from coda_tpu_torch.engine import run_seeds_compiled

    return run_seeds_compiled(
        lambda p: tcoda.make_coda(p, tcoda.CODAHyperparams(**hp),
                                  device="cpu"),
        np.asarray(preds), np.asarray(labels), iters=iters, seeds=1,
        device="cpu")


def test_fused_bf16_trajectory_matches_reference():
    """fused + bf16 on the CPU against the reference's Pallas kernels in
    interpret mode, 10 rounds."""
    from coda_tpu.data import make_synthetic_task
    from coda_tpu.engine import run_experiment
    from coda_tpu.selectors import CODAHyperparams, make_coda

    task = make_synthetic_task(seed=4, H=6, N=64, C=4)
    ref = run_experiment(make_coda(task.preds, CODAHyperparams(
        eig_mode="incremental", eig_backend="pallas", eig_refresh="fused",
        eig_cache_dtype="bfloat16")), task, iters=10, seed=0)
    port = _port_run(task.preds, task.labels, 10, eig_refresh="fused",
                     eig_cache_dtype="bfloat16")
    for f in ("chosen_idx", "true_class", "best_model", "regret"):
        np.testing.assert_array_equal(getattr(port, f)[0].numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_fused_trajectory_matches_reference_default_on_digits():
    """The port's fused path against the reference's default (jnp,
    precomputed) path on the real digits task, 30 rounds — the port's
    counterpart of ``test_fused_compute_refresh_real_data_trace``."""
    from coda_tpu.data import Dataset
    from coda_tpu.engine import run_experiment
    from coda_tpu.selectors import CODAHyperparams, make_coda

    ds = Dataset.from_file("data/digits.npz")
    ref = run_experiment(make_coda(ds.preds, CODAHyperparams(
        eig_mode="incremental")), ds, iters=30, seed=0)
    port = _port_run(ds.preds, ds.labels, 30, eig_refresh="fused")
    for f in ("chosen_idx", "true_class", "best_model", "regret"):
        np.testing.assert_array_equal(getattr(port, f)[0].numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_convert_bf16_state_then_fused_step_matches_reference():
    """A reference mid-run state with a bf16 cache crosses to the port
    bitwise (through an int16 view) and back; one fused round in each
    package then gives the same choice and the same next state."""
    import jax

    from coda_tpu.data import make_synthetic_task
    from coda_tpu.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.convert import state_from_numpy, state_to_numpy

    task = make_synthetic_task(seed=4, H=6, N=64, C=4)
    jsel = make_coda(task.preds, CODAHyperparams(
        eig_mode="incremental", eig_backend="pallas", eig_refresh="fused",
        eig_cache_dtype="bfloat16"))
    select, update = jax.jit(jsel.select), jax.jit(jsel.update)
    jstate = jax.jit(jsel.init)(jax.random.PRNGKey(0))
    for r in range(3):
        res = select(jstate, jax.random.PRNGKey(100 + r))
        jstate = update(jstate, res.idx, task.labels[res.idx], res.prob)
    fields = {k: (None if v is None else np.asarray(v))
              for k, v in jstate._asdict().items()}
    assert fields["pbest_hyp"].dtype.name == "bfloat16"
    tstate = state_from_numpy(fields, device="cpu")
    assert tstate.pbest_hyp.dtype == torch.bfloat16
    back = state_to_numpy(tstate)
    assert back["pbest_hyp"].dtype == fields["pbest_hyp"].dtype
    for f, v in back.items():
        np.testing.assert_array_equal(v.view(np.int16) if f == "pbest_hyp"
                                      else v, fields[f].view(np.int16)
                                      if f == "pbest_hyp" else fields[f])

    key = jax.random.PRNGKey(77)
    jres = select(jstate, key)
    jnext = update(jstate, jres.idx, task.labels[jres.idx], jres.prob)
    tsel = tcoda.make_coda(torch.from_numpy(np.array(task.preds)),
                           tcoda.CODAHyperparams(eig_refresh="fused",
                                                 eig_cache_dtype="bfloat16"),
                           device="cpu")
    tres = tsel.select(tstate, trandom.PRNGKey(77))
    assert int(tres.idx) == int(jres.idx)
    labels = torch.from_numpy(np.array(task.labels))
    got = state_to_numpy(tsel.update(tstate, tres.idx, labels.take(tres.idx),
                                     tres.prob))
    np.testing.assert_array_equal(got["dirichlets"],
                                  np.asarray(jnext.dirichlets))
    for f in ("pi_hat_xi", "pi_hat", "pi_xi_unnorm", "pbest_rows"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jnext, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    h_got = got["pbest_hyp"].astype(np.float32)
    h_want = np.asarray(jnext.pbest_hyp).astype(np.float32)
    # one bf16 ulp (2^-8 relative) where the two fp32 rows straddle a
    # rounding boundary; equal elsewhere
    np.testing.assert_allclose(h_got, h_want, rtol=2.0 ** -8, atol=0)
    np.testing.assert_allclose(got["eig_scores_cached"],
                               np.asarray(jnext.eig_scores_cached),
                               rtol=1e-3, atol=2e-5)


# -- guards ------------------------------------------------------------------

def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("kw", [
    dict(eig_refresh="Fused"), dict(eig_cache_dtype="float16"),
    dict(eig_entropy="fast"), dict(eig_refresh="fused", n_parallel=4),
    dict(eig_refresh="fused", eig_pbest="amortized")])
def test_guards_raise_the_reference_value_errors(kw):
    """The port refuses what the reference refuses, with the reference's
    text (up to the backend name the reference quotes: the port's
    backends are auto and plain)."""
    from coda_tpu.data import make_synthetic_task
    from coda_tpu.selectors import CODAHyperparams, make_coda

    t = make_synthetic_task(seed=1, H=4, N=32, C=4)
    ref = _message(lambda: make_coda(t.preds, CODAHyperparams(
        eig_backend="pallas", **kw)))
    got = _message(lambda: tcoda.make_coda(
        torch.from_numpy(np.array(t.preds)), tcoda.CODAHyperparams(**kw),
        device="cpu"))
    assert got.replace("'auto'", "'pallas'") == ref


def test_fused_refuses_shard_spec():
    preds = torch.full((3, 20, 2), 0.5)
    with pytest.raises(ValueError, match="neither shard_spec nor vmapped"):
        tcoda.make_coda(preds, tcoda.CODAHyperparams(
            eig_refresh="fused", shard_spec="data=2"), device="cpu")


def test_cli_takes_the_reference_headline_flags(capsys):
    """The reference's headline command line runs unchanged, seeds > 1
    included (the port runs seeds one after another)."""
    from coda_tpu_torch.cli import main, parse_args

    argv = ["--synthetic", "6,60,3", "--iters", "4", "--seeds", "2",
            "--device", "cpu", "--eig-backend", "pallas", "--eig-refresh",
            "fused", "--eig-cache-dtype", "bfloat16", "--eig-entropy",
            "approx", "--no-mlflow"]
    args = parse_args(argv)
    assert (args.eig_refresh, args.eig_cache_dtype, args.eig_entropy) == (
        "fused", "bfloat16", "approx")
    assert main(argv) == 0
    out = capsys.readouterr().out
    for s in range(2):
        assert f"seed {s}: regret@4=" in out
    d = parse_args([])
    assert (d.eig_backend, d.eig_refresh, d.eig_cache_dtype,
            d.eig_entropy) == ("auto", "precomputed", "float32", "exact")


def test_refresh_compute_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    routed to the plain version."""
    C, N, H = 3, 16, 8
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ek.eig_scores_refresh_compute(
            torch.empty(C, H, **meta), torch.empty(C, N, H, **meta),
            torch.empty(H, **meta), torch.empty(H, **meta),
            torch.empty(N, H, device="meta", dtype=torch.int32),
            torch.zeros((), dtype=torch.int32, device="meta"),
            torch.empty(C, **meta), torch.empty(N, C, **meta))


def test_flavour_names():
    assert ek.flavour("eig_score", torch.float32, False) == "eig_score"
    assert ek.flavour("eig_score", torch.bfloat16, True) == \
        "eig_score[bfloat16,approx]"
    assert ek.flavour("eig_refresh_score", torch.float32, True) == \
        "eig_refresh_score[approx]"


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _score_tol(H):
    # two fp32 summation orders of an H-term entropy differ by about
    # sqrt(H) ulps of log2(H): the card's tolerance scales with H
    return dict(rtol=1e-4, atol=4 * H ** 0.5 * 2.0 ** -24 * np.log2(H))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,approx", FLAVOURS)
@pytest.mark.parametrize("N,C,H,G", [(1000, 10, 100, 256), (1001, 3, 37, 256),
                                     (77, 4, 10, 50),
                                     # H past one 128-model chunk, ragged
                                     (640, 10, 300, 256),
                                     # N past two 64-item tiles, ragged
                                     (130, 5, 256, 256),
                                     # G past one 256-point pass of S
                                     (200, 3, 40, 300)])
def test_refresh_compute_kernel_matches_plain_on_card(cuda, dtype, approx, N,
                                                      C, H, G):
    c = C - 1
    inp = _fused_inputs(N + H, N, C, H, c)
    name = ek.flavour("eig_refresh_compute_score", getattr(torch, dtype),
                      approx)
    n0 = ek.launch_counts.get(name, 0)
    s_k, h_k = _port_fused(inp, c, dtype, approx, device=cuda, num_points=G)
    s_p, h_p = _port_fused(inp, c, dtype, approx, device=cuda, plain=True,
                           num_points=G)
    torch.cuda.synchronize()
    assert ek.launch_counts[name] == n0 + 1
    torch.testing.assert_close(s_k, s_p, rtol=1e-3, atol=2e-5)
    others = [i for i in range(C) if i != c]
    assert torch.equal(h_k[others], h_p[others])
    if dtype == "float32":
        torch.testing.assert_close(h_k[c], h_p[c], rtol=2e-5, atol=2e-6)
    else:
        # the fp32 rows each side rounded
        _, h32_k = _port_fused(inp, c, "float32", approx, device=cuda,
                               num_points=G)
        _, h32_p = _port_fused(inp, c, "float32", approx, device=cuda,
                               plain=True, num_points=G)
        _assert_bf16_ulp_rule(_bf16_bits(h_k[c].cpu()),
                              _bf16_bits(h_p[c].cpu()),
                              h32_k[c].cpu().numpy(), h32_p[c].cpu().numpy())
    # an out-of-range class gives NaN scores and writes nothing
    t = {k: torch.from_numpy(np.array(v)).to(cuda) for k, v in inp.items()}
    before = h_k.clone()
    bad, _ = ek.eig_scores_refresh_compute(
        t["rows"], h_k, t["a_t"], t["b_t"], t["hard"],
        torch.tensor(C, dtype=torch.int32, device=cuda), t["pi"], t["pi_xi"],
        num_points=G)
    torch.cuda.synchronize()
    assert torch.isnan(bad).all() and torch.equal(h_k, before)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,approx", FLAVOURS)
@pytest.mark.parametrize("N,C,H", [(1000, 10, 96), (1001, 3, 37)])
def test_score_kernel_flavours_match_plain_on_card(cuda, dtype, approx, N, C,
                                                   H):
    rows, hyp, pi, pi_xi, hyp_t = (torch.from_numpy(a).to(cuda) for a in
                                   _cache_inputs(N, N, C, H))
    hyp = hyp.to(getattr(torch, dtype))
    tol = _score_tol(H)
    got = ek.eig_scores_cache(rows, hyp, pi, pi_xi, approx=approx)
    want = ek.eig_scores_from_cache(rows, hyp, pi, pi_xi, approx=approx)
    torch.testing.assert_close(got, want, **tol)
    c = torch.tensor(C - 1, dtype=torch.int32, device=cuda)
    hyp_k, hyp_p = hyp.clone(), hyp.clone()
    s_k, _ = ek.eig_scores_refresh(rows, hyp_k, hyp_t, c, pi, pi_xi,
                                   approx=approx)
    s_p, _ = ek.eig_scores_refresh_plain(rows, hyp_p, hyp_t, c, pi, pi_xi,
                                         approx=approx)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k, s_p, **tol)
    assert torch.equal(hyp_k, hyp_p)     # the same round-to-nearest-even


@pytest.mark.gpu
def test_refresh_compute_refuses_models_past_shared_memory(cuda):
    """The row kernel keeps only the eq bitmask of its 64 items in shared
    memory per model, so H = 4000 (past the first design's limit of about
    3,300) runs and matches the plain version; a model count whose block
    would pass the opt-in shared-memory limit (16,224 at G = 256) is still
    refused before launch, naming the limit and the largest H."""
    C, N, H, c = 3, 40, 4000, 1
    inp = _fused_inputs(5, N, C, H, c)
    s_k, h_k = _port_fused(inp, c, "float32", False, device=cuda)
    s_p, h_p = _port_fused(inp, c, "float32", False, device=cuda, plain=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k, s_p, rtol=1e-3, atol=2e-5)
    torch.testing.assert_close(h_k[c], h_p[c], rtol=2e-5, atol=2e-5 / H)
    h_max = ek.refresh_compute_layout(C, H)["max_models"]
    assert h_max >= 16_000
    assert ek.refresh_compute_layout(C, h_max)["smem_bytes"] <= 232_448 < \
        ek.refresh_compute_layout(C, h_max + 1)["smem_bytes"]
    inp = _fused_inputs(5, 4, C, h_max + 1, c)
    with pytest.raises(ValueError, match=f"232448.*H up to {h_max}"):
        _port_fused(inp, c, "float32", False, device=cuda)
