"""The port's host-side building blocks against the JAX reference, on the
CPU: RNG bits, the synthetic task and file loading, losses, and the ops of
the P(best) chain. Inputs are made from numpy seeds and handed to both
packages as numpy arrays.

Tolerances: bitwise for the RNG and the synthetic task (same integer and
numpy arithmetic); rtol 1e-5 for the fp32 ops (same math, other reduction
order and other lgamma/log implementations); 1e-6 for ``log2_approx``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coda_tpu_torch import random as trandom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _beta_params(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 6.0, size=shape).astype(np.float32)
    b = rng.uniform(0.5, 6.0, size=shape).astype(np.float32)
    return a, b


def _dirichlets(seed, H, C):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 2.0, size=(H, C, C)).astype(np.float32)
            + 2.0 * np.eye(C, dtype=np.float32))


# -- random ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2**31 - 1, -3])
def test_random_bits_match_jax(seed):
    """PRNGKey / split / uniform: identical bits to jax.random with
    partitionable threefry (as coda_tpu turns it on)."""
    import coda_tpu  # noqa: F401 — sets jax_threefry_partitionable

    assert jax.config.jax_threefry_partitionable
    kj, kt = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(kj).astype(np.int64),
                                  kt.numpy())
    for n in (2, 3, 20):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(kj, n)).astype(np.int64),
            trandom.split(kt, n).numpy())
    for shape in ((1,), (13,), (300,), (4, 6)):
        uj = np.asarray(jax.random.uniform(kj, shape))
        ut = trandom.uniform(kt, shape).numpy()
        assert ut.dtype == np.float32 and ut.shape == uj.shape
        np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))
    # a chained schedule, as the engine walks it
    kj2 = jax.random.split(jax.random.split(kj, 3)[2], 5)[4]
    kt2 = trandom.split(trandom.split(kt, 3)[2], 5)[4]
    np.testing.assert_array_equal(np.asarray(kj2).astype(np.int64),
                                  kt2.numpy())


# -- data, losses, oracle ----------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 200, 4), (5, 48, 4), (3, 17, 2)])
def test_synthetic_task_bitwise(shape):
    from coda_tpu.data import make_synthetic_task as jtask
    from coda_tpu_torch.data import make_synthetic_task

    H, N, C = shape
    tj = jtask(3, H=H, N=N, C=C)
    tt = make_synthetic_task(3, H=H, N=N, C=C, device="cpu")
    assert tt.name == tj.name and tt.shape == tj.shape
    np.testing.assert_array_equal(tt.preds.numpy(), np.asarray(tj.preds))
    np.testing.assert_array_equal(tt.labels.numpy(), np.asarray(tj.labels))
    assert tt.preds.dtype == torch.float32
    assert tt.labels.dtype == torch.int32


def test_dataset_from_file_formats(tmp_path):
    """npz (preds + labels + names), npy + _labels.npy, and .pt files load
    to the same arrays as the reference loader."""
    from coda_tpu.data import Dataset as JDataset
    from coda_tpu_torch.data import Dataset, find_task_file

    rng = np.random.default_rng(0)
    preds = rng.dirichlet(np.ones(3), size=(4, 10)).astype(np.float32)
    labels = rng.integers(0, 3, size=10)
    np.savez(tmp_path / "a.npz", preds=preds, labels=labels,
             classes=np.array(["x", "y", "z"]))
    np.save(tmp_path / "b.npy", preds)
    np.save(tmp_path / "b_labels.npy", labels)
    torch.save(torch.from_numpy(preds), tmp_path / "c.pt")
    torch.save(torch.from_numpy(labels), tmp_path / "c_labels.pt")
    for task in ("a", "b", "c"):
        fp = find_task_file(str(tmp_path), task)
        assert fp is not None and os.path.basename(fp).startswith(task)
        dt = Dataset.from_file(fp, device="cpu")
        dj = JDataset.from_file(fp)
        assert dt.name == dj.name == task
        np.testing.assert_array_equal(dt.preds.numpy(), np.asarray(dj.preds))
        np.testing.assert_array_equal(dt.labels.numpy(),
                                      np.asarray(dj.labels))
        assert dt.labels.dtype == torch.int32
    assert Dataset.from_file(find_task_file(str(tmp_path), "a"),
                             device="cpu").class_names == ["x", "y", "z"]
    assert find_task_file(str(tmp_path), "missing") is None


def test_losses_and_true_losses_match_jax():
    from coda_tpu.losses import LOSS_FNS as JLOSS
    from coda_tpu.oracle import true_losses as jtl
    from coda_tpu_torch.losses import LOSS_FNS
    from coda_tpu_torch.oracle import true_losses

    rng = np.random.default_rng(2)
    preds = rng.dirichlet(np.ones(5), size=(6, 40)).astype(np.float32)
    labels = rng.integers(0, 5, size=40).astype(np.int32)
    onehot = np.eye(5, dtype=np.float32)[labels]
    assert set(LOSS_FNS) == set(JLOSS)
    for name in LOSS_FNS:
        _close(LOSS_FNS[name](_t(preds[1]), _t(labels)),
               JLOSS[name](_j(preds[1]), _j(labels)))
        _close(LOSS_FNS[name](_t(preds[0]), _t(onehot)),
               JLOSS[name](_j(preds[0]), _j(onehot)))
        _close(true_losses(_t(preds), _t(labels), LOSS_FNS[name]),
               jtl(_j(preds), _j(labels), JLOSS[name]))


def test_checks_raise_like_reference(monkeypatch):
    from coda_tpu_torch.utils import checks

    checks.check_finite(torch.ones(3), "ok")
    with pytest.raises(FloatingPointError, match="bad values"):
        checks.check_finite(torch.tensor([1.0, float("nan")]), "x")
    with pytest.raises(FloatingPointError, match="negatives"):
        checks.check_prob(torch.tensor([[1.5, -0.5]]), "p")
    checks.check_prob(torch.tensor([[0.25, 0.75]]), "p")
    bad = torch.tensor([float("inf")])
    checks.debug_check_finite(bad, "off")           # gated off by default
    monkeypatch.setattr(checks, "DEBUG_CHECKS", True)
    with pytest.raises(FloatingPointError):
        checks.debug_check_finite(bad, "on")


# -- beta, pbest --------------------------------------------------------------

def test_beta_ops_match_jax():
    from coda_tpu.ops import beta as jb
    from coda_tpu_torch.ops import beta as tb

    d = _dirichlets(0, 6, 4)
    for pt, pj in zip(tb.dirichlet_to_beta(_t(d)), jb.dirichlet_to_beta(_j(d))):
        _close(pt, pj)
    a, b = _beta_params(1, (5, 1))
    x = np.linspace(0.01, 0.99, 33, dtype=np.float32)
    _close(tb.beta_log_pdf(_t(x), _t(a), _t(b)),
           jb.beta_log_pdf(_j(x), _j(a), _j(b)), atol=1e-5)
    y = np.random.default_rng(3).uniform(0, 2, (3, 40)).astype(np.float32)
    for dim in (-1, 0):
        _close(tb.cumtrapz_uniform(_t(y), 0.1, dim=dim),
               jb.cumtrapz_uniform(_j(y), 0.1, axis=dim))


def test_pbest_grid_matches_jax():
    """The grid is jnp.linspace's formula in float32. XLA folds and
    reassociates that formula differently depending on the program around
    it, so the reference's own grid differs by an ulp between contexts:
    hold the port to one ulp, with the endpoints exact."""
    from coda_tpu.ops.pbest import pbest_grid as jgrid
    from coda_tpu_torch.ops.pbest import pbest_grid

    for G in (256, 64, 7):
        port, ref = pbest_grid(G).numpy(), np.asarray(jgrid(G))
        np.testing.assert_array_max_ulp(port, ref, maxulp=1)
        assert port[0] == ref[0] and port[-1] == ref[-1]


@pytest.mark.parametrize("shape", [(7,), (4, 9), (2, 3, 16)])
def test_compute_pbest_matches_jax(shape):
    from coda_tpu.ops.pbest import compute_pbest as jpb
    from coda_tpu_torch.ops.pbest import compute_pbest

    a, b = _beta_params(4, shape)
    out = compute_pbest(_t(a), _t(b))
    _close(out, jpb(_j(a), _j(b)), atol=1e-7)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_pbest_row_mixture_matches_jax():
    from coda_tpu.ops.pbest import pbest_row_mixture as jmix
    from coda_tpu_torch.ops.pbest import pbest_row_mixture

    d = _dirichlets(5, 9, 4)
    pi = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    _close(pbest_row_mixture(_t(d), _t(pi)), jmix(_j(d), _j(pi)), atol=1e-7)


# -- confusion -----------------------------------------------------------------

def test_confusion_ops_match_jax():
    from coda_tpu.ops import confusion as jc
    from coda_tpu_torch.ops import confusion as tc

    rng = np.random.default_rng(6)
    preds = rng.dirichlet(np.ones(4), size=(5, 60)).astype(np.float32)
    _close(tc.ensemble_preds(_t(preds)), jc.ensemble_preds(_j(preds)))
    ens = np.asarray(jc.ensemble_preds(_j(preds))).argmax(-1)
    for mode in ("hard", "soft"):
        conf_t = tc.create_confusion_matrices(_t(ens), _t(preds), mode=mode)
        conf_j = jc.create_confusion_matrices(_j(ens), _j(preds), mode=mode)
        _close(conf_t, conf_j, atol=1e-7)
        for diag_off in (False, True):
            _close(tc.initialize_dirichlets(conf_t, 0.1, diag_off),
                   jc.initialize_dirichlets(conf_j, 0.1, diag_off))
    with pytest.raises(ValueError):
        tc.create_confusion_matrices(_t(ens), _t(preds), mode="bogus")


# -- masked ------------------------------------------------------------------

def test_log2_approx_and_entropy_match_jax():
    from coda_tpu.ops import masked as jm
    from coda_tpu_torch.ops import masked as tm

    x = np.concatenate([np.geomspace(1e-12, 1.0, 2000),
                        np.random.default_rng(7).uniform(0, 1, 500)]
                       ).astype(np.float32)
    x = np.clip(x, 1e-12, None)
    _close(tm.log2_approx(_t(x)), jm.log2_approx(_j(x)), rtol=0, atol=1e-6)
    # the approximation itself stays within the reference's 1e-5 bound
    assert np.abs(tm.log2_approx(_t(x)).numpy() - np.log2(x)).max() < 1e-5
    p = np.random.default_rng(8).dirichlet(np.ones(30), size=12
                                           ).astype(np.float32)
    for approx in (False, True):
        _close(tm.entropy2(_t(p), approx=approx),
               jm.entropy2(_j(p), approx=approx), atol=1e-6)
        _close(tm.entropy2(_t(p.T), dim=0, approx=approx),
               jm.entropy2(_j(p.T), axis=0, approx=approx), atol=1e-6)


@pytest.mark.parametrize("case", ["unique", "ties", "isclose_ties",
                                  "all_masked_but_one"])
def test_masked_argmax_tiebreak_matches_jax(case):
    """Same index and tie count as the reference for the same key, with
    and without ties — the tie-break draw is the same threefry stream."""
    import coda_tpu  # noqa: F401 — partitionable threefry
    from coda_tpu.ops.masked import masked_argmax_tiebreak as jarg
    from coda_tpu_torch.ops.masked import masked_argmax_tiebreak

    rng = np.random.default_rng(9)
    N = 64
    scores = rng.uniform(0, 1, N).astype(np.float32)
    mask = rng.uniform(0, 1, N) < 0.7
    tol = {}
    if case == "ties":
        scores[mask] = np.float32(0.5)
    elif case == "isclose_ties":
        scores[np.flatnonzero(mask)[:5]] = np.float32(2.0)
        scores[np.flatnonzero(mask)[5:9]] = np.float32(2.0 - 5e-9)
        tol = dict(rtol=1e-8, atol=1e-8)
    elif case == "all_masked_but_one":
        mask[:] = False
        mask[17] = True
    for seed in range(6):
        kj, kt = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
        ij, nj = jarg(kj, _j(scores), _j(mask), **tol)
        it, nt = masked_argmax_tiebreak(kt, _t(scores), _t(mask), **tol)
        assert int(it) == int(ij) and int(nt) == int(nj), (case, seed)


# -- package boundaries ------------------------------------------------------

def test_port_imports_neither_jax_nor_reference():
    """Importing coda_tpu_torch and every submodule leaves no jax* and no
    coda_tpu / coda_tpu.* module in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import coda_tpu_torch\n"
        "for m in pkgutil.walk_packages(coda_tpu_torch.__path__, "
        "'coda_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib')) or n == 'coda_tpu' or "
        "n.startswith('coda_tpu.'))\n"
        "print('IMPORTED', len([n for n in sys.modules if "
        "n.startswith('coda_tpu_torch')]))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n_mods = int(out.stdout.split("IMPORTED")[1].split()[0])
    assert n_mods >= 20


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Without a CUDA device every entry point raises unless the caller
    passes device='cpu' — nothing carries on quietly on the CPU."""
    from coda_tpu_torch import convert, data
    from coda_tpu_torch.cli import main as cli_main
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.selectors import make_coda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.savez(tmp_path / "t.npz",
             preds=np.full((2, 3, 2), 0.5, np.float32), labels=np.zeros(3))
    task = data.make_synthetic_task(0, H=3, N=12, C=2, device="cpu")
    fields = {"dirichlets": np.ones((3, 2, 2))}
    calls = [
        lambda: data.make_synthetic_task(0, H=3, N=12, C=2),
        lambda: data.Dataset.from_file(str(tmp_path / "t.npz")),
        lambda: make_coda(task.preds),
        lambda: run_seeds_compiled(
            lambda p: make_coda(p, device="cpu"), task.preds, task.labels,
            iters=2, seeds=1),
        lambda: convert.state_from_numpy(fields),
        lambda: cli_main(["--synthetic", "3,12,2", "--iters", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the same calls with device='cpu' run
    assert data.make_synthetic_task(0, H=3, N=12, C=2, device="cpu") \
        .preds.device.type == "cpu"
    assert make_coda(task.preds, device="cpu").name == "coda"
