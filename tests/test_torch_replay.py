"""Re-executing flight-recorder records: the port's ``replay`` against its
own records and the reference's (mirrors the replay half of
``tests/test_recorder.py``).

* A port record of each of the six methods replays on the port at PARITY,
  bitwise (the auto tolerance is 0.0 on the recording's backend), through
  ``python -m coda_tpu_torch.cli replay`` (exit 0).
* A tampered record (one ``chosen_idx`` changed) exits 2, DIVERGED at the
  tampered round as a ``tie-break-flip`` (the decision moved, the scores
  did not).
* A dataset digest mismatch raises unless ``--allow-digest-mismatch``;
  ``--seed``, ``--set`` and ``--out`` work.
* Across packages (the reference in JAX on the CPU): a port record
  re-executed by the reference's ``verify_replay``, a fresh reference
  record re-executed by the port's, and the committed
  ``runs/surrogate_r17/exact`` (digits, 3 seeds x 100) re-executed by the
  port give PARITY at the cross-backend contract (2.34e-4) or
  ``tie-break-flip``s where the recorded runner-up gap is at most
  2.34e-4.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from coda_tpu_torch.engine import replay as treplay
from coda_tpu_torch.telemetry import recorder as trec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("coda", "iid", "uncertainty", "activetesting", "vma",
           "model_picker")
TOL = trec.CROSS_BACKEND_SCORE_TOL
SHAPE = "6,60,3"
ITERS, SEEDS = 6, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_cli(argv):
    from coda_tpu_torch.cli import main

    return main(argv)


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    """A port record of each method (synthetic task, 3 seeds; CODA's seeds
    as one batch, the baselines' one after another)."""
    root = tmp_path_factory.mktemp("port_rec")
    out = {}
    for m in METHODS:
        d = str(root / m)
        assert _port_cli(["--synthetic", SHAPE, "--method", m, "--iters",
                          str(ITERS), "--seeds", str(SEEDS), "--device",
                          "cpu", "--no-mlflow", "--record-dir", d]) == 0
        out[m] = d
    return out


def _hold_cross(report, record):
    """Parity, or a first divergence that is a tie-break flip at a recorded
    runner-up gap of at most the contract."""
    for s in report.seeds:
        if s.parity:
            continue
        gap = float(record.arrays["runner_up_gap"][
            s.seed, s.first_divergent_round])
        assert s.classification == "tie-break-flip", s.to_dict()
        assert abs(gap) <= TOL, (s.to_dict(), gap)


@pytest.mark.parametrize("method", METHODS)
def test_port_record_replays_bitwise(method, port_records):
    d = port_records[method]
    rec = trec.RunRecord.load(d)
    assert rec.meta["fingerprint"]["backend"] == "torch-cpu"
    assert treplay._auto_tol(rec, {}, device="cpu") == 0.0
    assert _port_cli(["replay", d, "--device", "cpu"]) == 0
    ds, factory, args = treplay.load_record_environment(rec, device="cpu")
    report = treplay.verify_replay(rec, factory, ds.preds, ds.labels,
                                   loss=args.loss, score_tol=0.0,
                                   device="cpu")
    assert report.parity and report.score_tol == 0.0
    assert [s.quantities["rounds_compared"] for s in report.seeds] == \
        [ITERS] * SEEDS


@pytest.mark.parametrize("method", METHODS)
def test_port_tampered_record_diverges(method, port_records, tmp_path):
    rec = trec.RunRecord.load(port_records[method])
    t = 2
    ci = rec.arrays["chosen_idx"]
    ci[1, t] = (ci[1, t] + 1) % 60
    d = str(tmp_path / "tampered")
    rec.save(d)
    out = str(tmp_path / "report.json")
    assert _port_cli(["replay", d, "--device", "cpu", "--out", out]) == 2
    with open(out) as f:
        report = json.load(f)
    assert report["seeds"][0]["parity"] and report["seeds"][2]["parity"]
    bad = report["seeds"][1]
    assert not bad["parity"] and bad["first_divergent_round"] == t
    assert (bad["quantity"], bad["classification"]) == (
        "chosen_idx", "tie-break-flip")


def test_port_replay_digest_guard(port_records, tmp_path):
    rec = trec.RunRecord.load(port_records["iid"])
    rec.meta["fingerprint"]["dataset"]["digest"] = "0" * 16
    d = str(tmp_path / "other_data")
    rec.save(d)
    with pytest.raises(ValueError, match="digest mismatch"):
        _port_cli(["replay", d, "--device", "cpu"])
    assert _port_cli(["replay", d, "--device", "cpu",
                      "--allow-digest-mismatch"]) == 0


def test_port_replay_seed_set_and_out(port_records, tmp_path, capsys):
    d = port_records["coda"]
    out = str(tmp_path / "r.json")
    assert _port_cli(["replay", d, "--device", "cpu", "--seed", "1",
                      "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert [s["seed"] for s in report["seeds"]] == [1]
    assert report["score_tol"] == 0.0 and report["mode"] == "replay"
    # an override is another program: the auto tolerance is the contract
    rc = _port_cli(["replay", d, "--device", "cpu", "--set",
                    "eig_entropy=approx", "--out", out])
    with open(out) as f:
        report = json.load(f)
    assert report["score_tol"] == TOL
    assert rc == (0 if report["parity"] else 2)
    assert treplay._parse_overrides(["a=1", "b=0.5", "c=true", "d=x"]) == \
        {"a": 1, "b": 0.5, "c": True, "d": "x"}
    with pytest.raises(SystemExit):
        treplay._parse_overrides(["novalue"])
    # --against compares two records without re-executing
    assert _port_cli(["replay", d, "--against", d]) == 0
    assert "contract: bitwise" in capsys.readouterr().out


def test_port_replay_refuses_other_programs(port_records, tmp_path):
    """A crowd-oracle record re-executes the crowd program from its knobs
    (a spec the crowd cannot parse raises its error); a mesh knob names
    the N-axis parallel part of slice 5; on a machine without a card the
    default device raises (no fallback to the CPU)."""
    rec = trec.RunRecord.load(port_records["coda"])
    noisy = trec.RunRecord(json.loads(json.dumps(rec.meta)), rec.arrays)
    noisy.meta["fingerprint"]["knobs"]["oracle_noise"] = "flip:0.2"
    treplay.load_record_environment(noisy, device="cpu")
    with pytest.raises(ValueError, match="not key=value"):
        treplay.record_crowd_config(noisy)
    noisy.meta["fingerprint"]["knobs"].update(
        oracle_noise="annotators=4,votes=3", oracle_reliability="majority")
    cfg = treplay.record_crowd_config(noisy)
    assert (cfg.annotators, cfg.votes, cfg.reliability) == (4, 3,
                                                            "majority")
    assert treplay.record_crowd_config(rec) is None
    meshed = trec.RunRecord(json.loads(json.dumps(rec.meta)), rec.arrays)
    meshed.meta["fingerprint"]["knobs"]["mesh"] = "data=2"
    ds, factory, _ = treplay.load_record_environment(meshed, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="N-axis parallel part of slice 5"):
        factory(ds.preds)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _port_cli(["replay", port_records["coda"]])


@pytest.mark.parametrize("method", METHODS)
def test_reference_replays_a_port_record(method, port_records):
    """The reference's ``verify_replay`` re-executes a port record (its
    knobs rebuild the reference's selector) at the contract."""
    from coda_tpu.engine import replay as jreplay
    from coda_tpu.telemetry.recorder import RunRecord

    rec = RunRecord.load(port_records[method])
    tol = jreplay._auto_tol(rec, {})
    assert tol == TOL          # torch-cpu is not the reference's backend
    ds, factory, args = jreplay.load_record_environment(rec)
    report = jreplay.verify_replay(rec, factory, ds.preds, ds.labels,
                                   loss=args.loss, score_tol=tol)
    _hold_cross(report, rec)


@pytest.fixture(scope="module")
def reference_records(tmp_path_factory):
    """A fresh reference record of each method (the reference CLI on the
    CPU, the same task and run as the port's)."""
    from coda_tpu import cli as jcli

    root = tmp_path_factory.mktemp("ref_rec")
    out = {}
    for m in METHODS:
        d = str(root / m)
        jcli.main(["--synthetic", SHAPE, "--method", m, "--iters",
                   str(ITERS), "--seeds", str(SEEDS), "--platform", "cpu",
                   "--no-mlflow", "--record-dir", d])
        out[m] = d
    return out


@pytest.mark.parametrize("method", METHODS)
def test_port_replays_a_reference_record(method, reference_records):
    d = reference_records[method]
    rec = trec.RunRecord.load(d)
    assert rec.meta["fingerprint"]["backend"] == "cpu"
    tol = treplay._auto_tol(rec, {}, device="cpu")
    assert tol == TOL
    ds, factory, args = treplay.load_record_environment(rec, device="cpu")
    report = treplay.verify_replay(rec, factory, ds.preds, ds.labels,
                                   loss=args.loss, score_tol=tol,
                                   device="cpu")
    _hold_cross(report, rec)
    assert _port_cli(["replay", d, "--device", "cpu"]) == (
        0 if report.parity else 2)


def test_port_replays_the_committed_digits_record():
    """``runs/surrogate_r17/exact`` (jax 0.4.37 on the CPU; digits, CODA,
    3 seeds x 100 at its recorded width 3) re-executed by the port: parity
    or near-tie flips (the committed record-vs-record triage found flips
    at rounds 32, 79 and 32, gap 2.384e-7)."""
    rec = trec.RunRecord.load(os.path.join(ROOT, "runs", "surrogate_r17",
                                           "exact"))
    ds, factory, args = treplay.load_record_environment(
        rec, data_dir=os.path.join(ROOT, "data"), device="cpu")
    assert args.n_parallel == 3 and ds.shape == (14, 899, 10)
    report = treplay.verify_replay(rec, factory, ds.preds, ds.labels,
                                   loss=args.loss, score_tol=TOL,
                                   device="cpu")
    _hold_cross(report, rec)
    assert not any(s.classification == "key-drift" for s in report.seeds)
