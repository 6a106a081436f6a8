"""The port's task-parallel suite scheduler (mirrors
``tests/test_scheduler.py``).

The planners are pure host code: each one's output must EQUAL the
reference's on the same inputs (LPT and FIFO order and placement, the
cost model, the fleet weighting, host partitions, the two-level
composition), on the reference tests' cases and on seeded random costs.
Placement is a pure copy, so scheduled results are pinned bitwise
(``tobytes``) to the serial ``run_batched``. On the CPU the device list
names the CPU several times: that drives the deferred harvest and the
throttle and places nothing.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.engine import scheduler as tsched
from coda_tpu_torch.engine.suite import SuiteRunner

_METHODS = ["iid", "uncertainty", "model_picker"]
QUIET = dict(progress=lambda s: None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _families():
    fam_a = [make_synthetic_task(seed=i, H=4, N=40, C=3, name=f"alpha_{i}",
                                 device="cpu") for i in range(3)]
    fam_b = [make_synthetic_task(seed=10 + i, H=3, N=24, C=4,
                                 name=f"beta_{i}", device="cpu")
             for i in range(2)]
    return [fam_a, fam_b]


def _runner(**kw):
    return SuiteRunner(device="cpu", **kw)


def _assert_bitwise(r_a: dict, r_b: dict) -> None:
    assert set(r_a) == set(r_b)
    for key in r_a:
        for fa, fb in zip(r_a[key], r_b[key]):
            fa, fb = np.asarray(fa), np.asarray(fb)
            assert fa.dtype == fb.dtype and fa.shape == fb.shape, key
            assert fa.tobytes() == fb.tobytes(), (
                f"{key}: scheduled result differs bitwise from serial")


def _random_costs(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    # ties included: LPT breaks them by input order
    return [float(c) for c in rng.integers(1, 6, size=n)]


@pytest.mark.parametrize("schedule", ["lpt", "fifo"])
def test_port_plan_schedule_equals_the_reference(schedule):
    from coda_tpu.engine import scheduler as jsched

    costs = [5.0, 1.0, 4.0, 2.0, 3.0]
    order, assignment, loads = tsched.plan_schedule(costs, 2, schedule)
    if schedule == "lpt":
        assert order == [0, 2, 4, 3, 1]
        assert assignment == [0, 0, 1, 0, 1] and loads == [8.0, 7.0]
    else:
        assert order == [0, 1, 2, 3, 4]
        assert assignment == [0, 1, 1, 0, 1]
    for seed in range(6):
        for n_dev in (1, 2, 3, 8):
            c = _random_costs(seed, 4 + 3 * seed)
            assert tsched.plan_schedule(c, n_dev, schedule) == \
                jsched.plan_schedule(c, n_dev, schedule)
    with pytest.raises(ValueError, match="unknown schedule"):
        tsched.plan_schedule(costs, 2, "bogus")


def test_port_estimate_cost_equals_the_reference():
    from coda_tpu.engine import scheduler as jsched

    profile = {"per_family_warm_s": {"domainnet": 120.0, "glue": 7.0},
               "per_method_warm_s": {"coda": 30.0, "iid": 10.0}}
    counts = {"domainnet": 12, "glue": 7}
    assert tsched.estimate_cost("domainnet", "coda", 2, profile, counts) \
        == pytest.approx(10.0 * 1.5 * 2)
    assert tsched.estimate_cost("glue", "iid", 7, profile, counts) \
        == pytest.approx(1.0 * 0.5 * 7)
    assert tsched.estimate_cost("msv", "vma", 1, profile, counts) \
        == pytest.approx(5.5)
    assert tsched.estimate_cost("msv", "vma", 3, None, None) == \
        pytest.approx(3.0)
    flat = {"domainnet": 50.0, "glue": 0.0, "note": "x"}
    for fam in ("domainnet", "glue", "msv"):
        for meth in ("coda", "iid", "vma"):
            for prof in (profile, flat, None, {}):
                for cnt in (counts, None, {"glue": 0}):
                    assert tsched.estimate_cost(fam, meth, 3, prof, cnt) \
                        == jsched.estimate_cost(fam, meth, 3, prof, cnt)


def test_port_fleet_planners_equal_the_reference():
    from coda_tpu.engine import scheduler as jsched

    costs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert tsched.plan_fleet_schedule(costs, [1, 1], "lpt") == \
        tsched.plan_schedule(costs, 2, "lpt")
    _, _, loads = tsched.plan_fleet_schedule(costs, [3, 1], "lpt")
    assert loads[0] > loads[1] and loads[1] <= sum(costs) / 3
    for seed in range(5):
        c = _random_costs(seed, 9)
        for w in ([1, 1], [3, 1], [2, 5, 1], [8]):
            for schedule in ("lpt", "fifo"):
                assert tsched.plan_fleet_schedule(c, w, schedule) == \
                    jsched.plan_fleet_schedule(c, w, schedule)
    with pytest.raises(ValueError, match="positive"):
        tsched.plan_fleet_schedule(costs, [1, 0])
    with pytest.raises(ValueError, match="unknown schedule"):
        tsched.plan_fleet_schedule(costs, [1, 1], "bogus")
    for n, hosts in ((8, 3), (4, [[0, 1], [2, 3]]), (5, 5), (7, 2)):
        assert tsched.partition_hosts(n, hosts) == \
            jsched.partition_hosts(n, hosts)
    assert tsched.partition_hosts(8, 3) == [[0, 1, 2], [3, 4, 5], [6, 7]]
    with pytest.raises(ValueError, match="hosts"):
        tsched.partition_hosts(2, 3)
    with pytest.raises(ValueError, match="disjoint"):
        tsched.partition_hosts(4, [[0, 1], [1, 2]])
    with pytest.raises(ValueError, match="cover"):
        tsched.partition_hosts(4, [[0], [2]])


def test_port_plan_two_level_equals_the_reference():
    from coda_tpu.engine import scheduler as jsched

    costs = [7.0, 5.0, 4.0, 3.0, 2.0, 1.0]
    groups = [[0, 1], [2, 3, 4]]
    order, assignment, loads = tsched.plan_two_level(costs, groups, "lpt")
    _, h_assign, h_loads = tsched.plan_fleet_schedule(costs, [2, 3], "lpt")
    for i, d in enumerate(assignment):
        assert d in groups[h_assign[i]]
    for hi, g in enumerate(groups):
        assert sum(loads[d] for d in g) == pytest.approx(h_loads[hi])
    for seed in range(5):
        c = _random_costs(seed, 11)
        for g in (groups, [[0], [1, 2, 3]], [[0, 1, 2, 3]]):
            for schedule in ("lpt", "fifo"):
                assert tsched.plan_two_level(c, g, schedule) == \
                    jsched.plan_two_level(c, g, schedule)


def test_port_resolve_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert tsched.resolve_devices("auto", "cpu") == [cpu]
    assert tsched.resolve_devices(3, "cpu") == [cpu] * 3
    assert tsched.resolve_devices("2", "cpu") == [cpu] * 2
    assert tsched.resolve_devices(["cpu", 0], "cpu") == [cpu] * 2
    with pytest.raises(ValueError):
        tsched.resolve_devices(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsched.resolve_devices("auto")
    # the CUDA forms, with four devices visible
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    local = [torch.device("cuda", i) for i in range(4)]
    assert tsched.resolve_devices("auto") == local
    assert tsched.resolve_devices(None) == local
    assert tsched.resolve_devices(2) == local[:2]
    assert tsched.resolve_devices("3") == local[:3]
    assert tsched.resolve_devices([1, "cuda:0"]) == [local[1], local[0]]
    with pytest.raises(ValueError, match="local devices"):
        tsched.resolve_devices(5)
    with pytest.raises(ValueError, match="no local device"):
        tsched.resolve_devices([7])
    with pytest.raises(ValueError, match="empty"):
        tsched.resolve_devices([])


def test_port_scheduled_equals_serial_bitwise():
    """Three CPU lanes, a mixed deterministic/stochastic multi-family
    config, ModelPicker memory-heavy (a cap of 2): bitwise the serial
    run_batched."""
    groups = _families()
    caps = {"model_picker": 2}
    r_ser = _runner(iters=3, seeds=3).run_batched(groups, _METHODS,
                                                  batch_caps=caps, **QUIET)
    runner = _runner(iters=3, seeds=3)
    r_sch = runner.run_batched(
        groups, _METHODS, batch_caps=caps, devices=3,
        cost_profile={"per_family_warm_s": {"alpha": 3.0, "beta": 1.0}},
        **QUIET)
    _assert_bitwise(r_ser, r_sch)
    stats = runner.last_stats
    assert stats["n_devices"] == 3 and stats["schedule"] == "lpt"
    assert stats["devices"] == ["cpu"] * 3
    assert stats["compute_s"] > 0 and stats["compute_device_s"] > 0
    assert set(stats["occupancy"]) == {0, 1, 2}
    assert all(0.0 <= v <= 1.0 + 1e-6 for v in stats["occupancy"].values())
    assert all("device" in p for p in stats["pairs"])
    mp = [p["batched"] for p in stats["pairs"]
          if p["method"] == "model_picker"]
    assert mp and max(mp) <= 2


def test_port_scheduled_lpt_dispatch_order():
    runner = _runner(iters=2, seeds=2)
    runner.run_batched(
        _families(), ["iid", "uncertainty"], devices=2,
        cost_profile={"per_family_warm_s": {"alpha": 50.0, "beta": 1.0},
                      "per_method_warm_s": {"iid": 3.0, "uncertainty": 1.0}},
        **QUIET)
    entries = [e for recs in runner.last_stats["device_timeline"].values()
               for e in recs]
    assert len(entries) == 4
    by_start = sorted(entries, key=lambda e: e["start"])
    costs = [e["est_cost"] for e in by_start]
    assert costs == sorted(costs, reverse=True), costs
    assert by_start[0]["method"] == "iid"
    assert by_start[0]["tasks"][0].startswith("alpha")


def test_port_scheduled_resume_with_store(tmp_path):
    from coda_tpu_torch.tracking import TrackingStore

    groups = _families()
    store = TrackingStore(str(tmp_path / "s.sqlite"))
    _runner(iters=2, seeds=2).run_batched(groups, ["uncertainty"],
                                          store=store, **QUIET)
    msgs: list = []
    runner = _runner(iters=2, seeds=2)
    r_sch = runner.run_batched(groups, ["uncertainty", "iid"], store=store,
                               progress=msgs.append, devices=2)
    assert sum("skip" in m for m in msgs) == 5
    assert not any(p["method"] == "uncertainty"
                   for p in runner.last_stats["pairs"])
    assert set(r_sch) == {(f"alpha_{i}", "iid") for i in range(3)} \
        | {(f"beta_{i}", "iid") for i in range(2)}
    r_ref = _runner(iters=2, seeds=2).run_batched(groups, ["iid"], **QUIET)
    _assert_bitwise(r_ref, r_sch)
    msgs.clear()
    assert runner.run_batched(groups, ["uncertainty", "iid"], store=store,
                              progress=msgs.append, devices=2) == {}
    assert sum("skip" in m for m in msgs) == 10
    store.close()


def test_port_scheduled_single_device_schema_and_parity():
    groups = _families()
    r_ser = _runner(iters=2, seeds=2).run_batched(
        groups, ["iid", "uncertainty"], **QUIET)
    runner = _runner(iters=2, seeds=2)
    r_one = runner.run_batched(groups, ["iid", "uncertainty"], devices=1,
                               max_inflight=1, **QUIET)
    _assert_bitwise(r_ser, r_one)
    stats = runner.last_stats
    assert stats["n_devices"] == 1
    keys = ("total_s", "load_s", "compute_s", "compute_device_s", "pairs",
            "per_method_warm_s", "per_family_warm_s", "n_devices",
            "schedule", "device_timeline", "occupancy")
    for key in keys:
        assert key in stats, key
    ser = _runner(iters=2, seeds=2)
    ser.run_batched(groups, ["iid"], **QUIET)
    for key in keys:
        assert key in ser.last_stats, key


def test_port_hosts_two_level_matches_serial_bitwise():
    groups = _families()
    r_ser = _runner(iters=3, seeds=3).run_batched(
        groups, ["iid", "uncertainty"], **QUIET)
    runner = _runner(iters=3, seeds=3)
    r_two = runner.run_batched(
        groups, ["iid", "uncertainty"], devices=4, hosts=2,
        cost_profile={"per_family_warm_s": {"alpha": 3.0, "beta": 1.0}},
        **QUIET)
    _assert_bitwise(r_ser, r_two)
    assert runner.last_stats["hosts"] == [[0, 1], [2, 3]]
    assert len(runner.last_stats["host_load"]) == 2


def test_port_cli_suite_devices_subcommand(tmp_path, capsys):
    import json

    from coda_tpu_torch import cli
    from coda_tpu_torch.tracking import TrackingStore

    npdir = tmp_path / "preds"
    npdir.mkdir()
    for i in range(2):
        t = make_synthetic_task(seed=i, H=4, N=30, C=3, name=f"t_{i}",
                                device="cpu")
        np.savez(npdir / f"t_{i}.npz", preds=t.preds.numpy(),
                 labels=t.labels.numpy())
    db = str(tmp_path / "db.sqlite")
    assert cli.main(["suite", "--pred-dir", str(npdir), "--db", db,
                     "--methods", "iid", "--seeds", "2", "--iters", "2",
                     "--suite-devices", "2", "--schedule", "lpt",
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n_devices"] == 2 and line["schedule"] == "lpt"
    store = TrackingStore(db)
    assert store.query("SELECT COUNT(*) FROM experiments")[0][0] == 2
    store.close()
