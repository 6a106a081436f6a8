"""Divergence triage between two flight-recorder records (counterpart of
the numpy record-vs-record half of ``coda_tpu/engine/replay.py``).

This copy lets the port triage a record with no JAX at hand, on the card:
``compare_records`` locates, per seed, the first round where two records
disagree and classifies it by the causally first diverging quantity:

  * ``key-drift`` — the round's PRNG key words differ;
  * ``score-delta`` — the acquisition scores moved beyond the tolerance;
  * ``tie-break-flip`` — the scores agree within the tolerance but the pick
    changed (a near-tie argmax flipped);
  * ``posterior-drift`` — the decisions agree, the P(best) digest or the
    best model moved;
  * ``metric-drift`` — only derived metrics (regret) moved.

Records of different ``acq_batch`` widths, ``eig_scorer`` rungs or
surrogate priors run genuinely different acquisition programs; they
compare by the reference's label-aligned regret envelope
(``acq-batch-envelope``, ``eig-scorer-envelope``,
``surrogate-prior-envelope``), never claiming parity. In two q-wide
records a near tie of a round's first pick reads as ``score-delta`` (the
later picks follow it); :func:`first_pick_flip` tells it apart.

Records of different oracles (``--oracle-noise``) compare by the same
envelope (``oracle-noise-envelope``). It gives the reference's
``ReplayReport.to_dict()`` on every pair.

The re-execution half (:func:`replay_record`, :func:`verify_replay`,
:func:`replay_main`) runs a record's program again: the same recording
program (``make_batched_experiment_fn`` with the record's ``trace_k`` and
``acq_batch``) at the recorded replica width (the ``n_parallel`` knob,
which decides the auto tier; seeds as one batch where
``engine/loop.seeds_batch`` says so, else one after another), seeded with
the record's root keys, on ``--device``. On the recording's backend
(``torch-cuda`` or ``torch-cpu``) with unchanged knobs the replay is
bitwise its record; against a JAX record (backends ``cpu``/``tpu``) or
with ``--set`` overrides the tolerance is the cross-backend score
contract, 2.34e-4::

    python -m coda_tpu_torch.cli replay <record-dir> [--against DIR]
        [--data-dir D] [--device cuda|cpu] [--score-tol auto|x] [--seed s]
        [--set K=V] [--allow-digest-mismatch] [--out REPORT.json]

It exits 0 on PARITY and 2 on DIVERGED. A record of a noisy crowd oracle
re-executes the crowd program (``crowd/loop.py``) from its knobs
(``oracle_noise``, ``oracle_annotators``, ``oracle_reliability``); the
reference's replay runs the clean engine there. A ``mesh`` knob raises
naming the N-axis parallel part of slice 5.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from coda_tpu_torch.telemetry.recorder import (
    CROSS_BACKEND_SCORE_TOL,
    RunRecord,
    dataset_digest,
)

# quantity -> triage class, in causal order: a key mismatch explains a
# score delta explains a flip explains posterior drift explains metric
# drift, so the FIRST diverging group at the first diverging round names
# the root cause
_QUANTITY_GROUPS = (
    ("key-drift", ("round_key",)),
    ("score-delta", ("topk_score", "chosen_score", "select_prob")),
    ("tie-break-flip", ("chosen_idx", "true_class")),
    ("posterior-drift", ("pbest_max", "pbest_entropy", "best_model")),
    ("metric-drift", ("regret", "cumulative_regret", "runner_up_gap",
                      "surrogate_fallback")),
)
_INT_QUANTITIES = {"chosen_idx", "true_class", "best_model", "round_key"}



def _record_knobs(record: RunRecord) -> dict:
    """A record's fingerprinted knob dict, NORMALIZED for comparison:
    knobs that predate a record are filled with the default the replay
    would rebuild them at (``eig_scorer`` missing == ``'exact'``: records
    older than the knob would otherwise 'differ' from a fresh exact capture
    on it and silently loosen the auto tolerance from bitwise to the
    2.34e-4 contract)."""
    knobs = dict(record.meta.get("fingerprint", {}).get("knobs", {}) or {})
    knobs.setdefault("eig_scorer", "exact")
    # crowd-oracle knobs: a CLEAN oracle runs the plain-oracle
    # program bitwise, so 'clean'/'none' normalizes to ABSENT — a pre-v4
    # record vs a fresh clean-crowd capture must take the bitwise path,
    # not spuriously 'differ' on a knob that changes nothing. The
    # satellite knobs only mean anything under a noisy spec, so they are
    # dropped alongside it.
    if knobs.get("oracle_noise") in (None, "clean", "none"):
        for key in ("oracle_noise", "oracle_annotators",
                    "oracle_reliability"):
            knobs.pop(key, None)
    # cross-session prior: 'off' runs the pre-pool program bitwise, so it
    # normalizes to ABSENT — a pre-pool record vs a fresh
    # --surrogate-prior off capture compares bitwise; the pool-digest
    # satellite knob means nothing without the mode
    if knobs.get("surrogate_prior") in (None, "off"):
        knobs.pop("surrogate_prior", None)
        knobs.pop("surrogate_prior_digest", None)
    return knobs


def _rows_equal(a: np.ndarray, b: np.ndarray, tol: float) -> np.ndarray:
    """(T,) bool: per-round equality, reducing trailing axes. ``tol=0`` is
    bitwise-for-floats (NaN==NaN so an absent posterior digest never
    diverges); integers always compare exact."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype.kind in "iub" or tol == 0.0:
        eq = (a == b)
        if a.dtype.kind == "f":
            eq |= np.isnan(a) & np.isnan(b)
    else:
        eq = np.isclose(a.astype(np.float64), b.astype(np.float64),
                        rtol=0.0, atol=tol, equal_nan=True)
        # two -inf (masked non-candidates) are equal; isclose(inf,inf) is
        # already True, but inf-vs-finite must stay a divergence
    while eq.ndim > 1:
        eq = eq.all(axis=-1)
    return eq


def _max_delta(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.abs(a - b)
    d = np.where(np.isnan(a) & np.isnan(b), 0.0, d)
    # NaN on exactly ONE side is a structural difference (a posterior digest
    # present in one record, absent in the other) — report it as inf, never
    # drop it (nanmax would) or let it poison the max (plain max of NaN)
    d = np.where(np.isnan(a) ^ np.isnan(b), np.inf, d)
    d = np.where(np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b)),
                 0.0, d)
    return float(np.max(d)) if d.size else 0.0


@dataclass
class SeedTriage:
    """Divergence verdict for one seed of a record comparison."""

    seed: int
    parity: bool
    first_divergent_round: Optional[int] = None
    quantity: Optional[str] = None
    classification: Optional[str] = None
    # per-quantity evidence: first diverging round + max |delta| over rounds
    quantities: dict = field(default_factory=dict)
    note: str = ""

    def to_dict(self) -> dict:
        return {
            "seed": self.seed, "parity": self.parity,
            "first_divergent_round": self.first_divergent_round,
            "quantity": self.quantity,
            "classification": self.classification,
            "quantities": self.quantities, "note": self.note,
        }


@dataclass
class ReplayReport:
    """Aggregate verdict of a replay/record comparison."""

    mode: str                    # "replay" | "records"
    score_tol: float
    seeds: list = field(default_factory=list)   # [SeedTriage]
    meta: dict = field(default_factory=dict)

    @property
    def parity(self) -> bool:
        return all(s.parity for s in self.seeds)

    def to_dict(self) -> dict:
        return {
            "mode": self.mode, "parity": self.parity,
            "score_tol": self.score_tol,
            "seeds": [s.to_dict() for s in self.seeds],
            "meta": self.meta,
        }


def compare_seed(rec: dict, rep: dict, score_tol: float = 0.0,
                 seed: int = 0,
                 int_tol_quantities: tuple = ()) -> SeedTriage:
    """Triage one seed's recorded-vs-replayed (or A-vs-B) round arrays.

    ``score_tol`` bounds every float quantity; integer decision quantities
    always compare exact. The first diverging round is located across ALL
    quantities, then classified by the causally-first diverging group at
    that round (see module docstring)."""
    first_by_q: dict = {}
    deltas: dict = {}
    T = int(np.asarray(rec["chosen_idx"]).shape[0])
    for cls_name, quantities in _QUANTITY_GROUPS:
        for q in quantities:
            if q not in rec or q not in rep:
                continue
            # the runner-up gap is a DIFFERENCE of two tol-bounded scores,
            # so its honest bound is 2·tol — comparing it at 1·tol would
            # double-count drift the score comparison already admitted
            tol_q = 2.0 * score_tol if q == "runner_up_gap" else score_tol
            eq = _rows_equal(rec[q], rep[q], tol_q)
            div = np.nonzero(~eq)[0]
            if div.size:
                first_by_q[q] = int(div[0])
                if q not in _INT_QUANTITIES:
                    deltas[q] = _max_delta(rec[q], rep[q])
    if not first_by_q:
        return SeedTriage(seed=seed, parity=True,
                          quantities={"rounds_compared": T})
    t0 = min(first_by_q.values())
    quantity = None
    classification = None
    for cls_name, quantities in _QUANTITY_GROUPS:
        hit = [q for q in quantities if first_by_q.get(q) == t0]
        if hit:
            quantity = hit[0]
            classification = cls_name
            break
    note = ""
    if classification == "tie-break-flip":
        gap = float(np.asarray(rec["runner_up_gap"])[t0])
        note = (f"recorded runner-up gap at round {t0} is {gap:.3e} — "
                f"{'a near-tie; ' if abs(gap) <= max(score_tol, 1e-6) else ''}"
                "scores agree within tolerance but the argmax pick changed")
    info = {q: {"first_divergent_round": r,
                "max_abs_delta": deltas.get(q)}
            for q, r in sorted(first_by_q.items())}
    return SeedTriage(seed=seed, parity=False, first_divergent_round=t0,
                      quantity=quantity, classification=classification,
                      quantities=info, note=note)


def _scorer_knob(record: RunRecord) -> str:
    return str(record.meta.get("fingerprint", {}).get("knobs", {}).get(
        "eig_scorer") or "exact")


def _oracle_knob(record: RunRecord) -> str:
    """A record's normalized ``--oracle-noise`` spec: 'clean' when absent
    (every pre-v4 record) or when explicitly clean."""
    spec = record.meta.get("fingerprint", {}).get("knobs", {}).get(
        "oracle_noise")
    return "clean" if spec in (None, "clean", "none") else str(spec)


def _prior_knob(record: RunRecord) -> str:
    """A record's normalized ``--surrogate-prior`` mode, digest-qualified:
    'off' when absent (every pre-pool record); a pool-seeded record is
    ``pool@<digest>`` — two runs seeded from DIFFERENT pools ran
    different warm-starts and must not be conflated."""
    knobs = record.meta.get("fingerprint", {}).get("knobs", {}) or {}
    mode = knobs.get("surrogate_prior")
    if mode in (None, "off"):
        return "off"
    digest = knobs.get("surrogate_prior_digest")
    return f"{mode}@{digest}" if digest else str(mode)


def _label_aligned_cum(record: RunRecord, seed: int) -> np.ndarray:
    """One seed's cumulative regret indexed by label: entry L-1 is the
    cumulative regret after L labels (each round's regret counted for its
    q labels, re-derived from ``regret`` so v1 and v2 records align)."""
    q = record.acq_batch
    regret = np.asarray(record.arrays["regret"][seed], np.float64)
    return np.repeat(np.cumsum(q * regret), q)


def _compare_records_envelope(a: RunRecord, b: RunRecord,
                              classification: str, meta_key: str,
                              label_a: str, label_b: str,
                              force_diff_key: Optional[str] = None
                              ) -> ReplayReport:
    """The label-aligned regret-envelope comparison of two records that
    ran different acquisition programs: per seed, the two cumulative
    regret curves on their common label prefix, the final gap and ratio
    and the worst aligned gap, under ``classification``. Parity is never
    claimed."""
    report = ReplayReport(mode="records", score_tol=0.0, meta={
        "a": a.meta.get("run", {}), "b": b.meta.get("run", {}),
        "backend_a": a.meta.get("fingerprint", {}).get("backend"),
        "backend_b": b.meta.get("fingerprint", {}).get("backend"),
    })
    knobs_a = _record_knobs(a)
    knobs_b = _record_knobs(b)
    diff = {key: [knobs_a.get(key), knobs_b.get(key)]
            for key in sorted(set(knobs_a) | set(knobs_b))
            if knobs_a.get(key) != knobs_b.get(key)}
    if force_diff_key:
        diff.setdefault(force_diff_key, [a.acq_batch, b.acq_batch])
    report.meta["knob_diff"] = diff
    n_seeds = min(a.seeds, b.seeds)
    if a.seeds != b.seeds:
        report.meta["seed_count_mismatch"] = {"a": a.seeds, "b": b.seeds,
                                              "compared": n_seeds}
    per_seed = []
    for s in range(n_seeds):
        ca = _label_aligned_cum(a, s)
        cb = _label_aligned_cum(b, s)
        L = min(ca.shape[0], cb.shape[0])
        ca, cb = ca[:L], cb[:L]
        gap = cb - ca
        final_ratio = (float(cb[-1] / ca[-1]) if ca[-1] > 0
                       else (1.0 if cb[-1] <= 0 else float("inf")))
        info = {
            "labels_compared": int(L),
            "final_cum_a": float(ca[-1]), "final_cum_b": float(cb[-1]),
            "final_gap": float(gap[-1]),
            "max_aligned_gap": float(np.max(gap)),
            "final_ratio_b_over_a": final_ratio,
        }
        per_seed.append(info)
        report.seeds.append(SeedTriage(
            seed=s, parity=False, first_divergent_round=0,
            quantity="cumulative_regret",
            classification=classification,
            quantities={"cumulative_regret": info},
            note=(f"label-aligned regret envelope over {L} labels: "
                  f"final {ca[-1]:.4f} ({label_a}) vs "
                  f"{cb[-1]:.4f} ({label_b}), "
                  f"ratio {final_ratio:.3f}, "
                  f"max aligned gap {np.max(gap):.4f}")))
    report.meta[meta_key] = {
        "a": label_a, "b": label_b, "seeds": per_seed,
        "max_final_ratio_b_over_a": max(
            (i["final_ratio_b_over_a"] for i in per_seed), default=None),
        "max_aligned_gap": max(
            (i["max_aligned_gap"] for i in per_seed), default=None),
    }
    return report


def compare_records_batchq(a: RunRecord, b: RunRecord) -> ReplayReport:
    """Records of different ``acq_batch`` widths: the envelope, triage
    class ``acq-batch-envelope``."""
    report = _compare_records_envelope(
        a, b, classification="acq-batch-envelope",
        meta_key="batchq_envelope",
        label_a=f"q={a.acq_batch}", label_b=f"q={b.acq_batch}",
        force_diff_key="acq_batch")
    report.meta["batchq_envelope"].update(
        {"q_a": a.acq_batch, "q_b": b.acq_batch})
    return report


def compare_records_scorer(a: RunRecord, b: RunRecord) -> ReplayReport:
    """Records of different ``eig_scorer`` rungs (the surrogate's score
    vector legitimately holds predictions outside its re-scored rows):
    the envelope, triage class ``eig-scorer-envelope``."""
    report = _compare_records_envelope(
        a, b, classification="eig-scorer-envelope",
        meta_key="scorer_envelope",
        label_a=f"eig_scorer={_scorer_knob(a)}",
        label_b=f"eig_scorer={_scorer_knob(b)}")
    report.meta["scorer_envelope"].update(
        {"scorer_a": _scorer_knob(a), "scorer_b": _scorer_knob(b)})
    return report


def compare_records_oracle(a: RunRecord, b: RunRecord) -> ReplayReport:
    """Records of different ``--oracle-noise`` specs (a noisy crowd labels
    with corrupted answers, so per-round parity is not the contract): the
    envelope, triage class ``oracle-noise-envelope``."""
    report = _compare_records_envelope(
        a, b, classification="oracle-noise-envelope",
        meta_key="oracle_envelope",
        label_a=f"oracle={_oracle_knob(a)}",
        label_b=f"oracle={_oracle_knob(b)}")
    report.meta["oracle_envelope"].update(
        {"oracle_a": _oracle_knob(a), "oracle_b": _oracle_knob(b)})
    return report


def compare_records_prior(a: RunRecord, b: RunRecord) -> ReplayReport:
    """Records of different ``--surrogate-prior`` modes or pool digests (a
    seeded run skips warmup rounds already paid): the envelope, triage
    class ``surrogate-prior-envelope``; the reference's gate bounds the
    seeded run's final cumulative regret at :data:`PRIOR_ENVELOPE_RATIO`
    times the cold one's plus :data:`PRIOR_ENVELOPE_ABS`."""
    report = _compare_records_envelope(
        a, b, classification="surrogate-prior-envelope",
        meta_key="prior_envelope",
        label_a=f"surrogate_prior={_prior_knob(a)}",
        label_b=f"surrogate_prior={_prior_knob(b)}")
    report.meta["prior_envelope"].update(
        {"prior_a": _prior_knob(a), "prior_b": _prior_knob(b)})
    return report


# the reference's bound on a pool-seeded run against a cold one
# (scripts/check_perf.py PRIOR_ENVELOPE_RATIO / PRIOR_ENVELOPE_ABS)
PRIOR_ENVELOPE_RATIO = 1.05
PRIOR_ENVELOPE_ABS = 0.02


def within_prior_envelope(cold_final_mean: float,
                          seeded_final_mean: float) -> bool:
    """The seeded run's mean final cumulative regret within the
    reference's envelope of the cold run's."""
    return seeded_final_mean <= (PRIOR_ENVELOPE_RATIO * cold_final_mean
                                 + PRIOR_ENVELOPE_ABS)


def first_pick_flip(a: RunRecord, b: RunRecord, seed: int, t0: int,
                    tol: float = CROSS_BACKEND_SCORE_TOL) -> bool:
    """Whether seed ``seed`` of two q-wide records first diverges at round
    ``t0`` by a near tie of the round's FIRST pick: the first picks
    differ, the score vectors agree within ``tol`` (the top-k and the
    chosen score) and ``a``'s runner-up gap is within it. The later picks
    then follow another first pick, so their probabilities differ by more
    than ``tol`` and the per-round triage names the round ``score-delta``
    (its quantity order) where the cause is a ``tie-break-flip``."""
    x, y = a.seed_arrays(seed), b.seed_arrays(seed)
    return bool(
        x["chosen_idx"][t0, 0] != y["chosen_idx"][t0, 0]
        and abs(float(x["runner_up_gap"][t0])) <= tol
        and abs(float(x["chosen_score"][t0] - y["chosen_score"][t0])) <= tol
        and np.allclose(x["topk_score"][t0], y["topk_score"][t0], rtol=0,
                        atol=tol))


def compare_records(a: RunRecord, b: RunRecord,
                    score_tol: float = 0.0) -> ReplayReport:
    """Direct record-vs-record comparison (no re-execution), the
    reference's path: the first diverging round of each seed and its
    triage class.

    Records captured with different ``--record-topk`` compare on the
    common top-k prefix; a seed-count mismatch compares the common seeds
    and is surfaced in the report meta + triage text (never silently
    called full parity). Records of different ``acq_batch`` widths,
    ``eig_scorer`` rungs or surrogate priors take the label-aligned
    regret envelope (:func:`compare_records_batchq`,
    :func:`compare_records_scorer`, :func:`compare_records_oracle`,
    :func:`compare_records_prior`), as the reference's do."""
    if a.acq_batch != b.acq_batch:
        return compare_records_batchq(a, b)
    if _scorer_knob(a) != _scorer_knob(b):
        return compare_records_scorer(a, b)
    if _oracle_knob(a) != _oracle_knob(b):
        return compare_records_oracle(a, b)
    if _prior_knob(a) != _prior_knob(b):
        return compare_records_prior(a, b)
    if a.rounds != b.rounds:
        raise ValueError(
            f"records disagree on round count ({a.rounds} vs {b.rounds}); "
            "nothing round-aligned to compare")
    report = ReplayReport(mode="records", score_tol=score_tol, meta={
        "a": a.meta.get("run", {}), "b": b.meta.get("run", {}),
        "backend_a": a.meta.get("fingerprint", {}).get("backend"),
        "backend_b": b.meta.get("fingerprint", {}).get("backend"),
    })
    # name the knobs the two sides disagree on (e.g. posterior=dense vs
    # sparse:32) — the reason the auto tolerance dropped to the score
    # contract, surfaced instead of leaving the reader to diff fingerprints
    knobs_a = _record_knobs(a)
    knobs_b = _record_knobs(b)
    diff = {key: [knobs_a.get(key), knobs_b.get(key)]
            for key in sorted(set(knobs_a) | set(knobs_b))
            if knobs_a.get(key) != knobs_b.get(key)}
    if diff:
        report.meta["knob_diff"] = diff
    k = min(int(a.meta.get("trace_k", 8)), int(b.meta.get("trace_k", 8)))
    if a.meta.get("trace_k") != b.meta.get("trace_k"):
        report.meta["trace_k_compared"] = k
    n_seeds = min(a.seeds, b.seeds)
    if a.seeds != b.seeds:
        report.meta["seed_count_mismatch"] = {"a": a.seeds, "b": b.seeds,
                                              "compared": n_seeds}
    def _trim(arr_dict):
        return {key: (v[:, :k] if key in ("topk_idx", "topk_score")
                      else v) for key, v in arr_dict.items()}
    for s in range(n_seeds):
        report.seeds.append(compare_seed(_trim(a.seed_arrays(s)),
                                         _trim(b.seed_arrays(s)),
                                         score_tol=score_tol, seed=s))
    return report


def format_triage(report: ReplayReport) -> str:
    """Human-readable verdict block (the CLI's stdout)."""
    lines = []
    tol = ("bitwise" if report.score_tol == 0.0
           else f"|Δscore| ≤ {report.score_tol:g}")
    lines.append(f"replay[{report.mode}] contract: {tol}")
    mism = report.meta.get("seed_count_mismatch")
    if mism:
        lines.append(
            f"  WARNING: seed counts differ (a={mism['a']}, b={mism['b']})"
            f" — only the {mism['compared']} common seed(s) were compared;"
            " this verdict covers nothing beyond them")
    if "trace_k_compared" in report.meta:
        lines.append(f"  note: records carry different top-k widths; "
                     f"compared the common top-"
                     f"{report.meta['trace_k_compared']} prefix")
    if report.meta.get("knob_diff"):
        pairs = ", ".join(f"{k}: {va!r} vs {vb!r}" for k, (va, vb)
                          in report.meta["knob_diff"].items())
        contract = ("the label-aligned regret envelope"
                    if (report.meta.get("batchq_envelope")
                        or report.meta.get("scorer_envelope")
                        or report.meta.get("oracle_envelope")
                        or report.meta.get("prior_envelope"))
                    else ("BITWISE equality (score-tol 0 despite the "
                          "knob diff)" if report.score_tol == 0.0
                          else "the documented score contract"))
        lines.append(f"  knobs differ ({pairs}) — compared under "
                     f"{contract}, not bitwise")
    env = report.meta.get("batchq_envelope")
    if env:
        lines.append(
            f"  acq-batch envelope: q={env['q_a']} vs q={env['q_b']}, "
            f"worst final cum-regret ratio "
            f"{env['max_final_ratio_b_over_a']:.3f}, worst aligned gap "
            f"{env['max_aligned_gap']:.4f}")
    env = report.meta.get("scorer_envelope")
    if env:
        lines.append(
            f"  eig-scorer envelope: {env['scorer_a']} vs "
            f"{env['scorer_b']}, worst final cum-regret ratio "
            f"{env['max_final_ratio_b_over_a']:.3f}, worst aligned gap "
            f"{env['max_aligned_gap']:.4f}")
    env = report.meta.get("oracle_envelope")
    if env:
        lines.append(
            f"  oracle-noise envelope: {env['oracle_a']} vs "
            f"{env['oracle_b']}, worst final cum-regret ratio "
            f"{env['max_final_ratio_b_over_a']:.3f}, worst aligned gap "
            f"{env['max_aligned_gap']:.4f}")
    env = report.meta.get("prior_envelope")
    if env:
        lines.append(
            f"  surrogate-prior envelope: {env['prior_a']} vs "
            f"{env['prior_b']}, worst final cum-regret ratio "
            f"{env['max_final_ratio_b_over_a']:.3f}, worst aligned gap "
            f"{env['max_aligned_gap']:.4f}")
    for s in report.seeds:
        if s.parity:
            lines.append(f"  seed {s.seed}: PARITY "
                         f"({s.quantities.get('rounds_compared', '?')} "
                         "rounds)")
            continue
        lines.append(
            f"  seed {s.seed}: DIVERGED at round {s.first_divergent_round} "
            f"— first diverging quantity: {s.quantity} "
            f"[{s.classification}]")
        if s.note:
            lines.append(f"    {s.note}")
        for q, info in s.quantities.items():
            if "first_divergent_round" not in info:
                continue  # envelope entries carry their own note line
            d = info.get("max_abs_delta")
            lines.append(
                f"    {q}: first at round {info['first_divergent_round']}"
                + (f", max |Δ| = {d:.3e}" if d is not None else ""))
    lines.append("verdict: " + ("PARITY" if report.parity else "DIVERGED"))
    return "\n".join(lines)


def _current_backend(device) -> str:
    """The fingerprint backend a re-execution on ``device`` writes."""
    import torch

    return f"torch-{torch.device(device or 'cuda').type}"


def _auto_tol(record: RunRecord, overrides: dict,
              against: Optional[RunRecord] = None, device=None) -> float:
    """Bitwise when the two sides share a backend with unchanged knobs;
    the documented cross-backend score contract otherwise.

    In replay mode the "other side" is this process on ``device``
    (``torch-cuda`` or ``torch-cpu``; every JAX record differs); in
    ``--against`` mode it is the second record, and this process's device
    is irrelevant."""
    fp = record.meta.get("fingerprint", {})
    if against is not None:
        fp_b = against.meta.get("fingerprint", {})
        # knob dicts compare NORMALIZED (_record_knobs): a knob one
        # record predates is its replay default, not a difference
        same = (fp.get("backend") == fp_b.get("backend")
                and _record_knobs(record) == _record_knobs(against))
        return 0.0 if same else CROSS_BACKEND_SCORE_TOL
    same_backend = fp.get("backend") == _current_backend(device)
    return 0.0 if (same_backend and not overrides) \
        else CROSS_BACKEND_SCORE_TOL


# ---------------------------------------------------------------------------
# re-execution: the record's own program, run again
# ---------------------------------------------------------------------------

def replay_record(record: RunRecord, selector_factory, preds, labels,
                  loss: str = "acc", device=None,
                  timings: Optional[list] = None) -> dict:
    """Re-execute a record's program and return the replayed arrays
    (the record's names and dtypes, a leading seed axis).

    Runs the recording program — ``make_batched_experiment_fn`` with the
    record's ``trace_k`` and ``acq_batch``, seeds as one batch where the
    selector batches them — seeded with the record's root keys, on
    ``device`` (default: the card); a noisy crowd record runs the crowd's
    (``crowd.loop.make_batched_crowd_experiment_fn``, its config from the
    record's knobs, :func:`record_crowd_config`) and returns its
    ``oracle_label``/``label_weight`` too. ``selector_factory`` carries the
    recorded replica width (:func:`load_record_environment`). Same backend
    and knobs: bitwise the recorded arrays. ``timings``: the experiment
    functions' ``{"init_ms", "rounds_ms"}`` entries (one for a seed batch,
    one a seed otherwise)."""
    import torch

    from coda_tpu_torch.engine.loop import (
        _as_tensor,
        make_batched_experiment_fn,
    )
    from coda_tpu_torch.losses import LOSS_FNS
    from coda_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    run = record.meta.get("run", {})
    iters = int(run.get("iters", record.rounds))
    trace_k = int(record.meta.get("trace_k", 8))
    keys = torch.from_numpy(
        np.asarray(record.arrays["root_key"]).astype(np.int64))
    args = (_as_tensor(preds).to(dev, torch.float32),
            _as_tensor(labels).to(dev), keys)
    cfg = record_crowd_config(record)
    if cfg is None:
        result, aux = make_batched_experiment_fn(
            selector_factory, iters, LOSS_FNS[loss], trace_k=trace_k,
            acq_batch=record.acq_batch, timings=timings)(*args)
        crowd = None
    else:
        from coda_tpu_torch.crowd.loop import (
            make_batched_crowd_experiment_fn,
        )

        result, aux, crowd = make_batched_crowd_experiment_fn(
            selector_factory, cfg, iters, LOSS_FNS[loss], trace_k=trace_k,
            acq_batch=record.acq_batch, timings=timings)(*args)
    arrays = RunRecord.from_result(result, aux, {}, {}, crowd=crowd).arrays
    return {k: arrays[k] for k in (
        "chosen_idx", "true_class", "best_model", "regret",
        "cumulative_regret", "select_prob", "round_key", "topk_idx",
        "topk_score", "chosen_score", "runner_up_gap", "pbest_max",
        "pbest_entropy", "surrogate_fallback", "oracle_label",
        "label_weight") if k in arrays}


def record_crowd_config(record: RunRecord):
    """The ``CrowdConfig`` of a record that ran a noisy crowd oracle (its
    ``oracle_noise``, ``oracle_annotators`` and ``oracle_reliability``
    knobs, as the CLI resolves them), else None."""
    if _oracle_knob(record) == "clean":
        return None
    from argparse import Namespace

    from coda_tpu_torch.cli import crowd_config

    knobs = record.meta.get("fingerprint", {}).get("knobs", {})
    return crowd_config(Namespace(
        oracle_noise=knobs["oracle_noise"],
        oracle_annotators=knobs.get("oracle_annotators"),
        oracle_reliability=knobs.get("oracle_reliability")))


def verify_replay(record: RunRecord, selector_factory, preds, labels,
                  loss: str = "acc", score_tol: float = 0.0, seeds=None,
                  device=None) -> ReplayReport:
    """Re-execute ``record`` through its own program and triage each seed
    (all of them, or ``seeds``: the program always runs every recorded
    seed, as it was recorded). ``meta["timings"]`` holds the
    re-execution's init and round times (host clock, the device
    synchronised at the phase boundaries)."""
    timings: list = []
    report = ReplayReport(mode="replay", score_tol=score_tol,
                          meta={"run": record.meta.get("run", {}),
                                "timings": timings})
    replayed = replay_record(record, selector_factory, preds, labels,
                             loss=loss, device=device, timings=timings)
    for s in (range(record.seeds) if seeds is None else seeds):
        rec = record.seed_arrays(s)
        rep = {k: v[s] for k, v in replayed.items()}
        report.seeds.append(compare_seed(rec, rep, score_tol=score_tol,
                                         seed=s))
    return report


# knobs of a record that name where the reference ran, not what: the
# port's --device decides
_PLACE_KNOBS = ("platform",)


def _args_from_record(record: RunRecord, data_dir: Optional[str] = None,
                      overrides: Optional[dict] = None):
    """Rebuild the port's argparse namespace a record was captured under:
    the port CLI's defaults, then the fingerprinted knobs (a reference
    record's too: ``eig_backend='pallas'`` runs the kernels, ``'jnp'`` the
    plain versions; the ``n_parallel`` knob keeps the recorded replica
    width, so the auto tier resolves as it did), then explicit
    overrides."""
    from coda_tpu_torch.cli import parse_args

    args = parse_args([])
    run = record.meta.get("run", {})
    knobs = dict(record.meta.get("fingerprint", {}).get("knobs", {}))
    knobs.update(overrides or {})
    for k, v in knobs.items():
        if k not in _PLACE_KNOBS:
            setattr(args, k, v)
    if args.eig_backend == "plain":
        args.eig_backend = "jnp"
    args.task = run.get("task")
    args.synthetic = run.get("synthetic")
    if data_dir:
        args.data_dir = data_dir
    elif run.get("data_dir"):
        args.data_dir = run["data_dir"]
    return args


def load_record_environment(record: RunRecord,
                            data_dir: Optional[str] = None,
                            overrides: Optional[dict] = None,
                            check_digest: bool = True, device=None):
    """``(dataset, selector_factory, args)`` for a record on ``device`` —
    everything :func:`verify_replay` needs to re-execute the recorded
    program. The dataset's digest must be the record's unless
    ``check_digest`` is False."""
    from coda_tpu_torch.cli import build_selector_factory, load_dataset

    args = _args_from_record(record, data_dir, overrides)
    args.device = "cuda" if device is None else str(device)
    dataset = load_dataset(args)
    want = record.meta.get("fingerprint", {}).get("dataset", {}).get(
        "digest")
    if check_digest and want:
        got = dataset_digest(dataset.preds, dataset.labels)
        if got != want:
            raise ValueError(
                f"dataset digest mismatch: record was captured on "
                f"{want}, loaded data hashes to {got} — replaying against "
                "different data answers a different question "
                "(pass --allow-digest-mismatch to proceed anyway)")
    factory = build_selector_factory(args, dataset.name)
    return dataset, factory, args


def _parse_overrides(pairs) -> dict:
    """``--set KEY=VALUE`` pairs: ints, then floats, then true/false, else
    the string."""
    out = {}
    for p in pairs or ():
        if "=" not in p:
            raise SystemExit(f"--set expects KEY=VALUE, got {p!r}")
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        out[k] = v
    return out


def replay_main(argv=None) -> int:
    """``python -m coda_tpu_torch.cli replay <record-dir> [...]``: 0 on
    PARITY, 2 on DIVERGED."""
    p = argparse.ArgumentParser(
        prog="coda_tpu_torch.cli replay",
        description="re-execute a flight-recorder record on the card and "
                    "triage any divergence (or diff two records with "
                    "--against)")
    p.add_argument("record_dir", help="directory with record.json + "
                                      "rounds.npz (a --record-dir output)")
    p.add_argument("--against", default=None, metavar="DIR",
                   help="compare against this second record instead of "
                        "re-executing")
    p.add_argument("--data-dir", default=None,
                   help="override the recorded data directory")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the re-execution runs (default: the card)")
    p.add_argument("--score-tol", default="auto",
                   help="float tolerance on score/posterior quantities; "
                        "'auto' = bitwise (0.0) on the recorded backend "
                        "with unchanged knobs, else the documented "
                        f"{CROSS_BACKEND_SCORE_TOL} cross-backend contract")
    p.add_argument("--seed", type=int, default=None,
                   help="triage only this recorded seed (default: all)")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   dest="overrides",
                   help="override a recorded knob for the replay (e.g. "
                        "eig_entropy=approx)")
    p.add_argument("--allow-digest-mismatch", action="store_true")
    p.add_argument("--out", default=None, metavar="REPORT.json",
                   help="write the triage report there as JSON")
    args = p.parse_args(argv)

    record = RunRecord.load(args.record_dir)
    overrides = _parse_overrides(args.overrides)
    other = RunRecord.load(args.against) if args.against else None
    tol = (_auto_tol(record, overrides, against=other, device=args.device)
           if args.score_tol == "auto" else float(args.score_tol))

    if other is not None:
        report = compare_records(record, other, score_tol=tol)
    else:
        from coda_tpu_torch.utils.platform import resolve_device

        dev = resolve_device(args.device)
        dataset, factory, rec_args = load_record_environment(
            record, data_dir=args.data_dir, overrides=overrides,
            check_digest=not args.allow_digest_mismatch, device=dev)
        seeds = None if args.seed is None else [args.seed]
        report = verify_replay(record, factory, dataset.preds,
                               dataset.labels,
                               loss=getattr(rec_args, "loss", "acc"),
                               score_tol=tol, seeds=seeds, device=dev)
        report.meta["device"] = str(dev)
    print(format_triage(report))
    if report.meta.get("timings"):
        rounds_ms = sum(t["rounds_ms"] for t in report.meta["timings"])
        print(f"re-executed {record.seeds} seed(s) x {record.rounds} rounds "
              f"on {report.meta['device']}: "
              f"{rounds_ms / record.rounds:.3f} ms a round")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report.to_dict(), f, indent=2)
        print(f"triage report written to {args.out}")
    return 0 if report.parity else 2
