"""Prometheus text exposition of the telemetry registry (counterpart of
``coda_tpu/telemetry/prometheus.py``).

:func:`render` turns the counter/gauge registry into the Prometheus text
exposition format (version 0.0.4), written as ``metrics.prom`` beside
``telemetry.json``; :func:`lint` checks a text against that contract. No
client library: the format is lines of ``name{labels} value`` under
``# HELP`` / ``# TYPE`` headers. ``render(serve_metrics=...)`` adds the
serve families (``ServeMetrics``' snapshot, the reference's names) and
the decision-quality families (``quality_*``, absent with
``--no-quality``); :func:`render_fleet` comes with the fleet, slice 9 of
the port.
"""

from __future__ import annotations

import re
from typing import Optional

from coda_tpu_torch.telemetry.registry import Registry, get_registry

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _name(prefix: str, name: str) -> str:
    n = f"{prefix}_{name}" if prefix else name
    n = _NAME_OK.sub("_", n)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    v = float(value)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _line(name: str, labels: dict, value: float) -> str:
    if labels:
        lab = ",".join(f'{_NAME_OK.sub("_", str(k))}="{_escape(v)}"'
                       for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def _family(out: list, name: str, kind: str, help: str,
            samples: list) -> None:
    if help:
        out.append(f"# HELP {name} {_escape(help)}")
    out.append(f"# TYPE {name} {kind}")
    for labels, value in samples:
        out.append(_line(name, labels, value))


def _exemplar_family(out: list, name: str, help: str,
                     samples: list) -> None:
    """A gauge family whose samples carry OpenMetrics exemplars:
    ``name{labels} value # {trace_id="..."} value`` — the one-hop join
    from a latency outlier on ``/metrics`` to its distributed trace.
    ``samples`` is ``[(labels, {"value_s": float, "trace_id": str})]``."""
    if help:
        out.append(f"# HELP {name} {_escape(help)}")
    out.append(f"# TYPE {name} gauge")
    for labels, ex in samples:
        v = float(ex["value_s"])
        out.append(_line(name, labels, v)
                   + f' # {{trace_id="{_escape(ex["trace_id"])}"}} '
                   + _fmt(v))


def render(registry: Optional[Registry] = None, serve_metrics=None,
           prefix: str = "coda") -> str:
    """The registry (+ an optional ``ServeMetrics`` snapshot) as exposition
    text."""
    out: list[str] = []
    reg = registry if registry is not None else get_registry()
    for m in reg.collect():
        _family(out, _name(prefix, m.name), m.kind, m.help, m.samples())
    if serve_metrics is not None:
        _render_serve(out, serve_metrics.snapshot(), prefix)
    return "\n".join(out) + "\n"


def render_fleet(*args, **kwargs) -> str:
    """The fleet router's merged exposition comes with the fleet, slice 9
    of the port."""
    raise NotImplementedError(
        "render_fleet: the fleet router comes with slice 9 of the port")


# (snapshot key, metric suffix, kind, help) — counters keep their
# monotonic-total names, distribution means/maxes surface as gauges
_SERVE_SCALARS = [
    ("uptime_s", "serve_uptime_seconds", "gauge",
     "Seconds since the serve metrics baseline (monotonic clock)"),
    ("dispatches", "serve_dispatches_total", "counter",
     "Compiled slab-step dispatches"),
    ("requests", "serve_requests_total", "counter",
     "Requests served across all dispatches"),
    ("sessions_opened", "serve_sessions_opened_total", "counter",
     "Sessions admitted"),
    ("sessions_closed", "serve_sessions_closed_total", "counter",
     "Sessions closed"),
    ("sessions_rejected", "serve_sessions_rejected_total", "counter",
     "Sessions refused by admission control (slab full / draining)"),
    ("requests_rejected", "serve_requests_rejected_total", "counter",
     "Requests refused (draining / unknown session / stale item)"),
    ("fencing_rejections", "serve_fencing_rejections_total", "counter",
     "Stale-epoch verbs this replica refused (the ownership fence held)"),
    ("max_occupancy", "serve_max_occupancy", "gauge",
     "Most requests ever served by one dispatch"),
    # tiered posterior state (serve/tiering.py)
    ("demotions", "serve_demotions_total", "counter",
     "Sessions demoted hot -> warm (slab slot freed, payload in host RAM)"),
    ("hibernates", "serve_hibernates_total", "counter",
     "Sessions hibernated warm -> cold (payload spilled to disk)"),
    ("peer_pages", "serve_peer_pages_total", "counter",
     "Warm sessions paged to a less-loaded peer replica instead of disk"),
    ("wakes", "serve_wakes_total", "counter",
     "Non-resident sessions transparently woken back onto the slab"),
    ("wakes_from_warm", "serve_wakes_from_warm_total", "counter",
     "Wakes served from the host-RAM warm tier"),
    ("wakes_from_cold", "serve_wakes_from_cold_total", "counter",
     "Wakes served from the on-disk cold tier"),
    ("wake_failures", "serve_wake_failures_total", "counter",
     "Wakes that raised (payload re-parked, session still reachable)"),
    ("mean_occupancy", "serve_mean_occupancy", "gauge",
     "Mean requests per dispatch over the recent ring"),
    ("mean_queue_depth", "serve_mean_queue_depth", "gauge",
     "Mean queue depth at tick start over the recent ring"),
    ("ring_capacity", "serve_ring_capacity", "gauge",
     "Capacity of each metrics ring (fill == capacity means wrapped)"),
    # contract-gated EIG surrogate (--eig-scorer surrogate:k buckets):
    # absent (not zero) on servers with no surrogate bucket. GAUGES, not
    # counters: the values are sums over LIVE slots of the slab-carried
    # fit state, and a session closing / demoting / migrating away takes
    # its slot's contribution with it — a decreasing "_total" would make
    # Prometheus rate() fabricate counter-reset spikes
    ("surrogate_rounds", "serve_surrogate_rounds", "gauge",
     "Rounds scored by the surrogate rung, summed over live slots "
     "(decreases when sessions close/demote/migrate)"),
    ("surrogate_fallbacks", "serve_surrogate_fallbacks", "gauge",
     "Surrogate rounds that fell back to the full exact pass on a "
     "violated contract, summed over live slots"),
    ("surrogate_fit_refreshes", "serve_surrogate_fit_refreshes", "gauge",
     "Surrogate ridge-fit refolds (normal-equation updates + re-solves), "
     "summed over live slots"),
    ("surrogate_contract_margin", "serve_surrogate_contract_margin",
     "gauge",
     "Worst escape-gate margin across live slots (best refreshed exact "
     "score minus best unrefreshed prediction; healthy > 0)"),
    # cross-session surrogate prior pool (--surrogate-prior pool): absent
    # (not zero) under the default 'off'. The warmup/rejection pair are
    # live-slot sums of slab-carried counters (same decrease-on-close
    # semantics as the surrogate gauges above); sessions_contributed is
    # pool state and only ever grows, but stays a gauge so the family
    # keeps one scrape semantics
    ("prior_sessions_contributed", "serve_prior_sessions_contributed",
     "gauge",
     "Sessions whose surrogate fit statistics were folded into the "
     "cross-session prior pool"),
    ("prior_warmup_rounds_skipped", "serve_prior_warmup_rounds_skipped",
     "gauge",
     "Exact warmup rounds the pool prior credited to live sessions "
     "(summed over live slots; decreases when sessions close/demote)"),
    ("prior_gate_rejections", "serve_prior_gate_rejections", "gauge",
     "Trust-gate fallbacks fired inside a prior-credited warmup window, "
     "summed over live slots (a transferring-badly prior shows up here)"),
    ("prior_pools", "serve_prior_pools", "gauge",
     "Distinct (task, pool-fingerprint) priors this replica holds"),
    ("prior_rounds_pooled", "serve_prior_rounds_pooled", "gauge",
     "Decay-weighted audited rounds aggregated across all pool priors"),
    ("prior_pool_staleness_seconds", "serve_prior_pool_staleness_seconds",
     "gauge",
     "Age of the LEAST recently refreshed prior pool (seconds since its "
     "last statistic fold) — the learned-decay sensor's staleness axis"),
]

# spill store v3 evidence (serve/spill.py, nested under snapshot["spill"]):
# absent without --tier-spill-dir
_SERVE_SPILL = [
    ("entries", "serve_spill_entries", "gauge",
     "Live hibernated payloads in the spill store"),
    ("segments", "serve_spill_segments", "gauge",
     "Sharded segment files currently on disk"),
    ("live_bytes", "serve_spill_live_bytes", "gauge",
     "Bytes of live frames across all segments"),
    ("log_bytes", "serve_spill_log_bytes", "gauge",
     "Total bytes across all segment files"),
    ("garbage_bytes", "serve_spill_garbage_bytes", "gauge",
     "Bytes of superseded/tombstoned frames awaiting compaction"),
    ("segment_compactions", "serve_spill_segment_compactions_total",
     "counter",
     "Per-segment compactions (live frames copied forward, file "
     "reclaimed) — never stop-the-world"),
    ("put_errors", "serve_spill_put_errors_total", "counter",
     "Spill appends that failed (payload kept warm instead)"),
    ("startup_scan_frames", "serve_spill_startup_scan_frames", "gauge",
     "Frames the last startup had to scan past the persisted index "
     "(0 = pure O(index) startup)"),
]

# decision-quality plane (telemetry/quality.py, nested under
# snapshot["quality"]): absent (not zero) with --no-quality. Each entry
# is (suffix, kind, help, extract) where extract(quality_snapshot)
# returns [(extra_labels, value)] — shared by the single-replica and
# fleet render paths (the fleet path merges a replica label in).

def _q_audit(key):
    def extract(q):
        v = (q.get("audit") or {}).get(key)
        return [] if v is None else [({}, v)]
    return extract


def _q_scalar(key):
    def extract(q):
        v = q.get(key)
        return [] if v is None else [({}, v)]
    return extract


def _q_calibration(key):
    def extract(q):
        return [({"task": task}, cal[key])
                for task, cal in sorted((q.get("calibration") or {}).items())
                if cal.get(key) is not None]
    return extract


def _q_drift(key):
    def extract(q):
        out = []
        for name, det in sorted((q.get("drift") or {}).items()):
            # absent, not zero: a detector whose signal never fed (e.g.
            # surrogate gate pressure on an exact-scorer server) exports
            # no series — families only exist where the signal runs
            if not det.get("observations"):
                continue
            v = det.get(key)
            if v is not None:
                out.append(({"detector": name},
                            float(v) if not isinstance(v, bool)
                            else (1.0 if v else 0.0)))
        return out
    return extract


_SERVE_QUALITY = [
    ("quality_audits_total", "counter",
     "Closed sessions the shadow auditor bitwise-re-replayed",
     _q_audit("audits_total")),
    ("quality_audits_skipped_total", "counter",
     "Shadow audits skipped (scratch slab full / replay setup failure)",
     _q_audit("audits_skipped")),
    ("quality_audit_rounds_verified_total", "counter",
     "Recorded decision rounds bitwise-verified by shadow replays",
     _q_audit("rounds_verified")),
    ("quality_audit_divergences_total", "counter",
     "Shadow replays that bitwise-diverged from the recorded stream "
     "(must stay 0 on a healthy fleet)",
     _q_audit("divergences_total")),
    ("quality_audit_divergences_recent", "gauge",
     "Divergences inside the recent attribution window",
     _q_audit("divergences_recent")),
    ("quality_audit_tampered_total", "counter",
     "Audits whose stream copy was deliberately ulp-tampered by fault "
     "injection (each must show up as a divergence)",
     _q_audit("tampered_total")),
    ("quality_audit_prior_gap", "gauge",
     "Seeded-vs-cold shadow-replay decision gap (EWMA fraction of "
     "warmup rounds where the pool prior changed the pick; a healthy "
     "prior keeps this HIGH — it is actually steering)",
     _q_audit("prior_gap")),
    ("quality_audit_queue_drops_total", "counter",
     "Audit candidates dropped because the audit queue was full",
     _q_scalar("audit_queue_drops")),
    ("quality_pre_dispatch_errors_total", "counter",
     "Calibration pre-dispatch reads that raised (decision math is "
     "never affected; the round just goes unobserved)",
     _q_scalar("pre_dispatch_errors")),
    ("quality_calibration_rounds", "gauge",
     "Labeled rounds folded into the task's calibration accumulators",
     _q_calibration("n")),
    ("quality_calibration_ece", "gauge",
     "Streaming expected calibration error of the served posterior's "
     "predicted-label confidence, per task",
     _q_calibration("ece")),
    ("quality_calibration_brier", "gauge",
     "Streaming Brier score of the served posterior's predicted-label "
     "confidence, per task",
     _q_calibration("brier")),
    ("quality_drift_statistic", "gauge",
     "Current drift-detector statistic (CUSUM s / Page-Hinkley m-min)",
     _q_drift("statistic")),
    ("quality_drift_firing", "gauge",
     "Whether the drift detector is currently firing (0/1)",
     _q_drift("firing")),
    ("quality_drift_fired_total", "counter",
     "Drift-detector fire transitions since start",
     _q_drift("fired_total")),
]


_SERVE_SUMMARIES = [
    ("dispatch_latency", "serve_dispatch_latency_seconds", "dispatches",
     "Slab-step dispatch seconds over the recent ring"),
    ("request_latency", "serve_request_latency_seconds", "requests",
     "Submit-to-result request seconds over the recent ring"),
    ("queue_wait", "serve_queue_wait_seconds", "requests",
     "Submit-to-tick-start queue wait seconds over the recent ring"),
    ("step_latency", "serve_step_latency_seconds", "dispatches",
     "Compiled slab-step execution seconds over the recent ring"),
    ("wake_latency", "serve_wake_latency_seconds", "wakes",
     "Non-resident session wake seconds over the recent ring"),
]

# warm-pool evidence: (warm_pool snapshot key, metric suffix, kind, help)
_SERVE_WARM = [
    ("size", "serve_warm_pool_size", "gauge",
     "AOT-precompiled executables in the warm pool"),
    ("warm_s", "serve_warm_pool_seconds", "gauge",
     "Wall seconds the warm-up pass took"),
    ("hits", "serve_warm_pool_hits_total", "counter",
     "Dispatches served by an AOT-precompiled executable"),
    ("misses", "serve_warm_pool_misses_total", "counter",
     "Dispatches that fell back to lazy jit compilation"),
]


# -- exposition lint ---------------------------------------------------------

_METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
# one sample line: name{labels} value — labels quoted, escapes resolved by
# the tokenizer below, value a float or NaN/+Inf/-Inf; optionally followed
# by an OpenMetrics exemplar ``# {labels} value [timestamp]``. The labels
# group is non-greedy so a greedy match cannot swallow the exemplar's
# braces into the sample's label body (backtracking still recovers label
# values that legitimately contain ``}`` or ``# {``).
_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*?)\})?"
    r" (?P<value>NaN|[+-]Inf|[+-]?[0-9][0-9.eE+-]*)"
    r"(?P<exemplar> # \{(?P<elabels>.*)\}"
    r" (?P<evalue>NaN|[+-]Inf|[+-]?[0-9][0-9.eE+-]*)"
    r"(?: (?P<ets>[0-9][0-9.eE+-]*))?)?$")
_LABEL_PAIR = re.compile(
    r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\\n]|\\["\\n])*)"')
# the WHOLE label body must be comma-separated pairs (an optional trailing
# comma is legal exposition) — substring matching alone would tolerate
# missing separators like k1="a"k2="b"
_LABELS_BODY = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\["\\n])*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\["\\n])*")*,?$')


def lint(text: str) -> list[str]:
    """Violations of the v0.0.4 text-exposition contract (empty = clean).

    The checks a scraping Prometheus would actually choke or mis-ingest
    on: malformed sample lines, unescaped label values or missing label
    separators, duplicate series (same name + label set twice), a HELP
    after its family's TYPE, a family re-opened after other families
    interleaved (duplicate TYPE), samples with no TYPE, bad metric/label
    names, and values that are not valid floats (NaN/±Inf must use the
    canonical spellings). Summary ``_count``/``_sum`` suffixed samples
    belong to their base family. OpenMetrics exemplars
    (``# {trace_id="..."} value``) are validated like sample labels and
    are only legal on gauge and histogram families — a counter or summary
    exemplar is how a hand-rolled renderer silently breaks OpenMetrics
    parsers, so it lints.
    """
    out: list[str] = []
    typed: dict[str, str] = {}       # family -> kind
    helped: set[str] = set()
    closed: set[str] = set()         # families a later line may not reopen
    series: set[tuple] = set()       # (name, canonical labels) seen
    current: str = ""

    def _family_of(name: str) -> str:
        base = name
        for suffix in ("_count", "_sum", "_bucket"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed:
                base = name[: -len(suffix)]
        return base

    for i, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3:
                out.append(f"line {i}: malformed HELP")
                continue
            name = parts[2]
            if name in helped:
                out.append(f"line {i}: duplicate HELP for {name}")
            if name in typed:
                out.append(f"line {i}: HELP for {name} after its TYPE")
            helped.add(name)
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4:
                out.append(f"line {i}: malformed TYPE")
                continue
            name, kind = parts[2], parts[3]
            if not _METRIC_NAME.match(name):
                out.append(f"line {i}: bad metric name {name!r}")
            if kind not in ("counter", "gauge", "summary", "histogram",
                            "untyped"):
                out.append(f"line {i}: unknown TYPE kind {kind!r}")
            if name in typed:
                out.append(f"line {i}: duplicate TYPE for {name}")
            if name in closed:
                out.append(f"line {i}: family {name} reopened after other "
                           "families (non-contiguous)")
            if current and current != name:
                closed.add(current)
            typed[name] = kind
            current = name
            continue
        if line.startswith("#"):
            continue  # comments are legal anywhere
        m = _SAMPLE.match(line)
        if not m:
            out.append(f"line {i}: unparseable sample {line!r}")
            continue
        name = m.group("name")
        fam = _family_of(name)
        if fam not in typed:
            out.append(f"line {i}: sample {name} has no TYPE header")
        elif fam != current:
            out.append(f"line {i}: sample {name} outside its family block")
        labels = m.group("labels")
        pairs: list = []
        if labels is not None:
            if not (labels == "" or _LABELS_BODY.match(labels)):
                out.append(f"line {i}: malformed/unescaped labels "
                           f"{labels!r} (pairs must be comma-separated "
                           "with escaped quoted values)")
            else:
                seen = []
                for lm in _LABEL_PAIR.finditer(labels):
                    if lm.group("k") in seen:
                        out.append(f"line {i}: duplicate label "
                                   f"{lm.group('k')!r}")
                    seen.append(lm.group("k"))
                    pairs.append((lm.group("k"), lm.group("v")))
        if m.group("exemplar"):
            kind = typed.get(fam)
            if kind not in ("gauge", "histogram"):
                out.append(f"line {i}: exemplar on {kind or 'untyped'} "
                           f"family {fam} (exemplars are only legal on "
                           "gauge/histogram samples)")
            elabels = m.group("elabels")
            if elabels and not _LABELS_BODY.match(elabels):
                out.append(f"line {i}: malformed exemplar labels "
                           f"{elabels!r}")
        key = (name, tuple(sorted(pairs)))
        if key in series:
            out.append(f"line {i}: duplicate series {name}"
                       f"{{{dict(pairs)}}} (same name + label set "
                       "emitted twice)")
        series.add(key)
        val = m.group("value")
        if val not in ("NaN", "+Inf", "-Inf"):
            try:
                float(val)
            except ValueError:
                out.append(f"line {i}: bad value {val!r}")
    return out


def _render_serve(out: list, snap: dict, prefix: str) -> None:
    for key, suffix, kind, help in _SERVE_SCALARS:
        v = snap.get(key)
        if v is not None:
            _family(out, _name(prefix, suffix), kind, help, [({}, v)])
    warm = snap.get("warm_pool") or {}
    for key, suffix, kind, help in _SERVE_WARM:
        v = warm.get(key)
        if v is not None:
            _family(out, _name(prefix, suffix), kind, help, [({}, v)])
    tiers = snap.get("tiers") or {}
    for tier in ("hot", "warm", "cold"):
        if tier in tiers:
            _family(out, _name(prefix, f"serve_sessions_{tier}"), "gauge",
                    f"Open sessions currently in the {tier} tier",
                    [({}, tiers[tier])])
    spill = snap.get("spill") or {}
    for key, suffix, kind, help in _SERVE_SPILL:
        v = spill.get(key)
        if v is not None:
            _family(out, _name(prefix, suffix), kind, help, [({}, v)])
    quality = snap.get("quality")
    if isinstance(quality, dict):
        for suffix, kind, help, extract in _SERVE_QUALITY:
            samples = extract(quality)
            if samples:
                _family(out, _name(prefix, suffix), kind, help, samples)
    ages = (snap.get("prior_pool_ages_seconds")
            or (snap.get("prior_pool") or {}).get("pool_ages_seconds")
            or {})
    if ages:
        _family(out, _name(prefix, "serve_prior_pool_age_seconds"),
                "gauge",
                "Seconds since each prior pool's last statistic fold",
                [({"pool": k}, v) for k, v in sorted(ages.items())])
    fills = snap.get("ring_fill") or {}
    if fills:
        _family(out, _name(prefix, "serve_ring_fill"), "gauge",
                "Events currently held in a metrics ring",
                [({"ring": k}, n) for k, n in sorted(fills.items())])
    exemplars = snap.get("exemplars") or {}
    samples = [({"ring": ring}, ex)
               for ring, ex in sorted(exemplars.items())
               if ex and ex.get("trace_id")]
    if samples:
        _exemplar_family(
            out, _name(prefix, "serve_latency_outlier_seconds"),
            "Latest p99-bucket latency outlier per ring; the exemplar's "
            "trace_id joins it to its stitched distributed trace",
            samples)
    for key, suffix, count_key, help in _SERVE_SUMMARIES:
        q = snap.get(key) or {}
        name = _name(prefix, suffix)
        samples = []
        for qk, quantile in (("p50_ms", "0.5"), ("p99_ms", "0.99")):
            if q.get(qk) is not None:
                samples.append(({"quantile": quantile}, q[qk] / 1e3))
        if not samples:
            continue
        _family(out, name, "summary", help, samples)
        out.append(_line(name + "_count", {}, snap.get(count_key, 0)))
