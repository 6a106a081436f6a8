"""Prometheus text exposition of the telemetry registry (counterpart of
``coda_tpu/telemetry/prometheus.py``).

:func:`render` turns the counter/gauge registry into the Prometheus text
exposition format (version 0.0.4), written as ``metrics.prom`` beside
``telemetry.json``; :func:`lint` checks a text against that contract. No
client library: the format is lines of ``name{labels} value`` under
``# HELP`` / ``# TYPE`` headers. The serve, fleet and quality families of
the reference come with the serve layer (slices 8-9 of the port).
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


def render(registry: Optional[Registry] = None, serve_metrics=None,
           prefix: str = "coda") -> str:
    """The registry as exposition text. ``serve_metrics`` (a serve layer's
    snapshot) comes with the serve layer, slice 8 of the port."""
    if serve_metrics is not None:
        raise NotImplementedError(
            "the serve metric families come with the serve layer (slice 8 "
            "of the port)")
    out: list[str] = []
    reg = registry if registry is not None else get_registry()
    for m in reg.collect():
        _family(out, _name(prefix, m.name), m.kind, m.help, m.samples())
    return "\n".join(out) + "\n"


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
