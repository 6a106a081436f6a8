"""The crowd model: seeded annotator pools and the oracle verb protocol
(counterpart of ``coda_tpu/crowd/oracle.py``).

An annotator is a ``(C, C)`` row-stochastic confusion matrix: row ``z`` is
the response distribution when the true class is ``z``. Honest annotators
put ``acc`` on the diagonal and spread the rest uniformly; adversarial
(poisoned) annotators put their mass on the SHIFTED diagonal ``(z + 1) %
C``, a systematic mislabeler the reliability posterior must learn to
down-weight.

Verbs: ``answer`` (a label drawn from the annotator's confusion row),
``abstain`` (no label; a weighted update with w = 0 is the structural
no-op), ``defer`` (the answer arrives ``k`` rounds late; host-side
delivery, the serve layer's) and ``poison`` (the adversarial family).

Everything is deterministic. The device-side votes derive from the
round's key through a fold-in salt (:data:`CROWD_SALT`), so the clean
run's select/best key stream is untouched; the draws are the reference's
threefry bits (``coda_tpu_torch/random.py``). The annotator pool is host
numpy seeded by ``np.random.RandomState``, built once, then placed on the
device. :class:`HostCrowdSampler` is the serve half: counter-addressed
SHA-256 draws, the same ``(seed, session, round, slot)`` always giving the
same verb.

The engine draws a run's votes before its rounds: :func:`draw_votes`
takes the run's round keys (a batch) on the host and gives every round's
annotator ids, Gumbel noise and abstention flags, uploaded once;
:func:`votes_from_draws` turns one round's draws and the chosen point's
true class into responses on the device. :func:`sample_votes` is the two
in one, the reference's function.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device

# fold-in salt separating the crowd's vote randomness from the engine's
# select/best key stream (the reference's constant: the same bits)
CROWD_SALT = 0xC403D


class CrowdConfig(NamedTuple):
    """One crowd-oracle configuration (parsed from ``--oracle-noise``)."""

    spec: str = "clean"          # the original spec string (the knob)
    clean: bool = True           # clean => the plain-oracle program runs
    annotators: int = 8          # pool size A
    votes: int = 3               # votes drawn per labeled item
    acc_lo: float = 0.55         # honest-annotator accuracy range
    acc_hi: float = 0.95
    abstain: float = 0.0         # per-vote abstention probability
    adversarial: int = 0         # poisoned annotators (last slots of the pool)
    reliability: str = "learned"  # 'learned' (DS posterior) | 'majority'
    trust_votes: float = 32.0    # pool votes before the learned gate opens
    defer: float = 0.0           # per-answer deferral probability (serve verb)
    defer_depth: int = 4         # max rounds an answer arrives late
    seed: int = 0                # the annotator-pool / vote-stream seed


def parse_oracle_spec(spec: Optional[str]) -> CrowdConfig:
    """``None``/``'clean'`` -> the clean config; otherwise comma-separated
    ``k=v`` pairs, e.g.
    ``annotators=8,votes=3,acc=0.55:0.95,abstain=0.1,adversarial=1,
    trust=32,defer=0.2:4,reliability=learned,seed=0``.
    Fails loudly on unknown keys, with the reference's messages."""
    if spec is None or spec == "clean":
        return CrowdConfig(spec="clean", clean=True)
    cfg: dict = {"spec": spec, "clean": False}
    for kv in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in kv:
            raise ValueError(f"oracle-noise param {kv!r} is not key=value")
        k, v = kv.split("=", 1)
        if k == "annotators":
            cfg["annotators"] = int(v)
        elif k == "votes":
            cfg["votes"] = int(v)
        elif k == "acc":
            lo, _, hi = v.partition(":")
            cfg["acc_lo"] = float(lo)
            cfg["acc_hi"] = float(hi or lo)
        elif k == "abstain":
            cfg["abstain"] = float(v)
        elif k == "adversarial":
            cfg["adversarial"] = int(v)
        elif k == "trust":
            cfg["trust_votes"] = float(v)
        elif k == "defer":
            p, _, d = v.partition(":")
            cfg["defer"] = float(p)
            if d:
                cfg["defer_depth"] = int(d)
        elif k == "reliability":
            if v not in ("learned", "majority"):
                raise ValueError(
                    f"oracle-noise reliability={v!r} (use 'learned' or "
                    "'majority')")
            cfg["reliability"] = v
        elif k == "seed":
            cfg["seed"] = int(v)
        else:
            raise ValueError(
                f"unknown oracle-noise key {k!r} in {spec!r}")
    out = CrowdConfig(**cfg)
    if out.annotators < 1 or out.votes < 1:
        raise ValueError(f"oracle-noise needs annotators >= 1 and "
                         f"votes >= 1 (got {out.annotators}, {out.votes})")
    if out.adversarial >= out.annotators:
        raise ValueError(
            f"adversarial={out.adversarial} must leave at least one "
            f"honest annotator (pool of {out.annotators})")
    if not (0.0 <= out.abstain < 1.0) or not (0.0 <= out.defer < 1.0):
        raise ValueError("abstain/defer rates must be in [0, 1)")
    return out


def planted_accuracies(cfg: CrowdConfig) -> np.ndarray:
    """The pool's (A,) diagonal accuracies: honest annotators drawn
    uniformly from ``[acc_lo, acc_hi]`` by the seeded generator,
    adversarial slots at that value ON THE SHIFTED DIAGONAL. Host numpy,
    the values :func:`make_annotators` bakes into the confusions."""
    rng = np.random.RandomState(cfg.seed)
    return cfg.acc_lo + (cfg.acc_hi - cfg.acc_lo) * rng.rand(cfg.annotators)


def annotator_matrices(cfg: CrowdConfig, n_classes: int) -> np.ndarray:
    """The pool's ``(A, C, C)`` float32 confusions as a host array (the
    reference's float64 arithmetic, rounded once)."""
    A, C = cfg.annotators, n_classes
    acc = planted_accuracies(cfg)                                # (A,)
    eye = np.eye(C)
    shift = np.eye(C)[:, list(range(1, C)) + [0]]                # (z+1)%C
    off = (1.0 - acc)[:, None, None] / max(C - 1, 1)
    conf = acc[:, None, None] * eye[None] + off * (1.0 - eye[None])
    if cfg.adversarial:
        bad = (acc[:, None, None] * shift[None]
               + off * (1.0 - shift[None]))
        is_bad = np.arange(A)[:, None, None] >= (A - cfg.adversarial)
        conf = np.where(is_bad, bad, conf)
    return conf.astype(np.float32)


def make_annotators(cfg: CrowdConfig, n_classes: int,
                    device: DeviceLike = None) -> torch.Tensor:
    """The pool's ``(A, C, C)`` row-stochastic confusions on ``device``
    (default: the card). Deterministic in ``cfg.seed``; the last
    ``cfg.adversarial`` slots are poisoned (accuracy mass on ``(z + 1) %
    C``)."""
    return torch.from_numpy(annotator_matrices(cfg, n_classes)).to(
        resolve_device(device))


class VoteDraws(NamedTuple):
    """The key-derived half of a round's votes (leading axes: the batch
    of keys they were drawn with)."""

    ann_ids: torch.Tensor    # (..., V) int64 — who votes
    noise: torch.Tensor      # (..., V, C) float32 — the responses' Gumbel
    answered: torch.Tensor   # (..., V) bool — False where a vote abstains


def draw_votes(key: torch.Tensor, cfg: CrowdConfig,
               n_classes: int) -> VoteDraws:
    """The reference's ``sample_votes`` draws from ``key`` (a ``(..., 2)``
    batch of keys gives every row's): ``split`` into three keys,
    ``randint`` for the annotator ids, the Gumbel noise ``categorical``
    adds to the log confusion row, ``uniform`` for abstention. Computed on
    the key's device."""
    V = cfg.votes
    k = trandom.split(key, 3)
    ann_ids = trandom.randint(k[..., 0, :], (V,), 0, cfg.annotators)
    noise = trandom.gumbel(k[..., 1, :], (V, n_classes))
    if cfg.abstain > 0.0:
        answered = trandom.uniform(k[..., 2, :], (V,)) >= cfg.abstain
    else:
        answered = torch.ones(ann_ids.shape, dtype=torch.bool,
                              device=ann_ids.device)
    return VoteDraws(ann_ids, noise, answered)


def log_confusions(confusions: torch.Tensor) -> torch.Tensor:
    """``log(clip(confusions, 1e-30))``, the logits ``categorical`` draws
    a response from (taken once a run; a row of it is the log of the
    row)."""
    return torch.log(torch.clamp(confusions, min=1e-30))


def votes_from_draws(draws: VoteDraws, log_conf: torch.Tensor,
                     true_class: torch.Tensor) -> torch.Tensor:
    """The (..., V) responses of one round's votes: the argmax of the
    Gumbel noise plus each annotator's log confusion row at
    ``true_class`` (0-d, or one a row of a ``(S,)`` batch)."""
    tc = true_class.to(torch.int64)
    if tc.dim():
        tc = tc[:, None]
    return torch.argmax(draws.noise + log_conf[draws.ann_ids, tc], dim=-1)


def sample_votes(key: torch.Tensor, confusions: torch.Tensor, true_class,
                 cfg: CrowdConfig):
    """One round's crowd response: ``(ann_ids (V,) int64, responses (V,)
    int64, answered (V,) bool)``, ``V = cfg.votes`` annotators drawn
    uniformly with replacement, each answering from its confusion row for
    ``true_class`` or abstaining (an abstained slot keeps its response
    draw; consumers mask on ``answered``). The draws run on
    ``confusions``' device."""
    draws = draw_votes(key.to(confusions.device), cfg, confusions.shape[-1])
    tc = torch.as_tensor(true_class, device=confusions.device)
    responses = votes_from_draws(draws, log_confusions(confusions), tc)
    return draws.ann_ids, responses, draws.answered


def _draw(seed: int, *fields) -> float:
    """Counter-addressed uniform in [0, 1): a pure function of ``(seed,
    fields...)``, so a host-side crowd run replays exactly from its
    spec."""
    h = hashlib.sha256(
        ":".join([str(seed)] + [str(f) for f in fields]).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class HostCrowdSampler:
    """Host-side deterministic crowd: the serve/loadgen half of the verb
    protocol. ``answer(session, round, slot, true_label)`` returns::

        {"verb": "answer" | "abstain",
         "label": int,          # the (possibly noisy) response
         "annotator": int,      # who answered
         "defer": int}          # rounds late (0 = deliver now)

    A deferred answer is the SAME answer delivered late; the caller holds
    it for ``defer`` rounds and posts it out of order."""

    def __init__(self, cfg: CrowdConfig, n_classes: int):
        self.cfg = cfg
        self.n_classes = n_classes
        self.confusions = annotator_matrices(cfg, n_classes)

    def answer(self, session: str, round_idx: int, slot: int,
               true_label: int, attempt: int = 0) -> dict:
        # `attempt` re-addresses the draw when a slot's annotator abstained
        # and the caller re-requests the item
        cfg = self.cfg
        key = (session, round_idx, slot, attempt)
        ann = int(_draw(cfg.seed, "who", *key) * cfg.annotators)
        ann = min(ann, cfg.annotators - 1)
        if cfg.clean:
            return {"verb": "answer", "label": int(true_label),
                    "annotator": ann, "defer": 0}
        if _draw(cfg.seed, "abstain", *key) < cfg.abstain:
            return {"verb": "abstain", "label": int(true_label),
                    "annotator": ann, "defer": 0}
        # invert the annotator's confusion row CDF at a deterministic draw
        row = self.confusions[ann, int(true_label)]
        u = _draw(cfg.seed, "resp", *key)
        label = int(np.searchsorted(np.cumsum(row), u))
        label = min(label, self.n_classes - 1)
        defer = 0
        if cfg.defer > 0.0 and _draw(cfg.seed, "defer", *key) < cfg.defer:
            defer = 1 + int(
                _draw(cfg.seed, "depth", *key) * cfg.defer_depth)
        return {"verb": "answer", "label": label, "annotator": ann,
                "defer": defer}
