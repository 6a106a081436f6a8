"""Telemetry of the port. So far the run-record half of the decision
flight recorder (:mod:`coda_tpu_torch.telemetry.recorder`); spans, the
registry and the exporters come with slice 7 of the port."""

from coda_tpu_torch.telemetry.recorder import (
    CROSS_BACKEND_SCORE_TOL,
    KNOB_FIELDS,
    RECORD_SCHEMA_VERSION,
    REQUIRED_ARRAYS,
    RunRecord,
    dataset_digest,
    environment_fingerprint,
    is_record_dir,
    knobs_from_args,
    optional_arrays,
    required_arrays,
)

__all__ = [
    "CROSS_BACKEND_SCORE_TOL",
    "KNOB_FIELDS",
    "RECORD_SCHEMA_VERSION",
    "REQUIRED_ARRAYS",
    "RunRecord",
    "dataset_digest",
    "environment_fingerprint",
    "is_record_dir",
    "knobs_from_args",
    "optional_arrays",
    "required_arrays",
]
