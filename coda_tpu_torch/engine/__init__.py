from coda_tpu_torch.engine.checkpoint import (
    ExperimentCheckpointer,
    latest_step,
    make_resumable_runner,
    run_experiment_resumable,
)
from coda_tpu_torch.engine.loop import (
    ExperimentResult,
    RoundTrace,
    RunTraceAux,
    batched_select_keys,
    build_batched_experiment_fn,
    build_experiment_fn,
    make_batched_experiment_fn,
    make_batched_step_fn,
    make_round_trace,
    make_step_fn,
    run_seeds_compiled,
    run_seeds_recorded,
)
from coda_tpu_torch.engine.replay import replay_record, verify_replay
from coda_tpu_torch.engine.suite import SuiteRunner

__all__ = [
    "ExperimentCheckpointer",
    "ExperimentResult",
    "RoundTrace",
    "RunTraceAux",
    "SuiteRunner",
    "batched_select_keys",
    "build_batched_experiment_fn",
    "build_experiment_fn",
    "latest_step",
    "make_batched_experiment_fn",
    "make_batched_step_fn",
    "make_resumable_runner",
    "make_round_trace",
    "make_step_fn",
    "replay_record",
    "run_experiment_resumable",
    "run_seeds_compiled",
    "run_seeds_recorded",
    "verify_replay",
]
