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

__all__ = [
    "ExperimentResult",
    "RoundTrace",
    "RunTraceAux",
    "batched_select_keys",
    "build_batched_experiment_fn",
    "build_experiment_fn",
    "make_batched_experiment_fn",
    "make_batched_step_fn",
    "make_round_trace",
    "make_step_fn",
    "run_seeds_compiled",
    "run_seeds_recorded",
]
