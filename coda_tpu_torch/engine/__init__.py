from coda_tpu_torch.engine.loop import (
    ExperimentResult,
    batched_select_keys,
    build_batched_experiment_fn,
    build_experiment_fn,
    make_batched_experiment_fn,
    make_batched_step_fn,
    make_step_fn,
    run_seeds_compiled,
)

__all__ = [
    "ExperimentResult",
    "batched_select_keys",
    "build_batched_experiment_fn",
    "build_experiment_fn",
    "make_batched_experiment_fn",
    "make_batched_step_fn",
    "make_step_fn",
    "run_seeds_compiled",
]
