from coda_tpu_torch.engine.loop import (
    ExperimentResult,
    build_experiment_fn,
    make_step_fn,
    run_seeds_compiled,
)

__all__ = [
    "ExperimentResult",
    "build_experiment_fn",
    "make_step_fn",
    "run_seeds_compiled",
]
