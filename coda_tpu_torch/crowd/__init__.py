"""The crowd oracle: noisy, abstaining, asynchronous labelers (counterpart
of ``coda_tpu/crowd``).

  * :mod:`coda_tpu_torch.crowd.oracle`: the seeded annotator pool
    (honest and adversarial confusion matrices), the verb vocabulary, the
    device-side vote draws and the host-side :class:`HostCrowdSampler`;
  * :mod:`coda_tpu_torch.crowd.reliability`: the Dawid-Skene annotator
    posterior, its vote aggregation and the trust gate;
  * :mod:`coda_tpu_torch.crowd.loop`: the crowd experiment, the engine's
    rounds with the reliability state carried beside the selector's and
    answers applied through the weighted updates (``update_w``,
    ``update_qw``). A clean config runs the engine's own program.
"""

from coda_tpu_torch.crowd.oracle import (  # noqa: F401
    CROWD_SALT,
    CrowdConfig,
    HostCrowdSampler,
    make_annotators,
    parse_oracle_spec,
    planted_accuracies,
    sample_votes,
)
from coda_tpu_torch.crowd.reliability import (  # noqa: F401
    ReliabilityState,
    accuracy_movement,
    aggregate_votes,
    annotator_accuracy,
    init_reliability,
)
from coda_tpu_torch.crowd.loop import (  # noqa: F401
    CrowdAux,
    build_crowd_experiment_fn,
    build_recording_crowd_experiment_fn,
    make_crowd_step_fn,
    run_seeds_crowd,
    run_seeds_crowd_recorded,
)
