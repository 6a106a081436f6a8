"""The port's experiment tracking store (the reference's MLflow-schema
sqlite layout)."""

from coda_tpu_torch.tracking.store import Run, TrackingStore

__all__ = ["TrackingStore", "Run"]
