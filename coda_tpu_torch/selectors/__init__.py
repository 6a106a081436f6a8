from coda_tpu_torch.selectors.activetesting import make_activetesting
from coda_tpu_torch.selectors.coda import CODAHyperparams, make_coda
from coda_tpu_torch.selectors.iid import make_iid
from coda_tpu_torch.selectors.modelpicker import (
    DEFAULT_EPS,
    TASK_EPS,
    make_modelpicker,
)
from coda_tpu_torch.selectors.protocol import Selector, SelectResult
from coda_tpu_torch.selectors.uncertainty import make_uncertainty
from coda_tpu_torch.selectors.vma import make_vma

SELECTOR_FACTORIES = {
    "iid": make_iid,
    "uncertainty": make_uncertainty,
    "coda": make_coda,
    "activetesting": make_activetesting,
    "vma": make_vma,
    "model_picker": make_modelpicker,
}

__all__ = [
    "Selector",
    "SelectResult",
    "make_coda",
    "CODAHyperparams",
    "make_iid",
    "make_uncertainty",
    "make_activetesting",
    "make_vma",
    "make_modelpicker",
    "TASK_EPS",
    "DEFAULT_EPS",
    "SELECTOR_FACTORIES",
]
