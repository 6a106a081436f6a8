from coda_tpu_torch.selectors.coda import CODAHyperparams, make_coda
from coda_tpu_torch.selectors.protocol import Selector, SelectResult

__all__ = ["CODAHyperparams", "make_coda", "Selector", "SelectResult"]
