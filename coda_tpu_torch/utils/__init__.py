from coda_tpu_torch.utils.checks import check_finite, check_prob

__all__ = ["check_finite", "check_prob"]
