from sstem_tpu_torch.utils.debug import StepTimer, enable_nan_checks, profile_trace

__all__ = ["StepTimer", "enable_nan_checks", "profile_trace"]
