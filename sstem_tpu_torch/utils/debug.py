"""Debug and observability tools (counterpart of ``sstem_tpu/utils/debug.py``).

  * ``enable_nan_checks``: anomaly detection in autograd and a check on every
    module's forward output (the counterpart of ``jax_debug_nans`` and
    ``jax_debug_infs``)
  * ``profile_trace``: a context manager around ``torch.profiler`` that
    writes a TensorBoard-loadable trace of host and device activity
  * ``StepTimer``: per-phase wall time, accumulated
"""

import contextlib
import time
from collections import defaultdict

import torch

_nan_hook = None  # the handle of the global forward hook, while it is on


def _raise_if_not_finite(module, inputs, output):
    outs = output if isinstance(output, (tuple, list)) else (
        output.values() if isinstance(output, dict) else (output,))
    for t in outs:
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and not bool(torch.isfinite(t).all())):
            raise FloatingPointError(
                f"{type(module).__name__} returned a non-finite value")


def enable_nan_checks(enable=True):
    """Turn on (or, with False, off) ``torch.autograd.set_detect_anomaly``
    and a forward hook on every module that raises ``FloatingPointError``
    when a floating output holds a NaN or an infinity. The check reads each
    output back to the host, so it synchronises the card at every module."""
    global _nan_hook
    torch.autograd.set_detect_anomaly(enable)
    if _nan_hook is not None:
        _nan_hook.remove()
        _nan_hook = None
    if enable:
        _nan_hook = torch.nn.modules.module.register_module_forward_hook(
            _raise_if_not_finite)


@contextlib.contextmanager
def profile_trace(logdir):
    """``with profile_trace(logdir): ...`` writes a TensorBoard trace of the
    block (host activity, and the card's when CUDA is available) into
    ``logdir`` as ``*.pt.trace.json``. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StepTimer:
    """Accumulates per-phase wall time; ``report()`` gives each phase's total
    and mean seconds, as the reference's per-stage timers do
    (``sff_scripts_fusion/inference.py:194-201``). Time on the card counts
    only if the phase ends in a synchronising call."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def report(self):
        return {
            name: {"total_s": self.totals[name],
                   "mean_s": self.totals[name] / max(self.counts[name], 1)}
            for name in self.totals
        }
