"""What the readers of the program's spans and counters share
(ac3acm_tpu_torch.utils.trace, recorded while the traced window's
profiler records): a span metric is the median over the window's steps
(chunks) of each step's summed span time, as host_call_ms is.  Both
return None on a program without spans, or where none was recorded."""
from ..core.runner import median


def step_ms(*names):
    """The spans named `names`, summed a step, median over the steps, in
    ms."""
    try:
        from ac3acm_tpu_torch.utils.trace import spans
    except ImportError:
        return None
    per_step = {}
    for name, step, t0, t1 in spans():
        if name in names:
            per_step[step] = per_step.get(step, 0) + (t1 - t0)
    return median(list(per_step.values())) * 1e-6 if per_step else None


def counter(name):
    """The counter `name`: {step: total}."""
    try:
        from ac3acm_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    return counters().get(name) or None
