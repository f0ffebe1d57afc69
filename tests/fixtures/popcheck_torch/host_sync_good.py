"""Good twin: same structure, everything stays on the device; readbacks
only in the (cold) caller, which is not reachable from the hot root."""
import numpy as np
import torch


def _inner_step(x):
    gap = torch.sum(x)
    mask = torch.where(x > 0, x + 1.0, x)   # data-dependent via where
    if torch.cuda.is_available():           # a host query, not device data
        mask = mask * 1.0
    return gap, mask


# popcheck: hot
def run_hot(x):
    return _inner_step(torch.as_tensor(x))


def cold_report(x):
    # not reachable from run_hot: boundary readbacks are the point here
    gap, mask = run_hot(x)
    torch.cuda.synchronize()
    return float(np.asarray(gap.cpu()))
