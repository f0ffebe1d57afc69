"""Known-bad fixture: host syncs reachable from a hot root."""
import numpy as np
import torch


def _inner_step(x):
    torch.as_tensor(x)                  # fine: stays on the device
    gap = float(torch.sum(x))           # BAD: float() of a torch call
    host = np.asarray(x)                # BAD: np.asarray readback
    torch.cuda.synchronize()            # BAD: sync in the hot loop
    if torch.any(x > 0):                # BAD: Python branch on device data
        host = host + 1
    return gap, host


# popcheck: hot
def run_hot(x):
    val = _inner_step(x)
    tail = x.sum().item()               # BAD: .item() readback
    got = x.cpu()                       # BAD: explicit copy to the host
    return val, tail, got
