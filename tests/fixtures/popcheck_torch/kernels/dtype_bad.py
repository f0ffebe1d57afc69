"""Known-bad fixture (lives under kernels/): f64 creep in a kernel's
plain version."""
import torch

torch.set_default_dtype(torch.float64)          # BAD: repo-wide f64


def reference(A, x):
    acc = torch.zeros(A.shape[0], dtype=torch.float64)     # BAD: f64 accum
    return acc + A.double() @ torch.as_tensor(x, dtype=torch.double)  # BAD x2
