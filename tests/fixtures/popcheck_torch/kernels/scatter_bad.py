"""Known-bad fixture (lives under kernels/): atomic scatters in a kernel
module's fold."""
import torch


def fold(out, wide, ids):
    out = out.index_add_(0, ids, wide)                   # BAD: index_add_
    seg = torch.zeros_like(out).scatter_add_(0, ids, wide)   # BAD: scatter
    return out + seg
