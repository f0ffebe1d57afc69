"""Good twin: gather + a fixed-order sum (the structured kernels' design)."""
import torch


def fold(val, idx, v, n_out):
    out = torch.sum(val * torch.gather(v, 0, idx.reshape(-1)).reshape(
        idx.shape), dim=0)
    onehot = idx[:, None] == torch.arange(n_out)[None, :]
    # a plain index write, not an accumulating one
    out = out.index_put_((idx[:1],), out[:1], accumulate=False)
    return out + torch.sum(val[:, None] * onehot.to(val.dtype), dim=0)
