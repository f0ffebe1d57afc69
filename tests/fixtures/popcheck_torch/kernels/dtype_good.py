"""Good twin: f32 end to end."""
import torch


def reference(A, x):
    acc = torch.zeros(A.shape[0], dtype=torch.float32)
    return acc + A.float() @ torch.as_tensor(x, dtype=torch.float32)
