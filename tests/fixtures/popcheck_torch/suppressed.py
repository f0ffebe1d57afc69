"""Fixture: known-bad patterns silenced by the suppression syntax — every
finding here must be suppressed (tests assert this file scans clean)."""
import torch


# popcheck: hot
def run_hot(x):
    # measured once at the boundary  # popcheck: disable=host-sync-in-hot-path
    gap = float(torch.sum(x))
    # popcheck: disable=host-sync-in-hot-path
    tail = x.sum().item()
    return gap, tail
