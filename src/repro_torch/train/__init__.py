"""Training substrate (the port of ``repro/train``): AdamW, the
microbatched train step, gradient compression."""
from .optimizer import AdamWConfig, AdamWState, init_state, apply_updates
from .train_step import (TrainConfig, make_train_step, jit_train_step,
                         cross_entropy)
