"""Serving substrate (the port of ``repro/serve``): the KV/state-cached
decode engine and the POP request balancer."""
from .engine import (BalanceResult, ServeConfig, balance_requests,
                     jit_serve_step, make_serve_step, prefill)

__all__ = ["BalanceResult", "ServeConfig", "balance_requests",
           "jit_serve_step", "make_serve_step", "prefill"]
