"""Data pipeline (the port of ``repro/data``): synthetic token streams
staged onto a device."""
from .pipeline import TokenPipeline, DevicePrefetcher
