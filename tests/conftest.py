"""Shared pytest config: deterministic hypothesis profile (reproducible CI
across runs — property tests explore a fixed corpus).

``hypothesis`` is optional: minimal environments still collect and run the
160+ non-property tests; property tests skip via the ``_hypothesis_compat``
shim the test modules import instead of ``hypothesis`` directly."""

try:
    from hypothesis import settings
except ImportError:
    settings = None

if settings is not None:
    settings.register_profile("ci", derandomize=True, deadline=None)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs on the GPU, skips "
        "elsewhere with a reason)")
