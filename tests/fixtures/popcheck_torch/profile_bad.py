"""Bad: tuning profiles read without the version/digest gate.

``load_profile`` parses but does not validate; skipping ``check_profile``
means a stale-format or hand-edited artifact silently tunes the service.
"""

from repro_torch import tuning
from repro_torch.tuning import load_profile


def read_direct(path):
    prof = load_profile(path)        # BAD: never checked
    return prof.domains


def read_via_alias(path):
    prof = tuning.load_profile(path)  # BAD: never checked
    return prof.launch_cost


# BAD: module-scope read, no check anywhere at module scope
PROFILE = load_profile("TUNING_profile.json")
