"""Good twin: every TuningProfile read passes through ``check_profile``
in the same scope before the curves are trusted."""

from repro_torch import tuning
from repro_torch.tuning import check_profile, load_profile


def read_direct(path):
    # the idiomatic sealed form (check_profile returns the profile)
    return check_profile(load_profile(path))


def read_via_alias(path):
    prof = tuning.load_profile(path)
    tuning.check_profile(prof, platform="cuda")
    return prof.launch_cost


def unrelated_method(store):
    # a load_profile METHOD on some other object is not the tuning door
    return store.load_profile("latest")


PROFILE = check_profile(load_profile("TUNING_profile.json"))
