"""The port's offline profiler (``repro_torch.tuning.build_profile``)
against the reference's: the fast one-domain build on the CPU measures the
same quality curve, and the profile it seals passes the reference's
``check_profile``.  Most of this file's time is the reference's own fast
build (its solves compile once per shape)."""

from repro import tuning as rtuning
from repro_torch.core import pdhg as tpdhg
from repro_torch.tuning import DomainCurves, build_profile, profile_digest

from test_torch_pdhg import reference_probes
from test_torch_tuning import CPU, _ref_profile

# the fast build's quality curve, port against reference, at equal ks
PROFILE_QUALITY_TOL = 1e-3


def test_fast_profile_quality_matches(monkeypatch):
    """The fast one-domain build on the CPU: the port's quality curve
    within PROFILE_QUALITY_TOL of the reference's at equal ks, both
    drawing the reference's equilibration probes; the port's profile
    names the torch device type and version and seals."""
    monkeypatch.setattr(tpdhg, "rademacher_probes", reference_probes)
    kw = dict(fast=True, domains=("gavel",), measure_launch=False,
              measure_backends=False)
    mine = build_profile(device=CPU, **kw)
    ref = rtuning.build_profile(**kw)
    a = dict(mine.domains["gavel"].quality_vs_k)
    b = dict(ref.domains["gavel"].quality_vs_k)
    assert sorted(a) == sorted(b)
    for k in a:
        assert abs(a[k] - b[k]) < PROFILE_QUALITY_TOL, (k, a[k], b[k])
    assert mine.platform == "cpu"
    assert mine.jax_version.startswith("torch-")
    assert mine.domains["gavel"].probe_n == ref.domains["gavel"].probe_n
    assert isinstance(mine.domains["gavel"], DomainCurves)
    mine.digest = profile_digest(mine)
    assert rtuning.check_profile(_ref_profile(mine)).digest == \
        mine.digest
