"""The round generator: every round is drawn from the seed; sizes and the
churn schedule are the same for every seed."""

import numpy as np

from popbench_tiny import config
from popbench.generate import Rounds, load_mix


def draw(seed, n=7):
    gen = Rounds(config(), load_mix("drift"), seed)
    return [gen.next() for _ in range(n)]


def test_same_seed_same_rounds():
    a, b = draw(2**33 + 17), draw(2**33 + 17)
    for fa, fb in zip(a, b):
        assert fa.keys() == fb.keys()
        for key in fa:
            assert np.array_equal(np.asarray(fa[key]), np.asarray(fb[key]))


def test_seeds_draw_other_data_of_the_same_sizes():
    a, b = draw(2**31 + 1), draw(2**31 + 2)
    for fa, fb in zip(a, b):
        assert fa["T"].shape == fb["T"].shape
        assert np.array_equal(fa["num_workers"], fb["num_workers"])
        assert not np.array_equal(fa["T"], fb["T"])
    assert [f["churn"] for f in a] == [f["churn"] for f in b] == \
        [False] * 5 + [True, False]


def test_the_first_round_is_the_ports_workload_of_that_seed():
    seed = 2**31 + 3
    fleet = draw(seed, n=1)[0]
    from repro_torch.problems.cluster_scheduling import make_cluster_workload
    wl = make_cluster_workload(256, num_workers=(64, 64, 64), seed=seed)
    assert np.array_equal(fleet["T"], wl.T)
    assert np.array_equal(fleet["w"], wl.w)


def test_churn_replaces_a_share_under_new_ids():
    rounds = draw(99)
    before, after = rounds[4]["ids"], rounds[5]["ids"]
    n = before.shape[0]
    gone = np.setdiff1d(before, after)
    new = np.setdiff1d(after, before)
    assert gone.size == new.size == max(1, int(round(0.05 * n)))
    assert new.min() > before.max()
    assert np.unique(after).size == n


def test_drift_stays_in_range():
    a = draw(5, n=2)
    ratio = a[1]["T"] / a[0]["T"]
    assert ratio.min() >= 0.97 and ratio.max() <= 1.03
