"""The one traffic generator: the same seed gives the same work, another
seed the same sizes in another order; the packer gives the rows of the
port's ``train.data.pack_documents``."""

import itertools

import numpy as np
import pytest

from portbench import traffic

from .tiny import CLOSED, DOCS, OPEN


def _open(seed, rate=5.0, seconds=4.0):
    return traffic.open_loop(OPEN, rate, seconds, 256, seed, 3.0)


def test_open_loop_repeats_for_a_seed():
    a, b = _open(2**40 + 3), _open(2**40 + 3)
    assert [(r.prompt, r.max_new, r.due, r.counted) for r in a] == \
        [(r.prompt, r.max_new, r.due, r.counted) for r in b]


def test_open_loop_window_holds_the_same_work_for_every_seed():
    a, b = _open(1), _open(2**33 + 1)
    for reqs in (a, b):
        win = [r for r in reqs if r.counted]
        assert len(win) == 20                         # round(5.0 * 4.0)
        assert all(0.5 <= r.due < 4.5 for r in win)   # the lead is 0.5 s
    key = lambda reqs: sorted((len(r.prompt), r.max_new)  # noqa: E731
                              for r in reqs if r.counted)
    assert sorted(len(r.prompt) for r in a if r.counted) == \
        sorted(len(r.prompt) for r in b if r.counted)
    assert sorted(r.max_new for r in a if r.counted) == \
        sorted(r.max_new for r in b if r.counted)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    assert key(a) != [] and all(4 <= p <= 48 for p, _ in key(a))
    dues = [r.due for r in a]
    assert dues == sorted(dues)


def test_closed_loop_repeats_and_permutes():
    take = lambda s: [(r.prompt, r.max_new) for r in  # noqa: E731
                      itertools.islice(traffic.closed_loop(CLOSED, 256, s),
                                       traffic.BLOCK)]
    a, b, c = take(7), take(7), take(8)
    assert a == b
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in c)
    assert a != c


def test_lognormal_set_is_the_clipped_quantiles():
    got = traffic.lognormal_set(5, {"median": 100, "sigma": 1.0,
                                    "min": 40, "max": 200})
    # quantiles at 0.1, 0.3, ... 0.9: 100 exp(z), z = -1.2816, -0.5244,
    # 0, 0.5244, 1.2816: 27.8 (clipped to 40), 59.2, 100, 168.9, 360.2
    # (clipped to 200)
    assert got.tolist() == [40, 59, 100, 169, 200]
    gaps = traffic.exponential_gaps(4, 2.0)
    assert gaps.sum() == pytest.approx(2.0)
    assert list(gaps) == sorted(gaps)


def test_pack_rows_equals_the_ports_packer():
    from kubedl_tpu_torch.train.data import pack_documents
    docs = list(itertools.islice(traffic.documents(DOCS, 256, 11), 200))
    ours = list(itertools.islice(traffic.pack_rows(iter(docs), 64, 2), 6))
    # a generator takes the port's Python loop, the packer's plain version
    theirs = list(itertools.islice(pack_documents(
        (d.tolist() for d in docs), 64, 2), 6))
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        for k in ("tokens", "targets", "segment_ids", "positions", "mask"):
            np.testing.assert_array_equal(a[k], b[k])


BURSTS = {**OPEN, "arrival": {"kind": "bursts", "on_s": 0.25, "off_s": 0.75}}
SHARED = {**OPEN, "prefix": {"length": {"median": 30, "sigma": 0.5,
                                        "min": 16, "max": 60}, "asks": 3}}


def test_bursts_press_the_same_arrivals_into_on_phases():
    plain = _open(5)
    burst = traffic.open_loop(BURSTS, 5.0, 4.0, 256, 5, 3.0)
    assert [(r.prompt, r.max_new, r.counted) for r in burst] == \
        [(r.prompt, r.max_new, r.counted) for r in plain]
    for lo, hi, reqs in ((0.5, 4.5, [r for r in burst if r.counted]),):
        assert all(lo <= r.due < hi for r in reqs)
        # each part starts with an on phase of 0.25 s in every second
        assert all((r.due - lo) % 1.0 < 0.25 + 1e-9 for r in reqs)
    dues = [r.due for r in burst]
    assert dues == sorted(dues)


def test_shared_prefixes_are_asked_by_consecutive_requests():
    a = traffic.open_loop(SHARED, 6.0, 4.0, 256, 9, 3.0)
    b = traffic.open_loop(SHARED, 6.0, 4.0, 256, 9, 3.0)
    assert [r.prompt for r in a] == [r.prompt for r in b]
    win = [r for r in a if r.counted]
    assert len(win) == 24
    plain = [r for r in _open(9, rate=6.0) if r.counted]
    for j, (r, p) in enumerate(zip(win, plain)):
        n = len(r.prompt) - len(p.prompt)
        assert 16 <= n <= 60 and r.prompt[n:] == p.prompt
        if j % 3:
            assert r.prompt[:n] == win[j - 1].prompt[:n]
    assert win[0].prompt[:16] != win[3].prompt[:16]
    assert traffic.prompt_range(SHARED) == (4 + 16, 48 + 60)
    # 4.8 requests a second over 4 s is 19.2: 18, in whole groups of 3
    assert sum(r.counted for r in traffic.open_loop(
        SHARED, 4.8, 4.0, 256, 9, 3.0)) == 18
    # another seed: the same prefix and own lengths, paired otherwise
    other = [r for r in traffic.open_loop(SHARED, 6.0, 4.0, 256, 10, 3.0)
             if r.counted]
    mine = [r for r in _open(10, rate=6.0) if r.counted]
    prefixes = lambda rs, ps: sorted(  # noqa: E731
        len(r.prompt) - len(p.prompt) for r, p in zip(rs, ps))
    assert prefixes(other, mine) == prefixes(win, plain)
    assert sum(len(r.prompt) for r in other) == \
        sum(len(r.prompt) for r in win)


def test_a_closed_loop_shares_prefixes_too():
    mix = {**SHARED, "arrival": {"kind": "closed", "clients": 4}}
    reqs = list(itertools.islice(traffic.closed_loop(mix, 256, 3), 7))
    head = [r.prompt[:16] for r in reqs]
    assert head[0] == head[1] == head[2] != head[3]
    assert head[3] == head[5] != head[6]


@pytest.mark.parametrize("mix", [
    {**OPEN, "arrival": {"kind": "weibull"}},
    {**DOCS},
])
def test_an_unknown_or_wrong_kind_of_mix_raises(mix):
    with pytest.raises(ValueError):
        traffic.open_loop(mix, 5.0, 4.0, 256, 1, 3.0)
    with pytest.raises(ValueError):
        next(traffic.closed_loop(mix, 256, 1))


def test_each_loop_refuses_the_others_mix():
    with pytest.raises(ValueError):
        traffic.open_loop(CLOSED, 5.0, 4.0, 256, 1, 3.0)
    with pytest.raises(ValueError):
        next(traffic.closed_loop(OPEN, 256, 1))
    with pytest.raises(ValueError):
        next(traffic.documents(OPEN, 256, 1))
