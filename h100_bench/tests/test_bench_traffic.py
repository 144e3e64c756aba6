"""The traffic generator: the same for the same seed, another for another
seed, the same work in every block whatever the seed."""

import statistics

from harness import spec
from harness.traffic import Traffic
from toy import OPEN

CHAT = spec._load_json(spec.BENCH_DIR / "traffic" / "chat-closed64.json")

BIG = 2**31 + 12345  # seeds past 32 signed bits


def test_same_seed_same_requests_and_arrivals():
    a = Traffic(OPEN, BIG, 152064, rate_rps=3.0)
    b = Traffic(OPEN, BIG, 152064, rate_rps=3.0)
    assert [a.request(i) for i in range(70)] == [b.request(i)
                                                 for i in range(70)]
    assert a.arrivals(50.0) == b.arrivals(50.0)


def test_other_seed_other_order_and_tokens():
    a = Traffic(CHAT, BIG, 152064)
    b = Traffic(CHAT, BIG + 1, 152064)
    assert [a.sizes(i) for i in range(64)] != [b.sizes(i) for i in range(64)]
    assert a.request(0)[0][:16] != b.request(0)[0][:16]
    assert Traffic(OPEN, 7, 10, 3.0).arrivals(30) != \
        Traffic(OPEN, 8, 10, 3.0).arrivals(30)


def test_every_block_holds_the_same_sizes():
    """Blocked stratification: each block of 64 requests has one multiset of
    (prompt, output) lengths per seed family, shuffled."""
    for mix in (CHAT, OPEN):
        sets = []
        for seed in (1, BIG, 99):
            t = Traffic(mix, seed, 1000, rate_rps=2.0)
            for blk in range(2):
                rng = range(64 * blk, 64 * blk + 64)
                sets.append((sorted(t.sizes(i)[0] for i in rng),
                             sorted(t.sizes(i)[1] for i in rng)))
        assert all(s == sets[0] for s in sets)


def test_lengths_follow_the_mix():
    t = Traffic(CHAT, 5, 152064)
    p = [t.sizes(i)[0] for i in range(640)]
    o = [t.sizes(i)[1] for i in range(640)]
    assert min(p) >= 4 and max(p) <= 1024
    assert 112 <= statistics.median(p) <= 125  # lognormal median 118.4
    assert 158 <= statistics.mean(p) <= 165  # the source's mean, 161.31
    assert min(o) >= 4 and max(o) <= 672
    assert 330 <= statistics.mean(o) <= 346  # the source's mean, 337.99
    toks = t.request(3)[0]
    assert len(toks) == t.sizes(3)[0]
    assert all(0 <= x < 152064 for x in toks)


def test_poisson_arrivals_hold_the_rate():
    t = Traffic(OPEN, BIG, 100, rate_rps=4.0)
    arr = t.arrivals(51.0)
    assert arr == sorted(arr) and 0 < arr[0] and arr[-1] < 51.0
    # a few stratified blocks of 64 gaps of mean 1/rate
    assert 190 <= len(arr) <= 214
    assert len(Traffic(OPEN, 3, 100, rate_rps=4.0).arrivals(51.0)) in range(
        190, 215)
