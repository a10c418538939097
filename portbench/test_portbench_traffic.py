"""The traffic generator repeats exactly for a seed, and every seed serves
the same sizes in every stratum."""
import numpy as np

from portbench.harness import tiny
from portbench.traffic import generator as G

BIG = 2 ** 31 + 12345


def _requests(seed, n):
    mix = tiny.spec("serve_sc2_3b_batch")["mix"]
    src = G.lm_requests(mix, seed, 512)
    return [next(src) for _ in range(n)]


def test_requests_repeat_for_a_seed_with_the_same_sizes_in_every_stratum():
    a, b, c = _requests(BIG, 12), _requests(BIG, 12), _requests(7, 12)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))
    mix = tiny.spec("serve_sc2_3b_batch")["mix"]
    k = mix["stratum"]
    for lo in range(0, 12, k):
        sa = sorted((len(t), m) for t, m in a[lo:lo + k])
        sc = sorted((len(t), m) for t, m in c[lo:lo + k])
        assert [s for s, _ in sa] == [s for s, _ in sc]
        assert sorted(m for _, m in sa) == sorted(m for _, m in sc)
    assert [x[1] for x in a] != [x[1] for x in c]
    # after the initial requests, the same sizes in every block
    b = mix["block"]
    for lo in range(mix["initial"], 12, b):
        assert (sorted(len(t) for t, _ in a[lo:lo + b])
                == sorted(len(t) for t, _ in c[lo:lo + b]))
        assert (sorted(m for _, m in a[lo:lo + b])
                == sorted(m for _, m in c[lo:lo + b]))
    p = mix["prompt"]
    assert all(p["min"] <= len(t) <= p["max"] for t, _ in a)


def test_full_size_request_sizes_follow_the_mix():
    mix = tiny.cell.load_cell("serve_sc2_3b_batch")["mix"]
    src = G.lm_requests(mix, BIG, 49152)
    reqs = [next(src) for _ in range(mix["initial"] + 64)]
    first = [m for _, m in reqs[:mix["initial"]]]
    later = [m for _, m in reqs[mix["initial"]:]]
    assert min(first) >= 1 and max(first) <= 1024 and min(first) < 256
    assert min(later) >= 256 and max(later) <= 1024
    lens = sorted(len(t) for t, _ in reqs)
    assert 32 <= lens[0] and lens[-1] <= 2048
    assert 200 <= lens[len(lens) // 2] <= 320
    # a window that admits any number of later requests admits the same
    # sizes for every seed but a part of one block, and each run of them
    # spreads over the whole range of prompts
    other = G.lm_requests(mix, 7, 49152)
    more = [next(other) for _ in range(mix["initial"] + 64)]
    b = mix["block"]
    later = slice(mix["initial"], None)
    assert ([len(t) for t, _ in reqs[later]]
            != [len(t) for t, _ in more[later]])
    for lo in range(mix["initial"], len(reqs), b):
        assert (sorted(len(t) for t, _ in reqs[lo:lo + b])
                == sorted(len(t) for t, _ in more[lo:lo + b]))
    head = sorted(len(t) for t, _ in reqs[mix["initial"]:][:16])
    assert head[0] < 100 and head[-1] > 700


def test_train_batches_repeat_for_a_seed_and_every_row_differs():
    a = G.lm_batches(4, 16, 512, BIG, 3)
    b = G.lm_batches(4, 16, 512, BIG, 3)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    rows = np.concatenate([x["tokens"] for x in a])
    assert len({r.tobytes() for r in rows}) == len(rows)
    assert np.array_equal(a[0]["tokens"][:, 1:], a[0]["labels"][:, :-1])
