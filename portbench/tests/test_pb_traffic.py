"""The generator is seeded and pure, and the open loop counts every
request it sends."""

import numpy as np
import pytest

from conftest import load
from harness import traffic

SEED = 2**31 + 77


def test_prompts_repeat_by_seed():
    mix = load("traffic", "prefill-split")
    a = traffic.prompt_lengths(mix, SEED, 200)
    assert np.array_equal(a, traffic.prompt_lengths(mix, SEED, 200))
    assert np.array_equal(traffic.prompt_tokens(SEED, 5, 300, 49155),
                          traffic.prompt_tokens(SEED, 5, 300, 49155))
    assert not np.array_equal(traffic.prompt_tokens(SEED, 5, 300, 49155),
                              traffic.prompt_tokens(SEED, 6, 300, 49155))


def test_every_seed_sends_the_same_lengths_in_another_order():
    mix = load("traffic", "prefill-split")
    n = mix["prompt_len"]["stratum"]
    a = traffic.prompt_lengths(mix, SEED, 4 * n)
    b = traffic.prompt_lengths(mix, SEED + 1, 4 * n)
    assert not np.array_equal(a, b)
    for i in range(4):
        assert sorted(a[i * n:(i + 1) * n]) == sorted(b[i * n:(i + 1) * n])
    p = mix["prompt_len"]
    assert a.min() >= p["min"] and a.max() <= p["max"]
    assert np.median(a) == pytest.approx(p["median"], rel=0.1)
    assert list(traffic.distinct_lengths(mix)) == sorted(set(a), reverse=True)
    assert traffic.cache_len(mix, 1537) == 1792
    assert traffic.cache_len(mix, 1536) == 1536


def test_packed_rows():
    mix = load("traffic", "train-2k")
    a = traffic.PackedRows(mix, 49155, SEED)
    b = traffic.PackedRows(mix, 49155, SEED)
    first = [a.batch() for _ in range(3)]
    for x in first:
        y = b.batch()
        assert np.array_equal(x["tokens"], y["tokens"])
        assert x["tokens"].shape == (2, 1024)
        assert np.array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    rows = np.concatenate([x["tokens"] for x in first])
    assert len({r.tobytes() for r in rows}) == len(rows)
    assert (rows == mix["eos"]).any()       # documents end inside rows
    assert rows.max() < 49155


def test_open_loop_counts_every_request():
    t = [0.0]

    def clock():
        return t[0]

    def sleep(dt):
        t[0] += dt

    def serve(s):
        s.t_start = t[0]
        t[0] += 0.7 if s.uid < 6 else 0.2
        if s.uid % 3 == 2:
            s.error = "planted"
        else:
            s.token = 7
        s.t_done = t[0]

    lengths = np.arange(1, 1000)
    sent = traffic.open_loop(serve, lengths, 2.0, 0.0, 10.0, clock, sleep)
    # Due at 0, 0.5, ..., 9.5: 20 sent, all served and counted.
    assert [s.uid for s in sent] == list(range(20))
    assert [s.t_send for s in sent] == [i / 2 for i in range(20)]
    assert sum(s.error is not None for s in sent) == 6
    assert all(s.length == s.uid + 1 for s in sent)
    # Served in order, one at a time, never before due; a queue builds
    # behind the six slow ones and drains.
    assert all(s.t_start >= s.t_send for s in sent)
    assert all(a.t_done <= b.t_start for a, b in zip(sent, sent[1:]))
    assert sent[6].t_start > sent[6].t_send
    assert sent[-1].t_start == sent[-1].t_send
    assert not any(s.late for s in sent)


def test_open_loop_drains_after_the_close():
    t = [0.0]

    def serve(s):
        s.t_start = t[0]
        t[0] += 1.0
        s.t_done = t[0]

    sent = traffic.open_loop(serve, np.full(100, 5), 4.0, 0.0, 3.0,
                             lambda: t[0], lambda dt: None)
    # Twelve due before 3.0; served one a second: those begun at or
    # after 3.0 are late, and none is sent after the close.
    assert len(sent) == 12
    assert sum(s.late for s in sent) == 9
    assert all(s.t_send < 3.0 for s in sent)


def test_closed_loop_keeps_the_server_busy_and_withdraws_at_the_close():
    t = [0.0]

    def serve(s):
        s.t_start = t[0]
        t[0] += 0.7 if s.uid % 2 else 0.4
        if s.uid == 3:
            s.error = "planted"
        else:
            s.token = 1
        s.t_done = t[0]

    mix = load("traffic", "prefill-flood")
    lengths = traffic.PromptLengths(mix, SEED)
    sent = traffic.closed_loop(serve, lengths, 4, 0.0, 5.0, lambda: t[0])
    # Each begun the moment the last ended: the
    # server never waits, and nothing is begun at or after the close.
    assert [s.uid for s in sent] == list(range(len(sent)))
    assert all(a.t_done == b.t_start for a, b in zip(sent, sent[1:]))
    assert sent[0].t_start == 0.0
    assert all(s.t_start < 5.0 for s in sent) and sent[-1].t_done >= 5.0
    assert len(sent) == 10          # begun at 0, 0.4, 1.1, ..., 4.4, 4.8
    # Four sent at the start, then one as each is answered.
    assert [s.t_send for s in sent[:4]] == [0.0] * 4
    assert [s.t_send for s in sent[4:]] == [s.t_done for s in sent[:6]]
    assert sum(s.error is not None for s in sent) == 1
    assert [s.length for s in sent] == list(
        traffic.prompt_lengths(mix, SEED, len(sent)))


def test_lengths_drawn_lazily_are_the_same():
    mix = load("traffic", "prefill-flood")
    lazy = traffic.PromptLengths(mix, SEED)
    assert [lazy[i] for i in (40, 3, 0, 39)] == list(
        traffic.prompt_lengths(mix, SEED, 41)[[40, 3, 0, 39]])
