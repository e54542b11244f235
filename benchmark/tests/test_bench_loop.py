"""The measured window: rate over the dispatches completed inside it, the tail over all of them."""
import pytest

from benchmark.lib import loop


class FakeCard:
    """A host clock and a card: each call costs the host ``host`` seconds and queues ``dev``
    seconds of work on the card behind what it already holds."""

    def __init__(self, host, dev):
        self.t, self.free, self.host, self.dev = 0.0, 0.0, host, dev

    def clock(self):
        return self.t

    def call(self, k):
        self.t += self.host
        self.free = max(self.free, self.t) + self.dev
        return ("out", k)

    def marker(self):
        card, done = self, self.free

        class Ev:
            def wait(self):
                card.t = max(card.t, done)
        return Ev()


def window(host, dev, seconds=0.1, keep=False, seed=0):
    c = FakeCard(host, dev)
    return loop.run(c.call, 4, 1000, seconds, 2, c.marker, keep=keep, seed=seed, clock=c.clock)


def test_percentile_is_nearest_rank():
    assert loop.percentile(range(1, 101), 95) == 95
    assert loop.percentile([4, 1, 3, 2], 95) == 4
    assert loop.percentile([4, 1, 3, 2], 50) == 2
    with pytest.raises(ValueError):
        loop.percentile([], 95)


def test_host_paced_window():
    w = window(host=1e-3, dev=0.5e-3, seconds=0.1005)
    # dispatch i: called at i ms, done at i + 1.5 ms, seen after the next enqueue, at i + 2 ms;
    # the last, called at 100 ms, is waited for after the close and seen at 101.5 ms
    lat = w.latencies_ms()
    assert len(lat) == 101
    assert lat[:-1] == pytest.approx([2.0] * 100) and lat[-1] == pytest.approx(1.5)
    assert loop.percentile(lat, 95) == pytest.approx(2.0)
    # seen inside the 100.5 ms: i + 2 <= 100.5, so i <= 98
    assert w.completed() == 99
    assert loop.msym_per_s(w) == pytest.approx(99 * 1000 / 1e6 / 0.1005)


def test_card_paced_window_counts_every_dispatch_in_the_tail():
    w = window(host=0.2e-3, dev=1e-3)
    lat = w.latencies_ms()
    # in steady state each dispatch waits behind the one ahead of it: two device times
    assert loop.percentile(lat, 95) == pytest.approx(2.0, rel=0.15)
    assert loop.msym_per_s(w) == pytest.approx(1000 * 1000 / 1e6, rel=0.05)
    assert all(c[2] is not None for c in w.calls)          # the drained ones are timed too
    assert sum(1 for c in w.calls if c[2] - w.start > w.seconds) >= 1


def test_the_sample_is_one_dispatch_of_each_capture_by_a_seeded_reservoir():
    a = window(1e-3, 0.5e-3, keep=True, seed=7).kept
    b = window(1e-3, 0.5e-3, keep=True, seed=7).kept
    c = window(1e-3, 0.5e-3, keep=True, seed=8).kept
    assert a == b and a != c
    assert [k for _, k, _ in a] == [0, 1, 2, 3]                # the pool of FakeCard's window
    assert all(out == ("out", k) and i % 4 == k for i, k, out in a)
    assert max(i for i, _, _ in a) >= 4                        # not merely the first ones
