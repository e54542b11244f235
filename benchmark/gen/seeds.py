"""Seeds of the parts of a run, derived from the run's ``--seed``."""


def part(seed, k):
    """The seed of part ``k`` of a run (a capture of the pool, the pilots): distinct for
    distinct (seed, k < 1,000,003) below 2**63 / 1,000,003, and always below 2**63."""
    return (int(seed) * 1_000_003 + int(k) + 1) % 2 ** 63
