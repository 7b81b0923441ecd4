"""The load a run offers: every seed sends the same work, in another order."""

import collections
import itertools

import pytest

from olapbench import client, run
from olapbench.tests.conftest import CELLS
from olapbench.tests.conftest import cell as bench_cell


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_sends_the_same_work(cell):
    kinds = run._kinds(bench_cell(cell))
    size = len(client.deck(kinds))
    per_kind = collections.Counter(k for k, _ in client.deck(kinds))
    assert len(set(per_kind.values())) == 1  # each kind equally often
    drawn = {}
    for seed in (1, 2 ** 31 + 11, 2 ** 62 + 3):
        for c in range(3):
            got = list(itertools.islice(client.client_stream(seed, c, kinds), 3 * size))
            drawn[(seed, c)] = got
            assert collections.Counter(got) == collections.Counter(client.deck(kinds) * 3)
    assert len({tuple(v) for v in drawn.values()}) == len(drawn)  # in another order
