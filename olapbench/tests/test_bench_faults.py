"""A whole run, on the CPU at a tiny scale, with the program broken under
the timed path after its set-up: `correct` must come out false for each
fault a cell can have, and true with none."""

import pytest

from olapbench.run import run_cell
from olapbench.tests.conftest import CELLS, TINY, bench_for_tests


def _scale_floats(df, factor):
    df = df.copy()
    for c in df.columns:
        if df[c].dtype.kind == "f":
            df[c] = df[c] * factor
    return df


def answer_altered(monkeypatch):
    from spark_druid_olap_tpu_torch.exec import engine

    execute = engine.Engine.execute
    monkeypatch.setattr(engine.Engine, "execute",
                        lambda self, *a, **k: _scale_floats(execute(self, *a, **k), 1.001))


def half_the_rows_left_out(monkeypatch):
    from spark_druid_olap_tpu_torch.exec import engine

    scope = engine.segments_in_scope
    monkeypatch.setattr(engine, "segments_in_scope", lambda q, ds: scope(q, ds)[::2])


def a_group_dropped(monkeypatch):
    from spark_druid_olap_tpu_torch.exec import engine

    execute = engine.Engine.execute

    def drop(self, *a, **k):
        df = execute(self, *a, **k)
        return df.iloc[:-1] if len(df) > 1 else df

    monkeypatch.setattr(engine.Engine, "execute", drop)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, answer_altered, half_the_rows_left_out, a_group_dropped])
def test_correct_follows_the_program(root, monkeypatch, cell, fault):
    r = run_cell(root, cell, 31337, 1.0, False, device="cpu", overrides=TINY,
                 bench=bench_for_tests(root),
                 fault=None if fault is None else (lambda ctx: fault(monkeypatch)))
    assert r["attempted"] > 0
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"
