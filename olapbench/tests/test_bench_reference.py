"""The plain reference agrees with the program on every request kind of
both mixes, native and SQL, served over HTTP on the CPU at a tiny scale;
and the control (the reference over bfloat16 metrics) fails the limit."""

import http.client
import json

import pytest
import torch

from olapbench import compare, control
from olapbench.run import _kinds, _session
from olapbench.tests.conftest import CELLS, TINY
from olapbench.tests.conftest import cell as bench_cell


@pytest.fixture(scope="module", params=CELLS)
def served(request):
    from spark_druid_olap_tpu_torch.api import TPUOlapContext
    from spark_druid_olap_tpu_torch.server import OlapServer

    cell = bench_cell(request.param)
    cell.config.update(TINY)
    star = cell.data_module().generate(TINY["scale_factor"], 20240601, "cpu")
    ctx = TPUOlapContext(_session(cell, torch.device("cpu")), device="cpu")
    cell.data_module().register(ctx, star, cell.config)
    server = OlapServer(ctx, port=0).start()
    yield cell, star, server.port
    server.shutdown()
    ctx.close()


def test_reference_agrees_with_the_program_on_every_kind(served):
    cell, star, port = served
    ref = cell.reference_module()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    checked = 0
    for k in _kinds(cell):
        exp = ref.expected(star, k["name"], "cpu")
        assert exp.rows, k["name"]  # the tiny scale still answers rows
        for form in k["forms"]:
            conn.request("POST", "/druid/v2" if form == "native" else "/druid/v2/sql",
                         k["bodies"][form], {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            assert resp.status == 200, body[:300]
            j = compare.Judgement()
            compare.judge(k["name"], body, exp, j)
            assert j.mismatched == 0, j.first_fault
            assert j.max_rel_err <= cell.config["limits"]["max_rel_err"], (k["name"], form)
            checked += 1
    conn.close()
    assert checked == sum(len(r["forms"]) for r in cell.mix["requests"])


def test_the_control_fails_the_limit(served):
    cell, star, _ = served
    got = control.control_numbers(cell, star, torch.device("cpu"), torch.bfloat16)
    assert got["max_rel_err"] > cell.config["limits"]["max_rel_err"] or got["mismatched_answers"]
    same = control.control_numbers(cell, star, torch.device("cpu"), None)
    assert same["max_rel_err"] == 0.0 and same["mismatched_answers"] == 0


@pytest.mark.parametrize("family", ["ssb", "tpch"])
def test_a_broken_answer_is_caught(family):
    """The comparison itself: a value, a key and the order altered."""
    cell = bench_cell(CELLS[0] if family == "ssb" else CELLS[1])
    star = cell.data_module().generate(TINY["scale_factor"], 5, "cpu")
    ref = cell.reference_module()
    name = "q4_1" if family == "ssb" else "q1"
    exp = ref.expected(star, name, "cpu")
    rows = json.loads(control.as_served(exp))
    j = compare.Judgement()
    compare.judge(name, json.dumps(rows).encode(), exp, j)
    assert j.mismatched == 0 and j.max_rel_err < 1e-12
    value, limit = exp.values[0], cell.config["limits"]["max_rel_err"]
    for broken in ([dict(rows[0], **{value: rows[0][value] * (1 + 10 * limit)})] + rows[1:],
                   rows[:-1], rows[::-1]):
        j = compare.Judgement()
        compare.judge(name, json.dumps(broken).encode(), exp, j)
        assert j.mismatched or j.max_rel_err > limit
