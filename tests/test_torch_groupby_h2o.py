"""The db-benchmark groupby questions q1-q10 (cell ``h2o-groupby-q1-q10``)
through the port's ``sql()`` over the G1 data at the configuration's
``tiny`` size on the CPU, against the benchmark's plain reference
(``benchmark/reference/h2o_groupby.py``); that reference imports neither
JAX nor the program; planted faults make the cell's run come out not
correct.

No JAX here: the reference is plain torch.
"""

import importlib
import json
import subprocess
import sys

import pytest
import torch

import radix_sort_tpu_torch as rst
from benchmark import h2o_data, harness
from benchmark.drivers import h2o_groupby as D
from benchmark.reference import h2o_groupby as R
from benchmark.tests.conftest import REPO, make_root
from radix_sort_tpu_torch import plan

SQL = importlib.import_module("radix_sort_tpu_torch.sql")  # the module, not the function

CELL = "h2o-groupby-q1-q10"
CFG = json.loads((REPO / "benchmark/configs/h2o-groupby-1e8.json").read_text())
QUERIES = json.loads((REPO / "benchmark/traffic/groupby-q1-q10.json").read_text())["queries"]
SEED = 2**31 + 23


def query(name):
    return json.loads((REPO / "benchmark/queries" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def data():
    cols, dicts = h2o_data.generate(torch.Generator().manual_seed(SEED), {**CFG, **CFG["tiny"]})
    return cols, dicts, rst.Table(cols, dictionaries=dicts, device="cpu")


@pytest.mark.parametrize("name", QUERIES)
def test_question_matches_reference(name, data):
    """Row for row and by fingerprint, within the question's limits; the
    control (the reference one precision lower) comes out outside them."""
    cols, dicts, t = data
    q = query(name)
    out = rst.sql(q["sql"], {"x": t}, **q["kw"]).collect()
    ans = R.answer(cols, q["answer"])
    assert next(iter(ans.columns.values())).shape[0] > 0
    got, out_dicts = D.result_columns(out)
    mism, gaps = D.compare(got, out_dicts, ans, dicts)
    ref_fp = D.fingerprint(D.answer_columns(ans, stated=True))
    fp_mism, fp_gaps = D.fingerprint_gaps(D.fingerprint(got), ref_fp, ans)
    assert (mism, fp_mism) == (0, 0)
    for tag, v in {**gaps, **fp_gaps}.items():
        assert v <= q["limits"][f"{tag}_rel_err"], (tag, v)
    low = D.answer_columns(R.answer(cols, q["answer"], lower=True), stated=True)
    mism_l, gaps_l = D.compare(low, dicts, ans, dicts)
    fp_l = D.fingerprint_gaps(D.fingerprint(low), ref_fp, ans)[1]
    if q["limits"] and name != "h2o/q8":  # its floats move in the lower precision
        assert any(max(gaps_l.get(t, 0), fp_l.get(t, 0)) > q["limits"][f"{t}_rel_err"]
                   for t in ("f32", "f64") if f"{t}_rel_err" in q["limits"])
    if name == "h2o/q8":  # the selected values themselves change
        assert mism_l > 0


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys, benchmark.reference.h2o_groupby, benchmark.h2o_data; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'radix_sort_tpu', 'radix_sort_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return harness.Registry(make_root(tmp_path_factory.mktemp("h2o") / "root"))


def run(reg):
    """A short run of the cell as ``harness.run_cell`` makes it (set-up,
    window, judgement and ``correct``), without its check of the loaded
    modules: this process holds JAX for the other tests."""
    cell = reg.cell(CELL)
    session = D.Session(reg, reg.config(cell["config"]), reg.data("traffic", cell["traffic"]),
                        SEED, harness.Device("cpu"))
    rec = harness.Record(CELL, SEED)
    harness.window(session, rec, 0.2)
    session.close()
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in session.judge().items()}
    checks["failed"] = {"value": rec.failed, "limit": 0}
    correct = rec.completed > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
            "checks": checks}


def test_sound_run_is_correct(reg):
    res = run(reg)
    assert res["correct"], res["checks"]
    assert res["attempted"] % 10 == 0 and res["failed"] == 0


def _replace_results(monkeypatch, change):
    """Every result the program's plans collect, passed through ``change``."""
    real = plan.LazyTable.collect

    def collect(self, *a, **kw):
        return change(real(self, *a, **kw))

    monkeypatch.setattr(plan.LazyTable, "collect", collect)


def test_a_dropped_group_is_not_correct(reg, monkeypatch):
    def drop_last(out):
        n = out.num_rows if out.count is None else int(out.count)
        return out.limit(n - 1)

    _replace_results(monkeypatch, drop_last)
    res = run(reg)
    assert not res["correct"]
    assert res["checks"]["mismatches"]["value"] > 0
    assert res["checks"]["fingerprint_mismatches"]["value"] > 0


def test_a_float64_off_by_a_millionth_is_not_correct(reg, monkeypatch):
    def nudge(out):  # q3's AVG(v3), one group
        if out.column_names != ["id3", "v1", "v3"]:
            return out
        v = out["v3"].clone()
        v[0] *= 1 + 1e-6
        return out.with_columns(v3=v)

    _replace_results(monkeypatch, nudge)
    res = run(reg)
    assert not res["correct"]
    check = res["checks"]["q3.f64_rel_err"]
    assert check["value"] > check["limit"]


def test_an_altered_fingerprint_word_is_not_correct(reg, monkeypatch):
    real = D.Session.step

    def step(self, rec):
        ok = real(self, rec)
        if self.i == 4:  # one window result of q4: its first hash word
            self.prints["q4"][-1][2] += 1
        return ok

    monkeypatch.setattr(D.Session, "step", step)
    res = run(reg)
    assert not res["correct"]
    assert res["checks"]["fingerprint_mismatches"]["value"] == 1
    assert res["checks"]["mismatches"]["value"] == 0


def test_population_deviation_is_not_correct(reg, monkeypatch):
    monkeypatch.setitem(SQL._AGG_FNS, "STDDEV_SAMP", "std")  # the population deviation
    res = run(reg)
    assert not res["correct"]
    check = res["checks"]["q6.f64_rel_err"]
    assert check["value"] > check["limit"]
