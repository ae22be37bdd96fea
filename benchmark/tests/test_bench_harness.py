"""The harness: discovery by name, the modules a run may load, the control
and the planted faults coming out not correct, the command line, and a run
on the card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import CELLS, REPO, cells_of, make_root


def run(reg, cell, seconds=0.3, traced=False, seed=2**31 + 11):
    return harness.run_cell(reg, cell, seed, seconds, traced, device="cpu")[0]


def test_benchmark_json_names_what_exists(reg):
    spec = reg.spec
    names = [c["name"] for c in spec["workloads"]]
    assert len(set(names)) == len(names) == len(CELLS)
    for c in spec["workloads"]:
        cfg = reg.config(c["config"])
        assert cfg["name"] == c["config"]
        assert cfg["tiny"], "the sizes the CPU tests run the configuration at"
        reg.data("traffic", c["traffic"])
        assert (REPO / "benchmark" / "drivers" / f"{cfg['driver']}.py").exists()
        e2e = {m["name"] for m in reg.end_to_end(c["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reg.per_layer(c["name"])
    for m in spec["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in reg.end_to_end(cell)}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(reg, cell):
    res = run(reg, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]


def test_traced_run_reports_host_metrics_and_breakdown(reg):
    res = run(reg, "tpch-sf10-q1", traced=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"plan_ms"}  # the CPU gives no device metric
    assert res["device"]["busy_s"] == 0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_discovery_of_new_files(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as new
    files run with no edit to the harness."""
    root = make_root(tmp_path / "root")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/sort-u64pair-4gb.json").read_text())
    cfg.update(name="sort-u32pair-tiny", rows=4096, key_dtype="uint32", payload_dtype="uint32")
    (root / "benchmark/configs/sort-u32pair-tiny.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/step-10.json").write_text(
        json.dumps({"keys": "step_uniform", "key_params": {"steps": 10}, "batches": 3}))
    (root / "benchmark/metrics/calls_per_s.py").write_text(textwrap.dedent('''
        def read(rec):
            return rec.completed / rec.window_s
    '''))
    spec["configs"].append({"name": "sort-u32pair-tiny", "source": "a test",
                            "file": "benchmark/configs/sort-u32pair-tiny.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "sort-u32-step", "config": "sort-u32pair-tiny",
                              "traffic": "step-10", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["sort-u32-step"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run(harness.Registry(root), "sort-u32-step")
    assert res["correct"]
    assert set(res["metrics"]) == {"calls_per_s", "setup_s"}
    assert res["attempted"] % 3 == 0  # the window ends on a whole cycle of batches


def test_no_forbidden_module_is_loaded(tiny_root):
    """Planning and running every cell, in a fresh process, loads no
    module whose top-level name is forbidden (the JAX package above all,
    whose name the port's begins with)."""
    code = textwrap.dedent(f'''
        import sys
        from benchmark import harness
        reg = harness.Registry({str(tiny_root)!r})
        for cell in {CELLS!r}:
            harness.run_cell(reg, cell, 5, 0.05, False, device="cpu")
        assert "radix_sort_tpu_torch" in sys.modules
        print(harness.forbidden_modules())
    ''')
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


PLANTED = ("jax", "flax", "radix_sort_tpu")


def plant(name):
    """A stand-in for the module ``name``, put into ``sys.modules`` as an
    import of it would."""
    sys.modules.setdefault(name, types.ModuleType(name))


@pytest.mark.parametrize("where", ["sort reference", "query reference", "metric reader"])
def test_a_module_loaded_after_the_window_is_refused(where, tmp_path, monkeypatch):
    """A forbidden module that the judgement or a metric's reader loads,
    once the window has closed, refuses the run as one loaded before."""
    root = make_root(tmp_path / "root")
    if where == "sort reference":
        from benchmark.reference import sort_pairs as ref

        real = ref.sort_rows
        monkeypatch.setattr(ref, "sort_rows", lambda *a, **kw: (plant("flax"), real(*a, **kw))[1])
        cell, found = cells_of("sort_pairs")[0], "flax"
    elif where == "query reference":
        from benchmark.reference.tpch import Q1

        real = Q1.answer
        monkeypatch.setattr(Q1, "answer", lambda *a, **kw: (plant("jax"), real(*a, **kw))[1])
        cell, found = "tpch-sf10-q1", "jax"
    else:
        (root / "benchmark/metrics/setup_s.py").write_text(textwrap.dedent('''
            import sys, types
            def read(rec):
                sys.modules.setdefault("radix_sort_tpu", types.ModuleType("radix_sort_tpu"))
                return rec.setup_s
        '''))
        cell, found = CELLS[0], "radix_sort_tpu"
    saved = {n: sys.modules.pop(n) for n in PLANTED if n in sys.modules}
    try:
        with pytest.raises(harness.Forbidden, match=found):
            run(harness.Registry(root), cell)
    finally:
        for n in PLANTED:
            sys.modules.pop(n, None)
        sys.modules.update(saved)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "radix_sort_tpu_torch_extra", sys)
    assert "radix_sort_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "radix_sort_tpu.ops", sys)
    assert "radix_sort_tpu.ops" in harness.forbidden_modules()


def test_references_import_nothing_of_the_program():
    for path in sorted((REPO / "benchmark" / "reference").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN | {"radix_sort_tpu_torch"}, \
                    (path, n)
    code = ("import sys, benchmark.reference.sort_pairs, benchmark.reference.tpch.Q1, "
            "benchmark.reference.tpch.Q3, benchmark.reference.tpch.Q13, "
            "benchmark.reference.tpch.Q18; print(sorted(m for m in sys.modules "
            "if m.startswith('radix_sort_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(reg, cell):
    values = control.control_reading(reg, cell, 2**31 + 3, device="cpu")
    assert any(v > limit for v, limit in values.values()), values


def unchanged_sort(keys, values, **kw):
    return keys.clone(), values.clone()


def half_sort(keys, values, real, **kw):
    h = keys.shape[0] // 2
    k, v = real(keys[:h], values[:h], **kw)
    return torch.cat([k, keys[h:]]), torch.cat([v, values[h:]])


def altered_sort(keys, values, real, **kw):
    k, v = real(keys, values, **kw)
    k = k.clone()
    k[k.shape[0] // 2] = k[0]
    return k, v


@pytest.mark.parametrize("cell", cells_of("sort_pairs"))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_sort_faults_come_out_not_correct(reg, cell, fault, monkeypatch):
    import radix_sort_tpu_torch as rst

    real = rst.sort_pairs
    broken = {"unchanged": unchanged_sort,
              "half": lambda k, v, **kw: half_sort(k, v, real, **kw),
              "altered": lambda k, v, **kw: altered_sort(k, v, real, **kw)}[fault]
    monkeypatch.setattr(rst, "sort_pairs", broken)
    res = run(reg, cell)
    assert not res["correct"]
    assert res["checks"]["mismatched_rows"]["value"] > 0


@pytest.mark.parametrize("cell", cells_of("tpch_sql"))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_query_faults_come_out_not_correct(reg, cell, fault, monkeypatch):
    import radix_sort_tpu_torch as rst
    from radix_sort_tpu_torch.table import Table

    real_sql, real_rows = rst.sql, Table.to_numpy

    def unchanged(text, tables, **kw):  # the plan hands back its first input
        return real_sql("SELECT * FROM orders", tables)

    def half(text, tables, **kw):  # the query over half of LINEITEM
        li = tables["lineitem"]
        cols = {c: li[c][: li.num_rows // 2] for c in li.column_names}
        dicts = {c: li.dictionary(c) for c in ("l_returnflag", "l_linestatus")}
        return real_sql(text, dict(tables, lineitem=Table(cols, dictionaries=dicts,
                                                          device="cpu")), **kw)

    def altered(self):  # one answer changed where it is produced
        rows = real_rows(self)
        name = [c for c in rows if rows[c].dtype.kind in "iuf"][-1]
        rows[name] = rows[name].copy()
        rows[name][0] += 1
        return rows

    if fault == "altered":
        monkeypatch.setattr(Table, "to_numpy", altered)
    else:
        monkeypatch.setattr(rst, "sql", {"unchanged": unchanged, "half": half}[fault])
    res = run(reg, cell)
    assert not res["correct"], res["checks"]


def test_command_line_refuses_without_a_card(tmp_path):
    """Without CUDA the command exits non-zero and prints no result; from a
    directory holding only the benchmark it fails as well. The bytecode the
    runs cache goes to a prefix of the test's own."""
    env_cmd = [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
               "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPYCACHEPREFIX=str(tmp_path / "pyc"))
    out = subprocess.run(env_cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr
    assert any((tmp_path / "pyc").rglob("*.pyc"))
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(REPO / "benchmark"), str(alone)], check=True)
    out = subprocess.run(env_cmd, cwd=alone, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(reg, cell, cuda):
    res, lines = harness.run_cell(reg, cell, 2**31 + 13, 0.5, True, device="cuda")
    assert res["correct"], lines
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert res["metrics"]
