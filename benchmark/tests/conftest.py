"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data at a
size a test run holds.

Run from the root of the repository: ``python -m pytest benchmark/tests -q``.
Tests marked ``cuda`` need an NVIDIA GPU and skip without one.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in SPEC["workloads"]]
TINY_CAPACITY = 1 << 18  # every join of the tiny tables fits (Q3 joins all ~80k lineitems)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


def make_root(dest: Path) -> Path:
    """A checkout's data under ``dest``: BENCHMARK.json and the benchmark's
    data files, each configuration cut to the sizes its own ``tiny`` key
    gives and the queries' capacities to :data:`TINY_CAPACITY`."""
    dest.mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for entry in SPEC["configs"]:
        path = dest / entry["file"]
        cfg = json.loads(path.read_text())
        cfg.update(cfg["tiny"])
        path.write_text(json.dumps(cfg))
    for path in (dest / "benchmark" / "queries").glob("*.json"):
        q = json.loads(path.read_text())
        if "capacity" in q["kw"]:
            q["kw"]["capacity"] = TINY_CAPACITY
        path.write_text(json.dumps(q))
    return dest


def cells_of(driver: str) -> list:
    """The cells whose configuration the driver ``driver`` runs."""
    drivers = {c["name"]: json.loads((REPO / c["file"]).read_text())["driver"]
               for c in SPEC["configs"]}
    return [c["name"] for c in SPEC["workloads"] if drivers[c["config"]] == driver]


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench") / "root")


@pytest.fixture(scope="session")
def reg(tiny_root):
    from benchmark import harness

    return harness.Registry(tiny_root)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
