"""Fixtures of the benchmark's tests: a small benchmark root whose one
cell is the 8-atom lattice over two cycles, and the card where there is
one.  Run from the repository root: ``python -m pytest gmg_bench/tests``;
the tests marked ``cuda`` skip without a card."""

import json
import os
import shutil

import pytest

from gmg_bench import cells

TINY = "tiny.production"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


def make_root(path, cycles: int = 2) -> str:
    """A benchmark root at ``path`` with the one cell ``tiny.production``:
    the 64k configuration's settings on the 8-atom lattice, ``cycles``
    cycles, the production mix, this package's metrics, and the limits
    of ``nacl64k_f32.production``."""
    pkg = os.path.join(path, "gmg_bench")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(pkg, d), exist_ok=True)
    shutil.copytree(os.path.join(cells.PKG, "metrics"),
                    os.path.join(pkg, "metrics"), dirs_exist_ok=True)
    with open(os.path.join(cells.PKG, "configs", "nacl64k_f32.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "tiny"
    cfg["lattice"].update(n=1, atoms=8)
    cfg["settings"].update(domain_right=1.0, n_adaptive_cycles=cycles)
    cfg["published_cells"] = [85184, 85744, 87648, 91344, 99464][:cycles]
    with open(os.path.join(pkg, "configs", "tiny.json"), "w") as fh:
        json.dump(cfg, fh)
    shutil.copy(os.path.join(cells.PKG, "traffic", "production.json"),
                os.path.join(pkg, "traffic", "production.json"))
    shutil.copy(os.path.join(cells.PKG, "limits",
                             "nacl64k_f32.production.json"),
                os.path.join(pkg, "limits", TINY + ".json"))
    bench = cells.load_benchmark()
    bench["configs"] = [{"name": "tiny", "source": "x", "reduced": [],
                         "file": "gmg_bench/configs/tiny.json", "why": "x"}]
    bench["workloads"] = [{"name": TINY, "config": "tiny",
                           "traffic": "production", "chips": 1, "why": "x"}]
    for m in bench["per_layer"] + bench["end_to_end"]:
        m.pop("workloads", None)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
