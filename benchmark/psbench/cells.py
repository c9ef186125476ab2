"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``BENCHMARK.json``'s ``configs`` entry, whose
``file`` holds it), a traffic mix (``benchmark/traffic/<traffic>.json``) and
its chips; a metric is read by ``benchmark/metrics/<name>.py``, whose
``read(record)`` returns the number or None when the run gave it nothing to
read; a served configuration's data layout is checked by the reference its
``reference`` key names (``benchmark/references/<name>.py``, default
``buckets``). Adding a configuration, a layout, a mix or a metric adds files
and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = os.path.basename(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: str = ROOT) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of a cell."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, NAME, "traffic", wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return wl, config, traffic


def metrics(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or,
    traced, its per-layer metrics (those that list it, or that list no
    cells and move an end-to-end metric it reports)."""
    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in names)]


def _module(kind: str, name: str, root: str):
    """The module ``benchmark/<kind>/<name>.py`` of the checkout at ``root``."""
    path = os.path.join(root, NAME, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"psbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, root: str = ROOT):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    return _module("metrics", name, root).read


def reference(config: dict, root: str = ROOT):
    """The reference module of a served configuration's data layout:
    ``benchmark/references/<config["reference"]>.py``, ``buckets`` when the
    configuration names none. It gives ``draw``, ``loaded``, ``frame``,
    ``pack``, ``from_snapshot`` and ``least`` (``references/buckets.py``
    says what each returns)."""
    return _module("references", config.get("reference", "buckets"), root)
