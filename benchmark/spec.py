"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<mix>.json``,
``archs/<arch>.py``, ``loops/<kind>.py`` and ``metrics/<metric>.py`` under
this folder.

A later cell, configuration, architecture, traffic mix, loop or metric is
a new file here and an entry in ``BENCHMARK.json`` or a configuration;
nothing in the harness names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arch(name: str):
    """The module of a configuration's ``arch``: its weights, plain
    reference and counts (``archs/__init__.py`` says what it provides)."""
    return _module("archs", name)


def loop(kind: str):
    """The loop module of a traffic mix's ``loop`` kind."""
    return _module("loops", kind)


def metric(name: str):
    """The reader module of one metric: ``read(run) -> float | None``."""
    return _module("metrics", name)


def metrics_of(bench: dict, cell_name: str, group: str) -> list:
    """The entries of ``group`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those that list it, and those that list no cells."""
    return [m for m in bench[group]
            if cell_name in m.get("workloads", [cell_name])]
