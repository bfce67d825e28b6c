"""What a run is asked to do, read from files by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configuration and traffic, and the metrics. Everything that belongs to one
item sits in a file of its own under ``benchmark/``:

- ``configs/<config>.json`` — the deployment: shapes, solver settings, the
  data recipe (``recipes/<recipe>.py``) and the driver that calls the
  program (``drivers/<driver>.py``);
- ``traffic/<traffic>.json`` — the mix one caller sends: lanes a call and
  the recipe's per-mix parameters;
- ``limits/<cell>.json`` — the limits of the comparison that decides
  ``correct`` for that cell;
- ``metrics/<metric>.py`` — one reader a metric, ``read(run)``; a metric
  split by kind of cell, ``<base>.<kind>``, shares its base's reader.

A driver owns its contract with the harness and with the tests. Beside
``lanes(config, traffic)`` and ``Session(cell, seed, device,
lanes_override)`` (its batch made from the seed, the timed ``call()``, and
``account``, ``totals``, ``keep``, ``work``, ``readings`` and ``judge`` for
``run.run_cell``), ``drivers/<driver>.py`` exports:

- ``ENTRY`` — ``(module, attribute)``: the program's public entry that its
  ``Session`` times, looked up (:func:`entry`) when the session is built, so
  a patch of that attribute reaches the timed call;
- ``TWIN`` — the keywords that send the entry to the plain twins of the
  card's kernels on a CPU tensor;
- ``FAULTS`` — ``name → wrap(entry) → broken entry``: the entry's result
  broken where it is produced (``unchanged``, ``half_left_out``,
  ``x_altered``, ``flag_flipped``), each of which its check has to fail;
- ``LIMITS`` and ``EXACT`` — the names of the numbers its check compares,
  which a cell's ``limits/<cell>.json`` holds exactly, and those whose limit
  is 0;
- ``solver(config)`` — the program's settings for ``config["solver"]``.

A new cell, configuration, traffic mix, metric or driver is new files and
new entries in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file at ``path`` as module ``name`` (metric names may hold
    dots, which a plain import cannot take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple  # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(_json(root / configs[w["config"]]["file"]), name=w["config"])
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = _json(HERE / "limits" / f"{name}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``; a metric split
    by the kind of cell that reports it (``<base>.<kind>``) reads with
    ``metrics/<base>.py`` where it has no file of its own."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path, f"benchmark.metrics.{metric.replace('.', '_')}").read


def driver(config: dict):
    """The module of ``drivers/<driver>.py`` that calls the program."""
    return importlib.import_module(f"benchmark.drivers.{config['driver']}")


def entry(where: tuple):
    """The program's callable at ``where``, a driver's ``ENTRY``, as it
    stands now."""
    module, name = where
    return getattr(importlib.import_module(module), name)


def recipe(config: dict):
    """The ``build`` function of ``recipes/<recipe>.py``."""
    return importlib.import_module(f"benchmark.recipes.{config['recipe']}").build
