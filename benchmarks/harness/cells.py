"""A cell of ``BENCHMARK.json`` and the files it is made of, found by
name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json``; modules ``calls/<call>.py``,
``reference/<reference>.py``, ``generators/<generator>.py`` and
``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass
from typing import List

HERE = pathlib.Path(__file__).resolve().parent.parent      # benchmarks/
ROOT = HERE.parent


def module(kind: str, name: str):
    """The module ``benchmarks/<kind>/<name>.py``, loaded once by path
    (a metric's name may hold dots)."""
    key = 'benchmarks.%s.%s' % (kind, name.replace('.', '__'))
    if key not in sys.modules:
        path = HERE / kind / (name + '.py')
        if not path.is_file():
            raise FileNotFoundError('no %s named %r (%s)' % (kind, name, path))
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / (name + '.json')
    if not path.is_file():
        raise FileNotFoundError('no %s named %r (%s)' % (kind, name, path))
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def load(name: str, spec_path: pathlib.Path = ROOT / 'BENCHMARK.json') -> Cell:
    """The cell ``name`` of the benchmark file, with its configuration,
    traffic mix, limits and the metrics it reports."""
    spec = json.loads(spec_path.read_text())
    cells = {w['name']: w for w in spec['workloads']}
    if name not in cells:
        raise KeyError('no workload %r in %s (cells: %s)'
                       % (name, spec_path, ', '.join(cells)))
    w = cells[name]
    return Cell(name=name, chips=int(w['chips']),
                config=_json('configs', w['config']),
                traffic=_json('traffic', w['traffic']),
                limits=_json('limits', name),
                end_to_end=[m for m in spec['end_to_end']
                            if _applies(m, name)],
                per_layer=[m for m in spec['per_layer'] if _applies(m, name)])
