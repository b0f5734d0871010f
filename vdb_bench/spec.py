"""What a run measures, found by name: ``BENCHMARK.json`` at the root of the
checkout names the cells; a cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); each
metric is a reader of its own (``metrics/<name>.py``, a function
``read(run)``; a name with a suffix, ``<stem>.<suffix>``, falls back to
``metrics/<stem>.py`` where it has no file of its own, so one quantity split
by the end-to-end metric it moves keeps one reader); a configuration names
its index kind (``index.kind``: ``kinds/<kind>.py``, the build, the facts
and the roofline bounds of one index family). Adding a configuration, a
mix, a metric or an index kind adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list     # the metric entries this cell reports, --trace 0
    per_layer: list      # ... and --trace 1
    kind: ModuleType     # the configuration's index kind (load_kind)


def load_benchmark(root: Path = CHECKOUT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def name_problems(bench: dict) -> list[str]:
    """Every name or unit of ``bench`` that breaks the character rules."""
    bad = []

    def name(v, where):
        if not (isinstance(v, str) and NAME.fullmatch(v)):
            bad.append(f"{where}: name {v!r}")

    for c in bench.get("configs", []):
        name(c.get("name"), "configs")
        for key in c.get("reduced", []):
            name(key, f"configs.{c.get('name')}.reduced")
    for w in bench.get("workloads", []):
        name(w.get("name"), "workloads")
        name(w.get("config"), f"workloads.{w.get('name')}.config")
        name(w.get("traffic"), f"workloads.{w.get('name')}.traffic")
    for group in ("end_to_end", "per_layer"):
        for m in bench.get(group, []):
            name(m.get("name"), group)
            if not (isinstance(m.get("unit"), str)
                    and UNIT.fullmatch(m["unit"])):
                bad.append(f"{group}.{m.get('name')}: unit {m.get('unit')!r}")
    return bad


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, else every cell (end to end) or every cell that reports the
    end-to-end metric it ``moves`` (per layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(bench: dict, workload: str, base: Path = HERE) -> Cell:
    """The cell named ``workload`` with its configuration and traffic
    files read, and its configuration's index kind loaded, from under
    ``base``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(Path(base).parent / configs[w["config"]]["file"])
    traffic = _read_json(Path(base) / "traffic" / f"{w['traffic']}.json")
    kind = load_kind(config.get("index", {}).get("kind"), base)
    e2e = [m for m in bench["end_to_end"] if reports(m, workload, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, workload, e2e_names)]
    return Cell(name=workload, config=config, traffic=traffic,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                kind=kind)


def reader_path(name: str, base: Path = HERE) -> Path:
    """``metrics/<name>.py``, else ``metrics/<stem>.py`` for a name
    ``<stem>.<suffix>``."""
    path = Path(base) / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = Path(base) / "metrics" / f"{name.split('.', 1)[0]}.py"
    return path


def _load(prefix: str, name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"{prefix}{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, base: Path = HERE):
    """The ``read(run)`` function of the metric's reader
    (:func:`reader_path`)."""
    return _load("vdb_bench_metric_", name, reader_path(name, base)).read


def kind_path(name: str, base: Path = HERE) -> Path:
    """``kinds/<name>.py``."""
    return Path(base) / "kinds" / f"{name}.py"


def load_kind(name, base: Path = HERE) -> ModuleType:
    """The module of the index kind ``name`` (:func:`kind_path`). A
    ``ValueError``, naming the kinds there are, where ``name`` is missing or
    names no file."""
    path = (kind_path(name, base)
            if isinstance(name, str) and NAME.fullmatch(name) else None)
    if path is None or not path.is_file():
        have = sorted(p.stem for p in (Path(base) / "kinds").glob("*.py"))
        raise ValueError(f"no index kind {name!r} (index.kind; have: "
                         f"{', '.join(have)})")
    return _load("vdb_bench_kind_", name, path)
