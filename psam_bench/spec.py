"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration
(``psam_bench/configs/<config>.json``) and a traffic mix
(``psam_bench/traffic/<traffic>.json``), and has its comparison limits in
``psam_bench/limits/<cell>.json``. The mix names the loop that drives it
(``"loop"``: ``psam_bench/loops/<loop>.py``, its ``run(ctx)``); the
configuration names its model kind (``"kind"``:
``psam_bench/reference/<kind>.py``, the kind's reference layers and
FLOPs). A per-layer metric is read by ``psam_bench/metrics/<metric>.py``'s
``read(records)``. A new cell, configuration, mix, loop, model kind or
metric is new files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    pass


def check_name(kind: str, name) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"bad {kind} name {name!r}")
    return name


def load(home: Path = HERE) -> dict:
    """``BENCHMARK.json`` beside the benchmark's folder ``home``, its names
    and units checked; ``home`` rides along under ``"home"``."""
    spec = json.loads((Path(home).parent / "BENCHMARK.json").read_text())
    for entry in spec["configs"] + spec["workloads"] + spec["end_to_end"] + spec["per_layer"]:
        check_name("entry", entry["name"])
    for w in spec["workloads"]:
        check_name("config", w["config"])
        check_name("traffic", w["traffic"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        if not UNIT.match(m["unit"]):
            raise SpecError(f"bad unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            raise SpecError(f"bad 'better' of {m['name']}")
    spec["home"] = Path(home)
    return spec


def _entry(items: list, name: str, what: str) -> dict:
    for e in items:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r}")


def _json(home: Path, sub: str, name: str) -> dict:
    path = home / sub / f"{check_name(sub, name)}.json"
    if not path.is_file():
        raise SpecError(f"no file {sub}/{name}.json in {home}")
    return json.loads(path.read_text())


def cell(spec: dict, name: str) -> dict:
    """The cell's entry with its configuration, traffic and limits loaded."""
    home = spec["home"]
    w = _entry(spec["workloads"], name, "workload")
    c = _entry(spec["configs"], w["config"], "config")
    config = json.loads((home.parent / c["file"]).read_text())
    return dict(w, config_data=config, traffic_data=_json(home, "traffic", w["traffic"]),
                limits=_json(home, "limits", name))


def end_to_end(spec: dict, cell_name: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(spec: dict, cell_name: str) -> list:
    """The per-layer metrics a cell's traced run reports: those listing it,
    and those without a list that move an end-to-end metric it reports."""
    mine = {m["name"] for m in end_to_end(spec, cell_name)}

    def listed(m):
        return cell_name in m["workloads"] if "workloads" in m else m["moves"] in mine

    return [m for m in spec["per_layer"] if listed(m)]


def module(home: Path, sub: str, name: str):
    """The Python file ``<home>/<sub>/<name>.py``, loaded by its path."""
    path = Path(home) / sub / f"{check_name(sub, name)}.py"
    if not path.is_file():
        raise SpecError(f"no file {sub}/{name}.py in {home}")
    mod_spec = importlib.util.spec_from_file_location(
        f"psam_bench_{sub}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(spec: dict, name: str):
    """The ``read(records)`` function of a per-layer metric."""
    return module(spec["home"], "metrics", name).read


def loop(spec: dict, traffic: dict):
    """The loop module that drives a traffic mix (its ``"loop"``)."""
    return module(spec["home"], "loops", traffic["loop"])


def kind(spec: dict, config: dict):
    """The model kind's module of a configuration (its ``"kind"``)."""
    return module(spec["home"], "reference", config["kind"])
