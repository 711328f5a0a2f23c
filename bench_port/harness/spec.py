"""The benchmark file and the lookups by name: a cell's configuration
(``configs/<name>.json``), its traffic mix (``traffic/<name>.json``),
the driver of the configuration's app (``apps/<app>.py``) and each
per-layer metric's reader (``metrics/<name>.py``).  Adding a
configuration, a mix, a cell or a metric adds files and entries; no
file here names one."""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
METRICS_DIR = BENCH_DIR / "metrics"
APPS_DIR = BENCH_DIR / "apps"


def load_benchmark(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def cell(bench, workload):
    """(workload entry, configuration entry) of a cell's name."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    for c in bench["configs"]:
        if c["name"] == w["config"]:
            return w, c
    raise KeyError(f"workload {workload!r} names no configuration")


def load_config(entry, root=ROOT):
    return json.loads((Path(root) / entry["file"]).read_text())


def load_module(path, name):
    """A Python file as a module, by path (names may hold '-')."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def app_driver(config, directory=APPS_DIR):
    return load_module(Path(directory) / f"{config['app']}.py",
                       f"bench_port_app_{config['app']}")


def metric_reader(name, directory=METRICS_DIR):
    """The reader of a per-layer metric: a module with ``UNIT`` and
    ``read(record) -> float or None``."""
    return load_module(Path(directory) / f"{name}.py",
                       "bench_port_metric_" + name.replace(".", "_")
                       .replace("-", "_"))


def metrics_of(bench, workload, key):
    """The ``end_to_end`` or ``per_layer`` entries that a cell reports:
    those without ``workloads`` and those that list it."""
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]
