"""Each per-layer metric of BENCHMARK.json is found by name, and a new
one is added as a file, with no edit to any file that is there."""

import json

import pytest

from bench_port.harness import spec

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_its_reader(metric):
    reader = spec.metric_reader(metric)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert reader.UNIT == entry["unit"]
    assert callable(reader.read)
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_a_metric_added_from_a_new_directory(tmp_path):
    (tmp_path / "frames_seen.py").write_text(
        'UNIT = "frames"\n\ndef read(record):\n    return record.frames\n')
    reader = spec.metric_reader("frames_seen", directory=tmp_path)

    class Record:
        frames = 7
    assert reader.read(Record()) == 7


def test_a_cell_and_a_config_added_as_entries(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    base = bench["configs"][0]
    bench["configs"].append(dict(base, name="semidense-copy"))
    bench["workloads"].append({"name": "sd-copy.forward",
                               "config": "semidense-copy",
                               "traffic": "forward", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = spec.load_benchmark(tmp_path)
    entry, config = spec.cell(loaded, "sd-copy.forward")
    assert config["file"] == base["file"]
    reported = [m["name"] for m in spec.metrics_of(loaded, "sd-copy.forward",
                                                   "per_layer")]
    assert reported == []          # every metric lists its cells
    assert [m["name"] for m in spec.metrics_of(
        loaded, "sd-copy.forward", "end_to_end")] == [
            "fps", "pose_ms_p95", "setup_s"]


def test_every_cell_reports_setup_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.metrics_of(BENCH, w["name"],
                                                  "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(BENCH, w["name"], "per_layer")
        _, config_entry = spec.cell(BENCH, w["name"])
        config = spec.load_config(config_entry)
        spec.app_driver(config)      # the configuration's driver exists
