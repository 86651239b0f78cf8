"""``BENCHMARK.json`` and the files it names: found by name, within the
contract's limits, and open to a new file with no existing file edited."""

from __future__ import annotations

import json
import re
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from slambench import registry, traffic  # noqa: E402
from slambench.tests.cpu_root import make_root  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "slambench/run.py"]
    assert spec["paths"] == ["slambench"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("key", sorted(ENTRY_KEYS))
def test_entries_have_the_contract_keys_and_names(spec, key):
    names = [e["name"] for e in spec[key]]
    assert len(names) == len(set(names))
    for entry in spec[key]:
        extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[key] <= set(entry) <= ENTRY_KEYS[key] | extra, entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in entry:
                assert _line(entry[text]), (entry["name"], text)


def test_every_name_is_ascii(spec):
    for key in ENTRY_KEYS:
        for entry in spec[key]:
            for field in ("name", "config", "traffic", "unit", "layer", "moves"):
                if field in entry:
                    assert entry[field].isascii(), entry[field]
    for entry in spec["configs"]:
        assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])


def test_workloads_name_known_configs_and_mixes(spec):
    bench = registry.Benchmark(REPO)
    configs = {c["name"] for c in spec["configs"]}
    pairs = set()
    for cell in spec["workloads"]:
        assert cell["config"] in configs and cell["chips"] in (1, 4)
        assert (cell["config"], cell["traffic"]) not in pairs
        pairs.add((cell["config"], cell["traffic"]))
        conf = bench.config(cell["config"])
        assert conf["sequence_frames"] > 0
        traffic.check_mix(bench.traffic(cell["traffic"]))
        limits = bench.limits(cell["name"])
        leaves = limits.pop("leaves")
        assert limits and all(v["limit"] is not None for v in limits.values())
        assert all(v >= 0 for v in leaves.values())
    assert {c["config"] for c in spec["workloads"]} == configs
    four = sum(c["chips"] == 4 for c in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)


def test_config_files_lie_under_paths_and_hold_what_reduced_names(spec):
    for entry in spec["configs"]:
        path = REPO / entry["file"]
        assert entry["file"].startswith("slambench/configs/") and path.exists()
        conf = json.loads(path.read_text())
        assert set(entry["reduced"]) <= set(conf)


def test_metrics_cover_every_cell(spec):
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names
    assert all(m["source"] in ("host_clock", "device_trace") for m in spec["end_to_end"])
    bench = registry.Benchmark(REPO)
    for cell in spec["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.per_layer(cell["name"])
        assert layer
        assert all(m["moves"] in e2e for m in layer)
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_each_per_layer_metric_has_a_reader(spec):
    for m in spec["per_layer"]:
        reader = registry.load_reader(REPO, m["name"])
        assert callable(reader.read)
        assert set(reader.NEEDS) <= set(registry.COLLECTORS)


def test_a_new_metric_file_is_found_with_no_file_edited(tmp_path):
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "slambench").rglob("*") if p.is_file()}
    (root / "slambench" / "metrics" / "frames_pulled.x.py").write_text(
        'NEEDS = ()\n\n\ndef read(run):\n    return float(sum(len(s.pulls) for s in run.sequences))\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "frames_pulled.x", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "runner", "moves": "fps"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = registry.Benchmark(root)
    readers = bench.readers("fr1_vo.room")
    assert "frames_pulled.x" in readers
    run = types.SimpleNamespace(sequences=[types.SimpleNamespace(pulls=[1, 2, 3])])
    assert readers["frames_pulled.x"].read(run) == 3.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_new_mix_and_cell_are_found_with_no_file_edited(tmp_path):
    root = make_root(tmp_path)
    mix = json.loads((root / "slambench" / "traffic" / "room.json").read_text())
    mix.update(scene="HardRoomScene", why="holes and bursts")
    (root / "slambench" / "traffic" / "hard.json").write_text(json.dumps(mix))
    (root / "slambench" / "limits" / "fr1_vo.hard.json").write_text(
        (root / "slambench" / "limits" / "fr1_vo.room.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "fr1_vo.hard", "config": "fr1_vo", "traffic": "hard",
                              "chips": 1, "why": "holes"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = registry.Benchmark(root)
    cell = bench.workload("fr1_vo.hard")
    assert bench.traffic(cell["traffic"])["scene"] == "HardRoomScene"
    assert bench.limits("fr1_vo.hard")
    traffic.check_mix(bench.traffic("hard"))


def test_an_unknown_name_is_refused():
    bench = registry.Benchmark(REPO)
    with pytest.raises(KeyError):
        bench.workload("no_such.cell")
