"""The benchmark's files: every cell, configuration and metric found by
name; the character sets; a cell, a configuration and a metric added as
files alone; the guard against JAX; the StyleGAN2 window's period."""
import json
import re
import shutil

import pytest

from benchmark.harness import core
from benchmark.reference import sg2_train

SPEC = core.load_json(core.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_and_unit_is_in_the_character_sets():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(set(names[:len(SPEC["end_to_end"]) + len(SPEC["per_layer"])])) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert all(UNIT.match(m["unit"]) for m in SPEC["end_to_end"] + SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        assert "\n" not in m["layer"] and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files(cell):
    workload, config, e2e, per_layer = core.find_cell(cell)
    assert workload["config"] == config["name"]
    assert (core.BENCH_DIR / "traffic" / f"{workload['driver']}.py").is_file()
    assert workload["metric"] in {m["name"] for m in e2e} and "setup_s" in {m["name"] for m in e2e}
    assert per_layer
    for m in per_layer:
        reader = core.load_module(core.BENCH_DIR / "metrics" / f"{m['name']}.py")
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
    spec_cell = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert {k: workload[k] for k in spec_cell} == spec_cell


def test_each_config_file_is_the_one_named():
    for c in SPEC["configs"]:
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_a_cell_config_and_metric_added_as_files_alone(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(core.BENCH_DIR, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cfg = dict(core.load_json(bench / "configs" / "stylegan2-256-ffhq.json"), name="dummy-cfg")
    (bench / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    wl = dict(core.load_json(bench / "workloads" / "sg2_256.drs.json"), name="dummy.cell",
              config="dummy-cfg", traffic="dummy")
    (bench / "workloads" / "dummy.cell.json").write_text(json.dumps(wl))
    (bench / "metrics" / "dummy_pct.py").write_text(
        'LAYER, MOVES = "eval", "drs_accepted_per_s"\n\n\ndef read(facts):\n    return 1.0\n')
    spec["workloads"].append({k: wl[k] for k in ("name", "config", "traffic", "chips", "why")})
    spec["per_layer"].append({"name": "dummy_pct", "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "eval",
                              "moves": "drs_accepted_per_s", "workloads": ["dummy.cell"]})
    next(m for m in spec["end_to_end"] if m["name"] == "drs_accepted_per_s")["workloads"].append(
        "dummy.cell")
    workload, config, e2e, per_layer = core.find_cell("dummy.cell", bench, spec)
    assert config["name"] == "dummy-cfg" and workload["driver"] == "drs"
    assert [m["name"] for m in per_layer] == ["dummy_pct"]
    assert {m["name"] for m in e2e} == {"drs_accepted_per_s", "setup_s"}
    assert core.load_module(bench / "metrics" / "dummy_pct.py").read({}) == 1.0


def test_the_guard_compares_whole_top_level_names():
    assert core.loaded_forbidden({"diagan_tpu_torch": 1, "diagan_tpu_torch.ops": 1,
                                  "jaxtyping": 1, "numpy": 1}) == []
    assert core.loaded_forbidden({"jax.numpy": 1, "flax": 1, "diagan_tpu.models": 1,
                                  "jaxlib": 1}) == ["diagan_tpu", "flax", "jax", "jaxlib"]


def test_the_guard_finds_nothing_in_this_process_after_a_cpu_run():
    import benchmark.traffic.sg2_train  # noqa: F401  (the drivers import the port)
    import diagan_tpu_torch.train.stylegan2_trainer  # noqa: F401
    assert core.loaded_forbidden() == []


@pytest.mark.parametrize("start", [0, 16, 200000])
def test_a_window_of_whole_periods_holds_the_published_mix(start):
    cfg = core.load_json(core.BENCH_DIR / "configs" / "stylegan2-256-ffhq.json")
    for periods in (1, 2, 3):
        kinds = [sg2_train.step_kind(t, cfg) for t in range(start, start + 16 * periods)]
        assert (kinds.count("r1+path"), kinds.count("path"), kinds.count("plain")) == \
            (periods, 3 * periods, 12 * periods)
