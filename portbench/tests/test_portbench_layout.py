"""The benchmark's files: every name in BENCHMARK.json finds its file,
the contract's shapes hold, and a new cell, configuration, mix or metric
is added by adding files only."""
import json
import re
import subprocess
import sys

import pytest

from portbench.harness import spec
from portbench.tests import smoke

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    b = spec.benchmark()
    for name in spec.cells_of(b):
        cell = spec.Cell(name, b)
        assert (spec.PORTBENCH / "mixes" / f"{cell.mix_name}.py").is_file()
        assert (spec.PORTBENCH / "reference"
                / f"{cell.conf['arch']}.py").is_file()
        for m in cell.per_layer:
            cell.reader(m["name"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert cell.limits


def test_names_and_shapes_follow_the_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        conf = spec.read_json(spec.ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for x in b["configs"] + b["workloads"] + metrics:
        assert NAME.match(x["name"]), x["name"]
        assert len(x.get("why", "")) <= 200
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_added_as_files_loads(tmp_path):
    root = smoke.tree(tmp_path)
    # a per-layer metric added as a file and an entry
    (root / "portbench" / "metrics" / "loss_ms_new.py").write_text(
        "def read(ctx):\n    return None\n")
    b = spec.benchmark(root)
    b["per_layer"].append({"name": "loss_ms_new", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "model", "moves": "train_tokens_per_s",
                           "workloads": ["t-smoke"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.Cell("t-smoke", spec.benchmark(root), root / "portbench")
    assert cell.conf["name"] == "glm-smoke"
    assert "loss_ms_new" in [m["name"] for m in cell.per_layer]
    assert cell.reader("loss_ms_new").read(None) is None
    assert cell.mix().SPANS and cell.reference().leaf_specs(cell.conf["model"])
    # the files that were there are unchanged
    for f in spec.PORTBENCH.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (root / "portbench" / f.relative_to(spec.PORTBENCH)
                    ).read_bytes() == f.read_bytes()


def test_a_cell_file_that_disagrees_is_refused(tmp_path):
    root = smoke.tree(tmp_path)
    w = spec.read_json(root / "portbench" / "workloads" / "t-smoke.json")
    w["config"] = "granite-smoke"
    (root / "portbench" / "workloads" / "t-smoke.json").write_text(
        json.dumps(w))
    with pytest.raises(ValueError):
        spec.Cell("t-smoke", spec.benchmark(root), root / "portbench")


def _modules_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{spec.ROOT}:{spec.ROOT / 'src'}",
             "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_imports_jax_or_the_jax_package():
    code = ("from portbench.harness import bench, spec, profile, spans, "
            "readers\nb = spec.benchmark()\n"
            "for n in spec.cells_of(b):\n"
            "    c = spec.Cell(n, b); c.mix(); c.reference()\n"
            "    [c.reader(m['name']) for m in c.per_layer]\n"
            "import repro_torch.train.train_step, "
            "repro_torch.serve.serve_step\n")
    tops = _modules_after(code)
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks",
                       "chip_smoke"}
    assert "repro_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    code = ("from portbench.harness import spec\nb = spec.benchmark()\n"
            "[spec.Cell(n, b).reference() for n in spec.cells_of(b)]\n")
    assert "repro_torch" not in _modules_after(code)


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for a machine without")
    b = spec.benchmark()
    out = subprocess.run(
        [sys.executable, *b["command"][1:], "--workload",
         spec.cells_of(b)[0], "--seed", "2147483648", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and not out.stdout.strip()


def test_each_pass_serves_the_pool_in_rounds_of_every_stratum():
    from portbench.mixes import prefill_ship
    lp = spec.read_json(spec.PORTBENCH / "workloads"
                        / "chatglm3-prefill-long.json")["params"]["lengths"]
    base = sorted(prefill_ship.pool(lp))
    k, n = lp["strata"], len(base)
    w = n // k
    got = prefill_ship.lengths(2**31 + 11, lp, 3 * n)
    assert got == prefill_ship.lengths(2**31 + 11, lp, 3 * n)
    assert got != prefill_ship.lengths(2**31 + 12, lp, 3 * n)
    for c in range(3):
        one = got[c * n:(c + 1) * n]
        assert sorted(one) == base
        for r in range(w):
            block = sorted(one[r * k:(r + 1) * k])
            # one length from each stratum of the sorted pool
            assert all(base[s * w] <= block[s] <= base[s * w + w - 1]
                       for s in range(k)), (c, r, block)
