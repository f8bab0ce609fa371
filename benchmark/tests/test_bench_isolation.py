"""The benchmark loads neither JAX nor the JAX package, its reference loads
nothing of the port, and a run refuses to print a result where it cannot
measure the port on a card."""

import shutil
import subprocess
import sys

import pytest

from benchmark import harness, manifest

ROOT = manifest.ROOT
REF = ROOT / "benchmark" / "reference"


@pytest.mark.parametrize("loaded,found", [
    (["torch", "paddlerobotics_torch.envs.batched_env"], []),
    (["jax.numpy"], ["jax"]), (["jaxlib"], ["jaxlib"]),
    (["flax.linen", "optax"], ["flax", "optax"]),
    (["orbax.checkpoint"], ["orbax"]),
    (["paddlerobotics_tpu.ops.pallas"], ["paddlerobotics_tpu"]),
    (["paddlerobotics_tpu_extra", "jaxtyping", "flaxen"], []),
])
def test_guard_compares_whole_top_level_names(loaded, found):
    assert harness.forbidden_modules(loaded) == found


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    """Every module a run imports, the port's included, in a fresh
    process."""
    code = (
        "import benchmark.run, benchmark.harness as h, benchmark.manifest as m\n"
        "for d in ('rollout', 'train', 'deploy'):\n"
        "    m.driver(d)\n"
        "import paddlerobotics_torch.train.etg_rl, "
        "paddlerobotics_torch.deploy.policy_export, "
        "paddlerobotics_torch.deploy.realtime\n"
        "import benchmark.tools.readings\n"
        "for x in m.load()['per_layer']:\n"
        "    m.metric_reader(x['name'])\n"
        "print(h.forbidden_modules())")
    assert _fresh(code) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    mods = sorted(p.stem for p in REF.glob("*.py") if p.stem != "__init__")
    code = ("import importlib, sys\n"
            f"for n in {mods!r}:\n"
            "    importlib.import_module('benchmark.reference.' + n)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'paddlerobotics_torch', 'paddlerobotics_tpu', 'jax'}))")
    assert _fresh(code) == "[]"
    for p in REF.glob("*.py"):
        for line in p.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "paddlerobotics" not in s, (p.name, s)


def test_no_card_means_no_result():
    """Here there is no card: the command exits 2 and prints nothing on
    standard output."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "a1_etg_flat.rollout_b4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_alone_in_a_directory_it_gives_no_result(tmp_path):
    """BENCHMARK.json and the files under paths, without the program: the
    run fails before any result, here on the CPU too."""
    bench = manifest.load()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import benchmark.run as r, json\n"
            "line, _ = r.run_cell('a1_etg_flat.rollout_b4096', 1, 0.1, "
            "False, device='cpu')\n"
            "print(json.dumps(line))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "correct" not in out.stdout
    assert "paddlerobotics_torch" in out.stderr
