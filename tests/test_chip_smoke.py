"""The GPU smoke script's and the benchmark's host-side contract.

What needs no card: where the compile cache goes, refusal of a CPU
device, the exact last line, and a non-zero exit whenever a phase
fails or the script runs without the repository.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from parmgmc_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_cache_dir_is_repo_dir_when_variable_unset():
    path = compile_cache.cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_defers_to_variable_when_set():
    assert compile_cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None


def test_enable_compile_cache_sets_repo_dir_when_unset(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == compile_cache.REPO_CACHE_DIR
    assert calls == [("jax_compilation_cache_dir", compile_cache.REPO_CACHE_DIR)]


def test_enable_compile_cache_sets_nothing_when_variable_set(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == "/elsewhere"
    assert calls == []


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="not a GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_require_gpu_counts_cards():
    card = types.SimpleNamespace(platform="gpu", device_kind=GPU["kind"])
    assert chip_smoke.require_gpu([card]) == GPU
    with pytest.raises(RuntimeError, match="4 needed"):
        chip_smoke.require_gpu([card], count=4)
    assert chip_smoke.require_gpu([card] * 4, count=4)["count"] == 4


def test_result_line_is_exact():
    assert chip_smoke.result_line(GPU) == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )


def test_run_phases_reports_each_phase(capsys):
    def boom():
        raise ValueError("bad")

    assert chip_smoke.run_phases([("X", lambda: {"v": 1}), ("Y", boom)]) is False
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [(r["phase"], r["ok"]) for r in lines] == [("X", True), ("Y", False)]
    assert lines[0]["v"] == 1 and "bad" in lines[1]["error"]
    assert chip_smoke.run_phases([("Z", lambda: None)]) is True


def _fake_card(monkeypatch, failing=()):
    """Replace the card and every phase; ``failing`` phases raise."""
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "NVIDIA H100, 700.00 W")
    monkeypatch.setattr(chip_smoke, "require_gpu", lambda devs, count=1: dict(GPU, count=count))
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "/cache")

    def phase(name):
        def run(*a, **k):
            if name in failing:
                raise RuntimeError(f"{name} failed")
            return {}

        return run

    for name in ("phase_b", "phase_c", "phase_bench", "phase_f", "phase_g",
                 "phase_sharded_mgmc", "phase_chain_mesh", "phase_graph_sharded"):
        monkeypatch.setattr(chip_smoke, name, phase(name))


@pytest.mark.parametrize("failing", ["phase_b", "phase_c", "phase_bench", "phase_g"])
def test_main_exits_nonzero_when_a_phase_fails(monkeypatch, capsys, failing):
    _fake_card(monkeypatch, failing=(failing,))
    assert chip_smoke.main([]) == 1
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()[1:]]
    assert all("phase" in r for r in lines)
    assert any(not r["ok"] for r in lines)


@pytest.mark.parametrize("argv,count", [([], 1), (["--four-cards"], 4)])
def test_main_prints_result_last_when_all_pass(monkeypatch, capsys, argv, count):
    _fake_card(monkeypatch)
    assert chip_smoke.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == chip_smoke.result_line(dict(GPU, count=count))
    assert "NVIDIA H100, 700.00 W" in out[:-1]


def test_main_exits_nonzero_without_nvidia_smi(monkeypatch, capsys):
    def missing():
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(chip_smoke, "nvidia_smi", missing)
    assert chip_smoke.main([]) == 1
    assert capsys.readouterr().out == ""


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_bench_refuses_cpu_unless_rehearsal(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert bench.require_gpu()["platform"] == "cpu"
    monkeypatch.delenv("JAX_PLATFORMS")
    with pytest.raises(SystemExit, match="GPU"):
        bench.require_gpu()


@pytest.mark.parametrize("posterior", [False, True])
def test_bench_build(posterior):
    op, b, smp = bench.build(posterior=posterior, n=16)
    assert smp.grid_shape == (16, 16, 16)
    assert smp.dtype == jnp.float32
    assert (b is None) != posterior
    if posterior:
        assert op.k == 5 and op.patch_vals is not None


def test_bench_main_record(monkeypatch, capsys):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    record, smp, b = bench.main(n=16, steps=8, iact_steps=16)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["ms_per_cycle"] == record["ms_per_cycle"] > 0
    assert record["device"]["platform"] == "cpu"
    assert record["iact_steps"] == 16 and b is None
    assert np.isfinite(record["value"]) and record["compile_s"] > 0
