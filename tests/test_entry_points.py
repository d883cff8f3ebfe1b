"""Entry-point contracts that hold on any host: the GPU smoke test and the
benchmark refuse to report without a GPU, the compile cache lives where
the environment or the checkout says, and no module needs Pallas."""

import ast
import json
import os
import subprocess
import sys

import pytest

from particle_col_image_segmentation_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "particle_col_image_segmentation_tpu")


def _run(args, env_extra=None, drop=(), timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_no_gpu_exits_nonzero_without_result(script):
    r = _run([script], {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "{" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_result_line_contract_keys():
    sys.path.insert(0, ROOT)
    import chip_smoke

    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    obj = json.loads(line)
    assert obj == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }


def test_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == str(tmp_path)


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert cache.DEFAULT_CACHE_DIR == want
    assert cache.compile_cache_dir() == want
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


_PROBE = (
    "import sys; sys.path.insert(0, '.');"
    "__import__(sys.argv[1]);"
    "import jax; print(jax.config.jax_compilation_cache_dir)"
)


@pytest.mark.parametrize(
    "module",
    ["particle_col_image_segmentation_tpu.cli", "bench", "chip_smoke"],
)
@pytest.mark.parametrize("env_set", [True, False])
def test_entry_points_use_cache_dir(module, env_set, tmp_path):
    """The CLI, bench.py and chip_smoke.py cache where
    JAX_COMPILATION_CACHE_DIR says, else in <checkout>/.jax_cache."""
    if env_set:
        r = _run(["-c", _PROBE, module],
                 {"JAX_PLATFORMS": "cpu",
                  "JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        want = str(tmp_path)
    else:
        r = _run(["-c", _PROBE, module], {"JAX_PLATFORMS": "cpu"},
                 drop=("JAX_COMPILATION_CACHE_DIR",))
        want = os.path.join(ROOT, ".jax_cache")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want


def _imported_names(path):
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_module_imports_pallas():
    found = {}
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                hits = [n for n in _imported_names(p)
                        if n.startswith("jax.experimental.pallas")]
                if hits:
                    found[os.path.relpath(p, ROOT)] = hits
    assert found == {}


_TRACE_PROBE = """
import sys, jax, jax.numpy as jnp
from particle_col_image_segmentation_tpu.utils.profiling import (
    device_stage_times, hlo_op_stages)
@jax.jit
def f(x):
    with jax.named_scope("median"):
        y = jnp.sum(jnp.sin(x), axis=0)  # a reduction: its own kernel
    with jax.named_scope("fill"):
        with jax.named_scope("edt"):
            z = jnp.cos(x) * y[None, :] + 1.0
    return z
x = jnp.ones((256, 256))
f(x).block_until_ready()
with jax.profiler.trace(sys.argv[1]):
    for _ in range(3):
        f(x).block_until_ready()
stages = hlo_op_stages(sys.argv[2])
times = device_stage_times(sys.argv[1], stages)
print(sorted(set(v for (m, _), v in stages.items() if m == "jit_f")))
print(sorted(times))
"""


def test_device_stage_times_from_trace(tmp_path):
    """The trace → per-stage reduction on a recorded CPU trace: ops map to
    the OUTERMOST stage scope of their op_name (an EDT inside the fill
    stage counts as fill), and the times carry total and window."""
    trace, hlo = tmp_path / "trace", tmp_path / "hlo"
    r = _run(
        ["-c", _TRACE_PROBE, str(trace), str(hlo)],
        {"JAX_PLATFORMS": "cpu", "JAX_ENABLE_COMPILATION_CACHE": "false",
         "XLA_FLAGS": f"--xla_dump_to={hlo} --xla_dump_hlo_as_text"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    mapped, keys = (eval(line) for line in r.stdout.strip().splitlines()[-2:])
    assert mapped == ["fill", "median"]
    assert {"median", "fill", "total", "window"} <= set(keys)
