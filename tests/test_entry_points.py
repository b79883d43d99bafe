"""Entry points and what the package may depend on.

The encoder runs on XLA alone: no module imports Pallas, the CLI, the
benchmark and the smoke test refuse a backend they cannot measure, and
the compile cache has one fixed home.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_module_imports_pallas():
    files = sorted((REPO / "nanohevc_tpu").rglob("*.py"))
    files += [REPO / "bench.py", REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = {
        str(f.relative_to(REPO)): mod
        for f in files
        for mod in _imported_modules(f)
        if mod.startswith("jax.experimental.pallas")
    }
    assert not bad, bad


class TestCompileCache:
    def test_honours_env_variable(self, monkeypatch):
        from nanohevc_tpu.utils.compile_cache import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
        assert enable_compile_cache() == "/somewhere/else"
        assert jax.config.jax_compilation_cache_dir == before

    def test_fixed_checkout_path_otherwise(self, monkeypatch):
        from nanohevc_tpu.utils.compile_cache import enable_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            got = enable_compile_cache()
            assert got == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            assert ".jax_cache/" in (REPO / ".gitignore").read_text()
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


def _run(script: Path, cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _printed_ok(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_gpu():
    proc = _run(REPO / "chip_smoke.py", REPO)
    assert proc.returncode != 0
    assert not _printed_ok(proc.stdout)
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    proc = _run(alone, tmp_path)
    assert proc.returncode != 0
    assert not _printed_ok(proc.stdout)


def test_bench_refuses_cpu():
    proc = _run(REPO / "bench.py", REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "measures the GPU" in proc.stderr


@pytest.mark.parametrize("module", ["bench", "chip_smoke"])
def test_scripts_import_without_side_effects(module, monkeypatch):
    """Importing a script runs nothing: tests and tools can reuse its
    helpers without touching a device."""
    monkeypatch.syspath_prepend(str(REPO))
    mod = __import__(module)
    assert callable(mod.main)
