"""Placement of JAX's persistent compilation cache (runtime/jax_cache.py):
``JAX_COMPILATION_CACHE_DIR`` when set, else the fixed in-checkout
``.jax_cache``; no other code picks a directory."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

from kmtricks_tpu.runtime import jax_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture()
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_dir_is_honoured(tmp_path):
    """A CLI run with JAX_COMPILATION_CACHE_DIR set writes its compiled
    programs there (and the shape history beside them)."""
    cache = tmp_path / "cache"
    rng_reads = "\n".join(
        f">r{i}\n" + "ACGTTGCAAGGCTTAC"[i % 7:] * 8 for i in range(40))
    (tmp_path / "S0.fasta").write_text(rng_reads + "\n")
    (tmp_path / "t.fof").write_text(f"S0 : {tmp_path / 'S0.fasta'}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(REPO))
    code = ("import jax, sys; from kmtricks_tpu.cli import main; "
            "main(sys.argv[1:]); "
            "print('DIR', jax.config.jax_compilation_cache_dir)")
    out = subprocess.run(
        [sys.executable, "-c", code, "pipeline", "--file",
         str(tmp_path / "t.fof"), "--run-dir", str(tmp_path / "run"),
         "-k", "21", "--hard-min", "1", "--backend", "mesh",
         "--nb-partitions", "2", "--verbose", "warning"],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"DIR {cache}" in out.stdout
    written = [p for p in cache.iterdir() if p.is_file()]
    assert written, "no compiled program was cached"


def test_default_is_fixed_checkout_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax_cache.DEFAULT_DIR == str(REPO / ".jax_cache")
    assert jax_cache.compile_cache_dir() == jax_cache.DEFAULT_DIR
    assert jax_cache.enable_compile_cache() == jax_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == jax_cache.DEFAULT_DIR
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_no_code_override(tmp_path, monkeypatch, restore_cache_config):
    """With the variable set, the helper hands JAX exactly that directory,
    and no other file of the program sets a cache directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert jax_cache.enable_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    sources = list((REPO / "kmtricks_tpu").rglob("*.py"))
    sources += list((REPO / "scripts").glob("*.py"))
    sources += [REPO / "bench.py", REPO / "chip_smoke.py"]
    setters = []
    for f in sources:
        text = f.read_text()
        if ("jax_compilation_cache_dir\"," in text
                or "set_cache_dir(" in text):
            setters.append(f.relative_to(REPO).as_posix())
    assert setters == ["kmtricks_tpu/runtime/jax_cache.py"], setters
