"""Backend choices that follow the JAX platform: ``--backend auto`` and the
repartition sampler pick the device path on any accelerator, the host path
on a CPU backend, and a backend that fails to start raises."""

import jax
import pytest

from kmtricks_tpu.runtime import pipeline as rp


def _opts(**kw):
    return rp.PipelineOptions(fof="x.fof", run_dir="run", backend="auto",
                              **kw)


@pytest.mark.parametrize("platform,want", [("gpu", "device"),
                                           ("cpu", "host")])
def test_sampler_backend_follows_platform(monkeypatch, platform, want):
    monkeypatch.delenv("KMTRICKS_REPART_SAMPLER", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert rp._sampler_backend() == want


@pytest.mark.parametrize("forced", ["device", "host"])
def test_sampler_backend_env_override(monkeypatch, forced):
    monkeypatch.setenv("KMTRICKS_REPART_SAMPLER", forced)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert rp._sampler_backend() == forced


@pytest.mark.parametrize("platform,kw,want", [
    ("gpu", {}, "mesh"),
    ("cpu", {}, "host"),
    ("gpu", {"until": "count"}, "device"),
    ("gpu", {"restrict_to_list": [0]}, "device"),
])
def test_resolve_backend_auto(monkeypatch, platform, kw, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert rp._resolve_backend(_opts(**kw)) == want


def test_resolve_backend_explicit_choice_kept(monkeypatch):
    def boom():
        raise AssertionError("an explicit backend must not query jax")
    monkeypatch.setattr(jax, "default_backend", boom)
    o = _opts()
    o.backend = "mesh"
    assert rp._resolve_backend(o) == "mesh"


def test_backend_init_failure_propagates(monkeypatch):
    """A broken accelerator plugin fails loudly instead of silently
    running the host numpy path."""
    def broken():
        raise RuntimeError("Unable to initialize backend 'cuda'")
    monkeypatch.setattr(jax, "default_backend", broken)
    monkeypatch.delenv("KMTRICKS_REPART_SAMPLER", raising=False)
    with pytest.raises(RuntimeError, match="initialize backend"):
        rp._resolve_backend(_opts())
    with pytest.raises(RuntimeError, match="initialize backend"):
        rp._sampler_backend()
