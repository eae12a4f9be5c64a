"""Placement rule of the persistent compilation cache (utils/compcache.py)."""

import os

import pytest

from oece_tpu.utils import compcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(compcache.ENV_VAR, raising=False)
    assert compcache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compcache.ENV_VAR, str(tmp_path))
    assert compcache.cache_dir() == str(tmp_path)


def test_checkout_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert os.path.basename(compcache.REPO_CACHE_DIR) in ignored


@pytest.mark.parametrize("env_set", [False, True])
def test_enable_sets_no_dir_when_env_given(monkeypatch, tmp_path, env_set):
    """With the variable set the program configures no directory of its
    own; without it, the fixed checkout directory."""
    import jax

    calls = {}
    monkeypatch.setattr(compcache, "_enabled", False)
    monkeypatch.setattr(compcache, "REPO_CACHE_DIR", str(tmp_path / "repo"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    if env_set:
        monkeypatch.setenv(compcache.ENV_VAR, str(tmp_path / "env"))
    else:
        monkeypatch.delenv(compcache.ENV_VAR, raising=False)
    assert compcache.enable_compilation_cache()
    if env_set:
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert calls["jax_compilation_cache_dir"] == str(tmp_path / "repo")
        assert os.path.isdir(tmp_path / "repo")
    monkeypatch.setattr(compcache, "_enabled", False)
