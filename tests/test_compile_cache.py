"""The scripts' compilation-cache helper (utils/compile_cache.py)."""
import os

import pytest

from advancedmh_tpu.utils import compile_cache


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"],
                         ids=["unset", "set"])
def test_cache_dir(monkeypatch, env_dir):
    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: calls.append(a))
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
    path = compile_cache.enable_compile_cache()
    if env_dir is not None:
        # JAX reads the variable itself; nothing else is set in code
        assert path == env_dir and calls == []
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
