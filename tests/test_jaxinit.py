"""The persistent compilation-cache rule of art_jax._jaxinit.ensure_jax:
``JAX_COMPILATION_CACHE_DIR`` governs where it is set; otherwise the cache
is ``<repo>/.jax_cache``.  Each case runs in a fresh process, since the
rule is applied once per process."""

import json
import os
import subprocess
import sys

import pytest

from art_jax._jaxinit import REPO_CACHE_DIR, cache_dir_to_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, jax
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
from art_jax._jaxinit import ensure_jax
ensure_jax()
import jax.numpy as jnp
jax.jit(lambda x: jnp.cos(x) * 3.0 + 1.0)(jnp.ones(5)).block_until_ready()
print(json.dumps({"dir": jax.config.jax_compilation_cache_dir}))
"""


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])["dir"]


@pytest.mark.parametrize("environ,expect", [
    ({}, str(REPO_CACHE_DIR)),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, str(REPO_CACHE_DIR)),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
])
def test_cache_dir_rule(environ, expect):
    assert cache_dir_to_set(environ) == expect


def test_repo_cache_dir_is_gitignored_path():
    assert REPO_CACHE_DIR == REPO_CACHE_DIR.parent / ".jax_cache"
    assert REPO_CACHE_DIR.parent.samefile(REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_cache_dir_governs_and_receives_entries(tmp_path):
    target = tmp_path / "cc"
    assert _probe(target) == str(target)
    assert any(target.iterdir())


def test_unset_env_uses_repo_cache():
    assert _probe(None) == str(REPO_CACHE_DIR)
