"""Process set-up shared by every entry point: the persistent compile
cache's location and one card per process under a same-host launch."""

import os

import jax
import pytest

from tpudraco.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honors_env(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed_ignored_dir(monkeypatch,
                                                    restore_cache_dir):
    """Unset, the cache lands in one fixed directory at the checkout's
    root, which git ignores."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    got = compile_cache.enable_compile_cache()
    assert got == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert ".jax_cache/" in ignored, ".jax_cache must be listed in .gitignore"


@pytest.mark.parametrize("coordinator,pid,want", [
    ("localhost:1234", 1, [1]),     # same host: one card per process
    ("127.0.0.1:1234", 3, [3]),
    ("10.0.0.2:1234", 1, None),     # other hosts: all local cards
])
def test_init_distributed_one_card_per_local_process(monkeypatch,
                                                     coordinator, pid,
                                                     want):
    from tpudraco.parallel import multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    multihost.init_distributed(coordinator, num_processes=4,
                               process_id=pid)
    assert seen == {"coordinator_address": coordinator,
                    "num_processes": 4, "process_id": pid,
                    "local_device_ids": want}


def test_init_distributed_reads_launcher_env(monkeypatch):
    from tpudraco.parallel import multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:999")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    multihost.init_distributed()
    assert seen["num_processes"] == 2 and seen["process_id"] == 1
    assert seen["local_device_ids"] == [1]
