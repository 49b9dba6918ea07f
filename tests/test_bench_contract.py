"""The bench line's contract: the production corpus metric carries its
per-plane sub-metrics (bulk_device_mbs / bulk_host_mbs), the routing
decisions and the cold/warm routing times, and every line names the
device it ran on. The bench functions run in-process here at tiny
sizes on the CPU backend; bench.py itself refuses to run without a
GPU, so no CPU number can stand under a device metric's name."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, ROOT)
    import bench as mod
    return mod


def test_live_line_carries_single_plane_submetrics(bench):
    positions, faces, _gn, _gathers = bench._setup(batch=8, n=12)
    res = bench.bench_corpus_auto(positions, faces, small_n=12, huge_n=32)
    assert res["metric"] == "corpus_encode_auto_throughput"
    assert res["value"] > 0
    assert res.get("bulk_device_mbs", 0) > 0, \
        "single-plane device number must ride the recorded line"
    assert res.get("bulk_host_mbs", 0) > 0
    assert res["routing"], "routing decisions must be visible"
    # cold vs warm auto: the cold pass and the fresh-encoder-with-disk-
    # route-cache pass both ride the recorded line
    assert res.get("auto_cold_s", 0) > 0
    assert res.get("auto_cold_cached_s", 0) > 0
    assert res.get("route_cache_hits", -1) >= 0
    assert res["device"] == {"platform": "cpu", "kind": "cpu",
                             "count": 8}
    assert not any(k.startswith(("link", "tunnel")) for k in res)


@pytest.mark.parametrize("fn", ["bench_e2e", "bench_e2e_breakdown"])
def test_device_e2e_lines_name_the_device(bench, fn):
    positions, faces, gn, gathers = bench._setup(batch=4, n=10)
    res = getattr(bench, fn)(positions, faces, gn, gathers)
    assert res["device"]["platform"] == "cpu"
    if fn == "bench_e2e":
        assert res["value"] > 0 and res["baseline_measured"] > 0
    else:
        assert res["total_ms"] > 0 and res["mbps"] > 0


def test_bench_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                       capture_output=True, text=True, timeout=300,
                       env=env, cwd=ROOT)
    assert r.returncode != 0
    assert "measures the GPU" in r.stderr
    assert not r.stdout.strip(), "no result line without a GPU"
