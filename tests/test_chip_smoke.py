"""chip_smoke.py's phases at tiny sizes on the CPU backend, byte-checked
against the host encode()/decode() exactly as on the card, and its
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def bulk():
    meshes = cs.grid_batch(6, 10)
    return meshes, cs.host_blobs(meshes)


def test_phase_bulk_encode(bulk):
    meshes, ref = bulk
    res = cs.phase_bulk_encode(meshes, ref, reps=1)
    assert res["meshes"] == 6 and res["warm_s"] > 0
    assert [bytes(b) for b in res["blobs"]] == ref


def test_phase_words_scan(bulk):
    meshes, _ = bulk
    res = cs.phase_words_scan(meshes, reps=1)
    assert res["lanes"] == 6 and res["symbols"] == 300
    assert res["chunk_lanes"] == 6
    assert res["chunk_warm_s"] > 0 and res["all_lanes_warm_s"] > 0


def test_phase_grouped_decode(bulk):
    meshes, ref = bulk
    res = cs.phase_grouped_decode(ref, reps=1)
    assert res["host_refills"] == 0 and res["blobs"] == 6
    assert res["host_decode_s"] > 0
    assert res["device_entropy_host_normals_s"] > 0


def test_phase_resident_huge():
    res = cs.phase_resident_huge(n=24, reps=1)
    assert res["vertices"] == 576 and res["bytes"] == len(res["ref"])


def test_phase_auto_router():
    corpus = cs.mixed_corpus(cs.grid_batch(17, 8, textured=False),
                             small_n=6, huge_n=24)
    res = cs.phase_auto_router(corpus, cs.host_blobs(corpus), reps=1)
    assert res["meshes"] == 50 and res["fallbacks"] == [0, 0]
    assert res["routing"]


def test_phase_cli(tmp_path):
    res = cs.phase_cli(str(tmp_path / "cli"), n_files=5, n=6, reps=1)
    assert res["files"] == 5 and res["decode_warm_s"] > 0


def test_phase_four_cards(bulk):
    """The 4-card phase on 4 of the suite's virtual CPU devices: the
    data-parallel batch equals one device and the host, and the
    stream-sharded mesh equals encode()."""
    meshes, ref = bulk
    huge = cs.grid_mesh(20, seed=7)
    from tpudraco.encode import encode
    res = cs.phase_four_cards(meshes[:4], ref[:4], huge, encode(huge),
                              n_cards=4, reps=1)
    assert res["cards"] == 4
    assert len(res["peak_bytes_in_use_per_card"]) == 4


def test_card_checks_are_the_gpu_tests():
    """Phase 7 runs one check function for each gpu-marked test
    (check_X behind test_X)."""
    from tests import test_gpu_checks

    tests = {n for n in dir(test_gpu_checks) if n.startswith("test_")}
    assert {"test_" + c.__name__.removeprefix("check_")
            for c in cs.CARD_CHECKS} == tests


def test_main_refuses_cpu(tmp_path):
    """No GPU: non-zero exit and no result line, from the repo and from
    a directory holding chip_smoke.py alone."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()
