"""Batch driver tests: topology caching, determinism vs sequential encode,
corpus resume, error isolation, device-batched group encoding."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tpudraco.encode import encode
from tpudraco.models import AttributeDomain, AttributeType, MeshBuilder
from tpudraco.parallel import (
    BatchEncoder, PreparedTopology, encode_with_topology, topology_signature,
)

REF_DATA = "/root/reference/draco-oxide/tests/data"
needs_ref = pytest.mark.skipif(
    not os.path.isdir(REF_DATA), reason="reference fixtures not mounted")


def _grid_mesh(n, seed):
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.rand(n * n).astype(np.float32)], axis=1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + 1, a + n])
            faces.append([a + 1, a + n + 1, a + n])
    b = MeshBuilder()
    b.set_connectivity_attribute(np.asarray(faces))
    b.add_attribute(pos, AttributeType.POSITION, AttributeDomain.POSITION)
    return b.build()


def test_topology_cache_matches_sequential():
    """Batch output must be byte-identical to per-mesh encode()."""
    meshes = [_grid_mesh(10, s) for s in range(4)]
    be = BatchEncoder()
    batch = be.encode_meshes(meshes)
    for m, blob in zip(meshes, batch):
        assert blob == encode(m)
    assert len(be._topo_cache) == 1  # one shared topology


def test_signature_distinguishes_topologies():
    a = _grid_mesh(8, 0)
    b = _grid_mesh(9, 0)
    assert topology_signature(a) != topology_signature(b)
    assert topology_signature(a) == topology_signature(_grid_mesh(8, 5))


@needs_ref
def test_prepared_topology_on_fixture():
    from tpudraco.io import load_obj
    m = load_obj(os.path.join(REF_DATA, "tetrahedron.obj"))
    topo = PreparedTopology(m)
    assert encode_with_topology(m, topo) == encode(m)


@needs_ref
def test_corpus_driver_resume_and_errors(tmp_path):
    out = str(tmp_path / "corpus")
    inputs = [os.path.join(REF_DATA, n) for n in
              ("sphere.obj", "torus.obj", "cube_quads.obj")]
    bad = str(tmp_path / "broken.obj")
    open(bad, "w").write("v not a number\nf 1 2 x\n")
    be = BatchEncoder()
    report = be.encode_corpus(inputs + [bad], out)
    assert report["encoded"] == 3
    assert len(report["failed"]) == 1
    assert "broken" in report["failed"][0]["path"]
    # resume: all existing outputs skipped
    report2 = BatchEncoder().encode_corpus(inputs, out)
    assert report2["skipped"] == 3 and report2["encoded"] == 0
    # outputs decodable
    from tpudraco.decode import decode
    mesh = decode(open(os.path.join(out, "sphere.drc"), "rb").read())
    assert mesh.num_faces == 224


def test_device_group_matches_host_symbols():
    from tpudraco.parallel import device_encode_group
    meshes = [_grid_mesh(8, s) for s in range(3)]
    topo = PreparedTopology(meshes[0])
    pos_batch = np.stack([m.position_attribute().values.astype(np.float32)
                          for m in meshes])
    syms = device_encode_group(pos_batch, topo, meshes[0].position_attribute())
    assert syms.shape[0] == 3
    # per-mesh blobs must decode to the same geometry as sequential encode
    be = BatchEncoder()
    for m in meshes:
        assert be.encode_mesh(m) == encode(m)


def test_device_batch_encode_bit_exact(monkeypatch):
    """Full device chain (batched predict/residual + multi-lane rANS) must
    produce byte-identical .drc output to sequential host encode() — and
    must not silently pass via the host fallback."""
    meshes = [_grid_mesh(8, s) for s in range(4)] + [_grid_mesh(6, 9)]
    be = BatchEncoder()

    def no_fallback(self, mesh):
        raise AssertionError("device batch path fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes)
    for m, blob in zip(meshes, got):
        assert blob == encode(m)


def test_packed_upload_roundtrip_and_twin():
    """native.pack12 <-> ops.unpack12_kernel invert each other, and the
    numpy fallback twin produces identical packed bytes (incl. odd row
    lengths, where the final nibble pairs with zero)."""
    import tpudraco.native as nat
    from tpudraco.native import pack12
    from tpudraco.ops import unpack12_kernel
    rng = np.random.default_rng(3)
    for shape, bits in [((4, 100, 3), 11), ((3, 7, 3), 12),
                        ((2, 5, 1), 9), ((1, 3, 3), 11)]:
        q = rng.integers(0, 1 << bits, size=shape).astype(np.uint16)
        lo, hb = pack12(q)
        assert lo.nbytes + hb.nbytes < q.nbytes
        out = np.asarray(unpack12_kernel(jnp.asarray(lo), jnp.asarray(hb)))
        assert out.shape == q.shape and (out == q).all()
    # numpy twin == native bytes (odd per-row count: n = 33)
    q = rng.integers(0, 4096, size=(5, 33)).astype(np.uint16)
    lo1, hb1 = pack12(q)
    orig = nat.load_library
    nat.load_library = lambda: None
    try:
        lo2, hb2 = pack12(q)
    finally:
        nat.load_library = orig
    assert (lo1 == lo2).all() and (hb1 == hb2).all()


@pytest.mark.parametrize("bits,knob", [(11, True), (11, False),
                                       (8, True), (12, True)])
def test_packed_upload_byte_oracle(monkeypatch, bits, knob):
    """Device batch bytes with the narrow upload layouts (u8 at
    bits<=8, 12-bit pack at bits<=12) == the PACKED_UPLOAD=False u16
    twin == sequential host encode(), at every depth bucket and with no
    silent host fallback."""
    import tpudraco.parallel.batch as pb
    from tpudraco.encode import Config
    monkeypatch.setattr(pb, "PACKED_UPLOAD", knob)
    meshes = [_grid_mesh(5, s) for s in range(6)]
    cfg = Config(quant_bits={AttributeType.POSITION: bits})
    seq = [encode(m, cfg=cfg) for m in meshes]
    be = BatchEncoder(use_device=True, strict_device=True, cfg=cfg)
    be.MIN_DEVICE_GROUP = 1
    got = be.encode_meshes(meshes)
    assert [bytes(b) for b in got] == [bytes(s) for s in seq]


def test_packed_upload_sharded_byte_oracle(monkeypatch):
    """The packed upload shards on the data axis (lo AND the per-row
    nibble array) — sharded bytes must equal sequential encode()."""
    import jax
    from jax.sharding import Mesh as JMesh

    import tpudraco.parallel.batch as pb
    monkeypatch.setattr(pb, "PACKED_UPLOAD", True)
    devs = np.array(jax.devices()[:4])
    if devs.size < 4:
        pytest.skip("needs 4 devices")
    meshes = [_grid_mesh(5, s) for s in range(8)]
    be = BatchEncoder(use_device=True, strict_device=True,
                      mesh_axis=JMesh(devs, ("data",)))
    be.MIN_DEVICE_GROUP = 1
    got = be.encode_meshes(meshes)
    assert [bytes(b) for b in got] == [bytes(encode(m)) for m in meshes]


def test_sharded_normal_uv_chains_byte_oracle():
    """Under a ("data",) device mesh the NORMAL and TEX_COORD chains
    shard_map over the batch axis too (round-4 late; previously they ran
    unsharded) — sharded bytes must equal sequential encode(), with no
    host fallback (strict), and the chain entries must actually engage."""
    import jax
    from jax.sharding import Mesh as JMesh

    import tpudraco.parallel.batch as bm
    devs = np.array(jax.devices()[:4])
    if devs.size < 4:
        pytest.skip("needs 4 devices")
    meshes = [_grid_mesh_with_normals(7, s) for s in range(8)]
    mesh_ax = JMesh(devs, ("data",))
    be = BatchEncoder(use_device=True, strict_device=True,
                      mesh_axis=mesh_ax)
    be.MIN_DEVICE_GROUP = 1
    got = be.encode_meshes(meshes)
    assert [bytes(b) for b in got] == [bytes(encode(m)) for m in meshes]
    topo = be._topo_cache[topology_signature(meshes[0])]
    entries = bm._device_extra_attribute_entries(
        meshes, list(range(8)), topo, bits=11, chunk=8, mesh_axis=mesh_ax)
    assert 1 in entries[0] and 2 in entries[0]


def test_lone_huge_mesh_routes_device():
    """The auto-router's static rule sends a lone huge mesh to the
    resident device route (with no throughput estimates to overrule
    it), with bytes identical to host encode()."""
    mesh = _grid_mesh(40, 3)  # 1600 verts, "huge" under the lowered bar
    be = BatchEncoder(use_device="auto")
    be.CHUNKED_MIN_VERTS = 256
    got = be.encode_meshes_auto([mesh])
    assert bytes(got[0]) == bytes(encode(mesh))
    assert be.routing_log[-1]["plane"] == "device"
    assert be.routing_log[-1]["reason"] == "single mesh (static)"
    assert be.fallback_groups == 0


def test_batch_decoder_corpus(tmp_path):
    from tpudraco.parallel import BatchDecoder
    import os
    meshes = [_grid_mesh(6, s) for s in range(3)]
    enc_dir = os.path.join(tmp_path, "enc")
    os.makedirs(enc_dir)
    paths = []
    for i, m in enumerate(meshes):
        p = os.path.join(enc_dir, f"m{i}.drc")
        with open(p, "wb") as f:
            f.write(encode(m))
        paths.append(p)
    with open(os.path.join(enc_dir, "bad.drc"), "wb") as f:
        f.write(b"NOTDRACO")
    paths.append(os.path.join(enc_dir, "bad.drc"))

    out = os.path.join(tmp_path, "dec")
    bd = BatchDecoder()
    report = bd.decode_corpus(paths, out)
    assert report["decoded"] == 3 and len(report["failed"]) == 1
    # resume skips existing outputs
    report2 = bd.decode_corpus(paths, out)
    assert report2["skipped"] == 3
    from tpudraco.io import load_obj
    back = load_obj(os.path.join(out, "m0.obj"))
    assert back.num_faces == meshes[0].num_faces


def test_encode_with_topology_honors_prediction_config():
    """Regression (self-review r2): encode_with_topology must forward
    Config.prediction so topology-cached output equals sequential
    encode() for every Config knob."""
    from tpudraco.encode import Config
    from tpudraco.models import AttributeType
    from tpudraco.shared.prediction import PRED_MULTI_PARALLELOGRAM

    mesh = _grid_mesh(8, 0)
    topo = PreparedTopology(mesh)
    cfg = Config(prediction={
        AttributeType.POSITION: PRED_MULTI_PARALLELOGRAM})
    assert encode_with_topology(mesh, topo, cfg=cfg) == encode(mesh, cfg=cfg)
    assert encode_with_topology(mesh, topo, cfg=cfg) != encode(mesh)


def test_device_decode_failure_falls_back_per_blob(monkeypatch):
    """A device-stage failure in the entropy decode must not lose the
    batch: every blob falls back to the host path individually."""
    import tpudraco.parallel.decode_batch as db
    from tpudraco.decode import decode
    from tpudraco.parallel import BatchDecoder

    meshes = [_grid_mesh(7, s) for s in range(3)]
    blobs = [encode(m) for m in meshes]

    def boom(streams):
        raise RuntimeError("device decode broke")
    monkeypatch.setattr(db, "_device_decode_streams", boom)
    bd = BatchDecoder()
    out = bd.decode_blobs_shared_topology(blobs, entropy="device")
    for blob, got in zip(blobs, out):
        ref = decode(blob)
        assert np.array_equal(got.faces, ref.faces)
    # the refills are counted, so a broken device path cannot hide
    assert bd.host_refills == len(blobs)


def test_device_decode_counts_no_refills_when_healthy():
    """A working device entropy decode refills nothing from the host."""
    from tpudraco.decode import decode
    from tpudraco.parallel import BatchDecoder

    meshes = [_grid_mesh_with_normals(7, s) for s in range(4)]
    blobs = [encode(m) for m in meshes]
    bd = BatchDecoder()
    out = bd.decode_blobs_shared_topology(blobs, entropy="device",
                                          normals="device")
    assert bd.host_refills == 0
    for blob, got in zip(blobs, out):
        ref = decode(blob)
        assert np.array_equal(got.faces, ref.faces)
        for ga, ra in zip(got.attributes, ref.attributes):
            assert np.array_equal(ga.values_per_point(),
                                  ra.values_per_point())


def test_shared_topology_batch_decode_device_entropy():
    """Device-entropy batch decode (rANS lanes) must produce meshes
    identical to per-blob host decode() — including mixed topologies and
    garbage blobs in the batch, and multi-attribute streams."""
    from tpudraco.decode import decode
    from tpudraco.io import load_gltf
    from tpudraco.parallel import BatchDecoder

    meshes = [_grid_mesh(8, s) for s in range(4)]
    blobs = [encode(m) for m in meshes]
    blobs.append(encode(_grid_mesh(6, 9)))   # different topology
    blobs.append(b"garbage")                 # error isolation
    out = BatchDecoder().decode_blobs_shared_topology(blobs,
                                                      entropy="device")
    assert out[-1] is None
    for blob, got in zip(blobs[:-1], out[:-1]):
        ref = decode(blob)
        assert np.array_equal(got.faces, ref.faces)
        for a, b in zip(got.attributes, ref.attributes):
            assert np.array_equal(np.asarray(a.values), np.asarray(b.values))

    # multi-attribute (position+normal+uv) streams through the lane decoder
    duck_path = os.path.join(REF_DATA, "Duck", "Duck.glb")
    if os.path.isfile(duck_path):
        duck = load_gltf(duck_path)
        dblob = encode(duck)
        got = BatchDecoder().decode_blobs_shared_topology(
            [dblob, dblob], entropy="device")
        ref = decode(dblob)
        for g in got:
            assert np.array_equal(g.faces, ref.faces)
            for a, b in zip(g.attributes, ref.attributes):
                assert np.array_equal(np.asarray(a.values),
                                      np.asarray(b.values))


def test_multihost_helpers_single_process(tmp_path):
    import os
    from tpudraco.parallel import encode_corpus_multihost, shard_corpus

    assert shard_corpus(["a", "b", "c", "d"], 0, 2) == ["a", "c"]
    assert shard_corpus(["a", "b", "c", "d"], 1, 2) == ["b", "d"]

    from tpudraco.io.obj import save_obj
    corpus = os.path.join(tmp_path, "in")
    os.makedirs(corpus)
    inputs = []
    for i in range(3):
        p = os.path.join(corpus, f"g{i}.obj")
        save_obj(_grid_mesh(5, i), p)
        inputs.append(p)
    out = os.path.join(tmp_path, "out")
    report = encode_corpus_multihost(inputs, out)
    assert report["encoded"] == 3
    from tpudraco.decode import decode
    blob = open(os.path.join(out, "g0.drc"), "rb").read()
    assert decode(blob).num_faces == _grid_mesh(5, 0).num_faces


def test_multihost_two_process(tmp_path):
    """Real 2-process jax.distributed run (VERDICT r1 #7): two CPU
    processes on localhost shard the corpus, encode their slices, and
    aggregate the report via process_allgather over Gloo. Outputs must be
    byte-identical to a single-process run."""
    import socket
    import subprocess
    import sys

    from tpudraco.io.obj import save_obj

    corpus = os.path.join(tmp_path, "in")
    os.makedirs(corpus)
    inputs = []
    for i in range(3):
        p = os.path.join(corpus, f"g{i}.obj")
        save_obj(_grid_mesh(6, i), p)
        inputs.append(p)
    # a textured mesh (normals + UVs) rides the corpus too (VERDICT r4
    # #7: multihost evidence at the round-4 plane — the NORMAL/UV chains
    # and narrow uploads engage when the worker uses the device plane)
    p = os.path.join(corpus, "g3.obj")
    save_obj(_grid_mesh_with_normals(6, 3), p)
    inputs.append(p)
    out_dir = os.path.join(tmp_path, "out")

    with socket.socket() as s:  # free port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(tmp_path, "mh_worker.py")
    # each rank writes its summary to its own FILE: stdout is shared with
    # stderr and jax log lines can interleave mid-JSON (observed flake)
    with open(script, "w") as f:
        f.write(f"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from tpudraco.parallel import encode_corpus_multihost, init_distributed
from tpudraco.utils.compile_cache import enable_compile_cache
# share the suite's persistent compile cache: each worker would otherwise
# cold-compile the device plane
enable_compile_cache()
pid = int(sys.argv[1])
init_distributed("localhost:{port}", num_processes=2, process_id=pid)
inputs = {inputs!r}
rep = encode_corpus_multihost(inputs, {out_dir!r}, use_device=True)
with open({str(tmp_path)!r} + f"/worker{{pid}}.json", "w") as fh:
    json.dump({{"pid": pid, "encoded": rep["encoded"],
               "num_hosts": rep.get("num_hosts")}}, fh)
""")
    procs = [subprocess.Popen([sys.executable, script, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=480)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o

    import json as _json
    reports = []
    for i in range(2):
        with open(os.path.join(tmp_path, f"worker{i}.json")) as f:
            reports.append(_json.load(f))
    # merged totals identical on both hosts
    assert all(r["encoded"] == 4 for r in reports)
    assert all(r["num_hosts"] == 2 for r in reports)
    # rank-0 merged report on disk
    with open(os.path.join(out_dir, "corpus_report.json")) as f:
        merged = _json.load(f)
    assert merged["encoded"] == 4 and merged["num_hosts"] == 2
    # outputs byte-identical to a single-process run
    solo = os.path.join(tmp_path, "solo")
    BatchEncoder().encode_corpus(inputs, solo)
    for i in range(4):
        a = open(os.path.join(out_dir, f"g{i}.drc"), "rb").read()
        b = open(os.path.join(solo, f"g{i}.drc"), "rb").read()
        assert a == b


def test_corpus_workers_byte_identical(tmp_path):
    import os
    from tpudraco.io.obj import save_obj

    corpus = os.path.join(tmp_path, "in")
    os.makedirs(corpus)
    inputs = []
    for i in range(6):
        p = os.path.join(corpus, f"g{i}.obj")
        save_obj(_grid_mesh(7, i), p)
        inputs.append(p)
    r1 = BatchEncoder().encode_corpus(inputs, os.path.join(tmp_path, "o1"),
                                      workers=1)
    r4 = BatchEncoder().encode_corpus(inputs, os.path.join(tmp_path, "o4"),
                                      workers=4)
    assert r1["encoded"] == r4["encoded"] == 6
    for i in range(6):
        a = open(os.path.join(tmp_path, "o1", f"g{i}.drc"), "rb").read()
        b = open(os.path.join(tmp_path, "o4", f"g{i}.drc"), "rb").read()
        assert a == b


def test_shared_topology_batch_decode():
    """Shared-topology batch decode must equal per-blob decode()."""
    from tpudraco.decode import decode
    from tpudraco.parallel import BatchDecoder

    meshes = [_grid_mesh(8, s) for s in range(4)]
    blobs = [encode(m) for m in meshes]
    blobs.append(encode(_grid_mesh(6, 9)))   # different topology in the mix
    blobs.append(b"garbage")                 # error isolation
    out = BatchDecoder().decode_blobs_shared_topology(blobs)
    assert out[-1] is None
    for blob, got in zip(blobs[:-1], out[:-1]):
        ref = decode(blob)
        assert np.array_equal(got.faces, ref.faces)
        for a, b in zip(got.attributes, ref.attributes):
            assert np.array_equal(np.asarray(a.values), np.asarray(b.values))


def test_device_batch_encode_device_entropy(monkeypatch):
    """The device-resident entropy option must also be byte-exact."""
    meshes = [_grid_mesh(7, s) for s in range(3)]
    be = BatchEncoder()

    def no_fallback(self, mesh):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes, entropy="device")
    for m, blob in zip(meshes, got):
        assert blob == encode(m)


def test_encode_corpus_use_device(tmp_path):
    import os
    from tpudraco.io.obj import save_obj

    corpus = os.path.join(tmp_path, "in")
    os.makedirs(corpus)
    inputs = []
    for i in range(4):
        p = os.path.join(corpus, f"g{i}.obj")
        save_obj(_grid_mesh(7, i), p)
        inputs.append(p)
    rep = BatchEncoder(use_device=True).encode_corpus(
        inputs, os.path.join(tmp_path, "out"))
    assert rep["encoded"] == 4
    # byte-identical to the host driver
    rep2 = BatchEncoder().encode_corpus(inputs, os.path.join(tmp_path, "o2"))
    for i in range(4):
        a = open(os.path.join(tmp_path, "out", f"g{i}.drc"), "rb").read()
        b = open(os.path.join(tmp_path, "o2", f"g{i}.drc"), "rb").read()
        assert a == b


def test_device_batch_encode_custom_bits_device_entropy(monkeypatch):
    """Regression (ADVICE r1 high): at quant bits >= 13 the device histogram
    used to mis-bin large zigzag symbols into a fixed 4096-bin table, and
    entropy='device' built corrupt rANS tables from it with no error. The
    bins are now derived from the bit depth; output must be byte-exact."""
    from tpudraco.encode import Config
    from tpudraco.models import AttributeType

    meshes = [_grid_mesh(7, s) for s in range(3)]
    be = BatchEncoder(strict_device=True)  # any fallback -> raise

    def no_fallback(self, mesh):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes, bits=13, entropy="device")
    cfg = Config(quant_bits={AttributeType.POSITION: 13})
    for m, blob in zip(meshes, got):
        assert blob == encode(m, cfg=cfg)


def test_device_fallback_strict_and_counters(monkeypatch):
    """A broken device entropy path must (a) raise under strict_device and
    (b) be counted as a fallback otherwise — never silently pass."""
    import tpudraco.parallel.batch as batch_mod

    meshes = [_grid_mesh(6, s) for s in range(2)]

    def boom(*a, **k):
        raise RuntimeError("deliberately broken device kernel")
    monkeypatch.setattr(batch_mod, "device_encode_group", boom)

    with pytest.raises(RuntimeError, match="deliberately broken"):
        BatchEncoder(strict_device=True).encode_meshes_device(meshes)

    be = BatchEncoder()
    got = be.encode_meshes_device(meshes)
    assert be.fallback_groups == 1 and be.fallback_meshes == 2
    for m, blob in zip(meshes, got):
        assert blob == encode(m)  # fallback output stays correct


def test_corpus_resume_skips_device_batch(tmp_path, monkeypatch):
    """Resumed device-corpus runs must not re-run the device batch for
    files whose outputs already exist (ADVICE r1 low)."""
    import os

    import tpudraco.parallel.batch as batch_mod
    from tpudraco.io.obj import save_obj

    corpus = os.path.join(tmp_path, "in")
    os.makedirs(corpus)
    inputs = []
    for i in range(3):
        p = os.path.join(corpus, f"g{i}.obj")
        save_obj(_grid_mesh(6, i), p)
        inputs.append(p)
    out = os.path.join(tmp_path, "out")
    rep = BatchEncoder(use_device=True).encode_corpus(inputs, out)
    assert rep["encoded"] == 3 and rep["device_fallback_groups"] == 0

    def boom(*a, **k):
        raise AssertionError("device batch re-ran on resume")
    monkeypatch.setattr(batch_mod, "device_encode_group", boom)
    rep2 = BatchEncoder(use_device=True).encode_corpus(inputs, out)
    assert rep2["skipped"] == 3


def test_sharded_batch_byte_oracle(monkeypatch):
    """SURVEY §4d: the shard_map data-parallel device batch must produce
    .drc bytes identical to sequential encode() on an 8-device CPU mesh —
    byte equality, not shape checks (VERDICT r1 weak #1)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh from conftest")
    dp_mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    meshes = [_grid_mesh(8, s) for s in range(5)]
    be = BatchEncoder(strict_device=True, mesh_axis=dp_mesh)

    def no_fallback(self, mesh):
        raise AssertionError("sharded batch fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes)
    for m, blob in zip(meshes, got):
        assert blob == encode(m)

    # and with the device-resident entropy path on top
    got2 = be.encode_meshes_device(meshes, entropy="device")
    for m, blob in zip(meshes, got2):
        assert blob == encode(m)


def test_dryrun_multichip_oracle():
    """__graft_entry__.dryrun_multichip itself now asserts byte equality
    (sharded symbols/histograms vs single-device, dp-batch .drc bytes vs
    sequential); run it at 8 devices so a divergence fails the suite."""
    import jax

    import __graft_entry__ as g

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh from conftest")
    g.dryrun_multichip(8)


def test_chunked_huge_mesh_byte_oracle():
    """SURVEY §5.7 streaming path: a mesh encoded in fixed-size segments
    (device memory O(chunk)) must produce .drc bytes identical to host
    encode() — including a chunk size far smaller than the traversal, odd
    tails, and non-default bit depths."""
    from tpudraco.encode import Config
    from tpudraco.models import AttributeType

    mesh = _grid_mesh(20, 3)  # 400 vertices, 722 faces
    be = BatchEncoder()
    for chunk in (64, 257, 1 << 15):
        blob = be.encode_mesh_device_chunked(mesh, chunk=chunk)
        assert blob == encode(mesh), f"chunk={chunk}"
    blob13 = be.encode_mesh_device_chunked(mesh, bits=13, chunk=100)
    assert blob13 == encode(
        mesh, cfg=Config(quant_bits={AttributeType.POSITION: 13}))


def test_resident_single_mesh_byte_oracle():
    """The resident single-mesh device path (positions + gathers stay on
    device, one u16 symbol readback) must produce .drc bytes identical to
    host encode(), at default and non-default depths; the huge-mesh router
    must pick it (and fall back cleanly past the HBM budget)."""
    from tpudraco.encode import Config
    from tpudraco.models import AttributeType

    mesh = _grid_mesh(20, 3)
    be = BatchEncoder()
    assert be.encode_mesh_device(mesh) == encode(mesh)
    assert be.encode_mesh_device(mesh, bits=13) == encode(
        mesh, cfg=Config(quant_bits={AttributeType.POSITION: 13}))
    # the huge-mesh route resolves to the same bytes both sides of the
    # resident budget (beyond it: the chunked streaming twin)
    assert be._encode_huge_safe(mesh) == encode(mesh)
    old = BatchEncoder.RESIDENT_MAX_VERTS
    try:
        BatchEncoder.RESIDENT_MAX_VERTS = 1
        assert be._encode_huge_safe(mesh) == encode(mesh)
    finally:
        BatchEncoder.RESIDENT_MAX_VERTS = old


def test_resident_route_covers_normals_and_uvs():
    """VERDICT r3 weak #4: the resident single-mesh route must keep the
    NORMAL and TEX_COORD chains on device too (same batch chains, B=1) —
    byte-equal to host encode(), with the device entries actually present
    (not silently host-fallen-back)."""
    from tpudraco.parallel import batch as batch_mod

    mesh = _grid_mesh_with_normals(16, 5)
    be = BatchEncoder()
    topo = be._topo_for(mesh)
    extra = batch_mod._device_extra_attribute_entries(
        [mesh], [0], topo, bits=11, chunk=1)
    ni = next(i for i, a in enumerate(mesh.attributes)
              if a.att_type == AttributeType.NORMAL)
    ui = next(i for i, a in enumerate(mesh.attributes)
              if a.att_type == AttributeType.TEX_COORD)
    assert ni in extra.get(0, {}) and ui in extra.get(0, {}), \
        "device normal/UV chains did not engage for the resident mesh"
    assert be.encode_mesh_device(mesh) == encode(mesh)


def test_stream_sharded_single_mesh_byte_oracle():
    """Single-mesh cross-chip API: the traversal shards over an 8-device
    ("stream",) mesh; output bytes equal host encode()."""
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh from conftest")
    sp_mesh = Mesh(np.asarray(jax.devices()[:8]), ("stream",))
    be = BatchEncoder()
    for n in (9, 12):
        mesh = _grid_mesh(n, n)
        blob = be.encode_mesh_device_stream_sharded(mesh, sp_mesh)
        assert blob == encode(mesh)


def _grid_mesh_with_normals(n, seed):
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.rand(n * n).astype(np.float32)], axis=1)
    nrm = rng.randn(n * n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = (pos[:, :2] / n).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + 1, a + n])
            faces.append([a + 1, a + n + 1, a + n])
    b = MeshBuilder()
    b.set_connectivity_attribute(np.asarray(faces))
    pid = b.add_attribute(pos, AttributeType.POSITION,
                          AttributeDomain.POSITION)
    b.add_attribute(nrm, AttributeType.NORMAL, AttributeDomain.CORNER,
                    parents=[pid])
    b.add_attribute(uv, AttributeType.TEX_COORD, AttributeDomain.CORNER,
                    parents=[pid])
    return b.build()


def test_device_batch_encode_normals_bit_exact(monkeypatch):
    """The device normal chain (ring-sum prediction + octahedral quantize
    + OctOrthogonal residuals, ops/normals.py) must produce .drc bytes
    identical to sequential host encode() for pos+normal+uv meshes."""
    from tpudraco.decode import decode

    meshes = [_grid_mesh_with_normals(7, s) for s in range(3)]
    be = BatchEncoder(strict_device=True)

    def no_fallback(self, mesh):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes)
    for m, blob in zip(meshes, got):
        assert blob == encode(m)
        assert decode(blob).num_faces == m.num_faces

    # and the device paths really ran (entries produced, not fallbacks)
    import tpudraco.parallel.batch as bm
    topo = be._topo_cache[topology_signature(meshes[0])]
    entries = bm._device_extra_attribute_entries(meshes, [0, 1, 2], topo,
                                                 bits=11, chunk=4)
    assert entries
    assert 1 in entries[0]  # normal attribute index 1
    assert 2 in entries[0]  # texcoord attribute index 2


def test_device_batch_nonfinite_uvs_route_to_host_error():
    """A mesh whose UVs hold NaN must FAIL through the device batch the
    same way sequential encode() fails (portabilize's canonical
    non-finite rejection), and must not poison the group: the old device
    UV quantize silently encoded garbage from NaN; now the finiteness
    precheck drops the UV chain so the host path raises per mesh."""
    meshes = [_grid_mesh_with_normals(7, s) for s in range(3)]
    bad = _grid_mesh_with_normals(7, 9)
    bad.attributes[2].values[3, 0] = np.nan
    meshes.append(bad)
    with pytest.raises(ValueError, match="non-finite"):
        encode(bad)
    be = BatchEncoder(use_device=True)
    be.MIN_DEVICE_GROUP = 1
    got = be.encode_meshes(meshes)
    assert got[3] is None  # canonical failure, isolated
    for m, blob in zip(meshes[:3], got[:3]):
        assert bytes(blob) == bytes(encode(m))


def test_device_batch_quant_depth_overrides_bit_exact(monkeypatch):
    """Every device chain honors -qp/-qn/-qt depths: batch bytes with
    (bits=12, normal_bits=10, uv_bits=12) must equal sequential host
    encode() under the same Config — positions, the ring-sum normal
    chain at a non-default octahedral depth, and the UV chain all
    included (no host fallback allowed)."""
    from tpudraco.decode import decode
    from tpudraco.encode import Config

    meshes = [_grid_mesh_with_normals(7, s) for s in range(3)]
    cfg = Config(quant_bits={AttributeType.POSITION: 12,
                             AttributeType.NORMAL: 10,
                             AttributeType.TEX_COORD: 12})
    be = BatchEncoder(strict_device=True)

    def no_fallback(self, mesh, cfg=None):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes, bits=12, normal_bits=10,
                                  uv_bits=12)
    for m, blob in zip(meshes, got):
        assert blob == encode(m, cfg=cfg)
        assert decode(blob).num_faces == m.num_faces

    # the device normal/UV entries really computed at those depths
    import tpudraco.parallel.batch as bm
    topo = be._topo_cache[topology_signature(meshes[0])]
    entries = bm._device_extra_attribute_entries(
        meshes, [0, 1, 2], topo, bits=12, chunk=4, normal_bits=10,
        uv_bits=12)
    assert 1 in entries[0] and 2 in entries[0]
    # out-of-range normal depth routes normals to host (entry absent)
    entries6 = bm._device_extra_attribute_entries(
        meshes, [0, 1, 2], topo, bits=12, chunk=4, normal_bits=6)
    assert 1 not in entries6.get(0, {})
    # ...and the public API raises up front instead of returning silent
    # Nones through the per-group fallback (round-3 review)
    with pytest.raises(ValueError, match="7..16"):
        BatchEncoder().encode_meshes_device(meshes, normal_bits=5)
    # an out-of-range quant-only cfg is "beyond the device space": the
    # corpus drivers route it to the host plane where the canonical
    # error surfaces per file
    assert bm._device_quant_bits(
        Config(quant_bits={AttributeType.NORMAL: 5})) is None


def test_device_batch_generic_quant_passthrough(monkeypatch):
    """A cfg quantizing a NON-device attribute type (-qg's COLOR) rides
    the device batch: colors are host-encoded during assembly at the cfg
    depth, device-computed positions at theirs — bytes equal host
    encode(cfg)."""
    from tpudraco.encode import Config

    rng = np.random.RandomState(5)
    meshes = []
    for s in range(2):
        m0 = _grid_mesh_with_normals(6, s)
        b = MeshBuilder()
        b.set_connectivity_attribute(m0.faces)
        pid = b.add_attribute(m0.attributes[0].values,
                              AttributeType.POSITION,
                              AttributeDomain.POSITION)
        b.add_attribute(rng.rand(m0.attributes[0].values.shape[0], 3)
                        .astype(np.float32), AttributeType.COLOR,
                        AttributeDomain.POSITION)
        meshes.append(b.build())
    cfg = Config(quant_bits={AttributeType.POSITION: 12,
                             AttributeType.COLOR: 9})
    be = BatchEncoder(strict_device=True, cfg=cfg)

    def no_fallback(self, mesh, cfg=None):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes)
    for m, blob in zip(meshes, got):
        assert blob == encode(m, cfg=cfg)


@needs_ref
def test_device_batch_encode_fixtures_bit_exact(monkeypatch):
    """Device batch over the reference OBJ fixtures — boundaries
    (punctured sphere), handles (torus), seams + normals + UVs
    (tetrahedron) — must stay byte-identical to host encode()."""
    from tpudraco.io import load_obj

    names = ["tetrahedron.obj", "sphere.obj", "torus.obj",
             "punctured_sphere.obj"]
    meshes = [load_obj(os.path.join(REF_DATA, n)) for n in names]
    be = BatchEncoder(strict_device=True)

    def no_fallback(self, mesh):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes)
    for name, m, blob in zip(names, meshes, got):
        assert blob == encode(m), name


def test_device_batch_normal_guards(monkeypatch):
    """Self-review r2 regressions: (a) an integer-normal sibling in a
    group whose signature matches a float-normal mesh must not be cast
    through the wrong octahedral branch; (b) a degenerate (zero) normal
    routes its mesh to the host path (device exact-div masks 0/0 where
    the host NaN-propagates). Bytes must equal encode() either way."""
    meshes = [_grid_mesh_with_normals(6, s) for s in range(3)]
    # (b) degenerate normal in mesh 1
    meshes[1].attributes[1].values[3] = 0.0
    be = BatchEncoder(strict_device=True)

    def no_fallback(self, mesh):
        raise AssertionError("fell back to full host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes)
    for m, blob in zip(meshes, got):
        assert blob == encode(m)

    # (a) int-normal sibling: same faces + dedup maps, integer dtype
    int_meshes = [_grid_mesh_with_normals(5, 7)]
    vals = int_meshes[0].attributes[1].values
    int_meshes[0].attributes[1].values = (
        np.clip(vals * 100, -127, 127).astype(np.int32))
    got2 = BatchEncoder(strict_device=True).encode_meshes_device(int_meshes)
    assert got2[0] == encode(int_meshes[0])


def test_device_batch_encode_custom_bits(monkeypatch):
    """Device batch at a non-default quantization depth must match the
    sequential encoder at the same depth (metadata/payload consistency)."""
    from tpudraco.encode import Config
    from tpudraco.models import AttributeType

    meshes = [_grid_mesh(7, s) for s in range(3)]
    be = BatchEncoder()

    def no_fallback(self, mesh):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes, bits=13)
    cfg = Config(quant_bits={AttributeType.POSITION: 13})
    for m, blob in zip(meshes, got):
        assert blob == encode(m, cfg=cfg)


@needs_ref
def test_transcode_corpus_device_matches_per_file(tmp_path):
    """Device-batched corpus transcode must produce GLBs byte-identical
    to per-file DracoTranscoder runs, with resume + error isolation."""
    import shutil

    from tpudraco.io import DracoTranscoder
    from tpudraco.parallel import transcode_corpus

    duck = os.path.join(REF_DATA, "Duck", "Duck.glb")
    inputs = []
    for i in range(3):
        p = str(tmp_path / f"duck{i}.glb")
        shutil.copy(duck, p)
        inputs.append(p)
    bad = str(tmp_path / "broken.glb")
    with open(bad, "wb") as f:
        f.write(b"not a glb at all")
    inputs.append(bad)

    out = str(tmp_path / "out")
    rep = transcode_corpus(inputs, out, use_device=True)
    assert rep["transcoded"] == 3
    assert len(rep["failed"]) == 1 and "broken" in rep["failed"][0]["path"]

    ref_out = str(tmp_path / "ref.glb")
    DracoTranscoder().transcode_file(inputs[0], ref_out)
    want = open(ref_out, "rb").read()
    for i in range(3):
        got = open(os.path.join(out, f"duck{i}.glb"), "rb").read()
        assert got == want

    # resume skips everything
    rep2 = transcode_corpus(inputs, out, use_device=True)
    assert rep2["skipped"] == 3 and rep2["transcoded"] == 0


@needs_ref
def test_transcode_corpus_quant_cfg_stays_on_device(tmp_path):
    """A quantization-only Config (-qp/-qn/-qt) keeps the device batch
    (the chains honor the depths); bytes must equal the per-file host
    transcoder under the same cfg. A cfg beyond the device config space
    (-cl preset changing symbol coding etc.) falls back to host and
    STILL matches."""
    import shutil

    from tpudraco.encode import Config
    from tpudraco.io import DracoTranscoder
    from tpudraco.parallel import transcode_corpus
    from tpudraco.parallel.batch import _device_quant_bits

    cfg = Config(quant_bits={AttributeType.POSITION: 12,
                             AttributeType.TEX_COORD: 11})
    assert _device_quant_bits(cfg) == {"bits": 12, "normal_bits": 8,
                                       "uv_bits": 11}
    assert _device_quant_bits(Config(symbol_coding="length")) is None
    assert _device_quant_bits(None) == {"bits": 11, "normal_bits": 8,
                                        "uv_bits": 10}

    duck = os.path.join(REF_DATA, "Duck", "Duck.glb")
    inputs = []
    for i in range(2):
        p = str(tmp_path / f"duck{i}.glb")
        shutil.copy(duck, p)
        inputs.append(p)
    out = str(tmp_path / "out")
    rep = transcode_corpus(inputs, out, use_device=True,
                           cfg=Config(quant_bits=dict(cfg.quant_bits)))
    assert rep["transcoded"] == 2
    assert rep.get("device_fallback_groups") == 0
    assert rep.get("encoder_hook_misses") == 0

    ref_out = str(tmp_path / "ref.glb")
    DracoTranscoder(cfg=cfg).transcode_file(inputs[0], ref_out)
    want = open(ref_out, "rb").read()
    for i in range(2):
        got = open(os.path.join(out, f"duck{i}.glb"), "rb").read()
        assert got == want


def test_device_batch_random_topology_fuzz(monkeypatch):
    """Randomized meshes (Delaunay triangulations with punched holes,
    random normals/UVs) through the full device batch — bytes must equal
    host encode() for every seed. Catches corner cases the grid fixtures
    miss (irregular valences, boundary rings, fallback-heavy
    traversals)."""
    from scipy.spatial import Delaunay

    def random_mesh(seed):
        rng = np.random.RandomState(seed)
        pts = rng.rand(60, 2).astype(np.float32) * 4
        tri = Delaunay(pts)
        faces = tri.simplices.astype(np.int64)
        keep = rng.rand(len(faces)) > 0.15   # punch holes
        faces = faces[keep]
        z = rng.rand(len(pts)).astype(np.float32)
        pos = np.concatenate([pts, z[:, None]], axis=1)
        nrm = rng.randn(len(pts), 3).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        uv = (pts / 4).astype(np.float32)
        b = MeshBuilder()
        b.set_connectivity_attribute(faces)
        pid = b.add_attribute(pos, AttributeType.POSITION,
                              AttributeDomain.POSITION)
        b.add_attribute(nrm, AttributeType.NORMAL, AttributeDomain.CORNER,
                        parents=[pid])
        b.add_attribute(uv, AttributeType.TEX_COORD,
                        AttributeDomain.CORNER, parents=[pid])
        return b.build()

    meshes = [random_mesh(s) for s in range(6)]
    be = BatchEncoder(strict_device=True)

    def no_fallback(self, mesh):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    got = be.encode_meshes_device(meshes)
    for s, (m, blob) in enumerate(zip(meshes, got)):
        assert blob == encode(m), f"seed {s}"

    # same irregular meshes at randomized depth combos (the depth args
    # reach every chain: positions, ring normals, UVs)
    from tpudraco.encode import Config
    rng = np.random.RandomState(11)
    for trial in range(2):  # each combo compiles fresh chain shapes
        qp = int(rng.randint(8, 15))
        qn = int(rng.randint(7, 17))
        qt = int(rng.randint(8, 15))
        cfg = Config(quant_bits={AttributeType.POSITION: qp,
                                 AttributeType.NORMAL: qn,
                                 AttributeType.TEX_COORD: qt})
        got = be.encode_meshes_device(meshes, bits=qp, normal_bits=qn,
                                      uv_bits=qt)
        for s, (m, blob) in enumerate(zip(meshes, got)):
            assert blob == encode(m, cfg=cfg), \
                f"depths ({qp},{qn},{qt}) seed {s}"


def test_decode_corpus_use_device(tmp_path):
    """decode_corpus(use_device=True) groups by connectivity prefix and
    lane-decodes; outputs identical to the host driver."""
    meshes = [_grid_mesh(7, s) for s in range(4)] + [_grid_mesh(5, 9)]
    enc = os.path.join(tmp_path, "enc")
    os.makedirs(enc)
    paths = []
    for i, m in enumerate(meshes):
        p2 = os.path.join(enc, f"m{i}.drc")
        with open(p2, "wb") as f:
            f.write(encode(m))
        paths.append(p2)
    with open(os.path.join(enc, "bad.drc"), "wb") as f:
        f.write(b"NOTDRACO")
    paths.append(os.path.join(enc, "bad.drc"))

    from tpudraco.parallel import BatchDecoder
    dev_out = os.path.join(tmp_path, "dev")
    rep = BatchDecoder().decode_corpus(paths, dev_out, use_device=True,
                                       fmt="ply")
    assert rep["decoded"] == 5 and len(rep["failed"]) == 1
    host_out = os.path.join(tmp_path, "host")
    BatchDecoder().decode_corpus(paths, host_out, fmt="ply")
    for i in range(5):
        a = open(os.path.join(dev_out, f"m{i}.ply"), "rb").read()
        b = open(os.path.join(host_out, f"m{i}.ply"), "rb").read()
        assert a == b, i


def test_encode_corpus_device_windowed(tmp_path):
    """Bounded-memory device corpus: with device_window=W the driver holds
    at most W meshes at once (O(W) host RAM), and the output bytes are
    identical to the all-at-once device path AND the host path. Mixed
    topologies across window boundaries still group correctly within each
    window."""
    from tpudraco.io.obj import save_obj

    corpus = os.path.join(tmp_path, "in")
    os.makedirs(corpus)
    inputs = []
    for i in range(10):
        # two topologies interleaved so windows see mixed groups
        p = os.path.join(corpus, f"m{i}.obj")
        save_obj(_grid_mesh(6 if i % 2 else 7, i), p)
        inputs.append(p)

    batch_sizes = []
    orig = BatchEncoder.encode_meshes_device

    def spy(self, meshes, **kw):
        batch_sizes.append(len(meshes))
        return orig(self, meshes, **kw)

    import unittest.mock as mock
    with mock.patch.object(BatchEncoder, "encode_meshes_device", spy):
        rep = BatchEncoder(use_device=True).encode_corpus(
            inputs, os.path.join(tmp_path, "ow"), device_window=3)
    assert rep["encoded"] == 10
    assert batch_sizes == [3, 3, 3, 1]  # O(window) residency

    rep_all = BatchEncoder(use_device=True).encode_corpus(
        inputs, os.path.join(tmp_path, "oa"), device_window=100)
    rep_host = BatchEncoder().encode_corpus(
        inputs, os.path.join(tmp_path, "oh"))
    assert rep_all["encoded"] == rep_host["encoded"] == 10
    for i in range(10):
        w = open(os.path.join(tmp_path, "ow", f"m{i}.drc"), "rb").read()
        a = open(os.path.join(tmp_path, "oa", f"m{i}.drc"), "rb").read()
        h = open(os.path.join(tmp_path, "oh", f"m{i}.drc"), "rb").read()
        assert w == a == h, i


def test_encode_meshes_auto_routing(tmp_path):
    """use_device='auto' routes per topology group by in-process probing;
    whatever it picks, the bytes equal sequential encode() (both planes
    share the determinism oracle) and decisions land in routing_log /
    the corpus report."""
    # 20 meshes of one topology (big enough to probe the device chunk),
    # 3 of another (small -> host, no probe)
    meshes = [_grid_mesh(7, s) for s in range(20)] + \
             [_grid_mesh(5, s) for s in range(3)]
    be = BatchEncoder(use_device="auto")
    blobs = be.encode_meshes_auto(meshes)
    for m, blob in zip(meshes, blobs):
        assert blob == encode(m)
    planes = {e["group"]: e for e in be.routing_log}
    assert len(be.routing_log) == 2
    small = next(e for e in be.routing_log if e["meshes"] == 3)
    assert small["plane"] == "host" and small["reason"] == "small group"
    big = next(e for e in be.routing_log if e["meshes"] == 20)
    assert big["plane"] in ("host", "device")
    assert "host_s_per_mesh" in big
    # a probed group also records the device rate; a group cheaper than
    # the probe's fixed overhead records the skip reason instead
    assert "device_s_per_mesh" in big or big.get("reason")

    # corpus driver surface: report carries the routing log
    import os as _os

    from tpudraco.io.obj import save_obj
    corpus = _os.path.join(tmp_path, "in")
    _os.makedirs(corpus)
    inputs = []
    for i in range(18):
        p = _os.path.join(corpus, f"r{i}.obj")
        save_obj(_grid_mesh(7, i), p)
        inputs.append(p)
    rep = BatchEncoder(use_device="auto").encode_corpus(
        inputs, _os.path.join(tmp_path, "out"))
    assert rep["encoded"] == 18
    assert rep["routing"] and rep["routing"][0]["meshes"] == 18
    rep_host = BatchEncoder().encode_corpus(
        inputs, _os.path.join(tmp_path, "oh"))
    for i in range(18):
        a = open(_os.path.join(tmp_path, "out", f"r{i}.drc"), "rb").read()
        b = open(_os.path.join(tmp_path, "oh", f"r{i}.drc"), "rb").read()
        assert a == b


@pytest.mark.parametrize("compact", ["sort", "marks"])
def test_device_entropy_sharded_byte_oracle(compact):
    """The lane-sharded word scan (entropy stage over a 'data' mesh) must
    produce bytes identical to sequential encode() — the full pipeline
    (step AND entropy) sharded (SURVEY §4d oracle) — under both word
    compaction strategies (the marks concat runs per shard)."""
    import jax
    from jax.sharding import Mesh

    from tpudraco.ops import rans_lanes

    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    meshes = [_grid_mesh(9, s) for s in range(8)]
    rans_lanes.set_words_compact(compact)
    try:
        be = BatchEncoder(strict_device=True, mesh_axis=mesh)
        blobs = be.encode_meshes_device(meshes, entropy="device")
    finally:
        rans_lanes.set_words_compact(None)
    for m, blob in zip(meshes, blobs):
        assert blob == encode(m)


def test_device_batch_deep_depths_bit_exact(monkeypatch):
    """Regression (round-3 soak): at -qn >= 15 the device flip selection
    squared d2 = -pred - orig in int32 (overflows, spurious flips), and
    XLA:CPU fuses mul+add into FMAs through optimization_barrier (1-ulp
    oct/quantize drift at fine depths) — both corrupted device-batch
    streams vs host encode(). Deep depths must be byte-exact with no
    host fallback."""
    from tpudraco.encode import Config

    meshes = [_grid_mesh_with_normals(7, s) for s in range(2)]

    def no_fallback(self, mesh, cfg=None):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(BatchEncoder, "encode_mesh", no_fallback)
    for qp, qn, qt in ((11, 15, 10), (11, 16, 10), (9, 13, 12),
                      (16, 16, 16)):
        cfg = Config(quant_bits={AttributeType.POSITION: qp,
                                 AttributeType.NORMAL: qn,
                                 AttributeType.TEX_COORD: qt})
        got = BatchEncoder(strict_device=True).encode_meshes_device(
            meshes, bits=qp, normal_bits=qn, uv_bits=qt)
        for m, blob in zip(meshes, got):
            assert blob == encode(m, cfg=cfg), (qp, qn, qt)


def test_device_batch_rejects_non_finite_positions():
    """The round-4 batch pipeline replaces portabilize with the
    vectorized host quantize — it must carry the non-finite rejection
    (portabilization._require_finite) or NaN inputs would quantize into
    silent garbage. Per-mesh error isolation still encodes the clean
    siblings."""
    from tpudraco.parallel.batch import quantize_positions_host

    batch = np.random.RandomState(0).rand(3, 64, 3).astype(np.float32)
    batch[1, 5, 2] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        quantize_positions_host(batch, 11)

    meshes = [_grid_mesh(8, 0), _grid_mesh(8, 1)]
    meshes[1].position_attribute().values[3, 1] = np.inf
    out = BatchEncoder().encode_meshes_device(meshes)
    assert out[0] == encode(meshes[0])
    assert out[1] is None  # isolated, not silently wrong
    with pytest.raises(Exception):
        BatchEncoder(strict_device=True).encode_meshes_device(
            [meshes[1]])


def test_native_quantize_matches_numpy_twin():
    """The C++ fused quantizer (native/csrc/quantize.cpp) must be
    bit-exact with quantize_positions_host across scales, depths, widths,
    and the degenerate delta==0 branch — it feeds the wire directly
    (uint16 upload buffer + portabilization metadata)."""
    from tpudraco.native import quantize_batch
    from tpudraco.parallel.batch import quantize_positions_host

    if quantize_batch(np.zeros((1, 1, 3), np.float32), 11) is None:
        pytest.skip("native library unavailable")
    rng = np.random.RandomState(7)
    shapes = [(16, 257, 3), (3, 17, 2), (5, 64, 4), (2, 9, 3), (1, 1, 3)]
    for t, (B, V, C) in enumerate(shapes):
        vals = (rng.randn(B, V, C)
                * np.float32(10.0 ** rng.randint(-3, 6))).astype(np.float32)
        if t == 1:
            vals[1] = 7.25  # degenerate mesh: delta_max == 0
        if t == 3:
            vals[:] = 0.0
        for bits in (7, 11, 14, 16):
            got = quantize_batch(vals, bits)
            q, mins, delta, vmin, vmax = got
            q2, mins2, delta2 = quantize_positions_host(vals, bits)
            assert np.array_equal(q.astype(np.int32), q2), (t, bits)
            assert np.array_equal(mins, mins2)
            assert np.array_equal(delta, delta2)
            assert np.array_equal(vmin, q2.min(axis=(1, 2)))
            assert np.array_equal(vmax, q2.max(axis=(1, 2)))

    # non-finite input -> None (the caller re-runs the numpy twin, which
    # raises the canonical error; pipeline behavior pinned by
    # test_device_batch_rejects_non_finite_positions)
    bad = rng.randn(2, 8, 3).astype(np.float32)
    bad[1, 3, 1] = np.nan
    assert quantize_batch(bad, 11) is None


def test_uint16_port_values_feed_host_predicted_child(monkeypatch):
    """The batch plane returns its uint16 upload buffer as the position
    port values (no int32 copy). When a child attribute is NOT
    precomputed (ineligible for the device chains) its host prediction
    reads those parent values — the lazy widen in encode_attributes must
    kick in or the parallelogram arithmetic would wrap in uint16."""
    from tpudraco.parallel import batch as batch_mod

    meshes = [_grid_mesh_with_normals(7, s) for s in range(3)]
    # force the normals onto the host path while positions stay device
    monkeypatch.setattr(batch_mod, "_device_extra_attribute_entries",
                        lambda *a, **k: {})
    out = BatchEncoder(strict_device=True).encode_meshes_device(meshes)
    for m, blob in zip(meshes, out):
        assert blob == encode(m)


def test_auto_routing_decision_cache():
    """A probed routing decision is reused for later calls over the same
    topology group (corpus windows re-encounter their groups every
    window; re-probing pays the fixed device dispatch each time). Reuse
    is direction-safe: device decisions generalize up in group size,
    host decisions down. Bytes stay pinned either way."""
    meshes = [_grid_mesh(7, s) for s in range(20)]
    be = BatchEncoder(use_device="auto")
    be.encode_meshes_auto(meshes)
    first = be.routing_log[-1]
    assert not str(first.get("reason", "")).startswith("cached decision")

    blobs = be.encode_meshes_auto(meshes)
    second = be.routing_log[-1]
    if first.get("reason") == "group cheaper than probe":
        # nothing was cached; the skip rule re-fires instead
        assert second["reason"] == "group cheaper than probe"
    else:
        assert second["reason"] == "cached decision (memory)"
        assert second["plane"] == first["plane"]
    for m, blob in zip(meshes, blobs):
        assert blob == encode(m)


def test_route_cache_persists_across_encoders(tmp_path, monkeypatch):
    """VERDICT r4 #5: routing decisions persist on disk so a fresh process
    (modeled by a fresh BatchEncoder with the same cache path) routes
    without paying the probe. Bytes stay pinned."""
    cache = str(tmp_path / "route_cache.json")
    meshes = [_grid_mesh(7, s) for s in range(20)]

    a = BatchEncoder(use_device="auto", route_cache_path=cache)
    a.PROBE_SKIP_S = 0.0  # deterministic: always probe, always persist
    a.encode_meshes_auto(meshes)
    first = a.routing_log[-1]
    assert os.path.isfile(cache)

    b = BatchEncoder(use_device="auto", route_cache_path=cache)
    blobs = b.encode_meshes_auto(meshes)
    second = b.routing_log[-1]
    assert second["reason"] == "cached decision (disk)"
    assert second["plane"] == first["plane"]
    for m, blob in zip(meshes, blobs):
        assert blob == encode(m)

    # expired entries are ignored (TTL'd: host speed drifts)
    import json as _json
    data = _json.load(open(cache))
    for e in data["entries"].values():
        e["ts"] -= 7 * 3600.0
    _json.dump(data, open(cache, "w"))
    c = BatchEncoder(use_device="auto", route_cache_path=cache)
    c.encode_meshes_auto(meshes)
    assert c.routing_log[-1]["reason"] != "cached decision (disk)"


def test_route_cache_disabled_and_corrupt(tmp_path):
    """A disabled or corrupt cache must never break routing."""
    meshes = [_grid_mesh(7, s) for s in range(20)]
    be = BatchEncoder(use_device="auto", route_cache_path=None)
    blobs = be.encode_meshes_auto(meshes)
    assert all(b == encode(m) for m, b in zip(meshes, blobs))

    bad = tmp_path / "corrupt.json"
    bad.write_text("{not json")
    be2 = BatchEncoder(use_device="auto", route_cache_path=str(bad))
    blobs2 = be2.encode_meshes_auto(meshes)
    assert all(b == encode(m) for m, b in zip(meshes, blobs2))


def test_route_cache_cross_process(tmp_path):
    """Two genuinely fresh processes: the second routes from the disk
    cache without probing (the one-shot CLI scenario)."""
    import json
    import subprocess
    import sys

    cache = str(tmp_path / "route_cache.json")
    script = tmp_path / "drive.py"
    script.write_text("""
import os, sys, json
sys.path.insert(0, %r)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from tpudraco.models import MeshBuilder, AttributeType
from tpudraco.models.attribute import AttributeDomain
from tpudraco.parallel.batch import BatchEncoder

def grid(n, seed):
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.rand(n * n).astype(np.float32)], axis=1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + 1, a + n])
            faces.append([a + 1, a + n + 1, a + n])
    b = MeshBuilder()
    b.set_connectivity_attribute(np.asarray(faces))
    b.add_attribute(pos, AttributeType.POSITION, AttributeDomain.POSITION)
    return b.build()

be = BatchEncoder(use_device="auto")
be.encode_meshes_auto([grid(7, s) for s in range(20)])
print(json.dumps(be.routing_log[-1]))
""" % os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, TPUDRACO_ROUTE_CACHE=cache,
               JAX_PLATFORMS="cpu")
    r1 = subprocess.run([sys.executable, str(script)], env=env,
                        capture_output=True, text=True, timeout=300)
    assert r1.returncode == 0, r1.stderr[-2000:]
    first = json.loads(r1.stdout.strip().splitlines()[-1])
    if first.get("reason") == "group cheaper than probe":
        pytest.skip("host under probe threshold; nothing persisted")
    r2 = subprocess.run([sys.executable, str(script)], env=env,
                        capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    second = json.loads(r2.stdout.strip().splitlines()[-1])
    assert second["reason"] == "cached decision (disk)", second
    assert second["plane"] == first["plane"]


def test_lone_huge_mesh_measured_estimates():
    """The static huge->device rule defers to measured throughput
    estimates when both planes have data. Estimates come from in-process
    observations or the disk route cache; the decision is recorded with
    both numbers."""
    mesh = _grid_mesh(40, 3)  # 1600 verts, "huge" under the lowered bar

    # host observed much faster than device-huge -> routes host
    be = BatchEncoder(use_device="auto")
    be.CHUNKED_MIN_VERTS = 256
    be._host_obs = [100e6, 1.0]       # 100 MB/s
    be._huge_dev_obs = [10e6, 1.0]    # 10 MB/s
    got = be.encode_meshes_auto([mesh])
    assert bytes(got[0]) == bytes(encode(mesh))
    entry = be.routing_log[-1]
    assert entry["plane"] == "host"
    assert entry["reason"].startswith("single mesh (measured")

    # device observed faster -> routes device
    be2 = BatchEncoder(use_device="auto")
    be2.CHUNKED_MIN_VERTS = 256
    be2._host_obs = [5e6, 1.0]
    be2._huge_dev_obs = [50e6, 1.0]
    got2 = be2.encode_meshes_auto([mesh])
    assert bytes(got2[0]) == bytes(encode(mesh))
    assert be2.routing_log[-1]["plane"] == "device"

    # estimates persist: a fresh encoder sharing the disk cache sees them
    import json as _json
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        cache = os.path.join(td, "routes.json")
        be3 = BatchEncoder(use_device="auto", route_cache_path=cache)
        be3.CHUNKED_MIN_VERTS = 256
        be3._note_mbs("host", int(100e6), 1.0)
        be3._note_mbs("huge_device", int(10e6), 1.0)
        data = _json.load(open(cache))
        keys = set(data["entries"])
        assert "__mbs__|host" in keys
        assert "__mbs__|huge_device" in keys
        be4 = BatchEncoder(use_device="auto", route_cache_path=cache)
        be4.CHUNKED_MIN_VERTS = 256
        got4 = be4.encode_meshes_auto([mesh])
        assert bytes(got4[0]) == bytes(encode(mesh))
        assert be4.routing_log[-1]["plane"] == "host"
        assert be4.routing_log[-1]["reason"].startswith(
            "single mesh (measured")
