"""Phased device decode-normals: grouped decode defers NORMAL chains and
batches them on the accelerator (positions first, then one ring-predict
+ inverse-transform batch). These tests pin the bit-exactness contract
and the failure isolation."""

import numpy as np
import pytest

from tpudraco.encode import Config, encode
from tpudraco.decode import decode
from tpudraco.models.attribute import AttributeType
from tpudraco.parallel.decode_batch import BatchDecoder

from tests.test_parallel import _grid_mesh, _grid_mesh_with_normals


def _assert_equal(got, ref):
    assert got is not None
    assert len(got.attributes) == len(ref.attributes)
    for ga, ra in zip(got.attributes, ref.attributes):
        assert np.array_equal(ga.values_per_point(), ra.values_per_point())


@pytest.mark.parametrize("mode", ["host", "device", "auto"])
def test_phased_normals_bit_exact(mode):
    """Textured grids (CORNER-domain normals -> real seams): every mode
    must equal per-blob decode()."""
    meshes = [_grid_mesh_with_normals(9, s) for s in range(20)]
    blobs = [encode(m) for m in meshes]
    ref = [decode(b) for b in blobs]
    got = BatchDecoder().decode_blobs_shared_topology(blobs, normals=mode)
    for g, r in zip(got, ref):
        _assert_equal(g, r)


def test_phased_normals_with_device_entropy_and_depths():
    meshes = [_grid_mesh_with_normals(9, s) for s in range(16)]
    for qn in (7, 12, 16):
        cfg = Config(quant_bits={AttributeType.NORMAL: qn})
        blobs = [encode(m, cfg=cfg) for m in meshes]
        ref = [decode(b) for b in blobs]
        got = BatchDecoder().decode_blobs_shared_topology(
            blobs, entropy="device", normals="device")
        for g, r in zip(got, ref):
            _assert_equal(g, r)


def test_phased_normals_device_failure_refills_host(monkeypatch):
    """A device-chain failure must refill the affected blobs from the
    host path, bit-exactly, without poisoning the group."""
    import tpudraco.parallel.decode_batch as db

    meshes = [_grid_mesh_with_normals(8, s) for s in range(6)]
    blobs = [encode(m) for m in meshes]
    ref = [decode(b) for b in blobs]

    def boom(conn, deferred):
        return {bi for bi, _, _, _ in deferred}

    monkeypatch.setattr(db.BatchDecoder, "_fill_deferred_normals",
                        staticmethod(boom))
    bd = BatchDecoder()
    got = bd.decode_blobs_shared_topology(blobs, normals="device")
    for g, r in zip(got, ref):
        _assert_equal(g, r)
    assert bd.host_refills == len(blobs)


def test_phased_auto_threshold():
    """auto engages the phased path only at PHASED_NORMALS_MIN_BLOBS+
    blobs (below it the dispatch overhead loses) — and bytes stay equal
    on both sides of the threshold."""
    bd = BatchDecoder()
    small = [encode(_grid_mesh_with_normals(8, s)) for s in range(4)]
    large = [encode(_grid_mesh_with_normals(8, s))
             for s in range(bd.PHASED_NORMALS_MIN_BLOBS)]
    for blobs in (small, large):
        ref = [decode(b) for b in blobs]
        got = bd.decode_blobs_shared_topology(blobs, normals="auto")
        for g, r in zip(got, ref):
            _assert_equal(g, r)


def test_phased_ignores_normal_free_groups():
    """Position-only groups must pass through the phased gate untouched."""
    meshes = [_grid_mesh(8, s) for s in range(20)]
    blobs = [encode(m) for m in meshes]
    ref = [decode(b) for b in blobs]
    got = BatchDecoder().decode_blobs_shared_topology(blobs,
                                                      normals="device")
    for g, r in zip(got, ref):
        _assert_equal(g, r)


def test_phased_normals_opt_in_transforms_stay_host():
    """Opt-in transforms (OctReflection / Orthogonal) are not deferred —
    the scalar/vectorized host chains handle them and bytes stay equal."""
    meshes = [_grid_mesh_with_normals(8, s) for s in range(18)]
    for xf in (2, 4):
        cfg = Config(transform={AttributeType.NORMAL: xf})
        blobs = [encode(m, cfg=cfg) for m in meshes]
        ref = [decode(b) for b in blobs]
        got = BatchDecoder().decode_blobs_shared_topology(blobs,
                                                          normals="device")
        for g, r in zip(got, ref):
            _assert_equal(g, r)


def test_ring_sum_overflow_at_deep_position_depth():
    """Round-5 soak find: at deep -qp the ring-sum of cross products
    exceeds int32, and the host clamps the UNWRAPPED int64 sum before
    wrapping — the device chain used to sum in int32 (wrapping during
    accumulation) and diverged on both the encode and the phased-decode
    side. Pin both directions at -qp 18."""
    from tpudraco.parallel import BatchEncoder

    rng = np.random.RandomState(11)
    meshes = []
    for s in range(4):
        m = _grid_mesh_with_normals(9, s)
        # spread the positions so quantized diffs at -qp 18 push ring
        # sums past 2^31
        pos = m.attributes[0]
        pos.values = (pos.values * np.float32(1e4)).astype(np.float32)
        meshes.append(m)
    cfg = Config(quant_bits={AttributeType.POSITION: 18})
    blobs = [encode(m, cfg=cfg) for m in meshes]
    # encode-side device chain byte oracle
    got_e = BatchEncoder(use_device=True, strict_device=True,
                         cfg=cfg).encode_meshes_device(meshes)
    for b, w in zip(got_e, blobs):
        assert bytes(b) == w
    # phased decode value oracle
    ref = [decode(b) for b in blobs]
    got = BatchDecoder().decode_blobs_shared_topology(blobs,
                                                      normals="device")
    for g, r in zip(got, ref):
        _assert_equal(g, r)


def test_phased_mixed_traversal_group():
    """Review-found round-5 bug: blobs with different attribute-traversal
    bytes share the connectivity prefix but have DIFFERENT sequences;
    grouping them into one phased batch used the majority's sequence for
    everyone. Groups now key on the traversal and each sub-group decodes
    with its own rings/sequence — values must equal per-blob decode for
    both dialects in one call."""
    mesh = _grid_mesh_with_normals(9, 1)
    df = encode(mesh)
    pd = encode(mesh, cfg=Config(attribute_traversal="prediction-degree"))
    blobs = [df, pd, df, pd]
    ref = [decode(b) for b in blobs]
    got = BatchDecoder().decode_blobs_shared_topology(blobs,
                                                      normals="device")
    for g, r in zip(got, ref):
        _assert_equal(g, r)


def test_phased_engages_for_single_huge_blob(monkeypatch):
    """auto also engages at B=1 when the mesh is big enough to amortize
    the dispatch (the decode mirror of the resident encode route)."""
    bd = BatchDecoder()
    monkeypatch.setattr(BatchDecoder, "PHASED_NORMALS_MIN_FACES", 64)
    mesh = _grid_mesh_with_normals(9, 5)  # 128 faces >= lowered bar
    blob = encode(mesh)
    ref = decode(blob)
    filled = {}
    orig = BatchDecoder._fill_deferred_normals

    def spy(conn, deferred):
        filled["n"] = len(deferred)
        return orig(conn, deferred)

    monkeypatch.setattr(BatchDecoder, "_fill_deferred_normals",
                        staticmethod(spy))
    got = bd.decode_blobs_shared_topology([blob], normals="auto")
    assert filled.get("n") == 1, "phased path did not engage at B=1"
    _assert_equal(got[0], ref)
