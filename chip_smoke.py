"""Smoke run of the device encode/decode plane on an NVIDIA GPU.

    python chip_smoke.py                # one card: phases 1-7
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

One process drives the system's main path through the entry points a
user calls, at deployment sizes, with inputs made from a seed. Every
device result is held to the sequential host ``encode()`` / ``decode()``
byte for byte; any mismatch or exception ends the run with a non-zero
exit code. Without a GPU the script exits non-zero and prints no result.

Phases (one card):
  1 bulk shared-topology encode: 512 meshes of 64x64 grids with
    POSITION/NORMAL/TEX_COORD at the default depths, device entropy,
    strict (no host fallback)
  2 the device rANS words scan alone at phase 1's shapes, against the
    host rANS coder lane by lane
  3 grouped decode of phase 1's blobs on the device (no host refills),
    beside host decode() of the same blobs
  4 resident huge mesh: one 1024x1024 textured grid
  5 auto router over a mixed corpus (small meshes, one huge, the bulk)
  6 the corpus CLI, in-process: ``encode --device`` and ``decode
    --device`` over 64 seeded textured OBJ files
  7 the card-only checks (the ``gpu``-marked tests' check functions)

Each phase prints one line: set-up and compile time apart from the warm
time (median of 3 after warm-up, ending in a readback), the device's
peak_bytes_in_use so far, and the card's name and power limit. The last
line is the JSON object {"ok": true, "device": {...}}.

``--four-cards`` runs phase 1's batch on a 4-card ("data",) mesh and
phase 4's mesh on a 4-card ("stream",) mesh, each against one card and
the host, and checks that every card held memory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np



# ------------------------------------------------------------------ setup


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them (a
    child process that never imports JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(ln.strip() for ln in r.stdout.splitlines()
                     if ln.strip()) or "nvidia-smi printed nothing"


def peak_bytes(device=None) -> int | None:
    """peak_bytes_in_use of ``device`` (the first device by default);
    None where the backend keeps no memory statistics (CPU)."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


def timed(fn, reps: int = 3):
    """(first-call seconds, median warm seconds over ``reps``, result of
    the last call). ``fn`` must end in a host readback."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        warm.append(time.perf_counter() - t0)
    return first, statistics.median(warm), out


def report(name: str, card: str, **fields) -> None:
    fields["peak_bytes_in_use"] = peak_bytes()
    fields["card"] = card
    print(f"phase {name}: {json.dumps(fields)}", flush=True)


# ----------------------------------------------------------------- inputs


def grid_faces(n: int) -> np.ndarray:
    """Triangles of an n x n vertex grid (vectorized)."""
    a = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).ravel()
    f1 = np.stack([a, a + 1, a + n], axis=1)
    f2 = np.stack([a + 1, a + n + 1, a + n], axis=1)
    return np.concatenate([f1, f2]).astype(np.int64)


def grid_mesh(n: int, seed: int, textured: bool = True, faces=None):
    """One seeded n x n grid mesh: jittered positions, random unit
    normals and planar UVs (CORNER domain, parented to the positions,
    as the glTF importer builds them)."""
    from tpudraco.models import AttributeDomain, AttributeType, MeshBuilder

    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(), np.zeros(n * n, np.float32)],
                   axis=1) + rng.rand(n * n, 3).astype(np.float32)
    mb = MeshBuilder()
    mb.set_connectivity_attribute(grid_faces(n) if faces is None else faces)
    pid = mb.add_attribute(pos, AttributeType.POSITION,
                           AttributeDomain.POSITION)
    if textured:
        nrm = rng.randn(n * n, 3).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        mb.add_attribute(nrm, AttributeType.NORMAL, AttributeDomain.CORNER,
                         parents=[pid])
        uv = (pos[:, :2] / np.float32(n)).astype(np.float32)
        mb.add_attribute(uv, AttributeType.TEX_COORD,
                         AttributeDomain.CORNER, parents=[pid])
    return mb.build()


def grid_batch(batch: int, n: int, seed: int = 1, textured: bool = True):
    """``batch`` meshes sharing one n x n grid topology."""
    faces = grid_faces(n)
    return [grid_mesh(n, seed * 100003 + b, textured, faces)
            for b in range(batch)]


def host_blobs(meshes) -> list[bytes]:
    from tpudraco.encode import encode
    return [encode(m) for m in meshes]


def assert_same_blobs(got, ref, what: str) -> None:
    assert len(got) == len(ref), what
    bad = [i for i, (g, r) in enumerate(zip(got, ref))
           if g is None or bytes(g) != bytes(r)]
    assert not bad, f"{what}: {len(bad)} blobs differ from host encode() " \
                    f"(first {bad[:5]})"


# ----------------------------------------------------------------- phases


def phase_bulk_encode(meshes, ref_blobs, reps: int = 3) -> dict:
    """Phase 1: the bulk batch through the strict device plane."""
    from tpudraco.parallel import BatchEncoder

    enc = BatchEncoder(strict_device=True)
    first, warm, blobs = timed(
        lambda: enc.encode_meshes_device(meshes, entropy="device"), reps)
    assert_same_blobs(blobs, ref_blobs, "bulk device encode")
    assert enc.fallback_groups == 0 and enc.fallback_meshes == 0
    raw = sum(a.values.nbytes for m in meshes for a in m.attributes)
    return {"meshes": len(meshes), "setup_compile_s": first,
            "warm_s": warm, "raw_mb_per_s": raw / warm / 1e6,
            "blobs": blobs}


def scan_inputs(meshes):
    """The words scan's inputs at phase 1's shapes: device residual
    symbols of the batch's positions, flipped into lanes, with per-lane
    tables normalized on device (the device-tables flow)."""
    import jax
    import jax.numpy as jnp

    from tpudraco.ops import rans_lanes
    from tpudraco.parallel.batch import PreparedTopology, device_encode_group

    topo = PreparedTopology(meshes[0])
    pos = np.stack([m.position_attribute().values.astype(np.float32)
                    for m in meshes])
    dev = device_encode_group(pos, topo, meshes[0].position_attribute(),
                              bits=11, return_device=True)
    B, T, C = dev["symbols"].shape
    with jax.enable_x64(True):
        dist, cums, prec, _tiny = rans_lanes._normalize_tables_x64(
            dev["counts"], jnp.int32(T * C))
    lanes = rans_lanes._flip_lanes(dev["symbols"])
    lengths = jnp.full((B,), T * C, jnp.int32)
    return lanes, dist, cums, lengths, prec


def lane_bytes(combined, lengths) -> list[bytes]:
    """Per-lane byte streams of one words-scan output, unpacked on the
    host as the encoder unpacks them."""
    from tpudraco.ops import rans_lanes

    L = len(lengths)
    bufs, counts, packed, nflush = rans_lanes._collect_words(
        combined, L, int(max(lengths, default=0)), -1)
    nbytes = rans_lanes._append_flush(
        bufs, counts, np.asarray(packed).astype(np.uint64),
        np.asarray(nflush).astype(np.int64))
    return [bufs[i, :nbytes[i]].tobytes() for i in range(L)]


def assert_lanes_match_host(got: list[bytes], syms, dist, lengths,
                            prec) -> None:
    """Every lane's bytes equal the host rANS coder's over the same
    symbols and table."""
    from tpudraco.entropy.rans import RansEncoder

    syms, dist, lengths, prec = (np.asarray(a) for a in
                                 (syms, dist, lengths, prec))
    for i, blob in enumerate(got):
        enc = RansEncoder(dist[i], precision=int(prec[i]))
        enc.write_all(syms[i, :lengths[i]])
        assert blob == enc.flush(), f"words scan lane {i} differs from " \
                                    "the host rANS coder"


def phase_words_scan(meshes, reps: int = 3) -> dict:
    """Phase 2: the device rANS words scan (lax.scan recurrence + word
    compaction + readback) alone at phase 1's shapes: one LANE_CHUNK-lane
    chunk, as the pipelined encoder runs it, and one call over all
    lanes. Every lane's bytes are held to the host rANS coder."""
    from tpudraco.ops import rans_lanes

    lanes, dist, cums, lengths, prec = scan_inputs(meshes)
    L, T = lanes.shape
    ch = min(rans_lanes.LANE_CHUNK, L)
    kw = {"compact": rans_lanes._words_compact(),
          "k": rans_lanes.SYMBOLS_PER_STEP}
    chunk_first, chunk_warm, chunk = timed(lambda: np.asarray(
        rans_lanes._words_scan_chunk_vprec(lanes, np.int32(0), dist, cums,
                                           lengths, prec, ch=ch, **kw)),
        reps)
    all_first, all_warm, _ = timed(lambda: np.asarray(
        rans_lanes._rans_scan_lanes_words_vprec(lanes, dist, cums, lengths,
                                                prec, **kw)), reps)
    combined = rans_lanes._rans_scan_lanes_words_vprec(
        lanes, dist, cums, lengths, prec, **kw)
    assert np.array_equal(chunk, np.asarray(combined)[:ch]), \
        "a lane chunk differs from the same lanes scanned together"
    assert_lanes_match_host(lane_bytes(combined, np.asarray(lengths)),
                            lanes, dist, lengths, prec)
    return {"lanes": L, "symbols": T, "chunk_lanes": ch,
            "chunk_setup_compile_s": chunk_first, "chunk_warm_s": chunk_warm,
            "all_lanes_setup_compile_s": all_first,
            "all_lanes_warm_s": all_warm}


def assert_same_meshes(got, ref, what: str) -> None:
    """Decoded meshes equal host decode()'s: connectivity, and the bits
    of every attribute (dequantization is a fixed map of the quantized
    integers, so equal bits mean equal quantized values)."""
    assert len(got) == len(ref), what
    for i, (mesh, r) in enumerate(zip(got, ref)):
        assert mesh is not None, f"{what}: blob {i} failed to decode"
        assert np.array_equal(mesh.faces, r.faces), f"{what}: faces of {i}"
        assert len(mesh.attributes) == len(r.attributes)
        for ga, ra in zip(mesh.attributes, r.attributes):
            assert ga.values.dtype == ra.values.dtype
            assert ga.values.shape == ra.values.shape
            assert ga.values.tobytes() == ra.values.tobytes(), \
                f"{what}: attribute {ga.att_type.name} of blob {i}"
            assert np.array_equal(
                ga.point_map if ga.point_map is not None else [],
                ra.point_map if ra.point_map is not None else [])


def phase_grouped_decode(blobs, reps: int = 3) -> dict:
    """Phase 3: the shared-topology grouped decoder with device entropy
    and device (phased) normals, against per-blob host decode(), whose
    time is reported beside it. One more pass with the NORMAL chains on
    the host splits the device time between entropy and normals."""
    from tpudraco.decode import decode
    from tpudraco.parallel.decode_batch import BatchDecoder

    t0 = time.perf_counter()
    ref = [decode(b) for b in blobs]
    host_s = time.perf_counter() - t0
    bd = BatchDecoder()
    first, warm, got = timed(
        lambda: bd.decode_blobs_shared_topology(blobs, entropy="device",
                                                normals="device"), reps)
    assert_same_meshes(got, ref, "grouped device decode")
    t0 = time.perf_counter()
    got = bd.decode_blobs_shared_topology(blobs, entropy="device",
                                          normals="host")
    host_normals_s = time.perf_counter() - t0
    assert_same_meshes(got, ref, "grouped decode, host normals")
    assert bd.host_refills == 0, f"{bd.host_refills} blobs refilled on host"
    return {"blobs": len(blobs), "setup_compile_s": first, "warm_s": warm,
            "host_decode_s": host_s,
            "device_entropy_host_normals_s": host_normals_s,
            "host_refills": bd.host_refills}


def phase_resident_huge(n: int = 1024, reps: int = 3) -> dict:
    """Phase 4: one n x n textured grid through the resident route."""
    from tpudraco.encode import encode
    from tpudraco.parallel import BatchEncoder

    t0 = time.perf_counter()
    mesh = grid_mesh(n, seed=7)
    ref = encode(mesh)
    host_s = time.perf_counter() - t0
    enc = BatchEncoder(strict_device=True)
    first, warm, blob = timed(lambda: enc.encode_mesh_device(mesh), reps)
    assert blob == ref, "resident huge-mesh bytes differ from encode()"
    return {"vertices": n * n, "faces": 2 * (n - 1) ** 2,
            "host_build_and_encode_s": host_s, "setup_compile_s": first,
            "warm_s": warm, "bytes": len(blob), "mesh": mesh, "ref": ref}


def mixed_corpus(bulk, small_n: int = 63, huge_n: int = 768):
    """bench.py's mixed corpus: 32 small distinct meshes, one huge
    positions-only mesh, then the bulk shared-topology batch."""
    small = [grid_mesh(small_n, s, textured=False) for s in range(32)]
    huge = [grid_mesh(huge_n, 3, textured=False)]
    return small + huge + bulk


def phase_auto_router(corpus, ref_blobs, reps: int = 3) -> dict:
    """Phase 5: the auto router over the mixed corpus. The first pass
    probes, compiles and caches its routing decisions; the warm passes
    reuse them, as a long-lived encoder would. Every pass must give the
    host bytes."""
    from tpudraco.parallel import BatchEncoder

    auto = BatchEncoder(use_device="auto", route_cache_path=None)

    def once():
        blobs = auto.encode_meshes_auto(corpus)
        assert_same_blobs(blobs, ref_blobs, "auto router")
        return blobs

    first, warm, _ = timed(once, reps)
    return {"meshes": len(corpus), "setup_compile_s": first,
            "warm_s": warm,
            "fallbacks": [auto.fallback_groups, auto.fallback_meshes],
            "routing": [{k: e.get(k) for k in ("meshes", "verts", "plane",
                                                "reason")}
                        for e in auto.routing_log]}


def phase_cli(work_dir: str, n_files: int = 64, n: int = 64,
              reps: int = 3) -> dict:
    """Phase 6: the corpus CLI in-process over seeded textured OBJ files
    (n x n grids with normals and UVs, like phase 1's meshes):
    ``encode --device``, then ``decode --device`` of its output, each
    rerun over the same files (``--no-resume``). Every blob equals
    encode() of the loaded file, and every decoded file equals the one
    written from host decode()."""
    import contextlib
    import io
    import shutil

    from tpudraco.decode import decode
    from tpudraco.encode import encode
    from tpudraco.io import load_mesh
    from tpudraco.io.obj import save_obj
    from tpudraco.tools import corpus

    shutil.rmtree(work_dir, ignore_errors=True)
    src, drc, back = (os.path.join(work_dir, d)
                      for d in ("obj", "drc", "decoded"))
    os.makedirs(src)
    faces = grid_faces(n)
    for i in range(n_files):
        save_obj(grid_mesh(n, 500 + i, faces=faces),
                 os.path.join(src, f"m{i:03d}.obj"))

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = corpus.main(argv)
        return rc, json.loads(buf.getvalue())

    enc_first, enc_warm, (rc, rep) = timed(
        lambda: run(["encode", "-i", src, "-o", drc, "--device",
                     "--no-resume"]), reps)
    assert rc == 0 and rep["encoded"] == n_files, rep
    assert rep.get("device_fallback_groups") == 0, rep
    blobs = []
    for i in range(n_files):
        obj = os.path.join(src, f"m{i:03d}.obj")
        with open(os.path.join(drc, f"m{i:03d}.drc"), "rb") as f:
            blobs.append(f.read())
        assert blobs[-1] == encode(load_mesh(obj)), \
            f"CLI blob {i} differs from encode()"
    dec_first, dec_warm, (rc, rep_d) = timed(
        lambda: run(["decode", "-i", drc, "-o", back, "--device",
                     "--no-resume"]), reps)
    assert rc == 0 and rep_d["decoded"] == n_files, rep_d
    ref_obj = os.path.join(work_dir, "host.obj")
    for i, blob in enumerate(blobs):
        save_obj(decode(blob), ref_obj)
        with open(ref_obj, "rb") as a, \
                open(os.path.join(back, f"m{i:03d}.obj"), "rb") as b:
            assert a.read() == b.read(), \
                f"CLI decode of blob {i} differs from host decode()"
    return {"files": n_files, "encode_setup_compile_s": enc_first,
            "encode_warm_s": enc_warm, "decode_setup_compile_s": dec_first,
            "decode_warm_s": dec_warm}


# ------------------------------------------------------ card-only checks


def check_words_scan_on_device(L: int = 37, T: int = 613) -> None:
    """The words scan compiled for the device equals the host rANS coder
    on a ragged shape: L not a multiple of 32, T not of the scan step,
    ragged lengths, per-lane precisions 12..20."""
    import jax.numpy as jnp

    from tpudraco.entropy.rans import normalize_freq_counts
    from tpudraco.ops import rans_lanes

    rng = np.random.default_rng(5)
    syms = (rng.integers(0, 13, size=(L, T)) ** 2).astype(np.int32)
    lengths = rng.integers(0, T + 1, size=L).astype(np.int32)
    lengths[0] = T
    precs = rng.integers(12, 21, size=L).astype(np.uint32)
    freqs = np.zeros((L, 256), np.uint32)
    for i in range(L):
        d = normalize_freq_counts(np.bincount(syms[i], minlength=256),
                                  int(precs[i]))
        freqs[i, :len(d)] = d
    cums = np.concatenate([np.zeros((L, 1), np.uint32),
                           np.cumsum(freqs, axis=1)[:, :-1]],
                          axis=1).astype(np.uint32)
    combined = rans_lanes._rans_scan_lanes_words_vprec(
        *(jnp.asarray(a) for a in (syms, freqs, cums, lengths, precs)),
        compact=rans_lanes._words_compact(),
        k=rans_lanes.SYMBOLS_PER_STEP)
    assert_lanes_match_host(lane_bytes(combined, lengths), syms, freqs,
                            lengths, precs)


def check_bincount_on_device() -> None:
    """The device histogram (XLA scatter-add) equals np.bincount and
    drops out-of-range symbols."""
    import jax.numpy as jnp

    from tpudraco.ops import bincount_kernel

    rng = np.random.default_rng(9)
    sym = rng.integers(-3, 4200, size=(6, 50000)).astype(np.int32)
    got = np.asarray(bincount_kernel(jnp.asarray(sym), 4096))
    for row, g in zip(sym, got):
        ok = row[(row >= 0) & (row < 4096)]
        assert np.array_equal(g, np.bincount(ok, minlength=4096))


CARD_CHECKS = (check_words_scan_on_device, check_bincount_on_device)


def phase_card_checks(reps: int = 3) -> dict:
    """Phase 7: every card-only check, in this process."""
    out = {}
    for check in CARD_CHECKS:
        first, warm, _ = timed(check, reps)
        out[check.__name__] = {"setup_compile_s": first, "warm_s": warm}
    return out


# -------------------------------------------------------------- 4 cards


def phase_four_cards(meshes, ref_blobs, huge_mesh, huge_ref,
                     n_cards: int = 4, reps: int = 3) -> dict:
    """The data-parallel batch (step, device entropy and NORMAL/UV
    chains shard over ("data",)) and the stream-sharded single mesh
    (traversal shards over ("stream",)), each against one card and the
    host, with every card required to hold memory."""
    import jax
    from jax.sharding import Mesh

    from tpudraco.parallel import BatchEncoder

    devs = jax.devices()[:n_cards]
    assert len(devs) == n_cards, f"needs {n_cards} devices"
    one = BatchEncoder(strict_device=True)
    one_first, one_warm, blobs1 = timed(
        lambda: one.encode_meshes_device(meshes, entropy="device"), reps)
    assert_same_blobs(blobs1, ref_blobs, "1-card batch")
    data = BatchEncoder(strict_device=True,
                        mesh_axis=Mesh(np.asarray(devs), ("data",)))
    dp_first, dp_warm, blobs4 = timed(
        lambda: data.encode_meshes_device(meshes, entropy="device"), reps)
    assert_same_blobs(blobs4, blobs1, f"{n_cards}-card data-parallel batch")
    assert data.fallback_groups == 0 and one.fallback_groups == 0

    stream_mesh = Mesh(np.asarray(devs), ("stream",))
    enc = BatchEncoder(strict_device=True)
    sp_first, sp_warm, blob_s = timed(
        lambda: enc.encode_mesh_device_stream_sharded(huge_mesh,
                                                      stream_mesh), reps)
    assert blob_s == huge_ref, "stream-sharded bytes differ from encode()"
    r_first, r_warm, blob_r = timed(
        lambda: enc.encode_mesh_device(huge_mesh), reps)
    assert blob_r == huge_ref

    peaks = [peak_bytes(d) for d in devs]
    if jax.default_backend() == "gpu":
        assert all(p and p > 0 for p in peaks), \
            f"a card held no memory: peak_bytes_in_use {peaks}"
    return {"cards": n_cards,
            "batch_1card_compile_s": one_first,
            "batch_1card_warm_s": one_warm,
            "batch_data_compile_s": dp_first,
            "batch_data_warm_s": dp_warm,
            "huge_resident_1card_compile_s": r_first,
            "huge_resident_1card_warm_s": r_warm,
            "huge_stream_compile_s": sp_first,
            "huge_stream_warm_s": sp_warm,
            "peak_bytes_in_use_per_card": peaks}


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded paths")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devices[0].platform!r} devices", file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print(f"chip_smoke: --four-cards needs 4 GPUs, JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 2

    from tpudraco import native
    from tpudraco.utils.compile_cache import enable_compile_cache

    os.environ.setdefault("TPUDRACO_ROUTE_CACHE", "0")
    cache = enable_compile_cache()
    card = card_info()
    print(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"devices {len(devices)}; compile cache {cache}")
    print(f"card: {card}")
    print(f"native library loaded: {native.load_library() is not None}",
          flush=True)

    t0 = time.perf_counter()
    meshes = grid_batch(512, 64)
    ref_blobs = host_blobs(meshes)
    print(f"inputs: 512 textured 64x64 meshes + host encode() in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    if args.four_cards:
        t0 = time.perf_counter()
        huge = grid_mesh(1024, seed=7)
        from tpudraco.encode import encode
        huge_ref = encode(huge)
        print(f"inputs: 1024x1024 mesh + host encode() in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        report("four_cards", card, **phase_four_cards(
            meshes, ref_blobs, huge, huge_ref, n_cards=4))
    else:
        res = phase_bulk_encode(meshes, ref_blobs)
        blobs = res.pop("blobs")
        report("1 bulk_encode", card, **res)
        report("2 words_scan", card, **phase_words_scan(meshes))
        report("3 grouped_decode", card, **phase_grouped_decode(blobs))
        res = phase_resident_huge()
        res.pop("mesh"), res.pop("ref")
        report("4 resident_huge", card, **res)
        corpus = mixed_corpus([grid_mesh(64, 1000 + i, textured=False,
                                         faces=grid_faces(64))
                               for i in range(512)])
        report("5 auto_router", card,
               **phase_auto_router(corpus, host_blobs(corpus)))
        with tempfile.TemporaryDirectory() as work:
            report("6 cli", card, **phase_cli(os.path.join(work, "cli")))
        report("7 card_checks", card, **phase_card_checks())

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
