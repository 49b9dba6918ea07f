"""Corpus-scale decoding: the mirror of the batch encoder.

Decodes many .drc blobs with per-item error isolation and file-level
resume. Connectivity reconstruction runs in the native C++ Spirale core
per mesh; residual-to-value chains use the native/vectorized decode paths.
Symbol streams across meshes are independent, so corpus decode also
exposes a device path that rANS-decodes many attribute streams as lanes
(ops/rans_lanes.rans_decode_lanes) when a corpus shares topology groups.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..decode import decode

# per-call budget for the (lanes, 1<<precision) slot tables the device
# decoder gathers from; high-precision streams decode in smaller lane groups
_SLOT_BUDGET_BYTES = 64 << 20


def _device_decode_streams(streams: dict) -> dict:
    """rANS-decode many independent DirectCoded streams as device lanes.
    ``streams``: key -> (dist, precision, payload bytes, n_sym). Returns
    key -> (n_sym,) symbol array (forward order, matching the host
    decoder). Lanes group by precision; each group is chunked so the
    per-lane slot tables fit the budget."""
    import jax.numpy as jnp

    from ..ops.rans_lanes import rans_decode_lanes

    out: dict = {}
    by_prec: dict = {}
    for key, (dist, prec, payload, n_sym) in streams.items():
        by_prec.setdefault(int(prec), []).append(key)

    def _pow2_at_least(x: int, floor: int) -> int:
        n = floor
        while n < x:
            n *= 2
        return n

    for prec, keys in by_prec.items():
        lanes_per_call = max(
            1, _SLOT_BUDGET_BYTES // ((1 << prec) * 4))
        for c0 in range(0, len(keys), lanes_per_call):
            chunk = keys[c0:c0 + lanes_per_call]
            # bucket every data-dependent dimension so the jitted scan
            # compiles once per (precision, bucket), not once per corpus
            L = _pow2_at_least(len(chunk) + 1, 16)  # >=1 padding lane
            S = _pow2_at_least(max(len(streams[k][0]) for k in chunk), 16)
            maxlen = _pow2_at_least(
                max(len(streams[k][2]) for k in chunk) + 1, 256)
            max_T = _pow2_at_least(
                max(int(streams[k][3]) for k in chunk), 128)
            buffers = np.zeros((L, maxlen), np.uint8)
            nbytes = np.ones(L, np.int32)   # padding lanes: 1 zero byte
            freqs = np.zeros((L, S), np.uint32)
            cums = np.zeros((L, S), np.uint32)
            slots = np.zeros((L, 1 << prec), np.int32)
            counts = np.zeros(L, np.int64)
            freqs[:, 0] = 1 << prec  # valid table for padding lanes
            # the last (always-padding) lane pins the scan length to the
            # bucket so the jit key is (precision, buckets), not data
            counts[-1] = max_T
            for j, k in enumerate(chunk):
                dist, _, payload, n_sym = streams[k]
                buffers[j, :len(payload)] = np.frombuffer(payload, np.uint8)
                nbytes[j] = len(payload)
                freqs[j, :len(dist)] = dist
                freqs[j, len(dist):] = 0
                cums[j, 1:len(dist)] = np.cumsum(dist)[:-1]
                slots[j, :int(dist.sum())] = np.repeat(
                    np.arange(len(dist)), dist)
                counts[j] = n_sym
            got = np.asarray(rans_decode_lanes(
                jnp.asarray(buffers), jnp.asarray(nbytes),
                jnp.asarray(freqs), jnp.asarray(cums), jnp.asarray(slots),
                counts, precision=prec))
            for j, k in enumerate(chunk):
                out[k] = got[j][:int(streams[k][3])]
    return out


class BatchDecoder:
    """Decode a corpus of Draco blobs with error isolation + resume
    (the decode-side counterpart of BatchEncoder, SURVEY.md §5.3-5.4).

    ``host_refills`` counts the blobs that a device-stage failure sent
    back to the host decoder (the mirror of BatchEncoder's fallback
    counters): the output stays exact, but a broken device path must
    not hide behind correct-but-slow host decodes."""

    def __init__(self) -> None:
        self.host_refills = 0

    def decode_blobs(self, blobs: list[bytes]) -> list:
        out = []
        for b in blobs:
            try:
                out.append(decode(b))
            except Exception:
                out.append(None)
        return out

    # phased-normals auto thresholds: below this many matching blobs the
    # device dispatch overhead beats the host chains. A SINGLE huge blob
    # also engages (B=1 with enough traversal steps amortizes the
    # dispatch the same way the resident encode route does). Set on the
    # previous accelerator; not yet measured on the H100.
    PHASED_NORMALS_MIN_BLOBS = 16
    PHASED_NORMALS_MIN_FACES = 1 << 17

    def _phased_auto(self, n_blobs: int, conn) -> bool:
        """auto engages when the batch (or a lone huge mesh) amortizes the
        device dispatch."""
        return (n_blobs >= self.PHASED_NORMALS_MIN_BLOBS
                or conn.corner_table.num_faces()
                >= self.PHASED_NORMALS_MIN_FACES)

    def decode_blobs_shared_topology(self, blobs: list[bytes],
                                     entropy: str = "host",
                                     normals: str = "auto") -> list:
        """Batch decode for blobs produced from one topology group (the
        output of BatchEncoder.encode_meshes_device): the connectivity
        section is parsed and Spirale-reconstructed ONCE and reused for
        every blob whose connectivity bytes match byte-for-byte; blobs that
        diverge (or fail) fall back to the full per-blob decoder. Output
        meshes are identical to per-blob decode() (pinned by tests).

        ``entropy="device"`` rANS-decodes every attribute symbol stream of
        the group as batched lanes on the accelerator (the decoder-side
        mirror of encode_meshes_device(entropy="device")).

        ``normals``: "host" keeps the per-blob vectorized NORMAL chains;
        "device" batches them across blobs on the accelerator (the PHASED
        decode: positions first per blob, then all normal chains as one
        ring-predict + inverse-transform batch); "auto" picks device at
        PHASED_NORMALS_MIN_BLOBS+ matching blobs. Bytes identical either
        way (pinned by tests); any device failure refills from the host
        path per blob, counted in ``host_refills``."""
        from ..decode import decode_header
        from ..decode.attribute import decode_attributes
        from ..decode.connectivity import decode_connectivity
        from ..wire.byte_io import ByteReader

        if not blobs:
            return []
        out: list = [None] * len(blobs)
        try:
            r0 = ByteReader(blobs[0])
            header = decode_header(r0)
            if header["flags"] & 0x8000 or header["method"] != 1 \
                    or header["geometry_type"] != 1:
                raise ValueError("not a plain edgebreaker mesh stream")
            conn = decode_connectivity(r0)
            conn_end = r0.pos
            prefix = bytes(blobs[0][:conn_end])
        except Exception:
            return self.decode_blobs(blobs)

        if entropy == "device":
            return self._decode_shared_device(blobs, conn, conn_end, prefix,
                                              normals=normals)

        phased = (normals == "device"
                  or (normals == "auto"
                      and self._phased_auto(len(blobs), conn)))
        items = []
        for i, blob in enumerate(blobs):
            try:
                if bytes(blob[:conn_end]) != prefix:
                    out[i] = decode(blob)  # different topology: full path
                    continue
            except Exception:
                out[i] = None
                continue

            def fn(collector, _b=blob):
                r = ByteReader(_b, pos=conn_end)
                return decode_attributes(r, conn,
                                         normal_collector=collector)
            items.append((i, fn))
        self._decode_items_with_phase(blobs, conn, items, out, phased)
        return out

    def _decode_items_with_phase(self, blobs, conn, items, out,
                                 phased: bool) -> None:
        """Shared phased-decode orchestration for the host and
        device-entropy paths: run each blob's attribute decode (with the
        deferral collector when phased), batch the deferred NORMAL chains
        on device, fill, assemble — failed blobs refill from the full
        host decoder, per blob. ``items``: (blob index, callable taking
        the collector and returning the decoded attribute list)."""
        from ..decode import _assemble_mesh

        deferred: list = []       # (blob idx, att idx, da, payload)
        pending: dict = {}        # blob idx -> decoded attribute list
        for i, fn in items:
            try:
                if phased:
                    collector = (lambda ai, da, pl, _i=i:
                                 deferred.append((_i, ai, da, pl)))
                    pending[i] = fn(collector)
                else:
                    out[i] = _assemble_mesh(conn, fn(None))
            except Exception:
                deferred = [d for d in deferred if d[0] != i]
                pending.pop(i, None)
                out[i] = None
        if pending:
            failed = self._fill_deferred_normals(conn, deferred)
            for i, atts in pending.items():
                if i in failed:
                    self.host_refills += 1
                    try:  # host refill keeps per-blob isolation
                        out[i] = decode(blobs[i])
                    except Exception:
                        out[i] = None
                    continue
                try:
                    out[i] = _assemble_mesh(conn, atts)
                except Exception:
                    out[i] = None

    @staticmethod
    def _fill_deferred_normals(conn, deferred: list) -> set:
        """Phase 2 of the phased decode: batch every deferred NORMAL chain
        (same attribute slot, same topology) through the device ring
        prediction + OctOrthogonal inverse (ops/normals.normal_decode_chain
        — bit-identical to the host chain), then scatter, dequantize, and
        fill each DecodedAttribute in place. Returns the blob indices that
        must refill from the host path (empty on success)."""
        if not deferred:
            return set()
        from ..decode.attribute import _deportabilize
        from ..shared.prediction import collect_normal_rings

        failed: set = set()
        groups: dict = {}
        for bi, ai, da, pl in deferred:
            # the attribute TRAVERSAL is part of the key: blobs with
            # different TraversalType bytes have different sequences over
            # the same topology (review-found round 5 — a mixed
            # depth-first/prediction-degree group decoded the minority
            # blobs with the majority's sequence, silently wrong)
            trav = int(pl["h"].get("traversal", 0))
            groups.setdefault((ai, int(pl["max_q"]), trav), []).append(
                (bi, da, pl))
        for (ai, max_q, trav), items in groups.items():
            try:
                import jax.numpy as jnp

                from ..ops.normals import normal_decode_chain

                pl0 = items[0][2]
                view, seq = pl0["view"], pl0["sequence"]
                bits = int(max_q).bit_length()  # max_q == 2^bits - 1
                cache = getattr(conn, "_phased_rings", None)
                if cache is None:
                    cache = conn._phased_rings = {}
                hit = cache.get((ai, trav))
                if hit is None:
                    rings = collect_normal_rings(view, seq)
                    row = np.asarray(pl0["pos"].da.vertex_of_corner,
                                     dtype=np.int64)
                    hit = cache[(ai, trav)] = (
                        jnp.asarray(row[rings["tip_pt"]]),
                        jnp.asarray(row[rings["next_pt"]]),
                        jnp.asarray(row[rings["prev_pt"]]),
                        jnp.asarray(rings["mask"]))
                tip_i, next_i, prev_i, mask = hit
                T = len(seq)
                q_pos = np.stack([
                    np.asarray(pl["pos"].da.quantized_by_vertex,
                               dtype=np.int32)
                    for _, _, pl in items])
                sym = np.stack([
                    np.asarray(pl["symbols"][:T], dtype=np.int32)
                    for _, _, pl in items])
                fl = np.stack([
                    np.asarray(pl["flips"][:T], dtype=bool)
                    for _, _, pl in items])
                vals = np.asarray(normal_decode_chain(
                    jnp.asarray(q_pos), jnp.asarray(sym), jnp.asarray(fl),
                    tip_i, next_i, prev_i, mask, bits=bits))
                _opp, ctv, _lm = view.as_arrays()
                rows = ctv[np.asarray(seq, dtype=np.int64)]
                for b, (bi, da, pl) in enumerate(items):
                    vbv = np.zeros((view.num_vertices, 2), dtype=np.int64)
                    vbv[rows] = vals[b]
                    da.quantized_by_vertex = vbv
                    da.values_by_vertex = _deportabilize(
                        vbv, pl["h"], pl["port_meta"])
            except Exception:
                failed.update(bi for bi, _, _ in items)
        return failed

    def _decode_shared_device(self, blobs, conn, conn_end, prefix,
                              normals: str = "auto") -> list:
        """Three-phase device entropy decode: (A) one structural pass per
        blob collects every DirectCoded stream (table + payload bytes)
        without decoding, (B) all streams rANS-decode as device lanes
        grouped by precision, (C) a second pass injects the decoded
        symbols into the reconstruction chains (with the NORMAL chains
        optionally deferred to the phased device batch, see
        decode_blobs_shared_topology)."""
        from ..decode.attribute import decode_attributes
        from ..entropy.symbol_coding import parse_direct_coded_stream
        from ..wire.byte_io import ByteReader

        out: list = [None] * len(blobs)
        streams: dict = {}   # (blob idx, att idx) -> (dist, prec, payload, n)
        matching = []
        for i, blob in enumerate(blobs):
            try:
                if bytes(blob[:conn_end]) != prefix:
                    out[i] = decode(blob)
                    continue

                def collect(att_idx, n_sym, n, reader, _i=i):
                    dist, prec, payload = parse_direct_coded_stream(reader)
                    if int(dist.sum()) != 1 << prec:
                        # corrupt/foreign table: isolate this blob to the
                        # host path instead of poisoning the device batch
                        raise ValueError("non-normalized rANS table")
                    streams[(_i, att_idx)] = (dist, prec, payload, n_sym)
                    return None

                r = ByteReader(blob, pos=conn_end)
                decode_attributes(r, conn, symbol_source=collect,
                                  collect_only=True)
                matching.append(i)
            except Exception:
                try:  # e.g. LengthCoded streams: full host path
                    out[i] = decode(blob)
                except Exception:
                    out[i] = None
                streams = {k: s for k, s in streams.items() if k[0] != i}

        try:
            decoded_syms = _device_decode_streams(streams)
        except Exception:
            # device failure: per-blob host fallback keeps isolation
            self.host_refills += len(matching)
            for i in matching:
                try:
                    out[i] = decode(blobs[i])
                except Exception:
                    out[i] = None
            return out

        phased = (normals == "device"
                  or (normals == "auto"
                      and self._phased_auto(len(matching), conn)))
        items = []
        for i in matching:
            def fn(collector, _i=i):
                def inject(att_idx, n_sym, n, reader):
                    parse_direct_coded_stream(reader)  # advance the reader
                    return decoded_syms[(_i, att_idx)][:n_sym].astype(
                        np.uint64)

                r = ByteReader(blobs[_i], pos=conn_end)
                return decode_attributes(r, conn, symbol_source=inject,
                                         normal_collector=collector)
            items.append((i, fn))
        self._decode_items_with_phase(blobs, conn, items, out, phased)
        return out

    def decode_corpus(self, inputs: list[str], out_dir: str,
                      resume: bool = True, fmt: str = "obj",
                      workers: int = 1, use_device: bool = False) -> dict:
        """Decode .drc files to meshes on disk (``fmt``: obj or ply).
        Skips outputs that already exist (resume); a bad blob is reported,
        not fatal. ``workers`` > 1 decodes on a thread pool (the C++
        chains release the GIL). ``use_device`` groups the corpus by
        connectivity-section bytes and rANS-decodes each group's symbol
        streams as batched device lanes (the decode mirror of
        encode_corpus(use_device=True))."""
        from ..io.obj import save_obj as _save_obj
        from ..io.ply import save_ply as _save_ply
        save_mesh = _save_ply if fmt == "ply" else _save_obj

        os.makedirs(out_dir, exist_ok=True)
        report = {"decoded": 0, "skipped": 0, "failed": [],
                  "total_in_bytes": 0}
        t0 = time.perf_counter()

        def out_path_for(path):
            name = os.path.splitext(os.path.basename(path))[0] + "." + fmt
            return os.path.join(out_dir, name)

        from .batch import _drop_output_collisions
        inputs, collided = _drop_output_collisions(inputs, out_path_for)
        for path in collided:
            report["failed"].append(
                {"path": path, "error": "output name collision"})

        done: dict[str, tuple] = {}
        if use_device:
            # group pending files by a cheap connectivity-prefix key (the
            # shared-topology decoder re-verifies the full prefix), then
            # lane-decode AND write one group at a time so memory stays
            # O(group), not O(corpus)
            groups: dict[bytes, list[str]] = {}
            for path in inputs:
                if resume and os.path.isfile(out_path_for(path)):
                    continue
                try:
                    with open(path, "rb") as f:
                        head = f.read(64)
                    groups.setdefault(bytes(head), []).append(path)
                except Exception:
                    pass  # per-file isolation below re-reports
            for paths in groups.values():
                blobs, sizes = [], []
                for p in paths:
                    with open(p, "rb") as f:
                        b = f.read()
                    blobs.append(b)
                    sizes.append(len(b))
                got = self.decode_blobs_shared_topology(blobs,
                                                        entropy="device")
                for p, mesh, nbytes in zip(paths, got, sizes):
                    if mesh is None:
                        continue  # host pass below reports the error
                    try:
                        out_path = out_path_for(p)
                        tmp = out_path + f".tmp{os.getpid()}"
                        save_mesh(mesh, tmp)
                        os.replace(tmp, out_path)
                        done[p] = ("decoded", p, nbytes)
                    except Exception as e:
                        done[p] = ("failed", p, repr(e))

        def one(path):
            if path in done:
                return done[path]
            out_path = out_path_for(path)
            if resume and os.path.isfile(out_path):
                return ("skipped", path, 0)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
                mesh = decode(blob)
                tmp = out_path + f".tmp{os.getpid()}"
                save_mesh(mesh, tmp)
                os.replace(tmp, out_path)
                return ("decoded", path, len(blob))
            except Exception as e:  # per-item isolation
                return ("failed", path, repr(e))

        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=workers) as pool:
                results = list(pool.map(one, inputs))
        else:
            results = [one(p) for p in inputs]

        for status, path, x in results:
            if status == "decoded":
                report["decoded"] += 1
                report["total_in_bytes"] += x
            elif status == "skipped":
                report["skipped"] += 1
            else:
                report["failed"].append({"path": path, "error": x})
        report["seconds"] = round(time.perf_counter() - t0, 3)
        tmp_rep = os.path.join(out_dir, f"decode_report.json.tmp{os.getpid()}")
        with open(tmp_rep, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp_rep, os.path.join(out_dir, "decode_report.json"))
        return report
