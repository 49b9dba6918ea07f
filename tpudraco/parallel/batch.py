"""Data-parallel batch encoding over a mesh corpus.

The distribution plane of SURVEY.md §2.9: independent meshes shard across
chips; per-group topology (corner table + edgebreaker + traversal) is
computed once and broadcast; the fused device step (quantize -> predict ->
residual -> zigzag) runs batched on the accelerator; encoded blobs are
gathered back in input order (the "bitstream order" contract).

Guarantee: batch output bytes are identical to per-mesh sequential
encode() — determinism is the distributed test oracle (SURVEY.md §4d).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import time

import jax
import numpy as np

from ..encode import Config, encode
from ..models import AttributeType, Mesh, TableView
from ..wire.byte_io import ByteWriter

# Narrow upload layouts (u8 / 12-bit pack) for the device batch plane;
# TPUDRACO_PACKED_UPLOAD=0 is the off-switch twin (byte-equality pinned
# by tests/test_parallel.py). See device_encode_group for the rationale.
PACKED_UPLOAD = os.environ.get("TPUDRACO_PACKED_UPLOAD", "1") != "0"


class PreparedTopology:
    """Reusable connectivity state for meshes sharing one topology: the
    connectivity byte blob, the corner tables, and per-attribute traversal
    sequences."""

    def __init__(self, mesh: Mesh, traversal: int = 0,
                 single_connectivity: bool = False) -> None:
        from ..encode.connectivity import EdgebreakerEncoder
        from ..shared.sequencer import compute_sequence

        self.signature = topology_signature(mesh)
        w = ByteWriter()
        eb = EdgebreakerEncoder(mesh.faces, mesh.attributes,
                                traversal=traversal,
                                single_connectivity=single_connectivity)
        self.conn_out = eb.encode(w)
        self.conn_bytes = w.getvalue()
        self.sequences: dict[int, list[int]] = {}
        self.normal_rings: dict[int, dict] = {}  # lazy (ops/normals.py)
        # lazy per-attribute parallelogram gather cache: the gathers are
        # a pure function of (view, sequence, unique_of_point), and the
        # signature pins all three per attribute (unique_indices() is
        # hashed in), so every mesh sharing this topology reuses them
        # (measured ~18% of warm host encode_mesh before caching)
        self.pred_gathers: dict[int, dict] = {}
        aict = self.conn_out.corner_table
        for i in range(len(mesh.attributes)):
            att_table = None
            if 0 < i <= len(aict.attribute_tables):
                att_table = aict.attribute_tables[i - 1]
            view = TableView(aict.corner_table, att_table)
            self.sequences[i] = compute_sequence(
                view, list(self.conn_out.corners_of_edgebreaker))

    def view_for(self, i: int) -> TableView:
        aict = self.conn_out.corner_table
        att_table = None
        if 0 < i <= len(aict.attribute_tables):
            att_table = aict.attribute_tables[i - 1]
        return TableView(aict.corner_table, att_table)

    def rings_for(self, i: int) -> dict:
        from ..ops.normals import collect_normal_rings
        if i not in self.normal_rings:
            self.normal_rings[i] = collect_normal_rings(
                self.view_for(i), self.sequences[i])
        return self.normal_rings[i]


def _drop_output_collisions(inputs, out_path_for):
    """Split ``inputs`` into (kept, collided): inputs whose output path
    was already claimed by an earlier input (duplicate basenames across
    directories, duplicate paths) are reported instead of silently
    overwriting the earlier result."""
    seen: dict = {}
    kept, collided = [], []
    for p in inputs:
        o = out_path_for(p)
        if o in seen:
            collided.append(p)
        else:
            seen[o] = p
            kept.append(p)
    return kept, collided


def topology_signature(mesh: Mesh) -> str:
    """Meshes share a PreparedTopology iff faces and all per-attribute
    value-dedup maps coincide."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.faces).tobytes())
    for a in mesh.attributes:
        h.update(bytes([a.att_type, a.domain, a.num_components]))
        h.update(np.ascontiguousarray(a.unique_indices()).tobytes())
    return h.hexdigest()


# default wire depths (portabilization/mod.rs:116-143): POSITION 11,
# NORMAL 8 (octahedral), TEX_COORD 10 — single source for every merge
DEFAULT_DEPTHS = {"bits": 11, "normal_bits": 8, "uv_bits": 10}
_DEPTH_TYPES = (("bits", AttributeType.POSITION),
                ("normal_bits", AttributeType.NORMAL),
                ("uv_bits", AttributeType.TEX_COORD))


def _device_quant_bits(cfg: Config | None) -> dict | None:
    """encode_meshes_device depth kwargs iff ``cfg`` differs from the
    default Config ONLY in quantization depths (the config space the
    device batch covers bit-exactly: POSITION/NORMAL/TEX_COORD ride the
    device chains at these depths, every other type's depth is honored
    by the host-side assembly) AND every depth is in-range; None
    otherwise — out-of-range depths route to the host plane so its
    canonical per-file error surfaces instead of a doomed device
    attempt per window. A None cfg is the default config."""
    import dataclasses

    if cfg is None:
        return dict(DEFAULT_DEPTHS)
    if dataclasses.replace(cfg, quant_bits={}) != Config():
        return None
    out = {k: cfg.quant_bits.get(t, DEFAULT_DEPTHS[k])
           for k, t in _DEPTH_TYPES}
    if not _depths_in_range(**out):
        return None
    return out


def _depths_in_range(bits: int, normal_bits: int, uv_bits: int) -> bool:
    """The device chains' (and the wire's) accepted depth ranges:
    normals 7..16 (OctOrthogonal mod-max ambiguity below 7 —
    portabilization.py), position/UV 1..30 (int ranges)."""
    return (7 <= normal_bits <= 16 and 1 <= bits <= 30
            and 1 <= uv_bits <= 30)


def _merged_quant_cfg(base_cfg: Config | None, bits: int,
                      normal_bits: int, uv_bits: int) -> Config | None:
    """The assembly/fallback Config for device-encoded meshes: the
    resolved depths override base_cfg's quantization entries (set when
    non-default, dropped when default — both spell identical bytes),
    every other quantization key passes through (those attributes are
    host-encoded during assembly)."""
    qb = dict(base_cfg.quant_bits) if base_cfg is not None else {}
    vals = {"bits": bits, "normal_bits": normal_bits, "uv_bits": uv_bits}
    for k, t in _DEPTH_TYPES:
        if vals[k] != DEFAULT_DEPTHS[k]:
            qb[t] = vals[k]
        else:
            qb.pop(t, None)
    return Config(quant_bits=qb) if qb else None


def encode_with_topology(mesh: Mesh, topo: PreparedTopology,
                         cfg: Config | None = None,
                         precomputed: dict | None = None) -> bytes:
    """encode() with the connectivity stage replayed from the cache (and,
    in the device batch path, attribute payloads precomputed on chip)."""
    from ..encode import _traversal_wire_id, encode_header, encode_metadata
    from ..encode.attribute import encode_attributes

    cfg = cfg or Config()
    writer = ByteWriter()
    encode_header(writer, cfg)
    if cfg.metadata:
        encode_metadata(mesh, writer)
    writer.write_bytes(topo.conn_bytes)
    encode_attributes(mesh.attributes, writer, topo.conn_out,
                      sequences=topo.sequences, precomputed=precomputed,
                      quant_bits=cfg.quant_bits,
                      symbol_coding=cfg.symbol_coding,
                      prediction=cfg.prediction,
                      transform=cfg.transform,
                      pred_cache=topo.pred_gathers,
                      attribute_traversal=_traversal_wire_id(
                          cfg.attribute_traversal))
    return writer.getvalue()


class BatchEncoder:
    """Encodes a corpus with topology-group batching and (optionally) the
    device compute step sharded over a JAX device mesh."""

    def __init__(self, use_device: bool | str = False, devices=None,
                 strict_device: bool = False, mesh_axis=None,
                 cfg: Config | None = None,
                 route_cache_path: str | None = "default") -> None:
        # use_device routes encode_corpus through the topology-grouped
        # accelerator path (encode_meshes_device); the host path is the
        # default. use_device="auto" routes PER TOPOLOGY GROUP by
        # measuring both planes in-process on a slice of the group (host
        # speed varies with the machine and its load, so a static
        # crossover constant would be wrong on some of them); decisions
        # land in routing_log and corpus reports.
        # strict_device re-raises device-path failures instead of silently
        # re-encoding on host, so a broken kernel fails tests loudly.
        # mesh_axis: a 1-D jax.sharding.Mesh with a "data" axis — the
        # device step then runs shard_map'ed data-parallel over it; output
        # bytes stay identical to the single-device/sequential paths
        # (SURVEY.md §4d determinism oracle, pinned by tests).
        # cfg: an optional encoder Config every plane honors (the
        # reference Encoder owns its ConfigType the same way). Host
        # planes apply it directly; device planes cover the
        # quantization-depth subset (_device_quant_bits) and the corpus
        # drivers route to host when cfg goes beyond it.
        if use_device not in (False, True, "auto"):
            raise ValueError(f"use_device must be bool or 'auto', "
                             f"got {use_device!r}")
        self.use_device = use_device
        self.cfg = cfg
        self.devices = devices
        self.strict_device = strict_device
        self.mesh_axis = mesh_axis
        self.fallback_groups = 0   # device groups that fell back to host
        self.fallback_meshes = 0   # meshes encoded via that fallback
        self.routing_log: list[dict] = []  # use_device="auto" decisions
        # measured routing decisions: sig -> (plane, probe basis size);
        # reused across calls/windows in the safe direction only (see
        # _route_group)
        self._plane_cache: dict[str, tuple] = {}
        # on-disk continuation of _plane_cache (decisions would otherwise
        # die with the process, so every one-shot CLI invocation would
        # re-pay the probe). route_cache_path: "default"
        # resolves TPUDRACO_ROUTE_CACHE / ~/.cache/tpudraco; None/"" off
        self._route_cache_path = (_route_cache_default_path()
                                  if route_cache_path == "default"
                                  else (route_cache_path or None))
        self._route_disk: dict | None = None
        # opportunistic throughput observations (raw position bytes /
        # wall seconds) feeding the lone-huge-mesh decision: a static
        # "huge -> device" rule mis-routes whenever the native host plane
        # is the faster one, which these estimates exist to see
        self._host_obs = [0.0, 0.0]         # bytes, seconds on host
        self._huge_dev_obs = [0.0, 0.0]     # bytes, seconds on device-huge
        self._topo_cache: dict[str, PreparedTopology] = {}
        # LRU over device-resident topology artifacts (gather arrays):
        # sig -> topo, most-recent last
        self._dev_cache: dict[str, PreparedTopology] = {}

    # device-artifact memory budget for the cached gather arrays
    DEV_CACHE_BUDGET = 2 << 30

    @staticmethod
    def _dev_topo_bytes(topo: PreparedTopology) -> int:
        n = 0
        cached = getattr(topo, "_dev_gathers", None)
        if cached is not None:
            n += sum(int(np.asarray(v).nbytes) for v in cached[0].values())
        return n

    def _dev_cache_touch(self, sig: str, topo: PreparedTopology) -> None:
        """Mark ``topo``'s device artifacts most-recently-used and evict
        least-recent ones past DEV_CACHE_BUDGET."""
        self._dev_cache.pop(sig, None)
        self._dev_cache[sig] = topo
        total = sum(self._dev_topo_bytes(t) for t in self._dev_cache.values())
        for old_sig in list(self._dev_cache):
            if total <= self.DEV_CACHE_BUDGET or old_sig == sig:
                break
            old = self._dev_cache.pop(old_sig)
            total -= self._dev_topo_bytes(old)
            old._dev_gathers = None

    def encode_mesh(self, mesh: Mesh, cfg: Config | None = None) -> bytes:
        cfg = cfg if cfg is not None else self.cfg
        sig = topology_signature(mesh)
        # the prepared connectivity bytes bake the traversal kind and the
        # single-connectivity vertex space — key the cache on them (a
        # valence/predictive/single-conn cfg previously reused STANDARD
        # connectivity silently; regression test in tests/test_parallel.py)
        key = sig
        if cfg is not None and (cfg.traversal
                                or cfg.use_single_connectivity):
            key = (sig, cfg.traversal, cfg.use_single_connectivity)
        topo = self._topo_cache.get(key)
        if topo is None:
            topo = PreparedTopology(
                mesh,
                traversal=cfg.traversal if cfg is not None else 0,
                single_connectivity=bool(cfg.use_single_connectivity)
                if cfg is not None else False)
            self._topo_cache[key] = topo
        return encode_with_topology(mesh, topo, cfg=cfg)

    # fixed device batch width: jit compiles once per (topology, CHUNK)
    # instead of once per corpus size; short groups pad up with copies.
    # One entropy call per chunk: a lax.scan words scan costs about the
    # same per step whatever its lane width, so wide chunks amortize it
    DEVICE_CHUNK = 512

    def encode_meshes_device(self, meshes: list[Mesh],
                             bits: int | None = None,
                             entropy: str = "auto",
                             normal_bits: int | None = None,
                             uv_bits: int | None = None,
                             _timings: dict | None = None
                             ) -> list[bytes | None]:
        """Device encode chain for the position attribute: meshes are
        grouped by topology; per group, quantize -> predict -> residual ->
        histogram runs batched on the accelerator (in fixed-size chunks,
        see DEVICE_CHUNK). Output bytes are identical to sequential
        encode() (determinism oracle in tests). ``bits``/``normal_bits``/
        ``uv_bits`` are the -qp/-qn/-qt depths; every device chain honors
        them (normal depths outside 7..16 raise the host path's canonical
        error). Unset depths come from ``self.cfg``, which must then be
        quantization-only (ValueError otherwise — the device batch cannot
        honor other overrides).

        ``entropy`` picks the rANS coder for the symbol payloads:
        "device" runs the multi-lane scan coder with symbols kept on
        device (only the histogram + compacted payload bytes cross to the
        host — ~3x fewer D2H bytes than shipping raw int32 symbols);
        "host" reads the symbols back and threads the C++ coder over
        meshes. "auto" (default) resolves PER GROUP: the device coder's
        rate grows with the lane count, so it takes groups of 128+
        meshes and the host coder the rest (a crossover carried over
        from the previous accelerator, not yet measured on the H100).
        CPU backends always take "host"."""
        import jax as _jax
        auto = entropy == "auto"
        if auto:
            entropy = ("device" if _jax.default_backend() != "cpu"
                       else "host")
        dflt = _device_quant_bits(self.cfg)
        if dflt is None:
            raise ValueError(
                "BatchEncoder.cfg goes beyond the device batch's config "
                "space (quantization depths only); encode these meshes "
                "on the host plane instead")
        bits = dflt["bits"] if bits is None else bits
        normal_bits = (dflt["normal_bits"] if normal_bits is None
                       else normal_bits)
        uv_bits = dflt["uv_bits"] if uv_bits is None else uv_bits
        from concurrent.futures import ThreadPoolExecutor

        from ..entropy.symbol_coding import DIRECT_CODED, encode_symbols
        from ..ops.rans_lanes import encode_group_entropy_device

        groups: dict[str, list[int]] = {}
        for idx, m in enumerate(meshes):
            groups.setdefault(topology_signature(m), []).append(idx)

        if not _depths_in_range(bits, normal_bits, uv_bits):
            raise ValueError(
                f"quantization depths out of range (position {bits}, "
                f"normal {normal_bits} [7..16], texcoord {uv_bits})")
        # keep the host-side portabilization metadata (and any host
        # fallback re-encode) at the same bit depths the device
        # quantizes with; self.cfg's OTHER quantization keys (e.g. -qg's
        # COLOR/TANGENT/WEIGHT) pass through — those attributes are
        # host-encoded during assembly
        cfg = _merged_quant_cfg(self.cfg, bits, normal_bits, uv_bits)

        out: list[bytes | None] = [None] * len(meshes)
        for sig, idxs in groups.items():
            # per-group auto resolution: the device coder's rate grows
            # with the lane count; 128 lanes is the crossover
            group_entropy = entropy
            if auto and entropy == "device" and len(idxs) < 128:
                group_entropy = "host"
            try:
                topo = self._topo_cache.get(sig)
                if topo is None:
                    topo = PreparedTopology(meshes[idxs[0]])
                    self._topo_cache[sig] = topo
                pos_atts = [meshes[i].position_attribute() for i in idxs]
                batch = np.stack([a.values.astype(np.float32)
                                  for a in pos_atts])
                # pad to a whole number of fixed-width chunks so the jitted
                # step compiles once per (topology, chunk), not once per
                # corpus size. Chunks bucket to powers of two up to
                # DEVICE_CHUNK (<= log2(64) compiled shapes per topology)
                # so a 3-mesh group of huge meshes pads to 4 slots, not 64.
                # Under a data-parallel mesh the chunk must also divide by
                # the axis size (lcm covers non-power-of-2 axes).
                n = len(idxs)
                chunk = 1
                while chunk < min(n, self.DEVICE_CHUNK):
                    chunk *= 2
                if self.mesh_axis is not None:
                    import math
                    dp = int(np.prod(self.mesh_axis.devices.shape))
                    chunk = math.lcm(chunk, dp)
                n_pad = -(-n // chunk) * chunk
                if n_pad != n:
                    batch = np.concatenate(
                        [batch, np.repeat(batch[:1], n_pad - n, axis=0)])
                payloads, vmins, vmaxs = [], [], []
                minss, deltas, qs = [], [], []

                def consume(dev_c):
                    # sync point: everything here reads the chunk back,
                    # overlapping the NEXT chunk's step already queued on
                    # the device (double-buffered dispatch below)
                    if group_entropy == "device":
                        # symbols stay on device; only the histogram +
                        # compacted bytes cross to the host. Under a device
                        # mesh the word scan shards over lanes too — the
                        # WHOLE pipeline (step + entropy) scales across
                        # chips, bytes unchanged (oracle in tests/dryrun)
                        payloads.extend(encode_group_entropy_device(
                            dev_c["symbols"], dev_c["counts"],
                            mesh_axis=self.mesh_axis, _timings=_timings))
                    else:
                        # zigzag residuals < 2^(bits+1): a u16 device cast
                        # halves the symbol readback bytes
                        syms_dev = dev_c["symbols"]
                        if bits + 1 <= 16:
                            import jax.numpy as jnp
                            syms_dev = syms_dev.astype(jnp.uint16)
                        syms_np = np.asarray(syms_dev).astype(np.uint64)

                        def one(sym):
                            w = ByteWriter()
                            encode_symbols(sym.ravel(), sym.shape[-1],
                                           DIRECT_CODED, w)
                            return w.getvalue()

                        with ThreadPoolExecutor(max_workers=8) as pool:
                            payloads.extend(pool.map(one, syms_np))
                    # host-resident already (quantization runs on host)
                    vmins.append(dev_c["vmin"])
                    vmaxs.append(dev_c["vmax"])
                    minss.append(dev_c["mins"])
                    deltas.append(dev_c["delta_max"])
                    qs.append(dev_c["q"])

                pending = None
                for c0 in range(0, n_pad, chunk):
                    cur = device_encode_group(
                        batch[c0:c0 + chunk], topo, pos_atts[0],
                        bits=bits, mesh_axis=self.mesh_axis,
                        return_device=True, _timings=_timings)
                    if pending is not None:
                        consume(pending)
                    pending = cur
                if pending is not None:
                    consume(pending)
                t_asm = time.time()

                def cat(parts):
                    # single-chunk groups (the common production shape):
                    # a view, not a 25 MB concatenate copy
                    return (parts[0] if len(parts) == 1
                            else np.concatenate(parts))[:n]

                dev = {"vmin": cat(vmins), "vmax": cat(vmaxs),
                       "mins": cat(minss), "delta_max": cat(deltas)}
                q_all = cat(qs)
                payloads = payloads[:n]
                # NORMAL and TEX_COORD attributes ride the device too
                # (ops/normals.py ring chain, ops/texcoords.py UV chain)
                normal_pre = _device_extra_attribute_entries(
                    meshes, idxs, topo, bits=bits, chunk=chunk,
                    normal_bits=normal_bits, uv_bits=uv_bits,
                    mesh_axis=self.mesh_axis)
                bits_byte = bytes([bits])
                for k, i in enumerate(idxs):
                    w = ByteWriter()
                    w.write_u32(int(dev["vmin"][k]) & 0xFFFFFFFF)
                    w.write_u32(int(dev["vmax"][k]) & 0xFFFFFFFF)
                    pos_idx = next(
                        j for j, a in enumerate(meshes[i].attributes)
                        if a.att_type == AttributeType.POSITION)
                    # quantization already ran (vectorized, host): hand the
                    # assembly its metadata bytes + port values so
                    # portabilize is skipped per mesh (it re-quantized the
                    # whole attribute — the dominant assembly cost)
                    port_meta = (dev["mins"][k].astype("<f4").tobytes()
                                 + dev["delta_max"][k:k + 1]
                                 .astype("<f4").tobytes() + bits_byte)
                    pre = {pos_idx: {"payload": payloads[k],
                                     "xform_meta": bytes(w.getvalue()),
                                     "port_meta": port_meta,
                                     "port_values": q_all[k]}}
                    pre.update(normal_pre.get(k, {}))
                    out[i] = encode_with_topology(meshes[i], topo, cfg=cfg,
                                                  precomputed=pre)
                if _timings is not None:
                    _timings["assembly"] = (_timings.get("assembly", 0.0)
                                            + time.time() - t_asm)
                # keep the device-resident gathers for the next call
                # instead of re-uploading them per call. A bytes-bounded
                # LRU keeps device memory from growing with every
                # distinct topology.
                self._dev_cache_touch(sig, topo)
            except Exception:
                if self.strict_device:
                    raise
                # per-group error isolation: fall back to the host path
                # at the SAME depths (counted, so corpus reports surface
                # device regressions)
                self.fallback_groups += 1
                for i in idxs:
                    try:
                        out[i] = self.encode_mesh(meshes[i], cfg=cfg)
                        self.fallback_meshes += 1
                    except Exception:
                        out[i] = None
        return out

    # auto-routing knobs: groups smaller than MIN_DEVICE_GROUP never pay
    # the device dispatch overhead unless the meshes are huge; huge single
    # meshes (>= CHUNKED_MIN_VERTS) take the resident device path when
    # they fit RESIDENT_MAX_VERTS, the chunked streaming path beyond;
    # groups whose full host cost undercuts a device probe's fixed
    # dispatch+readback overhead (PROBE_SKIP_S) skip the probe; probes
    # run on a PROBE_CHUNK-wide device batch. The constants were set on
    # the previous accelerator and are not yet measured on the H100.
    MIN_DEVICE_GROUP = 16
    CHUNKED_MIN_VERTS = 1 << 17
    # resident single-mesh budget: positions + gather indices + symbols
    # cost ~50 B/vert on device (~800 MB at the cap); beyond it the
    # O(chunk) streaming path bounds device memory instead
    RESIDENT_MAX_VERTS = 1 << 24
    PROBE_SKIP_S = 0.5
    PROBE_CHUNK = 16

    def encode_meshes_auto(self, meshes: list[Mesh]) -> list[bytes | None]:
        """Per-topology-group host/device routing by IN-PROCESS
        measurement: time the host plane on a few meshes and the device
        plane on one chunk of the same group, then route the remainder to
        the faster plane. Both planes produce identical bytes (the batch
        determinism oracle), so mixing is safe; the probe outputs are
        kept, not discarded. Decisions are recorded in ``routing_log``
        (surfaced in corpus reports)."""
        groups: dict[str, list[int]] = {}
        for idx, m in enumerate(meshes):
            groups.setdefault(topology_signature(m), []).append(idx)

        out: list[bytes | None] = [None] * len(meshes)
        for sig, idxs in groups.items():
            try:
                self._route_group(meshes, idxs, sig, out)
            except Exception:
                # per-group isolation (mirrors encode_meshes_device): a
                # malformed group falls back to per-mesh host encodes
                for i in idxs:
                    if out[i] is None:
                        out[i] = self._encode_one_safe(meshes[i])
                self.routing_log.append(
                    {"group": sig[:12], "meshes": len(idxs),
                     "plane": "host", "reason": "group error"})
        return out

    def _route_group(self, meshes, idxs, sig, out) -> None:
        n = len(idxs)
        v = int(meshes[idxs[0]].position_attribute().num_points)
        entry = {"group": sig[:12], "meshes": n, "verts": v}
        if n == 1:
            # a lone mesh cannot be probed without doing the work
            # twice: huge meshes take the resident device path
            # (chunked streaming beyond RESIDENT_MAX_VERTS), the
            # rest stay host — UNLESS measured throughput estimates
            # (this process or the disk cache) say the other plane
            # is faster
            huge = v >= (self.CHUNKED_MIN_VERTS << 2)
            reason = "single mesh (static)"
            if huge:
                est_h = self._mbs_estimate("host")
                est_d = self._mbs_estimate("huge_device")
                if est_h and est_d:
                    # estimates from other processes are coarse —
                    # only a 2x+ gap overrides the static rule
                    if est_h > 2 * est_d:
                        huge = False
                    elif est_d > 2 * est_h:
                        huge = True
                    reason = (f"single mesh (measured: device "
                              f"{est_d:.1f} vs host {est_h:.1f} MB/s)")
            m = meshes[idxs[0]]
            nbytes = int(m.position_attribute().values.nbytes)
            t0 = time.perf_counter()
            out[idxs[0]] = (self._encode_huge_safe(m) if huge
                            else self._encode_one_safe(m))
            dt = time.perf_counter() - t0
            if out[idxs[0]] is not None and dt > 0:
                self._note_mbs("huge_device" if huge else "host",
                               nbytes, dt)
            entry.update(plane="device" if huge else "host",
                         reason=reason)
            self.routing_log.append(entry)
            return
        if n < self.MIN_DEVICE_GROUP and v < self.CHUNKED_MIN_VERTS:
            for i in idxs:
                out[i] = self._encode_one_safe(meshes[i])
            entry.update(plane="host", reason="small group")
            self.routing_log.append(entry)
            return
        # in-process decision cache: corpus windows and repeated runs
        # re-encounter the same topology group — re-probing each time
        # (a fixed device dispatch per probe) would dominate repeated
        # mixed-corpus walls. A device decision generalizes UP in
        # group size (fixed costs amortize further), a host decision
        # DOWN — reuse only in the safe direction.
        cached = self._plane_cache.get(sig)
        source = "memory"
        if cached is None and self._route_cache_path:
            disk = self._route_cache_load().get(sig)
            if disk is not None:
                cached = (disk["plane"], int(disk["n_basis"]))
                source = "disk"
        if cached is not None:
            plane, n_basis = cached
            if (plane == "device" and n >= n_basis) \
                    or (plane == "host" and n <= 2 * n_basis):
                if source == "disk":
                    self._plane_cache[sig] = cached
                if plane == "device":
                    for i, blob in zip(idxs, self.encode_meshes_device(
                            [meshes[i] for i in idxs])):
                        out[i] = blob
                    for i in idxs:
                        if out[i] is None:
                            out[i] = self._encode_one_safe(meshes[i])
                else:
                    for i in idxs:
                        out[i] = self._encode_one_safe(meshes[i])
                entry.update(plane=plane,
                             reason=f"cached decision ({source})")
                self.routing_log.append(entry)
                return
        # probe: host on a few meshes (one, if they are huge) vs the
        # device batch on one small pow2-bucketed chunk of the group
        k = 1 if v >= self.CHUNKED_MIN_VERTS else min(4, n - 1)
        t0 = time.perf_counter()
        for i in idxs[:k]:
            out[i] = self._encode_one_safe(meshes[i])
        th = (time.perf_counter() - t0) / k
        self._note_mbs(
            "host",
            k * int(meshes[idxs[0]].position_attribute().values.nbytes),
            th * k)
        if th * (n - k) < self.PROBE_SKIP_S:
            # the whole group costs less on host than a device probe's
            # fixed dispatch+readback overhead could ever recoup
            for i in idxs[k:]:
                out[i] = self._encode_one_safe(meshes[i])
            entry.update(plane="host", reason="group cheaper than "
                         "probe", host_s_per_mesh=round(th, 4))
            self.routing_log.append(entry)
            return
        # probe width scales with the group: the device pipeline has a
        # fixed dispatch/sync cost, so a 16-mesh probe reads pessimistic
        # for a 512-mesh group (its fixed cost amortizes 32x further).
        # A quarter of the group (capped at
        # 128 lanes — the entropy-auto threshold, so the probe runs
        # the same plane the full group would) keeps the probe cheap
        # while pricing the amortization honestly.
        probe_w = min(max(self.PROBE_CHUNK, n // 4), 128, n - k)
        chunk_ids = idxs[k:k + probe_w]
        fb0 = self.fallback_groups
        t0 = time.perf_counter()
        dev_blobs = self.encode_meshes_device(
            [meshes[i] for i in chunk_ids])
        td = (time.perf_counter() - t0) / len(chunk_ids)
        for i, blob in zip(chunk_ids, dev_blobs):
            if blob is not None:
                out[i] = blob
        rest = [i for i in idxs if out[i] is None]
        # only THIS group's probe failures veto its device routing —
        # a cumulative check would let one bad group disable the
        # device plane for the rest of the corpus
        probe_failed = self.fallback_groups > fb0
        use_dev = td < th and not probe_failed
        if use_dev and rest:
            for i, blob in zip(rest, self.encode_meshes_device(
                    [meshes[i] for i in rest])):
                out[i] = blob
        for i in rest:
            if out[i] is None:
                out[i] = self._encode_one_safe(meshes[i])
        entry.update(plane="device" if use_dev else "host",
                     host_s_per_mesh=round(th, 4),
                     device_s_per_mesh=round(td, 4))
        if probe_failed:
            entry["reason"] = "device probe fell back"
        else:
            # remember the measured outcome for this topology (see the
            # reuse rule above); failed probes never cache. The disk
            # copy survives the process so one-shot CLI runs skip the
            # probe (TTL'd)
            self._plane_cache[sig] = (
                "device" if use_dev else "host", probe_w + k)
            self._route_cache_store(
                sig, "device" if use_dev else "host", probe_w + k,
                th, td)
        self.routing_log.append(entry)

    def _route_cache_load(self) -> dict:
        """Unexpired entries of the on-disk routing cache ({} when the
        cache is disabled, missing, or unreadable)."""
        if self._route_disk is not None:
            return self._route_disk
        self._route_disk = {}
        p = self._route_cache_path
        if p:
            try:
                with open(p) as f:
                    data = json.load(f)
                if isinstance(data, dict) and data.get("v") == 1:
                    now = time.time()
                    self._route_disk = {
                        k: e for k, e in data.get("entries", {}).items()
                        if isinstance(e, dict)
                        and now - float(e.get("ts", 0)) < ROUTE_CACHE_TTL_S}
            except Exception:
                pass
        return self._route_disk

    def _route_cache_persist(self, key: str, entry: dict) -> None:
        """Write one entry into the on-disk cache (atomic rename; failures
        are silent — the cache is an optimization, never a dependency)."""
        p = self._route_cache_path
        if not p:
            return
        try:
            entries = dict(self._route_cache_load())
            entries[key] = entry
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
            tmp = f"{p}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"v": 1, "entries": entries}, f)
            os.replace(tmp, p)
            self._route_disk = entries
        except Exception:
            pass

    def _route_cache_store(self, sig: str, plane: str, n_basis: int,
                           th: float, td: float) -> None:
        """Persist a freshly measured routing decision."""
        self._route_cache_persist(
            sig,
            {"plane": plane, "n_basis": int(n_basis),
             "host_s_per_mesh": round(th, 5),
             "device_s_per_mesh": round(td, 5), "ts": time.time()})

    def _note_mbs(self, kind: str, nbytes: int, seconds: float) -> None:
        """Accumulate a throughput observation (raw position bytes / wall
        seconds); persist when the evidence roughly doubles (the first
        draft rewrote the cache file on EVERY observation past 1 MB —
        one disk rewrite per lone mesh on large corpora, review-found).
        kind: "host" (any host-plane encode) or "huge_device" (the
        resident/chunked lone-huge route)."""
        obs = self._host_obs if kind == "host" else self._huge_dev_obs
        obs[0] += float(nbytes)
        obs[1] += float(seconds)
        if len(obs) == 2:
            obs.append(0.0)  # bytes total at last persist
        if obs[0] >= 1e6 and obs[1] > 0.05 and obs[0] >= 2 * obs[2]:
            obs[2] = obs[0]
            self._route_cache_persist(
                f"__mbs__|{kind}",
                {"mbs": round(obs[0] / obs[1] / 1e6, 2),
                 "ts": time.time()})

    def _mbs_estimate(self, kind: str) -> float | None:
        """In-process observation first (same window beats any cache),
        then the TTL'd disk record."""
        obs = self._host_obs if kind == "host" else self._huge_dev_obs
        if obs[0] >= 1e6 and obs[1] > 0.05:
            return obs[0] / obs[1] / 1e6
        e = self._route_cache_load().get(f"__mbs__|{kind}")
        if e and e.get("mbs"):
            return float(e["mbs"])
        return None

    def _encode_one_safe(self, mesh: Mesh) -> bytes | None:
        try:
            return self.encode_mesh(mesh)
        except Exception:
            return None

    def _encode_huge_safe(self, mesh: Mesh) -> bytes | None:
        """Single-huge-mesh device route: resident when the mesh fits the
        device-memory budget, chunked streaming beyond it; a resident
        failure falls through to the chunked twin (then host) with the
        fallback counted."""
        v = int(mesh.position_attribute().num_points)
        if v > self.RESIDENT_MAX_VERTS:
            return self._encode_chunked_safe(mesh)
        try:
            return self.encode_mesh_device(mesh)
        except Exception:
            if self.strict_device:
                raise
            self.fallback_groups += 1
            return self._encode_chunked_safe(mesh)

    def _encode_chunked_safe(self, mesh: Mesh) -> bytes | None:
        try:
            return self.encode_mesh_device_chunked(mesh)
        except Exception:
            if self.strict_device:
                raise
            # surface the fallback in the corpus counters (same invariant
            # as encode_meshes_device: a broken kernel must not hide
            # behind correct-but-slow host re-encodes)
            self.fallback_groups += 1
            blob = self._encode_one_safe(mesh)
            if blob is not None:
                self.fallback_meshes += 1
            return blob

    def _topo_for(self, mesh: Mesh) -> PreparedTopology:
        sig = topology_signature(mesh)
        topo = self._topo_cache.get(sig)
        if topo is None:
            topo = PreparedTopology(mesh)
            self._topo_cache[sig] = topo
        return topo

    def _assemble_precomputed(self, mesh: Mesh, topo: PreparedTopology,
                              symbols: np.ndarray, vmin: int, vmax: int,
                              bits: int,
                              extra_pre: dict | None = None) -> bytes:
        """Final .drc assembly from device-produced position symbols +
        wrapped-difference range (byte-identical to the host path).
        ``extra_pre`` carries additional per-attribute precomputed entries
        (the resident route's device normal/UV chains)."""
        from ..entropy.symbol_coding import DIRECT_CODED, encode_symbols

        w = ByteWriter()
        encode_symbols(symbols.astype(np.uint64).ravel(),
                       symbols.shape[-1], DIRECT_CODED, w)
        payload = w.getvalue()
        meta = ByteWriter()
        meta.write_u32(int(vmin) & 0xFFFFFFFF)
        meta.write_u32(int(vmax) & 0xFFFFFFFF)
        pos_idx = next(j for j, a in enumerate(mesh.attributes)
                       if a.att_type == AttributeType.POSITION)
        # attributes without a precomputed entry encode host-side inside
        # encode_with_topology, so self.cfg's other quantization depths
        # are honored here
        dflt = _device_quant_bits(self.cfg) or dict(DEFAULT_DEPTHS)
        cfg = _merged_quant_cfg(self.cfg, bits, dflt["normal_bits"],
                                dflt["uv_bits"])
        pre = {pos_idx: {"payload": payload,
                         "xform_meta": bytes(meta.getvalue())}}
        if extra_pre:
            pre.update(extra_pre)
        return encode_with_topology(mesh, topo, cfg=cfg, precomputed=pre)

    def encode_mesh_device(self, mesh: Mesh, bits: int | None = None
                           ) -> bytes:
        """Single-mesh device encode with RESIDENT positions and gather
        indices (O(V) device memory, cached per topology): one H2D of the
        positions, the fused quantize/predict/residual step on device, one
        D2H of the uint16 residual symbols, host C++ entropy + assembly.
        This is the fast single-huge-mesh plane — the streaming twin
        (encode_mesh_device_chunked) re-uploads every traversal row from
        host (5 x 12 B/row vs 12 B/vert once
        here) to bound device memory at O(chunk) instead. Output bytes
        are identical to host encode() (pinned by tests)."""
        bits = self._resolve_pos_bits(bits)
        import jax.numpy as jnp

        topo = self._topo_for(mesh)
        pos_att = mesh.position_attribute()
        pos = np.ascontiguousarray(pos_att.values, np.float32)[None]
        dev = device_encode_group(pos, topo, pos_att, bits=bits,
                                  return_device=True)
        syms = dev["symbols"][0]
        if bits + 1 <= 16:  # zigzag symbols < 2^(bits+1): halve the D2H
            syms = syms.astype(jnp.uint16)
        # NORMAL/TEX_COORD chains ride the device too (the same batch
        # chains, B=1): a huge mesh with normals + UVs no longer pays the
        # sequential host chains for them. The
        # symbols readback below is queued AFTER these chains' dispatches,
        # so their device compute overlaps nothing extra.
        dflt = _device_quant_bits(self.cfg) or dict(DEFAULT_DEPTHS)
        extra = _device_extra_attribute_entries(
            [mesh], [0], topo, bits=bits, chunk=1,
            normal_bits=dflt["normal_bits"], uv_bits=dflt["uv_bits"])
        # exactly ONE readback for positions (the symbols): quantization
        # runs on host now, so the range pair is already host-resident
        vmin, vmax = int(dev["vmin"][0]), int(dev["vmax"][0])
        blob = self._assemble_precomputed(mesh, topo, np.asarray(syms),
                                          int(vmin), int(vmax), bits,
                                          extra_pre=extra.get(0))
        self._dev_cache_touch(topology_signature(mesh), topo)
        return blob

    def encode_mesh_device_chunked(self, mesh: Mesh, bits: int | None = None,
                                   chunk: int = 1 << 15) -> bytes:
        """Single-huge-mesh streaming encode (SURVEY §5.7): the device only
        ever holds O(chunk) rows — pass 1 streams vertex chunks for the
        global quantization range, pass 2 for the global residual range,
        pass 3 streams traversal segments (pre-gathered rows from host)
        through the fused quantize/predict/residual/histogram kernel.
        Output bytes are identical to host encode() (pinned by tests)."""
        bits = self._resolve_pos_bits(bits)
        import jax.numpy as jnp

        from ..ops import (default_hist_bins, encode_step_chunk,
                           minmax_chunk_kernel, quantized_range_chunk_kernel)

        topo = self._topo_for(mesh)
        pos_att = mesh.position_attribute()
        pos = np.ascontiguousarray(pos_att.values, dtype=np.float32)
        g = topology_gathers_np(topo, pos_att)
        V, N = pos.shape
        T = len(g["order"])

        def vertex_chunks():
            for c0 in range(0, V, chunk):
                rows = pos[c0:c0 + chunk]
                if len(rows) < chunk:  # pad by replicating a real row
                    rows = np.concatenate(
                        [rows, np.broadcast_to(pos[:1],
                                               (chunk - len(rows), N))])
                yield jnp.asarray(rows)

        # pass 1: global min/max (exact reduces; float32 throughout,
        # matching quantize_kernel's zero-seeded range semantics).
        # DISPATCH every chunk before the first readback: per-chunk syncs
        # would serialize a round trip per chunk (the per-chunk results
        # are tiny)
        mins = np.full(N, np.inf, np.float32)
        maxs = np.full(N, -np.inf, np.float32)
        jobs = [minmax_chunk_kernel(rows) for rows in vertex_chunks()]
        for mn, mx in jobs:
            mins = np.minimum(mins, np.asarray(mn))
            maxs = np.maximum(maxs, np.asarray(mx))
        mins = np.minimum(mins, np.float32(0)).astype(np.float32)
        maxs = np.maximum(maxs, np.float32(0)).astype(np.float32)
        delta_max = np.float32(np.max((maxs - mins).astype(np.float32)))
        jmins = jnp.asarray(mins)
        jdelta = jnp.asarray(delta_max)

        # pass 2: global residual (quantized-value) range, dispatch-ahead
        vmin, vmax = np.iinfo(np.int32).max, np.iinfo(np.int32).min
        jobs = [quantized_range_chunk_kernel(rows, jmins, jdelta, bits)
                for rows in vertex_chunks()]
        for lo, hi in jobs:
            vmin = min(vmin, int(lo))
            vmax = max(vmax, int(hi))

        # pass 3: traversal segments, pre-gathered on host
        hist_bins = default_hist_bins(bits)
        counts = np.zeros(hist_bins, np.int64)
        sym_parts = []
        order, nxt, prv = g["order"], g["next"], g["prev"]
        opp, fb = g["opp"], g["fallback"]
        can_para = np.asarray(g["can_para"], bool)
        has_fb = np.asarray(g["has_fallback"], bool)
        pending = None
        for t0 in range(0, T, chunk):
            t1 = min(t0 + chunk, T)
            n_valid = t1 - t0

            def rows_of(idx):
                r = pos[idx[t0:t1]]
                if n_valid < chunk:
                    r = np.concatenate(
                        [r, np.zeros((chunk - n_valid, N), np.float32)])
                return jnp.asarray(r)

            def mask_of(m):
                r = m[t0:t1]
                if n_valid < chunk:
                    r = np.concatenate([r, np.zeros(chunk - n_valid, bool)])
                return jnp.asarray(r)

            active = np.zeros(chunk, bool)
            active[:n_valid] = True
            cur = encode_step_chunk(
                rows_of(order), rows_of(nxt), rows_of(prv), rows_of(opp),
                rows_of(fb), mask_of(can_para), mask_of(has_fb),
                jnp.asarray(active), jmins, jdelta, vmin, vmax,
                bits=bits, hist_bins=hist_bins)
            # consume the PREVIOUS chunk while this one computes
            # (double-buffered dispatch: the readback overlaps the next
            # chunk's device work)
            if pending is not None:
                sym, cnt, nv = pending
                counts += np.asarray(cnt, dtype=np.int64)
                sym_parts.append(np.asarray(sym)[:nv])
            pending = (*cur, n_valid)
        if pending is not None:
            sym, cnt, nv = pending
            counts += np.asarray(cnt, dtype=np.int64)
            sym_parts.append(np.asarray(sym)[:nv])

        symbols = (np.concatenate(sym_parts) if sym_parts
                   else np.zeros((0, N), np.uint32))
        assert int(counts.sum()) == T * N, "chunked histogram lost symbols"
        return self._assemble_precomputed(mesh, topo, symbols, vmin, vmax,
                                          bits)

    def _resolve_pos_bits(self, bits: int | None) -> int:
        """Position depth for the single-mesh device paths: explicit arg
        wins; otherwise self.cfg's -qp (the cfg must be quantization-only
        — other overrides cannot ride the precomputed-positions
        assembly)."""
        dflt = _device_quant_bits(self.cfg)
        if dflt is None:
            raise ValueError(
                "BatchEncoder.cfg goes beyond the device chains' config "
                "space (quantization depths only); encode this mesh on "
                "the host plane instead")
        return dflt["bits"] if bits is None else bits

    def encode_mesh_device_stream_sharded(self, mesh: Mesh, device_mesh,
                                          bits: int | None = None) -> bytes:
        """Single-mesh cross-chip encode: the traversal (residual stream)
        shards over a 1-D ("stream",) device mesh — each chip computes its
        segment of the fused step from replicated positions; the histogram
        all-reduces over the stream axis (table broadcast). Bytes identical
        to host encode() (SURVEY §4d oracle, pinned by tests)."""
        bits = self._resolve_pos_bits(bits)
        import jax
        import jax.numpy as jnp

        topo = self._topo_for(mesh)
        pos_att = mesh.position_attribute()
        g = topology_gathers_np(topo, pos_att)
        sp = int(np.prod(device_mesh.devices.shape))
        T = len(g["order"])
        T_pad = -(-max(T, 1) // sp) * sp
        gp = {}
        for k, v in g.items():
            pad = np.zeros(T_pad - T, dtype=v.dtype)
            gp[k] = jnp.asarray(np.concatenate([v, pad]))
        pos = jnp.asarray(pos_att.values.astype(np.float32))[None]

        syms, vmin, vmax, _counts = _jit_step_stream_sharded(
            pos, gp, bits, device_mesh)
        symbols = np.asarray(syms)[0][:T]
        return self._assemble_precomputed(mesh, topo, symbols,
                                          int(vmin[0]), int(vmax[0]), bits)

    def encode_meshes(self, meshes: list[Mesh]) -> list[bytes | None]:
        """Per-mesh error isolation: a failing mesh yields None and does not
        abort the batch (SURVEY.md §5.3)."""
        out: list[bytes | None] = []
        for m in meshes:
            try:
                out.append(self.encode_mesh(m))
            except Exception:
                out.append(None)
        return out

    # device-corpus window: meshes resident on host at once (O(window)
    # memory; topology groups still batch within a window and the topology
    # cache persists across windows)
    DEVICE_CORPUS_WINDOW = 256

    def encode_corpus(self, inputs: list[str], out_dir: str,
                      resume: bool = True, workers: int = 1,
                      device_window: int | None = None) -> dict:
        """File-level corpus driver with resume (skip existing outputs) and
        per-mesh error isolation. ``workers`` > 1 encodes files on a thread
        pool — the C++ topology/entropy passes release the GIL, so this
        scales across host cores. With use_device, inputs stream through
        the chip in windows of ``device_window`` meshes (default
        DEVICE_CORPUS_WINDOW) so a large corpus never loads fully into host
        RAM; output bytes are identical to the all-at-once path (same
        per-group encoding, windows only bound the batch width). Returns a
        report dict."""
        from ..io import load_mesh

        os.makedirs(out_dir, exist_ok=True)
        report = {"encoded": 0, "skipped": 0, "failed": [],
                  "total_in_bytes": 0, "total_out_bytes": 0}
        t0 = time.perf_counter()

        def out_path_for(path):
            name = os.path.splitext(os.path.basename(path))[0] + ".drc"
            return os.path.join(out_dir, name)

        # output names key on the basename: a second input mapping to the
        # same name would silently overwrite the first and corrupt resume
        # accounting — report it instead
        inputs, name_collisions = _drop_output_collisions(inputs,
                                                          out_path_for)
        for path in name_collisions:
            report["failed"].append(
                {"path": path, "error": "output name collision"})

        device_blobs: dict[str, bytes | None] = {}
        # a cfg beyond the device chains' quantization-depth space routes
        # the whole corpus to the host plane (which honors every option)
        dev_plane = (self.use_device
                     and _device_quant_bits(self.cfg) is not None)
        if self.use_device and not dev_plane:
            report["device_disabled_by_cfg"] = True
        if dev_plane:
            # stream in bounded windows: load W meshes, device-batch them
            # by topology group, keep only the (small) encoded blobs —
            # skipping inputs whose outputs already exist (resume), so a
            # resumed run doesn't redo (and discard) the device batch
            W = device_window or self.DEVICE_CORPUS_WINDOW
            pending = [p for p in inputs
                       if not (resume and os.path.isfile(out_path_for(p)))]
            for w0 in range(0, len(pending), W):
                loadable, load_meshes = [], []
                for path in pending[w0:w0 + W]:
                    try:
                        load_meshes.append(load_mesh(path))
                        loadable.append(path)
                    except Exception:
                        pass  # per-file isolation below re-reports it
                blobs = (self.encode_meshes_auto(load_meshes)
                         if self.use_device == "auto"
                         else self.encode_meshes_device(load_meshes))
                device_blobs.update(zip(loadable, blobs))

        def one(path):
            out_path = out_path_for(path)
            if resume and os.path.isfile(out_path):
                return ("skipped", path, 0, 0)
            try:
                blob = device_blobs.get(path)
                if blob is None:
                    blob = self.encode_mesh(load_mesh(path))
                tmp = out_path + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, out_path)
                return ("encoded", path, os.path.getsize(path), len(blob))
            except Exception as e:  # error isolation
                return ("failed", path, repr(e), 0)

        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=workers) as pool:
                results = list(pool.map(one, inputs))
        else:
            results = [one(p) for p in inputs]

        for status, path, a, b in results:
            if status == "encoded":
                report["encoded"] += 1
                report["total_in_bytes"] += a
                report["total_out_bytes"] += b
            elif status == "skipped":
                report["skipped"] += 1
            else:
                report["failed"].append({"path": path, "error": a})
        report["seconds"] = round(time.perf_counter() - t0, 3)
        if self.use_device:
            # surface silent device->host fallbacks (a broken kernel must
            # not hide behind correct-but-slow host re-encodes)
            report["device_fallback_groups"] = self.fallback_groups
            report["device_fallback_meshes"] = self.fallback_meshes
            if self.use_device == "auto":
                report["routing"] = self.routing_log
        tmp_rep = os.path.join(out_dir, f"corpus_report.json.tmp{os.getpid()}")
        with open(tmp_rep, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp_rep, os.path.join(out_dir, "corpus_report.json"))
        return report


@functools.partial(jax.jit, static_argnames=("bits",))
def _jit_quantize(pos, bits):
    from ..ops import quantize_kernel
    return quantize_kernel(pos, bits)


@jax.jit
def _jit_unpack12(lo, hb):
    from ..ops import unpack12_kernel
    return unpack12_kernel(lo, hb)


@jax.jit
def _jit_widen(x):
    import jax.numpy as jnp
    return x.astype(jnp.int32)


def _host_quantized_upload(batch: np.ndarray, bits: int):
    """Host-quantize a (B, V, C) float32 batch (canonical formula — the
    native fused kernel with the numpy twin as fallback) and upload the
    NARROWEST layout the depth allows, exactly like device_encode_group's
    position upload: u8 at bits<=8, the 12-bit pack at bits<=12, u16
    otherwise. Returns the device int32 quantized array.

    The extra-attribute chains (_device_extra_attribute_entries)
    previously uploaded raw float32 and quantized on device — a SECOND
    full-size upload of the positions the main path had already
    quantized. The
    device quantize_kernel was built to match the host formula
    bit-for-bit, so swapping the producer cannot change any byte
    (oracles in tests/test_parallel.py).

    Returns None when the batch holds non-finite values (callers route
    the attribute to the host path, whose portabilize raises the
    canonical error — the old device quantize silently encoded garbage
    from NaN here) or when bits > 16 (caller keeps the f32 upload)."""
    import jax.numpy as jnp

    if bits > 16:
        return None
    from ..native import quantize_batch as _nq
    got = _nq(batch, bits)
    if got is not None:
        q_up = got[0]
    else:
        if not np.isfinite(batch).all():
            return None
        q_up = quantize_positions_host(batch, bits)[0].astype(np.uint16)
    if PACKED_UPLOAD and bits <= 8:
        return _jit_widen(jnp.asarray(q_up.astype(np.uint8)))
    if PACKED_UPLOAD and bits <= 12:
        from ..native import pack12 as _pack12
        lo, hb = _pack12(q_up)  # lo keeps (B, V, C); nibbles pair per row
        return _jit_unpack12(jnp.asarray(lo), jnp.asarray(hb))
    return _jit_widen(jnp.asarray(q_up))


def _attribute_eligible(meshes, idxs, att_idx, pos_id, n_comp):
    """Device-chain eligibility shared by the normal and UV entries: the
    attribute must be float32 with the expected component count IN EVERY
    mesh of the group (topology_signature does not hash dtype) and must be
    parented to the group's position attribute (the device chains predict
    from it, matching the host's parents[0])."""
    a0 = meshes[idxs[0]].attributes[att_idx]
    if a0.num_components != n_comp or a0.parents != [pos_id]:
        return False
    return all(meshes[i].attributes[att_idx].values.dtype == np.float32
               for i in idxs)


def _device_extra_attribute_entries(meshes, idxs, topo: PreparedTopology,
                                    bits: int, chunk: int,
                                    normal_bits: int = 8,
                                    uv_bits: int = 10,
                                    mesh_axis=None) -> dict:
    """Device-encode the NORMAL (ops/normals.py) and TEX_COORD
    (ops/texcoords.py) attributes of a topology group. Positions quantize
    ONCE per chunk and feed every chain. Returns
    {position-in-idxs: {att_idx: {"payload", "xform_meta"}}}; ineligible
    attributes (or individual "risky"/degenerate meshes) are simply
    absent and take the host path."""
    import jax.numpy as jnp

    from ..entropy.symbol_coding import DIRECT_CODED, encode_symbols
    from ..ops.normals import normal_encode_chain
    from ..ops.texcoords import collect_uv_gathers, uv_encode_chain
    from ..shared.prediction import (write_normal_flips,
                                     write_tex_orientations)

    mesh0 = meshes[idxs[0]]
    out: dict = {}
    pos_att0 = mesh0.position_attribute()
    pos_id = pos_att0.att_id

    normal_idxs = []
    for ni, a in enumerate(mesh0.attributes):
        if a.att_type != AttributeType.NORMAL:
            continue
        # the wire rejects depths < 7 (OctOrthogonal mod-max ambiguity,
        # portabilization.py); route out-of-range depths to the host
        # path so its canonical error surfaces
        if not 7 <= normal_bits <= 16:
            continue
        if not _attribute_eligible(meshes, idxs, ni, pos_id, 3):
            continue
        rings = topo.rings_for(ni)
        R = max(int(rings["next_pt"].shape[1]), 1)
        # the host clamp/sum runs in int64; the device chain is int32, so
        # only run it where no intermediate can leave int32
        if 3 * R * (1 << (2 * bits + 1)) >= (1 << 31):
            continue
        normal_idxs.append(ni)
    uv_idxs = [ui for ui, a in enumerate(mesh0.attributes)
               if a.att_type == AttributeType.TEX_COORD
               and _attribute_eligible(meshes, idxs, ui, pos_id, 2)]
    if not normal_idxs and not uv_idxs:
        return out

    # per-mesh degeneracy guard for normals: a zero/non-finite normal
    # makes the host path NaN-propagate (0/0) where the device chain's
    # exact division masks to 0 — route such meshes to the host
    nrm_ok = {ni: np.array([
        bool(np.isfinite(v).all() and not (v == 0).all(axis=1).any())
        for v in (meshes[i].attributes[ni].values for i in idxs)])
        for ni in normal_idxs}

    uo_pos = jnp.asarray(pos_att0.unique_indices().astype(np.int32))
    n = len(idxs)
    n_pad = -(-n // chunk) * chunk

    def padded(values_list):
        batch = np.stack(values_list)
        if n_pad != n:
            batch = np.concatenate(
                [batch, np.repeat(batch[:1], n_pad - n, axis=0)])
        return batch

    pos_batch = padded([meshes[i].position_attribute()
                        .values.astype(np.float32) for i in idxs])
    nrm_batches = {ni: padded([meshes[i].attributes[ni]
                               .values.astype(np.float32) for i in idxs])
                   for ni in normal_idxs}
    uv_batches = {ui: padded([meshes[i].attributes[ui]
                              .values.astype(np.float32) for i in idxs])
                  for ui in uv_idxs}
    # non-finite UVs must take the host path (its portabilize raises the
    # canonical error); the old device quantize silently encoded garbage
    uv_idxs = [ui for ui in uv_idxs if np.isfinite(uv_batches[ui]).all()]
    if not normal_idxs and not uv_idxs:
        return out
    uv_gathers = {ui: collect_uv_gathers(topo.view_for(ui),
                                         topo.sequences[ui],
                                         pos_att0.num_points)
                  for ui in uv_idxs}

    results: dict = {}
    for c0 in range(0, n_pad, chunk):
        # host quantize + narrow upload (u8/pack12/u16); the f32 upload +
        # device quantize remains only for depths past 16 bits
        q_pos = _host_quantized_upload(pos_batch[c0:c0 + chunk], bits)
        if q_pos is None:
            q_pos = _jit_quantize(jnp.asarray(pos_batch[c0:c0 + chunk]),
                                  bits)[0]
        for ni in normal_idxs:
            rings = topo.rings_for(ni)
            a0 = mesh0.attributes[ni]
            n_args = (
                q_pos, jnp.asarray(nrm_batches[ni][c0:c0 + chunk]),
                jnp.asarray(rings["tip_pt"]), jnp.asarray(rings["next_pt"]),
                jnp.asarray(rings["prev_pt"]), jnp.asarray(rings["mask"]),
                uo_pos, jnp.asarray(a0.unique_indices().astype(np.int32)))
            if mesh_axis is not None:
                with jax.enable_x64(True):
                    s, f = _jit_normal_chain_sharded(
                        *n_args, bits=normal_bits, mesh_axis=mesh_axis)
            else:
                s, f = normal_encode_chain(*n_args, bits=normal_bits)
            syms, flips = np.asarray(s), np.asarray(f)
            r = results.setdefault(ni, {"syms": [], "flips": []})
            r["syms"].append(syms)
            r["flips"].append(flips)
        for ui in uv_idxs:
            a0 = mesh0.attributes[ui]
            q_uv = _host_quantized_upload(uv_batches[ui][c0:c0 + chunk],
                                          uv_bits)
            if q_uv is None:  # bits > 16 (finiteness pre-checked above)
                q_uv = _jit_quantize(
                    jnp.asarray(uv_batches[ui][c0:c0 + chunk]), uv_bits)[0]
            if mesh_axis is not None:
                from ..ops.texcoords import uv_encode_chain_sharded
                syms, vmin, vmax, ovals, oflags, risky = \
                    uv_encode_chain_sharded(
                        q_pos, q_uv, uv_gathers[ui],
                        pos_att0.unique_indices(), a0.unique_indices(),
                        mesh_axis)
            else:
                syms, vmin, vmax, ovals, oflags, risky = uv_encode_chain(
                    q_pos, q_uv, uv_gathers[ui], pos_att0.unique_indices(),
                    a0.unique_indices())
            r = results.setdefault(ui, {"syms": [], "vmin": [], "vmax": [],
                                        "ovals": [], "oflags": [],
                                        "risky": []})
            for key, arr in (("syms", syms), ("vmin", vmin),
                             ("vmax", vmax), ("ovals", ovals),
                             ("oflags", oflags), ("risky", risky)):
                r[key].append(np.asarray(arr))

    for ni in normal_idxs:
        syms = np.concatenate(results[ni]["syms"])[:n]
        flips = np.concatenate(results[ni]["flips"])[:n]
        for k in range(n):
            if not nrm_ok[ni][k]:
                continue
            w = ByteWriter()
            encode_symbols(syms[k].astype(np.uint64).ravel(), 2,
                           DIRECT_CODED, w)
            xw = ByteWriter()
            n_mx = (1 << normal_bits) - 1
            xw.write_u32(n_mx)
            xw.write_u32(n_mx // 2)
            write_normal_flips(flips[k].tolist(), xw)
            out.setdefault(k, {})[ni] = {
                "payload": w.getvalue(),
                "xform_meta": bytes(xw.getvalue())}
    for ui in uv_idxs:
        r = results[ui]
        syms = np.concatenate(r["syms"])[:n]
        vmin = np.concatenate(r["vmin"])[:n]
        vmax = np.concatenate(r["vmax"])[:n]
        ovals = np.concatenate(r["ovals"])[:n]
        oflags = np.concatenate(r["oflags"])[:n]
        risky = np.concatenate(r["risky"])[:n]
        for k in range(n):
            if risky[k]:
                continue  # host path handles this mesh's UVs exactly
            w = ByteWriter()
            encode_symbols(syms[k].astype(np.uint64).ravel(), 2,
                           DIRECT_CODED, w)
            xw = ByteWriter()
            write_tex_orientations(ovals[k][oflags[k]].tolist(), xw)
            xw.write_u32(int(vmin[k]) & 0xFFFFFFFF)
            xw.write_u32(int(vmax[k]) & 0xFFFFFFFF)
            out.setdefault(k, {})[ui] = {
                "payload": w.getvalue(),
                "xform_meta": bytes(xw.getvalue())}
    return out


def topology_gathers_np(topo: PreparedTopology, pos_att) -> dict:
    """Per-topology parallelogram gather arrays (numpy), native pass with
    Python fallback — shared by every device encode driver."""
    from ..native import topo as ntopo
    from ..ops.gathers import build_parallelogram_gathers

    view = TableView(topo.conn_out.corner_table.corner_table)
    seq = topo.sequences[0]
    unique_of_point = pos_att.unique_indices()
    arrays = view.as_arrays()
    voc = unique_of_point[view.u.faces_points.ravel()]
    g = ntopo.parallelogram_gathers(arrays[0], arrays[1], arrays[2], voc,
                                    np.asarray(seq))
    if g is None:
        g = build_parallelogram_gathers(view, seq, unique_of_point)
    return {k: np.asarray(v) for k, v in g.items()}


def quantize_positions_host(batch: np.ndarray, bits: int):
    """Vectorized canonical coordinate-wise quantization over a (B, V, C)
    float32 batch — the EXACT per-value formula of
    encode/portabilization.quantize_coordinate_wise (min/max seeded with
    zero, one shared delta_max per mesh, all math float32; the device
    quantize_kernel's f32_div/mul_exact machinery exists to match THIS).
    Returns (q int32 (B,V,C), mins float32 (B,C), delta_max float32 (B,))."""
    vals = batch.astype(np.float32)
    zero = np.float32(0.0)
    mins = np.minimum(vals.min(axis=1), zero).astype(np.float32)
    maxs = np.maximum(vals.max(axis=1), zero).astype(np.float32)
    # this path REPLACES portabilize for the batch, so it must also carry
    # its non-finite rejection (portabilization._require_finite) — NaN/inf
    # propagate into the min/max reductions, so the O(B*C) check here is
    # equivalent to scanning the values
    if not (np.isfinite(mins).all() and np.isfinite(maxs).all()):
        bad = ~(np.isfinite(mins).all(axis=1)
                & np.isfinite(maxs).all(axis=1))
        raise ValueError(
            f"attribute POSITION contains non-finite values (NaN/inf) in "
            f"{int(bad.sum())} mesh(es) of the batch; refusing to quantize")
    delta_max = np.maximum(np.float32(0.0),
                           (maxs - mins).max(axis=1)).astype(np.float32)
    # in-place passes over ONE work buffer (the naive where/astype chain
    # allocated ~8 full-size temporaries); each op is the same f32 op in
    # the same order as quantize_coordinate_wise, so values stay bit-identical
    work = vals - mins[:, None, :]
    safe = np.where(delta_max == 0.0, np.float32(1.0), delta_max)
    np.divide(work, safe[:, None, None], out=work)
    if np.any(delta_max == 0.0):
        # degenerate meshes keep the un-divided diff (canonical branch)
        dz = delta_max == 0.0
        work[dz] = vals[dz] - mins[dz][:, None, :]
    np.multiply(work, np.float32((1 << bits) - 1), out=work)
    np.add(work, np.float32(0.5), out=work)
    # f32 -> int truncation toward zero; quantized values live in
    # [0, 2^bits), so the canonical int64 hop cannot change anything
    q = work.astype(np.int32)
    return q, mins, delta_max


def device_encode_group(positions_batch: np.ndarray, topo: PreparedTopology,
                        pos_att, bits: int = 11, mesh_axis=None,
                        return_full: bool = False,
                        return_device: bool = False,
                        _timings: dict | None = None):
    """Device compute for a batch of meshes sharing one topology:
    quantizes on the HOST (canonical formula, so the device float quirks
    never enter), uploads uint16 quantized values (HALF the f32 bytes),
    and runs the fused predict/residual/histogram step on device
    (optionally shard_map'ed over a 'data' mesh axis).
    Returns per-mesh residual symbol arrays plus the wrapped-difference
    vmin/vmax and quantization mins/delta_max — all host-resident already
    (zero metadata readbacks).

    Symbols match the host pipeline bit-for-bit (tests/test_device_ops.py).
    The gather arrays are cached on the PreparedTopology so multi-chunk
    groups upload them once."""
    import jax.numpy as jnp

    cached = getattr(topo, "_dev_gathers", None)
    if cached is None:
        g = topology_gathers_np(topo, pos_att)
        gathers = {k: jnp.asarray(v) for k, v in g.items()}
        topo._dev_gathers = (g, gathers)
    else:
        g, gathers = cached

    B, V, C = positions_batch.shape
    import time as _time
    t0 = _time.perf_counter()
    # C++ fused quantizer (two memory passes, emits the uint16 upload
    # buffer directly — the numpy form below makes ~10 memory passes).
    # Bit-exact twin, equality pinned by tests/test_parallel.py; returns
    # None without a toolchain or on non-finite inputs (the numpy twin
    # then raises the canonical error).
    from ..native import quantize_batch as _native_quantize
    got = _native_quantize(positions_batch, bits) if bits <= 16 else None
    if got is not None:
        q_up, mins, delta_max, vmin, vmax = got
        q_np = q_up  # uint16; encode_attributes casts lazily if a host-
        # predicted child attribute ever reads these parent values
    else:
        q_np, mins, delta_max = quantize_positions_host(positions_batch,
                                                        bits)
        vmin = q_np.min(axis=(1, 2)).astype(np.int32)
        vmax = q_np.max(axis=(1, 2)).astype(np.int32)
        # q in [0, 2^bits) — uint16 upload when it fits
        q_up = q_np.astype(np.uint16) if bits <= 16 else q_np
    if _timings is not None:
        _timings["host_quantize"] = (_timings.get("host_quantize", 0.0)
                                     + _time.perf_counter() - t0)
        _timings["h2d_mb"] = (_timings.get("h2d_mb", 0.0)
                              + q_up.nbytes / 1e6)

    t0 = _time.perf_counter()
    # Upload layout: ship the narrowest layout the depth allows — u8 at
    # bits<=8 (half the u16 bytes), the 12-bit pack at bits<=12 (3/4),
    # u16 otherwise. The
    # device unpacks inside the jitted step (ops.unpack12_kernel); the
    # symbols are bit-identical because every op past the upload is
    # integer. PACKED_UPLOAD=False (or TPUDRACO_PACKED_UPLOAD=0) is the
    # equality-tested off-switch twin.
    packed = None
    if PACKED_UPLOAD and bits <= 12 and q_up.dtype == np.uint16:
        if bits <= 8:
            q_up8 = q_up.astype(np.uint8)
            q_dev = jnp.asarray(q_up8)
            up_bytes = q_up8.nbytes
        else:
            from ..native import pack12 as _pack12
            lo, hb = _pack12(q_up)
            packed = (jnp.asarray(lo), jnp.asarray(hb))
            up_bytes = lo.nbytes + hb.nbytes
    else:
        q_dev = jnp.asarray(q_up)  # H2D (async; lands at first use)
        up_bytes = q_up.nbytes
    if _timings is not None:
        _timings["upload_dispatch"] = (_timings.get("upload_dispatch", 0.0)
                                       + _time.perf_counter() - t0)
        _timings["h2d_mb"] += (up_bytes - q_up.nbytes) / 1e6
    if mesh_axis is not None:
        if packed is not None:
            syms, counts = _jit_step_sharded_p12(*packed, gathers, bits,
                                                 mesh_axis)
        else:
            syms, counts = _jit_step_sharded_q(q_dev, gathers, bits,
                                               mesh_axis)
    elif packed is not None:
        syms, counts = _jit_step_gather_p12(*packed, gathers, bits)
    else:
        syms, counts = _jit_step_gather_q(q_dev, gathers, bits)
    if _timings is not None:
        # forced tiny sync so upload+step time is visible apart from the
        # entropy stage (timing mode only — production never syncs here)
        t0 = _time.perf_counter()
        np.asarray(counts[:1, :1])
        _timings["upload_step_sync"] = (
            _timings.get("upload_step_sync", 0.0)
            + _time.perf_counter() - t0)
        _timings["n_timing_syncs"] = _timings.get("n_timing_syncs", 0) + 1
    if return_device:
        # symbols/counts stay on device (the entropy stage consumes them
        # there); every scalar the host needs is already host-resident
        return {"symbols": syms, "vmin": vmin, "vmax": vmax,
                "counts": counts, "mins": mins, "delta_max": delta_max,
                "q": q_np}
    if return_full:
        return {"symbols": np.asarray(syms), "vmin": vmin, "vmax": vmax,
                "mins": mins, "delta_max": delta_max, "q": q_np}
    return np.asarray(syms)


# module-level jitted steps: defining the closure inside device_encode_group
# would miss jax's jit cache on every call and recompile for every batch
@functools.partial(jax.jit, static_argnames=("bits",))
def _jit_step_gather_q(q, gathers, bits):
    from ..ops import encode_step_from_q
    out = encode_step_from_q(q, gathers, bits=bits)
    return out["symbols"], out["counts"]


ROUTE_CACHE_TTL_S = 6 * 3600.0  # host speed drifts on multi-hour scales


def _route_cache_default_path() -> str | None:
    """TPUDRACO_ROUTE_CACHE: a path, or ''/'0' to disable; default
    ~/.cache/tpudraco/route_cache.json (XDG_CACHE_HOME honored)."""
    p = os.environ.get("TPUDRACO_ROUTE_CACHE")
    if p is not None:
        return None if p in ("", "0") else p
    root = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(root, "tpudraco", "route_cache.json")


@functools.partial(jax.jit, static_argnames=("bits", "mesh_axis"))
def _jit_normal_chain_sharded(q_pos, normals, tip_pt, next_pt, prev_pt,
                              mask, uo_pos, uo_nrm, bits, mesh_axis):
    """Data-parallel NORMAL chain over the ("data",) mesh: the batch axis
    shards (meshes are independent), every ring/index table replicates.
    Bytes equal the unsharded chain (oracle in tests/test_parallel.py)."""
    from jax.sharding import PartitionSpec as P

    from ..ops.normals import _normal_encode_chain_impl
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def run(qp, nr, tp, nx, pv, mk, up, un):
        # the raw impl: the caller scopes jax.enable_x64 OUTSIDE this
        # jit (the public wrapper would re-enter the scope mid-trace)
        return _normal_encode_chain_impl(qp, nr, tp, nx, pv, mk, up, un,
                                         bits=bits)

    fn = shard_map(run, mesh=mesh_axis,
                   in_specs=(P("data", None, None), P("data", None, None),
                             P(), P(), P(), P(), P(), P()),
                   out_specs=(P("data", None, None), P("data", None)))
    return fn(q_pos, normals, tip_pt, next_pt, prev_pt, mask, uo_pos,
              uo_nrm)


# packed-upload twins of the three steps above: same compute after a
# fused device unpack (ops.unpack12_kernel); bit-identical symbols
@functools.partial(jax.jit, static_argnames=("bits",))
def _jit_step_gather_p12(lo, hb, gathers, bits):
    from ..ops import encode_step_from_q, unpack12_kernel
    out = encode_step_from_q(unpack12_kernel(lo, hb), gathers, bits=bits)
    return out["symbols"], out["counts"]


@functools.partial(jax.jit, static_argnames=("bits", "mesh_axis"))
def _jit_step_sharded_p12(lo, hb, gathers, bits, mesh_axis):
    """Packed-upload twin of _jit_step_sharded_q: lo/hb shard on the
    data axis (nibbles pair within a mesh row only — native.pack12's
    layout contract), each shard unpacks locally, then runs the plain
    step."""
    from jax.sharding import PartitionSpec as P

    from ..ops import encode_step_from_q, unpack12_kernel
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def step(lo_s, hb_s, g):
        out = encode_step_from_q(unpack12_kernel(lo_s, hb_s), g, bits=bits)
        return out["symbols"], out["counts"]

    fn = shard_map(step, mesh=mesh_axis,
                   in_specs=(P("data", None, None), P("data", None), P()),
                   out_specs=(P("data", None, None), P("data", None)))
    return fn(lo, hb, gathers)


@functools.partial(jax.jit, static_argnames=("bits", "mesh_axis"))
def _jit_step_sharded_q(q, gathers, bits, mesh_axis):
    """Data-parallel encode step over a 1-D ("data",) device mesh. The
    per-shard computation is the plain encode_step_from_q; meshes are
    independent, so the only cross-device contract is the gather order
    (handled by the out_specs concatenation) — output equals the
    single-device run bit-for-bit (pinned by tests/test_parallel.py)."""
    from jax.sharding import PartitionSpec as P

    from ..ops import encode_step_from_q
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def step(q_shard, g):
        out = encode_step_from_q(q_shard, g, bits=bits)
        return out["symbols"], out["counts"]

    fn = shard_map(step, mesh=mesh_axis,
                   in_specs=(P("data", None, None), P()),
                   out_specs=(P("data", None, None), P("data", None)))
    return fn(q, gathers)


@functools.partial(jax.jit, static_argnames=("bits", "mesh_axis"))
def _jit_step_stream_sharded(pos, gathers, bits, mesh_axis):
    """Single-mesh stream-parallel step over a 1-D ("stream",) mesh:
    positions replicate, the traversal gathers shard, each chip emits its
    residual segment, and the histogram all-reduces over the stream axis.
    The residual range comes from the replicated pre-gather array
    (wrapped_difference_kernel range_source), so every shard wraps against
    the global range — bit-identical to the single-device run."""
    from jax.sharding import PartitionSpec as P

    from ..ops import encode_step
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def step(pos_rep, g):
        out = encode_step(pos_rep, g, bits=bits)
        counts = jax.lax.psum(out["counts"], "stream")
        return out["symbols"], out["vmin"], out["vmax"], counts

    fn = shard_map(step, mesh=mesh_axis,
                   in_specs=(P(), P("stream")),
                   out_specs=(P(None, "stream", None), P(), P(), P()))
    return fn(pos, gathers)
