"""Batched multi-lane rANS on the accelerator.

Each lane is one independent Draco rANS stream (per-attribute, per-mesh —
draco streams are independent, so lane parallelism preserves bit-exactness).
The sequential per-symbol recurrence runs as a lax.scan over symbol steps
with all lanes vectorized. Renormalization bytes are packed into words
and compacted on device, then sliced into per-lane byte streams on the
host. See PAPERS.md (Recoil; interleaved entropy coders) for the lane
formulation.

Bit-exact with the host coder (tpudraco/entropy/rans.py): same state
update, same renormalization condition, same flush framing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_RENORM_PER_SYMBOL = 3  # state <= l_base<<8 drains in <= 2 emissions; +1 margin

# adaptive readback widths per (shape, precision): the host guesses the
# occupied prefix from the last batch and re-reads only on (rare) overflow
_WORD_BUCKET: dict = {}
_HIST_BUCKET: dict = {}
_DIST_BUCKET: dict = {}
# pipelined group encode: lanes per scan chunk (chunk k's payload
# readback overlaps chunk k+1's scan). Groups below 2*LANE_CHUNK lanes
# stay one-shot. Tuned on the previous accelerator; not yet measured on
# the H100 (ROADMAP A4).
LANE_CHUNK = 128
# symbols per lax.scan iteration: each iteration pays a fixed overhead,
# so K sequential symbols per step cut the iteration count K-fold (the
# recurrence itself stays symbol-sequential within the body). The words
# scans take this as a STATIC k argument (call sites read this global at
# call time).
SYMBOLS_PER_STEP = 8

# word-compaction strategy for the words scan: "sort" = stable-partition
# argsort, "sortkv" = the same partition through one fused
# lax.sort_key_val pass (no separate take_along_axis gather), "marks" =
# in-register per-step block packing + scatter-max/cummax/gather ragged
# concat (no sort; see _words_scan_core docstring). The flag threads into
# the scans as a STATIC argument, so both variants coexist in the jit
# caches and switching is free. None = auto: "marks" on the CPU backend
# (XLA:CPU's stable argsort dominates the stage there), "sortkv"
# elsewhere (chosen on the previous accelerator; not yet measured on the
# H100, ROADMAP A4). Byte streams are identical in every mode (oracle in
# tests).
WORDS_COMPACT = None


def set_words_compact(mode) -> None:
    """Select the words-scan compaction strategy ("sort" | "sortkv" |
    "marks"), or None/"auto" for the per-backend default. "sortkv" is
    the same stable partition as "sort" through one fused
    lax.sort_key_val pass (no separate take_along_axis gather)."""
    global WORDS_COMPACT
    if mode == "auto":
        mode = None
    assert mode in ("sort", "sortkv", "marks", None), mode
    WORDS_COMPACT = mode


def _words_compact() -> str:
    """Resolve the active compaction mode (per-backend when auto)."""
    if WORDS_COMPACT is not None:
        return WORDS_COMPACT
    return "marks" if jax.default_backend() == "cpu" else "sortkv"


@functools.partial(jax.jit, static_argnames=("precision",))
def _rans_scan_lanes(symbols: jnp.ndarray, freqs: jnp.ndarray,
                     cums: jnp.ndarray, lengths: jnp.ndarray,
                     precision: int = 12):
    """The dense byte-slot twin of the word-packed scan: per-step
    renormalization bytes emitted DENSELY as scan outputs, then
    stable-partitioned to the front of each lane. Tests hold the words
    path to it. Returns (compacted (L, T*R) uint8, byte counts (L,),
    packed flush state (L,) uint32, flush byte count (L,) int32)."""
    L, T = symbols.shape
    l_base = (1 << precision) << 2
    base_sh = l_base >> precision
    S = freqs.shape[-1]

    K = SYMBOLS_PER_STEP
    T_pad = -(-T // K) * K
    if T_pad != T:  # padding symbols land beyond every lane's length
        symbols = jnp.pad(symbols, ((0, 0), (0, T_pad - T)))

    # hoist ALL table lookups out of the sequential loop: one parallel
    # gather over (L, T) instead of a per-step vector gather in the body
    idx = jnp.clip(symbols, 0, S - 1)
    if freqs.ndim == 2:
        fs = jnp.take_along_axis(freqs, idx, axis=1).astype(jnp.uint32)
        cs = jnp.take_along_axis(cums, idx, axis=1).astype(jnp.uint32)
    else:
        fs = freqs[idx].astype(jnp.uint32)
        cs = cums[idx].astype(jnp.uint32)

    def one_symbol(states, f, cum, active):
        limit = (jnp.uint32(base_sh) * f) << jnp.uint32(8)
        emitted = []
        for _ in range(MAX_RENORM_PER_SYMBOL):
            do = active & (states >= limit)
            byte = (states & jnp.uint32(0xFF)).astype(jnp.int16)
            emitted.append(jnp.where(do, byte, jnp.int16(256)))
            states = jnp.where(do, states >> jnp.uint32(8), states)
        new_states = ((states // f) << jnp.uint32(precision)) \
            + states % f + cum
        states = jnp.where(active, new_states, states)
        return states, emitted

    def step(states, s):
        emitted = []
        for k in range(K):
            i = s * K + k
            states, e = one_symbol(states, fs[:, i], cs[:, i],
                                   i < lengths)
            emitted.extend(e)
        return states, jnp.stack(emitted)  # (K*R, L)

    states0 = jnp.full((L,), l_base, dtype=jnp.uint32)
    states, emits = jax.lax.scan(step, states0, jnp.arange(T_pad // K))
    # (steps, K*R, L) -> per-lane t-major emission layout (L, T*R)
    emits = emits.reshape(T_pad, MAX_RENORM_PER_SYMBOL, L)[:T]
    flat = emits.transpose(2, 0, 1).reshape(
        L, T * MAX_RENORM_PER_SYMBOL)
    emitted = flat.astype(jnp.uint8)
    is_byte = flat != 256

    # flush framing: final state with 2-bit size flag (rans.rs:48-68)
    st = states - jnp.uint32(l_base)
    nbytes_state = jnp.where(st < (1 << 6), 1,
                             jnp.where(st < (1 << 14), 2,
                                       jnp.where(st < (1 << 22), 3, 4)))
    flag = (nbytes_state - 1).astype(jnp.uint32)
    packed = st + (flag << (jnp.uint32(6)
                            + jnp.uint32(8)
                            * (nbytes_state - 1).astype(jnp.uint32)))

    # on-device compaction: stable-partition real bytes to the front so
    # the host transfer is the occupied prefix, not (T, R, L) int32
    not_byte = ~is_byte
    order = jnp.argsort(not_byte, axis=1, stable=True)
    compacted = jnp.take_along_axis(emitted, order, axis=1)
    counts = is_byte.sum(axis=1).astype(jnp.int32)
    return compacted, counts, packed, nbytes_state.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n",))
def _slice_cols(arr: jnp.ndarray, n: int) -> jnp.ndarray:
    return arr[:, :n]


@functools.partial(jax.jit, static_argnames=("g",))
def _concat_tiny_dist(tiny: jnp.ndarray, dist: jnp.ndarray,
                      g: int) -> jnp.ndarray:
    """[tiny summary | occupied-prefix of the table matrix] as one buffer
    so the device-tables flow pays a single readback for both. The prefix
    rides 21-bit-packed (_pack_dist21): every normalized freq is in
    [0, 2^prec] with prec <= 20, so 21 bits are exact and the table's
    share of the D2H transfer drops 32/21 = 1.52x."""
    return jnp.concatenate([tiny.astype(jnp.uint32),
                            _pack_dist21(dist, g)], axis=1)


# exact 21-bit bitpack of the (B, S) freq-table matrix for readback:
# 32 values (672 bits) -> 21 little-endian uint32 words per group. Only
# the TRANSFER is packed — the scans consume the unpacked device copy.

def _pack21_cols(g: int) -> int:
    return 21 * (-(-g // 32))


@functools.partial(jax.jit, static_argnames=("g",))
def _pack_dist21(dist: jnp.ndarray, g: int) -> jnp.ndarray:
    B = dist.shape[0]
    g_pad = -(-g // 32) * 32
    d = dist[:, :min(g, int(dist.shape[1]))]
    if int(d.shape[1]) < g_pad:
        d = jnp.pad(d, ((0, 0), (0, g_pad - int(d.shape[1]))))
    # mask defensively: pathological lanes (discarded by the caller) may
    # hold values beyond 21 bits, which must not bleed into neighbors
    d = d.astype(jnp.uint32).reshape(B, g_pad // 32, 32) \
        & jnp.uint32((1 << 21) - 1)
    words = []
    for k in range(21):
        w = jnp.zeros(d.shape[:2], jnp.uint32)
        for j in range((32 * k - 20) // 21, min(32, (32 * k + 31) // 21
                                                + 1)):
            if j < 0:
                continue
            off = 32 * k - 21 * j  # value j's bit 'off' lands at word
            # bit 0 (negative: value starts 'off' bits into the word)
            w = w | (jnp.where(off >= 0, d[..., j] >> off,
                               d[..., j] << -off)
                     if off != 0 else d[..., j])
        words.append(w)
    return jnp.stack(words, axis=-1).reshape(B, -1)


def _unpack_dist21(words: np.ndarray, g: int) -> np.ndarray:
    """Host inverse of _pack_dist21: (B, 21*G) uint32 -> (B, g) int32."""
    B = words.shape[0]
    w = words.reshape(B, -1, 21).astype(np.uint64)
    vals = []
    for j in range(32):
        lo = 21 * j
        k0, off = lo // 32, lo % 32
        v = w[..., k0] >> off
        if off + 21 > 32:
            v = v | (w[..., k0 + 1] << (32 - off))
        vals.append(v & np.uint64((1 << 21) - 1))
    out = np.stack(vals, axis=-1).reshape(B, -1)
    return out[:, :g].astype(np.int32)


def _words_scan_core(fs, cs, lengths, T: int, l_base, prec,
                     compact: str = "sort", k: int = 8):
    """Shared body of the word-packed scan: the recurrence, word
    packing, flush framing, and word-level compaction. ``l_base`` and
    ``prec`` are uint32 scalars (static-precision kernel) or (L,)
    vectors (_rans_scan_lanes_words_vprec) — the renorm limit
    (4*f) << 8 is precision-independent (l_base >> p == 4), so the
    recurrence itself never branches on which. fs/cs are the
    pre-gathered per-symbol (freq, cum) tables over the K-padded
    symbol axis.

    ``compact`` (static, from the WORDS_COMPACT flag): "sort" is the
    stable-partition argsort; "marks" packs each scan step's flushed
    words into per-step block slots IN REGISTERS (static select network,
    no sort input at all) and concatenates the ragged blocks with a
    small scatter-max + two cummaxes + one gather, which removes the
    sort where scatter/cummax lower well. Byte streams are identical
    (oracle in tests)."""
    L, T_pad = fs.shape
    K = k
    u8_ = jnp.uint32(8)

    def one_symbol(carry, f, cum, active):
        states, lo, hi, nacc = carry
        limit = (jnp.uint32(4) * f) << u8_
        for _ in range(MAX_RENORM_PER_SYMBOL):
            do = active & (states >= limit)
            b = states & jnp.uint32(0xFF)
            in_lo = nacc < 4
            sh_lo = u8_ * jnp.where(in_lo, nacc, 0)
            sh_hi = u8_ * jnp.where(in_lo, 0, nacc - 4)
            lo = jnp.where(do & in_lo, lo | (b << sh_lo), lo)
            hi = jnp.where(do & ~in_lo, hi | (b << sh_hi), hi)
            nacc = nacc + do.astype(jnp.uint32)
            states = jnp.where(do, states >> u8_, states)
        new_states = ((states // f) << prec) + states % f + cum
        states = jnp.where(active, new_states, states)
        # nacc <= 6 here (<= 3 carried in + <= 3 emitted): one flush
        # drains a full little-endian word and shifts the tail down
        fl = nacc >= 4
        word = lo
        lo = jnp.where(fl, hi, lo)
        hi = jnp.where(fl, jnp.uint32(0), hi)
        nacc = jnp.where(fl, nacc - 4, nacc)
        return (states, lo, hi, nacc), (word, fl)

    marks = compact == "marks"
    # max full-word flushes per step: <= 3 carried bytes + K *
    # MAX_RENORM_PER_SYMBOL emitted, one word per 4 bytes
    BW = (3 + MAX_RENORM_PER_SYMBOL * K) // 4

    def step(carry, s):
        if marks:
            slots = [carry[0] * 0 for _ in range(BW)]
            cnt = carry[0] * 0
            for k in range(K):
                i = s * K + k
                carry, (w, fl) = one_symbol(carry, fs[:, i], cs[:, i],
                                            i < lengths)
                for b in range(BW):
                    slots[b] = jnp.where(fl & (cnt == b), w, slots[b])
                cnt = cnt + fl.astype(jnp.uint32)
            return carry, (jnp.stack(slots), cnt)  # (BW, L), (L,)
        words, flags = [], []
        for k in range(K):
            i = s * K + k
            carry, (w, fl) = one_symbol(carry, fs[:, i], cs[:, i],
                                        i < lengths)
            words.append(w)
            flags.append(fl)
        return carry, (jnp.stack(words), jnp.stack(flags))  # (K, L)

    # derive the carry from a (sharded) input so shard_map's varying-axis
    # typing accepts the scan (a fresh constant would be unvarying while
    # the body output varies over the lane axis)
    zeros = (lengths * 0).astype(jnp.uint32)
    carry0 = (zeros + l_base, zeros, zeros, zeros)
    (states, lo, _hi, nacc), (wq, flq) = jax.lax.scan(
        step, carry0, jnp.arange(T_pad // K))

    # flush framing: final state with 2-bit size flag (rans.rs:48-68)
    st = states - l_base
    nbytes_state = jnp.where(st < (1 << 6), 1,
                             jnp.where(st < (1 << 14), 2,
                                       jnp.where(st < (1 << 22), 3, 4)))
    flag = (nbytes_state - 1).astype(jnp.uint32)
    packed = st + (flag << (jnp.uint32(6)
                            + u8_ * (nbytes_state - 1).astype(jnp.uint32)))

    cap_w = min(T, (3 * T) // 4 + 2)
    if marks:
        compacted, nwords = _compact_blocks_marks(
            wq.transpose(2, 0, 1), flq.T.astype(jnp.int32), cap_w)
    else:
        words = wq.reshape(T_pad, L)[:T].T  # (L, T) symbol-major
        mask = flq.reshape(T_pad, L)[:T].T
        if compact == "sortkv":
            # fused stable key-value sort: one pass moves the payload
            # with the keys instead of argsort (pass 1) + a separate
            # take_along_axis gather (pass 2). Identical stable
            # partition semantics -> identical bytes (twin test).
            _, compacted = jax.lax.sort(
                ((~mask).astype(jnp.uint8), words), dimension=1,
                is_stable=True, num_keys=1)
        else:
            # word-level stable partition (3x fewer sort elements than
            # byte slots)
            order = jnp.argsort(~mask, axis=1, stable=True)
            compacted = jnp.take_along_axis(words, order, axis=1)
        compacted = compacted[:, :cap_w]
        nwords = mask.sum(axis=1).astype(jnp.uint32)
    meta = jnp.stack([nwords, nacc, lo, packed,
                      nbytes_state.astype(jnp.uint32)], axis=1)
    return jnp.concatenate([meta, compacted], axis=1)


def _compact_blocks_marks(blocks, cnts, cap_w: int):
    """Ragged-concatenate per-step word blocks without a sort: scatter a
    (block-id, block-offset) mark at each block's start position,
    forward-fill both with cummax (block starts are monotone), and
    gather every output slot straight from (src block, p - offset).
    blocks (L, G, BW) uint32, cnts (L, G) int32 with cnts[g] <= BW.
    Returns (compacted (L, cap_w) uint32, nwords (L,) uint32)."""
    L, G, BW = blocks.shape
    off = jnp.cumsum(cnts, axis=1) - cnts              # exclusive (L, G)
    nwords = (off[:, -1] + cnts[:, -1]).astype(jnp.uint32)
    rows = jnp.arange(L, dtype=jnp.int32)[:, None]
    gids = jnp.broadcast_to(jnp.arange(G, dtype=jnp.int32), (L, G))
    # duplicate start positions (empty-block runs) resolve to the max
    # block id = the run's single non-empty terminator; trailing empties
    # scatter at position nwords and drop when out of range
    zero = jnp.zeros((L, cap_w), jnp.int32)
    gmark = zero.at[rows, off].max(gids, mode="drop")
    omark = zero.at[rows, off].max(off, mode="drop")
    src = jax.lax.cummax(gmark, axis=1)
    offp = jax.lax.cummax(omark, axis=1)
    p = jnp.arange(cap_w, dtype=jnp.int32)[None, :]
    idx = jnp.clip(src * BW + (p - offp), 0, G * BW - 1)
    compacted = jnp.take_along_axis(blocks.reshape(L, G * BW), idx,
                                    axis=1)
    return compacted, nwords


@functools.partial(jax.jit, static_argnames=("precision", "compact", "k"))
def _rans_scan_lanes_words(symbols: jnp.ndarray, freqs: jnp.ndarray,
                           cums: jnp.ndarray, lengths: jnp.ndarray,
                           precision: int = 12, compact: str = "sort",
                           k: int = 8):
    """Device scan with WORD-PACKED emissions: each lane packs its
    renormalization bytes little-endian into uint32 words carried through
    the scan (at most one full word flushes per symbol), so the on-device
    stable-partition compaction sorts T word slots instead of 3T byte
    slots, and the host transfer carries the exact payload with no slot
    padding. Byte streams are bit-identical to _rans_scan_lanes (pinned
    by tests).

    Returns ONE (L, 5 + WCAP) uint32 array — columns [nwords, partial
    byte count, partial word, packed flush state, flush byte count,
    words...] — so the host pays a SINGLE device->host readback instead
    of one per metadata array."""
    L, T = symbols.shape
    S = freqs.shape[-1]

    K = k
    T_pad = -(-T // K) * K
    if T_pad != T:  # padding symbols land beyond every lane's length
        symbols = jnp.pad(symbols, ((0, 0), (0, T_pad - T)))

    # hoist ALL table lookups out of the sequential loop (see
    # _rans_scan_lanes) — through PACKED tables: (freq-1, cum) ride one
    # u32 gather for P <= 14 and a u32 + u8 pair for P <= 20 instead of
    # two u32s (the unpack is a few vector ops per symbol, off the
    # critical path)
    idx = jnp.clip(symbols, 0, S - 1)
    fq = freqs.astype(jnp.uint32)
    cq = cums.astype(jnp.uint32)

    def take(tbl):
        return (jnp.take_along_axis(tbl, idx, axis=1)
                if tbl.ndim == 2 else tbl[idx])

    if precision <= 14:
        pk = take(((fq - 1) & jnp.uint32(0x3FFF)) | (cq << jnp.uint32(14)))
        fs = (pk & jnp.uint32(0x3FFF)) + jnp.uint32(1)
        cs = pk >> jnp.uint32(14)
    else:
        fs, cs = _take_packed_u32u8(fq, cq, take)

    return _words_scan_core(fs, cs, lengths, T,
                            jnp.uint32((1 << precision) << 2),
                            jnp.uint32(precision), compact=compact, k=k)


def _take_packed_u32u8(fq, cq, take):
    """(f-1, c < 2^20) pre-gather through a u32 + u8 pair: low 16 bits
    of each in the u32, high 4+4 in the u8 (valid for every precision
    <= 20, draco's schedule cap)."""
    g32 = take(((fq - 1) & jnp.uint32(0xFFFF))
               | ((cq & jnp.uint32(0xFFFF)) << jnp.uint32(16)))
    g8 = take(((((fq - 1) >> jnp.uint32(16)) & jnp.uint32(0xF))
               | ((cq >> jnp.uint32(16)) << jnp.uint32(4)))
              .astype(jnp.uint8)).astype(jnp.uint32)
    fs = ((g32 & jnp.uint32(0xFFFF))
          | ((g8 & jnp.uint32(0xF)) << jnp.uint32(16))) + jnp.uint32(1)
    cs = (g32 >> jnp.uint32(16)) | ((g8 >> jnp.uint32(4))
                                    << jnp.uint32(16))
    return fs, cs


@functools.partial(jax.jit, static_argnames=("compact", "k"))
def _rans_scan_lanes_words_vprec(symbols: jnp.ndarray, freqs: jnp.ndarray,
                                 cums: jnp.ndarray, lengths: jnp.ndarray,
                                 prec: jnp.ndarray, compact: str = "sort",
                                 k: int = 8):
    """_rans_scan_lanes_words with PER-LANE precision as traced data.

    The static kernel's precision only reaches three value-level spots —
    the carry seed l_base = 4 << p, the state-update shift, and the
    flush-frame subtract (the renorm limit is (4*f) << 8 for EVERY p,
    since l_base >> p == 4) — so per-lane precisions vectorize through
    the SHARED _words_scan_core without touching the recurrence. This
    removes the last host sync before the scan in the device-tables
    flow: precisions are computed on device by _normalize_tables_x64,
    so step -> histogram -> normalize -> scan all dispatch back-to-back
    and the host validates afterwards, overlapped. Tables always ride
    the u32+u8 packing (valid for every p <= 20; the u32-only p <= 14
    packing would need the precision on host). Byte streams are
    bit-identical to the static kernel per lane (tests)."""
    L, T = symbols.shape
    S = freqs.shape[-1]
    prec = prec.astype(jnp.uint32)

    K = k
    T_pad = -(-T // K) * K
    if T_pad != T:
        symbols = jnp.pad(symbols, ((0, 0), (0, T_pad - T)))

    idx = jnp.clip(symbols, 0, S - 1)

    def take(tbl):
        return (jnp.take_along_axis(tbl, idx, axis=1)
                if tbl.ndim == 2 else tbl[idx])

    fs, cs = _take_packed_u32u8(freqs.astype(jnp.uint32),
                                cums.astype(jnp.uint32), take)
    return _words_scan_core(fs, cs, lengths, T, jnp.uint32(4) << prec,
                            prec, compact=compact, k=k)


@functools.partial(jax.jit, static_argnames=("ch", "compact", "k"))
def _words_scan_chunk_vprec(symbols, c0, freqs, cums, lengths, prec,
                            ch: int, compact: str = "sort", k: int = 8):
    """Chunked _rans_scan_lanes_words_vprec: every input slices at the
    traced c0 so all chunks share one compiled program (a per-offset
    static slice would cost an XLA compile per chunk)."""
    sl = functools.partial(jax.lax.dynamic_slice_in_dim, start_index=c0,
                           slice_size=ch, axis=0)
    return _rans_scan_lanes_words_vprec.__wrapped__(
        sl(symbols), sl(freqs), sl(cums), sl(lengths), sl(prec),
        compact=compact, k=k)


@functools.partial(jax.jit,
                   static_argnames=("precision", "ch", "compact", "k"))
def _words_scan_chunk(symbols, c0, freqs, cums, lengths,
                      precision: int, ch: int, compact: str = "sort",
                      k: int = 8):
    """Word scan over a CONTIGUOUS lane chunk [c0, c0+ch) of a resident
    (L, T) symbol matrix. The chunk start is a traced scalar so every
    chunk of a batch reuses ONE compiled program; the chunk width is
    static. Used by the pipelined group encoder: chunk k+1's scan is
    queued on the device while chunk k's payload is read back, instead
    of the readback waiting behind the whole batch's scan."""
    sym = jax.lax.dynamic_slice_in_dim(symbols, c0, ch, axis=0)
    return _rans_scan_lanes_words.__wrapped__(
        sym, freqs, cums, lengths, precision=precision, compact=compact,
        k=k)


@functools.partial(jax.jit,
                   static_argnames=("mesh_axis", "compact", "k"))
def _rans_scan_lanes_words_vprec_sharded(symbols, freqs, cums, lengths,
                                         prec, mesh_axis,
                                         compact: str = "sort",
                                         k: int = 8):
    """Lane-sharded per-lane-precision word scan (the device-tables flow
    under a 1-D ("data",) mesh): precisions shard with their lanes, the
    recurrence is per-lane, so the gathered result is bit-identical to
    the single-device vprec scan (dryrun + mesh tests byte-check)."""
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def scan_shard(sym, fq, cq, ln, pr):
        return _rans_scan_lanes_words_vprec.__wrapped__(
            sym, fq, cq, ln, pr, compact=compact, k=k)

    fn = shard_map(scan_shard, mesh=mesh_axis,
                   in_specs=(P("data", None), P("data", None),
                             P("data", None), P("data"), P("data")),
                   out_specs=P("data", None))
    return fn(symbols, freqs, cums, lengths, prec)


@functools.partial(jax.jit,
                   static_argnames=("precision", "mesh_axis", "compact",
                                    "k"))
def _rans_scan_lanes_words_sharded(symbols, freqs, cums, lengths,
                                   precision: int, mesh_axis,
                                   compact: str = "sort", k: int = 8):
    """Lane-sharded word scan over a 1-D ("data",) device mesh: each chip
    runs the identical recurrence on its lane shard (lanes are
    independent rANS streams), so the gathered result is bit-identical to
    the single-device scan (byte oracle in tests + dryrun). Completes the
    fully-sharded encode pipeline: step AND entropy scale over chips."""
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def scan_shard(sym, fq, cq, ln):
        return _rans_scan_lanes_words.__wrapped__(
            sym, fq, cq, ln, precision=precision, compact=compact, k=k)

    per_lane_tables = freqs.ndim == 2
    fn = shard_map(scan_shard, mesh=mesh_axis,
                   in_specs=(P("data", None),
                             P("data", None) if per_lane_tables else P(),
                             P("data", None) if per_lane_tables else P(),
                             P("data")),
                   out_specs=P("data", None))
    return fn(symbols, freqs, cums, lengths)


def rans_encode_lanes(symbols: jnp.ndarray, freqs: jnp.ndarray,
                      cums: jnp.ndarray, lengths: jnp.ndarray,
                      precision: int = 12, _timings: dict | None = None,
                      mesh_axis=None):
    """Encode L lanes of up to T symbols each.

    symbols: (L, T) int32, entries beyond lengths[l] ignored.
    freqs/cums: (S,) shared normalized table (sum == 1<<precision), or
    (L, S) per-lane tables (per-mesh tables in corpus batches).
    lengths: (L,) int32 active symbol counts.
    Returns (buffers (L, CAP) uint8, nbytes (L,) int32) as NUMPY arrays —
    every caller slices per-lane byte blobs on host. The sequential
    recurrence runs on device; the flush-byte append runs vectorized on
    host."""
    import time as _time

    L, T = symbols.shape
    t0 = _time.perf_counter()
    # word-packed scan: bytes pack into uint32 words, so the compaction
    # sorts 3x fewer elements than byte slots and the transfer is the
    # exact payload. Meta rides in the words array: ONE readback, sized
    # by an adaptive per-shape bucket (overflow costs one rare re-read)
    if mesh_axis is not None:
        combined = _rans_scan_lanes_words_sharded(
            jnp.asarray(symbols), jnp.asarray(freqs),
            jnp.asarray(cums), jnp.asarray(lengths),
            precision=precision, mesh_axis=mesh_axis,
            compact=_words_compact(), k=SYMBOLS_PER_STEP)
    else:
        combined = _rans_scan_lanes_words(
            jnp.asarray(symbols), jnp.asarray(freqs),
            jnp.asarray(cums), jnp.asarray(lengths),
            precision=precision, compact=_words_compact(),
            k=SYMBOLS_PER_STEP)
    buffers, counts, packed, nflush = _collect_words(
        combined, L, T, precision, _timings=_timings, _t0=t0)

    packed = np.asarray(packed).astype(np.uint64)
    nflush = np.asarray(nflush).astype(np.int64)
    nbytes = _append_flush(buffers, counts, packed, nflush)
    return buffers, nbytes


def _dispatch_words_readback(combined, L: int, T: int, precision: int,
                             want_tiny: bool = False):
    """Queue the readback slice ops for a word-scan output IMMEDIATELY
    after its scan in the device stream. The stream executes in
    dispatch order and can overlap a D2H transfer with later queued
    compute, so the pipelined group encoder dispatches scan0, slice0,
    scan1, slice1, ... and then collects: chunk k's transfer overlaps
    chunk k+1's scan. A slice dispatched at collect time instead would
    queue BEHIND every later scan and serialize the pipeline."""
    dev_cap = int(combined.shape[1]) - 5
    key = (L, T, precision)
    bucket = min(dev_cap, _WORD_BUCKET.get(key, max(256, T // 4)))
    sliced = (_slice_cols(combined, 5 + bucket) if bucket < dev_cap
              else combined)
    tiny = _slice_cols(combined, 1) if want_tiny else None
    return (sliced, bucket, tiny)


def _collect_words(combined, L: int, T: int, precision: int,
                   _timings: dict | None = None, _t0: float | None = None,
                   _pre=None):
    """Readback + host unpack of one word-scan output: adaptive-bucket
    occupied-prefix transfer, then the uint32 word rows viewed
    little-endian become the byte streams. Returns (buffers (L, 3T+8)
    uint8 WITHOUT the flush bytes, counts, packed flush states, flush
    byte counts). ``_pre`` carries slice ops dispatched right after the
    scan (see _dispatch_words_readback)."""
    import time as _time

    if _pre is None:
        _pre = _dispatch_words_readback(combined, L, T, precision,
                                        want_tiny=_timings is not None)
    sliced, bucket, tiny = _pre
    if _timings is not None:
        if _t0 is None:
            _t0 = _time.perf_counter()
        if tiny is None:
            tiny = _slice_cols(combined, 1)
        np.asarray(tiny)  # forced tiny sync (timing-only; not counted
        # in n_readbacks — the untimed path never issues it)
        _timings["n_timing_syncs"] = _timings.get("n_timing_syncs", 0) + 1
        _timings["scan_compute"] = _timings.get("scan_compute", 0.0) \
            + _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
    cap = 3 * T + 8  # true bound (3 renorm bytes/symbol + flush)
    dev_cap = int(combined.shape[1]) - 5
    key = (L, T, precision)
    while True:
        got = np.asarray(sliced)
        nwords = got[:, 0].astype(np.int64)
        max_w = int(nwords.max()) if L else 0
        if max_w <= bucket or bucket >= dev_cap:
            break
        bucket = min(dev_cap, -(-max_w // 256) * 256)
        sliced = (_slice_cols(combined, 5 + bucket) if bucket < dev_cap
                  else combined)
    _WORD_BUCKET[key] = min(dev_cap, -(-max(max_w, 1) // 256) * 256
                            + 256)
    naccs = got[:, 1].astype(np.int64)
    partial = got[:, 2].astype(np.uint64)
    packed = got[:, 3]
    nflush = got[:, 4]
    counts = 4 * nwords + naccs
    buffers = np.zeros((L, cap), dtype=np.uint8)
    nb4 = min((got.shape[1] - 5) * 4, cap)
    # uint32 rows viewed little-endian ARE the byte streams
    buffers[:, :nb4] = np.ascontiguousarray(
        got[:, 5:]).view(np.uint8)[:, :nb4]
    # partial-word tail: up to 3 bytes at columns 4*nwords + i
    p_idx = np.arange(3, dtype=np.int64)[None, :]
    pmask = p_idx < naccs[:, None]
    prow = np.repeat(np.arange(L, dtype=np.int64)[:, None], 3, axis=1)
    pcol = 4 * nwords[:, None] + p_idx
    pval = ((partial[:, None] >> (8 * p_idx).astype(np.uint64))
            & np.uint64(0xFF)).astype(np.uint8)
    buffers[prow[pmask], pcol[pmask]] = pval[pmask]
    if _timings is not None:
        _timings["bytes_readback"] = _timings.get("bytes_readback", 0.0) \
            + _time.perf_counter() - _t0
        _timings["bytes_mb"] = _timings.get("bytes_mb", 0.0) \
            + got.nbytes / 1e6
        _timings["d2h_mb"] = _timings.get("d2h_mb", 0.0) + got.nbytes / 1e6
        _timings["n_readbacks"] = _timings.get("n_readbacks", 0) + 1
    return buffers, counts, packed, nflush


def _append_flush(buffers, counts, packed, nflush):
    """Vectorized flush append (up to 4 state bytes per lane) into the
    unpacked stream buffers; returns per-lane byte counts."""
    L = buffers.shape[0]
    b_idx = np.arange(4, dtype=np.int64)[None, :]
    mask = b_idx < nflush[:, None]
    rows = np.repeat(np.arange(L, dtype=np.int64)[:, None], 4, axis=1)
    cols = counts[:, None] + b_idx
    vals = ((packed[:, None] >> (8 * b_idx).astype(np.uint64))
            & np.uint64(0xFF)).astype(np.uint8)
    buffers[rows[mask], cols[mask]] = vals[mask]
    return (counts + nflush).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("precision", "max_T"))
def _rans_decode_scan(bufs_u8, nbytes, freqs, cums, slots, counts,
                      precision: int, max_T: int):
    L = bufs_u8.shape[0]
    l_base = (1 << precision) << 2
    lane_ids = jnp.arange(L)
    bufs = bufs_u8.astype(jnp.uint32)

    # init: read the tail metadata byte per lane
    pos = nbytes.astype(jnp.int32) - 1
    metadata = bufs[lane_ids, pos].astype(jnp.uint32)
    flag = (metadata >> jnp.uint32(6)).astype(jnp.int32)

    def read_back(k, val):
        states, pos = val
        do = k < flag
        pos2 = jnp.where(do, pos - 1, pos)
        byte = bufs[lane_ids, jnp.maximum(pos2, 0)].astype(jnp.uint32)
        states = jnp.where(do, (states << jnp.uint32(8)) | byte, states)
        return states, pos2

    states, pos = jax.lax.fori_loop(
        0, 3, read_back, (jnp.zeros((L,), jnp.uint32), pos))
    states = states | ((metadata & jnp.uint32(0x3F))
                       << (jnp.uint32(8) * flag.astype(jnp.uint32)))
    states = states + jnp.uint32(l_base)

    mask = jnp.uint32((1 << precision) - 1)

    def one_symbol(states, pos, i):
        active = i < counts

        def refill(j, val):
            states, pos = val
            need = active & (states < jnp.uint32(l_base)) & (pos > 0)
            pos2 = jnp.where(need, pos - 1, pos)
            byte = bufs[lane_ids, jnp.maximum(pos2, 0)].astype(jnp.uint32)
            states = jnp.where(need, states * jnp.uint32(256) + byte, states)
            return states, pos2

        states, pos = jax.lax.fori_loop(0, MAX_RENORM_PER_SYMBOL, refill,
                                        (states, pos))
        q = states >> jnp.uint32(precision)
        r = states & mask
        if slots.ndim == 2:
            idx = slots[lane_ids, r.astype(jnp.int32)]
            f = freqs[lane_ids, idx].astype(jnp.uint32)
            c = cums[lane_ids, idx].astype(jnp.uint32)
        else:
            idx = slots[r.astype(jnp.int32)]
            f = freqs[idx].astype(jnp.uint32)
            c = cums[idx].astype(jnp.uint32)
        new_states = q * f + r - c
        states = jnp.where(active, new_states, states)
        return states, pos, jnp.where(active, idx, -1)

    K = SYMBOLS_PER_STEP
    T_pad = -(-max_T // K) * K

    def step(carry, s):
        states, pos = carry
        outs = []
        for k in range(K):
            states, pos, o = one_symbol(states, pos, s * K + k)
            outs.append(o)
        return (states, pos), jnp.stack(outs)  # (K, L)

    (_, _), out = jax.lax.scan(step, (states, pos), jnp.arange(T_pad // K))
    out = out.reshape(T_pad, L)[:max_T]
    # halve the readback when the alphabet fits int16 (-1 sentinel included)
    if int(freqs.shape[-1]) <= (1 << 15) - 1:
        out = out.astype(jnp.int16)
    return out.T  # (L, T)


@functools.partial(jax.jit,
                   static_argnames=("precision", "max_T", "fuse_sym"))
def _rans_decode_scan_packed(bufs_u8, nbytes, freqs, cums, slots, counts,
                             precision: int, max_T: int, fuse_sym: bool):
    """Packed-table decode fast path for precision <= 14.

    P <= 14 implies freq-1 and cum each fit 14 bits, so (freq-1 | cum<<14)
    packs into ONE uint32 slot-indexed table — one in-scan gather for the
    state update instead of three (slot, freq, cum); the symbol id rides
    a u16 slot table (second gather), or is FUSED into the same u32 when
    P == 12 and the alphabet < 256 (idx<<24 | (f-1)<<12 | c — one gather
    total). The refill reads ONE pre-packed uint32 of the next 4 stream
    bytes in pop order instead of up to three byte gathers; P <= 14 needs
    at most 2 refill bytes per symbol (state >= l_base >> P = 4 after
    every update, and 4 << 16 >= l_base). Gathers dominate the decode
    step, so 2-3 gathers/symbol vs the generic path's ~6 is the win.
    Bit-exact with _rans_decode_scan
    (twin tests)."""
    L, cap = bufs_u8.shape
    l_base = jnp.uint32((1 << precision) << 2)
    lane_ids = jnp.arange(L)
    bufs = bufs_u8.astype(jnp.uint32)

    idx = slots.astype(jnp.int32)
    if slots.ndim == 2:
        f = jnp.take_along_axis(freqs, idx, axis=1).astype(jnp.uint32)
        c = jnp.take_along_axis(cums, idx, axis=1).astype(jnp.uint32)
    else:
        f = freqs[idx].astype(jnp.uint32)
        c = cums[idx].astype(jnp.uint32)
    if fuse_sym:  # P == 12, alphabet < 256: 8 + 12 + 12 bits
        fc_tbl = ((idx.astype(jnp.uint32) << 24) | ((f - 1) << 12) | c)
        sym_tbl = None
    else:         # (f-1 | c<<14) <= 28 bits; symbol separate u16
        fc_tbl = (f - 1) | (c << 14)
        sym_tbl = idx.astype(jnp.uint16)

    # rev32[:, i] = stream bytes i-1, i-2, i-3, i-4 packed LSB-first —
    # the next refill bytes in pop order, one gather away
    def shifted(k):
        return jnp.pad(bufs, ((0, 0), (k, 0)))[:, :cap]
    rev32 = (shifted(1) | (shifted(2) << 8) | (shifted(3) << 16)
             | (shifted(4) << 24))

    # init: read the tail metadata byte per lane (shared with the generic
    # path's framing, decode/entropy/rans.rs:30-56)
    pos = nbytes.astype(jnp.int32) - 1
    metadata = bufs[lane_ids, pos].astype(jnp.uint32)
    flag = (metadata >> jnp.uint32(6)).astype(jnp.int32)

    def read_back(k, val):
        states, pos = val
        do = k < flag
        pos2 = jnp.where(do, pos - 1, pos)
        byte = bufs[lane_ids, jnp.maximum(pos2, 0)].astype(jnp.uint32)
        states = jnp.where(do, (states << jnp.uint32(8)) | byte, states)
        return states, pos2

    states, pos = jax.lax.fori_loop(
        0, 3, read_back, (jnp.zeros((L,), jnp.uint32), pos))
    states = states | ((metadata & jnp.uint32(0x3F))
                      << (jnp.uint32(8) * flag.astype(jnp.uint32)))
    states = states + l_base

    rmask = jnp.uint32((1 << precision) - 1)
    m14 = jnp.uint32((1 << 14) - 1)

    def gather(tbl, r):
        if tbl.ndim == 2:
            return tbl[lane_ids, r]
        return tbl[r]

    def one_symbol(states, pos, i):
        active = i < counts
        w = rev32[lane_ids, jnp.maximum(pos, 0)]
        n1 = active & (states < l_base) & (pos > 0)
        s1 = jnp.where(n1, (states << jnp.uint32(8)) | (w & jnp.uint32(0xFF)),
                       states)
        p1 = pos - n1
        n2 = n1 & (s1 < l_base) & (p1 > 0)
        states = jnp.where(
            n2, (s1 << jnp.uint32(8)) | ((w >> jnp.uint32(8))
                                         & jnp.uint32(0xFF)), s1)
        pos = p1 - n2
        q = states >> jnp.uint32(precision)
        r = (states & rmask).astype(jnp.int32)
        e = gather(fc_tbl, r)
        if fuse_sym:
            out = (e >> jnp.uint32(24)).astype(jnp.uint8)
            fv = ((e >> jnp.uint32(12)) & jnp.uint32(0xFFF)) + jnp.uint32(1)
            cv = e & jnp.uint32(0xFFF)
            sentinel = jnp.uint8(0)
        else:
            out = gather(sym_tbl, r)
            fv = (e & m14) + jnp.uint32(1)
            cv = e >> jnp.uint32(14)
            sentinel = jnp.uint16(0)
        new_states = q * fv + r.astype(jnp.uint32) - cv
        states = jnp.where(active, new_states, states)
        return states, pos, jnp.where(active, out, sentinel)

    K = SYMBOLS_PER_STEP
    T_pad = -(-max_T // K) * K

    def step(carry, s):
        states, pos = carry
        outs = []
        for k in range(K):
            states, pos, o = one_symbol(states, pos, s * K + k)
            outs.append(o)
        return (states, pos), jnp.stack(outs)  # (K, L)

    (_, _), out = jax.lax.scan(step, (states, pos), jnp.arange(T_pad // K))
    return out.reshape(T_pad, L)[:max_T].T  # (L, T) uint8/uint16


def rans_decode_lanes(buffers: jnp.ndarray, nbytes: jnp.ndarray,
                      freqs: jnp.ndarray, cums: jnp.ndarray,
                      slots: jnp.ndarray, counts: jnp.ndarray,
                      precision: int = 12):
    """Decode L lanes: buffers (L, CAP) uint8, nbytes (L,), counts (L,)
    symbols per lane (max T). freqs/cums (S,) + slots (1<<P,) shared, or
    (L, S) / (L, 1<<P) per-lane. Returns (L, T) int symbols (int16 when
    the alphabet fits — the readback is usually the bottleneck)."""
    L, cap = buffers.shape
    T = int(np.asarray(counts).max()) if np.asarray(counts).size else 0
    max_T = T if T > 0 else cap * 2
    if precision <= 14 and int(np.asarray(freqs).shape[-1]) <= (1 << 16):
        # packed-slot fast path: 2-3 gathers per symbol instead of ~6
        # (fully fused to a single table gather for P=12 small alphabets).
        # Alphabets wider than 2^16 (legal at low precision when only the
        # occurrence COUNT is small) would truncate the u16 symbol table,
        # so they take the generic int32 path.
        fuse = precision == 12 and int(np.asarray(freqs).shape[-1]) <= 256
        return _rans_decode_scan_packed(
            jnp.asarray(buffers), jnp.asarray(nbytes), jnp.asarray(freqs),
            jnp.asarray(cums), jnp.asarray(slots), jnp.asarray(counts),
            precision=precision, max_T=max_T, fuse_sym=fuse)
    return _rans_decode_scan(
        jnp.asarray(buffers), jnp.asarray(nbytes), jnp.asarray(freqs),
        jnp.asarray(cums), jnp.asarray(slots), jnp.asarray(counts),
        precision=precision, max_T=max_T)


def encode_streams_device(symbol_streams: list[np.ndarray], freq_counts,
                          precision: int = 12) -> list[bytes]:
    """Host convenience wrapper: pad streams into lanes, run the device
    encoder, slice the per-lane byte blobs (bit-exact with the host coder)."""
    from ..entropy.rans import normalize_freq_counts

    dist = normalize_freq_counts(freq_counts, precision)
    cums = np.concatenate(([0], np.cumsum(dist)[:-1]))
    L = len(symbol_streams)
    T = max(len(s) for s in symbol_streams)
    symbols = np.zeros((L, T), dtype=np.int32)
    lengths = np.zeros(L, dtype=np.int32)
    for i, s in enumerate(symbol_streams):
        symbols[i, :len(s)] = s
        lengths[i] = len(s)
    bufs, nbytes = rans_encode_lanes(
        jnp.asarray(symbols), jnp.asarray(dist, dtype=jnp.uint32),
        jnp.asarray(cums, dtype=jnp.uint32), jnp.asarray(lengths),
        precision=precision)
    bufs = np.asarray(bufs)
    nbytes = np.asarray(nbytes)
    return [bufs[i, :nbytes[i]].tobytes() for i in range(L)]


def encode_direct_coded_streams_device(streams: list[np.ndarray]) -> list[bytes]:
    """Full DirectCoded symbol payloads for many independent streams with
    the rANS inner loop on the accelerator, bit-exact with the host
    ``encode_symbols(s, n, DIRECT_CODED, w)`` (tests pin this).

    Each stream gets its own frequency table (per-mesh tables in corpus
    batches); lanes are bucketed by rANS precision (a function of each
    stream's nonzero count) and each bucket runs as one device call with
    per-lane tables. Header bytes (method, bit length, serialized table,
    leb128 blob length) are assembled on host.
    """
    from ..entropy.rans import normalize_freq_counts, serialize_rans_table
    from ..entropy.symbol_coding import (
        DIRECT_CODED, bit_length_u64, rans_precision_for_bit_length)
    from ..wire.byte_io import ByteWriter
    from ..wire.varint import leb128_write

    L = len(streams)
    streams = [np.asarray(s, dtype=np.int64).ravel() for s in streams]
    precisions = np.empty(L, dtype=np.int64)
    dists: list[np.ndarray] = []
    for i, s in enumerate(streams):
        num_nonzero = int(np.count_nonzero(s))
        bl = int(bit_length_u64(np.asarray([num_nonzero]))[0]) + 1
        bl = max(1, min(18, bl))
        precisions[i] = rans_precision_for_bit_length(bl)
        max_symbol = int(s.max()) if len(s) else 0
        counts = np.bincount(s, minlength=max_symbol + 1)
        dists.append(normalize_freq_counts(counts, int(precisions[i])))

    def _pow2_at_least(x: int, floor: int) -> int:
        n = floor
        while n < x:
            n *= 2
        return n

    blobs: list[bytes | None] = [None] * L
    for prec in sorted(set(precisions.tolist())):
        lanes = [i for i in range(L) if precisions[i] == prec]
        # pad lane count and symbol length to buckets so the device scan
        # compiles once per (precision, bucket) instead of per corpus shape
        LB = _pow2_at_least(len(lanes), 16)
        T = _pow2_at_least(max((len(streams[i]) for i in lanes), default=1),
                           128)
        S = _pow2_at_least(max((len(dists[i]) for i in lanes), default=1),
                           16)
        sym = np.zeros((LB, T), dtype=np.int32)
        lengths = np.zeros(LB, dtype=np.int32)
        freqs = np.zeros((LB, S), dtype=np.uint32)
        cums = np.zeros((LB, S), dtype=np.uint32)
        freqs[:, 0] = 1 << int(prec)  # valid table for padding lanes
        for k, i in enumerate(lanes):
            sym[k, :len(streams[i])] = streams[i][::-1]  # reversed feed
            lengths[k] = len(streams[i])
            d = dists[i]
            freqs[k, :len(d)] = d
            freqs[k, len(d):] = 0
            cums[k, 1:len(d)] = np.cumsum(d)[:-1]
        bufs, nbytes = rans_encode_lanes(
            jnp.asarray(sym), jnp.asarray(freqs), jnp.asarray(cums),
            jnp.asarray(lengths), precision=int(prec))
        bufs = np.asarray(bufs)
        nbytes = np.asarray(nbytes)
        for k, i in enumerate(lanes):
            blobs[i] = bufs[k, :nbytes[k]].tobytes()

    out: list[bytes] = []
    for i in range(L):
        w = ByteWriter()
        w.write_u8(DIRECT_CODED)
        num_nonzero = int(np.count_nonzero(streams[i]))
        bl = max(1, min(18, int(bit_length_u64(
            np.asarray([num_nonzero]))[0]) + 1))
        w.write_u8(bl)
        serialize_rans_table(dists[i], w)
        leb128_write(len(blobs[i]), w)
        w.write_bytes(blobs[i])
        out.append(w.getvalue())
    return out


@jax.jit
def _flip_lanes(symbols_dev: jnp.ndarray) -> jnp.ndarray:
    B = symbols_dev.shape[0]
    return jnp.flip(symbols_dev.reshape(B, -1).astype(jnp.int32), axis=1)


@jax.jit
def _cast_u16(counts: jnp.ndarray) -> jnp.ndarray:
    return counts.astype(jnp.uint16)


@functools.partial(jax.jit, static_argnames=("n", "u16"))
def _counts_prefix(counts: jnp.ndarray, n: int, u16: bool) -> jnp.ndarray:
    """Occupied histogram prefix, u16 when every entry fits (halves the
    transfer bytes again)."""
    c = counts[:, :n]
    return c.astype(jnp.uint16) if u16 else c


# Build the per-lane rANS tables ON DEVICE (normalize + fixups) so the
# entropy scan can be dispatched without waiting for the histogram
# readback; the host only syncs a tiny (B, 4) summary, and the full
# table matrix rides back AFTER the scans are queued (the transfer
# overlaps their compute). Flip to False
# to force the legacy host-table path (kept for the sharded mesh_axis
# plane and as the A/B twin; byte oracle in tests).
DEVICE_TABLES = True


@jax.jit
def _normalize_tables_x64(counts, n_sym_arr):
    """Per-lane rANS table normalization on device, bit-identical to
    entropy/rans.py normalize_freq_counts_batch (which replicates the
    reference's f64 `floor(f/total*rp + 0.5)`, encode/entropy/rans.rs).

    Exactness argument: rp is a power of two, so the f64 expression
    rounds exactly once (the division; *rp and +0.5 are exact), with
    absolute error <= rp * 2^-53. The exact value f*rp/total sits either
    ON a half-integer boundary (then f/total is dyadic — denominator
    divides 2^prec+1 — hence exact in f64, both forms agree) or at
    distance >= 1/(2*total) >> rp*2^-53 from it. Therefore the pure
    integer form floor((2*f*rp + total) / (2*total)) used here equals
    the host's f64 computation for every input this encoder can see.

    Runs under scoped x64 (exact int64 — see ops/texcoords.py). Input
    counts (B, S) int32, n_sym_arr () int32.
    Returns (dist (B, S) int32, cums (B, S) int32 exclusive cumulative,
    prec (B,) int32 per-lane precisions, tiny (B, 4) int32) where tiny
    rows are [counts[:,0], num_symbols, total, pathological]."""
    B, S = counts.shape
    c = counts.astype(jnp.int64)
    nz = c > 0
    ns = (S - jnp.argmax(nz[:, ::-1], axis=1)).astype(jnp.int64)  # (B,)
    col = jnp.arange(S, dtype=jnp.int64)
    valid = col[None, :] < ns[:, None]
    f = jnp.where(valid, c, 0)
    total = f.sum(axis=1)                                        # (B,)
    # per-lane precision schedule — MUST mirror the host formulas
    # (bls from the zero-bin count, encode_group_entropy_device)
    num_nonzero = n_sym_arr.astype(jnp.int64) - c[:, 0]
    bl = (num_nonzero[:, None] >=
          (jnp.int64(1) << jnp.arange(32, dtype=jnp.int64))[None, :]
          ).sum(axis=1)
    bls = jnp.clip(bl + 1, 1, 18)
    prec = jnp.clip((3 * bls) // 2, 12, 20)
    rp = (jnp.int64(1) << prec)                                  # (B,)
    safe_total = jnp.maximum(total, 1)  # all-zero rows flagged by caller
    dist = ((2 * f * rp[:, None] + safe_total[:, None])
            // (2 * safe_total[:, None]))
    dist = jnp.where((dist == 0) & (f > 0), jnp.int64(1), dist)
    err = dist.sum(axis=1) - rp                                  # (B,)
    # stable-ascending rank order == unique key (clamped dist, col):
    # a clamped collision would need two entries summing > rp
    key = jnp.where(valid, dist, -1)
    kcl = jnp.clip(key + 1, 0, (1 << 20) - 1)
    S_pad = 1
    while S_pad < S:
        S_pad *= 2
    combined = kcl * jnp.int64(S_pad) + col[None, :]             # (B, S)
    if S_pad <= (1 << 12):
        # key < 2^20 * 2^12 + 2^12 <= 2^32: sort in uint32 (half the
        # bytes of an int64 sort; values are exact)
        combined = combined.astype(jnp.uint32)
    # under: add -err to the stable-order tail (largest combined key)
    tgt = jnp.argmax(combined, axis=1)
    dist = dist.at[jnp.arange(B), tgt].add(jnp.where(err < 0, -err, 0))
    # over: decrement each of the top-err entries by one (keys unique,
    # so exactly err entries clear the err-th descending threshold)
    desc = jnp.flip(jnp.sort(combined, axis=1), axis=1)
    e_ix = jnp.clip(err, 1, S) - 1
    thresh = jnp.take_along_axis(desc, e_ix[:, None], axis=1)    # (B, 1)
    dec = (err > 0)[:, None] & (combined >= thresh)
    dist = dist - dec.astype(jnp.int64)
    # the host's vectorized over-fixup only covers err <= num_symbols
    # (one decrement per entry); flag the pathological rest for a host
    # fallback instead of diverging
    patho = (err > ns) | (total == 0)
    tiny = jnp.stack([c[:, 0], ns, total, patho.astype(jnp.int64)],
                     axis=1).astype(jnp.int32)
    dist32 = dist.astype(jnp.int32)
    # exclusive per-lane cumulative table, full width — the scan's cum
    # input (the vprec flow never builds per-precision-group tables)
    cums = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32),
         jnp.cumsum(dist32[:, :-1], axis=1, dtype=jnp.int32)], axis=1)
    return dist32, cums, prec.astype(jnp.int32), tiny


def encode_group_entropy_device(symbols_dev, counts_dev,
                                _timings: dict | None = None,
                                mesh_axis=None) -> list[bytes]:
    """DirectCoded payloads for a topology-group batch with the symbols
    kept ON DEVICE end-to-end: `symbols_dev` (B, T, C) uint32/int32 from
    encode_step, `counts_dev` (B, bins) int32 the device histogram of
    the flattened per-mesh streams. Only the (small) counts and the
    compacted byte streams cross to the host. Bit-exact with
    `encode_symbols(..., DIRECT_CODED)` (pinned by tests)."""
    from ..entropy.rans import (normalize_freq_counts_batch,
                                serialize_rans_tables_batch)
    from ..entropy.symbol_coding import bit_length_u64

    import time as _time
    t0 = _time.perf_counter()
    B, T, C = symbols_dev.shape
    n_sym = T * C
    counts_dev = jnp.asarray(counts_dev)
    total_bins = int(counts_dev.shape[1])
    if DEVICE_TABLES:
        out = _group_entropy_device_tables(symbols_dev, counts_dev,
                                           _timings=_timings,
                                           mesh_axis=mesh_axis)
        if out is not None:
            return out
        # pathological normalization rows: fall through to the legacy
        # host-table path (bit-exact, just not overlapped)
    # occupied-prefix histogram transfer: residuals concentrate near 0, so
    # shipping all hist_bins columns wastes most of the transfer. The
    # prefix width is guessed from the last batch (no extra max-bin
    # sync); a truncated guess
    # shows up as a count deficit and retries at full width. The counts
    # SLICE dispatches before the flip so its readback is not queued
    # behind the (independent) flip on the serial device stream.
    hkey = (B, total_bins, n_sym)
    bins = min(total_bins, _HIST_BUCKET.get(hkey, 1024))
    counts_job = _counts_prefix(counts_dev, bins, n_sym < (1 << 16))
    # reversed-feed flip: dispatched after the counts slice, computed by
    # the device while the host reads the histogram and builds tables
    lanes_dev = _flip_lanes(jnp.asarray(symbols_dev))
    for attempt in range(2):
        raw_counts = np.asarray(counts_job)
        if _timings is not None:
            _timings["d2h_mb"] = (_timings.get("d2h_mb", 0.0)
                                  + raw_counts.nbytes / 1e6)
            _timings["n_readbacks"] = _timings.get("n_readbacks", 0) + 1
        counts = raw_counts.astype(np.int64)
        sums = counts.sum(axis=1)
        if np.all(sums == n_sym) or bins == total_bins:
            break
        bins = total_bins  # guess truncated an occupied bin: full retry
        counts_job = _counts_prefix(counts_dev, bins, n_sym < (1 << 16))
    cols_any = (counts > 0).any(axis=0)
    maxbin = int(counts.shape[1] - 1 - np.argmax(cols_any[::-1])) \
        if cols_any.any() else 0
    _HIST_BUCKET[hkey] = min(total_bins,
                             max(256, -(-(maxbin + 1) // 256) * 256) + 256)
    if _timings is not None:
        _timings["hist_sync"] = _time.perf_counter() - t0
        t0 = _time.perf_counter()

    # the device histogram DROPS out-of-range symbols; a deficit at FULL
    # width means hist_bins was too small for the residual range (the
    # lanes would encode symbols the table never saw -> corrupt
    # bitstream), so fail loudly and let the caller fall back / re-raise
    # instead of emitting garbage
    if not np.all(sums == n_sym):
        bad = int(np.flatnonzero(sums != n_sym)[0])
        raise ValueError(
            f"device histogram dropped symbols (lane {bad}: "
            f"{int(sums[bad])}/{n_sym} binned) — hist_bins too small for "
            "the symbol range")

    # per-lane table parameters from the device histogram; all-lane
    # vectorized (the per-lane python loop dominated this stage)
    num_nonzero = n_sym - counts[:, 0]
    bls = np.clip(bit_length_u64(num_nonzero.astype(np.uint64)) + 1, 1, 18)
    precisions = np.clip((3 * bls) // 2, 12, 20)  # schedule, vectorized
    dist, num_symbols = normalize_freq_counts_batch(counts, precisions)
    if _timings is not None:
        _timings["table_build"] = _time.perf_counter() - t0

    blobs: list[bytes | None] = [None] * B
    for prec in sorted(set(precisions.tolist())):
        in_group = precisions == prec
        S = 16
        while S < int(num_symbols[in_group].max()):
            S *= 2
        freqs = np.zeros((B, S), dtype=np.uint32)
        w = min(S, dist.shape[1])
        freqs[:, :w] = dist[:, :w]
        freqs[~in_group] = 0
        freqs[~in_group, 0] = 1 << int(prec)  # valid table, masked lanes
        cums = np.zeros_like(freqs)
        np.cumsum(freqs[:, :-1], axis=1, out=cums[:, 1:])
        # single-precision groups (the common case) run as one device call
        # over ALL lanes; mixed groups mask out foreign lanes via length 0
        lengths = np.where(in_group, n_sym, 0).astype(np.int32)
        ch = LANE_CHUNK
        if mesh_axis is None and B % ch == 0 and B >= 2 * ch:
            # pipelined lane chunks: queue every chunk's scan on the
            # device FIRST (one compiled program — the chunk start is a
            # traced scalar), then read back in order, so chunk k's
            # payload readback overlaps chunk k+1's compute.
            # Lanes are independent rANS streams: bytes are identical to
            # the one-shot scan (byte oracle in tests).
            jobs = []
            for c0 in range(0, B, ch):
                combined = _words_scan_chunk(
                    lanes_dev, np.int32(c0),
                    jnp.asarray(freqs[c0:c0 + ch]),
                    jnp.asarray(cums[c0:c0 + ch]),
                    jnp.asarray(lengths[c0:c0 + ch]),
                    precision=int(prec), ch=ch, compact=_words_compact(),
                    k=SYMBOLS_PER_STEP)
                # readback slices dispatch NOW so they sit between scans
                # in the in-order stream
                pre = _dispatch_words_readback(
                    combined, ch, n_sym, int(prec),
                    want_tiny=_timings is not None)
                jobs.append((c0, combined, pre))
            for c0, combined, pre in jobs:
                bufs, cnts, packed, nflush = _collect_words(
                    combined, ch, n_sym, int(prec), _timings=_timings,
                    _pre=pre)
                nbytes = _append_flush(bufs, cnts,
                                       packed.astype(np.uint64),
                                       nflush.astype(np.int64))
                for k in np.flatnonzero(in_group[c0:c0 + ch]):
                    blobs[c0 + k] = bufs[k, :nbytes[k]].tobytes()
            continue
        bufs, nbytes = rans_encode_lanes(
            lanes_dev, jnp.asarray(freqs), jnp.asarray(cums),
            jnp.asarray(lengths), precision=int(prec),
            _timings=_timings, mesh_axis=mesh_axis)
        for i in np.flatnonzero(in_group):
            blobs[i] = bufs[i, :nbytes[i]].tobytes()

    if _timings is not None:
        t0 = _time.perf_counter()
    tables = serialize_rans_tables_batch(dist, num_symbols)
    out = _assemble_payloads(bls, tables, blobs)
    if _timings is not None:
        _timings["assembly"] = _time.perf_counter() - t0
    return out


def _leb128_bytes(n: int) -> bytes:
    """leb128 as bytes: loop-free for the payload sizes this encoder
    emits, delegating bigger values to the wire module (one source of
    truth for the varint framing)."""
    if n < 0x80:
        return bytes((n,))
    if n < 0x4000:
        return bytes((n & 0x7F | 0x80, n >> 7))
    from ..wire.varint import leb128_bytes
    return leb128_bytes(n)


def _assemble_payloads(bls, tables, blobs) -> list[bytes]:
    """Final DirectCoded payload assembly: [tag, bit-length, table,
    leb128(len), stream] per lane, as a single bytes-join per lane (a
    ByteWriter per lane measurably dominates this stage at B in the
    hundreds)."""
    from ..entropy.symbol_coding import DIRECT_CODED

    tag = bytes((DIRECT_CODED,))
    return [b"".join((tag, bytes((int(bl),)), tb, _leb128_bytes(len(blob)),
                      blob))
            for bl, tb, blob in zip(bls, tables, blobs)]


def _group_entropy_device_tables(symbols_dev, counts_dev,
                                 _timings: dict | None = None,
                                 mesh_axis=None) -> list[bytes] | None:
    """encode_group_entropy_device with ZERO host syncs before the
    entropy scans: the tables (and per-lane precisions) are built on
    device (_normalize_tables_x64), the scans run the per-lane-precision
    kernel (_rans_scan_lanes_words_vprec), so histogram -> normalize ->
    scan dispatch back-to-back; the host then reads the tiny (B, 4)
    summary and the table matrix while the scans compute (reading an
    already-materialized buffer overlaps queued compute) and serializes
    the wire tables in the same window.
    Byte-identical to the legacy host-table path (oracle in tests).
    Under a 1-D ("data",) ``mesh_axis`` the scan lane-shards across
    chips (precisions shard with their lanes) — the full pipeline scales
    and bytes stay pinned (dryrun oracle). Returns None when any lane's
    normalization is pathological (err > num_symbols; caller falls
    back)."""
    from ..entropy.rans import serialize_rans_tables_batch
    from ..entropy.symbol_coding import bit_length_u64

    import time as _time
    t0 = _time.perf_counter()
    B, T, C = symbols_dev.shape
    n_sym = T * C
    with jax.enable_x64(True):
        dist_dev, cums_dev, prec_dev, tiny_job = _normalize_tables_x64(
            jnp.asarray(counts_dev), jnp.int32(n_sym))
    lanes_dev = _flip_lanes(jnp.asarray(symbols_dev))
    W = int(dist_dev.shape[1])

    def check_tiny(tiny):
        counts0, ns, totals, patho = tiny.astype(np.int64).T
        if patho.any():
            return None
        if not np.all(totals == n_sym):
            # the device histogram DROPS out-of-range symbols — a table
            # that never saw them would corrupt the bitstream
            bad = int(np.flatnonzero(totals != n_sym)[0])
            raise ValueError(
                f"device histogram dropped symbols (lane {bad}: "
                f"{int(totals[bad])}/{n_sym} binned) — hist_bins too "
                "small for the symbol range")
        return counts0, ns

    def read_tiny():
        tiny = np.asarray(tiny_job)
        if _timings is not None:
            _timings["d2h_mb"] = (_timings.get("d2h_mb", 0.0)
                                  + tiny.nbytes / 1e6)
            _timings["n_readbacks"] = _timings.get("n_readbacks", 0) + 1
        return check_tiny(tiny)

    wide = W > (1 << 14)
    if wide:
        # wide alphabets: reading the full-width table matrix would be
        # enormous, so pay the summary sync up front and dispatch an
        # occupied-prefix slice BEFORE the scans (it still overlaps them)
        got = read_tiny()
        if got is None:
            return None
        counts0, ns = got
        if _timings is not None:
            _timings["hist_sync"] = _time.perf_counter() - t0
            t0 = _time.perf_counter()
        maxS = min(W, -(-max(int(ns.max()), 1) // 256) * 256)
        dist_job = _pack_dist21(dist_dev, maxS)
    else:
        # narrow alphabets still waste the transfer at full width (residuals
        # concentrate near 0: e.g. 4096 bins with ~128 occupied is 8 MB
        # for a ~0.25 MB table at B=512). Same zero-sync trick as
        # _HIST_BUCKET: slice to the cached occupied-prefix guess from
        # the previous batch of this shape, verify against ns after the
        # sync, and re-read full width on the rare deficit. The tiny
        # summary rides as 4 leading columns so summary + tables cost
        # ONE readback.
        guess = min(W, _DIST_BUCKET.get((B, W), W))
        combo_job = _concat_tiny_dist(tiny_job, dist_dev, guess)

    # dispatch every scan chunk (one compiled per-lane-precision
    # program) with its readback slices interleaved — nothing here
    # waits on the host
    lengths_dev = jnp.full((B,), n_sym, jnp.int32)
    jobs = []
    ch = LANE_CHUNK
    if mesh_axis is None and B % ch == 0 and B >= 2 * ch:
        for c0 in range(0, B, ch):
            combined = _words_scan_chunk_vprec(
                lanes_dev, np.int32(c0), dist_dev, cums_dev,
                lengths_dev, prec_dev, ch=ch, compact=_words_compact(),
                k=SYMBOLS_PER_STEP)
            pre = _dispatch_words_readback(
                combined, ch, n_sym, -1, want_tiny=_timings is not None)
            jobs.append((c0, ch, combined, pre))
    else:
        combined = (_rans_scan_lanes_words_vprec_sharded(
            lanes_dev, dist_dev, cums_dev, lengths_dev, prec_dev,
            mesh_axis=mesh_axis, compact=_words_compact(),
            k=SYMBOLS_PER_STEP)
            if mesh_axis is not None else
            _rans_scan_lanes_words_vprec(
                lanes_dev, dist_dev, cums_dev, lengths_dev, prec_dev,
                compact=_words_compact(), k=SYMBOLS_PER_STEP))
        pre = _dispatch_words_readback(
            combined, B, n_sym, -1, want_tiny=_timings is not None)
        jobs.append((0, B, combined, pre))

    if not wide:
        # ONE readback: [tiny summary | dist prefix], materialized before
        # the scans so the transfer overlaps their compute
        raw = np.asarray(combo_job)
        if _timings is not None:
            _timings["d2h_mb"] = (_timings.get("d2h_mb", 0.0)
                                  + raw.nbytes / 1e6)
            _timings["n_readbacks"] = _timings.get("n_readbacks", 0) + 1
        got = check_tiny(raw[:, :4])
        if got is None:
            return None
        counts0, ns = got
        if _timings is not None:
            _timings["hist_sync"] = _time.perf_counter() - t0
            t0 = _time.perf_counter()
        dist32 = _unpack_dist21(raw[:, 4:], guess)
        need = int(ns.max()) if B else 1
        if dist32.shape[1] < need:
            # prefix guess truncated an occupied column: full re-read
            # (dist_dev is still materialized; rare by construction)
            dist32 = np.asarray(dist_dev)
            if _timings is not None:
                _timings["d2h_mb"] = (_timings.get("d2h_mb", 0.0)
                                      + dist32.nbytes / 1e6)
                _timings["n_readbacks"] = _timings.get("n_readbacks",
                                                       0) + 1
        _DIST_BUCKET[(B, W)] = min(W, -(-max(need, 1) // 256) * 256 + 256)
    else:
        packed = np.asarray(dist_job)
        if _timings is not None:
            _timings["d2h_mb"] = (_timings.get("d2h_mb", 0.0)
                                  + packed.nbytes / 1e6)
            _timings["n_readbacks"] = _timings.get("n_readbacks", 0) + 1
        dist32 = _unpack_dist21(packed, maxS)

    # host mirror of the device precision schedule (same integer ops;
    # only bls reaches the wire — the scan used the device copy)
    num_nonzero = (n_sym - counts0).astype(np.uint64)
    bls = np.clip(bit_length_u64(num_nonzero) + 1, 1, 18)
    dist = dist32.astype(np.int64)
    tables = serialize_rans_tables_batch(dist, ns)
    if _timings is not None:
        _timings["table_build"] = _time.perf_counter() - t0

    blobs: list[bytes | None] = [None] * B
    for c0, ch_n, combined, pre in jobs:
        bufs, cnts, packed, nflush = _collect_words(
            combined, ch_n, n_sym, -1, _timings=_timings, _pre=pre)
        nbytes = _append_flush(bufs, cnts, packed.astype(np.uint64),
                               nflush.astype(np.int64))
        for k in range(ch_n):
            blobs[c0 + k] = bufs[k, :nbytes[k]].tobytes()

    if _timings is not None:
        t0 = _time.perf_counter()
    out = _assemble_payloads(bls, tables, blobs)
    if _timings is not None:
        _timings["assembly"] = _timings.get("assembly", 0.0) \
            + _time.perf_counter() - t0
    return out
