"""Device multi-lane rANS must be bit-exact with the host coder."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpudraco.entropy.rans import RansDecoder, RansEncoder, normalize_freq_counts
from tpudraco.ops.rans_lanes import encode_streams_device, rans_decode_lanes
from tpudraco.wire import ByteReader


def _host_encode(stream, dist):
    enc = RansEncoder(dist, precision=12)
    enc.write_all(stream)
    return enc.flush()


def test_lanes_match_host_bytes():
    rng = np.random.RandomState(0)
    raw_counts = rng.randint(1, 50, size=37)
    dist = normalize_freq_counts(raw_counts, 12)
    streams = [rng.randint(0, 37, size=rng.randint(5, 400)).astype(np.int32)
               for _ in range(16)]
    device_blobs = encode_streams_device(streams, raw_counts)
    for s, blob in zip(streams, device_blobs):
        assert blob == _host_encode(s, dist)


def test_lanes_decode_roundtrip():
    rng = np.random.RandomState(1)
    raw_counts = rng.randint(1, 30, size=20)
    dist = normalize_freq_counts(raw_counts, 12)
    cums = np.concatenate(([0], np.cumsum(dist)[:-1]))
    slots = np.repeat(np.arange(len(dist)), dist)
    streams = [rng.randint(0, 20, size=120).astype(np.int32)
               for _ in range(8)]
    blobs = encode_streams_device(streams, raw_counts)

    cap = max(len(b) for b in blobs)
    bufs = np.zeros((8, cap), dtype=np.uint8)
    nbytes = np.zeros(8, dtype=np.int32)
    for i, b in enumerate(blobs):
        bufs[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        nbytes[i] = len(b)
    counts = np.full(8, 120, dtype=np.int32)
    out = np.asarray(rans_decode_lanes(
        jnp.asarray(bufs), jnp.asarray(nbytes),
        jnp.asarray(dist, dtype=jnp.uint32),
        jnp.asarray(cums, dtype=jnp.uint32),
        jnp.asarray(slots, dtype=jnp.int32), counts))
    # rANS decodes in reverse encode order
    for i, s in enumerate(streams):
        assert np.array_equal(out[i][:120], s[::-1])

    # cross-check one lane against the host decoder
    r = ByteReader(blobs[0])
    dec = RansDecoder(r, len(blobs[0]), dist, precision=12)
    assert np.array_equal(dec.read_all(120), streams[0][::-1])


def test_lanes_varying_lengths_and_skew():
    rng = np.random.RandomState(2)
    counts = np.zeros(9, dtype=np.int64)
    counts[0] = 1000  # heavily skewed: long renormalization runs
    counts[8] = 1
    streams = [np.zeros(rng.randint(1, 200), dtype=np.int32) for _ in range(5)]
    streams[2][:] = 8  # rare symbol everywhere -> max renorm pressure
    dist = normalize_freq_counts(counts, 12)
    blobs = encode_streams_device(streams, counts)
    for s, blob in zip(streams, blobs):
        assert blob == _host_encode(s, dist)


def test_per_lane_tables_roundtrip():
    """2D (per-lane) frequency tables: encode and decode lanes with
    different alphabets in one device call."""
    import jax.numpy as jnp
    from tpudraco.entropy.rans import normalize_freq_counts
    from tpudraco.ops.rans_lanes import rans_decode_lanes, rans_encode_lanes

    rng = np.random.default_rng(7)
    L, T, prec = 3, 200, 12
    streams = [rng.integers(0, 5 + 7 * i, size=T, dtype=np.int64)
               for i in range(L)]
    S = max(int(s.max()) + 1 for s in streams)
    freqs = np.zeros((L, S), np.uint32)
    cums = np.zeros((L, S), np.uint32)
    slots = np.zeros((L, 1 << prec), np.int32)
    sym = np.zeros((L, T), np.int32)
    for i, s in enumerate(streams):
        d = normalize_freq_counts(np.bincount(s), prec)
        freqs[i, :len(d)] = d
        cums[i, 1:len(d)] = np.cumsum(d)[:-1]
        for j, f in enumerate(d):
            slots[i, cums[i, j]:cums[i, j] + f] = j
        sym[i] = s
    lengths = np.full(L, T, np.int32)
    bufs, nbytes = rans_encode_lanes(jnp.asarray(sym), jnp.asarray(freqs),
                                     jnp.asarray(cums), jnp.asarray(lengths),
                                     precision=prec)
    # decode reads symbols back in reverse emission order
    out = rans_decode_lanes(bufs, np.asarray(nbytes), jnp.asarray(freqs),
                            jnp.asarray(cums), jnp.asarray(slots),
                            np.full(L, T), precision=prec)
    got = np.asarray(out)
    for i in range(L):
        assert np.array_equal(got[i][::-1], streams[i]), i


def test_encode_direct_coded_streams_device_bit_exact():
    """Device DirectCoded payloads must equal host encode_symbols bytes."""
    from tpudraco.entropy.symbol_coding import DIRECT_CODED, encode_symbols
    from tpudraco.ops.rans_lanes import encode_direct_coded_streams_device
    from tpudraco.wire import ByteWriter

    rng = np.random.default_rng(3)
    streams = [
        rng.integers(0, 40, size=333, dtype=np.uint64),
        rng.integers(0, 3, size=50, dtype=np.uint64),      # small alphabet
        np.zeros(64, dtype=np.uint64),                      # all zero
        rng.integers(0, 5000, size=1200, dtype=np.uint64),  # high precision
    ]
    got = encode_direct_coded_streams_device(streams)
    for i, s in enumerate(streams):
        w = ByteWriter()
        encode_symbols(s, 1, DIRECT_CODED, w)
        assert got[i] == w.getvalue(), f"stream {i}"


def test_group_entropy_pipelined_chunks_bit_exact(monkeypatch):
    """The lane-chunked pipelined group encoder (scan dispatch-ahead +
    overlapped readbacks) must produce payloads byte-identical to host
    encode_symbols AND to the one-shot (unchunked) device path."""
    from tpudraco.entropy.symbol_coding import DIRECT_CODED, encode_symbols
    from tpudraco.ops import rans_lanes
    from tpudraco.wire import ByteWriter

    rng = np.random.default_rng(7)
    B, T, C = 16, 40, 3
    # skewed residual-like symbols so per-lane tables differ
    syms = (rng.integers(0, 9, size=(B, T, C)) ** 2).astype(np.int32)
    bins = 128
    counts = np.stack([np.bincount(s.ravel(), minlength=bins)
                       for s in syms]).astype(np.int32)

    one_shot = rans_lanes.encode_group_entropy_device(
        jnp.asarray(syms), jnp.asarray(counts))
    monkeypatch.setattr(rans_lanes, "LANE_CHUNK", 4)  # forces 4 chunks
    # ... through BOTH table flows: the vprec device-tables branch and
    # the legacy static-precision host-tables branch (each has its own
    # chunk dispatch loop)
    for dtab in (True, False):
        monkeypatch.setattr(rans_lanes, "DEVICE_TABLES", dtab)
        chunked = rans_lanes.encode_group_entropy_device(
            jnp.asarray(syms), jnp.asarray(counts))
        assert chunked == one_shot, f"tables={dtab}"
        for i in range(B):
            w = ByteWriter()
            encode_symbols(syms[i].ravel().astype(np.uint64), C,
                           DIRECT_CODED, w)
            assert chunked[i] == w.getvalue(), f"tables={dtab} lane {i}"


def test_word_packed_scan_matches_dense():
    """Fast-path/twin invariant for the entropy scan: the word-packed
    emission path (_rans_scan_lanes_words, default) and the dense
    byte-slot lax.scan twin (_rans_scan_lanes) must produce identical
    buffers for ragged lane lengths and both table shapes."""
    import numpy as np

    from tpudraco.entropy.rans import normalize_freq_counts
    from tpudraco.ops.rans_lanes import (_append_flush, _rans_scan_lanes,
                                         rans_encode_lanes)

    rng = np.random.RandomState(5)
    L, T = 20, 700
    syms = rng.randint(0, 37, (L, T)).astype(np.int32)
    lengths = rng.randint(1, T + 1, L).astype(np.int32)
    lengths[0], lengths[1] = 0, T  # degenerate + full lanes
    dist = normalize_freq_counts(np.bincount(syms.ravel()), 12)
    cums = np.concatenate([[0], np.cumsum(dist)[:-1]])
    per_lane = (np.broadcast_to(dist, (L, len(dist))),
                np.broadcast_to(cums, (L, len(cums))))
    for freqs, cm in ((dist, cums), per_lane):
        freqs = np.ascontiguousarray(freqs, np.uint32)
        cm = np.ascontiguousarray(cm, np.uint32)
        buf_w, n_w = rans_encode_lanes(syms, freqs, cm, lengths)
        compacted, counts, packed, nflush = _rans_scan_lanes(
            syms, freqs, cm, lengths, precision=12)
        buf_d = np.zeros((L, 3 * T + 8), np.uint8)
        got = np.asarray(compacted)
        buf_d[:, :got.shape[1]] = got
        n_d = _append_flush(buf_d, np.asarray(counts).astype(np.int64),
                            np.asarray(packed).astype(np.uint64),
                            np.asarray(nflush).astype(np.int64))
        assert np.array_equal(n_w, n_d)
        for i in range(L):
            assert buf_w[i, :n_w[i]].tobytes() == \
                buf_d[i, :n_d[i]].tobytes(), i


import pytest


@pytest.mark.parametrize("prec,alpha_max", [(12, 50), (12, 400), (13, 60),
                                            (14, 300)])
def test_decode_packed_matches_generic(prec, alpha_max):
    """Twin invariant for the P<=14 packed-table decode fast path (fused
    single-gather form for P=12 small alphabets, fc+sym two-table form
    otherwise): identical symbols to the generic scan for ragged counts
    and per-lane tables."""
    import numpy as np

    from tpudraco.entropy.rans import normalize_freq_counts
    from tpudraco.ops.rans_lanes import (_rans_decode_scan,
                                         rans_decode_lanes,
                                         rans_encode_lanes)
    import jax.numpy as jnp

    rng = np.random.RandomState(11)
    L, T = 24, 600
    counts_per = rng.randint(1, T + 1, L).astype(np.int64)
    counts_per[0] = T
    syms = np.zeros((L, T), np.int32)
    dists, slot_rows = [], []
    S = 16
    while S < alpha_max:
        S *= 2
    for i in range(L):
        a = rng.randint(2, alpha_max)  # per-lane alphabet
        s = rng.randint(0, a, counts_per[i])
        syms[i, :counts_per[i]] = s[::-1]  # reversed feed
        d = normalize_freq_counts(np.bincount(s, minlength=a), prec)
        dists.append(d)
    freqs = np.zeros((L, S), np.uint32)
    cums = np.zeros((L, S), np.uint32)
    slots = np.zeros((L, 1 << prec), np.int32)
    for i, d in enumerate(dists):
        freqs[i, :len(d)] = d
        cums[i, 1:len(d)] = np.cumsum(d)[:-1]
        reps = np.repeat(np.arange(len(d)), d)
        slots[i, :len(reps)] = reps
    bufs, nbytes = rans_encode_lanes(
        jnp.asarray(syms), jnp.asarray(freqs), jnp.asarray(cums),
        jnp.asarray(counts_per.astype(np.int32)), precision=prec)

    fast = np.asarray(rans_decode_lanes(
        jnp.asarray(bufs), jnp.asarray(nbytes), jnp.asarray(freqs),
        jnp.asarray(cums), jnp.asarray(slots), counts_per,
        precision=prec))
    want_dtype = np.uint8 if (prec == 12 and S <= 256) else np.uint16
    assert fast.dtype == want_dtype  # packed path taken
    slow = np.asarray(_rans_decode_scan(
        jnp.asarray(bufs), jnp.asarray(nbytes), jnp.asarray(freqs),
        jnp.asarray(cums), jnp.asarray(slots),
        jnp.asarray(counts_per), precision=prec, max_T=T))
    for i in range(L):
        n = counts_per[i]
        assert np.array_equal(fast[i, :n].astype(np.int64),
                              slow[i, :n].astype(np.int64)), i
        # and both give back the original (un-reversed) stream
        assert np.array_equal(fast[i, :n].astype(np.int32),
                              syms[i, :n][::-1]), i


def test_decode_wide_alphabet_low_precision():
    """Regression (round-3 review): precision tracks the nonzero
    OCCURRENCE count, not the alphabet width, so a P=12 stream can carry
    symbol values beyond 2^16. The packed decode path's u16 symbol table
    would truncate them (69999 -> 4463); such streams must take the
    generic int32 path and round-trip exactly."""
    import numpy as np

    from tpudraco.entropy.rans import normalize_freq_counts
    from tpudraco.ops.rans_lanes import rans_decode_lanes, rans_encode_lanes
    import jax.numpy as jnp

    prec = 12
    stream = np.array([0, 69999, 3, 0, 69999, 1, 2, 3] * 4, np.int64)
    counts = np.bincount(stream)
    dist = normalize_freq_counts(counts, prec)
    S = len(dist)
    cums = np.concatenate([[0], np.cumsum(dist)[:-1]])
    slots = np.repeat(np.arange(S), dist).astype(np.int32)

    syms = stream[::-1].astype(np.int32)[None, :]  # reversed feed, 1 lane
    bufs, nbytes = rans_encode_lanes(
        jnp.asarray(syms), jnp.asarray(dist.astype(np.uint32)),
        jnp.asarray(cums.astype(np.uint32)),
        jnp.asarray(np.array([len(stream)], np.int32)), precision=prec)
    got = np.asarray(rans_decode_lanes(
        jnp.asarray(bufs), jnp.asarray(nbytes),
        jnp.asarray(dist.astype(np.uint32)),
        jnp.asarray(cums.astype(np.uint32)), jnp.asarray(slots),
        np.array([len(stream)], np.int64), precision=prec))
    assert got.dtype.itemsize >= 4  # generic path (no u16 truncation)
    assert np.array_equal(got[0].astype(np.int64), stream)


def test_normalize_tables_device_bit_exact():
    """_normalize_tables_x64 (pure int64 on device) must reproduce
    normalize_freq_counts_batch (host f64 floor(f/total*rp + 0.5)) for
    adversarial count matrices: interior zeros, exact rounding ties
    (dyadic f*rp/total), single-symbol rows, extreme skew, and every
    precision the schedule can pick. The module docstring's exactness
    argument is the contract; this is its fuzz."""
    import jax

    from tpudraco.entropy.rans import normalize_freq_counts_batch
    from tpudraco.entropy.symbol_coding import bit_length_u64
    from tpudraco.ops.rans_lanes import _normalize_tables_x64

    rng = np.random.default_rng(13)
    S = 96
    rows = []
    # skewed random rows with interior zero gaps
    for k in range(24):
        r = (rng.integers(0, 40, size=S) ** 2) * rng.integers(
            0, 2, size=S)
        if r.sum() == 0:
            r[0] = 1
        rows.append(r)
    # exact-tie construction: total a power of two, f*rp/total = k - 0.5
    tie = np.zeros(S, dtype=np.int64)
    tie[0] = 1
    tie[1] = 3
    tie[2] = 4  # total 8; with rp=2^12: 1*4096/8 = 512 exactly, no tie;
    rows.append(tie)
    tie2 = np.zeros(S, dtype=np.int64)
    tie2[0] = 1
    tie2[5] = 2047  # total 2048 (pow2): 1*rp/2048 at rp 2^12 -> 2.0;
    rows.append(tie2)
    one = np.zeros(S, dtype=np.int64)
    one[7] = 5000  # single symbol -> dist[7] = rp
    rows.append(one)
    counts = np.stack(rows).astype(np.int64)

    n_syms = counts.sum(axis=1)
    # the group encoder derives precision from the zero bin; emulate the
    # same schedule per row for the host reference
    num_nonzero = (n_syms - counts[:, 0]).astype(np.uint64)
    bls = np.clip(bit_length_u64(num_nonzero) + 1, 1, 18)
    precisions = np.clip((3 * bls) // 2, 12, 20)
    want_dist, want_ns = normalize_freq_counts_batch(counts, precisions)

    # device path needs one shared n_sym; run row-by-row (B=1) so each
    # row's schedule matches
    for b in range(counts.shape[0]):
        with jax.enable_x64(True):
            dist, cums, prec, tiny = _normalize_tables_x64(
                jnp.asarray(counts[b:b + 1].astype(np.int32)),
                jnp.int32(int(n_syms[b])))
        dist, cums, tiny = (np.asarray(dist), np.asarray(cums),
                            np.asarray(tiny))
        assert tiny[0, 3] == 0, f"row {b} flagged pathological"
        assert tiny[0, 1] == want_ns[b], f"row {b} num_symbols"
        assert np.array_equal(dist[0].astype(np.int64),
                              want_dist[b]), f"row {b}"
        assert int(np.asarray(prec)[0]) == precisions[b], f"row {b} prec"
        want_cums = np.concatenate([[0], np.cumsum(want_dist[b])[:-1]])
        assert np.array_equal(cums[0].astype(np.int64), want_cums), \
            f"row {b} cums"


def test_group_entropy_device_tables_twin(monkeypatch):
    """DEVICE_TABLES on/off must produce identical payload lists (the
    device-normalized flow vs the legacy host-table flow), both equal to
    host encode_symbols."""
    from tpudraco.entropy.symbol_coding import DIRECT_CODED, encode_symbols
    from tpudraco.ops import rans_lanes
    from tpudraco.wire import ByteWriter

    rng = np.random.default_rng(21)
    B, T, C = 24, 50, 3
    syms = (rng.integers(0, 11, size=(B, T, C)) ** 2).astype(np.int32)
    # force MIXED per-lane precisions: near-constant lanes get a tiny
    # nonzero count (low precision), dense lanes keep the full alphabet
    # — the vprec kernel runs them in ONE program, the legacy path in
    # per-precision groups; bytes must still agree
    syms[:8] = (rng.integers(0, 2, size=(8, T, C)) * 100).astype(np.int32)
    counts = np.stack([np.bincount(s.ravel(), minlength=160)
                       for s in syms]).astype(np.int32)

    monkeypatch.setattr(rans_lanes, "DEVICE_TABLES", True)
    dev = rans_lanes.encode_group_entropy_device(
        jnp.asarray(syms), jnp.asarray(counts))
    monkeypatch.setattr(rans_lanes, "DEVICE_TABLES", False)
    host = rans_lanes.encode_group_entropy_device(
        jnp.asarray(syms), jnp.asarray(counts))
    assert dev == host
    for i in range(B):
        w = ByteWriter()
        encode_symbols(syms[i].ravel().astype(np.uint64), C,
                       DIRECT_CODED, w)
        assert dev[i] == w.getvalue(), f"lane {i}"


def test_high_entropy_deep_precision_lanes():
    """Regression (round-3 review): high-entropy lanes at precision >=
    17 legally emit MORE than 2 bytes/symbol, overflowing the old 2T+8
    host buffer cap (reproduced IndexError). Uniform symbols over a wide
    alphabet force precision 20, the u8 table high bits, the wide
    (W > 2^14) dist-prefix branch, AND > 2T output bytes; payloads must
    byte-match host encode_symbols through both table flows."""
    from tpudraco.entropy.symbol_coding import DIRECT_CODED, encode_symbols
    from tpudraco.ops import rans_lanes
    from tpudraco.wire import ByteWriter

    rng = np.random.default_rng(3)
    B, T, C = 4, 6000, 3
    W = 1 << 15  # uniform over 32k values -> ~15 bits/symbol, prec 20
    syms = rng.integers(0, W, size=(B, T, C)).astype(np.int32)
    counts = np.stack([np.bincount(s.ravel(), minlength=W)
                       for s in syms]).astype(np.int32)

    want = []
    for i in range(B):
        w = ByteWriter()
        encode_symbols(syms[i].ravel().astype(np.uint64), C,
                       DIRECT_CODED, w)
        want.append(w.getvalue())
    # sanity: this workload really exceeds the old 2T+8 cap
    assert max(len(b) for b in want) > 2 * T * C + 8

    for dtab in (True, False):
        prev = rans_lanes.DEVICE_TABLES
        rans_lanes.DEVICE_TABLES = dtab
        try:
            got = rans_lanes.encode_group_entropy_device(
                jnp.asarray(syms), jnp.asarray(counts))
        finally:
            rans_lanes.DEVICE_TABLES = prev
        for i in range(B):
            assert got[i] == want[i], f"tables={dtab} lane {i}"


def test_group_entropy_randomized_sweep(monkeypatch):
    """Randomized property sweep over the sync-free device-tables flow:
    random batch widths (odd sizes, chunk-divisible sizes), symbol
    counts, alphabet widths, and skews — every payload must byte-match
    host encode_symbols. Catches shape/precision corners the targeted
    tests miss."""
    from tpudraco.entropy.symbol_coding import DIRECT_CODED, encode_symbols
    from tpudraco.ops import rans_lanes
    from tpudraco.wire import ByteWriter

    rng = np.random.default_rng(99)
    monkeypatch.setattr(rans_lanes, "LANE_CHUNK", 8)
    for trial in range(6):
        B = int(rng.integers(1, 40))
        if trial == 5:
            B = 16  # exercise the chunked branch (B % 8 == 0, B >= 16)
        T = int(rng.integers(1, 120))
        C = int(rng.choice([1, 2, 3]))
        width = int(rng.choice([2, 17, 300, 5000]))
        skew = float(rng.choice([0.5, 2.0, 8.0]))
        u = rng.random(size=(B, T, C)) ** skew
        syms = (u * width).astype(np.int32)
        bins = 1 << int(np.ceil(np.log2(max(width, 2))))
        counts = np.stack([np.bincount(s.ravel(), minlength=bins)
                           for s in syms]).astype(np.int32)
        got = rans_lanes.encode_group_entropy_device(
            jnp.asarray(syms), jnp.asarray(counts))
        for i in range(B):
            w = ByteWriter()
            encode_symbols(syms[i].ravel().astype(np.uint64), C,
                           DIRECT_CODED, w)
            assert got[i] == w.getvalue(), \
                f"trial {trial} (B={B} T={T} C={C} w={width}) lane {i}"


def test_words_compact_marks_twin():
    """WORDS_COMPACT="marks" (sort-free block compaction: in-register
    per-step slots + scatter-max/cummax/gather concat) and "sortkv"
    (fused stable key-value sort, no separate gather) must be
    byte-identical to the "sort" default through BOTH table flows, at
    mixed per-lane precisions, and at high entropy (max flush density —
    exercises the per-step block-slot bound BW and the cap_w edge)."""
    from tpudraco.entropy.symbol_coding import DIRECT_CODED, encode_symbols
    from tpudraco.ops import rans_lanes
    from tpudraco.wire import ByteWriter

    rng = np.random.default_rng(17)
    cases = []
    B, T, C = 24, 50, 3
    syms = (rng.integers(0, 11, size=(B, T, C)) ** 2).astype(np.int32)
    syms[:8] = (rng.integers(0, 2, size=(8, T, C)) * 100).astype(np.int32)
    cases.append((syms, 160))
    # high entropy: uniform over 2^13 values -> deep precision, ~2+
    # bytes/symbol, the worst flush density the wire can produce
    cases.append((rng.integers(0, 1 << 13,
                               size=(4, 900, 3)).astype(np.int32),
                  1 << 13))
    try:
        for syms, bins in cases:
            counts = np.stack([np.bincount(s.reshape(-1), minlength=bins)
                               for s in syms]).astype(np.int32)
            outs = {}
            for mode in ("sort", "sortkv", "marks"):
                rans_lanes.set_words_compact(mode)
                for dtab in (True, False):
                    prev = rans_lanes.DEVICE_TABLES
                    rans_lanes.DEVICE_TABLES = dtab
                    try:
                        outs[(mode, dtab)] = \
                            rans_lanes.encode_group_entropy_device(
                                jnp.asarray(syms), jnp.asarray(counts))
                    finally:
                        rans_lanes.DEVICE_TABLES = prev
            ref = outs[("sort", True)]
            assert all(v == ref for v in outs.values())
            w = ByteWriter()
            encode_symbols(syms[0].reshape(-1).astype(np.uint64),
                           syms.shape[2], DIRECT_CODED, w)
            assert ref[0] == w.getvalue()
    finally:
        rans_lanes.set_words_compact(None)


def test_pack_dist21_roundtrip():
    """The 21-bit table-readback bitpack must be exact over the full
    normalized-freq range [0, 2^20], odd widths included, and must mask
    out-of-range garbage (pathological lanes) instead of corrupting
    neighbors."""
    from tpudraco.ops.rans_lanes import _pack_dist21, _unpack_dist21

    rng = np.random.default_rng(7)
    for B, S, g in ((3, 4096, 4096), (5, 300, 257), (1, 64, 33),
                    (2, 32, 32)):
        d = rng.integers(0, (1 << 20) + 1, size=(B, S)).astype(np.int32)
        got = _unpack_dist21(np.asarray(_pack_dist21(jnp.asarray(d), g)),
                             g)
        assert np.array_equal(got, d[:, :g]), (B, S, g)
    # garbage beyond 21 bits in one row must not bleed across the pack
    d = np.zeros((2, 32), np.int32)
    d[0] = -1  # 0xFFFFFFFF
    d[1, :4] = [1 << 20, 0, 5, 123456]
    got = _unpack_dist21(np.asarray(_pack_dist21(jnp.asarray(d), 32)), 32)
    assert np.array_equal(got[1], d[1])


def test_dist_prefix_deficit_retry():
    """The zero-sync occupied-prefix readback of the device-built table
    matrix (_DIST_BUCKET) trains its guess on the previous batch of the
    same shape; a following batch with a wider occupied range must hit
    the deficit retry and still serialize byte-exact tables."""
    from tpudraco.entropy.symbol_coding import DIRECT_CODED, encode_symbols
    from tpudraco.ops import rans_lanes
    from tpudraco.wire import ByteWriter

    rng = np.random.default_rng(41)
    B, T, C, bins = 6, 150, 3, 4096

    def check(width):
        syms = rng.integers(0, width, size=(B, T, C)).astype(np.int32)
        counts = np.stack([np.bincount(s.ravel(), minlength=bins)
                           for s in syms]).astype(np.int32)
        got = rans_lanes.encode_group_entropy_device(
            jnp.asarray(syms), jnp.asarray(counts))
        for i in range(B):
            w = ByteWriter()
            encode_symbols(syms[i].ravel().astype(np.uint64), C,
                           DIRECT_CODED, w)
            assert got[i] == w.getvalue(), f"width {width} lane {i}"

    rans_lanes._DIST_BUCKET.pop((B, bins), None)
    check(16)    # trains a ~512-column guess
    assert rans_lanes._DIST_BUCKET.get((B, bins), bins) < bins
    check(3500)  # occupied range far past the guess: deficit path
    assert rans_lanes._DIST_BUCKET[(B, bins)] >= 3500

@pytest.mark.parametrize("L,T,vprec", [
    (24, 640, False),   # ragged lanes, T a multiple of K
    (37, 613, False),   # L odd, T not a multiple of K
    (37, 613, True),    # per-lane precisions (the device-tables flow)
    (5, 131, True),     # a handful of lanes
])
def test_words_scan_matches_host(L, T, vprec):
    """The words scan, unpacked as the encoder unpacks it, gives every
    lane the host rANS coder's bytes for ragged lengths (empty lanes
    included), per-lane precisions 12..20, and symbol counts that are
    not a multiple of SYMBOLS_PER_STEP."""
    from tpudraco.ops import rans_lanes

    rng = np.random.default_rng(L * 1000 + T)
    syms = (rng.integers(0, 13, size=(L, T)) ** 2).astype(np.int32)
    lengths = rng.integers(0, T + 1, size=L).astype(np.int32)
    lengths[0], lengths[1] = T, 0
    precs = rng.integers(12, 21, size=L) if vprec else np.full(L, 12)
    S = 256
    freqs = np.zeros((L, S), np.uint32)
    for i in range(L):
        d = normalize_freq_counts(
            np.bincount(syms[i], minlength=S)[:S], int(precs[i]))
        freqs[i, :len(d)] = d
    cums = np.concatenate([np.zeros((L, 1), np.uint32),
                           np.cumsum(freqs, axis=1)[:, :-1]],
                          axis=1).astype(np.uint32)
    args = [jnp.asarray(a) for a in (syms, freqs, cums, lengths)]
    k = rans_lanes.SYMBOLS_PER_STEP
    if vprec:
        combined = rans_lanes._rans_scan_lanes_words_vprec(
            *args, jnp.asarray(precs.astype(np.uint32)), compact="sortkv",
            k=k)
    else:
        combined = rans_lanes._rans_scan_lanes_words(
            *args, precision=12, compact="sortkv", k=k)
    bufs, counts, packed, nflush = rans_lanes._collect_words(
        combined, L, T, -1)
    nbytes = rans_lanes._append_flush(
        bufs, counts, np.asarray(packed).astype(np.uint64),
        np.asarray(nflush).astype(np.int64))
    for i in range(L):
        enc = RansEncoder(freqs[i], precision=int(precs[i]))
        enc.write_all(syms[i, :lengths[i]])
        assert bufs[i, :nbytes[i]].tobytes() == enc.flush(), f"lane {i}"
