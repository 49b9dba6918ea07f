"""Device (JAX/XLA) data-plane kernels for the encode pipeline.

These mirror the host numpy reference implementations bit-for-bit
(quantization math is float32, truncation toward zero) and run batched over
SoA vertex arrays in HBM. XLA fuses the elementwise chain
(quantize -> gather-predict -> residual -> zigzag) into a single pass.

Reference semantics:
  - quantization: encode/attribute/portabilization/
    quantization_coordinate_wise.rs (min seeded with 0, shared delta_max)
  - parallelogram prediction: shared/attribute/prediction_scheme/
    mesh_parallelogram_prediction.rs:186-237 (pure gathers given the
    precomputed traversal order + visited masks — the encoder-side
    prediction has no sequential dependency)
  - zigzag: utils/mod.rs:152-168
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def f32_div_exact(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """IEEE-754 round-to-nearest-even float32 division (finite a, b != 0),
    bit-identical to numpy/Rust on every backend.

    A divide computed by reciprocal refinement (as accelerator backends
    may lower it) is off by 1 ulp on a large fraction of inputs — enough
    to flip quantized values sitting on .5 boundaries. This computes the
    quotient mantissa by 32-bit integer long division (4 x 7-bit steps,
    no int64 needed without
    jax_enable_x64) and rounds exactly; signs factor out (rounding is
    sign-symmetric).

    Caveat: quotients in the SUBNORMAL range double-round (the 24-bit
    mantissa rounds first, ldexp then re-rounds to subnormal precision)
    and may differ from a single correctly-rounded step by 1 ulp of a
    subnormal. Immaterial for every codec use: a subnormal quotient
    (< 2^-126) always quantizes/scales to integer 0 on both sides."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    sign = jnp.sign(a) * jnp.sign(b)
    a = jnp.abs(a)
    b = jnp.abs(b)
    ma, ea = jnp.frexp(a)   # a = ma * 2^ea, ma in [0.5, 1)
    mb, eb = jnp.frexp(b)
    ia = (ma * jnp.float32(1 << 24)).astype(jnp.int32)  # [2^23, 2^24)
    ib = (mb * jnp.float32(1 << 24)).astype(jnp.int32)
    ib = jnp.maximum(ib, 1)  # only reachable where a == 0 masks the result

    # qhat = floor(ia * 2^28 / ib) in (2^27, 2^29); 7 bits per step keeps
    # every intermediate inside int32
    qhat = jnp.zeros_like(ia)
    rem = ia
    for _ in range(4):
        rem = rem << 7
        d = rem // ib
        rem = rem - d * ib
        qhat = (qhat << 7) | d
    sticky = rem != 0

    ge1 = qhat >= (1 << 28)         # quotient ratio >= 1
    k = jnp.where(ge1, 5, 4)        # discarded low bits
    r = qhat >> k
    disc = qhat & ((1 << k) - 1)
    half = jnp.int32(1) << (k - 1)
    round_up = (disc > half) | ((disc == half) & (sticky | ((r & 1) == 1)))
    r = r + round_up.astype(jnp.int32)
    # mantissa overflow after rounding: 2^24 -> renormalize
    ovf = r == (1 << 24)
    r = jnp.where(ovf, r >> 1, r)
    e = ea - eb + jnp.where(ge1, 0, -1) + ovf.astype(jnp.int32)

    out = jnp.ldexp(r.astype(jnp.float32), e - 23)
    out = jnp.where(a == 0, jnp.float32(0.0), out)
    return (sign * out).astype(jnp.float32)


def f32_mul_exact(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """IEEE-754 round-to-nearest-even float32 product (finite inputs),
    bit-identical to numpy on every backend, computed WITHOUT a float
    multiply so no compiler can contract it with a neighboring add.

    Motivation: XLA:CPU fuses `a * b + c` into an FMA THROUGH
    `lax.optimization_barrier`, bitcast round-trips, scoped f64 upcasts,
    and every xla_cpu_* flag on this jaxlib, and a GPU compiler may
    contract multiply-adds as well — the only safe form of "round the product
    before the add" is to not emit a float multiply at all, on every
    backend, so the CPU tests run the code the GPU runs.

    The 48-bit exact mantissa product is held in int32 limbs via 12-bit
    splits; round-to-nearest-even on the discarded bits; ldexp scales.
    Subnormal caveat matches f32_div_exact (double rounding near
    2^-126; immaterial for the codec's quantization uses)."""
    shape = jnp.broadcast_shapes(jnp.shape(a), jnp.shape(b))
    a = jnp.broadcast_to(jnp.asarray(a, jnp.float32), shape)
    b = jnp.broadcast_to(jnp.asarray(b, jnp.float32), shape)
    sign = jnp.sign(a) * jnp.sign(b)
    ma, ea = jnp.frexp(jnp.abs(a))  # |a| = ma * 2^ea, ma in [0.5, 1)
    mb, eb = jnp.frexp(jnp.abs(b))
    ia = (ma * jnp.float32(1 << 24)).astype(jnp.int32)  # [2^23, 2^24)
    ib = (mb * jnp.float32(1 << 24)).astype(jnp.int32)
    ah, al = ia >> 12, ia & 0xFFF
    bh, bl = ib >> 12, ib & 0xFFF
    # p = ia * ib = hi * 2^24 + mid * 2^12 + lo, every limb < 2^25
    hi = ah * bh
    mid = ah * bl + al * bh
    lo = al * bl
    mid_lo = ((mid & 0xFFF) << 12) + lo      # < 2^25
    ph = hi + (mid >> 12) + (mid_lo >> 24)   # p >> 24, in [2^22, 2^24)
    low24 = mid_lo & 0xFFFFFF                # p & (2^24 - 1)
    # normalize: p in [2^47, 2^48) keeps ph as the 24-bit mantissa;
    # p in [2^46, 2^47) shifts one bit up from low24
    big = ph >= (1 << 23)
    r = jnp.where(big, ph, (ph << 1) | (low24 >> 23))
    rnd_bit = jnp.where(big, 1 << 23, 1 << 22)
    disc = low24 & (rnd_bit | (rnd_bit - 1))
    round_up = (disc > rnd_bit) | ((disc == rnd_bit) & ((r & 1) == 1))
    r = r + round_up.astype(jnp.int32)
    ovf = r == (1 << 24)                     # 2^24 after rounding
    r = jnp.where(ovf, r >> 1, r)
    e = ea + eb + big.astype(jnp.int32) + ovf.astype(jnp.int32)
    out = jnp.ldexp(r.astype(jnp.float32), e - 48 + 23)
    out = jnp.where((a == 0) | (b == 0), jnp.float32(0.0), out)
    return (sign * out).astype(jnp.float32)


def f32_sqrt_exact(a: jnp.ndarray) -> jnp.ndarray:
    """IEEE-754 round-to-nearest float32 sqrt of a >= 0, bit-identical to
    numpy on every backend (an approximate hardware sqrt can be 1 ulp
    off). Works entirely in int32: the 24-bit result mantissa R is the
    nearest integer to sqrt(T) for an exact 48-bit target T (held as a
    base-2^24 digit pair); integer targets can never tie at .5, so
    R = floor(sqrt(T)) + [T > R_f^2 + R_f]. floor(sqrt) comes from the
    (approximate) hardware seed refined over +-3 candidates with exact
    integer squaring via 12-bit splits."""
    a = a.astype(jnp.float32)
    ma, ea = jnp.frexp(a)                   # a = ma * 2^ea, ma in [0.5, 1)
    im = (ma * jnp.float32(1 << 24)).astype(jnp.int32)  # [2^23, 2^24)
    e2 = ea - 24
    parity = e2 & 1                          # two's-complement parity
    p = (e2 - parity) >> 1
    # target T = im << 24 (even e2) or im << 23 (odd): base-2^24 pair
    t_hi = jnp.where(parity == 0, im, im >> 1)
    t_lo = jnp.where(parity == 0, 0, (im & 1) << 23)

    # hardware seed for floor(sqrt(T)), then exact refinement
    shift = jnp.where(parity == 0, jnp.float32(1 << 24),
                      jnp.float32(1 << 23))
    seed = jnp.sqrt(im.astype(jnp.float32) * shift)
    r0 = jnp.clip(seed.astype(jnp.int32), 1 << 23, (1 << 24) - 1)

    def sq_le_t(c):
        # exact c^2 (c < 2^24) as base-2^24 pair via 12-bit split
        c = jnp.maximum(c, 0)
        c1, c0 = c >> 12, c & 0xFFF
        mid = 2 * c1 * c0                   # <= 2^25
        low_sum = ((mid & 0xFFF) << 12) + c0 * c0
        h2 = c1 * c1 + (mid >> 12) + (low_sum >> 24)
        l2 = low_sum & 0xFFFFFF
        return (h2 < t_hi) | ((h2 == t_hi) & (l2 <= t_lo))

    floor_r = jnp.full_like(r0, 1 << 23)    # true floor is >= 2^23
    for d in range(-8, 9):                  # largest c with c^2 <= T
        c = r0 + d
        floor_r = jnp.where(sq_le_t(c), jnp.maximum(floor_r, c), floor_r)
    # round: T > R^2 + R  <=>  sqrt(T) > R + 0.5 (never exactly equal)
    c1, c0 = floor_r >> 12, floor_r & 0xFFF
    mid = 2 * c1 * c0
    low_sum = ((mid & 0xFFF) << 12) + c0 * c0 + floor_r
    h2 = c1 * c1 + (mid >> 12) + (low_sum >> 24)
    l2 = low_sum & 0xFFFFFF
    up = (h2 < t_hi) | ((h2 == t_hi) & (l2 < t_lo))
    r = floor_r + up.astype(jnp.int32)
    ovf = r == (1 << 24)                    # rounding crossed a binade
    r = jnp.where(ovf, r >> 1, r)
    out = jnp.ldexp(r.astype(jnp.float32),
                    p - 12 + parity + ovf.astype(jnp.int32))
    return jnp.where(a == 0, jnp.float32(0.0), out).astype(jnp.float32)


def quantize_kernel(values: jnp.ndarray, bits: int):
    """Coordinate-wise quantization of (..., V, N) float32 values.

    Returns (quantized int32, mins (..., N), delta_max (...,))."""
    v = values.astype(jnp.float32)
    zero = jnp.float32(0.0)
    mins = jnp.minimum(v.min(axis=-2), zero)
    maxs = jnp.maximum(v.max(axis=-2), zero)
    delta_max = jnp.max(maxs - mins, axis=-1)
    diff = v - mins[..., None, :]
    safe = jnp.where(delta_max == 0, jnp.float32(1.0), delta_max)
    normalized = jnp.where((delta_max == 0)[..., None, None], diff,
                           f32_div_exact(diff, jnp.broadcast_to(
                               safe[..., None, None], diff.shape)))
    scale = jnp.float32((1 << bits) - 1)
    # the host reference rounds the float32 product BEFORE adding 0.5;
    # a fused mul-add flips values on .5 boundaries. The integer-exact
    # product is the only form no backend can contract (XLA:CPU fuses
    # straight through an optimization_barrier, see f32_mul_exact)
    prod = f32_mul_exact(normalized, scale)
    q = (prod + jnp.float32(0.5)).astype(jnp.int32)
    return q, mins, delta_max


def dequantize_kernel(q: jnp.ndarray, mins: jnp.ndarray,
                      delta_max: jnp.ndarray, bits: int) -> jnp.ndarray:
    scale = delta_max.astype(jnp.float32) / jnp.float32((1 << bits) - 1)
    return (q.astype(jnp.float32) * scale[..., None, None]
            + mins[..., None, :]).astype(jnp.float32)


def zigzag_kernel(v: jnp.ndarray) -> jnp.ndarray:
    v = v.astype(jnp.int32)
    return jnp.where(v >= 0, v << 1, ((-(v + 1)) << 1) + 1).astype(jnp.uint32)


def unzigzag_kernel(u: jnp.ndarray) -> jnp.ndarray:
    u = u.astype(jnp.uint32)
    half = (u >> 1).astype(jnp.int32)
    return jnp.where((u & 1) == 0, half, -half - 1)


def parallelogram_predict_kernel(values: jnp.ndarray,
                                 gather_next: jnp.ndarray,
                                 gather_prev: jnp.ndarray,
                                 gather_opp: jnp.ndarray,
                                 gather_fallback: jnp.ndarray,
                                 can_parallelogram: jnp.ndarray,
                                 has_fallback: jnp.ndarray) -> jnp.ndarray:
    """Vectorized parallelogram prediction over a precomputed traversal.

    All predictions are pure gathers on the encoder side: the host
    precomputes, per traversal step, the value indices of the
    next/prev/opposite corners, the visited-before masks, and the fallback
    (most-recent) value index. pred = a + b - diagonal where available,
    else the fallback value, else 0."""
    a = values[..., gather_next, :].astype(jnp.int32)
    b = values[..., gather_prev, :].astype(jnp.int32)
    d = values[..., gather_opp, :].astype(jnp.int32)
    fb = values[..., gather_fallback, :].astype(jnp.int32)
    para = a + b - d
    fallback = jnp.where(has_fallback[..., None], fb, 0)
    return jnp.where(can_parallelogram[..., None], para, fallback)


def wrapped_difference_kernel(origs: jnp.ndarray, preds: jnp.ndarray,
                              range_source: jnp.ndarray | None = None):
    """Wrapped-difference residual (wrapped_difference.rs:36-99), batched.
    Returns (zigzagged corrections uint32, vmin, vmax).

    ``range_source`` optionally supplies the array the vmin/vmax reduction
    runs over. The traversal order is a permutation of the unique values,
    so reducing over the pre-gather quantized array is byte-identical to
    reducing over the traversal — and, under stream-axis sharding, the
    pre-gather array is replicated per shard, so every shard computes the
    global range without a collective (the per-shard-slice range would
    silently diverge from the single-device bytes)."""
    o = origs.astype(jnp.int32)
    r = o if range_source is None else range_source.astype(jnp.int32)
    vmax = r.max(axis=(-2, -1))
    vmin = r.min(axis=(-2, -1))
    max_diff = 1 + vmax - vmin
    max_corr = max_diff // 2
    min_corr = -max_corr
    max_corr = jnp.where((max_diff & 1) == 0, max_corr - 1, max_corr)
    p = jnp.clip(preds.astype(jnp.int32), vmin[..., None, None],
                 vmax[..., None, None])
    val = o - p
    md = max_diff[..., None, None]
    corr = jnp.where(val > max_corr[..., None, None], val - md,
                     jnp.where(val < min_corr[..., None, None], val + md, val))
    return zigzag_kernel(corr), vmin, vmax


def bincount_kernel(symbols: jnp.ndarray, num_bins: int) -> jnp.ndarray:
    """Per-row frequency counts (rANS table construction). symbols (B, T).
    Out-of-range symbols are DROPPED (not clamped) so a too-small bin count
    surfaces as counts.sum() != T downstream instead of silently mis-binning
    (the entropy stage verifies this)."""
    def one(row):
        # negative indices would wrap Python-style: route them past the
        # end, where mode="drop" discards them with the too-large ones
        row = jnp.where(row < 0, num_bins, row)
        return jnp.zeros(num_bins, jnp.int32).at[row].add(1, mode="drop")
    return jax.vmap(one)(symbols.astype(jnp.int32))


def default_hist_bins(bits: int) -> int:
    """Smallest safe histogram size for zigzagged wrapped-difference
    residuals at a given quantization depth: quantized values span
    [0, 2^bits - 1], so max_diff <= 2^bits and the zigzagged correction is
    <= 2^bits; one power of two above covers it for every depth."""
    return 1 << (bits + 1)


# ---------------------------------------------------------------------------
# Chunked/streaming kernels for meshes exceeding one chip's HBM (SURVEY §5.7)
# ---------------------------------------------------------------------------
#
# The unchunked encode_step holds (V, 3) positions + (T,) gathers resident.
# For a single huge mesh, the host instead streams fixed-size segments:
#   pass 1: per-vertex-chunk min/max reduce       -> global quantization range
#   pass 2: per-vertex-chunk quantized min/max    -> global residual range
#   pass 3: per-traversal-chunk gather rows shipped from host, quantize +
#           predict + wrapped-difference + histogram on device
# Each pass is O(chunk) device memory; results are bit-identical to the
# resident path because min/max reduces are exact and every per-element
# formula is unchanged (pinned by tests).


@functools.partial(jax.jit, static_argnames=())
def minmax_chunk_kernel(pos_chunk: jnp.ndarray):
    """(C, N) float32 -> ((N,) min, (N,) max). Padding rows must replicate
    a real row so they cannot bias the reduce."""
    v = pos_chunk.astype(jnp.float32)
    return v.min(axis=0), v.max(axis=0)


def quantize_rows_kernel(rows: jnp.ndarray, mins: jnp.ndarray,
                         delta_max: jnp.ndarray, bits: int) -> jnp.ndarray:
    """quantize_kernel's per-element formula with an externally supplied
    global range (bit-identical to the resident reduce+quantize)."""
    v = rows.astype(jnp.float32)
    diff = v - mins
    safe = jnp.where(delta_max == 0, jnp.float32(1.0), delta_max)
    normalized = jnp.where(delta_max == 0, diff,
                           f32_div_exact(diff, jnp.broadcast_to(safe,
                                                                diff.shape)))
    scale = jnp.float32((1 << bits) - 1)
    # contraction-proof exact product — see quantize_kernel
    prod = f32_mul_exact(normalized, scale)
    return (prod + jnp.float32(0.5)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("bits",))
def quantized_range_chunk_kernel(pos_chunk, mins, delta_max, bits: int):
    """Global residual range pass: ((), ()) scalar min/max of the chunk's
    quantized values over all components."""
    q = quantize_rows_kernel(pos_chunk, mins, delta_max, bits)
    return q.min(), q.max()


@functools.partial(jax.jit, static_argnames=("bits", "hist_bins"))
def encode_step_chunk(cur, nxt, prv, opp, fb, can_para, has_fallback,
                      active, mins, delta_max, vmin, vmax,
                      bits: int, hist_bins: int):
    """One traversal segment of the fused encode step. All position rows
    arrive pre-gathered from host ((C, N) each), so device memory is
    O(chunk) regardless of mesh size. ``active`` masks padding rows out of
    the histogram (their symbols route to the dropped-sentinel bin).
    Returns ((C, N) uint32 symbols, (hist_bins,) int32 partial counts)."""
    q_cur = quantize_rows_kernel(cur, mins, delta_max, bits)
    q_n = quantize_rows_kernel(nxt, mins, delta_max, bits).astype(jnp.int32)
    q_p = quantize_rows_kernel(prv, mins, delta_max, bits).astype(jnp.int32)
    q_o = quantize_rows_kernel(opp, mins, delta_max, bits).astype(jnp.int32)
    q_f = quantize_rows_kernel(fb, mins, delta_max, bits).astype(jnp.int32)
    para = q_n + q_p - q_o
    fallback = jnp.where(has_fallback[:, None], q_f, 0)
    preds = jnp.where(can_para[:, None], para, fallback)

    # wrapped difference against the externally supplied global range
    o = q_cur.astype(jnp.int32)
    max_diff = 1 + vmax - vmin
    max_corr = max_diff // 2
    min_corr = -max_corr
    max_corr = jnp.where((max_diff & 1) == 0, max_corr - 1, max_corr)
    p = jnp.clip(preds, vmin, vmax)
    val = o - p
    corr = jnp.where(val > max_corr, val - max_diff,
                     jnp.where(val < min_corr, val + max_diff, val))
    sym = zigzag_kernel(corr)

    flat = sym.reshape(-1).astype(jnp.int32)
    act = jnp.repeat(active, sym.shape[1])
    counts = jnp.zeros(hist_bins, jnp.int32).at[
        jnp.where(act, flat, hist_bins)].add(1, mode="drop")
    return sym, counts


def encode_step(positions: jnp.ndarray, gathers: dict, bits: int = 11,
                hist_bins: int | None = None):
    """The fused device encode compute for a batch of meshes sharing one
    topology: quantize -> parallelogram predict (gathers) ->
    wrapped-difference residual -> zigzag -> symbol histogram.

    positions: (B, V, 3) float32; gathers: (T,) index/mask arrays from the
    host topology pass. Returns residual symbols + clamped rANS histogram +
    quantization metadata; the host performs the final entropy coding and
    bitstream assembly."""
    if hist_bins is None:
        hist_bins = default_hist_bins(bits)
    q, mins, delta_max = quantize_kernel(positions, bits)
    q_trav = q[:, gathers["order"], :]
    preds = parallelogram_predict_kernel(
        q, gathers["next"], gathers["prev"], gathers["opp"],
        gathers["fallback"], gathers["can_para"], gathers["has_fallback"])
    corr, vmin, vmax = wrapped_difference_kernel(q_trav, preds,
                                                 range_source=q)
    flat = corr.reshape(corr.shape[0], -1)
    counts = bincount_kernel(flat, hist_bins)
    return {"symbols": corr, "counts": counts, "mins": mins,
            "delta_max": delta_max, "vmin": vmin, "vmax": vmax}


def encode_step_from_q(q_in: jnp.ndarray, gathers: dict, bits: int = 11,
                       hist_bins: int | None = None):
    """encode_step starting from HOST-quantized values.

    The honest pipeline quantizes on the host (the canonical
    quantize_coordinate_wise formula — the device quantize_kernel exists
    to match IT bit-for-bit) and uploads (B, V, C) uint16 instead of
    float32: half the H2D bytes, and the quantization metadata
    (mins/delta_max) plus the wrapped-difference range never cross to
    the device at all. Residual symbols are bit-identical to encode_step on the
    same inputs because int ops have no backend-dependent rounding."""
    if hist_bins is None:
        hist_bins = default_hist_bins(bits)
    q = q_in.astype(jnp.int32)
    q_trav = q[:, gathers["order"], :]
    preds = parallelogram_predict_kernel(
        q, gathers["next"], gathers["prev"], gathers["opp"],
        gathers["fallback"], gathers["can_para"], gathers["has_fallback"])
    corr, vmin, vmax = wrapped_difference_kernel(q_trav, preds,
                                                 range_source=q)
    flat = corr.reshape(corr.shape[0], -1)
    counts = bincount_kernel(flat, hist_bins)
    return {"symbols": corr, "counts": counts, "vmin": vmin, "vmax": vmax}


def unpack12_kernel(lo: jnp.ndarray, hb: jnp.ndarray) -> jnp.ndarray:
    """Device inverse of native.pack12: rebuild int32 quantized values
    from the 12-bit upload layout (lo bytes shaped like q, high nibbles
    paired per batch row). Two shifts + an OR + a relayout — trivial
    elementwise work that fuses into the jitted encode step; the H2D
    transfer carries 1.5 bytes/value instead of 2 (whether that pays on
    a PCIe-attached card is not measured yet)."""
    B = lo.shape[0]
    n = int(np.prod(lo.shape[1:]))
    # interleave (low nibble = even index, high = odd) then trim the
    # odd-length pad nibble
    hi = jnp.stack([hb & jnp.uint8(0xF), hb >> 4], axis=-1).reshape(B, -1)
    hi = hi[:, :n].reshape(lo.shape)
    return lo.astype(jnp.int32) | (hi.astype(jnp.int32) << 8)
