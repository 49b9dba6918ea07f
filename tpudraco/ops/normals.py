"""Device (JAX) normal-attribute encode chain.

Mirrors the host pipeline bit-for-bit for NORMAL attributes:
octahedral quantization (shared/octahedral.py), ring-sum normal
prediction (shared/prediction.py NormalPrediction), flip selection, and
the OctahedralOrthogonal residual transform (encode/transforms.py) —
batched over meshes sharing one topology. The float steps ride
f32_div_exact / f32_sqrt_exact (a backend's div and sqrt need not be
correctly rounded), integer steps use int32 (wrapping matches the host's
explicit wrap32), so symbols equal the host encoder's exactly (pinned by
tests).

Reference semantics: mesh_normal_prediction.rs (ring cross-product sums,
clamp at 2^29, flips), octahedral_quantization.rs + geom.rs (transform +
faithful fixups), oct_orthogonal.rs via the involutive InvertDiamond.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .device import f32_div_exact, f32_mul_exact, f32_sqrt_exact


# ---------------------------------------------------------------- host prep

# single source of truth for the ring precompute lives with the host twin
from ..shared.prediction import collect_normal_rings  # noqa: F401


# -------------------------------------------------------------- device ops

def oct_transform_device(v: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 2) float32 octahedral coords; integer inputs are
    normalized first with exact sqrt/div (shared/octahedral.py float
    semantics, geom.rs:40-91)."""
    if not jnp.issubdtype(v.dtype, jnp.floating):
        f = v.astype(jnp.float32)
        x, y, z = f[..., 0], f[..., 1], f[..., 2]
        # explicit left-fold sum matches numpy's small-axis reduction;
        # integer-exact products: the host rounds every square before
        # adding, and XLA:CPU fuses a float mul into the adds as an FMA
        # straight through an optimization_barrier (soak-found round 3 —
        # a 1-ulp nsq flipped a quantized prediction; see f32_mul_exact)
        xx = f32_mul_exact(x, x)
        yy = f32_mul_exact(y, y)
        zz = f32_mul_exact(z, z)
        nsq = (xx + yy) + zz
        norm = f32_sqrt_exact(nsq)
        f = f32_div_exact(f, jnp.broadcast_to(norm[..., None], f.shape))
        v = f
    v = v.astype(jnp.float32)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    abs_sum = (jnp.abs(x) + jnp.abs(y)) + jnp.abs(z)
    u = f32_div_exact(y, abs_sum)
    w = f32_div_exact(z, abs_sum)
    one = jnp.float32(1.0)
    u_out = jnp.where(u < 0, jnp.abs(w) - one, one - jnp.abs(w))
    v_out = jnp.where(w < 0, jnp.abs(u) - one, one - jnp.abs(u))
    neg = x < 0
    return jnp.stack([jnp.where(neg, u_out, u),
                      jnp.where(neg, v_out, w)], axis=-1)


def into_faithful_device(q: jnp.ndarray, bits: int = 8) -> jnp.ndarray:
    """Edge fixups on quantized (..., 2) int oct coords (geom.rs:139-157;
    the reference hardcodes 8-bit max=255 — the formulas generalize to
    max = 2^bits - 1 exactly as the host twin,
    shared/octahedral.py into_faithful_oct_quantization)."""
    q = q.astype(jnp.int32)
    u, v = q[..., 0], q[..., 1]
    mx = (1 << bits) - 1
    half = mx // 2
    x, y = u, v
    corner = (((u == 0) & (v == 0)) | ((u == mx) & (v == 0))
              | ((u == 0) & (v == mx)))
    cond1 = (~corner) & (u == 0) & (v > half)
    y = jnp.where(cond1, half - (v - half), y)
    cond2 = (~corner) & (~cond1) & (u == mx) & (v < half)
    y = jnp.where(cond2, half + (half - v), y)
    cond3 = (~corner) & (~cond1) & (~cond2) & (v == mx) & (u < half)
    x = jnp.where(cond3, half + (half - u), x)
    cond4 = (~corner) & (~cond1) & (~cond2) & (~cond3) & (v == 0) & (u > half)
    x = jnp.where(cond4, half - (u - half), x)
    x = jnp.where(corner, mx, x)
    y = jnp.where(corner, mx, y)
    return jnp.stack([x, y], axis=-1)


def oct_quantize_device(vals: jnp.ndarray, bits: int = 8) -> jnp.ndarray:
    """(..., 3) float normals -> (..., 2) int32 oct coords
    (octahedral_quantization.rs:49-65)."""
    oct = oct_transform_device(vals) + jnp.float32(1.0)
    scale = jnp.float32((1 << (bits - 1)) - 1)
    # the lone mul is exactly rounded (no neighboring add to contract
    # with); truncation toward zero matches the host
    return (oct * scale).astype(jnp.int32)


def oct_quantize_faithful_device(vals: jnp.ndarray,
                                 bits: int = 8) -> jnp.ndarray:
    """oct_quantize_device + faithful fixups at a matching depth
    (shared/octahedral.py oct_quantize_normals)."""
    return into_faithful_device(oct_quantize_device(vals, bits), bits)


def invert_diamond_device(v: jnp.ndarray, center: int = 127) -> jnp.ndarray:
    """Involutive diamond inversion on centered int coords
    (shared/octahedral.py invert_diamond)."""
    v = v.astype(jnp.int32)
    s, t = v[..., 0], v[..., 1]
    both_nonneg = (s >= 0) & (t >= 0)
    both_nonpos = (s <= 0) & (t <= 0)
    sign_s = jnp.where(both_nonneg, 1, jnp.where(both_nonpos, -1,
                                                 jnp.where(s > 0, 1, -1)))
    sign_t = jnp.where(both_nonneg, 1, jnp.where(both_nonpos, -1,
                                                 jnp.where(t > 0, 1, -1)))
    cs = sign_s * center
    ct = sign_t * center
    s2 = 2 * s - cs
    t2 = 2 * t - ct
    rotate = (sign_s * sign_t) >= 0
    ns = jnp.where(rotate, -t2, t2)
    nt = jnp.where(rotate, -s2, s2)
    # sums are even; arithmetic shift == floor division by 2 here because
    # (ns+cs) and (nt+ct) are even, so >>1 is exact for both signs
    return jnp.stack([(ns + cs) >> 1, (nt + ct) >> 1], axis=-1)


def _trunc_div(a, b):
    return jnp.sign(a) * (jnp.abs(a) // jnp.maximum(jnp.abs(b), 1))


def _ring_predict(q_pos, tip_i, next_i, prev_i, mask, bits: int):
    """Ring-sum normal prediction from quantized positions: (B, T, 2)
    faithful oct-quantized predictions + the nonzero-ring mask. The exact
    compute both directions share — the encoder's prediction and the
    decoder's (which re-predicts from the already-decoded positions)."""
    pos_tip = q_pos[:, tip_i, :]           # (B, T, 3)
    pn = q_pos[:, next_i, :] - pos_tip[:, :, None, :]   # (B, T, R, 3)
    pp = q_pos[:, prev_i, :] - pos_tip[:, :, None, :]
    # int32 products wrap mod 2^32 == the host's explicit wrap32
    cr = jnp.stack([
        pn[..., 1] * pp[..., 2] - pn[..., 2] * pp[..., 1],
        pn[..., 2] * pp[..., 0] - pn[..., 0] * pp[..., 2],
        pn[..., 0] * pp[..., 1] - pn[..., 1] * pp[..., 0],
    ], axis=-1)
    cr = jnp.where(mask[None, :, :, None], cr, 0)
    # the ring SUM accumulates in int64 on the host (scalar + vectorized
    # NormalPrediction) and the overflow clamp reads the UNWRAPPED sum —
    # only afterwards does the host wrap to i32. Summing in int32 here
    # diverged once deep position depths pushed ring sums past 2^31
    # (round-5 soak, phased-decode oracle at -qp 18). Callers MUST scope
    # jax.enable_x64 (the public wrappers do): without it the int64 is
    # silently int32 and the 2^31 wrap constant below fails the trace
    # with an OverflowError — loud, never silently divergent.
    total64 = cr.astype(jnp.int64).sum(axis=2)          # (B, T, 3)

    upper = 1 << 29
    abs_sum = jnp.abs(total64).sum(axis=-1)             # (B, T)
    big = abs_sum > upper
    qd = jnp.where(big, abs_sum // upper, 1)
    total64 = jnp.where(big[..., None], _trunc_div(total64, qd[..., None]),
                        total64)
    # host wrap32 after the clamp (mesh_normal_prediction.rs wrap)
    total = (((total64 + (1 << 31)) % (1 << 32)) - (1 << 31)).astype(
        jnp.int32)

    nonzero = (total != 0).any(axis=-1)
    safe_total = jnp.where(nonzero[..., None], total,
                           jnp.array([1, 0, 0], jnp.int32))
    oct = oct_transform_device(safe_total) + jnp.float32(1.0)
    quant = (oct * jnp.float32((1 << (bits - 1)) - 1)).astype(jnp.int32)
    pred = into_faithful_device(quant, bits)
    pred = jnp.where(nonzero[..., None], pred, 0)       # (B, T, 2)
    return pred, nonzero


def normal_encode_chain(q_pos, normals, tip_pt, next_pt, prev_pt, mask,
                        uo_point_pos, uo_point_nrm, bits: int = 8):
    """x64-scoped wrapper of the jitted chain: the ring-sum clamp needs a
    real int64 (see _ring_predict); every compute dtype in the chain is
    explicit, so enabling x64 changes no other op. Sharded callers
    shard_map _normal_encode_chain_impl directly under their own x64
    scope (parallel/batch.py)."""
    with jax.enable_x64(True):
        return _normal_encode_chain_jit(q_pos, normals, tip_pt, next_pt,
                                        prev_pt, mask, uo_point_pos,
                                        uo_point_nrm, bits=bits)


def _normal_encode_chain_impl(q_pos, normals, tip_pt, next_pt, prev_pt, mask,
                              uo_point_pos, uo_point_nrm, bits: int = 8):
    """Batched device encode of a NORMAL attribute.

    q_pos:    (B, Vp, 3) int32 quantized positions (unique values)
    normals:  (B, Vn, 3) float32 normal values (unique values)
    tip_pt/next_pt/prev_pt/mask: ring precompute (collect_normal_rings)
    uo_point_pos / uo_point_nrm: (P,) point -> unique-value index maps
    bits: octahedral depth (-qn, 7..16); every stage — quantization,
          prediction, faithful fixups, squeeze — runs at this depth,
          matching the host chain with Config.quant_bits[NORMAL]=bits.

    Returns (symbols (B, T, 2) int32, flips (B, T) bool).
    """
    # per-point gathers resolved to unique-value rows
    tip_i = uo_point_pos[tip_pt]           # (T,)
    next_i = uo_point_pos[next_pt]         # (T, R)
    prev_i = uo_point_pos[prev_pt]
    pred, nonzero = _ring_predict(q_pos, tip_i, next_i, prev_i, mask, bits)

    # orig values: oct-quantize the normals, faithful fixups, traversal
    # gather (portabilization + per_point[pts] in the host path)
    q_n = into_faithful_device(oct_quantize_device(normals, bits), bits)
    orig = q_n[:, uo_point_nrm[tip_pt], :]              # (B, T, 2)

    # flip selection (mesh_normal_prediction.rs:133-143): the host
    # compares exact int64 squared distances; d2 = -pred - orig reaches
    # 2*(2^bits - 1), so its square overflows int32 at bits >= 15
    # (soak-found round 3: spurious flips at -qn 15/16 diverged the
    # device stream). Decompose each square into base-2^16 limbs —
    # exact in int32 for |v| < 2^17 — and compare lexicographically.
    def _sq_sum_limbs(v):
        a = jnp.abs(v)
        ah, al = a >> 8, a & 255
        m = ah * al * 512 + al * al          # a^2 = ah^2 * 2^16 + m
        hi = (ah * ah + (m >> 16)).sum(-1)
        lo = (m & 65535).sum(-1)
        return hi + (lo >> 16), lo & 65535
    h1, l1 = _sq_sum_limbs(pred - orig)
    h2, l2 = _sq_sum_limbs(-pred - orig)
    flips = (h1 > h2) | ((h1 == h2) & (l1 > l2))
    pred = jnp.where(flips[..., None], -pred, pred)

    # OctahedralOrthogonal squeeze (encode/transforms.py)
    mx = (1 << bits) - 1
    one = mx // 2
    o = orig - one
    p = pred - one
    flip = jnp.abs(p).sum(-1) > one
    p = jnp.where(flip[..., None], invert_diamond_device(p, one), p)
    o = jnp.where(flip[..., None], invert_diamond_device(o, one), o)
    nonzero_p = (p != 0).any(-1)
    for _ in range(4):
        todo = nonzero_p & ((p[..., 0] >= 0) | (p[..., 1] > 0))
        rp = jnp.stack([-p[..., 1], p[..., 0]], axis=-1)
        ro = jnp.stack([-o[..., 1], o[..., 0]], axis=-1)
        p = jnp.where(todo[..., None], rp, p)
        o = jnp.where(todo[..., None], ro, o)
    corr = o - p
    corr = jnp.where(corr < 0, corr + mx, corr)
    return corr.astype(jnp.int32), flips


_normal_encode_chain_jit = functools.partial(
    jax.jit, static_argnames=("bits",))(_normal_encode_chain_impl)


def invert_diamond_inverse_device(w: jnp.ndarray,
                                  center: int = 127) -> jnp.ndarray:
    """Exact diamond-inversion preimage, batched on device: evaluate the
    five candidate preimages, forward-map them, take the first that maps
    back to ``w`` (shared/octahedral.py invert_diamond_inverse_batched —
    same preference order, so values are bit-identical)."""
    w = w.astype(jnp.int32)
    w0, w1 = w[..., 0], w[..., 1]
    cands = jnp.stack([
        invert_diamond_device(w, center),
        jnp.stack([center - w1, center - w0], axis=-1),
        jnp.stack([-w1 - center, -w0 - center], axis=-1),
        jnp.stack([w1 + center, w0 - center], axis=-1),
        jnp.stack([w1 - center, w0 + center], axis=-1),
    ])                                                   # (5, ..., 2)
    ok = (invert_diamond_device(cands, center) == w[None]).all(-1)
    first = jnp.argmax(ok, axis=0)  # 0 when none match == host fallback
    return jnp.take_along_axis(
        cands, first[None, ..., None].astype(jnp.int32), axis=0)[0]


def normal_decode_chain(q_pos, symbols, flips, tip_i, next_i, prev_i,
                        mask, bits: int = 8):
    """x64-scoped wrapper (see normal_encode_chain)."""
    with jax.enable_x64(True):
        return _normal_decode_chain_jit(q_pos, symbols, flips, tip_i,
                                        next_i, prev_i, mask, bits=bits)


@functools.partial(jax.jit, static_argnames=("bits",))
def _normal_decode_chain_jit(q_pos, symbols, flips, tip_i, next_i, prev_i,
                             mask, bits: int = 8):
    """Batched device DECODE of a NORMAL attribute (the phased decoder's
    second phase): re-predict from the already-decoded positions with the
    exact encoder ring compute (_ring_predict), apply the wire flips,
    then invert the OctOrthogonal residual — the device mirror of
    decode/attribute.py _decode_normals_vectorized, integer-exact (pinned
    by grouped-vs-per-blob byte equality tests).

    q_pos:   (B, Vp, 3) int32 decoded quantized positions (by vertex)
    symbols: (B, T, 2) int32 residual symbols (decode order)
    flips:   (B, T) bool wire flip bits
    tip_i/next_i/prev_i/mask: ring rows into q_pos (corner -> vertex
    resolved on host)

    Returns (B, T, 2) int32 decoded oct values along the traversal.
    """
    pred, _ = _ring_predict(q_pos, tip_i, next_i, prev_i, mask, bits)
    pred = jnp.where(flips[..., None], -pred, pred)

    mx = (1 << bits) - 1
    one = mx // 2
    corr = symbols.astype(jnp.int32)
    p = pred - one
    flip = jnp.abs(p).sum(-1) > one
    p = jnp.where(flip[..., None], invert_diamond_device(p, one), p)

    rots = [p]
    for _ in range(3):
        q = rots[-1]
        rots.append(jnp.stack([-q[..., 1], q[..., 0]], axis=-1))
    rots_s = jnp.stack(rots)                             # (4, B, T, 2)
    in_q3 = (rots_s[..., 0] < 0) & (rots_s[..., 1] <= 0)
    r = jnp.where(p.any(-1), jnp.argmax(in_q3, axis=0), 0)
    r_idx = r[None, ..., None].astype(jnp.int32)
    p_rot = jnp.take_along_axis(rots_s, r_idx, axis=0)[0]

    o = ((p_rot + corr + one) % mx) - one
    outs = [o]
    for _ in range(3):
        q = outs[-1]
        outs.append(jnp.stack([q[..., 1], -q[..., 0]], axis=-1))
    o = jnp.take_along_axis(jnp.stack(outs), r_idx, axis=0)[0]
    o = jnp.where(flip[..., None], invert_diamond_inverse_device(o, one), o)
    return (o + one).astype(jnp.int32)
