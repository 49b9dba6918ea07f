"""Device (JAX) TexCoord-attribute encode chain.

Port of the encoder-side batched UV prediction
(shared/prediction.py TexCoordPrediction.predict_sequence) to jnp int64
under a scoped ``jax.enable_x64`` (XLA executes s64 exactly),
batched over meshes sharing one topology, plus the WrappedDifference
residual. Bit-identical to the host path (pinned by tests); rows whose
intermediates could exceed the int64 headroom mark the mesh "risky" and
the integration layer routes that mesh to the host encoder (the host
handles them with arbitrary-precision Python ints).

Reference semantics: mesh_prediction_for_texture_coordinates.rs (integer
sqrt, overflow guards, the intentionally omitted prev-vertex fallback,
orientation bits), wrapped_difference.rs.
"""

from __future__ import annotations

import numpy as np

# single source of truth for the topology-static UV gathers lives with
# the host twin
from ..shared.prediction import collect_uv_gathers  # noqa: F401


def uv_encode_chain(q_pos, q_uv, g, uo_pos, uo_uv):
    """Batched device UV encode. All arrays numpy/jnp; runs an x64-scoped
    jit internally.

    q_pos: (B, Vp, 3) int quantized positions (unique values)
    q_uv:  (B, Vu, 2) int quantized UVs (unique values)
    g: collect_uv_gathers output; uo_*: point -> unique-value maps

    Returns numpy (symbols (B, T, 2) uint32, vmin (B,), vmax (B,),
    orient_vals (B, T) bool, orient_flags (B, T) bool, risky (B,) bool).
    """
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        out = _uv_chain_x64(
            jnp.asarray(q_pos).astype(jnp.int64),
            jnp.asarray(q_uv).astype(jnp.int64),
            jnp.asarray(np.asarray(uo_pos).astype(np.int32)),
            jnp.asarray(np.asarray(uo_uv).astype(np.int32)),
            jnp.asarray(g["cpt"]), jnp.asarray(g["npt"]),
            jnp.asarray(g["ppt"]), jnp.asarray(g["last_pt"]),
            jnp.asarray(g["vis_n"]), jnp.asarray(g["vis_p"]),
            jnp.asarray(g["pos_ok_n"]), jnp.asarray(g["pos_ok_p"]),
            jnp.asarray(g["pos_ok_c"]))
        return tuple(np.asarray(x) for x in out)


def _int_sqrt_dev(value):
    """Port of TexCoordPrediction._int_sqrt_vec (draco's integer sqrt:
    power-of-two seed, one averaged Newton step, downward refinement) —
    identical by construction. value int64 >= 0, < 2^62."""
    import jax
    import jax.numpy as jnp

    value = value.astype(jnp.int64)
    act = value
    sqrt = jnp.ones_like(value)

    def seed_step(_, st):
        act, sqrt = st
        m = act >= 2
        sqrt = jnp.where(m, sqrt * 2, sqrt)
        act = jnp.where(m, act // 4, act)
        return act, sqrt

    act, sqrt = jax.lax.fori_loop(0, 32, seed_step, (act, sqrt))
    nz = value > 0
    safe = jnp.where(nz, sqrt, 1)
    sqrt = jnp.where(nz, (sqrt + value // safe) // 2, 0)

    def refine(_, sqrt):
        over = nz & (sqrt * sqrt > value)
        safe = jnp.where(sqrt > 0, sqrt, 1)
        return jnp.where(over, (sqrt + value // safe) // 2, sqrt)

    return jax.lax.fori_loop(0, 64, refine, sqrt)


def _uv_chain_impl(q_pos, q_uv, uo_pos, uo_uv, cpt, npt, ppt, last_pt,
                   vis_n, vis_p, ok_n, ok_p, ok_c):
    import jax.numpy as jnp

    B = q_pos.shape[0]
    T = cpt.shape[0]
    i64max = jnp.int64((1 << 63) - 1)

    def uv_at(pt):
        return q_uv[:, uo_uv[pt], :].astype(jnp.int64)     # (B, T, 2)

    def pos_at(pt, ok):
        v = q_pos[:, uo_pos[jnp.where(ok, pt, 0)], :].astype(jnp.int64)
        return jnp.where(ok[None, :, None], v, 0)

    next_uv, prev_uv, curr_uv = uv_at(npt), uv_at(ppt), uv_at(cpt)
    cpos = pos_at(cpt, ok_c)
    npos = pos_at(npt, ok_n)
    ppos = pos_at(ppt, ok_p)

    geo_try = (vis_n & vis_p)[None, :]                     # (1|B, T)
    eq = (next_uv == prev_uv).all(-1)
    pn = ppos - npos
    pn_norm2 = (pn * pn).sum(-1)
    nz = pn_norm2 != 0
    cn = cpos - npos
    cn_dot_pn = (pn * cn).sum(-1)
    pn_uv = prev_uv - next_uv

    wide = jnp.abs(pn).max(-1) >= (1 << 20)
    pn_norm2_s = jnp.where(nz, pn_norm2, 1)
    g1 = jnp.abs(next_uv).max(-1) > i64max // pn_norm2_s
    pn_uv_am = jnp.abs(pn_uv).max(-1)
    g2 = (pn_uv_am != 0) & (jnp.abs(cn_dot_pn)
                            > i64max // jnp.where(pn_uv_am != 0,
                                                  pn_uv_am, 1))
    pn_am = jnp.abs(pn).max(-1)
    g3 = jnp.abs(cn_dot_pn) > i64max // jnp.where(pn_am != 0, pn_am, 1)
    geo = geo_try & ~eq & nz & ~(g1 | g2 | g3)

    def tdiv(a, b):
        return jnp.sign(a) * jnp.sign(b) * (jnp.abs(a) // jnp.abs(b))

    x_uv = next_uv * pn_norm2_s[..., None] + pn_uv * cn_dot_pn[..., None]
    x_pos = npos + tdiv(pn * cn_dot_pn[..., None], pn_norm2_s[..., None])
    cx = cpos - x_pos
    cx_norm2 = (cx * cx).sum(-1)
    prod_u = cx_norm2.astype(jnp.uint64) * pn_norm2.astype(jnp.uint64)
    risky = geo & (prod_u >= jnp.uint64(1 << 62))
    prod_c = jnp.where(risky | ~geo, 0, prod_u).astype(jnp.int64)
    norm_sq = _int_sqrt_dev(prod_c)
    risky = risky | (geo & ((jnp.maximum(pn_uv_am, 1) * norm_sq)
                            >= (1 << 62)))
    risky = risky | (geo & (jnp.abs(x_uv).max(-1) >= (1 << 62)))
    risky = risky | (geo_try & ~eq & wide)
    geo_v = geo & ~risky

    cx_uv = jnp.stack([pn_uv[..., 1], -pn_uv[..., 0]],
                      axis=-1) * norm_sq[..., None]
    pred0 = tdiv(x_uv + cx_uv, pn_norm2_s[..., None])
    pred1 = tdiv(x_uv - cx_uv, pn_norm2_s[..., None])
    d0 = curr_uv - pred0
    d1 = curr_uv - pred1
    orient = (d0 * d0).sum(-1) < (d1 * d1).sum(-1)

    def wrap32(x):
        return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)

    pred_geo = wrap32(jnp.where(orient[..., None], pred0, pred1))

    lastvals = uv_at(last_pt)
    lastvals = lastvals.at[:, 0, :].set(0)
    fb = jnp.where(vis_n[None, :, None], next_uv, lastvals)
    preds = jnp.where(geo_v[..., None], pred_geo, fb)

    # WrappedDifference residual against the global UV range
    o = curr_uv
    r = q_uv.astype(jnp.int64)
    vmax = r.max(axis=(-2, -1))
    vmin = r.min(axis=(-2, -1))
    max_diff = 1 + vmax - vmin
    max_corr = max_diff // 2
    min_corr = -max_corr
    max_corr = jnp.where((max_diff & 1) == 0, max_corr - 1, max_corr)
    p = jnp.clip(preds, vmin[..., None, None], vmax[..., None, None])
    val = o - p
    md = max_diff[..., None, None]
    corr = jnp.where(val > max_corr[..., None, None], val - md,
                     jnp.where(val < min_corr[..., None, None],
                               val + md, val))
    sym = jnp.where(corr >= 0, corr << 1,
                    ((-(corr + 1)) << 1) + 1).astype(jnp.uint32)

    return (sym, vmin.astype(jnp.int32), vmax.astype(jnp.int32),
            orient, geo_v, risky.any(axis=-1))


_uv_chain_cache = {}


def _uv_chain_x64(*args):
    """jit wrapper created lazily inside the x64 scope (the trace captures
    the x64 state; the cache keys on nothing else because shapes key the
    jit itself)."""
    import jax
    if "fn" not in _uv_chain_cache:
        _uv_chain_cache["fn"] = jax.jit(_uv_chain_impl)
    return _uv_chain_cache["fn"](*args)


def uv_encode_chain_sharded(q_pos, q_uv, g, uo_pos, uo_uv, mesh_axis):
    """Data-parallel twin of uv_encode_chain over a ("data",) device
    mesh: q_pos/q_uv shard on the batch axis (meshes are independent),
    every gather table replicates, the x64-scoped recurrence runs
    per-shard. Bytes equal the unsharded chain (oracle in
    tests/test_parallel.py)."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        key = ("sharded", mesh_axis)
        if key not in _uv_chain_cache:
            from jax.sharding import PartitionSpec as P
            try:
                from jax import shard_map
            except ImportError:  # older jax
                from jax.experimental.shard_map import shard_map
            fn = shard_map(
                _uv_chain_impl, mesh=mesh_axis,
                in_specs=(P("data", None, None), P("data", None, None))
                + (P(),) * 11,
                out_specs=(P("data", None, None), P("data"), P("data"),
                           P("data", None), P("data", None), P("data")))
            _uv_chain_cache[key] = jax.jit(fn)
        out = _uv_chain_cache[key](
            jnp.asarray(q_pos).astype(jnp.int64),
            jnp.asarray(q_uv).astype(jnp.int64),
            jnp.asarray(np.asarray(uo_pos).astype(np.int32)),
            jnp.asarray(np.asarray(uo_uv).astype(np.int32)),
            jnp.asarray(g["cpt"]), jnp.asarray(g["npt"]),
            jnp.asarray(g["ppt"]), jnp.asarray(g["last_pt"]),
            jnp.asarray(g["vis_n"]), jnp.asarray(g["vis_p"]),
            jnp.asarray(g["pos_ok_n"]), jnp.asarray(g["pos_ok_p"]),
            jnp.asarray(g["pos_ok_c"]))
        return tuple(np.asarray(x) for x in out)
