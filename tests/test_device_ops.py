"""Device (JAX) kernels must match the host reference pipeline bit-for-bit."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpudraco.encode.connectivity import EdgebreakerEncoder
from tpudraco.encode.portabilization import quantize_coordinate_wise
from tpudraco.encode.transforms import WrappedDifferenceTransform
from tpudraco.models import Attribute, AttributeDomain, AttributeType, TableView
from tpudraco.ops import (
    build_parallelogram_gathers, dequantize_kernel, encode_step,
    quantize_kernel, unzigzag_kernel, zigzag_kernel,
)
from tpudraco.shared.prediction import PredictionState, make_prediction
from tpudraco.shared.sequencer import compute_sequence
from tpudraco.wire import ByteWriter


class _Buf:
    def write_u8(self, v):
        pass

    def write_u32(self, v):
        pass

    def write_f32(self, v):
        pass


def _grid_mesh(n, seed):
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.rand(n * n).astype(np.float32) * 3], axis=1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + 1, a + n])
            faces.append([a + 1, a + n + 1, a + n])
    return pos, np.asarray(faces, dtype=np.int64)


def test_quantize_kernel_matches_host():
    pos, _ = _grid_mesh(8, 0)
    att = Attribute(pos, AttributeType.POSITION, AttributeDomain.POSITION)
    host = quantize_coordinate_wise(att, 11, _Buf())
    q, mins, dm = quantize_kernel(jnp.asarray(att.values)[None], 11)
    assert np.array_equal(np.asarray(q[0]), host.values)


def test_zigzag_kernel():
    v = np.array([0, -1, 1, -2, 2, 1000, -1000], dtype=np.int32)
    z = np.asarray(zigzag_kernel(jnp.asarray(v)))
    assert z.tolist() == [0, 1, 2, 3, 4, 2000, 1999]
    assert np.array_equal(np.asarray(unzigzag_kernel(jnp.asarray(z))), v)


def test_device_encode_step_matches_host_pipeline():
    pos, faces = _grid_mesh(10, 3)
    att = Attribute(pos, AttributeType.POSITION, AttributeDomain.POSITION)
    eb = EdgebreakerEncoder(faces, [att])
    out = eb.encode(ByteWriter())
    view = TableView(out.corner_table.corner_table)
    seq = compute_sequence(view, list(out.corners_of_edgebreaker))

    # host pipeline
    port = quantize_coordinate_wise(att, 11, _Buf())
    per_point = port.values[port.unique_indices()].astype(np.int64)
    pred = make_prediction(1, view, [port], 3)
    state = PredictionState(view.num_vertices)
    origs = np.empty((len(seq), 3), dtype=np.int64)
    preds = np.empty((len(seq), 3), dtype=np.int64)
    for k, c in enumerate(seq):
        preds[k] = pred.predict(c, state, lambda p: per_point[p])
        state.push(view.vertex(c))
        origs[k] = per_point[view.point(c)]
    host_syms = WrappedDifferenceTransform().squeeze(origs, preds, _Buf())

    # device pipeline
    gathers = build_parallelogram_gathers(view, seq, att.unique_indices())
    gathers = {k: jnp.asarray(v) for k, v in gathers.items()}
    dev = encode_step(jnp.asarray(att.values, dtype=jnp.float32)[None],
                      gathers, bits=11)
    dev_syms = np.asarray(dev["symbols"][0]).astype(np.uint64)
    assert np.array_equal(dev_syms, host_syms)

    # histogram consistency
    counts = np.asarray(dev["counts"][0])
    expect = np.bincount(np.minimum(host_syms.ravel().astype(np.int64),
                                    (1 << 12) - 1), minlength=1 << 12)
    assert np.array_equal(counts, expect)


def test_dequantize_kernel_roundtrip():
    pos, _ = _grid_mesh(6, 5)
    q, mins, dm = quantize_kernel(jnp.asarray(pos)[None], 11)
    deq = dequantize_kernel(q, mins, dm, 11)
    assert np.max(np.abs(np.asarray(deq[0]) - pos)) < np.asarray(dm)[0] / 2000


def test_graft_entry_and_multichip():
    import __graft_entry__ as g
    fn, args = g.entry()
    syms, counts = jax.jit(fn)(*args)
    assert syms.shape[0] == args[0].shape[0]
    if len(jax.devices()) >= 8:
        g.dryrun_multichip(8)
    g.dryrun_multichip(1)


def test_f32_div_exact_bitwise():
    """f32_div_exact must be bit-identical to IEEE round-to-nearest-even
    (numpy) division across random, tie-boundary, and degenerate inputs."""
    from tpudraco.ops import f32_div_exact

    rng = np.random.default_rng(11)
    a = rng.uniform(0, 1e6, size=200_000).astype(np.float32)
    b = rng.uniform(1e-3, 1e6, size=200_000).astype(np.float32)
    # adversarial: quotients landing exactly on representable values and
    # near .5 ulp ties (integer ratios, power-of-two scales)
    ints = rng.integers(1, 1 << 24, size=50_000)
    a2 = (ints.astype(np.float32) * 3.0).astype(np.float32)
    b2 = np.full(50_000, 3.0, np.float32)
    a3 = rng.integers(1, 4000, size=50_000).astype(np.float32)
    b3 = np.full(50_000, 1023.0, np.float32)  # the quantize denominator
    a = np.concatenate([a, a2, a3, [0.0, 1.0, 3.2484121]]).astype(np.float32)
    b = np.concatenate([b, b2, b3, [5.0, 3.0, 1023.0]]).astype(np.float32)

    # signed operands (rounding is sign-symmetric)
    sa = rng.choice([-1.0, 1.0], size=len(a)).astype(np.float32)
    sb = rng.choice([-1.0, 1.0], size=len(b)).astype(np.float32)
    a = a * sa
    b = b * sb
    got = np.asarray(f32_div_exact(jnp.asarray(a), jnp.asarray(b)))
    want = (a / b).astype(np.float32)
    mism = got.view(np.int32) != want.view(np.int32)
    assert not mism.any(), (a[mism][:5], b[mism][:5], got[mism][:5],
                            want[mism][:5])


def test_f32_sqrt_exact_bitwise():
    """f32_sqrt_exact must be bit-identical to IEEE round-to-nearest
    (numpy) sqrt across random scales and exact squares."""
    from tpudraco.ops import f32_sqrt_exact

    rng = np.random.default_rng(12)
    a = (np.abs(rng.standard_normal(300_000)).astype(np.float32)
         * rng.choice([1e-6, 1e-2, 1.0, 1e3, 1e8],
                      300_000).astype(np.float32))
    sq = rng.integers(0, 1 << 12, size=50_000).astype(np.float32) ** 2
    ints = rng.integers(0, 1 << 24, size=50_000).astype(np.float32)
    a = np.concatenate([a, sq, ints, [0.0, 1.0, 2.0, 4.0, 0.25,
                                      3.0, 1e30, 1e-30]]).astype(np.float32)
    got = np.asarray(f32_sqrt_exact(jnp.asarray(a)))
    want = np.sqrt(a)
    mism = got.view(np.int32) != want.view(np.int32)
    assert not mism.any(), (a[mism][:5], got[mism][:5], want[mism][:5])


def test_f32_mul_exact_bitwise():
    """f32_mul_exact must be bit-identical to IEEE round-to-nearest-even
    (numpy) multiplication across magnitudes, exact squares, and signs —
    and must stay exact when composed with an add inside ONE jit, the
    FMA-contraction scenario XLA:CPU produces straight through
    lax.optimization_barrier (soak-found round 3)."""
    import jax

    from tpudraco.ops import f32_mul_exact

    rng = np.random.default_rng(23)
    parts = []
    for ea in (-30, -7, 0, 9, 27):
        parts.append((rng.random(60_000).astype(np.float32) * 2 - 1)
                     * np.float32(2.0) ** ea)
    # integer-valued floats (the oct-transform square inputs)
    parts.append(rng.integers(-(1 << 24), 1 << 24,
                              size=60_000).astype(np.float32))
    parts.append(np.array([0.0, -0.0, 1.0, -1.0, 6241.0], np.float32))
    a = np.concatenate(parts)
    b = np.concatenate([rng.permutation(p) for p in parts])
    got = np.asarray(f32_mul_exact(jnp.asarray(a), jnp.asarray(b)))
    want = (a * b).astype(np.float32)
    # -0.0 vs 0.0: both quantize identically; compare on abs for zeros
    zs = want == 0
    assert np.array_equal(got[~zs].view(np.int32), want[~zs].view(np.int32))
    assert (got[zs] == 0).all()

    # the FMA case: round(a*a) + c must keep the intermediate rounding
    @jax.jit
    def f(z, c):
        return c + f32_mul_exact(z, z)

    z, c = np.float32(6241.0), np.float32(4506002.0)
    assert float(f(jnp.asarray(z), jnp.asarray(c))) == float(
        np.float32(z * z) + c)  # 43456080, not the fused 43456084


def test_bincount_kernel_matches_numpy():
    """The device histogram (an XLA scatter-add) equals np.bincount per
    row."""
    from tpudraco.ops import bincount_kernel

    rng = np.random.default_rng(0)
    sym = rng.integers(0, 300, size=(4, 5000)).astype(np.int32)
    got = np.asarray(bincount_kernel(jnp.asarray(sym), 512))
    for row, g in zip(sym, got):
        assert np.array_equal(g, np.bincount(row, minlength=512))


def test_bincount_kernel_drops_out_of_range():
    """Negative and too-large symbols are dropped, not clamped, so an
    undersized bin count shows up as counts.sum() != T downstream."""
    from tpudraco.ops import bincount_kernel

    sym = np.array([[0, 1, 1, -1, 511, 512, 700, -40]], np.int32)
    got = np.asarray(bincount_kernel(jnp.asarray(sym), 512))[0]
    assert got.sum() == 4
    assert got[0] == 1 and got[1] == 2 and got[511] == 1


def test_bincount_kernel_long_rows():
    """Rows far longer than the bin count (the huge-mesh histogram) and a
    bin count that is not a power of two."""
    from tpudraco.ops import bincount_kernel

    rng = np.random.default_rng(1)
    sym = rng.integers(0, 100, size=(2, 200000)).astype(np.int32)
    got = np.asarray(bincount_kernel(jnp.asarray(sym), 100))
    for row, g in zip(sym, got):
        assert np.array_equal(g, np.bincount(row, minlength=100))
        assert g.sum() == row.size
