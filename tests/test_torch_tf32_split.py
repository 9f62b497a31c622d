"""The arithmetic of kernel B1 (``csrc/residual_unit.cu``), emulated in
numpy: each float32 operand is split into TF32 parts, hi = a rounded to
TF32 (to nearest, ties away from zero: ``cvt.rna.tf32.f32``, which the
kernel does with two integer ops) and lo = a - hi, of which the tensor
core reads the top 19 bits; every term accumulates lo*hi + hi*lo + hi*hi
(3xTF32).

At the widest fused shape (C=512, k=3, B=1, T=64) and chip_smoke.py's
weight scales, the emulated unit meets chip_smoke.py's B1 tolerance
(atol 1e-4, rtol 1e-3) against a float64 reference, and one TF32 product
per term does not.  The emulation sums in float64, so it checks the
rounding of the operands, not the card's float32 summation order.
"""
import numpy as np
import pytest

B1_TOL = dict(atol=1e-4, rtol=1e-3)   # chip_smoke.py KERNEL_TOL


def tf32_round(a):
    """Round float32 to TF32, to nearest with ties away from zero."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_read(a):
    """What the tensor core reads of a float32 register: its top 19 bits."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    hi = tf32_round(a)
    return hi, tf32_read(a - hi)


def matmul_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    f = lambda p, q: p.astype(np.float64) @ q.astype(np.float64)  # noqa: E731
    return (f(al, bh) + f(ah, bl) + f(ah, bh)).astype(np.float32)


def matmul_1xtf32(a, b):
    return (tf32_round(a).astype(np.float64)
            @ tf32_round(b).astype(np.float64)).astype(np.float32)


def lrelu(v):
    return np.where(v >= 0, v, 0.2 * v)


def unit(matmul, x, w1, b1, w2, b2, dilation, pad_left):
    """The fused unit on one batch row, x (C, T), w1 (k, C_out, C_in) as
    the kernel reads it, with ``matmul`` for both contractions."""
    k, C, T = w1.shape[0], x.shape[0], x.shape[1]
    xp = np.pad(lrelu(x), ((0, 0), (pad_left, (k - 1) * dilation - pad_left)))
    window = np.concatenate([xp[:, j * dilation:j * dilation + T]
                             for j in range(k)])          # (k*C_in, T)
    w1_rows = np.concatenate(list(w1), axis=1)            # (C_out, k*C_in)
    h = lrelu(matmul(w1_rows, window) + b1[:, None]).astype(np.float32)
    return x + (matmul(w2, h) + b2[:, None])


def _inputs(C=512, k=3, T=64, seed=0):
    """chip_smoke.py's unit_inputs scales, made with numpy."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(C, T), f(k, C, C) / np.float32(np.sqrt(C * k)), f(C) * 0.1,
            f(C, C) / np.float32(np.sqrt(C)), f(C) * 0.1)


def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10                      # TF32 spacing in [1, 2)
    a = np.array([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                  1 + ulp * 1.5], np.float32)
    want = np.array([1 + ulp, 1, 1 + ulp, -(1 + ulp), 1 + 2 * ulp],
                    np.float32)
    np.testing.assert_array_equal(tf32_round(a), want)


def test_split_parts_are_exact_and_small():
    a = np.random.default_rng(1).standard_normal(10000).astype(np.float32)
    hi = tf32_round(a)
    assert not np.any(hi.view(np.uint32) & np.uint32(0x1FFF))
    lo = a - hi                           # exact in float32
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, a)
    assert np.all(np.abs(lo) <= np.abs(a) * 2.0 ** -11)


@pytest.mark.parametrize("dilation", [1, 9])
def test_three_products_meet_the_b1_tolerance_one_does_not(dilation):
    x, w1, b1, w2, b2 = _inputs(seed=dilation)
    pad_left = dilation                   # (k - 1) * d = 2d, centred
    f64 = [a.astype(np.float64) for a in (x, w1, b1, w2, b2)]
    want = unit(lambda p, q: p @ q, *f64, dilation, pad_left)
    got3 = unit(matmul_3xtf32, x, w1, b1, w2, b2, dilation, pad_left)
    got1 = unit(matmul_1xtf32, x, w1, b1, w2, b2, dilation, pad_left)
    assert np.allclose(got3, want, **B1_TOL)
    assert np.abs(got3 - want).max() < 1e-5
    assert not np.allclose(got1, want, **B1_TOL)
