"""Stencil / transfer ops on the padded layout (see ops.layout).

Each op mirrors its ops.stencils / ops.zoom counterpart exactly on the true
(n, n) corner of the padded array and preserves the layout invariant (pad
cells zero, boundary ring frozen). Shapes are (R8(n), C128(n)); the true
``n`` is a static argument. Neighbor access uses whole-array shifts
(jnp.roll) + masks instead of interior slicing, so every intermediate keeps
the level's padded shape and XLA fuses each op into one elementwise loop.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .layout import interior_mask
from .zoom import _zoom_matrix_np


def _shifts(u: jnp.ndarray):
    """(north, south, west, east) neighbor arrays via rolls; wrap values are
    masked away by interior_mask downstream (the interior never touches the
    wrapped rows/cols because pad/boundary cells are excluded)."""
    un = jnp.roll(u, 1, axis=0)     # row j−1
    us = jnp.roll(u, -1, axis=0)    # row j+1
    uw = jnp.roll(u, 1, axis=1)
    ue = jnp.roll(u, -1, axis=1)
    return un, us, uw, ue


def residual_p(u: jnp.ndarray, f: jnp.ndarray, h: float, n: int) -> jnp.ndarray:
    """Padded 5-point residual: r on the interior, 0 elsewhere (incl. pad)."""
    inv_h2 = jnp.asarray(1.0 / (h * h), u.dtype)
    un, us, uw, ue = _shifts(u)
    r = inv_h2 * (un + us + uw + ue - 4.0 * u) - f
    return jnp.where(interior_mask(n, u.shape), r, jnp.zeros_like(u))


def jacobi_sweep_p(u: jnp.ndarray, f: jnp.ndarray, h: float, n: int,
                   omega: float = 1.0) -> jnp.ndarray:
    """Padded damped-Jacobi sweep; identical to stencils.jacobi_sweep on the
    true grid (doSmoothing increment form, MG_solver_CPU.cpp:590-603)."""
    h2 = jnp.asarray(h * h, u.dtype)
    un, us, uw, ue = _shifts(u)
    incr = 0.25 * (un + us + uw + ue - 4.0 * u - h2 * f)
    new = u + jnp.asarray(omega, u.dtype) * incr
    return jnp.where(interior_mask(n, u.shape), new, u)


def redblack_gs_sweep_p(u: jnp.ndarray, f: jnp.ndarray, h: float, n: int) -> jnp.ndarray:
    """Padded red-black Gauss-Seidel sweep (even half then odd half)."""
    h2 = jnp.asarray(h * h, u.dtype)
    r = jax.lax.broadcasted_iota(jnp.int32, u.shape, 0)
    c = jax.lax.broadcasted_iota(jnp.int32, u.shape, 1)
    parity = (r + c) % 2
    interior = interior_mask(n, u.shape)

    def half(u, color):
        un, us, uw, ue = _shifts(u)
        val = 0.25 * (un + us + uw + ue - h2 * f)
        take = jnp.logical_and(parity == color, interior)
        return jnp.where(take, val, u)

    return half(half(u, 0), 1)


def smoothing_error_p(u, f, h: float, n: int, compat: bool = True) -> jnp.ndarray:
    """Padded smoothing-error metric (reference-compat color bug preserved,
    MG_solver_CPU.cpp:606-622; see stencils.smoothing_error)."""
    res = residual_p(u, f, h, n)
    if compat:
        r = jax.lax.broadcasted_iota(jnp.int32, u.shape, 0)
        c = jax.lax.broadcasted_iota(jnp.int32, u.shape, 1)
        even = ((r + c) % 2 == 0).astype(u.dtype)
        s = 2.0 * jnp.sum(jnp.abs(res) * even)
    else:
        s = jnp.sum(jnp.abs(res))
    return s / (n * n)


def gpu_smoothing_error_p(u_new, u_old, h: float, n: int) -> jnp.ndarray:
    """Padded GPU smoother metric: mean |U_new − U_old|·4/h² over N²
    (ker_Smoothing_GPU, MG_solver_GPU.cu:633, 1266-1272; see
    stencils.gpu_smoothing_error). Padding rows/cols are identical in both
    iterates, so the plain full-array sum is exact."""
    scale = jnp.asarray(4.0 / (h * h), u_new.dtype)
    return jnp.sum(jnp.abs(u_new - u_old)) * scale / (n * n)


def mean_abs_interior_residual_p(u, f, h: float, n: int) -> jnp.ndarray:
    res = residual_p(u, f, h, n)
    return jnp.sum(jnp.abs(res)) / ((n - 2) * (n - 2))


# --- compensated residual on the padded layout --------------------------------

def residual_compensated_p(u: jnp.ndarray, f: jnp.ndarray, h: float, n: int) -> jnp.ndarray:
    """Padded compensated residual (see ops.precision): immune to the fp32
    eps/h² cancellation noise that dominates naive fp32 residuals at N ≥ 2049."""
    from .precision import two_sum

    un, us, uw, ue = _shifts(u)
    hi, lo = two_sum(un, us)
    hi, e = two_sum(hi, uw)
    lo = lo + e
    hi, e = two_sum(hi, ue)
    lo = lo + e
    for _ in range(4):
        hi, e = two_sum(hi, -u)
        lo = lo + e
    hi, lo = two_sum(hi, lo)
    inv_h2 = jnp.asarray(1.0 / (h * h), u.dtype)
    r = (hi * inv_h2 - f) + lo * inv_h2
    return jnp.where(interior_mask(n, u.shape), r, jnp.zeros_like(u))


def relative_residual_norm_p(u, f, h: float, n: int) -> jnp.ndarray:
    """Compensated ‖r‖₂/‖f‖₂ on the padded layout (benchmark metric)."""
    r = residual_compensated_p(u, f, h, n)
    num = jnp.linalg.norm(r)
    den = jnp.linalg.norm(jnp.where(interior_mask(n, u.shape), f, jnp.zeros_like(f)))
    return num / jnp.maximum(den, jnp.asarray(jnp.finfo(u.dtype).tiny, u.dtype))


# --- padded zoom (restriction / prolongation) --------------------------------

@lru_cache(maxsize=None)
def _zoom_matrix_padded_np(n_src: int, n_dst: int, rows_pad: int, cols_pad: int,
                           dtype_name: str) -> np.ndarray:
    """1-D interpolation matrix extended with zero rows/cols to padded dims.

    (rows_pad, cols_pad) ⊇ (n_dst, n_src); the zero extension makes
    W_pad @ src_pad exact on the padded shapes (pad cells of src are zero,
    pad rows of the output stay zero).
    """
    w = _zoom_matrix_np(n_src, n_dst, dtype_name)
    out = np.zeros((rows_pad, cols_pad), dtype=w.dtype)
    out[:n_dst, :n_src] = w
    return out


def zoom_p(src: jnp.ndarray, n_src: int, n_dst: int,
           dst_shape: tuple[int, int], zero_boundary: bool = False) -> jnp.ndarray:
    """Bilinear zoom between padded layouts: (R8(n_src), C128(n_src)) →
    ``dst_shape`` = (R8(n_dst), C128(n_dst)). Two dense matmuls (the matrix
    form of ker_Zoom_GPU, MG_solver_GPU.cu:913-958)."""
    rp_d, cp_d = dst_shape
    rp_s, cp_s = src.shape
    dt = jnp.dtype(src.dtype).name
    wy = jnp.asarray(_zoom_matrix_padded_np(n_src, n_dst, rp_d, rp_s, dt))
    wx = jnp.asarray(_zoom_matrix_padded_np(n_src, n_dst, cp_d, cp_s, dt))
    # HIGHEST: a float32 matmul may otherwise run in TF32 (~3 digits)
    hi = jax.lax.Precision.HIGHEST
    tmp = jnp.dot(wy, src, precision=hi,
                  preferred_element_type=src.dtype)                # (rp_d, cp_s)
    out = jnp.dot(tmp, wx.T, precision=hi,
                  preferred_element_type=src.dtype)                # (rp_d, cp_d)
    if zero_boundary:
        out = jnp.where(interior_mask(n_dst, out.shape), out, jnp.zeros_like(out))
    else:
        # keep layout invariant: anything outside the true grid must be 0
        from .layout import valid_mask
        out = jnp.where(valid_mask(n_dst, out.shape), out, jnp.zeros_like(out))
    return out


@lru_cache(maxsize=None)
def _zoom_take_taps_np(n_src: int, n_dst: int, pad_dst: int,
                       zero_boundary: bool):
    """(i0, w0, w1) arrays of length pad_dst for gather-based 1-D
    interpolation: out[j] = w0[j]·src[i0[j]] + w1[j]·src[i0[j]+1].

    The masking is baked into the tap weights — pad entries (j ≥ n_dst) and,
    for ``zero_boundary``, the boundary entries (j = 0, n_dst−1) get
    w0 = w1 = 0 — so no separate full-array mask pass is needed.
    """
    s = np.arange(pad_dst, dtype=np.float64) * ((n_src - 1) / (n_dst - 1))
    i0 = np.clip(np.floor(s).astype(np.int32), 0, n_src - 2)
    w = (s - i0).astype(np.float32)
    w0 = (1.0 - w).astype(np.float32)
    w1 = w
    w0[n_dst:] = 0.0
    w1[n_dst:] = 0.0
    i0[n_dst:] = 0
    if zero_boundary:
        w0[0] = w1[0] = 0.0
        w0[n_dst - 1] = w1[n_dst - 1] = 0.0
    return i0, w0, w1


def zoom_take_p(src: jnp.ndarray, n_src: int, n_dst: int,
                dst_shape: tuple[int, int], zero_boundary: bool = False) -> jnp.ndarray:
    """Gather-based bilinear zoom between padded layouts.

    Same contract as zoom_p but O(n²) memory traffic instead of O(n³)
    matmul flops: separable 2-point interpolation via gathers (``jnp.take``)
    along each axis, with boundary/pad zeroing baked into the tap weights.
    The axis processed first is chosen so the intermediate array stays at
    the COARSE size in both directions (restriction shrinks rows first;
    prolongation expands rows last) — the wrong order costs a fine-sized
    intermediate, measured 2.5× slower at 8193².
    """
    rp_d, cp_d = dst_shape
    iy, wy0, wy1 = _zoom_take_taps_np(n_src, n_dst, rp_d, zero_boundary)
    ix, wx0, wx1 = _zoom_take_taps_np(n_src, n_dst, cp_d, zero_boundary)
    iy = jnp.asarray(iy)
    wy0 = jnp.asarray(wy0, src.dtype)[:, None]
    wy1 = jnp.asarray(wy1, src.dtype)[:, None]
    ix = jnp.asarray(ix)
    wx0 = jnp.asarray(wx0, src.dtype)[None, :]
    wx1 = jnp.asarray(wx1, src.dtype)[None, :]

    def rows_pass(a):
        return (jnp.take(a, iy, axis=0) * wy0
                + jnp.take(a, iy + 1, axis=0) * wy1)

    def cols_pass(a):
        return (jnp.take(a, ix, axis=1) * wx0
                + jnp.take(a, ix + 1, axis=1) * wx1)

    if n_dst <= n_src:          # restriction: shrink rows before cols
        return cols_pass(rows_pass(src))
    return rows_pass(cols_pass(src))   # prolongation: expand rows last


def full_weighting_restrict_p(d: jnp.ndarray, n_src: int, n_dst: int,
                              dst_shape: tuple[int, int]) -> jnp.ndarray:
    """Full-weighting 2:1 restriction (extension beyond the reference).

    Requires exact vertex alignment: ``n_src == 2·n_dst − 1`` (the odd-halve
    coarsening rule 3). The separable [1/4, 1/2, 1/4]² stencil averages the
    residual over both colors — required when the smoother is red-black
    Gauss-Seidel: GS leaves the residual entirely on one color, and the
    reference's *sampling* restriction aliases that checkerboard into a
    double-amplitude coarse RHS (observed: rbgs V-cycles stall at ~0.5
    contraction and diverge at large N with sampling; textbook-fast with FW).
    Output boundary and pad cells are zero (restriction semantics).
    """
    if n_src != 2 * n_dst - 1:
        raise ValueError(
            f"full weighting needs n_src == 2*n_dst-1, got {n_src} -> {n_dst}")
    # separable smoothing pass then even-point sampling per axis
    sy = 0.25 * jnp.roll(d, 1, 0) + 0.5 * d + 0.25 * jnp.roll(d, -1, 0)
    sxy = 0.25 * jnp.roll(sy, 1, 1) + 0.5 * sy + 0.25 * jnp.roll(sy, -1, 1)
    rp_d, cp_d = dst_shape
    iy = np.minimum(2 * np.arange(rp_d), n_src - 1).astype(np.int32)
    ix = np.minimum(2 * np.arange(cp_d), n_src - 1).astype(np.int32)
    out = jnp.take(jnp.take(sxy, jnp.asarray(iy), axis=0),
                   jnp.asarray(ix), axis=1)
    return jnp.where(interior_mask(n_dst, out.shape), out, jnp.zeros_like(out))


def add_correction_p(u: jnp.ndarray, corr: jnp.ndarray, n: int) -> jnp.ndarray:
    """u += corr on the interior only (doGridAddition + the scheduler's
    interior-only application, MG_solver_CPU.cpp:350-368)."""
    return jnp.where(interior_mask(n, u.shape), u + corr, u)


def mean_abs_error_p(u, ref, n: int) -> jnp.ndarray:
    """Mean |u − ref| over the true n² cells (final report metric)."""
    from .layout import valid_mask
    d = jnp.where(valid_mask(n, u.shape), jnp.abs(u - ref), jnp.zeros_like(u))
    return jnp.sum(d) / (n * n)
