"""Mixed-precision panel Cholesky on split (band, off) storage.

Counterpart of `repro.core.panel_cholesky`, the performance engine: the
factorization runs as p panel steps over

  band : (p, t, nb, nb) in hi -- band[i, d] = tile (i, i-d), the diag_thick
         tile sub-diagonals kept in high precision;
  off  : (p, p, nb, nb) in lo -- tiles with i - j >= t (lower triangle).

Per step k:
  1. potrf(band[k,0]) in hi                               (dpotrf)
     (the blocked_potrf kernel for an fp32 band, cuSOLVER's for fp64)
  2. hi TRSM on the <= t-1 band panel tiles               (dtrsm)
     lo TRSM on the off panel tiles                       (strsm)
  3. U = C C^T of the gathered panel column C, in hi inside the band and
     in lo (fp32 sum rounded once to lo) outside it; U's band blocks update
     the hi sub-diagonals, its off-band blocks the lo region    (syrk/gemm)

`impl` picks who computes the three hot operations: "kernel" calls the
kernels' `ops` functions (the CUDA kernels on a CUDA tensor, their plain
versions on a CPU tensor), "plain" their plain versions (`ref`) on any
device.  With off_update="chunked" step 3 stays plain PyTorch on both, like
the reference.

Unlike the reference, the factorization works in place on (band, off): at
the main path's size a second copy would cost 10.7 GB.  A tile that is not
positive definite raises a flag on the device (no host sync per step), and
`banded_loglik` returns NaN where it is set.

The engine is differentiable in theta (and z) as the reference's is:
`geostat_loglik_step` with a theta tensor that requires grad builds the
storage through `BandedMaternCov` (its backward the `matern_cov_grad`
kernel's tile-stack forms on the card) and factors it through
`PanelCholesky`, whose backward is the reverse sweep
`panel_cholesky_backward`: per step, from the last, the trailing update's
cotangent through `mp_syrk_grad` (the kernel on the card), the two panel
TRSMs' and the diagonal tile's Cholesky backward, reading every value it
needs from the final factor and working in place on the cotangents of
(band, off), which stay in the storage dtypes.  It does not differentiate
in the locations.
"""

from __future__ import annotations

import functools
import math

import torch

from ..covariance.matern import HALF_INTEGER_NUS, matern_covariance
from ..kernels.blocked_potrf import ops as potrf_ops, ref as potrf_ref
from ..kernels.matern_cov import ops as matern_ops, ref as matern_ref
from ..kernels.mp_gemm import ops as syrk_ops
from .precision import PrecisionPolicy, lo_matmul, require_ieee_fp32

# (matern_cov module, POTRF, SYRK) of each impl.  Under autograd the kernel
# POTRF differentiates through `Potrf` and the plain one through autograd;
# the SYRK of either through `MpSyrk`, whose backward is the mp_syrk_grad
# kernel with "kernel" on a CUDA tensor and its plain version otherwise
# (autograd through ref.mp_syrk would clone U's whole gradient per tile row)
_IMPLS = {
    "kernel": (matern_ops, potrf_ops.potrf, syrk_ops.mp_syrk),
    "plain": (matern_ref, potrf_ref.potrf,
              functools.partial(syrk_ops.mp_syrk, plain=True)),
}


def _impl(impl):
    if impl not in _IMPLS:
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    return _IMPLS[impl]


def _cholesky(a, dtype):
    """(l, info): the lower Cholesky factor of `a` in `dtype`, all NaN where
    the matrix is not positive definite (the reference's convention), and
    info != 0 there, as the POTRF kernel's.  The NaN is set in place, but
    where autograd records `a` out of place, since its Cholesky backward
    reads the factor it saved, and then only when a factor failed (a host
    read of info): a second fp64 factor at n = 40,960 would be 13.4 GB."""
    l, info = torch.linalg.cholesky_ex(a.to(dtype))
    bad = (info != 0)[..., None, None]
    if a.requires_grad and torch.is_grad_enabled():
        return (l.masked_fill(bad, torch.nan) if bool(bad.any()) else l), info
    return l.masked_fill_(bad, torch.nan), info


def _potrf(impl, hi):
    """The diagonal-tile factorization of a band in `hi`, chosen by dtype up
    front: an fp32 band goes to the `blocked_potrf` kernel (its plain
    version with impl="plain"), which is fp32-only as the TPU kernel is;
    any other band to `torch.linalg.cholesky_ex` in `hi`, as the reference
    engines factor it with `jnp.linalg.cholesky`."""
    if hi == torch.float32:
        return _impl(impl)[1]
    return lambda a: _cholesky(a, hi)


def _requires_grad(*values):
    """Whether autograd would record any of these tensors (grad mode on)."""
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in values)


def _host_theta(theta):
    """theta as host floats: the kernels take it as launch arguments."""
    return [float(v) for v in torch.as_tensor(theta).reshape(-1).tolist()]


# ----------------------------------------------------------------------
# banded storage construction
# ----------------------------------------------------------------------

def build_banded_covariance(locs, theta, *, nb: int, policy: PrecisionPolicy,
                            nu_static=None, metric="euclidean", jitter=1e-6,
                            impl: str = "kernel"):
    """Matern covariance directly into (band, off) split storage.

    band[i, d] = Sigma tile (i, i-d) in hi; off[i, j] = tile (i, j) in lo
    (only i - j >= t is filled; the rest is zero).  nu_static=None takes
    the smoothness from theta[2] (see `kernels.matern_cov.ops`).
    """
    matern, _, _ = _impl(impl)
    n = locs.shape[0]
    if n % nb:
        raise ValueError(f"n={n} is not a multiple of nb={nb}")
    p = n // nb
    t = min(policy.diag_thick, p)
    hi, lo = policy.hi, (policy.lo if policy.mode != "full" else policy.hi)
    theta = _host_theta(theta)
    nu = nu_static if nu_static is not None else theta[2]
    locs_t = locs.reshape(p, nb, locs.shape[-1])

    band = torch.zeros((p, t, nb, nb), dtype=hi, device=locs.device)
    for d in range(t):  # band sub-diagonals, written in place
        matern.matern_cov_tiles(locs_t[d:], locs_t[:p - d], theta,
                                nu=nu, out_dtype=hi, metric=metric,
                                out=band[d:, d])
    band[:, 0].diagonal(dim1=-2, dim2=-1).add_(jitter)
    off = matern.matern_cov_lower(locs_t, theta, nu=nu, min_lag=t,
                                  out_dtype=lo, metric=metric)
    return band, off


def _banded_covariance_plain_grad(locs, theta, *, nb, policy, nu, metric,
                                  jitter):
    """(band, off) as `build_banded_covariance` builds them for a nu with no
    closed form, through the plain covariance (covariance/matern.py) under
    autograd, as the reference builds its storage: differentiable in theta,
    nu = theta[2] (or `nu` where given) taking the general Bessel path, the
    same tiles and bits as the plain build."""
    n = locs.shape[0]
    if n % nb:
        raise ValueError(f"n={n} is not a multiple of nb={nb}")
    p = n // nb
    t = min(policy.diag_thick, p)
    hi, lo = policy.hi, (policy.lo if policy.mode != "full" else policy.hi)
    th = theta.reshape(-1).to(torch.promote_types(locs.dtype, torch.float32))
    if nu is not None:
        th = torch.cat([th[:2], th.new_tensor([float(nu)])])
    locs_t = locs.reshape(p, nb, locs.shape[-1])
    cols = []
    for d in range(t):
        blk = matern_covariance(locs_t[d:], locs_t[:p - d], th,
                                metric=metric).to(hi)
        cols.append(torch.cat([blk.new_zeros((d, nb, nb)), blk]))
    band = torch.stack(cols, dim=1)
    band[:, 0].diagonal(dim1=-2, dim2=-1).add_(jitter)
    rows = []
    for i in range(p):
        j = max(0, i - t + 1)
        tiles = [torch.zeros((p - j, nb, nb), dtype=lo, device=locs.device)]
        if j:
            cols_j = locs_t[:j].reshape(-1, locs.shape[-1])
            row = matern_covariance(locs_t[i], cols_j, th, metric=metric)
            tiles.insert(0, row.reshape(nb, j, nb).transpose(0, 1).to(lo))
        rows.append(torch.cat(tiles))
    return band, torch.stack(rows)


def _banded_covariance_grad(locs, theta, *, nb, policy, nu_static, metric,
                            jitter, impl):
    """(band, off) differentiable in the theta tensor: a half-integer
    nu_static through `BandedMaternCov` (the forward the plain build's, the
    backward the matern_cov_grad kernel's tile-stack forms, or their plain
    versions with impl="plain"), any other nu through the plain covariance
    under autograd."""
    if nu_static not in HALF_INTEGER_NUS:
        return _banded_covariance_plain_grad(locs, theta, nb=nb, policy=policy,
                                             nu=nu_static, metric=metric,
                                             jitter=jitter)
    build = functools.partial(build_banded_covariance, locs, nb=nb,
                              policy=policy, nu_static=nu_static,
                              metric=metric, jitter=jitter, impl=impl)
    return matern_ops.BandedMaternCov.apply(locs, theta, build, nu_static,
                                            metric, _impl(impl)[0])


def assemble_from_banded(band, off, t: int, dtype=None):
    """(band, off) -> dense lower-triangular (n, n) matrix in hi."""
    p, _, nb, _ = band.shape
    dtype = dtype or band.dtype
    n = p * nb
    out = torch.zeros((n, n), dtype=dtype, device=band.device)
    for i in range(p):
        for d in range(min(i + 1, t)):
            j = i - d
            out[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = band[i, d]
        for j in range(0, i - t + 1):
            out[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = off[i, j]
    return torch.tril(out)


# ----------------------------------------------------------------------
# the factorization
# ----------------------------------------------------------------------

def _trsm_right_lt(l, a, exec_dtype, out_dtype):
    """a[i] <- a[i] L^{-T} for a: (m, nb, nb), solved in exec_dtype."""
    x = torch.linalg.solve_triangular(l.to(exec_dtype).mT, a.to(exec_dtype),
                                      upper=True, left=False)
    return x.to(out_dtype)


def panel_cholesky_banded(band, off, policy: PrecisionPolicy, *,
                          off_update: str = "square", impl: str = "kernel"):
    """Factor the banded-storage SPD matrix in place.

    Returns (band, off, failed): failed is a 0-d bool tensor on the device,
    set when a diagonal tile was not positive definite.

    off_update: "square"  -- one m x m SYRK per step (mp_syrk), whose
                             off-band blocks update the lo region;
                "chunked" -- per-column-block lo GEMMs over the lower
                             trapezoid only (plain PyTorch).
    """
    if off_update not in ("square", "chunked"):
        raise ValueError(off_update)
    require_ieee_fp32()
    _, _, syrk = _impl(impl)
    p, t, nb, _ = band.shape
    hi = policy.hi
    potrf = _potrf(impl, hi)
    lo = off.dtype
    failed = torch.zeros((), dtype=torch.bool, device=band.device)

    for k in range(p):
        lkk, info = potrf(band[k, 0])
        band[k, 0] = lkk
        failed |= info != 0
        m_t = p - k - 1
        if m_t == 0:
            break

        # --- panel TRSMs -------------------------------------------------
        # the lo TRSM solves with the lo-rounded factor, as the SP tiles of
        # the paper's algorithm see it
        d_idx = torch.arange(1, min(t - 1, m_t) + 1, device=band.device)
        band[k + d_idx, d_idx] = _trsm_right_lt(lkk, band[k + d_idx, d_idx],
                                                hi, hi)
        if k + t <= p - 1:
            off[k + t:, k] = _trsm_right_lt(lkk.to(lo), off[k + t:, k],
                                            policy.solve_dtype, lo)

        # --- the factored panel column as hi tiles ------------------------
        # c_hi[m] = tile (k+1+m, k), shape (m_t, nb, nb)
        c_hi = torch.cat([band[k + d_idx, d_idx], off[k + t:, k].to(hi)])

        if off_update == "square":
            u = syrk(c_hi.reshape(m_t * nb, nb), tile=nb, round_k=nb,
                     band_blocks=t, hi=hi, lo=lo, accum=policy.accum_dtype)
            u4 = u.view(m_t, nb, m_t, nb)
            for d in range(min(t, m_t)):    # hi sub-diagonal d: u4[a+d, :, a, :]
                band[k + 1 + d:, d] -= torch.diagonal(
                    u4, offset=-d, dim1=0, dim2=2).permute(2, 0, 1)
            # lo update of tiles (i, j), i - j >= t, one tile row at a time
            # and in place: a masked update of the whole square would take
            # three lo temporaries of its size (8.6 GB each at step 0 of the
            # main path)
            for i in range(t, m_t):
                off[k + 1 + i, k + 1:k + 2 + i - t] -= (
                    u4[i, :, :i - t + 1].transpose(0, 1).to(lo))
            # free this step's U before the next step allocates its own
            del u, u4
        else:
            for d in range(min(t, m_t)):
                band[k + 1 + d:, d] -= torch.einsum(
                    "iab,icb->iac", c_hi[d:], c_hi[:m_t - d])
            # exact lower trapezoid: for each target column-tile j, only
            # rows i >= j + t receive the lo update
            c_lo = c_hi.to(lo)
            for j in range(k + 1, p - t):
                lhs = c_lo[j + t - k - 1:]              # tiles (j+t..p-1, k)
                rhs = c_lo[j - k - 1]                   # tile (j, k)
                off[j + t:, j] -= lo_matmul(lhs, rhs.T, policy)
    return band, off, failed


def _trailing_cotangent(g_band, g_off, k, t, buf):
    """The cotangent of step k's trailing product U = C C^T (m_t nb square
    in hi) from those of the storage after step k, written into the front
    of `buf` (the sweep's one buffer of step 0's size in hi: a dU per step
    would strand the allocator's smaller blocks as dU grows, 21 GiB of the
    paper pair's at n = 59,392 on an NVIDIA H100 80GB HBM3, 700 W): U's
    band tiles (i, i - d) are g_band's
    sub-diagonals, its off-band tiles (i, j), i - j >= t, g_off's; U's
    strictly upper tiles are left unset (mp_syrk_grad reads only the lower
    ones).  The forward subtracts U, so U's cotangent is this one
    negated."""
    p, _, nb, _ = g_band.shape
    m_t = p - k - 1
    du = buf[:(m_t * nb) ** 2].view(m_t, nb, m_t, nb)
    for d in range(min(t, m_t)):    # du[a + d, :, a, :] = g_band[k+1+a+d, d]
        torch.diagonal(du, offset=-d, dim1=0, dim2=2).copy_(
            g_band[k + 1 + d:, d].permute(1, 2, 0))
    for i in range(t, m_t):
        du[i, :, :i - t + 1] = g_off[k + 1 + i,
                                     k + 1:k + 2 + i - t].transpose(0, 1)
    return du.view(m_t * nb, m_t * nb)


def panel_cholesky_backward(band, off, g_band, g_off, policy: PrecisionPolicy,
                            *, impl: str = "kernel"):
    """The reverse sweep of `panel_cholesky_banded`: from the factored
    storage (band, off) and the cotangents (g_band, g_off) of the factor,
    the cotangents of the storage it factored, written in place into
    g_band (hi) and g_off (lo) and returned.

    Step k, from the last, reads only the final factor: L_kk = band[k, 0],
    the band panel X = band[k+d, d] and the lo panel Y = off[k+t:, k].
      * the trailing update U = C C^T of C = [X; Y in hi]: its cotangent
        (`_trailing_cotangent`) through mp_syrk_grad (the kernel on a CUDA
        tensor with impl="kernel", its plain version otherwise), with the
        forward's band / off-band precision split, gives C's, added to X's
        and Y's own (Y's rounded to lo, as the cast to hi passes it back);
      * the hi TRSM X = B L^-T: B's cotangent X_bar L^-1, and -B_bar^T X
        into L_kk's;
      * the lo TRSM, solved in solve_dtype with L_kk rounded to lo: the
        same in solve_dtype, B's cotangent stored in lo and L_kk's share
        rounded to lo and back to hi, as the casts pass it;
      * L_kk = chol(A_kk): A_kk's cotangent by `cholesky_backward` (torch's
        own formula, in torch ops, for either band dtype).
    A NaN factor (a tile that was not positive definite) gives NaN
    cotangents.  The backward uses the forward's "square" SYRK for either
    off_update: both compute the same lower products."""
    require_ieee_fp32()
    plain = _impl(impl) is _IMPLS["plain"]
    p, t, nb, _ = band.shape
    hi, lo, sd = policy.hi, off.dtype, policy.solve_dtype
    du_buf = torch.empty(((p - 1) * nb) ** 2, dtype=hi, device=band.device)
    for k in reversed(range(p)):
        lkk = band[k, 0]
        gl = g_band[k, 0]
        m_t = p - k - 1
        if m_t:
            n_bp = min(t - 1, m_t)
            d_idx = torch.arange(1, n_bp + 1, device=band.device)
            x = band[k + d_idx, d_idx]
            y = off[k + t:, k]
            c_hi = torch.cat([x, y.to(hi)])
            du = _trailing_cotangent(g_band, g_off, k, t, du_buf)
            g_c = -syrk_ops.mp_syrk_grad(
                du, c_hi.reshape(m_t * nb, nb), tile=nb, band_blocks=t,
                hi=hi, lo=lo, accum=policy.accum_dtype, plain=plain)
            del du, c_hi
            g_c = g_c.view(m_t, nb, nb)
            g_b = torch.linalg.solve_triangular(
                lkk, g_band[k + d_idx, d_idx] + g_c[:n_bp], upper=False,
                left=False)
            gl = gl - g_b.reshape(-1, nb).mT @ x.reshape(-1, nb)
            g_band[k + d_idx, d_idx] = g_b
            if k + t <= p - 1:
                g_y = (g_off[k + t:, k] + g_c[n_bp:].to(lo)).to(sd)
                g_o = torch.linalg.solve_triangular(
                    lkk.to(lo).to(sd), g_y.reshape(-1, nb), upper=False,
                    left=False)
                gl = gl - (g_o.mT @ y.to(sd).reshape(-1, nb)).to(lo).to(hi)
                g_off[k + t:, k] = g_o.view(-1, nb, nb).to(lo)
            del g_c
        g_band[k, 0] = potrf_ops.cholesky_backward(gl, lkk)
    return g_band, g_off


class PanelCholesky(torch.autograd.Function):
    """(band, off, failed) = panel_cholesky_banded(band, off), in place,
    differentiable in (band, off): the forward marks both dirty and saves
    the factored storage only; the backward is `panel_cholesky_backward`,
    which works in place on the cotangents autograd hands it (the engine's
    own, from `banded_loglik`): no second copy of the storage or of its
    cotangent.  failed has no gradient.

    On the card the forward ends by returning the caching allocator's free
    blocks to the device: they are its per-step U products, one of step 0's
    size and smaller ones, and the cotangents of (band, off) allocated into
    them in the backward stranded the rest of each (22 GiB of the paper
    pair's at n = 59,392 on an NVIDIA H100 80GB HBM3, 700 W, where the
    sweep's dU then found no room).

        PanelCholesky.apply(band, off, policy, off_update, impl)
    """

    @staticmethod
    def forward(ctx, band, off, policy, off_update, impl):
        band, off, failed = panel_cholesky_banded(band, off, policy,
                                                  off_update=off_update,
                                                  impl=impl)
        if band.is_cuda:
            torch.cuda.empty_cache()
        ctx.mark_dirty(band, off)
        ctx.mark_non_differentiable(failed)
        ctx.save_for_backward(band, off)
        ctx.policy, ctx.impl = policy, impl
        return band, off, failed

    @staticmethod
    def backward(ctx, g_band, g_off, _):
        band, off = ctx.saved_tensors
        g_band, g_off = panel_cholesky_backward(
            band, off, g_band.contiguous(), g_off.contiguous(), ctx.policy,
            impl=ctx.impl)
        return g_band, g_off, None, None, None


# ----------------------------------------------------------------------
# solve / likelihood on banded storage
# ----------------------------------------------------------------------

def banded_forward_solve(band, off, z, t: int):
    """w = L^{-1} z via blocked forward substitution on split storage."""
    require_ieee_fp32()
    p, _, nb, _ = band.shape
    hi = band.dtype
    z_t = z.to(hi).reshape(p, nb)
    # tile rows by unbind, not an index per tile: under autograd an index's
    # backward is a zero tensor of the whole storage (8 GiB of off at the
    # main path's size), an unbound row's one row of it
    band_rows, off_rows = band.unbind(0), off.unbind(0)
    ws = []
    for i in range(p):
        acc = z_t[i]
        for d in range(1, min(i + 1, t)):
            acc = acc - band_rows[i][d] @ ws[i - d]
        if i - t >= 0:
            w_mat = torch.stack(ws[:i - t + 1])            # (i-t+1, nb)
            acc = acc - torch.einsum("jab,jb->a",
                                     off_rows[i][:i - t + 1].to(hi), w_mat)
        ws.append(torch.linalg.solve_triangular(
            band_rows[i][0], acc[:, None], upper=False)[:, 0])
    return torch.cat(ws)


def banded_loglik(band, off, z, t: int, failed=None):
    """Gaussian log-likelihood (Eq. 2) from the factored banded storage.

    NaN where `failed` (from `panel_cholesky_banded`) is set.
    """
    p, _, nb, _ = band.shape
    n = p * nb
    diag = torch.diagonal(band[:, 0], dim1=-2, dim2=-1)
    logdet_half = torch.sum(torch.log(diag))
    w = banded_forward_solve(band, off, z, t)
    ll = -0.5 * n * math.log(2.0 * math.pi) - logdet_half - 0.5 * torch.sum(w * w)
    if failed is not None:
        ll = torch.where(failed, torch.nan, ll)
    return ll


def geostat_loglik_step(locs, z, theta, *, nb: int, policy: PrecisionPolicy,
                        nu_static=None, metric="euclidean", jitter=1e-6,
                        off_update: str = "square", impl: str = "kernel"):
    """One full likelihood evaluation: cov-gen -> factor -> solve -> ll.

    Computes on the device of `locs` and returns a 0-d tensor there.  This
    is the unit the paper benchmarks ("time per iteration").  A theta
    tensor that requires grad (with grad mode on) makes it differentiable,
    on either device and for either impl: the storage is built through
    `BandedMaternCov` (a general nu through the plain covariance under
    autograd) and factored in place through `PanelCholesky`, whose
    backward is the reverse sweep (`panel_cholesky_backward`); z that
    requires grad differentiates through the solve.  theta3 gets a zero
    gradient under a half-integer nu_static.  Locations that require grad
    raise: no path of the port differentiates in them.  The value is the
    same bit for bit with and without autograd.
    """
    if _requires_grad(locs):
        raise NotImplementedError(
            "geostat_loglik_step does not differentiate in the locations: "
            "the covariance's backward gives theta's gradient only")
    require_ieee_fp32()
    if _requires_grad(theta):
        band, off = _banded_covariance_grad(
            locs, theta, nb=nb, policy=policy, nu_static=nu_static,
            metric=metric, jitter=jitter, impl=impl)
        band, off, failed = PanelCholesky.apply(band, off, policy,
                                                off_update, impl)
    else:
        band, off = build_banded_covariance(locs, theta, nb=nb, policy=policy,
                                            nu_static=nu_static, metric=metric,
                                            jitter=jitter, impl=impl)
        band, off, failed = panel_cholesky_banded(band, off, policy,
                                                  off_update=off_update,
                                                  impl=impl)
    t = min(policy.diag_thick, band.shape[0])
    return banded_loglik(band, off, z, t, failed)
