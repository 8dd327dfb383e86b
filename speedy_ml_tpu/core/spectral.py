"""Spherical-harmonic spectral transforms as batched array programs.

Replaces the reference's per-latitude Legendre loops + vendored FFTPACK
(/root/reference/src/spe_spectral.f90, spe_subfft_fftpack.f90) with
batched einsums over precomputed associated-Legendre tables and
`jnp.fft.rfft/irfft` on the longitude axis.  Coefficient conventions,
hemispheric symmetric/antisymmetric folding, and truncation masks are
behaviorally identical to the reference so spectral states interoperate.

Layout conventions:
- grid fields: (..., nlat, nlon), latitude index 0 = southernmost row
  (matches the reference's j=1 ordering, ini_indyns.f90:72-80);
- spectral fields: complex (..., mx, nx) where mx-1 = zonal wavenumber m,
  and the total wavenumber is l = m + n (0-based n).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# All transform einsums run at full f32 precision: a reduced-precision
# matmul (bf16 passes, or TF32 on tensor-core GPUs) puts an 8-10-bit
# mantissa error into every grid<->spectral round trip, which accumulates
# through the leapfrog and blows the T30 integration up after ~20 days
# (true f32, as on CPU, is stable for the same run).  These arrays are
# tiny, so HIGHEST costs nothing measurable against the physics.
_PREC = jax.lax.Precision.HIGHEST

from speedy_ml_tpu.core.geometry import Geometry


def _legendre_tables(geom: Geometry) -> dict[str, np.ndarray]:
    """Build all Legendre/operator tables in float64 numpy.

    Mirrors parmtr/lgndre (spe_spectral.f90:45-242) with 0-based indices.
    """
    mx, nx, iy = geom.mx, geom.nx, geom.nlat_half
    mxp, nxp = geom.mx, geom.nx + 1  # recursion needs one extra row
    ntrun, ntrun1 = geom.trunc, geom.ntrun1

    sia, wt = geom.sia, geom.wt
    coa = geom.coa

    # wavenumber tables
    m_idx = np.arange(mx)
    n_idx = np.arange(nx)
    ll = m_idx[:, None] + n_idx[None, :]          # total wavenumber l
    l2 = ll * (ll + 1)
    trfilt = (ll <= ntrun).astype(np.float64)
    mask_g = (ll <= ntrun1).astype(np.float64)    # transform mask (nsh2)
    mask_s = mask_g * (n_idx[None, :] <= ntrun1 - 1)  # specy also skips n=nx-1

    # epsi recursion coefficients: epsi[m, n] with emm=m, ell=m+n
    # (parmtr, spe_spectral.f90:130-146); rows n = 0..nx (one extra).
    me = np.arange(mxp)[:, None]
    ne = np.arange(nxp)[None, :]
    elle = me + ne
    with np.errstate(divide="ignore", invalid="ignore"):
        epsi = np.sqrt((elle.astype(np.float64) ** 2 - me.astype(np.float64) ** 2)
                       / (4.0 * elle.astype(np.float64) ** 2 - 1.0))
    epsi[0, 0] = 0.0
    epsi[:, nxp - 1] = 0.0
    repsi = np.where(epsi > 0.0, 1.0 / np.where(epsi > 0, epsi, 1.0), 0.0)

    # associated Legendre polynomials per half-grid latitude (lgndre)
    sqrhlf = np.sqrt(0.5)
    consq = np.zeros(mxp)
    consq[1:] = np.sqrt(0.5 * (2.0 * np.arange(1, mxp) + 1.0) / np.arange(1, mxp))

    cpol = np.zeros((iy, mx, nx))
    for j in range(iy):
        x, y = sia[j], coa[j]
        alp = np.zeros((mxp, nx))
        alp[0, 0] = sqrhlf
        for m in range(1, mxp):
            alp[m, 0] = consq[m] * y * alp[m - 1, 0]
        alp[:, 1] = (x * alp[:, 0]) * repsi[:, 1]
        for n in range(2, nx):
            alp[:, n] = (x * alp[:, n - 1] - epsi[:, n - 1] * alp[:, n - 2]) * repsi[:, n]
        alp[np.abs(alp) <= 1e-30] = 0.0
        cpol[j] = alp[:mx, :]

    return dict(ll=ll, l2=l2, trfilt=trfilt, mask_g=mask_g, mask_s=mask_s,
                epsi=epsi, cpol=cpol, wt=wt)


def _operator_tables(geom: Geometry, radius: float, tab: dict) -> dict[str, np.ndarray]:
    """Derivative/rotational operator tables (parmtr, spe_spectral.f90:153-175)."""
    mx, nx = geom.mx, geom.nx
    a = radius
    ll = tab["ll"].astype(np.float64)
    l2 = tab["l2"].astype(np.float64)
    epsi = tab["epsi"]

    el2 = l2 / (a * a)
    elm2 = np.zeros_like(el2)
    elm2[el2 > 0] = 1.0 / el2[el2 > 0]

    m_idx = np.arange(mx).astype(np.float64)
    gradx = m_idx / a

    # epsi shifted onto the (m, n) operator grid: eps_m[m, n] = epsi[m, n] and
    # eps_p[m, n] = epsi[m, n+1] (Fortran epsi(m2, n) / epsi(m2, n+1)).
    eps_m = epsi[:mx, :nx]
    eps_p = epsi[:mx, 1:nx + 1]

    el1 = ll
    gradym = np.zeros((mx, nx))
    gradyp = (el1 + 2.0) * eps_p / a
    uvdx = np.zeros((mx, nx))
    uvdym = np.zeros((mx, nx))
    uvdyp = -a * eps_p / (el1 + 1.0)
    vddym = np.zeros((mx, nx))
    vddyp = el1 * eps_p / a

    # n = 0 row
    uvdx[:, 0] = -a / (m_idx + 1.0)
    # n >= 1 rows
    sl = np.s_[:, 1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        uvdx[sl] = -a * m_idx[:, None] / (el1[sl] * (el1[sl] + 1.0))
        gradym[sl] = (el1[sl] - 1.0) * eps_m[sl] / a
        uvdym[sl] = -a * eps_m[sl] / el1[sl]
        vddym[sl] = (el1[sl] + 1.0) * eps_m[sl] / a

    return dict(el2=el2, elm2=elm2, el4=el2 * el2, gradx=gradx,
                gradym=gradym, gradyp=gradyp, uvdx=uvdx, uvdym=uvdym,
                uvdyp=uvdyp, vddym=vddym, vddyp=vddyp)


def _shift_right(x: jnp.ndarray) -> jnp.ndarray:
    """x[..., n] -> x[..., n-1], zero at n=0 (last axis = n)."""
    return jnp.concatenate([jnp.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)


def _shift_left(x: jnp.ndarray) -> jnp.ndarray:
    """x[..., n] -> x[..., n+1], zero at n=nx-1."""
    return jnp.concatenate([x[..., 1:], jnp.zeros_like(x[..., :1])], axis=-1)


class SpectralTransform:
    """Batched spherical-harmonic transform pack for one geometry.

    All methods are pure functions of jnp arrays and are safe to call
    inside jit; the instance holds constant tables (closed over as
    compile-time constants).
    """

    def __init__(self, geom: Geometry, radius: float = 6.371e6,
                 dtype=jnp.float32, zonal: str = "fft"):
        self.geom = geom
        self.radius = radius
        self.dtype = jnp.dtype(dtype)
        self.cdtype = jnp.complex128 if self.dtype == jnp.float64 else jnp.complex64

        tab = _legendre_tables(geom)
        ops = _operator_tables(geom, radius, tab)

        # host-side (numpy) tables: embedded as XLA constants at trace time
        f = lambda x: np.asarray(x, dtype=self.dtype)
        iy = geom.nlat_half
        n_idx = np.arange(geom.nx)
        even_n = (n_idx % 2 == 0).astype(np.float64)

        # Legendre matrices with masks and parity folded in.
        self.cpol_even_g = f(tab["cpol"] * tab["mask_g"] * even_n)          # (iy,mx,nx)
        self.cpol_odd_g = f(tab["cpol"] * tab["mask_g"] * (1.0 - even_n))
        self.cpol_even_s = f(tab["cpol"] * tab["mask_s"] * even_n)
        self.cpol_odd_s = f(tab["cpol"] * tab["mask_s"] * (1.0 - even_n))
        self.wt = f(tab["wt"])                                              # (iy,)
        self.trfilt = f(tab["trfilt"])

        self.el2 = f(ops["el2"])
        self.elm2 = f(ops["elm2"])
        self.gradx = f(ops["gradx"])
        self.gradym, self.gradyp = f(ops["gradym"]), f(ops["gradyp"])
        self.uvdx = f(ops["uvdx"])
        self.uvdym, self.uvdyp = f(ops["uvdym"]), f(ops["uvdyp"])
        self.vddym, self.vddyp = f(ops["vddym"]), f(ops["vddyp"])
        # mask that kills the i*m*f zonal-derivative term in the last n row,
        # matching the reference's edge handling in vds/uvspec
        # (spe_spectral.f90:330-337, 368-375).
        zrow = np.ones(geom.nx)
        zrow[-1] = 0.0
        self.zrow_mask = f(zrow)

        cosg = geom.cos_lat
        self.cosgr = f(1.0 / cosg)       # (nlat,)
        self.cosgr2 = f(1.0 / cosg**2)
        self.ll = np.asarray(tab["ll"])  # int

        # zonal-transform backend: "fft" (XLA FFT kernels) or "dft"
        # (explicit DFT matmuls).  Only mx of nlon/2+1 frequencies are
        # kept (triangular truncation), so the DFT matrices are small
        # (nlon x mx); they run as matmuls beside the Legendre einsums,
        # and they compose with ANY sharding — XLA's CPU fft thunk
        # rejects the relayouts GSPMD introduces around a sharded GCM.
        self.zonal = zonal
        if zonal == "dft":
            j = np.arange(geom.nlon)
            m = np.arange(geom.mx)
            ang = 2.0 * np.pi * np.outer(j, m) / geom.nlon
            self.dft_fwd = (np.exp(-1j * ang) / geom.nlon).astype(
                np.dtype(self.cdtype))                      # (nlon, mx)
            cm = np.ones(geom.mx)
            cm[1:] = 2.0
            self.dft_inv = (np.exp(1j * ang) * cm[None, :]).T.astype(
                np.dtype(self.cdtype))                      # (mx, nlon)
        elif zonal != "fft":
            raise ValueError(f"zonal must be 'fft' or 'dft', got {zonal}")

        # tensor parallelism over zonal wavenumber m (SURVEY 2.3 TP row):
        # set_mesh installs sharding constraints at the transform
        # boundaries so the Legendre einsum batch axis partitions across
        # devices instead of replicating the whole spectral core
        self._c_fm = None     # (..., lat, m): m is the LAST axis
        self._c_sp = None     # (..., m, n):   m is the second-to-last

    def set_mesh(self, mesh, axis: str = "regions"):
        """Shard the spectral transforms over zonal wavenumber m.

        The reference's Legendre work is a per-latitude loop over m
        (spe_spectral.f90:454-538); here it is a batched einsum whose m
        axis this pins to the mesh.  Every spectral operator (vds/
        uvspec/grad/lap/trunct) is elementwise in m — the _shift_* ops
        move n — so the sharding propagates through the whole dycore
        step with collectives only at the zonal legs (reduce over lon
        on the way in, over m on the way out).  Requires zonal='dft'
        (the matmul DFT composes with GSPMD; the FFT thunk does not)."""
        if self.zonal != "dft":
            raise ValueError("spectral m-sharding needs zonal='dft'")
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        fm_s = NamedSharding(mesh, P(axis))       # rank-extended below
        def c(a, pos):
            spec = [None] * a.ndim
            spec[pos] = axis
            return jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, P(*spec)))
        self._c_fm = lambda a: c(a, a.ndim - 1)
        self._c_sp = lambda a: c(a, a.ndim - 2)

    # ------------------------------------------------------------------
    # longitude (Fourier) leg
    # ------------------------------------------------------------------

    def _specx(self, field: jnp.ndarray) -> jnp.ndarray:
        """Grid (..., nlat, nlon) -> zonal coeffs (..., nlat, mx) complex."""
        if self.zonal == "dft":
            fm = jnp.einsum("...j,jm->...m", field.astype(self.dtype),
                            self.dft_fwd, precision=_PREC)
            return fm if self._c_fm is None else self._c_fm(fm)
        fm = jnp.fft.rfft(field.astype(self.dtype), axis=-1)
        return (fm[..., : self.geom.mx] / self.geom.nlon).astype(self.cdtype)

    def _gridx(self, fm: jnp.ndarray, kcos: int) -> jnp.ndarray:
        """Zonal coeffs (..., nlat, mx) -> grid (..., nlat, nlon)."""
        if self.zonal == "dft":
            g = jnp.einsum("...m,mj->...j", fm, self.dft_inv,
                           precision=_PREC).real
            g = g.astype(self.dtype)
        else:
            nfreq = self.geom.nlon // 2 + 1
            pad = nfreq - self.geom.mx
            fmp = jnp.pad(fm, [(0, 0)] * (fm.ndim - 1) + [(0, pad)])
            g = jnp.fft.irfft(fmp, n=self.geom.nlon, axis=-1) * self.geom.nlon
            g = g.astype(self.dtype)
        if kcos != 1:
            g = g * self.cosgr[:, None]
        return g

    # ------------------------------------------------------------------
    # latitude (Legendre) leg with hemispheric folding
    # ------------------------------------------------------------------

    def _specy(self, fm: jnp.ndarray) -> jnp.ndarray:
        """Zonal coeffs (..., nlat, mx) -> spectral (..., mx, nx)."""
        iy = self.geom.nlat_half
        south = fm[..., :iy, :]
        north = jnp.flip(fm[..., iy:, :], axis=-2)
        sv = (north + south) * self.wt[:, None]
        dv = (north - south) * self.wt[:, None]
        even = jnp.einsum("jmn,...jm->...mn", self.cpol_even_s, sv,
                          precision=_PREC)
        odd = jnp.einsum("jmn,...jm->...mn", self.cpol_odd_s, dv,
                         precision=_PREC)
        out = even + odd
        return out if self._c_sp is None else self._c_sp(out)

    def _gridy(self, v: jnp.ndarray) -> jnp.ndarray:
        """Spectral (..., mx, nx) -> zonal coeffs (..., nlat, mx)."""
        if self._c_sp is not None:
            v = self._c_sp(v)
        even = jnp.einsum("jmn,...mn->...jm", self.cpol_even_g, v,
                          precision=_PREC)
        odd = jnp.einsum("jmn,...mn->...jm", self.cpol_odd_g, v,
                         precision=_PREC)
        north = even + odd
        south = even - odd
        fm = jnp.concatenate([south, jnp.flip(north, axis=-2)], axis=-2)
        return fm if self._c_fm is None else self._c_fm(fm)

    # ------------------------------------------------------------------
    # public transforms
    # ------------------------------------------------------------------

    def grid_to_spec(self, field: jnp.ndarray) -> jnp.ndarray:
        """Forward transform (spec = specy . specx)."""
        return self._specy(self._specx(field))

    def spec_to_grid(self, v: jnp.ndarray, kcos: int = 1) -> jnp.ndarray:
        """Inverse transform (grid = gridx . gridy); kcos=2 multiplies 1/cos."""
        return self._gridx(self._gridy(v), kcos)

    def vdspec(self, ug: jnp.ndarray, vg: jnp.ndarray, kcos: int = 2
               ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Grid u,v -> spectral vorticity & divergence (spe_spectral.f90:416-452)."""
        scale = self.cosgr if kcos == 2 else self.cosgr2
        u1 = ug * scale[:, None]
        v1 = vg * scale[:, None]
        um = self._specy(self._specx(u1))
        vm = self._specy(self._specx(v1))
        return self.vds(um, vm)

    def vds(self, ucosm: jnp.ndarray, vcosm: jnp.ndarray
            ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Spectral (u*cos, v*cos) -> (vor, div) (spe_spectral.f90:307-349)."""
        zp = 1j * self.gradx[:, None] * ucosm * self.zrow_mask
        zc = 1j * self.gradx[:, None] * vcosm * self.zrow_mask
        vorm = (self.vddym * _shift_right(ucosm)
                - self.vddyp * _shift_left(ucosm) + zc)
        divm = (-self.vddym * _shift_right(vcosm)
                + self.vddyp * _shift_left(vcosm) + zp)
        return vorm, divm

    def uvspec(self, vorm: jnp.ndarray, divm: jnp.ndarray
               ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Spectral (vor, div) -> spectral (u*cos, v*cos) (spe_spectral.f90:351-387)."""
        zp = 1j * self.uvdx * vorm * self.zrow_mask
        zc = 1j * self.uvdx * divm * self.zrow_mask
        ucosm = (self.uvdym * _shift_right(vorm)
                 - self.uvdyp * _shift_left(vorm) + zc)
        vcosm = (-self.uvdym * _shift_right(divm)
                 + self.uvdyp * _shift_left(divm) + zp)
        return ucosm, vcosm

    def uv_grid(self, vorm: jnp.ndarray, divm: jnp.ndarray
                ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Spectral vor/div -> grid u, v (with 1/cos applied)."""
        ucosm, vcosm = self.uvspec(vorm, divm)
        u = self.spec_to_grid(ucosm, kcos=2)
        v = self.spec_to_grid(vcosm, kcos=2)
        return u, v

    def grad(self, psi: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Spectral gradient (spe_spectral.f90:271-305): returns (d/dx, d/dy)*cos-weighted."""
        psdx = 1j * self.gradx[:, None] * psi
        psdy = -self.gradym * _shift_right(psi) + self.gradyp * _shift_left(psi)
        return psdx, psdy

    def lap(self, psi: jnp.ndarray) -> jnp.ndarray:
        return -psi * self.el2

    def invlap(self, vor: jnp.ndarray) -> jnp.ndarray:
        return -vor * self.elm2

    def trunct(self, v: jnp.ndarray) -> jnp.ndarray:
        return v * self.trfilt


@functools.lru_cache(maxsize=8)
def get_transform(geom: Geometry, radius: float, dtype_name: str) -> SpectralTransform:
    return SpectralTransform(geom, radius, jnp.dtype(dtype_name))
