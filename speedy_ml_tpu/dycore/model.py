"""The primitive-equation spectral dynamical core (T30L8 by default).

A batched-array re-design of the reference's dynamics layer
(/root/reference/src/dyn_step.f90, dyn_grtend.f90, dyn_sptend.f90,
dyn_implic.f90, dyn_geop.f90, ini_indyns.f90, ini_impint.f90):
everything is a pure function of an immutable `SpectralState`; all
per-level Fortran loops become batched array ops over a leading level
axis; the semi-implicit per-wavenumber 8x8 solves become one gathered
einsum over the whole (m, n) plane.

Physics plugs in through a callable taking the grid-space state at the
physics time level and returning grid-space (du, dv, dT, dtr) tendencies.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.core.constants import (GAMMA_LAPSE, HSCALE, HSHUM, TDRS,
                                          THD, THDD, THDS, PhysicalConstants)
from speedy_ml_tpu.core.geometry import Geometry
from speedy_ml_tpu.core.spectral import SpectralTransform
from speedy_ml_tpu.dycore.state import SpectralState


class ImplicitCoeffs(NamedTuple):
    """Semi-implicit gravity-wave + implicit-diffusion coefficients for one dt.

    Built by `build_implicit` (reference: ini_impint.f90).
    """
    tref: jnp.ndarray     # (K,)
    tref1: jnp.ndarray    # (K,) rgas*tref
    tref2: jnp.ndarray    # (K,) akap*tref
    tref3: jnp.ndarray    # (K,) fsgr*tref
    xc: jnp.ndarray       # (K, K)  (already scaled by xi)
    xd: jnp.ndarray       # (K, K)
    xj_g: jnp.ndarray     # (M, N, K, K) gathered per-(m,n) inverse; zero row for l=0
    dhsx: jnp.ndarray     # (K,) xi*dhs
    elz: jnp.ndarray      # (M, N) l(l+1)*xi/a^2
    dmp1: jnp.ndarray     # (M, N) 1/(1+dmp*dt)
    dmp1d: jnp.ndarray
    dmp1s: jnp.ndarray


class GridTendencies(NamedTuple):
    """Grid-space physics tendencies (added to the dynamics tendencies)."""
    u: jnp.ndarray        # (K, lat, lon)
    v: jnp.ndarray
    t: jnp.ndarray
    tr: jnp.ndarray       # (R, K, lat, lon)


# physics callback: (state, j_phys, model, forcing) -> GridTendencies
PhysicsFn = Callable[..., GridTendencies]


class DycoreModel:
    """Holds static tables and provides the pure step functions."""

    def __init__(self, geom: Geometry = Geometry(),
                 constants: PhysicalConstants = PhysicalConstants(),
                 dtype=jnp.float32,
                 nsteps_day: int = 96,
                 alph: float = 0.5,
                 rob: float = 0.05,
                 wil: float = 0.53,
                 zonal: str = "fft",
                 cgrate_on: bool = False):
        # cgrate_on: eddy-kinetic-energy growth-rate limiter (cgrate,
        # dyn_step.f90:192-276).  The reference defines it but never
        # calls it, so it stays off by default.
        self.geom = geom
        self.const = constants
        self.cgrate_on = cgrate_on
        self.dtype = jnp.dtype(dtype)
        self.sht = SpectralTransform(geom, radius=constants.rearth, dtype=dtype,
                                     zonal=zonal)
        self.cdtype = self.sht.cdtype
        self.nsteps_day = nsteps_day
        self.delt = 86400.0 / nsteps_day
        self.delt2 = 2.0 * self.delt
        self.alph = alph
        self.rob = rob
        self.wil = wil

        c = constants
        f = lambda x: np.asarray(x, dtype=self.dtype)

        # vertical tables (ini_indyns.f90:50-64)
        self.dhs = f(geom.dhs)
        self.fsg = f(geom.full_sigma)
        self.hsg = f(geom.half_sigma)
        self.dhsr = f(geom.dhsr)
        self.fsgr = f(geom.fsgr(c.akap))

        # latitude tables (south -> north)
        self.coriol = f(2.0 * c.omega * geom.sin_lat)

        # geopotential coefficients (ini_indyns.f90:89-92)
        hsg, fsgn = geom.half_sigma, geom.full_sigma
        xgeop1 = c.rgas * np.log(hsg[1:] / fsgn)
        xgeop2 = np.zeros(geom.nlev)
        xgeop2[1:] = c.rgas * np.log(fsgn[1:] / hsg[1:-1])
        self.xgeop1, self.xgeop2 = f(xgeop1), f(xgeop2)
        # zonal-mean lapse-rate correction factors (dyn_geop.f90:29-32)
        corf = np.zeros(geom.nlev)
        for k in range(1, geom.nlev - 1):
            corf[k] = xgeop1[k] * 0.5 * np.log(hsg[k + 1] / fsgn[k]) \
                / np.log(fsgn[k + 1] / fsgn[k - 1])
        self.geop_corf = f(corf)

        # horizontal diffusion damping tables (ini_indyns.f90:96-112)
        npowhd = 4
        hdiff, hdifd, hdifs = 1 / (THD * 3600), 1 / (THDD * 3600), 1 / (THDS * 3600)
        rlap = 1.0 / (geom.trunc * (geom.trunc + 1))
        twn = np.add.outer(np.arange(geom.mx), np.arange(geom.nx)).astype(np.float64)
        elap = twn * (twn + 1.0) * rlap
        self.dmp = f(hdiff * elap**npowhd)
        self.dmpd = f(hdifd * elap**npowhd)
        self.dmps = f(hdifs * elap)
        self.sdrag = 1.0 / (TDRS * 3600.0)

        # orographic T/q vertical correction profiles (ini_indyns.f90:114-127)
        rgam = c.rgas * GAMMA_LAPSE / (1000.0 * c.grav)
        qexp = HSCALE / HSHUM
        tcorv = np.zeros(geom.nlev)
        qcorv = np.zeros(geom.nlev)
        tcorv[1:] = fsgn[1:] ** rgam
        qcorv[2:] = fsgn[2:] ** qexp
        self.tcorv, self.qcorv = f(tcorv), f(qcorv)
        self._rgam = rgam

        # semi-implicit coefficient sets for the three step lengths used
        # by stepone + the main loop (ini_stepone.f90)
        self.imp_half = self.build_implicit(0.5 * self.delt, alph)
        self.imp_full = self.build_implicit(self.delt, alph)
        self.imp_double = self.build_implicit(self.delt2, alph)

    # ------------------------------------------------------------------
    # table builders
    # ------------------------------------------------------------------

    def build_implicit(self, dt: float, alph: float) -> ImplicitCoeffs:
        """Semi-implicit matrices for step length dt (ini_impint.f90)."""
        g, c = self.geom, self.const
        kx = g.nlev
        a = c.rearth
        hsg = np.asarray(g.half_sigma, dtype=np.float64)
        dhs = np.asarray(g.dhs, dtype=np.float64)
        fsg = np.asarray(g.full_sigma, dtype=np.float64)
        fsgr = np.asarray(g.fsgr(c.akap), dtype=np.float64)

        # implicit-diffusion factors
        dmp = np.asarray(self.dmp, dtype=np.float64)
        dmpd = np.asarray(self.dmpd, dtype=np.float64)
        dmps = np.asarray(self.dmps, dtype=np.float64)
        dmp1 = 1.0 / (1.0 + dmp * dt)
        dmp1d = 1.0 / (1.0 + dmpd * dt)
        dmp1s = 1.0 / (1.0 + dmps * dt)

        rgam = c.rgas * GAMMA_LAPSE / (1000.0 * c.grav)
        tref = 288.0 * np.maximum(0.2, fsg) ** rgam
        tref1 = c.rgas * tref
        tref2 = c.akap * tref
        tref3 = fsgr * tref

        xi = dt * alph
        xxi = xi / (a * a)
        dhsx = xi * dhs

        ll = np.add.outer(np.arange(g.mx), np.arange(g.nx)).astype(np.float64)
        elz = ll * (ll + 1.0) * xxi

        ya = -c.akap * np.outer(tref, dhs)                       # (k, k1)
        xa = np.zeros((kx, kx))
        for k in range(1, kx):
            xa[k, k - 1] = 0.5 * (c.akap * tref[k] / fsg[k]
                                  - (tref[k] - tref[k - 1]) / dhs[k])
        for k in range(kx - 1):
            xa[k, k] = 0.5 * (c.akap * tref[k] / fsg[k]
                              - (tref[k + 1] - tref[k]) / dhs[k])

        dsum = np.cumsum(dhs)
        xb = np.zeros((kx, kx))
        for k in range(kx - 1):
            for k1 in range(kx):
                xb[k, k1] = dhs[k1] * dsum[k]
                if k1 <= k:
                    xb[k, k1] -= dhs[k1]

        xc = ya + xa[:, : kx - 1] @ xb[: kx - 1, :]

        xd = np.zeros((kx, kx))
        for k in range(kx):
            for k1 in range(k + 1, kx):
                xd[k, k1] = c.rgas * np.log(hsg[k1 + 1] / hsg[k1])
            xd[k, k] = c.rgas * np.log(hsg[k + 1] / fsg[k])

        xe = xd @ xc

        lmax = g.lmax
        ell_vals = np.arange(1, lmax + 1, dtype=np.float64)
        xxx = ell_vals * (ell_vals + 1.0) / (a * a)              # (lmax,)
        xf = (xi * xi) * xxx[:, None, None] * (
            c.rgas * np.outer(tref, dhs)[None] - xe[None])
        xf += np.eye(kx)[None]
        xj = np.linalg.inv(xf)                                   # (lmax, k, k)

        # gather xj to the (m, n) plane by total wavenumber; zero for l=0
        ll_int = np.add.outer(np.arange(g.mx), np.arange(g.nx))
        xj_g = np.zeros((g.mx, g.nx, kx, kx))
        pos = ll_int > 0
        xj_g[pos] = xj[np.clip(ll_int[pos], 1, lmax) - 1]

        xc_scaled = xc * xi

        f = lambda x: np.asarray(x, dtype=self.dtype)
        return ImplicitCoeffs(
            tref=f(tref), tref1=f(tref1), tref2=f(tref2), tref3=f(tref3),
            xc=f(xc_scaled), xd=f(xd), xj_g=f(xj_g), dhsx=f(dhsx),
            elz=f(elz), dmp1=f(dmp1), dmp1d=f(dmp1d), dmp1s=f(dmp1s))

    # ------------------------------------------------------------------
    # diagnostic pieces
    # ------------------------------------------------------------------

    def geopotential(self, t_spec: jnp.ndarray, phis: jnp.ndarray,
                     ) -> jnp.ndarray:
        """Hydrostatic integration in spectral space (dyn_geop.f90).

        t_spec: (K, M, N); phis: (M, N). Returns phi: (K, M, N).
        """
        kx = self.geom.nlev
        phis_b = phis[None]
        # bottom-up integration: phi[k] = phis + xgeop1[kx-1] t[kx-1]
        #                                 + sum_{j>k} (xgeop2[j] + xgeop1 terms)
        layers = [phis_b[0] + self.xgeop1[kx - 1] * t_spec[kx - 1]]
        for k in range(kx - 2, -1, -1):
            layers.append(layers[-1] + self.xgeop2[k + 1] * t_spec[k + 1]
                          + self.xgeop1[k] * t_spec[k])
        phi = jnp.stack(layers[::-1], axis=0)
        # zonal-mean lapse-rate correction (m=0 coefficients only)
        tm0 = t_spec[:, 0, :]
        corr = self.geop_corf[1:kx - 1, None] * (tm0[2:kx] - tm0[0:kx - 2])
        phi = phi.at[1:kx - 1, 0, :].add(corr)
        return phi

    # ------------------------------------------------------------------
    # tendency computation
    # ------------------------------------------------------------------

    def grid_tendencies(self, state: SpectralState, j2: int,
                        imp: ImplicitCoeffs):
        """Nonlinear grid-point dynamics tendencies (dyn_grtend.f90, dynamics part).

        Returns spectral (vordt, divdt, tdt, psdt, trdt) before sptend, plus
        the grid-space diagnostic fields needed by physics.
        """
        sht, g, c = self.sht, self.geom, self.const
        vor_s, div_s, t_s, ps_s, tr_s = state.at_level(j2)
        K, R = g.nlev, g.ntracers

        # ONE batched inverse transform for every needed field: stacking
        # [vor, div, t, tracers, ucos, vcos, d(ps)/dx, d(ps)/dy] keeps the
        # small T30 matrices busy in a single set of einsums instead
        # of 8 separate kernel launches.
        ucosm, vcosm = sht.uvspec(vor_s, div_s)
        pxs, pys = sht.grad(ps_s)
        stacked = jnp.concatenate([
            vor_s, div_s, t_s, tr_s.reshape(R * K, g.mx, g.nx),
            ucosm, vcosm, pxs[None], pys[None]], axis=0)
        gall = sht.spec_to_grid(stacked)
        cosf = self.sht.cosgr[:, None]
        vorg = gall[0:K]
        divg = gall[K:2 * K]
        tg = gall[2 * K:3 * K]
        trg = gall[3 * K:(3 + R) * K].reshape(R, K, g.nlat, g.nlon)
        o = (3 + R) * K
        ug = gall[o:o + K] * cosf          # kcos=2 fields: scale by 1/cos
        vg = gall[o + K:o + 2 * K] * cosf
        px = gall[o + 2 * K] * cosf
        py = gall[o + 2 * K + 1] * cosf

        vorg_abs = vorg + self.coriol[:, None]

        dhs_c = self.dhs[:, None, None]
        umean = jnp.sum(ug * dhs_c, axis=0)
        vmean = jnp.sum(vg * dhs_c, axis=0)
        dmean = jnp.sum(divg * dhs_c, axis=0)

        # log-ps tendency
        psdt = sht.grid_to_spec(-umean * px - vmean * py)
        psdt = psdt.at[0, 0].set(0.0)

        # vertical sigma velocity (half levels 0..K)
        puv = (ug - umean) * px + (vg - vmean) * py
        incr_s = -dhs_c * (puv + divg - dmean)
        incr_m = -dhs_c * puv
        zeros1 = jnp.zeros_like(incr_s[:1])
        sigdt = jnp.concatenate([zeros1, jnp.cumsum(incr_s, axis=0)], axis=0)
        sigm = jnp.concatenate([zeros1, jnp.cumsum(incr_m, axis=0)], axis=0)

        tref = imp.tref[:, None, None]
        tgg = tg - tref
        rpx = c.rgas * px
        rpy = c.rgas * py

        def half_flux(f):
            """temp[j] = sigdt[j]*(f[j]-f[j-1]) on interior half levels."""
            interior = sigdt[1:g.nlev] * (f[1:] - f[:-1])
            return jnp.concatenate([zeros1, interior, zeros1], axis=0)

        tku = half_flux(ug)
        utend = vg * vorg_abs - tgg * rpx \
            - (tku[1:] + tku[:-1]) * self.dhsr[:, None, None]

        tkv = half_flux(vg)
        vtend = -ug * vorg_abs - tgg * rpy \
            - (tkv[1:] + tkv[:-1]) * self.dhsr[:, None, None]

        dtref = tref[1:] - tref[:-1]
        tkt_int = sigdt[1:g.nlev] * (tgg[1:] - tgg[:-1]) + sigm[1:g.nlev] * dtref
        tkt = jnp.concatenate([zeros1, tkt_int, zeros1], axis=0)
        ttend = (tgg * divg
                 - (tkt[1:] + tkt[:-1]) * self.dhsr[:, None, None]
                 + self.fsgr[:, None, None] * tgg * (sigdt[1:] + sigdt[:-1])
                 + imp.tref3[:, None, None] * (sigm[1:] + sigm[:-1])
                 + c.akap * (tg * puv - tgg * dmean))

        # tracer tendencies; vertical advection disabled in top 3 layers
        # for moisture (dyn_grtend.f90:196-207)
        def tracer_tend(q):
            tk_int = sigdt[1:g.nlev] * (q[1:] - q[:-1])
            tk_int = tk_int.at[:2].set(0.0)
            tk = jnp.concatenate([zeros1, tk_int, zeros1], axis=0)
            return q * divg - (tk[1:] + tk[:-1]) * self.dhsr[:, None, None]

        trtend = jax.vmap(tracer_tend)(trg)

        grid_fields = dict(ug=ug, vg=vg, tg=tg, tgg=tgg, trg=trg,
                           vorg=vorg, divg=divg, puv=puv, sigdt=sigdt,
                           umean=umean, vmean=vmean, dmean=dmean,
                           px=px, py=py)
        return (utend, vtend, ttend, trtend, psdt), grid_fields

    def to_spectral_tendencies(self, utend, vtend, ttend, trtend,
                               grid_fields) -> tuple:
        """Convert grid tendencies to spectral (dyn_grtend.f90:233-278).

        All forward transforms are fused: one vdspec over the stacked
        (u,v)-pairs [momentum; T-advection; tracer advection] and one
        grid_to_spec over [KE; ttend; trtend]."""
        sht = self.sht
        g = self.geom
        K, R = g.nlev, g.ntracers
        ug, vg = grid_fields["ug"], grid_fields["vg"]
        tgg, trg = grid_fields["tgg"], grid_fields["trg"]

        u_stack = jnp.concatenate(
            [utend, -ug * tgg, (-ug[None] * trg).reshape(R * K, *ug.shape[1:])],
            axis=0)
        v_stack = jnp.concatenate(
            [vtend, -vg * tgg, (-vg[None] * trg).reshape(R * K, *vg.shape[1:])],
            axis=0)
        vor_all, div_all = sht.vdspec(u_stack, v_stack, kcos=2)
        vordt = vor_all[:K]
        divdt = div_all[:K]
        tdt_adv = div_all[K:2 * K]
        trdt_adv = div_all[2 * K:].reshape(R, K, g.mx, g.nx)

        ke = 0.5 * (ug * ug + vg * vg)
        s_stack = jnp.concatenate(
            [ke, ttend, trtend.reshape(R * K, *ke.shape[1:])], axis=0)
        spec_all = sht.grid_to_spec(s_stack)
        divdt = divdt - sht.lap(spec_all[:K])
        tdt = tdt_adv + spec_all[K:2 * K]
        trdt = trdt_adv + spec_all[2 * K:].reshape(R, K, g.mx, g.nx)
        return vordt, divdt, tdt, trdt

    def sptend(self, state: SpectralState, j4: int, imp: ImplicitCoeffs,
               phis: jnp.ndarray, divdt, tdt, psdt):
        """Linear (reference-profile) spectral tendencies (dyn_sptend.f90)."""
        g, c = self.geom, self.const
        div_s = state.div[j4]
        t_s = state.t[j4]
        ps_s = state.ps[j4]

        dhs_c = self.dhs[:, None, None].astype(self.dtype)
        dmeanc = jnp.sum(div_s * dhs_c, axis=0)
        psdt = psdt - dmeanc
        psdt = psdt.at[0, 0].set(0.0)

        # sigma-dot on half levels: loop runs only to kx-1 so the bottom
        # half-level stays exactly zero (dyn_sptend.f90:42-44)
        incr = -dhs_c[:-1] * (div_s[:-1] - dmeanc)
        zeros1 = jnp.zeros_like(div_s[:1])
        sigdtc = jnp.concatenate(
            [zeros1, jnp.cumsum(incr, axis=0), zeros1], axis=0)

        dtref = (imp.tref[1:] - imp.tref[:-1])[:, None, None]
        dumk_int = sigdtc[1:g.nlev] * dtref
        dumk = jnp.concatenate([zeros1, dumk_int, zeros1], axis=0)

        tdt = tdt - (dumk[1:] + dumk[:-1]) * self.dhsr[:, None, None] \
            + imp.tref3[:, None, None] * (sigdtc[1:] + sigdtc[:-1]) \
            - imp.tref2[:, None, None] * dmeanc

        phi = self.geopotential(t_s, phis)
        gp = phi + c.rgas * imp.tref[:, None, None] * ps_s[None]
        divdt = divdt - self.sht.lap(gp)
        return divdt, tdt, psdt

    def implicit_correction(self, imp: ImplicitCoeffs, divdt, tdt, psdt):
        """Semi-implicit gravity-wave correction (dyn_implic.f90)."""
        # ye[k] = sum_k1 xd[k,k1] tdt[k1] + tref1[k] psdt
        # full f32 precision: reduced-precision matmul passes
        # destabilize the long integration (see core/spectral._PREC)
        import jax
        prec = jax.lax.Precision.HIGHEST
        ye = jnp.einsum("kl,lmn->kmn", imp.xd.astype(self.dtype), tdt,
                        precision=prec) \
            + imp.tref1[:, None, None] * psdt[None]
        yf = divdt + imp.elz[None] * ye
        # divdt[m,n,:] = xj[l(m,n)] @ yf[m,n,:]  (zero for l=0)
        divdt_new = jnp.einsum("mnkl,lmn->kmn", imp.xj_g.astype(self.dtype),
                               yf, precision=prec)
        psdt = psdt - jnp.sum(divdt_new * imp.dhsx[:, None, None], axis=0)
        tdt = tdt + jnp.einsum("kl,lmn->kmn", imp.xc.astype(self.dtype),
                               divdt_new, precision=prec)
        return divdt_new, tdt, psdt

    # ------------------------------------------------------------------
    # diffusion + time integration
    # ------------------------------------------------------------------

    @staticmethod
    def _hordif(field, fdt, dmp, dmp1):
        return (fdt - dmp * field) * dmp1

    def _timint(self, field, fdt, j1: int, dt: float, eps: float):
        """Leapfrog + Robert-Asselin-Williams filter (dyn_step.f90:153-190)."""
        if self.geom.nlon == 4 * self.geom.nlat_half:
            fdt = self.sht.trunct(fdt)
        old1 = field[0]
        oldj = field[j1 - 1]
        fnew = old1 + dt * fdt
        wil = self.wil
        new1 = oldj + wil * eps * (old1 - 2.0 * oldj + fnew)
        new2 = fnew - (1.0 - wil) * eps * (new1 - 2.0 * oldj + fnew)
        return jnp.stack([new1, new2], axis=0)

    # ------------------------------------------------------------------
    # the full step
    # ------------------------------------------------------------------

    def step(self, state: SpectralState, phis: jnp.ndarray,
             j1: int, j2: int, dt: float, imp: ImplicitCoeffs,
             physics_fn: Optional[PhysicsFn] = None,
             physics_args: tuple = (),
             corrections: Optional[tuple] = None):
        """One time step (dyn_step.f90):

        Fnew = F(0) + dt * [T_dyn(F(j2-1)) + T_phy(F(0))], then RAW filter.
        j1, j2 use the Fortran 1-based convention: (1,1) forward,
        (1,2) initial leapfrog, (2,2) filtered leapfrog.

        physics_fn(state, j_phys, model, *physics_args) may return either a
        GridTendencies or (GridTendencies, aux); `aux` (e.g. the radiation
        carry + flux diagnostics) is threaded back to the caller.
        corrections = (tcorh, qcorh): spectral orographic diffusion
        correction fields from the daily forcing.

        Returns (new_state, aux); aux is None for the dry core.
        """
        g = self.geom

        (utend, vtend, ttend, trtend, psdt), gf = \
            self.grid_tendencies(state, j2 - 1, imp)

        aux = None
        if physics_fn is not None:
            # physics ALWAYS evaluates at time level 1 (index 0), the
            # Robert-filtered center — the reference hardwires
            # grtend(..., J1=1, j2) for every step (dyn_step.f90:45).
            # Evaluating at the new leapfrog level instead couples the
            # dissipative physics to the computational mode: a 2*dt
            # vertical zig-zag grows at convective columns and blows up
            # T30 integrations after ~20-110 simulated days.
            out = physics_fn(state, 0, self, *physics_args)
            if isinstance(out, tuple) and not isinstance(out, GridTendencies):
                ptend, aux = out
            else:
                ptend = out
            utend = utend + ptend.u
            vtend = vtend + ptend.v
            ttend = ttend + ptend.t
            trtend = trtend + ptend.tr

        vordt, divdt, tdt, trdt = self.to_spectral_tendencies(
            utend, vtend, ttend, trtend, gf)

        # linear tendencies + semi-implicit correction (alph=0.5 path)
        if self.alph == 0.0:
            divdt, tdt, psdt = self.sptend(state, j2 - 1, imp, phis,
                                           divdt, tdt, psdt)
        else:
            divdt, tdt, psdt = self.sptend(state, 0, imp, phis,
                                           divdt, tdt, psdt)
            divdt, tdt, psdt = self.implicit_correction(imp, divdt, tdt, psdt)

        # horizontal diffusion (dyn_step.f90:60-106)
        tcorh, qcorh = corrections if corrections is not None else (None, None)
        dmp = self.dmp[None]
        dmpd = self.dmpd[None]
        vordt = self._hordif(state.vor[0], vordt, dmp, imp.dmp1[None])
        divdt = self._hordif(state.div[0], divdt, dmpd, imp.dmp1d[None])

        ctmp = state.t[0] + (tcorh[None] * self.tcorv[:, None, None]
                             if tcorh is not None else 0.0)
        tdt = self._hordif(ctmp, tdt, dmp, imp.dmp1[None])

        # stratospheric drag on the zonal-mean top-level flow
        vordt = vordt.at[0, 0, :].add(-self.sdrag * state.vor[0, 0, 0, :])
        divdt = divdt.at[0, 0, :].add(-self.sdrag * state.div[0, 0, 0, :])

        # extra stratospheric del^2 diffusion, top level only
        vordt = vordt.at[0].set(self._hordif(state.vor[0, 0], vordt[0],
                                             self.dmps, imp.dmp1s))
        divdt = divdt.at[0].set(self._hordif(state.div[0, 0], divdt[0],
                                             self.dmps, imp.dmp1s))
        tdt = tdt.at[0].set(self._hordif(ctmp[0], tdt[0],
                                         self.dmps, imp.dmp1s))

        if self.cgrate_on:
            vordt, divdt = self._cgrate(state.vor[0], state.div[0],
                                        vordt, divdt)

        qtmp = state.tr[0, 0] + (qcorh[None] * self.qcorv[:, None, None]
                                 if qcorh is not None else 0.0)
        trdt = trdt.at[0].set(self._hordif(qtmp, trdt[0], dmpd[0],
                                           imp.dmp1d))
        for itr in range(1, g.ntracers):
            trdt = trdt.at[itr].set(self._hordif(state.tr[0, itr], trdt[itr],
                                                 dmp[0], imp.dmp1[0]))

        if dt <= 0.0:
            return state, aux

        eps = 0.0 if j1 == 1 else self.rob
        new_state = SpectralState(
            ps=self._timint(state.ps, psdt, j1, dt, eps),
            vor=self._timint(state.vor, vordt, j1, dt, eps),
            div=self._timint(state.div, divdt, j1, dt, eps),
            t=self._timint(state.t, tdt, j1, dt, eps),
            tr=self._timint(state.tr, trdt, j1, dt, eps),
        )
        return new_state, aux

    def _cgrate(self, vor, div, vordt, divdt):
        """Eddy-kinetic-energy growth-rate limiter (cgrate,
        dyn_step.f90:192-276): per field, the eddy (m>0) KE growth rate
        grate = -sum Re(fdt conj(invlap f)) is compared per level
        (k >= 2, 1-based) against grmax * rnorm with rnorm =
        -sum Re(f conj(invlap f)) >= 0; on trigger, all eddy
        coefficients of the tendency are damped by 0.8*grate/rnorm."""
        grmax = 0.2 / (86400.0 * 2.0)
        mmask = (jnp.arange(vor.shape[1]) > 0)[None, :, None]

        def damp(f, fdt):
            temp = self.sht.invlap(f)
            pr = lambda a: -jnp.sum(jnp.real(a * jnp.conj(temp)) * mmask,
                                    axis=(1, 2))
            grate, rnorm = pr(fdt), pr(f)
            lev_sel = jnp.arange(f.shape[0]) >= 1       # k=2..kx (1-based)
            trig = (grate > grmax * rnorm) & lev_sel & (rnorm > 0.0)
            cd = jnp.max(jnp.where(trig, 0.8 * grate
                                   / jnp.where(rnorm > 0, rnorm, 1.0), 0.0))
            return fdt - cd * f * mmask
        return damp(vor, vordt), damp(div, divdt)

    def stepone(self, state: SpectralState, phis: jnp.ndarray,
                physics_fn: Optional[PhysicsFn] = None,
                physics_args: tuple = (),
                corrections: Optional[tuple] = None):
        """Cold-start double half-step (ini_stepone.f90)."""
        state, aux = self.step(state, phis, 1, 1, 0.5 * self.delt,
                               self.imp_half, physics_fn, physics_args,
                               corrections)
        state, aux = self.step(state, phis, 1, 2, self.delt, self.imp_full,
                               physics_fn, physics_args, corrections)
        return state, aux

    def leapfrog_step(self, state: SpectralState, phis: jnp.ndarray,
                      physics_fn: Optional[PhysicsFn] = None,
                      physics_args: tuple = (),
                      corrections: Optional[tuple] = None):
        """The main-loop filtered leapfrog step (dyn_stloop.f90:43)."""
        return self.step(state, phis, 2, 2, self.delt2, self.imp_double,
                         physics_fn, physics_args, corrections)
