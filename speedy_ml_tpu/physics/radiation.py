"""Radiation: solar forcing, clouds, 2-band SW, 4-band LW.

Reference: phy_radiat.f90 (sol_oz/solar/cloud/radsw/radlw/radset).
All flux recursions are short static loops over K=8 levels and <=4 bands;
XLA fuses them into a handful of elementwise kernels over (lat, lon).

Longwave band fractions use the reference's integer-temperature lookup
table (fband), implemented as a gather.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.physics import constants as pc


def build_fband() -> np.ndarray:
    """LW band energy fractions vs temperature (radset, phy_radiat.f90:659-692).

    Returns (301, 4) table indexed by round(T)-100 clipped to [100, 400].
    """
    fband = np.zeros((401, 4))
    eps1 = 1.0 - pc.EPSLW
    for jtemp in range(200, 321):
        fband[jtemp, 1] = (0.148 - 3.0e-6 * (jtemp - 247) ** 2) * eps1
        fband[jtemp, 2] = (0.356 - 5.2e-6 * (jtemp - 282) ** 2) * eps1
        fband[jtemp, 3] = (0.314 + 1.0e-5 * (jtemp - 315) ** 2) * eps1
        fband[jtemp, 0] = eps1 - fband[jtemp, 1:4].sum()
    fband[100:200] = fband[200]
    fband[321:401] = fband[320]
    return fband[100:401]


def _fband_lookup(fband_tab, ta: jnp.ndarray, jb: int) -> jnp.ndarray:
    """LW band fraction at round(T).

    The reference tabulates piecewise quadratics over integer T
    (radset, phy_radiat.f90:677-691); evaluating the quadratics at
    round(T) reproduces the table EXACTLY without a gather: the lookup
    fuses into the surrounding elementwise physics (per-step hot path,
    ~70 lookups x 4608 points per radlw call)."""
    tc = jnp.clip(jnp.round(ta), 200.0, 320.0)   # constant outside [200,320]
    eps1 = 1.0 - pc.EPSLW
    f2 = (0.148 - 3.0e-6 * (tc - 247.0) ** 2) * eps1
    if jb == 1:
        return f2
    f3 = (0.356 - 5.2e-6 * (tc - 282.0) ** 2) * eps1
    if jb == 2:
        return f3
    f4 = (0.314 + 1.0e-5 * (tc - 315.0) ** 2) * eps1
    if jb == 3:
        return f4
    return eps1 - (f2 + f3 + f4)


class SolarForcing(NamedTuple):
    """Zonally uniform daily radiative forcing (sol_oz)."""
    fsol: jnp.ndarray     # (lat, lon) TOA insolation
    ozupp: jnp.ndarray
    ozone: jnp.ndarray
    zenit: jnp.ndarray
    stratz: jnp.ndarray


def solar_flux(tyear: float, csol: float, slat: np.ndarray, clat: np.ndarray
               ) -> np.ndarray:
    """Daily-mean TOA insolation, Hartmann (1994) (phy_radiat.f90:77-121)."""
    pigr = np.pi
    alpha = 2.0 * pigr * tyear
    ca1, sa1 = np.cos(alpha), np.sin(alpha)
    ca2, sa2 = ca1 * ca1 - sa1 * sa1, 2 * sa1 * ca1
    ca3, sa3 = ca1 * ca2 - sa1 * sa2, sa1 * ca2 + sa2 * ca1
    decl = (0.006918 - 0.399912 * ca1 + 0.070257 * sa1 - 0.006758 * ca2
            + 0.000907 * sa2 - 0.002697 * ca3 + 0.001480 * sa3)
    fdis = 1.000110 + 0.034221 * ca1 + 0.001280 * sa1 + 0.000719 * ca2 \
        + 0.000077 * sa2
    cdecl, sdecl = np.cos(decl), np.sin(decl)
    tdecl = sdecl / cdecl
    csolp = csol / pigr
    ch0 = np.clip(-tdecl * slat / clat, -1.0, 1.0)
    h0 = np.arccos(ch0)
    sh0 = np.sin(h0)
    return csolp * fdis * (h0 * slat * sdecl + sh0 * clat * cdecl)


def sol_oz(tyear: float, slat: np.ndarray, clat: np.ndarray, nlon: int
           ) -> SolarForcing:
    """Zonal solar/ozone forcing for one date (phy_radiat.f90:1-75).

    tyear is a Python float (host-side daily update, like fordate)."""
    alpha = 2.0 * np.pi * (tyear + 10.0 / 365.0)
    coz1 = max(0.0, np.cos(alpha))
    coz2 = 1.8
    azen, nzen = 1.0, 2
    rzen = -np.cos(alpha) * 23.45 * np.pi / 180.0
    czen, szen = np.cos(rzen), np.sin(rzen)
    fs0 = 6.0

    topsr = solar_flux(tyear, 4.0 * pc.SOLC, slat, clat)
    flat2 = 1.5 * slat**2 - 0.5
    fsol = topsr
    ozupp = 0.5 * pc.EPSSW
    ozone = 0.4 * pc.EPSSW * (1.0 + coz1 * slat + coz2 * flat2)
    zenit = 1.0 + azen * (1.0 - (clat * czen + slat * szen)) ** nzen
    ozupp = fsol * ozupp * zenit
    ozone = fsol * ozone * zenit
    stratz = np.maximum(fs0 - fsol, 0.0)

    tile = lambda z: jnp.asarray(np.broadcast_to(z[:, None], (len(slat), nlon)))
    return SolarForcing(fsol=tile(fsol), ozupp=tile(ozupp), ozone=tile(ozone),
                        zenit=tile(zenit), stratz=tile(stratz))


def solar_flux_traced(tyear, csol: float, slat: jnp.ndarray,
                      clat: jnp.ndarray) -> jnp.ndarray:
    """jnp version of solar_flux with traced tyear (for in-jit forcing)."""
    pigr = jnp.pi
    alpha = 2.0 * pigr * tyear
    ca1, sa1 = jnp.cos(alpha), jnp.sin(alpha)
    ca2, sa2 = ca1 * ca1 - sa1 * sa1, 2 * sa1 * ca1
    ca3, sa3 = ca1 * ca2 - sa1 * sa2, sa1 * ca2 + sa2 * ca1
    decl = (0.006918 - 0.399912 * ca1 + 0.070257 * sa1 - 0.006758 * ca2
            + 0.000907 * sa2 - 0.002697 * ca3 + 0.001480 * sa3)
    fdis = 1.000110 + 0.034221 * ca1 + 0.001280 * sa1 + 0.000719 * ca2 \
        + 0.000077 * sa2
    cdecl, sdecl = jnp.cos(decl), jnp.sin(decl)
    tdecl = sdecl / cdecl
    csolp = csol / pigr
    ch0 = jnp.clip(-tdecl * slat / clat, -1.0, 1.0)
    h0 = jnp.arccos(ch0)
    sh0 = jnp.sin(h0)
    return csolp * fdis * (h0 * slat * sdecl + sh0 * clat * cdecl)


def sol_oz_traced(tyear, slat: jnp.ndarray, clat: jnp.ndarray, nlon: int
                  ) -> SolarForcing:
    """jnp version of sol_oz: tyear may be a traced scalar."""
    alpha = 2.0 * jnp.pi * (tyear + 10.0 / 365.0)
    coz1 = jnp.maximum(0.0, jnp.cos(alpha))
    coz2 = 1.8
    azen, nzen = 1.0, 2
    rzen = -jnp.cos(alpha) * 23.45 * jnp.pi / 180.0
    czen, szen = jnp.cos(rzen), jnp.sin(rzen)
    fs0 = 6.0

    topsr = solar_flux_traced(tyear, 4.0 * pc.SOLC, slat, clat)
    flat2 = 1.5 * slat**2 - 0.5
    fsol = topsr
    ozupp = 0.5 * pc.EPSSW
    ozone = 0.4 * pc.EPSSW * (1.0 + coz1 * slat + coz2 * flat2)
    zenit = 1.0 + azen * (1.0 - (clat * czen + slat * szen)) ** nzen
    ozupp = fsol * ozupp * zenit
    ozone = fsol * ozone * zenit
    stratz = jnp.maximum(fs0 - fsol, 0.0)

    tile = lambda z: jnp.broadcast_to(z[:, None], (slat.shape[0], nlon))
    return SolarForcing(fsol=tile(fsol), ozupp=tile(ozupp), ozone=tile(ozone),
                        zenit=tile(zenit), stratz=tile(stratz))


def cloud(qa, rh, precnv, precls, iptop, gse, fmask):
    """Cloud cover and top (phy_radiat.f90:123-233).

    Returns (icltop, cloudc, clstr, qcloud)."""
    K = qa.shape[0]
    nl1 = K - 1 - 1 + 1  # 1-based nl1=nlev-1 -> 0-based K-2
    nl1 = K - 2
    rrcl = 1.0 / (pc.RHCL2 - pc.RHCL1)

    cloudc = jnp.where(rh[nl1] > pc.RHCL1, rh[nl1] - pc.RHCL1, 0.0)
    icltop = jnp.where(rh[nl1] > pc.RHCL1, nl1, K).astype(jnp.int32)

    # 1-based k = 3..nlev-2  ->  0-based 2..K-3
    for k in range(2, K - 2):
        drh = rh[k] - pc.RHCL1
        better = (drh > cloudc) & (qa[k] > pc.QACL)
        cloudc = jnp.where(better, drh, cloudc)
        icltop = jnp.where(better, k, icltop)

    cl1 = jnp.minimum(1.0, cloudc * rrcl)
    pr1 = jnp.minimum(pc.PMAXCL, 86.4 * (precnv + precls))
    cloudc = jnp.minimum(1.0, pc.WPCL * jnp.sqrt(pr1) + cl1 * cl1)
    icltop = jnp.minimum(iptop, icltop)

    qcloud = qa[nl1]

    # stratiform clouds at PBL top
    clfact = 1.2
    rgse = 1.0 / (pc.GSE_S1 - pc.GSE_S0)
    fstab = jnp.clip(rgse * (gse - pc.GSE_S0), 0.0, 1.0)
    clstr = fstab * jnp.maximum(pc.CLSMAX - clfact * cloudc, 0.0)
    clstrl = jnp.maximum(clstr, pc.CLSMINL) * rh[K - 1]
    clstr = clstr + fmask * (clstrl - clstr)
    return icltop, cloudc, clstr, qcloud


def radsw(psa, qa, icltop, cloudc, clstr, qcloud, sol: SolarForcing,
          albsfc, *, sig, dsig):
    """Shortwave radiation + LW transmissivity setup (phy_radiat.f90:235-435).

    Returns (ssrd, ssr, tsr, dfabs_sw, tau2, stratc): surface downward /
    net SW, top net SW, per-layer absorbed SW flux, the LW transmissivity
    carried to radlw, and the stratospheric correction terms.
    """
    K = qa.shape[0]
    nl1 = K - 2
    fband2 = 0.05
    fband1 = 1.0 - fband2
    lev = jnp.arange(K)[:, None, None]

    # SW cloud reflectivity stored in tau2[...,2] (band-3 slot)
    tau_refl = jnp.where(lev == jnp.clip(icltop, 0, K - 1)[None],
                         jnp.where((icltop <= K - 1)[None], pc.ALBCL * cloudc[None], 0.0),
                         0.0)
    tau_refl = tau_refl.at[K - 1].set(pc.ALBCLS * clstr)

    psaz = psa * sol.zenit
    acloud = cloudc * jnp.minimum(pc.ABSCL1 * qcloud, pc.ABSCL2)

    # SW transmissivity per layer, visible band (tau1) and near-IR (taunir)
    tau1 = []
    taunir = []
    for k in range(K):
        deltap = psaz * dsig[k]
        if k == 0:
            t = jnp.exp(-deltap * pc.ABSDRY)
        else:
            abs1 = pc.ABSDRY + pc.ABSAER * float(sig[k]) ** 2
            if k < K - 1:
                cloudy = k >= icltop
                t = jnp.where(cloudy,
                              jnp.exp(-deltap * (abs1 + pc.ABSWV1 * qa[k] + acloud)),
                              jnp.exp(-deltap * (abs1 + pc.ABSWV1 * qa[k])))
            else:
                t = jnp.exp(-deltap * (abs1 + pc.ABSWV1 * qa[k]))
        tau1.append(t)
        taunir.append(jnp.exp(-deltap * pc.ABSWV2 * qa[k]) if k > 0
                      else jnp.ones_like(psa))

    # downward flux
    ftop = sol.fsol
    flux1 = sol.fsol * fband1
    flux2 = sol.fsol * fband2
    dfabs = [jnp.zeros_like(psa) for _ in range(K)]

    # stratosphere: ozone absorption
    dfabs[0] = flux1
    flux1 = tau1[0] * (flux1 - sol.ozupp * psa)
    dfabs[0] = dfabs[0] - flux1
    dfabs[1] = flux1
    flux1 = tau1[1] * (flux1 - sol.ozone * psa)
    dfabs[1] = dfabs[1] - flux1

    # troposphere: cloud reflection + absorption
    for k in range(2, K):
        refl = flux1 * tau_refl[k]
        flux1 = flux1 - refl
        dfabs[k] = flux1
        flux1 = tau1[k] * flux1
        dfabs[k] = dfabs[k] - flux1
        tau_refl = tau_refl.at[k].set(refl)  # store reflected flux (reused upward)

    for k in range(1, K):
        dfabs[k] = dfabs[k] + flux2
        flux2 = taunir[k] * flux2
        dfabs[k] = dfabs[k] - flux2

    # surface
    ssrd = flux1 + flux2
    flux1 = flux1 * albsfc
    ssr = ssrd - flux1

    # upward absorption and cloud re-reflection
    for k in range(K - 1, -1, -1):
        dfabs[k] = dfabs[k] + flux1
        flux1 = tau1[k] * flux1
        dfabs[k] = dfabs[k] - flux1
        flux1 = flux1 + tau_refl[k]

    tsr = ftop - flux1

    # ---- LW transmissivity (tau2) for radlw ----
    # under jax_enable_x64 the cloud fields promote to f64 while psa stays
    # f32; the scatter target must match the value dtype (the physics
    # driver pins the RadiationCarry dtype back afterwards)
    tau2 = jnp.zeros((K, 4) + psa.shape,
                     dtype=jnp.result_type(psa, qa, cloudc))
    acloud_lw = cloudc * pc.ABLCL2
    for k in range(K):
        # keep the model dtype: dsig is host f64, and an f64 deltap would
        # make the tau2 scatter below an unsafe f64->f32 cast (x64 mode)
        deltap = (psa * dsig[k]).astype(psa.dtype)
        t1 = jnp.exp(-deltap * pc.ABLWIN)
        t2 = jnp.exp(-deltap * pc.ABLCO2)
        if k == 0:
            t3 = jnp.ones_like(psa)
            t4 = jnp.ones_like(psa)
        elif k == 1 or k == K - 1:
            t3 = jnp.exp(-deltap * pc.ABLWV1 * qa[k])
            t4 = jnp.exp(-deltap * pc.ABLWV2 * qa[k])
        else:
            acl1 = jnp.where(k < icltop, acloud_lw, pc.ABLCL1 * cloudc)
            t1 = jnp.exp(-deltap * (pc.ABLWIN + acl1))
            t3 = jnp.exp(-deltap * jnp.maximum(pc.ABLWV1 * qa[k], acloud_lw))
            t4 = jnp.exp(-deltap * jnp.maximum(pc.ABLWV2 * qa[k], acloud_lw))
        tau2 = tau2.at[k, 0].set(t1).at[k, 1].set(t2).at[k, 2].set(t3).at[k, 3].set(t4)

    eps1 = pc.EPSLW / (dsig[0] + dsig[1])
    stratc = jnp.stack([sol.stratz * psa, eps1 * psa])

    return ssrd, ssr, tsr, jnp.stack(dfabs), tau2, stratc


def radlw_down(ta, tau2, fband_tab, *, wvi2, dsig, sbc):
    """Downward LW (radlw imode=-1, phy_radiat.f90:484-584).

    Returns (slrd, dfabs, flux_bands, st4a) to be completed by radlw_up."""
    K = ta.shape[0]
    nl1 = K - 2

    # temperature at layer boundaries
    thalf = [ta[k] + wvi2[k] * (ta[k + 1] - ta[k]) for k in range(K - 1)]

    st4a_mean = [None] * K   # blackbody emission per level
    st4a_grad = [None] * K
    t_strat1 = 0.75 * ta[0] + 0.25 * thalf[0]
    t_strat2 = 0.50 * ta[1] + 0.25 * (thalf[0] + thalf[1])
    anis, anish = 1.0, 0.5

    grads = [jnp.zeros_like(ta[0]), jnp.zeros_like(ta[0])]
    for k in range(2, K - 1):
        grads.append(anish * jnp.maximum(thalf[k] - thalf[k - 1], 0.0))
    grads.append(anis * jnp.maximum(ta[K - 1] - thalf[K - 2], 0.0))

    st4a_mean[0] = sbc * t_strat1**4
    st4a_mean[1] = sbc * t_strat2**4
    st4a_grad[0] = jnp.zeros_like(ta[0])
    st4a_grad[1] = jnp.zeros_like(ta[0])
    for k in range(2, K):
        st3a = sbc * ta[k] ** 3
        st4a_mean[k] = st3a * ta[k]
        st4a_grad[k] = 4.0 * st3a * grads[k]

    slrd = jnp.zeros_like(ta[0])
    dfabs = [jnp.zeros_like(ta[0]) for _ in range(K)]
    flux = [jnp.zeros_like(ta[0]) for _ in range(4)]

    # stratosphere (bands 1-2 at k=0)
    for jb in range(2):
        emis = 1.0 - tau2[0, jb]
        brad = _fband_lookup(fband_tab, ta[0], jb) * (st4a_mean[0] + emis * st4a_grad[0])
        flux[jb] = emis * brad
        dfabs[0] = dfabs[0] - flux[jb]

    # troposphere, all bands
    for jb in range(4):
        for k in range(1, K):
            emis = 1.0 - tau2[k, jb]
            brad = _fband_lookup(fband_tab, ta[k], jb) * (st4a_mean[k] + emis * st4a_grad[k])
            dfabs[k] = dfabs[k] + flux[jb]
            flux[jb] = tau2[k, jb] * flux[jb] + emis * brad
            dfabs[k] = dfabs[k] - flux[jb]

    for jb in range(4):
        slrd = slrd + pc.EMISFC * flux[jb]

    # "black" band correction incl. surface reflection
    eps1 = pc.EPSLW * pc.EMISFC
    corlw = eps1 * st4a_mean[K - 1]
    dfabs[K - 1] = dfabs[K - 1] - corlw
    slrd = slrd + corlw

    st4a = (jnp.stack(st4a_mean), jnp.stack(st4a_grad))
    return slrd, jnp.stack(dfabs), jnp.stack(flux), st4a


def radlw_up(ta, ts, slrd, slru_sfc, dfabs, flux_bands, st4a, tau2, stratc,
             fband_tab, *, dsig, sbc):
    """Upward LW (radlw imode=+1, phy_radiat.f90:600-656).

    slru_sfc: upward sfc emission (esbc*ts^4, from suflux).
    Returns (slr_net, olr, dfabs)."""
    K = ta.shape[0]
    st4a_mean, st4a_grad = st4a
    refsfc = 1.0 - pc.EMISFC

    slr = slru_sfc - slrd
    flux = [ _fband_lookup(fband_tab, ts, jb) * slru_sfc + refsfc * flux_bands[jb]
             for jb in range(4)]

    dfabs = [dfabs[k] for k in range(K)]
    dfabs[K - 1] = dfabs[K - 1] + pc.EPSLW * slru_sfc

    for jb in range(4):
        for k in range(K - 1, 0, -1):
            emis = 1.0 - tau2[k, jb]
            brad = _fband_lookup(fband_tab, ta[k], jb) * (st4a_mean[k] - emis * st4a_grad[k])
            dfabs[k] = dfabs[k] + flux[jb]
            flux[jb] = tau2[k, jb] * flux[jb] + emis * brad
            dfabs[k] = dfabs[k] - flux[jb]

    for jb in range(2):
        emis = 1.0 - tau2[0, jb]
        brad = _fband_lookup(fband_tab, ta[0], jb) * (st4a_mean[0] - emis * st4a_grad[0])
        dfabs[0] = dfabs[0] + flux[jb]
        flux[jb] = tau2[0, jb] * flux[jb] + emis * brad
        dfabs[0] = dfabs[0] - flux[jb]

    corlw1 = dsig[0] * stratc[1] * st4a_mean[0] + stratc[0]
    corlw2 = dsig[1] * stratc[1] * st4a_mean[1]
    dfabs[0] = dfabs[0] - corlw1
    dfabs[1] = dfabs[1] - corlw2
    olr = corlw1 + corlw2
    for jb in range(4):
        olr = olr + flux[jb]

    return slr, olr, jnp.stack(dfabs)
