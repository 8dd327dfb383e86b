"""Region tiling, halo windows, and state-vector packing.

Reference: res_domain.f90.  The globe is split into n_regions rectangles
(T30 production: 1152 regions of 2x2 grid points, res_domain.f90:258-292);
each region's ESN input is its core patch plus an overlap halo, periodic
in longitude and clipped at the poles (getoverlapindices,
res_domain.f90:155-204).

Batched design: regions are grouped into CLASSES by their input-patch height
(pole rows are clipped, so polar regions have a smaller input vector and
hence a different reservoir size).  Within a class everything is uniform
and batches into single gathers/scatters; there is no rank-0 hub — the
"global grid" is just the (lat, lon) array the cores scatter into.

Vector packing order matches the reference exactly
(tile_full_input_to_target_data*, res_domain.f90:602-740): the atmo block
is Fortran column-major over (var, x, y, z) — i.e. var fastest, then lon,
lat, level — followed by flat (x, y) blocks for logp, precip, sst, tisr.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.core.geometry import Geometry


@dataclasses.dataclass(frozen=True)
class RegionClass:
    """A group of regions sharing identical patch geometry (static)."""
    name: str
    region_ids: np.ndarray       # (Rc,) global region numbers
    ix_core: np.ndarray          # (Rc, xc) global lon indices of the core
    iy_core: np.ndarray          # (Rc, yc) global lat indices
    ix_in: np.ndarray            # (Rc, xi) lon indices of the input window
    iy_in: np.ndarray            # (Rc, yi) lat indices
    core_in_input_x: np.ndarray  # (xc,) position of core cols inside window
    core_in_input_y: np.ndarray  # (yc,)

    @property
    def count(self):
        return len(self.region_ids)

    @property
    def core_shape(self):
        return self.ix_core.shape[1], self.iy_core.shape[1]

    @property
    def input_shape(self):
        return self.ix_in.shape[1], self.iy_in.shape[1]


class VertSpec(NamedTuple):
    """Vertical localization group (getoverlapindices_vert,
    res_domain.f90:206-256): a reservoir owns core sigma levels
    [z0, z1) and sees input levels [zi0, zi1) (core + clipped overlap).
    Only the BOTTOM group carries the 2-D surface blocks
    (logp/precip/sst in+out; trained_reservoir_prediction,
    mod_reservoir.f90:1790-1811); every group sees TISR."""
    z0: int
    z1: int
    zi0: int
    zi1: int
    top: bool
    bottom: bool

    @property
    def nz_core(self):
        return self.z1 - self.z0

    @property
    def nz_in(self):
        return self.zi1 - self.zi0

    @property
    def z_off(self):
        """Core offset inside the input window."""
        return self.z0 - self.zi0


def vert_specs(nz: int, num_vert_levels: int, vert_overlap: int
               ) -> list[VertSpec]:
    """All vertical groups (get_z_res_extent + getoverlapindices_vert,
    res_domain.f90:143-256), 0-based half-open ranges."""
    if nz % num_vert_levels:
        raise ValueError(f"nz={nz} not divisible by {num_vert_levels}")
    zchunk = nz // num_vert_levels
    out = []
    for g in range(num_vert_levels):
        z0, z1 = g * zchunk, (g + 1) * zchunk
        zi0 = max(z0 - vert_overlap, 0)
        zi1 = min(z1 + vert_overlap, nz)
        out.append(VertSpec(z0=z0, z1=z1, zi0=zi0, zi1=zi1,
                            top=(z0 == 0), bottom=(z1 == nz)))
    return out


FULL_COLUMN = None   # sentinel: single group spanning all levels (bottom)


def full_column_spec(nz: int) -> VertSpec:
    return VertSpec(z0=0, z1=nz, zi0=0, zi1=nz, top=True, bottom=True)


class VectorLayout(NamedTuple):
    """Slice offsets of each block inside the packed vector."""
    atmo: tuple        # (start, end)
    logp: Optional[tuple]
    precip: Optional[tuple]
    sst: Optional[tuple]
    tisr: Optional[tuple]
    total: int


def build_layout(nx: int, ny: int, nvar: int, nz: int, *, logp: bool,
                 precip: bool, sst: bool, tisr: bool) -> VectorLayout:
    pos = nvar * nx * ny * nz
    atmo = (0, pos)
    sl = {}
    for name, active in [("logp", logp), ("precip", precip),
                         ("sst", sst), ("tisr", tisr)]:
        if active:
            sl[name] = (pos, pos + nx * ny)
            pos += nx * ny
        else:
            sl[name] = None
    return VectorLayout(atmo=atmo, logp=sl["logp"], precip=sl["precip"],
                        sst=sl["sst"], tisr=sl["tisr"], total=pos)


class RegionLayout:
    """Static tiling of the Gaussian grid into ESN regions."""

    def __init__(self, geom: Geometry = Geometry(), n_regions: int = 1152,
                 overlap: int = 1):
        self.geom = geom
        self.n_regions = n_regions
        self.overlap = overlap

        nlon, nlat = geom.nlon, geom.nlat
        # factorization (domaindecomposition, res_domain.f90:258-280)
        n = (nlon * nlat) // n_regions
        fy = 0
        for i in range(int(np.sqrt(n)), 0, -1):
            if nlat % i == 0 and n % i == 0 and nlon % (n // i) == 0:
                fy = i
                break
        self.xc = n // fy         # core width  (lon)
        self.yc = fy              # core height (lat)
        self.nx_blocks = nlon // self.xc
        self.ny_blocks = nlat // self.yc

        # region r -> lower-left corner (getworkerlower_leftcorner):
        # col = r % ny_blocks indexes latitude blocks, row = r // ny_blocks
        r = np.arange(n_regions)
        self.block_x = r // self.ny_blocks
        self.block_y = r % self.ny_blocks
        self.x0 = self.block_x * self.xc      # 0-based core start lon
        self.y0 = self.block_y * self.yc

        lat_deg = np.rad2deg(geom.lat_radians)
        self.lat_start = lat_deg[self.y0]
        self.lat_end = lat_deg[self.y0 + self.yc - 1]

        self._build_classes()

    def _build_classes(self):
        o = self.overlap
        nlon, nlat = self.geom.nlon, self.geom.nlat
        groups: dict[tuple, list[int]] = {}
        for r in range(self.n_regions):
            ys = max(self.y0[r] - o, 0)
            ye = min(self.y0[r] + self.yc - 1 + o, nlat - 1)
            key = (ys - self.y0[r], ye - (self.y0[r] + self.yc - 1))
            groups.setdefault(key, []).append(r)

        self.classes: list[RegionClass] = []
        for (off_lo, off_hi), ids in sorted(groups.items()):
            ids = np.asarray(ids)
            xi = self.xc + 2 * o
            ix_core = (self.x0[ids, None] + np.arange(self.xc)[None, :]) % nlon
            iy_core = self.y0[ids, None] + np.arange(self.yc)[None, :]
            ix_in = (self.x0[ids, None] - o + np.arange(xi)[None, :]) % nlon
            # off_lo = (clipped window start) - y0 in [-o, 0];
            # off_hi = (clipped window end) - (y0 + yc - 1) in [0, o]
            start = self.y0[ids] + off_lo
            end = self.y0[ids] + self.yc - 1 + off_hi
            ylen = int(end[0] - start[0] + 1)
            iy_in = start[:, None] + np.arange(ylen)[None, :]
            name = f"y{off_lo}_{off_hi}"
            self.classes.append(RegionClass(
                name=name, region_ids=ids,
                ix_core=ix_core.astype(np.int32),
                iy_core=iy_core.astype(np.int32),
                ix_in=ix_in.astype(np.int32), iy_in=iy_in.astype(np.int32),
                core_in_input_x=np.arange(o, o + self.xc, dtype=np.int32),
                core_in_input_y=np.arange(-off_lo, -off_lo + self.yc,
                                          dtype=np.int32)))

    # ------------------------------------------------------------------
    # gathers and scatters (all batched over a class)
    # ------------------------------------------------------------------

    @staticmethod
    def gather_patches(field: jnp.ndarray, iy: np.ndarray, ix: np.ndarray
                       ) -> jnp.ndarray:
        """field (..., lat, lon) -> (Rc, ..., yi, xi) patches (gather path;
        kept as the oracle for class_patches and for irregular tilings)."""
        iyj = jnp.asarray(iy)   # (Rc, yi)
        ixj = jnp.asarray(ix)   # (Rc, xi)
        # advanced indexing broadcast: (Rc, yi, xi) index arrays
        patches = field[..., iyj[:, :, None], ixj[:, None, :]]
        # result (..., Rc, yi, xi) -> move Rc to front
        return jnp.moveaxis(patches, -3, 0)

    def class_patches(self, cls: RegionClass, field: jnp.ndarray,
                      core_only: bool = False) -> jnp.ndarray:
        """Windowed patches via cyclic rolls + strided slices — no gathers.

        field (..., lat, lon) -> (Rc, ..., yi, xi).  Exploits the regular
        block tiling: window element (a, b) across ALL regions of a class
        sits at one fixed global offset, so it is a single roll of the
        field subsampled on the block lattice.  XLA lowers rolls and
        strided slices to contiguous copies that fuse with their
        consumers."""
        iy = cls.iy_core if core_only else cls.iy_in
        ix = cls.ix_core if core_only else cls.ix_in
        yi, xi = iy.shape[1], ix.shape[1]
        off_lo = int(iy[0, 0]) - int(cls.iy_core[0, 0])
        xoff = 0 if core_only else -self.overlap
        by = np.asarray(cls.iy_core[:, 0]) // self.yc
        by_lo, by_hi = int(by.min()), int(by.max())
        nby = by_hi - by_lo + 1
        rows = []
        for a in range(yi):
            cols_l = []
            for b in range(xi):
                sh = (-(off_lo + a) - by_lo * self.yc, -(xoff + b))
                rolled = jnp.roll(field, sh, axis=(-2, -1))
                sub = rolled[..., 0:nby * self.yc:self.yc, ::self.xc]
                cols_l.append(sub)                # (..., nby, nbx)
            rows.append(jnp.stack(cols_l, axis=-1))
        p = jnp.stack(rows, axis=-2)              # (..., nby, nbx, yi, xi)
        # region order within a class is block_x-major, block_y-minor
        p = jnp.moveaxis(p, (-3, -4), (0, 1))     # (nbx, nby, ..., yi, xi)
        return p.reshape((p.shape[0] * p.shape[1],) + p.shape[2:])

    def pack_vector(self, cls: RegionClass, atmo: jnp.ndarray,
                    logp=None, precip=None, sst=None, tisr=None,
                    core_only: bool = False) -> jnp.ndarray:
        """Pack fields into per-region vectors in reference order.

        atmo: (V, K, lat, lon); 2-D fields (lat, lon).
        Returns (Rc, total). core_only packs the target/output layout."""
        parts = []
        ap = self.class_patches(cls, atmo, core_only)   # (Rc, V, K, y, x)
        # Fortran order: var fastest, then x, then y, then z ->
        # transpose to (Rc, z, y, x, v) and C-flatten
        parts.append(jnp.transpose(ap, (0, 2, 3, 4, 1)).reshape(ap.shape[0], -1))
        for f in (logp, precip, sst, tisr):
            if f is not None:
                p = self.class_patches(cls, f, core_only)   # (Rc, y, x)
                # Fortran (x, y) column-major = x fastest -> C-flatten (y, x)
                parts.append(p.reshape(p.shape[0], -1))
        return jnp.concatenate(parts, axis=1)

    def unpack_core_vector(self, cls: RegionClass, vec: jnp.ndarray,
                           nvar: int, nz: int, *, logp: bool, precip: bool
                           ) -> dict:
        """Inverse of pack_vector(core_only=True): (Rc, O) -> field patches."""
        xc, yc = cls.core_shape
        lay = build_layout(xc, yc, nvar, nz, logp=logp, precip=precip,
                           sst=False, tisr=False)
        out = {}
        a0, a1 = lay.atmo
        atmo = vec[:, a0:a1].reshape(-1, nz, yc, xc, nvar)
        out["atmo"] = jnp.transpose(atmo, (0, 4, 1, 2, 3))  # (Rc, V, K, y, x)
        if logp:
            l0, l1 = lay.logp
            out["logp"] = vec[:, l0:l1].reshape(-1, yc, xc)
        if precip:
            p0, p1 = lay.precip
            out["precip"] = vec[:, p0:p1].reshape(-1, yc, xc)
        return out

    def scatter_core(self, cls: RegionClass, patches: jnp.ndarray,
                     field: jnp.ndarray) -> jnp.ndarray:
        """Write core patches (Rc, ..., yc, xc) into the global field.

        A class's cores tile a contiguous latitude band over the full
        longitude circle, so the scatter is a reshape + one static slice
        update (no scatter op).  The regularity assumption (regions ordered
        block_x-major / block_y-minor, contiguous full band) is asserted on
        the static index tables — an irregular class raises instead of
        silently corrupting the field."""
        by = np.asarray(cls.iy_core[:, 0]) // self.yc
        by_lo, by_hi = int(by.min()), int(by.max())
        nby = by_hi - by_lo + 1
        nbx = self.nx_blocks
        if nbx * nby != cls.count:
            raise ValueError(
                f"scatter_core: class {cls.name} has {cls.count} regions, "
                f"not a full {nbx}x{nby} longitude band")
        exp_bx = np.repeat(np.arange(nbx), nby)
        exp_by = np.tile(np.arange(by_lo, by_hi + 1), nbx)
        if (np.any(np.asarray(cls.ix_core[:, 0]) != exp_bx * self.xc)
                or np.any(np.asarray(cls.iy_core[:, 0]) != exp_by * self.yc)):
            raise ValueError(
                f"scatter_core: class {cls.name} region order is not "
                "block_x-major/block_y-minor contiguous; use gather_patches "
                "based scatter for irregular tilings")
        yc, xc = self.yc, self.xc
        p = patches.reshape((nbx, nby) + patches.shape[1:])
        p = jnp.moveaxis(p, (0, 1), (-2, -4))   # (..., nby, yc, nbx, xc)
        band = p.reshape(p.shape[:-4] + (nby * yc, nbx * xc))
        lo = by_lo * yc
        return field.at[..., lo:lo + nby * yc, :].set(band)

    def input_to_target(self, cls: RegionClass, vec: jnp.ndarray,
                        nvar: int, nz_in: int, nz_core: int, z_off: int, *,
                        logp: bool, precip: bool, sst: bool, tisr: bool
                        ) -> jnp.ndarray:
        """Extract the core/target sub-vector from a packed input vector
        (tile_full_input_to_target_data, res_domain.f90:602-651)."""
        xi, yi = cls.input_shape
        lay = build_layout(xi, yi, nvar, nz_in, logp=logp, precip=precip,
                           sst=sst, tisr=tisr)
        Rc = vec.shape[0]
        cx = cls.core_in_input_x
        cy = cls.core_in_input_y
        a0, a1 = lay.atmo
        atmo = vec[:, a0:a1].reshape(Rc, nz_in, yi, xi, nvar)
        core = atmo[:, z_off:z_off + nz_core][:, :, cy][:, :, :, cx]
        parts = [core.reshape(Rc, -1)]
        for name in ("logp", "precip"):
            sl = getattr(lay, name)
            if sl is not None:
                f = vec[:, sl[0]:sl[1]].reshape(Rc, yi, xi)
                parts.append(f[:, cy][:, :, cx].reshape(Rc, -1))
        return jnp.concatenate(parts, axis=1)
