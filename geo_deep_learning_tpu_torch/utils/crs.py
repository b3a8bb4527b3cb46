"""Coordinate reference system transforms (numpy, no GDAL).

The port's own copy of ``geo_deep_learning_tpu/utils/crs.py``: the same
formulas, constants and EPSG registry, so both packages reproject alike
(``tests/test_torch_utils.py`` holds the two against each other).

Covers the CRS families that appear in this framework's raster workflows
(reference ``utils/rasters.py:45-79`` delegates to ``rasterio.warp`` /
PROJ; this is a from-scratch implementation):

- **Geographic WGS84** (EPSG:4326)
- **UTM on WGS84** (EPSG:32601-32660 north, 32701-32760 south) via an
  extended Krüger-series transverse Mercator (6th order in the third
  flattening — the same formulation PROJ's ``etmerc`` uses; sub-mm
  agreement within UTM zones)
- **Web Mercator** (EPSG:3857, spherical)
- **Lambert conformal conic (2SP)** — EPSG:3978 (Canada Atlas Lambert,
  the NRCan house projection), EPSG:3347 (Statistics Canada Lambert),
  EPSG:2154 (France Lambert-93)
- **Albers equal-area conic** — EPSG:5070 (CONUS Albers),
  EPSG:3577 (Australian Albers)
- **Polar stereographic (variant B)** — EPSG:3413 (NSIDC Arctic),
  EPSG:3031 (Antarctic)

The conic/polar families use the exact ellipsoidal formulas (Snyder,
"Map Projections — A Working Manual", USGS PP 1395, §14/15/21),
vectorized over numpy arrays; goldens in tests/test_utils_rasters.py
reproduce Snyder's published worked examples on their own ellipsoids
plus projection invariants (unit scale on standard parallels, area
preservation for Albers, origin mapping). Datum note: NAD83/RGF93/GDA94
are treated as coincident with WGS84 (GRS80 vs WGS84 flattening differs
in the 9th significant digit; plate drift aside, the standard EO
approximation).

API: :func:`to_geographic` / :func:`from_geographic` convert between a
projected CRS and lon/lat degrees; :func:`transform_points` goes between
any two supported CRSs. All functions are vectorized over numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_E = np.sqrt(_F * (2.0 - _F))  # first eccentricity
_N = _F / (2.0 - _F)  # third flattening
_K0 = 0.9996
_FE = 500000.0

# rectifying radius and Krüger series coefficients (6th order in n)
_n = _N
_A_BAR = _A / (1 + _n) * (1 + _n**2 / 4 + _n**4 / 64 + _n**6 / 256)
_ALPHA = np.array(
    [
        _n / 2 - 2 * _n**2 / 3 + 5 * _n**3 / 16 + 41 * _n**4 / 180
        - 127 * _n**5 / 288 + 7891 * _n**6 / 37800,
        13 * _n**2 / 48 - 3 * _n**3 / 5 + 557 * _n**4 / 1440
        + 281 * _n**5 / 630 - 1983433 * _n**6 / 1935360,
        61 * _n**3 / 240 - 103 * _n**4 / 140 + 15061 * _n**5 / 26880
        + 167603 * _n**6 / 181440,
        49561 * _n**4 / 161280 - 179 * _n**5 / 168 + 6601661 * _n**6 / 7257600,
        34729 * _n**5 / 80640 - 3418889 * _n**6 / 1995840,
        212378941 * _n**6 / 319334400,
    ]
)
_BETA = np.array(
    [
        _n / 2 - 2 * _n**2 / 3 + 37 * _n**3 / 96 - _n**4 / 360
        - 81 * _n**5 / 512 + 96199 * _n**6 / 604800,
        _n**2 / 48 + _n**3 / 15 - 437 * _n**4 / 1440 + 46 * _n**5 / 105
        - 1118711 * _n**6 / 3870720,
        17 * _n**3 / 480 - 37 * _n**4 / 840 - 209 * _n**5 / 4480
        + 5569 * _n**6 / 90720,
        4397 * _n**4 / 161280 - 11 * _n**5 / 504 - 830251 * _n**6 / 7257600,
        4583 * _n**5 / 161280 - 108847 * _n**6 / 3991680,
        20648693 * _n**6 / 638668800,
    ]
)


def utm_zone_params(epsg: int) -> tuple[float, float]:
    """(central meridian deg, false northing) for a WGS84 UTM EPSG code."""
    if 32601 <= epsg <= 32660:
        return (epsg - 32600) * 6.0 - 183.0, 0.0
    if 32701 <= epsg <= 32760:
        return (epsg - 32700) * 6.0 - 183.0, 10000000.0
    msg = f"EPSG:{epsg} is not a WGS84 UTM zone"
    raise ValueError(msg)


def _tm_forward(lon_deg, lat_deg, lon0_deg: float):
    """Transverse Mercator forward: lon/lat deg → (easting-from-CM, northing)."""
    lam = np.radians(np.asarray(lon_deg, np.float64) - lon0_deg)
    phi = np.radians(np.asarray(lat_deg, np.float64))
    s = np.sin(phi)
    # conformal latitude via Gauss-Schreiber: t = tan(chi)
    t = np.sinh(
        np.arctanh(s) - _E * np.arctanh(_E * s)
    )
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.sqrt(t**2 + np.cos(lam) ** 2))
    j = np.arange(1, 7).reshape((6,) + (1,) * np.ndim(xi_p))
    xi = xi_p + np.sum(_ALPHA.reshape(j.shape) * np.sin(2 * j * xi_p) * np.cosh(2 * j * eta_p), axis=0)
    eta = eta_p + np.sum(_ALPHA.reshape(j.shape) * np.cos(2 * j * xi_p) * np.sinh(2 * j * eta_p), axis=0)
    return _K0 * _A_BAR * eta, _K0 * _A_BAR * xi


def _tm_inverse(x, y, lon0_deg: float):
    """Transverse Mercator inverse: (easting-from-CM, northing) → lon/lat deg."""
    eta = np.asarray(x, np.float64) / (_K0 * _A_BAR)
    xi = np.asarray(y, np.float64) / (_K0 * _A_BAR)
    j = np.arange(1, 7).reshape((6,) + (1,) * np.ndim(xi))
    xi_p = xi - np.sum(_BETA.reshape(j.shape) * np.sin(2 * j * xi) * np.cosh(2 * j * eta), axis=0)
    eta_p = eta - np.sum(_BETA.reshape(j.shape) * np.cos(2 * j * xi) * np.sinh(2 * j * eta), axis=0)
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    # conformal → geodetic latitude by fixed-point iteration (converges
    # quadratically fast for |e| of Earth; 6 rounds ≈ double precision)
    phi = chi
    half_pi = np.pi / 2
    for _ in range(6):
        es = _E * np.sin(phi)
        phi = (
            2.0
            * np.arctan(
                np.tan(np.pi / 4 + chi / 2)
                * ((1 + es) / (1 - es)) ** (_E / 2)
            )
            - half_pi
        )
    return np.degrees(lam) + lon0_deg, np.degrees(phi)


def to_geographic(epsg: int, x, y):
    """Projected (x, y) in ``epsg`` → (lon, lat) degrees on WGS84."""
    if epsg == 4326:
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    proj = PROJECTIONS.get(epsg)
    if proj is not None:
        return proj.inverse(x, y)
    if epsg == 3857:
        lon = np.degrees(np.asarray(x, np.float64) / _A)
        lat = np.degrees(
            2 * np.arctan(np.exp(np.asarray(y, np.float64) / _A)) - np.pi / 2
        )
        return lon, lat
    lon0, fn = utm_zone_params(epsg)
    return _tm_inverse(np.asarray(x, np.float64) - _FE, np.asarray(y, np.float64) - fn, lon0)


def from_geographic(epsg: int, lon, lat):
    """(lon, lat) degrees on WGS84 → projected (x, y) in ``epsg``."""
    if epsg == 4326:
        return np.asarray(lon, np.float64), np.asarray(lat, np.float64)
    proj = PROJECTIONS.get(epsg)
    if proj is not None:
        return proj.forward(lon, lat)
    if epsg == 3857:
        x = _A * np.radians(np.asarray(lon, np.float64))
        y = _A * np.log(np.tan(np.pi / 4 + np.radians(np.asarray(lat, np.float64)) / 2))
        return x, y
    lon0, fn = utm_zone_params(epsg)
    e, n = _tm_forward(lon, lat, lon0)
    return e + _FE, n + fn


# --------------------------------------------------------------------------
# Conic + polar families (exact ellipsoidal formulas, Snyder PP 1395)

# (a, flattening); GRS80 and WGS84 differ only in the 9th digit of 1/f
_WGS84 = (6378137.0, 1.0 / 298.257223563)
_GRS80 = (6378137.0, 1.0 / 298.257222101)


def _ecc(ell: tuple[float, float]) -> float:
    a, f = ell
    return float(np.sqrt(f * (2.0 - f)))


def _msf(e: float, phi):
    """m(φ) = cosφ / sqrt(1 − e² sin²φ) (Snyder 14-15)."""
    s = np.sin(phi)
    return np.cos(phi) / np.sqrt(1.0 - (e * s) ** 2)


def _tsf(e: float, phi):
    """t(φ) = tan(π/4 − φ/2) / ((1 − e sinφ)/(1 + e sinφ))^{e/2} (15-9)."""
    s = e * np.sin(phi)
    return np.tan(np.pi / 4 - phi / 2) / ((1.0 - s) / (1.0 + s)) ** (e / 2.0)


def _phi_from_ts(e: float, ts):
    """Invert :func:`_tsf` by fixed-point iteration (Snyder 7-9)."""
    phi = np.pi / 2 - 2.0 * np.arctan(ts)
    for _ in range(8):
        s = e * np.sin(phi)
        phi = np.pi / 2 - 2.0 * np.arctan(
            ts * ((1.0 - s) / (1.0 + s)) ** (e / 2.0)
        )
    return phi


def _qsf(e: float, phi):
    """Albers q(φ) (Snyder 3-12)."""
    s = np.sin(phi)
    es = e * s
    return (1.0 - e * e) * (
        s / (1.0 - es * es) - (1.0 / (2.0 * e)) * np.log((1.0 - es) / (1.0 + es))
    )


@dataclass(frozen=True)
class LambertConformal2SP:
    """Snyder §15 (ellipsoid, two standard parallels)."""

    ellipsoid: tuple[float, float]
    lat0: float
    lon0: float
    sp1: float
    sp2: float
    fe: float = 0.0
    fn: float = 0.0

    def _consts(self):
        a, _ = self.ellipsoid
        e = _ecc(self.ellipsoid)
        p1, p2 = np.radians(self.sp1), np.radians(self.sp2)
        m1, m2 = _msf(e, p1), _msf(e, p2)
        t1, t2 = _tsf(e, p1), _tsf(e, p2)
        if abs(self.sp1 - self.sp2) < 1e-10:
            n = np.sin(p1)
        else:
            n = (np.log(m1) - np.log(m2)) / (np.log(t1) - np.log(t2))
        f_ = m1 / (n * t1**n)
        rho0 = a * f_ * _tsf(e, np.radians(self.lat0)) ** n
        return a, e, n, f_, rho0

    def forward(self, lon, lat):
        a, e, n, f_, rho0 = self._consts()
        phi = np.radians(np.asarray(lat, np.float64))
        theta = n * np.radians(np.asarray(lon, np.float64) - self.lon0)
        rho = a * f_ * _tsf(e, phi) ** n
        return (
            self.fe + rho * np.sin(theta),
            self.fn + rho0 - rho * np.cos(theta),
        )

    def inverse(self, x, y):
        a, e, n, f_, rho0 = self._consts()
        xp = np.asarray(x, np.float64) - self.fe
        yp = rho0 - (np.asarray(y, np.float64) - self.fn)
        rho = np.sign(n) * np.hypot(xp, yp)
        theta = np.arctan2(np.sign(n) * xp, np.sign(n) * yp)
        ts = (rho / (a * f_)) ** (1.0 / n)
        phi = _phi_from_ts(e, ts)
        return np.degrees(theta / n) + self.lon0, np.degrees(phi)


@dataclass(frozen=True)
class AlbersEqualArea:
    """Snyder §14 (ellipsoid, two standard parallels)."""

    ellipsoid: tuple[float, float]
    lat0: float
    lon0: float
    sp1: float
    sp2: float
    fe: float = 0.0
    fn: float = 0.0

    def _consts(self):
        a, _ = self.ellipsoid
        e = _ecc(self.ellipsoid)
        p1, p2 = np.radians(self.sp1), np.radians(self.sp2)
        m1, m2 = _msf(e, p1), _msf(e, p2)
        q1, q2 = _qsf(e, p1), _qsf(e, p2)
        n = (m1 * m1 - m2 * m2) / (q2 - q1)
        c = m1 * m1 + n * q1
        rho0 = a * np.sqrt(c - n * _qsf(e, np.radians(self.lat0))) / n
        return a, e, n, c, rho0

    def forward(self, lon, lat):
        a, e, n, c, rho0 = self._consts()
        phi = np.radians(np.asarray(lat, np.float64))
        theta = n * np.radians(np.asarray(lon, np.float64) - self.lon0)
        rho = a * np.sqrt(c - n * _qsf(e, phi)) / n
        return (
            self.fe + rho * np.sin(theta),
            self.fn + rho0 - rho * np.cos(theta),
        )

    def inverse(self, x, y):
        a, e, n, c, rho0 = self._consts()
        xp = np.asarray(x, np.float64) - self.fe
        yp = rho0 - (np.asarray(y, np.float64) - self.fn)
        rho = np.hypot(xp, yp)
        theta = np.arctan2(np.sign(n) * xp, np.sign(n) * yp)
        q = (c - (rho * n / a) ** 2) / n
        # iterate Snyder 3-16 for φ from q
        phi = np.arcsin(np.clip(q / 2.0, -1.0, 1.0))
        for _ in range(8):
            s = np.sin(phi)
            es = e * s
            phi = phi + (1.0 - es * es) ** 2 / (2.0 * np.cos(phi)) * (
                q / (1.0 - e * e)
                - s / (1.0 - es * es)
                + np.log((1.0 - es) / (1.0 + es)) / (2.0 * e)
            )
        return np.degrees(theta / n) + self.lon0, np.degrees(phi)


@dataclass(frozen=True)
class PolarStereographic:
    """Snyder §21 variant B (ellipsoid, standard parallel lat_ts)."""

    ellipsoid: tuple[float, float]
    lat_ts: float
    lon0: float
    fe: float = 0.0
    fn: float = 0.0

    @property
    def north(self) -> bool:
        return self.lat_ts >= 0

    def _consts(self):
        a, _ = self.ellipsoid
        e = _ecc(self.ellipsoid)
        pts = np.radians(abs(self.lat_ts))
        # ρ = a m(φ_ts) t(φ)/t(φ_ts)
        scale = a * _msf(e, pts) / _tsf(e, pts)
        return a, e, scale

    def forward(self, lon, lat):
        _, e, scale = self._consts()
        lam = np.radians(np.asarray(lon, np.float64) - self.lon0)
        phi = np.radians(np.asarray(lat, np.float64))
        if not self.north:
            lam, phi = -lam, -phi
        rho = scale * _tsf(e, phi)
        x = rho * np.sin(lam)
        y = -rho * np.cos(lam)
        if not self.north:
            x, y = -x, -y
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        _, e, scale = self._consts()
        xp = np.asarray(x, np.float64) - self.fe
        yp = np.asarray(y, np.float64) - self.fn
        if not self.north:
            xp, yp = -xp, -yp
        rho = np.hypot(xp, yp)
        ts = rho / scale
        phi = _phi_from_ts(e, ts)
        lam = np.arctan2(xp, -yp)
        if not self.north:
            lam, phi = -lam, -phi
        lon = np.degrees(lam) + self.lon0
        return (lon + 180.0) % 360.0 - 180.0, np.degrees(phi)


# EPSG registry for the conic/polar families (official parameter sets)
PROJECTIONS: dict[int, object] = {
    # NAD83 / Canada Atlas Lambert — the NRCan house projection
    3978: LambertConformal2SP(_GRS80, 49.0, -95.0, 49.0, 77.0),
    # NAD83 / Statistics Canada Lambert
    3347: LambertConformal2SP(
        _GRS80, 63.390675, -91.0 - 52.0 / 60.0, 49.0, 77.0, 6200000.0, 3000000.0
    ),
    # RGF93 / Lambert-93 (France)
    2154: LambertConformal2SP(_GRS80, 46.5, 3.0, 49.0, 44.0, 700000.0, 6600000.0),
    # NAD83 / CONUS Albers
    5070: AlbersEqualArea(_GRS80, 23.0, -96.0, 29.5, 45.5),
    # GDA94 / Australian Albers
    3577: AlbersEqualArea(_GRS80, 0.0, 132.0, -18.0, -36.0),
    # WGS84 / NSIDC Sea Ice Polar Stereographic North
    3413: PolarStereographic(_WGS84, 70.0, -45.0),
    # WGS84 / Antarctic Polar Stereographic
    3031: PolarStereographic(_WGS84, -71.0, 0.0),
}


def is_supported(epsg: int | None) -> bool:
    """True when the NATIVE projection math handles this EPSG code."""
    if epsg in (4326, 3857) or epsg in PROJECTIONS:
        return True
    return epsg is not None and (
        32601 <= epsg <= 32660 or 32701 <= epsg <= 32760
    )


SUPPORTED_FAMILIES = (
    "EPSG:4326 (WGS84 geographic), EPSG:3857 (Web Mercator), "
    "WGS84 UTM 32601-32660/32701-32760, and the registered conic/polar "
    "projections " + "/".join(f"EPSG:{c}" for c in sorted(PROJECTIONS))
)


def _pyproj_transformer(src_epsg: int, dst_epsg: int):
    """A pyproj transform callable for an arbitrary CRS pair, or None.

    pyproj is an OPTIONAL escape hatch: the native families above stay the
    tested default (no heavy GDAL/PROJ dependency), but when pyproj is
    importable any CRS pair it knows becomes reprojectable — matching the
    reference's any-GDAL-CRS reach (reference utils/rasters.py:45-79).
    Returns None when pyproj is missing OR rejects the pair (unknown EPSG
    code), so callers fall through to the curated actionable error
    instead of a raw pyproj CRSError mid-resampling.
    """
    try:
        from pyproj import Transformer
    except ImportError:
        return None
    try:
        return Transformer.from_crs(
            f"EPSG:{src_epsg}", f"EPSG:{dst_epsg}", always_xy=True
        ).transform
    except Exception:  # pyproj.exceptions.CRSError et al.
        return None


def can_transform(src_epsg: int | None, dst_epsg: int | None) -> bool:
    """True when :func:`transform_points` can handle this CRS pair —
    natively, or through the optional pyproj fallback (checked by
    actually constructing the transformer, not just importability)."""
    if src_epsg is None or dst_epsg is None:
        return False
    if is_supported(src_epsg) and is_supported(dst_epsg):
        return True
    return _pyproj_transformer(src_epsg, dst_epsg) is not None


def transform_points(src_epsg: int, dst_epsg: int, x, y):
    """Transform coordinate arrays between two CRSs.

    Uses the in-repo projection math for the supported families; for any
    other pair, delegates to pyproj when importable. Raises
    ``NotImplementedError`` with the supported envelope otherwise.
    """
    if src_epsg == dst_epsg:
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    if is_supported(src_epsg) and is_supported(dst_epsg):
        lon, lat = to_geographic(src_epsg, x, y)
        return from_geographic(dst_epsg, lon, lat)
    tf = _pyproj_transformer(src_epsg, dst_epsg)
    if tf is None:
        msg = (
            f"CRS pair EPSG:{src_epsg} -> EPSG:{dst_epsg} is outside the "
            f"natively supported families ({SUPPORTED_FAMILIES}), and "
            "pyproj is not installed or does not recognize the pair. "
            "Install pyproj for arbitrary-CRS reprojection, check the "
            "EPSG codes, or pre-reproject the raster with GDAL "
            "(gdalwarp -t_srs EPSG:<code>)."
        )
        raise NotImplementedError(msg)
    xs, ys = tf(np.asarray(x, np.float64), np.asarray(y, np.float64))
    return np.asarray(xs, np.float64), np.asarray(ys, np.float64)
