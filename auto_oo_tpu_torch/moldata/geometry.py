"""Geometry input handling: xyz strings and Z-matrices -> cartesian coords.

Replaces the geometry-parsing capability the reference obtained from PySCF's
``gto.Mole(atom=...)`` (reference moldata_pyscf.py:28).
Accepts the same input styles used throughout the reference tests:

* ``'H 0 0 0; F 0 0 1.1'`` - xyz rows separated by ``;`` or newlines,
  distances in Angstrom.
* Z-matrix strings such as the formaldimine geometry of
  ``get_formal_geo`` (reference utils/miscellaneous.py:34),
  with distances in Angstrom and angles in degrees.

The Z-matrix -> cartesian construction follows the same frame convention as
PySCF (first atom at origin, second displaced along +x, angles opened by
rotation about the bond-plane normal) so that frame-dependent golden arrays
(e.g. OAO coefficient matrices in the reference tests) remain comparable.
"""

import numpy as np

from ..config import BOHR

ELEMENTS = [
    "X", "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
]

CHARGES = {sym: z for z, sym in enumerate(ELEMENTS)}


def _norm_symbol(tok):
    tok = tok.strip()
    sym = tok[0].upper() + tok[1:].lower()
    if sym not in CHARGES:
        raise ValueError(f"Unknown element symbol: {tok!r}")
    return sym


def _tokenize_lines(geometry):
    lines = []
    for chunk in geometry.replace(";", "\n").splitlines():
        toks = chunk.replace(",", " ").split()
        if toks:
            lines.append(toks)
    return lines


def rotation_mat(axis, angle):
    """Rodrigues rotation matrix about (unnormalized) axis."""
    axis = np.asarray(axis, dtype=float)
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    ux, uy, uz = axis
    k = np.array([[0.0, -uz, uy], [uz, 0.0, -ux], [-uy, ux, 0.0]])
    return c * np.eye(3) + s * k + (1 - c) * np.outer(axis, axis)


def parse_geometry(geometry, unit="angstrom"):
    """Parse a geometry string into (symbols, coords) with coords in Bohr.

    Auto-detects Z-matrix vs xyz format: a first line holding only an element
    symbol marks a Z-matrix.
    """
    if isinstance(geometry, (list, tuple)):
        symbols = [_norm_symbol(a[0]) for a in geometry]
        coords = np.array([a[1] for a in geometry], dtype=float)
    else:
        lines = _tokenize_lines(geometry)
        if not lines:
            raise ValueError("empty geometry")
        if len(lines[0]) == 1:
            symbols, coords = _zmatrix_to_cart(lines)
        else:
            symbols = [_norm_symbol(t[0]) for t in lines]
            coords = np.array([[float(x) for x in t[1:4]] for t in lines])
    if unit.lower().startswith("ang"):
        coords = coords / BOHR
    return symbols, np.asarray(coords, dtype=float)


def _zmatrix_to_cart(lines):
    """Z-matrix -> cartesian (PySCF frame convention)."""
    symbols = []
    coords = []
    for n, toks in enumerate(lines):
        symbols.append(_norm_symbol(toks[0]))
        if len(toks) < 3:
            coords.append(np.zeros(3))
        elif len(toks) == 3:
            ia = int(toks[1]) - 1
            bond = float(toks[2])
            coords.append(coords[ia] + np.array([bond, 0.0, 0.0]))
        elif len(toks) == 5:
            ia = int(toks[1]) - 1
            bond = float(toks[2])
            ib = int(toks[3]) - 1
            ang = np.deg2rad(float(toks[4]))
            v1 = coords[ib] - coords[ia]
            if not np.allclose(v1[:2], 0.0):
                vecn = np.cross(v1, np.array([0.0, 0.0, 1.0]))
            else:
                vecn = np.array([0.0, 0.0, 1.0])
            c = rotation_mat(vecn, ang) @ v1 * (bond / np.linalg.norm(v1))
            coords.append(coords[ia] + c)
        else:
            ia = int(toks[1]) - 1
            bond = float(toks[2])
            ib = int(toks[3]) - 1
            ang = np.deg2rad(float(toks[4]))
            ic = int(toks[5]) - 1
            dih = np.deg2rad(float(toks[6]))
            v1 = coords[ib] - coords[ia]
            v2 = coords[ic] - coords[ib]
            vecn = np.cross(v2, -v1)
            vecn_norm = np.linalg.norm(vecn)
            if vecn_norm < 1e-7:
                # reference atoms collinear: dihedral plane undefined; pick
                # any perpendicular (matches degenerate-case handling).
                for trial in (np.array([0.0, 0.0, 1.0]),
                              np.array([0.0, 1.0, 0.0])):
                    vecn = np.cross(v1, trial)
                    if np.linalg.norm(vecn) > 1e-7:
                        break
                vecn = vecn / np.linalg.norm(vecn)
                vecn = rotation_mat(v1, -dih) @ vecn
            else:
                vecn = rotation_mat(v1, -dih) @ (vecn / vecn_norm)
            c = rotation_mat(vecn, ang) @ v1 * (bond / np.linalg.norm(v1))
            coords.append(coords[ia] + c)
    return symbols, np.array(coords)


def nuclear_repulsion(charges, coords):
    """Nuclear repulsion energy (coords in Bohr)."""
    e = 0.0
    for i in range(len(charges)):
        for j in range(i):
            e += charges[i] * charges[j] / np.linalg.norm(coords[i] - coords[j])
    return e
