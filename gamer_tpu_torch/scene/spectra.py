"""Named RGB spectra (spectrum.h:50-72): case-insensitive lookup with the
white fallback of Galaxy::SetupSpectra (galaxy.cpp:75-85)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

Vec3 = Tuple[float, float, float]

# Spectra::PopulateSpectra (spectrum.h:50-58), the f32-exact constants
BUILTIN_SPECTRA: Dict[str, Vec3] = {
    "red": (1.0, 0.6, 0.4),
    "yellow": (1.0, 0.9, 0.45),
    "blue": (0.4, 0.6, 1.0),
    "white": (1.0, 1.0, 1.0),
    "cyan": (0.3, 0.7, 1.0),
    "purple": (1.0, 0.3, 0.8),
}

DEFAULT_SPECTRUM: Vec3 = (1.0, 1.0, 1.0)


def find_spectrum(name: str, table: Optional[Mapping[str, Vec3]] = None) -> Vec3:
    """The spectrum called ``name`` in ``table`` (None: the built-ins),
    white when there is none."""
    tbl = BUILTIN_SPECTRA if table is None else {k.lower(): v for k, v in table.items()}
    return tbl.get(name.lower(), DEFAULT_SPECTRUM)


def verify_spectra(names, table: Optional[Mapping[str, Vec3]] = None) -> str:
    """The first name in ``names`` that ``table`` (None: the built-ins)
    does not hold, case-insensitively; '' when every name resolves
    (Galaxy::VerifySpectra, galaxy.cpp:87-95)."""
    tbl = BUILTIN_SPECTRA if table is None else {k.lower(): v for k, v in table.items()}
    for n in names:
        if n.lower() not in tbl:
            return n
    return ""
