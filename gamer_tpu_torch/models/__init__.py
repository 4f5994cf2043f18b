"""Galaxy model families: parametric families + the fixture gallery."""

from .presets import (  # noqa: F401
    GALLERY,
    barred_spiral,
    dusty_disk,
    elliptical,
    fixture,
    fixture_names,
    flocculent,
    irregular,
    ring,
    spiral,
)
