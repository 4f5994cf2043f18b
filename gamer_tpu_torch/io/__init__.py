"""File IO: FITS export, RenderParams.dat, PNG."""

from .fits import read_fits_image, write_fits_channels, write_fits_image  # noqa: F401
from .renderparams import RenderParamsFile  # noqa: F401
