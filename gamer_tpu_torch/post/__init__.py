"""Image-space post stages: star-field overlay, Mollweide, HEALPix."""

from .healpix import ang2pix_ring, npix, pix2vec_ring  # noqa: F401
from .mollweide import mollweide_image, mollweide_lookup  # noqa: F401
from .stars import render_star_field  # noqa: F401
