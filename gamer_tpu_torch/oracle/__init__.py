"""Spec-exact CPU reference renderer (conformance oracle): a copy of
``gamer_tpu.oracle``, held equal to it by tests/test_torch_copies.py.

This subpackage is the differential-testing datum for the renderers (the
JAX package's and this port's CUDA march), in the same role
``tools/galaxy_repro.py`` plays for the reference C++ binary. It is pure
numpy, mirrors the reference's mixed precision model (f32 Qt vectors, f64
scalars), and is deliberately structured differently from the engines so
agreement between them is meaningful. The CLI's ``galaxy oracle`` renders
with it.
"""

from .reference import render_oracle, OracleTimings  # noqa: F401
