"""Physical and unit-conversion constants.

Capability parity with the reference's ``glomar_gridding/constants.py:17-27``
(Earth radii, nautical-mile conversions). The joblib knobs of the reference
have no equivalent here: batching is ``jax.vmap``, not process pools.
"""

RADIUS_OF_EARTH_M: float = 6371000.0  # Average radius of Earth (m)
RADIUS_OF_EARTH_KM: float = 6371.0  # Average radius of Earth (km)
KM_TO_M: float = 1000.0

# Each degree of latitude equals 60 nautical miles (cosine correction applies
# for longitude).
NM_PER_LAT: float = 60.0
KM_TO_NM: float = 1.852  # km per nautical mile

# Default tile edge for blocked pairwise/covariance kernels.
DEFAULT_TILE: int = 256
