"""Device-mesh sharding for batched wideband fits."""

from pulseportraiture_tpu.parallel.mesh import (
    make_mesh, fit_portrait_full_sharded, fit_portrait_full_sharded_direct)
