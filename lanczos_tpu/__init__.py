"""lanczos_tpu — a Lanczos resampling framework in JAX.

A from-scratch reimplementation of the capabilities of PKBeam/Lanczos-HLS
(a Vivado-HLS streaming Lanczos image upscaler) for accelerators:
resampling is expressed as application of banded resampling operators
``Y = R_v · X · R_hᵀ`` whose values come from per-phase Lanczos weight
tables (the rational-scale phase-LUT insight of the reference's
``kernel.cpp:50-59``), executed as a fused Pallas kernel on one card and
row-partitioned with ``ppermute`` halo exchange across a device mesh.

Public API:
    - ``lanczos_tpu.core``:   configuration, filter kernels, weight tables
    - ``lanczos_tpu.ref``:    NumPy oracles faithful to the reference numerics
    - ``lanczos_tpu.ops``:    XLA and Pallas resampling ops
    - ``lanczos_tpu.parallel``: mesh sharding + halo exchange
    - ``lanczos_tpu.models``: high-level upscaler pipelines
    - ``lanczos_tpu.io``:     image codecs (the full stb set: PNG/JPEG/BMP/
      TGA/PNM/GIF/PSD/HDR/PIC + probe/16-bit/GIF-frames APIs; native C++
      fast paths) and Y4M video (8- and 10/12/14/16-bit)
    - ``lanczos_tpu.utils``:  metrics, profiling, roofline
"""

__version__ = "0.1.0"

from lanczos_tpu.core.config import (  # noqa: F401
    EdgeMode,
    Order,
    Precision,
    Profile,
    ResampleConfig,
)
from lanczos_tpu.models.streaming import (  # noqa: F401
    ShardedStreamingUpscaler,
    StreamingUpscaler,
)
from lanczos_tpu.models.upscaler import Upscaler, upscale  # noqa: F401
from lanczos_tpu.models.video import VideoUpscaler, upscale_y4m  # noqa: F401
from lanczos_tpu.parallel.sharded import ShardedUpscaler  # noqa: F401
