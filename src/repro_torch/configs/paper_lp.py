"""The paper's own workload: batched 2-D LPs.

Problem-size grid mirroring the paper's experiments (section 4): LP sizes
(constraints per problem) sweep 2^3..2^13 and batch amounts sweep
2^7..2^17 (their figures 3a-3c use batches {128, 2048, 16384}; figure 4
sweeps batch at sizes {64, 8192})."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LPWorkload:
    name: str
    batch: int
    m: int  # constraints per LP
    dtype: str = "float32"


FIG3_BATCHES = (128, 2048, 16384)
FIG3_SIZES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
FIG4_SIZES = (64, 8192)
FIG4_BATCHES = (128, 512, 2048, 8192, 32768, 131072)

# production-scale batch for the multi-pod dry-run: one LP per "agent"
PRODUCTION = LPWorkload(name="lp-production", batch=1 << 20, m=256)
