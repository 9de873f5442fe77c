"""Lower a function for CUDA from a CPU-only process, verifying every Triton
module it emits.

The GPU side parses and verifies a Pallas kernel's Triton IR before it
compiles it; running the same MLIR verifier here catches IR the card would
refuse (e.g. a `while` carry whose type changes between iterations) without
a GPU.  What the Triton compiler itself refuses still shows only on the card.
"""

from unittest import mock

import jax
from jax._src.pallas.triton import lowering as triton_lowering


def lower_for_cuda(fn, *args):
    """(StableHLO text, number of Triton modules verified)."""
    orig = triton_lowering.lower_jaxpr_to_triton_module
    count = [0]

    def checked(*a, **kw):
        result = orig(*a, **kw)
        result.module.operation.verify()
        count[0] += 1
        return result

    with mock.patch.object(triton_lowering, "lower_jaxpr_to_triton_module", checked):
        text = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    return text, count[0]
