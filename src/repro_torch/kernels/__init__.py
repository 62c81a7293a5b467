"""Hand-written CUDA kernels for MGit's storage and serving hot paths (+ plain
torch versions).

- ``delta_quantize`` / ``dequant_apply``: Algorithm 1's lossy delta step.
- ``snapshot_fused``: the commit's quantize + int8 narrowing in one pass.
- ``chain_apply``: folded checkout of a same-eps delta chain.
- ``fingerprint``: the checkpoint's content fingerprint of a device tensor,
  hashed in place (8 bytes cross to the host).
- ``flash_attention``: the serving prefill's causal attention
  (``flash_attention.flash_attention``, torch tensors in and out).

``ops`` dispatches the storage kernels (``"cuda"``, the default) or to the
plain torch versions on the CPU (``"ref"``). Kernels build at first use
(``build.py``), never at import.
"""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (chain_apply, default_backend,
                                     delta_quantize, dequant_apply,
                                     fingerprint, snapshot_fused)

__all__ = ["ops", "ref", "default_backend", "delta_quantize", "dequant_apply",
           "chain_apply", "snapshot_fused", "fingerprint"]
