"""MGit on PyTorch and CUDA: model lineage, versioning and delta storage.

A port of the reference package ``repro`` (JAX, TPU) that runs its
storage hot path on an NVIDIA H100 through hand-written CUDA kernels
(``repro_torch.kernels``). It imports torch, numpy and the standard
library, and nothing of ``jax`` or ``repro``. Ported so far: the lineage
graph, artifacts, diff, merge, update cascades and auto-construction
(``core``), the diagnostics engine and its test gate (``diag``), the
content-addressed delta store and continuous checkpointing (``store``),
the dense models (``models``), AdamW (``optim``), gradient compression
(``dist``), the synthetic pipeline (``data``), the train step and loop
(``train``), straggler handling (``ft``) and serving (``serve``).
"""
