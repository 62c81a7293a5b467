"""Model configs, parameters, the forward pass and decoding, every family."""

from repro_torch.models.config import (ModelConfig, get_config, list_archs,
                                       register_arch)
from repro_torch.models.graph import spec_graph, state_graph
from repro_torch.models.model import (cache_shapes, decode_step, flat_paths,
                                      forward, init_cache, init_params,
                                      param_shapes, prefill)

__all__ = ["ModelConfig", "get_config", "list_archs", "register_arch",
           "spec_graph", "state_graph", "init_params", "param_shapes",
           "forward", "flat_paths", "cache_shapes", "init_cache",
           "decode_step", "prefill"]
