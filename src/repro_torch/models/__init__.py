"""Model configs, parameters and the training forward pass (dense family)."""

from repro_torch.models.config import (ModelConfig, get_config, list_archs,
                                       register_arch)
from repro_torch.models.graph import spec_graph, state_graph
from repro_torch.models.model import (flat_paths, forward, init_params,
                                      param_shapes)

__all__ = ["ModelConfig", "get_config", "list_archs", "register_arch",
           "spec_graph", "state_graph", "init_params", "param_shapes",
           "forward", "flat_paths"]
