"""The model families the benchmark knows, one module each, found by a
configuration's ``model.family``. A family module gives:

* ``KERNELS``: the port's CUDA kernels its serving path launches, built
  in set-up;
* ``layer_specs(m)``: {path: (shape, dtype)} of its layer leaves, the
  port's parameter layout;
* ``UNIFORM`` and ``init(leaf, normal, uniform, std)``: the leaves that
  take a uniform draw, and each leaf's initial value;
* ``token_ops(m)`` and ``context_ops(m, tokens)``: the operations one
  token needs through the stack, and those that grow with its context;
* ``layer(model, x, i)``: layer ``i`` of the plain reference, with
  ``model``'s products and norm (``reference/model.py``).

A family module imports nothing of the program. A new family is a new
module here; so is a variant of one (biases, windowed attention), which a
configuration names by ``model.family_module`` where it differs from the
port's ``family``.
"""

import importlib


def family(m: dict):
    """The module of the model family that ``m`` names."""
    name = m.get("family_module", m["family"])
    return importlib.import_module(f"mgitbench.families.{name}")
