"""Parameters, initialisation, the forward pass and decoding (dense family).

``param_shapes`` gives the same flat ``{path: shape}`` as the reference
package's ``repro/models/model.py::param_shapes`` for the dense family, and
``init_params`` draws the same distributions (``_init_one``'s scaling)
from a ``torch.Generator``. The two packages' random streams differ, so
tests that need equal weights make them with numpy and carry them across
with ``repro_torch.convert``.

``forward`` is the reference's training forward for the dense family: the
``lax.scan`` over stacked layer weights becomes a loop that indexes layer
``i`` of every stacked leaf. ``prefill`` and ``decode_step`` are the
reference's too, with the decode cache (``init_cache``) carried through
the same loop: layer ``i`` writes its slice of the stacked K/V buffers in
place. The other families raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import shard
from repro_torch.kernels.ref import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention_layer, mlp, rmsnorm

Params = Dict[str, Any]
MODELS_ITEM = "the other model families"
_NORM_LEAVES = ("ln1", "ln2", "ln_cross", "final_norm", "enc_final_norm",
                "norm", "q_norm", "k_norm")


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r}: only dense models are ported so far "
            f"(ROADMAP item '{MODELS_ITEM}')")


def _attn_shapes(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Tuple]:
    hd = cfg.resolved_head_dim
    s = {
        "wq": lead + (cfg.d_model, cfg.n_heads * hd),
        "wk": lead + (cfg.d_model, cfg.n_kv_heads * hd),
        "wv": lead + (cfg.d_model, cfg.n_kv_heads * hd),
        "wo": lead + (cfg.n_heads * hd, cfg.d_model),
    }
    if cfg.qk_norm:
        s["q_norm"] = lead + (hd,)
        s["k_norm"] = lead + (hd,)
    return s


def _mlp_shapes(cfg: ModelConfig, lead: Tuple[int, ...], prefix: str = "w"
                ) -> Dict[str, Tuple]:
    s = {f"{prefix}_in": lead + (cfg.d_model, cfg.d_ff),
         f"{prefix}_out": lead + (cfg.d_ff, cfg.d_model)}
    if cfg.mlp_type == "swiglu":
        s[f"{prefix}_gate"] = lead + (cfg.d_model, cfg.d_ff)
    return s


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Flat {path: shape} for the whole model (dense family)."""
    _require_dense(cfg)
    L = cfg.n_layers
    shapes: Dict[str, Tuple] = {"embed/tok": (cfg.vocab_size, cfg.d_model)}
    for k, v in _attn_shapes(cfg, (L,)).items():
        shapes[f"layers/attn/{k}"] = v
    for k, v in _mlp_shapes(cfg, (L,)).items():
        shapes[f"layers/mlp/{k}"] = v
    shapes["layers/ln1"] = (L, cfg.d_model)
    shapes["layers/ln2"] = (L, cfg.d_model)
    shapes["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


def _init_one(path: str, shape: Tuple, cfg: ModelConfig,
              generator: torch.Generator) -> torch.Tensor:
    dtype = torch_dtype(cfg.dtype)
    if path.rsplit("/", 1)[-1] in _NORM_LEAVES:
        return torch.zeros(shape, dtype=dtype,
                           device=generator.device)  # 1+w convention
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Random parameters as a flat ``{path: tensor}`` in sorted path order,
    drawn from ``generator`` on its device."""
    return {p: _init_one(p, s, cfg, generator)
            for p, s in sorted(param_shapes(cfg).items())}


def _nested(flat: Dict[str, Any]) -> Params:
    tree: Params = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def flat_paths(tree: Params, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_paths(v, path))
        else:
            out[path] = v
    return out


# ---------------------------------------------------------------------------
# Forward (training)
# ---------------------------------------------------------------------------

def _dense_block(x, lp, cfg: ModelConfig, positions, prefix_len,
                 cache=None, cache_pos=0, causal=True):
    """One dense decoder layer (writes its ``cache`` slice in place)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    x = x + attention_layer(h, lp["attn"], cfg, positions=positions,
                            causal=causal, prefix_len=prefix_len,
                            cache=cache, cache_pos=cache_pos)
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i``'s weights: index ``i`` of every stacked leaf."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _run_stack(x, layers_params, cfg: ModelConfig, positions, *,
               prefix_len: int = 0, causal: bool = True, cache=None,
               cache_pos: int = 0):
    """The reference's scan over stacked layers, as a loop. Layer ``i``
    gets views of ``cache``'s slices ``[i]`` and writes them in place.

    ``cfg.remat`` does not change the numbers, so activations are kept."""
    n = next(iter(flat_paths(layers_params).values())).shape[0]
    for i in range(n):
        c = None if cache is None else _layer(cache, i)
        x = _dense_block(x, _layer(layers_params, i), cfg, positions,
                         prefix_len, cache=c, cache_pos=cache_pos,
                         causal=causal)
    return x


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = params["embed"]["tok"][tokens]
    x = x * torch.tensor(np.sqrt(cfg.d_model).astype(np.float32),
                         device=x.device)
    return shard(x, ("pod", "data"), None, None).to(torch_dtype(cfg.dtype))


def _unembed(cfg: ModelConfig, params: Params, x: torch.Tensor
             ) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = torch.einsum("bsd,dv->bsv", x, head)
    return shard(logits, ("pod", "data"), None, "model")


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Training forward -> logits (B, S, V) over the token stream.

    ``params`` is the nested tree (``_nested(init_params(...))``)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _run_stack(x, params["layers"], cfg, positions)
    return _unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int
                 ) -> Dict[str, Tuple[Tuple, torch.dtype]]:
    """Flat {path: (shape, dtype)} for the decode cache: stacked K and V of
    (layers, batch, slots, kv heads, head_dim), with ``min(max_len,
    window)`` slots (a ring buffer) under a sliding window."""
    _require_dense(cfg)
    dtype = torch_dtype(cfg.dtype)
    kv_len = min(max_len, cfg.window) if cfg.window else max_len
    shape = (cfg.n_layers, batch, kv_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cpu") -> Params:
    """A zeroed decode cache on ``device``."""
    return _nested({p: torch.zeros(s, dtype=d, device=device)
                    for p, (s, d) in cache_shapes(cfg, batch, max_len).items()})


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                cache: Params, pos: int):
    """One decode step: token (B, 1) + cache at position ``pos`` ->
    (logits (B, V), cache). The cache is updated in place."""
    _require_dense(cfg)
    x = _embed(cfg, params, token)
    positions = pos + torch.arange(token.shape[1], device=token.device)
    x = _run_stack(x, params["layers"], cfg, positions, cache=cache,
                   cache_pos=pos)
    return _unembed(cfg, params, x)[:, -1], cache


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Run the prompt, returning (last-token logits (B, V), filled cache).

    The cache is written at positions [0, S); attention over the prompt
    runs through the flash-attention kernel on the card."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    cache = init_cache(cfg, B, max_len, device=x.device)
    x = _run_stack(x, params["layers"], cfg,
                   torch.arange(S, device=tokens.device), cache=cache)
    # unembed the LAST position only: prefill never needs (B, S, V) logits
    return _unembed(cfg, params, x[:, -1:])[:, 0], cache
