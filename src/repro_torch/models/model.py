"""Parameters, initialisation, the forward pass and decoding, every family.

Families (``cfg.family``), as in the reference package's
``repro/models/model.py``:
  dense / moe          decoder-only LM (GQA/MQA/SWA attention, MLP or MoE)
  ssm                  attention-free Mamba2 stack
  hybrid               jamba-style groups of ``attn_period`` sublayers
                       (1 attention + N-1 mamba, alternating MoE/MLP)
  encdec / audio       encoder-decoder; the audio frontend is a stub that
                       feeds precomputed frame embeddings
  vlm                  decoder LM with a visual prefix (patch embeddings)

``param_shapes`` gives the reference's flat ``{path: shape}``, and
``init_params`` draws the same distributions (``_init_one``'s scaling,
and the SSM's deterministic ``A_log``, ``dt_bias``, ``D`` in f32 in every
model dtype) from a ``torch.Generator``. The two packages' random streams
differ, so tests that need equal weights make them with numpy and carry
them across with ``repro_torch.convert``.

The reference's ``lax.scan`` over stacked layer weights becomes a loop
that indexes layer ``i`` of every stacked leaf. ``prefill`` and
``decode_step`` carry the decode cache (``init_cache``) through the same
loop: layer ``i`` writes its slice of the stacked buffers in place (K/V
at the write position, an SSM layer's new state and conv window, an
encoder-decoder's cross K/V at prefill). Prefill self-attention runs
through the flash-attention kernel on the card (windows and a vlm's
prefix included); the encoder and cross-attention run in plain torch, as
the reference computes them. Under autograd each layer runs under
``cfg.remat`` (``_remat``), as the reference's scan body does.

``param_structs`` and ``cache_structs`` give the parameters and the cache
as ``meta`` tensors, the dry run's inputs (``repro_torch.launch``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.tree import leaves
from repro_torch.dist.sharding import shard
from repro_torch.kernels.ref import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention_layer, decode_attention, mlp,
                                       moe, rmsnorm)
from repro_torch.models.ssm import ssm_layer

Params = Dict[str, Any]
_NORM_LEAVES = ("ln1", "ln2", "ln_cross", "final_norm", "enc_final_norm",
                "norm", "q_norm", "k_norm")


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


def _moe_shapes(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Tuple]:
    E = cfg.n_experts
    s = {"router": lead + (cfg.d_model, E),
         "w_in": lead + (E, cfg.d_model, cfg.d_ff),
         "w_out": lead + (E, cfg.d_ff, cfg.d_model)}
    if cfg.mlp_type == "swiglu":
        s["w_gate"] = lead + (E, cfg.d_model, cfg.d_ff)
    if cfg.n_shared_experts:
        s.update(_mlp_shapes(cfg, lead, prefix="shared_w"))
    return s


def _ssm_shapes(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Tuple]:
    N, H = cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = cfg.d_inner + 2 * N
    return {
        "in_proj": lead + (cfg.d_model, 2 * cfg.d_inner + 2 * N + H),
        "conv_w": lead + (cfg.ssm_conv_width, conv_dim),
        "A_log": lead + (H,),
        "dt_bias": lead + (H,),
        "D": lead + (H,),
        "norm": lead + (cfg.d_inner,),
        "out_proj": lead + (cfg.d_inner, cfg.d_model),
    }


def _hybrid_counts(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(groups, mamba, MoE and MLP sublayers per group) of a hybrid."""
    period = cfg.attn_period
    n_moe = sum(1 for j in range(period)
                if (j % cfg.moe_period) == cfg.moe_period - 1)
    return cfg.n_layers // period, period - 1, n_moe, period - n_moe


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Flat {path: shape} for the whole model."""
    L = cfg.n_layers
    shapes: Dict[str, Tuple] = {"embed/tok": (cfg.vocab_size, cfg.d_model)}

    if cfg.family in ("dense", "moe", "vlm"):
        lead = (L,)
        for k, v in _attn_shapes(cfg, lead).items():
            shapes[f"layers/attn/{k}"] = v
        ffn = _moe_shapes(cfg, lead) if cfg.n_experts else _mlp_shapes(cfg, lead)
        kind = "moe" if cfg.n_experts else "mlp"
        for k, v in ffn.items():
            shapes[f"layers/{kind}/{k}"] = v
        shapes["layers/ln1"] = (L, cfg.d_model)
        shapes["layers/ln2"] = (L, cfg.d_model)

    elif cfg.family == "ssm":
        for k, v in _ssm_shapes(cfg, (L,)).items():
            shapes[f"layers/ssm/{k}"] = v
        shapes["layers/ln1"] = (L, cfg.d_model)

    elif cfg.family == "hybrid":
        ng, n_ssm, n_moe, n_mlp = _hybrid_counts(cfg)
        for k, v in _attn_shapes(cfg, (ng,)).items():
            shapes[f"groups/attn/{k}"] = v
        for k, v in _ssm_shapes(cfg, (ng, n_ssm)).items():
            shapes[f"groups/ssm/{k}"] = v
        for k, v in _moe_shapes(cfg, (ng, n_moe)).items():
            shapes[f"groups/moe/{k}"] = v
        for k, v in _mlp_shapes(cfg, (ng, n_mlp)).items():
            shapes[f"groups/mlp/{k}"] = v
        shapes["groups/ln1"] = (ng, cfg.attn_period, cfg.d_model)
        shapes["groups/ln2"] = (ng, cfg.attn_period, cfg.d_model)

    elif cfg.family in ("encdec", "audio"):
        Le = cfg.n_encoder_layers or L
        for k, v in _attn_shapes(cfg, (Le,)).items():
            shapes[f"enc_layers/attn/{k}"] = v
        for k, v in _mlp_shapes(cfg, (Le,)).items():
            shapes[f"enc_layers/mlp/{k}"] = v
        shapes["enc_layers/ln1"] = (Le, cfg.d_model)
        shapes["enc_layers/ln2"] = (Le, cfg.d_model)
        shapes["enc_final_norm"] = (cfg.d_model,)
        for k, v in _attn_shapes(cfg, (L,)).items():
            shapes[f"dec_layers/attn/{k}"] = v
        for k, v in _attn_shapes(cfg, (L,)).items():
            shapes[f"dec_layers/xattn/{k}"] = v
        for k, v in _mlp_shapes(cfg, (L,)).items():
            shapes[f"dec_layers/mlp/{k}"] = v
        shapes["dec_layers/ln1"] = (L, cfg.d_model)
        shapes["dec_layers/ln_cross"] = (L, cfg.d_model)
        shapes["dec_layers/ln2"] = (L, cfg.d_model)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")

    shapes["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


def _init_one(path: str, shape: Tuple, cfg: ModelConfig,
              generator: torch.Generator) -> torch.Tensor:
    dtype = torch_dtype(cfg.dtype)
    dev = generator.device
    last = path.rsplit("/", 1)[-1]
    if last in _NORM_LEAVES:
        return torch.zeros(shape, dtype=dtype, device=dev)  # 1+w convention
    if last == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                        dtype=torch.float32, device=dev)
                         * torch.ones(shape, dtype=torch.float32, device=dev))
    if last == "dt_bias":
        return torch.full(shape, -4.6, dtype=torch.float32,
                          device=dev)  # softplus^-1(0.01)
    if last == "D":
        return torch.ones(shape, dtype=torch.float32, device=dev)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=dev)
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


def param_structs(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors (no allocation): the dry
    run's input. ``A_log``, ``dt_bias`` and ``D`` are float32, everything
    else ``cfg.dtype``, as ``init_params`` makes them."""
    dtype = torch_dtype(cfg.dtype)
    f32 = {"A_log", "dt_bias", "D"}
    return _nested({p: torch.empty(s, dtype=torch.float32
                                   if p.rsplit("/", 1)[-1] in f32 else dtype,
                                   device="meta")
                    for p, s in param_shapes(cfg).items()})


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _dot_without_batch(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy: keep the output of a matrix product with
    no batch dimension (``mm``, ``addmm``, or the ``bmm`` of batch 1 that
    an ``einsum`` against a 2-D weight reaches), recompute the rest; JAX's
    ``checkpoint_dots_with_no_batch_dims``."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` (one layer) under ``cfg.remat`` when autograd records it (grad
    mode on and some input requiring grad):
    ``"none"`` keeps every activation, ``"full"`` keeps the layer's inputs
    and recomputes the rest in the backward pass
    (``torch.utils.checkpoint``), ``"dots"`` also keeps the outputs of the
    products without batch dimensions. It changes memory, never numbers."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}: expected none, "
                         f"full or dots")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    context = {}
    if cfg.remat == "dots":
        context["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dot_without_batch)

    def run(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in leaves(args))):
            return fn(*args)        # nothing to differentiate: no remat
        return checkpoint(fn, *args, use_reentrant=False, **context)
    return run


def _dense_block(x, lp, cfg: ModelConfig, positions, prefix_len,
                 cache=None, cache_pos=0, causal=True):
    """One dense/moe decoder layer (writes its ``cache`` slice in place)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    x = x + attention_layer(h, lp["attn"], cfg, positions=positions,
                            causal=causal, prefix_len=prefix_len,
                            cache=cache, cache_pos=cache_pos)
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        return x + moe(h, lp["moe"], cfg)
    return x + mlp(h, lp["mlp"], cfg)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i``'s weights: index ``i`` of every stacked leaf."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _ssm_step(h, sp, cfg: ModelConfig, state=None, conv=None):
    """``ssm_layer`` on ``h``; with a cache, its new state and conv window
    are written into the slices ``state`` and ``conv`` in place."""
    cache = None if state is None else {"state": state, "conv": conv}
    out, new = ssm_layer(h, sp, cfg, cache=cache)
    if new is not None:
        state.copy_(new["state"])
        conv.copy_(new["conv"])
    return out


def _hybrid_group(x, gp, cfg: ModelConfig, positions, cache=None,
                  cache_pos=0):
    """One jamba group: ``attn_period`` sublayers, each mixer + FFN."""
    i_ssm = i_moe = i_mlp = 0
    for j in range(cfg.attn_period):
        h = rmsnorm(x, gp["ln1"][j], cfg.norm_eps)
        if j == cfg.attn_offset:
            out = attention_layer(h, gp["attn"], cfg, positions=positions,
                                  cache=cache["attn"] if cache else None,
                                  cache_pos=cache_pos)
        else:
            out = _ssm_step(
                h, _layer(gp["ssm"], i_ssm), cfg,
                *((cache["ssm_state"][i_ssm], cache["ssm_conv"][i_ssm])
                  if cache else ()))
            i_ssm += 1
        x = x + out
        h = rmsnorm(x, gp["ln2"][j], cfg.norm_eps)
        if (j % cfg.moe_period) == cfg.moe_period - 1:
            x = x + moe(h, _layer(gp["moe"], i_moe), cfg)
            i_moe += 1
        else:
            x = x + mlp(h, _layer(gp["mlp"], i_mlp), cfg)
            i_mlp += 1
    return x


def _run_stack(x, layers_params, cfg: ModelConfig, positions, *,
               prefix_len: int = 0, causal: bool = True,
               family: Optional[str] = None, cache=None, cache_pos: int = 0,
               xa=None):
    """The reference's scan over stacked layers, as a loop. Layer ``i``
    gets views of ``cache``'s slices ``[i]`` and writes them in place.

    ``family="encdec_dec"`` is a decoder layer of an encoder-decoder: with
    ``xa`` (the encoder's output) its cross-attention computes K/V from
    ``xa`` (and writes them into the cache's ``cross`` buffers when there
    is a cache); without, it reads the cross K/V cached at prefill.
    Each layer runs under ``_remat`` (``cfg.remat``), as the reference's
    scan body does."""
    family = family or cfg.family

    def body(x, lp, c):
        if family == "hybrid":
            x = _hybrid_group(x, lp, cfg, positions, cache=c,
                              cache_pos=cache_pos)
        elif family == "ssm":
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            x = x + _ssm_step(h, lp["ssm"], cfg,
                              *((c["state"], c["conv"]) if c else ()))
        elif family == "encdec_dec":
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            x = x + attention_layer(h, lp["attn"], cfg, positions=positions,
                                    causal=True,
                                    cache=c["self"] if c else None,
                                    cache_pos=cache_pos)
            h = rmsnorm(x, lp["ln_cross"], cfg.norm_eps)
            if xa is None:
                # cross K/V precomputed at prefill: a pure read
                out = _cross_from_cache(h, lp["xattn"], cfg, c["cross"])
            else:
                out, (k, v) = attention_layer(
                    h, lp["xattn"], cfg, positions=positions, xa=xa,
                    causal=False, return_kv=True)
                if c is not None:
                    c["cross"]["k"].copy_(k)
                    c["cross"]["v"].copy_(v)
            x = x + out
            h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            x = x + mlp(h, lp["mlp"], cfg)
        else:  # dense / moe / vlm / encoder
            x = _dense_block(x, lp, cfg, positions, prefix_len, cache=c,
                             cache_pos=cache_pos, causal=causal)
        return x

    body = _remat(body, cfg)
    n = next(iter(flat_paths(layers_params).values())).shape[0]
    for i in range(n):
        x = body(x, _layer(layers_params, i),
                 None if cache is None else _layer(cache, i))
    return x


def _cross_from_cache(x, p, cfg: ModelConfig, cross):
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    q = torch.einsum("bsd,dh->bsh", x, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    out = decode_attention(q, cross["k"], cross["v"], cfg,
                           kv_len=cross["k"].shape[1])
    return torch.einsum("bsh,hd->bsd",
                        out.reshape(B, S, cfg.n_heads * hd).to(x.dtype),
                        p["wo"])


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = params["embed"]["tok"][tokens]
    # a float32 scalar filled on x's device: no host-to-device copy, so a
    # CUDA graph can capture it, and the same product as a copied one (on
    # the card a float32 device operand is rounded to a bf16 x's dtype
    # before the multiply, which a host scalar would not be)
    x = x * torch.full((), float(np.sqrt(cfg.d_model).astype(np.float32)),
                       dtype=torch.float32, device=x.device)
    return shard(x, ("pod", "data"), None, None).to(torch_dtype(cfg.dtype))


def _unembed(cfg: ModelConfig, params: Params, x: torch.Tensor
             ) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = torch.einsum("bsd,dv->bsv", x, head)
    return shard(logits, ("pod", "data"), None, "model")


def _encode(cfg: ModelConfig, params: Params, frames: torch.Tensor
            ) -> torch.Tensor:
    """The encoder stack over precomputed frame embeddings (B, Se, D)."""
    frames = frames.to(torch_dtype(cfg.dtype))
    enc_pos = torch.arange(frames.shape[1], device=frames.device)
    enc = _run_stack(frames, params["enc_layers"], cfg, enc_pos,
                     causal=False, family="dense")
    return rmsnorm(enc, params["enc_final_norm"], cfg.norm_eps)


def _with_prefix(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """A vlm's input stream: the patch embeddings, then the text tokens'."""
    patches = batch["patches"].to(torch_dtype(cfg.dtype))
    tok_x = _embed(cfg, params, batch["tokens"])
    return torch.cat([patches.to(tok_x.device), tok_x], dim=1)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Training forward -> logits (B, S, V) over the decoder token stream.

    ``params`` is the nested tree (``_nested(init_params(...))``); ``batch``
    holds ``tokens``, and ``frames`` (encdec/audio) or ``patches`` (vlm)."""
    tokens = batch["tokens"]
    if cfg.family in ("encdec", "audio"):
        enc = _encode(cfg, params, batch["frames"])
        x = _embed(cfg, params, tokens)
        dec_pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = _run_stack(x, params["dec_layers"], cfg, dec_pos,
                       family="encdec_dec", xa=enc)
        return _unembed(cfg, params, x)

    if cfg.family == "vlm":
        x = _with_prefix(cfg, params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x = _run_stack(x, params["layers"], cfg, positions,
                       prefix_len=cfg.n_prefix_tokens, family="dense")
        return _unembed(cfg, params, x[:, cfg.n_prefix_tokens:])

    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    key = "groups" if cfg.family == "hybrid" else "layers"
    x = _run_stack(x, params[key], cfg, positions)
    return _unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# KV / state caches + decode
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 enc_len: int = 0) -> Dict[str, Tuple[Tuple, torch.dtype]]:
    """Flat {path: (shape, dtype)} for the decode cache: stacked K and V of
    (layers, batch, slots, kv heads, head_dim), with ``min(max_len,
    window)`` slots (a ring buffer) under a sliding window; an SSM's f32
    state (layers, batch, H, N, P) and conv window; a hybrid's per group;
    an encoder-decoder's self K/V and ``enc_len`` cross K/V."""
    dtype = torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    kv_len = min(max_len, cfg.window) if cfg.window else max_len
    out: Dict[str, Tuple[Tuple, torch.dtype]] = {}
    L = cfg.n_layers
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * N

    if cfg.family in ("dense", "moe", "vlm"):
        out["k"] = ((L, batch, kv_len, cfg.n_kv_heads, hd), dtype)
        out["v"] = ((L, batch, kv_len, cfg.n_kv_heads, hd), dtype)
    elif cfg.family == "ssm":
        out["state"] = ((L, batch, H, N, P), torch.float32)
        out["conv"] = ((L, batch, cfg.ssm_conv_width - 1, conv_dim), dtype)
    elif cfg.family == "hybrid":
        ng, n_ssm, _, _ = _hybrid_counts(cfg)
        out["attn/k"] = ((ng, batch, kv_len, cfg.n_kv_heads, hd), dtype)
        out["attn/v"] = ((ng, batch, kv_len, cfg.n_kv_heads, hd), dtype)
        out["ssm_state"] = ((ng, n_ssm, batch, H, N, P), torch.float32)
        out["ssm_conv"] = ((ng, n_ssm, batch, cfg.ssm_conv_width - 1,
                            conv_dim), dtype)
    elif cfg.family in ("encdec", "audio"):
        out["self/k"] = ((L, batch, kv_len, cfg.n_kv_heads, hd), dtype)
        out["self/v"] = ((L, batch, kv_len, cfg.n_kv_heads, hd), dtype)
        out["cross/k"] = ((L, batch, enc_len, cfg.n_kv_heads, hd), dtype)
        out["cross/v"] = ((L, batch, enc_len, cfg.n_kv_heads, hd), dtype)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device="cpu") -> Params:
    """A zeroed decode cache on ``device``."""
    return _nested({p: torch.zeros(s, dtype=d, device=device)
                    for p, (s, d) in cache_shapes(cfg, batch, max_len,
                                                  enc_len).items()})


def cache_structs(cfg: ModelConfig, batch: int, max_len: int,
                  enc_len: int = 0) -> Params:
    """The decode cache as ``meta`` tensors (no allocation)."""
    return init_cache(cfg, batch, max_len, enc_len, device="meta")


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                cache: Params, pos: int):
    """One decode step: token (B, 1) + cache at position ``pos`` ->
    (logits (B, V), cache). The cache is updated in place.

    Works for every family; encoder-decoder models read the cross K/V
    cached at prefill (the encoder runs once, at prefill). A vlm's text
    token ``t`` sits at position ``n_prefix_tokens + t``."""
    x = _embed(cfg, params, token)
    positions = pos + torch.arange(token.shape[1], device=token.device)
    if cfg.family in ("encdec", "audio"):
        x = _run_stack(x, params["dec_layers"], cfg, positions,
                       family="encdec_dec", cache=cache, cache_pos=pos)
    else:
        key = "groups" if cfg.family == "hybrid" else "layers"
        x = _run_stack(x, params[key], cfg, positions, cache=cache,
                       cache_pos=pos)
    return _unembed(cfg, params, x)[:, -1], cache


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Run the prompt, returning (last-token logits (B, V), filled cache).

    The cache is written at positions [0, S) (a vlm's at [0, prefix + S),
    its cache holding ``max_len + n_prefix_tokens`` slots); self-attention
    over the prompt runs through the flash-attention kernel on the card."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if cfg.family in ("encdec", "audio"):
        enc = _encode(cfg, params, batch["frames"])
        x = _embed(cfg, params, tokens)
        cache = init_cache(cfg, B, max_len, enc_len=enc.shape[1],
                           device=x.device)
        x = _run_stack(x, params["dec_layers"], cfg,
                       torch.arange(S, device=tokens.device),
                       family="encdec_dec", cache=cache, xa=enc)
        # unembed the LAST position only: prefill never needs (B, S, V) logits
        return _unembed(cfg, params, x[:, -1:])[:, 0], cache

    prefix = 0
    if cfg.family == "vlm":  # the visual prefix precedes the text prompt
        x = _with_prefix(cfg, params, batch)
        prefix = cfg.n_prefix_tokens
        S = S + prefix
    else:
        x = _embed(cfg, params, tokens)
    cache = init_cache(cfg, B, max_len + prefix, device=x.device)
    key = "groups" if cfg.family == "hybrid" else "layers"
    x = _run_stack(x, params[key], cfg, torch.arange(S, device=x.device),
                   prefix_len=prefix, cache=cache)
    return _unembed(cfg, params, x[:, -1:])[:, 0], cache
