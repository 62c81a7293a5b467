"""Frozen peaks and the operations and bytes of each measured kernel and step.

Copies, frozen here so that a later change to the program cannot move the
yardstick:

* flash attention: ``repro_torch/kernels/flash_attention.py``'s
  ``visible_pairs`` and ``roofline`` (4 * hd operations per visible
  (query, key) pair; q, k, v read once and the result written once; f32 as
  three TF32 passes);
* the storage kernels: each input read once and each output written once,
  at the width the kernel is given (PERF.md's kernel table);
* the model step: the operations the real tokens need (each family's
  own in ``families/<family>.py``).

Peaks are NVIDIA's data sheet for one H100 SXM, dense, at 700 W.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                  "float16": 989e12}
TF32_PASSES = 3
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "int8": 1}


# -- flash attention ---------------------------------------------------------

def visible_pairs(Sq: int, Skv: int, *, causal: bool = True, window: int = 0,
                  prefix_len: int = 0) -> int:
    """(query, key) pairs the mask leaves visible, row by row."""
    i = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    if causal:
        hi = np.maximum(np.minimum(i, Skv - 1), min(prefix_len, Skv) - 1)
    else:
        hi = np.full_like(i, Skv - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_ops(B: int, Hq: int, Sq: int, Skv: int, hd: int, *,
              causal: bool = True, window: int = 0, prefix_len: int = 0
              ) -> int:
    return 4 * B * Hq * hd * visible_pairs(Sq, Skv, causal=causal,
                                           window=window,
                                           prefix_len=prefix_len)


def flash_bound_s(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, hd: int,
                  dtype: str, *, causal: bool = True, window: int = 0,
                  prefix_len: int = 0) -> float:
    """The least seconds one H100 could take for one flash call."""
    ops = flash_ops(B, Hq, Sq, Skv, hd, causal=causal, window=window,
                    prefix_len=prefix_len)
    if dtype in ("bfloat16", "float16"):
        ops_s = ops / PEAK_OPS_PER_S[dtype]
    elif dtype == "float32":
        ops_s = TF32_PASSES * ops / PEAK_OPS_PER_S["tf32"]
    else:
        raise TypeError(f"no bound for {dtype}")
    bytes_s = ((2 * B * Hq * Sq + 2 * B * Hkv * Skv) * hd * ITEMSIZE[dtype]
               / HBM_BYTES_PER_S)
    return max(bytes_s, ops_s)


# -- storage kernels (bytes per element; each operand once) -----------------

def snapshot_fused_bytes(n: int) -> int:
    """f32 p1 and p2 read, int8 q written."""
    return n * (4 + 4 + 1)


def delta_quantize_bytes(n: int, p1: str, p2: str) -> int:
    """p1 and p2 at their widths read, int32 q written."""
    return n * (ITEMSIZE[p1] + ITEMSIZE[p2] + 4)


def dequant_apply_bytes(n: int, p1: str, out: str) -> int:
    """p1 and int32 q read, the result written at its width."""
    return n * (ITEMSIZE[p1] + 4 + ITEMSIZE[out])


def chain_apply_bytes(n: int, k: int) -> int:
    """f32 base and k int32 deltas read, the f32 result written."""
    return n * (4 + 4 * k + 4)


def bytes_bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


# -- the model step: operations the real tokens need -----------------------

def sequence_ops(m: dict, prompt: int, generated: int) -> int:
    """Operations one sequence needs: ``prompt`` real tokens, then
    ``generated`` tokens of which the first comes from the prompt's last
    position (``prompt + generated - 1`` tokens pass through the stack),
    and the output head at each of the ``generated`` positions. The
    stack's share is its family's (``families/<family>.py``:
    ``token_ops``, ``context_ops``)."""
    from mgitbench.families import family
    fam = family(m)
    tokens = prompt + generated - 1
    head = 2 * m["d_model"] * m["vocab_size"] * generated
    return fam.token_ops(m) * tokens + fam.context_ops(m, tokens) + head
