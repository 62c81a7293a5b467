"""Delta compression between related models (paper §4, Algorithm 1).

Parent and child need not share an architecture: an LCS over the two models'
parameter sequences (in layer-graph topological order, items equal iff
shape+dtype match) yields the parameter mapping; matched pairs are quantized
(`repro_torch.kernels.ops.snapshot_fused`, the CUDA-kernel hot path) and
losslessly compressed. Compression is *accepted* only if it actually saves
bytes AND, when tests are registered, the reconstructed model's scores stay
within ``t_thr`` of the original — otherwise the uncompressed tensor is kept.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import bf16
from repro_torch.core.artifact import ModelArtifact
from repro_torch.kernels import ops
from repro_torch.kernels.ref import quant_scale, torch_dtype
from repro_torch.store.codecs import get_codec


# ---------------------------------------------------------------------------
# LCS parameter matching
# ---------------------------------------------------------------------------

def _signature(arr: np.ndarray) -> Tuple:
    return (tuple(np.shape(arr)), bf16.dtype_name(np.asarray(arr)))


def _signature_of(artifact: ModelArtifact, key: str) -> Tuple:
    """(shape, dtype) signature WITHOUT materializing lazy parameters."""
    params = artifact.params
    spec_of = getattr(params, "spec_of", None)
    if spec_of is not None:
        shape, dtype = spec_of(key)
        return (tuple(shape), bf16.dtype_name(dtype))
    return _signature(params[key])


def _ordered_keys(artifact: ModelArtifact) -> List[str]:
    """Param keys in layer-graph topological order (fallback: dict order)."""
    try:
        keys = [f"{l}/{p}" for (l, p) in artifact.graph.param_names()]
        missing = [k for k in artifact.params if k not in set(keys)]
        return [k for k in keys if k in artifact.params] + missing
    except Exception:
        return list(artifact.params)


def lcs_param_matching(parent: ModelArtifact, child: ModelArtifact
                       ) -> List[Tuple[str, str]]:
    """Longest common subsequence over (shape, dtype) signatures.

    Returns [(parent_key, child_key), ...]. For identical architectures this
    reduces to position-wise matching of corresponding layers (paper §4).
    """
    pk = _ordered_keys(parent)
    ck = _ordered_keys(child)
    ps = [_signature_of(parent, k) for k in pk]
    cs = [_signature_of(child, k) for k in ck]
    if ps == cs:  # common fast path: same architecture
        return list(zip(pk, ck))

    # integer-encode signatures, then numpy row-DP (O(n*m) cells)
    vocab: Dict[Tuple, int] = {}
    for s in ps + cs:
        vocab.setdefault(s, len(vocab))
    a = np.array([vocab[s] for s in ps], dtype=np.int32)
    b = np.array([vocab[s] for s in cs], dtype=np.int32)
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    for i in range(1, n + 1):
        match = (b == a[i - 1])
        take = dp[i - 1, :-1] + match
        dp[i, 1:] = np.maximum(dp[i - 1, 1:], take)
        np.maximum.accumulate(dp[i], out=dp[i])
    # backtrack
    pairs: List[Tuple[str, str]] = []
    i, j = n, m
    while i > 0 and j > 0:
        if a[i - 1] == b[j - 1] and dp[i, j] == dp[i - 1, j - 1] + 1:
            pairs.append((pk[i - 1], ck[j - 1]))
            i -= 1
            j -= 1
        elif dp[i - 1, j] >= dp[i, j - 1]:
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    return pairs


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParamDelta:
    child_key: str
    parent_key: str
    blob: bytes
    codec: str
    eps: float
    shape: Tuple[int, ...]
    dtype: str
    raw_bytes: int          # uncompressed child tensor size
    qdtype: str = "int32"   # int8 when the fused kernel narrowed (§Perf-C)

    @property
    def saving(self) -> float:
        return self.raw_bytes / max(len(self.blob), 1)


@dataclasses.dataclass
class CompressResult:
    accepted: bool
    deltas: Dict[str, ParamDelta]          # child_key -> delta (accepted only)
    reconstructed: ModelArtifact           # m2' (== m2 when nothing accepted)
    test_deltas: Dict[str, float]
    raw_bytes: int
    compressed_bytes: int
    # content hashes of reconstructed delta params, precomputed on the
    # pipeline's worker threads (commit reuses them instead of re-hashing)
    param_hashes: Dict[str, str] = dataclasses.field(default_factory=dict)
    # open-segment fold states of the reconstructed params (opaque to this
    # module; the store installs them in its FoldCache at commit so the
    # NEXT commit's parent materialization is pure cache hits)
    fold_states: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(self.compressed_bytes, 1)


def delta_compression(m2: ModelArtifact, m1: ModelArtifact,
                      t_thr: float = 0.5, eps: float = 1e-4,
                      codec: str = "lzma", tests: Sequence = (),
                      per_param: bool = True,
                      zero_frac_prefilter: float = 0.0,
                      backend: Optional[str] = None) -> CompressResult:
    """Paper Algorithm 1 — compress m1 - m2 (m1 parent, m2 child).

    ``per_param=True`` accepts/rejects each tensor independently (beyond-paper
    refinement); ``False`` reproduces the paper's whole-model accept/reject.
    ``zero_frac_prefilter``: skip host compression when the on-device zero
    fraction predicts a ratio <= 1 (DESIGN.md §3 pre-filter).
    """
    cod = get_codec(codec)
    pairs = lcs_param_matching(m1, m2)
    candidates: Dict[str, ParamDelta] = {}
    recon_params: Dict[str, np.ndarray] = {}

    for pkey, ckey in pairs:
        p1 = np.asarray(m1.params[pkey])
        p2 = np.asarray(m2.params[ckey])
        if p1.size == 0:
            continue
        # fused snapshot pass: quantized delta (int8-narrowed when it fits)
        # + zero stats, one HBM read of each input (§Perf-C); the
        # fingerprint is never read here, so it is not computed
        q, nz, _fp, _narrow = ops.snapshot_fused(p1, p2, eps=eps,
                                                 backend=backend,
                                                 with_fingerprint=False)
        q = np.asarray(q)
        zero_frac = nz / q.size
        if zero_frac < zero_frac_prefilter:
            continue  # on-device pre-filter says "won't compress" — skip host work
        blob = cod.encode(q)
        delta = ParamDelta(child_key=ckey, parent_key=pkey, blob=blob,
                           codec=codec, eps=eps, shape=tuple(p2.shape),
                           dtype=bf16.dtype_name(p2), raw_bytes=int(p2.nbytes),
                           qdtype=str(q.dtype))
        if per_param and len(blob) >= p2.nbytes:
            continue  # no saving for this tensor
        candidates[ckey] = delta
        recon = np.asarray(ops.dequant_apply(p1, q, eps=eps, backend=backend,
                                             out_dtype=p2.dtype))
        recon_params[ckey] = recon.reshape(p2.shape)

    total_raw = m2.nbytes()
    delta_raw = sum(d.raw_bytes for d in candidates.values())
    delta_compressed = sum(len(d.blob) for d in candidates.values())
    storage_saving = delta_raw / max(delta_compressed, 1)

    if not candidates or (not per_param and storage_saving < 1.0):
        return CompressResult(False, {}, m2, {}, total_raw, total_raw)

    # m2' = m2 with the compressed params replaced by their reconstructions
    m2_prime = m2.replace_params(recon_params)

    test_deltas: Dict[str, float] = {}
    for t in tests:
        before = float(t.fn(m2))
        after = float(t.fn(m2_prime))
        test_deltas[t.name] = after - before
        if abs(after - before) > t_thr:
            # accuracy drop beyond threshold — reject compression entirely
            return CompressResult(False, {}, m2, test_deltas, total_raw, total_raw)

    compressed_total = (total_raw - delta_raw) + delta_compressed
    return CompressResult(True, candidates, m2_prime, test_deltas,
                          total_raw, compressed_total)


def host_snapshot(p1: np.ndarray, p2: np.ndarray, eps: float
                  ) -> Tuple[np.ndarray, int, bool]:
    """Numpy twin of ``ops.snapshot_fused`` (sans fingerprint).

    Returns ``(q int8|int32, n_zero, narrow)``, bit-identical to the plain
    torch version and the CUDA kernel (all compute
    ``floor(f32(p1-p2)/f32(scale) + 0.5)`` with correctly-rounded f32 ops)
    but with zero dispatch overhead. The commit pipeline uses it on the
    ``"ref"`` backend, and the chunk engine always does. Operands of any
    float dtype (the bf16 carrier included) are widened to f32 exactly."""
    scale = np.float32(quant_scale(eps))
    d = bf16.widen(p1) - bf16.widen(p2)
    q32 = np.floor(d / scale + np.float32(0.5)).astype(np.int32)
    nz = int((q32 == 0).sum())
    q8 = np.clip(q32, -127, 127)
    if bool((q32 == q8).all()):
        return q8.astype(np.int8), nz, True
    return q32, nz, False


def host_dequant(parent_value: np.ndarray, q: np.ndarray, eps: float,
                 out_dtype=None) -> np.ndarray:
    """Host-side dequant-apply: ``p2' = f32(p1) - f32(q) * f32(scale)``.

    Bit-identical to ``ops.dequant_apply`` on either backend — an f32
    multiply and an f32 subtract, each correctly rounded, per element —
    but with zero dispatch overhead, which is what the checkout/commit hot
    loops need on the ``"ref"`` backend. The parent may be the bf16
    carrier (widened exactly). A bf16 ``out_dtype`` rounds to the carrier
    in numpy (``bf16.narrow``, as the kernel rounds); other non-f32
    ``out_dtype`` casts go through torch, so they round as the device path
    does."""
    scale = np.float32(quant_scale(eps))
    out = bf16.widen(parent_value) - np.asarray(q, dtype=np.float32) * scale
    dt = torch_dtype(out_dtype if out_dtype is not None else "float32")
    if dt == torch.float32:
        return out
    if dt == torch.bfloat16:
        return bf16.narrow(out)
    return ops.to_host(torch.from_numpy(out).to(dt))


def decode_q(delta_or_entry, blob) -> np.ndarray:
    """Decode one delta blob to its quantized array (reshaped).

    The stored dtype (int8 when the fused kernel narrowed) is preserved —
    int8→f32 and int8→int32-accum conversions are exact, so downstream
    dequant/fold never needs the 4x-larger int32 copy. ``blob`` may be any
    buffer (bytes or a zero-copy CAS view)."""
    codec = delta_or_entry.codec
    shape = tuple(delta_or_entry.shape)
    qdtype = getattr(delta_or_entry, "qdtype", "int32")
    n = int(np.prod(shape)) if shape else 1
    return get_codec(codec).decode(blob, n, dtype=qdtype).reshape(shape)


def decompress_param(parent_value: np.ndarray, delta: ParamDelta,
                     backend: Optional[str] = None) -> np.ndarray:
    """Invert one ParamDelta given the materialized parent tensor.

    ``backend=None`` means the card (``ops.default_backend()``); ``"ref"``
    runs the numpy twin."""
    q = decode_q(delta, delta.blob)
    backend = backend or ops.default_backend()
    if backend == "ref":
        return host_dequant(parent_value, q, eps=delta.eps,
                            out_dtype=delta.dtype).reshape(delta.shape)
    out = ops.dequant_apply(np.asarray(parent_value), q, eps=delta.eps,
                            backend=backend, out_dtype=delta.dtype)
    return np.asarray(out).reshape(delta.shape)
