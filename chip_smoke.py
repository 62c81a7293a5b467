#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it puts ``src`` on ``sys.path`` itself and
imports nothing of JAX or of the reference package. Phases, each of which
exits non-zero on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels with nvcc and prints the seconds;
   prints each flash-attention instantiation's ptxas report (registers,
   spills) and the tensor-core instructions in its SASS (``cuobjdump
   -sass``: HGMMA, or HMMA for an mma.sync f32 path), and fails when one
   of the nine (f32, bf16, f16 x head dim 64, 128, 256) has none or
   ``cuobjdump`` is missing;
3. kernels: runs each storage kernel's wrapper at the main path's shapes,
   at ragged shapes and with an overflowing delta, and holds it bit for
   bit against its plain torch version on the same card inputs and
   against the numpy twin on the host; holds the flash-attention kernel
   within 2e-5 (f32), 3e-2 (bf16) and 1e-2 (f16) of its plain version
   over the reference test's five mask specs, a prefix-LM prefix past a
   query tile, ragged lengths, the serving prefills' shapes (paper-bert's,
   and qwen3-0.6b's of phase 4d), the qwen3-0.6b geometry at 4096 tokens,
   a head dim the wrapper pads, a window that masks a row's whole first
   key tile, and at head dim 256 paligemma-3b's prefill of phase 8
   (8, 8 q / 1 kv, 768, 256) with a 256-token prefix, a prefix past a
   query tile, a window, no mask and a padded head dim 200; holds
   delta_quantize and dequant_apply with float16 operands and results
   (main-path, ragged and overflowing cases) and with bfloat16 ones
   (qwen3-0.6b's (151936, 1024) and (28, 1024, 3072) leaves, ragged,
   overflowing, mixed and rounding-edge cases) bit for bit against the
   plain versions and the numpy twins (bf16 on the host as the carrier of
   ``repro_torch/common/bf16.py``), and ``ops.delta_quantize``'s per-tile
   zero counts against a numpy count of the reference's tiling; times each
   kernel (and its float16 and bfloat16 variants) and its plain version,
   and flash attention in f32, bf16 and f16 (device time per call, and
   eager) beside ``scaled_dot_product_attention``, which the port never
   calls, at the serving shapes (paper-bert's and qwen3-0.6b's) and the
   qwen3-0.6b geometry at 4096 tokens, and at paligemma-3b's prefill
   beside SDPA with the prefix-LM mask as an explicit boolean mask (on
   the first SDPA backend that takes it, named in the output);
4. main path: commits a full-width paper-bert (f32, random weights from a
   seed) lineage base -> ft1 -> ft2 -> ft3 plus task-head (a child of ft1
   with a re-initialised lm_head) through ``ArtifactStore(chunk_threshold=
   0)`` on the card, reopens the repository, checks out ft3 and task-head,
   and requires every checked-out tensor to match its manifest hash, a
   host (``backend="ref"``) checkout of the same repository, and the live
   weights within the quantization bound, a clean ``fsck``, and at least
   one launch of every kernel in that run;
4b. serving, on phase 4's repository: ``ModelPool`` builds the ft3 and
   task-head views on the card (``verify=True``; multi-hop segments
   through the chain_apply kernel); ``ServeApp`` over a ``Router`` answers
   HTTP requests whose probes must equal host-built views' bit for bit,
   and its ``LineageWatcher`` hot-swaps ``prod`` to a newly published
   finetune with no failed request; ``ServeEngine`` runs prefill (through
   the flash kernel) and greedy decode of ft3 at full width on a batch of
   8 x 512-token prompts and a ragged batch; two rows are held against
   the port's engine on the host (prefill logits within 1e-3, greedy
   tokens equal except after a near tie);
4c. float16: base -> ft1 -> ft2 plus task-head, every tensor float16, is
   committed and checked out through the card's store; its manifest refs
   and checkouts must equal a host (``backend="ref"``) store's, and a
   dequant_apply launch must take a float16 operand; ``ServeEngine``
   prefills 8 x 512 prompts on the ft2 pool view in float16 (the f16
   flash kernel), two rows held against the host engine on the same
   weights in f32;
4d. bfloat16: a lineage of full-width qwen3-0.6b (28 layers, vocab
   151,936, 596 M parameters) in its own dtype, random weights from the
   seed, base -> ft1 -> ft2 (noise drawn in f32 and narrowed) plus
   task-head (ft1 with the last layer of layers/mlp/w_out re-drawn: an
   int8-overflowing delta), committed and checked out through the card's
   store (bf16 delta_quantize and dequant_apply), hash-exact, within the
   quantization step of the live weights, fsck clean; the lineage cut to
   layers 0, 1, 2 and 27 (``BF16_CUT_LAYERS``, embed/tok left out: cut for
   time) committed through a card store and a host store with refs and
   bits equal, and equal to the whole checkout's layers; a ModelPool view
   of ft2 on the card equal to the checkout;
   ``ServeEngine`` on it (8 x 512 prompts, 32 new tokens, bf16 flash),
   two rows held against the host engine in bf16: prefill logits and,
   with the card fed the host's tokens, each of the 31 decode steps'
   logits within 3e-2, greedy tokens equal except after a near tie. It
   fails unless bf16
   delta_quantize, dequant_apply and flash attention each launched;
8. a vlm lineage: paligemma-3b in bf16 at full width (d_model 2048, 8 q /
   1 kv heads of 256, vocab 257,216, a 256-token visual prefix) cut to
   ``VLM_LAYERS`` (2) of its 18 layers, random weights from the seed,
   base -> ft1 -> ft2, committed and checked out (ft2) through the card's
   store, hash-exact, fsck clean (no host store: cut for time); a
   ModelPool view of ft2 equal to the
   checkout, whose ``probe`` equals the probe over the widened weights;
   ``ServeEngine`` on it: 8 prompts of 256 patch embeddings + 512 tokens
   (the flash kernel at head dim 256 with ``prefix_len=256``, one launch
   per layer and prefill) and 16 greedy tokens, two rows held against the
   host engine in f32 (prefill logits, then each decode step's, the card
   fed the host's tokens) within 3e-2 of the logits' magnitude;
9. the other families' serving at full width where one card holds them,
   random weights drawn on the card, bf16: mixtral-8x7b (1 of 32 layers),
   mamba2-780m and seamless-m4t-large-v2 (all layers; frames 128 x
   1024), and jamba-1.5-large-398b at the reference's ``reduced()`` shape
   (one group of its 45 B parameters does not fit the card);
   ``ServeEngine`` prefill of 8 x 128 and 8 greedy tokens each, held
   against the host engine in f32 on the same weights within 3e-2 of the
   logits' magnitude (mamba2, whose bf16 rounding drifts past that:
   within twice the host's own bf16 drift, and once more in f32 on the
   card within 1e-3; ``FAMILY_RUNS``): two rows, or an
   MoE's whole batch (capacity couples
   the rows), whose routing on card and host is compared call by call; a
   pick that differs must be at a near tie (``NEAR_TIE``), and logits are
   held on the rows whose routing agrees everywhere;
5. the same lineage with the default chunk threshold, whose large tensors
   take the host chunk engine, cut to its first ``PHASE5_LAYERS`` layers
   (host work, no kernel): bit-identical checkouts and a clean fsck;
6. continuous checkpointing: ``Trainer`` trains full-width paper-bert (f32,
   batch 8, sequence 128; ``CHECKPOINT_LAYERS`` of its 12 layers) on the
   card with its default exact-tier
   ``CheckpointManager`` committing every 2 steps: 6 steps in runs of 2
   (each waits for its commit: 3 commits), then one ``run(6)``, whose
   saves come faster than the commits, so at least one coalesces. It
   saves the unchanged state once more (every leaf of 64 KiB or more must
   be skipped by its fingerprint) and restores the last commit bit for
   bit onto the card in a fresh manager (``verify=True``, clean fsck).
   Then it runs the lossy tier (keyframe every 2 commits) through a store
   with the chunk engine off, and restores a lossy step within each
   leaf's quantization step of the live state. The fingerprint kernel
   must launch once per large leaf per save, and dequant_apply in the
   lossy commits;
7. the paper's update workflow (Figure 4, Algorithm 2): full-width
   paper-bert versions (``WORKFLOW_LAYERS`` of its 12 layers) made by the
   port's train step on the card (base;
   task-a and task-b under it; task-a-sub under task-a) in one
   ``LineageGraph`` over a ``chunk_threshold=0`` store, each node tested
   by a probe scored from ``models.prefill`` (flash kernel); a gated
   ``run_update_cascade`` from base to base@v2 must create the three @v2
   nodes, quarantine exactly the poisoned task-b@v2 on a metric drop, carry
   no error in any result and replay with 0 executions; a second cascade
   whose creation function raises must leave no empty node; ``auto_insert``
   must place a further finetune of task-b@v2 under it; two disjoint edits
   of base must merge to their picks bit for bit, two overlapping ones
   conflict, and ``module_diff`` must agree on card and host checkouts;
   every new node checks out hash-exact and equal to the host's, with a
   clean fsck over the models and the test ledger.

Phases 4, 4b, 4c, 4d, 8, 9, 6 and 7 (in that order) each zero every
kernel's launch count (and its count by operand dtype) just before they
drive their path and read it just after. The line before last is one
JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
EPS = 1e-4
SRC = "src/repro_torch/kernels/csrc"
NODES = ("base", "ft1", "ft2", "ft3", "task-head")
CHECKOUT = ("ft3", "task-head")
# depths of the host-bound paths, cut to keep the script inside its time
# limit: phase 5 (the host chunk engine) and phase 6 (whose first exact
# commit is a host cut search over the whole train state); both cut once
# more when phases 8 and 9 came
PHASE5_LAYERS = 1
CHECKPOINT_LAYERS = 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: what the flash kernel compiled to
# ---------------------------------------------------------------------------

def cuobjdump(build) -> str:
    """The toolkit's cuobjdump (beside nvcc), else Triton's copy."""
    import importlib.util
    found = shutil.which("cuobjdump")
    if found:
        return found
    beside = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if os.path.exists(beside):
        return beside
    spec = importlib.util.find_spec("triton")
    for root in (spec.submodule_search_locations or []) if spec else []:
        path = os.path.join(root, "backends", "nvidia", "bin", "cuobjdump")
        if os.path.exists(path):
            return path
    fail("cuobjdump not found (CUDA toolkit or Triton's backend)")


def instantiation(symbol: str) -> str:
    """'bf16 hd128' for a mangled flash_kernel<T, HD> symbol."""
    import re
    dtype = ("bf16" if "bfloat16" in symbol
             else "f16" if "__half" in symbol else "f32")
    hd = re.search(r"Li(\d+)E", symbol)
    return f"{dtype} hd{hd.group(1) if hd else '?'}"


def tensor_core_report(build, log: str) -> None:
    """Print each flash_kernel instantiation's ptxas report and the count
    of tensor-core instructions in its SASS; fail when one has none."""
    reports, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
            reports[current] = []
        elif current and ("Used" in line or "spill" in line
                          or "warning" in line.lower()):
            reports[current].append(line.strip())
    for symbol, lines in reports.items():
        print(f"ptxas flash_attention {instantiation(symbol)}: "
              f"{' | '.join(lines)}", flush=True)
    sass = subprocess.run(
        [cuobjdump(build), "-sass",
         str(build.library_path("flash_attention"))],
        capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump exited {sass.returncode}: {sass.stderr.strip()}")
    counts, current = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            counts[current] = {"HGMMA": 0, "HMMA": 0}
        elif current:
            for op in ("HGMMA", "HMMA"):
                counts[current][op] += f" {op}." in line or f" {op} " in line
    kernels = {instantiation(k): v for k, v in counts.items()
               if "flash_kernel" in k}
    print(f"sass flash_attention tensor-core instructions: "
          f"{json.dumps(kernels, sort_keys=True)}", flush=True)
    if len(kernels) != 9:
        fail(f"expected 9 flash_kernel instantiations, found {sorted(kernels)}")
    for label, n in kernels.items():
        need = ("HGMMA",) if label.startswith(("bf16", "f16")) \
            else ("HGMMA", "HMMA")
        if not any(n[op] for op in need):
            fail(f"flash_kernel {label} has no {' or '.join(need)} in its SASS")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, warm."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b) -> float:
    """Largest |a - b|; an inf or NaN at the same place in both counts as
    no error (``same_bits`` checks the bits), anywhere else as inf."""
    import torch
    if a.numel() == 0:
        return 0.0
    a, b = a.double(), b.double()
    d = (a - b).abs()
    d[(a == b) | (torch.isnan(a) & torch.isnan(b))] = 0.0
    d[torch.isnan(d)] = math.inf
    return float(d.max())


def same_bits(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype in (torch.float16, torch.bfloat16):
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def kernel_cases(gen):
    """(label, p1, p2) f32 pairs on the card: the main path's shapes with a
    finetune-sized delta, ragged shapes, and an overflowing delta."""
    import torch

    def pair(shape, scale):
        p2 = torch.randn(shape, generator=gen, device="cuda") * 0.036
        noise = torch.randn(shape, generator=gen, device="cuda") * scale
        keep = torch.rand(shape, generator=gen, device="cuda") < 0.3
        return p2 + noise * keep, p2

    out = []
    for shape in ((12, 768, 3072), (30522, 768), (257, 33), (1,)):
        out.append((f"{shape} finetune", *pair(shape, 1e-4)))
    out.append(("(768, 30522) overflow", *pair((768, 30522), 0.05)))
    out.append(("(257, 33) overflow", *pair((257, 33), 0.05)))
    return out


def check_kernels(gen):
    """Hold every kernel against its plain version and its numpy twin.

    Returns {kernel: largest |kernel - plain or twin| over all cases}."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.chain_apply import chain_apply_flat
    from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                    dequant_apply_flat)
    from repro_torch.kernels.snapshot_fused import snapshot_fused_flat
    from repro_torch.store.delta import host_dequant, host_snapshot

    scale = np.float32(ref.quant_scale(EPS))
    errs = {k: 0.0 for k in ("snapshot_fused", "delta_quantize",
                             "dequant_apply", "chain_apply")}
    bad = []

    def hold(kernel, label, got, plain, twin):
        errs[kernel] = max(errs[kernel], max_abs(got, plain),
                           max_abs(got.cpu(), twin))
        if not same_bits(got, plain):
            bad.append(f"{kernel} {label}: differs from its plain version")
        if not same_bits(got.cpu(), twin):
            bad.append(f"{kernel} {label}: differs from the numpy twin")
    hold.bad = bad

    for label, p1, p2 in kernel_cases(gen):
        h1, h2 = p1.cpu().numpy(), p2.cpu().numpy()
        q32_np = np.floor((h1 - h2) / scale + np.float32(0.5)).astype(np.int32)
        q8, zeros, ovf = snapshot_fused_flat(p1, p2, EPS)
        q8_p, zeros_p, ovf_p = ref.snapshot_fused_ref(p1, p2, EPS)
        hold("snapshot_fused", label, q8, q8_p,
             torch.from_numpy(np.clip(q32_np, -127, 127).astype(np.int8)))
        counts = (int(zeros), int(ovf))
        twin_counts = (int((q32_np == 0).sum()),
                       int((np.abs(q32_np) > 127).sum()))
        if counts != (int(zeros_p), int(ovf_p)) or counts != twin_counts:
            bad.append(f"snapshot_fused {label}: counts {counts} vs plain "
                       f"{(int(zeros_p), int(ovf_p))} vs twin {twin_counts}")
        _, tnz, narrow = host_snapshot(h1, h2, EPS)
        if narrow != (counts[1] == 0) or tnz != counts[0]:
            bad.append(f"snapshot_fused {label}: host_snapshot disagrees")
        if "overflow" in label and counts[1] == 0:
            bad.append(f"{label}: the delta did not overflow int8")

        q, nz = delta_quantize_flat(p1, p2, EPS)
        q_p, nz_p = ref.delta_quantize_ref(p1, p2, EPS)
        hold("delta_quantize", label, q, q_p, torch.from_numpy(q32_np))
        if int(nz) != int(nz_p) or int(nz) != twin_counts[0]:
            bad.append(f"delta_quantize {label}: zero count {int(nz)} vs "
                       f"{int(nz_p)} vs {twin_counts[0]}")

        out = dequant_apply_flat(p1, q, EPS)
        out_p = ref.dequant_apply_ref(p1, q, EPS, out_dtype=torch.float32)
        hold("dequant_apply", label, out, out_p,
             torch.from_numpy(host_dequant(h1, q32_np, EPS)))

        # a three-hop fold: the kernel sums the int32 stack in registers
        qs = torch.stack([q, -(q // 2), q // 3]).contiguous()
        chained = chain_apply_flat(p1, qs, EPS)
        chained_p = ref.chain_apply_ref(p1, qs, EPS)
        qsum = qs.sum(dim=0, dtype=torch.int32).cpu().numpy()
        hold("chain_apply", label, chained, chained_p,
             torch.from_numpy(host_dequant(h1, qsum, EPS)))
        if label.startswith(("(12, 768, 3072)", "(257, 33)",
                             "(768, 30522) overflow")):
            check_f16(label, p1, p2, hold)
    check_bf16(gen, hold)
    check_tile_zeros(gen, bad)
    torch.cuda.synchronize()
    errs["fingerprint"] = check_fingerprint(gen, bad)
    flash = check_flash(gen, bad)
    for name, suffix, _ in FLASH_DTYPES:
        errs[f"flash_attention{suffix}"] = flash[name]
    for line in bad:
        print(f"MISMATCH {line}", flush=True)
    if bad:
        fail(f"{len(bad)} kernel checks failed")
    print("kernels: the five storage kernels equal their plain versions "
          "(and their numpy twins) bit for bit, in f32, f16 and bf16; "
          "flash_attention is within "
          f"{FLASH_TOL['float32']} (f32), {FLASH_TOL['bfloat16']} (bf16) and "
          f"{FLASH_TOL['float16']} (f16) of its plain version: max |err| "
          f"{errs['flash_attention']:.3g} f32, "
          f"{errs['flash_attention_bf16']:.3g} bf16, "
          f"{errs['flash_attention_f16']:.3g} f16", flush=True)
    return errs


def check_f16(label, p1, p2, hold):
    """delta_quantize and dequant_apply with float16 operands (widened in
    the kernel) and float16 results (rounded in the kernel), against the
    plain versions and the numpy twins."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                    dequant_apply_flat)
    from repro_torch.store.delta import host_dequant

    scale = np.float32(ref.quant_scale(EPS))
    a, b = p1.half(), p2.half()
    ha, hb = a.cpu().numpy(), b.cpu().numpy()
    q_np = np.floor((ha.astype(np.float32) - hb.astype(np.float32)) / scale
                    + np.float32(0.5)).astype(np.int32)
    label = f"{label} f16"
    q, nz = delta_quantize_flat(a, b, EPS)
    hold("delta_quantize", label, q, ref.delta_quantize_ref(a, b, EPS)[0],
         torch.from_numpy(q_np))
    if int(nz) != int((q_np == 0).sum()):
        hold.bad.append(f"delta_quantize {label}: zero count {int(nz)}")
    # mixed operands: f32 parent, f16 child
    q_mixed, _ = delta_quantize_flat(p1, b, EPS)
    hold("delta_quantize", f"{label} (f32, f16)", q_mixed,
         ref.delta_quantize_ref(p1, b, EPS)[0], torch.from_numpy(np.floor(
             (p1.cpu().numpy() - hb.astype(np.float32)) / scale
             + np.float32(0.5)).astype(np.int32)))
    for parent, host_parent, out_dtype in ((a, ha, "float16"),
                                           (a, ha, "float32"),
                                           (p1, p1.cpu().numpy(), "float16")):
        out = dequant_apply_flat(parent, q, EPS, out_dtype=out_dtype)
        hold("dequant_apply",
             f"{label} {str(parent.dtype)[6:]} -> {out_dtype}", out,
             ref.dequant_apply_ref(parent, q, EPS, out_dtype=out_dtype),
             torch.from_numpy(host_dequant(host_parent, q_np, EPS,
                                           out_dtype=out_dtype)))


# qwen3-0.6b's largest leaves, the shapes phase 4d's bf16 kernels run at:
# embed/tok (tied to the head) and the stacked MLP weights of its 28 layers
BF16_SHAPES = ((151936, 1024), (28, 1024, 3072))
# f32 bit patterns whose bf16 rounding is an edge case: +-0, subnormals,
# ties to even, the largest finite value (rounds to inf), +-inf and
# positive NaNs (CUDA's f32 arithmetic returns the canonical NaN, sign
# dropped, where the host's keeps a negative NaN's sign)
BF16_EDGE_BITS = (0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF,
                  0x3F808000, 0x3F818000, 0xBF808000, 0x3F80FFFF, 0x7F7FFFFF,
                  0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001)


def bf16_cases(gen):
    """(label, p1, p2) bf16 pairs on the card: qwen3-0.6b's largest leaves
    with a finetune-sized delta (weights ~0.03, noise 1e-3 at density
    0.3), a ragged shape, an overflowing delta, and one element."""
    import torch

    def pair(shape, scale):
        p2 = torch.randn(shape, generator=gen, device="cuda") * 0.03
        noise = torch.randn(shape, generator=gen, device="cuda") * scale
        keep = torch.rand(shape, generator=gen, device="cuda") < 0.3
        return ((p2 + noise * keep).to(torch.bfloat16),
                p2.to(torch.bfloat16))

    out = [(f"{shape} bf16 finetune", *pair(shape, 1e-3))
           for shape in BF16_SHAPES]
    out.append(("(257, 33) bf16 finetune", *pair((257, 33), 1e-3)))
    out.append(("(257, 33) bf16 overflow", *pair((257, 33), 0.5)))
    out.append(("(1,) bf16", *pair((1,), 1e-3)))
    return out


def check_bf16(gen, hold):
    """delta_quantize and dequant_apply with bfloat16 operands (widened in
    the kernel) and bfloat16 results (rounded in the kernel), against the
    plain versions and the numpy twins on the host's bf16 carrier, bit for
    bit: q, zero counts, and the output's 16 bits."""
    import numpy as np
    import torch

    from repro_torch.common import bf16
    from repro_torch.kernels import ref
    from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                    dequant_apply_flat)
    from repro_torch.store.delta import host_dequant, host_snapshot

    for label, a, b in bf16_cases(gen):
        ha, hb = bf16.from_torch(a), bf16.from_torch(b)
        q_np, nz_np, narrow = host_snapshot(ha, hb, EPS)
        q_np = q_np.astype(np.int32)
        q, nz = delta_quantize_flat(a, b, EPS)
        hold("delta_quantize", label, q, ref.delta_quantize_ref(a, b, EPS)[0],
             torch.from_numpy(q_np))
        if int(nz) != nz_np:
            hold.bad.append(f"delta_quantize {label}: zero count {int(nz)} "
                            f"vs twin {nz_np}")
        if ("overflow" in label) == narrow:
            hold.bad.append(f"{label}: int8 narrowing {narrow}")
        out = dequant_apply_flat(a, q, EPS)
        hold("dequant_apply", f"{label} -> bfloat16", out,
             ref.dequant_apply_ref(a, q, EPS),
             bf16.to_torch(host_dequant(ha, q_np, EPS, out_dtype="bfloat16")))
        if not label.startswith("(257, 33)"):
            continue
        # the mixed cases: bf16 -> f32, f32 -> bf16, (f32, bf16) into q
        wide = a.float()
        for parent, host_parent, out_dtype in ((a, ha, "float32"),
                                               (wide, bf16.widen(ha),
                                                "bfloat16")):
            got = dequant_apply_flat(parent, q, EPS, out_dtype=out_dtype)
            twin = host_dequant(host_parent, q_np, EPS, out_dtype=out_dtype)
            hold("dequant_apply", f"{label} {str(parent.dtype)[6:]} -> "
                 f"{out_dtype}", got,
                 ref.dequant_apply_ref(parent, q, EPS, out_dtype=out_dtype),
                 bf16.to_torch(twin) if bf16.is_bf16(twin)
                 else torch.from_numpy(twin))
        q_mixed, _ = delta_quantize_flat(wide, b, EPS)
        hold("delta_quantize", f"{label} (f32, bf16)", q_mixed,
             ref.delta_quantize_ref(wide, b, EPS)[0],
             torch.from_numpy(host_snapshot(bf16.widen(ha), hb, EPS)[0]
                              .astype(np.int32)))
    # results at the rounding edges, NaN parents included
    edges = torch.tensor(BF16_EDGE_BITS, dtype=torch.int64).to(
        torch.int32).view(torch.float32).to("cuda")
    parent = ref.to_bfloat16(edges)
    q = torch.zeros(edges.shape, dtype=torch.int32, device="cuda")
    q[5:8] = torch.tensor([1, -1, 2], dtype=torch.int32)
    for p, host_p in ((parent, bf16.from_torch(parent)),
                      (edges, edges.cpu().numpy())):
        with np.errstate(invalid="ignore"):     # NaN and inf parents
            twin = host_dequant(host_p, q.cpu().numpy(), EPS,
                                out_dtype="bfloat16")
        hold("dequant_apply", f"edges {str(p.dtype)[6:]} -> bfloat16",
             dequant_apply_flat(p, q, EPS, out_dtype=torch.bfloat16),
             ref.dequant_apply_ref(p, q, EPS, out_dtype=torch.bfloat16),
             bf16.to_torch(twin))


def tile_zeros_model(q: "np.ndarray"):
    """The reference kernel's per-tile zero counts of flat ``q``, in numpy:
    q zero padded to (rows, 1024), rows = ceil(n / 1024) rounded up to a
    multiple of 8, in tiles of the first of 256, 128, ..., 8 rows that
    divides rows (``src/repro/kernels/ops.py``: ``_to_2d``, ``_block_rows``)."""
    import numpy as np
    n = q.size
    rows = -(-n // 8192) * 8
    block = next(c for c in (256, 128, 64, 32, 16, 8) if rows % c == 0)
    padded = np.zeros(rows * 1024, np.int32)
    padded[:n] = q.ravel()
    return (padded.reshape(-1, block * 1024) == 0).sum(axis=1)


def check_tile_zeros(gen, bad):
    """``ops.delta_quantize(return_block_zeros=True)`` on the card returns
    the reference's per-tile counts: the main path's largest tensor (108
    tiles of 256 rows) and a ragged one whose last tile is one real element
    and 8,191 padding zeros."""
    import torch

    from repro_torch.kernels import ops
    for shape in ((12, 768, 3072), (65537,)):
        p2 = torch.randn(shape, generator=gen, device="cuda") * 0.036
        p1 = p2 + torch.randn(shape, generator=gen, device="cuda") * 1e-4
        q, nz, blocks = ops.delta_quantize(p1, p2, EPS,
                                           return_block_zeros=True)
        want = tile_zeros_model(q)
        if (blocks is None or blocks.tolist() != want.tolist()
                or nz != int((q == 0).sum())):
            bad.append(f"delta_quantize per-tile zeros {shape}: "
                       f"{None if blocks is None else blocks[:4]} vs "
                       f"{want[:4]}")


# the reference test's tolerances (tests/test_kernels.py): the kernel sums
# in another order than the plain version, so the bits differ; float16
# (not in the reference test) keeps three more mantissa bits than bf16 and
# is held to a third of bf16's tolerance (tests/test_torch_flash.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 1e-2}
FLASH_DTYPES = (("float32", "", ""), ("bfloat16", "_bf16", "bf16"),
                ("float16", "_f16", "f16"))   # (name, key suffix, label)
SERVE_SHAPE = dict(B=8, Hq=12, Hkv=12, S=512, hd=64)   # paper-bert prefill
SERVE_MAX_LEN = 544      # a 512-token prompt + 32 new tokens
# last-token logits, card against host: f32 through 12 layers in another
# summation order (cuBLAS and the flash kernel against the CPU's products
# and the plain attention); greedy steps whose top-2 margin on the host is
# below it may pick the other token
SERVE_LOGIT_TOL = 1e-3
# the same for 16-bit engines (phases 4c, 4d, 8 and 9), relative to the
# logits' magnitude: the flash kernel's tolerances of those dtypes; and
# for an f32 engine held against the host in f32 (phase 9's mamba2)
SERVE_TOL = {"float16": FLASH_TOL["float16"],
             "bfloat16": FLASH_TOL["bfloat16"], "float32": SERVE_LOGIT_TOL}
# configs/qwen3_0_6b.py's attention (GQA, head_dim 128) at a long prompt
QWEN3_SHAPE = dict(B=1, Hq=16, Hkv=8, S=4096, hd=128)
# the same attention at phase 4d's serving prefill (8 x 512-token prompts)
QWEN3_SERVE_SHAPE = dict(B=8, Hq=16, Hkv=8, S=512, hd=128)
# configs/paligemma_3b.py's attention (MQA, head_dim 256) at phase 8's
# prefill: 256 patch embeddings (a bidirectional prefix) + 512 text tokens
PALIGEMMA_SERVE_SHAPE = dict(B=8, Hq=8, Hkv=1, S=768, hd=256)
PALIGEMMA_MASKS = dict(causal=True, prefix_len=256)


def flash_cases():
    """(shape, masks) of the flash kernel's checks: the reference test's
    five specs, a prefix-LM prefix past a 64-row query tile, ragged
    lengths (one with GQA at head_dim 128), the serving prefills of
    paper-bert (phases 4b, 4c) and qwen3-0.6b (phase 4d), the qwen3-0.6b
    geometry at 4096 tokens, a head_dim the wrapper pads (100 -> 104), a
    window that masks a row's whole first key tile;
    at head_dim 256: paligemma-3b's prefill (phase 8), a prefix past a
    query tile, a window, no mask over a ragged length, and a padded
    head_dim (200)."""
    return [
        (dict(B=2, Hq=4, Hkv=2, S=64, hd=16), dict(causal=True)),
        (dict(B=1, Hq=8, Hkv=1, S=32, hd=8), dict(causal=True)),
        (dict(B=2, Hq=4, Hkv=4, S=64, hd=16), dict(causal=True, window=24)),
        (dict(B=1, Hq=4, Hkv=2, S=48, hd=16),
         dict(causal=True, prefix_len=16)),
        (dict(B=2, Hq=2, Hkv=2, S=64, hd=16), dict(causal=False)),
        (dict(B=1, Hq=4, Hkv=2, S=200, hd=64),
         dict(causal=True, prefix_len=100)),
        (dict(B=2, Hq=4, Hkv=2, S=77, hd=128), dict(causal=True)),
        (dict(B=2, Hq=16, Hkv=8, S=300, hd=128),
         dict(causal=True, window=100)),
        (SERVE_SHAPE, dict(causal=True)),
        (QWEN3_SERVE_SHAPE, dict(causal=True)),
        (QWEN3_SHAPE, dict(causal=True)),
        (dict(B=1, Hq=4, Hkv=2, S=150, hd=100),
         dict(causal=True, prefix_len=70)),
        (dict(B=1, Hq=2, Hkv=1, S=130, hd=64),
         dict(causal=True, window=50)),
        (PALIGEMMA_SERVE_SHAPE, PALIGEMMA_MASKS),
        (dict(B=1, Hq=4, Hkv=2, S=200, hd=256),
         dict(causal=True, prefix_len=100)),
        (dict(B=2, Hq=4, Hkv=4, S=130, hd=256),
         dict(causal=True, window=50)),
        (dict(B=1, Hq=2, Hkv=1, S=77, hd=256), dict(causal=False)),
        (dict(B=1, Hq=4, Hkv=2, S=150, hd=200),
         dict(causal=True, prefix_len=70)),
    ]


def flash_inputs(gen, shape, dtype):
    import torch
    B, Hq, Hkv, S, hd = (shape[k] for k in ("B", "Hq", "Hkv", "S", "hd"))
    return [torch.randn(dims, generator=gen, device="cuda").to(dtype)
            for dims in ((B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]


def check_flash(gen, bad):
    """The flash kernel against its plain version on the same card inputs,
    in f32, bf16 and f16. Returns {dtype name: largest |kernel - plain|}."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    worst = {}
    for name, _, _ in FLASH_DTYPES:
        dtype = getattr(torch, name)
        worst[name] = 0.0
        for shape, masks in flash_cases():
            q, k, v = flash_inputs(gen, shape, dtype)
            got = flash_attention(q, k, v, **masks)
            torch.cuda.synchronize()
            plain = flash_attention_ref(q, k, v, **masks)
            err = max_abs(got, plain)
            worst[name] = max(worst[name], err)
            if got.dtype != dtype or got.shape != q.shape or not (
                    err <= FLASH_TOL[name]):
                bad.append(f"flash_attention {name} {shape} {masks}: "
                           f"max |kernel - plain| {err} (tolerance "
                           f"{FLASH_TOL[name]})")
    return worst


def fingerprint_cases(gen):
    """(label, tensor) on the card: the checkpoint's largest leaves, a
    ragged length, the 16-bit float types, int32, and f64 (cast to f32)."""
    import torch

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return [("(12, 768, 3072) f32", randn((12, 768, 3072))),
            ("(30522, 768) f32", randn((30522, 768))),
            ("(1000003,) f32", randn((1000003,))),
            ("(4097, 33) bf16", randn((4097, 33), torch.bfloat16)),
            ("(4097, 33) f16", randn((4097, 33), torch.float16)),
            ("(100003,) int32", torch.randint(
                -2**31, 2**31 - 1, (100003,), generator=gen, device="cuda",
                dtype=torch.int32)),
            ("(300007,) f64", randn((300007,), torch.float64))]


def check_fingerprint(gen, bad):
    """The kernel's raw (h1, h2) pair against its plain version's, and
    ``ops``' salted fingerprint (alone and from ``snapshot_fused``) on the
    card against the host's."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fingerprint import fingerprint_flat

    err = 0.0
    for label, x in fingerprint_cases(gen):
        got = fingerprint_flat(x).cpu()
        plain = ref.fingerprint_padded(x).cpu()
        err = max(err, max_abs(got, plain))
        if got.tolist() != plain.tolist():
            bad.append(f"fingerprint {label}: {got.tolist()} vs plain "
                       f"{plain.tolist()}")
    p2 = torch.randn((257, 33), generator=gen, device="cuda")
    p1 = p2 + torch.randn((257, 33), generator=gen, device="cuda") * 1e-4
    host = ops.fingerprint(p2.cpu(), backend="ref")
    if (ops.fingerprint(p2) != host
            or ops.snapshot_fused(p1, p2, EPS)[2] != host):
        bad.append("fingerprint: ops on the card differs from the host")
    return err


def time_kernels(gen):
    """Kernel and plain-version milliseconds at the main paths' largest
    shapes, with the bound each could reach on an H100 SXM; for flash
    attention see ``time_flash``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.chain_apply import chain_apply_flat
    from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                    dequant_apply_flat)
    from repro_torch.kernels.fingerprint import fingerprint_flat
    from repro_torch.kernels.snapshot_fused import snapshot_fused_flat

    def pair(shape, scale):
        p2 = torch.randn(shape, generator=gen, device="cuda") * 0.036
        return p2 + torch.randn(shape, generator=gen, device="cuda") * scale, p2

    w1, w2 = pair((12, 768, 3072), 1e-4)      # layers/mlp/w_in: the largest
    h1, h2 = pair((768, 30522), 0.05)          # lm_head re-initialised
    q_w, _ = delta_quantize_flat(w1, w2, EPS)
    qs3 = torch.stack([q_w, q_w, q_w]).contiguous()   # ft3's 3-hop fold
    n_w, n_h = w1.numel(), h1.numel()
    rows = {
        "snapshot_fused": (
            lambda: snapshot_fused_flat(w1, w2, EPS),
            lambda: ref.snapshot_fused_ref(w1, w2, EPS),
            9 * n_w, 4 * n_w, "(12, 768, 3072) f32"),
        "delta_quantize": (
            lambda: delta_quantize_flat(h1, h2, EPS),
            lambda: ref.delta_quantize_ref(h1, h2, EPS),
            12 * n_h, 4 * n_h, "(768, 30522) f32"),
        "dequant_apply": (
            lambda: dequant_apply_flat(w1, q_w, EPS),
            lambda: ref.dequant_apply_ref(w1, q_w, EPS),
            12 * n_w, 2 * n_w, "(12, 768, 3072) f32 + int32"),
        "chain_apply": (
            lambda: chain_apply_flat(w1, qs3, EPS),
            lambda: ref.chain_apply_ref(w1, qs3, EPS),
            (8 + 4 * 3) * n_w, 2 * n_w, "(12, 768, 3072) f32 + 3 x int32"),
        # reads 4 B per element, writes 16 B; 12 integer operations per
        # element (4 multiplies, 2 shifts, 3 xors, 3 adds), counted
        # against the f32 rate, the table's only non-tensor-core peak
        "fingerprint": (
            lambda: fingerprint_flat(w2),
            lambda: ref.fingerprint_padded(w2),
            4 * n_w + 16, 12 * n_w, "(12, 768, 3072) f32"),
    }
    # the f16 instantiations: 2 B per operand, int32 q, f16 out
    h1h, h2h, w1h = h1.half(), h2.half(), w1.half()
    rows["delta_quantize_f16"] = (
        lambda: delta_quantize_flat(h1h, h2h, EPS),
        lambda: ref.delta_quantize_ref(h1h, h2h, EPS),
        8 * n_h, 4 * n_h, "(768, 30522) f16")
    rows["dequant_apply_f16"] = (
        lambda: dequant_apply_flat(w1h, q_w, EPS),
        lambda: ref.dequant_apply_ref(w1h, q_w, EPS),
        8 * n_w, 2 * n_w, "(12, 768, 3072) f16 + int32 -> f16")
    # the bf16 instantiations at qwen3-0.6b's largest leaves (phase 4d):
    # 2 B per operand, int32 q, bf16 out
    e1, e2 = (t.to(torch.bfloat16) for t in pair(BF16_SHAPES[0], 1e-3))
    m1, m2 = (t.to(torch.bfloat16) for t in pair(BF16_SHAPES[1], 1e-3))
    q_m, _ = delta_quantize_flat(m1, m2, EPS)
    n_e, n_m = e1.numel(), m1.numel()
    rows["delta_quantize_bf16"] = (
        lambda: delta_quantize_flat(e1, e2, EPS),
        lambda: ref.delta_quantize_ref(e1, e2, EPS),
        8 * n_e, 4 * n_e, f"{BF16_SHAPES[0]} bf16")
    rows["dequant_apply_bf16"] = (
        lambda: dequant_apply_flat(m1, q_m, EPS),
        lambda: ref.dequant_apply_ref(m1, q_m, EPS),
        8 * n_m, 2 * n_m, f"{BF16_SHAPES[1]} bf16 + int32 -> bf16")
    out = {}
    for name, (kernel, plain, nbytes, flops, shape) in rows.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_OPS_PER_S * 1e3
        out[name] = {
            "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "shape": shape}
    for name in ("delta_quantize", "dequant_apply"):
        for sub in ("f16", "bf16"):
            out[name][sub] = out.pop(f"{name}_{sub}")
    out["flash_attention"] = time_flash(gen, SERVE_SHAPE, plain=True)
    out["flash_attention"]["qwen3_0_6b"] = time_flash(gen, QWEN3_SHAPE)
    out["flash_attention"]["qwen3_0_6b_serve"] = time_flash(
        gen, QWEN3_SERVE_SHAPE)
    out["flash_attention"]["paligemma_3b_serve"] = time_flash(
        gen, PALIGEMMA_SERVE_SHAPE, plain=True, masks=PALIGEMMA_MASKS)
    return out


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()``: ``iters`` calls captured in a
    CUDA graph, replayed 5 times between CUDA events, so the host's cost of
    issuing each call is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def sdpa_backend(q, k, v, mask):
    """The first of SDPA's flash, memory-efficient, cuDNN and math backends
    that takes these inputs and ``mask``."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                sdpa(q, k, v, attn_mask=mask)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    fail("no SDPA backend takes the prefix-LM mask")


def time_flash(gen, shape, plain=False, masks=None):
    """The flash kernel's milliseconds at ``shape`` (causal, or ``masks``)
    in f32, bf16 and f16, each beside its bound
    (``flash_attention.roofline``) and one library call that computes the
    same function, ``scaled_dot_product_attention`` (timed here, never
    called by the port), on k and v expanded to the query heads outside
    the timing. ``is_causal`` cannot express a prefix-LM mask, so with
    ``prefix_len`` SDPA takes an explicit boolean mask and runs on the
    first backend that takes it (``sdpa_backend``, named in the result).

    ``ms`` is device time per call (``graph_ms``); ``eager_ms`` times the
    same calls issued one by one (``cuda_ms``), where a call this short
    can be bound by the host issuing it."""
    import torch
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref,
                                                     roofline)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    masks = masks or dict(causal=True)
    prefix = masks.get("prefix_len", 0)
    B, Hq, Hkv, S, hd = (shape[k] for k in ("B", "Hq", "Hkv", "S", "hd"))
    out = {"shape": f"({B}, {Hq}, {Hkv}, {S}, {hd}) causal"
                    + (f", prefix_len {prefix}" if prefix else "")
                    + ", f32 / bf16 / f16"}
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < prefix)
    for name, tag, _ in FLASH_DTYPES:
        dtype = getattr(torch, name)
        q, k, v = flash_inputs(gen, shape, dtype)
        ke, ve = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
        bound, by = roofline(B, Hq, Hkv, S, S, hd, dtype, **masks)

        def kernel():
            return flash_attention(q, k, v, **masks)

        if prefix:
            backend = sdpa_backend(q, ke, ve, mask)
            out[f"library_backend{tag}"] = backend.name

            def library():
                with sdpa_kernel(backend):
                    return sdpa(q, ke, ve, attn_mask=mask)
        else:
            def library():
                return sdpa(q, ke, ve, is_causal=True)

        out.update({
            f"ms{tag}": graph_ms(kernel, 20),
            f"library_ms{tag}": graph_ms(library, 20),
            f"eager_ms{tag}": cuda_ms(kernel, 20),
            f"library_eager_ms{tag}": cuda_ms(library, 20),
            f"bound_ms{tag}": bound, f"bound_by{tag}": by})
        if plain:
            out[f"plain_ms{tag}"] = cuda_ms(
                lambda: flash_attention_ref(q, k, v, **masks), 5)
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def finetune(parent, scale, gen):
    """{key: f32 numpy}: ``parent`` plus sparse noise (density 0.3)."""
    import numpy as np
    import torch
    out = {}
    for k, v in parent.items():
        t = torch.from_numpy(np.array(v, np.float32))
        noise = torch.randn(t.shape, generator=gen) * scale
        keep = torch.rand(t.shape, generator=gen) < 0.3
        out[k] = (t + noise * keep).numpy()
    return out


def make_lineage(cfg, seed: int):
    """{node: flat f32 numpy params}: random paper-bert weights from a
    seeded torch.Generator, three sparse finetunes, and task-head (ft1
    with lm_head re-initialised)."""
    import numpy as np
    import torch

    from repro_torch.convert import to_numpy
    from repro_torch.models import init_params

    gen = torch.Generator().manual_seed(seed)
    base = {k: to_numpy(v) for k, v in init_params(cfg, generator=gen).items()}
    params = {"base": base}
    params["ft1"] = finetune(base, 5e-5, gen)
    params["ft2"] = finetune(params["ft1"], 1e-4, gen)
    params["ft3"] = finetune(params["ft2"], 7e-5, gen)
    head = dict(params["ft1"])
    shape = head["lm_head"].shape
    head["lm_head"] = (torch.randn(shape, generator=gen)
                       / np.sqrt(shape[0])).numpy()
    params["task-head"] = head
    return params


def commit_lineage(root, arch, params, **store_kw):
    """Commit the lineage (the nodes of ``NODES`` that ``params`` holds)
    through LineageGraph + ArtifactStore; return the store."""
    from repro_torch.convert import to_artifact
    from repro_torch.core import LineageGraph
    from repro_torch.store import ArtifactStore

    store = ArtifactStore(root=root, **store_kw)
    graph = LineageGraph(path=root, store=store)
    graph.add_node(to_artifact(params["base"], arch), "base")
    for parent, child in (("base", "ft1"), ("ft1", "ft2"), ("ft2", "ft3")):
        if child not in params:
            continue
        graph.add_node(None, child, model_type=arch)
        graph.add_version_edge(parent, child)
        graph.add_node(to_artifact(params[child], arch), child)
    if "task-head" in params:
        graph.add_node(None, "task-head", model_type=arch)
        graph.add_edge("ft1", "task-head")
        graph.add_node(to_artifact(params["task-head"], arch), "task-head")
    return store


def check_out(root, nodes, **store_kw):
    """Reopen the repository in a fresh store and lineage; materialize
    ``nodes``. Returns (store, refs, {node: {key: array}})."""
    from repro_torch.core import LineageGraph
    from repro_torch.store import ArtifactStore

    store = ArtifactStore(root=root, **store_kw)
    graph = LineageGraph(path=root, store=store)
    refs = {n: graph.nodes[n].artifact_ref for n in graph.nodes}
    out = {n: dict(store.materialize_artifact(refs[n]).params) for n in nodes}
    return store, refs, out


def verify(label, store, refs, out, params, reference=None):
    """Hash-exact checkouts, agreement with a reference checkout and with
    the live weights, and a clean fsck."""
    import numpy as np

    from repro_torch.common.hashing import tensor_hash
    from repro_torch.kernels.ref import quant_scale

    bound = float(np.float32(quant_scale(EPS)))
    worst = 0.0
    for node, tensors in out.items():
        manifest = store.get_manifest(refs[node])
        if set(tensors) != set(manifest["params"]):
            fail(f"{label}: {node} checked out other params than committed")
        for key, value in tensors.items():
            value = np.asarray(value)
            live = params[node][key]
            if value.shape != live.shape or value.dtype != np.float32:
                fail(f"{label}: {node}:{key} is {value.dtype}{value.shape}")
            if not np.isfinite(value).all():
                fail(f"{label}: {node}:{key} has non-finite values")
            if tensor_hash(value) != manifest["params"][key]["hash"]:
                fail(f"{label}: {node}:{key} does not match its manifest hash")
            if reference is not None and not np.array_equal(
                    value.view(np.int32), np.asarray(reference[node][key])
                    .view(np.int32)):
                fail(f"{label}: {node}:{key} differs from the host checkout")
            err = float(np.abs(value.astype(np.float64) - live).max())
            worst = max(worst, err)
            if err > bound:
                fail(f"{label}: {node}:{key} is {err} from the live weights "
                     f"(bound {bound})")
    report = store.fsck(list(refs.values()))
    if not report["ok"]:
        fail(f"{label}: fsck is not clean: "
             f"{ {k: report[k] for k in ('corrupt', 'missing_objects', 'refcount_drift')} }")
    print(f"{label}: checkouts hash-exact, max |checkout - live| = {worst} "
          f"(bound {bound}), fsck clean", flush=True)


def wrappers():
    from repro_torch.kernels.chain_apply import chain_apply_flat
    from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                    dequant_apply_flat)
    from repro_torch.kernels.fingerprint import fingerprint_flat
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.snapshot_fused import snapshot_fused_flat
    return {"snapshot_fused": snapshot_fused_flat,
            "delta_quantize": delta_quantize_flat,
            "dequant_apply": dequant_apply_flat,
            "chain_apply": chain_apply_flat,
            "fingerprint": fingerprint_flat,
            "flash_attention": flash_attention}


# {path: {kernel: {operand dtypes: launches}}}, recorded by read_launches
LAUNCHES_BY_DTYPE = {}


def zero_launches():
    for w in wrappers().values():
        w.launches = 0
        w.launches_by_dtype = {}


def read_launches(path=None):
    """{kernel: launches} since zero_launches; with ``path``, the counts by
    operand dtype are kept in LAUNCHES_BY_DTYPE[path]."""
    if path is not None:
        LAUNCHES_BY_DTYPE[path] = {k: dict(w.launches_by_dtype)
                                   for k, w in wrappers().items()}
    return {k: w.launches for k, w in wrappers().items()}


def main_path(cfg, params, workdir, card):
    """Phase 4: whole-tensor lineage on the card. Returns launch counts."""
    import torch

    root = os.path.join(workdir, "whole")
    zero_launches()
    t0 = time.perf_counter()
    store = commit_lineage(root, cfg.name, params, chunk_threshold=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    store2, refs, out = check_out(root, CHECKOUT, chunk_threshold=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches("lineage")
    print(f"main path: commit {t1 - t0:.3f} s, checkout of "
          f"{'+'.join(CHECKOUT)} {t2 - t1:.3f} s, compression ratio "
          f"{store.compression_ratio():.3f}, launches {json.dumps(launches)} "
          f"({card})", flush=True)
    _, _, host = check_out(root, CHECKOUT, chunk_threshold=0, backend="ref")
    verify("main path", store2, refs, out, params, reference=host)
    missing = [k for k, n in launches.items()
               if n == 0 and k not in ("fingerprint", "flash_attention")]
    if missing:
        fail(f"main path launched no {', '.join(missing)} kernel")
    return launches


def chunked_path(cfg, params, workdir):
    """Phase 5: the same lineage with the default chunk threshold, cut to
    the first ``PHASE5_LAYERS`` of its 12 layers (host work: the chunk
    engine never reaches a kernel)."""
    params = {node: {k: v[:PHASE5_LAYERS] if k.startswith("layers/") else v
                     for k, v in flat.items()}
              for node, flat in params.items()}
    print(f"chunked path: depth cut to {PHASE5_LAYERS} of {cfg.n_layers} "
          f"layers", flush=True)
    root = os.path.join(workdir, "chunked")
    t0 = time.perf_counter()
    store = commit_lineage(root, cfg.name, params)
    t1 = time.perf_counter()
    store2, refs, out = check_out(root, CHECKOUT)
    t2 = time.perf_counter()
    kinds = {}
    for e in store2.get_manifest(refs["ft3"])["params"].values():
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    print(f"chunked path: commit {t1 - t0:.3f} s, checkout {t2 - t1:.3f} s, "
          f"compression ratio {store.compression_ratio():.3f}, ft3 entries "
          f"{json.dumps(kinds)}", flush=True)
    if "chunked" not in kinds:
        fail("chunked path: no tensor took the chunk engine")
    _, _, host = check_out(root, CHECKOUT, backend="ref")
    verify("chunked path", store2, refs, out, params, reference=host)


F16_NODES = ("base", "ft1", "ft2", "task-head")
F16_CHECKOUT = ("ft2", "task-head")


def f16_path(cfg, params, workdir, card):
    """Phase 4c: phase 4's lineage shape (base -> ft1 -> ft2, task-head
    under ft1) with every tensor float16, committed and checked out through
    the card's store; manifest refs and checkouts must equal a host
    (``backend="ref"``) store's. Then one ``ServeEngine`` prefill of ft2's
    pool view in float16 (the f16 flash kernel), held against the host
    engine. Returns the launch counts of its run."""
    import numpy as np
    import torch

    from repro_torch.common.hashing import tensor_hash
    from repro_torch.serve import ModelPool
    from repro_torch.store import ArtifactStore

    half = {n: {k: v.astype(np.float16) for k, v in params[n].items()}
            for n in F16_NODES}
    nbytes = sum(v.nbytes for v in half["base"].values())
    root, host_root = (os.path.join(workdir, d) for d in ("f16", "f16-host"))
    zero_launches()
    t0 = time.perf_counter()
    commit_lineage(root, cfg.name, half, chunk_threshold=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    store, refs, out = check_out(root, F16_CHECKOUT, chunk_threshold=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pool = ModelPool(ArtifactStore(root=root, chunk_threshold=0), verify=True)
    view = pool.get(refs["ft2"])
    cfg16 = dataclasses.replace(cfg, dtype="float16")
    gen = torch.Generator(device="cuda").manual_seed(7)
    served = serve_view("f16 path", cfg16, view.params, gen, n_tokens=1,
                        host_dtype="float32")
    launches = read_launches("lineage_f16")
    commit_lineage(host_root, cfg.name, half, chunk_threshold=0,
                   backend="ref")
    _, host_refs, host = check_out(host_root, F16_CHECKOUT,
                                   chunk_threshold=0, backend="ref")
    if refs != host_refs:
        fail(f"f16 path: manifest refs {refs} differ from the host's "
             f"{host_refs}")
    for node, tensors in out.items():
        manifest = store.get_manifest(refs[node])["params"]
        for key, value in tensors.items():
            value = np.asarray(value)
            if (value.dtype != np.float16 or not np.isfinite(value).all()
                    or tensor_hash(value) != manifest[key]["hash"]
                    or not np.array_equal(value.view(np.uint16), np.asarray(
                        host[node][key]).view(np.uint16))):
                fail(f"f16 path: {node}:{key} is not its manifest's and the "
                     f"host's float16 tensor")
    for key, value in view.params.items():
        if not np.array_equal(np.asarray(value).view(np.uint16),
                              np.asarray(host["ft2"][key]).view(np.uint16)):
            fail(f"f16 path: the card's ft2 view differs from the host "
                 f"checkout at {key}")
    report = store.fsck(list(refs.values()))
    if not report["ok"]:
        fail(f"f16 path: fsck is not clean: {report}")
    by_dtype = LAUNCHES_BY_DTYPE["lineage_f16"]
    print(f"f16 path: {cfg.name} f16 ({nbytes} bytes per model), "
          f"{len(F16_NODES)} models committed in {t1 - t0:.3f} s, "
          f"{'+'.join(F16_CHECKOUT)} checked out in {t2 - t1:.3f} s, "
          f"compression ratio {store.compression_ratio():.3f}; manifest refs "
          f"and checkouts equal the host store's, fsck clean; ft2 view built "
          f"in {view.build_s:.3f} s, prefill {served['prefill_s']:.4f} s; "
          f"launches {json.dumps(launches)}, by dtype "
          f"{json.dumps(by_dtype, sort_keys=True)} ({card})", flush=True)
    if not any(k.startswith("float16") for k in by_dtype["dequant_apply"]):
        fail("f16 path: no dequant_apply launch with a float16 operand")
    if not by_dtype["flash_attention"].get("float16"):
        fail("f16 path: the f16 prefill launched no float16 flash kernel")
    return launches


def serve_view(label, cfg, flat, gen, n_tokens, host_dtype=None, *,
               prompt=SERVE_SHAPE["S"], max_len=SERVE_MAX_LEN, inputs=None,
               host_rows=2, routing=None, drift=False):
    """``ServeEngine`` on a view's params on the card: prefill of 8 x
    ``prompt`` prompts (with ``inputs``, the batch's patches or frames on
    the card) and ``n_tokens`` greedy tokens, then ``host_rows`` rows
    against the port's engine functions on the host, in the same dtype or,
    with ``host_dtype``, on the same weights widened to it (the host's f16
    products are scalar and take minutes at full width). Prefill logits
    must lie within ``SERVE_TOL[dtype]`` times the larger of 1 and the
    host logits' largest magnitude (a 16-bit float rounds relative to the
    magnitude), and the tokens must be equal except after a near tie. With
    decode steps, the card's step functions are then fed the host's tokens
    (teacher forcing), and every decode step's logits are held to the same
    tolerance against the host's.

    With ``routing`` (a :class:`Routing`; an MoE, whose capacity couples
    the rows, so ``host_rows`` is the whole batch) the host run and the
    card's forced run record each layer's routing, and logits are held on
    the rows whose routing agrees everywhere; greedy tokens are not held
    (a row that parts at a near tie changes the others' capacity).

    With ``drift`` (a model whose own rounding in ``cfg.dtype`` moves its
    logits from the f32 host's by more than the tolerance) the host also
    runs the engine in ``cfg.dtype``, fed the same tokens, and each step
    is held within the larger of the tolerance and twice that host run's
    distance from the f32 one. Returns the timings."""
    import contextlib

    import torch

    from repro_torch.convert import to_params
    from repro_torch.models import flat_paths
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, to_params(flat, "cuda"), max_len=max_len)
    B, S = SERVE_SHAPE["B"], prompt
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens, **(inputs or {})}
    prefills = 0

    def timed(n):
        nonlocal prefills
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(batch, n)
        torch.cuda.synchronize()
        prefills += 1
        return time.perf_counter() - t0, out

    timed(min(n_tokens, 2))                 # warm-up
    prefill_s, one = timed(1)
    out = {"prefill_s": prefill_s}
    full = one
    if n_tokens > 1:
        total_s, full = timed(n_tokens)
        out.update(total_s=total_s,
                   decode_ms=(total_s - prefill_s) / (n_tokens - 1) * 1e3,
                   tokens_per_s=B * n_tokens / total_s)
        if not torch.equal(full[:, :1], one):
            fail(f"{label}: generate(1) is not the first of "
                 f"generate({n_tokens})")
    if (tuple(full.shape) != (B, n_tokens) or int(full.min()) < 0
            or int(full.max()) >= cfg.vocab_size):
        fail(f"{label}: the engine gave {full.dtype}{tuple(full.shape)}")
    rows = {k: v[:host_rows] for k, v in batch.items()}
    card_params = engine.params
    del engine
    t0 = time.perf_counter()
    host_cfg, host_params = cfg, to_params(flat, "cpu")
    if host_dtype is not None:
        host_cfg = dataclasses.replace(cfg, dtype=host_dtype)
        # leaves of the model's dtype change; an SSM's f32 leaves stay f32
        host_params = to_params({k: v.to(getattr(torch, host_dtype))
                                 if v.dtype == getattr(torch, cfg.dtype)
                                 else v
                                 for k, v in flat_paths(host_params).items()})
    record = routing.record if routing else (
        lambda run: contextlib.nullcontext())
    with record("host"):
        host_steps, host_tokens, margins = _greedy_host(
            host_cfg, host_params, {k: v.cpu() for k, v in rows.items()},
            n_tokens, max_len)
    out["host_s"] = time.perf_counter() - t0
    drifts = None
    if drift:
        own = to_params(flat, "cpu")
        drifts = [float((o - h.float()).abs().max()) for o, h in zip(
            _forced_logits(cfg, own, {k: v.cpu() for k, v in rows.items()},
                           host_tokens, max_len), host_steps)]
        del own
    del host_params
    with record("card"):
        card_steps = _forced_logits(cfg, card_params, rows, host_tokens,
                                    max_len)
    prefills += 1
    out["prefills"] = prefills
    del card_params
    held = routing.agreeing_rows(label, host_rows) if routing else list(
        range(host_rows))
    host_steps = [h.float()[held] for h in host_steps]
    card_steps = [c[held] for c in card_steps]
    if not all(torch.isfinite(x).all() for x in card_steps + host_steps):
        fail(f"{label}: non-finite logits")
    errs, tols = [], []
    for i, (card_logits, host_logits) in enumerate(zip(card_steps,
                                                        host_steps)):
        errs.append(float((card_logits - host_logits).abs().max()))
        tols.append(max(SERVE_TOL[cfg.dtype]
                        * max(1.0, float(host_logits.abs().max())),
                        2 * drifts[i] if drifts else 0.0))
    err, tol = errs[0], tols[0]
    decode_worst = max(range(1, n_tokens), key=lambda i: errs[i] / tols[i],
                       default=None)
    near = []
    for r in ([] if routing else range(host_rows)):
        got, want = full[r].cpu().tolist(), host_tokens[r].tolist()
        i = next((i for i in range(n_tokens) if got[i] != want[i]), None)
        if i is None:
            continue
        near.append((r, i, margins[i][r]))
        if margins[i][r] >= tol:
            fail(f"{label}: row {r} step {i}: card token {got[i]} vs host "
                 f"{want[i]} with a host top-2 margin of {margins[i][r]}")
    extra = "".join(f" + {k} {tuple(v.shape[1:])}" for k, v in
                    (inputs or {}).items())
    print(f"{label}: engine {cfg.name} {cfg.dtype} (host {host_cfg.dtype}), "
          f"batch {B} x {S}{extra}: prefill "
          f"{prefill_s:.4f} s"
          + (f", {n_tokens} tokens in {out['total_s']:.4f} s "
             f"({out['decode_ms']:.3f} ms per decode step, "
             f"{out['tokens_per_s']:.1f} tokens/s)" if n_tokens > 1 else "")
          + f"; host run of {host_rows} rows {out['host_s']:.3f} s"
          + (f" (its own {cfg.dtype} run lies up to {max(drifts):.3g} from "
             f"its f32 one)" if drifts else "")
          + f", logits held on rows {held}: last-token prefill "
          f"logits max |card - host| {err:.3g} (tolerance {tol:.3g}), "
          + (f"decode logits fed the host's tokens max |card - host| "
             f"{errs[decode_worst]:.3g} at step {decode_worst} (tolerance "
             f"{tols[decode_worst]:.3g}) over {n_tokens - 1} steps"
             if decode_worst is not None else "")
          + ("" if routing else
             f", greedy tokens "
             f"{'equal' if not near else 'equal up to near ties'}"
             f"{''.join(f'; row {r} diverges at step {i} (host top-2 margin {m:.3g})' for r, i, m in near)}"),
          flush=True)
    if not err <= tol:
        fail(f"{label}: prefill logits differ by {err} (tolerance {tol})")
    for i in range(1, n_tokens):
        if not errs[i] <= tols[i]:
            fail(f"{label}: decode step {i}'s logits, fed the host's tokens, "
                 f"differ by {errs[i]} (tolerance {tols[i]})")
    return out


# ---------------------------------------------------------------------------
# phase 4d: a bf16 lineage of full-width qwen3-0.6b, committed, checked out
# and served
# ---------------------------------------------------------------------------

BF16_ARCH = "qwen3-0.6b"
BF16_NODES = ("base", "ft1", "ft2", "task-head")
BF16_CHECKOUT = ("ft2", "task-head")
# the layers of the lineage that also go through a host store (cut for
# time: the host store's commit and checkout of all 28 took 145 s): the
# first three and the last, whose w_out task-head re-draws (its int32
# delta); embed/tok is left out
BF16_CUT_LAYERS = (0, 1, 2, 27)
# finetune noise, drawn in f32 and narrowed: it must exceed the weights'
# bf16 ulp (about 1.2e-4 at the 0.03 of a 1024-wide layer) or the children
# round back onto their parents
BF16_FT_SCALE = 1e-3


def bf16_lineage(cfg, seed, task_head=True):
    """{node: flat bf16 carriers}: random weights of ``cfg`` drawn on the
    card from ``seed``, two sparse finetunes (density 0.3) and, with
    ``task_head``, task-head (ft1 with the last layer's slice of
    layers/mlp/w_out re-drawn: its delta overflows int8). Returns (params,
    {node: share of elements that differ from the parent})."""
    import numpy as np
    import torch

    from repro_torch.common import bf16
    from repro_torch.kernels.ref import to_bfloat16
    from repro_torch.models import init_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = init_params(cfg, generator=gen)
    tensors, changed = {"base": base}, {}

    def finetune_bf16(parent):
        out, moved, total = {}, 0, 0
        for k, v in parent.items():
            noise = torch.randn(v.shape, generator=gen, device="cuda")
            keep = torch.rand(v.shape, generator=gen, device="cuda") < 0.3
            out[k] = to_bfloat16(v.float() + noise * keep * BF16_FT_SCALE)
            moved += int((out[k].view(torch.int16)
                          != v.view(torch.int16)).sum())
            total += v.numel()
        return out, moved / total

    tensors["ft1"], changed["ft1"] = finetune_bf16(base)
    tensors["ft2"], changed["ft2"] = finetune_bf16(tensors["ft1"])
    if task_head:
        head = dict(tensors["ft1"])
        w_out = head["layers/mlp/w_out"].clone()
        fan_in = w_out.shape[-2]
        w_out[-1] = to_bfloat16(torch.randn(w_out.shape[1:], generator=gen,
                                            device="cuda") / np.sqrt(fan_in))
        head["layers/mlp/w_out"] = w_out
        tensors["task-head"] = head
        changed["task-head"] = int(
            (w_out.view(torch.int16) != tensors["ft1"]["layers/mlp/w_out"]
             .view(torch.int16)).sum()) / sum(v.numel()
                                              for v in base.values())
    params = {n: {k: bf16.from_torch(v) for k, v in flat.items()}
              for n, flat in tensors.items()}
    del tensors, base
    torch.cuda.empty_cache()
    return params, changed


def cut_lineage(params, layers):
    """The lineage ``params`` with every stacked leaf (``layers/...``) cut
    to ``layers`` and only ``final_norm`` of the others."""
    import numpy as np
    idx = np.asarray(layers)
    return {node: {k: (np.ascontiguousarray(v[idx])
                       if k.startswith("layers/") else v)
                   for k, v in flat.items()
                   if k.startswith("layers/") or k == "final_norm"}
            for node, flat in params.items()}


def compare_cut(label, workdir, arch, params, card_out, layers, checkout):
    """The lineage ``params`` cut to ``layers`` (``cut_lineage``), committed
    through a card store and a host store (``backend="ref"``), each checked
    out at ``checkout``: the manifest refs must be equal, the two checkouts
    equal bit for bit, and equal to the same cut of the card's checkouts of
    the whole lineage (``card_out``). Returns the host store's seconds."""
    import numpy as np

    cut = cut_lineage(params, layers)
    card_root, host_root = (os.path.join(workdir, f"{label}-{d}".replace(
        " ", "-")) for d in ("cut", "cut-host"))
    commit_lineage(card_root, arch, cut, chunk_threshold=0)
    _, refs, card = check_out(card_root, checkout, chunk_threshold=0)
    t0 = time.perf_counter()
    commit_lineage(host_root, arch, cut, chunk_threshold=0, backend="ref")
    _, host_refs, host = check_out(host_root, checkout, chunk_threshold=0,
                                   backend="ref")
    host_s = time.perf_counter() - t0
    if refs != host_refs:
        fail(f"{label}: the cut's manifest refs {refs} differ from the "
             f"host's {host_refs}")
    whole = cut_lineage({n: card_out[n] for n in checkout}, layers)
    for node in checkout:
        for key, value in card[node].items():
            bits = np.asarray(value).view(np.uint8)
            if not (np.array_equal(bits, np.asarray(host[node][key])
                                   .view(np.uint8))
                    and np.array_equal(bits, np.asarray(whole[node][key])
                                       .view(np.uint8))):
                fail(f"{label}: the cut's {node}:{key} differs between the "
                     f"card, the host and the whole lineage's checkout")
    nbytes = sum(v.nbytes for v in cut["ft2"].values())
    print(f"{label}: lineage cut to layers {list(layers)} ({nbytes} bytes "
          f"per model): refs equal to the host store's, checkouts of "
          f"{'+'.join(checkout)} equal on card and host and to the whole "
          f"checkout's layers; host store {host_s:.3f} s", flush=True)
    return host_s


def bf16_path(workdir, card, seed):
    """Phase 4d: a bf16 lineage of full-width qwen3-0.6b committed and
    checked out through the card's store (bf16 delta_quantize and
    dequant_apply), hash-exact and, cut to ``BF16_CUT_LAYERS``, with refs
    and bits equal to a host store's; a ModelPool view of ft2 on the card
    equal to the card's checkout bit for bit; ServeEngine on
    it (bf16 flash attention). Returns the launch counts of its run."""
    import numpy as np
    import torch

    from repro_torch.common import bf16
    from repro_torch.common.hashing import tensor_hash
    from repro_torch.kernels.ref import quant_scale
    from repro_torch.models import get_config
    from repro_torch.serve import ModelPool
    from repro_torch.store import ArtifactStore

    cfg = get_config(BF16_ARCH)     # its own dtype: bfloat16
    t0 = time.perf_counter()
    params, changed = bf16_lineage(cfg, seed)
    n_params = sum(v.size for v in params["base"].values())
    nbytes = sum(v.nbytes for v in params["base"].values())
    print(f"bf16 path: {cfg.name} {cfg.dtype} at full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}): "
          f"{n_params} params, {nbytes} bytes per model, {len(BF16_NODES)} "
          f"models made in {time.perf_counter() - t0:.3f} s; share of "
          f"elements changed from the parent "
          f"{json.dumps({k: round(v, 6) for k, v in changed.items()})}",
          flush=True)
    if min(changed.values()) <= 0.0:
        fail(f"bf16 path: a finetune rounded back onto its parent: {changed}")
    root = os.path.join(workdir, "bf16")
    zero_launches()
    t0 = time.perf_counter()
    store = commit_lineage(root, cfg.name, params, chunk_threshold=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    store2, refs, out = check_out(root, BF16_CHECKOUT, chunk_threshold=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pool = ModelPool(ArtifactStore(root=root, chunk_threshold=0), verify=True)
    view = pool.get(refs["ft2"])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    served = serve_view("bf16 path", cfg, view.params, gen, n_tokens=32)
    launches = read_launches("lineage_bf16")
    by_dtype = LAUNCHES_BY_DTYPE["lineage_bf16"]
    ratio = store.compression_ratio()
    print(f"bf16 path: commit {t1 - t0:.3f} s, checkout of "
          f"{'+'.join(BF16_CHECKOUT)} {t2 - t1:.3f} s, compression ratio "
          f"{ratio:.3f}, ft2 view built in {view.build_s:.3f} s "
          f"({view.private_bytes} private bytes, "
          f"{len(view.aliased)} params aliased); launches "
          f"{json.dumps(launches)}, by dtype "
          f"{json.dumps(by_dtype, sort_keys=True)} ({card})", flush=True)

    # the lineage cut to 4 of its 28 layers through a card store and a
    # host store: the same refs and bits
    t4 = time.perf_counter()
    host_s = compare_cut("bf16 path", workdir, cfg.name, params, out,
                         BF16_CUT_LAYERS, BF16_CHECKOUT)
    t5 = time.perf_counter()
    step = float(np.float32(quant_scale(EPS)))
    worst = 0.0
    for node, tensors in out.items():
        manifest = store2.get_manifest(refs[node])["params"]
        for key, value in tensors.items():
            value = np.asarray(value)
            if (not bf16.is_bf16(value)
                    or tensor_hash(value) != manifest[key]["hash"]):
                fail(f"bf16 path: {node}:{key} is not its manifest's bf16 "
                     f"tensor")
            got, live = bf16.widen(value), bf16.widen(params[node][key])
            if not np.isfinite(got).all():
                fail(f"bf16 path: {node}:{key} has non-finite values")
            # a hop quantizes against the parent's stored truth (error
            # within one step, never compounding) and rounds to bf16
            err = np.abs(got - live)
            worst = max(worst, float(err.max()))
            if not (err <= step + np.abs(live) * 2.0 ** -8).all():
                fail(f"bf16 path: {node}:{key} is {float(err.max())} from "
                     f"the live weights")
    for key, value in view.params.items():
        if not np.array_equal(np.asarray(value).view(np.uint16),
                              np.asarray(out["ft2"][key]).view(np.uint16)):
            fail(f"bf16 path: the card's ft2 view differs from the card's "
                 f"checkout at {key}")
    report = store2.fsck(list(refs.values()))
    if not report["ok"]:
        fail(f"bf16 path: fsck is not clean: "
             f"{ {k: report[k] for k in ('corrupt', 'missing_objects', 'refcount_drift')} }")
    print(f"bf16 path: checkouts hash-exact, max |checkout - live| "
          f"{worst:.3g}; ft2 view equals the checkout; fsck clean; cut "
          f"comparison {t5 - t4:.3f} s (host store {host_s:.3f} s); phase "
          f"took {t5 - t0:.3f} s (pool view {t3 - t2:.3f} s)", flush=True)
    missing = [k for k, key in (("delta_quantize", "bfloat16"),
                                ("dequant_apply", "bfloat16->bfloat16"),
                                ("flash_attention", "bfloat16"))
               if not by_dtype[k].get(key)]
    if missing:
        fail(f"bf16 path: no bf16 launch of {', '.join(missing)}")
    return launches


# ---------------------------------------------------------------------------
# phase 8: a paligemma-3b lineage at full width, committed, checked out and
# served through flash attention at head dim 256
# ---------------------------------------------------------------------------

VLM_ARCH = "paligemma-3b"
# depth cut for time: at all 18 layers a model is 5.02 GB in bf16; at 6
# the phase took 345 s, most of it host work (LZMA and SHA-256) on the
# 1.05 GB embed/tok, whose cost no depth cut lowers
VLM_LAYERS = 2
VLM_CHECKOUT = ("ft2",)
VLM_PROMPT = 512          # text tokens after the 256 patch embeddings
VLM_TOKENS = 16


def vlm_path(workdir, card, seed):
    """Phase 8: a bf16 lineage of paligemma-3b at full width
    (``VLM_LAYERS`` of its 18 layers) committed and checked out through the
    card's store, hash-exact (no host store: cut for time; 4d compares the
    bf16 store path with one); a ModelPool view of ft2 equal to the checkout,
    its ``probe`` equal to the probe over the widened weights; ServeEngine
    on it: prefill of 8 x (256 patches + 512 tokens), the flash kernel at
    head dim 256 with a bidirectional prefix, and 16 greedy tokens, held
    against the host engine in f32. Returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch.common import bf16
    from repro_torch.common.hashing import tensor_hash
    from repro_torch.convert import to_artifact
    from repro_torch.models import get_config
    from repro_torch.serve import ModelPool, ResidentView
    from repro_torch.store import ArtifactStore

    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    params, changed = bf16_lineage(cfg, seed + 8, task_head=False)
    n_params = sum(v.size for v in params["base"].values())
    nbytes = sum(v.nbytes for v in params["base"].values())
    print(f"vlm path: {cfg.name} {cfg.dtype} at full width ({cfg.n_layers} "
          f"of 18 layers, d_model {cfg.d_model}, {cfg.n_heads} q / "
          f"{cfg.n_kv_heads} kv heads of {cfg.resolved_head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.n_prefix_tokens} prefix tokens): "
          f"{n_params} params, {nbytes} bytes per model, {len(params)} "
          f"models made in {time.perf_counter() - t0:.3f} s; share of "
          f"elements changed from the parent "
          f"{json.dumps({k: round(v, 6) for k, v in changed.items()})}",
          flush=True)
    if min(changed.values()) <= 0.0:
        fail(f"vlm path: a finetune rounded back onto its parent: {changed}")
    root = os.path.join(workdir, "vlm")
    zero_launches()
    t0 = time.perf_counter()
    store = commit_lineage(root, cfg.name, params, chunk_threshold=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    store2, refs, out = check_out(root, VLM_CHECKOUT, chunk_threshold=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pool = ModelPool(ArtifactStore(root=root, chunk_threshold=0), verify=True)
    view = pool.get(refs["ft2"])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    patches = torch.randn((SERVE_SHAPE["B"], cfg.n_prefix_tokens,
                           cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    served = serve_view("vlm path", cfg, view.params, gen,
                        n_tokens=VLM_TOKENS, host_dtype="float32",
                        prompt=VLM_PROMPT,
                        max_len=VLM_PROMPT + VLM_TOKENS,
                        inputs={"patches": patches})
    launches = read_launches("lineage_vlm")
    by_dtype = LAUNCHES_BY_DTYPE["lineage_vlm"]
    ratio = store.compression_ratio()
    print(f"vlm path: commit {t1 - t0:.3f} s, checkout of ft2 "
          f"{t2 - t1:.3f} s, compression ratio {ratio:.3f}, ft2 view built "
          f"in {view.build_s:.3f} s ({view.private_bytes} private bytes); "
          f"{served['prefills']} prefills; launches {json.dumps(launches)}, "
          f"by dtype {json.dumps(by_dtype, sort_keys=True)} ({card})",
          flush=True)
    flash = by_dtype["flash_attention"].get("bfloat16", 0)
    if flash != cfg.n_layers * served["prefills"]:
        fail(f"vlm path: {flash} bf16 flash launches for "
             f"{served['prefills']} prefills of {cfg.n_layers} layers")
    if not by_dtype["dequant_apply"].get("bfloat16->bfloat16"):
        fail("vlm path: no bf16 dequant_apply launch")

    t4 = time.perf_counter()
    for key, value in out["ft2"].items():
        value = np.asarray(value)
        manifest = store2.get_manifest(refs["ft2"])["params"]
        if (not bf16.is_bf16(value)
                or tensor_hash(value) != manifest[key]["hash"]):
            fail(f"vlm path: ft2:{key} is not its manifest's bf16 tensor")
        if not np.array_equal(np.asarray(view.params[key]).view(np.uint16),
                              value.view(np.uint16)):
            fail(f"vlm path: the ft2 view differs from the checkout at {key}")
    report = store2.fsck(list(refs.values()))
    if not report["ok"]:
        fail(f"vlm path: fsck is not clean: "
             f"{ {k: report[k] for k in ('corrupt', 'missing_objects', 'refcount_drift')} }")
    # /predict's response: the view's probe widens its bf16 weights
    widened = to_artifact({k: bf16.widen(v) for k, v in out["ft2"].items()},
                          cfg.name)
    probe = view.probe()
    if not (np.isfinite(probe).all() and np.array_equal(
            probe, ResidentView("f32", widened, [], 0, 0.0).probe())):
        fail("vlm path: the view's probe differs from the probe over the "
             "widened weights")
    t5 = time.perf_counter()
    print(f"vlm path: ft2 checkout hash-exact and equal to its view, probe "
          f"{probe.shape} equals the widened weights' ({t5 - t4:.3f} s with "
          f"the checks), fsck clean; phase took {t5 - t0:.3f} s (pool view "
          f"{t3 - t2:.3f} s)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 9: the other families' serving at full width where one card holds it
# ---------------------------------------------------------------------------

FAMILY_PROMPT = 128
FAMILY_TOKENS = 8
# each family's configuration on the card: its layers (None: all of
# them), whether it runs at the reference's reduced() shape instead, and
# whether its own bf16 rounding drifts past the tolerance. mamba2-780m's
# does: 48 layers amplify rounding, in the reference as here, so that a
# bf16 host run lies as far from the card's bf16 run as from f32. Its
# bf16 run is held within twice the host's own bf16 drift
# (``serve_view``'s ``drift``) and the same engine runs once more in f32
# on the card, held to the f32 tolerance
FAMILY_RUNS = (("mixtral-8x7b", 1, False, False),
               ("mamba2-780m", None, False, True),
               ("seamless-m4t-large-v2", None, False, False),
               ("jamba-1.5-large-398b", None, True, False))
# at full width a disagreement of the card's MoE routing with the host's
# is allowed only where the host's K-th and (K+1)-th router logits are
# this close, relative to the magnitude of the token's router logits
# (their largest |value|: the card's bf16 error scales with it, as
# SERVE_TOL's does). At jamba's reduced width of 128 the card's router
# logits lie up to several percent from the host's, so there the rule is
# not applied: differing rows are only set aside
NEAR_TIE = 1e-2


class Routing:
    """Each MoE layer call's routing while ``record(run)`` is active (the
    model's ``moe``, wrapped): the experts each token picks, whether each
    pick kept its capacity slot, and the host's router logits.
    ``agreeing_rows`` compares the host's run with the card's."""

    def __init__(self, near_tie=NEAR_TIE):
        self.runs = {}
        self.near_tie = near_tie

    def record(self, run):
        import contextlib

        import torch

        import repro_torch.models.model as model
        from repro_torch.models.layers import route

        calls = self.runs[run] = []
        original = model.moe

        def recorded(x, p, cfg):
            B, S, D = x.shape
            logits, sel, _, _, keep, _ = route(x.reshape(B * S, D),
                                               p["router"], cfg)
            order = torch.argsort(sel, dim=-1)
            calls.append((S, torch.gather(sel, 1, order).cpu(),
                          torch.gather(keep, 1, order).cpu(),
                          logits.float().cpu()))
            return original(x, p, cfg)

        @contextlib.contextmanager
        def active():
            model.moe = recorded
            try:
                yield
            finally:
                model.moe = original
        return active()

    def agreeing_rows(self, label, rows):
        """Rows whose every token picked the same experts and kept the same
        slots in every call on host and card. Calls are compared in the
        order they ran (each prefill layer, then each decode step's); a
        row is set aside from its first difference on, since its hidden
        states, and so its later routing, differ from then. A differing
        pick in a row not yet set aside must be a near tie (``near_tie``,
        unless None) and a differing kept slot needs a differing pick in
        its call (capacity couples the rows); anything else fails, as does
        a batch with no row left."""
        import torch
        host, card = self.runs["host"], self.runs["card"]
        if len(host) != len(card):
            fail(f"{label}: {len(host)} MoE calls on the host, "
                 f"{len(card)} on the card")
        aside, picks, slots = set(), 0, 0
        worst = 0.0
        for (S, h_sel, h_keep, logits), (_, c_sel, c_keep, c_logits) in zip(
                host, card):
            K = h_sel.shape[1]
            pick = (h_sel != c_sel).any(dim=1)
            slot = ~pick & (h_keep != c_keep).any(dim=1)
            mag = logits.abs().amax(dim=-1)
            top = torch.topk(logits, K + 1, dim=-1).values
            gap = (top[:, K - 1] - top[:, K]) / mag
            diff = (c_logits - logits).abs().amax(dim=-1) / mag
            clean = torch.tensor([t // S not in aside
                                  for t in range(len(pick))])
            if clean.any():
                worst = max(worst, float(diff[clean].max()))
            far = pick & clean & (gap >= (self.near_tie or math.inf))
            if far.any():
                t = int(far.nonzero()[0])
                fail(f"{label}: token {t} routes to {h_sel[t].tolist()} on "
                     f"the host and {c_sel[t].tolist()} on the card, with a "
                     f"router-logit gap of {float(gap[t]):.3g} of their "
                     f"magnitude (near tie below {self.near_tie})")
            if slot.any() and not pick.any():
                fail(f"{label}: a capacity slot differs with no differing "
                     f"pick in its call")
            picks += int((pick & clean).sum())
            slots += int(slot.sum())
            aside.update(int(t) // S for t in (pick | slot).nonzero().flatten())
        held = [r for r in range(rows) if r not in aside]
        print(f"{label}: routing of {len(host)} MoE calls: router logits of "
              f"rows not set aside within {worst:.3g} of their magnitude of "
              f"the host's; {picks} first picks differ"
              + (", all at near ties" if self.near_tie else "")
              + f"; {slots} kept "
              f"slots differ with them; rows {sorted(aside)} set aside",
              flush=True)
        if not held:
            fail(f"{label}: no row's routing agrees")
        return held


def family_config(name, layers, reduced):
    """A family's configuration in bf16: full width at ``layers`` layers
    (None: all), or the reference's ``reduced()`` shape."""
    from repro_torch.models import get_config
    cfg = get_config(name)
    if reduced:
        return cfg.reduced(dtype="bfloat16", remat=cfg.remat)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def families_path(card, seed):
    """Phase 9: each other family's ServeEngine in bf16 on the card,
    random weights drawn there from the seed: prefill of 8 x 128 (seamless
    with 128 x 1024 frames) and 8 greedy tokens, held against the host
    engine on the same weights (two rows; an MoE's whole batch, whose
    capacity couples its rows, with its routing compared); mamba2 against
    its own drift and once more in f32 (``FAMILY_RUNS``). Returns the
    launch counts."""
    import torch

    from repro_torch.models import init_params

    zero_launches()
    t_phase = time.perf_counter()
    results = {}
    for i, (name, layers, reduced, drifts) in enumerate(FAMILY_RUNS):
        cfg = family_config(name, layers, reduced)
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(seed + 9 + i)
        flat = init_params(cfg, generator=gen)
        n_params = sum(v.numel() for v in flat.values())
        nbytes = sum(v.numel() * v.element_size() for v in flat.values())
        inputs = {}
        if cfg.family in ("encdec", "audio"):
            inputs["frames"] = torch.randn(
                (SERVE_SHAPE["B"], FAMILY_PROMPT, cfg.d_model), generator=gen,
                device="cuda").to(torch.bfloat16)
        routing = (Routing(near_tie=None if reduced else NEAR_TIE)
                   if cfg.n_experts else None)
        print(f"families: {name} ({cfg.family}) "
              + ("at the reference's reduced() shape" if reduced else
                 f"at full width, {cfg.n_layers} of "
                 f"{family_config(name, None, False).n_layers} layers")
              + f": {n_params} params, {nbytes} bytes, made in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        serve_view(
            f"families {name}", cfg, flat, gen, n_tokens=FAMILY_TOKENS,
            host_dtype="float32", prompt=FAMILY_PROMPT,
            max_len=FAMILY_PROMPT + FAMILY_TOKENS, inputs=inputs,
            host_rows=SERVE_SHAPE["B"] if routing else 2, routing=routing,
            drift=drifts)
        if drifts:
            serve_view(f"families {name} f32", dataclasses.replace(
                cfg, dtype="float32"), {k: v.float() for k, v in flat.items()},
                gen, n_tokens=FAMILY_TOKENS, prompt=FAMILY_PROMPT,
                max_len=FAMILY_PROMPT + FAMILY_TOKENS)
        del flat, inputs
        torch.cuda.empty_cache()
        results[name] = time.perf_counter() - t0
    launches = read_launches("families")
    print(f"families: phase took {time.perf_counter() - t_phase:.3f} s; "
          f"{json.dumps({k: round(v, 3) for k, v in results.items()})}; "
          f"launches {json.dumps(launches)}, by dtype "
          f"{json.dumps(LAUNCHES_BY_DTYPE['families'], sort_keys=True)} "
          f"({card})", flush=True)
    if not launches["flash_attention"]:
        fail("families: no prefill launched the flash kernel")
    return launches


# ---------------------------------------------------------------------------
# phase 4b: lineage-native serving of phase 4's lineage
# ---------------------------------------------------------------------------

def _http(url, body=None):
    """(seconds, json) of a GET (``body`` None) or a POST; raises on a
    status other than 200."""
    import urllib.request
    req = urllib.request.Request(
        url, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    return time.perf_counter() - t0, out


def _quantiles_ms(seconds):
    import numpy as np
    a = np.atleast_1d(np.asarray(seconds, np.float64)) * 1e3
    if a.size == 0:
        return "none"
    return (f"n={a.size} p50 {np.percentile(a, 50):.3f} ms, p99 "
            f"{np.percentile(a, 99):.3f} ms, max {a.max():.3f} ms")


def serve_pool(root, refs):
    """Step 1: views of ft3 and task-head built on the card, verified."""
    from repro_torch.serve import ModelPool
    from repro_torch.store import ArtifactStore

    pool = ModelPool(ArtifactStore(root=root, chunk_threshold=0), verify=True)
    chain0 = wrappers()["chain_apply"].launches
    for node in CHECKOUT:
        view = pool.get(refs[node])
        print(f"serving pool: {node} view built in {view.build_s:.3f} s, "
              f"{len(view.params)} params ({len(view.aliased)} aliased to "
              f"the base, {len(view.params) - len(view.aliased)} applied), "
              f"private {view.private_bytes} bytes", flush=True)
    stats = pool.stats()
    launches = wrappers()["chain_apply"].launches - chain0
    print(f"serving pool: base {stats['base_bytes']} bytes resident; "
          f"{json.dumps({k: stats[k] for k in ('views_built', 'params_aliased', 'params_applied', 'chain_hops', 'segments_applied', 'fused_applies', 'params_verified')})}; "
          f"chain_apply launches {launches}", flush=True)
    if stats["fused_applies"] == 0 or launches == 0:
        fail(f"serving pool: {stats['fused_applies']} fused applies and "
             f"{launches} chain_apply launches")
    return pool


def serve_http(cfg, root, refs, pool, gen):
    """Step 2: the HTTP surface over the pool, probes held against host
    views, then a publish on the branch that the watcher hot-swaps to."""
    import numpy as np

    from repro_torch.convert import to_artifact
    from repro_torch.core import LineageGraph
    from repro_torch.serve import (LineageWatcher, LocalLineageSource,
                                   ModelPool, Router, ServeApp,
                                   start_in_thread)
    from repro_torch.store import ArtifactStore

    host = ModelPool(ArtifactStore(root=root, chunk_threshold=0,
                                   backend="ref"), backend="ref")
    router = Router(pool, ["prod=branch:base", "head=node:task-head"])
    watcher = LineageWatcher(LocalLineageSource(root), router,
                             interval_s=0.2)
    app = ServeApp(router, pool, watcher)
    server, thread = start_in_thread(app)
    try:
        first = watcher.poll()
        nodes = {n: first["endpoints"][n].get("node") for n in ("prod", "head")}
        if nodes != {"prod": "ft3", "head": "task-head"}:
            fail(f"serving http: endpoints resolved to {nodes}: {first}")
        watcher.start()
        seconds = {}
        for path in ("/api/endpoints", "/api/stats"):
            seconds[path], doc = _http(server.url + path)
        for name, node in nodes.items():
            want = host.get(refs[node])
            got = pool.get(refs[node])
            if any(not np.array_equal(np.asarray(v).view(np.int32),
                                      np.asarray(want.params[k]).view(np.int32))
                   for k, v in got.params.items()):
                fail(f"serving http: the card's {node} view differs from "
                     f"the host's")
            probe = want.probe()
            for i in range(3):
                t, out = _http(f"{server.url}/api/predict/{name}", {})
                seconds.setdefault(f"predict {name}", []).append(t)
                if (out["ref"] != refs[node]
                        or out["y"] != [float(v) for v in probe.ravel()[:16]]
                        or out["mean"] != float(probe.mean())):
                    fail(f"serving http: {name} answered {out}, not the "
                         f"host view's probe")

        # publish ft4 on the branch while a client keeps predicting
        errors, latencies, last = [], [], {}
        stop = threading.Event()

        def client():
            while not stop.is_set():
                try:
                    t, out = _http(server.url + "/api/predict/prod", {})
                    latencies.append(t)
                    last.update(out)
                except Exception as exc:  # noqa: BLE001 — any drop fails
                    errors.append(repr(exc))

        hammer = threading.Thread(target=client)
        hammer.start()
        t0 = time.perf_counter()
        view = pool.get(refs["ft3"])
        ft4 = finetune(view.params, 6e-5, gen)
        writer = ArtifactStore(root=root, chunk_threshold=0)
        graph = LineageGraph(path=root, store=writer, autosave=False)
        graph.add_node(None, "ft4", model_type=cfg.name)
        graph.add_version_edge("ft3", "ft4")
        graph.add_node(to_artifact(ft4, cfg.name), "ft4")
        graph.save()            # one atomic publish of lineage.json
        ft4_ref = graph.nodes["ft4"].artifact_ref
        t1 = time.perf_counter()
        prod = router.endpoints["prod"]
        while prod.current_ref != ft4_ref and time.perf_counter() - t1 < 300:
            time.sleep(0.05)
        t2 = time.perf_counter()
        time.sleep(0.5)
        stop.set()
        hammer.join(timeout=60)
        swapped = prod.current_ref == ft4_ref
        print(f"serving http: ft4 committed + published in {t1 - t0:.3f} s, "
              f"prod swapped {t2 - t1:.3f} s later (view build "
              f"{prod.last_swap_s:.3f} s); {len(latencies)} predicts during "
              f"the swap, {len(errors)} failed: {_quantiles_ms(latencies)}",
              flush=True)
        if not swapped or errors or last.get("ref") != ft4_ref:
            fail(f"serving http: swapped={swapped}, last answer "
                 f"{last.get('node')}, errors {errors[:3]}")
        host.store.reload()     # the host pool's store predates ft4
        want = host.get(ft4_ref).probe()
        if last["y"] != [float(v) for v in want.ravel()[:16]]:
            fail("serving http: ft4's answer is not the host view's probe")
        stats = app.stats_json()
        for path, t in seconds.items():
            print(f"serving http: {path} {_quantiles_ms(t)}", flush=True)
        print(f"serving http: server latency "
              f"{json.dumps(stats['request_latency'])}; watcher "
              f"{json.dumps({k: stats['watch'][k] for k in ('polls', 'changes', 'poll_failures')})}",
              flush=True)
    finally:
        watcher.stop()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def _first_decode_pos(cfg, batch) -> int:
    """Where the engine's first decoded token goes: after the prompt, and
    after a vlm's visual prefix."""
    return batch["tokens"].shape[1] + (
        cfg.n_prefix_tokens if cfg.family == "vlm" else 0)


def _greedy_host(cfg, params, batch, n, max_len=SERVE_MAX_LEN):
    """Greedy tokens and each step's top-2 logit margin, on the host, with
    the engine's own step functions on ``batch`` (tokens, and patches or
    frames). Returns (each step's logits, the prefill's first, tokens,
    margins)."""
    import torch

    from repro_torch.serve import make_prefill_step, make_serve_step
    step = make_serve_step(cfg)
    pos = _first_decode_pos(cfg, batch)
    with torch.inference_mode():
        logits, cache = make_prefill_step(cfg, max_len)(params, batch)
        out, margins, steps = [], [], []
        for i in range(n):
            steps.append(logits.clone())
            top = torch.topk(logits, 2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).tolist())
            token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            out.append(token)
            if i < n - 1:
                _, logits, cache = step(params, cache, token, pos + i)
    return steps, torch.cat(out, dim=1), margins


def _forced_logits(cfg, params, batch, forced, max_len=SERVE_MAX_LEN):
    """Each step's logits of the engine's step functions on ``params``'
    device when step i is fed ``forced[:, i]`` (teacher forcing), on the
    host as float32: the prefill's, then one per decode step."""
    import torch

    from repro_torch.serve import make_prefill_step, make_serve_step
    step = make_serve_step(cfg)
    pos = _first_decode_pos(cfg, batch)
    with torch.inference_mode():
        logits, cache = make_prefill_step(cfg, max_len)(params, batch)
        steps = [logits.float().cpu()]
        for i in range(forced.shape[1] - 1):
            token = forced[:, i:i + 1].to(logits.device)
            _, logits, cache = step(params, cache, token, pos + i)
            steps.append(logits.float().cpu())
    return steps


def serve_engine(cfg, pool, refs, gen):
    """Steps 3 and 4: ServeEngine at full width on the card, then two rows
    against the port's own engine on the host."""
    import numpy as np
    import torch

    from repro_torch.convert import to_params
    from repro_torch.models import prefill
    from repro_torch.serve import ServeEngine

    flat = pool.get(refs["ft3"]).params
    engine = ServeEngine(cfg, to_params(flat, "cuda"), max_len=SERVE_MAX_LEN)
    flash = wrappers()["flash_attention"]
    B, S = SERVE_SHAPE["B"], SERVE_SHAPE["S"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    launches0 = flash.launches

    def timed(batch, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(batch, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    timed({"tokens": tokens}, 2)            # warm-up: cuBLAS and the kernel
    prefill_s, one = timed({"tokens": tokens}, 1)
    total_s, full = timed({"tokens": tokens}, 32)
    decode_ms = (total_s - prefill_s) / 31 * 1e3
    lengths = torch.linspace(64, S, B).to(torch.int32).to("cuda")
    pad = torch.arange(S, device="cuda")[None, :] >= lengths[:, None]
    ragged_tokens = tokens.masked_fill(pad, 0)
    ragged_s, ragged = timed({"tokens": ragged_tokens, "lengths": lengths}, 16)
    launches = flash.launches - launches0
    print(f"serving engine: {cfg.name} f32 ft3 view, batch {B} x {S} "
          f"prompt: prefill {prefill_s:.4f} s, 32 tokens in {total_s:.4f} s "
          f"({decode_ms:.3f} ms per decode step, {B * 32 / total_s:.1f} "
          f"tokens/s); ragged batch (lengths "
          f"{lengths.tolist()}) 16 tokens in {ragged_s:.4f} s "
          f"({B * 16 / ragged_s:.1f} tokens/s); flash launches {launches}",
          flush=True)
    for name, out, n in (("full", full, 32), ("ragged", ragged, 16)):
        if (tuple(out.shape) != (B, n) or out.dtype != torch.int32
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size):
            fail(f"serving engine: {name} batch gave {out.dtype}"
                 f"{tuple(out.shape)} tokens")
    if not torch.equal(full[:, :1], one):
        fail("serving engine: generate(1) is not the first of generate(32)")
    if launches == 0:
        fail("serving engine: prefill launched no flash_attention kernel")

    # step 4: two rows against the port's engine functions on the host
    rows = tokens[:2]
    with torch.inference_mode():
        card_logits, _ = prefill(cfg, engine.params, {"tokens": rows},
                                 SERVE_MAX_LEN)
    host_params = to_params(flat, "cpu")
    t0 = time.perf_counter()
    host_steps, host_tokens, margins = _greedy_host(
        cfg, host_params, {"tokens": rows.cpu()}, 32)
    host_logits = host_steps[0]
    host_s = time.perf_counter() - t0
    card_logits = card_logits.cpu()
    if not (torch.isfinite(card_logits).all() and
            torch.isfinite(host_logits).all()):
        fail("serving engine: non-finite logits")
    err = float((card_logits - host_logits).abs().max())
    near = []
    for r in range(2):
        got, want = full[r].cpu().tolist(), host_tokens[r].tolist()
        diverged = next((i for i in range(32) if got[i] != want[i]), None)
        if diverged is None:
            continue
        near.append((r, diverged, margins[diverged][r]))
        if margins[diverged][r] >= SERVE_LOGIT_TOL:
            fail(f"serving engine: row {r} step {diverged}: card token "
                 f"{got[diverged]} vs host {want[diverged]} with a host "
                 f"top-2 margin of {margins[diverged][r]}")
    print(f"serving engine: host run of 2 rows in {host_s:.3f} s; last-token "
          f"prefill logits max |card - host| {err:.3g} (tolerance "
          f"{SERVE_LOGIT_TOL}); greedy tokens "
          f"{'equal over all 32 steps' if not near else 'equal up to near ties'}"
          f"{''.join(f'; row {r} diverges at step {i} (host top-2 margin {m:.3g})' for r, i, m in near)}",
          flush=True)
    if not err <= SERVE_LOGIT_TOL:
        fail(f"serving engine: prefill logits differ by {err}")
    del engine


def serving_path(cfg, workdir, seed):
    """Phase 4b. Returns the launch counts of its run."""
    import torch

    from repro_torch.core import LineageGraph
    from repro_torch.store import ArtifactStore

    root = os.path.join(workdir, "whole")
    graph = LineageGraph(path=root, store=ArtifactStore(
        root=root, chunk_threshold=0, backend="ref"))
    refs = {n: graph.nodes[n].artifact_ref for n in graph.nodes}
    gen = torch.Generator().manual_seed(seed + 1)
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    zero_launches()
    t0 = time.perf_counter()
    pool = serve_pool(root, refs)
    serve_http(cfg, root, refs, pool, gen)
    serve_engine(cfg, pool, refs, cuda_gen)
    torch.cuda.synchronize()
    launches = read_launches("serving")
    print(f"serving: phase took {time.perf_counter() - t0:.3f} s, launches "
          f"{json.dumps(launches)}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: continuous checkpointing of a training run
# ---------------------------------------------------------------------------

BIG_LEAVES = 24          # 8 parameters of 64 KiB or more x params, mu, nu


def _span_seconds(name):
    from repro_torch.obs import export_chrome_trace
    return [e["dur"] / 1e6 for e in export_chrome_trace()["traceEvents"]
            if e.get("name") == name and e.get("ph") == "X"]


def _commit_bytes(store, refs):
    """Bytes each commit added to the CAS: the objects of its manifest
    closure that no earlier commit's closure holds."""
    seen, out = set(), []
    for ref in refs:
        keys = set(store.expected_refcounts([ref]))
        out.append(sum(store.cas.size(k) for k in keys - seen))
        seen |= keys
    return out


def _step_refs(cm):
    return [cm.lineage.nodes[cm._node_name(s)].artifact_ref
            for s in sorted(cm._steps())]


def _fsck(label, cm):
    report = cm.store.fsck(_step_refs(cm))
    if not report["ok"]:
        fail(f"{label}: fsck is not clean: "
             f"{ {k: report[k] for k in ('corrupt', 'missing_objects', 'refcount_drift')} }")


def _overhead(tier):
    from repro_torch.store import CKPT_OVERHEAD
    _, total, count = CKPT_OVERHEAD[tier].snapshot()
    return total, count


def _within_grid(label, cm, step, restored, live):
    """Every leaf of ``restored`` (a state on the card) within one
    quantization step of the host flat ``live``; nu leaves committed in
    the log domain are compared there. Returns the largest error over the
    step of its leaf's grid."""
    import numpy as np

    from repro_torch.kernels.ref import quant_scale
    from repro_torch.store import flatten_state

    manifest = cm.store.get_manifest(
        cm.lineage.nodes[cm._node_name(step)].artifact_ref)
    transforms = manifest["metadata"].get("transforms", {})
    flat = flatten_state(restored)
    worst = 0.0
    for key, value in live.items():
        got = flat[key]
        if got.dtype != value.dtype or got.shape != value.shape:
            fail(f"{label}: {key} restored as {got.dtype}{got.shape}")
        if value.dtype != np.float32:
            if got.tobytes() != value.tobytes():
                fail(f"{label}: {key} differs from the live state")
            continue
        a, b = got.astype(np.float64), value.astype(np.float64)
        if transforms.get(key) == "log1p":
            a, b = np.log1p(a), np.log1p(b)
        entry = manifest["params"][key]
        grid = quant_scale(entry.get("eps", cm.store.eps))
        err = float(np.abs(a - b).max()) / grid
        worst = max(worst, err)
        if not np.isfinite(a).all() or err > 1.0:
            fail(f"{label}: {key} is {err} quantization steps from the "
                 f"live state")
    return worst


def whole_tensor_store(root):
    """The checkpoint manager's store with the chunk engine off: every
    leaf commits as a whole-tensor step delta (xdelta in the exact tier, an
    int8 delta whose truth the dequant kernel computes in the lossy tier).
    With the default 8 MiB threshold the large leaves go through the host
    chunk engine, which never reaches the dequant kernel."""
    from repro_torch.store import ArtifactStore
    return ArtifactStore(root=root, t_thr=float("inf"), chunk_threshold=0)


def train(tr, steps, every=2):
    """``steps`` steps in runs of ``every``, moving ``tr.start_step`` on
    after each. A run ends by waiting for its commit, so no save coalesces
    into the next. Returns the runs' history."""
    hist = {"loss": [], "step_time": []}
    for _ in range(steps // every):
        for k, v in tr.run(every).items():
            hist[k] += v
        tr.start_step += every
    return hist


def checkpoint_path(cfg, workdir, card, seed):
    """Phase 6, at full width and ``CHECKPOINT_LAYERS`` of the 12 layers.
    Returns the launch counts of its run."""
    import torch

    from repro_torch.common.tree import leaves
    from repro_torch.obs import reset_trace, tracing
    from repro_torch.store import CKPT_STATS, CheckpointManager, flatten_state
    from repro_torch.train import Trainer

    print(f"checkpoint: depth cut to {CHECKPOINT_LAYERS} of {cfg.n_layers} "
          f"layers", flush=True)
    cfg = dataclasses.replace(cfg, n_layers=CHECKPOINT_LAYERS)

    fp = wrappers()["fingerprint"]
    zero_launches()
    stats0 = CKPT_STATS.snapshot()
    over0 = _overhead("exact")
    root = os.path.join(workdir, "ckpt-exact")
    with tracing():
        reset_trace()
        t0 = time.perf_counter()
        tr = Trainer(cfg, batch=8, seq=128, checkpoint_dir=root,
                     commit_every=2, seed=seed)
        t1 = time.perf_counter()
        hist = train(tr, 6)         # commits at steps 2, 4 and 6
        t2 = time.perf_counter()
        if fp.launches != 3 * BIG_LEAVES:
            fail(f"checkpoint: {fp.launches} fingerprint launches in 3 saves "
                 f"(expected {BIG_LEAVES} per save)")
        # one run of 6 steps, as a user calls it: the saves at 8, 10 and 12
        # come faster than the commits, so the pending one coalesces
        coalesced0 = int(CKPT_STATS["coalesced"])
        more = tr.run(6)
        t3 = time.perf_counter()
        coalesced = int(CKPT_STATS["coalesced"]) - coalesced0
        steps = sorted(tr.ckpt._steps())
        if (coalesced < 1 or len(steps) != 6 - coalesced or steps[-1] != 12
                or fp.launches != 6 * BIG_LEAVES):
            fail(f"checkpoint: run(6) committed steps {steps} with "
                 f"{coalesced} coalesced saves and {fp.launches} fingerprint "
                 f"launches in 6 saves (expected at least one coalesced "
                 f"save, the last commit at 12 and {BIG_LEAVES} launches "
                 f"per save)")
        skipped0 = int(CKPT_STATS["leaves_skipped"])
        tr.ckpt.save(13, tr.state)  # unchanged state: every big leaf skips
        tr.ckpt.wait()
        skipped = int(CKPT_STATS["leaves_skipped"]) - skipped0
        commit_s = _span_seconds("ckpt.commit")
        snapshot_s = _span_seconds("ckpt.snapshot")
    if fp.launches != 7 * BIG_LEAVES or skipped != BIG_LEAVES:
        fail(f"checkpoint: unchanged save skipped {skipped} leaves with "
             f"{fp.launches} fingerprint launches in 7 saves (expected "
             f"{BIG_LEAVES} skipped and {BIG_LEAVES} launches per save)")
    if tr.elastic.restarts:
        fail(f"checkpoint: the straggler policy restarted the run: "
             f"{tr.elastic.restarts}")
    total, count = _overhead("exact")
    state_bytes = sum(v.numel() * v.element_size()
                      for v in leaves(tr.state))
    print(f"checkpoint: {cfg.name} f32 state of {state_bytes} bytes, trainer "
          f"built in {t1 - t0:.3f} s, 6 steps + 3 commits in {t2 - t1:.3f} s, "
          f"run(6) + its commits in {t3 - t2:.3f} s with {coalesced} "
          f"coalesced save(s), committed steps {steps} ({card})", flush=True)
    print(f"checkpoint: loss per step {json.dumps(hist['loss'] + more['loss'])}",
          flush=True)
    print(f"checkpoint: seconds per step "
          f"{json.dumps(hist['step_time'] + more['step_time'])}", flush=True)
    print(f"checkpoint: save-side blocking {total - over0[0]:.6f} s over "
          f"{count - over0[1]} saves; snapshot spans {json.dumps(snapshot_s)}",
          flush=True)
    print(f"checkpoint: seconds per commit {json.dumps(commit_s)}; stored "
          f"bytes per commit "
          f"{json.dumps(_commit_bytes(tr.ckpt.store, _step_refs(tr.ckpt)))}",
          flush=True)
    if not all(map(math.isfinite, hist["loss"] + more["loss"])):
        fail("checkpoint: the loss is not finite")

    # a fresh manager restores the last commit bit for bit onto the card
    t0 = time.perf_counter()
    cm = CheckpointManager(root, model_name=cfg.name)
    restored, step = cm.restore(verify=True, template=tr.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    live = flatten_state(tr.state)
    for leaf in leaves(restored):
        if leaf.device != tr.device:
            fail(f"checkpoint: a restored leaf lies on {leaf.device}")
    got = flatten_state(restored)
    if step != 13 or list(got) != list(live) or any(
            got[k].dtype != v.dtype or got[k].tobytes() != v.tobytes()
            for k, v in live.items()):
        fail(f"checkpoint: the restore of step {step} is not the live state "
             f"bit for bit")
    _fsck("checkpoint", cm)
    print(f"checkpoint: restore (verify=True) of step {step} in "
          f"{restore_s:.3f} s, bit-identical on {tr.device}, fsck clean",
          flush=True)
    exact_launches = read_launches()
    del restored, got, cm

    # the lossy tier, through a whole-tensor store: keyframe, lossy commit,
    # keyframe
    lossy_over0 = _overhead("lossy")
    root = os.path.join(workdir, "ckpt-lossy")
    trl = Trainer(cfg, batch=8, seq=128, checkpoint_dir=root, commit_every=2,
                  seed=seed, lossy_tier=True, keyframe_every=2)
    trl.ckpt = CheckpointManager(root, model_name=cfg.name, tier="lossy",
                                 keyframe_every=2,
                                 store=whole_tensor_store(root))
    t0 = time.perf_counter()
    train(trl, 4)
    live4 = flatten_state(trl.state)
    train(trl, 2)
    t1 = time.perf_counter()
    if wrappers()["dequant_apply"].launches == exact_launches["dequant_apply"]:
        fail("checkpoint: the lossy commits launched no dequant_apply")
    cml = CheckpointManager(root, model_name=cfg.name, tier="lossy",
                            keyframe_every=2)
    lossy = [bool(cml.store.get_manifest(r)["metadata"].get("lossy"))
             for r in _step_refs(cml)]
    if lossy != [False, True, False]:
        fail(f"checkpoint: lossy flags of the three commits are {lossy}")
    state4, step = cml.restore(step=4, template=trl.state, allow_lossy=True)
    err4 = _within_grid("checkpoint lossy step 4", cml, 4, state4, live4)
    del state4
    _, back = cml.restore(step=4, template=trl.state)
    if back != 2:
        fail(f"checkpoint: restore of lossy step 4 resolved to {back}, not "
             f"the keyframe at 2")
    state6, step = cml.restore(template=trl.state, allow_lossy=True)
    err6 = _within_grid("checkpoint lossy step 6", cml, 6, state6,
                        flatten_state(trl.state))
    _fsck("checkpoint lossy", cml)
    total, count = _overhead("lossy")
    print(f"checkpoint lossy: 6 steps + 3 commits in {t1 - t0:.3f} s, "
          f"save-side blocking {total - lossy_over0[0]:.6f} s over "
          f"{count - lossy_over0[1]} saves, stored bytes per commit "
          f"{json.dumps(_commit_bytes(cml.store, _step_refs(cml)))}; "
          f"restore of lossy step 4 within {err4:.4f} and of keyframe 6 "
          f"within {err6:.4f} quantization steps of the live state, fsck "
          f"clean", flush=True)
    if fp.launches != 10 * BIG_LEAVES:
        fail(f"checkpoint: {fp.launches} fingerprint launches in 10 saves")
    launches = read_launches("checkpoint")
    stats = {k: v - stats0.get(k, 0) for k, v in CKPT_STATS.snapshot().items()}
    print(f"checkpoint: CKPT_STATS {json.dumps(stats)}; launches "
          f"{json.dumps(launches)}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 7: the paper's update workflow (Figure 4, Algorithm 2) at full width
# ---------------------------------------------------------------------------

WORKFLOW_STEPS = 2       # train steps that make each model version
PROBE_BATCH, PROBE_SEQ = 8, 128
# an honest version (a few train steps on another seed) moves the probe's
# loss by far less than this many nats; the poisoned lm_head (x 100)
# moves it by hundreds
GATE_TOL = 0.5
WORKFLOW_ARCH = "paper-bert"
# phase 7's depth, cut for time (its commits and probe tests are host work
# that scales with the layers): 2 of paper-bert's 12 layers, full width
WORKFLOW_LAYERS = 2


def workflow_config():
    from repro_torch.models import get_config
    return dataclasses.replace(get_config(WORKFLOW_ARCH), dtype="float32",
                               n_layers=WORKFLOW_LAYERS)


def probe_score(model) -> float:
    """The registered test of every node: the negated mean next-token loss
    of a fixed probe batch (8 prompts of 128 tokens, each scored on its
    129th), from ``models.prefill`` logits on the card, so the flash
    kernel runs inside the diagnostics."""
    import numpy as np
    import torch

    from repro_torch.convert import to_params
    from repro_torch.models import prefill
    from repro_torch.train.step import cross_entropy
    cfg = workflow_config()
    tokens = torch.from_numpy(np.random.default_rng(2024).integers(
        0, cfg.vocab_size, (PROBE_BATCH, PROBE_SEQ + 1))).to("cuda")
    params = to_params(model.params, "cuda")
    with torch.inference_mode():
        logits, _ = prefill(cfg, params, {"tokens": tokens[:, :-1]},
                            PROBE_SEQ)
        return -float(cross_entropy(logits[:, None], tokens[:, -1:]))


def train_flat(cfg, flat, seed, device="cuda"):
    """{key: f32 numpy}: ``flat`` (a model's params, or None for a fresh
    init from ``seed``) after ``WORKFLOW_STEPS`` steps of the port's train
    step on ``device`` (batch 8, sequence 128, AdamW without warmup)."""
    import torch

    from repro_torch.convert import to_numpy, to_params
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.model import flat_paths
    from repro_torch.optim import adamw
    from repro_torch.train.step import init_state, make_train_step

    if flat is None:
        state = init_state(cfg, seed=seed, device=device)
    else:
        params = to_params(dict(flat.items()), device)
        state = {"params": params, "opt": adamw.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
    step = make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0))
    pipe = SyntheticPipeline(cfg, batch=8, seq=128, seed=seed, device=device)
    for _ in range(WORKFLOW_STEPS):
        state, metrics = step(state, next(pipe))
        if not math.isfinite(float(metrics["loss"])):
            fail(f"workflow: training loss {float(metrics['loss'])}")
    return {k: to_numpy(v) for k, v in flat_paths(state["params"]).items()}


def workflow_types():
    """The creation function of every derived node, registered by name as
    ``examples/finetune_cascade.py`` registers its own: train the parent
    for ``WORKFLOW_STEPS`` steps on the task's seed. ``poison`` multiplies
    lm_head by 100 (a regression by construction); ``boom`` raises."""
    from repro_torch.convert import to_artifact
    from repro_torch.core import CreationFunction, register_creation_type

    @register_creation_type("smoke-finetune")
    class Finetune(CreationFunction):
        seconds = 0.0

        def __call__(self, parents):
            t0 = time.perf_counter()
            if self.config.get("boom"):
                raise RuntimeError(f"creation function of seed "
                                   f"{self.config['seed']} failed")
            flat = train_flat(workflow_config(), parents[0].get_model().params,
                              self.config["seed"])
            if self.config.get("poison"):
                flat["lm_head"] = flat["lm_head"] * 100
            Finetune.seconds += time.perf_counter() - t0
            return to_artifact(flat, WORKFLOW_ARCH)

    return Finetune


def edit_of(parent, keys, gen, layers=None):
    """{key: f32 numpy}: ``parent`` with phase 4's sparse finetune noise on
    ``keys`` only, on their first ``layers`` rows when given."""
    import numpy as np
    out = {k: np.asarray(v) for k, v in parent.items()}
    for k in keys:
        value = out[k].copy()
        part = value[:layers] if layers else value
        part[...] = finetune({k: part}, 1e-4, gen)[k]
        out[k] = value
    return out


def _result_errors(runner):
    return [(r.get("node"), r.get("test"), r["error"])
            for r in runner.ledger.entries() if r.get("error") is not None]


def workflow_cascade(g, Finetune, gate, runner, seed):
    """Step 3: the gated update cascade base -> base@v2. Prints its
    seconds split into creation functions, commits and gate; returns the
    new names and the cascade's seconds."""
    import torch

    from repro_torch.convert import to_artifact
    from repro_torch.diag import is_quarantined
    from repro_torch.obs import reset_trace, tracing

    old = {n: g.nodes[n].artifact_ref for n in g.nodes}
    g.nodes["task-b"].creation_fn.config["poison"] = True
    g.add_node(to_artifact(train_flat(workflow_config(), g.get_model(
        "base").params, seed + 20), WORKFLOW_ARCH), "base@v2")
    g.add_version_edge("base", "base@v2")
    gate_s = [0.0]
    apply = gate.apply

    def timed_apply(node):
        t0 = time.perf_counter()
        try:
            return apply(node)
        finally:
            gate_s[0] += time.perf_counter() - t0
    gate.apply = timed_apply
    Finetune.seconds = 0.0
    with tracing():
        reset_trace()
        t0 = time.perf_counter()
        created = g.run_update_cascade("base", "base@v2", gate=gate)
        torch.cuda.synchronize()
        cascade_s = time.perf_counter() - t0
        commit_s = sum(_span_seconds("store.commit"))
    gate.apply = apply
    want = ["task-a@v2", "task-b@v2", "task-a-sub@v2"]
    if sorted(created) != sorted(want) or \
            g.nodes["task-a-sub@v2"].parents != ["task-a@v2"]:
        fail(f"workflow cascade: created {created}, task-a-sub@v2's parents "
             f"{g.nodes.get('task-a-sub@v2') and g.nodes['task-a-sub@v2'].parents}")
    quarantined = sorted(n for n in g.nodes if is_quarantined(g.nodes[n]))
    decision = {d.node: d for d in gate.decisions}
    kinds = [(r.kind, r.error) for r in decision["task-b@v2"].regressions]
    if quarantined != ["task-b@v2"] or kinds != [("metric_drop", None)]:
        fail(f"workflow cascade: quarantined {quarantined}, task-b@v2's "
             f"regressions {kinds}")
    errors = _result_errors(runner)
    if errors:
        fail(f"workflow cascade: test results with errors {errors}")
    if any(g.nodes[n].artifact_ref != ref for n, ref in old.items()):
        fail("workflow cascade: an old version's manifest changed")
    values = {d.node: {t: r.value for t, r in d.results.items()}
              for d in gate.decisions}
    baselines = {n: runner.run_one(g.nodes[n], g.tests[0]).value
                 for n in ("task-a", "task-b", "task-a-sub")}
    spread = max(abs(values[f"{n}@v2"]["probe"] - baselines[n])
                 for n in ("task-a", "task-a-sub"))
    print(f"workflow cascade: created {created} in {cascade_s:.3f} s "
          f"(creation functions {Finetune.seconds:.3f} s, commits "
          f"{commit_s:.3f} s including their tests, gate "
          f"{gate_s[0]:.3f} s); quarantined {quarantined} "
          f"({decision['task-b@v2'].regressions[0].to_json()}); probe "
          f"scores {json.dumps(values)}, old versions "
          f"{json.dumps(baselines)}; honest versions moved by at most "
          f"{spread:.6f} (gate tol {GATE_TOL})", flush=True)
    if spread >= GATE_TOL:
        fail(f"workflow cascade: honest versions moved by {spread}")
    executed, hits = runner.stats["executed"], runner.stats["memo_hits"]
    for n in created:
        gate.check(n)
    if runner.stats["executed"] != executed or runner.stats["memo_hits"] <= hits:
        fail(f"workflow cascade: the repeated gate check executed "
             f"{runner.stats['executed'] - executed} tests")
    print(f"workflow cascade: the repeated gate check executed 0 tests "
          f"({runner.stats['memo_hits'] - hits} memo hits)", flush=True)
    return created, cascade_s


def workflow_rollback(g, root, Finetune, seed):
    """Step 4: a cascade base@v2 -> base@v3 whose third creation function
    raises must leave no empty node behind in the persisted lineage."""
    from repro_torch.convert import to_artifact
    from repro_torch.core import LineageGraph

    g.add_node(to_artifact(train_flat(workflow_config(), g.get_model(
        "base@v2").params, seed + 30), WORKFLOW_ARCH), "base@v3")
    g.add_version_edge("base@v2", "base@v3")
    g.nodes["task-a-sub@v2"].creation_fn = Finetune(seed=seed + 13,
                                                    boom=True)
    t0 = time.perf_counter()
    try:
        g.run_update_cascade("base@v2", "base@v3",
                             skip_fn=lambda n: n.name == "task-b@v2")
    except RuntimeError as exc:
        raised = str(exc)
    else:
        fail("workflow rollback: the raising creation function did not "
             "propagate")
    rollback_s = time.perf_counter() - t0
    reloaded = LineageGraph(path=root, store=g.store)
    empty = sorted(n for n, node in reloaded.nodes.items()
                   if node.artifact_ref is None)
    if empty or "task-a-sub@v3" in reloaded.nodes or \
            "task-a@v3" not in reloaded.nodes:
        fail(f"workflow rollback: empty nodes {empty}, nodes "
             f"{sorted(reloaded.nodes)}")
    refs = [n.artifact_ref for n in reloaded.nodes.values()]
    report = reloaded.store.fsck(refs)
    if not report["ok"]:
        fail(f"workflow rollback: fsck {report}")
    print(f"workflow rollback: '{raised}' propagated after "
          f"{rollback_s:.3f} s; task-a@v3 kept, no empty node in the "
          f"reloaded lineage ({len(reloaded.nodes)} nodes), fsck clean",
          flush=True)


def workflow_merge_diff(g, root, seed):
    """Step 5: merge two disjoint edits of base, a conflicting pair, and
    diff on the card against the host."""
    import numpy as np
    import torch

    from repro_torch.convert import to_artifact
    from repro_torch.core import (CONFLICT, NO_CONFLICT, LineageGraph, merge,
                                  merge_artifacts, module_diff)
    from repro_torch.core.merge import compute_changeset
    from repro_torch.store import ArtifactStore

    gen = torch.Generator().manual_seed(seed + 40)
    base = g.get_model("base").params
    trunk = [k for k in base if k.startswith("layers/")]
    # edit-b changes the token embedding: a contextual hash never sees
    # the content of a key without a "/" (lm_head, final_norm), in the
    # reference as here, so a lm_head-only edit would merge as no change
    edits = {"edit-a": edit_of(base, trunk, gen,
                               layers=max(1, WORKFLOW_LAYERS // 2)),
             "edit-b": edit_of(base, ["embed/tok"], gen)}
    for name, flat in edits.items():
        g.add_node(to_artifact(flat, WORKFLOW_ARCH), name)
        g.add_edge("base", name)
    # merge what the store holds: a graph reloaded from lineage.json
    # checks every model out of the phase's store
    fresh = LineageGraph(path=root, store=g.store)
    fresh.tests = list(g.tests)
    t0 = time.perf_counter()
    result = merge(fresh, "edit-a", "edit-b",
                   test_threshold=-2 * math.log(workflow_config().vocab_size))
    merge_s = time.perf_counter() - t0
    if result.status != NO_CONFLICT or "merge(edit-a,edit-b)" not in fresh:
        fail(f"workflow merge: {result.status} ({result.detail}), "
             f"{result.test_results}")
    picks = {"edit-a": trunk, "edit-b": ["embed/tok"]}
    for key, value in result.merged.params.items():
        src = next((n for n, keys in picks.items() if key in keys), "base")
        want = np.asarray(fresh.get_model(src).params[key])
        if not np.array_equal(np.asarray(value).view(np.int32),
                              want.view(np.int32)):
            fail(f"workflow merge: {key} is not {src}'s")
    ancestor = fresh.get_model("base")
    edit_c = to_artifact(edit_of(ancestor.params, ["layers/attn/wq"], gen,
                                 layers=1), WORKFLOW_ARCH)
    conflict = merge_artifacts(ancestor, fresh.get_model("edit-a"), edit_c)
    if conflict.status != CONFLICT or "layers/attn" not in \
            conflict.conflicting_layers:
        fail(f"workflow merge: a pair that both change layer 0 gave "
             f"{conflict.status} {conflict.conflicting_layers}")
    print(f"workflow merge: edit-a (first {max(1, WORKFLOW_LAYERS // 2)} "
          f"encoder layers) + edit-b "
          f"(token embedding) -> {result.status} ({result.detail}, probe "
          f"{json.dumps(result.test_results)}) in {merge_s:.3f} s, every "
          f"merged tensor is its pick bit for bit; edit-a + a layer-0 "
          f"edit -> {conflict.status} {conflict.conflicting_layers}",
          flush=True)

    # diff on the card's checkouts against the host's
    summaries = {}
    for label, kw in (("card", {}), ("host", {"backend": "ref"})):
        store = ArtifactStore(root=root, chunk_threshold=0, **kw)
        a, b = (store.materialize_artifact(g.nodes[n].artifact_ref)
                for n in ("base", "task-a"))
        for art in (a, b):
            art.param_hashes(recompute=True)
        summaries[label] = {
            mode: (d.matched_nodes, d.add_nodes, d.del_nodes, d.divergence)
            for mode, d in ((m, module_diff(a, b, mode=m))
                            for m in ("structural", "contextual"))}
        summaries[label]["changed"] = sorted(compute_changeset(a, b).changed)
    if summaries["card"] != summaries["host"]:
        fail(f"workflow diff: card {summaries['card']} vs host "
             f"{summaries['host']}")
    print(f"workflow diff: base -> task-a equal on card and host checkouts: "
          f"{json.dumps(summaries['card'])}", flush=True)
    return merge_s


def workflow_auto_insert(g, seed):
    """Step 6: a further finetune of task-b@v2, made outside the graph,
    must be inserted under task-b@v2."""
    from repro_torch.convert import to_artifact
    from repro_torch.core import auto_insert

    art = to_artifact(train_flat(workflow_config(), g.get_model(
        "task-b@v2").params, seed + 50), WORKFLOW_ARCH)
    n = len(g.nodes)
    t0 = time.perf_counter()
    parent = auto_insert(g, art, "task-b-ft")
    auto_s = time.perf_counter() - t0
    if parent != "task-b@v2":
        fail(f"workflow auto_insert: chose {parent}, not task-b@v2")
    print(f"workflow auto_insert: parent task-b@v2 chosen among {n} nodes "
          f"in {auto_s:.3f} s (every node checked out and diffed)",
          flush=True)
    return auto_s


def workflow_checkout(root, names):
    """Step 7: a fresh store checks out every new node, hash-exact and
    equal to the host's checkout; fsck is clean with the ledger in it."""
    import numpy as np

    from repro_torch.common.hashing import tensor_hash
    from repro_torch.core import LineageGraph
    from repro_torch.store import ArtifactStore

    store = ArtifactStore(root=root, chunk_threshold=0)
    host = ArtifactStore(root=root, chunk_threshold=0, backend="ref")
    g = LineageGraph(path=root, store=store)
    t0 = time.perf_counter()
    for name in names:
        ref = g.nodes[name].artifact_ref
        manifest = store.get_manifest(ref)["params"]
        got = store.materialize_artifact(ref).params
        want = host.materialize_artifact(ref).params
        for key, value in got.items():
            value = np.asarray(value)
            if tensor_hash(value) != manifest[key]["hash"] or \
                    not np.array_equal(value.view(np.int32),
                                       np.asarray(want[key]).view(np.int32)):
                fail(f"workflow checkout: {name}:{key} differs from its "
                     f"manifest or the host's checkout")
    checkout_s = time.perf_counter() - t0
    refs = [n.artifact_ref for n in g.nodes.values()]
    report = store.fsck(refs)
    ledger = [k for k in store.cas.keys() if k.startswith("t_")]
    if not report["ok"] or not ledger:
        fail(f"workflow checkout: fsck "
             f"{ {k: report[k] for k in ('ok', 'corrupt', 'missing_objects', 'refcount_drift')} }, "
             f"{len(ledger)} ledger entries")
    print(f"workflow checkout: {len(names)} new nodes checked out on the "
          f"card and the host in {checkout_s:.3f} s, hash-exact and equal; "
          f"fsck clean over {len(refs)} models and {len(ledger)} ledger "
          f"entries; compression ratio {store.compression_ratio():.3f}",
          flush=True)


def workflow_path(workdir, card, seed):
    """Phase 7. Returns the launch counts of its run."""
    import torch

    from repro_torch.convert import to_artifact
    from repro_torch.core import LineageGraph
    from repro_torch.diag import DiagnosticsRunner, TestGate
    from repro_torch.store import ArtifactStore

    cfg = workflow_config()
    Finetune = workflow_types()
    root = os.path.join(workdir, "workflow")
    zero_launches()
    t0 = time.perf_counter()
    # a tensor cache that holds a few models (the default holds 256 MiB,
    # less than one): the gate checks out each new version and its
    # version parent, which share most of their delta chain
    g = LineageGraph(path=root, store=ArtifactStore(
        root=root, chunk_threshold=0, cache_budget_bytes=4 * 2**30))
    g.register_test_function(probe_score, "probe", mt=cfg.name)
    g.add_node(to_artifact(train_flat(cfg, None, seed), cfg.name), "base")
    for name, parent, task_seed in (("task-a", "base", 1), ("task-b", "base", 2),
                                    ("task-a-sub", "task-a", 3)):
        fn = Finetune(seed=seed + task_seed)
        g.add_node(fn([g.nodes[parent]]), name, cr=fn)
        g.add_edge(parent, name)
    print(f"workflow: {cfg.name} f32 (depth cut to {cfg.n_layers} layers) "
          f"lineage base -> task-a -> task-a-sub, base -> task-b in "
          f"{time.perf_counter() - t0:.3f} s ({card})", flush=True)
    runner = DiagnosticsRunner(g)
    gate = TestGate(graph=g, runner=runner, tol=GATE_TOL)
    created, cascade_s = workflow_cascade(g, Finetune, gate, runner, seed)
    workflow_rollback(g, root, Finetune, seed)
    auto_s = workflow_auto_insert(g, seed)
    merge_s = workflow_merge_diff(g, root, seed)
    workflow_checkout(root, created + ["task-a@v3", "task-b-ft",
                                       "merge(edit-a,edit-b)"])
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t0
    launches = read_launches("workflow")
    print(f"workflow: phase took {phase_s:.3f} s (cascade {cascade_s:.3f} s, "
          f"auto_insert {auto_s:.3f} s, merge {merge_s:.3f} s); launches "
          f"{json.dumps(launches)}; delta_quantize "
          f"{'launched: the poisoned commit overflowed int8' if launches['delta_quantize'] else 'not launched: no commit overflowed int8'}",
          flush=True)
    missing = [k for k in ("snapshot_fused", "dequant_apply", "chain_apply",
                           "flash_attention") if launches[k] == 0]
    if missing:
        fail(f"workflow launched no {', '.join(missing)} kernel")
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # f32 products in full f32 on the card (no TF32), and 16-bit products
    # summed in f32 (no reduced-precision reduction), as on the host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.kernels import build
    from repro_torch.models import get_config

    # phase 1: device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # phase 2: build, one nvcc per source, all at once
    t0 = time.perf_counter()
    seconds = build.build()
    print(f"build: {time.perf_counter() - t0:.3f} s wall "
          f"({json.dumps({k: round(v, 3) for k, v in seconds.items()})}); "
          f"flash_attention {seconds['flash_attention']:.3f} s", flush=True)
    for name in build.SOURCES:
        log = (build.build_dir() / f"{name}.log").read_text().strip()
        if name == "flash_attention":
            tensor_core_report(build, log)
        else:
            print(f"ptxas {name}: {' | '.join(log.splitlines()[-4:])}",
                  flush=True)

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = check_kernels(gen)
    timing = time_kernels(gen)

    # phases 4 and 5: the main path at full width
    cfg = dataclasses.replace(get_config("paper-bert"), dtype="float32")
    t0 = time.perf_counter()
    params = make_lineage(cfg, args.seed)
    n_params = sum(v.size for v in params["base"].values())
    print(f"lineage: {cfg.name} f32, {n_params} params per model, "
          f"{len(NODES)} models, made in {time.perf_counter() - t0:.3f} s",
          flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip-smoke-",
                               dir=os.path.join(ROOT, "build"))
    try:
        launches = {"lineage": main_path(cfg, params, workdir, card)}
        launches["serving"] = serving_path(cfg, workdir, args.seed)
        launches["lineage_f16"] = f16_path(cfg, params, workdir, card)
        launches["lineage_bf16"] = bf16_path(workdir, card, args.seed)
        launches["lineage_vlm"] = vlm_path(workdir, card, args.seed)
        launches["families"] = families_path(card, args.seed)
        chunked_path(cfg, params, workdir)
        del params
        launches["checkpoint"] = checkpoint_path(cfg, workdir, card,
                                                 args.seed)
        launches["workflow"] = workflow_path(workdir, card, args.seed)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    replaces = {
        "snapshot_fused": ("snapshot_fused.cu",
                           "src/repro/kernels/snapshot_fused.py:73"),
        "delta_quantize": ("delta_quantize.cu",
                           "src/repro/kernels/delta_quantize.py:55"),
        "dequant_apply": ("delta_quantize.cu",
                          "src/repro/kernels/delta_quantize.py:86"),
        "chain_apply": ("chain_apply.cu",
                        "src/repro/kernels/chain_apply.py:60"),
        "fingerprint": ("fingerprint.cu",
                        "src/repro/kernels/fingerprint.py:57"),
        "flash_attention": ("flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:112"),
    }
    def dtype_launches(name, dtype):
        """Launches of kernel ``name`` on all paths whose first operand is
        ``dtype``."""
        return sum(n for path in LAUNCHES_BY_DTYPE.values()
                   for key, n in path[name].items()
                   if key.split("->")[0].split("+")[0] == dtype)

    kernels = []
    for name, (source, where) in replaces.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{SRC}/{source}",
            "replaces": where,
            "launches": sum(path[name] for path in launches.values()),
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "launches_by_dtype": {p: n[name]
                                  for p, n in LAUNCHES_BY_DTYPE.items()},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"]})
        for sub, dtype in (("f16", "float16"), ("bf16", "bfloat16")):
            if sub in t:    # the storage kernels' 16-bit instantiations
                kernels[-1][sub] = dict(
                    t[sub], launches=dtype_launches(name, dtype),
                    max_abs_err=errs[name])
        if name == "flash_attention":
            kernels[-1].update(
                {key: t[key] for key in (
                    "ms_bf16", "library_ms_bf16", "bound_ms_bf16",
                    "bound_by_bf16", "eager_ms", "eager_ms_bf16",
                    "library_eager_ms", "library_eager_ms_bf16",
                    "qwen3_0_6b", "qwen3_0_6b_serve",
                    "paligemma_3b_serve")},
                max_abs_err_bf16=errs[f"{name}_bf16"])
            for dtype, tag, sub in FLASH_DTYPES[1:]:
                kernels[-1][sub] = {
                    "ms": t[f"ms{tag}"], "plain_ms": t[f"plain_ms{tag}"],
                    "bound_ms": t[f"bound_ms{tag}"],
                    "bound_by": t[f"bound_by{tag}"],
                    "library_ms": t[f"library_ms{tag}"],
                    "eager_ms": t[f"eager_ms{tag}"],
                    "library_eager_ms": t[f"library_eager_ms{tag}"],
                    "shape": t["shape"],
                    "launches": dtype_launches(name, dtype),
                    "max_abs_err": errs[f"{name}{tag}"]}
    for k in kernels:
        library = ("" if k["library_ms"] is None
                   else f", library {k['library_ms']:.4f} ms")
        print(f"kernel {k['name']}: {k['ms']:.4f} ms at {k['shape']} "
              f"(bound {k['bound_ms']:.4f} ms, plain {k['plain_ms']:.4f} ms"
              f"{library}), "
              f"{k['launches']} launches on the main paths "
              f"{json.dumps(k['launches_by_path'])}", flush=True)
        for sub in ("f16", "bf16"):
            if sub in k and k["name"] != "flash_attention":
                f = k[sub]
                print(f"kernel {k['name']} {sub}: {f['ms']:.4f} ms at "
                      f"{f['shape']} (bound {f['bound_ms']:.4f} ms, plain "
                      f"{f['plain_ms']:.4f} ms), {f['launches']} launches",
                      flush=True)
    flash = timing["flash_attention"]
    for label, t in (("serving", flash), ("qwen3-0.6b", flash["qwen3_0_6b"]),
                     ("qwen3-0.6b serving", flash["qwen3_0_6b_serve"]),
                     ("paligemma-3b serving",
                      flash["paligemma_3b_serve"])):
        for _, tag, dt in FLASH_DTYPES:
            print(f"flash_attention {label} {t['shape']} {dt}: "
                  f"{t['ms' + tag]:.4f} ms per call on the device (eager "
                  f"{t['eager_ms' + tag]:.4f}), bound "
                  f"{t['bound_ms' + tag]:.4f} by {t['bound_by' + tag]}, "
                  f"sdpa {t['library_ms' + tag]:.4f} (eager "
                  f"{t['library_eager_ms' + tag]:.4f}"
                  + (f", backend {t['library_backend' + tag]}"
                     if 'library_backend' + tag in t else "") + ")"
                  + (f", plain {t['plain_ms' + tag]:.4f}"
                     if 'plain_ms' + tag in t else ""), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
