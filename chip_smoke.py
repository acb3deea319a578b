#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA Hopper
card and check it. Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --serve-ab DIR`` instead serves the dense and
paged mixes of phases 6 and 6a with the port imported from DIR, a
checkout of another commit, and prints one JSON line: see ``serve_ab``.)

Phases, one line each; any failure raises and exits non-zero:

1. env     -- the card's name and power limit, torch and CUDA versions.
2. build   -- nvcc builds every kernel source under
              ``ray_tpu_torch/ops/csrc`` for sm_90a (one process per
              source, all started together); the compiler's register and
              spill report is printed per kernel, and the bf16 B1, B2 and
              B3 (tensor cores) must not spill and must fit two blocks on
              an SM. Every instantiation of C2, C4, C5 and C6 is printed
              with its registers, spills and resident blocks, and must not
              spill.
3. kernels -- each kernel against its plain PyTorch version on the card,
              in bf16 and f32, at the shapes the serving and training
              paths give it, with its time, the plain version's, the
              least time the card could take (bound) and one PyTorch
              library call's as a yardstick: B1 (flash forward; its and
              SDPA's device time from a CUDA graph of 50 calls, beside the
              wrapper's time per call with its host time), B2 (flash
              backward dK/dV) and B3 (flash backward dQ), each with its
              TFLOP/s; then B1-B3 at head dims 64 and 16
              (padded to 128 by the wrappers) and with the full mask at
              S=256; then B1 at the draft prefill's shapes (4 heads of 16,
              S 128, 256 and 512, f32 and bf16).
4. serve   -- Llama-3-8B at full width and depth (random weights from a
              seed, int8 weight-only, ``attn_impl="flash"``) answers 12
              requests from 4 client threads through ``LLMServer``; every
              prefill must have launched B1 once per layer.
5. parity  -- for 3 of those prompts the engine's greedy tokens equal the
              port's own ``generate`` on the same params.
6. profile -- device time by kernel over 8 more requests (torch.profiler),
              and the device's idle share of that window. Then the dense
              server takes the paged serve's traffic mix (below) without
              its prompts over 512 tokens, for figures beside the paged
              run's. One weight tree (seed 0) serves phases 4-6a, one
              server at a time, each quantizing it to int8.
6a. paged  -- the paged server at the same width and depth (block 16, a
              pool of 96 blocks against the dense equivalent's 512, prefix
              cache, host KV tier, preemption with no hold): 8 requests on
              a 256-token shared prefix, then two batch decodes and two
              chunked prompts of 700-900 tokens, then 8 more on the
              prefix, from four client threads. stats() must show prefix
              hits on every repeat, a prompt prefilled in two or more
              chunks, an admission queued for blocks, a spill to and a
              promote from the host tier, and a preemption; tok/s, TTFT
              and TPOT p50 beside the dense run's; the agreement with the
              dense run's tokens (and the top-2 logit gap at a first
              divergence); a profile window, with the indexing kernels'
              share of it (the pool gather's upper bound).
6b. spec   -- the mix's third-phase requests on a fresh paged server
              without a draft, then on a fresh one with the default
              random draft (2 layers, dim 64, head dim 16), spec_k 4, each
              after the same warm-up: tok/s of both, acceptance, B1
              launches = draft layers x draft prefills (none without the
              draft), also inside a profile window; then B1 on the q, k
              and v of real draft prefills at every bucket against its
              plain version.
6c. paged bitwise -- 4 layers at Llama-3-8B widths, bf16: paged decode =
              dense decode on the same contents at batch 8 (logits and
              rows), export -> adopt, preempt -> resume and tier promote
              -> in-pool history and tokens, each bit for bit.
6d. paged tokens -- the same widths in f32: the paged engine's greedy
              tokens equal the dense engine's and generate's (prefix
              hits, a chunked prompt, preempted and promoted requests),
              and the speculative server's equal the plain paged one's;
              B1 on that f32 draft's real prefills against its plain
              version.
6e. disagg -- a PrefillServer and a DecodeServer at full width and depth
              (int8, the paged server's engine config each) sharing the
              card in one process. Bitwise: 12 requests (8 on a 256-token
              shared prefix, 2 chunked prompts of 700-900 tokens, 2 short
              ones of 64-128), one at a time, all two-hop (prefill, export,
              adopt, decode), give the greedy tokens of a fresh monolithic
              paged server. Then the same mix from four client threads on
              a fresh pair, prompts of 256 tokens or more two-hop (each
              under its own trace_root), the rest to the decode server:
              tok/s, TTFT and TPOT p50, export and adopt ms and bytes per
              migration; gated: the token counter against the cost meters
              (each migrated first token counted on both hops, as in the
              reference), one tenant-ledger row per request, the importer's
              blocks and bytes, every two-hop span tree. A profile window
              over each server (a second mix, split by hop). A speculative
              decode server adopting from the prefill server: B1 launches
              = draft layers x draft prefills, then B1 on an adopted
              request's real draft q/k/v. A fresh monolithic server on the
              same mix (tok/s, TTFT, TPOT, token agreement), which then
              donates a prompt's prefix chain to a fresh receiver: every
              exported block promoted, only the suffix prefilled, the
              donor's tokens. Last, the hooks' cost: 4 pairs of fresh
              servers with the cost meters on and off
              (serve_accounting_instrumentation), alternating which runs
              first, on the same mix: tok/s of each and their ratios.
6f. disagg gates -- 4 layers at Llama-3-8B widths: two-hop equal to one
              paged engine bit for bit in bf16, and in f32 also equal to
              generate; a speculative decode server adopting the prefill
              server's f32 checkpoints gives the paged engine's tokens; B1
              on that draft's real prefills.
7. train   -- f32 checks first: flash against plain attention at dim
              256 (head dim 128) and at ``LlamaConfig.tiny()`` (head dim
              16), which also trains one step with exact B1-B3 counts.
              Llama-3-8B widths at 4 layers (bf16 params, flash
              attention, ``remat="dots"``, fused loss, AdamW) trains 6
              steps of batch 4 x 1024 tokens through ``build_train_step``,
              then one step with ``grad_accum=2``: finite losses and grad
              norms, and launch counts of B1 (twice per layer and
              micro-step: forward and remat), B2 and B3 (once each).
              Step time, tokens/s, MFU, peak memory and the device time
              of one profiled step by kernel group. Before the steps,
              flash against plain attention on the initial params and the
              first batch: the loss and every gradient leaf within a
              relative L2 tolerance.
8. ring    -- (run after phase 3) the ring collectives C1-C4
              (``ring.cu``) bitwise against their plain versions at ring
              sizes 2, 4 and 8, f32, bf16, f16 and int32, sum and max,
              ragged and large per-rank blocks, and the split-phase forms
              (C1 per hop) against C2 and C3; C3 also at 16 ranks, into a
              caller's ``out`` and with each shard already lying in its
              place of ``out``; C4 at 16 ranks with every op (sum, max,
              min, prod) and type; the same at the ZeRO path's
              size (the 4-layer flat parameter vector, 4 ranks, bf16),
              and the four kernels' times beside their plain versions',
              bounds and one library call's; C2 must leave its input as
              it was.
9. zero    -- f32 at dim 256: ZeRO at 2 ranks bitwise equal to plain
              data parallelism through C4, ZeRO at 4 ranks against the
              one-device step. Then Llama-3-8B widths at 4 layers through
              ``build_zero_train_step`` over 4 virtual ranks (batch 4 x
              1024, one row per rank): 3 monolithic steps (C2 + C3, one
              launch each per step), one profiled step, then 3 steps with
              ``overlap=True`` (C1, 24 launches per step) from the same
              params: finite losses and grad norms, exact launch counts,
              every rank's copy equal to rank 0's, overlap within bf16
              re-association of monolithic; step time, tokens/s, peak
              memory and the ring kernels' share of a profiled step.
10. qring  -- (run after phase 8) the int8 ring C5 and C6 (``ring.cu``)
              bitwise against their plain versions at ring sizes 2, 4 and
              8, f32, for a ragged block, exactly 1024 elements and a large
              block per rank, each with random data, an all-zero chunk
              (the 1e-30 scale floor) and a chunk whose max sits in one
              block (the per-rank barrier): C6 through
              ``quantized_ring_allreduce``, C5 alone and through the
              split-phase int8 reduce-scatter. C5's in-place form (the
              split-phase hop, its scale carried from the hop before)
              hop by hop against its plain version, buffer and carry
              table, at ring sizes 2, 3, 4, 8 and 16; two reduce-scatters
              interleaved as the overlap path issues them; a missing carry
              stops the kernel and the group raises. The fallback ladder
              (f64, a small call, ``precision="bf16"``) takes C4, not C6.
              At the quantized ZeRO size (the 1-layer flat vector, 4
              ranks, f32) C6 in place, C5 on one overlap hop and C5 in
              place on one overlap chunk bitwise, and the kernels' times
              beside their plain versions', bounds and yardsticks
              (``x.sum(0)``, ``torch.roll``, and for the in-place form
              the split-phase hop as tensor ops around C5).
11. zero quantized -- f32 at dim 256, 2 and 4 ranks: the int8 ZeRO step
              (monolithic, overlap, error feedback) through C5 / C6 equal
              to the same steps through the plain versions bit for bit.
              Then Llama-3-8B widths at 1 layer over 4 virtual ranks with
              ``quantized_grads=True``: 3 monolithic steps (C6 + C3), 3
              with ``error_feedback=True``, 3 with ``overlap=True`` (C5
              and C1 per hop), each from the same params and followed by
              one profiled step: finite losses and grad norms, the first
              loss equal to the exact step's, exact launch counts, every
              rank's copy equal to rank 0's, ``ef`` finite, f32 and
              non-zero. Recorded, not gated: step time, tokens/s, peak
              memory, C5/C6's share of a profiled step, and the first
              step's int8 gradient shard against the exact reduce-scatter
              (relative L2, share of elements sent as 0).

Every profiled window (serve, train, each ZeRO route) is one
torch.profiler window with no schedule that must hold every event: it
fails if the profiler warns that it cleared or dropped events, if the
device was busy longer than the window's wall time, or if the trace holds
another number of launches of a hand-written kernel than its wrapper
counted.

Then one JSON line of per-kernel numbers, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero before printing any result. It needs nothing but
the repository (no network) and stops every process it starts.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its operations over the tensor-core rate of its type and its
# bytes over the memory rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# Kernel B1 against its plain version on the same inputs, at every shape.
# bf16 O: the two round P to bf16 at different points (the kernel per
# 64-key tile against a running max, the plain version against the row's
# final max) and both round O to bf16, so an element may land one bf16
# ulp apart, and one ulp is at most 2**-7 of the value. So each element is
# held to TOL_O_BF16_ABS + 2**-7 * |plain|. The card read a max abs error
# of 0.0039 at every shape, one ulp for |O| in [0.5, 1), against a limit
# there of 0.008 to 0.012; a typical |O| of a late row at S = 512 is about
# 0.07 to 0.1 for randn inputs, where the limit is about 0.0045.
# f32 O: nothing is rounded to a narrower type, so only summation order
# differs (the card read 4.8e-7). The f32 instantiation runs the same
# template code, so this limit holds the P.V product and the
# normalisation tightly at every shape.
# LSE is f32 on both sides (the card read at most 9.5e-7).
TOL_O_BF16_ABS, TOL_O_BF16_REL = 4e-3, 2.0 ** -7
TOL_O_F32 = 1e-4
TOL_LSE = 1e-4

# Kernels B2 and B3 against flash_attention_bwd_plain on the same inputs.
# Each gradient element is held to A * max|plain| + R * |plain|, with the
# scale of the gradient (which grows with S) taken from the plain result.
# bf16: the kernels and the plain version round P and dS to bf16 at the
# same places, but their f32 sums run in different orders, so a P or dS
# element near a rounding boundary may land one bf16 ulp apart, and the
# outputs are rounded to bf16 (one ulp is at most 2**-7 of the value):
# A = 2**-8, R = 2**-7, the bound the CPU tests hold the port's plain
# version to against the JAX package's kernels. f32: nothing is rounded
# to a narrower type and the f32 kernels run full f32 FMAs, so only
# summation order differs: A = 1e-5, R = 0 (the card read at most 1e-6).
TOL_BWD = {torch.bfloat16: (2.0 ** -8, 2.0 ** -7), torch.float32: (1e-5, 0.0)}

N_HEADS, HEAD_DIM = 32, 128
# (batch, S, causal): B1 at the serving path's prefill buckets, a ragged
# length, a full mask, the ZeRO path's per-rank shape, a long ragged
# length, and the training shape.
KERNEL_SHAPES = [(1, 128, True), (1, 256, True), (1, 512, True),
                 (1, 200, True), (1, 256, False), (1, 1024, True),
                 (1, 1000, True), (4, 1024, True)]
# (batch, S) for B2 and B3, causal: B = 1 at short, mid and training
# length and one ragged length, then the training shape itself.
BWD_SHAPES = [(1, 128), (1, 512), (1, 1024), (1, 1000), (4, 1024)]
# Head dims below the kernels' 128, which the wrappers pad (LlamaConfig.tiny
# has 16), checked at (1, PADDED_SEQ) through B1, B2 and B3, causal; and
# the full mask at 128 (flash_attention takes it at S % 128 == 0).
PADDED_HEAD_DIMS, PADDED_SEQ = (64, 16), 256
# The train phase: Llama-3-8B widths at the depth of the reference's own
# training geometry (bench.py: 4 layers, batch x 1024, bf16 params,
# flash, remat "dots"), fused loss, optax.adamw(1e-4)'s settings. Token
# rows are SEQ + 1 long so the model sees SEQ positions after the shift.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4, 1024, 6
# Flash against plain attention at those widths, both in bf16: plain
# attention rounds its scores to bf16 before the softmax and the kernels
# keep them in f32, so the two differ at bf16 rounding. Each gradient
# leaf is held to a relative L2 distance of 5e-2 and the loss to 1e-2.
TOL_PARITY_GRAD, TOL_PARITY_LOSS = 5e-2, 1e-2
# The same comparison in f32 at a narrow width: only summation order.
TOL_PARITY_F32 = 1e-4
ENGINE = {"num_slots": 8, "max_seq_len": 1024,
          "prefill_buckets": (128, 256, 512)}
N_REQUESTS, N_CLIENTS, N_PARITY = 12, 4, 3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after warm-up, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# How B1's times are taken, stated in its row of the kernels line.
TIMED_BY_GRAPH = ("ms and library_ms: device time of one call, from a CUDA "
                  "graph of 50 calls, no host time (graph_ms); call_ms: CUDA "
                  "events around 50 back-to-back calls, host time included, "
                  "as every other kernel's ms (time_ms)")


def graph_ms(fn, iters: int) -> float:
    """Mean device time of one ``fn`` call, from CUDA events around one
    replay of a CUDA graph that holds ``iters`` calls: the host's time per
    call (Python, ctypes, allocation) stays out of it, so a kernel shorter
    than its caller's overhead is timed by the device's work. Capturing
    runs the wrappers, so each captured call adds one to its wrapper's
    launch count; the replays add nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def attention_flops(B, S, H, D, causal):
    """The operations of one attention forward: two products of 2 * D
    flops per visible (query, key) pair (causal: S(S+1)/2 per head)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4.0 * B * H * D * pairs


def attention_bound(B, S, H, D, causal, dtype):
    """(bound_ms, bound_by) for one attention forward: each input read
    once, O and LSE written once; the products this input needs
    (``attention_flops``)."""
    flops = attention_flops(B, S, H, D, causal)
    nbytes = 4 * B * S * H * D * torch.finfo(dtype).bits // 8 + 4 * B * H * S
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ptxas_kernels(report: str) -> dict:
    """{mangled kernel name: {"registers", "spill_bytes"}} from an
    ``nvcc -Xptxas -v`` report (spill bytes: stores plus loads)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$.]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": None, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


# The tensor-core (bf16) flash kernels: (name in the compiler's report,
# blocks_per_sm's key). Each must not spill and must fit 2 blocks per SM.
TC_KERNELS = (("flash_fwd_kernel", "fwd"), ("flash_bwd_dkv_kernel", "dkv"),
              ("flash_bwd_dq_kernel", "dq"))


def phase_build():
    """Build every kernel source; print and return each kernel's
    registers and spills from the compiler's report. Fails if a
    tensor-core flash kernel spills or fits fewer than 2 blocks per SM."""
    from ray_tpu_torch.ops import _build

    names = _build.all_kernels()
    t0 = time.perf_counter()
    _build.build(names)
    log("build", f"nvcc sm_90a {names} in {time.perf_counter() - t0:.1f} s")
    kernels = {}
    for name in names:
        found = ptxas_kernels(_build.build_log(name))
        kernels.update(found)
        regs = sorted({k["registers"] for k in found.values()
                       if k["registers"] is not None})
        spills = {n: k["spill_bytes"] for n, k in found.items()
                  if k["spill_bytes"]}
        log("build", f"{name}: {len(found)} kernels, registers {regs}, "
            f"spills {spills or 'none'}")
    for name, key in TC_KERNELS:
        report = kernel_report(kernels, name)
        blocks = blocks_per_sm(key, torch.bfloat16)
        log("build", f"{name} (bf16): {report['registers']} registers, "
            f"{report['spill_bytes']} spill bytes, {blocks} blocks per SM")
        check(report["spill_bytes"] == 0 and blocks >= 2,
              f"{name} (bf16): {report['spill_bytes']} spill bytes, "
              f"{blocks} blocks per SM")
    return kernels


def kernel_report(kernels: dict, name: str) -> dict:
    """The report of the one kernel whose mangled name holds ``name``."""
    hits = [v for k, v in kernels.items() if name in k]
    check(len(hits) == 1, f"{len(hits)} kernels named {name} in the "
          f"compiler's report")
    return hits[0]


def blocks_per_sm(kernel: str, dtype) -> int:
    """Blocks of B1 ("fwd"), B2 ("dkv") or B3 ("dq") resident on one SM
    at once, from the CUDA runtime's occupancy calculator."""
    import ctypes

    from ray_tpu_torch.ops import _build

    code = 0 if dtype == torch.float32 else 1
    n = ctypes.c_int(0)
    if kernel == "fwd":
        fn = _build.load("flash_fwd").flash_fwd_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        args = (code, ctypes.byref(n))
    else:
        fn = _build.load("flash_bwd").flash_bwd_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        args = (0 if kernel == "dkv" else 1, code, ctypes.byref(n))
    fn.restype = ctypes.c_int
    err = fn(*args)
    check(err == 0, f"occupancy query failed ({err})")
    return n.value


# The ring kernels whose every instantiation the build phase reports
# (registers, spills, resident blocks) and holds free of spills: (ID,
# name in the compiler's report, ring.cu's kind code). C2 and C4 have one
# per element type and op (16), C5 and C6 one each.
RING_REPORTED = (("C2", "ring_reduce_scatter_kernel", 1),
                 ("C4", "ring_allreduce_kernel", 3),
                 ("C5", "ring_qhop_kernel", 4),
                 ("C6", "ring_qallreduce_kernel", 5))
# Template arguments in a mangled ring kernel name: element type (as the
# compiler mangles it) -> (label, ring.cu's dtype code); op digit -> op.
_MANGLED_TYPES = {"f": ("f32", 0), "13__nv_bfloat16": ("bf16", 1),
                  "6__half": ("f16", 2), "i": ("int32", 3)}
_RING_OP_NAMES = ("sum", "max", "min", "prod")


def ring_instances(kernels: dict) -> dict:
    """{ID: [{"dtype", "op", "registers", "spill_bytes", "blocks_per_sm",
    "resident_blocks"}, ...]} for every instantiation of the kernels of
    RING_REPORTED in the compiler's report; resident blocks are blocks per
    SM (the runtime's occupancy calculator, as ring_launch asks it) times
    the SMs, the most blocks one cooperative launch of n ranks may hold."""
    import ctypes

    from ray_tpu_torch.util.collective import ring as R

    lib = R._lib()
    lib.ring_blocks_per_sm.restype = ctypes.c_int
    lib.ring_blocks_per_sm.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for key, name, kind in RING_REPORTED:
        rows = []
        for mangled, rep in kernels.items():
            if name not in mangled or rep["registers"] is None:
                continue      # another kernel, or a device function
            m = re.search(name + r"I(\w+?)Li(\d)E", mangled)
            dtype, code = _MANGLED_TYPES[m.group(1)] if m else ("f32", 0)
            op = int(m.group(2)) if m else 0
            per_sm = ctypes.c_int(0)
            err = lib.ring_blocks_per_sm(kind, op, code, ctypes.byref(per_sm))
            check(err == 0, f"{key} occupancy query failed ({err})")
            rows.append({"dtype": dtype, "op": _RING_OP_NAMES[op],
                         "registers": rep["registers"],
                         "spill_bytes": rep["spill_bytes"],
                         "blocks_per_sm": per_sm.value,
                         "resident_blocks": per_sm.value * sms})
        out[key] = sorted(rows, key=lambda r: (r["dtype"], r["op"]))
    return out


def phase_ring_build(kernels: dict) -> dict:
    """Print the registers, spills and resident blocks of every C2, C4, C5
    and C6 instantiation; fail if one spills, or if C2 or C4 has not one
    per element type and op (16) or C5 or C6 not exactly one. Also fail
    unless C1-C4 ask for no comm slots and the int8 ring (C5 in both
    forms, C6) for two int8 chunks and two f32 scales a block, per rank
    (``ring.cu``'s ``ring_slot_bytes``)."""
    from ray_tpu_torch.util.collective import ring as R

    lib, chunk = R._lib(), 4096
    for n in (2, ZERO_N, R.MAX_RANKS):
        for code, kind in enumerate(R.KINDS):
            want = (n * (2 * chunk + 2 * R.MAX_BLOCKS_PER_RANK * 4)
                    if kind in ("qhop", "qallreduce", "qrs_hop") else 0)
            got = lib.ring_slot_bytes(code, n, chunk)
            check(got == want, f"{kind} asks for {got} bytes of comm slots "
                  f"at n={n}, {chunk} elements a chunk; want {want}")
    log("build", f"comm slots: C1-C4 ask for none; the int8 ring for two "
        f"int8 chunks and {2 * R.MAX_BLOCKS_PER_RANK} f32 scales a rank")
    found = ring_instances(kernels)
    for key, rows in found.items():
        for r in rows:
            log("build", f"{key} {r['dtype']} {r['op']}: {r['registers']} "
                f"registers, {r['spill_bytes']} spill bytes, "
                f"{r['blocks_per_sm']} blocks per SM, {r['resident_blocks']} "
                f"resident blocks")
        spills = [r for r in rows if r["spill_bytes"]]
        check(not spills, f"{key} spills: {spills}")
        check(len(rows) == (16 if key in ("C2", "C4") else 1),
              f"{len(rows)} instantiations of {key} in the compiler's report")
    return found


def ring_build_fields(rows: list) -> dict:
    """The build numbers of a ring kernel's row of the kernels line."""
    return {"registers": max(r["registers"] for r in rows),
            "spills": max(r["spill_bytes"] for r in rows),
            "blocks_per_sm": min(r["blocks_per_sm"] for r in rows),
            "resident_blocks": min(r["resident_blocks"] for r in rows),
            "instances": rows}


def phase_kernels(dev):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def qkv(B, S, dtype):
        return [torch.randn((B, S, N_HEADS, HEAD_DIM), generator=gen,
                            device=dev, dtype=dtype) for _ in range(3)]

    rows = []
    for B, S, causal in KERNEL_SHAPES:
        q, k, v = qkv(B, S, torch.float32)
        o, lse = attention.flash_fwd_cuda(q, k, v, causal)
        po, plse = attention.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err_f32 = (o - po).abs().max().item()
        err_lse_f32 = (lse - plse).abs().max().item()
        check(err_f32 <= TOL_O_F32 and err_lse_f32 <= TOL_LSE,
              f"flash_fwd f32 S={S} causal={causal}: O err {err_f32}, "
              f"LSE err {err_lse_f32}")

        q, k, v = qkv(B, S, torch.bfloat16)
        o, lse = attention.flash_fwd_cuda(q, k, v, causal)
        po, plse = attention.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        diff = (o.float() - po.float()).abs()
        err_o = diff.max().item()
        # Share of the elementwise limit used by the worst element (<= 1).
        used = (diff / (TOL_O_BF16_ABS + TOL_O_BF16_REL
                        * po.float().abs())).max().item()
        err_lse = (lse - plse).abs().max().item()
        check(bool(torch.isfinite(o.float()).all()), "non-finite O")
        check(used <= 1.0 and err_lse <= TOL_LSE,
              f"flash_fwd S={S} causal={causal}: O err {err_o} "
              f"({used:.2f} of the limit), LSE err {err_lse}")
        # The kernel's and SDPA's device time from a CUDA graph: at the
        # serving shapes the wrapper's host time per call (call_ms) is
        # longer than the kernel, so back-to-back calls would time the host.
        ms = graph_ms(lambda: attention.flash_fwd_cuda(q, k, v, causal), 50)
        call_ms = time_ms(lambda: attention.flash_fwd_cuda(q, k, v, causal),
                          50)
        plain_ms = time_ms(
            lambda: attention.flash_attention_plain(q, k, v, causal), 20)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 50)
        bound_ms, bound_by = attention_bound(B, S, N_HEADS, HEAD_DIM,
                                             causal, torch.bfloat16)
        tflops = attention_flops(B, S, N_HEADS, HEAD_DIM, causal) / ms / 1e9
        rows.append({"B": B, "S": S, "causal": causal, "max_abs_err": err_o,
                     "lse_max_abs_err": err_lse, "tol_used": used,
                     "f32_max_abs_err": err_f32,
                     "f32_lse_max_abs_err": err_lse_f32, "ms": ms,
                     "tflops": tflops, "call_ms": call_ms,
                     "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})
        log("kernels", f"flash_fwd bf16 B={B} H={N_HEADS} D={HEAD_DIM} S={S} "
            f"{'causal' if causal else 'full'}: O err {err_o:.3g} "
            f"({used:.2f} of tol {TOL_O_BF16_ABS} + 2^-7 |plain|), LSE err {err_lse:.3g} (tol {TOL_LSE}), "
            f"f32 O err {err_f32:.3g} (tol {TOL_O_F32}), f32 LSE err "
            f"{err_lse_f32:.3g}; "
            f"kernel {ms:.5f} ms = {tflops:.1f} TFLOP/s (a call "
            f"{call_ms:.4f} ms with its host time), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}), sdpa "
            f"{lib_ms:.5f} ms")
    check(attention.flash_fwd_cuda.launches > 0, "flash_fwd never launched")
    return rows


def bwd_flops(B, S, H, D, products):
    """The operations of one causal backward kernel: ``products`` products
    of 2 * D flops per visible (query, key) pair, S(S+1)/2 per head."""
    return 2.0 * D * products * B * H * (S * (S + 1) // 2)


def bwd_bound(B, S, H, D, dtype, products, n_out):
    """(bound_ms, bound_by) for one causal backward kernel: its
    operations (``bwd_flops``); bytes of q, k, v, dO read once, LSE and
    delta (f32) read once and ``n_out`` gradients written once."""
    flops = bwd_flops(B, S, H, D, products)
    elem = torch.finfo(dtype).bits // 8
    nbytes = (4 + n_out) * B * S * H * D * elem + 2 * B * H * S * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def held(got, want, dtype):
    """(max abs error, share of the elementwise limit A * max|want| +
    R * |want| that the worst element uses) for one gradient."""
    a, r = TOL_BWD[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    limit = a * w.abs().max() + r * w.abs()
    return diff.max().item(), (diff / limit).max().item()


def phase_bwd_kernels(dev):
    """B2 and B3 against flash_attention_bwd_plain on the card, in bf16
    and f32, on the O and LSE that B1 gives for random q, k, v and a
    random dO; then the time of each kernel, of the plain backward (which
    computes dQ, dK and dV together), and of SDPA's backward (its dQ, dK
    and dV from torch.autograd.grad of an SDPA output, forward excluded),
    in bf16."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for B, S in BWD_SHAPES:
        row = {"B": B, "S": S, "causal": True}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = [torch.randn((B, S, N_HEADS, HEAD_DIM),
                                       generator=gen, device=dev,
                                       dtype=dtype) for _ in range(4)]
            o, lse = attention.flash_fwd_cuda(q, k, v, True)
            delta = attention.attention_delta(o, do)
            dk, dv = attention.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
            dq = attention.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
            pdq, pdk, pdv = attention.flash_attention_bwd_plain(
                q, k, v, o, lse, do)
            torch.cuda.synchronize()
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            for g, w, what in ((dk, pdk, "dk"), (dv, pdv, "dv"),
                               (dq, pdq, "dq")):
                check(bool(torch.isfinite(g.float()).all()),
                      f"non-finite {what} at B={B} S={S} {name}")
                err, used = held(g, w, dtype)
                row[f"{name}_{what}_err"], row[f"{name}_{what}_used"] = (
                    err, used)
                check(used <= 1.0, f"flash backward {what} {name} B={B} "
                      f"S={S}: max abs err {err:.3g}, {used:.2f} of the "
                      f"limit {TOL_BWD[dtype]}")
        # bf16 q, k, v, dO, O, LSE from the last pass of the loop.
        ms_dkv = time_ms(lambda: attention.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta), 20)
        ms_dq = time_ms(lambda: attention.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta), 20)
        plain_ms = time_ms(lambda: attention.flash_attention_bwd_plain(
            q, k, v, o, lse, do), 5)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 20)
        b2 = bwd_bound(B, S, N_HEADS, HEAD_DIM, torch.bfloat16, 4, 2)
        b3 = bwd_bound(B, S, N_HEADS, HEAD_DIM, torch.bfloat16, 3, 1)
        tf2 = bwd_flops(B, S, N_HEADS, HEAD_DIM, 4) / ms_dkv / 1e9
        tf3 = bwd_flops(B, S, N_HEADS, HEAD_DIM, 3) / ms_dq / 1e9
        row.update({"dkv_ms": ms_dkv, "dq_ms": ms_dq, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "dkv_bound_ms": b2[0],
                    "dkv_bound_by": b2[1], "dq_bound_ms": b3[0],
                    "dq_bound_by": b3[1], "dkv_tflops": tf2,
                    "dq_tflops": tf3})
        rows.append(row)
        log("kernels", f"flash_bwd B={B} H={N_HEADS} D={HEAD_DIM} S={S} "
            f"causal: bf16 err dk {row['bf16_dk_err']:.3g} "
            f"({row['bf16_dk_used']:.2f} of limit), dv "
            f"{row['bf16_dv_err']:.3g} ({row['bf16_dv_used']:.2f}), dq "
            f"{row['bf16_dq_err']:.3g} ({row['bf16_dq_used']:.2f}); f32 "
            f"err dk {row['f32_dk_err']:.3g} ({row['f32_dk_used']:.2f}), "
            f"dv {row['f32_dv_err']:.3g} ({row['f32_dv_used']:.2f}), dq "
            f"{row['f32_dq_err']:.3g} ({row['f32_dq_used']:.2f}); B2 "
            f"{ms_dkv:.4f} ms = {tf2:.1f} TFLOP/s (bound "
            f"{b2[0] * 1e3:.2f} us, {b2[1]}), B3 {ms_dq:.4f} ms = "
            f"{tf3:.1f} TFLOP/s (bound {b3[0] * 1e3:.2f} us, {b3[1]}), "
            f"plain backward {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} "
            f"ms")

    # The gradient that reaches attention may be a strided view: through
    # the autograd Function it must give what its contiguous copy gives.
    B, S = 1, 512
    q, k, v = (torch.randn((B, S, N_HEADS, HEAD_DIM), generator=gen,
                           device=dev, dtype=torch.bfloat16
                           ).requires_grad_(True) for _ in range(3))
    out = attention.flash_attention(q, k, v, causal=True)
    g = torch.randn((B, N_HEADS, S, HEAD_DIM), generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    strided = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    dense = torch.autograd.grad(out, (q, k, v), g.contiguous())
    check(not g.is_contiguous()
          and all(torch.equal(a, b) for a, b in zip(strided, dense)),
          "a strided dO gave other gradients than its contiguous copy")
    log("kernels", "flash_bwd: a strided dO gives the gradients of its "
        "contiguous copy, bit for bit")
    return rows


def b1_used(o, lse, po, plse, dtype):
    """The shares of B1's limits that O and LSE use against the plain
    version's: O to TOL_O_F32 in f32, to TOL_O_BF16_ABS + TOL_O_BF16_REL
    |plain| in bf16; LSE to TOL_LSE."""
    diff = (o.float() - po.float()).abs()
    if dtype == torch.float32:
        used_o = diff.max().item() / TOL_O_F32
    else:
        used_o = (diff / (TOL_O_BF16_ABS + TOL_O_BF16_REL
                          * po.float().abs())).max().item()
    return used_o, (lse - plse).abs().max().item() / TOL_LSE


def phase_head_dims(dev):
    """B1, B2 and B3 at head dims below 128 (the wrappers pad them with
    zeros and scale by the unpadded 1/sqrt(D)), causal, and at 128 with
    the full mask, against the plain versions, in f32 and bf16, to the
    limits of the full-width checks. Returns {case: the largest share of
    its limit any output used}."""
    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    used_by_dim = {}
    cases = [(D, True) for D in PADDED_HEAD_DIMS] + [(HEAD_DIM, False)]
    for D, causal in cases:
        worst = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = [torch.randn((1, PADDED_SEQ, N_HEADS, D),
                                       generator=gen, device=dev,
                                       dtype=dtype) for _ in range(4)]
            o, lse = attention.flash_fwd_cuda(q, k, v, causal)
            po, plse = attention.flash_attention_plain(q, k, v, causal)
            delta = attention.attention_delta(o, do)
            dk, dv = attention.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                  causal)
            dq = attention.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                             causal)
            pdq, pdk, pdv = attention.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            check(o.shape == q.shape and dq.shape == q.shape
                  and dk.shape == k.shape and dv.shape == v.shape,
                  f"head dim {D}: outputs not sliced back to D")
            used = list(b1_used(o, lse, po, plse, dtype)) + [
                held(g, w, dtype)[1]
                for g, w in ((dq, pdq), (dk, pdk), (dv, pdv))]
            mask = "causal" if causal else "full"
            check(max(used) <= 1.0, f"head dim {D} {mask} {dtype}: shares "
                  f"of the limits (O, LSE, dQ, dK, dV) {used}")
            worst = max(worst, max(used))
        used_by_dim[f"{D} {mask}"] = worst
        log("kernels", f"head dim {D}"
            + (" (padded to 128)" if D < HEAD_DIM else "")
            + f", B=1 S={PADDED_SEQ} {mask}, f32 and bf16: B1 O and LSE, "
            f"B2 dK dV, B3 dQ within their limits (at most {worst:.2f} of "
            f"one)")
    return used_by_dim


def phase_draft_b1(dev):
    """B1 at the draft prefill's shapes, [1, Pb, heads, head dim] of the
    default draft (``draft_config_for`` of the served model: 4 heads of
    16, padded to 128), causal, at every prefill bucket Pb, in f32 (the
    f32 token gate's draft) and bf16 (the full-width draft), against the
    plain version to the limits of the full-width checks. Returns
    {case: the larger share of its limit O or LSE used}."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm.disagg.spec import draft_config_for

    dc = draft_config_for(serve_config())
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    used = {}
    for Pb in ENGINE["prefill_buckets"]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = [torch.randn((1, Pb, dc.n_heads, dc.head_dim),
                                   generator=gen, device=dev, dtype=dtype)
                       for _ in range(3)]
            o, lse = attention.flash_fwd_cuda(q, k, v, True)
            po, plse = attention.flash_attention_plain(q, k, v, True)
            torch.cuda.synchronize()
            case = f"{Pb} {str(dtype).rsplit('.', 1)[-1]}"
            shares = b1_used(o, lse, po, plse, dtype)
            check(o.shape == q.shape and max(shares) <= 1.0,
                  f"B1 at the draft's shape, S {case}: shares of the "
                  f"limits (O, LSE) {shares}")
            used[case] = max(shares)
    log("kernels", f"B1 at the draft prefill's shapes (B=1 H={dc.n_heads} "
        f"D={dc.head_dim} padded to 128, causal, S "
        f"{ENGINE['prefill_buckets']}, f32 and bf16): O and LSE within "
        f"their limits (at most {max(used.values()):.2f} of one)")
    return used


def serve_config():
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama3_8b(attn_impl="flash",
                                 param_dtype=torch.bfloat16)


def phase_serve(dev, cfg, loader, mix, card):
    """The dense server: 12 requests with B1's launch count, parity with
    ``generate`` and a profile window, then the paged serve's traffic mix
    without its prompts over 512 tokens (the dense layout cannot take
    them), for its figures beside the paged run's."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import LLMServer

    t0 = time.perf_counter()
    server = LLMServer(model_config=cfg, engine_config=dict(ENGINE),
                       params_loader=loader, device=dev)
    torch.cuda.synchronize()
    log("serve", f"Llama-3-8B (L={cfg.n_layers}, kv heads "
        f"{cfg.n_kv_heads}, vocab {cfg.vocab_size}) int8 built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    try:
        # One warm request (cuBLAS handles, first launches) outside the
        # measured window.
        server({"prompt": [1] * 128, "max_tokens": 2})
        rng = np.random.RandomState(0)
        reqs = [{"prompt": rng.randint(0, cfg.vocab_size,
                                       int(rng.randint(100, 501))).tolist(),
                 "max_tokens": int(rng.randint(16, 49))}
                for _ in range(N_REQUESTS)]
        results = [None] * N_REQUESTS
        errors = []

        def client(i):
            try:
                for j in range(i, N_REQUESTS, N_CLIENTS):
                    results[j] = server(reqs[j])
            except BaseException as e:       # relayed to the main thread
                errors.append(e)

        prefills0 = server.stats()["prefills"]
        attention.flash_fwd_cuda.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        launches = attention.flash_fwd_cuda.launches
        prefills = server.stats()["prefills"] - prefills0
        if errors:
            raise errors[0]
        check(all(not t.is_alive() for t in threads), "clients hung")
        for r, res in zip(reqs, results):
            check(res is not None and res["finish_reason"] == "length"
                  and res["num_tokens"] == r["max_tokens"]
                  and all(0 <= t < cfg.vocab_size for t in res["tokens"]),
                  f"bad result {res}")
        n_tok = sum(res["num_tokens"] for res in results)
        ttft = float(np.median([res["ttft_s"] for res in results]))
        log("serve", f"{len(results)}/{N_REQUESTS} completed, {n_tok} "
            f"tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s, TTFT p50 "
            f"{ttft * 1e3:.1f} ms, flash launches {launches} for "
            f"{prefills} prefills (x{cfg.n_layers} layers)")
        check(prefills == N_REQUESTS
              and launches == cfg.n_layers * prefills,
              f"flash launches {launches} != {cfg.n_layers} x {prefills}")
        phase_parity(server, cfg, reqs, results, dev)
        profile = phase_profile(server, cfg)
        dense_mix = run_mix(server, mix, "serve", card, long_prompts=False)
        return launches, profile, dense_mix
    finally:
        server.shutdown()


def phase_parity(server, cfg, reqs, results, dev):
    """Engine greedy tokens against the port's ``generate``, run at the
    engine's batch width (the prompt in every one of ``num_slots`` rows):
    same shapes, so the same bits, and the tokens must be equal. At
    batch 1 cuBLAS may choose another algorithm for the final f32
    logits product (4.8e-6 apart on the H100), so a near-tie could break
    the other way there; that comparison is printed, not required."""
    from ray_tpu_torch.models.llama import generate

    # Prompts of at least 128 tokens: below that the reference's rule
    # sends generate's exact-length prefill to plain attention while the
    # engine's 128 bucket goes through the kernel, and in bf16 the two
    # round P at different places (normalised vs. not).
    params = server._engine.params
    width = server._engine.config.num_slots
    pairs = [(r, res) for r, res in zip(reqs, results)
             if len(r["prompt"]) >= 128][:N_PARITY]
    check(len(pairs) == N_PARITY, "too few prompts of >= 128 tokens")
    for r, res in pairs:
        prompt, got = r["prompt"], res["tokens"]
        rows = generate(params, torch.tensor([prompt] * width, device=dev),
                        cfg, max_new_tokens=len(got)).tolist()
        ref1 = generate(params, torch.tensor([prompt], device=dev), cfg,
                        max_new_tokens=len(got))[0].tolist()
        same = rows[0] == got and all(row == rows[0] for row in rows)
        msg = (f"prompt len {len(prompt)}: engine == generate (batch "
               f"{width}) for {len(got)} tokens: {same}")
        first = next((i for i, (a, b) in enumerate(zip(ref1, got))
                      if a != b), None)
        msg += ("; == generate (batch 1): True" if first is None else
                f"; generate (batch 1) first differs at token {first}")
        log("parity", msg)
        check(same, "engine greedy tokens differ from generate")


# Kernel groups of a profile, by a substring of the kernel's name: the
# hand-written kernels first (ring_q before ring_), then the libraries'.
_GROUPS = (("flash_fwd", "flash_fwd"), ("flash_bwd_dkv", "flash_bwd_dkv"),
           ("flash_bwd_dq", "flash_bwd_dq"), ("ring_q", "ring C5/C6"),
           ("ring_", "ring C1-C4"))


def _kernel_group(name: str) -> str:
    low = name.lower()
    for key, group in _GROUPS:
        if key in low:
            return group
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                              "splitk")):
        return "matmul"
    return "elementwise/other"


def _is_index(name: str) -> bool:
    """An indexing kernel of elementwise/other (gather, index, index-put,
    index_add; not ``elementwise_kernel_with_index``, arange's), reported
    as a part of that group."""
    low = name.lower()
    return (_kernel_group(name) == "elementwise/other"
            and any(k in low for k in ("gather", "index_", "indexfunc")))


def _traced_kernels():
    """(wrapper, a substring of its kernel's name) for every hand-written
    kernel: a profile window must see as many launches of each as its
    wrapper counted."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    names = ("ring_permute_kernel", "ring_reduce_scatter_kernel",
             "ring_allgather_kernel", "ring_allreduce_kernel",
             "ring_qhop_kernel", "ring_qallreduce_kernel")
    return [(attention.flash_fwd_cuda, "flash_fwd"),
            (attention.flash_bwd_dkv_cuda, "flash_bwd_dkv"),
            (attention.flash_bwd_dq_cuda, "flash_bwd_dq")] + list(
                zip(R.KERNELS + Q.KERNELS, names))


def profile_window(phase: str, fn, card: str = ""):
    """Run fn() once under one torch.profiler window that keeps every event
    (no schedule; ``acc_events`` where this torch has it) and return
    {wall_ms, busy_ms, groups: {group: device ms}, top: [(ms, count,
    name)]}. Fails if the profiler warns that it cleared or dropped
    events, if the device was busy longer than the wall time, or if the
    trace holds another number of launches of a hand-written kernel than
    its wrapper counted in the window."""
    import inspect
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    traced = _traced_kernels()
    before = [w.launches for w, _ in traced]
    kw = ({"acc_events": True}
          if "acc_events" in inspect.signature(profile).parameters else {})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **kw) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.device_time_total > 0
                  # user annotations span kernels counted already
                  and not getattr(e, "is_user_annotation", False)]
    lost = [str(w.message) for w in caught
            if re.search(r"clears? events|drop|lost|overflow",
                         str(w.message), re.I)]
    check(not lost, f"{phase}: the profiler warned {lost}")
    check(bool(events), f"{phase}: the profiler recorded no device time")
    busy = sum(e.device_time_total for e in events) / 1e3
    check(busy <= wall_ms, f"{phase}: device busy {busy:.1f} ms exceeds "
          f"the window's wall time {wall_ms:.1f} ms")
    short = []
    for (w, name), b in zip(traced, before):
        seen = sum(e.count for e in events if name in e.key)
        if seen != w.launches - b:
            short.append((name, seen, w.launches - b))
    check(not short, f"{phase}: the trace and the wrappers disagree on "
          f"launches (kernel, traced, launched): {short}")
    groups = {}
    for e in events:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.device_time_total / 1e3
    index = sorted(((e.device_time_total / 1e3, e.count, e.key)
                    for e in events if _is_index(e.key)), reverse=True)
    index_ms = sum(ms for ms, _, _ in index)
    top = sorted(((e.device_time_total / 1e3, e.count, e.key)
                  for e in events), reverse=True)
    log(phase, f"profiled: {wall_ms:.1f} ms wall, device busy {busy:.1f} "
        f"ms (idle {100 * (1 - busy / wall_ms):.1f}%); "
        + ", ".join(f"{g} {ms:.1f} ms ({100 * ms / busy:.1f}%)"
                    for g, ms in sorted(groups.items(),
                                        key=lambda kv: -kv[1]))
        + f"; of elementwise/other, indexing kernels {index_ms:.1f} ms "
        f"({100 * index_ms / busy:.1f}%)"
        + "; every hand-written kernel's launches in the trace"
        + (f"; {card}" if card else ""))
    for ms, count, name in top[:8]:
        log(phase, f"  {ms:8.2f} ms {count:6d}x  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "groups": groups,
            "index_ms": index_ms, "index_top": [list(t) for t in index[:4]],
            "top": [list(t) for t in top[:8]]}


def phase_profile(server, cfg, phase="profile", card=""):
    """Where the serving time goes: device time by kernel over 8 requests
    (prompts of 100-500 tokens, 32 new tokens each) under torch.profiler,
    against the host's wall time for the same window."""
    rng = np.random.RandomState(1)
    reqs = [{"prompt": rng.randint(0, cfg.vocab_size,
                                   int(rng.randint(100, 501))).tolist(),
             "max_tokens": 32} for _ in range(8)]

    def run():
        threads = [threading.Thread(target=server, args=(r,))
                   for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(all(not t.is_alive() for t in threads), "requests hung")

    return profile_window(phase, run, card)


# ---------------------------------------------------------------------------
# The paged serving slice: paged KV, prefix cache, chunked prefill, the host
# KV tier, preemption and speculative decoding.
# ---------------------------------------------------------------------------

# The paged server: the dense server's geometry at block size 16, with a
# pool of PAGED_BLOCKS blocks, 19% of the dense equivalent (8 x 1024 / 16 =
# 512). Four shared-prefix requests in flight (16 shared blocks, up to 18
# own each) fit; in phase 2 two batch decodes (up to 29 blocks each) and a
# long prompt (58 blocks) do not, so the long prompts' admissions queue
# for blocks and preempt the batch decodes, and every entry phase 1 left
# in the prefix cache, the shared prefix included, is evicted into the
# host tier. The tier is sized (1 GiB, 512 blocks of 2 MiB) to keep every
# spilled block, so phase 3's first shared-prefix request finds the
# prefix there and promotes it (16 blocks: 3.6 ms by the cost model's
# defaults against 12.8 ms of recompute), and the others hit the pool.
PAGED_BLOCKS = 96
PAGED_ENGINE = {**ENGINE, "kv_layout": "paged", "kv_block_size": 16,
                "num_kv_blocks": PAGED_BLOCKS, "prefix_cache": True,
                "kv_spill": True, "kv_host_tier_bytes": 1 << 30,
                "preempt_hold_s": 0.0, "preempt_cooldown_s": 0.0}
SYS_PREFIX, SPEC_K, GATE_LAYERS = 256, 4, 4
# Pairs of fresh servers, accounting on and off, that price the hooks.
HOOK_PAIRS = 4


def paged_mix(vocab):
    """The paged serve's traffic, from numpy seed 0, in three phases:
    (1) 8 interactive requests sharing a 256-token system prefix with
    50-250 tokens of their own (16-32 new); (2) two batch requests
    (150-250 prompt tokens, 200 new), then two interactive prompts of
    700-900 tokens with chunked_prefill (16 new); (3) 8 more requests on
    the shared prefix, after phase 2 evicted it from the pool."""
    rng = np.random.RandomState(0)

    def toks(n):
        return rng.randint(0, vocab, int(n)).tolist()

    sys_prefix = toks(SYS_PREFIX)

    def shared():
        return {"prompt": sys_prefix + toks(rng.randint(50, 251)),
                "max_tokens": int(rng.randint(16, 33))}

    batch = [{"prompt": toks(rng.randint(150, 251)), "max_tokens": 200,
              "slo": "batch"} for _ in range(2)]
    first = [shared() for _ in range(8)]
    long = [{"prompt": toks(rng.randint(700, 901)), "max_tokens": 16,
             "chunked_prefill": True} for _ in range(2)]
    second = [shared() for _ in range(8)]
    return {"batch": batch, "first": first, "long": long, "second": second,
            "sys_prefix": sys_prefix}


def warm(server, cfg):
    """One request per prefill bucket through the server (its scheduler
    thread owns the engine), distinct random prompts, outside any
    measured window."""
    rng = np.random.RandomState(99)
    for b in ENGINE["prefill_buckets"]:
        server({"prompt": rng.randint(0, cfg.vocab_size, b).tolist(),
                "max_tokens": 2})


def _clients(server, reqs, errors, n=N_CLIENTS):
    """Start n client threads that send ``reqs`` round-robin; returns
    (threads, results)."""
    results = [None] * len(reqs)

    def client(i):
        try:
            for j in range(i, len(reqs), n):
                results[j] = server(reqs[j])
        except BaseException as e:           # relayed to the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(min(n, len(reqs)))]
    for t in threads:
        t.start()
    return threads, results


def _join(threads, errors):
    for t in threads:
        t.join(600)
    if errors:
        raise errors[0]
    check(all(not t.is_alive() for t in threads), "clients hung")


def run_mix(server, mix, phase, card, long_prompts=True):
    """Send the mix through ``server`` with four client threads, phase by
    phase: (1) the first shared-prefix requests; (2) two clients start
    the batch requests and, once both decode, the two others the long
    prompts (skipped on the dense server); (3) the second shared-prefix
    requests. Every request must end at its max_tokens. Returns
    {"results": [(request, result)], tok/s, TTFT and TPOT p50 over all
    requests}."""
    errors = []
    t0 = time.perf_counter()
    threads, res = _clients(server, mix["first"], errors)
    _join(threads, errors)
    done = list(zip(mix["first"], res))
    threads, res = _clients(server, mix["batch"], errors)
    deadline = time.monotonic() + 120
    while server.load()["active_slots"] < len(mix["batch"]) and not errors:
        check(time.monotonic() < deadline, "batch requests never admitted")
        time.sleep(0.005)
    if long_prompts:
        more, res2 = _clients(server, mix["long"], errors)
        _join(more, errors)
        done += list(zip(mix["long"], res2))
    _join(threads, errors)
    done += list(zip(mix["batch"], res))
    threads, res = _clients(server, mix["second"], errors)
    _join(threads, errors)
    done += list(zip(mix["second"], res))
    wall = time.perf_counter() - t0
    for r, res in done:
        check(res is not None and res["finish_reason"] == "length"
              and res["num_tokens"] == r["max_tokens"],
              f"{phase}: a request for {r['max_tokens']} tokens ended "
              f"{res and (res['finish_reason'], res['num_tokens'])}")
    n_tok = sum(res["num_tokens"] for _, res in done)
    out = {"requests": len(done), "tokens": n_tok, "wall_s": wall,
           "tok_s": n_tok / wall,
           "ttft_p50_ms": 1e3 * float(np.median([res["ttft_s"]
                                                 for _, res in done])),
           "tpot_p50_ms": 1e3 * float(np.median([res["tpot_s"]
                                                 for _, res in done])),
           "results": done}
    log(phase, f"mix{'' if long_prompts else ' without prompts over 512'}: "
        f"{len(done)} requests, {n_tok} tokens in {wall:.2f} s = "
        f"{out['tok_s']:.1f} tok/s, TTFT p50 {out['ttft_p50_ms']:.1f} ms, "
        f"TPOT p50 {out['tpot_p50_ms']:.2f} ms; {card}")
    return out


def _top2_gap(params, cfg, prompt, tokens, i, dev):
    """The top-2 logit gap of the port's forward at generated token i."""
    from ray_tpu_torch.models.llama import forward

    with torch.no_grad():
        logits = forward(params, torch.tensor([prompt + tokens[:i]],
                                              device=dev), cfg)[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def _agreement(phase, paged, dense, params, cfg, dev):
    """Requests of the paged run whose tokens equal the dense run's, and
    for the others the first divergence and the top-2 logit gap there
    (printed, not required: bf16/int8 at full depth, other shapes)."""
    by_prompt = {tuple(r["prompt"]): res["tokens"] for r, res in dense}
    same, diffs = 0, []
    for r, res in paged:
        want = by_prompt.get(tuple(r["prompt"]))
        if want is None:
            continue
        if res["tokens"] == want:
            same += 1
            continue
        i = next(k for k, (a, b) in enumerate(zip(res["tokens"], want))
                 if a != b)
        diffs.append((len(r["prompt"]), i, _top2_gap(
            params, cfg, list(r["prompt"]), res["tokens"], i, dev)))
    log(phase, f"paged == dense tokens for {same} of {same + len(diffs)} "
        f"requests" + "".join(
            f"; prompt {p}: first differs at token {i}, top-2 gap there "
            f"{g:.4g}" for p, i, g in diffs))
    return {"equal": same, "compared": same + len(diffs),
            "first_divergence": [{"prompt_len": p, "token": i,
                                  "top2_gap": g} for p, i, g in diffs]}


def phase_paged_serve(dev, cfg, loader, mix, dense_mix, card):
    """The paged server at full width and depth (int8, flash): the mix,
    every stats() event it must cause, its figures beside the dense
    server's, the agreement with the dense server's tokens, a profile
    window, with the indexing kernels' share of it (the pool gather's
    upper bound)."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import LLMServer

    server = LLMServer(model_config=cfg, engine_config=dict(PAGED_ENGINE),
                       params_loader=loader, device=dev)
    try:
        warm(server, cfg)
        log("paged", f"pool of {PAGED_BLOCKS} blocks of 16 rows (dense "
            f"equivalent {ENGINE['num_slots'] * ENGINE['max_seq_len'] // 16}"
            f"), {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        s0 = server.stats()
        attention.flash_fwd_cuda.launches = 0
        out = run_mix(server, mix, "paged", card)
        launches = attention.flash_fwd_cuda.launches
        st = server.stats()
        pc, tiers = st["prefix_cache"], st["kv_tiers"]
        hits = pc["hits"] - s0["prefix_cache"]["hits"]
        hit_tokens = pc["hit_tokens"] - s0["prefix_cache"]["hit_tokens"]
        events = {
            "prefix_hits": hits, "prefix_hit_tokens": hit_tokens,
            "chunked_prompts": st["chunked_prefill"]["prompts"],
            "chunks": st["chunked_prefill"]["chunks"],
            "admission_waits": st["kv"]["admission_waits"],
            "evictions": pc["evictions"], "spilled": pc["spilled"],
            "promoted_blocks": tiers["promoted_blocks"],
            "promote_skips": tiers["promote_skips"],
            "preempted": st["preempted"],
            "adopted_blocks": st["migration"]["blocks"],
            "dropped_blocks": tiers["dropped_blocks"]}
        log("paged", "stats: " + ", ".join(f"{k} {v}"
                                           for k, v in events.items()))
        # Every shared-prefix request but the first of each round hits
        # the pool (the first of round 2 promotes the prefix from the
        # tier).
        repeats = len(mix["first"]) + len(mix["second"]) - 2
        check(hits >= repeats and hit_tokens >= repeats * SYS_PREFIX,
              f"prefix hits {hits} / hit tokens {hit_tokens}: fewer than "
              f"the shared prefix's {repeats} repeats")
        check(events["chunked_prompts"] >= 1 and events["chunks"] >= 2,
              "no prompt was prefilled in two chunks")
        check(events["admission_waits"] >= 1, "no admission queued for "
              "blocks")
        check(events["spilled"] >= 1 and events["promoted_blocks"] >= 1,
              "no spill to the host tier, or no promote from it")
        check(events["preempted"] >= 1, "no preemption")
        check(st["kv"]["used_blocks"] == pc["entries"],
              "blocks held outside the prefix cache after the run")
        check(launches == 0, f"the paged path launched B1 {launches} times "
              f"(its prefill is plain attention)")
        log("paged", f"paged {out['tok_s']:.1f} tok/s, TTFT p50 "
            f"{out['ttft_p50_ms']:.1f} ms, TPOT p50 "
            f"{out['tpot_p50_ms']:.2f} ms; dense (same mix without the two "
            f"long prompts) {dense_mix['tok_s']:.1f} tok/s, TTFT p50 "
            f"{dense_mix['ttft_p50_ms']:.1f} ms, TPOT p50 "
            f"{dense_mix['tpot_p50_ms']:.2f} ms; {card}")
        agree = _agreement("paged", out["results"], dense_mix["results"],
                           server._engine.params, cfg, dev)
        profile = phase_profile(server, cfg, "paged profile", card)
        log("paged", f"indexing kernels (the pool gather, the KV writes, "
            f"the embedding lookup): {profile['index_ms']:.1f} of "
            f"{profile['busy_ms']:.1f} ms busy in the paged profile window "
            f"({100 * profile['index_ms'] / profile['busy_ms']:.1f}%); "
            + "; ".join(f"{ms:.1f} ms {n}x {name[:60]}"
                        for ms, n, name in profile["index_top"])
            + f"; {card}")
        return {"events": events, "agreement": agree, "profile": profile,
                **{k: v for k, v in out.items() if k != "results"},
                "dense": {k: v for k, v in dense_mix.items()
                          if k != "results"}}
    finally:
        server.shutdown()


def phase_spec_serve(dev, cfg, loader, mix, card):
    """Speculative decoding at full width: the default draft
    (``draft_config_for``: 2 layers, dim 64, head dim 16, random weights
    from seed 0) on the paged server, spec_k 4. The third phase's
    shared-prefix requests go through a fresh paged server without a
    draft and then a fresh speculative one, each after the same warm-up,
    so both start from the same state; then four more requests on the
    speculative server in a profile window. B1 launches = draft layers x
    draft prefills, all at buckets of 128 and more (none without the
    draft). Last, B1 on the q, k and v of real draft prefills at every
    bucket, against its plain version."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import LLMServer

    reqs = mix["second"]

    def serve(server):
        warm(server, cfg)
        s0 = server.stats()
        attention.flash_fwd_cuda.launches = 0
        errors = []
        t0 = time.perf_counter()
        threads, res = _clients(server, reqs, errors)
        _join(threads, errors)
        wall = time.perf_counter() - t0
        for r, x in zip(reqs, res):
            check(x["finish_reason"] == "length"
                  and x["num_tokens"] == r["max_tokens"], f"bad result {x}")
        return res, wall, s0, attention.flash_fwd_cuda.launches

    server = LLMServer(model_config=cfg, engine_config=dict(PAGED_ENGINE),
                       params_loader=loader, device=dev)
    try:
        plain, plain_wall, _, plain_launches = serve(server)
    finally:
        server.shutdown()
    check(plain_launches == 0, f"the paged server without a draft "
          f"launched B1 {plain_launches} times")
    del server
    gc.collect()
    torch.cuda.empty_cache()

    server = LLMServer(model_config=cfg, engine_config=dict(
        PAGED_ENGINE, spec_k=SPEC_K), params_loader=loader,
        speculative={"draft_seed": 0}, device=dev)
    try:
        eng = server._engine
        dc = eng.draft_config
        check((dc.n_layers, dc.dim, dc.head_dim, dc.vocab_size)
              == (2, 64, 16, cfg.vocab_size), f"draft config {dc}")
        res, wall, s0, launches = serve(server)
        s0 = s0["spec"]
        spec = server.stats()["spec"]
        prefills = spec["draft_prefills"] - s0["draft_prefills"]
        check(prefills == len(reqs) and launches == dc.n_layers * prefills,
              f"B1 launches {launches} != {dc.n_layers} draft layers x "
              f"{prefills} draft prefills ({len(reqs)} requests)")
        n_tok = sum(x["num_tokens"] for x in res)
        same = sum(x["tokens"] == y["tokens"] for x, y in zip(res, plain))
        accepted = spec["accepted"] - s0["accepted"]
        proposed = spec["proposed"] - s0["proposed"]
        out = {"requests": len(reqs), "tokens": n_tok, "wall_s": wall,
               "tok_s": n_tok / wall, "paged_wall_s": plain_wall,
               "paged_tok_s": n_tok / plain_wall,
               "accept_ratio": accepted / max(proposed, 1),
               "accepted": accepted, "proposed": proposed,
               "rounds": spec["rounds"] - s0["rounds"],
               "draft_prefills": prefills, "b1_launches": launches,
               "equal_to_paged": same}
        log("spec", f"{len(reqs)} requests, {n_tok} tokens in {wall:.2f} s "
            f"= {out['tok_s']:.1f} tok/s; the same requests on a fresh "
            f"paged server without a draft, after the same warm-up: "
            f"{plain_wall:.2f} s = {out['paged_tok_s']:.1f} tok/s "
            f"({out['tok_s'] / out['paged_tok_s']:.3f}x); "
            f"acceptance {accepted}/{proposed} = "
            f"{100 * out['accept_ratio']:.2f}% (a random draft: near zero "
            f"by construction), {out['rounds']} rounds; B1 launches "
            f"{launches} = {dc.n_layers} x {prefills} draft prefills; "
            f"tokens equal to the server's without a draft for {same} of "
            f"{len(reqs)} (bf16/int8, printed, not required); {card}")
        more = [dict(r, max_tokens=16) for r in mix["first"][:4]]
        before = attention.flash_fwd_cuda.launches
        p0 = server.stats()["spec"]["draft_prefills"]

        def run():
            errs = []
            th, _ = _clients(server, more, errs)
            _join(th, errs)

        out["profile"] = profile_window("spec profile", run, card)
        n = server.stats()["spec"]["draft_prefills"] - p0
        check(attention.flash_fwd_cuda.launches - before
              == dc.n_layers * n == dc.n_layers * len(more),
              "profiled B1 launches != draft layers x draft prefills")
        out["b1_launches"] += attention.flash_fwd_cuda.launches - before
    finally:
        server.shutdown()
    # Comparison launches, after every count of the path was read.
    out["draft_b1_tol_used"] = check_draft_b1(eng, reqs[0]["prompt"],
                                              "spec")
    return out


def check_draft_b1(eng, prompt, phase):
    """B1 on the q, k and v of real draft prefills: the engine's draft
    prefills ``prompt`` cut to fill each prefill bucket that launches B1
    (the whole prompt in the largest), zero-padded as the engine pads it;
    every layer's attention call is captured on its way to B1, and B1's O
    and LSE on those inputs (made contiguous, as the path makes them) are held against the plain version's to the
    limits of the full-width checks. Returns the largest share of a limit
    used."""
    from ray_tpu_torch.models.llama import prefill_kv
    from ray_tpu_torch.ops import attention

    dc = eng.draft_config
    check(dc.attn_impl == "flash", f"the draft's attention is "
          f"{dc.attn_impl!r}, not B1")
    lens = sorted({min(len(prompt), b) for b in eng.config.prefill_buckets
                   if b >= attention.MIN_KERNEL_SEQ})
    worst, shapes = 0.0, []
    for n in lens:
        calls = []

        def capture(q, k, v, causal=True):
            calls.append((q, k, v, causal))
            return attention.flash_attention(q, k, v, causal=causal)

        padded = np.zeros((eng._bucket_for(n),), np.int64)
        padded[:n] = prompt[:n]
        tokens = torch.from_numpy(padded).to(eng.device)[None]
        with torch.no_grad():
            prefill_kv(eng._draft, tokens, dc, attn_impl=capture)
            for i, (q, k, v, causal) in enumerate(calls):
                check(q.shape == (1, padded.shape[0], dc.n_heads,
                                  dc.head_dim) and causal,
                      f"{phase}: draft layer {i} attends {tuple(q.shape)}")
                q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
                o, lse = attention.flash_fwd_cuda(q, k, v, causal)
                po, plse = attention.flash_attention_plain(q, k, v, causal)
                used = b1_used(o, lse, po, plse, q.dtype)
                check(max(used) <= 1.0, f"{phase}: B1 on draft layer {i}'s "
                      f"prefill of {n} tokens (bucket {padded.shape[0]}, "
                      f"{q.dtype}): shares of the limits (O, LSE) {used}")
                worst = max(worst, max(used))
        check(len(calls) == dc.n_layers, f"{phase}: {len(calls)} draft "
              f"attention calls for {dc.n_layers} layers")
        shapes.append(f"{n} tokens in bucket {padded.shape[0]}")
    log(phase, f"B1 on the q, k and v of real draft prefills "
        f"({', '.join(shapes)}; {dc.n_layers} layers, {dc.n_heads} heads of "
        f"{dc.head_dim}, {dc.dtype}): O and LSE within their limits against "
        f"the plain version (at most {worst:.2f} of one)")
    return worst


def _gate_cfg(dtype):
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama3_8b(n_layers=GATE_LAYERS, attn_impl="flash",
                                 dtype=dtype, param_dtype=dtype)


def phase_paged_bitwise(dev, card):
    """Bitwise gates at Llama-3-8B widths, 4 layers, bf16: (1)
    decode_step_paged against decode_step on the same KV contents at
    batch 8 (logits and written rows); (2) export -> adopt round trip;
    (3) a preempted request's tokens equal its tokens without preemption;
    (4) a tier-promoted request's tokens equal the same prompt's with its
    prefix still in the pool."""
    from ray_tpu_torch.models.llama import (_paged_view, decode_step,
                                            decode_step_paged,
                                            init_paged_kv_cache,
                                            init_params)
    from ray_tpu_torch.serve.llm.engine import (EngineConfig, LLMEngine,
                                                Request)

    cfg = _gate_cfg(torch.bfloat16)
    params = init_params(cfg, 3, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    B, bs, mb = 8, 16, 64
    pools = init_paged_kv_cache(cfg, B * mb, bs, device=dev)
    for t in pools.values():
        t.normal_(generator=gen)
    tables = torch.randperm(B * mb, generator=gen, device=dev).reshape(B, mb)
    dense = {n: torch.stack([_paged_view(pools[n][i], tables)
                             for i in range(cfg.n_layers)])
             for n in ("k", "v")}
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev)
    pos = torch.randint(0, mb * bs, (B,), generator=gen, device=dev)
    with torch.no_grad():
        pl, pools = decode_step_paged(params, pools, tables, tok, pos, cfg)
        dl, dense = decode_step(params, dense, tok, pos, cfg)
    rows_equal = all(torch.equal(torch.stack(
        [_paged_view(pools[n][i], tables) for i in range(cfg.n_layers)]),
        dense[n]) for n in ("k", "v"))
    check(torch.equal(pl, dl) and rows_equal,
          "decode_step_paged != decode_step on the same contents")
    del pools, dense

    rng = np.random.RandomState(11)
    sys_p = rng.randint(0, cfg.vocab_size, 160).tolist()
    prompt = sys_p + rng.randint(0, cfg.vocab_size, 60).tolist()
    geo = dict(num_slots=8, max_seq_len=1024,
               prefill_buckets=(128, 256, 512), kv_layout="paged",
               kv_block_size=bs, kv_prefill_cost_per_token_ms=50.0)

    def engine():
        return LLMEngine(params, cfg, EngineConfig(**geo), device=dev)

    def run(eng, p, n):
        h = eng.submit(Request(prompt=p, max_tokens=n))
        eng.drain()
        return h.tokens

    with torch.no_grad():
        plain = run(engine(), prompt, 24)
        eng = engine()
        h = eng.submit(Request(prompt=prompt, max_tokens=24, slo="batch"))
        for _ in range(6):
            eng.step()
        slot = next(s for s in range(8) if eng._slots[s].handle is h)
        n_valid = -(-int(eng._pos[slot]) // bs)
        ids = eng._tables[slot, :n_valid].tolist()
        rows = (eng._cache["k"][:, ids].cpu(), eng._cache["v"][:, ids].cpu())
        eng.preempt(slot)
        st = h.kv_state
        exported = (torch.equal(st.k_blocks, rows[0])
                    and torch.equal(st.v_blocks, rows[1]))
        eng._admit()
        slot = next(s for s in range(8) if eng._slots[s].handle is h)
        ids = eng._tables[slot, :n_valid].tolist()
        adopted = (torch.equal(eng._cache["k"][:, ids].cpu(), st.k_blocks)
                   and torch.equal(eng._cache["v"][:, ids].cpu(),
                                   st.v_blocks))
        eng.drain()
        check(exported and adopted, f"export -> adopt not bitwise "
              f"(export {exported}, adopt {adopted})")
        check(h.tokens == plain, "preempted tokens differ from the run "
              "without preemption")

        eng = engine()
        other = sys_p + rng.randint(0, cfg.vocab_size, 40).tolist()
        run(eng, prompt, 4)                 # the shared blocks in the pool
        run(eng, other, 4)                  # other's own full blocks too
        hit = eng._prefix.match(other)
        rows = (eng._cache["k"][:, hit].cpu(), eng._cache["v"][:, hit].cpu())
        eng._allocator.free(hit)
        in_pool = run(eng, other, 16)       # every full block a pool hit
        n = len(eng._prefix)
        check(eng._prefix.evict(n) == n, "evict")
        promoted = run(eng, other, 16)      # the same blocks promoted
        st = eng.stats()["kv_tiers"]
        check(st["promoted_blocks"] == len(hit), f"promote: {st}")
        back = eng._prefix.match(other)
        check(torch.equal(eng._cache["k"][:, back].cpu(), rows[0])
              and torch.equal(eng._cache["v"][:, back].cpu(), rows[1]),
              "the promoted history differs from the pool history")
        eng._allocator.free(back)
        check(promoted == in_pool, "promoted tokens differ from the "
              "in-pool prefix's")
    log("paged bitwise", f"Llama-3-8B widths, {GATE_LAYERS} layers, bf16: "
        f"decode_step_paged == decode_step at batch {B} (logits and "
        f"rows); export -> adopt bitwise ({n_valid} blocks); preempted "
        f"tokens == unpreempted ({len(plain)}); promoted "
        f"({st['promoted_blocks']} blocks) tokens == in-pool ({len(in_pool)}"
        f"); {card}")
    del params
    return {"decode_batch": B, "round_trip_blocks": n_valid,
            "promoted_blocks": st["promoted_blocks"]}


def phase_paged_tokens(dev, card):
    """Token gates in f32 at Llama-3-8B widths, 4 layers: the paged
    engine's greedy tokens equal the dense engine's and generate's for
    every request (prefix hits, a chunked prompt, preempted and promoted
    requests), and LLMServer(speculative=True) at spec_k 4 equals the
    same paged server without a draft; then B1 on the q, k and v of that
    f32 draft's real prefills."""
    from ray_tpu_torch.models.llama import generate, init_params
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.serve.llm.engine import (EngineConfig, LLMEngine,
                                                Request)

    cfg = _gate_cfg(torch.float32)
    params = init_params(cfg, 4, dev)
    rng = np.random.RandomState(12)

    def toks(n):
        return rng.randint(0, cfg.vocab_size, n).tolist()

    sys_p = toks(SYS_PREFIX)
    geo = dict(num_slots=4, max_seq_len=1024,
               prefill_buckets=(128, 256, 512))
    paged = LLMEngine(params, cfg, EngineConfig(
        **geo, kv_layout="paged", kv_block_size=16,
        kv_prefill_cost_per_token_ms=50.0, preempt_hold_s=0.0,
        preempt_cooldown_s=0.0), device=dev)
    dense = LLMEngine(params, cfg, EngineConfig(**geo), device=dev)
    n_new = 8
    cases = []
    with torch.no_grad():
        # Prefix miss, then hits; a chunked prompt (paged only).
        for p in (sys_p + toks(40), sys_p + toks(90)):
            cases.append(("prefix", p, paged.submit(Request(
                prompt=p, max_tokens=n_new))))
            paged.drain()
        p = toks(700)
        cases.append(("chunked", p, paged.submit(Request(
            prompt=p, max_tokens=n_new, chunked_prefill=True))))
        paged.drain()
        # Batch decodes in every slot; an interactive arrival preempts.
        batch = [toks(150) for _ in range(4)]
        hb = [paged.submit(Request(prompt=p, max_tokens=n_new, slo="batch"))
              for p in batch]
        paged.step()
        p = sys_p + toks(30)
        cases.append(("interactive", p, paged.submit(Request(
            prompt=p, max_tokens=n_new))))
        paged.drain()
        cases += [("batch", p, h) for p, h in zip(batch, hb)]
        # Spill the cache, then a prompt on the spilled prefix.
        paged._prefix.evict(len(paged._prefix))
        p = sys_p + toks(50)
        cases.append(("promoted", p, paged.submit(Request(
            prompt=p, max_tokens=n_new))))
        paged.drain()
        st = paged.stats()
        check(st["preempted"] >= 1 and st["kv_tiers"]["promoted_blocks"]
              >= SYS_PREFIX // 16 and st["prefix_cache"]["hits"] >= 2
              and st["chunked_prefill"]["prompts"] == 1,
              f"f32 gate: events missing {st}")
        bad = []
        for kind, p, h in cases:
            ref = generate(params, torch.tensor([p], device=dev), cfg,
                           max_new_tokens=n_new)[0].tolist()
            want = [ref]
            if len(p) <= geo["prefill_buckets"][-1]:
                hd = dense.submit(Request(prompt=p, max_tokens=n_new))
                dense.drain()
                want.append(hd.tokens)
            if any(h.tokens != w for w in want):
                bad.append((kind, len(p)))
        check(not bad, f"f32: paged tokens differ from dense/generate: "
              f"{bad}")
        del paged, dense
        reqs = [{"prompt": sys_p + toks(int(rng.randint(20, 200))),
                 "max_tokens": 12} for _ in range(4)]
        outs = []
        for spec in (None, True):
            server = LLMServer(model_config=cfg, engine_config=dict(
                geo, kv_layout="paged", kv_block_size=16, spec_k=SPEC_K),
                params_loader=lambda: params, quantize="bf16",
                speculative=spec, device=dev)
            try:
                outs.append([server(r)["tokens"] for r in reqs])
                rounds = server.stats().get("spec", {}).get("rounds", 0)
            finally:
                server.shutdown()
        check(rounds > 0, "the speculative server ran no round")
        check(outs[0] == outs[1], "speculative tokens differ from the "
              "paged server's without a draft")
    draft_used = check_draft_b1(server._engine, reqs[0]["prompt"],
                                "paged tokens")
    log("paged tokens", f"Llama-3-8B widths, {GATE_LAYERS} layers, f32: "
        f"paged == dense == generate for {len(cases)} requests (prefix "
        f"hits, a chunked 700-token prompt, a preempting interactive and "
        f"4 batch requests, {st['preempted']} preempted, a promoted "
        f"prefix); speculative (spec_k {SPEC_K}, {rounds} rounds) == plain "
        f"paged for {len(reqs)} requests; {card}")
    del params
    return {"requests": len(cases), "preempted": st["preempted"],
            "spec_rounds": rounds, "draft_b1_tol_used": draft_used}


# ---------------------------------------------------------------------------
# The disaggregated serving slice: a prefill server and a decode server
# sharing the card in one process, KV migration between them, the peer
# prefix pull, and the engine's metrics, spans and cost meters.
# ---------------------------------------------------------------------------

# Prompts of at least this many tokens take the two-hop path (prefill, then
# adopt), the reference's prefill_threshold default (disagg/app.py); the
# others go straight to the decode server.
PREFILL_THRESHOLD = 256


def disagg_mix(vocab, seed=0):
    """The disagg phase's traffic, from numpy ``seed``: 8 requests on a
    256-token shared prefix with 50-250 own tokens (16-32 new), 2
    interactive prompts of 700-900 tokens with chunked_prefill (16 new),
    2 short prompts of 64-128 tokens (16-32 new). In submission order,
    each with a tenant of three."""
    rng = np.random.RandomState(seed)

    def toks(n):
        return rng.randint(0, vocab, int(n)).tolist()

    sys_prefix = toks(SYS_PREFIX)
    shared = [{"prompt": sys_prefix + toks(rng.randint(50, 251)),
               "max_tokens": int(rng.randint(16, 33))} for _ in range(8)]
    long = [{"prompt": toks(rng.randint(700, 901)), "max_tokens": 16,
             "chunked_prefill": True} for _ in range(2)]
    short = [{"prompt": toks(rng.randint(64, 129)),
              "max_tokens": int(rng.randint(16, 33))} for _ in range(2)]
    reqs = shared[:4] + long[:1] + short[:1] + shared[4:] + long[1:] + \
        short[1:]
    return [dict(r, tenant=f"tenant-{i % 3}") for i, r in enumerate(reqs)]


def _two_hop(pre, dec, r):
    """Prefill on ``pre``, adopt on ``dec``; (response, prefill result)."""
    res = pre.prefill(r)
    return dec.adopt(res, r), res


class _DisaggClient:
    """Routes requests as the reference's router does: two hops for
    prompts of PREFILL_THRESHOLD tokens or more, each under its own
    trace_root, the rest to the decode server. Keeps every two-hop
    request's trace id and exported state."""

    def __init__(self, pre, dec):
        self.pre, self.dec = pre, dec
        self.traces, self.states = [], []

    def __call__(self, r):
        from ray_tpu_torch.util import tracing

        if len(r["prompt"]) < PREFILL_THRESHOLD:
            return self.dec(r)
        with tracing.trace_root("disagg.request") as tc:
            out, res = _two_hop(self.pre, self.dec, r)
        self.traces.append(tc.trace_id)
        self.states.append(res["kv_state"])
        return out


def _concurrent(route, reqs, phase, card):
    """Send ``reqs`` through ``route`` from N_CLIENTS threads; every
    request must end at its max_tokens. Returns tok/s, TTFT and TPOT p50
    and the results in request order."""
    errors = []
    t0 = time.perf_counter()
    threads, res = _clients(route, reqs, errors)
    _join(threads, errors)
    wall = time.perf_counter() - t0
    for r, x in zip(reqs, res):
        check(x is not None and x["finish_reason"] == "length"
              and x["num_tokens"] == r["max_tokens"],
              f"{phase}: a request for {r['max_tokens']} tokens ended "
              f"{x and (x['finish_reason'], x['num_tokens'])}")
    n_tok = sum(x["num_tokens"] for x in res)
    out = {"requests": len(reqs), "tokens": n_tok, "wall_s": wall,
           "tok_s": n_tok / wall,
           "ttft_p50_ms": 1e3 * float(np.median([x["ttft_s"] for x in res])),
           "tpot_p50_ms": 1e3 * float(np.median([x["tpot_s"] for x in res])),
           "results": res}
    log(phase, f"{len(reqs)} requests from {N_CLIENTS} clients, {n_tok} "
        f"tokens in {wall:.2f} s = {out['tok_s']:.1f} tok/s, TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms, TPOT p50 {out['tpot_p50_ms']:.2f} "
        f"ms; {card}")
    return out


def _free(*servers):
    for s in servers:
        s.shutdown()
    gc.collect()
    torch.cuda.empty_cache()


def _ledger_requests():
    from ray_tpu_torch.observability.accounting import tenant_ledger

    return sum(t["requests"] for t in tenant_ledger().snapshot().values())


def _tree_ok(trace_id):
    """The span tree of one two-hop request: llm.disagg_prefill and
    llm.disagg_decode under the root, each over its engine's llm.request,
    kv.migrate under the decode side's, nothing orphaned."""
    from ray_tpu_torch.util import tracing

    tree = tracing.build_trace_tree(tracing.span_events(trace_id))
    root = tree["root"]
    if root is None or tree["orphans"]:
        return False
    kids = {c["name"]: c for c in root["children"]}
    if set(kids) != {"llm.disagg_prefill", "llm.disagg_decode"}:
        return False
    reqs = [c for c in kids["llm.disagg_decode"]["children"]
            if c["name"] == "llm.request"]
    pre = [c for c in kids["llm.disagg_prefill"]["children"]
           if c["name"] == "llm.request"]
    return (len(reqs) == 1 and len(pre) == 1
            and "kv.migrate" in {c["name"] for c in reqs[0]["children"]}
            and pre[0]["attrs"].get("finish_reason") == "prefill")


def phase_disagg(dev, cfg, loader, card):
    """The disaggregated tier at Llama-3-8B full width and depth (int8,
    the paged phase's engine config on every server), two servers on the
    one card in one process.

    (1) Bitwise: the mix one request at a time, all two-hop, through a
    fresh PrefillServer/DecodeServer pair, then in the same order through
    a fresh monolithic paged server: equal greedy tokens for every
    request. (2) The mix from four client threads on a fresh warmed pair,
    the reference router's split: tok/s, TTFT and TPOT p50, migration
    cost per two-hop request (export: the gather and device-to-host copy;
    adopt: the kv.migrate span; bytes); gates: the token counter against
    the meters, one ledger row per request, KVImporter's blocks and bytes
    against the adopted states', every two-hop span tree. Then one
    profile window over the prefill server and one over the decode
    server, on a second mix (seed 1) split by hop. (3) A speculative
    decode server (the default random draft) adopting from the prefill
    server: B1 launches = draft layers x draft prefills, then B1 on an
    adopted request's real draft q/k/v. (4) A fresh monolithic server on
    the same mix from the same state (tok/s, TTFT, TPOT, agreement), then
    the peer pull: it donates a 256-token-prefix prompt's chain to a
    fresh receiver, which promotes every exported block, prefills only
    the suffix and decodes what the donor does on a pool hit of the same
    depth. (5) The hooks' host cost: HOOK_PAIRS pairs of fresh servers
    with serve_accounting_instrumentation on and off, alternating which
    runs first, each on the same mix after the same warm-up."""
    from ray_tpu_torch.observability.accounting import TokenReconciler
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import (DecodeServer, KVImporter,
                                         LLMServer, PrefillServer)
    from ray_tpu_torch.serve.llm.engine import Request
    from ray_tpu_torch.util import tracing

    reqs = disagg_mix(cfg.vocab_size)
    two = [r for r in reqs if len(r["prompt"]) >= PREFILL_THRESHOLD]

    def server(cls, **kw):
        return cls(model_config=cfg, engine_config=dict(PAGED_ENGINE),
                   params_loader=loader, device=dev, **kw)

    # (1) Bitwise, one request at a time.
    pre, dec = server(PrefillServer), server(DecodeServer)
    hop = [_two_hop(pre, dec, r)[0]["tokens"] for r in reqs]
    _free(pre, dec)
    del pre, dec
    mono = server(LLMServer)
    whole = [mono(r)["tokens"] for r in reqs]
    _free(mono)
    del mono
    same = sum(a == b for a, b in zip(hop, whole))
    log("disagg", f"bitwise: two-hop == monolithic greedy tokens for "
        f"{same} of {len(reqs)} requests, one at a time (int8, "
        f"{cfg.n_layers} layers); {card}")
    check(same == len(reqs), "two-hop tokens differ from the monolithic "
          "server's")

    # (2) The concurrent mix on a fresh warmed pair.
    pre, dec = server(PrefillServer), server(DecodeServer)
    warm(pre, cfg)
    warm(dec, cfg)
    exports = []
    export_state = pre._engine._export_state

    def timed_export(slot):
        t0 = time.perf_counter()
        st = export_state(slot)
        exports.append(time.perf_counter() - t0)
        return st

    pre._engine._export_state = timed_export
    importer = KVImporter(dec._engine)
    route = _DisaggClient(pre, dec)
    rows0, mig0 = _ledger_requests(), importer.stats()
    with TokenReconciler() as rec:
        pair = _concurrent(route, reqs, "disagg", card)
    rows = _ledger_requests() - rows0
    mig = {k: v - mig0[k] for k, v in importer.stats().items()}
    states = route.states
    check(len(states) == len(two) and len(route.traces) == len(two),
          f"{len(states)} two-hop requests, expected {len(two)}")
    check(rec.meter_sum == sum(x["num_tokens"] for x in pair["results"])
          and rec.counter_delta - rec.meter_sum == len(two),
          f"token counter against the meters: {rec.detail()} (expected "
          f"the counter {len(two)} ahead: each two-hop request's first "
          f"token is counted on both hops)")
    check(rows == len(reqs) and len(rec._rows) == len(reqs),
          f"{rows} ledger rows ({len(rec._rows)} folded) for "
          f"{len(reqs)} requests")
    want = {"blocks": sum(s.n_blocks for s in states),
            "bytes": sum(s.payload_bytes for s in states)}
    check(mig == want, f"KVImporter {mig} != the adopted states' {want}")
    bad = [t for t in route.traces if not _tree_ok(t)]
    check(not bad, f"{len(bad)} two-hop span trees malformed")
    spans = {t: tracing.span_events(t) for t in route.traces}
    adopt_ms = [1e3 * e["dur"] for ev in spans.values() for e in ev
                if e["name"] == "kv.migrate"]
    migration = {
        "export_ms_p50": 1e3 * float(np.median(exports)),
        "export_ms_max": 1e3 * max(exports),
        "adopt_ms_p50": float(np.median(adopt_ms)),
        "adopt_ms_max": max(adopt_ms),
        "mib_p50": float(np.median([s.payload_bytes for s in states]))
        / 2**20,
        "blocks": want["blocks"], "bytes": want["bytes"],
        "requests": len(states)}
    log("disagg", f"migration per two-hop request ({len(states)}): export "
        f"(gather + pageable device-to-host copy) p50 "
        f"{migration['export_ms_p50']:.2f} ms, max "
        f"{migration['export_ms_max']:.2f}; adopt (kv.migrate) p50 "
        f"{migration['adopt_ms_p50']:.2f} ms, max "
        f"{migration['adopt_ms_max']:.2f}; payload p50 "
        f"{migration['mib_p50']:.1f} MiB ({want['blocks']} blocks, "
        f"{want['bytes'] / 2**20:.0f} MiB in all); token counter "
        f"{rec.counter_delta:.0f} = meters {rec.meter_sum:.0f} + "
        f"{len(two)} migrated first tokens; {rows} ledger rows; "
        f"{len(route.traces)} span trees whole; {card}")

    # Profiles: a second mix, each hop in a window of its own.
    prof = disagg_mix(cfg.vocab_size, seed=1)
    ptwo = [r for r in prof if len(r["prompt"]) >= PREFILL_THRESHOLD]
    pshort = [r for r in prof if len(r["prompt"]) < PREFILL_THRESHOLD]
    results = [None] * len(ptwo)

    def prefill_all():
        errs = []
        th, res = _clients(pre.prefill, ptwo, errs)
        _join(th, errs)
        results[:] = res

    def decode_all():
        errs = []
        jobs = [("adopt", x, r) for x, r in zip(results, ptwo)] + \
            [("call", None, r) for r in pshort]

        def run(job):
            kind, res, r = job
            return dec.adopt(res, r) if kind == "adopt" else dec(r)

        th, _ = _clients(run, jobs, errs)
        _join(th, errs)

    profiles = {"prefill": profile_window("disagg prefill profile",
                                          prefill_all, card),
                "decode": profile_window("disagg decode profile",
                                         decode_all, card)}
    _free(dec)
    del dec

    # (3) A speculative decode server adopting from the prefill server.
    spec = server(DecodeServer, speculative={"draft_seed": 0})
    eng = spec._engine
    dc = eng.draft_config
    warm(spec, cfg)
    p0 = eng.stats()["spec"]["draft_prefills"]
    attention.flash_fwd_cuda.launches = 0
    spec_route = _DisaggClient(pre, spec)
    spec_out = _concurrent(spec_route, two, "disagg spec", card)
    b1 = attention.flash_fwd_cuda.launches
    prefills = eng.stats()["spec"]["draft_prefills"] - p0
    fits = sum(len(r["prompt"]) <= ENGINE["prefill_buckets"][-1]
               for r in two)
    check(prefills == fits and b1 == dc.n_layers * prefills and b1 > 0,
          f"B1 launches {b1} != {dc.n_layers} draft layers x {prefills} "
          f"draft prefills ({fits} adopted prompts fit a bucket)")
    agree = sum(a["tokens"] == b["tokens"] for a, b in
                zip(spec_out["results"],
                    [x for r, x in zip(reqs, pair["results"])
                     if len(r["prompt"]) >= PREFILL_THRESHOLD]))
    log("disagg spec", f"a speculative decode server (draft {dc.n_layers} "
        f"layers, head dim {dc.head_dim}) adopted {len(two)} checkpoints: "
        f"B1 launches {b1} = {dc.n_layers} x {prefills} draft prefills "
        f"(the {len(two) - fits} longer than the largest bucket decode "
        f"without a draft); tokens equal to the plain decode server's for "
        f"{agree} of {len(two)} (bf16/int8, printed, not required); {card}")
    _free(pre, spec)
    del pre
    draft_used = check_draft_b1(eng, next(
        r["prompt"] for r in two
        if len(r["prompt"]) <= ENGINE["prefill_buckets"][-1]), "disagg spec")
    del spec, eng

    # (4) The monolithic server on the same mix from the same state, then
    # the peer pull from it to a fresh receiver.
    mono = server(LLMServer)
    warm(mono, cfg)
    whole = _concurrent(mono, reqs, "disagg monolithic", card)
    agree_mono = sum(a["tokens"] == b["tokens"]
                     for a, b in zip(pair["results"], whole["results"]))
    log("disagg", f"two-hop pair {pair['tok_s']:.1f} tok/s, TTFT p50 "
        f"{pair['ttft_p50_ms']:.1f} ms, TPOT p50 {pair['tpot_p50_ms']:.2f} "
        f"ms; monolithic {whole['tok_s']:.1f} tok/s, TTFT p50 "
        f"{whole['ttft_p50_ms']:.1f} ms, TPOT p50 "
        f"{whole['tpot_p50_ms']:.2f} ms ({pair['tok_s'] / whole['tok_s']:.3f}"
        f"x); tokens equal for {agree_mono} of {len(reqs)} requests "
        f"(concurrent: printed, not required); {card}")
    rng = np.random.RandomState(5)
    prompt = reqs[0]["prompt"][:SYS_PREFIX]
    while len(prompt) % 16 == 0 or len(prompt) == SYS_PREFIX:
        prompt = reqs[0]["prompt"][:SYS_PREFIX] + rng.randint(
            0, cfg.vocab_size, int(rng.randint(60, 200))).tolist()

    def serve(s):
        h = s._engine.submit(Request(prompt=prompt, max_tokens=16))
        h.result(timeout=300)
        return h

    serve(mono)
    donor = serve(mono)
    links = mono.export_prefix(prompt)
    recv = server(LLMServer)
    t0 = recv.stats()["kv_tiers"]
    imported = recv.import_prefix(links)
    got = serve(recv)
    t1 = recv.stats()["kv_tiers"]
    promoted = t1["promoted_blocks"] - t0["promoted_blocks"]
    suffix = len(prompt) - len(links) * 16
    check(imported == len(links) == len(prompt) // 16 and
          promoted == len(links),
          f"peer pull: {len(links)} links exported, {imported} imported, "
          f"{promoted} promoted")
    check(got.prefilled_tokens == suffix == donor.prefilled_tokens,
          f"peer pull: the receiver prefilled {got.prefilled_tokens} "
          f"tokens, the donor {donor.prefilled_tokens}, the suffix is "
          f"{suffix}")
    check(got.tokens == donor.tokens, "peer pull: the receiver's tokens "
          "differ from the donor's pool hit")
    log("disagg", f"peer pull: a {len(prompt)}-token prompt's {len(links)} "
        f"blocks ({sum(x.payload_bytes for x in links) / 2**20:.0f} MiB) "
        f"exported, imported and promoted; {suffix} suffix tokens "
        f"prefilled; tokens == the donor's pool hit ({len(got.tokens)}); "
        f"{card}")
    _free(mono, recv)
    del mono, recv

    # (5) The hooks' host cost: HOOK_PAIRS pairs of fresh servers, the
    # accounting knob (latched at engine init) on and off, alternating
    # which side runs first, on the same mix from the same state.
    hooks = {"on": [], "off": []}
    for i in range(HOOK_PAIRS):
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            os.environ["RAY_TPU_serve_accounting_instrumentation"] = \
                "1" if side == "on" else "0"
            try:
                s = server(LLMServer)
            finally:
                os.environ.pop("RAY_TPU_serve_accounting_instrumentation")
            check(s._engine._acct is (side == "on"),
                  f"accounting not {side} on a server built with it {side}")
            warm(s, cfg)
            hooks[side].append(_concurrent(
                s, reqs, f"disagg accounting {side} ({i + 1})", card))
            _free(s)
            del s
    ratios = [a["tok_s"] / b["tok_s"]
              for a, b in zip(hooks["on"], hooks["off"])]

    def med(side, key):
        return float(np.median([r[key] for r in hooks[side]]))

    hooks_cost = {
        "pairs": HOOK_PAIRS, "tok_s_ratio": ratios,
        "tok_s_ratio_median": float(np.median(ratios)),
        **{f"{side}_{key}": [r[key] for r in hooks[side]]
           for side in hooks for key in ("tok_s", "ttft_p50_ms",
                                         "tpot_p50_ms")}}
    log("disagg", f"accounting on/off tok/s over {HOOK_PAIRS} alternating "
        f"pairs: " + ", ".join(f"{r:.3f}x" for r in ratios)
        + f" (median {hooks_cost['tok_s_ratio_median']:.3f}x); median on "
        f"{med('on', 'tok_s'):.1f} tok/s, TTFT p50 "
        f"{med('on', 'ttft_p50_ms'):.1f} ms, TPOT p50 "
        f"{med('on', 'tpot_p50_ms'):.2f} ms; off {med('off', 'tok_s'):.1f}"
        f" tok/s, TTFT p50 {med('off', 'ttft_p50_ms'):.1f} ms, TPOT p50 "
        f"{med('off', 'tpot_p50_ms'):.2f} ms; {card}")

    def strip(d):
        return {k: v for k, v in d.items() if k != "results"}

    return {"bitwise_requests": len(reqs), "pair": strip(pair),
            "monolithic": strip(whole), "agreement": agree_mono,
            "migration": migration, "profiles": profiles,
            "spec": {"b1_launches": b1, "draft_prefills": prefills,
                     "agreement": agree, "tok_s": spec_out["tok_s"],
                     "draft_b1_tol_used": draft_used},
            "peer_pull": {"blocks": len(links), "promoted": promoted,
                          "suffix_tokens": suffix},
            "hooks_cost": hooks_cost}


def phase_disagg_gates(dev, card):
    """At Llama-3-8B widths, 4 layers: two-hop (prefill engine, then
    submit_adopted on a decode engine) equal to one paged engine, bit for
    bit in bf16 and token for token in f32, where both also equal
    ``generate``; then a PrefillServer feeding a
    DecodeServer(speculative=True) in f32 gives the plain paged engine's
    tokens for every request, and B1 on that draft's real prefills."""
    from ray_tpu_torch.models.llama import generate, init_params
    from ray_tpu_torch.serve.llm import DecodeServer, PrefillServer
    from ray_tpu_torch.serve.llm.engine import (EngineConfig, LLMEngine,
                                                Request)

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = _gate_cfg(dtype)
        params = init_params(cfg, 6, dev)
        rng = np.random.RandomState(13)

        def toks(n):
            return rng.randint(0, cfg.vocab_size, n).tolist()

        sys_p = toks(SYS_PREFIX)
        reqs = [(sys_p + toks(40), 10), (sys_p + toks(120), 10),
                (toks(700), 8), (toks(100), 10)]
        geo = dict(PAGED_ENGINE, num_slots=4)

        def engine():
            return LLMEngine(params, cfg, EngineConfig(**geo), device=dev)

        pe, de, mono = engine(), engine(), engine()
        hop, whole = [], []
        with torch.no_grad():
            for p, n in reqs:
                chunk = len(p) > ENGINE["prefill_buckets"][-1]
                h = pe.submit(Request(prompt=p, max_tokens=n,
                                      prefill_only=True,
                                      chunked_prefill=chunk))
                pe.drain()
                h2 = de.submit_adopted(Request(prompt=p, max_tokens=n),
                                       h.kv_state)
                de.drain()
                hop.append(h2.tokens)
                h3 = mono.submit(Request(prompt=p, max_tokens=n,
                                         chunked_prefill=chunk))
                mono.drain()
                whole.append(h3.tokens)
            check(hop == whole, f"{dtype}: two-hop tokens differ from the "
                  f"paged engine's")
            name = str(dtype).rsplit(".", 1)[-1]
            if dtype == torch.float32:
                ref = [generate(params, torch.tensor([p], device=dev), cfg,
                                max_new_tokens=n)[0].tolist()
                       for p, n in reqs]
                check(hop == ref, "f32: two-hop tokens differ from "
                      "generate")
                servers = [PrefillServer(
                    model_config=cfg, engine_config=geo,
                    params_loader=lambda: params, quantize="bf16",
                    device=dev), DecodeServer(
                    model_config=cfg, engine_config=dict(geo, spec_k=SPEC_K),
                    params_loader=lambda: params, quantize="bf16",
                    speculative=True, device=dev)]
                try:
                    spec = [servers[1].adopt(servers[0].prefill(
                        {"prompt": p, "max_tokens": n}),
                        {"prompt": p, "max_tokens": n})["tokens"]
                        for p, n in reqs]
                    rounds = servers[1].stats()["spec"]["rounds"]
                finally:
                    for s in servers:
                        s.shutdown()
                check(rounds > 0, "the speculative decode server ran no "
                      "round")
                check(spec == whole, "f32: the speculative decode server's "
                      "tokens differ from the paged engine's")
                out["draft_b1_tol_used"] = check_draft_b1(
                    servers[1]._engine, reqs[0][0], "disagg gates")
                out["spec_rounds"] = rounds
                del servers
            out[name] = len(reqs)
        del pe, de, mono, params
        gc.collect()
        torch.cuda.empty_cache()
    log("disagg gates", f"Llama-3-8B widths, {GATE_LAYERS} layers: two-hop "
        f"== paged engine bit for bit in bf16 ({out['bfloat16']} requests: "
        f"prefix hits, a chunked 700-token prompt, a short one); f32: "
        f"two-hop == paged == generate, and a speculative decode server "
        f"({out['spec_rounds']} rounds) adopting the prefill server's "
        f"checkpoints == paged for {out['float32']}; {card}")
    return out


def _grads(cfg, params, batch, impl):
    from ray_tpu_torch.models.llama import loss_fn

    leaves = torch.utils._pytree.tree_leaves(params)
    loss = loss_fn(params, batch, cfg, attn_impl=impl)
    return loss.item(), torch.autograd.grad(loss, leaves)


def _rel_l2(got, want):
    return [((a.float() - b.float()).norm() / b.float().norm()).item()
            for a, b in zip(got, want)]


def phase_train_parity(cfg, params, batch, card):
    """Flash against plain attention on the same params and batch, both
    in bf16 (the gate), and each of them against the same model computed
    in f32 with plain attention (printed: how much of their distance is
    the bf16 rounding of either)."""
    lf, gf = _grads(cfg, params, batch, "flash")
    lx, gx = _grads(cfg, params, batch, "xla")
    rel = _rel_l2(gf, gx)
    loss_rel = abs(lf - lx) / abs(lx)
    l32, g32 = _grads(dataclasses.replace(cfg, dtype=torch.float32), params,
                      batch, "xla")
    rf, rx = _rel_l2(gf, g32), _rel_l2(gx, g32)
    del gf, gx, g32
    log("train", f"flash vs plain attention (bf16): loss {lf:.5f} vs "
        f"{lx:.5f} (rel {loss_rel:.2e}, tol {TOL_PARITY_LOSS}); grad "
        f"leaves' relative L2 max {max(rel):.3e}, median "
        f"{np.median(rel):.3e} over {len(rel)} leaves (tol "
        f"{TOL_PARITY_GRAD}). Against f32 compute (loss {l32:.5f}): flash "
        f"max {max(rf):.3e} median {np.median(rf):.3e}, plain max "
        f"{max(rx):.3e} median {np.median(rx):.3e}; {card}")
    check(loss_rel <= TOL_PARITY_LOSS and max(rel) <= TOL_PARITY_GRAD,
          "flash and plain attention disagree on the loss or a gradient")
    return rel, loss_rel


def phase_train_f32(dev):
    """The training path in f32 at a narrow width with head dim 128 (the
    kernels' width): flash and plain attention must then agree to f32
    summation order, which holds B1, B2, B3, the autograd Function, GQA,
    remat and the fused loss to each other far more tightly than bf16
    can. f32 products on the card run in full f32 (TF32 off)."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the f32 check needs full f32")
    cfg = LlamaConfig(vocab_size=1000, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, hidden_dim=512, max_seq_len=512,
                      dtype=torch.float32, param_dtype=torch.float32,
                      attn_impl="flash", remat="dots")
    params = init_params(cfg, seed=1, device=dev)
    for t in torch.utils._pytree.tree_leaves(params):
        t.requires_grad_(True)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 301))
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    lf, gf = _grads(cfg, params, batch, "flash")
    lx, gx = _grads(cfg, params, batch, "xla")
    rel = _rel_l2(gf, gx)
    loss_rel = abs(lf - lx) / abs(lx)
    log("train", f"f32, dim 256, head dim 128, 2 layers, 2 x 300 "
        f"positions: flash vs plain attention loss rel {loss_rel:.2e}, "
        f"grad leaves' relative L2 max {max(rel):.3e} (tol "
        f"{TOL_PARITY_F32})")
    check(loss_rel <= TOL_PARITY_F32 and max(rel) <= TOL_PARITY_F32,
          "f32 flash and plain attention disagree")
    return max(rel)


def phase_train_tiny(dev):
    """LlamaConfig.tiny() (head dim 16, which the kernel wrappers pad to
    128) under attn_impl="flash" on the card, in f32 at 2 x 128
    positions: the loss and every gradient leaf against plain attention
    (TOL_PARITY_F32), then one build_train_step step with B1 launched
    twice per layer (forward and remat) and B2, B3 once."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import build_train_step, create_train_state

    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                           attn_impl="flash", remat="dots")
    L = cfg.n_layers
    state = create_train_state(init_params(cfg, seed=2, device=dev),
                               device=dev)
    toks = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, cfg.max_seq_len + 1)).astype(np.int64)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    lf, gf = _grads(cfg, state.params, batch, "flash")
    lx, gx = _grads(cfg, state.params, batch, "xla")
    rel = _rel_l2(gf, gx)
    loss_rel = abs(lf - lx) / abs(lx)
    check(loss_rel <= TOL_PARITY_F32 and max(rel) <= TOL_PARITY_F32,
          f"tiny (head dim {cfg.head_dim}): flash and plain attention "
          f"disagree: loss rel {loss_rel}, grad rel L2 max {max(rel)}")
    kernels = (attention.flash_fwd_cuda, attention.flash_bwd_dkv_cuda,
               attention.flash_bwd_dq_cuda)
    for fn in kernels:
        fn.launches = 0
    step = build_train_step(lambda p, b: loss_fn(p, b, cfg), device=dev)
    state, m = step(state, batch)
    got, want = tuple(fn.launches for fn in kernels), (2 * L, L, L)
    check(np.isfinite(m["loss"].item()) and got == want,
          f"tiny flash step: loss {m['loss'].item()}, launches (B1, B2, "
          f"B3) {got} != {want}")
    log("train", f"LlamaConfig.tiny (head dim {cfg.head_dim}, padded to "
        f"128), f32, flash vs plain attention: loss rel {loss_rel:.2e}, "
        f"grad leaves' relative L2 max {max(rel):.3e} (tol "
        f"{TOL_PARITY_F32}); one step, loss {m['loss'].item():.4f}, "
        f"launches B1 {got[0]}, B2 {got[1]}, B3 {got[2]} (expected {want})")
    return {"head_dim": cfg.head_dim, "loss_rel": loss_rel,
            "grad_rel_l2_max": max(rel), "launches_b1_b3": list(got)}


def phase_train(dev, card):
    """Llama-3-8B widths at TRAIN_LAYERS layers through the port's
    build_train_step; see the module docstring."""
    from ray_tpu_torch.models.llama import (
        LlamaConfig, flops_per_token, init_params, loss_fn)
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import build_train_step, create_train_state

    f32_rel = phase_train_f32(dev)
    tiny = phase_train_tiny(dev)

    kernels = (attention.flash_fwd_cuda, attention.flash_bwd_dkv_cuda,
               attention.flash_bwd_dq_cuda)

    def reset():
        for fn in kernels:
            fn.launches = 0

    def counts():
        return tuple(fn.launches for fn in kernels)

    cfg = LlamaConfig.llama3_8b(
        n_layers=TRAIN_LAYERS, max_seq_len=TRAIN_SEQ, attn_impl="flash",
        remat="dots", param_dtype=torch.bfloat16)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = create_train_state(init_params(cfg, seed=0, device=dev),
                               device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in
                   torch.utils._pytree.tree_leaves(state.params))
    log("train", f"Llama-3-8B widths, {L} layers, {n_params / 1e9:.3f} B "
        f"params (bf16) built in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; {card}")
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size,
                           (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int64)
               for _ in range(TRAIN_STEPS + 2)]

    # Flash against plain attention: the initial params, the first batch.
    batch = {"tokens": torch.as_tensor(batches[0], device=dev)}
    rel, loss_rel = phase_train_parity(cfg, state.params, batch, card)

    # The main path: TRAIN_STEPS steps, counts from 0.
    step = build_train_step(lambda p, b: loss_fn(p, b, cfg), device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset()
    losses, norms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": batches[i]})
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        times.append(time.perf_counter() - t0)
    got = counts()
    want = (2 * L * TRAIN_STEPS, L * TRAIN_STEPS, L * TRAIN_STEPS)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(got == want, f"launches (B1, B2, B3) {got} != {want} for "
          f"{TRAIN_STEPS} steps of {L} layers under remat")
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = flops_per_token(cfg, TRAIN_SEQ) * tokens / step_s / PEAK_FLOPS[
        torch.bfloat16]
    log("train", "losses " + ", ".join(f"{x:.4f}" for x in losses)
        + "; grad norms " + ", ".join(f"{x:.3f}" for x in norms))
    log("train", f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens: step times " + ", ".join(f"{x:.3f}" for x in times)
        + f" s; median after the first {step_s:.4f} s = "
        f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% "
        f"(flops_per_token over 989 TFLOP/s); peak memory "
        f"{peak / 2**30:.2f} GiB; launches B1 {got[0]}, B2 {got[1]}, B3 "
        f"{got[2]} (expected {want}); {card}")

    # One step with grad_accum=2: two micro-batches of TRAIN_BATCH / 2.
    step2 = build_train_step(lambda p, b: loss_fn(p, b, cfg), grad_accum=2,
                             device=dev)
    reset()
    state, m = step2(state, {"tokens": batches[TRAIN_STEPS]})
    got2, want2 = counts(), (2 * L * 2, L * 2, L * 2)
    loss2, norm2 = m["loss"].item(), m["grad_norm"].item()
    check(np.isfinite(loss2) and np.isfinite(norm2),
          f"grad_accum=2: non-finite loss {loss2} or grad norm {norm2}")
    check(got2 == want2, f"grad_accum=2 launches {got2} != {want2}")
    log("train", f"grad_accum=2 step {m['step']}: loss {loss2:.4f}, grad "
        f"norm {norm2:.3f}, launches B1 {got2[0]}, B2 {got2[1]}, B3 "
        f"{got2[2]} (expected {want2})")
    launches = tuple(a + b for a, b in zip(got, got2))

    # Device time of one profiled step by kernel group.
    def one_step():
        _, m = step(state, {"tokens": batches[TRAIN_STEPS + 1]})
        m["loss"].item()

    prof = profile_window("train", one_step, card)
    del state
    return {"launches": launches, "step_s": step_s,
            "tokens_per_s": tokens / step_s, "mfu": mfu,
            "peak_gib": peak / 2**30, "losses": losses,
            "grad_rel_l2_max": max(rel), "loss_rel": loss_rel,
            "f32_grad_rel_l2_max": f32_rel, "tiny_flash": tiny,
            "profiled": prof}


# The ring collectives C1-C4 against their plain versions: ring sizes,
# types, ops, and per-rank blocks (rows x 128 elements, or a ragged shape
# whose per-rank and per-slab element counts are not multiples of 128, so
# every padding path runs). n = 4 and 8 reuse comm slots (hop t >= 2); n = 2
# never does. Every case must be bitwise: the kernels run the plain
# versions' hop schedule and round each combine once, as torch does.
RING_NS = (2, 4, 8)
# C3 is also held at the kernels' largest ring (ring.cu's MAX_RANKS).
RING_MAX_N = 16
RING_SHAPES = ((8, 128), (1000, 125), (65536, 128))
RING_OPS = ("sum", "max")
# The block types C1-C4 take; int32 blocks span the whole int32 range, so
# sums wrap around 2**32 as torch's do.
RING_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)
# The ZeRO phase: ranks, steps per route, chunks under overlap, and the
# f32 checks' config (the train phase's narrow one) and steps.
ZERO_N, ZERO_STEPS, ZERO_CHUNKS = 4, 3, 4
ZERO_F32_STEPS = 3
# Peak memory (GiB) two routes read on an NVIDIA H100 80GB HBM3 at 700 W
# while C2 still ran its hops through two chunks of comm slots a rank,
# which the group keeps for its life (ZeRO monolithic), and the int8
# overlap hop was tensor ops around C5's standalone form (its gathers and
# sum as whole tensors). Earlier runs' readings: logged in the text beside
# this run's peaks, never put in the kernels line.
PEAK_GIB_BEFORE = {"monolithic": 54.13, "int8 overlap": 42.4}
# ZeRO against the one-device step in f32: the summed gradients differ only
# in summation order, and each param is held to TOL_ZERO_F32 after the
# steps. Except where a gradient element sums to almost nothing (below
# TOL_ZERO_F32_G but not 0 at some step, from cancelling terms): AdamW
# divides each element by its own magnitude plus eps (1e-8), so there f32
# rounding noise of about 1e-9 changes the update direction itself, and
# such a param is held to the most AdamW can move it apart, 2 lr per step.
# (The card read 1.3e-5 on one such lm_head element, whose first gradient
# was about 4e-9.)
TOL_ZERO_F32 = 1e-5
TOL_ZERO_F32_G = 1e-7
TOL_ZERO_F32_NZ = 2 * 1e-4 * ZERO_F32_STEPS
# Overlap against monolithic in bf16, after ZERO_STEPS AdamW steps from the
# same params: the chunked rings sum each gradient element in another order
# (each hop rounds to bf16), which moves AdamW's normalised update by a
# few parts in 2**8 and flips the bf16 rounding of some params by one ulp.
# Gate: the relative L2 distance of the two runs' params, measured against
# the distance they moved from the initial params, at most 0.2; the first
# step's loss equal (same params, same batch).
TOL_ZERO_OVERLAP = 0.2


def _ring_input(n, shape, dtype, gen, dev):
    """Rank-major random data; int32 spans the whole int32 range."""
    if dtype == torch.int32:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,) + shape,
                             generator=gen, device=dev, dtype=dtype)
    return torch.randn((n,) + shape, generator=gen, device=dev, dtype=dtype)


def _allgather_cases(gen, dev):
    """C3 against its plain version, bit for bit, on [n, rows, 128]
    shards of every type: at RING_MAX_N ranks (small blocks), and at
    every RING_NS size into a caller's ``out`` and with each shard a view
    of its own place in ``out`` (rank r's shard at out[r, r * rows]), as
    an allgather in place. Returns the number of cases."""
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import ring as R

    checked = 0
    for n in RING_NS + (RING_MAX_N,):
        group = RingGroup(n, dev)
        shapes = RING_SHAPES[:2] if n == RING_MAX_N else RING_SHAPES
        for dtype in RING_DTYPES:
            for shape in shapes:
                x = _ring_input(n, shape, dtype, gen, dev)
                xb = x.reshape(n, -1)
                rows = -(-xb.shape[1] // 128)
                xb = torch.nn.functional.pad(
                    xb, (0, rows * 128 - xb.shape[1])).view(n, rows, 128)
                want = R.ring_allgather_plain(xb)
                cases = [("C3", R.ring_allgather_cuda(xb, group=group))]
                if n != RING_MAX_N:
                    out = torch.full_like(want, 7)
                    got = R.ring_allgather_cuda(xb, group=group, out=out)
                    cases.append(("C3 into out", got))
                    out = torch.zeros_like(want)
                    o4 = out.view(n, n, rows, 128)
                    for r in range(n):
                        o4[r, r] = xb[r]
                    inplace = out.as_strided(
                        (n, rows, 128), ((n + 1) * rows * 128, 128, 1))
                    got = R.ring_allgather_cuda(inplace, group=group,
                                                out=out)
                    cases.append(("C3 in place", got))
                for name, got in cases:
                    check(got.shape == want.shape and torch.equal(got, want),
                          f"{name} n={n} {dtype} {shape}: differs from its "
                          f"plain version")
                    checked += 1
        group.check()
        del group
    return checked


# C4 at the kernels' largest ring, every op: sixteen loads a vector, and
# the min and prod instantiations that RING_OPS leaves out. prod takes
# factors near 1 (int32: -3 .. 3), so products of 16 stay finite.
RING_ALL_OPS = ("sum", "max", "min", "prod")


def _allreduce_cases(gen, dev):
    """C4 against its plain version, bit for bit, at RING_MAX_N ranks, every
    type and op of RING_DTYPES and RING_ALL_OPS, per-rank blocks
    RING_SHAPES[:2]. Returns the number of cases."""
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import ring as R

    n, checked = RING_MAX_N, 0
    group = RingGroup(n, dev)
    for dtype in RING_DTYPES:
        for shape in RING_SHAPES[:2]:
            for op in RING_ALL_OPS:
                if op != "prod":
                    x = _ring_input(n, shape, dtype, gen, dev)
                elif dtype == torch.int32:
                    x = torch.randint(-3, 4, (n,) + shape, generator=gen,
                                      device=dev, dtype=dtype)
                else:
                    x = (1 + 0.1 * torch.randn((n,) + shape, generator=gen,
                                               device=dev)).to(dtype)
                want = R.ring_allreduce(x, op, impl="plain")
                got = R.ring_allreduce(x, op, impl="cuda", group=group)
                check(got.shape == want.shape and torch.equal(got, want),
                      f"C4 allreduce n={n} {dtype} {shape} op={op}: differs "
                      f"from its plain version")
                checked += 1
    group.check()
    return checked


def ring_bound(in_bytes, out_bytes):
    """(bound_ms, "bytes"): each input read once, each output written
    once, at the card's memory rate; a ring does no arithmetic to speak
    of (one combine per element and hop)."""
    return (in_bytes + out_bytes) / PEAK_BYTES * 1e3, "bytes"


def _ring_cases(x, group, op, shards=None, hop=None):
    """Yield (name, kernel result, plain result) for every ring kernel:
    C4 and C2 on the rank-major x [n, L] (L divisible by n), C3 on
    ``shards`` and C1 on ``hop`` (both x unless given), and the split-phase
    forms (one C1 launch per hop) against the monolithic kernels. Each
    plain result is computed first and each pair dropped after use, to
    keep the ZeRO size within the card's memory."""
    from ray_tpu_torch.util.collective import ring as R

    shards = x if shards is None else shards
    hop = x if hop is None else hop
    cuda = dict(impl="cuda", group=group)
    want = R.ring_allreduce(x, op, impl="plain")
    yield "C4 allreduce", R.ring_allreduce(x, op, **cuda), want
    want = None
    want = R.ring_reduce_scatter(x, op, impl="plain")
    rs = R.ring_reduce_scatter(x, op, **cuda)
    yield "C2 reduce_scatter", rs, want
    want = None
    yield "C1 split reduce_scatter vs C2", R.wait_ring_reduce_scatter(
        R.start_ring_reduce_scatter(x, op, **cuda)), rs
    rs = None
    want = R.ring_allgather(shards, impl="plain")
    ag = R.ring_allgather(shards, **cuda)
    yield "C3 allgather", ag, want
    want = None
    yield "C1 split allgather vs C3", R.wait_ring_allgather(
        R.start_ring_allgather(shards, **cuda)), ag
    ag = None
    want = R.wait_ring_permute(R.start_ring_permute(hop, impl="plain"))
    yield "C1 permute", R.wait_ring_permute(
        R.start_ring_permute(hop, **cuda)), want


def _ring_times(group, n, rows, gen, dev):
    """Kernel, plain, bound and library times of C1-C4 in bf16, sum, at
    per-rank blocks of ``rows`` x 128 (C4, C2: the rank's whole block;
    C3: its shard of rows / n; C1: one hop of the overlap path, rows /
    (n * ZERO_CHUNKS))."""
    from ray_tpu_torch.util.collective import ring as R

    dtype = torch.bfloat16
    e = torch.finfo(dtype).bits // 8
    c, h = rows // n, rows // (n * ZERO_CHUNKS)
    x = torch.randn((n, rows, 128), generator=gen, device=dev, dtype=dtype)
    full, part, one = n * rows * 128 * e, n * c * 128 * e, n * h * 128 * e
    iters = 5 if full > 2**30 else 20
    out = {}
    out["C4"] = dict(
        ms=time_ms(lambda: R.ring_allreduce_cuda(x, group=group), iters),
        plain_ms=time_ms(lambda: R.ring_allreduce_plain(x), iters),
        library_ms=time_ms(lambda: x.sum(0), iters),
        library_computes="x.sum(0)", bound=ring_bound(full, full))
    # C2 with donate=True, as the ZeRO path calls it: the kernel reads x
    # and writes only its result, so x must come out as it went in. Then x
    # is scratch: the plain version accumulates in it.
    before = x.clone()
    c2_ms = time_ms(lambda: R.ring_reduce_scatter_cuda(
        x, group=group, donate=True), iters)
    check(torch.equal(x, before), "C2 changed its input")
    del before
    out["C2"] = dict(
        ms=c2_ms, input_unchanged=True,
        plain_ms=time_ms(lambda: R.ring_reduce_scatter_plain(
            x, donate=True), iters),
        library_ms=time_ms(lambda: x.view(n, n, c, 128).sum(0), iters),
        library_computes="x.view(n, n, c, 128).sum(0)",
        bound=ring_bound(full, part))
    shard = torch.randn((n, c, 128), generator=gen, device=dev, dtype=dtype)
    del x
    out["C3"] = dict(
        ms=time_ms(lambda: R.ring_allgather_cuda(shard, group=group), iters),
        plain_ms=time_ms(lambda: R.ring_allgather_plain(shard), iters),
        library_ms=time_ms(lambda: shard.reshape(1, -1, 128).expand(
            n, -1, -1).contiguous(), iters),
        library_computes="x.reshape(1, -1, 128).expand(n, -1, -1)"
                         ".contiguous()",
        bound=ring_bound(part, full))
    block = shard[:, :h].contiguous()
    del shard
    out["C1"] = dict(
        ms=time_ms(lambda: R.ring_permute_cuda(block, group=group), 20),
        plain_ms=time_ms(lambda: R.ring_permute_plain(block), 20),
        library_ms=time_ms(lambda: torch.roll(block, 1, 0), 20),
        library_computes="torch.roll(x, 1, 0)",
        bound=ring_bound(one, one))
    del block
    gc.collect()
    torch.cuda.empty_cache()
    shapes = {"C4": rows, "C2": rows, "C3": c, "C1": h}
    for k, row in out.items():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        row.update({"n": n, "rows": shapes[k], "dtype": "bf16"})
    return out


def phase_ring_kernels(dev, card, zero_rows=None):
    """C1-C4 against their plain versions on the card, bit for bit, at
    every ring size, type, op and block of RING_*; then, at ``zero_rows``
    (the ZeRO path's flat parameter vector, in 128-lane rows, n = 4, bf16,
    sum), the same checks and the four kernels' times beside their plain
    versions', their bounds and one library call's; and the times at
    65536 rows per rank."""
    from ray_tpu_torch.util.collective import RingGroup

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    checked = 0
    for n in RING_NS:
        group = RingGroup(n, dev)
        for dtype in RING_DTYPES:
            for shape in RING_SHAPES:
                x = _ring_input(n, shape, dtype, gen, dev)
                for op in RING_OPS:
                    for name, got, want in _ring_cases(x, group, op):
                        check(got.shape == want.shape
                              and torch.equal(got, want),
                              f"{name} n={n} {dtype} {shape} op={op}: "
                              f"differs from its plain version (max abs "
                              f"{(got.float() - want.float()).abs().max()})")
                        checked += 1
        group.check()
        del group
    log("ring", f"C1-C4 bitwise equal to their plain versions in {checked} "
        f"cases: n {RING_NS}, {[str(d)[6:] for d in RING_DTYPES]}, ops "
        f"{RING_OPS}, per-rank blocks {RING_SHAPES}; split-phase "
        f"reduce-scatter and allgather (C1 per hop) bitwise equal to C2 "
        f"and C3")
    checked = _allgather_cases(gen, dev)
    log("ring", f"C3 bitwise equal to its plain version in {checked} more "
        f"cases: n {RING_NS + (RING_MAX_N,)} (n {RING_MAX_N} at per-rank "
        f"blocks {RING_SHAPES[:2]}), every type; into a caller's out and "
        f"with each shard already in its place of out")
    checked = _allreduce_cases(gen, dev)
    log("ring", f"C4 bitwise equal to its plain version in {checked} more "
        f"cases: n {RING_MAX_N}, every type, ops {RING_ALL_OPS}, per-rank "
        f"blocks {RING_SHAPES[:2]}")
    timings = []
    group = RingGroup(ZERO_N, dev)
    if zero_rows:
        x = torch.randn((ZERO_N, zero_rows * 128), generator=gen,
                        device=dev, dtype=torch.bfloat16)
        c = zero_rows // ZERO_N
        shards = x[:, :c * 128].contiguous()
        hop = x[:, :c * 128 // ZERO_CHUNKS].contiguous()
        for name, got, want in _ring_cases(x, group, "sum", shards, hop):
            check(torch.equal(got, want), f"{name} at the ZeRO size differs "
                  f"from its plain version")
            del got, want
        del x, shards, hop
        gc.collect()
        torch.cuda.empty_cache()
        log("ring", f"ZeRO size ({ZERO_N} ranks x {zero_rows} x 128 bf16, "
            f"sum; C3 on its {c}-row shards, C1 on one overlap hop of "
            f"{c // ZERO_CHUNKS} rows): C1-C4 and the split-phase forms "
            f"bitwise equal to their plain versions")
        timings.append(_ring_times(group, ZERO_N, zero_rows, gen, dev))
    timings.append(_ring_times(group, ZERO_N, 65536, gen, dev))
    group.check()
    del group
    gc.collect()
    torch.cuda.empty_cache()
    for t in timings:
        for k, row in t.items():
            log("ring", f"{k} n={row['n']} {row['rows']} rows bf16: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['library_computes']} {row['library_ms']:.4f} ms; "
                f"{card}")
    return timings


def _zero_f32_cfg():
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=1000, dim=256, n_layers=2, n_heads=2,
                       n_kv_heads=1, hidden_dim=512, max_seq_len=512,
                       dtype=torch.float32, param_dtype=torch.float32,
                       attn_impl="flash", remat="dots")


def phase_zero_f32(dev):
    """The ZeRO step in f32 at dim 256 (the train phase's f32 config):
    (1) at n = 2, bitwise equal to plain data parallelism whose summed
    gradient goes through C4 (``build_replicated_train_step``); the
    embedding's backward sums with ``index_add_``, whose CUDA atomics add
    in a varying order, so both steps run under
    ``torch.use_deterministic_algorithms`` (index_add_ then sums in a fixed
    order); (2) monolithic at n = 4 against the one-device
    ``build_train_step`` on the same global batch, its loss scaled by n to
    match ZeRO's summed gradients (only summation order differs), to
    TOL_ZERO_F32 (see there). Returns C4's launches in (1) and the largest
    param difference of (2) outside the near-zero gradients."""
    import functools
    import warnings

    from ray_tpu_torch.models.llama import init_params, loss_fn
    from ray_tpu_torch.parallel import (
        build_replicated_train_step, build_train_step,
        build_zero_train_step, create_train_state, create_zero_state)
    from ray_tpu_torch.parallel.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import ring as R

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the f32 check needs full f32")
    cfg = _zero_f32_cfg()
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    rng = np.random.RandomState(3)
    toks = [rng.randint(0, cfg.vocab_size, (ZERO_N, 301))
            for _ in range(ZERO_F32_STEPS)]

    def run(make_step, n, **kw):
        group = RingGroup(n, dev)
        state = create_zero_state(init_params(cfg, seed=1, device=dev), opt,
                                  group)
        step = make_step(lambda p, b: loss_fn(p, b, cfg), opt, group, **kw)
        for t in toks:
            state, m = step(state, {"tokens": t[:n]})
        group.check()
        return state, m["loss"].item()

    prev = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            zero, zl = run(build_zero_train_step, 2)
            for k in R.KERNELS:
                k.launches = 0
            rep, rl = run(build_replicated_train_step, 2)
            c4 = R.ring_allreduce_cuda.launches
        finally:
            torch.use_deterministic_algorithms(prev)
    check(c4 == ZERO_F32_STEPS, f"replicated step: C4 launches {c4} != "
          f"{ZERO_F32_STEPS}")
    check(torch.equal(zero.flat, rep.flat) and zl == rl,
          "ZeRO (n = 2) and the replicated C4 step differ")
    log("zero", f"f32 dim 256, n=2, {ZERO_F32_STEPS} AdamW steps: ZeRO "
        f"(C2 + C3) bitwise equal to the replicated step through C4 "
        f"({c4} launches); every rank's copy equal")
    del zero, rep

    zero, zl = run(build_zero_train_step, ZERO_N)
    one = create_train_state(init_params(cfg, seed=1, device=dev),
                             device=dev)
    init = _flat_of(one.params)
    step = build_train_step(lambda p, b: ZERO_N * loss_fn(p, b, cfg),
                            device=dev)
    near_zero = torch.zeros_like(init, dtype=torch.bool)
    for t in toks:
        one, m = step(one, {"tokens": t})
        g = _flat_of(one.params, grad=True).abs()
        near_zero |= (g > 0) & (g < TOL_ZERO_F32_G)
    want = _flat_of(one.params)
    diff = (_flat_of(zero.params) - want).abs()
    err = diff[~near_zero].max().item()
    err_nz = diff[near_zero].max().item() if near_zero.any() else 0.0
    moved = (want - init).norm().item()
    rel = diff.norm().item() / moved
    loss_err = abs(ZERO_N * zl - m["loss"].item())
    log("zero", f"f32 dim 256, n={ZERO_N}, {ZERO_F32_STEPS} AdamW steps: "
        f"ZeRO vs the one-device build_train_step (loss x {ZERO_N}): max abs "
        f"param difference {err:.3g} (tol {TOL_ZERO_F32}) over "
        f"{int((~near_zero).sum())} params; the {int(near_zero.sum())} "
        f"whose gradient fell below {TOL_ZERO_F32_G} (not 0) at some step "
        f"{err_nz:.3g} (tol {TOL_ZERO_F32_NZ:.3g}); L2 distance "
        f"{rel:.3g} of the distance moved; loss {loss_err:.3g}")
    check(err <= TOL_ZERO_F32 and err_nz <= TOL_ZERO_F32_NZ,
          f"ZeRO n={ZERO_N} vs one-device step: params differ by {err} "
          f"(near-zero gradients: {err_nz})")
    return c4, err


def _flat_of(tree, grad=False):
    """A param tree (or its gradients) as one f32 vector, leaves in name
    order."""
    return torch.cat([(t.grad if grad else t).detach().float().reshape(-1)
                      for _, t in sorted(_flat_leaves(tree))])


def _flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _sq_dist(a, b, chunk=1 << 27):
    """sum((a - b)^2) in f32 over two equal flat tensors, in chunks."""
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    for i in range(0, a.numel(), chunk):
        d = a[i:i + chunk].float() - b[i:i + chunk].float()
        total += d.square().sum()
    return total.item()


def _profile_step(phase, step, state, batch, card):
    """profile_window over one step on ``batch``."""
    def one_step():
        _, m = step(state, {"tokens": batch})
        m["loss"].item()

    return profile_window(phase, one_step, card)


def phase_zero_train(dev, card):
    """Llama-3-8B widths at TRAIN_LAYERS layers through
    ``build_zero_train_step`` over ZERO_N virtual ranks: ZERO_STEPS
    monolithic steps (C2 + C3) and one profiled step, then the same with
    ``overlap=True`` (C1 per hop) from the same initial params. See the
    module docstring for the gates."""
    import functools

    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import build_zero_train_step, create_zero_state
    from ray_tpu_torch.parallel.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import ring as R

    cfg = LlamaConfig.llama3_8b(
        n_layers=TRAIN_LAYERS, max_seq_len=TRAIN_SEQ, attn_impl="flash",
        remat="dots", param_dtype=torch.bfloat16)
    L = cfg.n_layers
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size,
                           (ZERO_N, TRAIN_SEQ + 1)).astype(np.int64)
               for _ in range(ZERO_STEPS + 1)]
    tokens = ZERO_N * TRAIN_SEQ
    kernels = R.KERNELS + (attention.flash_fwd_cuda,
                           attention.flash_bwd_dkv_cuda,
                           attention.flash_bwd_dq_cuda)

    def run(overlap):
        name = "overlap" if overlap else "monolithic"
        group = RingGroup(ZERO_N, dev)
        torch.cuda.reset_peak_memory_stats()
        state = create_zero_state(init_params(cfg, seed=0, device=dev), opt,
                                  group)
        step = build_zero_train_step(
            lambda p, b: loss_fn(p, b, cfg), opt, group, overlap=overlap,
            n_chunks=ZERO_CHUNKS)
        for k in kernels:
            k.launches = 0
        losses, norms, times = [], [], []
        for i in range(ZERO_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": batches[i]})
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            times.append(time.perf_counter() - t0)
        group.check()
        ring = [k.launches for k in kernels[:4]]
        b = [k.launches for k in kernels[4:]]
        n_c = len(state.layout) - 1
        want = ([2 * (ZERO_N - 1) * n_c * ZERO_STEPS, 0, 0, 0] if overlap
                else [0, ZERO_STEPS, ZERO_STEPS, 0])
        want_b = [2 * L * ZERO_N * ZERO_STEPS, L * ZERO_N * ZERO_STEPS,
                  L * ZERO_N * ZERO_STEPS]
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"{name}: non-finite loss or grad norm {losses} {norms}")
        check(ring == want, f"{name}: launches (C1, C2, C3, C4) {ring} != "
              f"{want}")
        check(b == want_b, f"{name}: launches (B1, B2, B3) {b} != {want_b}")
        check(all(torch.equal(state.flat[r], state.flat[0])
                  for r in range(ZERO_N)),
              f"{name}: a rank's parameter copy differs from rank 0's")
        peak = torch.cuda.max_memory_allocated()
        before = PEAK_GIB_BEFORE.get(name)
        step_s = float(np.median(times[1:]))
        log("zero", f"{name}: losses " + ", ".join(f"{x:.4f}" for x in losses)
            + "; grad norms " + ", ".join(f"{x:.3f}" for x in norms))
        log("zero", f"{name}: {ZERO_STEPS} steps of {ZERO_N} ranks x "
            f"{TRAIN_SEQ} tokens: step times "
            + ", ".join(f"{x:.3f}" for x in times) + f" s; median after the "
            f"first {step_s:.4f} s = {tokens / step_s:.0f} tokens/s; peak "
            f"memory {peak / 2**30:.2f} GiB"
            + (f" (before C2 dropped its slots: {before} GiB)" if before
               else "") + f"; launches C1-C4 {ring} (expected "
            f"{want}), B1-B3 {b}; every rank's copy equal to rank 0's; {card}")
        rec = {"losses": losses, "grad_norms": norms, "step_times_s": times,
               "step_s": step_s, "tokens_per_s": tokens / step_s,
               "peak_gib": peak / 2**30, "launches_c1_c4": ring,
               "launches_b1_b3": b, "chunks": n_c}
        return group, state, step, rec

    def profiled(name, step, state, rec):
        log("zero", f"{name}: one profiled step")
        prof = _profile_step("zero", step, state, batches[ZERO_STEPS], card)
        busy = prof["busy_ms"]
        ring_ms = prof["groups"].get("ring C1-C4", 0.0)
        rec.update({"profiled_wall_ms": prof["wall_ms"],
                    "profiled_busy_ms": busy, "ring_ms": ring_ms,
                    "ring_share": ring_ms / busy,
                    "profiled_groups": prof["groups"]})

    n_params = cfg.num_params()
    log("zero", f"Llama-3-8B widths, {L} layers, {n_params / 1e9:.3f} B "
        f"params (bf16), {ZERO_N} virtual ranks, AdamW (optax.adamw(1e-4)'s "
        f"settings), batch {ZERO_N} x {TRAIN_SEQ}; {card}")
    group, state, step, mono = run(False)
    mono_final = state.flat[0].clone()
    spec = state.spec
    profiled("monolithic", step, state, mono)
    del group, state, step
    gc.collect()
    torch.cuda.empty_cache()
    # The initial params as one flat vector, in the state's layout.
    init = torch.zeros_like(mono_final)
    p0 = init_params(cfg, seed=0, device=dev)
    for path, shape, off in spec:
        leaf = p0
        for key in path:
            leaf = leaf[key]
        init[off:off + shape.numel()] = leaf.reshape(-1)
    del p0

    group, state, step, over = run(True)
    moved = _sq_dist(mono_final, init) ** 0.5
    rel = _sq_dist(state.flat[0], mono_final) ** 0.5 / moved
    loss0 = abs(over["losses"][0] - mono["losses"][0]) / abs(mono["losses"][0])
    log("zero", f"overlap vs monolithic after {ZERO_STEPS} steps: params' "
        f"L2 distance {rel:.3e} of the distance moved from the initial "
        f"params (tol {TOL_ZERO_OVERLAP}); first-step loss rel diff "
        f"{loss0:.2e}")
    check(loss0 <= 1e-6, "overlap and monolithic disagree on the first "
          "step's loss (same params, same batch)")
    check(rel <= TOL_ZERO_OVERLAP, "overlap and monolithic params differ "
          "beyond bf16 re-association")
    profiled("overlap", step, state, over)
    del group, state, step, mono_final, init
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": L, "params": n_params, "monolithic": mono,
            "overlap": over, "overlap_vs_mono_rel_l2": rel}


# The int8 ring C5, C6 against their plain versions: ring sizes, per-rank
# shapes (a ragged one, exactly _MIN_QUANT_ELEMS elements, a large block)
# and three data variants: randn; one chunk all zero (every hop of it
# takes the 1e-30 scale floor); one element 1e3 (a chunk's max sits in
# one block, so the per-rank barrier decides every scale of that chunk).
# Every case bitwise: the kernels and the plain versions take the same
# scales, codes and roundings.
QRING_SHAPES = ((1000, 125), (1024,), (65536, 128))
QRING_VARIANTS = ("randn", "zero_chunk", "one_block_max")
# C5's in-place form hop by hop: ring sizes (3 and 16 beside RING_NS: an
# odd ring and the kernels' largest), on the same shapes and variants;
# and QRS_INTERLEAVED reduce-scatters of ZERO_N ranks in flight together.
QRS_NS = (2, 3, 4, 8, 16)
QRS_INTERLEAVED = 3
# The quantized ZeRO phase: Llama-3-8B widths at QZERO_LAYERS layers (the
# f32 carry and the error-feedback buffer are 4 bytes per param per rank
# each: 66 GiB before activations at 1 layer, 100 GiB at 4), ZERO_N ranks,
# ZERO_STEPS steps per route, ZERO_CHUNKS chunks under overlap.
QZERO_LAYERS = 1


def _qring_input(n, shape, variant, gen, dev):
    x = torch.randn((n,) + shape, generator=gen, device=dev)
    flat = x.view(n, -1)
    size = flat.shape[1]
    chunk = -(-size // (n * 128)) * 128
    if variant == "zero_chunk":
        flat[:, :min(chunk, size)] = 0.0
    elif variant == "one_block_max":
        flat[n - 1, min(size - 1, chunk + chunk // 2 + 3)] = 1e3
    return x


def _qring_cases(x, group):
    """(name, kernel result, plain result) for C6 through
    quantized_ring_allreduce, C5 alone on the padded block, and the
    split-phase int8 reduce-scatter (C5 per hop)."""
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    cuda = dict(impl="cuda", group=group)
    n = x.shape[0]
    yield ("C6 quantized_ring_allreduce",
           Q.quantized_ring_allreduce(x, **cuda),
           Q.quantized_ring_allreduce(x, impl="plain"))
    block = R._to_block(x, n)[0]
    yield ("C5 qhop", Q.ring_qhop_cuda(block, group=group),
           Q.ring_qhop_plain(block))
    yield ("C5 split-phase int8 reduce_scatter",
           Q.wait_quantized_ring_reduce_scatter(
               Q.start_quantized_ring_reduce_scatter(block, **cuda)),
           Q.wait_quantized_ring_reduce_scatter(
               Q.start_quantized_ring_reduce_scatter(block, impl="plain")))


def _qrs_hops(got, want, group):
    """C5's in-place form against its plain version over a whole int8
    reduce-scatter, hop by hop: got and want [n, n * c, 128] f32 hold the
    same values (got may be a view with a wider rank stride, as the ZeRO
    path's chunk of its gradient buffer); after each hop t the two buffers
    and the two carry tables must be equal bit for bit. The kernel's table
    starts as one an earlier reduce-scatter left, every word tagged with
    its row's hop and holding the largest finite max: hop 0 must clear it,
    or atomicMax keeps those maxes. Returns the hops checked."""
    from ray_tpu_torch.util.collective import quantized as Q

    n = got.shape[0]
    carry_want = torch.zeros((n - 1, n), dtype=torch.int64, device=got.device)
    carry_got = (torch.arange(n - 1, device=got.device) << 32).view(-1, 1) \
        + torch.full_like(carry_want, 0x7f7fffff)
    for t in range(n - 1):
        Q.ring_qrs_hop_cuda(got, t, carry_got, group=group)
        Q.ring_qrs_hop_plain(want, t, carry_want)
        check(torch.equal(got, want) and torch.equal(carry_got, carry_want),
              f"C5 in place n={n} rows={got.shape[1]} hop {t}: the buffer "
              f"or the carried max differs from the plain version's")
    return n - 1


def _qrs_interleaved(xs, **kw):
    """Int8 reduce-scatters of xs, issued as the overlap path issues them
    (``parallel/zero.py``): chunk c + 1's first hop before chunk c's wait.
    Returns the results in order."""
    from ray_tpu_torch.util.collective import quantized as Q

    hs = [Q.start_quantized_ring_reduce_scatter(xs[0], **kw)]
    out = []
    for c in range(len(xs)):
        if c + 1 < len(xs):
            hs.append(Q.start_quantized_ring_reduce_scatter(xs[c + 1], **kw))
        out.append(Q.wait_quantized_ring_reduce_scatter(hs[c]))
    return out


def _qrs_cases(gen, dev):
    """C5's in-place form bit for bit against its plain version: hop by
    hop (_qrs_hops) at every ring size of QRS_NS, shape of QRING_SHAPES and
    variant of QRING_VARIANTS; QRS_INTERLEAVED reduce-scatters interleaved
    against the same through the plain version and through the kernel one
    after another; and a hop whose carry no hop before filled stops the
    kernel and the group raises. Returns (hops checked, interleaved
    reduce-scatters checked)."""
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    hops = 0
    for n in QRS_NS:
        group = RingGroup(n, dev)
        for shape in QRING_SHAPES:
            for variant in QRING_VARIANTS:
                block = R._to_block(_qring_input(n, shape, variant, gen, dev),
                                    n)[0]
                hops += _qrs_hops(block.clone(), block, group)
        group.check()
        del group
    group = RingGroup(ZERO_N, dev)
    xs = [torch.randn((ZERO_N, ZERO_N * rows, 128), generator=gen, device=dev)
          for rows in (4096, 2048, 1000)]
    got = _qrs_interleaved(xs, impl="cuda", group=group)
    want = _qrs_interleaved(xs, impl="plain")
    alone = [Q.wait_quantized_ring_reduce_scatter(
        Q.start_quantized_ring_reduce_scatter(x, impl="cuda", group=group))
        for x in xs]
    group.check()
    for c, (g, w, a) in enumerate(zip(got, want, alone)):
        check(torch.equal(g, w) and torch.equal(g, a),
              f"C5 in place, interleaved reduce-scatter {c}: differs from "
              f"the plain version's or from the same alone")
    del group
    # A carry that no hop before filled: the kernel stops, the group
    # raises, and no max pass stands in.
    group = RingGroup(ZERO_N, dev)
    x = torch.randn((ZERO_N, ZERO_N * 8, 128), generator=gen, device=dev)
    Q.ring_qrs_hop_cuda(x, 1, torch.zeros((ZERO_N - 1, ZERO_N),
                                          dtype=torch.int64, device=dev),
                        group=group)
    try:
        group.check()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    check("carried" in raised, f"C5 in place with an empty carry did not "
          f"raise ({raised!r})")
    del group
    return hops, len(xs)


def _qring_times(group, n, elems, gen, dev, x=None):
    """Kernel, plain, bound and yardstick times of C6 (in place on the
    rank-major f32 block of ``elems`` per rank) and C5 (one overlap
    chunk: elems / ZERO_CHUNKS per rank). No library call requantizes per
    hop, so each has a yardstick, not the same function: x.sum(0) for C6.
    C5's row is its in-place form, the one the overlap path launches: hop
    1 (``ms``, scale carried from hop 0) and hop 0 (``hop0_ms``, max pass
    and barrier), its plain version, its bound (read the send and the
    receiving chunk, write the latter) and, as the yardstick, the
    split-phase hop as tensor ops around the standalone form, the route
    it replaces. The standalone form (one hop of a ring chunk, n of which
    make the overlap chunk) sits under ``standalone``, with torch.roll as
    its yardstick."""
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    if x is None:
        x = torch.randn((n, elems), generator=gen, device=dev)
    xb = x.view(n, -1, 128)
    full = n * elems * 4
    iters = 3 if full > 2**30 else 20
    out = {"C6": dict(
        ms=time_ms(lambda: Q.ring_qallreduce_cuda(xb, group=group, out=xb),
                   iters),
        plain_ms=time_ms(lambda: Q.ring_qallreduce_plain(xb, out=xb),
                         1 if full > 2**30 else 5),
        yardstick_ms=time_ms(lambda: x.sum(0), iters),
        yardstick_computes="x.sum(0), the exact sum (yardstick)",
        bound=ring_bound(full, full), rows=elems // 128)}
    h = elems // (n * ZERO_CHUNKS * 128) * 128
    hop = torch.randn((n, h // 128, 128), generator=gen, device=dev)
    del x, xb
    standalone = dict(
        ms=time_ms(lambda: Q.ring_qhop_cuda(hop, group=group), 20),
        plain_ms=time_ms(lambda: Q.ring_qhop_plain(hop), 5),
        yardstick_ms=time_ms(lambda: torch.roll(hop, 1, 0), 20),
        yardstick_computes="torch.roll(x, 1, 0), the exact hop (yardstick)",
        rows=h // 128)
    standalone["bound_ms"], standalone["bound_by"] = ring_bound(
        n * h * 4, n * h * 4)
    del hop
    b = torch.randn((n, n * h // 128, 128), generator=gen, device=dev)
    carry = torch.zeros((n - 1, n), dtype=torch.int64, device=dev)
    b4 = b.view(n, n, -1, 128)
    # Each run of hop 0 clears the carry and fills row 1, which every run
    # of hop 1 reads.
    out["C5"] = dict(
        form="in place (qrs_hop): ms is hop 1, its scale carried from hop 0",
        hop0_ms=time_ms(lambda: Q.ring_qrs_hop_cuda(b, 0, carry, group=group),
                        20),
        ms=time_ms(lambda: Q.ring_qrs_hop_cuda(b, 1, carry, group=group), 20),
        plain_ms=time_ms(lambda: Q.ring_qrs_hop_plain(b, 1), 3),
        yardstick_ms=time_ms(lambda: R._rs_hop(
            b4, 1, "sum", lambda v: Q.ring_qhop_cuda(v, group=group)), 5),
        yardstick_computes="gather of the send chunks, C5 standalone, gather"
                           " of the receiving chunks, add, index-put: the "
                           "route the in-place form replaced (yardstick)",
        bound=ring_bound(2 * n * h * 4, n * h * 4), rows=n * h // 128,
        standalone=standalone)
    del b, b4, carry
    gc.collect()
    torch.cuda.empty_cache()
    for row in out.values():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        row.update({"n": n, "dtype": "f32", "library_ms": None})
    return out


def phase_qring_kernels(dev, card, zero_elems=None):
    """C5 and C6 against their plain versions on the card, bit for bit, at
    every ring size, shape and variant of QRING_*; the ladder (a bf16 call
    and a call below _MIN_QUANT_ELEMS take C4, not C6); then at
    ``zero_elems`` per rank (the quantized ZeRO path's flat vector, n = 4)
    the same checks in place, and the two kernels' times beside their
    plain versions', bounds and yardsticks; and the times at 65536 rows
    per rank."""
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    checked = 0
    for n in RING_NS:
        group = RingGroup(n, dev)
        for shape in QRING_SHAPES:
            for variant in QRING_VARIANTS:
                x = _qring_input(n, shape, variant, gen, dev)
                for name, got, want in _qring_cases(x, group):
                    check(got.shape == want.shape and torch.equal(got, want),
                          f"{name} n={n} {shape} {variant}: differs from "
                          f"its plain version (max abs "
                          f"{(got - want).abs().max()})")
                    checked += 1
        group.check()
        del group
    log("ring", f"C5, C6 bitwise equal to their plain versions in {checked} "
        f"cases: n {RING_NS}, f32, per-rank shapes {QRING_SHAPES}, "
        f"{QRING_VARIANTS}")
    hops, interleaved = _qrs_cases(gen, dev)
    log("ring", f"C5 in place bitwise equal to its plain version (buffer and "
        f"carried max) in {hops} hops: n {QRS_NS}, per-rank shapes "
        f"{QRING_SHAPES}, {QRING_VARIANTS}; {interleaved} reduce-scatters "
        f"interleaved as the overlap path issues them equal the plain "
        f"version's and the same alone; an empty carry stops the kernel "
        f"and the group raises")

    group = RingGroup(ZERO_N, dev)
    kernels = (R.KERNELS[3], Q.KERNELS[1])     # C4, C6
    for name, x, kw in (
            ("f64", torch.randn((ZERO_N, 4096), generator=gen, device=dev,
                                dtype=torch.float64), {}),
            ("small", torch.randn((ZERO_N, 100), generator=gen, device=dev),
             {}),
            ("precision=bf16", torch.randn((ZERO_N, 4096), generator=gen,
                                           device=dev),
             {"precision": "bf16"})):
        before = [k.launches for k in kernels]
        got = Q.quantized_ring_allreduce(x, group=group, **kw)
        want = R.ring_allreduce(x.to(torch.bfloat16), impl="plain").to(
            x.dtype)
        moved = [k.launches - b for k, b in zip(kernels, before)]
        check(moved == [1, 0] and torch.equal(got, want),
              f"ladder, {name}: launches (C4, C6) {moved} != [1, 0] or the "
              f"bf16 ring's result differs")
    log("ring", "ladder: f64 input, 100 elements per rank and "
        "precision='bf16' each took C4 once (C6 not at all) and equal the "
        "plain bf16 ring")

    timings = []
    if zero_elems:
        x = torch.randn((ZERO_N, zero_elems), generator=gen, device=dev)
        y = x.clone()
        Q.ring_qallreduce_cuda(x.view(ZERO_N, -1, 128), group=group,
                               out=x.view(ZERO_N, -1, 128))
        Q.ring_qallreduce_plain(y.view(ZERO_N, -1, 128),
                                out=y.view(ZERO_N, -1, 128))
        check(torch.equal(x, y), "C6 at the quantized ZeRO size differs from "
              "its plain version")
        del y
        h = zero_elems // (ZERO_N * ZERO_CHUNKS * 128) * 128
        hop = x[:, :h].reshape(ZERO_N, -1, 128)
        check(torch.equal(Q.ring_qhop_cuda(hop, group=group),
                          Q.ring_qhop_plain(hop)),
              "C5 at the quantized ZeRO hop differs from its plain version")
        del hop
        # C5 in place on one overlap chunk (n ring chunks of h a rank), in
        # x itself (a view with x's rank stride, as the ZeRO path's chunk
        # of its gradient buffer) against a contiguous copy.
        got = x[:, :ZERO_N * h].view(ZERO_N, -1, 128)
        _qrs_hops(got, got.clone(), group)
        del got
        log("ring", f"quantized ZeRO size ({ZERO_N} ranks x {zero_elems} f32,"
            f" C6 in place; C5 on one overlap hop of {h}; C5 in place on one "
            f"overlap chunk of {ZERO_N * h}, hop by hop): bitwise equal to "
            f"the plain versions")
        timings.append(_qring_times(group, ZERO_N, zero_elems, gen, dev, x))
        del x
    timings.append(_qring_times(group, ZERO_N, 65536 * 128, gen, dev))
    group.check()
    del group
    gc.collect()
    torch.cuda.empty_cache()
    for t in timings:
        for k, row in t.items():
            log("ring", f"{k} n={row['n']} {row['rows']} rows f32: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['yardstick_computes']} {row['yardstick_ms']:.4f} ms; "
                f"{card}")
        c5, sa = t["C5"], t["C5"]["standalone"]
        log("ring", f"C5 in place, hop 0 (max pass) {c5['hop0_ms']:.4f} ms; "
            f"C5 standalone n={c5['n']} {sa['rows']} rows f32: kernel "
            f"{sa['ms']:.4f} ms, plain {sa['plain_ms']:.4f} ms, bound "
            f"{sa['bound_ms']:.4f} ms ({sa['bound_by']}), "
            f"{sa['yardstick_computes']} {sa['yardstick_ms']:.4f} ms; {card}")
    return timings


def phase_zero_quant_f32(dev):
    """The int8 exchange in f32 at dim 256 (the train phase's f32 config),
    at n = 2 and ZERO_N, monolithic (C6), overlap (C5 per hop) and with
    error feedback: ZERO_F32_STEPS AdamW steps through the kernels equal
    the same steps through the plain versions bit for bit (params, ef and
    loss), with exact C5 / C6 launch counts. Under
    ``torch.use_deterministic_algorithms``, as phase_zero_f32 (index_add_).
    Returns the number of bitwise comparisons."""
    import functools
    import warnings

    from ray_tpu_torch.models.llama import init_params, loss_fn
    from ray_tpu_torch.parallel import build_zero_train_step, create_zero_state
    from ray_tpu_torch.parallel.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q

    cfg = _zero_f32_cfg()
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    rng = np.random.RandomState(4)
    toks = [rng.randint(0, cfg.vocab_size, (ZERO_N, 301))
            for _ in range(ZERO_F32_STEPS)]

    def run(n, collective, **kw):
        group = RingGroup(n, dev)
        ef = kw.get("error_feedback", False)
        state = create_zero_state(init_params(cfg, seed=1, device=dev), opt,
                                  group, error_feedback=ef)
        step = build_zero_train_step(lambda p, b: loss_fn(p, b, cfg), opt,
                                     group, collective=collective,
                                     quantized_grads=True, **kw)
        for t in toks:
            state, m = step(state, {"tokens": t[:n]})
        group.check()
        return state, m["loss"].item()

    routes = (("monolithic", {}),
              ("overlap", {"overlap": True, "n_chunks": ZERO_CHUNKS}),
              ("error feedback", {"error_feedback": True}))
    checked = 0
    prev = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for n in (2, ZERO_N):
                for name, kw in routes:
                    for k in Q.KERNELS:
                        k.launches = 0
                    got, gl = run(n, "cuda", **kw)
                    launches = [k.launches for k in Q.KERNELS]
                    want, wl = run(n, "plain", **kw)
                    n_c = len(got.layout) - 1
                    expect = ([(n - 1) * n_c * ZERO_F32_STEPS, 0]
                              if kw.get("overlap") else [0, ZERO_F32_STEPS])
                    check(launches == expect, f"int8 ZeRO f32 n={n} {name}: "
                          f"launches (C5, C6) {launches} != {expect}")
                    same = torch.equal(got.flat, want.flat) and gl == wl
                    if got.ef is not None:
                        same = same and torch.equal(got.ef, want.ef)
                    check(same, f"int8 ZeRO f32 n={n} {name}: the kernels' "
                          f"steps differ from the plain versions'")
                    checked += 1
                    del got, want
        finally:
            torch.use_deterministic_algorithms(prev)
    log("zero", f"int8 exchange, f32 dim 256, n = 2 and {ZERO_N}, "
        f"{ZERO_F32_STEPS} AdamW steps, monolithic (C6), overlap (C5 per "
        f"hop, {ZERO_CHUNKS} chunks) and error feedback: {checked} runs "
        f"bitwise equal to the plain versions (params, ef, loss), launches "
        f"exact")
    return checked


def _int8_first_grad(cfg, opt, batch, n, dev):
    """The first step's gradient of ``cfg`` over n ranks through the
    exact reduce-scatter (C2) and through the int8 ring (C6): (loss, the
    int8 shards' relative L2 distance from the exact ones, the share of
    shard elements sent as 0, the share sent as 0 where the exact sum is
    not 0). Everything it allocates is freed on return."""
    from ray_tpu_torch.models.llama import init_params, loss_fn
    from ray_tpu_torch.parallel import create_zero_state
    from ray_tpu_torch.parallel import zero as Z
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    group = RingGroup(n, dev)
    state = create_zero_state(init_params(cfg, seed=0, device=dev), opt,
                              group)
    loss, _ = Z._local_grads(state, lambda p, b: loss_fn(p, b, cfg), batch)
    s = state.flat.shape[1] // n
    with torch.no_grad():
        g = state.grads.clone()
        exact = R.ring_reduce_scatter(g.view(n, -1, 128), group=group,
                                      donate=True)
        del g
        full = Q.quantized_ring_allreduce(state.grads, group=group,
                                          donate=True)
        diff = ref = 0.0
        zeros = zeros_nz = 0
        step_e = 1 << 26
        for r in range(n):
            q, e = full[r, r * s:(r + 1) * s], exact[r].view(-1)
            for i in range(0, s, step_e):
                qi, ei = q[i:i + step_e], e[i:i + step_e].float()
                diff += (qi - ei).square().sum().item()
                ref += ei.square().sum().item()
                zeros += (qi == 0).sum().item()
                zeros_nz += ((qi == 0) & (ei != 0)).sum().item()
    group.check()
    return (loss.item(), (diff / ref) ** 0.5, zeros / (n * s),
            zeros_nz / (n * s))


def phase_zero_quant(dev, card):
    """Llama-3-8B widths at QZERO_LAYERS layers through
    ``build_zero_train_step(quantized_grads=True)`` over ZERO_N virtual
    ranks, from the same initial params: ZERO_STEPS monolithic steps (C6 +
    C3), ZERO_STEPS with ``error_feedback=True``, and ZERO_STEPS with
    ``overlap=True`` (C5 per reduce-scatter hop, C1 per allgather hop),
    each followed by one profiled step. Before them the first step's
    gradient through the exact reduce-scatter (C2) and through the int8
    ring (C6): the relative L2 distance of the shards and the share of
    elements the int8 exchange sends as 0. See the module docstring for
    the gates."""
    import functools

    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import build_zero_train_step, create_zero_state
    from ray_tpu_torch.parallel.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    f32_checked = phase_zero_quant_f32(dev)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = LlamaConfig.llama3_8b(
        n_layers=QZERO_LAYERS, max_seq_len=TRAIN_SEQ, attn_impl="flash",
        remat="dots", param_dtype=torch.bfloat16)
    L, n = cfg.n_layers, ZERO_N
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size,
                           (n, TRAIN_SEQ + 1)).astype(np.int64)
               for _ in range(ZERO_STEPS + 1)]
    tokens = n * TRAIN_SEQ
    ring_kernels = R.KERNELS + Q.KERNELS
    b_kernels = (attention.flash_fwd_cuda, attention.flash_bwd_dkv_cuda,
                 attention.flash_bwd_dq_cuda)
    n_params = cfg.num_params()
    log("zero", f"int8 exchange: Llama-3-8B widths, {L} layer, "
        f"{n_params / 1e9:.3f} B params (bf16), {n} virtual ranks, AdamW, "
        f"batch {n} x {TRAIN_SEQ}; {card}")

    # The first step's gradient, exact and through the int8 ring.
    loss0, grad_rel, zero_share, zero_share_nz = _int8_first_grad(
        cfg, opt, {"tokens": batches[0]}, n, dev)
    log("zero", f"int8 exchange of the first step's gradient against the "
        f"exact reduce-scatter (C2, bf16): shards' relative L2 distance "
        f"{grad_rel:.4f}; {100 * zero_share:.2f}% of shard elements sent as "
        f"0 ({100 * zero_share_nz:.2f}% where the exact sum is not 0)")
    gc.collect()
    torch.cuda.empty_cache()

    def run(name, **kw):
        group = RingGroup(n, dev)
        torch.cuda.reset_peak_memory_stats()
        ef = kw.get("error_feedback", False)
        state = create_zero_state(init_params(cfg, seed=0, device=dev), opt,
                                  group, error_feedback=ef)
        step = build_zero_train_step(
            lambda p, b: loss_fn(p, b, cfg), opt, group, quantized_grads=True,
            n_chunks=ZERO_CHUNKS, **kw)
        for k in ring_kernels + b_kernels:
            k.launches = 0
        losses, norms, times = [], [], []
        for i in range(ZERO_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": batches[i]})
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            times.append(time.perf_counter() - t0)
        group.check()
        ring = [k.launches for k in ring_kernels]
        b = [k.launches for k in b_kernels]
        n_c = len(state.layout) - 1
        hops = (n - 1) * n_c * ZERO_STEPS
        want = ([hops, 0, 0, 0, hops, 0] if kw.get("overlap")
                else [0, 0, ZERO_STEPS, 0, 0, ZERO_STEPS])
        want_b = [2 * L * n * ZERO_STEPS, L * n * ZERO_STEPS,
                  L * n * ZERO_STEPS]
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"int8 {name}: non-finite loss or grad norm {losses} {norms}")
        loss_rel = abs(losses[0] - loss0) / abs(loss0)
        check(loss_rel <= 1e-6, f"int8 {name}: first loss {losses[0]} is not "
              f"the exact step's {loss0}")
        check(ring == want, f"int8 {name}: launches (C1-C6) {ring} != {want}")
        check(b == want_b, f"int8 {name}: launches (B1-B3) {b} != {want_b}")
        check(all(torch.equal(state.flat[r], state.flat[0])
                  for r in range(n)),
              f"int8 {name}: a rank's parameter copy differs from rank 0's")
        rec = {}
        if ef:
            # max|ef| as a reduction (no copy of the 19 GiB buffer); a
            # NaN or an inf anywhere makes it non-finite.
            ef_max = torch.linalg.vector_norm(state.ef, float("inf")).item()
            check(state.ef.dtype == torch.float32 and np.isfinite(ef_max)
                  and ef_max > 0,
                  f"int8 {name}: ef is not finite, f32 and non-zero")
            rec["ef_abs_max"] = ef_max
        peak = torch.cuda.max_memory_allocated()
        before = PEAK_GIB_BEFORE.get(f"int8 {name}")
        step_s = float(np.median(times[1:]))
        log("zero", f"int8 {name}: losses "
            + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
            + ", ".join(f"{x:.3f}" for x in norms))
        log("zero", f"int8 {name}: {ZERO_STEPS} steps of {n} ranks x "
            f"{TRAIN_SEQ} tokens: step times "
            + ", ".join(f"{x:.3f}" for x in times) + f" s; median after the "
            f"first {step_s:.4f} s = {tokens / step_s:.0f} tokens/s; peak "
            f"memory {peak / 2**30:.2f} GiB"
            + (f" (before the hop ran in place: {before} GiB)" if before
               else "") + f"; launches C1-C6 {ring} (expected "
            f"{want}), B1-B3 {b}; every rank's copy equal; {card}")
        log("zero", f"int8 {name}: one profiled step")
        prof = _profile_step("zero", step, state, batches[ZERO_STEPS], card)
        wall, busy, groups = prof["wall_ms"], prof["busy_ms"], prof["groups"]
        q_ms = groups.get("ring C5/C6", 0.0)
        ring_ms = q_ms + groups.get("ring C1-C4", 0.0)
        rec.update({"profiled_groups": groups,
            "losses": losses, "grad_norms": norms, "step_times_s": times,
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "peak_gib": peak / 2**30, "launches_c1_c6": ring,
            "launches_b1_b3": b, "chunks": n_c, "first_loss_rel": loss_rel,
            "profiled_wall_ms": wall, "profiled_busy_ms": busy,
            "q_ms": q_ms, "ring_ms": ring_ms, "q_share": q_ms / busy})
        del state, step, group
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    out = {"layers": L, "params": n_params, "first_loss": loss0,
           "first_grad_rel_l2": grad_rel, "first_grad_zero_share": zero_share,
           "first_grad_zero_share_nonzero_exact": zero_share_nz,
           "f32_bitwise_runs": f32_checked}
    out["monolithic"] = run("monolithic")
    out["error_feedback"] = run("error feedback", error_feedback=True)
    out["overlap"] = run("overlap", overlap=True)
    return out


def serve_ab(tree: str) -> int:
    """``--serve-ab DIR``: the paged mix without its prompts over 512 on a
    dense server, then the whole mix on a paged server, each fresh and
    warmed, at Llama-3-8B full width and depth (int8, weights from seed
    0), with ``ray_tpu_torch`` imported from DIR (a checkout of another
    commit). Compares two commits on one card: run parent, change,
    change, parent, one process each, in one call. Prints one JSON
    line."""
    sys.path.insert(0, os.path.abspath(tree))
    import ray_tpu_torch
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.serve.llm import LLMServer

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    cfg = serve_config()
    params = init_params(cfg, 0, dev)
    mix = paged_mix(cfg.vocab_size)
    out = {"package": os.path.dirname(os.path.abspath(
        ray_tpu_torch.__file__)), "card": card}
    for name, engine, long_prompts in (("dense", ENGINE, False),
                                       ("paged", PAGED_ENGINE, True)):
        server = LLMServer(model_config=cfg, engine_config=dict(engine),
                           params_loader=lambda: params, device=dev)
        try:
            warm(server, cfg)
            res = run_mix(server, mix, f"serve-ab {name}", card,
                          long_prompts=long_prompts)
        finally:
            server.shutdown()
        out[name] = {k: v for k, v in res.items() if k != "results"}
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--serve-ab"] and len(sys.argv) == 3:
        return serve_ab(sys.argv[2])
    from ray_tpu_torch.models.llama import LlamaConfig

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log("env", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    built = phase_build()
    ring_built = phase_ring_build(built)
    rows = phase_kernels(dev)
    bwd_rows = phase_bwd_kernels(dev)
    head_dims = phase_head_dims(dev)
    draft_b1 = phase_draft_b1(dev)
    n_params = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS).num_params()
    group = ZERO_N * 128
    ring_rows = phase_ring_kernels(dev, card,
                                   -(-n_params // group) * group // 128)
    q_params = LlamaConfig.llama3_8b(n_layers=QZERO_LAYERS).num_params()
    qring_rows = phase_qring_kernels(dev, card,
                                     -(-q_params // group) * group)
    from ray_tpu_torch.models.llama import init_params

    # One weight tree (bf16, seed 0) behind the dense, paged and
    # speculative servers, one server at a time; each quantizes it to int8.
    serve_cfg = serve_config()
    serve_params = init_params(serve_cfg, 0, dev)
    mix = paged_mix(serve_cfg.vocab_size)
    serve_launches, serve_profile, dense_mix = phase_serve(
        dev, serve_cfg, lambda: serve_params, mix, card)
    gc.collect()
    torch.cuda.empty_cache()
    paged = phase_paged_serve(dev, serve_cfg, lambda: serve_params, mix,
                              dense_mix, card)
    gc.collect()
    torch.cuda.empty_cache()
    spec = phase_spec_serve(dev, serve_cfg, lambda: serve_params, mix, card)
    gc.collect()
    torch.cuda.empty_cache()
    disagg = phase_disagg(dev, serve_cfg, lambda: serve_params, card)
    del serve_params, dense_mix
    gc.collect()
    torch.cuda.empty_cache()
    paged_bitwise = phase_paged_bitwise(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    paged_tokens = phase_paged_tokens(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    disagg_gates = phase_disagg_gates(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    c4_launches, zero_f32_err = phase_zero_f32(dev)
    gc.collect()
    torch.cuda.empty_cache()
    zero = phase_zero_train(dev, card)
    mono, over = zero["monolithic"], zero["overlap"]
    gc.collect()
    torch.cuda.empty_cache()
    zq = phase_zero_quant(dev, card)
    qmono, qef, qover = zq["monolithic"], zq["error_feedback"], zq["overlap"]
    qruns = (qmono, qef, qover)
    zero_b = [a + b for a, b in zip(mono["launches_b1_b3"],
                                    over["launches_b1_b3"])]
    zq_b = [sum(r["launches_b1_b3"][i] for r in qruns) for i in range(3)]

    main_row = next(r for r in rows if r["S"] == 512 and r["causal"])
    fwd_report = kernel_report(built, "flash_fwd_kernel")
    fwd_f32_report = kernel_report(built, "flash_fwd_f32_kernel")
    bwd_main = next(r for r in bwd_rows
                    if (r["B"], r["S"]) == (TRAIN_BATCH, TRAIN_SEQ))
    bwd_shape = (f"B={TRAIN_BATCH} H={N_HEADS} S={TRAIN_SEQ} D={HEAD_DIM} "
                 f"causal bf16")

    def bwd_kernel(name, key, outs, replaces, train_launches, zero_launches,
                   zq_launches):
        report = kernel_report(built, f"{name}_kernel")
        f32_report = kernel_report(built, f"{name}_f32_kernel")
        return {
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": replaces,
            "launches": train_launches + zero_launches + zq_launches,
            "launches_by_path": {"train": train_launches,
                                 "zero_train": zero_launches,
                                 "zero_quant": zq_launches},
            "max_abs_err": max(r[f"bf16_{o}_err"] for r in bwd_rows
                               for o in outs),
            "f32_max_abs_err": max(r[f"f32_{o}_err"] for r in bwd_rows
                                   for o in outs),
            "tol_used_max": max(r[f"{t}_{o}_used"] for r in bwd_rows
                                for o in outs for t in ("bf16", "f32")),
            "ms": bwd_main[f"{key}_ms"],
            "plain_ms": bwd_main["plain_ms"],
            "plain_computes": "dQ, dK and dV",
            "bound_ms": bwd_main[f"{key}_bound_ms"],
            "bound_by": bwd_main[f"{key}_bound_by"],
            "library_ms": bwd_main["library_ms"],
            "library_computes": "SDPA backward: dQ, dK and dV",
            "tflops": bwd_main[f"{key}_tflops"],
            "registers": report["registers"],
            "spills": report["spill_bytes"],
            "blocks_per_sm": blocks_per_sm(key, torch.bfloat16),
            "f32_registers": f32_report["registers"],
            "f32_spills": f32_report["spill_bytes"],
            "f32_blocks_per_sm": blocks_per_sm(key, torch.float32),
            "head_dims_and_full_mask_tol_used": head_dims,
            "shape": bwd_shape, "per_shape": bwd_rows}

    def ring_kernel(key, name, line, by_path):
        main = ring_rows[0][key]
        build = ring_build_fields(ring_built[key]) if key in ring_built \
            else {}
        return {
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/ring.cu",
            "replaces": f"ray_tpu/util/collective/pallas/ring.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": 0.0,
            "tolerance": "bitwise: torch.equal with the plain version",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_computes": main["library_computes"],
            "shape": f"n={main['n']} ranks x {main['rows']} x 128 bf16 sum",
            "per_shape": [t[key] for t in ring_rows], **build}

    def qring_kernel(key, name, line, by_path):
        main = qring_rows[0][key]
        return {
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/ring.cu",
            "replaces": f"ray_tpu/util/collective/pallas/quantized.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": 0.0,
            "tolerance": "bitwise: torch.equal with the plain version",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "yardstick_ms": main["yardstick_ms"],
            "yardstick_computes": main["yardstick_computes"],
            "shape": f"n={main['n']} ranks x {main['rows']} x 128 f32",
            "per_shape": [t[key] for t in qring_rows],
            **{k: main[k] for k in ("form", "hop0_ms", "standalone")
               if k in main},
            **ring_build_fields(ring_built[key])}

    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:47",
        "launches": (serve_launches + spec["b1_launches"]
                     + disagg["spec"]["b1_launches"]
                     + train["launches"][0] + zero_b[0] + zq_b[0]),
        "launches_by_path": {"serve": serve_launches, "paged_serve": 0,
                             "spec_serve_draft": spec["b1_launches"],
                             "disagg_spec_decode_draft":
                                 disagg["spec"]["b1_launches"],
                             "train": train["launches"][0],
                             "zero_train": zero_b[0], "zero_quant": zq_b[0]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "timed_by": TIMED_BY_GRAPH,
        "call_ms": main_row["call_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "tflops": main_row["tflops"],
        "f32_max_abs_err": max(r["f32_max_abs_err"] for r in rows),
        "tol_used_max": max(r["tol_used"] for r in rows),
        "draft_shapes_tol_used": draft_b1,
        "draft_prefill_tol_used": {
            "bf16 full width": spec["draft_b1_tol_used"],
            "f32 gate": paged_tokens["draft_b1_tol_used"],
            "bf16 disagg decode": disagg["spec"]["draft_b1_tol_used"],
            "f32 disagg gate": disagg_gates["draft_b1_tol_used"]},
        "registers": fwd_report["registers"],
        "spills": fwd_report["spill_bytes"],
        "blocks_per_sm": blocks_per_sm("fwd", torch.bfloat16),
        "f32_registers": fwd_f32_report["registers"],
        "f32_spills": fwd_f32_report["spill_bytes"],
        "f32_blocks_per_sm": blocks_per_sm("fwd", torch.float32),
        "shape": f"B=1 H={N_HEADS} S=512 D={HEAD_DIM} causal bf16",
        "per_shape": rows,
    }, bwd_kernel("flash_bwd_dkv", "dkv", ("dk", "dv"),
                  "ray_tpu/ops/attention.py:149", train["launches"][1],
                  zero_b[1], zq_b[1]),
        bwd_kernel("flash_bwd_dq", "dq", ("dq",),
                   "ray_tpu/ops/attention.py:211", train["launches"][2],
                   zero_b[2], zq_b[2]),
        ring_kernel("C1", "ring_permute", 378,
                    {"zero_train_overlap": over["launches_c1_c4"][0],
                     "zero_quant_overlap": qover["launches_c1_c6"][0]}),
        ring_kernel("C2", "ring_reduce_scatter", 169,
                    {"zero_train": mono["launches_c1_c4"][1]}),
        ring_kernel("C3", "ring_allgather", 146,
                    {"zero_train": mono["launches_c1_c4"][2],
                     "zero_quant": qmono["launches_c1_c6"][2]
                     + qef["launches_c1_c6"][2]}),
        ring_kernel("C4", "ring_allreduce", 107,
                    {"zero_replicated_f32": c4_launches}),
        qring_kernel("C5", "ring_qhop", 121,
                     {"zero_quant_overlap": qover["launches_c1_c6"][4]}),
        qring_kernel("C6", "ring_qallreduce", 49,
                     {"zero_quant_monolithic": qmono["launches_c1_c6"][5],
                      "zero_quant_error_feedback":
                          qef["launches_c1_c6"][5]})],
        "serve_profile": serve_profile, "paged_serve": paged,
        "spec_serve": spec, "paged_bitwise": paged_bitwise,
        "paged_tokens": paged_tokens, "disagg": disagg,
        "disagg_gates": disagg_gates,
        "train": {k: v for k, v in train.items() if k != "launches"},
        "zero_train": zero, "zero_f32_max_abs_err": zero_f32_err,
        "zero_quant": zq}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
