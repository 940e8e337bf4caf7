"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device  -- a CUDA device is required; prints its name and power limit.
2. build   -- compiles the five CUDA sources (one nvcc each, all at
              once) and prints ptxas' registers / shared memory / spills.
3. kernels -- each kernel against its plain PyTorch version at its paths'
              full-width shapes (K1 bitwise, also at ragged shapes and
              misaligned views; K4 and K5 bitwise; K2, K3 within 2e-5 in
              f32, K3 bf16 within rtol = atol = 1e-2; K4's backward kernel:
              dW bitwise, dprobs within its summation bound; the autograd
              function within rtol 1e-4 of autograd), plus one
              full-width layer packed on the card vs on the CPU
              (byte-identical); then each kernel timed with
              CUDA events and the profiler (L2 flushed before every
              launch) beside its plain version, its PyTorch yardstick
              where one call computes the same function, and its bound;
              K1's decode layout at 8-, 4- and 2-bit and at mamba2-780m's
              decode shapes beside bf16 torch.matmul; K1's tiles at both
              serving paths' prefill shapes, 4- and 8-bit, beside bf16
              torch.matmul and torch._int_mm; K2 (both of its kernels) at
              the serving mix's lengths and at 8 slots of 1000 tokens
              beside SDPA; K4 forward and backward at every resnet18
              search shape beside their plain versions and bounds, summed
              over a search step's 21 nodes, each named by the kernel it
              took (ring or simple) and, where the ring runs, beside the
              simple kernels; one launch of the stamped forward
              (mps_combine_probe) for its phase split in cycles; K4 at
              llama3.2-1b's projections (512/2048/8192 x 2048, 2048 x
              8192 rows x K), also through the LM's channel-last route
              from (K, C_out) weights (forward and dW bitwise, dprobs in
              bound), timed likewise with the transposing copy into rows,
              summed over a train step's 112 projections.  K5's
              backward kernel against its plain version (ds_in and ds0
              bitwise, ddecay within 2 P N 2^-24 sum |G prefix| and the
              same in two runs) at H = 48 and path 7's B * H = 192, C 1
              to 509, dfinal given and None, the one-float path, timed
              at C = 8 for both.
4. rng     -- the threefry2x32 generator on the card against the CPU
              (bits, uniforms, randints bit-equal; normal, gumbel within
              stated ULPs); the device sampler's cost per decode step.
5. serve   -- path 1: llama3.2-1b at full width (random weights, seed 0)
              served through a synthetic mixed-precision plan on a paged
              cache (16 greedy requests), then float (4 requests); launch
              counts read around each run; 4 sampled requests (each draw
              held against the CPU's, one stream batched == solo); paged
              vs dense prefill logits agree.
6. mamba   -- path 3: mamba2-780m at full width (random weights, seed 0)
              served through a synthetic mixed-precision plan on the paged
              backend (8 greedy requests of 33-2048 tokens, chunks 256,
              150, 1 and 11), then float on the dense backend (4
              requests); K5 launched 48 x admissions, K1 at least 6 x 48 x
              (decode steps + admissions) and 0 when float, no attention
              kernel; finite logits; two requests served alone give their
              batched streams; one full-width layer's prefill on the card
              (K5) against the same layer on the CPU (plain version),
              float and plan-bound (K1 too); K1 bitwise against its plain
              version on every precision group of that plan-bound layer.
7. search  -- path 2: the paper's joint search on resnet18 at full width
              (Tiny-ImageNet shapes, 200 classes, batch 32, data made on
              the card) through Compressor.run([Warmup, JointSearch,
              Finetune]); K4's forward and backward launch counts read
              around the run must each be 21 weight nodes x search steps;
              finite losses; a plan with
              bits in pw and the classifier unpruned.
8. train   -- path 4: the paper's joint search on llama3.2-1b at full
              width (remat, f32 master weights, adam at 3e-4, random
              weights from seed 0) through make_train_step(search=True),
              4 steps of batch 4 x 256 tokens; K4's forward launched 112 x
              steps x 2 (the remat recompute) and its backward 112 x
              steps, no other kernel and no call of the plain quantizer
              stack; finite losses and grad norms, every gamma leaf moved,
              a finite mps_size_cost; step ms, tokens/s, peak memory; one
              profiled step's busy share and K4's share; then
              extract_plan (112 groups, bits in pw), bound, and served (2
              greedy requests x 8 tokens, paged) on K1, K2 and K3.
9. resume  -- llama3.2-1b-smoke under deterministic algorithms: 2 steps,
              a checkpoint, restore_latest into a fresh template and 2
              more equal 4 uninterrupted steps bit for bit.
10. sweep  -- path 5: the paper's Pareto-front sweep through
              repro_torch.sweep.SweepRunner at full width.  gsc (DS-CNN
              width 64, lams 2 and 20 + 1 adaptive, 8 / 8 / 4 steps, warm
              points 4 + 4, batch 32, checkpoints every 4) uninterrupted,
              then killed in the second point's finetune and resumed: the
              two stores byte-identical under deterministic algorithms;
              a rerun over the store launches nothing; the w8 / w2
              baselines and the iso-accuracy report.  cifar10 (ResNet-9
              width 16), one cold and one warm point.  llama3.2-1b, two
              points (4 and 2 search steps, batch 4 x 256), each ~6 GB
              warm-start handoff written to a temporary workdir removed at
              the end; the front's first plan loaded from the store and
              served (2 greedy requests x 8 tokens) on K1-K3.  K4 launched
              weight nodes x JointSearch steps each way (cnn), 112 x
              (steps x 2 + eval batches) forward and 112 x steps backward
              (lm); no weight on the plain quantizer stack; finite losses,
              scores and costs; seconds a point, handoff bytes and seconds.
11. moe     -- path 6: MoE serving at full width, depth cut, bf16
              weights from seed 0.  llama4-scout-17b-a16e at 12 of 48
              layers (3 super-blocks of 3 chunked + 1 full attention
              layers, 16 experts top-1 + the shared FFN) bound to
              synthetic_plan(bits=None, seed=0) on a paged cache (page 16,
              max_len 9216, 8 slots): 8 greedy requests x 32 tokens,
              prompts of 64-1024 tokens and of 8176 (decode crosses the
              8192 chunk boundary on K2) and 8320 (K3's prefill crosses
              it); then 2 float requests; then one profiled window split
              a decode step's device time between cuBLAS's products (the
              expert banks), K1, K2, K3 and the rest.  arctic-480b at 2 of
              35 layers (128 experts top-2 + the shared FFN), plan-bound,
              4 requests x 16 tokens.  Each: full-length streams, finite
              logits, K1 >= 7 x layers x (steps + admissions) plan-bound
              (0 float), K2 >= layers x steps, K3 >= layers x admissions;
              paged (K3) vs dense prefill logits of a 64-token prompt
              within 5e-2 relative L2; peak memory.  Before the paths, the
              kernels phase holds K2 and K3 against their plain versions
              at these archs' attention shapes (G = 5 and 7, D = 128,
              chunked window 8192 across a chunk boundary), timed beside
              SDPA.  Every path's peak memory is printed.
12. mamba-train -- path 7: the paper's joint search on full-width
              mamba2-780m (48 layers, d 1536, 48 heads of 64, state 128,
              chunk 256; remat, f32 master weights, adam at 3e-4, lam
              1e-9, random weights from seed 0) through
              make_train_step(search=True), 4 steps of batch 4 x 2048
              tokens; K4 launched 288 x steps x 2 forward (the remat
              recompute) and 288 x steps backward, K5 48 x steps x 2
              forward and 48 x steps backward, no other kernel; finite
              losses and grad norms, every gamma leaf moved; K5's backward
              on step 1's layer 0 at (8, 192, 64, 128) held against its
              plain version; one full-width layer's train-mode gradients
              on the card within 1e-2 relative L2 of the CPU's; step ms,
              tokens/s, peak memory; one profiled step's busy share with
              K4's and K5's forward and backward device ms; then
              extract_plan (288 groups), served (2 greedy requests x 8
              tokens, paged) on K1 and K5.
13. encdec-train -- path 8: the paper's joint search on full-width
              seamless-m4t-medium (12 encoder + 12 decoder layers, d 1024,
              16 heads of 64, d_ff 4096, vocab 256206 padded to 256256;
              remat, f32 master weights, adam at 3e-4, lam 1e-9, random
              weights from seed 0) through make_train_step(search=True), 4
              steps of 4 x 256 decoder tokens (lm_batch) against 4 x 512
              encoder frames (the audio frontend stub's, seeded bf16 x
              0.1); K4 launched 168 x steps x 2 forward (remat recomputes
              both stacks) and 168 x steps backward -- 84 encoder + 84
              decoder projections; the 48 cross projections take their raw
              weights, as in the reference, and never reach K4 -- no
              other kernel, no call of the plain quantizer stack; finite
              losses and grad norms, every gamma leaf moved (the cross
              ones too); one full-width decoder layer's train-mode
              gradients on the card within 1e-2 relative L2 of the CPU's;
              step ms, tokens/s, peak memory, one profiled step's busy
              share and K4's device ms; then extract_plan (132 groups),
              apply_plan (cross projections on K1, the encoder stacked and
              float), 2 requests (prompts 37 and 90, 512 frames each)
              prefilled into dense caches and 8 greedy tokens decoded: K1
              launched once a precision group of every planned projection
              a prefill and of all but the cross wk / wv a decode step (a
              decode step reads the cached encoder K/V and runs no
              encoder), no other kernel; finite, batched == solo.
14. vlm     -- path 9: qwen2-vl-72b at published widths (d 8192, 64 / 8
              heads of 128, d_ff 29568, vocab 152064), 16 of 80 layers,
              bf16 weights from seed 0 bound to synthetic_plan(bits=None,
              seed=0); InferenceServer refuses the family (as the
              reference's does), so a serve.cache.PagedCache (page 16, 4
              slots of 4128 tokens) is driven through lm.forward and
              lm.decode_step: 4 requests prefilled from the vision
              frontend stub's patch embeddings (1024, 2000, 3136 and 4100
              rows, seeded bf16 x 0.1) and 16 greedy decode steps, the
              last 4 profiled (device ms a step split into K1, K2, K3,
              cuBLAS and the rest); K1 launched once a precision group of
              the 112 planned projections a forward, K3 16 x admissions,
              K2 16 x steps, nothing else; finite; two requests served
              alone give their batched streams; 2 float requests (K1 0);
              paged (K3) vs dense prefill logits of a 64-row prompt within
              5e-2 relative L2; peak memory.  Before the paths, the
              kernels phase holds K4 at seamless's three projection shapes
              (directly and through the channel-last route, timed over a
              step's 168 projections), K1 bitwise at qwen2-vl's widths (M
              8 and 2048, 8/4/2-bit; layer 0's plan groups at M 4 and
              4112) timed beside bf16 torch.matmul, and K2 / K3 at G = 8,
              D = 128 (lens up to 4116; 4100 rows padded to 4112) against
              their plain versions, timed beside SDPA.
15. fleet   -- path 10: ``launch.fleet.build_fleet`` serving full-width
              llama3.2-1b (seed-0 weights, one parameter tree) from four
              replicas on the card, tiers float / w8 / mixed / w2 (paged,
              page 16, 8 slots, max_len 1024), behind pareto_degrade: a
              Poisson trace of 32 requests (prompts 16-512, 16-32 greedy
              tokens, 300 ms modelled deadlines; at least one routed below
              the top tier), timed, then again under the profiler (its
              device busy share: the union of device intervals over run
              1's wall; the same records), and a burst trace; then chaos
              with failover (nan_plan on float, crash on w8, slow on
              mixed, pool pressure on w2, at a virtual time when run 1 had
              float and w8 busy).  Every request at a terminal; 8 finished
              streams of run 1 and the burst (two a tier where it finished
              two) and one a tier of the chaos run (float, struck, left
              out) equal to their replica's solo serve, every tier that
              finished a stream among them; the NaN strike quarantines
              float and counts fault_nan_detected_total; over the three
              runs (counted around each replica's step, inside the runs
              only), K1 launched on w8 / mixed / w2 and never on float, K2
              and K3 on every replica that served; launches and
              streams of one replica equal with obs attached and with
              obs=None; the chaos run's metrics and trace pass
              repro_torch.obs.validate against the port's schema copy.
              Prints each run's wall seconds, decode steps and tokens,
              each tier's real wall ms a decode step beside its modelled
              step_ms (every fleet latency is on the modelled clock), the
              busy share and peak memory.
16. jamba   -- path 11: the hybrid jamba-1.5-large-398b at published
              widths (d 8192, 64 / 8 heads of 128, d_ff and moe_d_ff
              24576, Mamba-2 d_inner 16384 in 128 heads of 128, state
              128, top-2 MoE, vocab 65536, bf16 weights from seed 0), cut
              to one super-block (8 of 72 layers: 7 Mamba-2 and 1
              attention, a dense FFN on the even slots and MoE on the odd
              ones) and 8 of 16 experts a bank, bound to
              synthetic_plan(bits=None, seed=0) (58 groups) on a paged
              cache (page 16, 8 slots of 4160 tokens): 8 greedy requests
              x 32 tokens with prompts of 1-4100 tokens (SSM chunks 1 to
              256; 257 tokens scan 257 chunks), each prefilled unpadded
              into the pages; then 2 float requests (256 and 1000 tokens
              x 16).  K5 launched 7 x admissions, K3 once an admission,
              K2 once a decode step, K1 once a precision group of every
              planned projection a forward (0 float), no other kernel;
              finite logits; a profiled decode step split by class
              (cuBLAS's expert banks, K1, K2, K5, the rest) and each
              admission's device ms by class; one full-width Mamba-2
              layer's prefill card vs CPU, float and plan-bound, within
              1e-2; K1 bitwise on every precision group of plan-bound
              layer 0's mixer and dense FFN; paged (K3) vs dense prefill
              logits, and K3 vs its plain version in the paged prefill,
              within 5e-2 at 64, 33 and 255 tokens; memory_report and
              peak memory.  Before the paths, the kernels phase holds K5
              bitwise at (C, 128, 128, 128) for C = 1, 20, 257 and times
              it at C = 20, holds K1 bitwise at every (M, K, N, bits)
              path 11 gives it (jamba_k1_cases) and times its decode
              layout at the five new (K, N) and its tiles at M = 4100,
              K x N 8192 x 24576, and holds K3 (bf16, G = 8, D = 128)
              against its plain version within 1e-2 at each of path 11's
              exact prompt lengths, timing it at 4100 tokens.
17. arctic-train -- path 12: the paper's joint search on arctic-480b
              at published widths (d 7168, 56 / 8 heads of 128, d_ff =
              moe_d_ff 4864, top-2 + the shared FFN, vocab 32000), cut
              to 1 of 35 layers and 32 of 128 experts a bank (4.03 B
              parameters), bf16 masters, adam_int8 at 3e-4, 4
              micro-batches, remat, seed-0 weights, through
              make_train_step(search=True): 4 steps of 8 x 256 tokens;
              K4 launched 10 gamma nodes x 4 micro-batches x 2 (remat) a
              step forward and 10 x 4 backward (the 3 banks' C_out rows
              of E * K on its simple kernels), nothing else, no call of
              the plain quantizer stack; step 0's remat recomputes route
              as their forwards; finite losses and grad norms, every
              bank gamma moved; step ms, tokens/s, peak memory, one
              profiled step's busy share and K4's device ms (banks
              apart); then extract_plan (7 groups: no bank, no router),
              served plan-bound (4 requests of 64-512 tokens x 16, page
              16) and float (1 request) on K1-K3, paged vs dense
              prefill within 5e-2; one arctic MoE layer at published
              widths with 4 experts card vs CPU within 2e-2; one
              jamba-smoke search step card vs CPU (K4 on the banks and
              the dense projections, K5 forward and backward).  Before
              the paths, the kernels phase holds K4 bitwise at the
              expert banks' shapes (arctic's 32-expert and scout's
              16-expert banks as C_out rows of E * K) and times both
              kernels and the bank's transposing copy beside their
              bounds.
18. expert-parallel -- path 13: the mesh layer and the expert-parallel
              layout (``distributed.sharding``, ``launch.mesh``,
              ``nn/blocks.moe_layer``'s mesh branch; the rule overrides
              that unmap every axis but ``batch`` and ``experts``) on
              four processes
              sharing the card (a gloo group with a file rendezvous under
              a temporary directory; NCCL takes one rank a device); the
              parent builds every kernel first, the ranks only load them,
              and each rank draws only its own experts (every expert from
              a generator seeded by its bank and index).  (a) arctic-480b
              at published widths, 1 of 35 layers, all 128 experts on
              mesh (1, 4), 32 a rank, bf16, plan-bound through
              synthetic_plan(bits=None, seed=0) (K1; the banks on cuBLAS)
              and float: 4 prompts of 64-512 tokens prefilled into a
              PagedCache (page 16) through make_paged_prefill_step (K3)
              and 16 greedy decode steps through make_decode_step (K2);
              every rank's logits bitwise equal to the same layer served
              by one process after the ranks exit, tokens identical, each
              rank's K1 / K2 / K3 launches the single run's.  (b) arctic
              cut to 8 experts on mesh (2, 2), 4 a model rank, under the
              search (bf16 masters, adam_int8 at 3e-4, 4 micro-batches,
              remat), 3 steps of 8 x 256 tokens: step 0's data-shard
              losses bitwise against one process run on each shard alone
              (same t_loc), its clipped gradients within EP_TRAIN_GRAD
              relative L2 a leaf, each bank's absmax on every rank
              bitwise the whole bank's, replicated leaves identical on
              all ranks after every step, bank gammas moved, one plan on
              every rank, K4 80 forward (24 given the absmax) and 40
              backward launches a step a rank; one more step profiled on
              rank 0 (device ms by class, the all-reduces' wall ms).  (c)
              ``python -m torch.distributed.run --standalone
              --nproc-per-node 4 -m repro_torch.launch.train --arch
              arctic-480b-smoke --search --mesh 2,2 --dist-backend gloo
              --steps 3`` (the launcher's full placements) exits 0 and
              its checkpoint restores under (1, 1).  Before the paths,
              the kernels phase holds K4's forward
              given an absmax bitwise at path 13's bank-shard shapes
              (4864 x 28672 and 7168 x 19456) and times it.
19. tensor-parallel -- path 14: tensor parallelism, FSDP and the
              sequence-parallel residual stream in the search train step
              (``distributed.sharding.Region``, ``models/lm._make_getw``,
              the vocab-parallel embedding and loss, ``launch/steps``)
              under the reference's rules (the arch's RULE_OVERRIDES and
              the train shape's), four processes sharing the card over
              gloo.  (a) llama3.2-1b at published widths and full depth
              on mesh (2, 2), (b) mamba2-780m at published widths, 8 of
              48 layers, on mesh (1, 4) (12 of 48 heads a rank): each
              trained under the search (float32 masters, adam at 3e-4,
              remat), 3 steps of 4 x 256 tokens; step 0's loss within
              TP_LOSS and its clipped gradients within TP_GRAD relative
              L2 a leaf of the port's (1, 1) step on the card on the
              same parameters and data (run after the ranks exit);
              every leaf the same on the ranks that hold the same shard
              after every step; every gamma moved; K4 launches a rank
              (llama's all given the absmax) and K5's forward and
              backward on the local heads counted; step ms a rank, the
              collectives' count and wall ms by kind, the card's busy
              share over the last step (every rank profiled) and peak
              memory a rank.
20. report -- one JSON line of kernels (with each kernel's launches on
              paths 8 to 14), the card's name and power limit, and last
              the JSON status line.

Imports torch, numpy and the port (``src/repro_torch``) only.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
FLUSH_BYTES = 64 << 20        # > the 50 MB L2


def log(msg):
    print(msg, flush=True)


def bound(nbytes, ops, kind):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, n, flush):
    """Mean device time of ``fn`` over ``n`` calls after two warm-ups,
    with the L2 overwritten before each call (the main path meets every
    weight and page cold)."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(n):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / n


FLUSH_KERNELS = ("FillFunctor", "Memset")   # what ``flush.zero_()`` runs


def device_ms(fn, n, flush, kernel=None, names=True):
    """Mean device time of the CUDA kernels whose name holds ``kernel``
    per call of ``fn``, read by ``torch.profiler`` over ``n`` calls with
    the L2 overwritten before each: the kernel alone, without the host's
    launch path that a CUDA-event interval around a call also holds.
    ``kernel=None`` sums every kernel the calls ran except the flush's
    (a library call's cuBLAS / flash kernels, whatever their names).
    The profiler has returned traces that lost launch records between
    good ones, and traces that each lost one record of the calls' (a
    flush on each side of them takes such a loss), so each attempt also
    traces one call: every kernel name it
    holds must appear exactly ``n`` times as often in the ``n`` calls'
    trace, and no other, or both are taken again (four times at most).
    The names matched are left in ``device_ms.names``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()

    def trace(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a flush on each side of the calls: where a card's trace
            # drops its first or last launch record, it drops one of
            # these, which no count reads
            flush.zero_()
            torch.cuda.synchronize()
            for _ in range(calls):
                flush.zero_()
                fn()
            flush.zero_()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if e.self_device_time_total > 0
                and (kernel in e.key if kernel is not None
                     else not any(f in e.key for f in FLUSH_KERNELS))]

    what = kernel or "the library call"
    for attempt in range(5):
        one = {e.key: e.count for e in trace(1)}
        rows = trace(n)
        seen = {e.key: e.count for e in rows}
        if one and seen == {key: c * n for key, c in one.items()}:
            break
        log(f"[profile] trace {attempt + 1} of {what}: one call "
            f"{sorted(one.values())} launches, {n} calls "
            f"{sorted(seen.values())}")
    else:
        raise AssertionError(f"profiler lost launches of {what} in five "
                             f"traces")
    device_ms.names = sorted(seen)
    if kernel is None and names:
        log(f"[profile] library kernels: "
            f"{sorted({e.key[:80] for e in rows})}")
    return sum(e.self_device_time_total for e in rows) / n / 1e3


def pool_case(rng, lens, *, h, hkv, d, ps, width, dtype, dev, s=None):
    """Pools with a NaN null page, random physical pages, block tables
    (a freed slot gets an all-null row) and queries."""
    b = len(lens)
    n_pages = b * width
    k = torch.as_tensor(rng.normal(size=(n_pages + 1, ps, hkv, d)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(n_pages + 1, ps, hkv, d)),
                        dtype=torch.float32)
    k[0] = float("nan")
    v[0] = float("nan")
    tables = np.zeros((b, width), np.int32)
    perm = rng.permutation(np.arange(1, n_pages + 1))
    idx = 0
    for bi, n in enumerate(lens):
        npg = -(-n // ps)
        tables[bi, :npg] = perm[idx:idx + npg]
        idx += npg
    qshape = (b, h, d) if s is None else (b, s, h, d)
    q = torch.as_tensor(rng.normal(size=qshape), dtype=torch.float32)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.as_tensor(tables, device=dev))


K1_LLAMA = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))
K1_MAMBA = ((1536, 3072), (1536, 128), (1536, 48), (3072, 1536), (1536, 37))
# (M, K, N) the tensor-core tiles must also take: ragged M, N and K,
# unaligned rows (K = 37, 100), plan group widths (9, 1236), M = 1 / 9
K1_RAGGED = ((1, 100, 37), (9, 1536, 1236), (17, 37, 9), (65, 2048, 128),
             (129, 8192, 3072), (2048, 1536, 1236), (16, 100, 3072))
# prefill shapes timed: llama3.2-1b's widest projection at a 512-token
# prompt, mamba2-780m's in_z / in_x at a 2048-token prompt
K1_PREFILL = (("llama", 512, 2048, 8192), ("mamba", 2048, 1536, 3072))


def sdpa_kv(kp, vp, tb, h, hkv, d):
    """The pools' pages gathered through the tables into dense (B, H, T,
    D) K and V, each KV head repeated over its query group: SDPA's
    operands."""
    def one(pool):
        x = pool[tb.long()].reshape(tb.shape[0], -1, hkv, d).transpose(1, 2)
        return x.repeat_interleave(h // hkv, 1).contiguous()
    return one(kp), one(vp)


def k2_timing(dev, flush, pools, pos, lens, h, hkv, d, ps):
    """K2 timed beside its plain version and SDPA on the gathered K/V
    (repeated over the group, masked past each slot's length); the
    device time sums both of K2's kernels (split and merge)."""
    from repro_torch.kernels.paged_attention import ops as pops

    q, kp, vp, tb = pools
    live_tok = sum(lens)
    live_pages = sum(-(-x // ps) for x in lens)
    kd, vd = sdpa_kv(kp, vp, tb, h, hkv, d)
    key_pos = torch.arange(kd.shape[2], device=dev)
    mask = (key_pos[None, :] <= pos[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :]
    nb = 2 * (q.numel() * 2) + 2 * live_pages * ps * hkv * d * 2 + \
        tb.numel() * 4 + pos.numel() * 4
    bms, by = bound(nb, 4 * h * d * live_tok, "bf16")

    def kern():
        return pops.paged_attention_fwd(q, kp, vp, tb, pos)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask)

    return dict(ms=time_ms(kern, 50, flush),
                device_ms=device_ms(kern, 50, flush, "paged_decode"),
                plain_ms=time_ms(lambda: pops.paged_attention_ref(
                    q, kp, vp, tb, pos), 5, flush),
                library_ms=time_ms(lib, 50, flush),
                library_device_ms=device_ms(lib, 50, flush),
                bound_ms=bms, bound_by=by)


def k3_timing(dev, flush, pools, lens3, s_real, h, hkv, d, ps,
              q_chunk=16):
    """K3 (bf16) timed beside its plain version and causal SDPA on the
    gathered K/V of the prompt's pages, with its bound: each real query
    attends the keys up to itself."""
    from repro_torch.kernels.paged_attention import ops as pops

    q, kp, vp, tb = pools
    npg = -(-s_real // ps)
    qk = s_real * (s_real + 1) // 2
    nb = 2 * q[:, :s_real].numel() * 2 + 2 * s_real * hkv * d * 2 + \
        tb.numel() * 4
    bms, by = bound(nb, 4 * h * d * qk, "bf16")
    kd, vd = sdpa_kv(kp, vp, tb[:, :npg], h, hkv, d)
    qd = q.transpose(1, 2).contiguous()

    def lib():
        # top-left causal: query i reads keys 0..i of the gathered pages
        return torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True)

    def kern():
        return pops.paged_prefill_fwd(q, kp, vp, tb, lens3, q_chunk=q_chunk)

    return dict(ms=time_ms(kern, 10, flush),
                device_ms=device_ms(kern, 10, flush,
                                    "paged_prefill_mma_kernel"),
                plain_ms=time_ms(lambda: pops.paged_prefill_ref(
                    q, kp, vp, tb, lens3, q_chunk=q_chunk), 1, flush),
                library_ms=time_ms(lib, 10, flush),
                library_device_ms=device_ms(lib, 10, flush, names=False),
                bound_ms=bms, bound_by=by)


def phase_kernels(dev, flush):
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # -- K1: every main-path shape and width, bitwise ---------------------
    # llama3.2-1b's projections at decode and a 512-token prefill; then
    # mamba2-780m's (in_z / in_x 1536 -> 3072, in_b / in_c 1536 -> 128,
    # in_dt 1536 -> 48, out_proj 3072 -> 1536) at decode and a 2048-token
    # prefill, and a ragged group width
    k1_cases = [(m, kk, n) for m in (8, 512)
                for kk, n in K1_LLAMA] + [(m, kk, n) for m in (8, 2048)
                                          for kk, n in K1_MAMBA]
    k1_err = 0.0
    for case in k1_cases + list(K1_RAGGED) + ["views"]:
        for bits in (8, 4, 2):
            m, kk, n = (65, 1536, 130) if case == "views" else case
            per = 8 // bits
            qmax = 2 ** (bits - 1) - 1
            xq = torch.randint(-127, 128, (m, kk), generator=g,
                               device=dev, dtype=torch.int8)
            wq = torch.randint(-qmax - 1, qmax + 1,
                               (n, -(-kk // per) * per), generator=g,
                               device=dev, dtype=torch.int8)
            wq[:, kk:] = 0
            sw = torch.rand(n, generator=g, device=dev) * 1e-3
            sx = torch.ones((), device=dev)
            xk, wk = xq, qref.pack_weights(wq, bits)
            if case == "views":     # storage off a 16-byte boundary
                xb = torch.zeros(xq.numel() + 3, dtype=torch.int8,
                                 device=dev)
                xb[3:] = xq.reshape(-1)
                wb = torch.zeros(wk.numel() + 5, dtype=torch.int8,
                                 device=dev)
                wb[5:] = wk.reshape(-1)
                xk, wk = xb[3:].view(xq.shape), wb[5:].view(wk.shape)
            got = qops.quant_matmul(xk, wk, sw, sx, w_bits=bits)
            torch.cuda.synchronize()
            want = qref.quant_matmul_ref(xq, wq[:, :kk], sw, sx)
            diff = (got - want).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K1 not bitwise at M={m} K={kk} N={n} bits={bits}"
                    f"{' (misaligned views)' if case == 'views' else ''}: "
                    f"max |diff| {diff}")
            k1_err = max(k1_err, diff)
    log(f"[kernels] K1 quant_matmul: bitwise equal to the int32 plain "
        f"version at M in {{8, 512}} x (K, N) in {list(K1_LLAMA)} (llama), "
        f"M in {{8, 2048}} x (K, N) in {list(K1_MAMBA)} (mamba), (M, K, N) "
        f"in {list(K1_RAGGED)} and misaligned views at 65 x 1536 x 130, "
        f"bits 8/4/2")

    # K1 timing at the decode shape of the widest projection, 4-bit
    m, kk, n, bits = 8, 2048, 8192, 4
    copies = []
    for _ in range(8):        # distinct weights, as 112 layers would be
        wq = torch.randint(-7, 8, (n, kk), generator=g, device=dev,
                           dtype=torch.int8)
        copies.append((qref.pack_weights(wq, bits), wq))
    xq = torch.randint(-127, 128, (m, kk), generator=g, device=dev,
                       dtype=torch.int8)
    sw = torch.rand(n, generator=g, device=dev) * 1e-3
    sx = torch.ones((), device=dev)
    it = iter(range(10 ** 9))

    def k1():
        wp, _ = copies[next(it) % len(copies)]
        return qops.quant_matmul(xq, wp, sw, sx, w_bits=bits)

    def k1_plain():
        wp, _ = copies[next(it) % len(copies)]
        return qref.quant_matmul_ref(xq, qref.unpack_weights(wp, bits, kk),
                                     sw, sx)

    xb = xq.to(torch.bfloat16)
    deq = [(w.to(torch.bfloat16) * sw[:, None].to(torch.bfloat16))
           for _, w in copies]

    def k1_lib():
        return torch.matmul(xb, deq[next(it) % len(deq)].T)

    nbytes = m * kk + n * kk * bits // 8 + n * 4 + 4 + m * n * 4
    bms, by = bound(nbytes, 2 * m * n * kk, "int8")
    rows["quant_matmul"] = dict(
        shape=f"M={m} K={kk} N={n} {bits}-bit", max_abs_err=k1_err,
        ms=time_ms(k1, 50, flush), device_ms=device_ms(k1, 50, flush, "qmv"),
        plain_ms=time_ms(k1_plain, 10, flush),
        library_ms=time_ms(k1_lib, 50, flush),
        library_device_ms=device_ms(k1_lib, 50, flush), bound_ms=bms,
        bound_by=by)
    rows["quant_matmul"]["decode"] = phase_k1_decode(dev, flush, g)
    rows["quant_matmul"]["prefill"] = phase_k1_prefill(dev, flush, g)
    p0 = rows["quant_matmul"]["prefill"][0]      # llama, 4-bit
    rows["quant_matmul"].update(
        prefill_ms=p0["ms"], prefill_device_ms=p0["device_ms"],
        prefill_library_ms=p0["library_ms"], prefill_bound_ms=p0["bound_ms"])

    # -- K2: decode at the main path's shapes ------------------------------
    h, hkv, d, ps, width = 32, 8, 64, 16, 64
    lens = [1, 17, 200, 512, 1000, 0, 777, 64]      # slot 5 freed
    pos = torch.as_tensor([max(x - 1, 0) for x in lens], dtype=torch.int32,
                          device=dev)
    errs = {}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        q, kp, vp, tb = pool_case(rng, lens, h=h, hkv=hkv, d=d, ps=ps,
                                  width=width, dtype=dtype, dev=dev)
        got = pops.paged_attention_fwd(q, kp, vp, tb, pos)
        torch.cuda.synchronize()
        want = pops.paged_attention_ref(q, kp, vp, tb, pos)
        err = (got.float() - want.float()).abs().max().item()
        if not (torch.isfinite(got).all() and err <= tol
                and torch.equal(got[5], torch.zeros_like(got[5]))):
            raise AssertionError(f"K2 {dtype}: max |diff| {err} > {tol} "
                                 f"or non-finite / freed slot not zero")
        errs[dtype] = err
    log(f"[kernels] K2 paged decode: max |diff| {errs[torch.float32]:.3g} "
        f"(f32, bound 2e-5), {errs[torch.bfloat16]:.3g} (bf16, bound 1e-2 "
        f"= one bf16 rounding of O(1) outputs); NaN null page unread")
    # timed in bf16, the main path's type, at the serving mix's lengths
    # and at a uniform long table (8 slots of 1000 tokens)
    rows["paged_attention"] = dict(
        shape=f"B=8 H=32 Hkv=8 D=64 page 16, table 64, lens {lens}, bf16",
        max_abs_err=errs[torch.float32],
        **k2_timing(dev, flush, (q, kp, vp, tb), pos, lens, h, hkv, d, ps))
    long_lens = [1000] * 8
    lq, lkp, lvp, ltb = pool_case(np.random.default_rng(15), long_lens,
                                  h=h, hkv=hkv, d=d, ps=ps, width=width,
                                  dtype=torch.bfloat16, dev=dev)
    lpos = torch.full((8,), 999, dtype=torch.int32, device=dev)
    got = pops.paged_attention_fwd(lq, lkp, lvp, ltb, lpos)
    err = (got.float() - pops.paged_attention_ref(lq, lkp, lvp, ltb, lpos)
           .float()).abs().max().item()
    if not err <= 1e-2:
        raise AssertionError(f"K2 bf16 at 8 x 1000 tokens: max |diff| {err}")
    long = dict(shape="B=8 H=32 Hkv=8 D=64 page 16, table 64, 8 x 1000 "
                "tokens, bf16", max_abs_err_bf16=err,
                **k2_timing(dev, flush, (lq, lkp, lvp, ltb), lpos, long_lens,
                            h, hkv, d, ps))
    rows["paged_attention"]["long_table"] = long
    log(f"[kernels] K2 at {long['shape']}: {long['ms']:.4f} ms (device "
        f"{long['device_ms']:.4f}); SDPA {long['library_ms']:.4f} (device "
        f"{long['library_device_ms']:.4f}); bound {long['bound_ms']:.4f} ms "
        f"({long['bound_by']}); max |diff| {err:.3g} (bf16)")
    del lq, lkp, lvp, ltb

    # -- K3: prefill of one 512-token prompt -------------------------------
    # f32 (CUDA cores) within 2e-5; bf16 (tensor cores, bf16 operands)
    # within 1e-2 of the plain version; the ratio |diff| / (1e-2 + 1e-2
    # |want|) is printed beside it
    s = 512
    lens3 = torch.as_tensor([s], dtype=torch.int32, device=dev)
    ratio = {}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        q, kp, vp, tb = pool_case(rng, [s], h=h, hkv=hkv, d=d, ps=ps,
                                  width=width, dtype=dtype, dev=dev, s=s)
        got = pops.paged_prefill_fwd(q, kp, vp, tb, lens3, q_chunk=16)
        torch.cuda.synchronize()
        want = pops.paged_prefill_ref(q, kp, vp, tb, lens3, q_chunk=16)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        rtol = tol if dtype == torch.bfloat16 else 0.0
        ratio[dtype] = (diff / (tol + rtol * want.float().abs())).max().item()
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"K3 {dtype}: max |diff| {err} > {tol}")
        errs[dtype] = err
    log(f"[kernels] K3 paged prefill: max |diff| {errs[torch.float32]:.3g} "
        f"(f32, bound 2e-5), {errs[torch.bfloat16]:.3g} (bf16, bound "
        f"1e-2; worst |diff| / (1e-2 + 1e-2 |want|) = "
        f"{ratio[torch.bfloat16]:.3f})")
    kd, vd = sdpa_kv(kp, vp, tb, h, hkv, d)
    qd = q.transpose(1, 2).contiguous()
    kd, vd = kd[:, :, :s], vd[:, :, :s]
    nb = 2 * q.numel() * 2 + 2 * (s // ps) * ps * hkv * d * 2 + tb.numel() * 4
    bms, by = bound(nb, 4 * h * d * s * (s + 1) // 2, "bf16")

    def k3_lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True)

    rows["paged_prefill"] = dict(
        shape="B=1 S=512 H=32 Hkv=8 D=64 page 16, bf16",
        max_abs_err=errs[torch.float32],
        max_abs_err_bf16=errs[torch.bfloat16],
        bf16_tolerance_ratio=ratio[torch.bfloat16],
        ms=time_ms(lambda: pops.paged_prefill_fwd(q, kp, vp, tb, lens3),
                   50, flush),
        device_ms=device_ms(lambda: pops.paged_prefill_fwd(
            q, kp, vp, tb, lens3), 50, flush, "paged_prefill_mma_kernel"),
        plain_ms=time_ms(lambda: pops.paged_prefill_ref(q, kp, vp, tb,
                                                        lens3), 5, flush),
        library_ms=time_ms(k3_lib, 50, flush),
        library_device_ms=device_ms(k3_lib, 50, flush),
        bound_ms=bms, bound_by=by)

    # -- K4 and its backward: every resnet18 search weight shape ---------
    rows["mps_combine"], rows["mps_combine_bwd"] = phase_k4(dev, flush)
    # -- K5: the mamba2-780m prefill's inter-chunk scan, bitwise -----------
    rows["ssd_scan"] = phase_k5(dev, flush)
    # -- K5's backward: serving and training shapes, ddecay deterministic -
    rows["ssd_scan_bwd"] = phase_k5_bwd(dev, flush)
    for k, r in rows.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        if r.get("library_device_ms") is not None:
            lib += f" (device {r['library_device_ms']:.4f} ms)"
        log(f"[kernels] {k} at {r['shape']}: {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# the MoE archs' attention: llama4-scout's 40 query heads over 8 KV heads
# (G = 5) and arctic's 56 over 8 (G = 7), head dim 128 -- the first groups
# on the card that are not a power of two -- under scout's chunked window
# of 8192, with positions on both sides of a chunk boundary; path 6's
# table width (max_len 9216, pages of 16)
MOE_GROUPS = ((40, 8), (56, 8))
MOE_WINDOW, MOE_PS, MOE_WIDTH = 8192, 16, 576
MOE_K2_LENS = [8208, 8191, 8192, 8193, 100, 0, 1000, 5000]   # slot 5 freed
MOE_K3_LEN = 8320


def _chunk_keys(pos, window):
    """Keys a query at ``pos`` attends under a chunked window."""
    return pos - (pos // window) * window + 1


def _moe_pools(rng, lens, hkv, d, dtype, dev):
    """Pools of every slot's pages (NaN null page), tables of path 6's
    width, one set per dtype and shared by both head groups."""
    b = len(lens)
    n_pages = sum(-(-n // MOE_PS) for n in lens)
    k = torch.as_tensor(rng.normal(size=(n_pages + 1, MOE_PS, hkv, d)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(n_pages + 1, MOE_PS, hkv, d)),
                        dtype=torch.float32)
    k[0] = v[0] = float("nan")
    tables = np.zeros((b, MOE_WIDTH), np.int32)
    perm = rng.permutation(np.arange(1, n_pages + 1))
    idx = 0
    for bi, n in enumerate(lens):
        npg = -(-n // MOE_PS)
        tables[bi, :npg] = perm[idx:idx + npg]
        idx += npg
    return (k.to(dev, dtype), v.to(dev, dtype),
            torch.as_tensor(tables, device=dev))


def _sdpa_chunked(q, kp, vp, tb, hkv, d, q_pos):
    """SDPA on the gathered K/V, each KV head repeated over its group,
    masked causally within chunks of the window: the library's call for
    the same function.  q: (B, H, Sq, D); q_pos: (B, Sq)."""
    b, h = q.shape[:2]
    kd, vd = sdpa_kv(kp, vp, tb, h, hkv, d)
    key_pos = torch.arange(kd.shape[2], device=q.device)
    mask = (key_pos[None, None, :] <= q_pos[:, :, None]) & (
        key_pos[None, None, :] // MOE_WINDOW
        == q_pos[:, :, None] // MOE_WINDOW)
    mask = mask[:, None]                                   # (B, 1, Sq, T)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask)
    return lib


def phase_moe_attention(dev, flush):
    """K2 and K3 against their plain versions at the MoE archs' attention
    shapes (G = 5 and 7, D = 128, chunked window 8192 across a chunk
    boundary), f32 within 2e-5 and bf16 within 1e-2; each timed in bf16
    beside its plain version, SDPA on the gathered K/V and its bound.
    Returns ``{"paged_attention": [...], "paged_prefill": [...]}``, a row
    a group."""
    from repro_torch.kernels.paged_attention import ops as pops

    rng = np.random.default_rng(19)
    d, kw = 128, dict(window=MOE_WINDOW, chunked=True)
    pos = torch.as_tensor([max(n - 1, 0) for n in MOE_K2_LENS],
                          dtype=torch.int32, device=dev)
    out = {"paged_attention": {}, "paged_prefill": {}}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        kp, vp, tb = _moe_pools(rng, MOE_K2_LENS, 8, d, dtype, dev)
        kp3, vp3, tb3 = _moe_pools(rng, [MOE_K3_LEN], 8, d, dtype, dev)
        tb3 = tb3[:, :MOE_K3_LEN // MOE_PS].contiguous()
        lens3 = torch.as_tensor([MOE_K3_LEN], dtype=torch.int32, device=dev)
        for h, hkv in MOE_GROUPS:
            g = h // hkv
            q = torch.as_tensor(rng.normal(size=(len(MOE_K2_LENS), h, d)),
                                dtype=torch.float32).to(dev, dtype)
            got = pops.paged_attention_fwd(q, kp, vp, tb, pos, **kw)
            torch.cuda.synchronize()
            want = pops.paged_attention_ref(q, kp, vp, tb, pos, **kw)
            err2 = (got.float() - want.float()).abs().max().item()
            if not (torch.isfinite(got).all() and err2 <= tol and
                    torch.equal(got[5], torch.zeros_like(got[5]))):
                raise AssertionError(f"K2 G={g} {dtype}: max |diff| {err2} "
                                     f"> {tol}, non-finite or freed slot "
                                     f"not zero")
            q3 = torch.as_tensor(rng.normal(size=(1, MOE_K3_LEN, h, d)),
                                 dtype=torch.float32).to(dev, dtype)
            got3 = pops.paged_prefill_fwd(q3, kp3, vp3, tb3, lens3, **kw)
            torch.cuda.synchronize()
            want3 = pops.paged_prefill_ref(q3, kp3, vp3, tb3, lens3, **kw)
            err3 = (got3.float() - want3.float()).abs().max().item()
            if not (torch.isfinite(got3).all() and err3 <= tol):
                raise AssertionError(f"K3 G={g} {dtype}: max |diff| {err3} "
                                     f"> {tol}")
            log(f"[kernels] G={g} (H={h}, Hkv={hkv}, D={d}), chunked window "
                f"{MOE_WINDOW}, {dtype}: K2 at lens {MOE_K2_LENS} max |diff| "
                f"{err2:.3g}, K3 at S={MOE_K3_LEN} max |diff| {err3:.3g} "
                f"(bound {tol})")
            if dtype == torch.float32:
                out["paged_attention"][g] = dict(g=g, max_abs_err=err2)
                out["paged_prefill"][g] = dict(g=g, max_abs_err=err3)
                continue
            r2, r3 = out["paged_attention"][g], out["paged_prefill"][g]
            # K2: the live pages of each slot's chunk, read once
            keys = [_chunk_keys(int(p), MOE_WINDOW) if n else 0
                    for p, n in zip(pos.tolist(), MOE_K2_LENS)]
            pages = sum(-(-(p % MOE_WINDOW + 1) // MOE_PS) if n else 0
                        for p, n in zip(pos.tolist(), MOE_K2_LENS))
            nb = 2 * q.numel() * 2 + 2 * pages * MOE_PS * hkv * d * 2 + \
                tb.numel() * 4 + pos.numel() * 4
            bms, by = bound(nb, 4 * h * d * sum(keys), "bf16")
            lib2 = _sdpa_chunked(q[:, :, None, :], kp, vp, tb, hkv, d,
                                 pos.long()[:, None])
            r2.update(
                shape=f"B=8 H={h} Hkv={hkv} D={d} page {MOE_PS}, table "
                f"{MOE_WIDTH}, lens {MOE_K2_LENS}, chunked {MOE_WINDOW}, "
                f"bf16", max_abs_err_bf16=err2,
                ms=time_ms(lambda: pops.paged_attention_fwd(
                    q, kp, vp, tb, pos, **kw), 30, flush),
                device_ms=device_ms(lambda: pops.paged_attention_fwd(
                    q, kp, vp, tb, pos, **kw), 30, flush, "paged_decode"),
                plain_ms=time_ms(lambda: pops.paged_attention_ref(
                    q, kp, vp, tb, pos, **kw), 2, flush),
                library_ms=time_ms(lib2, 30, flush),
                library_device_ms=device_ms(lib2, 30, flush, names=False),
                bound_ms=bms, bound_by=by)
            # K3: one prompt crossing the boundary; each query attends the
            # keys of its chunk up to itself
            qk = sum(_chunk_keys(p, MOE_WINDOW) for p in range(MOE_K3_LEN))
            nb = 2 * q3.numel() * 2 + 2 * MOE_K3_LEN * hkv * d * 2 + \
                tb3.numel() * 4
            bms, by = bound(nb, 4 * h * d * qk, "bf16")
            lib3 = _sdpa_chunked(
                q3.transpose(1, 2).contiguous(), kp3, vp3, tb3, hkv, d,
                torch.arange(MOE_K3_LEN, device=dev)[None])
            r3.update(
                shape=f"B=1 S={MOE_K3_LEN} H={h} Hkv={hkv} D={d} page "
                f"{MOE_PS}, chunked {MOE_WINDOW}, bf16", max_abs_err_bf16=err3,
                ms=time_ms(lambda: pops.paged_prefill_fwd(
                    q3, kp3, vp3, tb3, lens3, **kw), 10, flush),
                device_ms=device_ms(lambda: pops.paged_prefill_fwd(
                    q3, kp3, vp3, tb3, lens3, **kw), 10, flush,
                    "paged_prefill_mma_kernel"),
                plain_ms=time_ms(lambda: pops.paged_prefill_ref(
                    q3, kp3, vp3, tb3, lens3, **kw), 1, flush),
                library_ms=time_ms(lib3, 10, flush),
                library_device_ms=device_ms(lib3, 10, flush, names=False),
                bound_ms=bms, bound_by=by)
            for name, r in (("K2", r2), ("K3", r3)):
                log(f"[kernels] {name} at {r['shape']}: {r['ms']:.4f} ms "
                    f"(device {r['device_ms']:.4f}), plain "
                    f"{r['plain_ms']:.2f} ms, SDPA {r['library_ms']:.4f} "
                    f"(device {r['library_device_ms']:.4f}), bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        del kp, vp, kp3, vp3
    torch.cuda.empty_cache()
    return {k: list(v.values()) for k, v in out.items()}


def moe_k1_cases():
    """(M, K, N, bits) of path 6's K1 calls: for each MoE arch at its cut,
    every precision group of every plan group (the seed-0 synthetic plan
    path 6 binds, drawn here over the meta-device tree: it depends on
    the shapes only) and each projection at its full width in 8/4/2
    bits, at the decode M (the slot count) and the longest padded
    prompt."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import engine

    cases = set()
    for arch, n_layers, _, slots, lens, _, _ in MOE_PATHS:
        cfg = dataclasses.replace(registry.get(arch), n_layers=n_layers,
                                  param_dtype="bfloat16")
        meta = lm.init_params(cfg, device="meta")
        groups = lm.serve_weight_groups(cfg, meta)
        plan = engine.synthetic_plan(cfg, meta, bits=None, seed=0)
        prefill_m = -(-max(lens) // 16) * 16
        for grp, w in groups.items():
            n_full, kk = w.shape
            cb = np.asarray(plan.channel_bits[grp])
            widths = [(int((cb == b).sum()), b) for b in (8, 4, 2)]
            widths += [(n_full, b) for b in (8, 4, 2)]
            for m in (slots, prefill_m):
                cases.update((m, kk, n, b) for n, b in widths if n)
    return sorted(cases)


def _k1_bitwise(dev, cases, seed, where):
    """K1 on seeded int8 inputs at each (M, K, N, bits) of ``cases``,
    held bitwise against its int32-exact plain version.  Returns the max
    |diff| (0 unless it raised)."""
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref

    g = torch.Generator(device=dev).manual_seed(seed)
    sx = torch.ones((), device=dev)
    err = 0.0
    for m, kk, n, bits in cases:
        qmax = 2 ** (bits - 1) - 1
        xq = torch.randint(-127, 128, (m, kk), generator=g, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-qmax - 1, qmax + 1, (n, kk), generator=g,
                           device=dev, dtype=torch.int8)
        sw = torch.rand(n, generator=g, device=dev) * 1e-3
        got = qops.quant_matmul(xq, qref.pack_weights(wq, bits), sw, sx,
                                w_bits=bits)
        torch.cuda.synchronize()
        want = qref.quant_matmul_ref(xq, wq, sw, sx)
        diff = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 not bitwise at {where} shape M={m} "
                                 f"K={kk} N={n} bits={bits}: max |diff| "
                                 f"{diff}")
        err = max(err, diff)
        del xq, wq, got, want
    return err


def phase_moe_k1(dev):
    """K1 bitwise against its int32-exact plain version at path 6's shapes
    (:func:`moe_k1_cases`): llama4-scout's K = 5120 / 8192 and arctic's
    K = 7168 / 4864, decode and prefill.  Returns the max |diff| and the
    number of cases."""
    cases = moe_k1_cases()
    err = _k1_bitwise(dev, cases, 6, "MoE")
    ms = sorted({c[0] for c in cases})
    ks = sorted({c[1] for c in cases})
    log(f"[kernels] K1 quant_matmul at path 6's shapes: bitwise equal to "
        f"the int32 plain version in {len(cases)} cases, M in {ms}, K in "
        f"{ks}, N from {min(c[2] for c in cases)} to "
        f"{max(c[2] for c in cases)} (every precision group of the "
        f"scout / arctic synthetic plans and the full widths), bits 8/4/2")
    return dict(moe_cases=len(cases), moe_max_abs_err=err)


# gemma2-2b's attention: 8 query heads over 4 KV heads of 256, a sliding
# window of 4096 and the score softcap 50; queries scaled so that the cap
# bites (scores of tens, where tanh bends)
CAP_SHAPE = dict(h=8, hkv=4, d=256, ps=16, cap=50.0, window=4096, q_scale=40.0)
CAP_K2_LENS = [1, 100, 4095, 4096, 4097, 0, 5000, 300]   # slot 5 freed
CAP_K3_LEN = 4160


def phase_softcap_attention(dev):
    """K2 and K3 with the attention softcap against their plain versions
    (which compute the capped scores as ``attention.softcap`` does on the
    card), f32 within 2e-5 and bf16 within 1e-2, at gemma2-2b's attention
    shape with slots and a prompt across the window's edge.  Returns
    ``{"paged_attention": err, "paged_prefill": err}`` (f32)."""
    from repro_torch.kernels.paged_attention import ops as pops

    c = CAP_SHAPE
    kw = dict(window=c["window"], cap=c["cap"])
    rng = np.random.default_rng(50)
    pos = torch.as_tensor([max(n - 1, 0) for n in CAP_K2_LENS],
                          dtype=torch.int32, device=dev)
    width = -(-max(CAP_K2_LENS) // c["ps"])
    lens3 = torch.as_tensor([CAP_K3_LEN], dtype=torch.int32, device=dev)
    out, msg = {}, []
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        q, kp, vp, tb = pool_case(rng, CAP_K2_LENS, h=c["h"], hkv=c["hkv"],
                                  d=c["d"], ps=c["ps"], width=width,
                                  dtype=dtype, dev=dev)
        q = (q.float() * c["q_scale"]).to(dtype)
        got = pops.paged_attention_fwd(q, kp, vp, tb, pos, **kw)
        torch.cuda.synchronize()
        want = pops.paged_attention_ref(q, kp, vp, tb, pos, **kw)
        err2 = (got.float() - want.float()).abs().max().item()
        if not (torch.isfinite(got).all() and err2 <= tol and
                torch.equal(got[5], torch.zeros_like(got[5]))):
            raise AssertionError(f"K2 capped {dtype}: max |diff| {err2} > "
                                 f"{tol}, non-finite or freed slot not zero")
        del q, kp, vp, tb
        q3, kp3, vp3, tb3 = pool_case(
            rng, [CAP_K3_LEN], h=c["h"], hkv=c["hkv"], d=c["d"], ps=c["ps"],
            width=CAP_K3_LEN // c["ps"], dtype=dtype, dev=dev, s=CAP_K3_LEN)
        q3 = (q3.float() * c["q_scale"]).to(dtype)
        got3 = pops.paged_prefill_fwd(q3, kp3, vp3, tb3, lens3, **kw)
        torch.cuda.synchronize()
        want3 = pops.paged_prefill_ref(q3, kp3, vp3, tb3, lens3, **kw)
        err3 = (got3.float() - want3.float()).abs().max().item()
        if not (torch.isfinite(got3).all() and err3 <= tol):
            raise AssertionError(f"K3 capped {dtype}: max |diff| {err3} > "
                                 f"{tol}")
        del q3, kp3, vp3, tb3
        msg.append(f"{dtype}: K2 {err2:.3g}, K3 {err3:.3g} (bound {tol})")
        if dtype == torch.float32:
            out = {"paged_attention": err2, "paged_prefill": err3}
    torch.cuda.empty_cache()
    log(f"[kernels] K2 / K3 with softcap {c['cap']} at H={c['h']} "
        f"Hkv={c['hkv']} D={c['d']}, window {c['window']}, queries x "
        f"{c['q_scale']}, K2 lens {CAP_K2_LENS}, K3 S={CAP_K3_LEN}: max "
        f"|diff| " + "; ".join(msg))
    return out


# decode shapes timed (M = 8): llama3.2-1b's widest projection at each
# width; mamba2-780m's in_z / in_x, in_b / in_c and out_proj, 4-bit
K1_DECODE = (("llama", 2048, 8192, 8), ("llama", 2048, 8192, 2),
             ("mamba", 1536, 3072, 4), ("mamba", 1536, 128, 4),
             ("mamba", 3072, 1536, 4))


def phase_k1_decode(dev, flush, g, shapes=K1_DECODE):
    """K1's decode layout at M = 8 beside bf16 ``torch.matmul`` on the
    dequantized weight, with its byte bound; bitwise first.  Returns one
    dict per (label, K, N, bits) of ``shapes``."""
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref

    out = []
    m = 8
    for label, kk, n, bits in shapes:
        qmax = 2 ** (bits - 1) - 1
        xq = torch.randint(-127, 128, (m, kk), generator=g, device=dev,
                           dtype=torch.int8)
        sw = torch.rand(n, generator=g, device=dev) * 1e-3
        sx = torch.ones((), device=dev)
        copies = []
        for _ in range(4):
            wq = torch.randint(-qmax - 1, qmax + 1, (n, kk), generator=g,
                               device=dev, dtype=torch.int8)
            copies.append((qref.pack_weights(wq, bits),
                           wq.to(torch.bfloat16)
                           * sw[:, None].to(torch.bfloat16)))
            if not torch.equal(qops.quant_matmul(xq, copies[-1][0], sw, sx,
                                                 w_bits=bits),
                               qref.quant_matmul_ref(xq, wq, sw, sx)):
                raise AssertionError(f"K1 decode not bitwise at M={m} "
                                     f"K={kk} N={n} bits={bits}")
        xb = xq.to(torch.bfloat16)
        it = iter(range(10 ** 9))

        def kern():
            return qops.quant_matmul(xq, copies[next(it) % 4][0], sw, sx,
                                     w_bits=bits)

        def mm():
            return torch.matmul(xb, copies[next(it) % 4][1].T)

        bms, by = bound(m * kk + n * kk * bits // 8 + n * 4 + 4 + m * n * 4,
                        2 * m * n * kk, "int8")
        r = dict(shape=f"{label} M={m} K={kk} N={n} {bits}-bit",
                 ms=time_ms(kern, 20, flush),
                 device_ms=device_ms(kern, 20, flush, "qmv"),
                 library_ms=time_ms(mm, 20, flush),
                 library_device_ms=device_ms(mm, 20, flush),
                 bound_ms=bms, bound_by=by)
        out.append(r)
        log(f"[kernels] K1 decode at {r['shape']}: {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f}); bf16 torch.matmul {r['library_ms']:.4f}"
            f" (device {r['library_device_ms']:.4f}); bound {bms:.4f} ms "
            f"({by})")
        del xq, xb, copies
    return out


def phase_k1_prefill(dev, flush, g, shapes=K1_PREFILL, widths=(4, 8)):
    """K1's tiles at the serving paths' prefill shapes (``shapes``: label,
    M, K, N), at each bit width of ``widths``, each beside two yardsticks
    on the same operands: bf16 ``torch.matmul`` on the dequantized weight
    and ``torch._int_mm`` (int8 through cuBLASLt) on the unpacked int8
    weight.  Event and profiler device times for all three.  Returns one
    dict per (shape, bits)."""
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref

    out = []
    for label, m, kk, n in shapes:
        for bits in widths:
            qmax = 2 ** (bits - 1) - 1
            xq = torch.randint(-127, 128, (m, kk), generator=g, device=dev,
                               dtype=torch.int8)
            wq = torch.randint(-qmax - 1, qmax + 1, (n, kk), generator=g,
                               device=dev, dtype=torch.int8)
            wp = qref.pack_weights(wq, bits)
            sw = torch.rand(n, generator=g, device=dev) * 1e-3
            sx = torch.ones((), device=dev)
            xb = xq.to(torch.bfloat16)
            deq = (wq.to(torch.bfloat16) * sw[:, None].to(torch.bfloat16))
            wt = wq.t()                 # (K, N) column-major, as cuBLASLt

            def kern():
                return qops.quant_matmul(xq, wp, sw, sx, w_bits=bits)

            def mm():
                return torch.matmul(xb, deq.T)

            def int_mm():
                return torch._int_mm(xq, wt)

            if not torch.equal(int_mm(), (xq.double() @ wq.double().T)
                               .to(torch.int32)):
                raise AssertionError("torch._int_mm yardstick disagrees")
            bms, by = bound(m * kk + n * kk * bits // 8 + n * 4 + 4
                            + m * n * 4, 2 * m * n * kk, "int8")
            r = dict(shape=f"{label} M={m} K={kk} N={n} {bits}-bit",
                     ms=time_ms(kern, 20, flush),
                     device_ms=device_ms(kern, 20, flush, "qmm_kernel"),
                     library_ms=time_ms(mm, 20, flush),
                     library_device_ms=device_ms(mm, 20, flush),
                     int_mm_ms=time_ms(int_mm, 20, flush),
                     int_mm_device_ms=device_ms(int_mm, 20, flush),
                     bound_ms=bms, bound_by=by)
            out.append(r)
            log(f"[kernels] K1 tiles at {r['shape']}: {r['ms']:.4f} ms "
                f"(device {r['device_ms']:.4f}); bf16 torch.matmul "
                f"{r['library_ms']:.4f} (device "
                f"{r['library_device_ms']:.4f}); torch._int_mm "
                f"{r['int_mm_ms']:.4f} (device {r['int_mm_device_ms']:.4f})"
                f"; bound {bms:.4f} ms ({by})")
            del xq, wq, wp, xb, deq, wt
    return out


K4_PW = (0, 2, 4, 8)


def k4_shapes():
    """Each distinct (C_out, C_in * kh * kw) of resnet18's 21 weight
    nodes, the shapes the search hands K4, with its count of nodes."""
    from repro_torch.models import cnn
    g = cnn.resnet18()
    ch, _ = cnn._trace_shapes(g)
    shapes = {}
    for n in g.weight_nodes():
        k = ch[n.inputs[0]] * (n.k[0] * n.k[1] if n.kind == "conv" else 1)
        shapes[(n.cout, k)] = shapes.get((n.cout, k), 0) + 1
    return shapes


# ragged (K % 4 != 0) and rows too long for two ring stages (the simple
# kernels' cases beside the misaligned views), and problems large enough
# for the ring whose tiles hold 8, 4 and 2 rows, the last one short
K4_EXTRA = ((5, 61), (3, 60000), (40, 60000), (37501, 64), (9377, 256),
            (4689, 512))


def _k4_inputs(g, dev, m, k, view=False):
    w = torch.randn(m, k, generator=g, device=dev) * 0.05
    up = torch.randn(m, k, generator=g, device=dev)
    if view:        # storage off a 16-byte boundary
        w, up = (torch.cat([torch.zeros(1, device=dev),
                            t.reshape(-1)])[1:].view(m, k) for t in (w, up))
    w[0, :3] = 0.0
    probs = torch.softmax(torch.randn(m, len(K4_PW), generator=g,
                                      device=dev), -1)
    return w, probs, up


def _k4_dprobs_check(w, probs, up, dprobs, where, absmax=None):
    """dprobs within the summation bound 2 K 2^-24 sum_k |g q| of a
    float64 row sum of the plain version's products (each row's scale
    from ``absmax`` when given)."""
    from repro_torch.kernels.mps_combine import ops as mops
    k = w.shape[1]
    for p in range(len(K4_PW)):
        onehot = torch.zeros_like(probs)
        onehot[:, p] = 1.0
        prod = (up * mops.mps_combine_ref(w, onehot, K4_PW,
                                          absmax)).double()
        err = (dprobs[:, p].double() - prod.sum(1)).abs()
        bound = 2 * k * 2.0 ** -24 * prod.abs().sum(1)
        if not bool((err <= bound).all()):
            raise AssertionError(f"K4 backward dprobs[:, {p}] outside the "
                                 f"summation bound at {where}: "
                                 f"{float((err - bound).max())}")


def _k4_check(w, probs, up):
    """Both kernels against their plain versions: the forward and its
    absmax bit for bit, dW bit for bit, dprobs within the summation bound
    2 K 2^-24 sum_k |g q| of a float64 row sum of the plain version's
    products.  Returns the max |diff| of the forward, dW and dprobs."""
    from repro_torch.kernels.mps_combine import ops as mops
    m, k = w.shape
    absmax = torch.empty(m, device=w.device)
    got = mops.mps_combine_fwd(w, probs, K4_PW, absmax)
    dw, dprobs = mops.mps_combine_bwd(w, probs, absmax, up, K4_PW)
    torch.cuda.synchronize()
    want = mops.mps_combine_ref(w, probs, K4_PW)
    want_dw, want_dp = mops._vjp_bwd(w, probs, K4_PW, up)
    where = f"{m}x{k}{' (misaligned views)' if w.data_ptr() % 16 else ''}"
    if not torch.equal(got, want) or not torch.equal(
            absmax, torch.amax(w.abs(), 1)):
        raise AssertionError(f"K4 forward not bitwise at {where}: max "
                             f"|diff| {(got - want).abs().max().item()}")
    if not torch.equal(dw, want_dw):
        raise AssertionError(f"K4 backward dW not bitwise at {where}: max "
                             f"|diff| {(dw - want_dw).abs().max().item()}")
    _k4_dprobs_check(w, probs, up, dprobs, where)
    return ((got - want).abs().max().item(),
            (dw - want_dw).abs().max().item(),
            (dprobs - want_dp).abs().max().item())


def k4_probe(dev, m, k):
    """One launch of the stamped forward (``mps_combine_probe``): clock64
    cycles per tile from load issued to landed, landed to combined (the
    block's row groups met), combined to stored (the stamped kernel waits
    for its bulk store to complete), and the blocks' spans."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mps_combine import ops as mops
    g = torch.Generator(device=dev).manual_seed(44)
    w, probs, _ = _k4_inputs(g, dev, m, k)
    out = torch.empty_like(w)
    stamps = torch.zeros(4 + 4 * m, dtype=torch.int64, device=dev)
    probe = build.symbol("mps_combine", "mps_combine_probe")
    build.check(probe(w.data_ptr(), probs.data_ptr(), out.data_ptr(), 0, m,
                      k, len(K4_PW), mops._packed(K4_PW), stamps.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream),
                "mps_combine_probe")
    torch.cuda.synchronize()
    if not torch.equal(out, mops.mps_combine_ref(w, probs, K4_PW)):
        raise AssertionError("K4 probe's output not bitwise")
    st = stamps.cpu()
    grid, r, stages, gw = (int(v) for v in st[:4])
    t = st[4:].view(-1, 4)[:-(-m // r)].double()
    phase = {"load": t[:, 1] - t[:, 0], "combine": t[:, 2] - t[:, 1],
             "store": t[:, 3] - t[:, 2]}
    blocks = torch.arange(t.shape[0]) % grid
    span = [float(t[blocks == b, 3].max() - t[blocks == b, 0].min())
            for b in range(grid)]
    split = {k2: float(v.mean()) for k2, v in phase.items()}
    log(f"[kernels] K4 probe at {m}x{k}, pw {K4_PW}: grid {grid}, {r} "
        f"row(s) a tile, {stages} stages, {gw} warps a row; mean cycles a "
        f"tile: load {split['load']:.0f}, combine {split['combine']:.0f}, "
        f"store {split['store']:.0f}; block span mean {np.mean(span):.0f}"
        f", max {max(span):.0f} cycles (clock64)")
    return dict(split, block_span_mean=float(np.mean(span)),
                block_span_max=max(span), grid=grid, rows_a_tile=r,
                stages=stages, warps_a_row=gw)


def k4_lm_shapes(arch):
    """(C_out, K) of ``arch``'s block projections that reach K4 -- the
    rows it takes from each (K, C_out) weight in a train step -- with
    their count over the super-blocks, read from ``init_params``' tree on
    the meta device, an enc-dec encoder's included (llama3.2-1b: 112 in
    all; mamba2-780m: 288; seamless-m4t-medium: 168).  A cross attention's
    projections carry gammas but take the raw weights, as in the
    reference, so they never reach K4: the cross groups ``lm``'s plan
    names are taken out."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = registry.get(arch)
    tree = lm.init_params(cfg, device="meta", mps_on=True)
    shapes = {}
    for node in lm._gamma_nodes(tree):
        nsb, k, n = node["w"].shape
        shapes[(n, k)] = shapes.get((n, k), 0) + nsb
    for layer, sub, name in lm._plan_weights(cfg):
        if sub == "cross":
            nsb, k, n = tree["blocks"][layer][sub][name]["w"].shape
            shapes[(n, k)] -= nsb
    return {mk: c for mk, c in shapes.items() if c}


def _k4_route_check(g, dev, m, k):
    """K4 through the LM's channel-last route (``core.mps.kernel_combine``
    with ``channel_axis=1``) from a (K, C_out) weight, with autograd: the
    effective weight and dW bitwise against the plain versions on the
    rows, dprobs within its summation bound.  Returns the max |diff| of
    the forward and dW."""
    from repro_torch.core import mps
    from repro_torch.kernels.mps_combine import ops as mops
    w, probs, up = _k4_inputs(g, dev, m, k)
    w_kn = w.T.contiguous().requires_grad_()
    p = probs.clone().requires_grad_()
    out = mps.kernel_combine(w_kn, p, K4_PW, channel_axis=1)
    out.backward(up.T.contiguous())
    torch.cuda.synchronize()
    want = mops.mps_combine_ref(w, probs, K4_PW)
    want_dw, _ = mops._vjp_bwd(w, probs, K4_PW, up)
    where = f"{k}x{m} (K, C_out) through kernel_combine"
    if out.shape != (k, m) or not torch.equal(out.detach().T, want):
        raise AssertionError(f"K4 route forward not bitwise at {where}")
    if not torch.equal(w_kn.grad.T, want_dw):
        raise AssertionError(f"K4 route dW not bitwise at {where}")
    _k4_dprobs_check(w, probs, up, p.grad, where)
    return ((out.detach().T - want).abs().max().item(),
            (w_kn.grad.T - want_dw).abs().max().item())


def phase_k4_lm(dev, flush, g, arch):
    """K4 at ``arch``'s projection shapes: checked directly and through
    the channel-last route, timed as the search shapes are, with the
    device time of the transposing copy of a (K, C_out) f32 weight into
    rows (the route's copy of W in the forward, of the upstream gradient
    in the backward), summed over one train step's projections with
    remat: two forward launches and two W copies a projection (the
    recompute), one backward launch and one gradient copy."""
    shapes = k4_lm_shapes(arch)
    n_proj = sum(shapes.values())
    errs = [0.0, 0.0]
    for m, k in shapes:
        e = _k4_check(*_k4_inputs(g, dev, m, k))
        r = _k4_route_check(g, dev, m, k)
        errs = [max(errs[0], e[0], r[0]), max(errs[1], e[1], r[1])]
    log(f"[kernels] K4 at {arch}'s projections {list(shapes)} "
        f"(rows x K), pw {K4_PW}: direct and through the channel-last route "
        f"from (K, C_out) weights, forward and dW bitwise, dprobs within "
        f"the summation bound")
    per, tot = {}, dict.fromkeys(K4_SUMS + ("copy",), 0.0)
    for (m, k), n in shapes.items():
        r = _k4_time(dev, flush, g, m, k)
        w_kn = torch.randn(k, m, generator=g, device=dev)
        r["copy"] = device_ms(lambda: torch.movedim(w_kn, 1, 0).contiguous(),
                              30, flush, names=False)
        r["copy_bound"] = bound(2 * m * k * 4, 0, "f32")[0]
        per[f"{m}x{k}"] = dict(r, projections=n)
        for key in tot:
            # remat: the forward and its W copy run twice a step
            rep = 3 if key == "copy" else 2 if key.startswith("fwd") else 1
            tot[key] += n * rep * r[key]
        _k4_log(m, k, f"{n} projections a train step", r)
        log(f"[kernels] K4 {m}x{k}: the transposing copy of the (K, C_out) "
            f"weight into rows {r['copy']:.4f} ms device (bound "
            f"{r['copy_bound']:.4f}, bytes)")
    log(f"[kernels] K4 one {arch} train step ({n_proj} projections, remat: "
        f"2 forward + 1 backward launches and 3 transposing copies each; "
        f"ms): forward {tot['fwd']:.4f} device / {tot['fwd_ms']:.4f} events, "
        f"plain {tot['fwd_plain']:.4f}, bound {tot['fwd_bound']:.4f}; "
        f"backward {tot['bwd']:.4f} device / {tot['bwd_ms']:.4f} events, "
        f"plain _vjp_bwd {tot['bwd_plain']:.4f}, bound "
        f"{tot['bwd_bound']:.4f}; copies {tot['copy']:.4f} device")
    return dict(shapes=per, train_step=tot, max_abs_err=errs[0],
                dw_max_abs_err=errs[1])


K4_SUMS = ("fwd", "bwd", "fwd_ms", "bwd_ms", "fwd_plain", "bwd_plain",
           "fwd_bound", "bwd_bound")


def _k4_time(dev, flush, g, m, k):
    """Both K4 kernels at one (rows, K) shape, launched through their C
    entry points as the wrappers launch them: device ms (profiler) and
    event ms, the kernel each took, their plain versions' device ms, the
    byte / operation bounds, and where the ring runs the simple kernels
    beside it."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mps_combine import ops as mops
    fwd_c = build.load("mps_combine")
    bwd_c = build.symbol("mps_combine", "mps_combine_bwd_launch")
    packed, n_p = mops._packed(K4_PW), len(K4_PW)
    n_nz = sum(1 for b in K4_PW if b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    copies = [_k4_inputs(g, dev, m, k) for _ in range(4)]
    it = iter(range(10 ** 9))

    def pick():
        return copies[next(it) % len(copies)]

    absmax = torch.amax(copies[0][0].abs(), 1)
    outs = (torch.empty(m, k, device=dev), torch.empty(m, n_p, device=dev))

    def fwd():
        w, probs, _ = pick()
        build.check(fwd_c(w.data_ptr(), probs.data_ptr(),
                          outs[0].data_ptr(), absmax.data_ptr(), m, k,
                          n_p, packed, stream), "mps_combine")

    def bwd():
        w, probs, up = pick()
        build.check(bwd_c(w.data_ptr(), up.data_ptr(), probs.data_ptr(),
                          absmax.data_ptr(), outs[0].data_ptr(),
                          outs[1].data_ptr(), m, k, n_p, packed,
                          stream), "mps_combine_bwd")

    def fwd_plain():
        w, probs, _ = pick()
        mops.mps_combine_ref(w, probs, K4_PW)

    def bwd_plain():
        w, probs, up = pick()
        mops._vjp_bwd(w, probs, K4_PW, up)

    def kind():     # the kernel the last device_ms timed
        return "ring" if any("mps_ring" in n for n in device_ms.names) \
            else "simple"

    fb, fby = bound(2 * m * k * 4 + m * n_p * 4 + m * 4,
                    7 * m * k * n_nz, "f32")
    # per element and nonzero precision: the forward's seven, the mask's
    # two compares, dW's multiply-multiply-add, dprobs' multiply-add
    bb, bby = bound(3 * m * k * 4 + 2 * m * n_p * 4 + m * 4,
                    14 * m * k * n_nz, "f32")
    r = dict(fwd=device_ms(fwd, 30, flush, "mps_"))
    r["fwd_kernel"] = kind()
    r["bwd"] = device_ms(bwd, 30, flush, "mps_")
    r["bwd_kernel"] = kind()
    r.update(fwd_ms=time_ms(fwd, 30, flush),
             bwd_ms=time_ms(bwd, 30, flush),
             fwd_plain=device_ms(fwd_plain, 10, flush, names=False),
             bwd_plain=device_ms(bwd_plain, 10, flush, names=False),
             fwd_bound=fb, bwd_bound=bb, bound_by=(fby, bby))
    if "ring" in (r["fwd_kernel"], r["bwd_kernel"]):
        # the simple kernels at the same shape: views off a 16-byte
        # boundary take them
        wv, pv, uv = _k4_inputs(g, dev, m, k, view=True)
        av = torch.amax(wv.abs(), 1)
        r["simple"] = (
            device_ms(lambda: mops.mps_combine_fwd(wv, pv, K4_PW, av),
                      30, flush, "mps_"),
            device_ms(lambda: mops.mps_combine_bwd(wv, pv, av, uv, K4_PW),
                      30, flush, "mps_"))
    return r


def _k4_log(m, k, what, r):
    simple = (f"; the simple kernels {r['simple'][0]:.4f} / "
              f"{r['simple'][1]:.4f}" if "simple" in r else "")
    log(f"[kernels] K4 {m}x{k} ({what}): forward {r['fwd']:.4f} ms device, "
        f"{r['fwd_kernel']} kernel ({r['fwd_ms']:.4f} events), plain "
        f"{r['fwd_plain']:.4f}, bound {r['fwd_bound']:.4f} "
        f"({r['bound_by'][0]}); backward {r['bwd']:.4f} device, "
        f"{r['bwd_kernel']} kernel ({r['bwd_ms']:.4f} events), plain "
        f"_vjp_bwd {r['bwd_plain']:.4f}, bound {r['bwd_bound']:.4f} "
        f"({r['bound_by'][1]}){simple}")


def phase_k4(dev, flush):
    """K4's forward and backward kernels: checked at every resnet18 search
    shape, ragged, long-row, ring-sized and misaligned; timed at every
    search shape beside their plain versions and byte bounds, summed over
    one search step's nodes, the kernel each launch took named, and where
    the ring takes a shape the simple kernels beside it; the stamped
    probe's phase split."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mps_combine import ops as mops

    g = torch.Generator(device=dev).manual_seed(4)
    shapes = k4_shapes()
    fwd_err = dw_err = dp_err = grad_err = 0.0
    for (m, k), view in [(s, False) for s in list(shapes) + list(K4_EXTRA)] \
            + [((64, 576), True)]:
        e1, e2, e3 = _k4_check(*_k4_inputs(g, dev, m, k, view))
        fwd_err, dw_err, dp_err = (max(fwd_err, e1), max(dw_err, e2),
                                   max(dp_err, e3))
    for m, k in shapes:     # the autograd function against autograd
        w, probs, up = _k4_inputs(g, dev, m, k)
        wk, pk = w.clone().requires_grad_(), probs.clone().requires_grad_()
        (mops.mps_combine(wk, pk, K4_PW) * up).sum().backward()
        wr, pr = w.clone().requires_grad_(), probs.clone().requires_grad_()
        (mops.mps_combine_ref(wr, pr, K4_PW) * up).sum().backward()
        for a, b in ((wk.grad, wr.grad), (pk.grad, pr.grad)):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * b.abs().max().item())
            grad_err = max(grad_err, (a - b).abs().max().item())
    log(f"[kernels] K4 mps_combine (forward) and mps_combine_bwd: forward, "
        f"absmax and dW bitwise, dprobs within the summation bound, at every "
        f"resnet18 weight shape {list(shapes)}, at {list(K4_EXTRA)} and "
        f"misaligned views, pw {K4_PW}; the autograd function within rtol "
        f"1e-4 of autograd through the plain version (max |diff| "
        f"{grad_err:.3g})")

    per, tot = {}, dict.fromkeys(K4_SUMS, 0.0)
    for (m, k), nodes in shapes.items():
        r = dict(_k4_time(dev, flush, g, m, k), nodes=nodes)
        per[(m, k)] = r
        for key in tot:
            tot[key] += nodes * r[key]
        _k4_log(m, k, f"{nodes} node(s)", r)
    n_nodes = sum(shapes.values())
    log(f"[kernels] K4 one search step ({n_nodes} nodes, node-weighted sums, "
        f"ms): forward {tot['fwd']:.4f} device / {tot['fwd_ms']:.4f} events, "
        f"plain {tot['fwd_plain']:.4f}, bound {tot['fwd_bound']:.4f}; "
        f"backward {tot['bwd']:.4f} device / {tot['bwd_ms']:.4f} events, "
        f"plain _vjp_bwd {tot['bwd_plain']:.4f}, bound "
        f"{tot['bwd_bound']:.4f}")
    probe = k4_probe(dev, 512, 4608)
    lm_k4 = phase_k4_lm(dev, flush, g, "llama3.2-1b")
    mamba_k4 = phase_k4_lm(dev, flush, g, "mamba2-780m")
    seamless_k4 = phase_k4_lm(dev, flush, g, "seamless-m4t-medium")

    m, k = max(shapes, key=lambda s: s[0] * s[1])     # 512 x 4608
    r = per[(m, k)]
    common = dict(library_ms=None, steps_sum_nodes=n_nodes,
                  shape=f"{m}x{k} f32, pw {K4_PW}",
                  kernels_by_shape={f"{a}x{b}": (v["fwd_kernel"],
                                                 v["bwd_kernel"])
                                    for (a, b), v in per.items()})
    fwd_row = dict(common, kernel_taken=r["fwd_kernel"],
                   max_abs_err=fwd_err, ms=r["fwd_ms"], device_ms=r["fwd"],
                   simple_device_ms=r.get("simple", (None,))[0],
                   plain_ms=r["fwd_plain"], bound_ms=r["fwd_bound"],
                   bound_by=r["bound_by"][0], backward_max_abs_diff=grad_err,
                   step_device_ms=tot["fwd"], step_ms=tot["fwd_ms"],
                   step_plain_ms=tot["fwd_plain"],
                   step_bound_ms=tot["fwd_bound"], probe=probe,
                   lm=lm_k4, lm_mamba=mamba_k4, lm_seamless=seamless_k4)
    bwd_row = dict(common, kernel_taken=r["bwd_kernel"],
                   max_abs_err=dp_err, dw_max_abs_err=dw_err, ms=r["bwd_ms"],
                   device_ms=r["bwd"],
                   simple_device_ms=r.get("simple", (None, None))[1],
                   plain_ms=r["bwd_plain"], bound_ms=r["bwd_bound"],
                   bound_by=r["bound_by"][1],
                   step_device_ms=tot["bwd"], step_ms=tot["bwd_ms"],
                   step_plain_ms=tot["bwd_plain"],
                   step_bound_ms=tot["bwd_bound"])
    return fwd_row, bwd_row


K5_SHAPE = (48, 64, 128)      # mamba2-780m: heads, head_dim, state


def phase_k5(dev, flush, shape=K5_SHAPE, checked=(1, 2, 8, 509), c=8):
    """K5 bitwise against its plain version at (C, H, P, N) for each C of
    ``checked``, s0 zero and random, then timed at ``c`` chunks beside
    the plain version and its byte bound."""
    from repro_torch.kernels.ssd_scan import ops as sops

    g = torch.Generator(device=dev).manual_seed(5)
    h, p, n = shape

    def case(c, zero_s0):
        dec = torch.rand(c, h, generator=g, device=dev) * 0.7 + 0.3
        s_in = torch.randn(c, h, p, n, generator=g, device=dev)
        s0 = torch.zeros(h, p, n, device=dev) if zero_s0 else \
            torch.randn(h, p, n, generator=g, device=dev)
        return dec, s_in, s0

    k5_err = 0.0
    for cc in checked:
        for zero_s0 in (True, False):
            args = case(cc, zero_s0)
            prefix, final = sops.ssd_scan(*args)
            torch.cuda.synchronize()
            want_p, want_f = sops.ssd_scan_ref(*args)
            err = max((prefix - want_p).abs().max().item(),
                      (final - want_f).abs().max().item())
            if not (torch.equal(prefix, want_p) and torch.equal(final,
                                                                want_f)):
                raise AssertionError(
                    f"K5 not bitwise at C={cc}, s0 "
                    f"{'zero' if zero_s0 else 'random'}: max |diff| {err}")
            k5_err = max(k5_err, err)
            del args, prefix, final, want_p, want_f
    log(f"[kernels] K5 ssd_scan: bitwise equal to the plain version at "
        f"(C, {h}, {p}, {n}) for C in {set(checked)}, s0 zero and random")
    # timed at c chunks (mamba2-780m: a 2048-token prompt at chunk 256)
    copies = [case(c, False) for _ in range(4)]
    it = iter(range(10 ** 9))

    def pick():
        return copies[next(it) % len(copies)]

    e = h * p * n
    nbytes = 4 * (2 * c * e + 2 * e + c * h)
    bms, by = bound(nbytes, 2 * c * e, "f32")
    return dict(shape=f"C={c} H={h} P={p} N={n} f32", max_abs_err=k5_err,
                ms=time_ms(lambda: sops.ssd_scan(*pick()), 50, flush),
                device_ms=device_ms(lambda: sops.ssd_scan(*pick()), 50,
                                    flush, "ssd_scan_kernel"),
                plain_ms=time_ms(lambda: sops.ssd_scan_ref(*pick()), 20,
                                 flush),
                library_ms=None, bound_ms=bms, bound_by=by)


# path 7 trains at batch 4: K5's backward scans B * heads = 192 rows
K5_TRAIN_BH = 4 * K5_SHAPE[0]


def k5_bwd_check(got, decay, prefix, dprefix, dfinal, where):
    """Hold ``ssd_scan_bwd``'s results ``got`` against its plain version:
    ``ds_in`` and ``ds0`` bitwise, ``ddecay`` within ``2 * P * N * 2^-24
    * sum |G * prefix|`` a (chunk, head), G being ``ds_in``: both sum the
    same rounded products in different orders.  Returns the largest
    |ddecay difference| and its ratio to the bound."""
    from repro_torch.kernels.ssd_scan import ref as sref
    want = sref.ssd_scan_bwd_ref(decay, prefix, dprefix, dfinal)
    for k, a, b in zip(("ds_in", "ds0"), got[1:], want[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"K5 backward {k} not bitwise at {where}: "
                                 f"max |diff| {(a - b).abs().max().item()}")
    pn = prefix.shape[2] * prefix.shape[3]
    lim = 2 * pn * 2.0 ** -24 * (want[1] * prefix).abs().sum(dim=(2, 3))
    diff = (got[0] - want[0]).abs()
    if not bool((diff <= lim).all()):
        raise AssertionError(f"K5 backward ddecay out of its bound at "
                             f"{where}: max |diff| {diff.max().item()}, "
                             f"max diff / bound "
                             f"{(diff / lim).max().item()}")
    return diff.max().item(), (diff / lim.clamp_min(1e-30)).max().item()


def phase_k5_bwd(dev, flush):
    """K5's backward kernel against ``ssd_scan_bwd_ref`` at the serving
    shape (H = 48) and path 7's (B * H = 192), C from 1 to 509, with and
    without ``dfinal``, on the one-float path (P * N = 15, and a view off
    the 16-byte boundary); run twice, ``ddecay`` bit for bit the same;
    timed at C = 8 for both H beside the plain version and its bound."""
    from repro_torch.kernels.ssd_scan import ops as sops

    g = torch.Generator(device=dev).manual_seed(9)
    _, p, n = K5_SHAPE

    def case(c, h, p=p, n=n, with_final=True):
        dec = torch.rand(c, h, generator=g, device=dev) * 0.7 + 0.3
        s_in = torch.randn(c, h, p, n, generator=g, device=dev)
        s0 = torch.randn(h, p, n, generator=g, device=dev)
        prefix, _ = sops.ssd_scan_ref(dec, s_in, s0)
        dprefix = torch.randn(c, h, p, n, generator=g, device=dev)
        dfinal = torch.randn(h, p, n, generator=g, device=dev) \
            if with_final else None
        return dec, prefix, dprefix, dfinal

    err, worst = 0.0, 0.0
    cases = [(c, h, p, n, wf) for h in (K5_SHAPE[0], K5_TRAIN_BH)
             for c in (1, 2, 8) for wf in (True, False)]
    cases += [(509, K5_SHAPE[0], p, n, True), (7, 6, 3, 5, True),
              (9, 5, 3, 5, False)]
    for c, h, pp, nn, wf in cases:
        args = case(c, h, pp, nn, wf)
        got = sops.ssd_scan_bwd(*args)
        again = sops.ssd_scan_bwd(*args)
        torch.cuda.synchronize()
        where = f"C={c} H={h} P={pp} N={nn} dfinal {'given' if wf else 'None'}"
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K5 backward differs between two runs at "
                                 f"{where}")
        e, r = k5_bwd_check(got, *args, where)
        err, worst = max(err, e), max(worst, r)
        del args, got, again
    # a view off the 16-byte boundary takes the one-float path too
    dec, prefix, dprefix, dfinal = case(8, K5_SHAPE[0])
    buf = torch.empty(dprefix.numel() + 1, device=dev)
    buf[1:] = dprefix.reshape(-1)
    moved = buf[1:].view(dprefix.shape)
    e, r = k5_bwd_check(sops.ssd_scan_bwd(dec, prefix, moved, dfinal), dec,
                        prefix, dprefix, dfinal, "a misaligned dprefix")
    err, worst = max(err, e), max(worst, r)
    log(f"[kernels] K5 ssd_scan_bwd: ds_in and ds0 bitwise equal to the "
        f"plain version, ddecay within 2 P N 2^-24 sum|G prefix| (largest "
        f"|diff| {err:.3g}, {worst:.3g} of its bound) and the same in two "
        f"runs, at (C, H, {p}, {n}) for C in {{1, 2, 8}}, H in "
        f"{{{K5_SHAPE[0]}, {K5_TRAIN_BH}}}, dfinal given and None, at C = "
        f"509, at P * N = 15 and on a misaligned view")
    rows = {}
    for h in (K5_SHAPE[0], K5_TRAIN_BH):
        c = 8
        copies = [case(c, h) for _ in range(4)]
        it = iter(range(10 ** 9))

        def pick():
            return copies[next(it) % len(copies)]

        e = h * p * n
        # prefix and dprefix read, ds_in written (12 B an element and
        # chunk), dfinal read and ds0 written, decay read, ddecay written
        nbytes = 4 * (3 * c * e + 2 * e + 2 * c * h)
        bms, by = bound(nbytes, 4 * c * e, "f32")
        rows[h] = dict(
            shape=f"C={c} H={h} P={p} N={n} f32", max_abs_err=err,
            ddecay_max_of_bound=worst,
            ms=time_ms(lambda: sops.ssd_scan_bwd(*pick()), 50, flush),
            device_ms=device_ms(lambda: sops.ssd_scan_bwd(*pick()), 50,
                                flush, "ssd_scan_bwd"),
            plain_ms=time_ms(lambda: sops.ssd_scan_bwd_ref(*pick()), 20,
                             flush),
            library_ms=None, bound_ms=bms, bound_by=by)
        del copies
        r = rows[h]
        log(f"[kernels] ssd_scan_bwd at {r['shape']}: {r['ms']:.4f} ms "
            f"(device {r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    row = rows[K5_SHAPE[0]]
    row["train_shape"] = rows[K5_TRAIN_BH]
    return row


def _ulps(a, b):
    """Distance in float32 steps between same-signed finite values."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    return (ia - ib).abs()


def phase_rng(dev, flush):
    """The threefry2x32 generator on the card against the same calls on
    the CPU, at the sampler's shape (8 rows of the 128,256-token vocab,
    each keyed by (seed, uid, token index)); then the device sampler's
    cost per decode step, greedy and sampled, beside a plain argmax."""
    from repro_torch.core import rng as trng
    from repro_torch.serve.sampling import sample_tokens_device

    b, v = 8, 128256
    seed = torch.arange(b, dtype=torch.int64) * 7 + 3
    uid = torch.arange(b, dtype=torch.int64) + 100
    tidx = torch.arange(b, dtype=torch.int64) * 5

    def keys(device):
        k = torch.stack([torch.zeros(b, dtype=torch.int64), seed], -1)
        return trng.fold_in(trng.fold_in(k.to(device), uid.to(device)),
                            tidx.to(device))

    kc, kg = keys("cpu"), keys(dev)
    exact = {
        "fold_in": (kc, kg),
        "split": (trng.split(kc[0], 3), trng.split(kg[0], 3)),
        "random_bits": (trng.random_bits(kc, (v,)),
                        trng.random_bits(kg, (v,))),
        "uniform": (trng.uniform(kc, (v,)), trng.uniform(kg, (v,))),
        "randint": (trng.randint(kc[0], (b, v), 0, v),
                    trng.randint(kg[0], (b, v), 0, v)),
        "bernoulli": (trng.bernoulli(kc, 0.3, (v,)),
                      trng.bernoulli(kg, 0.3, (v,)))}
    for name, (c, g) in exact.items():
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"rng: {name} on the card differs from "
                                 f"the CPU")
    nc, ng = trng.normal(kc, (v,)), trng.normal(kg, (v,)).cpu()
    n_ulps = int(_ulps(nc, ng).max())
    gc, gg = trng.gumbel(kc, (v,)), trng.gumbel(kg, (v,)).cpu()
    g_ulps = float(((gc - gg).abs() / torch.as_tensor(np.spacing(
        np.maximum(gc.abs().numpy(), 1.0).astype(np.float32)))).max())
    if n_ulps > 4 or g_ulps > 8 or not (torch.isfinite(ng).all()
                                        and torch.isfinite(gg).all()):
        raise AssertionError(f"rng: normal {n_ulps} ULPs (bound 4), gumbel "
                             f"{g_ulps} ULPs of max(|g|, 1) (bound 8)")
    log(f"[rng] threefry2x32 on the card vs the CPU, {b} keyed rows x {v}: "
        f"fold_in, split, random_bits, uniform, randint, bernoulli "
        f"bit-equal; normal within {n_ulps} ULPs (bound 4), gumbel within "
        f"{g_ulps:.3g} ULPs of max(|g|, 1) (bound 8)")

    # the device sampler per decode step: the all-greedy fork (argmax)
    # beside the unified sampler on greedy rows, and a sampled batch
    g = torch.Generator(device=dev).manual_seed(7)
    logits = torch.randn(b, v, generator=g, device=dev) * 3
    zeros = torch.zeros(b, device=dev)
    temps = torch.full((b,), 0.8, device=dev)
    topk = torch.tensor([0, 40] * (b // 2), device=dev)
    args = [t.to(dev) for t in (seed, uid, tidx)]
    greedy_rows = sample_tokens_device(logits, zeros, topk * 0, *args,
                                       need_top_k=False)
    if not torch.equal(greedy_rows.long(), torch.argmax(logits, -1)):
        raise AssertionError("sampler: greedy rows are not the argmax")
    t = dict(
        argmax_ms=time_ms(lambda: torch.argmax(logits, -1), 50, flush),
        greedy_ms=time_ms(lambda: sample_tokens_device(
            logits, zeros, topk * 0, *args, need_top_k=False), 20, flush),
        sampled_ms=time_ms(lambda: sample_tokens_device(
            logits, temps, topk, *args, need_top_k=True), 20, flush))
    log(f"[rng] device sampler at B={b} x {v} (ms): argmax (the "
        f"all-greedy fork) {t['argmax_ms']:.4f}, unified sampler on "
        f"greedy rows {t['greedy_ms']:.4f}, sampled rows (temperature "
        f"0.8, top-k 40 on half) {t['sampled_ms']:.4f}")
    return t


def phase_pack(cfg, params, plan):
    """One full-width layer packed on the card equals the CPU packing."""
    from repro_torch.nn import quantized as nnq
    grp = "blocks.l0.ffn.w_gate.sb0"
    w = params["blocks"]["l0"]["ffn"]["w_gate"]["w"][0]      # (2048, 8192)
    on_card = nnq.PackedLinear.from_dense(w, plan.channel_bits[grp],
                                          plan.permutations[grp])
    on_cpu = nnq.PackedLinear.from_dense(w.cpu(), plan.channel_bits[grp],
                                         plan.permutations[grp])
    same = on_card.bits == on_cpu.bits and torch.equal(
        on_card.out_index.cpu(), on_cpu.out_index) and all(
        torch.equal(a.cpu(), b) and torch.equal(sa.cpu(), sb)
        for (_, a, sa), (_, b, sb) in zip(on_card.groups, on_cpu.groups))
    if not same:
        raise AssertionError(f"{grp}: card and CPU packing differ")
    log(f"[kernels] {grp} ({on_card.n_in} x {on_card.n_out}, bits "
        f"{on_card.bits}) packs "
        f"byte-identically on the card and on the CPU")


def phase_serve(dev, counters):
    from repro_torch.configs import registry
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.models import lm
    from repro_torch.serve import engine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request

    cfg = registry.get("llama3.2-1b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    plan = engine.synthetic_plan(cfg, params, bits=None, seed=0)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; {plan.summary()}")
    phase_pack(cfg, params, plan)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 513, size=16)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    new_tokens = 64
    runs = {}
    for label, run_plan, n_req in (("plan", plan, 16), ("float", None, 4)):
        server = engine.InferenceServer(
            cfg, params, plan=run_plan, max_len=1024, max_batch=8,
            cache="paged", page_size=16, device=dev)
        reqs = [Request(uid=i, prompt=prompts[i],
                        sampling=SamplingParams(max_tokens=new_tokens))
                for i in range(n_req)]
        if label == "plan":
            log(f"[serve] apply_plan + server set-up "
                f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t1 = time.perf_counter()
        out = server.serve(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = {k: fn.launches for k, fn in counters.items()}
        st = server.stats
        for i in range(n_req):
            if len(out[i]) != new_tokens:
                raise AssertionError(f"{label}: request {i} gave "
                                     f"{len(out[i])} of {new_tokens} tokens")
        steps, adm = st["decode_steps"], st["admitted"]
        need = {"paged_attention": cfg.n_layers * steps,
                "paged_prefill": cfg.n_layers * adm,
                "quant_matmul": (7 * cfg.n_layers * (steps + adm)
                                 if run_plan is not None else 0)}
        for k, lo in need.items():
            if got[k] < lo or (lo == 0 and k == "quant_matmul"
                               and got[k] != 0):
                raise AssertionError(f"{label}: {k} launched {got[k]} "
                                     f"times, need >= {lo}")
        tok = sum(len(v) for v in out.values())
        log(f"[serve] {label}: {n_req} requests (prompts "
            f"{int(min(lens[:n_req]))}-{int(max(lens[:n_req]))}) x "
            f"{new_tokens} tokens, {steps} decode steps, {adm} admissions "
            f"in {dt:.2f} s = {tok / dt:.1f} tok/s on "
            f"{torch.cuda.get_device_name(dev)}; launches {got}")
        runs[label] = got

    # sampled traffic: each device draw is re-drawn on the CPU from the
    # same logits and keys and must give the same token; one request
    # served alone must give its batched stream
    checked = [0]
    draw = engine.sample_tokens_device

    def draw_checked(logits, *args, need_top_k=True):
        ids = draw(logits, *args, need_top_k=need_top_k)
        ref = draw(logits.cpu(), *[a.cpu() for a in args],
                   need_top_k=need_top_k)
        if not torch.equal(ids.cpu(), ref):
            raise AssertionError(f"sampled serve: card draws "
                                 f"{ids.cpu().tolist()}, CPU draws "
                                 f"{ref.tolist()}")
        checked[0] += ids.shape[0]
        return ids

    mix = [(0.8, 0), (1.0, 40), (0.7, 0), (1.2, 200)]
    sampled = [Request(uid=100 + i, prompt=prompts[i],
                       sampling=SamplingParams(temperature=tt, top_k=kk,
                                               max_tokens=16, seed=i))
               for i, (tt, kk) in enumerate(mix)]
    server = engine.InferenceServer(cfg, params, plan=plan, max_len=1024,
                                    max_batch=8, cache="paged",
                                    page_size=16, device=dev)
    engine.sample_tokens_device = draw_checked
    try:
        t1 = time.perf_counter()
        out = server.serve(sampled)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        solo = server.serve([sampled[1]])
    finally:
        engine.sample_tokens_device = draw
    if any(len(out[r.uid]) != 16 for r in sampled) or \
            list(solo[sampled[1].uid]) != list(out[sampled[1].uid]):
        raise AssertionError(f"sampled serve: streams {out}, solo {solo}")
    log(f"[serve] sampled: {len(sampled)} requests (temperature, top-k) "
        f"{mix} x 16 tokens in {dt:.2f} s; {checked[0]} device draws equal "
        f"the CPU's from the same logits and keys; request "
        f"{sampled[1].uid} alone gives its batched stream")

    # the paged path (K3 + K1) against the dense one (plain attention +
    # K1) on one short prompt: finite logits of the right shape that agree
    toks = prompts[0][:40]
    kernel = pops.paged_prefill_fwd

    def plain_k3(q, k_pool, v_pool, tables, lens, **kw):
        # K3's plain version (f32 math), rounded to bf16 once
        return pops.paged_prefill_ref(q, k_pool, v_pool, tables, lens, **kw)

    def prefill_gap(run_plan, k3):
        srv = engine.InferenceServer(cfg, params, plan=run_plan,
                                     max_len=1024, max_batch=1,
                                     cache="paged", page_size=16, device=dev)
        srv.begin()
        h = srv.backend.alloc(0, 0, toks.size)
        pops.paged_prefill_fwd = k3
        try:
            paged = srv._run_prefill(srv.backend, h, toks).float()
        finally:
            pops.paged_prefill_fwd = kernel
        dense, _ = lm.forward(cfg, srv.params, {"tokens": torch.as_tensor(
            toks[None], device=dev)}, mode="prefill", logits_mode="last")
        dense = dense[:, -1].float()
        return paged, dense, ((paged - dense).norm() / dense.norm()).item()

    # 16 bf16 layers with int8 activation quantization amplify the two
    # attention implementations' rounding differences; the relative L2
    # error of the logits is the stated measure, bound 5e-2
    paged, dense, rel = prefill_gap(plan, kernel)
    err = (paged - dense).abs().max().item()
    if paged.shape != (1, lm.padded_vocab(cfg)) or not torch.isfinite(
            paged).all() or rel > 5e-2:
        raise AssertionError(f"paged vs dense prefill logits: shape "
                             f"{tuple(paged.shape)}, relative L2 error "
                             f"{rel} > 5e-2 (max |diff| {err})")
    # witnesses for that gap: the same comparison with K3's plain version
    # in the kernel's place (what the dense path's rounding gives), and
    # the float model (no activation quantization) with the kernel
    _, _, rel_plain = prefill_gap(plan, plain_k3)
    _, _, rel_float = prefill_gap(None, kernel)
    _, _, rel_float_plain = prefill_gap(None, plain_k3)
    log(f"[serve] paged (K3) vs dense prefill logits on a 40-token prompt: "
        f"relative L2 error {rel:.3g} <= 5e-2, max |diff| {err:.4g} of max "
        f"|logit| {dense.abs().max().item():.4g}; witnesses: K3's plain "
        f"version in its place {rel_plain:.3g}; the float model "
        f"{rel_float:.3g} with K3, {rel_float_plain:.3g} with the plain "
        f"version")
    runs["paged_vs_dense"] = dict(plan_k3=rel, plan_plain=rel_plain,
                                  float_k3=rel_float,
                                  float_plain=rel_float_plain)
    return runs


def _check_logits(server, seen):
    """Hold every logits row the server samples from to be finite."""
    inner = server._sample_rows

    def checked(logits, rows, *rest):
        if not torch.isfinite(logits[:, :server.cfg.vocab]).all():
            raise AssertionError("non-finite logits in serving")
        seen[0] += logits.shape[0]
        return inner(logits, rows, *rest)

    server._sample_rows = checked


def _planned(layer):
    """The plan-bound projections of one layer's mixer tree, by name."""
    from repro_torch.nn import quantized as nnq
    return {k: v["w"] for k, v in sorted(layer.items())
            if isinstance(v, dict) and isinstance(v["w"], nnq.PackedLinear)}


def phase_mamba_layer(cfg, p_dev, dev, label, lens=(2048, 509),
                      tag="mamba"):
    """One full-width Mamba-2 layer's prefill (mamba2-780m's, or jamba's
    with ``tag="jamba"``) at each length of ``lens`` on the card (K5, and
    K1 for each plan-bound projection) against the same layer on the CPU
    (the plain versions)."""
    import copy
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import lm
    from repro_torch.nn import blocks

    def to_cpu(w):      # Module.cpu() moves in place: copy the card's first
        return copy.deepcopy(w).cpu() if isinstance(w, torch.nn.Module) \
            else w.cpu()

    p_cpu = {k: {"w": to_cpu(v["w"])} if isinstance(v, dict) else v.cpu()
             for k, v in p_dev.items()}
    k1_per_call = sum(len(w.bits) for w in _planned(p_dev).values())
    getw = lm._make_getw(cfg, None)
    g = torch.Generator(device=dev).manual_seed(6)
    errs = []
    for s in lens:
        x = torch.randn(1, s, cfg.d_model, generator=g,
                        device=dev).to(torch.bfloat16)
        before = sops.ssd_scan.launches, qops.quant_matmul.launches
        y, st = blocks.mamba2_layer(p_dev, x, cfg, mode="prefill",
                                    effective_w=getw)
        torch.cuda.synchronize()
        n5 = sops.ssd_scan.launches - before[0]
        n1 = qops.quant_matmul.launches - before[1]
        if (n5, n1) != (1, k1_per_call):
            raise AssertionError(f"{tag} {label} layer on the card: {n5} "
                                 f"K5 and {n1} K1 launches, need 1 and "
                                 f"{k1_per_call}")
        y_c, st_c = blocks.mamba2_layer(p_cpu, x.cpu(), cfg, mode="prefill",
                                        effective_w=getw)
        rel_y = float((y.cpu().float() - y_c.float()).norm()
                      / y_c.float().norm())
        rel_s = float((st["ssm"].cpu() - st_c["ssm"]).norm()
                      / st_c["ssm"].norm())
        if not (torch.isfinite(y).all() and torch.isfinite(st["ssm"]).all()
                and rel_y <= 1e-2 and rel_s <= 1e-2):
            raise AssertionError(f"{tag} {label} layer card vs CPU at "
                                 f"S={s}: relative L2 error y {rel_y}, "
                                 f"state {rel_s} (bound 1e-2)")
        errs.append((s, blocks.ssm_chunk(cfg, s), rel_y, rel_s))
    log(f"[{tag}] one full-width {label} Mamba-2 layer's prefill, card (K5"
        f"{', K1 x %d' % k1_per_call if k1_per_call else ''}) vs CPU "
        f"(plain versions), relative L2 error of output / final state: "
        + "; ".join(f"S={s} (chunk {q}) {ry:.3g} / {rs:.3g}"
                    for s, q, ry, rs in errs)
        + " (bound 1e-2: the bf16 projections round differently under "
        "cuBLAS and on the CPU, one bf16 step is 3.9e-3, and a plan-bound "
        "projection's int8 activation quantization can move one integer "
        "step where its bf16 input differs)")
    return errs


def phase_mamba_k1(p_dev, dev):
    """K1 against its plain version, bitwise, at every precision group of
    one plan-bound mamba2-780m layer: the path's own packed weights and
    ragged group widths, at decode (M = 8) and a 2048-token prefill.
    Returns the largest |difference| seen."""
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref

    g = torch.Generator(device=dev).manual_seed(8)
    one = torch.ones((), device=dev)
    err, seen = 0.0, []
    for name, w in _planned(p_dev).items():
        for bits, wq, sw in w.groups:
            wq_plain = qref.unpack_weights(wq, bits, w.n_in)
            for m in (8, 2048):
                xq = torch.randint(-127, 128, (m, w.n_in), generator=g,
                                   device=dev, dtype=torch.int8)
                got = qops.quant_matmul(xq, wq, sw, one, w_bits=bits)
                torch.cuda.synchronize()
                want = qref.quant_matmul_ref(xq, wq_plain, sw, one)
                diff = (got - want).abs().max().item()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K1 not bitwise on {name}'s {bits}-bit group "
                        f"({wq.shape[0]} x {w.n_in}) at M={m}: max |diff| "
                        f"{diff}")
                err = max(err, diff)
            seen.append(f"{name} {bits}b x {wq.shape[0]}")
    log(f"[mamba] K1 bitwise equal to its plain version at M in {{8, "
        f"2048}} on every precision group of plan-bound layer 0: "
        f"{', '.join(seen)}")
    return err


def phase_mamba(dev, counters):
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import engine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request

    cfg = registry.get("mamba2-780m")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    plan = engine.synthetic_plan(cfg, params, bits=None, seed=0)
    log(f"[mamba] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
        f"vocab {cfg.vocab}; {plan.summary()}")
    phase_mamba_layer(cfg, lm._index(params["blocks"]["l0"]["mixer"], 0),
                      dev, "float")
    rng = np.random.default_rng(0)
    lens = (2048, 1024, 512, 509, 300, 256, 64, 33)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    new_tokens = 64
    runs, outs = {}, {}
    for label, run_plan, cache, n_req in (("plan", plan, "paged", 8),
                                          ("float", None, "dense", 4)):
        server = engine.InferenceServer(
            cfg, params, plan=run_plan, max_len=4096, max_batch=8,
            cache=cache, page_size=16, device=dev)
        seen = [0]
        _check_logits(server, seen)
        reqs = [Request(uid=i, prompt=prompts[i],
                        sampling=SamplingParams(max_tokens=new_tokens))
                for i in range(n_req)]
        if label == "plan":
            log(f"[mamba] init + apply_plan + server set-up "
                f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t1 = time.perf_counter()
        out = server.serve(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = {k: fn.launches for k, fn in counters.items()}
        st = server.stats
        for i in range(n_req):
            if len(out[i]) != new_tokens:
                raise AssertionError(f"mamba {label}: request {i} gave "
                                     f"{len(out[i])} of {new_tokens} "
                                     f"tokens")
        steps, adm = st["decode_steps"], st["admitted"]
        k1_min = 6 * cfg.n_layers * (steps + adm)
        bad = [k for k, v in got.items() if k not in
               ("ssd_scan", "quant_matmul") and v]
        if (got["ssd_scan"] != cfg.n_layers * adm or bad
                or (run_plan is not None and got["quant_matmul"] < k1_min)
                or (run_plan is None and got["quant_matmul"])):
            raise AssertionError(
                f"mamba {label}: launches {got} after {steps} decode "
                f"steps and {adm} admissions; need ssd_scan == "
                f"{cfg.n_layers * adm}, quant_matmul "
                f"{'>= %d' % k1_min if run_plan is not None else '== 0'}, "
                f"no other kernel")
        tok = sum(len(v) for v in out.values())
        mem = st["memory"]
        log(f"[mamba] {label} ({cache}): {n_req} requests (prompts "
            f"{list(lens[:n_req])}) x {new_tokens} tokens, {steps} decode "
            f"steps, {adm} admissions in {dt:.2f} s = {tok / dt:.1f} tok/s "
            f"on {torch.cuda.get_device_name(dev)}; {seen[0]} logits rows "
            f"finite; launches {got}; SSM state "
            f"{lm.ssm_bytes_per_slot(cfg)} B a slot, pages in use at peak "
            f"{mem.get('peak_pages_in_use', 0)}")
        runs[label], outs[label] = got, (server, out)
        if run_plan is not None:
            layer = server.params["blocks"][0]["l0"]["mixer"]
            runs["k1_err"] = phase_mamba_k1(layer, dev)
            phase_mamba_layer(cfg, layer, dev, "plan-bound")

    # batched == solo: the prime-length prompt (chunk 1) and the 33-token
    # one (chunk 11), each served alone through the plan-bound server
    server, batched = outs["plan"]
    for i in (3, 7):
        solo = server.serve([Request(uid=i, prompt=prompts[i],
                                     sampling=SamplingParams(
                                         max_tokens=new_tokens))])
        if list(solo[i]) != list(batched[i]):
            first = next(j for j, (a, b) in enumerate(zip(solo[i],
                                                          batched[i]))
                         if a != b)
            raise AssertionError(f"mamba: request {i} alone diverges from "
                                 f"its batched stream at token {first}")
    log(f"[mamba] requests 3 (509 tokens) and 7 (33 tokens) alone give "
        f"their batched plan-bound streams")
    return runs


# path 6, MoE serving at full width with depth cut: (arch, layers kept,
# max_len, slots, prompt lengths, new tokens, float requests).  scout's
# 8176-token prompt makes decode cross the 8192 chunk boundary on K2, its
# 8320-token one makes K3's prefill cross it.
MOE_PATHS = (
    ("llama4-scout-17b-a16e", 12, 9216, 8,
     tuple(int(n) for n in np.random.default_rng(0).integers(64, 1025, 6))
     + (8176, 8320), 32, 2),
    ("arctic-480b", 2, 1024, 4,
     tuple(int(n) for n in np.random.default_rng(1).integers(64, 513, 4)),
     16, 0),
)
DEVICE_CLASSES = (("K1", ("qmv_kernel", "qmm_kernel")),
                  ("K2", ("paged_decode",)),
                  ("K3", ("paged_prefill",)),
                  ("cuBLAS products", ("nvjet", "gemm", "gemv", "cutlass",
                                       "xmma", "Kernel2", "sm90_")))


def _device_split(prof, classes=DEVICE_CLASSES):
    """Device ms of one profiled window by class: the port's kernels,
    cuBLAS's products (the expert banks, router, lm_head, float
    projections) and everything else (elementwise, sorts, gathers)."""
    out = {k: 0.0 for k, _ in classes}
    out["other"] = 0.0
    other = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k, keys in classes
                     if any(x in e.key for x in keys)), "other")
        out[name] += e.self_device_time_total / 1e3
        if name == "other":
            other[e.key[:60]] = e.self_device_time_total / 1e3
    _device_split.other = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    return out


def _moe_prefill_gap(cfg, params, plan, toks, dev):
    """Paged (K3, and K3's plain version as the witness) vs dense prefill
    logits of one prompt: on a dense stack of a length that is a multiple
    of 16 (the padded paged prefill then sees the dense path's token
    count, so the same MoE capacity), on a hybrid of any length (it
    prefills unpadded).  Returns relative L2 errors {"k3", "plain"} to
    the dense logits and "k3_vs_plain" between the two paged ones."""
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.models import lm
    from repro_torch.serve import engine

    kernel = pops.paged_prefill_fwd
    srv = engine.InferenceServer(cfg, params, plan=plan, max_len=256,
                                 max_batch=1, cache="paged", page_size=16,
                                 device=dev)
    dense, _ = lm.forward(cfg, srv.params, {"tokens": torch.as_tensor(
        toks[None], device=dev)}, mode="prefill", logits_mode="last")
    dense = dense[:, -1].float()
    out, paged = {}, {}
    for name, k3 in (("k3", kernel), ("plain", pops.paged_prefill_ref)):
        srv.begin()
        h = srv.backend.alloc(0, 0, toks.size)
        pops.paged_prefill_fwd = k3
        try:
            paged[name] = srv._run_prefill(srv.backend, h, toks).float()
        finally:
            pops.paged_prefill_fwd = kernel
        if paged[name].shape != (1, lm.padded_vocab(cfg)) or \
                not torch.isfinite(paged[name]).all():
            raise AssertionError(f"{cfg.name} paged prefill logits: shape "
                                 f"{tuple(paged[name].shape)} or non-finite")
        out[name] = ((paged[name] - dense).norm() / dense.norm()).item()
        srv.end()
    out["k3_vs_plain"] = ((paged["k3"] - paged["plain"]).norm()
                          / paged["plain"].norm()).item()
    return out


def _serve_counted(cfg, params, run_plan, prompts, new, dev, counters,
                   smi, tag, *, max_len, slots, need, at_least=False):
    """Serve ``prompts`` greedily for ``new`` tokens each through a paged
    server (16-token pages) and hold its kernel launches: every counter
    is zeroed just before the serve, and ``need(server, steps,
    admissions)`` gives the launches required of it (any counter it does
    not name: 0), exactly, or at least with ``at_least`` (a 0 stays
    exact).  Also held: finite logits, full-length streams and, on a
    hybrid, every paged prefill at the prompt's exact length.  Returns
    (the server, the run's figures)."""
    from repro_torch.serve import engine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request

    t0 = time.perf_counter()
    server = engine.InferenceServer(
        cfg, params, plan=run_plan, max_len=max_len, max_batch=slots,
        cache="paged", page_size=16, device=dev)
    seen, widths = [0], []
    _check_logits(server, seen)
    if server._has_ssm:
        if not server._paged_kv:
            raise AssertionError(f"{tag}: the paged server does not "
                                 f"prefill into KV pages")
        inner = server._prefill_paged

        def exact(params_, batch, *rest):
            widths.append(int(batch["tokens"].shape[1]))
            return inner(params_, batch, *rest)

        server._prefill_paged = exact
    reqs = [Request(uid=i, prompt=p, sampling=SamplingParams(max_tokens=new))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    t1 = time.perf_counter()
    out = server.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    got = {k: fn.launches for k, fn in counters.items()}
    st = server.stats
    lens = [int(p.size) for p in prompts]
    for i in range(len(prompts)):
        if len(out[i]) != new:
            raise AssertionError(f"{tag}: request {i} gave {len(out[i])} "
                                 f"of {new} tokens")
    steps, adm = st["decode_steps"], st["admitted"]
    want = need(server, steps, adm)
    if at_least:
        bad = {k: got[k] for k, lo in want.items()
               if got[k] < lo or (lo == 0 and got[k] != 0)}
    else:
        bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{tag}: launches {got} after {steps} decode "
                             f"steps and {adm} admissions; need "
                             f"{'at least ' if at_least else ''}{want}")
    if server._has_ssm and sorted(widths) != sorted(lens):
        raise AssertionError(f"{tag}: paged prefills of {widths} tokens, "
                             f"prompts of {lens}")
    tok = sum(len(v) for v in out.values())
    mem = st["memory"]
    log(f"{tag}: {len(prompts)} requests (prompts {lens}) x {new} tokens, "
        f"{steps} decode steps, {adm} admissions in {dt:.2f} s = "
        f"{tok / dt:.1f} tok/s (set-up {setup:.1f} s); {seen[0]} logits "
        f"rows finite; {'every prefill unpadded; ' if widths else ''}"
        f"launches {got}; memory_report pages_in_use peak "
        f"{mem['peak_pages_in_use']} of {mem['n_pages']} "
        f"({mem['bytes_per_page']} B a page), ssm_slot_bytes "
        f"{mem['ssm_slot_bytes']}, peak_cache_bytes "
        f"{mem['peak_cache_bytes']}; {smi}")
    run = dict(launches=got, decode_steps=steps, admitted=adm, seconds=dt,
               tok_s=tok / dt, memory={k: v for k, v in mem.items()
                                       if isinstance(v, (int, float))})
    return server, run


def phase_moe(dev, counters, smi):
    """Path 6: MoE serving (llama4-scout at 12 of 48 layers, arctic at 2
    of 35) at full width, bf16 weights from seed 0, on K1-K3."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import engine

    result = {}
    for arch, n_layers, max_len, slots, lens, new, n_float in MOE_PATHS:
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = dataclasses.replace(registry.get(arch), n_layers=n_layers,
                                  param_dtype="bfloat16")
        t0 = time.perf_counter()
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        n_par = sum(v.numel() for _, v in _leaves(params))
        plan = engine.synthetic_plan(cfg, params, bits=None, seed=0)
        log(f"[moe] {arch}: {n_layers} of {registry.get(arch).n_layers} "
            f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
            f"of {cfg.head_dim}, {cfg.n_experts} experts x {cfg.experts_per_token} "
            f"of d_ff {cfg.expert_d_ff} + shared d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab}; {n_par / 1e9:.3f} B bf16 parameters "
            f"({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB) drawn in "
            f"{time.perf_counter() - t0:.1f} s; {plan.summary()}")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
                   for n in lens]
        L = cfg.n_layers
        runs = {}
        for label, run_plan, n_req in (("plan", plan, len(lens)),
                                       ("float", None, n_float)):
            if not n_req:
                continue

            def need(server, steps, adm, planned=run_plan is not None):
                return {"paged_attention": L * steps,
                        "paged_prefill": L * adm,
                        "quant_matmul": 7 * L * (steps + adm) if planned
                        else 0}

            server, runs[label] = _serve_counted(
                cfg, params, run_plan, prompts[:n_req], new, dev, counters,
                smi, f"[moe] {arch} {label}", max_len=max_len, slots=slots,
                need=need, at_least=True)
            if label == "plan" and arch.startswith("llama4"):
                runs["decode_split"] = _decode_profile(
                    server, cfg, prompts, smi)
            del server
        rel = _moe_prefill_gap(cfg, params, plan, prompts[0][:64], dev)
        rel_f = _moe_prefill_gap(cfg, params, None, prompts[0][:64], dev)
        if max(rel["k3"], rel_f["k3"]) > 5e-2:
            raise AssertionError(f"{arch} paged vs dense prefill logits: "
                                 f"relative L2 error {rel} (plan), "
                                 f"{rel_f} (float) > 5e-2")
        log(f"[moe] {arch} paged (K3) vs dense prefill logits on a 64-token "
            f"prompt: relative L2 error {rel['k3']:.3g} plan-bound, "
            f"{rel_f['k3']:.3g} float (bound 5e-2); witnesses with K3's "
            f"plain version {rel['plain']:.3g} / {rel_f['plain']:.3g}")
        runs["paged_vs_dense"] = dict(plan_k3=rel["k3"],
                                      plan_plain=rel["plain"],
                                      float_k3=rel_f["k3"],
                                      float_plain=rel_f["plain"])
        runs["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        runs["params_b"] = n_par / 1e9
        log(f"[moe] {arch}: peak memory {runs['peak_gib']:.2f} GiB "
            f"(torch.cuda.max_memory_allocated); {smi}")
        result[arch] = runs
        del params, plan
        _free(dev)
    return result


def _decode_profile(server, cfg, prompts, smi, tag="moe",
                    classes=DEVICE_CLASSES):
    """The device time of a decode step by class: 8 requests of 64 prompt
    tokens served under torch.profiler twice, for 1 token (admissions
    only) and for 17 (the same admissions and 16 decode steps); the
    difference over the decode steps splits a step between cuBLAS's
    products (the expert banks above all), K1, K2, K3 (K5 for jamba)
    and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request

    windows = []
    for n in (1, 17):
        reqs = [Request(uid=100 + i, prompt=p[:64],
                        sampling=SamplingParams(max_tokens=n))
                for i, p in enumerate(prompts[:8])]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.serve(reqs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        windows.append((_device_split(prof, classes), wall,
                        server.stats["decode_steps"]))
    (adm, wall_a, _), (full, wall_f, steps) = windows
    per_step = {k: (full[k] - adm[k]) / steps for k in full}
    wall_step = (wall_f - wall_a) / steps
    busy = sum(per_step.values())
    log(f"[{tag}] {cfg.name} plan-bound decode step (8 slots, 64-token "
        f"prompts; {steps} steps, profiled): {wall_step:.2f} ms wall "
        f"({8e3 / wall_step:.1f} decode tok/s), {busy:.2f} ms device "
        f"({100 * busy / wall_step:.1f}% busy); "
        f"device ms a step by class: "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items())
        + f"; 8 admissions {sum(adm.values()):.2f} ms device in "
        f"{wall_a:.1f} ms wall; {smi}")
    log(f"[{tag}] largest 'other' kernels of the 17-token window (ms): "
        + "; ".join(f"{k} {v:.2f}" for k, v in _device_split.other))
    return dict(step_ms=per_step, step_wall_ms=wall_step, decode_steps=steps,
                admissions_device_ms=adm, admissions_wall_ms=wall_a)


def _free(dev):
    import gc
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


class StepTimer:
    """Compressor hook: wall time of every step (synchronised), each
    step's metrics, per phase."""

    def __init__(self):
        self.steps, self.metrics, self._t = {}, {}, None

    def on_phase_start(self, phase, state):
        torch.cuda.synchronize()
        self._t = time.perf_counter()

    def on_step(self, phase, state, step, metrics, train_state):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.steps.setdefault(phase.name, []).append(now - self._t)
        self.metrics.setdefault(phase.name, []).append(
            {k: float(v) for k, v in metrics.items()})
        self._t = now

    def on_phase_end(self, phase, state):
        pass


def phase_search(dev, counters, smi):
    from repro_torch.api import compressor, phases
    from repro_torch.api.plan import CompressionPlan
    from repro_torch.core import mps, sampling
    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    from repro_torch.optim import optimizers

    g = cnn.resnet18()
    spec = synthetic.TINYIMAGENET_LIKE
    pw, px, batch = K4_PW, (8,), 32
    n_w, n_s, n_f = 4, 6, 4
    n_nodes = len(g.weight_nodes())
    comp = compressor.Compressor(g, spec, pw=pw, px=px, batch=batch, seed=0)
    if comp.device.type != torch.device(dev).type:
        raise AssertionError(f"Compressor chose {comp.device}, not {dev}")
    timer = StepTimer()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = comp.run([phases.Warmup(steps=n_w),
                    phases.JointSearch(steps=n_s, lam=5.0),
                    phases.Finetune(steps=n_f)], hooks=[timer])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in counters.items()}
    for k in ("mps_combine", "mps_combine_bwd"):
        if got[k] != n_nodes * n_s:
            raise AssertionError(f"search: {k} launched {got[k]} times, "
                                 f"need {n_nodes} x {n_s}")
    if any(v for k, v in got.items()
           if k not in ("mps_combine", "mps_combine_bwd")):
        raise AssertionError(f"search launched serving kernels: {got}")
    for name, rows in timer.metrics.items():
        for r in rows:
            if not all(np.isfinite(v) for v in r.values()):
                raise AssertionError(f"search: {name} metrics {r} not "
                                     f"finite")
    plan = res.plan
    bits = set(int(b) for v in plan.channel_bits.values() for b in v)
    if not isinstance(plan, CompressionPlan) or not bits <= set(pw) or \
            not (plan.channel_bits["fc"] > 0).all() or \
            len(plan.channel_bits["fc"]) != spec.num_classes:
        raise AssertionError(f"search: bad plan {plan.summary()}, bits "
                             f"{sorted(bits)}")
    if not (np.isfinite(res.acc_float) and np.isfinite(res.acc_final)):
        raise AssertionError(f"search: accuracies {res.acc_float}, "
                             f"{res.acc_final}")
    # the searched network on the card (K4 in search mode) against the
    # port's plain path on the CPU, two images: logits that agree
    x, _ = synthetic.class_batch(spec, 123, 2, 0, dev)
    ctx = mps.SearchCtx(sampling.SOFTMAX, 0.5)
    gpu_mps = res.mps_params
    assignment = plan.to_assignment()
    def cpu(tree):
        return optimizers.tree_map(lambda a: a.cpu(), tree)

    errs = {}
    with torch.no_grad():
        for mode, net in (("search", res.folded), ("quant", res.net)):
            kw = dict(mode=mode, folded=True, pw=pw, px=px,
                      assignment=assignment, ctx=ctx)
            before = counters["mps_combine"].launches
            on_card, _ = cnn.apply(g, net, x, mps_params=gpu_mps, **kw)
            if mode == "search" and counters["mps_combine"].launches != \
                    before + n_nodes:
                raise AssertionError("search mode on the card bypassed K4")
            on_cpu, _ = cnn.apply(g, cpu(net), x.cpu(),
                                  mps_params=cpu(gpu_mps), **kw)
            on_card = on_card.cpu()
            rel = float((on_card - on_cpu).norm() / on_cpu.norm())
            if on_card.shape != (2, spec.num_classes) or \
                    not torch.isfinite(on_card).all() or rel > 1e-4:
                raise AssertionError(f"search: {mode}-mode logits on the card "
                                     f"vs the CPU: shape "
                                     f"{tuple(on_card.shape)}, relative L2 "
                                     f"error {rel} > 1e-4")
            errs[mode] = rel
    log(f"[search] searched resnet18 on the card (K4) vs the port's plain "
        f"CPU path, 2 images: relative L2 error of the logits "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + " (bound 1e-4: f32 convolutions in another order)")
    per_step = {name: (float(np.mean(v[1:])) if len(v) > 1 else v[0])
                for name, v in timer.steps.items()}
    log(f"[search] resnet18 (21 weight nodes, "
        f"{cnn.param_count(res.net) / 1e6:.2f} M params) on "
        f"{spec.name} {spec.shape}, batch {batch}, pw {pw}, px {px}: "
        f"{n_w} warmup / {n_s} search / {n_f} finetune steps in {dt:.1f} "
        f"s; K4 launches {got['mps_combine']} forward and "
        f"{got['mps_combine_bwd']} backward = {n_nodes} x {n_s} each")
    log(f"[search] mean step time after the first (ms): " + ", ".join(
        f"{k} {1e3 * v:.1f}" for k, v in per_step.items())
        + f"; phase wall (s, with evaluation): " + ", ".join(
        f"{k} {v:.2f}" for k, v in res.timings.items())
        + f"; on {torch.cuda.get_device_name(dev)} ({smi})")
    log(f"[search] losses: " + "; ".join(
        f"{k} {[round(r.get('loss', r.get('task', 0.0)), 4) for r in v]}"
        for k, v in timer.metrics.items()))
    log(f"[search] {plan.summary()}; acc float {res.acc_float:.4f}, final "
        f"{res.acc_final:.4f}; size {res.size_bytes / 1e6:.3f} MB")
    return got, per_step


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 256


def _count_plain_stack():
    """Count calls of the plain quantizer stack (``core.quantizers.
    quantize_weights_multi``), which a CUDA weight must never reach."""
    from repro_torch.core import quantizers
    inner = quantizers.quantize_weights_multi
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    quantizers.quantize_weights_multi = counted
    return calls, lambda: setattr(quantizers, "quantize_weights_multi",
                                  inner)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def phase_train(dev, counters, smi, k4_lm):
    """Path 4: the paper's joint search on full-width llama3.2-1b (remat,
    f32 master weights, adam at 3e-4, random weights from seed 0) through
    ``launch.steps.make_train_step(search=True)`` for TRAIN_STEPS steps;
    K4's launches read around the run; one more step profiled; then the
    searched plan extracted, bound and served on K1-K3."""
    from repro_torch.configs import registry
    from repro_torch.core import mps
    from repro_torch.data import synthetic
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import optimizers
    from repro_torch.serve import engine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request

    cfg = registry.get("llama3.2-1b")
    pw = cfg.mps_precisions
    n_proj = lm.mps_param_count(cfg) * lm.n_superblocks(cfg)
    if not cfg.remat or cfg.param_dtype != "float32" or \
            cfg.optimizer != "adam" or n_proj != 112:
        raise AssertionError(f"train: unexpected config {cfg}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, mps_on=True)
    n_params = sum(t.numel() for k, t in _leaves(params)
                   if not k.endswith("gamma"))
    opt = optimizers.make_optimizer(cfg.optimizer, 3e-4)
    state = {"params": params, "opt": opt.init(params)}
    del params
    step_fn = steps_lib.make_train_step(cfg, opt, search=True)
    gamma0 = {k: t.clone() for k, t in _leaves(state["params"])
              if k.endswith("gamma")}

    def batch_at(step):
        return synthetic.lm_batch(cfg.vocab, TRAIN_SEQ + 1, TRAIN_BATCH,
                                  step, device=dev)

    batches = [batch_at(i) for i in range(TRAIN_STEPS)]
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, remat {cfg.remat}, {cfg.param_dtype} master weights, "
        f"{cfg.optimizer} at 3e-4; {n_params / 1e9:.3f} B parameters + "
        f"{len(gamma0)} gamma leaves ({n_proj} projections), pw {pw}; "
        f"search, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}")
    plain, restore = _count_plain_stack()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    times, losses, norms = [], [], []
    try:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            p, o, loss = step_fn(state["params"], state["opt"], batch, i)
            state = {"params": p, "opt": o}
            losses.append(float(loss))
            norms.append(float(step_fn.grad_norm))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        restore()
    got = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    need = {"mps_combine": n_proj * TRAIN_STEPS * 2,       # + the recompute
            "mps_combine_bwd": n_proj * TRAIN_STEPS}
    if any(got[k] != v for k, v in need.items()) or any(
            v for k, v in got.items() if k not in need):
        raise AssertionError(f"train: launches {got}, need {need} and no "
                             f"other kernel")
    if plain[0]:
        raise AssertionError(f"train: {plain[0]} projections took the plain "
                             f"quantizer stack")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"train: losses {losses}, grad norms {norms}")
    moved = [k for k, t in _leaves(state["params"])
             if k.endswith("gamma") and not torch.equal(t, gamma0[k])]
    if len(moved) != len(gamma0):
        raise AssertionError(f"train: only {len(moved)} of {len(gamma0)} "
                             f"gamma leaves moved")
    with torch.no_grad():
        cost = float(lm.mps_size_cost(cfg, state["params"],
                                      mps.SearchCtx(tau=1.0)))
    if not np.isfinite(cost):
        raise AssertionError(f"train: mps_size_cost {cost}")
    ms = 1e3 * float(np.median(times[1:]))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3)
    log(f"[train] {TRAIN_STEPS} search steps on {torch.cuda.get_device_name(dev)}"
        f" ({smi}): losses {[round(v, 4) for v in losses]}, grad norms "
        f"{[round(v, 4) for v in norms]}; step ms {[round(1e3 * t, 1) for t in times]}"
        f", median of steps 2-{TRAIN_STEPS} {ms:.1f} ms = {tok_s:.0f} "
        f"training tokens/s; peak memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); mps_size_cost {cost:.6g} bytes;"
        f" K4 launches {got['mps_combine']} forward = {n_proj} x "
        f"{TRAIN_STEPS} x 2 (remat recompute), {got['mps_combine_bwd']} "
        f"backward = {n_proj} x {TRAIN_STEPS}; plain quantizer stack: 0 "
        f"calls; all {len(gamma0)} gamma leaves moved")

    state, prof = train.profile_steps(step_fn, state, batch_at, TRAIN_STEPS,
                                      1, dev)
    k4_s = sum(v for k, v in prof["kernels"].items() if "mps_" in k)
    copy_s = k4_lm["train_step"]["copy"] / 1e3
    busy = prof["device_s"] / prof["wall_s"]
    log(f"[train] one profiled step: wall {1e3 * prof['wall_s']:.1f} ms, "
        f"device {1e3 * prof['device_s']:.1f} ms = {100 * busy:.1f}% busy, "
        f"{prof['launches']} device operations; K4 {1e3 * k4_s:.2f} ms = "
        f"{100 * k4_s / prof['device_s']:.2f}% of device time; the "
        f"transposing copies {1e3 * copy_s:.2f} ms = "
        f"{100 * copy_s / prof['device_s']:.2f}% (from the kernels phase's "
        f"copy times x 3 a projection)")
    top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:8]
    log("[train] top kernels of the profiled step (device ms): " + "; ".join(
        f"{k[:60]} {1e3 * v:.2f}" for k, v in top))

    del state["opt"]
    params = state["params"]
    plan = lm.extract_plan(cfg, params)
    bits = {int(b) for v in plan.channel_bits.values() for b in v}
    if len(plan.groups) != n_proj or not bits <= set(pw) or \
            plan.meta != {"track": "lm", "arch": cfg.name}:
        raise AssertionError(f"train: plan {plan.summary()}, bits "
                             f"{sorted(bits)}, meta {plan.meta}")
    t0 = time.perf_counter()
    bound_layers = plan.bind(lm.serve_weight_groups(cfg, params))
    if sorted(bound_layers) != list(plan.groups):
        raise AssertionError("train: the plan did not bind every group")
    del bound_layers
    server = engine.InferenceServer(cfg, params, plan=plan, max_len=128,
                                    max_batch=2, cache="paged", page_size=16,
                                    device=dev)
    setup = time.perf_counter() - t0
    seen = [0]
    _check_logits(server, seen)
    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=n).astype(
        np.int32), sampling=SamplingParams(max_tokens=8))
        for i, n in enumerate((37, 90))]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = server.serve(reqs)
    torch.cuda.synchronize()
    served = {k: fn.launches for k, fn in counters.items()}
    if any(len(out[i]) != 8 for i in range(2)) or not seen[0]:
        raise AssertionError(f"train: served {out}")
    for k in ("quant_matmul", "paged_attention", "paged_prefill"):
        if not served[k]:
            raise AssertionError(f"train: serving the plan never launched {k}"
                                 f": {served}")
    log(f"[train] searched plan: {plan.summary()}, bits {sorted(bits)}; bind "
        f"+ apply_plan + server {setup:.2f} s; served 2 greedy requests x 8 "
        f"tokens (prompts 37, 90) on the paged cache, {seen[0]} logits rows "
        f"finite; launches {served}")
    return dict(launches=got, served=served, ms=ms, tok_s=tok_s,
                peak_bytes=peak, busy=busy, k4_share=k4_s / prof["device_s"])


MAMBA_STEPS, MAMBA_BATCH, MAMBA_SEQ = 4, 4, 2048


class _CaptureK5Bwd:
    """Stands in for ``ops.ssd_scan_bwd``, which the autograd backward
    calls by its module name, while a ``with`` block runs: call number
    ``at`` (1-based) keeps clones of its operands and results in
    ``kept``; the others pass through uncopied.  ``launches`` is the
    wrapped function's own count, read and written through, so that the
    count the wrapped function bumps under its module name lands where
    the counters read it."""

    def __init__(self, sops, at):
        self.sops, self.inner, self.at = sops, sops.ssd_scan_bwd, at
        self.calls, self.kept = 0, None

    launches = property(lambda self: self.inner.launches,
                        lambda self, v: setattr(self.inner, "launches", v))

    def __call__(self, decay, prefix, dprefix, dfinal=None):
        out = self.inner(decay, prefix, dprefix, dfinal)
        self.calls += 1
        if self.calls == self.at:
            self.kept = [t if t is None else t.clone()
                         for t in (decay, prefix, dprefix, dfinal, *out)]
        return out

    def __enter__(self):
        self.sops.ssd_scan_bwd = self
        return self

    def __exit__(self, *exc):
        self.sops.ssd_scan_bwd = self.inner


def phase_mamba_train_layer(cfg, p_dev, dev):
    """One full-width Mamba-2 layer under the search, train mode, 1 x 1024
    tokens (4 chunks): every parameter's gradient on the card (K4, K5 and
    its backward) against the same layer on the CPU (plain versions),
    relative L2 within 1e-2."""
    from repro_torch.core import mps
    from repro_torch.models import lm
    from repro_torch.nn import blocks

    def leaves(device):
        out = {}
        for k, v in p_dev.items():
            if isinstance(v, dict):
                out[k] = {kk: t.detach().to(device).clone().requires_grad_()
                          for kk, t in v.items()}
            else:
                out[k] = v.detach().to(device).clone().requires_grad_()
        return out

    getw = lm._make_getw(cfg, mps.SearchCtx(tau=1.0))
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(1, 1024, cfg.d_model, generator=g,
                    device=dev).to(torch.bfloat16)
    up = torch.randn(1, 1024, cfg.d_model, generator=g, device=dev)
    grads = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        p = leaves(d)
        y, st = blocks.mamba2_layer(p, x.to(d), cfg, mode="train",
                                    effective_w=getw)
        (y.float() * up.to(d)).sum().backward()
        grads[where] = dict(_leaves({k: ({kk: t.grad for kk, t in v.items()}
                                         if isinstance(v, dict) else v.grad)
                                     for k, v in p.items()}))
        if st is not None:
            raise AssertionError("mamba train layer: train mode returned a "
                                 "state")
    rel = {}
    for k, want in grads["cpu"].items():
        got = grads["card"][k].cpu().double()
        want = want.double()
        rel[k] = float((got - want).norm() / want.norm().clamp_min(1e-30))
        if not (torch.isfinite(got).all() and rel[k] <= 1e-2):
            raise AssertionError(f"mamba train layer: {k}'s gradient on the "
                                 f"card vs the CPU, relative L2 {rel[k]} "
                                 f"(bound 1e-2)")
    worst = max(rel, key=rel.get)
    log(f"[mamba-train] one full-width layer under the search, train mode, "
        f"1 x 1024 tokens: all {len(rel)} parameter gradients on the card "
        f"(K4, K5, K5 backward) within 1e-2 relative L2 of the CPU's "
        f"(plain versions); largest {worst} {rel[worst]:.3g}, median "
        f"{float(np.median(list(rel.values()))):.3g}")
    return rel


def phase_train_mamba(dev, counters, smi):
    """Path 7: the paper's joint search on full-width mamba2-780m (48
    layers, remat, f32 master weights, adam at 3e-4, lam 1e-9, random
    weights from seed 0) through ``make_train_step(search=True)`` for
    MAMBA_STEPS steps of 4 x 2048 tokens (K5 scans 8 chunks of 256 a
    layer, forward and backward); launches read around the run; K5's
    backward on step 1's first layer held against its plain version; one
    layer's gradients card vs CPU; one step profiled; then the plan
    extracted, bound and served on K1 + K5."""
    from repro_torch.configs import registry
    from repro_torch.core import mps
    from repro_torch.data import synthetic
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import optimizers
    from repro_torch.serve import engine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request

    cfg = registry.get("mamba2-780m")
    pw = cfg.mps_precisions
    n_layers = cfg.n_layers
    n_proj = lm.mps_param_count(cfg) * lm.n_superblocks(cfg)
    if (n_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.ssm_chunk, n_proj) != \
            (48, 1536, 48, 64, 128, 256, 288) or not cfg.remat or \
            cfg.param_dtype != "float32" or cfg.optimizer != "adam":
        raise AssertionError(f"mamba train: unexpected config {cfg}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, mps_on=True)
    n_params = sum(t.numel() for k, t in _leaves(params)
                   if not k.endswith("gamma"))
    opt = optimizers.make_optimizer(cfg.optimizer, 3e-4)
    state = {"params": params, "opt": opt.init(params)}
    del params
    step_fn = steps_lib.make_train_step(cfg, opt, search=True, lam=1e-9)
    gamma0 = {k: t.clone() for k, t in _leaves(state["params"])
              if k.endswith("gamma")}

    def batch_at(step):
        return synthetic.lm_batch(cfg.vocab, MAMBA_SEQ + 1, MAMBA_BATCH,
                                  step, device=dev)

    batches = [batch_at(i) for i in range(MAMBA_STEPS)]
    chunks = MAMBA_SEQ // cfg.ssm_chunk
    log(f"[mamba-train] {cfg.name}: {n_layers} layers, d {cfg.d_model}, "
        f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab}, remat "
        f"{cfg.remat}, {cfg.param_dtype} master weights, {cfg.optimizer} at "
        f"3e-4, lam 1e-9; {n_params / 1e9:.3f} B parameters + "
        f"{len(gamma0)} gamma leaves ({n_proj} projections), pw {pw}; "
        f"search, batch {MAMBA_BATCH} x seq {MAMBA_SEQ} ({chunks} chunks a "
        f"layer); init {time.perf_counter() - t0:.2f} s")
    shape = (chunks, MAMBA_BATCH * cfg.ssm_heads, cfg.ssm_head_dim,
             cfg.ssm_state)
    plain, restore_plain = _count_plain_stack()
    # step 1's backward runs layer 47 first: its last K5 backward is
    # layer 0's
    capture = _CaptureK5Bwd(sops, at=n_layers)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    times, losses, norms = [], [], []
    try:
        for i, batch in enumerate(batches):
            t1 = time.perf_counter()
            if i == 0:
                with capture:
                    p, o, loss = step_fn(state["params"], state["opt"],
                                         batch, i)
            else:
                p, o, loss = step_fn(state["params"], state["opt"], batch, i)
            state = {"params": p, "opt": o}
            losses.append(float(loss))
            norms.append(float(step_fn.grad_norm))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            if i == 0:
                # K5's backward of step 1's layer 0 against its plain
                # version; then the peak is read over steps 2-4, which
                # hold no copy of it
                if capture.calls != n_layers or capture.kept is None:
                    raise AssertionError(f"mamba train: step 1 made "
                                         f"{capture.calls} K5 backward "
                                         f"calls, want {n_layers}")
                decay, prefix, dprefix, dfinal, *out = capture.kept
                capture.kept = None
                if tuple(prefix.shape) != shape:
                    raise AssertionError(f"mamba train: K5 backward took "
                                         f"{tuple(prefix.shape)}, want "
                                         f"{shape}")
                k5_err, k5_ratio = k5_bwd_check(out, decay, prefix, dprefix,
                                                dfinal, "step 1, layer 0")
                del decay, prefix, dprefix, dfinal, out
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
    finally:
        restore_plain()
    got = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    need = {"mps_combine": n_proj * MAMBA_STEPS * 2,      # + the recompute
            "mps_combine_bwd": n_proj * MAMBA_STEPS,
            "ssd_scan": n_layers * MAMBA_STEPS * 2,       # + the recompute
            "ssd_scan_bwd": n_layers * MAMBA_STEPS}
    if any(got[k] != v for k, v in need.items()) or any(
            v for k, v in got.items() if k not in need):
        raise AssertionError(f"mamba train: launches {got}, need {need} and "
                             f"no other kernel")
    if plain[0]:
        raise AssertionError(f"mamba train: {plain[0]} projections took the "
                             f"plain quantizer stack")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"mamba train: losses {losses}, grad norms "
                             f"{norms}")
    moved = [k for k, t in _leaves(state["params"])
             if k.endswith("gamma") and not torch.equal(t, gamma0[k])]
    if len(moved) != len(gamma0):
        raise AssertionError(f"mamba train: only {len(moved)} of "
                             f"{len(gamma0)} gamma leaves moved")
    del gamma0
    with torch.no_grad():
        cost = float(lm.mps_size_cost(cfg, state["params"],
                                      mps.SearchCtx(tau=1.0)))
    if not np.isfinite(cost):
        raise AssertionError(f"mamba train: mps_size_cost {cost}")
    ms = 1e3 * float(np.median(times[1:]))
    tok_s = MAMBA_BATCH * MAMBA_SEQ / (ms / 1e3)
    log(f"[mamba-train] {MAMBA_STEPS} search steps on "
        f"{torch.cuda.get_device_name(dev)} ({smi}): losses "
        f"{[round(v, 4) for v in losses]}, grad norms "
        f"{[round(v, 4) for v in norms]}; step ms "
        f"{[round(1e3 * t, 1) for t in times]}, median of steps "
        f"2-{MAMBA_STEPS} {ms:.1f} ms = {tok_s:.0f} training tokens/s; peak "
        f"memory over steps 2-{MAMBA_STEPS} {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated);"
        f" mps_size_cost {cost:.6g} bytes; launches K4 {got['mps_combine']} "
        f"forward = {n_proj} x {MAMBA_STEPS} x 2 (remat recompute), "
        f"{got['mps_combine_bwd']} backward = {n_proj} x {MAMBA_STEPS}; K5 "
        f"{got['ssd_scan']} forward = {n_layers} x {MAMBA_STEPS} x 2, "
        f"{got['ssd_scan_bwd']} backward = {n_layers} x {MAMBA_STEPS}; "
        f"plain quantizer stack: 0 calls; all gamma leaves moved")
    log(f"[mamba-train] K5 backward of step 1's layer 0 at {shape}: ds_in "
        f"and ds0 bitwise equal to the plain version, ddecay largest |diff| "
        f"{k5_err:.3g} = {k5_ratio:.3g} of its bound")
    layer_rel = phase_mamba_train_layer(
        cfg, lm._index(state["params"]["blocks"]["l0"]["mixer"], 0), dev)

    state, prof = train.profile_steps(step_fn, state, batch_at, MAMBA_STEPS,
                                      1, dev)
    busy = prof["device_s"] / prof["wall_s"]
    split = {label: sum(v for k, v in prof["kernels"].items() if key in k)
             for label, key in train.KERNEL_CLASSES}
    log(f"[mamba-train] one profiled step: wall {1e3 * prof['wall_s']:.1f} "
        f"ms, device {1e3 * prof['device_s']:.1f} ms = {100 * busy:.1f}% "
        f"busy, {prof['launches']} device operations; " + "; ".join(
            f"{label} {1e3 * v:.2f} ms = {100 * v / prof['device_s']:.2f}%"
            for label, v in split.items()))
    top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:8]
    log("[mamba-train] top kernels of the profiled step (device ms): "
        + "; ".join(f"{k[:60]} {1e3 * v:.2f}" for k, v in top))

    del state["opt"]
    params = state["params"]
    plan = lm.extract_plan(cfg, params)
    bits = {int(b) for v in plan.channel_bits.values() for b in v}
    if len(plan.groups) != n_proj or not bits <= set(pw) or \
            plan.meta != {"track": "lm", "arch": cfg.name}:
        raise AssertionError(f"mamba train: plan {plan.summary()}, bits "
                             f"{sorted(bits)}, meta {plan.meta}")
    t1 = time.perf_counter()
    server = engine.InferenceServer(cfg, params, plan=plan, max_len=128,
                                    max_batch=2, cache="paged", page_size=16,
                                    device=dev)
    setup = time.perf_counter() - t1
    seen = [0]
    _check_logits(server, seen)
    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=n).astype(
        np.int32), sampling=SamplingParams(max_tokens=8))
        for i, n in enumerate((37, 90))]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = server.serve(reqs)
    torch.cuda.synchronize()
    served = {k: fn.launches for k, fn in counters.items()}
    if any(len(out[i]) != 8 for i in range(2)) or not seen[0]:
        raise AssertionError(f"mamba train: served {out}")
    if not (served["quant_matmul"] and served["ssd_scan"]) or any(
            v for k, v in served.items()
            if k not in ("quant_matmul", "ssd_scan")):
        raise AssertionError(f"mamba train: serving the plan launched "
                             f"{served}, need K1 and K5 only")
    log(f"[mamba-train] searched plan: {plan.summary()}, bits "
        f"{sorted(bits)}; apply_plan + server {setup:.2f} s; served 2 "
        f"greedy requests x 8 tokens (prompts 37, 90) on the paged backend, "
        f"{seen[0]} logits rows finite; launches {served}")
    return dict(launches=got, served=served, ms=ms, tok_s=tok_s,
                peak_bytes=peak, busy=busy, split=split, layer_rel=layer_rel,
                k5_err=k5_err)


def phase_resume(dev):
    """Resume on the card at llama3.2-1b-smoke under deterministic
    algorithms: 4 uninterrupted search steps against 2 steps, a
    checkpoint, the state restored by ``restore_latest`` into a freshly
    built template, and 2 more -- every parameter and moment bit for
    bit."""
    import os
    import tempfile

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.optim import optimizers

    cfg = registry.get("llama3.2-1b-smoke")
    opt = optimizers.make_optimizer(cfg.optimizer, 3e-4)
    step_fn = steps_lib.make_train_step(cfg, opt, search=True)

    def fresh():
        p = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev, mps_on=True)
        return {"params": p, "opt": opt.init(p)}

    def run(state, steps):
        for i in steps:
            b = synthetic.lm_batch(cfg.vocab, 65, 4, i, device=dev)
            p, o, _ = step_fn(state["params"], state["opt"], b, i)
            state = {"params": p, "opt": o}
        return state

    # cuBLAS is deterministic under this workspace setting, which
    # torch.use_deterministic_algorithms requires
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        full = run(fresh(), range(4))
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, keep=2)
            mgr.save(1, run(fresh(), range(2)))
            restored, meta = mgr.restore_latest(fresh())
            resumed = run(restored, range(meta["step"] + 1, 4))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = dict(_leaves(full)), dict(_leaves(resumed))
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    if sorted(a) != sorted(b) or bad:
        raise AssertionError(f"resume: {len(bad)} of {len(a)} leaves differ "
                             f"from the uninterrupted run: {bad[:4]}")
    log(f"[resume] {cfg.name} on the card, deterministic algorithms: 2 steps "
        f"+ checkpoint + restore_latest into a fresh template + 2 steps == 4 "
        f"uninterrupted steps, all {len(a)} parameter and moment leaves bit "
        f"for bit")


# path 5: the paper's Pareto-front sweep (sweep/, launch/sweep.py)
SWEEP_GSC = dict(name="gsc", track="cnn", bench="gsc", width=64,
                 lams=(2.0, 20.0), adaptive_points=1, warmup_steps=8,
                 search_steps=8, finetune_steps=4, batch=32,
                 eval_batches=2, checkpoint_every=4)
SWEEP_C10 = dict(SWEEP_GSC, name="c10", bench="cifar10", width=16,
                 adaptive_points=0)
# lm_lr as launch/train.py's: the spec's default 0.05 (sized for the
# smoke archs) took full-width llama3.2-1b's loss to NaN in 5 steps
SWEEP_LM = dict(name="lm", track="lm", bench="llama3.2-1b",
                lams=(0.5, 4.0), search_steps=4, batch=4, seq=256,
                lm_lr=3e-4, eval_batches=1, checkpoint_every=0)


def _sweep_runner_cls():
    """``SweepRunner`` timing each executed point (synchronised) and each
    warm-start handoff write and read, with the handoff's bytes."""
    from repro_torch import sweep

    class Timed(sweep.SweepRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.points, self.handoffs = [], []

        def _execute_point(self, index, name, lam, points, hooks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = super()._execute_point(index, name, lam, points, hooks)
            torch.cuda.synchronize()
            self.points.append((name, rec["steps"],
                                time.perf_counter() - t0))
            return rec

        def _save_handoff(self, index, tree):
            t0 = time.perf_counter()
            super()._save_handoff(index, tree)
            path = self._ptdir(index, "handoff")
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
            self.handoffs.append(("write", index, nbytes,
                                  time.perf_counter() - t0))

        def _load_handoff(self, index, template):
            t0 = time.perf_counter()
            tree = super()._load_handoff(index, template)
            torch.cuda.synchronize()
            self.handoffs.append(("read", index, None,
                                  time.perf_counter() - t0))
            return tree

    return Timed


def _store_fingerprint(store):
    """Entry JSON bytes, plan hashes and the front: what the sweep's
    kill/resume byte identity compares."""
    entries = {}
    for name in store.names():
        with open(store._entry_path(name), "rb") as f:
            entries[name] = f.read()
    return (entries, sorted(e["plan"] for e in store.entries()),
            [e["name"] for e in store.front()])


def _search_steps_needed(store, spec, kind="point"):
    """JointSearch steps the stored entries of one sweep took: a cold
    point (or a baseline) ``search_steps``, a warm one ``warm_search()``
    -- from the spec, as the runner's recipe is built."""
    return sum(spec.warm_search() if e["lineage"]["warm"]
               else spec.search_steps
               for e in store.query(kind=kind, sweep=spec.name))


class _Counting:
    """Kernel launch counts read as differences between snapshots."""

    def __init__(self, counters):
        self.counters = counters
        for fn in counters.values():
            fn.launches = 0
        self.total = {k: 0 for k in counters}
        self._last = dict(self.total)

    def take(self):
        torch.cuda.synchronize()
        now = {k: fn.launches for k, fn in self.counters.items()}
        got = {k: now[k] - self._last[k] for k in now}
        self._last = now
        self.total = now
        return got


def _sweep_points_log(tag, runner, smi):
    for name, steps, sec in runner.points:
        log(f"[sweep] {tag} {name}: {steps} steps in {sec:.2f} s = "
            f"{1e3 * sec / steps:.0f} ms a step with set-up and evaluation "
            f"({smi})")


def _cnn_sweep_gate(tag, got, n_nodes, need_steps, counted_steps):
    need = n_nodes * need_steps
    if counted_steps != need_steps or any(
            got[k] != need for k in ("mps_combine", "mps_combine_bwd")) \
            or any(v for k, v in got.items()
                   if k not in ("mps_combine", "mps_combine_bwd")):
        raise AssertionError(
            f"sweep {tag}: launches {got}, JointSearch steps counted "
            f"{counted_steps}; need {n_nodes} nodes x {need_steps} steps = "
            f"{need} each way and no other kernel")
    log(f"[sweep] {tag}: K4 launches {got['mps_combine']} forward, "
        f"{got['mps_combine_bwd']} backward; derived {n_nodes} weight nodes "
        f"x {need_steps} JointSearch steps (search_steps a cold point, "
        f"warm_search() a warm one) = {need} each")


def _check_entries_finite(tag, store):
    for e in store.entries():
        vals = list(e["metrics"].values()) + list(e["costs"].values())
        if not all(np.isfinite(vals)):
            raise AssertionError(f"sweep {tag}: {e['name']} has non-finite "
                                 f"metrics/costs {e['metrics']} {e['costs']}")


def phase_sweep(dev, counters, smi):
    """Path 5: the paper's Pareto-front sweep through
    ``repro_torch.sweep.SweepRunner`` at full width -- DS-CNN (gsc, width
    64) uninterrupted and killed-then-resumed into a byte-identical
    store, its w8 / w2 baselines and iso-accuracy report; ResNet-9
    (cifar10, width 16), two points; llama3.2-1b, two points, its front
    plan loaded from the store and served on K1-K3."""
    import shutil
    import tempfile

    from repro_torch import sweep
    from repro_torch.api import phases
    from repro_torch.configs import registry
    from repro_torch.models import cnn, lm
    from repro_torch.serve import engine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request

    Timed = _sweep_runner_cls()
    root = tempfile.mkdtemp(prefix="sweep_")

    class StepCount(phases.Hook):
        """JointSearch steps run (counted) and the LM's losses."""

        def __init__(self):
            self.search, self.losses = 0, []

        def on_step(self, phase, state, step, metrics, train_state):
            self.search += phase.name == "search"
            if phase.name == "lm_search":
                self.losses.append(float(metrics["loss"]))

    class Boom(phases.Hook):
        """Kill the sweep in the second point's finetune."""

        def __init__(self):
            self.finetunes, self.armed = 0, True

        def on_phase_start(self, phase, state):
            self.finetunes += phase.name == "finetune"

        def on_step(self, phase, state, step, metrics, train_state):
            if self.armed and phase.name == "finetune" and \
                    self.finetunes == 2:
                self.armed = False
                raise RuntimeError("boom")

    def runner(spec, sub, cls=Timed):
        store = sweep.PlanStore(os.path.join(root, sub, "store"))
        return cls(spec, store, os.path.join(root, sub, "work"),
                   device=dev, verbose=True), store

    plain, restore = _count_plain_stack()
    count = _Counting(counters)
    out = {}
    t_phase = time.perf_counter()
    try:
        # ---- gsc, DS-CNN at its published width 64, deterministic
        spec = sweep.SweepSpec(**SWEEP_GSC)
        n_nodes = len(cnn.dscnn(width=spec.width).weight_nodes())
        old = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        try:
            ra, sa = runner(spec, "gsc_a")
            hook = StepCount()
            count.take()
            sum_a = ra.run(hooks=[hook])
            _cnn_sweep_gate("gsc uninterrupted", count.take(), n_nodes,
                            _search_steps_needed(sa, spec), hook.search)
            rb, sb = runner(spec, "gsc_b")
            hook_b = StepCount()
            try:
                rb.run(hooks=[Boom(), hook_b])
                raise AssertionError("sweep: the kill hook never fired")
            except RuntimeError as e:
                if str(e) != "boom":
                    raise
            killed = sb.names()
            rb2, sb = runner(spec, "gsc_b")
            sum_b = rb2.run(hooks=[hook_b])
            _cnn_sweep_gate("gsc killed + resumed", count.take(), n_nodes,
                            _search_steps_needed(sb, spec), hook_b.search)
        finally:
            torch.use_deterministic_algorithms(False)
            if old is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = old
        fa, fb = _store_fingerprint(sa), _store_fingerprint(sb)
        if fa != fb or sum_b["loaded"] != 1:
            raise AssertionError(f"sweep: killed-and-resumed store differs "
                                 f"from the uninterrupted one: {fa[2]} vs "
                                 f"{fb[2]}, plans {fa[1]} vs {fb[1]}, "
                                 f"resume {sum_b}")
        log(f"[sweep] gsc (dscnn width {spec.width}, {n_nodes} weight "
            f"nodes, batch {spec.batch}, lams {spec.lams} + "
            f"{spec.adaptive_points} adaptive): points {sum_a['points']}, "
            f"front {sum_a['front']}; killed in the second point's "
            f"finetune with {killed} stored, resumed "
            f"({sum_b['loaded']} loaded, {sum_b['executed']} executed): "
            f"{len(fa[0])} entry JSONs byte-identical, plan hashes and "
            f"front equal, under deterministic algorithms")
        _sweep_points_log("gsc", ra, smi)
        for e in sa.entries():
            log(f"[sweep] gsc {e['name']}: lam {e['lineage']['lam']:g}, "
                f"warm {e['lineage']['warm']}, score "
                f"{e['metrics']['score']:.4f}, size {e['costs']['size']:.1f}"
                f" bytes, pruned {e['metrics']['prune_fraction']:.3f}, plan "
                f"{e['plan'][:12]}")
        rh, _ = runner(spec, "gsc_a")
        count.take()
        hits = rh.run()
        got = count.take()
        if hits["executed"] or any(got.values()):
            raise AssertionError(f"sweep: store hits ran {hits} and "
                                 f"launched {got}")
        log(f"[sweep] gsc again over the same store: {hits['loaded']} "
            f"store hits, 0 executed, no kernel launched")
        hook = StepCount()
        for bits in (8, 2):
            ra.baseline(bits, hooks=[hook])
        _cnn_sweep_gate("gsc w8 + w2 baselines", count.take(), n_nodes,
                        _search_steps_needed(sa, spec, kind="baseline"),
                        hook.search)
        iso = ra.iso_report()
        for label, row in iso.items():
            log(f"[sweep] gsc iso-accuracy vs {label}: baseline score "
                f"{row['baseline_score']:.4f}, size "
                f"{row['baseline_cost']:.1f} bytes, reduction "
                f"{row['reduction_pct']}%")
        log("[sweep] these accuracies come from synthetic data "
            "(synthetic.GSC_LIKE) after a few steps, so the reductions are "
            "not the paper's numbers")
        _check_entries_finite("gsc", sa)

        # ---- cifar10, ResNet-9 at width 16: one cold, one warm point
        spec = sweep.SweepSpec(**SWEEP_C10)
        n_nodes = len(cnn.resnet9(width=spec.width).weight_nodes())
        rc, sc = runner(spec, "c10")
        hook = StepCount()
        sum_c = rc.run(hooks=[hook])
        _cnn_sweep_gate("cifar10", count.take(), n_nodes,
                        _search_steps_needed(sc, spec), hook.search)
        if sum_c["points"] != ["c10.pt00", "c10.pt01"]:
            raise AssertionError(f"sweep cifar10: {sum_c}")
        _check_entries_finite("cifar10", sc)
        _sweep_points_log("cifar10", rc, smi)

        # ---- lm track, full-width llama3.2-1b
        spec = sweep.SweepSpec(**SWEEP_LM)
        cfg = registry.get(spec.bench)
        n_proj = lm.mps_param_count(cfg) * lm.n_superblocks(cfg)
        rl, sl = runner(spec, "lm")
        hook = StepCount()
        count.take()
        sum_l = rl.run(hooks=[hook])
        got = count.take()
        steps = sum(e["lineage"]["steps"] for e in sl.entries())
        n_pts = len(sl.names())
        fwd_a_step = 2 if cfg.remat else 1       # remat recomputes it
        need = {"mps_combine": n_proj * (fwd_a_step * steps
                                         + spec.eval_batches * n_pts),
                "mps_combine_bwd": n_proj * steps}
        if any(got[k] != v for k, v in need.items()) or any(
                v for k, v in got.items() if k not in need):
            raise AssertionError(f"sweep lm: launches {got}, need {need} "
                                 f"and no other kernel")
        if not all(np.isfinite(hook.losses)) or len(hook.losses) != steps:
            raise AssertionError(f"sweep lm: losses {hook.losses}")
        _check_entries_finite("lm", sl)
        log(f"[sweep] lm ({cfg.name}, {n_proj} projections, batch "
            f"{spec.batch} x seq {spec.seq}, lams {spec.lams}): points "
            f"{sum_l['points']}, front {sum_l['front']}; losses "
            f"{[round(v, 4) for v in hook.losses]}; K4 launches "
            f"{got['mps_combine']} forward = {n_proj} x ({steps} steps x "
            f"{fwd_a_step} (remat {cfg.remat}) + {spec.eval_batches} eval "
            f"batch x {n_pts} points), "
            f"{got['mps_combine_bwd']} backward = {n_proj} x {steps}")
        for e in sl.entries():
            log(f"[sweep] lm {e['name']}: lam {e['lineage']['lam']:g}, warm "
                f"{e['lineage']['warm']}, eval loss "
                f"{e['metrics']['eval_loss']:.4f}, size "
                f"{e['costs']['size'] / 1e6:.3f} MB, plan {e['plan'][:12]}")
        _sweep_points_log("lm", rl, smi)

        # the front's first plan, loaded from the store, served on K1-K3
        first = sl.front(sl.query(kind="point", sweep=spec.name))[0]
        plan = sl.load(first["name"])
        params = rl._load_handoff(first["lineage"]["index"],
                                  {"params": rl._lm_init(cfg)})["params"]
        for kind, index, nbytes, sec in rl.handoffs:
            log(f"[sweep] lm handoff {kind} pt{index:02d}: "
                + (f"{nbytes / 1e9:.3f} GB, " if nbytes else "")
                + f"{sec:.2f} s ({smi})")
        server = engine.InferenceServer(cfg, params, plan=plan, max_len=128,
                                        max_batch=2, cache="paged",
                                        page_size=16, device=dev)
        seen = [0]
        _check_logits(server, seen)
        rng = np.random.default_rng(11)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=n)
                        .astype(np.int32),
                        sampling=SamplingParams(max_tokens=8))
                for i, n in enumerate((37, 90))]
        count.take()
        served_out = server.serve(reqs)
        served = count.take()
        if any(len(served_out[i]) != 8 for i in range(2)) or not seen[0]:
            raise AssertionError(f"sweep: served {served_out}")
        for k in ("quant_matmul", "paged_attention", "paged_prefill"):
            if not served[k]:
                raise AssertionError(f"sweep: serving the swept plan never "
                                     f"launched {k}: {served}")
        log(f"[sweep] lm front plan {first['name']} ({plan.summary()}) "
            f"loaded from the store and served: 2 greedy requests x 8 "
            f"tokens on the paged cache, {seen[0]} logits rows finite; "
            f"launches {served}")
        del server, params
        if plain[0]:
            raise AssertionError(f"sweep: {plain[0]} weights took the plain "
                                 f"quantizer stack on the card")
        out.update(launches=dict(count.total), served=served)
    finally:
        restore()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[sweep] path 5 in {time.perf_counter() - t_phase:.1f} s; K4 "
        f"launches over the path {out['launches']['mps_combine']} forward, "
        f"{out['launches']['mps_combine_bwd']} backward; plain quantizer "
        f"stack: 0 calls; workdir {root} removed")
    return out


# ---------------------------------------------------------------------------
# path 8: enc-dec training under the search (seamless-m4t-medium)
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_STEPS, ENCDEC_BATCH, ENCDEC_SEQ, ENCDEC_FRAMES = 4, 4, 256, 512
ENCDEC_PROMPTS, ENCDEC_NEW = (37, 90), 8


def _enc_frames(cfg, b, n, seed, dev):
    """The audio frontend stub's encoder frames: (b, n, d) bf16, 0.1 x a
    seeded normal draw on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (0.1 * torch.randn(b, n, cfg.d_model, generator=g,
                              device=dev)).to(torch.bfloat16)


def phase_encdec_train_layer(cfg, blk, dev):
    """One full-width decoder super-block of the enc-dec stack (self
    attention, cross attention, FFN) under the search, train mode, 1 x 256
    tokens against 512 encoder frames: every parameter's gradient on the
    card (K4 for the self attention and the FFN; the cross attention's
    raw f32 weights promote the rest of the layer to f32) against the
    same layer on the CPU (plain versions), relative L2 within 1e-2."""
    from repro_torch.core import mps
    from repro_torch.models import lm

    def leaves(tree, device):
        if isinstance(tree, dict):
            return {k: leaves(v, device) for k, v in tree.items()}
        return tree.detach().to(device).clone().requires_grad_()

    getw = lm._make_getw(cfg, mps.SearchCtx(tau=1.0))
    g = torch.Generator(device=dev).manual_seed(11)
    x = (torch.randn(1, ENCDEC_SEQ, cfg.d_model, generator=g, device=dev)
         ).to(torch.bfloat16)
    enc = _enc_frames(cfg, 1, ENCDEC_FRAMES, 12, dev)
    up = torch.randn(1, ENCDEC_SEQ, cfg.d_model, generator=g, device=dev)
    grads = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        p = leaves(blk, d)
        y, _, _ = lm._superblock(
            cfg, lm.block_pattern(cfg), p, x.to(d), x.to(d), mode="train",
            caches=None, j=0, pos=None, getw=getw, tables=None,
            enc_out=enc.to(d))
        if y.dtype != torch.float32:
            raise AssertionError(f"encdec train layer: the float cross "
                                 f"attention left a {y.dtype} stream")
        (y.float() * up.to(d)).sum().backward()
        # the cross gammas have none: the cross projections take the raw
        # weights, so only the size cost reaches their gammas
        grads[where] = {k: t.grad for k, t in _leaves(p)
                        if t.grad is not None}
    if sorted(grads["card"]) != sorted(grads["cpu"]) or any(
            "/cross/" in k and k.endswith("gamma") for k in grads["cpu"]):
        raise AssertionError(f"encdec train layer: gradients of "
                             f"{sorted(grads['card'])} on the card, "
                             f"{sorted(grads['cpu'])} on the CPU")
    rel = {}
    for k, want in grads["cpu"].items():
        got = grads["card"][k].cpu().double()
        want = want.double()
        rel[k] = float((got - want).norm() / want.norm().clamp_min(1e-30))
        if not (torch.isfinite(got).all() and rel[k] <= 1e-2):
            raise AssertionError(f"encdec train layer: {k}'s gradient on the "
                                 f"card vs the CPU, relative L2 {rel[k]} "
                                 f"(bound 1e-2)")
    worst = max(rel, key=rel.get)
    log(f"[encdec-train] one full-width decoder layer under the search, "
        f"train mode, 1 x {ENCDEC_SEQ} tokens against {ENCDEC_FRAMES} encoder "
        f"frames: all {len(rel)} parameter gradients on the card (K4; the "
        f"cross attention's raw weights) within 1e-2 relative L2 of the "
        f"CPU's (plain versions); largest {worst} {rel[worst]:.3g}, median "
        f"{float(np.median(list(rel.values()))):.3g}")
    return rel


def _k1_groups(tree, skip=()):
    """Launches of K1 one call of every PackedLinear in ``tree`` (a tree
    or a plan-bound tuple of them) makes, one a precision group, leaving
    out paths holding a name in ``skip``."""
    from repro_torch.nn import quantized as nnq
    n = 0
    for blk in tree if isinstance(tree, (list, tuple)) else [tree]:
        for path, leaf in _leaves(blk):
            if isinstance(leaf, nnq.PackedLinear) and \
                    not any(s in path.split("/") for s in skip):
                n += len(leaf.bits)
    return n


def encdec_k1_cases(bound):
    """(M, K, N, bits) K1 takes on path 8's decode of its searched plan
    ``bound``: every precision group of every decoder PackedLinear at
    the decode M (1 alone, 2 batched) and the prompts' lengths, the cross
    wk / wv also at the encoder's frames (their prefill M), and
    seamless's full (K, N) at 8/4/2 bits at each of those M."""
    from repro_torch.nn import quantized as nnq

    ms = (1, len(ENCDEC_PROMPTS)) + ENCDEC_PROMPTS
    cases, full = set(), set()
    for blk in bound["blocks"]:
        for path, leaf in _leaves(blk):
            if not isinstance(leaf, nnq.PackedLinear):
                continue
            full.add((leaf.n_in, leaf.n_out))
            kv = path.split("/")[-2:] in (["cross", "wk"], ["cross", "wv"])
            for b, _, sw in leaf.groups:
                cases.update((m, leaf.n_in, sw.shape[0], b)
                             for m in ms + (ENCDEC_FRAMES,) * kv)
    cases.update((m, kk, n, b) for kk, n in full for b in (8, 4, 2)
                 for m in ms + (ENCDEC_FRAMES,))
    return sorted(cases)


def _encdec_decode(cfg, params, prompts, frames, dev, counters=None):
    """Each request prefilled alone into dense caches with its encoder
    frames, the caches copied into one ``init_caches(max_len, enc_len)``
    tree, then greedy decode of the whole batch.  Returns (tokens (B,
    ENCDEC_NEW), launches of the run or None, finite)."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm

    b = len(prompts)
    max_len = max(len(p) for p in prompts) + ENCDEC_NEW
    caches = lm.init_caches(cfg, b, max_len, enc_len=frames.shape[1],
                            device=dev)
    prefill = steps_lib.make_prefill_step(cfg)
    decode = steps_lib.make_decode_step(cfg)
    if counters:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
    finite = True
    toks = []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            logits, pc = prefill(params, {
                "tokens": torch.as_tensor(p[None], device=dev),
                "enc_embeddings": frames[i:i + 1]})
            finite &= bool(torch.isfinite(logits).all())
            for ln, c in caches.items():
                for kind, kv in c.items():
                    for k, big in kv.items():
                        small = pc[ln][kind][k]
                        big[:, i:i + 1, :small.shape[2]] = small.to(big.dtype)
            toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab])))
        out = [toks]
        pos = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                              device=dev)
        for _ in range(ENCDEC_NEW - 1):
            logits, caches = decode(params, {"tokens": torch.as_tensor(
                out[-1], device=dev)[:, None]}, caches, pos)
            finite &= bool(torch.isfinite(logits).all())
            out.append(torch.argmax(logits[:, -1, :cfg.vocab], -1).tolist())
            pos = pos + 1
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in counters.items()} if counters \
        else None
    return np.asarray(out).T, got, finite


def phase_train_encdec(dev, counters, smi):
    """Path 8: the paper's joint search on full-width seamless-m4t-medium
    (12 encoder + 12 decoder layers; remat, f32 master weights, adam at
    3e-4, lam 1e-9, random weights from seed 0) through
    ``make_train_step(search=True)`` for ENCDEC_STEPS steps on decoder
    tokens and the audio frontend stub's encoder frames; K4's launches
    read around the run; one decoder layer's gradients card vs CPU; one
    more step profiled; then the searched plan extracted, bound (the
    cross projections on K1, the encoder stacked and float) and decoded
    greedily on K1 from dense caches."""
    from repro_torch.configs import registry
    from repro_torch.core import mps
    from repro_torch.data import synthetic
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import optimizers
    from repro_torch.serve import engine

    cfg = registry.get(ENCDEC_ARCH)
    pw = cfg.mps_precisions
    n_k4 = sum(k4_lm_shapes(ENCDEC_ARCH).values())
    n_gamma = lm.mps_param_count(cfg)
    if (cfg.n_layers, cfg.enc_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.d_ff, lm.padded_vocab(cfg), n_k4, n_gamma) != \
            (12, 12, 1024, 16, 64, 4096, 256256, 168, 18) or \
            not cfg.remat or cfg.param_dtype != "float32" or \
            cfg.optimizer != "adam":
        raise AssertionError(f"encdec train: unexpected config {cfg}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, mps_on=True)
    n_params = sum(t.numel() for k, t in _leaves(params)
                   if not k.endswith("gamma"))
    opt = optimizers.make_optimizer(cfg.optimizer, 3e-4)
    state = {"params": params, "opt": opt.init(params)}
    del params
    step_fn = steps_lib.make_train_step(cfg, opt, search=True, lam=1e-9)
    gamma0 = {k: t.clone() for k, t in _leaves(state["params"])
              if k.endswith("gamma")}

    def batch_at(step):
        b = synthetic.lm_batch(cfg.vocab, ENCDEC_SEQ + 1, ENCDEC_BATCH, step,
                               device=dev)
        b["enc_embeddings"] = _enc_frames(cfg, ENCDEC_BATCH, ENCDEC_FRAMES,
                                          100 + step, dev)
        return b

    batches = [batch_at(i) for i in range(ENCDEC_STEPS)]
    log(f"[encdec-train] {cfg.name}: {cfg.enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d {cfg.d_model}, {cfg.n_heads} "
        f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded "
        f"{lm.padded_vocab(cfg)}), remat {cfg.remat}, {cfg.param_dtype} "
        f"master weights, {cfg.optimizer} at 3e-4, lam 1e-9; "
        f"{n_params / 1e9:.3f} B parameters + {len(gamma0)} gamma leaves "
        f"({n_gamma} gamma-carrying projections a pattern, {n_k4} reach K4: "
        f"the 48 cross projections take raw weights); search, batch "
        f"{ENCDEC_BATCH} x {ENCDEC_SEQ} decoder tokens, {ENCDEC_FRAMES} "
        f"encoder frames (bf16, 0.1 x a seeded normal); init "
        f"{time.perf_counter() - t0:.2f} s")
    plain, restore = _count_plain_stack()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    times, losses, norms = [], [], []
    try:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            p, o, loss = step_fn(state["params"], state["opt"], batch, i)
            state = {"params": p, "opt": o}
            losses.append(float(loss))
            norms.append(float(step_fn.grad_norm))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        restore()
    got = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    need = {"mps_combine": n_k4 * ENCDEC_STEPS * 2,     # + the recompute
            "mps_combine_bwd": n_k4 * ENCDEC_STEPS}
    if any(got[k] != v for k, v in need.items()) or any(
            v for k, v in got.items() if k not in need):
        raise AssertionError(f"encdec train: launches {got}, need {need} "
                             f"and no other kernel")
    if plain[0]:
        raise AssertionError(f"encdec train: {plain[0]} projections took the "
                             f"plain quantizer stack")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"encdec train: losses {losses}, grad norms "
                             f"{norms}")
    moved = [k for k, t in _leaves(state["params"])
             if k.endswith("gamma") and not torch.equal(t, gamma0[k])]
    cross = [k for k in gamma0 if "/cross/" in k]
    if len(moved) != len(gamma0) or len(cross) != 4:
        raise AssertionError(f"encdec train: {len(moved)} of {len(gamma0)} "
                             f"gamma leaves moved ({len(cross)} cross)")
    del gamma0
    ms = 1e3 * float(np.median(times[1:]))
    tok_s = ENCDEC_BATCH * ENCDEC_SEQ / (ms / 1e3)
    log(f"[encdec-train] {ENCDEC_STEPS} search steps on "
        f"{torch.cuda.get_device_name(dev)} ({smi}): losses "
        f"{[round(v, 4) for v in losses]}, grad norms "
        f"{[round(v, 4) for v in norms]}; step ms "
        f"{[round(1e3 * t, 1) for t in times]}, median of steps "
        f"2-{ENCDEC_STEPS} {ms:.1f} ms = {tok_s:.0f} training tokens/s "
        f"(decoder target tokens; with the {ENCDEC_BATCH * ENCDEC_FRAMES} "
        f"encoder frames a step "
        f"{ENCDEC_BATCH * (ENCDEC_SEQ + ENCDEC_FRAMES) / (ms / 1e3):.0f} "
        f"positions/s); peak memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); K4 launches "
        f"{got['mps_combine']} forward = {n_k4} x {ENCDEC_STEPS} x 2 (remat "
        f"recomputes both stacks), {got['mps_combine_bwd']} backward = "
        f"{n_k4} x {ENCDEC_STEPS}; plain quantizer stack: 0 calls; all "
        f"{len(moved)} gamma leaves moved, the 4 cross ones included")
    layer_rel = phase_encdec_train_layer(
        cfg, lm._index(state["params"]["blocks"], 0), dev)

    state, prof = train.profile_steps(step_fn, state, batch_at, ENCDEC_STEPS,
                                      1, dev)
    k4_s = sum(v for k, v in prof["kernels"].items() if "mps_" in k)
    busy = prof["device_s"] / prof["wall_s"]
    log(f"[encdec-train] one profiled step: wall {1e3 * prof['wall_s']:.1f} "
        f"ms, device {1e3 * prof['device_s']:.1f} ms = {100 * busy:.1f}% "
        f"busy, {prof['launches']} device operations; K4 {1e3 * k4_s:.2f} ms"
        f" = {100 * k4_s / prof['device_s']:.2f}% of device time")
    top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:8]
    log("[encdec-train] top kernels of the profiled step (device ms): "
        + "; ".join(f"{k[:60]} {1e3 * v:.2f}" for k, v in top))

    del state["opt"]
    params = state["params"]
    with torch.no_grad():
        cost = float(lm.mps_size_cost(cfg, params, mps.SearchCtx(tau=1.0)))
    plan = lm.extract_plan(cfg, params)
    bits = {int(b) for v in plan.channel_bits.values() for b in v}
    n_groups = len(lm._plan_weights(cfg)) * lm.n_superblocks(cfg)
    if len(plan.groups) != n_groups or n_groups != 132 or \
            not bits <= set(pw) or not np.isfinite(cost):
        raise AssertionError(f"encdec train: plan {plan.summary()}, bits "
                             f"{sorted(bits)}, size cost {cost}")
    t0 = time.perf_counter()
    bound = engine.apply_plan(cfg, params, plan)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if not isinstance(bound["blocks"], tuple) or \
            isinstance(bound["enc_blocks"], tuple):
        raise AssertionError("encdec: apply_plan must unroll blocks and "
                             "leave enc_blocks stacked")
    k1_cases = encdec_k1_cases(bound)
    k1_err = _k1_bitwise(dev, k1_cases, 8, "seamless")
    log(f"[encdec-train] K1 quant_matmul at the decode's shapes: bitwise "
        f"equal to the int32 plain version in {len(k1_cases)} cases, M in "
        f"{sorted({c[0] for c in k1_cases})}, K in "
        f"{sorted({c[1] for c in k1_cases})}: the projections' full widths "
        f"at 8/4/2 bits and every precision group of the searched plan (N "
        f"from {min(c[2] for c in k1_cases)} to "
        f"{max(c[2] for c in k1_cases)}; M {ENCDEC_FRAMES} for the cross "
        f"wk / wv over the encoder frames)")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in ENCDEC_PROMPTS]
    frames = _enc_frames(cfg, len(prompts), ENCDEC_FRAMES, 200, dev)
    toks, served, finite = _encdec_decode(cfg, bound, prompts, frames, dev,
                                          counters)
    # a prefill runs every planned projection, the cross wk / wv on the
    # encoder's output included; a decode step reads the cached encoder
    # K/V, so its cross attention runs wq and wo only
    per_adm = _k1_groups(bound["blocks"])
    per_step = _k1_groups(bound["blocks"], skip=("wk", "wv")) + \
        sum(_k1_groups(blk["l0"]["mixer"], skip=("wq", "wo"))
            for blk in bound["blocks"])
    need = len(prompts) * per_adm + (ENCDEC_NEW - 1) * per_step
    if served["quant_matmul"] != need or any(
            v for k, v in served.items() if k != "quant_matmul"):
        raise AssertionError(f"encdec decode: launches {served}, need K1 "
                             f"{need} and no other kernel")
    solo = [_encdec_decode(cfg, bound, [p], frames[i:i + 1], dev)[0][0]
            for i, p in enumerate(prompts)]
    if not finite or toks.shape != (len(prompts), ENCDEC_NEW) or any(
            not np.array_equal(toks[i], solo[i]) for i in range(len(solo))):
        raise AssertionError(f"encdec decode: batched {toks.tolist()}, solo "
                             f"{[s.tolist() for s in solo]}, finite {finite}")
    log(f"[encdec-train] searched plan: {plan.summary()}, bits "
        f"{sorted(bits)}, mps_size_cost {cost:.6g} bytes; apply_plan "
        f"{setup:.2f} s (132 groups on K1, the encoder stacked and float); 2 "
        f"requests (prompts {list(ENCDEC_PROMPTS)}, {ENCDEC_FRAMES} encoder "
        f"frames each) prefilled into dense caches and decoded greedily, "
        f"{ENCDEC_NEW} tokens each: finite logits, batched == solo; K1 "
        f"launched {served['quant_matmul']} = {len(prompts)} x {per_adm} a "
        f"prefill + {ENCDEC_NEW - 1} x {per_step} a decode step (cross wq "
        f"and wo only: decode reads the cached encoder K/V), no other "
        f"kernel")
    return dict(launches=got, served=served, ms=ms, tok_s=tok_s,
                peak_bytes=peak, busy=busy, k4_share=k4_s / prof["device_s"],
                k4_ms=1e3 * k4_s, layer_rel_max=max(layer_rel.values()),
                k1_cases=len(k1_cases), k1_max_abs_err=k1_err)


# ---------------------------------------------------------------------------
# path 9: VLM prefill from patch embeddings and decode (qwen2-vl-72b)
# ---------------------------------------------------------------------------

VLM_ARCH, VLM_LAYERS = "qwen2-vl-72b", 16
VLM_LENS, VLM_NEW, VLM_FLOAT = (1024, 2000, 3136, 4100), 16, 2
VLM_PS = 16
VLM_MAX_LEN = -(-(max(VLM_LENS) + VLM_NEW) // VLM_PS) * VLM_PS    # 4128
VLM_PROFILED = 4                # decode steps under the profiler


def _vlm_cfg():
    import dataclasses

    from repro_torch.configs import registry
    return dataclasses.replace(registry.get(VLM_ARCH), n_layers=VLM_LAYERS,
                               param_dtype="bfloat16")


def _patches(cfg, n, seed, dev):
    """The vision frontend stub's patch embeddings of one request: (1, n,
    d) bf16, 0.1 x a seeded normal draw on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (0.1 * torch.randn(1, n, cfg.d_model, generator=g,
                              device=dev)).to(torch.bfloat16)


def _vlm_serve(cfg, params, reqs, dev, counters, profile=False):
    """Paged prefill of every request from its patch embeddings (padded to
    a 16-row q chunk, straight into a ``serve.cache.PagedCache``'s pages,
    K3) then VLM_NEW greedy decode steps of the batch, each fed the
    generated tokens at per-slot positions (K2), through ``lm.forward``
    and ``lm.decode_step``.  ``reqs``: [(seed, length)].  Returns (tokens
    (B, VLM_NEW + 1), launches, finite, the profiled decode steps' device
    split or None, admissions)."""
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.serve import cache as cache_mod

    backend = cache_mod.PagedCache(cfg, len(reqs), VLM_MAX_LEN, dev,
                                   page_size=VLM_PS)
    prefill = steps_lib.make_paged_prefill_step(cfg)
    decode = steps_lib.make_decode_step(cfg)
    q = min(pops.PREFILL_Q, max(8, VLM_PS))
    embs = [_patches(cfg, n, seed, dev) for seed, n in reqs]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    finite, first, handles = True, [], []
    with torch.no_grad():
        for slot, emb in enumerate(embs):
            n = emb.shape[1]
            h = backend.alloc(slot, slot, n)
            spad = -(-n // q) * q
            padded = torch.zeros((1, spad, cfg.d_model), dtype=emb.dtype,
                                 device=dev)
            padded[:, :n] = emb
            width = min(-(-spad // VLM_PS), backend.table_width)
            tables = backend.device_tables()[slot:slot + 1, :width]
            logits, pc = prefill(params, {"embeddings": padded},
                                 backend.kv_caches(), tables,
                                 torch.tensor([n], dtype=torch.int32,
                                              device=dev))
            backend.insert(h, pc)
            finite &= bool(torch.isfinite(logits).all())
            first.append(int(torch.argmax(logits[0, -1, :cfg.vocab])))
            handles.append(h)
        out = [first]
        pos = [n for _, n in reqs]          # each slot's next position

        def step():
            """One decode step of the batch; appends its tokens."""
            tables = backend.device_tables()[:, :max(pos) // VLM_PS + 1]
            logits, caches = decode(
                params, {"tokens": torch.as_tensor(out[-1], device=dev)[
                    :, None]}, backend.gather(),
                torch.as_tensor(pos, dtype=torch.int32, device=dev), tables)
            backend.commit(caches)
            out.append(torch.argmax(logits[:, -1, :cfg.vocab], -1).tolist())
            for i, h in enumerate(handles):
                pos[i] += 1
                backend.append(h)
            return bool(torch.isfinite(logits).all())

        split = None
        n_plain = VLM_NEW - VLM_PROFILED if profile else VLM_NEW
        for _ in range(n_plain):
            finite &= step()
        if profile:
            split, ok = _vlm_decode_profile(step)
            finite &= ok
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in counters.items()}
    return np.asarray(out).T, got, finite, split, len(reqs)


def _vlm_decode_profile(step):
    """VLM_PROFILED decode steps (``step()`` runs one) under
    torch.profiler: wall and device ms a step, the device split by class
    (K1, K2, K3, cuBLAS, other).  Returns (split, finite)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    finite = True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(VLM_PROFILED):
            finite &= step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / VLM_PROFILED
    split = {k: v / VLM_PROFILED for k, v in _device_split(prof).items()}
    return dict(split, wall_ms=wall, device_ms=sum(split.values()),
                other_top=_device_split.other), finite


def _vlm_prefill_gap(cfg, params, dev):
    """Paged vs dense prefill logits of one 64-row prompt of patch
    embeddings: relative L2 error of the last position's logits with K3,
    and with K3's plain version in its place as the witness.  Returns
    {"k3", "plain"}."""
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.serve import cache as cache_mod

    emb = _patches(cfg, 64, 64, dev)
    kernel = pops.paged_prefill_fwd
    out = {}
    with torch.no_grad():
        dense, _ = lm.forward(cfg, params, {"embeddings": emb},
                              mode="prefill", logits_mode="last")
        dense = dense[:, -1].float()
        for name, k3 in (("k3", kernel), ("plain", pops.paged_prefill_ref)):
            backend = cache_mod.PagedCache(cfg, 1, 128, dev,
                                           page_size=VLM_PS)
            backend.alloc(0, 0, 64)
            pops.paged_prefill_fwd = k3
            try:
                paged, _ = steps_lib.make_paged_prefill_step(cfg)(
                    params, {"embeddings": emb}, backend.kv_caches(),
                    backend.device_tables()[:, :4],
                    torch.tensor([64], dtype=torch.int32, device=dev))
            finally:
                pops.paged_prefill_fwd = kernel
            paged = paged[:, -1].float()
            if not torch.isfinite(paged).all():
                raise AssertionError("vlm paged prefill logits non-finite")
            out[name] = ((paged - dense).norm() / dense.norm()).item()
    return out


def phase_vlm(dev, counters, smi):
    """Path 9: qwen2-vl-72b at published widths, 16 of 80 layers, bf16
    weights from seed 0, bound to ``synthetic_plan(bits=None, seed=0)``:
    paged prefill of 4 requests from patch embeddings (K1, K3) and 16
    greedy decode steps (K1, K2) driven through ``lm.forward`` /
    ``lm.decode_step`` over a ``serve.cache.PagedCache`` (the server
    refuses the family, as the reference's does); two requests again
    alone; then 2 float requests; paged vs dense prefill; one profiled
    decode window split by class."""
    from repro_torch.models import lm
    from repro_torch.serve import engine

    cfg = _vlm_cfg()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    n_par = sum(v.numel() for _, v in _leaves(params))
    per_layer = sum(v.numel() for _, v in _leaves(params["blocks"])) \
        / VLM_LAYERS
    plan = engine.synthetic_plan(cfg, params, bits=None, seed=0)
    t1 = time.perf_counter()
    bound = engine.apply_plan(cfg, params, plan)
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t1
    log(f"[vlm] {VLM_ARCH}: {VLM_LAYERS} of 80 layers (the depth cut; the "
        f"pattern is one layer long), d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim} (G = "
        f"{cfg.n_heads // cfg.n_kv_heads}), d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; {n_par / 1e9:.3f} B bf16 parameters, "
        f"{per_layer / 1e9:.3f} B a layer "
        f"({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB with the "
        f"bound tree) drawn in {t1 - t0:.1f} s; {plan.summary()}, bound in "
        f"{t_bind:.1f} s")
    try:
        engine.InferenceServer(cfg, params, max_len=64, max_batch=1,
                               device=dev)
    except NotImplementedError as e:
        if "decoder-only token-frontend" not in str(e):
            raise
    else:
        raise AssertionError("InferenceServer took a VLM")
    L = VLM_LAYERS
    k1_call = _k1_groups(bound["blocks"])
    reqs = [(1000 + i, n) for i, n in enumerate(VLM_LENS)]
    runs = {}
    t1 = time.perf_counter()
    toks, got, finite, split, adm = _vlm_serve(cfg, bound, reqs, dev,
                                               counters, profile=True)
    dt = time.perf_counter() - t1
    need = {"quant_matmul": k1_call * (adm + VLM_NEW),
            "paged_prefill": L * adm, "paged_attention": L * VLM_NEW}
    if any(got[k] != v for k, v in need.items()) or any(
            v for k, v in got.items() if k not in need):
        raise AssertionError(f"vlm plan: launches {got}, need {need} and no "
                             f"other kernel")
    solo = {i: _vlm_serve(cfg, bound, [reqs[i]], dev, counters)[0][0]
            for i in (0, len(reqs) - 1)}
    if not finite or toks.shape != (len(reqs), VLM_NEW + 1) or any(
            not np.array_equal(toks[i], s) for i, s in solo.items()):
        raise AssertionError(f"vlm plan: batched {toks.tolist()}, solo "
                             f"{ {i: s.tolist() for i, s in solo.items()} }"
                             f", finite {finite}")
    log(f"[vlm] plan-bound: {len(reqs)} requests (patch embeddings of "
        f"{list(VLM_LENS)}) x {VLM_NEW + 1} tokens ({VLM_NEW} decode steps) "
        f"in {dt:.2f} s; finite logits; requests 0 and {len(reqs) - 1} "
        f"alone give their batched streams; launches {got} = K1 "
        f"{k1_call} a forward ({7 * L} PackedLinears, one launch a "
        f"precision group) x ({adm} admissions + {VLM_NEW} steps), K3 {L} x "
        f"{adm}, "
        f"K2 {L} x {VLM_NEW}; {smi}")
    log(f"[vlm] plan-bound decode step ({len(reqs)} slots at "
        f"{min(VLM_LENS)}-{max(VLM_LENS)} + {VLM_NEW - VLM_PROFILED} tokens; "
        f"{VLM_PROFILED} steps profiled): {split['wall_ms']:.2f} ms wall, "
        f"{split['device_ms']:.2f} ms device "
        f"({100 * split['device_ms'] / split['wall_ms']:.1f}% busy); device "
        f"ms a step: " + ", ".join(f"{k} {split[k]:.3f}" for k in
                                   ("K1", "K2", "K3", "cuBLAS products",
                                    "other"))
        + "; largest 'other': " + "; ".join(
            f"{k} {v / VLM_PROFILED:.3f}" for k, v in split["other_top"]))
    runs["plan"] = dict(launches=got, decode_steps=VLM_NEW, admitted=adm,
                        seconds=dt, decode_split=split)
    float_reqs = reqs[:VLM_FLOAT]
    t1 = time.perf_counter()
    ftoks, fgot, ffinite, _, fadm = _vlm_serve(cfg, params, float_reqs, dev,
                                               counters)
    dt = time.perf_counter() - t1
    fneed = {"paged_prefill": L * fadm, "paged_attention": L * VLM_NEW}
    if any(fgot[k] != v for k, v in fneed.items()) or any(
            v for k, v in fgot.items() if k not in fneed) or not ffinite:
        raise AssertionError(f"vlm float: launches {fgot}, need {fneed} and "
                             f"no other kernel; finite {ffinite}")
    log(f"[vlm] float: {len(float_reqs)} requests x {VLM_NEW + 1} tokens in "
        f"{dt:.2f} s, finite; launches {fgot}")
    runs["float"] = dict(launches=fgot, decode_steps=VLM_NEW, admitted=fadm,
                         seconds=dt)
    rel = _vlm_prefill_gap(cfg, bound, dev)
    rel_f = _vlm_prefill_gap(cfg, params, dev)
    if max(rel["k3"], rel_f["k3"]) > 5e-2:
        raise AssertionError(f"vlm paged vs dense prefill logits: relative "
                             f"L2 {rel} (plan), {rel_f} (float) > 5e-2")
    log(f"[vlm] paged (K3) vs dense prefill logits on a 64-row prompt: "
        f"relative L2 error {rel['k3']:.3g} plan-bound, {rel_f['k3']:.3g} "
        f"float (bound 5e-2); witnesses with K3's plain version "
        f"{rel['plain']:.3g} / {rel_f['plain']:.3g}")
    runs["paged_vs_dense"] = dict(plan_k3=rel["k3"], plan_plain=rel["plain"],
                                  float_k3=rel_f["k3"],
                                  float_plain=rel_f["plain"])
    runs["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    runs["params_b"] = n_par / 1e9
    log(f"[vlm] peak memory {runs['peak_gib']:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); {smi}")
    return runs


# qwen2-vl-72b's projections (K, N): wq / wo, wk / wv, w_gate / w_up,
# w_down; at the decode slot count, the 2048-row yardstick and path 9's
# longest padded prompt
VLM_K1 = ((8192, 8192), (8192, 1024), (8192, 29568), (29568, 8192))


def vlm_k1_cases():
    """(M, K, N, bits) K1 takes on path 9: qwen2-vl's full widths at M 8
    and 2048, 8/4/2-bit, and every precision group of layer 0 of the
    seed-0 synthetic plan path 9 binds (drawn over the meta-device tree),
    the ragged splits of 29568 among them, at the decode M (4 slots) and
    the longest padded prompt."""
    from repro_torch.models import lm
    from repro_torch.serve import engine

    cases = {(m, kk, n, b) for m in (8, 2048) for kk, n in VLM_K1
             for b in (8, 4, 2)}
    cfg = _vlm_cfg()
    meta = lm.init_params(cfg, device="meta")
    plan = engine.synthetic_plan(cfg, meta, bits=None, seed=0)
    prefill_m = -(-max(VLM_LENS) // 16) * 16
    for grp, w in lm.serve_weight_groups(cfg, meta).items():
        if not grp.endswith(".sb0"):
            continue
        cb = np.asarray(plan.channel_bits[grp])
        for b in (8, 4, 2):
            n = int((cb == b).sum())
            if n:
                cases.update({(len(VLM_LENS), w.shape[1], n, b),
                              (prefill_m, w.shape[1], n, b)})
    return sorted(cases)


def phase_vlm_k1(dev, flush):
    """K1 bitwise against its int32-exact plain version at path 9's
    shapes (:func:`vlm_k1_cases`), then timed at the full widths, 4-bit,
    M 8 (decode layout) and 2048 (tiles) beside bf16 ``torch.matmul`` on
    the dequantized weight and the bound."""
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref

    g = torch.Generator(device=dev).manual_seed(21)
    sx = torch.ones((), device=dev)
    cases = vlm_k1_cases()
    err = _k1_bitwise(dev, cases, 21, "qwen2-vl")
    log(f"[kernels] K1 quant_matmul at path 9's shapes: bitwise equal to the "
        f"int32 plain version in {len(cases)} cases, M in "
        f"{sorted({c[0] for c in cases})}, (K, N) {list(VLM_K1)} at 8/4/2 "
        f"bits and layer 0's plan groups (N from "
        f"{min(c[2] for c in cases)} to {max(c[2] for c in cases)})")
    timed = []
    bits = 4
    for m in (8, 2048):
        for kk, n in VLM_K1:
            xq = torch.randint(-127, 128, (m, kk), generator=g, device=dev,
                               dtype=torch.int8)
            wq = torch.randint(-8, 8, (n, kk), generator=g, device=dev,
                               dtype=torch.int8)
            wp = qref.pack_weights(wq, bits)
            sw = torch.rand(n, generator=g, device=dev) * 1e-3
            xb = xq.to(torch.bfloat16)
            deq = wq.to(torch.bfloat16) * sw[:, None].to(torch.bfloat16)
            del wq
            kname = "qmv" if m <= 8 else "qmm_kernel"

            def kern():
                return qops.quant_matmul(xq, wp, sw, sx, w_bits=bits)

            def mm():
                return torch.matmul(xb, deq.T)

            bms, by = bound(m * kk + n * kk * bits // 8 + n * 4 + 4
                            + m * n * 4, 2 * m * n * kk, "int8")
            r = dict(shape=f"qwen2-vl M={m} K={kk} N={n} {bits}-bit",
                     ms=time_ms(kern, 10, flush),
                     device_ms=device_ms(kern, 10, flush, kname),
                     library_ms=time_ms(mm, 10, flush),
                     library_device_ms=device_ms(mm, 10, flush, names=False),
                     bound_ms=bms, bound_by=by)
            timed.append(r)
            log(f"[kernels] K1 at {r['shape']}: {r['ms']:.4f} ms (device "
                f"{r['device_ms']:.4f}); bf16 torch.matmul "
                f"{r['library_ms']:.4f} (device {r['library_device_ms']:.4f})"
                f"; bound {bms:.4f} ms ({by})")
            del xq, wp, xb, deq
    torch.cuda.empty_cache()
    return dict(vlm_cases=len(cases), vlm_max_abs_err=err, vlm_timed=timed)


# path 9's attention: 64 query heads over 8 KV heads (G = 8, the first
# group of 8 on the card), head dim 128, bf16 pools of 16-token pages,
# path 9's table width; decode at its prompts' lengths past the new
# tokens (a freed slot and short ones beside them), prefill of its
# longest prompt padded to the q chunk
VLM_H, VLM_HKV, VLM_D = 64, 8, 128
VLM_K2_LENS = [1040, 2016, 3152, 4116, 0, 1, 16, 17]
VLM_K3_LEN = 4100


def phase_vlm_attention(dev, flush):
    """K2 and K3 against their plain versions at path 9's attention shape
    (G = 8, D = 128), f32 within 2e-5 and bf16 within 1e-2; each timed in
    bf16 beside its plain version, SDPA on the gathered K/V and its
    bound."""
    from repro_torch.kernels.paged_attention import ops as pops

    rng = np.random.default_rng(21)
    h, hkv, d, ps = VLM_H, VLM_HKV, VLM_D, VLM_PS
    width = VLM_MAX_LEN // ps
    s3 = -(-VLM_K3_LEN // 16) * 16
    pos = torch.as_tensor([max(n - 1, 0) for n in VLM_K2_LENS],
                          dtype=torch.int32, device=dev)
    lens3 = torch.as_tensor([VLM_K3_LEN], dtype=torch.int32, device=dev)
    out = {}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        q, kp, vp, tb = pool_case(rng, VLM_K2_LENS, h=h, hkv=hkv, d=d, ps=ps,
                                  width=width, dtype=dtype, dev=dev)
        got = pops.paged_attention_fwd(q, kp, vp, tb, pos)
        torch.cuda.synchronize()
        want = pops.paged_attention_ref(q, kp, vp, tb, pos)
        err2 = (got.float() - want.float()).abs().max().item()
        freed = VLM_K2_LENS.index(0)
        if not (torch.isfinite(got).all() and err2 <= tol and
                torch.equal(got[freed], torch.zeros_like(got[freed]))):
            raise AssertionError(f"K2 G=8 D=128 {dtype}: max |diff| {err2} "
                                 f"> {tol}, non-finite or freed slot not "
                                 f"zero")
        q3, kp3, vp3, tb3 = pool_case(rng, [s3], h=h, hkv=hkv, d=d, ps=ps,
                                      width=s3 // ps, dtype=dtype, dev=dev,
                                      s=s3)
        got3 = pops.paged_prefill_fwd(q3, kp3, vp3, tb3, lens3)
        torch.cuda.synchronize()
        want3 = pops.paged_prefill_ref(q3, kp3, vp3, tb3, lens3)
        err3 = (got3[:, :VLM_K3_LEN].float()
                - want3[:, :VLM_K3_LEN].float()).abs().max().item()
        if not (torch.isfinite(got3[:, :VLM_K3_LEN]).all() and err3 <= tol):
            raise AssertionError(f"K3 G=8 D=128 {dtype}: max |diff| {err3} "
                                 f"> {tol}")
        log(f"[kernels] G=8 (H={h}, Hkv={hkv}, D={d}), page {ps}, {dtype}: "
            f"K2 at lens {VLM_K2_LENS} max |diff| {err2:.3g}, K3 at "
            f"{VLM_K3_LEN} tokens padded to {s3} max |diff| {err3:.3g} "
            f"(bound {tol})")
        if dtype == torch.float32:
            out = {"paged_attention": dict(g=8, max_abs_err=err2),
                   "paged_prefill": dict(g=8, max_abs_err=err3)}
            del q, kp, vp, q3, kp3, vp3
            continue
        r2, r3 = out["paged_attention"], out["paged_prefill"]
        r2.update(k2_timing(dev, flush, (q, kp, vp, tb), pos, VLM_K2_LENS,
                            h, hkv, d, ps),
                  shape=f"B=8 H={h} Hkv={hkv} D={d} page {ps}, table "
                  f"{width}, lens {VLM_K2_LENS}, bf16", max_abs_err_bf16=err2)
        r3.update(k3_timing(dev, flush, (q3, kp3, vp3, tb3), lens3,
                            VLM_K3_LEN, h, hkv, d, ps),
                  shape=f"B=1 S={VLM_K3_LEN} (padded {s3}) H={h} Hkv={hkv} "
                  f"D={d} page {ps}, bf16", max_abs_err_bf16=err3)
        for name, r in (("K2", r2), ("K3", r3)):
            log(f"[kernels] {name} at {r['shape']}: {r['ms']:.4f} ms "
                f"(device {r['device_ms']:.4f}), plain {r['plain_ms']:.2f} "
                f"ms, SDPA {r['library_ms']:.4f} (device "
                f"{r['library_device_ms']:.4f}), bound {r['bound_ms']:.4f} "
                f"ms ({r['bound_by']})")
        del q, kp, vp, q3, kp3, vp3
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# path 10: the multi-replica fleet over plan tiers (ROADMAP D12 + D13)
# ---------------------------------------------------------------------------

FLEET_ARCH = "llama3.2-1b"
FLEET_TIERS = ("float", "w8", "mixed", "w2")
FLEET_KW = dict(max_len=1024, max_batch=8, cache="paged", page_size=16,
                pages=None, base_step_ms=8.0)
FLEET_REQUESTS = 32
FLEET_SOLO = 8                  # finished streams held against solo serves


def _fleet_trace(mod, cfg, seed=0):
    """Run 1's open-loop trace: Poisson arrivals at 100 requests a
    virtual second, prompts of 16-512 tokens, 16-32 greedy tokens each, a
    300 ms modelled deadline (tight enough that the float tier's queue
    pushes requests down the front)."""
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request
    trace = mod.poisson_trace(FLEET_REQUESTS, rate_rps=100.0,
                              vocab=cfg.vocab, prompt_len=16, max_tokens=16,
                              deadline_ms=300.0, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for fr in trace:
        n = int(rng.integers(16, 513))
        fr.request = Request(
            uid=fr.uid, prompt=rng.integers(0, cfg.vocab, size=n).astype(
                np.int32),
            sampling=SamplingParams(max_tokens=int(rng.integers(16, 33))))
    return trace


class _FleetCounts:
    """Each kernel's launches, and the engine's decode seconds and decode
    steps (its ``_step_timing``: gather + step + sampling, which ends in
    a host copy of the sampled ids), by replica, counted around each
    replica's ``step`` into ``into`` while it is set.  Every launch of a
    fleet run happens inside one replica's ``step`` (admissions, decode
    and warm-up probes alike); ``_fleet_run`` sets ``into`` for its run
    alone, so the oracle's solo serves and the obs check add nothing."""

    def __init__(self, flt, counters):
        self.counters = counters
        self.into = None        # {tier: {kernel: n, "decode_s": s,
        #                               "decode_steps": n}}
        for rep in flt.replicas:
            rep.server.step = self._wrap(rep.tier.name, rep.server)

    def fresh(self, flt):
        return {rep.tier.name: dict(dict.fromkeys(self.counters, 0),
                                    decode_s=0.0, decode_steps=0)
                for rep in flt.replicas}

    def _wrap(self, name, server):
        inner = server.step

        def step():
            if self.into is None:
                return inner()
            got = self.into[name]
            before = {k: fn.launches for k, fn in self.counters.items()}
            t = list(server._step_timing)
            res = inner()
            for k, fn in self.counters.items():
                got[k] += fn.launches - before[k]
            got["decode_s"] += (server._step_timing[0] - t[0]
                                + server._step_timing[1] - t[1])
            got["decode_steps"] += server._step_timing[2] - t[2]
            return res
        return step


def _fleet_run(flt, trace, label, dev, counts):
    """One timed fleet run; returns its records, SLO report, wall
    seconds, each kernel's launches (``launches``), the same by replica
    with each replica's decode seconds and steps (``by_tier``), decode
    steps (every replica's, struck sessions too) and tokens."""
    from repro_torch import fleet as fleet_mod
    by_tier = counts.fresh(flt)
    before = {k: fn.launches for k, fn in counts.counters.items()}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    counts.into = by_tier
    try:
        records = flt.run(trace)
        torch.cuda.synchronize(dev)
    finally:
        counts.into = None
    wall = time.perf_counter() - t0
    launches = {k: fn.launches - before[k]
                for k, fn in counts.counters.items()}
    report = fleet_mod.slo_report(flt, records)
    open_ = {u: r.status for u, r in records.items() if r.status in (
        "queued", "running", "retrying")}
    if len(records) != len(trace) or open_:
        raise AssertionError(f"fleet {label}: {len(records)} of "
                             f"{len(trace)} requests recorded; not at a "
                             f"terminal: {open_}")
    steps = sum(g["decode_steps"] for g in by_tier.values())
    toks = sum(len(r.tokens) for r in records.values()
               if r.tokens is not None)
    log(f"[fleet] {label}: {len(records)} requests, {report['status']}, "
        f"{report['degraded']} degraded, {report['retries']} retries; "
        f"{steps} decode steps, {toks} tokens in {wall:.2f} s wall; "
        f"modelled (virtual clock) attainment "
        f"{report['deadline_attainment']}, ttft p50 "
        f"{report['ttft_ms']['p50']} ms, p99 {report['ttft_ms']['p99']} ms")
    return dict(records=records, report=report, wall=wall, steps=steps,
                tokens=toks, launches=launches, by_tier=by_tier)


def _stream(r):
    return (r.status, r.replica,
            None if r.tokens is None else r.tokens.tolist())


def _fleet_busy(flt, trace, run1, dev, counts):
    """Run 1's trace again under ``torch.profiler`` (CUDA activity):
    the records must equal run 1's (status, replica, tokens), and the
    union of the device's kernel, copy and set intervals over run 1's
    unprofiled wall time is run 1's busy share.  The profiler's raw
    kineto events are read directly: ``key_averages`` builds an event
    tree of the run's ~500,000 operations, which took minutes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = _fleet_run(flt, trace, "run 1 again, under the profiler",
                           dev, counts)
    t0 = time.perf_counter()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy_ns, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    diff = [u for u, r in run1["records"].items()
            if _stream(r) != _stream(again["records"][u])]
    if diff:
        raise AssertionError(f"fleet: run 1 under the profiler differs "
                             f"from run 1 at uids {diff}")
    if not spans:
        raise AssertionError("fleet: the profiler recorded no device "
                             "operation over run 1")
    busy = 1e-9 * busy_ns / run1["wall"]
    log(f"[fleet] run 1 device busy {100 * busy:.1f}%: "
        f"{1e-9 * busy_ns:.3f} s of device time (the union of "
        f"{len(spans)} kernel / copy / set intervals in a profiled repeat "
        f"of run 1 with equal records) over run 1's unprofiled "
        f"{run1['wall']:.2f} s wall; {100e-9 * busy_ns / again['wall']:.1f}"
        f"% of the profiled repeat's {again['wall']:.2f} s (events read "
        f"in {time.perf_counter() - t0:.1f} s)")
    return busy


def _fleet_oracle(flt, runs, per_tier, total=0, skip=()):
    """Hold finished streams of ``runs`` against the same request served
    alone on the replica that finished it (the reference's oracle): the
    first ``per_tier`` of each tier, then more up to ``total`` in all,
    tiers in ``skip`` left out.  Returns ``{tier: streams checked}``."""
    fin = [r for run in runs for r in run["records"].values()
           if r.status == "finished" and r.replica not in skip]
    picked = {}
    for r in fin:
        got = picked.setdefault(r.replica, [])
        if len(got) < per_tier:
            got.append(r)
    taken = {id(r) for got in picked.values() for r in got}
    rest = [r for r in fin if id(r) not in taken]
    picked[None] = rest[:max(0, total - sum(map(len, picked.values())))]
    for r in picked.pop(None):
        picked[r.replica].append(r)
    for tier, recs in picked.items():
        server = flt.replica_by_name(tier).server
        for r in recs:
            alone = server.serve([r.fr.request])[r.fr.uid]
            if alone.tolist() != r.tokens.tolist():
                raise AssertionError(
                    f"fleet: uid {r.fr.uid} on {tier}: fleet stream "
                    f"{r.tokens.tolist()} != solo {alone.tolist()}")
    return {t: len(v) for t, v in picked.items()}


def _chaos_window(records, tiers):
    """A virtual time at which run 1 had work in flight on the float and
    w8 replicas (the nan_plan and crash targets), and on as many others
    as possible: the faults then strike replicas that step."""
    spans = {t: [] for t in tiers}
    for r in records.values():
        a = r.attempts[-1]
        if r.status == "finished":
            spans[a.tier].append((a.t_start, r.finish_ms))
    best = None
    for t0, t1 in spans["float"]:
        t = 0.5 * (t0 + t1)
        busy = [name for name, sp in spans.items()
                if any(a < t < b for a, b in sp)]
        if "w8" in busy and (best is None or len(busy) > best[1]):
            best = (t, len(busy))
    if best is None:
        counts = {k: len(v) for k, v in spans.items()}
        raise AssertionError(f"fleet: run 1 never had float and w8 busy at "
                             f"once (finished requests by tier {counts})")
    return best[0]


def phase_fleet(dev, counters, smi):
    """Path 10: ``launch.fleet.build_fleet`` serving full-width
    llama3.2-1b (random weights, seed 0) from four replicas on the one
    card -- tiers float, w8, mixed, w2 built from one parameter tree --
    paged (page 16), 8 slots, max_len 1024.  Run 1: pareto_degrade over
    a Poisson trace of 32 requests (prompts 16-512, 16-32 greedy tokens,
    300 ms modelled deadlines), timed, then again under the profiler for
    the device busy share (the same records); a burst trace.  Run 2:
    chaos (nan_plan on float, crash on w8, slow on mixed, pool pressure
    on w2, all while run 1 had float and w8 busy) with failover.  Gates:
    every request at a terminal; finished streams of every tier that
    finished one (two a tier from run 1 and the burst, and from run 2 on
    every tier but the struck float) equal their replica's solo serve;
    the nan_plan strike quarantines float and counts
    ``fault_nan_detected_total``; over the three runs, K1 on w8 / mixed
    / w2 and never on float, K2 and K3 on every replica that served; one
    replica's launches and streams equal with obs attached and detached;
    the metrics and trace written pass ``repro_torch.obs.validate``.
    Launches and decode times are counted inside the three runs only."""
    import shutil
    import tempfile
    from repro_torch import fleet as fleet_mod
    from repro_torch.chaos import ChaosInjector, parse_chaos
    from repro_torch.configs import registry
    from repro_torch.launch import fleet as fleet_launch
    from repro_torch.models import lm
    from repro_torch.obs import (Observability, validate, write_prometheus)

    cfg = registry.get(FLEET_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    flt = fleet_launch.build_fleet(cfg, params, list(FLEET_TIERS),
                                   policy="pareto_degrade", device=dev,
                                   **FLEET_KW)
    torch.cuda.synchronize(dev)
    log(f"[fleet] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab}): {len(flt.replicas)} replicas built from one "
        f"parameter tree in {time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{r.tier.name} {r.tier.quality:.2f} bits, modelled step "
            f"{r.tier.step_ms:.3f} ms" for r in flt.replicas))
    counts = _FleetCounts(flt, counters)

    def per_step(runs):
        out = {}
        for name in FLEET_TIERS:
            s = sum(run["by_tier"][name]["decode_s"] for run in runs)
            k = sum(run["by_tier"][name]["decode_steps"] for run in runs)
            out[name] = (1e3 * s / k if k else None, k,
                         flt.replica_by_name(name).tier.step_ms)
        return out

    def per_step_log(steps):
        return "; ".join(f"{n} {ms:.2f} ms over {k} steps vs modelled "
                         f"{m:.3f} ms" if k else f"{n} no decode step"
                         for n, (ms, k, m) in steps.items())

    run1 = _fleet_run(flt, _fleet_trace(fleet_mod, cfg),
                      "run 1 (poisson, pareto_degrade)", dev, counts)
    if run1["report"]["degraded"] < 1:
        raise AssertionError("fleet run 1: no request was routed below the "
                             "top tier")
    log(f"[fleet] run 1: real wall ms a decode step (the engine's gather + "
        f"step + sampling) beside the modelled step_ms: "
        + per_step_log(per_step([run1])))
    busy = _fleet_busy(flt, _fleet_trace(fleet_mod, cfg), run1, dev, counts)

    burst = fleet_mod.burst_trace(4, 8, burst_every_ms=250.0,
                                  vocab=cfg.vocab, prompt_len=256,
                                  max_tokens=24, deadline_ms=600.0, seed=2,
                                  uid0=1000)
    run_b = _fleet_run(flt, burst, "burst (4 x 8, pareto_degrade)", dev,
                       counts)
    # the oracle before any fault: two finished streams a tier, eight in
    # all
    checked = _fleet_oracle(flt, (run1, run_b), 2, total=FLEET_SOLO)

    t_f = _chaos_window(run1["records"], FLEET_TIERS)
    n_pages = flt.replica_by_name("w2").server.backend.n_pages
    spec = (f"nan_plan@{t_f:.3f}-{t_f + 250:.3f}:float+"
            f"crash@{t_f:.3f}-{t_f + 250:.3f}:w8+"
            f"slow@{t_f:.3f}-{t_f + 400:.3f}:x4:mixed+"
            f"pool_pressure@{t_f:.3f}-{t_f + 300:.3f}:p{n_pages - 48}:w2")
    sched = parse_chaos(spec, targets=list(FLEET_TIERS), seed=0)
    flt.chaos = ChaosInjector(sched)
    flt.failover = True
    reg = flt.registry
    nan0 = reg.counter("fault_nan_detected_total").value()
    strikes = []
    strike = flt._strike

    def struck(rep, now, records, kind):
        strike(rep, now, records, kind)
        strikes.append((rep.tier.name, kind, now,
                        flt.health.state(rep.tier.name)))
    flt._strike = struck
    try:
        run2 = _fleet_run(flt, _fleet_trace(fleet_mod, cfg),
                          "run 2 (chaos, failover)", dev, counts)
    finally:
        del flt._strike
    delivered = len(flt.chaos.delivered)
    flt.chaos = None
    nan = reg.counter("fault_nan_detected_total").value() - nan0
    float_kinds = [e.kind for e in
                   flt.replica_by_name("float").server.obs.tracer.events]
    causes = [a.cause for r in run2["records"].values() for a in r.attempts]
    if nan < 1 or "quarantined" not in float_kinds or not any(
            s[:2] == ("float", "quarantined") for s in strikes):
        raise AssertionError(f"fleet chaos: nan_plan on float counted "
                             f"{nan} NaN detections; strikes {strikes}; "
                             f"float's events {sorted(set(float_kinds))}")
    if not any(c.startswith("recovered:") for c in causes):
        raise AssertionError("fleet chaos: no request was recovered")
    # a stream that finished on the same tier in both runs is the same
    same = [u for u, r in run2["records"].items()
            if r.status == "finished"
            and run1["records"][u].status == "finished"
            and run1["records"][u].replica == r.replica]
    for u in same:
        if run2["records"][u].tokens.tolist() != \
                run1["records"][u].tokens.tolist():
            raise AssertionError(f"fleet chaos: uid {u} on "
                                 f"{run2['records'][u].replica} differs "
                                 f"from run 1")
    # the metrics and trace of run 2 through the port's validator (before
    # the solo serves below add their own events)
    tmp = tempfile.mkdtemp(prefix="fleet_obs_")
    try:
        m, t = os.path.join(tmp, "fleet.prom"), os.path.join(tmp,
                                                             "fleet.jsonl")
        write_prometheus(reg, m)
        flt.write_trace(t)
        errors = validate.validate_files(m, t, validate.SCHEMA_PATH)
        if errors:
            raise AssertionError(f"fleet obs artifacts: {errors[:5]}")
        n_ev = len(flt.trace_events())
        log(f"[fleet] run 2's metrics ({len(reg.snapshot())} families) and "
            f"trace ({n_ev} events) pass repro_torch.obs.validate against "
            f"the port's schema copy")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # run 2's streams against solo serves, on every tier but float (its
    # poisoned step left NaN K/V in its pages)
    after = _fleet_oracle(flt, (run2,), 1, skip=("float",))
    finished = {r.replica for run in (run1, run_b, run2)
                for r in run["records"].values() if r.status == "finished"}
    if finished - set(checked) - set(after):
        raise AssertionError(f"fleet: tiers {sorted(finished)} finished "
                             f"streams; held against solo serves: before "
                             f"the faults {checked}, after {after}")
    log(f"[fleet] chaos: {spec}; {delivered} fault events delivered, NaN "
        f"detections {int(nan)}; strikes (tier, kind, virtual ms, health "
        f"right after): {strikes}; "
        f"{sum(c.startswith('recovered:') for c in causes)} recovered "
        f"attempts; {len(same)} streams that finished on the same tier as "
        f"in run 1 are equal; health at the end {flt.health.states()}")
    log(f"[fleet] finished streams equal to the same request served alone "
        f"on its replica: {checked} from run 1 and the burst, {after} from "
        f"run 2 (every tier that finished a stream: {sorted(finished)})")

    runs = (run1, run_b, run2)
    steps = per_step(runs)
    log("[fleet] real wall ms a decode step over the three runs, beside "
        "the modelled step_ms: " + per_step_log(steps))
    by_tier = {name: {k: sum(run["by_tier"][name][k] for run in runs)
                      for k in counters} for name in FLEET_TIERS}
    total = {k: sum(run["launches"][k] for run in runs) for k in counters}
    for name, got in by_tier.items():
        served = sum(1 for run in runs for r in run["records"].values()
                     if any(a.tier == name for a in r.attempts))
        if name == "float" and got["quant_matmul"] != 0:
            raise AssertionError(f"fleet: K1 launched {got['quant_matmul']} "
                                 f"times on the float replica")
        if name != "float" and got["quant_matmul"] == 0:
            raise AssertionError(f"fleet: K1 never launched on {name}")
        if served and (got["paged_attention"] == 0
                       or got["paged_prefill"] == 0):
            raise AssertionError(f"fleet: {name} served {served} requests "
                                 f"with launches {got}")
    log(f"[fleet] launches by replica over the three runs: "
        + "; ".join(f"{n}: K1 {g['quant_matmul']}, K2 "
                    f"{g['paged_attention']}, K3 {g['paged_prefill']}"
                    for n, g in by_tier.items())
        + f"; in all: K1 {total['quant_matmul']}, K2 "
        f"{total['paged_attention']}, K3 {total['paged_prefill']}")

    # obs attached vs detached: one replica, the same requests
    rep = flt.replica_by_name("w8")
    reqs = [r.fr.request for r in list(run1["records"].values())[:4]]
    seen = {}
    for label, obs in (("obs", Observability()), ("no obs", None)):
        rep.server.attach_obs(obs)
        torch.cuda.synchronize(dev)
        before = {k: f.launches for k, f in counters.items()}
        out = rep.server.serve(reqs)
        torch.cuda.synchronize(dev)
        seen[label] = ({k: f.launches - before[k]
                        for k, f in counters.items()},
                       {u: v.tolist() for u, v in out.items()})
    if seen["obs"] != seen["no obs"]:
        raise AssertionError(f"fleet: w8 with obs {seen['obs'][0]} vs "
                             f"without {seen['no obs'][0]}")
    log(f"[fleet] w8 serving 4 requests: launches {seen['obs'][0]} and "
        f"streams equal with obs attached and with obs=None; {smi}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[fleet] wall s: run 1 {run1['wall']:.2f}, burst "
        f"{run_b['wall']:.2f}, chaos {run2['wall']:.2f}; peak memory "
        f"{peak:.2f} GiB (torch.cuda.max_memory_allocated)")
    return dict(launches=total, by_tier=by_tier, busy=busy,
                per_step=steps, walls=(run1["wall"], run_b["wall"],
                                       run2["wall"]), peak=peak)


# path 11, the hybrid (jamba) at published widths: one super-block of its
# 72 layers (7 Mamba-2 layers and one attention layer, a dense FFN on the
# even slots and top-2 MoE on the odd ones) with 8 of the 16 experts a
# bank.  The prompts' SSM chunks (the largest divisor of the length up to
# 256) are 1, 33, 255, 256, 1, 250, 89 and 205: a prime length's chunk
# is 1, so 257 tokens scan C = 257 chunks.
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 8
JAMBA_LENS = (1, 33, 255, 256, 257, 1000, 2047, 4100)
JAMBA_NEW = 32
JAMBA_FLOAT, JAMBA_FLOAT_NEW = (256, 1000), 16
JAMBA_MAX_LEN, JAMBA_SLOTS, JAMBA_PS = 4160, 8, 16
JAMBA_LAYER_LENS = (1000, 257)      # the layer held card vs CPU
JAMBA_CLASSES = DEVICE_CLASSES + (("K5", ("ssd_scan",)),)


def _jamba_cfg():
    import dataclasses

    from repro_torch.configs import registry
    return dataclasses.replace(registry.get(JAMBA_ARCH),
                               n_layers=JAMBA_LAYERS,
                               n_experts=JAMBA_EXPERTS)


def jamba_k1_shapes(cfg):
    """The (K, N) of jamba's planned projections: Mamba-2 ``in_z`` /
    ``in_x``, ``out_proj``, ``in_b`` / ``in_c`` and ``in_dt`` (at full
    width N = ssm_state = ssm_heads = 128), the dense FFN's gate / up and
    down; the attention's are qwen2-vl's (path 9)."""
    d, di, f = cfg.d_model, cfg.d_inner, cfg.d_ff
    return tuple(dict.fromkeys(((d, di), (di, d), (d, cfg.ssm_state),
                                (d, cfg.ssm_heads), (d, f), (f, d))))


def jamba_k1_cases():
    """(M, K, N, bits) of path 11's K1 calls: every precision group of
    the seed-0 synthetic plan path 11 binds (drawn over the meta-device
    tree: it depends on the shapes only) and the five full widths at
    8/4/2 bits, at M 1 and 8 (the decode layout), 257 and 4100 (tiles;
    the hybrid's prefill is unpadded, so M is the prompt length)."""
    from repro_torch.models import lm
    from repro_torch.serve import engine

    cfg = _jamba_cfg()
    meta = lm.init_params(cfg, device="meta")
    plan = engine.synthetic_plan(cfg, meta, bits=None, seed=0)
    widths = {(kk, n, b) for kk, n in jamba_k1_shapes(cfg)
              for b in (8, 4, 2)}
    for grp, w in lm.serve_weight_groups(cfg, meta).items():
        cb = np.asarray(plan.channel_bits[grp])
        widths.update((w.shape[1], int((cb == b).sum()), b)
                      for b in (8, 4, 2) if (cb == b).any())
    return sorted((m, kk, n, b) for m in (1, 8, 257, max(JAMBA_LENS))
                  for kk, n, b in widths)


def phase_jamba_kernels(dev, flush):
    """Path 11's new kernel shapes: K5 bitwise at (C, 128, 128, 128) for
    C = 1, 20 and 257 (jamba's heads, head dim and state) and timed at
    C = 20 (a 4100-token prompt at chunk 205); K1 bitwise at
    :func:`jamba_k1_cases`, its decode layout timed at the five new (K,
    N), 4-bit, beside bf16 ``torch.matmul``, and its tiles at M = 4100,
    K x N 8192 x 24576 (the dense FFN's gate / up), 4-bit, beside bf16
    ``torch.matmul`` and ``torch._int_mm``, each with its bound."""
    cfg = _jamba_cfg()
    k5 = phase_k5(dev, flush, shape=(cfg.ssm_heads, cfg.ssm_head_dim,
                                     cfg.ssm_state),
                  checked=(1, 20, 257), c=20)
    log(f"[kernels] K5 at jamba's {k5['shape']}: {k5['ms']:.4f} ms (device "
        f"{k5['device_ms']:.4f}); plain {k5['plain_ms']:.4f}; bound "
        f"{k5['bound_ms']:.4f} ms ({k5['bound_by']})")
    cases = jamba_k1_cases()
    err = _k1_bitwise(dev, cases, 23, "jamba")
    log(f"[kernels] K1 quant_matmul at path 11's shapes: bitwise equal to "
        f"the int32 plain version in {len(cases)} cases, M in "
        f"{sorted({c[0] for c in cases})}, (K, N) {jamba_k1_shapes(cfg)} "
        f"at 8/4/2 bits and every precision group of the plan (N from "
        f"{min(c[2] for c in cases)} to {max(c[2] for c in cases)})")
    g = torch.Generator(device=dev).manual_seed(23)
    decode = phase_k1_decode(dev, flush, g, shapes=tuple(
        ("jamba", kk, n, 4) for kk, n in jamba_k1_shapes(cfg)))
    tiles = phase_k1_prefill(dev, flush, g, widths=(4,), shapes=(
        ("jamba", max(JAMBA_LENS), cfg.d_model, cfg.d_ff),))
    torch.cuda.empty_cache()
    k3 = phase_jamba_k3(dev, flush, cfg)
    return dict(k5=k5, k3=k3, k1=dict(jamba_cases=len(cases),
                                      jamba_max_abs_err=err,
                                      jamba_decode=decode,
                                      jamba_tiles=tiles))


def phase_jamba_k3(dev, flush, cfg):
    """K3 (bf16) against its plain version at path 11's exact prompt
    lengths (no padding: the last 64-row tile is partial at every odd
    length), G = 8, D = 128, over a table of path 11's width (null pages
    past the prompt), each at the q chunk the path gives it
    (``prefill_q_chunk``); timed at the longest beside causal SDPA."""
    from repro_torch.kernels.paged_attention import ops as pops

    rng = np.random.default_rng(23)
    h, hkv, d, ps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, JAMBA_PS
    errs, tol = {}, 1e-2
    for n in JAMBA_LENS:
        pools = pool_case(rng, [n], h=h, hkv=hkv, d=d, ps=ps,
                          width=JAMBA_MAX_LEN // ps, dtype=torch.bfloat16,
                          dev=dev, s=n)
        lens3 = torch.as_tensor([n], dtype=torch.int32, device=dev)
        qc = pops.prefill_q_chunk(n)
        got = pops.paged_prefill_fwd(*pools, lens3, q_chunk=qc)
        torch.cuda.synchronize()
        want = pops.paged_prefill_ref(*pools, lens3, q_chunk=qc)
        errs[n] = (got.float() - want.float()).abs().max().item()
        if not (torch.isfinite(got).all() and errs[n] <= tol):
            raise AssertionError(f"K3 at jamba's S={n} (unpadded, G=8, "
                                 f"D=128, bf16): max |diff| {errs[n]} > "
                                 f"{tol} or non-finite")
        if n == max(JAMBA_LENS):
            r = k3_timing(dev, flush, pools, lens3, n, h, hkv, d, ps,
                          q_chunk=qc)
        del pools, got, want
    r.update(shape=f"B=1 S={max(JAMBA_LENS)} (unpadded) H={h} Hkv={hkv} "
             f"D={d} page {ps}, table {JAMBA_MAX_LEN // ps}, bf16",
             lens=list(JAMBA_LENS), max_abs_err=max(errs.values()),
             max_abs_err_by_len=errs)
    log(f"[kernels] K3 at path 11's exact lengths (G=8, D=128, bf16, page "
        f"{ps}): max |diff| against its plain version "
        + ", ".join(f"S={n} {e:.3g}" for n, e in errs.items())
        + f" (bound {tol}); at {r['shape']}: {r['ms']:.4f} ms (device "
        f"{r['device_ms']:.4f}), plain {r['plain_ms']:.2f} ms, SDPA "
        f"{r['library_ms']:.4f} (device {r['library_device_ms']:.4f}), "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    return r


def _jamba_admissions(server, prompts, smi):
    """Device ms of each admission by class (K1, K3, K5, cuBLAS, other):
    every prompt served alone for one token under torch.profiler (the
    prefill, no decode step)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request

    out = []
    for i, p in enumerate(prompts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.serve([Request(uid=200 + i, prompt=p,
                                  sampling=SamplingParams(max_tokens=1))])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        split = _device_split(prof, JAMBA_CLASSES)
        out.append(dict(tokens=int(p.size), wall_ms=wall, device_ms=split))
        log(f"[jamba] admission of {p.size} tokens: {wall:.1f} ms wall, "
            f"{sum(split.values()):.3f} ms device: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"; {smi}")
    return out


def _jamba_need(server, steps, adm):
    """Path 11's launches: K5 once a Mamba-2 layer an admission, K3 once
    an attention layer an admission, K2 once an attention layer a decode
    step, K1 once a precision group of every planned projection a
    forward (at least one a plan group) plan-bound and never float, no
    other kernel.  The server must prefill into KV pages unpadded."""
    from repro_torch.models import lm

    if not (server._paged_kv and server._has_ssm):
        raise AssertionError("jamba: the paged server does not prefill "
                             "into KV pages at exact length")
    cfg = server.cfg
    pat = lm.block_pattern(cfg)
    n_mamba = lm.n_superblocks(cfg) * sum(p.mixer == "mamba" for p in pat)
    n_attn = lm.n_superblocks(cfg) * len(pat) - n_mamba
    per_fwd = _k1_groups(server.params["blocks"])
    if server.plan is not None and per_fwd < len(lm._plan_weights(cfg)):
        raise AssertionError(f"jamba: {per_fwd} K1 launches a forward, "
                             f"fewer than the plan's groups")
    return {"ssd_scan": n_mamba * adm, "paged_prefill": n_attn * adm,
            "paged_attention": n_attn * steps,
            "quant_matmul": per_fwd * (steps + adm)}


def phase_jamba(dev, counters, smi):
    """Path 11: the hybrid (jamba) served at published widths, bf16
    weights from seed 0, one super-block and 8 experts a bank, on K1, K2,
    K3 and K5."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import engine

    full, cfg = registry.get(JAMBA_ARCH), _jamba_cfg()
    bank_gb = 3 * cfg.d_model * cfg.expert_d_ff * 2 / 1e9
    log(f"[jamba] {JAMBA_ARCH} at published widths: d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff and "
        f"moe_d_ff {cfg.d_ff} / {cfg.expert_d_ff}, top-"
        f"{cfg.experts_per_token} MoE on the odd slots, Mamba-2 d_inner "
        f"{cfg.d_inner} ({cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}), vocab {cfg.vocab}, "
        f"{cfg.param_dtype}.  Cut: depth {full.n_layers} -> {cfg.n_layers} "
        f"(one super-block: 7 Mamba-2 + 1 attention layer, 4 MoE FFNs) and "
        f"experts {full.n_experts} -> {cfg.n_experts} a bank: at "
        f"{full.n_experts} experts one super-block's 4 MoE layers hold "
        f"{4 * full.n_experts * bank_gb:.1f} GB of bf16 banks (expert "
        f"banks stay float under a plan), more than one 80 GB card; every "
        f"matrix keeps its published shape and top-2 routing stays")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    n_par = sum(v.numel() for _, v in _leaves(params))
    plan = engine.synthetic_plan(cfg, params, bits=None, seed=0)
    log(f"[jamba] {n_par / 1e9:.3f} B bf16 parameters "
        f"({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB) drawn in "
        f"{time.perf_counter() - t0:.1f} s; {plan.summary()}")
    result = {"params_b": n_par / 1e9}
    result["layer_float"] = phase_mamba_layer(
        cfg, lm._index(params["blocks"]["l0"]["mixer"], 0), dev, "float",
        lens=JAMBA_LAYER_LENS, tag="jamba")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in JAMBA_LENS]

    server, result["plan"] = _serve_counted(
        cfg, params, plan, prompts, JAMBA_NEW, dev, counters, smi,
        "[jamba] plan", max_len=JAMBA_MAX_LEN, slots=JAMBA_SLOTS,
        need=_jamba_need)
    result["plan"]["k1_per_forward"] = _k1_groups(server.params["blocks"])
    short = [rng.integers(0, cfg.vocab, size=64).astype(np.int32)
             for _ in range(JAMBA_SLOTS)]
    result["decode_split"] = _decode_profile(server, cfg, short, smi,
                                             tag="jamba",
                                             classes=JAMBA_CLASSES)
    result["admissions"] = _jamba_admissions(server, prompts, smi)
    # K1 bitwise on every precision group of the plan-bound layer 0
    # (Mamba-2) and of its dense FFN, at decode and the longest prefill
    blk = server.params["blocks"][0]["l0"]
    groups = {**_planned(blk["mixer"]),
              **{f"ffn.{k}": v for k, v in _planned(blk["ffn"]).items()}}
    cases = sorted({(m, w.n_in, wq.shape[0], b) for w in groups.values()
                    for b, wq, _ in w.groups
                    for m in (JAMBA_SLOTS, max(JAMBA_LENS))})
    result["k1_err"] = _k1_bitwise(dev, cases, 11, "jamba layer 0")
    log(f"[jamba] K1 bitwise equal to its plain version on every precision "
        f"group of plan-bound layer 0's Mamba-2 mixer and dense FFN "
        f"({len(cases)} cases: {', '.join(sorted(groups))} at M "
        f"{JAMBA_SLOTS} and {max(JAMBA_LENS)})")
    result["layer_plan"] = phase_mamba_layer(
        cfg, blk["mixer"], dev, "plan-bound", lens=JAMBA_LAYER_LENS,
        tag="jamba")
    del server, blk, groups
    _free(dev)
    float_prompts = [prompts[JAMBA_LENS.index(n)] for n in JAMBA_FLOAT]
    server, result["float"] = _serve_counted(
        cfg, params, None, float_prompts, JAMBA_FLOAT_NEW, dev, counters,
        smi, "[jamba] float", max_len=JAMBA_MAX_LEN, slots=JAMBA_SLOTS,
        need=_jamba_need)
    del server
    _free(dev)
    # paged (K3 at the prompt's exact length) vs dense prefill logits, and
    # paged with K3 vs paged with its plain version, at 64 tokens and at
    # two lengths whose last 64-row tile is partial
    result["paged_vs_dense"] = {}
    for toks in (prompts[-1][:64], prompts[1], prompts[2]):
        rel = _moe_prefill_gap(cfg, params, plan, toks, dev)
        rel_f = _moe_prefill_gap(cfg, params, None, toks, dev)
        worst = max(rel["k3"], rel_f["k3"], rel["k3_vs_plain"],
                    rel_f["k3_vs_plain"])
        if worst > 5e-2:
            raise AssertionError(f"jamba paged vs dense prefill logits at "
                                 f"{toks.size} tokens: relative L2 error "
                                 f"{rel} (plan), {rel_f} (float) > 5e-2")
        log(f"[jamba] paged (K3, unpadded) vs dense prefill logits on a "
            f"{toks.size}-token prompt: relative L2 error {rel['k3']:.3g} "
            f"plan-bound, {rel_f['k3']:.3g} float (bound 5e-2); witnesses "
            f"with K3's plain version {rel['plain']:.3g} / "
            f"{rel_f['plain']:.3g}; K3 vs its plain version in the paged "
            f"prefill {rel['k3_vs_plain']:.3g} / {rel_f['k3_vs_plain']:.3g}")
        result["paged_vs_dense"][int(toks.size)] = dict(
            plan_k3=rel["k3"], float_k3=rel_f["k3"],
            plan_plain=rel["plain"], float_plain=rel_f["plain"],
            plan_k3_vs_plain=rel["k3_vs_plain"],
            float_k3_vs_plain=rel_f["k3_vs_plain"])
    result["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[jamba] peak memory {result['peak_gib']:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); {smi}")
    del params, plan
    _free(dev)
    return result


# ---------------------------------------------------------------------------
# path 12: MoE training under the search (arctic at published widths)
# ---------------------------------------------------------------------------

# K4 on expert banks: (label, E, K, C_out) of each bank a train step
# hands K4 as C_out rows of E * K (``core.mps.kernel_combine``)
K4_BANKS = (("arctic-480b w_gate / w_up (32 experts)", 32, 7168, 4864),
            ("arctic-480b w_down (32 experts)", 32, 4864, 7168),
            ("llama4-scout w_gate / w_up (16 experts)", 16, 5120, 8192),
            ("llama4-scout w_down (16 experts)", 16, 8192, 5120))
K4_BANK_CHUNK = 256         # rows of the plain version held at a time


def phase_k4_banks(dev, flush):
    """K4 at the expert banks' shapes: C_out rows of E * K (229,376 and
    155,648 at arctic's 32-expert banks, 81,920 and 131,072 at scout's
    16), too long for two ring stages, so the simple kernels take them.
    Forward, absmax and dW bitwise against the plain versions and dprobs
    within the summation bound, held K4_BANK_CHUNK rows at a time (each
    row is its own block); device ms of both kernels, of their plain
    versions and of the transposing copy of an (E, K, C_out) float32
    bank into rows, each beside its byte bound."""
    from repro_torch.kernels.mps_combine import ops as mops

    g = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for label, e, kin, c in K4_BANKS:
        m, k = c, e * kin
        w = torch.randn(m, k, generator=g, device=dev) * 0.05
        w[0, :3] = 0.0
        up = torch.randn(m, k, generator=g, device=dev)
        probs = torch.softmax(torch.randn(m, len(K4_PW), generator=g,
                                          device=dev), -1)
        absmax = torch.empty(m, device=dev)
        got = mops.mps_combine_fwd(w, probs, K4_PW, absmax)
        dw, dprobs = mops.mps_combine_bwd(w, probs, absmax, up, K4_PW)
        torch.cuda.synchronize()
        for r0 in range(0, m, K4_BANK_CHUNK):
            r = slice(r0, r0 + K4_BANK_CHUNK)
            where = f"{label} rows {r0}.. ({m}x{k})"
            want = mops.mps_combine_ref(w[r], probs[r], K4_PW)
            want_dw, _ = mops._vjp_bwd(w[r], probs[r], K4_PW, up[r])
            if not torch.equal(got[r], want) or not torch.equal(
                    absmax[r], torch.amax(w[r].abs(), 1)):
                raise AssertionError(f"K4 forward not bitwise at {where}")
            if not torch.equal(dw[r], want_dw):
                raise AssertionError(f"K4 backward dW not bitwise at {where}")
            _k4_dprobs_check(w[r], probs[r], up[r], dprobs[r], where)
        del got, dw, dprobs, want, want_dw
        n_p = len(K4_PW)
        n_nz = sum(1 for b in K4_PW if b)
        fwd = device_ms(lambda: mops.mps_combine_fwd(w, probs, K4_PW, absmax),
                        5, flush, "mps_")
        fwd_kernel = "ring" if any("mps_ring" in x for x in device_ms.names) \
            else "simple"
        bwd = device_ms(lambda: mops.mps_combine_bwd(w, probs, absmax, up,
                                                     K4_PW), 5, flush, "mps_")
        bwd_kernel = "ring" if any("mps_ring" in x for x in device_ms.names) \
            else "simple"
        fwd_plain = device_ms(lambda: mops.mps_combine_ref(w, probs, K4_PW),
                              2, flush, names=False)
        bank = up.view(e, kin, c)       # the layout the LM keeps a bank in
        copy = device_ms(lambda: torch.movedim(bank, 2, 0).contiguous(), 5,
                         flush, names=False)
        del bank
        r = dict(rows=m, k=k, fwd=fwd, fwd_kernel=fwd_kernel, bwd=bwd,
                 bwd_kernel=bwd_kernel, fwd_plain=fwd_plain, copy=copy)
        r["fwd_bound"], r["fwd_by"] = bound(2 * m * k * 4 + m * n_p * 4
                                            + m * 4, 7 * m * k * n_nz, "f32")
        r["bwd_bound"], r["bwd_by"] = bound(3 * m * k * 4 + 2 * m * n_p * 4
                                            + m * 4, 14 * m * k * n_nz, "f32")
        r["copy_bound"] = bound(2 * m * k * 4, 0, "f32")[0]
        out[label] = r
        log(f"[kernels] K4 bank {label}: {m} rows x {k} ({m * k * 4 / 1e9:.2f}"
            f" GB f32), pw {K4_PW}: forward, absmax and dW bitwise against "
            f"the plain versions, dprobs within the summation bound; forward "
            f"{fwd:.3f} ms device ({fwd_kernel} kernel), bound "
            f"{r['fwd_bound']:.3f} ({r['fwd_by']}), plain {fwd_plain:.3f}; "
            f"backward {bwd:.3f} ms device ({bwd_kernel} kernel), bound "
            f"{r['bwd_bound']:.3f} ({r['bwd_by']}); the transposing copy of "
            f"the ({e}, {kin}, {c}) bank into rows {copy:.3f} ms device "
            f"(bound {r['copy_bound']:.3f}, bytes)")
        del w, up, probs, absmax
        torch.cuda.empty_cache()
    return out


ARCTIC_TRAIN = dict(n_layers=1, n_experts=32)     # of 35 layers, 128 experts
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 8, 256
MOE_TRAIN_LENS = (64, 200, 377, 512)
MOE_TRAIN_NEW = 16
MOE_LAYER_TOKENS, MOE_LAYER_EXPERTS = 64, 4
JAMBA_SMOKE = "jamba-1.5-large-398b-smoke"
# the jamba-smoke step on the card against the CPU: bounds 1.5x this
# comparison's readings on the H100 (largest leaf 0.0595, median 0.0158;
# PERF.md section 6)
JAMBA_STEP_GRAD_MAX, JAMBA_STEP_GRAD_MEDIAN = 9e-2, 2.5e-2


def _arctic_train_cfg():
    import dataclasses

    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get("arctic-480b"), **ARCTIC_TRAIN)
    if not (cfg.remat and cfg.param_dtype == "bfloat16" and cfg.optimizer
            == "adam_int8" and cfg.train_microbatches == 4 and
            cfg.experts_per_token == 2 and cfg.dense_residual):
        raise AssertionError(f"moe train: unexpected config {cfg}")
    return cfg


def _rel(a, b):
    """Relative L2 of torch tensors (the CPU suites' ``rel`` takes numpy
    arrays, in a module that imports the JAX package)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def phase_moe_train_layer(cfg, dev):
    """One arctic MoE layer at published widths (d 7168, moe_d_ff = d_ff
    4864, top-2, the shared FFN) with MOE_LAYER_EXPERTS experts, bf16
    weights and a float32 router (so that no gate sits on a bf16 tie
    between the card's and the CPU's rounding), under the search: the
    output and every gradient (banks, bank gammas, router, shared FFN,
    input) on the card (K4 on the banks) against the CPU (the plain
    quantizer stack), relative L2 within 2e-2, the routing equal."""
    import dataclasses

    from repro_torch.core import mps, sampling
    from repro_torch.models import lm
    from repro_torch.nn import blocks

    lcfg = dataclasses.replace(cfg, n_experts=MOE_LAYER_EXPERTS)
    d, f, e = lcfg.d_model, lcfg.expert_d_ff, lcfg.n_experts
    g = torch.Generator().manual_seed(13)

    def w(*shape, gamma=True, dtype=torch.bfloat16):
        t = (torch.randn(*shape, generator=g) / shape[-2] ** 0.5).to(dtype)
        out = {"w": t}
        if gamma:
            out["gamma"] = sampling.init_selection_logits(
                lcfg.mps_precisions, (shape[-1],), "cpu")
        return out

    p0 = {"router": w(d, e, gamma=False, dtype=torch.float32),
          "w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d),
          "shared": {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}}
    x0 = torch.randn(1, MOE_LAYER_TOKENS, d, generator=g).to(torch.bfloat16)
    up = torch.randn(1, MOE_LAYER_TOKENS, d, generator=g)
    getw = lm._make_getw(lcfg, mps.SearchCtx(tau=1.0))
    res, routes = {}, {}
    inner = blocks.moe_route
    for where in ("card", "cpu"):
        dv = dev if where == "card" else torch.device("cpu")
        p = {k: ({kk: {n: t.to(dv).requires_grad_() for n, t in vv.items()}
                  for kk, vv in v.items()} if k == "shared" else
                 {n: t.to(dv).requires_grad_() for n, t in v.items()})
             for k, v in p0.items()}
        x = x0.to(dv).requires_grad_()

        def rec(xx, rw, **k):
            o = inner(xx, rw, **k)
            routes[where] = o[3].cpu()
            return o

        blocks.moe_route = rec
        try:
            y = blocks.moe_layer(p, x, lcfg, effective_w=getw)
        finally:
            blocks.moe_route = inner
        (y.float() * up.to(dv)).sum().backward()
        res[where] = dict(_leaves({"y": y, "x": x.grad, **{
            k: ({kk: {n: t.grad for n, t in vv.items()}
                 for kk, vv in v.items()} if k == "shared" else
                {n: t.grad for n, t in v.items()}) for k, v in p.items()}}))
    if not torch.equal(routes["card"], routes["cpu"]):
        raise AssertionError("moe train layer: the card routes otherwise "
                             "than the CPU")
    rel = {}
    for k, want in res["cpu"].items():
        got = res["card"][k]
        rel[k] = _rel(got, want)
        if not (torch.isfinite(got).all() and rel[k] <= 2e-2):
            raise AssertionError(f"moe train layer: {k} on the card vs the "
                                 f"CPU, relative L2 {rel[k]} (bound 2e-2)")
    worst = max(rel, key=rel.get)
    log(f"[moe-train] one arctic MoE layer at published widths with {e} "
        f"experts (bf16 weights, float32 router), {MOE_LAYER_TOKENS} tokens, "
        f"under the search: the routing equal and the output and all "
        f"{len(rel) - 1} gradients on the card (K4 on the banks) within 2e-2 "
        f"relative L2 of the CPU's (plain quantizer stack); largest {worst} "
        f"{rel[worst]:.3g}, output {rel['y']:.3g}, median "
        f"{float(np.median(list(rel.values()))):.3g}")
    return rel


class _KeepGrads:
    """Wraps an optimizer so its state keeps the gradients it was handed
    (after the global-norm clip): all of them, or the leaves whose path
    ``keep`` accepts (clones, so the rest are freed).  The CPU suites'
    ``tests/torch_train_cases._capturing`` is the same wrapper for both
    packages; this script cannot import it, since that module imports
    the JAX package."""

    def __init__(self, inner, keep=None):
        self.inner, self.keep = inner, keep

    def init(self, params):
        return {"inner": self.inner.init(params), "grads": None}

    def update(self, grads, state, params, step, axes=None):
        p, s = self.inner.update(grads, state["inner"], params, step, axes)
        if self.keep is not None:
            grads = {k: g.clone() for k, g in _leaves(grads) if self.keep(k)}
        return p, {"inner": s, "grads": grads}


def phase_jamba_train_step(dev, counters):
    """One jamba-smoke search train step (float32 masters, adam at 3e-4,
    seed-0 weights, 2 x 64 tokens) on the card against the same step on
    the CPU: the card runs K4 on the banks and the dense projections and
    K5 forward and backward in one step.  Held: the loss within rtol 1e-3,
    every gradient leaf within JAMBA_STEP_GRAD_MAX relative L2 and the
    median leaf within JAMBA_STEP_GRAD_MEDIAN (this comparison's own
    readings, PERF.md section 6), each parameter moved as on the CPU
    (``_moved_alike``), launches counted: K4 once a gamma node each way,
    K5 once a Mamba-2 layer each way."""
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.optim import optimizers

    cfg = registry.get(JAMBA_SMOKE)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", mps_on=True)
    batch = synthetic.lm_batch(cfg.vocab, 65, 2, 0, device="cpu")
    lr = 3e-4
    out = {}
    for where in ("cpu", "card"):
        dv = dev if where == "card" else torch.device("cpu")
        p = {k: v for k, v in _tree_to(params, dv).items()}
        opt = _KeepGrads(optimizers.make_optimizer(cfg.optimizer, lr))
        step = steps_lib.make_train_step(cfg, opt, search=True)
        b = {k: v.to(dv) for k, v in batch.items()}
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        new, st, loss = step(p, opt.init(p), b, 0)
        torch.cuda.synchronize()
        out[where] = dict(loss=float(loss), params=dict(_leaves(new)),
                          grads=dict(_leaves(st["grads"])),
                          launches={k: fn.launches
                                    for k, fn in counters.items()})
    n_nodes = lm.mps_param_count(cfg) * lm.n_superblocks(cfg)
    n_mamba = sum(s.mixer == "mamba" for s in lm.block_pattern(cfg))
    n_banks = 3 * sum(s.ffn == "moe" for s in lm.block_pattern(cfg))
    need = {"mps_combine": n_nodes, "mps_combine_bwd": n_nodes,
            "ssd_scan": n_mamba, "ssd_scan_bwd": n_mamba}
    got = out["card"]["launches"]
    if any(got[k] != v for k, v in need.items()) or any(
            v for k, v in got.items() if k not in need) or any(
            out["cpu"]["launches"].values()):
        raise AssertionError(f"jamba train step: launches {got} (CPU "
                             f"{out['cpu']['launches']}), need {need}")
    lc, lg = out["cpu"]["loss"], out["card"]["loss"]
    if not (np.isfinite(lg) and abs(lg - lc) <= 1e-3 * abs(lc)):
        raise AssertionError(f"jamba train step: loss {lg} on the card, {lc} "
                             f"on the CPU")
    gaps = {k: _rel(out["card"]["grads"][k], v)
            for k, v in out["cpu"]["grads"].items()}
    med = float(np.median(list(gaps.values())))
    worst = max(gaps, key=gaps.get)
    if gaps[worst] > JAMBA_STEP_GRAD_MAX or med > JAMBA_STEP_GRAD_MEDIAN:
        raise AssertionError(f"jamba train step: gradient {worst} "
                             f"{gaps[worst]} (bound {JAMBA_STEP_GRAD_MAX}), "
                             f"median {med} (bound {JAMBA_STEP_GRAD_MEDIAN})")
    start = dict(_leaves(params))
    stay = _moved_alike(out["card"]["params"], out["cpu"]["params"], start,
                        out["cpu"]["grads"])
    bank_grads = [k for k in gaps if "/ffn/w_" in k and "gamma" in k
                  and int(k.split("/")[1][1:]) % 2]
    if len(bank_grads) != n_banks or not all(
            out["card"]["grads"][k].abs().sum() > 0 for k in bank_grads):
        raise AssertionError(f"jamba train step: bank gamma gradients "
                             f"{bank_grads}")
    log(f"[jamba-train] one {cfg.name} search step (8 layers: 7 Mamba-2, 1 "
        f"attention, 4 MoE slots of 4 experts; 2 x 64 tokens) on the card "
        f"vs the CPU: loss {lg:.6f} vs {lc:.6f}; gradients of all "
        f"{len(gaps)} leaves within {JAMBA_STEP_GRAD_MAX} relative L2 "
        f"(largest {worst} "
        f"{gaps[worst]:.3g}, median {med:.3g}); every parameter entry "
        f"whose CPU gradient is a quarter of its leaf's largest moved as on "
        f"the CPU, {stay} of them not at all on the card; launches {got}: "
        f"K4 {n_nodes} "
        f"each way ({n_banks} of them banks), K5 {n_mamba} forward and "
        f"{n_mamba} backward")
    return dict(launches=got, gap_max=gaps[worst], gap_median=med,
                loss=(lg, lc))


def _moved_alike(new, ref, start, grads):
    """Adam's first step moves an entry by about ``lr * sign(g)``: where
    the reference's gradient is a quarter of its leaf's largest or more
    and its entry moved, the other entry moves the same way, never the
    other, and stays put in at most 1% of them (an entry whose step is
    near half its bf16 spacing may round to no move).  Returns how many
    stayed put."""
    stay = 0
    for k, v in ref.items():
        v, s0, g = v.cpu().float(), start[k].cpu().float(), grads[k].cpu()
        rd, nd = torch.sign(v - s0), torch.sign(new[k].cpu().float() - s0)
        big = (g.abs() >= 0.25 * g.abs().max()) & (rd != 0)
        n0 = int((nd[big] == 0).sum())
        if bool((nd[big] == -rd[big]).any()) or n0 > 0.01 * int(big.sum()):
            raise AssertionError(f"{k}: moved otherwise than the reference "
                                 f"({n0} of {int(big.sum())} stayed put)")
        stay += n0
    return stay


def _tree_to(tree, dv):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dv) for k, v in tree.items()}
    return tree.detach().to(dv).clone()


def phase_train_moe(dev, counters, smi, banks):
    """Path 12: the paper's joint search on arctic-480b at published
    widths cut to ARCTIC_TRAIN (1 of 35 layers, 32 of 128 experts a
    bank), bf16 masters, adam_int8 at 3e-4, 4 micro-batches, remat,
    weights from seed 0, through ``make_train_step(search=True)`` for
    MOE_TRAIN_STEPS steps of MOE_TRAIN_BATCH x MOE_TRAIN_SEQ tokens;
    launches read around the run; the remat recompute's routing held
    equal to the forward's; one step profiled; then the plan extracted,
    bound and served (4 requests plan-bound, 1 float) on K1-K3, paged
    vs dense prefill logits, one MoE layer card vs CPU and the jamba
    smoke step card vs CPU."""
    from repro_torch.core import mps
    from repro_torch.data import synthetic
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.nn import blocks
    from repro_torch.optim import optimizers

    cfg = _arctic_train_cfg()
    pw = cfg.mps_precisions
    n_nodes = lm.mps_param_count(cfg) * lm.n_superblocks(cfg)
    n_bank_nodes = 3 * lm.n_superblocks(cfg)
    k = cfg.train_microbatches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, mps_on=True)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for key, t in _leaves(params)
                   if not key.endswith("gamma"))
    n_bank = sum(t.numel() for key, t in _leaves(params)
                 if "/ffn/w_" in key and key.endswith("/w"))
    def is_bank_gamma(key):
        return "/ffn/w_" in key and key.endswith("gamma")

    opt = _KeepGrads(optimizers.make_optimizer(cfg.optimizer, 3e-4),
                     keep=is_bank_gamma)
    state = {"params": params, "opt": opt.init(params)}
    del params
    resident = torch.cuda.memory_allocated(dev)
    step_fn = steps_lib.make_train_step(cfg, opt, search=True)
    bank_gamma0 = {key: t.clone() for key, t in _leaves(state["params"])
                   if is_bank_gamma(key)}

    def batch_at(step):
        return synthetic.lm_batch(cfg.vocab, MOE_TRAIN_SEQ + 1,
                                  MOE_TRAIN_BATCH, step, device=dev)

    log(f"[moe-train] {cfg.name}: {cfg.n_layers} of 35 layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, {cfg.n_experts} of 128 experts top-"
        f"{cfg.experts_per_token} of d_ff {cfg.expert_d_ff} + the shared "
        f"FFN of {cfg.d_ff}, vocab {cfg.vocab}; {n_params / 1e9:.3f} B bf16 "
        f"parameters ({n_bank / 1e9:.3f} B in the 3 expert banks) + "
        f"{n_nodes} gammas, drawn in {time.perf_counter() - t0:.1f} s; "
        f"{cfg.optimizer} state: {resident / 2**30:.2f} GiB resident with "
        f"the weights; search, batch {MOE_TRAIN_BATCH} x seq "
        f"{MOE_TRAIN_SEQ} in {k} micro-batches, remat {cfg.remat}, pw {pw}")

    # the remat recompute routes as the forward did: step 0's calls come
    # in (forward, recompute) pairs, one pair a micro-batch
    routes, inner = [], blocks.moe_route

    def rec(x, rw, **kw):
        o = inner(x, rw, **kw)
        routes.append((o[3].clone(), o[2].clone()))
        return o

    plain, restore = _count_plain_stack()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    times, losses, norms = [], [], []
    try:
        for i in range(MOE_TRAIN_STEPS):
            batch = batch_at(i)
            torch.cuda.synchronize()
            blocks.moe_route = rec if i == 0 else inner
            t1 = time.perf_counter()
            p, o, loss = step_fn(state["params"], state["opt"], batch, i)
            state = {"params": p, "opt": o}
            losses.append(float(loss))
            norms.append(float(step_fn.grad_norm))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            del p, o
    finally:
        blocks.moe_route = inner
        restore()
    got = {key: fn.launches for key, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    need = {"mps_combine": n_nodes * k * 2 * MOE_TRAIN_STEPS,
            "mps_combine_bwd": n_nodes * k * MOE_TRAIN_STEPS}
    if any(got[key] != v for key, v in need.items()) or any(
            v for key, v in got.items() if key not in need):
        raise AssertionError(f"moe train: launches {got}, need {need} and no "
                             f"other kernel")
    if plain[0]:
        raise AssertionError(f"moe train: {plain[0]} weights took the plain "
                             f"quantizer stack")
    if len(routes) != 2 * k or any(
            not (torch.equal(routes[2 * j][0], routes[2 * j + 1][0]) and
                 torch.equal(routes[2 * j][1], routes[2 * j + 1][1]))
            for j in range(k)):
        raise AssertionError(f"moe train: {len(routes)} routing calls in "
                             f"step 0, or a remat recompute routed otherwise "
                             f"than its forward")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"moe train: losses {losses}, grad norms {norms}")
    moved = [key for key, t in _leaves(state["params"])
             if key in bank_gamma0 and not torch.equal(t, bank_gamma0[key])]
    grads = state["opt"]["grads"]       # the last step's, clipped
    nonzero = {key: float(g.abs().sum()) for key, g in grads.items()}
    if not bank_gamma0 or len(moved) != len(bank_gamma0) or sorted(
            nonzero) != sorted(bank_gamma0) or not all(
            np.isfinite(v) and v > 0 for v in nonzero.values()):
        raise AssertionError(f"moe train: bank gammas moved {moved} of "
                             f"{sorted(bank_gamma0)}; gradients {nonzero}")
    del bank_gamma0
    with torch.no_grad():
        cost = float(lm.mps_size_cost(cfg, state["params"],
                                      mps.SearchCtx(tau=1.0)))
    if not np.isfinite(cost):
        raise AssertionError(f"moe train: mps_size_cost {cost}")
    ms = 1e3 * float(np.median(times[1:]))
    tok_s = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (ms / 1e3)
    sums = ", ".join(f"{key.split('/')[-2]} {v:.3g}"
                     for key, v in nonzero.items())
    log(f"[moe-train] {MOE_TRAIN_STEPS} search steps on "
        f"{torch.cuda.get_device_name(dev)} ({smi}): losses "
        f"{[round(v, 4) for v in losses]}, grad norms "
        f"{[round(v, 4) for v in norms]}; step ms "
        f"{[round(1e3 * t, 1) for t in times]}, median of steps "
        f"2-{MOE_TRAIN_STEPS} {ms:.1f} ms = {tok_s:.0f} training tokens/s; "
        f"peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)"
        f"; mps_size_cost {cost:.6g} bytes; K4 launches {got['mps_combine']} "
        f"forward = {n_nodes} gamma nodes x {k} micro-batches x 2 (remat "
        f"recompute) x {MOE_TRAIN_STEPS} steps ({n_bank_nodes * k * 2} a step "
        f"on the banks), {got['mps_combine_bwd']} backward = {n_nodes} x {k} "
        f"x {MOE_TRAIN_STEPS} ({n_bank_nodes * k} a step on the banks); "
        f"plain quantizer stack: 0 calls; step 0's {k} remat recomputes "
        f"routed as their forwards (top_i, top_g equal); all "
        f"{len(moved)} bank gammas moved, their gradients nonzero (step "
        f"{MOE_TRAIN_STEPS - 1}'s sum |g|: {sums})")

    state, prof = train.profile_steps(step_fn, state, batch_at,
                                      MOE_TRAIN_STEPS, 1, dev)
    busy = prof["device_s"] / prof["wall_s"]
    kern = prof["kernels"]
    k4_bank = {d: sum(v for n, v in kern.items() if "mps_" in n
                      and "simple" in n and ("bwd" in n) == (d == "bwd"))
               for d in ("fwd", "bwd")}
    k4_all = sum(v for n, v in kern.items() if "mps_" in n)
    n_copy, copy_s = prof["copies"].get(mps.COPY_RANGES[True], (0, 0.0))
    copy_ms = 1e3 * copy_s
    if n_copy != 3 * n_bank_nodes * k or not copy_ms > 0:
        raise AssertionError(f"moe train: {n_copy} bank transposing copies "
                             f"({copy_ms} ms) in the profiled step, need "
                             f"{3 * n_bank_nodes * k} with device time")
    # cross-check: the kernels phase's copy times at the bank shapes, x 3
    # a bank a micro-batch
    copies = {label: b["copy"] for label, b in banks.items()
              if label.startswith("arctic")}
    copy_est = sum(3 * k * v * (2 if "w_up" in label else 1)
                   for label, v in copies.items())
    log(f"[moe-train] one profiled step: wall {1e3 * prof['wall_s']:.1f} ms, "
        f"device {1e3 * prof['device_s']:.1f} ms = {100 * busy:.1f}% busy, "
        f"{prof['launches']} device operations; K4 {1e3 * k4_all:.2f} ms "
        f"device: on the banks (simple kernels, {n_bank_nodes * k * 2} "
        f"forward + {n_bank_nodes * k} backward launches) forward "
        f"{1e3 * k4_bank['fwd']:.2f} + backward {1e3 * k4_bank['bwd']:.2f} "
        f"ms, the other {n_nodes - n_bank_nodes} projections (ring kernels) "
        f"{1e3 * (k4_all - k4_bank['fwd'] - k4_bank['bwd']):.2f} ms; the "
        f"banks' transposing copies into rows {copy_ms:.2f} ms device over "
        f"{n_copy} copies (profiler range '{mps.COPY_RANGES[True]}': W "
        f"twice a bank a micro-batch with remat, the gradient once; the "
        f"kernels phase's copy times x 3 a bank a micro-batch give "
        f"{copy_est:.2f} ms)")
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
    log("[moe-train] top kernels of the profiled step (device ms): "
        + "; ".join(f"{n[:70]} {1e3 * v:.2f}" for n, v in top))

    del state["opt"]
    params = state["params"]
    plan = lm.extract_plan(cfg, params)
    bits = {int(b) for v in plan.channel_bits.values() for b in v}
    want_groups = len(lm._plan_weights(cfg)) * lm.n_superblocks(cfg)
    if len(plan.groups) != want_groups or not bits <= set(pw) or any(
            ".ffn.w_" in grp or "router" in grp for grp in plan.groups):
        raise AssertionError(f"moe train: plan {plan.summary()} groups "
                             f"{list(plan.groups)}, bits {sorted(bits)}")
    log(f"[moe-train] searched plan: {plan.summary()}, bits {sorted(bits)}; "
        f"the banks and the router stay float (cuBLAS)")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in MOE_TRAIN_LENS]
    L = cfg.n_layers
    runs = {}
    for label, run_plan, reqs in (("plan", plan, prompts),
                                  ("float", None, prompts[1:2])):
        def need_serve(server, steps, adm, planned=run_plan is not None):
            return {"paged_attention": L * steps, "paged_prefill": L * adm,
                    "quant_matmul": 7 * L * (steps + adm) if planned else 0}

        server, runs[label] = _serve_counted(
            cfg, params, run_plan, reqs, MOE_TRAIN_NEW, dev, counters, smi,
            f"[moe-train] serve {label}", max_len=1024, slots=4,
            need=need_serve, at_least=True)
        del server
    gap = _moe_prefill_gap(cfg, params, plan, prompts[0][:64], dev)
    gap_f = _moe_prefill_gap(cfg, params, None, prompts[0][:64], dev)
    if max(gap["k3"], gap_f["k3"]) > 5e-2:
        raise AssertionError(f"moe train: paged vs dense prefill logits "
                             f"{gap} (plan), {gap_f} (float) > 5e-2")
    log(f"[moe-train] paged (K3) vs dense prefill logits on a 64-token "
        f"prompt: relative L2 {gap['k3']:.3g} plan-bound, {gap_f['k3']:.3g} "
        f"float (bound 5e-2)")
    del params, state, plan
    _free(dev)
    layer_rel = phase_moe_train_layer(cfg, dev)
    _free(dev)
    jamba = phase_jamba_train_step(dev, counters)
    return dict(launches=got, served=runs["plan"]["launches"],
                served_float=runs["float"]["launches"], ms=ms, tok_s=tok_s,
                peak_bytes=peak, resident_bytes=resident, busy=busy,
                k4_bank_ms=k4_bank, k4_ms=k4_all, copy_ms=copy_ms,
                copy_est_ms=copy_est,
                layer_rel=layer_rel, jamba=jamba,
                paged_vs_dense=dict(plan=gap["k3"], float=gap_f["k3"]))


# ---------------------------------------------------------------------------
# path 13: the expert-parallel layout on four ranks sharing the card
# ---------------------------------------------------------------------------

EP_ARCH = "arctic-480b"
EP_SERVE_MESH, EP_TRAIN_MESH = (1, 4), (2, 2)
EP_SERVE = dict(n_layers=1, param_dtype="bfloat16")     # all 128 experts
EP_TRAIN = dict(n_layers=1, n_experts=8)               # of 35 layers, 128
EP_LENS = (64, 200, 377, 512)
EP_NEW, EP_PS, EP_MAX_LEN = 16, 16, 544
EP_STEPS, EP_BATCH, EP_SEQ = 3, 8, 256
EP_CLI = "arctic-480b-smoke"
# the (2, 2) step's clipped gradients against the single-process
# reference on the same data shards, relative L2 per leaf: 1.5x this
# comparison's largest reading on the H100 (the router's 4.70e-3;
# median leaf 1.8e-6; PERF.md section 6)
EP_TRAIN_GRAD = 7e-3
K4_GIVEN = (("w_gate / w_up", 4864, 4 * 7168), ("w_down", 7168, 4 * 4864))


def _ep_rules():
    """The rule overrides that unmap every axis but ``batch`` and
    ``experts``: path 13 holds the expert-parallel layout alone."""
    from repro_torch.distributed import sharding
    return {a: None for a in sharding.DEFAULT_RULES
            if a not in ("batch", "experts")}


def _ep_cfg(kw):
    import dataclasses

    from repro_torch.configs import registry
    return dataclasses.replace(registry.get(EP_ARCH), **kw)


def _ep_draw(cfg, dev, experts, mps_on=False):
    """Parameters of ``cfg`` with ``lm.init_params``' tree whose expert
    banks hold only ``experts`` (a range of expert indices): every bank
    expert is drawn from a generator seeded by its bank and its index,
    every other leaf from one seeded by its path, so a rank draws its own
    experts alone and the single-process reference (all experts)
    concatenates the same draws.  Weights in ``cfg.param_dtype``, norms
    0, gammas at the Eq. 13 init."""
    import zlib

    from repro_torch.core import sampling
    from repro_torch.models import lm
    meta = lm.init_params(cfg, device="meta", mps_on=mps_on)
    axes = lm.logical_axes(cfg, mps_on=mps_on)
    dtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" else \
        torch.float32

    def draw(path, leaf, ax):
        if isinstance(leaf, dict):
            return {k: draw(f"{path}/{k}", leaf[k], ax[k]) for k in leaf}
        if path.endswith("gamma"):
            return sampling.init_selection_logits(
                cfg.mps_precisions, tuple(leaf.shape[:-1]), dev)
        if not path.endswith("/w"):
            return torch.zeros(leaf.shape, dtype=dtype, device=dev)
        seed = zlib.crc32(path.encode())
        scale = 0.02 if path in ("/embed/w", "/lm_head/w") else \
            1.0 / leaf.shape[-2] ** 0.5
        if "experts" not in ax:
            g = torch.Generator(device=dev).manual_seed(seed)
            return (torch.randn(leaf.shape, generator=g, device=dev)
                    * scale).to(dtype)
        shape = list(leaf.shape)
        shape[1] = len(experts)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for j in range(shape[0]):
            for i, e in enumerate(experts):
                g = torch.Generator(device=dev).manual_seed(
                    seed * 1009 + 131 * j + e)
                out[j, i] = (torch.randn(shape[2:], generator=g, device=dev)
                             * scale).to(dtype)
        return out

    return draw("", meta, axes)


def _ep_prompts(cfg):
    rng = np.random.default_rng(25)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
            for n in EP_LENS]


def _ep_serve_run(cfg, params, dev, counters):
    """The prompts prefilled into a ``serve.cache.PagedCache`` (page
    EP_PS, padded to a q chunk) through ``make_paged_prefill_step`` (K3),
    then EP_NEW greedy decode steps of the batch through
    ``make_decode_step(tables=...)`` (K2); K1 on a plan-bound tree.
    Launches read around the run.  Returns (the last position's logits of
    every prefill and the decode steps' logits (float32, host), the
    tokens (B, EP_NEW + 1), the launches, wall seconds)."""
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.serve import cache as cache_mod

    prompts = _ep_prompts(cfg)
    backend = cache_mod.PagedCache(cfg, len(prompts), EP_MAX_LEN, dev,
                                   page_size=EP_PS)
    prefill = steps_lib.make_paged_prefill_step(cfg)
    decode = steps_lib.make_decode_step(cfg)
    q = min(pops.PREFILL_Q, max(8, EP_PS))
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rows, first, handles = [], [], []
    with torch.no_grad():
        for slot, p in enumerate(prompts):
            n = p.size
            h = backend.alloc(slot, slot, n)
            spad = -(-n // q) * q
            toks = torch.zeros((1, spad), dtype=torch.int32, device=dev)
            toks[0, :n] = torch.as_tensor(p, device=dev)
            width = min(-(-spad // EP_PS), backend.table_width)
            tables = backend.device_tables()[slot:slot + 1, :width]
            logits, pc = prefill(params, {"tokens": toks},
                                 backend.kv_caches(), tables,
                                 torch.tensor([n], dtype=torch.int32,
                                              device=dev))
            backend.insert(h, pc)
            rows.append(logits[0, -1].float().cpu())
            first.append(int(torch.argmax(logits[0, -1, :cfg.vocab])))
            handles.append(h)
        out, pos = [first], [p.size for p in prompts]
        for _ in range(EP_NEW):
            tables = backend.device_tables()[:, :max(pos) // EP_PS + 1]
            logits, caches = decode(
                params, {"tokens": torch.as_tensor(out[-1], device=dev)[
                    :, None]}, backend.gather(),
                torch.as_tensor(pos, dtype=torch.int32, device=dev), tables)
            backend.commit(caches)
            rows.append(logits[:, -1].float().cpu())
            out.append(torch.argmax(logits[:, -1, :cfg.vocab], -1).tolist())
            for i, h in enumerate(handles):
                pos[i] += 1
                backend.append(h)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in counters.items()}
    return rows, np.asarray(out).T, got, wall


class _CollectiveTimer:
    """Wall ms of every all-reduce of ``distributed.sharding`` on this
    rank (the card synchronised before and after each), by op."""

    def __init__(self):
        from repro_torch.distributed import sharding
        self.mod, self.inner = sharding, sharding._all_reduce
        self.ms = {}

        def timed(t, op, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.inner(t, op, group)
            torch.cuda.synchronize()
            key = f"{str(op).split('.')[-1]} {tuple(t.shape)}"
            self.ms.setdefault(key, []).append(
                1e3 * (time.perf_counter() - t0))
            return out

        sharding._all_reduce = timed

    def close(self):
        self.mod._all_reduce = self.inner
        return self.ms


def _ep_rank(rank, world, tmp):
    """One of the four ranks: the serve half on EP_SERVE_MESH, then the
    train half on EP_TRAIN_MESH; its results to ``tmp/rank<r>.pt``."""
    import torch.distributed as dist
    # four processes share the card: segments that grow in place keep a
    # rank's cache from holding gigabytes it cannot reuse
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=world)
    try:
        res = {"serve": _ep_rank_serve(rank)}
        _free(torch.device("cuda"))
        res["train"] = _ep_rank_train(rank, tmp)
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _counters():
    """Every kernel wrapper, whose ``launches`` the paths read."""
    from repro_torch.kernels.mps_combine import ops as mops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.ssd_scan import ops as sops
    return {"quant_matmul": qops.quant_matmul,
            "paged_attention": pops.paged_attention_fwd,
            "paged_prefill": pops.paged_prefill_fwd,
            "mps_combine": mops.mps_combine_fwd,
            "mps_combine_bwd": mops.mps_combine_bwd,
            "ssd_scan": sops.ssd_scan, "ssd_scan_bwd": sops.ssd_scan_bwd}


def _ep_rank_serve(rank):
    """Serve half on one rank: its 32 experts of each bank, plan-bound
    then float, under the (1, 4) mesh."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as meshlib
    from repro_torch.serve import engine

    dev = torch.device("cuda")
    cfg = _ep_cfg(EP_SERVE)
    mesh = meshlib.make_debug_mesh(*EP_SERVE_MESH, device=dev)
    e_loc = cfg.n_experts // EP_SERVE_MESH[1]
    m = mesh.coords["model"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _ep_draw(cfg, dev, range(m * e_loc, (m + 1) * e_loc))
    torch.cuda.synchronize()
    drawn = time.perf_counter() - t0
    plan = engine.synthetic_plan(cfg, params, bits=None, seed=0)
    out = {"drawn_s": drawn, "coords": mesh.coords,
           "bank_shape": tuple(params["blocks"]["l0"]["ffn"]["w_gate"][
               "w"].shape)}
    counters = _counters()
    with sharding.use_mesh(mesh, _ep_rules()):
        for label, tree in (("plan", engine.apply_plan(cfg, params, plan)),
                            ("float", params)):
            timer = _CollectiveTimer()
            rows, toks, got, wall = _ep_serve_run(cfg, tree, dev, counters)
            out[label] = dict(rows=rows, tokens=toks, launches=got,
                              wall=wall, collectives=timer.close())
            del tree
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["plan_groups"] = len(plan.groups)
    return out


def _ep_rank_train(rank, tmp):
    """Train half on one rank: EP_STEPS search steps of arctic cut to
    EP_TRAIN (8 experts, 4 a model rank) on the (2, 2) mesh, bf16
    masters, adam_int8 at 3e-4, 4 micro-batches, remat.  Records the
    losses (global and this data shard's), step 0's absmax of each bank
    and clipped gradients, the replicated leaves' digests after each
    step, the bank gammas' moves, the plan's digest, the launches, the
    collectives' wall ms and one profiled step's device split."""
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.optim import grad as gradlib
    from repro_torch.optim import optimizers

    dev = torch.device("cuda")
    cfg = _ep_cfg(EP_TRAIN)
    mesh = meshlib.make_debug_mesh(*EP_TRAIN_MESH, device=dev)
    e_loc = cfg.n_experts // EP_TRAIN_MESH[1]
    m = mesh.coords["model"]
    torch.cuda.reset_peak_memory_stats()
    params = _ep_draw(cfg, dev, range(m * e_loc, (m + 1) * e_loc),
                      mps_on=True)
    logical = lm.logical_axes(cfg, mps_on=True)
    opt = _KeepGrads(optimizers.make_optimizer(cfg.optimizer, 3e-4))
    state = {"params": params, "opt": opt.init(params)}
    del params
    step_fn = steps_lib.make_train_step(cfg, opt, search=True)
    gamma0 = {k: t.clone() for k, t in _leaves(state["params"])
              if "/ffn/w_" in k and k.endswith("gamma")}
    counters = _counters()
    local, absmax = [], []
    inner_acc, inner_max = gradlib.accumulate_grads, sharding.all_reduce_max

    def acc(*a, **k):
        g, loss = inner_acc(*a, **k)
        local.append(float(loss))
        return g, loss

    def amax(v, group):
        got = inner_max(v, group)
        absmax.append(got.cpu())
        return got

    res = {"coords": mesh.coords, "losses": [], "norms": [], "digests": [],
           "ms": []}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    counters["mps_combine"].given_launches = 0
    gradlib.accumulate_grads = acc
    timer = _CollectiveTimer()
    try:
        with sharding.use_mesh(mesh, _ep_rules()):
            for i in range(EP_STEPS):
                sharding.all_reduce_max = amax if i == 0 else inner_max
                batch = synthetic.lm_batch(cfg.vocab, EP_SEQ + 1, EP_BATCH, i,
                                           device=dev)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                p, o, loss = step_fn(state["params"], state["opt"], batch, i)
                torch.cuda.synchronize()
                res["ms"].append(1e3 * (time.perf_counter() - t1))
                if i == 0:
                    res["grads"] = {k: g.cpu() for k, g in
                                    _leaves(o["grads"])}
                o["grads"] = None
                state = {"params": p, "opt": o}
                del p, o
                res["losses"].append(float(loss))
                res["norms"].append(float(step_fn.grad_norm))
                res["digests"].append(_ep_digests(state["params"], logical))
            res["launches"] = {k: fn.launches for k, fn in counters.items()}
            res["given_launches"] = counters["mps_combine"].given_launches
            res["collectives"] = timer.close()
            res["profile"] = _ep_profile(step_fn, state, cfg, dev,
                                         traced=rank == 0)
            plan = lm.extract_plan(cfg, state["params"])
    finally:
        gradlib.accumulate_grads = inner_acc
        sharding.all_reduce_max = inner_max
    res["local_losses"] = local[:1]
    res["absmax"] = absmax[:3]
    res["gammas_moved"] = {k: not torch.equal(t, gamma0[k]) for k, t in
                           _leaves(state["params"]) if k in gamma0}
    res["plan"] = {g: plan.channel_bits[g].tolist() for g in plan.groups}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if mesh.coords["data"] != 0:      # the data ranks hold one average
        res.pop("grads")
    elif m:                           # and the model ranks one copy of the
        res["grads"] = {k: v for k, v in res["grads"].items()   # rest
                        if "/ffn/w_" in k and k.endswith("/w")
                        and "shared" not in k}
    return res


def _ep_digests(tree, logical):
    """Per leaf: two int64 sums of its bit patterns (plain and weighted
    by position), to tell whether ranks hold the same leaf."""
    from repro_torch.launch import steps as steps_lib
    out = {}

    def dig(axes, t):
        bits = t.detach().contiguous().view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
                t.element_size()]).reshape(-1)
        plain = weighted = 0
        for i in range(0, bits.numel(), 1 << 24):     # 16M values at a time
            c = bits[i:i + (1 << 24)].to(torch.int64)
            w = (torch.arange(i, i + c.numel(), device=c.device) % 8191) + 1
            plain += int(c.sum())
            weighted += int((c * w).sum())
        return (plain, weighted, "experts" in axes)

    flat = steps_lib.tree_map_axes(dig, logical, tree)
    for k, v in _leaves(flat):
        out[k] = v
    return out


def _ep_profile(step_fn, state, cfg, dev, traced):
    """One more step (its batch step EP_STEPS) on every rank, under
    torch.profiler where ``traced`` (rank 0): device ms by class (K4,
    cuBLAS products, copies and casts, the rest) and the collectives'
    wall ms; None on the other ranks."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import synthetic
    batch = synthetic.lm_batch(cfg.vocab, EP_SEQ + 1, EP_BATCH, EP_STEPS,
                               device=dev)
    timer = _CollectiveTimer()
    torch.cuda.synchronize()
    with (profile(activities=[ProfilerActivity.CUDA]) if traced
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        step_fn(state["params"], state["opt"], batch, EP_STEPS)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    coll = timer.close()
    if not traced:
        return None
    split = {"K4": 0.0, "cuBLAS": 0.0, "copies/casts": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        n = e.key
        if "mps_" in n:
            split["K4"] += ms
        elif any(x in n.lower() for x in ("gemm", "cutlass", "nvjet",
                                          "sm90_xmma")):
            split["cuBLAS"] += ms
        elif "copy" in n.lower() or "Memcpy" in n:
            split["copies/casts"] += ms
        else:
            split["other"] += ms
    return dict(wall_ms=wall, device_ms=sum(split.values()), split=split,
                collective_ms=sum(sum(v) for v in coll.values()),
                collectives=len([x for v in coll.values() for x in v]))


def phase_k4_given(dev, flush):
    """K4's forward given an absmax, at path 13's bank-shard shapes (4
    experts of arctic's banks as C_out rows of E_loc * K): forward and,
    with the same absmax, dW bitwise against the plain versions, dprobs
    within the summation bound; the given absmax a maximum over more
    rows than the shard's (the whole bank's); device ms beside the
    bound and the plain version."""
    from repro_torch.kernels.mps_combine import ops as mops

    g = torch.Generator(device=dev).manual_seed(25)
    out = {}
    for label, m, k in K4_GIVEN:
        w = torch.randn(m, k, generator=g, device=dev) * 0.05
        up = torch.randn(m, k, generator=g, device=dev)
        probs = torch.softmax(torch.randn(m, len(K4_PW), generator=g,
                                          device=dev), -1)
        # the other ranks' rows raise some channels' maximum
        absmax = torch.amax(w.abs(), 1) * torch.where(
            torch.rand(m, generator=g, device=dev) < 0.5, 1.0, 1.25)
        got = mops.mps_combine_fwd(w, probs, K4_PW, absmax_in=absmax)
        dw, dprobs = mops.mps_combine_bwd(w, probs, absmax, up, K4_PW)
        torch.cuda.synchronize()
        err = 0.0
        for r0 in range(0, m, K4_BANK_CHUNK):
            r = slice(r0, r0 + K4_BANK_CHUNK)
            where = f"given absmax {label} rows {r0}.. ({m}x{k})"
            want = mops.mps_combine_ref(w[r], probs[r], K4_PW, absmax[r])
            want_dw, _ = mops._vjp_bwd(w[r], probs[r], K4_PW, up[r],
                                       absmax[r])
            if not torch.equal(got[r], want):
                raise AssertionError(f"K4 forward not bitwise at {where}")
            if not torch.equal(dw[r], want_dw):
                raise AssertionError(f"K4 backward dW not bitwise at {where}")
            _k4_dprobs_check(w[r], probs[r], up[r], dprobs[r], where,
                             absmax[r])
            err = max(err, float((got[r] - want).abs().max()))
        del got, dw, dprobs
        def given():
            return mops.mps_combine_fwd(w, probs, K4_PW, absmax_in=absmax)

        fwd = device_ms(given, 5, flush, "mps_")
        kernel = "ring" if any("mps_ring" in x for x in device_ms.names) \
            else "simple"
        ev = time_ms(given, 5, flush)
        plain = device_ms(lambda: mops.mps_combine_ref(w, probs, K4_PW,
                                                       absmax),
                          2, flush, names=False)
        n_nz = sum(1 for b in K4_PW if b)
        b, by = bound(2 * m * k * 4 + m * len(K4_PW) * 4 + m * 4,
                      7 * m * k * n_nz, "f32")
        out[label] = dict(rows=m, k=k, ms=ev, device_ms=fwd, kernel=kernel,
                          plain_ms=plain, bound_ms=b, bound_by=by,
                          max_abs_err=err)
        log(f"[kernels] K4 given absmax {label}: {m} rows x {k} (path 13's "
            f"bank shard), pw {K4_PW}: forward and dW bitwise against the "
            f"plain versions given the same absmax, dprobs within the "
            f"summation bound; forward {ev:.3f} ms (CUDA events), "
            f"{fwd:.3f} ms device ({kernel} kernel), bound {b:.3f} ({by}), "
            f"plain {plain:.3f}")
        del w, up, probs, absmax
        torch.cuda.empty_cache()
    return out


def phase_ep(dev, counters, smi):
    """Path 13: the expert-parallel layout on four ranks sharing the
    card (gloo; NCCL takes one rank a device).  The parent has built
    every kernel; the ranks only load them.  (a) arctic-480b at published
    widths, 1 of 35 layers, all 128 experts on the (1, 4) mesh (32 a
    rank), plan-bound then float, through the paged prefill and
    EP_NEW greedy decode steps; (b) arctic cut to 8 experts trained
    under the search on the (2, 2) mesh; then the single-process
    references (after the ranks exit) and (c) ``launch.train --mesh 2,2``
    under ``torch.distributed.run``, its checkpoint restored under (1,
    1)."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    try:
        socket.gethostbyname(socket.gethostname())
    except OSError:
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    tmp = tempfile.mkdtemp(prefix="ep_")
    t0 = time.perf_counter()
    mp.spawn(_ep_rank, args=(4, tmp), nprocs=4, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    out = {"spawn_s": spawn_s}
    out["serve"] = _ep_check_serve(ranks, dev, counters, smi)
    _free(dev)
    out["train"] = _ep_check_train(ranks, dev, smi)
    _free(dev)
    out["cli"] = _ep_cli(dev, tmp)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _ep_check_serve(ranks, dev, counters, smi):
    """The serve half against the same layer in one process (every
    expert): logits bitwise and tokens identical on every rank, each
    rank's K1 / K2 / K3 launches the single run's."""
    from repro_torch.serve import engine

    cfg = _ep_cfg(EP_SERVE)
    torch.cuda.reset_peak_memory_stats(dev)
    params = _ep_draw(cfg, dev, range(cfg.n_experts))
    plan = engine.synthetic_plan(cfg, params, bits=None, seed=0)
    res = {}
    for label, tree in (("plan", engine.apply_plan(cfg, params, plan)),
                        ("float", params)):
        rows, toks, got, wall = _ep_serve_run(cfg, tree, dev, counters)
        del tree
        for r in ranks:
            s = r["serve"][label]
            same = len(s["rows"]) == len(rows) and all(
                torch.equal(a, b) for a, b in zip(s["rows"], rows))
            if not same or not np.array_equal(s["tokens"], toks):
                raise AssertionError(f"ep serve {label}: rank "
                                     f"{r['serve']['coords']} logits or "
                                     f"tokens differ from the single run")
            if s["launches"] != got:
                raise AssertionError(f"ep serve {label}: rank launches "
                                     f"{s['launches']}, single {got}")
        if label == "plan" and not got["quant_matmul"] or not all(
                got[k] for k in ("paged_attention", "paged_prefill")):
            raise AssertionError(f"ep serve {label}: launches {got}")
        coll = ranks[0]["serve"][label]["collectives"]
        n_coll = sum(len(v) for v in coll.values())
        coll_ms = sum(sum(v) for v in coll.values())
        res[label] = dict(launches=got, rank_wall_s=[
            r["serve"][label]["wall"] for r in ranks], single_wall_s=wall,
            collectives=n_coll, collective_ms=coll_ms)
        log(f"[ep] serve {label}: {cfg.name} 1 of 35 layers, "
            f"{cfg.n_experts} experts on mesh {EP_SERVE_MESH} (bank shards "
            f"{ranks[0]['serve']['bank_shape']} a rank), prompts {EP_LENS} x "
            f"{EP_NEW} greedy tokens through the paged prefill and decode "
            f"steps: every rank's {len(rows)} logits rows bitwise equal to "
            f"the single process's (all {cfg.n_experts} experts), tokens "
            f"identical; launches a rank = single {got}; wall s a rank "
            f"{[round(v, 2) for v in res[label]['rank_wall_s']]}, single "
            f"{wall:.2f}; rank 0's {n_coll} all-reduces {coll_ms:.1f} ms "
            f"wall (gloo, CUDA tensors)")
    del params, plan
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    res["single_peak_gib"] = peak
    res["rank_peak_gib"] = [r["serve"]["peak_gib"] for r in ranks]
    res["drawn_s"] = [r["serve"]["drawn_s"] for r in ranks]
    log(f"[ep] serve: peak memory a rank "
        f"{[round(v, 2) for v in res['rank_peak_gib']]} GiB, the single "
        f"process {peak:.2f} GiB; {ranks[0]['serve']['plan_groups']} plan "
        f"groups; {smi}")
    return res


def _ep_check_train(ranks, dev, smi):
    """The train half against one process at 8 experts run on each data
    shard alone (same ``t_loc``): step 0's shard losses bitwise, the
    clipped gradients per leaf within EP_TRAIN_GRAD, each bank's absmax
    the whole bank's bitwise, replicated leaves identical on all ranks
    after every step, every bank gamma moved, one plan on every rank,
    K4's launches counted."""
    from repro_torch.core import mps
    from repro_torch.data import synthetic
    from repro_torch.models import lm
    from repro_torch.optim import grad as gradlib

    cfg = _ep_cfg(EP_TRAIN)
    k = cfg.train_microbatches
    dp, tp = EP_TRAIN_MESH
    tr = {tuple(r["train"]["coords"].values()): r["train"] for r in ranks}
    # replicated leaves identical on every rank after every step; a bank
    # shard identical across the data ranks that share it
    for step in range(EP_STEPS):
        for key, d0 in tr[0, 0]["digests"][step].items():
            for (d, m), r in tr.items():
                v = r["digests"][step][key]
                ref = tr[0, m]["digests"][step][key] if d0[2] else d0
                if v != ref:
                    raise AssertionError(f"ep train: {key} differs on rank "
                                         f"{(d, m)} after step {step}")
    losses = tr[0, 0]["losses"]
    if any(r["losses"] != losses for r in tr.values()) or not all(
            np.isfinite(losses + tr[0, 0]["norms"])):
        raise AssertionError(f"ep train: losses {[r['losses'] for r in tr.values()]}")
    plans = [r["plan"] for r in tr.values()]
    if any(p != plans[0] for p in plans):
        raise AssertionError("ep train: the ranks extracted other plans")
    moved = [all(r["gammas_moved"].values()) and len(r["gammas_moved"]) == 3
             for r in tr.values()]
    if not all(moved):
        raise AssertionError(f"ep train: bank gammas moved {moved}")
    n_nodes = lm.mps_param_count(cfg) * lm.n_superblocks(cfg)
    need = {"mps_combine": n_nodes * k * 2 * EP_STEPS,
            "mps_combine_bwd": n_nodes * k * EP_STEPS}
    given = 3 * k * 2 * EP_STEPS
    for c, r in tr.items():
        got = r["launches"]
        if any(got[x] != v for x, v in need.items()) or any(
                v for x, v in got.items() if x not in need) or \
                r["given_launches"] != given:
            raise AssertionError(f"ep train: rank {c} launches {got}, given "
                                 f"{r['given_launches']}; need {need}, "
                                 f"given {given}")
    # the single-process reference, each data shard alone
    torch.cuda.reset_peak_memory_stats(dev)
    params = _ep_draw(cfg, dev, range(cfg.n_experts), mps_on=True)
    ctx = mps.SearchCtx(tau=1.0)
    banks = {n: params["blocks"]["l0"]["ffn"][n]["w"] for n in
             ("w_gate", "w_up", "w_down")}
    for (d, m), r in tr.items():
        for got, (n, w) in zip(r["absmax"], banks.items()):
            want = torch.amax(w[0].float().abs(), dim=(0, 1)).cpu()
            if not torch.equal(got.reshape(-1), want):
                raise AssertionError(f"ep train: rank {(d, m)}'s absmax of "
                                     f"{n} is not the whole bank's")

    def loss_of(p, b):
        return lm.loss_fn(cfg, p, b, ctx=ctx, lam=1e-9)

    batch = synthetic.lm_batch(cfg.vocab, EP_SEQ + 1, EP_BATCH, 0, device=dev)
    micro = {x: v.reshape((k, EP_BATCH // k) + v.shape[1:])
             for x, v in batch.items()}
    n = EP_BATCH // k // dp
    shard_grads, shard_loss = [], []
    for d in range(dp):
        g, loss = gradlib.accumulate_grads(
            loss_of, params, {x: v[:, d * n:(d + 1) * n]
                              for x, v in micro.items()})
        shard_grads.append(g)
        shard_loss.append(float(loss))
        for m in range(tp):
            if tr[d, m]["local_losses"][0] != shard_loss[d]:
                raise AssertionError(
                    f"ep train: data shard {d}'s step-0 loss "
                    f"{tr[d, m]['local_losses'][0]} on rank {(d, m)}, "
                    f"{shard_loss[d]} alone")
    from repro_torch.optim.optimizers import tree_map
    mean = tree_map(lambda *gs: (sum(x.float() for x in gs) / dp).to(
        gs[0].dtype), *shard_grads)
    clipped, ref_norm = gradlib.clip_by_global_norm(mean, 1.0)
    ref = dict(_leaves(clipped))
    gaps = {}
    e_loc = cfg.n_experts // tp
    for m in range(tp):
        for key, g in tr[0, m]["grads"].items():
            want = ref[key]
            if "/ffn/w_" in key and key.endswith("/w") and "shared" not in key:
                want = want[:, m * e_loc:(m + 1) * e_loc]
            elif m:
                continue
            gaps[key if not m else f"{key}@{m}"] = _rel(g, want)
    worst = max(gaps, key=gaps.get)
    med = float(np.median(list(gaps.values())))
    if gaps[worst] > EP_TRAIN_GRAD:
        raise AssertionError(f"ep train: gradient {worst} {gaps[worst]} "
                             f"(bound {EP_TRAIN_GRAD})")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del params, shard_grads, mean, clipped, ref
    r0 = tr[0, 0]
    prof = r0["profile"]
    coll = r0["collectives"]
    mx = [x for key, v in coll.items() if key.startswith("MAX") for x in v]
    n_coll = sum(len(v) for v in coll.values())
    log(f"[ep] train: {cfg.name} 1 of 35 layers, {cfg.n_experts} of 128 "
        f"experts on mesh {EP_TRAIN_MESH} ({e_loc} a model rank), bf16 "
        f"masters, {cfg.optimizer}, {k} micro-batches, remat {cfg.remat}, "
        f"{EP_STEPS} steps of {EP_BATCH} x {EP_SEQ} tokens: losses "
        f"{[round(v, 5) for v in losses]} (every rank), grad norms "
        f"{[round(v, 4) for v in r0['norms']]}; step 0's data-shard losses "
        f"{shard_loss} bitwise equal to one process run on each shard "
        f"alone; each bank's absmax on every rank bitwise the whole bank's; "
        f"step 0's clipped gradients of {len(gaps)} leaves within "
        f"{EP_TRAIN_GRAD} relative L2 of that process's (largest {worst} "
        f"{gaps[worst]:.3g}, median {med:.3g}; reference norm "
        f"{float(ref_norm):.4f}, ranks {r0['norms'][0]:.4f}); replicated "
        f"leaves identical on all 4 ranks after every step; all 3 bank "
        f"gammas moved; one plan on every rank; K4 launches a rank "
        f"{r0['launches']['mps_combine']} forward ({r0['given_launches']} "
        f"given the absmax) and {r0['launches']['mps_combine_bwd']} "
        f"backward")
    log(f"[ep] train: step ms a rank {[[round(x, 1) for x in r['ms']] for r in tr.values()]}; "
        f"rank 0: {n_coll} all-reduces over {EP_STEPS} steps "
        f"{sum(sum(v) for v in coll.values()):.1f} ms wall, the absmax MAX "
        f"({len(mx)} calls) median {float(np.median(mx)) if mx else 0:.3f} "
        f"ms; one profiled step on rank 0: wall {prof['wall_ms']:.1f} ms, "
        f"device {prof['device_ms']:.1f} ms by class "
        f"{ {x: round(v, 2) for x, v in prof['split'].items()} }, its "
        f"{prof['collectives']} all-reduces {prof['collective_ms']:.1f} ms "
        f"wall; peak a rank {[round(r['peak_gib'], 2) for r in tr.values()]} "
        f"GiB, the reference {peak:.2f} GiB; {smi}")
    return dict(launches=r0["launches"], given=r0["given_launches"],
                losses=losses, gap_max=gaps[worst], gap_worst=worst,
                gap_median=med, ms=[r["ms"] for r in tr.values()],
                profile=prof, max_allreduce_ms=(float(np.median(mx))
                                                if mx else None),
                collective_ms=sum(sum(v) for v in coll.values()),
                rank_peak_gib=[r["peak_gib"] for r in tr.values()],
                ref_peak_gib=peak)


def _ep_cli(dev, tmp):
    """``python -m torch.distributed.run --standalone --nproc-per-node 4
    -m repro_torch.launch.train --arch arctic-480b-smoke --search --mesh
    2,2 --dist-backend gloo --steps 3 --ckpt-dir <tmp>`` on cuda: exit 0,
    then its checkpoint (the gathered tree) restored under (1, 1): every
    leaf of the whole tree's shape, finite, step 2."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.optim import optimizers

    ckpt = os.path.join(tmp, "ckpt")
    root = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--arch", EP_CLI, "--search", "--mesh", "2,2", "--dist-backend",
           "gloo", "--steps", "3", "--ckpt-dir", ckpt]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    wall = time.perf_counter() - t0
    if run.returncode != 0 or "[train] done" not in run.stdout:
        raise AssertionError(f"ep cli: exit {run.returncode}\n"
                             f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    cfg = registry.get(EP_CLI)
    params = lm.init_params(cfg, device="cpu", mps_on=True)
    opt = optimizers.make_optimizer(cfg.optimizer, 3e-4)
    state, meta = CheckpointManager(ckpt).restore_latest(
        {"params": params, "opt": opt.init(params)})
    if state is None or meta["step"] != 2 or not all(
            torch.isfinite(t.float()).all() for _, t in _leaves(
                state["params"])):
        raise AssertionError(f"ep cli: checkpoint {meta}")
    bank = state["params"]["blocks"]["l0"]["ffn"]["w_gate"]["w"]
    if bank.shape[1] != cfg.n_experts:
        raise AssertionError(f"ep cli: restored bank {tuple(bank.shape)}")
    done = [ln for ln in run.stdout.splitlines() if "[train] done" in ln]
    log(f"[ep] cli: {' '.join(cmd[2:])} on {torch.cuda.get_device_name(dev)}"
        f" exit 0 in {wall:.1f} s ({done[-1].strip()}); its checkpoint "
        f"(step {meta['step']}, the gathered tree: banks of "
        f"{tuple(bank.shape)}) restored under (1, 1), finite")
    return dict(wall_s=wall, step=meta["step"])


# ---------------------------------------------------------------------------
# path 14: tensor parallelism, FSDP and the split sequence
# ---------------------------------------------------------------------------

TP_RUNS = {"llama": ("llama3.2-1b", {}, (2, 2)),
           "mamba": ("mamba2-780m", dict(n_layers=8), (1, 4))}  # of 48
TP_STEPS = 3
TP_DEVICE = "cuda"           # the ranks' device
# step 0 against the port's (1, 1) step on the card: the loss within the
# LM's rtol and each clipped gradient leaf within the LM bound (ROADMAP
# section 3)
TP_LOSS, TP_GRAD = 1e-4, 3e-2


def _tp_cfg(which):
    import dataclasses

    from repro_torch.configs import registry
    arch, cut, _ = TP_RUNS[which]
    return dataclasses.replace(registry.get(arch), **cut)


def _tp_rules(cfg):
    """The reference's rules for the train shape: the arch's
    RULE_OVERRIDES and ``shape_rules``, as ``launch.train`` installs
    them."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as steps_lib
    rules = dict(registry.RULE_OVERRIDES.get(cfg.name, {}))
    rules.update(steps_lib.shape_rules(ShapeConfig(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH)))
    return rules


class _Collectives:
    """Count and wall ms of every collective of ``distributed.sharding``
    on this rank, by kind (the card synchronised before and after
    each)."""

    KINDS = (("all_reduce", "_all_reduce"), ("all_gather", "_all_gather"),
             ("reduce_scatter", "_reduce_scatter"))

    def __init__(self):
        from repro_torch.distributed import sharding
        self.mod = sharding
        self.inner = {attr: getattr(sharding, attr) for _, attr in self.KINDS}
        self.got = {kind: [0, 0.0] for kind, _ in self.KINDS}
        for kind, attr in self.KINDS:
            setattr(sharding, attr, self._wrap(kind, self.inner[attr]))

    def _wrap(self, kind, fn):
        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.got[kind][0] += 1
            self.got[kind][1] += 1e3 * (time.perf_counter() - t0)
            return out
        return timed

    def take(self):
        got = {k: tuple(v) for k, v in self.got.items()}
        self.got = {kind: [0, 0.0] for kind, _ in self.KINDS}
        return got

    def close(self):
        for _, attr in self.KINDS:
            setattr(self.mod, attr, self.inner[attr])


class _SplitK:
    """In this block every bf16 product of ``nn.xla_numerics.matmul``
    (the layers' projections) is formed as two products over the halves
    of its K axis, each rounded to bf16, summed in float32 and rounded
    once: the rounding a row-parallel split over two ranks adds, with
    nothing split.  The (1, 1) step under it is path 14's second
    witness, the gradient gap a summation order alone makes."""

    def __enter__(self):
        from repro_torch.nn import xla_numerics
        self.mod, self.inner = xla_numerics, xla_numerics.matmul
        inner = self.inner

        def split(a, b):
            k = a.shape[-1]
            if a.dtype != torch.bfloat16 or k % 2:
                return inner(a, b)
            h = k // 2
            return (inner(a[..., :h], b[..., :h, :]).float()
                    + inner(a[..., h:], b[..., h:, :]).float()).to(a.dtype)

        xla_numerics.matmul = split
        return self

    def __exit__(self, *exc):
        self.mod.matmul = self.inner


def _tp_digests(tree, logical):
    """Per leaf: two int64 sums of its bit patterns and the mesh axes
    that split it (the ranks that share its coordinates on them hold the
    same shard)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps as steps_lib

    def dig(axes, t):
        d = _ep_digests({"x": t}, {"x": axes})["x"]
        split = sorted({a for ax in sharding.dim_axes(*axes) for a in ax})
        return d[:2] + (tuple(split),)

    return dict(_leaves(steps_lib.tree_map_axes(dig, logical, tree)))


def _tp_rank(rank, world, tmp):
    """One of the four ranks: path 14's two runs; its results to
    ``tmp/rank<r>.pt``."""
    import torch.distributed as dist
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=world)
    try:
        res = {}
        for which in TP_RUNS:
            res[which] = _tp_rank_train(which, rank, tmp)
            _free(torch.device(TP_DEVICE))
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tp_rank_train(which, rank, tmp):
    """TP_STEPS search steps of one run on this rank under the
    reference's rules: the whole seed-0 tree drawn on the card and cut
    into this rank's shard, float32 masters, adam at 3e-4, remat.
    Records the losses and norms, step 0's clipped gradient shards (to
    ``tmp``), the digests after every step, the gammas' moves, the
    launches (K4 given the absmax apart), the collectives by kind, step
    ms, the last step's device ms (profiled) and peak memory."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.optim import optimizers

    dev = torch.device(TP_DEVICE)
    cfg = _tp_cfg(which)
    mesh = meshlib.make_debug_mesh(*TP_RUNS[which][2], device=dev)
    torch.cuda.reset_peak_memory_stats()
    logical = lm.logical_axes(cfg, mps_on=True)
    counters = _counters()
    res = {"coords": mesh.coords, "losses": [], "norms": [], "digests": [],
           "ms": []}
    coll = _Collectives()
    try:
        with sharding.use_mesh(mesh, _tp_rules(cfg)):
            whole = lm.init_params(cfg, torch.Generator(
                device=dev).manual_seed(0), dev, mps_on=True)
            params = steps_lib.shard_tree(whole, logical)
            del whole
            _free(dev)
            res["shapes"] = {k: tuple(t.shape) for k, t in _leaves(params)}
            gamma0 = {k: t.clone() for k, t in _leaves(params)
                      if k.endswith("gamma")}
            opt = _KeepGrads(optimizers.make_optimizer(cfg.optimizer, 3e-4))
            state = {"params": params, "opt": opt.init(params)}
            del params
            step_fn = steps_lib.make_train_step(cfg, opt, search=True)
            torch.cuda.synchronize()
            coll.take()
            for fn in counters.values():
                fn.launches = 0
            counters["mps_combine"].given_launches = 0
            for i in range(TP_STEPS):
                batch = synthetic.lm_batch(cfg.vocab, TRAIN_SEQ + 1,
                                           TRAIN_BATCH, i, device=dev)
                last = i == TP_STEPS - 1
                torch.cuda.synchronize()
                with (profile(activities=[ProfilerActivity.CUDA]) if last
                      else contextlib.nullcontext()) as prof:
                    t1 = time.perf_counter()
                    p, o, loss = step_fn(state["params"], state["opt"],
                                         batch, i)
                    torch.cuda.synchronize()
                    res["ms"].append(1e3 * (time.perf_counter() - t1))
                if i == 0:
                    torch.save({k: g.cpu() for k, g in _leaves(o["grads"])},
                               os.path.join(tmp, f"{which}_grads{rank}.pt"))
                o["grads"] = None
                state = {"params": p, "opt": o}
                del p, o
                res["losses"].append(float(loss))
                res["norms"].append(float(step_fn.grad_norm))
                res["digests"].append(_tp_digests(state["params"], logical))
            res["launches"] = {k: fn.launches for k, fn in counters.items()}
            res["given_launches"] = counters["mps_combine"].given_launches
            res["collectives"] = coll.take()
    finally:
        coll.close()
    # the last step's device ms by class: gloo's host staging (memcpy),
    # K4, K5 and every other kernel
    split = {"memcpy": 0.0, "K4": 0.0, "K5": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = e.key
        cls = "memcpy" if "memcpy" in n.lower() else "K4" if "mps_" in n \
            else "K5" if "ssd_scan" in n else "other"
        split[cls] += e.self_device_time_total / 1e3
    res["device_split"] = split
    res["device_ms"] = sum(split.values())
    res["gammas_moved"] = all(not torch.equal(t, gamma0[k]) for k, t in
                              _leaves(state["params"]) if k in gamma0)
    res["n_gammas"] = len(gamma0)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def phase_tp(dev, counters, smi):
    """Path 14: the full placements of the training step on four ranks
    sharing the card (gloo; NCCL takes one rank a device).  The parent
    has built every kernel; the ranks only load them.  (a) llama3.2-1b
    at published widths and full depth on the (2, 2) mesh; (b)
    mamba2-780m at published widths, 8 of 48 layers, on the (1, 4) mesh;
    then, after the ranks exit, each run's (1, 1) step 0 on the card as
    the reference."""
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as mp

    try:
        socket.gethostbyname(socket.gethostname())
    except OSError:
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    tmp = tempfile.mkdtemp(prefix="tp_")
    t0 = time.perf_counter()
    mp.spawn(_tp_rank, args=(4, tmp), nprocs=4, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    out = {"spawn_s": spawn_s}
    try:
        for which in TP_RUNS:
            out[which] = _tp_check(which, [r[which] for r in ranks], tmp,
                                   dev, smi)
            _free(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[tp] both runs' ranks in {spawn_s:.1f} s (spawn to exit)")
    return out


def _tp_join(cfg, parts, logical, dev):
    """The whole gradient tree of one run from every rank's shard
    (``parts``: ``(rank coords, {leaf: tensor})`` pairs), each shard
    placed at its rank's block of every dimension the rules split, on
    the card."""
    import math
    import types

    from repro_torch.distributed import sharding
    shape = dict(zip(("data", "model"), next(
        v[2] for v in TP_RUNS.values() if v[0] == cfg.name)))
    grid = types.SimpleNamespace(axis_names=("data", "model"), shape=shape)
    axes_of = dict(_leaves(logical))
    out = {}
    with sharding.use_mesh(grid, _tp_rules(cfg)):
        for key in parts[0][1]:
            dims = sharding.dim_axes(*axes_of[key])
            whole = None
            for coords, tree in parts:
                part = tree[key]
                if whole is None:
                    whole = torch.empty(
                        [n * math.prod(shape[a] for a in ax)
                         for n, ax in zip(part.shape, dims)],
                        dtype=part.dtype, device=dev)
                idx = []
                for n, ax in zip(part.shape, dims):
                    c = 0
                    for a in ax:
                        c = c * shape[a] + coords[a]
                    idx.append(slice(c * n, (c + 1) * n))
                whole[tuple(idx)] = part.to(dev)
            out[key] = whole
    return out


def _tp_check(which, tr, tmp, dev, smi):
    """One run against its (1, 1) reference on the card: step 0's loss
    within TP_LOSS, its clipped gradients a leaf within TP_GRAD relative
    L2 (the ranks' shards joined); the ranks' losses equal, finite;
    every leaf the same on the ranks that share its shard after every
    step; every gamma moved; the launches."""
    from repro_torch.data import synthetic
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.optim import optimizers

    cfg = _tp_cfg(which)
    shape = TP_RUNS[which][2]
    tag = f"[tp] ({'ab'[list(TP_RUNS).index(which)]}) {cfg.name}"
    losses = tr[0]["losses"]
    if any(r["losses"] != losses for r in tr) or not all(
            np.isfinite(losses + tr[0]["norms"])):
        raise AssertionError(f"{tag}: losses {[r['losses'] for r in tr]}")
    for step in range(TP_STEPS):
        for key, (_, _, split) in tr[0]["digests"][step].items():
            for r in tr:
                peers = [q for q in tr if all(
                    q["coords"][a] == r["coords"][a] for a in split)]
                if any(q["digests"][step][key] != r["digests"][step][key]
                       for q in peers):
                    raise AssertionError(f"{tag}: {key} differs between "
                                         f"ranks that share its shard after "
                                         f"step {step}")
    if not all(r["gammas_moved"] and r["n_gammas"] for r in tr):
        raise AssertionError(f"{tag}: a gamma did not move")
    # the (1, 1) reference: the same tree and step-0 batch, one process
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, mps_on=True)
    opt = _KeepGrads(optimizers.make_optimizer(cfg.optimizer, 3e-4))
    step_fn = steps_lib.make_train_step(cfg, opt, search=True)
    batch = synthetic.lm_batch(cfg.vocab, TRAIN_SEQ + 1, TRAIN_BATCH, 0,
                               device=dev)
    state0 = opt.init(params)
    _, st, loss = step_fn(params, state0, batch, 0)
    ref_loss, ref_norm = float(loss), float(step_fn.grad_norm)
    ref = dict(_leaves(st["grads"]))
    del st
    ref_s = time.perf_counter() - t0
    ref_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # the second witness: the same step with only its products' sums
    # reordered (_SplitK), against the (1, 1) step
    with _SplitK():
        _, st, loss = step_fn(params, state0, batch, 0)
    wit_loss = abs(float(loss) / ref_loss - 1)
    wit = {k: _rel(g, ref[k]) for k, g in _leaves(st["grads"])}
    del params, st, opt, state0
    _free(dev)
    if not np.isfinite(wit_loss + sum(wit.values())):
        raise AssertionError(f"{tag}: the split-K witness is not finite")
    wit_worst = max(wit, key=wit.get)
    parts = [(r["coords"], torch.load(
        os.path.join(tmp, f"{which}_grads{rank}.pt"), weights_only=False))
        for rank, r in enumerate(tr)]
    joined = _tp_join(cfg, parts, lm.logical_axes(cfg, mps_on=True), dev)
    del parts
    gaps = {k: _rel(joined[k], ref[k]) for k in ref}
    del joined, ref
    worst = max(gaps, key=gaps.get)
    loss_gap = abs(losses[0] / ref_loss - 1)
    if loss_gap > TP_LOSS or gaps[worst] > TP_GRAD:
        raise AssertionError(f"{tag}: step 0 loss {losses[0]} vs (1, 1) "
                             f"{ref_loss} (gap {loss_gap:.3g}, bound "
                             f"{TP_LOSS}); gradient {worst} {gaps[worst]:.3g} "
                             f"(bound {TP_GRAD})")
    r0 = tr[0]
    coll = r0["collectives"]
    wall = [r["ms"][-1] for r in tr]
    busy = sum(r["device_ms"] for r in tr) / max(wall)
    kern_busy = sum(r["device_ms"] - r["device_split"]["memcpy"]
                    for r in tr) / max(wall)
    heads = (f"{cfg.ssm_heads // shape[1]} of {cfg.ssm_heads} SSM heads"
             if cfg.is_ssm else f"{cfg.h_eff // shape[1]} of {cfg.h_eff} "
             f"query heads, {cfg.d_ff // shape[1]} of {cfg.d_ff} FFN columns")
    log(f"{tag} at published widths, {cfg.n_layers} layers on mesh {shape} "
        f"({heads} a rank, the vocab's {lm.padded_vocab(cfg) // shape[1]} "
        f"rows a rank, the sequence's {TRAIN_SEQ // shape[1]} rows between "
        f"layers), float32 masters, {cfg.optimizer}, remat {cfg.remat}, "
        f"{TP_STEPS} search steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
        f"losses {[round(v, 5) for v in losses]} (every rank), grad norms "
        f"{[round(v, 4) for v in r0['norms']]}; step 0 against the (1, 1) "
        f"step on the card: loss {losses[0]:.6f} vs {ref_loss:.6f} (gap "
        f"{loss_gap:.3g}, bound {TP_LOSS}), norm {r0['norms'][0]:.5f} vs "
        f"{ref_norm:.5f}, clipped gradients of {len(gaps)} leaves within "
        f"{TP_GRAD} relative L2 (worst {worst} {gaps[worst]:.3g}, median "
        f"{float(np.median(list(gaps.values()))):.3g}); the witness, the "
        f"(1, 1) step with every bf16 product's K halves rounded apart, "
        f"against the (1, 1) step: loss gap {wit_loss:.3g}, worst "
        f"{wit_worst} {wit[wit_worst]:.3g}, median "
        f"{float(np.median(list(wit.values()))):.3g}; every leaf the same "
        f"on the ranks that share its shard after every step; all "
        f"{r0['n_gammas']} gammas moved")
    log(f"{tag}: launches a rank K4 {r0['launches']['mps_combine']} forward "
        f"({r0['given_launches']} given the absmax) and "
        f"{r0['launches']['mps_combine_bwd']} backward"
        + (f", K5 {r0['launches']['ssd_scan']} forward and "
           f"{r0['launches']['ssd_scan_bwd']} backward on "
           f"{cfg.ssm_heads // shape[1]} heads a rank"
           if cfg.is_ssm else "")
        + f"; step ms a rank {[[round(x, 1) for x in r['ms']] for r in tr]} "
        f"(the last profiled on every rank); rank 0's collectives over the "
        f"{TP_STEPS} steps (count, wall ms): "
        f"{ {k: (n, round(ms, 1)) for k, (n, ms) in coll.items()} }, "
        f"{sum(ms for _, ms in coll.values()):.1f} ms of "
        f"{sum(r0['ms']):.1f}; the last step's device ms a rank "
        f"{[round(r['device_ms'], 1) for r in tr]} (rank 0's by class "
        f"{ {k: round(v, 1) for k, v in r0['device_split'].items()} }), "
        f"card busy {100 * busy:.1f}% (their sum over the slowest rank's "
        f"wall; {100 * kern_busy:.1f}% without the staging copies); peak "
        f"a rank {[round(r['peak_gib'], 2) for r in tr]} GiB; the (1, 1) "
        f"reference {ref_s:.1f} s, peak {ref_peak:.2f} GiB; {smi}")
    nsb = lm.n_superblocks(cfg)
    nodes = lm.mps_param_count(cfg) * nsb
    remat = 2 if cfg.remat else 1
    need = {"mps_combine": nodes * remat * TP_STEPS,
            "mps_combine_bwd": nodes * TP_STEPS}
    # a projection's C_in split over a mesh axis of extent > 1: every
    # llama projection; mamba's out_proj alone (C_in ssm_inner on model)
    given = need["mps_combine"] if shape[0] > 1 else \
        nsb * remat * TP_STEPS
    if cfg.is_ssm:
        need.update(ssd_scan=nsb * remat * TP_STEPS,
                    ssd_scan_bwd=nsb * TP_STEPS)
    for r in tr:
        got = r["launches"]
        if any(got[x] != v for x, v in need.items()) or any(
                v for x, v in got.items() if x not in need) or \
                r["given_launches"] != given:
            raise AssertionError(f"{tag}: rank {r['coords']} launches {got}, "
                                 f"given {r['given_launches']}; need {need}, "
                                 f"given {given}")
    return dict(launches=r0["launches"], given=r0["given_launches"],
                losses=losses, ref_loss=ref_loss, loss_gap=loss_gap,
                gap_max=gaps[worst], gap_worst=worst,
                gap_median=float(np.median(list(gaps.values()))),
                witness_loss=wit_loss, witness_max=wit[wit_worst],
                witness_worst=wit_worst,
                witness_median=float(np.median(list(wit.values()))),
                ms=[r["ms"] for r in tr], collectives=coll, busy=busy,
                kernel_busy=kern_busy, device_split=r0["device_split"],
                rank_peak_gib=[r["peak_gib"] for r in tr],
                ref_peak_gib=ref_peak)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    log(f"[build] {len(reports)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, out in reports.items():
        # ptxas: each kernel's registers, then its stack and spills
        kernel = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "Used" in line or "spill" in line:
                log(f"[build] {src}: {kernel}: {line.split(':')[-1].strip()}")

    counters = _counters()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def path(name, fn, *args):
        """Run one phase; free what it left and print its peak memory."""
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t_path = time.perf_counter()
        out = fn(*args)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"[memory] {name}: peak {peak:.2f} GiB "
            f"(torch.cuda.max_memory_allocated); "
            f"{time.perf_counter() - t_path:.1f} s")
        _free(dev)
        return out

    rows = path("kernels", phase_kernels, dev, flush)
    moe_att = path("kernels (MoE attention shapes)", phase_moe_attention,
                   dev, flush)
    for k, v in moe_att.items():
        rows[k]["moe_groups"] = v
        rows[k]["max_abs_err"] = max([rows[k]["max_abs_err"]]
                                     + [r["max_abs_err"] for r in v])
    moe_k1 = path("kernels (MoE K1 shapes)", phase_moe_k1, dev)
    rows["quant_matmul"].update(moe_k1)
    rows["quant_matmul"]["max_abs_err"] = max(
        rows["quant_matmul"]["max_abs_err"], moe_k1["moe_max_abs_err"])
    vlm_att = path("kernels (VLM attention shapes)", phase_vlm_attention,
                   dev, flush)
    for k, v in vlm_att.items():
        rows[k]["vlm_group"] = v
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"],
                                     v["max_abs_err"])
    vlm_k1 = path("kernels (VLM K1 shapes)", phase_vlm_k1, dev, flush)
    rows["quant_matmul"].update(vlm_k1)
    rows["quant_matmul"]["max_abs_err"] = max(
        rows["quant_matmul"]["max_abs_err"], vlm_k1["vlm_max_abs_err"])
    jamba_k = path("kernels (jamba shapes)", phase_jamba_kernels, dev,
                   flush)
    rows["ssd_scan"]["jamba"] = jamba_k["k5"]
    rows["paged_prefill"]["jamba"] = jamba_k["k3"]
    rows["paged_prefill"]["max_abs_err"] = max(
        rows["paged_prefill"]["max_abs_err"], jamba_k["k3"]["max_abs_err"])
    rows["quant_matmul"].update(jamba_k["k1"])
    rows["quant_matmul"]["max_abs_err"] = max(
        rows["quant_matmul"]["max_abs_err"],
        jamba_k["k1"]["jamba_max_abs_err"])
    banks = path("kernels (K4 on expert banks)", phase_k4_banks, dev, flush)
    for key, d in (("mps_combine", "fwd"), ("mps_combine_bwd", "bwd")):
        rows[key]["banks"] = {
            label: dict(rows_x_k=f"{b['rows']}x{b['k']}",
                        device_ms=b[d], kernel=b[f"{d}_kernel"],
                        bound_ms=b[f"{d}_bound"], bound_by=b[f"{d}_by"],
                        copy_ms=b["copy"], copy_bound_ms=b["copy_bound"],
                        **({"plain_ms": b["fwd_plain"]} if d == "fwd"
                           else {}))
            for label, b in banks.items()}
    given = path("kernels (K4 given absmax)", phase_k4_given, dev, flush)
    rows["mps_combine"]["given_absmax"] = given
    rows["mps_combine"]["max_abs_err"] = max(
        [rows["mps_combine"]["max_abs_err"]]
        + [g["max_abs_err"] for g in given.values()])
    capped = path("kernels (softcap)", phase_softcap_attention, dev)
    for k, err in capped.items():
        rows[k]["softcap_max_abs_err"] = err
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], err)
    path("rng", phase_rng, dev, flush)
    runs = path("path 1 (llama serve)", phase_serve, dev, counters)
    mamba_runs = path("path 3 (mamba serve)", phase_mamba, dev, counters)
    search_launches, _ = path("path 2 (resnet18 search)", phase_search,
                              dev, counters, smi)
    trained = path("path 4 (llama train)", phase_train, dev, counters, smi,
                   rows["mps_combine"]["lm"])
    path("resume", phase_resume, dev)
    swept = path("path 5 (sweep)", phase_sweep, dev, counters, smi)
    moe = path("path 6 (MoE serve)", phase_moe, dev, counters, smi)
    mamba_trained = path("path 7 (mamba train)", phase_train_mamba, dev,
                         counters, smi)
    encdec = path("path 8 (seamless train)", phase_train_encdec, dev,
                  counters, smi)
    vlm = path("path 9 (qwen2-vl serve)", phase_vlm, dev, counters, smi)
    fleet = path("path 10 (fleet)", phase_fleet, dev, counters, smi)
    jamba = path("path 11 (jamba serve)", phase_jamba, dev, counters, smi)
    moe_trained = path("path 12 (arctic train)", phase_train_moe, dev,
                       counters, smi, banks)
    ep = path("path 13 (expert parallel)", phase_ep, dev, counters, smi)
    tp = path("path 14 (tensor parallel)", phase_tp, dev, counters, smi)

    meta = {
        "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                         "src/repro/kernels/quant_matmul/kernel.py:68"),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:158"),
        "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                          "src/repro/kernels/paged_attention/prefill.py:179"),
        "mps_combine": ("src/repro_torch/csrc/mps_combine.cu",
                        "src/repro/kernels/mps_combine/kernel.py:40"),
        # the reference's custom-VJP backward (jnp code, no TPU kernel)
        "mps_combine_bwd": ("src/repro_torch/csrc/mps_combine.cu",
                            "src/repro/kernels/mps_combine/ops.py:58"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:39"),
        # the gradient JAX takes of its inline scan (no TPU kernel)
        "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan.cu",
                         "src/repro/nn/blocks.py:576-598"),
    }
    kernels = []
    for k, r in rows.items():
        src, rep = meta[k]
        row = {"name": k, "route": "cuda", "source": src, "replaces": rep}
        if k in ("mps_combine", "mps_combine_bwd"):    # paths 2, 4, 5, 7
            row.update(launches=search_launches[k], path="search",
                       launches_train=trained["launches"][k],
                       launches_sweep=swept["launches"][k],
                       launches_train_mamba=mamba_trained["launches"][k])
        elif k == "ssd_scan":       # path 3: mamba serving; path 7
            row.update(launches=mamba_runs["plan"][k],
                       launches_float=mamba_runs["float"][k],
                       path="serve_mamba",
                       launches_train_mamba=mamba_trained["launches"][k],
                       launches_train_mamba_plan=mamba_trained["served"][k])
        elif k == "ssd_scan_bwd":   # path 7: mamba training
            row.update(launches=mamba_trained["launches"][k],
                       path="train_mamba")
            r["max_abs_err"] = max(r["max_abs_err"], mamba_trained["k5_err"])
        else:                       # path 1: serving
            row.update(launches=runs["plan"][k],
                       launches_float=runs["float"][k], path="serve")
            if k == "paged_prefill":
                row.update(logits_vs_dense=runs["paged_vs_dense"])
            # path 10: the fleet's three runs, in all and by replica
            row.update(launches_fleet=fleet["launches"][k],
                       launches_fleet_by_tier={
                           t: g[k] for t, g in fleet["by_tier"].items()})
            row.update(launches_train_plan=trained["served"][k],
                        launches_sweep_plan=swept["served"][k])
            for arch, r_moe in moe.items():
                row[f"launches_{arch}"] = r_moe["plan"]["launches"][k]
                if "float" in r_moe:
                    row[f"launches_{arch}_float"] = \
                        r_moe["float"]["launches"][k]
            if k == "quant_matmul":
                row.update(launches_mamba=mamba_runs["plan"][k],
                           launches_train_mamba_plan=mamba_trained[
                               "served"][k])
                r["max_abs_err"] = max(r["max_abs_err"],
                                       mamba_runs["k1_err"],
                                       encdec["k1_max_abs_err"])
                row.update(encdec_cases=encdec["k1_cases"])
        # paths 8 and 9: enc-dec training and its plan's decode; VLM
        # serving plan-bound and float
        row.update(launches_train_encdec=encdec["launches"][k],
                   launches_encdec_plan=encdec["served"][k],
                   launches_vlm=vlm["plan"]["launches"][k],
                   launches_vlm_float=vlm["float"]["launches"][k])
        # path 11: jamba serving, plan-bound and float
        row.update(launches_jamba=jamba["plan"]["launches"][k],
                   launches_jamba_float=jamba["float"]["launches"][k])
        # path 12: arctic trained under the search, its plan served
        # (plan-bound and float), and the jamba smoke step
        row.update(launches_train_moe=moe_trained["launches"][k],
                   launches_train_moe_plan=moe_trained["served"][k],
                   launches_train_moe_float=moe_trained["served_float"][k],
                   launches_jamba_train_step=moe_trained["jamba"][
                       "launches"][k])
        # path 13: each rank's launches (every rank counts the same) in
        # the expert-parallel serve (plan-bound, float) and train halves
        row.update(launches_ep_serve_a_rank=ep["serve"]["plan"][
                       "launches"][k],
                   launches_ep_serve_float_a_rank=ep["serve"]["float"][
                       "launches"][k],
                   launches_ep_train_a_rank=ep["train"]["launches"][k])
        # path 14: each rank's launches (every rank counts the same) in
        # the tensor-parallel llama (2, 2) and mamba (1, 4) runs
        for which in TP_RUNS:
            row[f"launches_tp_{which}_a_rank"] = tp[which]["launches"][k]
        if k == "mps_combine":
            row["launches_tp_given_absmax_a_rank"] = {
                which: tp[which]["given"] for which in TP_RUNS}
            row["launches_ep_train_given_absmax_a_rank"] = ep["train"][
                "given"]
            row["ep_max_allreduce_ms"] = ep["train"]["max_allreduce_ms"]
        if k == "quant_matmul":
            r["max_abs_err"] = max(r["max_abs_err"], jamba["k1_err"])
        row.update({
            "max_abs_err": r["max_abs_err"], "max_abs_diff": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
        row.update({k2: v for k2, v in r.items() if k2 not in row})
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
