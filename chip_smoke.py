#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --parent DIR    # and the A/B of step 3b

Needs one NVIDIA Hopper card (compute capability 9.0) and ``nvcc``.  It:

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` for ``sm_90a``, one
   ``nvcc`` per source, all at once;
2. holds each kernel against its plain PyTorch version on the card, at the
   reference package's kernel tolerances (attention 2e-2 in bf16, 2e-5 in
   float32; the selective scan 1e-5; the MoE grouped matmul 5e-2 in bf16,
   1e-4 in float32), including the main paths' shapes, flash_decode's
   masks (an all-masked row, one valid slot in the last tile, a ring),
   both attention kernels at zamba2-7b's head width 112 (H = Kv = 32) in
   bf16 and float32, at h2o-danube3-4b's 120 (H = 32, Kv = 8) and
   paligemma-3b's 256 (H = 8, Kv = 1) in both dtypes under the causal,
   sliding-window and prefix-LM masks (with paligemma's 256-patch prefix
   before 1024 text tokens and danube's 4,600-token prompt under its
   4,096-token window), flash_decode at both widths under the tile masks
   and danube's full 4,096-slot ring, whisper-medium's attention (H = Kv = 16, D = 64) in
   both dtypes: flash_attention bidirectional over 1500 encoder frames,
   cross with 1, 4, 63, 65 and 224 queries against 1500 keys, causal at
   224, and flash_decode over a 1500-slot cross cache all valid and 600
   valid, and the grouped matmul with the occupancy ``rows``
   (0, 8 and 128 of 128 experts; nonzero x past the rows) and at
   phi3.5-moe-42b's experts (E = 16, D = 4096, F = 6400: prefill, wo,
   decode, rows of 2 occupied experts);
   flash_decode's log-sum-exp (``return_lse``: the output in fp32 and each
   row's log-sum-exp, a slot shard's partial) against the plain version's
   in both dtypes (1e-5 relative in float32, 2e-3 absolute in bf16), rows
   with no valid slot and with one among them; and a slot split on one
   card: llama3.2-1b's decode shape (H = 32, Kv = 8, D = 64) over a
   32,768-slot cache cut into 4 slot views, the kernel launched on each
   with its log-sum-exp and the partials merged
   (``merge_decode_partials``), against one whole-cache launch and the
   plain version (2e-2 bf16, 2e-5 float32) under three masks: 600 valid
   slots (three views empty), every slot valid, valid slots in every view;
   and paligemma-3b's head width 256 (``check_head_width_256``, the cases
   of ``tests/test_torch_cuda.py``): the warp-specialised prefill under
   causal, prefix-LM (256 patches before 1024 tokens), window, Sq != Skv,
   ragged, B > 1 and 1:1 cases (bf16, 2e-2), the unpadded decode in both
   dtypes with its log-sum-exp (5.4e-7 of max(|lse|, 1) in float32) and
   the same slot split at D = 256; the published attention shapes of
   public models the fleets do not cover (``PUBLIC_SHAPES``: phi-2,
   Phi-3-mini, SigLIP-so400m, Nemotron-4-340B, Llama-3.1-405B, StarCoder,
   falcon-7b: head widths 72-192, query groups 1-71) in prefill and decode,
   both dtypes; a width sweep (``check_width_sweep``): every head width
   from 1 to 264 and 272, 288, 320, 384, 512, 576 and 1,024 in both
   dtypes, a causal prefill (B 1, H 8, Kv 2, S 256) and a decode of 600
   valid slots of 2,048 beside a row with none, a ``width sweep`` line
   each naming the rows' alignment and the kernel form; and the served
   widths on views sliced out of a fused buffer one element in
   (``check_unaligned_views``: 2-byte aligned rows in bf16, 4-byte in
   float32), an ``unaligned view`` line each;
2b. llama3.2-1b's config with head_dim 100 and 288 at 2 layers, otherwise
   full width (``check_head_width_model``): prefill logits of the kernel
   route against the plain route and 16 captured replays against eager
   steps;
3. times each kernel at its main path's shapes (device time from
   ``torch.profiler``, with its clock held against CUDA events): kernel,
   plain version, one PyTorch library call where one computes the same
   function (a yardstick the port never calls), and the card's bound;
   flash_attention and flash_decode also at qwen3-moe-30b's shape (H=32,
   Kv=4, D=128), zamba2-7b's (H=32, Kv=32, D=112), whisper-medium's
   (H=Kv=16, D=64: the encoder's bidirectional S=1500, the cross cache's
   1500 valid slots), h2o-danube3-4b's (H=32, Kv=8, D=120) and
   paligemma-3b's (H=8, Kv=1, D=256; flash_attention also at its own
   prefill, 256 patches under the prefix-LM mask before 1024 text tokens,
   SDPA given the mask), and at ``PUBLIC_SHAPES`` (prefill S = 1,024
   causal, SigLIP's 729 patches bidirectional; decode 600 of 2,048 slots,
   the line naming the kv head's group tiles), at ``WIDE_PUBLIC_SHAPES``
   (OpenLLaMA-3B's head width 100, a width of 512 at G = 4, DeepSeek-V3's
   absorbed-MLA decode at 576), every attention line naming the backend
   SDPA picked, each line with the card's
   name and power limit, and moe_gmm with the
   rows of a real routing of one token
   (decode) and of 975 (the S=975 prefill), beside its time with every
   expert read; the extra shapes each on a log line;
3b. with ``--parent DIR`` (a checkout of an earlier commit, of which only
   ``src/repro_torch/kernels/csrc`` is read), its flash_attention.cu and
   flash_decode.cu against this tree's (``phase_parent_ab``): both
   compiled side by side and timed, the served instantiations' ptxas
   register counts equal, then at the served models' attention shapes
   bf16 and float32 outputs equal to the bit and bf16 times in turns, a
   ``parent A/B`` line each;
4. runs the SkyServe scenario engine over the reference benchmark's 96-cell
   matrix (``benchmarks/jax_engine.py``: SpotHedge and even_spread on spot
   trace aws-1, 48 seeds, llama3.2-1b on g5.48xlarge, Poisson at 1
   request/s for one hour): the port builds the cells from the recorded
   spec alone (``repro_torch.serving.torchengine.recorded.spec_matrix``),
   runs their control plane (phase A: its own cluster simulator, policies
   and autoscaler) on the host, times it and holds every cell's plane
   field for field against the reference's recorded plane; phase B runs
   through ``run_cells`` on the card in one ``scenario_scan`` launch (the
   launch counters zeroed just before, read just after), every cell must
   equal the reference oracle's recorded
   result (counts exact, costs to 1e-9, availability to 1e-12, latency
   percentiles and mean to 1e-6, no lane overflowed), the kernel is held
   against its plain version on the CPU on all 96 lanes (counts, statuses
   and slots equal, latencies and span timelines within the reference's
   1e-6, expected equal), the paper's metrics are printed per policy and
   the kernel is timed (device time, CUDA events; beside it the plain
   version's host time, phase B's wall time and cells/s, and the kernel
   on the first 8 lanes); the port's oracle (``VectorizedServingEngine``)
   runs the quick matrix's 8 cells on the host, timed, each equal to the
   recorded result; and one ``run_cells`` call on the card at a queue pool
   of one cell a slot overflows lanes (none is a failure), each rerun on
   the oracle and equal to the oracle's result field for field;
5. profiles the kernels of every arch (``--models all``: the ten of
   ``ARCH_IDS``) on the ``h100``
   instance (``repro_torch.profiles``, the kernels timed with CUDA events),
   writes ``chiprun_out/profiles/cuda-compiled.json``, reloads it with the
   port's schema and prints each row; ``mfu_prefill`` and ``mbu_decode``
   must lie in (0, 1.05];
5b. drives SkyServe's front door (``phase_service``), each part with the
   launch counts zeroed just before and read just after, phase B on the
   card, and no lane overflowed into an oracle rerun in any part:
   ``Service`` runs the golden specs of ``tests/test_golden.py``
   (SpotHedge, even_spread, on-demand only) under ``sim.engine: jax``,
   each equal to the golden constants (counts exact, abs 1e-6) in one
   ``scenario_scan`` launch; the README's quickstart service (command-r-35b,
   Arena at 2/s, 4 h; no ``sim.engine``, so ``Service``'s default) on the
   card and on the host engine, equal (counts exact, cost 1e-9,
   availability 1e-12, latencies 1e-6); a llama3.2-1b
   service on the ``h100`` instance priced by the ``ProfiledLatencyModel``
   of step 5's own row (no roofline fallback warning, the row's shares and
   provenance checked), and the same tape priced by the roofline, each
   equal to the host engine with no oracle rerun, their metrics printed
   side by side; ``ScenarioSuite.run`` over ``examples/sweep.yaml``'s grid
   with a workloads axis (12 cells, one launch per shape group), every cell
   equal to the host engine's; and the serve CLI's ``--status`` and
   ``--sweep`` in-process, exit 0.  Its ``scenario_scan`` launches are
   printed by part, apart from the matrix's count on the kernels line;
5c. drives token-level serving, KV migration and the legacy engine
   (``phase_token``), each part counted as in 5b: (a) the reference's token
   matrix uncut (``benchmarks/token_engine.py``: command-r-35b on
   g5.48xlarge, aws-1 and aws-3 at 2 h, Arena 2/s seed 11, 4 replicas,
   spothedge and ondemand_only x request and token) through
   ``ScenarioSuite.run``: the 4 request lanes in ``scenario_scan`` launches
   on the card, one a shape group, the 4 token cells on the host engine,
   no oracle rerun; then the same cells through ``run_cells`` (each
   launch's cells printed) and on the host engine, every cell equal
   (counts exact, cost 1e-9, availability 1e-12, latencies and the TTFT /
   TPOT arrays 1e-6, goodput and SLO attainment 1e-9) and its metrics
   printed; (b) the migration matrix uncut (``benchmarks/migration.py``:
   spothedge and risk_spothedge with its Markov forecast, aws-1 and aws-3
   at 2 h, Arena 4/s seed 11, int8, drain_threshold_s 2.0, off and on: 8
   token cells), each cell equal to the host and the legacy engine's, each
   run in 4 worker processes, the migration counters and the off -> on
   deltas printed; (c)
   a llama3.2-1b token service on the ``h100`` instance priced by step 5's
   own profile row (no roofline fallback warning) and by the roofline,
   each equal to the host engine, their TTFT / TPOT / goodput and the
   ``TokenEngineConfig`` each resolves to side by side; (e) the serve CLI's
   ``--replica-model token --status`` and ``--engine legacy
   --replica-model token --status`` in-process, exit 0.  Part (d) runs in
   step 6: the K and V bytes a cached token takes in the llama3.2-1b and
   qwen3-moe-30b caches on the card must equal
   ``TokenEngineConfig.kv_bytes_per_token`` (32,768 and 98,304 B);
5d. drives SkyServe's observability (``phase_obs``), each part counted as
   in 5b: (a) the reference's obs fixture (``tests/test_obs.py``: the mini
   trace over 3 zones, spothedge x 3 on g5.48xlarge, Poisson 0.8/s for 2 h,
   timeout 60 s, concurrency 2, detail ``full``, every request sampled)
   through the legacy and vector engines on the host, whose event and span
   logs must be byte-identical and whose event counts must be the
   reference's golden counts, and through ``run_cells`` on the card in one
   ``scenario_scan`` launch: its counts the golden ones without window and
   burn events, its control plane the vector engine's byte for byte, its
   spans rebuilt from the kernel's span timelines equal to the vector
   engine's after the reference's filter (one attempt, served, ``ok`` or
   ``timeout``) and to the plain version's, every span tiling its
   lifetime, its metrics the host's; (b) the same cell at detail ``off``,
   ``decisions`` and ``full``: metrics identical, one launch each,
   ``trace_on`` false only at ``off``; ``scenario_scan``'s time with
   ``trace_on`` off and on, phase B's wall and the span rebuild's host time
   printed; (c) the README's quickstart with its observability example
   through ``Service`` on the card: the event log, span log and trace
   written under ``chiprun_out/obs/`` and read back, and ``python -m
   repro_torch.obs`` ``summarize``, ``attribute``, ``request``, ``slo``,
   ``trace`` and ``diff`` (of a log with itself) in-process, exit 0; (d)
   the 96-cell matrix of step 4 with its spans rebuilt (count and host
   time printed), and the quick matrix's 8 cells, whose card spans must
   equal the port oracle's after the same filter;
5e. drives the forecasters, risk-aware SpotHedge, the Omniscient oracle and
   the suite's worker fan-out (``phase_forecast``), each part counted as in
   5b: (a) the paper's Listing 1 (``examples/service.yaml``, copied as a
   dict, its artifacts under ``chiprun_out/obs/``) uncut through
   ``Service``: a token cell, so 0 launches, equal to the host engine with
   its three artifacts byte-equal; then its request-model variant (no
   migration) in one ``scenario_scan`` launch, equal to the host engine;
   (b) the README's quickstart with a Markov forecast and a sweep of
   spothedge / risk_spothedge / omniscient / even_spread x persistence /
   ewma / markov (6 cells: risk_spothedge once per forecaster) through
   ``ScenarioSuite.run`` on the card, one launch a shape group, and on the
   host engine in 4 worker processes, every cell equal, each printed, with
   the Omniscient solve's status (Optimal, or the phase fails), time,
   objective and bucket count; (c) the backtest CLI in-process on aws-1,
   aws-2, aws-3 and gcp-1 x persistence / ewma / markov into
   ``chiprun_out/forecast/``, each report equal to the committed
   ``artifacts/forecast/`` one, and ``python -m repro_torch.cluster.traces
   --json`` in-process, exit 0; (d) ``benchmarks/forecast_eval.py``'s
   forecast-risk suite (8 cells, no workload, up to 7 days) on the host
   engine at 4 workers and serially, both equal to
   ``artifacts/bench/scenario_forecast_risk.json`` at its 6 digits, both
   walls printed; (f) the serve CLI in-process on Listing 1 (``--status``)
   and on (b)'s sweep (``--sweep --engine vector --workers 4``), exit 0.
   Part (e), the migration matrix uncut, is 5c (b).  The phase's launches
   are added to ``scenario_scan``'s count on the kernels line;
5f. trains on the card (``phase_train``), the reference's train path,
   which reaches none of the five kernels: (a) full-width llama3.2-1b
   (seeded bf16 weights, fp32 AdamW moments) through ``build_train_step``
   (``impl="blockwise"``, remat, 2 microbatches) on ``make_batch``
   batches of B = 4, S = 128, 5 steps and then 3 with int8 error-feedback
   compression: every loss and grad norm finite, every weight matrix
   changed, the five launch counters 0 across the phase; each step's loss
   (the first beside ln V), grad norm, wall, tokens/s and peak memory
   printed; (b) llama3.2-1b at full width with 2 layers in float32, one
   train step on the card and one on the CPU from the same weights and
   batch (B = 2, S = 64): loss and every parameter within 1e-5 relative;
   (c) the train CLI in-process, 6 smoke steps with a checkpoint every 3
   into ``chiprun_out/train`` and then 9, which must resume from step 6;
   (d) the ~100M trainer (``python -m repro_torch.launch.train_100m``, the
   reference's ``examples/train_100m.py``: llama-100m at full width, 30
   steps of B = 4, S = 128, a checkpoint every 10 under
   ``artifacts/chip_smoke_train_100m/``, removed after): once
   uninterrupted (its ``main`` in-process), in a fresh directory as a
   subprocess (started at nice 19 before (a), beside (a)–(c)) killed with
   SIGKILL once it has printed its step-10 checkpoint, and then again
   in-process, which must resume from step 10 (or 20) and finish; its
   lines, the parameter count, s/step, peak memory and both final losses
   with their difference (within 1e-3 of the loss) printed;
5g. the mesh on the card (``phase_mesh``): a 1x1 mesh over an NCCL process
   group of one rank; full-width llama3.2-1b's parameters placed under the
   ``tp`` rules and its cache under ``decode_cp`` (DTensors), every local
   shard equal to its source to the bit with no replication fallback
   counted, then re-meshed (``plan_remesh`` onto 1 survivor, ``reshard``)
   and equal again; the NCCL version printed;
5h. the dry run (``DryRun``, started after step 1 at nice 19 beside the
   card phases and collected after step 6): ``python -m
   repro_torch.launch.dryrun`` in subprocesses for the five served
   models x the four shapes x both
   H100 node meshes ((2, 4) and (2, 2, 4), each over a ``"fake"`` process
   group, on ``meta`` tensors: host work); every cell OK or the
   reference's own skip, a line per cell with one device's argument and
   temporary GiB, fits in 80 GiB, FLOPs, link bytes, the roofline bound
   and its bottleneck (counted, not measured); a decode cell of a model
   with attention (its cache sharded over its slots, attended where it
   lies and merged by log-sum-exp) must not be bound by its collectives,
   and a line per decode cell gives its link bytes and bottleneck;
5i. the port's static checker (``Analysis``, started at the beginning of
   the train phase at nice 19, collected at its end): ``python -m
   repro_torch.analysis --out -`` in a subprocess must exit 0 and end with
   ``analysis: OK``; its findings and summary line (files scanned,
   findings, exempted) are printed;
6. serves five full-width models, one after the other, with seeded random
   bf16 weights, through the same helpers: llama3.2-1b (flash_attention in
   prefill, flash_decode in decode), falcon-mamba-7b (64 Mamba-1 layers,
   the selective scan once per 256-token chunk of every prefill, no kernel
   in decode), qwen3-moe-30b (48 layers of GQA attention and 128-expert
   top-8 MoE: flash_attention, flash_decode, and three moe_gmm launches per
   layer in prefill and decode) and zamba2-7b (68 Mamba-2 layers, whose SSD
   has no kernel, and 13 applications of one shared attention block at
   head width 112: flash_attention 13 times a prefill, flash_decode 13
   times a decode step) and whisper-medium (24 encoder and 24 decoder
   layers: flash_attention 72 times a prefill, 24 over the 1500 encoder
   frames, 24 causal over the prompt and 24 cross; flash_decode 48 times
   a decode step, 24 over the self cache and 24 over the cross cache).
   Each fleet has two replicas and eight requests of 128-1024 prompt
   tokens into 2048 cache slots (whisper-medium: 4-224 prompt tokens into
   448 slots, each request with 1500 seeded audio frames, carried on its
   retry), least-loaded dispatch, replica 0
   preempted at step 4 and its requests retried on the survivor.  Each
   replica captures one serve step per cache slot as a CUDA graph when it
   is built, and every decode step replays one (prefill stays eager).  The
   launch counters are zeroed just before each fleet run and read just
   after (a replay adds its graph's launches, counted at capture): every
   request must complete with 33 tokens and every kernel must have
   launched exactly as often as the model's path says.  One request of the
   longest prompt then decodes 32 steps eagerly and 32 by replay from the
   same prefill: the tokens must be equal (the largest logit difference is
   printed) and a replay must hold one decode step's launches.  A prefill
   step of S = 1024 tokens (whisper-medium: 224, with 1500 frames) is
   captured (``build_prefill_step``) and one replay held against one
   eager prefill of the same tokens into a fresh cache: logits and every
   cache tensor equal to the bit, or else within the reference's bf16
   tolerance with the largest differences printed; the replay must add
   exactly one prefill's launches; eager and replay walls printed.  For
   the MoE model one full-width MoE layer is held kernel against plain.  Prefill
   logits of the kernel path are compared with the plain path (for MoE,
   with a count of the routing choices on which the two paths differ), and
   one prefill plus eight decode steps, eager and replayed, are profiled.
   (6b) Then, through the same helpers, the four dense archs at full width:
   paligemma-3b (18 layers, head width 256, one KV head; each request
   carries 256 seeded image patches, prefilled under the prefix-LM mask and
   carried on its retry), h2o-danube3-4b (24 layers, head width 120, a
   4,096-token window; one further request of 4,600 tokens prefilled into
   a 4,096-slot ring, so the prefill writes it wrapped, then 32 eager steps
   and 32 replays, which keep wrapping it, tokens equal), qwen2.5-3b (36
   layers, QKV bias, G = 8) and command-r-35b (40 layers of width 8192,
   the parallel attention + MLP block, 56.4 GiB of weights), each with its
   parameter count, fleet, launch counts, replay, prefill step, accounting
   and logits as above, and the K and V bytes of a cached token against
   the token model's.
   (6c) The dry run's accounting against these steps: the serve and
   prefill steps built by ``build_mesh_serve_step`` /
   ``build_mesh_prefill_step`` at the fleet's shapes (one device,
   ``impl="kernel"``, meta tensors) must predict the card's parameter and
   cache bytes exactly and the kernel calls of one replay of the captured
   serve step and of the captured prefill step; each roofline bound is
   printed beside the measured replay;
7. prints a ``kernels`` JSON line (all five kernels), the card line and,
   last, the device JSON line.

Any failure exits non-zero; without CUDA it exits 1 before printing results.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import re
import sys
import time
import types
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, float32 peak
# outside the tensor cores, and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = 1e-5           # the reference's scan tolerance (test_kernels.py)

# llama3.2-1b attention at the main path's shapes
MAIN_H, MAIN_KV, MAIN_D = 32, 8, 64
PREFILL_S = 1024
DECODE_S = 2048
# qwen3-moe-30b attention
QWEN_H, QWEN_KV, QWEN_D = 32, 4, 128
# zamba2-7b's shared attention block
ZAMBA_H, ZAMBA_KV, ZAMBA_D = 32, 32, 112
# whisper-medium's attention, and its 1500 encoder frames (30 s of audio)
WHISPER_H, WHISPER_KV, WHISPER_D = 16, 16, 64
ENC_S = 1500
# h2o-danube3-4b's attention (head width 120) and its 4,096-token window;
# paligemma-3b's (head width 256, one kv head) and its 256-patch image prefix
DANUBE_H, DANUBE_KV, DANUBE_D, DANUBE_WINDOW = 32, 8, 120, 4096
PALI_H, PALI_KV, PALI_D, PALI_PREFIX = 8, 1, 256, 256
# danube's ring request: a prompt longer than its window, into a cache of
# one window of slots
RING_PROMPT = 4600
# the published attention shapes of public models the served fleets do not
# cover, (model, H, Kv, D, prefill S, causal): head widths 80, 96, 72 and
# 192 and query groups 12, 16, 48 and 71; SigLIP's encoder attends its 729
# patches (27 x 27 at 384 px) bidirectionally, off the 64-row tiles
PUBLIC_SHAPES = [
    ("phi-2", 32, 32, 80, PREFILL_S, True),
    ("Phi-3-mini", 32, 32, 96, PREFILL_S, True),
    ("SigLIP-so400m/14-384", 16, 16, 72, 729, False),
    ("Nemotron-4-340B", 96, 8, 192, PREFILL_S, True),
    ("Llama-3.1-405B", 128, 8, 128, PREFILL_S, True),
    ("StarCoder-15.5B", 48, 1, 128, PREFILL_S, True),
    ("falcon-7b", 71, 1, 64, PREFILL_S, True),
]
# the width sweep: every head width from 1 to 264 (odd ones and those off a
# multiple of 8 copy at any alignment) and widths past it up to 1,024 (the
# sliced kernels), a causal prefill (B, H, Kv, S) and a decode of 600 valid
# slots of 2,048 beside a row with none (B, H, Kv, S, mask), in both dtypes
SWEEP_WIDTHS = (*range(1, 265), 272, 288, 320, 384, 512, 576, 1024)
SWEEP_FA = (1, 8, 2, 256)
SWEEP_FD = (2, 8, 2, 2048, "empty beside 600")
# the served widths on views sliced out of one fused projection buffer at
# an odd element offset (rows 2-byte aligned), (name, H, Kv, D)
UNALIGNED_SHAPES = [
    ("llama3.2-1b", MAIN_H, MAIN_KV, MAIN_D),
    ("zamba2-7b", ZAMBA_H, ZAMBA_KV, ZAMBA_D),
    ("h2o-danube3-4b", DANUBE_H, DANUBE_KV, DANUBE_D),
    ("qwen3-moe-30b", QWEN_H, QWEN_KV, QWEN_D),
    ("paligemma-3b", PALI_H, PALI_KV, PALI_D),
]
# public attention shapes past the served widths' rules, timed in step 3:
# (name, H, Kv, D, prefill S or 0 for decode only).  OpenLLaMA-3B's 3,200
# hidden over 32 heads (D = 100: 200-byte rows, 8-byte aligned); a head
# width of 512 at G = 4; DeepSeek-V3's absorbed-MLA decode, 128 heads on
# one latent kv head of score width 576 (a shape only: v is given k's width)
WIDE_PUBLIC_SHAPES = [
    ("OpenLLaMA-3B", 32, 32, 100, PREFILL_S),
    ("D=512 G=4", 32, 8, 512, PREFILL_S),
    ("DeepSeek-V3 absorbed MLA", 128, 1, 576, 0),
]
# llama3.2-1b's config with head_dim set so, at 2 layers (step 2b)
HEAD_WIDTH_MODELS = (100, 288)

FA_CASES = [
    # (dtype, B, H, Kv, S, D, causal, window, prefix)
    (torch.bfloat16, 1, 32, 8, 1024, 64, True, None, 0),    # main path
    (torch.bfloat16, 1, 32, 8, 1000, 64, True, None, 0),    # ragged edge
    (torch.bfloat16, 1, 32, 8, 512, 64, True, 96, 0),       # sliding window
    (torch.bfloat16, 1, 32, 8, 512, 64, True, None, 32),    # prefix-LM
    (torch.bfloat16, 1, 8, 1, 512, 128, True, None, 0),     # D=128, MQA
    (torch.bfloat16, 2, 4, 4, 192, 64, False, None, 0),     # bidirectional
    (torch.float32, 1, 32, 8, 256, 64, True, None, 0),
    (torch.float32, 2, 8, 2, 200, 128, True, 96, 0),
    # qwen3-moe-30b's attention (H=32, Kv=4, D=128): ragged lengths around
    # the 64-row tiles, with the causal, sliding-window and prefix-LM masks
    *((torch.bfloat16, 1, 32, 4, S, 128, True, window, prefix)
      for S in (1, 63, 65, 975) for window, prefix in ((None, 0), (96, 0), (None, 37))),
    # zamba2-7b's shared attention (H=Kv=32, D=112: the tile code of 128
    # with the last 16 columns zero), causal prefill at ragged lengths,
    # with the sliding-window and prefix-LM masks too, in both dtypes
    *((dtype, 1, ZAMBA_H, ZAMBA_KV, S, ZAMBA_D, True, window, prefix)
      for dtype in (torch.bfloat16, torch.float32)
      for S, window, prefix in ((1, None, 0), (63, None, 0), (65, None, 0),
                                (975, None, 0), (512, 96, 0), (512, None, 37))),
    (torch.bfloat16, 2, 8, 2, 192, 112, False, None, 0),     # D=112, GQA, bidirectional
    # the head widths 120 (h2o-danube3-4b: H=32, Kv=8; the tile code of 128
    # with one zero chunk in Q.K^T) and 256 (paligemma-3b: H=8, Kv=1; the
    # warp-specialised kernel in bf16), in both dtypes, at
    # ragged lengths and under the three masks (tests/test_torch_cuda.py
    # WIDE_ATTN_CASES), then each model's own prefill: paligemma's 256
    # patches under the prefix-LM mask before 1024 text tokens, danube's
    # ring request of 4600 tokens under its 4,096-token window
    *((dtype, B, H, Kv, S, D, causal, window, prefix)
      for dtype in (torch.bfloat16, torch.float32)
      for B, H, Kv, S, D, causal, window, prefix in (
          *((1, H, Kv, S, D, True, window, prefix)
            for H, Kv, D in ((DANUBE_H, DANUBE_KV, DANUBE_D),
                             (PALI_H, PALI_KV, PALI_D))
            for S, window, prefix in ((1, None, 0), (63, None, 0), (65, None, 0),
                                      (975, None, 0), (512, 96, 0),
                                      (512, None, 37))),
          (2, 8, 2, 192, 120, False, None, 0),
          (2, 8, 2, 192, 256, False, None, 0),
          (1, PALI_H, PALI_KV, PALI_PREFIX + 1024, PALI_D, True, None, PALI_PREFIX),
          (1, DANUBE_H, DANUBE_KV, RING_PROMPT, DANUBE_D, True, DANUBE_WINDOW, 0))),
    # the public models' prefill shapes (PUBLIC_SHAPES), in both dtypes
    *((dtype, 1, H, Kv, S, D, causal, None, 0)
      for dtype in (torch.bfloat16, torch.float32)
      for _, H, Kv, D, S, causal in PUBLIC_SHAPES),
]

# whisper-medium's attention (tests/test_torch_cuda.py WHISPER_ATTN_CASES),
# (dtype, B, H, Kv, Sq, Skv, D, causal): the encoder's bidirectional walk
# over 1500 frames (a 28-key last tile), the cross-attention of a decoder
# prompt of Sq tokens against them (Sq under, at and past one 64-row
# tile, and the 224-token prompt cap), and the decoder's causal prefill
WHISPER_FA_CASES = [
    (dtype, 1, WHISPER_H, WHISPER_KV, Sq, Skv, WHISPER_D, causal)
    for dtype in (torch.bfloat16, torch.float32)
    for Sq, Skv, causal in ((ENC_S, ENC_S, False),
                            *((Sq, ENC_S, False) for Sq in (1, 4, 63, 65, 224)),
                            (224, 224, True))
]

# flash_decode's tile skipping (tests/test_torch_cuda.py CARD_DECODE_CASES):
# (B, H, Kv, S, D, mask) with an all-masked row beside a partial one, one
# valid slot in the last tile, a ring wrapping past the end, S off the
# 64-slot tiles, and qwen3-moe-30b's decode shape
CARD_DECODE_CASES = [
    (2, 32, 8, 2048, 64, "empty beside 600"),
    (1, 32, 8, 2048, 64, "last"),
    (2, 32, 8, 2048, 64, "ring"),
    (2, 32, 8, 1000, 64, "ring"),
    (1, 32, 4, 2048, 128, "600"),
    (1, 32, 4, 2048, 128, "empty"),
    # zamba2-7b's decode shape (H=Kv=32, D=112) under the same masks
    (1, 32, 32, 2048, 112, "600"),
    (2, 32, 32, 2048, 112, "empty beside 600"),
    (1, 32, 32, 2048, 112, "last"),
    (2, 32, 32, 1000, 112, "ring"),
    # the head widths 120 (h2o-danube3-4b: H=32, Kv=8, and its full
    # 4,096-slot ring) and 256 (paligemma-3b: H=8, Kv=1, G=8)
    (1, 32, 8, 2048, 120, "600"),
    (2, 32, 8, 2048, 120, "empty beside 600"),
    (1, 32, 8, 2048, 120, "last"),
    (2, 32, 8, 1000, 120, "ring"),
    (1, 32, 8, 4096, 120, "4096"),
    (1, 8, 1, 2048, 256, "600"),
    (2, 8, 1, 2048, 256, "empty beside 600"),
    (1, 8, 1, 2048, 256, "last"),
    (2, 8, 1, 1000, 256, "ring"),
    # the public models' decode shapes (PUBLIC_SHAPES; SigLIP's width 72,
    # though an encoder does not decode), then their query groups in
    # several group tiles beside an empty row, in a ring, at the last slot
    *((1, H, Kv, DECODE_S, D, "600") for _, H, Kv, D, _, _ in PUBLIC_SHAPES),
    (2, 71, 1, 2048, 64, "empty beside 600"),
    (2, 96, 8, 1000, 192, "ring"),
    (2, 48, 1, 2048, 128, "last"),
]

# whisper-medium's decode caches (tests/test_torch_cuda.py
# WHISPER_DECODE_CASES): the cross cache, 1500 slots all valid (24 tiles,
# none skipped, the last ragged) or 600 valid; and the self cache, 448
# slots (7 tiles) of which a request of 4-224 prompt tokens and 32 output
# tokens fills the first 5 to 257 (a 4-token prompt's first step, a
# mid-range one, a 224-token prompt's last), or only the last slot
WHISPER_SELF_S = 448
WHISPER_DECODE_CASES = [
    *((B, WHISPER_H, WHISPER_KV, ENC_S, WHISPER_D, mask)
      for B in (1, 2) for mask in (str(ENC_S), "600")),
    *((1, WHISPER_H, WHISPER_KV, WHISPER_SELF_S, WHISPER_D, mask)
      for mask in ("5", "212", "257", "last")),
]

FD_CASES = [
    # (dtype, B, H, Kv, S, D, mask: see make_valid)
    (torch.bfloat16, 1, 32, 8, 2048, 64, "600"),            # main path
    (torch.bfloat16, 4, 32, 8, 2048, 64, "1,300,1000,2048"),
    (torch.bfloat16, 2, 8, 1, 1024, 128, "700,1024"),
    (torch.float32, 2, 32, 8, 2048, 64, "300,1500"),
    (torch.float32, 1, 8, 1, 1024, 128, "700"),
    *((dtype, *case) for case in CARD_DECODE_CASES + WHISPER_DECODE_CASES
      for dtype in (torch.bfloat16, torch.float32)),
]

# paligemma-3b's head width 256 in bf16 (tests/test_torch_cuda.py
# PALI_ATTN_CASES and PALI_DECODE_CASES): the warp-specialised prefill,
# (B, H, Kv, Sq, Skv, causal, window, prefix), causal at GQA 8:1, the
# 256-patch prefix before 1024 text tokens, a window, Sq != Skv, ragged
# lengths, B > 1 and GQA 1:1; the unpadded decode, (B, H, Kv, S, mask)
# (make_valid), in both dtypes with its log-sum-exp, the fp32 one within
# PALI_LSE_RTOL of max(|lse|, 1) (lse_error's measure; the worst across the
# head widths before the redesign)
PALI_FA_CASES = [
    (1, 8, 1, 1024, 1024, True, None, 0),
    (1, 8, 1, 1280, 1280, True, None, 256),
    (1, 8, 1, 512, 512, True, 96, 0),
    (1, 8, 1, 100, 700, False, None, 0),
    (1, 8, 1, 975, 975, True, None, 0),
    (1, 8, 1, 1, 1, True, None, 0),
    (1, 8, 1, 130, 130, True, None, 0),
    (2, 8, 1, 333, 333, True, None, 37),
    (2, 4, 4, 200, 200, True, None, 0),
    (2, 4, 4, 192, 192, False, None, 0),
]
PALI_FD_CASES = [
    (2, 8, 1, 2048, "600"),
    (2, 8, 1, 2048, "empty beside 600"),
    (2, 8, 1, 1000, "ring"),
    (1, 8, 1, 2048, "2048"),
    (1, 8, 1, 2048, "last"),
    (2, 8, 1, 1001, "700"),
    (2, 8, 8, 512, "300"),
    (1, 8, 2, 2048, "empty"),
]
PALI_LSE_RTOL = 5.4e-7

# falcon-mamba-7b's scan: d_inner 8192, ssm_state 16, 256-step chunks
SCAN_C, SCAN_N, SCAN_Q = 8192, 16, 256

SCAN_CASES = [
    # (label, dtype, B, S, chunk slice [c0, c1), C, N, nonzero h0)
    ("main path", torch.float32, 1, 256, (0, 256), 8192, 16, False),
    ("ragged last chunk of S=975", torch.float32, 1, 207, (0, 207), 8192, 16, True),
    ("B=2 N=8 Q=17", torch.float32, 2, 17, (0, 17), 1024, 8, True),
    ("nonzero h0", torch.float32, 1, 256, (0, 256), 8192, 16, True),
    ("chunk slice of (2, 975, 2048, 16)", torch.float32, 2, 975, (768, 975),
     2048, 16, True),
    ("bf16 inputs", torch.bfloat16, 1, 64, (0, 64), 8192, 16, True),
]

# the scenario engine's float outputs (latencies, span timelines): the
# reference's JAX-vs-oracle tolerance (tests/test_jax_engine.py); kernel
# and plain version round every operation alike, so they are expected to
# agree to the bit
SCENARIO_TOL = 1e-6
# the NVIDIA H100 SXM data sheet's float64 peak outside the tensor cores
PEAK_FP64_FLOPS = 34e12

# the reference's grouped-matmul tolerances (test_kernels.py)
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}

# qwen3-moe-30b's expert products: 128 experts, d_model 2048, expert d_ff
# 768; capacity 1 in decode, 77 for the fleet's longest prompt (S = 975)
GMM_E, GMM_D, GMM_F = 128, 2048, 768
GMM_DECODE_C, GMM_PREFILL_C = 1, 77

GMM_CASES = [
    # (label, dtype, E, C, D, F, layout of x: see gmm_x)
    ("reference case", torch.float32, 4, 64, 128, 256, "contiguous"),
    ("reference case, D and F not aligned", torch.float32, 8, 96, 200, 64, "contiguous"),
    ("reference case, C > one tile", torch.float32, 2, 256, 512, 512, "contiguous"),
    ("reference case", torch.bfloat16, 4, 64, 128, 256, "contiguous"),
    ("reference case, D and F not aligned", torch.bfloat16, 8, 96, 200, 64, "contiguous"),
    ("reference case, C > one tile", torch.bfloat16, 2, 256, 512, 512, "contiguous"),
    ("qwen3 decode", torch.bfloat16, 128, 1, 2048, 768, "dispatch"),
    ("qwen3 decode", torch.float32, 128, 1, 2048, 768, "dispatch"),
    ("qwen3 prefill S=975", torch.bfloat16, 128, 77, 2048, 768, "dispatch"),
    ("qwen3 prefill S=975", torch.float32, 128, 77, 2048, 768, "dispatch"),
    ("qwen3 wo product", torch.bfloat16, 128, 77, 768, 2048, "contiguous"),
    # phi3.5-moe-42b's experts (E=16, D=4096, F=6400; top-2): the S = 975
    # prefill's capacity, its wo product, the decode buffer, and rows with
    # 2 of the 16 experts occupied
    ("phi3.5-moe prefill S=975", torch.bfloat16, 16, 153, 4096, 6400, "contiguous"),
    ("phi3.5-moe wo product", torch.bfloat16, 16, 153, 6400, 4096, "contiguous"),
    *((f"phi3.5-moe {label}", dtype, 16, C, 4096, 6400, layout)
      for label, C, layout in (("decode", 1, "dispatch"),
                               ("rows, 2 experts occupied, C=1", 1, "occupied:2"),
                               ("rows, 2 experts occupied, C=153", 153, "occupied:2"))
      for dtype in (torch.bfloat16, torch.float32)),
    ("small C, F not a multiple of 4", torch.bfloat16, 8, 5, 200, 102, "dispatch"),
    ("small C, F not a multiple of 4", torch.float32, 8, 3, 130, 66, "contiguous"),
    ("C=12, one 16-row tile", torch.float32, 8, 12, 200, 64, "dispatch"),
    # the tensor-core kernel's row tiles (16-row fragments, balanced tiles
    # of <= 128 rows) at qwen3's D and F
    *((f"qwen3 D and F, C={C}", torch.bfloat16, 16, C, 2048, 768, "dispatch")
      for C in (9, 16, 17, 63, 64, 65, 77, 128, 129, 153)),
    ("ragged D slice", torch.bfloat16, 8, 40, 200, 768, "dispatch"),
    ("D not a multiple of 8: element loads", torch.bfloat16, 8, 40, 203, 768, "contiguous"),
    ("x base not 16-byte aligned: element loads", torch.bfloat16, 8, 40, 2048, 768, "offset"),
    # rows (tests/test_torch_cuda.py CARD_ROWS_GMM_CASES): N of qwen3's 128
    # experts hold tokens, x zero past rows[e] or nonzero there ("garbage")
    *((f"rows, {layout.split(':')[1]} experts occupied, C={C}", dtype, 128, C,
       2048, 768, layout)
      for C in (1, 5, 77)
      for layout in ("occupied:0", "occupied:8", "occupied:128")
      for dtype in (torch.bfloat16, torch.float32)),
    *((f"rows, nonzero x past them, C={C}", dtype, 128, C, 2048, 768, "garbage:8")
      for C in (1, 77) for dtype in (torch.bfloat16, torch.float32)),
    ("rows, small C, F not a multiple of 4", torch.bfloat16, 8, 5, 200, 102, "garbage:3"),
    ("rows, small C, F not a multiple of 4", torch.float32, 8, 3, 130, 66, "occupied:3"),
]


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 10, attempts: int = 2):
    """Mean device time of ``fn`` in ms with no host gaps: a spin kernel
    holds the stream while the host enqueues ``iters`` calls, so they run
    back to back between two CUDA events.  The spin is lengthened until the
    enqueue ends inside it (its cycles over the 1.98 GHz top clock bound
    its length from below).  None where it never does: ``fn`` waits for the
    device (a host-to-device copy does), so its calls cannot be queued."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        end.synchronize()
        if enqueue_ms < cycles / 1.98e6:
            return start.elapsed_time(end) / iters
        cycles *= 4
    return None


def _on_device(events):
    """The profiler's device-side events (kernels, copies): not the host
    operators that launched them (summing both would count a kernel twice)
    and not the ``ProfilerStep`` range the profiler may mirror onto the
    device timeline, which spans the whole window."""
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")]


def profile_window(window, cpu: bool = False):
    """Run ``window`` twice under ``torch.profiler``: the first run is the
    profiler's warm-up cycle, whose events are discarded (a trace started
    cold was seen to lose its first few kernels), the second is recorded.

    Returns the recorded device events, the second run's host wall time in
    ms (it ends in a synchronize) and the profiler's clock ratio: the span
    of the recorded device events over the CUDA-event time of the same
    window.  It is near 1 when the profiler's device timestamps are right;
    a run of this script once recorded kernels at 0.6 of their CUDA-event
    time, below the card's byte bound."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        window()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        start.record()
        window()
        end.record()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        prof.step()
    device = [e.time_range for e in _on_device(prof.events())]
    if not device:      # a lost trace; checked_profile measures again
        return [], wall_ms, float("nan")
    span_ms = (max(r.end for r in device) - min(r.start for r in device)) / 1e3
    kernels = [e for e in _on_device(prof.key_averages())
               if e.self_device_time_total > 0]
    return kernels, wall_ms, span_ms / start.elapsed_time(end)


CLOCK_OK = (0.8, 1.05)    # accepted profiler clock ratios (see profile_window)


class ProfilerFailed(RuntimeError):
    """torch.profiler gave no trustworthy trace in any window."""


def checked_profile(window, cpu: bool = False, iters: int = 1, attempts: int = 3):
    """``profile_window`` held to what a right trace must show: some device
    time, no longer than the wall time, a clock ratio inside ``CLOCK_OK``,
    and, when ``window`` is ``iters`` identical calls, a kernel count that
    is a multiple of ``iters`` (else the profiler lost events).  A window
    that fails is measured again; after ``attempts`` failures this raises
    ``ProfilerFailed``."""
    for _ in range(attempts):
        events, wall_ms, clock = profile_window(window, cpu=cpu)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        n_kernels = sum(e.count for e in events)
        if (busy_ms > 0 and n_kernels % iters == 0 and busy_ms <= wall_ms
                and CLOCK_OK[0] <= clock <= CLOCK_OK[1]):
            return events, wall_ms, clock
        log(f"torch.profiler recorded {n_kernels} kernels ({iters} identical "
            f"calls), busy {busy_ms:.3f} of {wall_ms:.3f} wall ms, clock ratio "
            f"{clock:.3f}; measuring again")
    raise ProfilerFailed(f"torch.profiler failed its checks in {attempts} windows")


def device_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: the CUDA kernel time that
    ``torch.profiler`` records over ``iters`` calls after ``warmup`` calls,
    so host overhead between launches does not count.  Where the profiler
    fails in every window (on the card it once recorded no device event at
    all, late in a run), ``queued_ms`` is returned instead, and the log says
    so: CUDA events around calls queued behind a spin kernel, which leave
    out the host's gaps too (plain CUDA events around a kernel faster than
    its wrapper's host work time the host).  Where ``fn`` waits for the
    device and cannot be queued, plain CUDA events around ``iters``
    back-to-back calls are the fallback: an upper bound."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    try:
        events, _, _ = checked_profile(lambda: [fn() for _ in range(iters)],
                                       iters=iters)
    except ProfilerFailed as e:
        ms = queued_ms(fn, iters=iters)
        if ms is not None:
            log(f"{e}; timed with CUDA events behind a spin kernel instead: "
                f"{ms:.4f} ms per call")
            return ms
        ms = cuda_ms(fn, iters=iters, warmup=0)
        log(f"{e}; timed with CUDA events instead (calls that wait for the "
            f"device; host gaps included, an upper bound): {ms:.4f} ms per call")
        return ms
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """Least time the card could take: the larger of flops over the peak
    for their type (bf16 tensor cores unless given) and bytes over the HBM
    rate.  Returns (ms, limiting resource)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    from repro_torch.profiles.profiler import card_description

    return card_description(torch.device("cuda", torch.cuda.current_device()))


def randn(rng: np.random.Generator, shape, dtype) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device="cuda", dtype=dtype)


# ---------------------------------------------------------------------------
# Phase 1: card and build
# ---------------------------------------------------------------------------


def phase_card_and_build() -> None:
    from repro_torch.kernels import build

    log("card:", card_line())
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {torch.cuda.get_device_name(0)} capability {cap} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap < (9, 0):
        raise RuntimeError(f"need compute capability >= 9.0, got {cap}")
    t0 = time.perf_counter()
    paths = build.build()
    each = ", ".join(f"{n} {t:.1f} s" for n, t in build.build_seconds.items())
    log(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s, "
        f"all nvcc at once ({each})")
    for name in paths:
        entry = ""
        for line in build.log_path(name).read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas[{name}] {entry}: {line.strip()}")


def ptxas_resources(name: str) -> str:
    """Each entry function's registers and spill bytes as ``nvcc -Xptxas
    -v`` logged them when kernel ``name`` was built, the function named by
    its bool template arguments ("not in the build log" where this process
    loaded a library built earlier)."""
    from repro_torch.kernels import build

    path = build.log_path(name)
    found, entry, spills = [], "", "?"
    for line in (path.read_text().splitlines() if path.exists() else ()):
        if "Compiling entry function" in line:
            flags = re.findall(r"Lb([01])E", line)
            entry = f"{name}<{', '.join('true' if b == '1' else 'false' for b in flags)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append(f"{entry}: {m.group(1)} registers, spill stores/loads "
                         f"{spills} B")
    return "; ".join(found) or "not in the build log"


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_flash_attention() -> float:
    """Every FA_CASES and WHISPER_FA_CASES case, kernel against plain;
    returns the largest error."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(11)
    worst = 0.0
    cases = [(dtype, B, H, Kv, S, S, D, causal, window, prefix)
             for dtype, B, H, Kv, S, D, causal, window, prefix in FA_CASES]
    cases += [(dtype, B, H, Kv, Sq, Skv, D, causal, None, 0)
              for dtype, B, H, Kv, Sq, Skv, D, causal in WHISPER_FA_CASES]
    for dtype, B, H, Kv, Sq, S, D, causal, window, prefix in cases:
        q = randn(rng, (B, Sq, H, D), dtype)
        k = randn(rng, (B, S, Kv, D), dtype)
        v = randn(rng, (B, S, Kv, D), dtype)
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        got = fa.launch(q, k, v, **kw)
        want = fa.plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dtype]
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        shape = f"S={S}" if Sq == S else f"Sq={Sq} Skv={S}"
        log(f"flash_attention {str(dtype)[6:]} B={B} H={H} Kv={Kv} {shape} "
            f"D={D} causal={causal} window={window} prefix={prefix}: "
            f"max_abs_err={err:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_attention disagrees with its plain version")
        worst = max(worst, err)
    return worst


def make_valid(B: int, S: int, mask: str, rng) -> torch.Tensor:
    """The (B, S) int8 mask ``mask`` names: "N" or "N0,N1,..", the first N
    slots of every row or of each; "empty", none; "empty beside N", none in
    row 0 and the first N in the others; "last", slot S - 1 alone; "ring",
    a window of live slots wrapping past the end, with holes."""
    pos = np.arange(S)[None, :].repeat(B, 0)
    if mask == "last":
        valid = pos == S - 1
    elif mask == "ring":
        valid = ((pos - (S - 300)) % S < 900) & (rng.random((B, S)) < 0.9)
    elif mask == "empty":
        valid = np.zeros((B, S), bool)
    elif mask.startswith("empty beside "):
        valid = pos < int(mask.split()[-1])
        valid[0] = False
    else:
        valid = pos < np.array([int(n) for n in mask.split(",")])[:, None]
    return torch.from_numpy(valid.astype(np.int8)).cuda()


def check_flash_decode() -> float:
    """Every FD_CASES case, kernel against plain; returns the largest error."""
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(12)
    worst = 0.0
    for dtype, B, H, Kv, S, D, mask in FD_CASES:
        q = randn(rng, (B, 1, H, D), dtype)
        k = randn(rng, (B, S, Kv, D), dtype)
        v = randn(rng, (B, S, Kv, D), dtype)
        valid = make_valid(B, S, mask, rng)
        got = fd.launch(q, k, v, valid)
        want = fd.plain(q, k, v, valid)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dtype]
        ok = (torch.isfinite(got).all().item()
              and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        log(f"flash_decode {str(dtype)[6:]} B={B} H={H} Kv={Kv} S={S} D={D} "
            f"valid={mask}: max_abs_err={err:.3g} tol={tol} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_decode disagrees with its plain version")
        worst = max(worst, err)
    return worst


# flash_decode's log-sum-exp (tests/test_torch_cuda.py LSE_CASES): (B, H,
# Kv, S, D, mask) with a row with no valid slot beside a partial one, one
# valid slot, llama3.2-1b's decode shape and qwen3-moe-30b's and
# zamba2-7b's heads
LSE_CASES = [
    (2, 32, 8, 2048, 64, "empty beside 600"),
    (1, 32, 8, 2048, 64, "last"),
    (1, 32, 8, 2048, 64, "600"),
    (1, 32, 8, 2048, 64, "empty"),
    (2, 32, 4, 1000, 128, "ring"),
    (1, 32, 32, 2048, 112, "empty beside 600"),
    (2, 32, 8, 2048, 120, "empty beside 600"),
    (2, 8, 1, 1000, 256, "ring"),
]
LSE_TOL = {torch.float32: ("relative", 1e-5), torch.bfloat16: ("absolute", 2e-3)}
NEG_INF = -1e30

# a slot split on one card: llama3.2-1b's decode heads over a 32,768-slot
# cache (decode_32k's), cut into 4 views of 8,192 slots (multiples of the
# 64-slot tile, 16-byte aligned); masks: 600 valid slots (three views
# empty), every slot valid, and slots valid in every view
SPLIT_S, SPLIT_VIEWS = 32_768, 4
SPLIT_MASKS = ("600", str(SPLIT_S), "every view")


def lse_error(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """The largest log-sum-exp difference in LSE_TOL's measure for
    ``dtype``: relative in float32, absolute in bf16.  Rows with no valid
    slot must hold the mask's -1e30 in both."""
    empty = want == NEG_INF
    if not torch.equal(got == NEG_INF, empty):
        return float("inf")
    diff = (got - want).abs()[~empty]
    if LSE_TOL[dtype][0] == "relative":
        diff = diff / want.abs()[~empty].clamp(min=1.0)
    return diff.max().item() if diff.numel() else 0.0


def check_flash_decode_lse() -> float:
    """Step 2, flash_decode's log-sum-exp: every LSE_CASES case in both
    dtypes, the kernel's (fp32 output, log-sum-exp) against the plain
    version's, and the launch without it equal to that fp32 output cast
    to q's dtype, to the bit; returns the largest output error."""
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(13)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, Kv, S, D, mask in LSE_CASES:
            q = randn(rng, (B, 1, H, D), dtype)
            k = randn(rng, (B, S, Kv, D), dtype)
            v = randn(rng, (B, S, Kv, D), dtype)
            valid = make_valid(B, S, mask, rng)
            got, got_lse = fd.launch(q, k, v, valid, return_lse=True)
            want, want_lse = fd.plain(q, k, v, valid, return_lse=True)
            # without it: the same launch but for the epilogue's store
            same = torch.equal(fd.launch(q, k, v, valid), got.to(dtype))
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lerr = lse_error(got_lse, want_lse, dtype)
            tol = TOL[dtype]
            kind, ltol = LSE_TOL[dtype]
            ok = (same and got.dtype == torch.float32 and got_lse.shape == (B, H)
                  and torch.isfinite(got).all().item()
                  and torch.isfinite(got_lse).all().item()
                  and torch.allclose(got, want, atol=tol, rtol=tol)
                  and lerr <= ltol)
            log(f"flash_decode lse {str(dtype)[6:]} B={B} H={H} Kv={Kv} S={S} "
                f"D={D} valid={mask}: output max_abs_err={err:.3g} tol={tol}, "
                f"lse {kind} err={lerr:.3g} tol={ltol}, without the lse "
                f"the fp32 output cast to the bit {same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("flash_decode's log-sum-exp disagrees "
                                     "with its plain version")
            worst = max(worst, err)
    return worst


def split_inputs(rng, dtype, mask: str, B: int = 2):
    q = randn(rng, (B, 1, MAIN_H, MAIN_D), dtype)
    k = randn(rng, (B, SPLIT_S, MAIN_KV, MAIN_D), dtype)
    v = randn(rng, (B, SPLIT_S, MAIN_KV, MAIN_D), dtype)
    if mask == "every view":
        pos = torch.arange(SPLIT_S, device="cuda")
        valid = ((pos % (SPLIT_S // SPLIT_VIEWS)) < 3000)[None].expand(B, SPLIT_S)
        valid = valid.to(torch.int8).contiguous()
    else:
        valid = make_valid(B, SPLIT_S, mask, rng)
    return q, k, v, valid


def split_decode(q, k, v, valid):
    """The kernel on SPLIT_VIEWS slot views of the cache, each with its
    log-sum-exp, merged once (``merge_decode_partials``)."""
    from repro_torch.kernels import flash_decode as fd

    n = SPLIT_S // SPLIT_VIEWS
    parts = [fd.launch(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                       valid[:, i * n:(i + 1) * n], return_lse=True)
             for i in range(SPLIT_VIEWS)]
    return fd.merge_decode_partials([o for o, _ in parts],
                                    [lse for _, lse in parts], dtype=q.dtype)


def check_slot_split() -> float:
    """Step 2, a slot split on one card: SPLIT_VIEWS views of a
    SPLIT_S-slot cache through the kernel with their log-sum-exp, merged,
    against one whole-cache launch and the plain version, bf16 then
    float32, under SPLIT_MASKS; returns the largest error."""
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(17)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for mask in SPLIT_MASKS:
            q, k, v, valid = split_inputs(rng, dtype, mask)
            got = split_decode(q, k, v, valid)
            whole = fd.launch(q, k, v, valid)
            want = fd.plain(q, k, v, valid)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            errs = [(got.float() - w.float()).abs().max().item()
                    for w in (whole, want)]
            ok = (got.dtype == dtype and torch.isfinite(got).all().item()
                  and all(torch.allclose(got.float(), w.float(), atol=tol,
                                         rtol=tol) for w in (whole, want)))
            log(f"flash_decode slot split {str(dtype)[6:]} B={q.shape[0]} "
                f"H={MAIN_H} Kv={MAIN_KV} D={MAIN_D} S={SPLIT_S} in "
                f"{SPLIT_VIEWS} views, valid={mask}: max_abs_err vs the "
                f"whole-cache launch {errs[0]:.3g}, vs plain {errs[1]:.3g} "
                f"tol={tol} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the merged slot split disagrees with "
                                     "the whole cache")
            worst = max(worst, *errs)
    return worst


def check_head_width_256() -> dict:
    """Step 2, paligemma-3b's head width: PALI_FA_CASES through the
    warp-specialised prefill and PALI_FD_CASES through the unpadded decode
    (output, then the fp32 output and log-sum-exp), each against its plain
    version, and the slot split at D = 256 (SPLIT_VIEWS views of a
    SPLIT_S-slot cache, merged) against the whole-cache launch and plain.
    Returns each kernel's largest output error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(19)
    worst = {"flash_attention": 0.0, "flash_decode": 0.0}
    tol = TOL[torch.bfloat16]
    for B, H, Kv, Sq, Skv, causal, window, prefix in PALI_FA_CASES:
        q = randn(rng, (B, Sq, H, PALI_D), torch.bfloat16)
        k = randn(rng, (B, Skv, Kv, PALI_D), torch.bfloat16)
        v = randn(rng, (B, Skv, Kv, PALI_D), torch.bfloat16)
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        got = fa.launch(q, k, v, **kw)
        want = fa.plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = (torch.isfinite(got).all().item()
              and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        log(f"flash_attention D=256 bf16 B={B} H={H} Kv={Kv} Sq={Sq} Skv={Skv} "
            f"causal={causal} window={window} prefix={prefix}: "
            f"max_abs_err={err:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_attention at D=256 disagrees with its "
                                 "plain version")
        worst["flash_attention"] = max(worst["flash_attention"], err)
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, Kv, S, mask in PALI_FD_CASES:
            q = randn(rng, (B, 1, H, PALI_D), dtype)
            k = randn(rng, (B, S, Kv, PALI_D), dtype)
            v = randn(rng, (B, S, Kv, PALI_D), dtype)
            valid = make_valid(B, S, mask, rng)
            got = fd.launch(q, k, v, valid)
            out, lse = fd.launch(q, k, v, valid, return_lse=True)
            want, want_lse = fd.plain(q, k, v, valid, return_lse=True)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            err = max((got.float() - want.float()).abs().max().item(),
                      (out - want).abs().max().item())
            lerr = lse_error(lse, want_lse, dtype)
            kind, ltol = LSE_TOL[dtype]
            if dtype == torch.float32:
                ltol = PALI_LSE_RTOL
            ok = (torch.isfinite(got).all().item()
                  and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
                  and torch.allclose(out, want, atol=tol, rtol=tol)
                  and lerr <= ltol)
            log(f"flash_decode D=256 {str(dtype)[6:]} B={B} H={H} Kv={Kv} S={S} "
                f"valid={mask}: max_abs_err={err:.3g} tol={tol}, lse {kind} "
                f"err={lerr:.3g} tol={ltol} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("flash_decode at D=256 disagrees with its "
                                     "plain version")
            worst["flash_decode"] = max(worst["flash_decode"], err)
    tol = TOL[torch.bfloat16]
    for mask in SPLIT_MASKS:
        B = 2
        q = randn(rng, (B, 1, PALI_H, PALI_D), torch.bfloat16)
        k = randn(rng, (B, SPLIT_S, PALI_KV, PALI_D), torch.bfloat16)
        v = randn(rng, (B, SPLIT_S, PALI_KV, PALI_D), torch.bfloat16)
        if mask == "every view":
            pos = torch.arange(SPLIT_S, device="cuda")
            valid = ((pos % (SPLIT_S // SPLIT_VIEWS)) < 3000)[None].expand(B, SPLIT_S)
            valid = valid.to(torch.int8).contiguous()
        else:
            valid = make_valid(B, SPLIT_S, mask, rng)
        got = split_decode(q, k, v, valid)
        whole = fd.launch(q, k, v, valid)
        want = fd.plain(q, k, v, valid)
        torch.cuda.synchronize()
        errs = [(got.float() - w.float()).abs().max().item() for w in (whole, want)]
        ok = all(torch.allclose(got.float(), w.float(), atol=tol, rtol=tol)
                 for w in (whole, want))
        log(f"flash_decode D=256 slot split bf16 B={B} H={PALI_H} Kv={PALI_KV} "
            f"S={SPLIT_S} in {SPLIT_VIEWS} views, valid={mask}: max_abs_err vs "
            f"the whole-cache launch {errs[0]:.3g}, vs plain {errs[1]:.3g} "
            f"tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the merged slot split at D=256 disagrees")
        worst["flash_decode"] = max(worst["flash_decode"], *errs)
    return worst


def check_width_sweep() -> dict:
    """Step 2, the head widths of SWEEP_WIDTHS in both dtypes: one causal
    prefill (SWEEP_FA) and one decode (SWEEP_FD: 600 valid slots beside a
    row with none), each kernel against its plain version at the
    reference's tolerances; a line per width and dtype, naming the copies'
    alignment.  The inputs of a width are the leading elements of seeded
    buffers made once per dtype (contiguous, at the width's own row
    alignment).  Returns each kernel's largest error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(23)
    worst = {"flash_attention": 0.0, "flash_decode": 0.0}
    B, H, Kv, S = SWEEP_FA
    dB, dH, dKv, dS, mask = SWEEP_FD
    wmax = max(SWEEP_WIDTHS)
    valid = make_valid(dB, dS, mask, rng)

    def lead(buf, shape):
        return buf[:math.prod(shape)].view(shape)

    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[dtype]
        bufs = [randn(rng, (n * wmax,), dtype) for n in (
            B * S * H, B * S * Kv, B * S * Kv, dB * dH, dB * dS * dKv, dB * dS * dKv)]
        for D in SWEEP_WIDTHS:
            q, k, v = (lead(b, (B, S, h, D)) for b, h in zip(bufs, (H, Kv, Kv)))
            got, want = fa.launch(q, k, v), fa.plain(q, k, v)
            qd = lead(bufs[3], (dB, 1, dH, D))
            kd, vd = (lead(b, (dB, dS, dKv, D)) for b in bufs[4:])
            got_d, want_d = fd.launch(qd, kd, vd, valid), fd.plain(qd, kd, vd, valid)
            torch.cuda.synchronize()
            errs = [(g.float() - w.float()).abs().max().item()
                    for g, w in ((got, want), (got_d, want_d))]
            ok = all(torch.isfinite(g).all().item()
                     and torch.allclose(g.float(), w.float(), atol=tol, rtol=tol)
                     for g, w in ((got, want), (got_d, want_d)))
            log(f"width sweep {str(dtype)[6:]} D={D} (rows {fa.row_alignment(q, k, v)}-"
                f"byte aligned, {fa.kernel_form(dtype, D, fa.row_alignment(q, k, v))}): "
                f"flash_attention B={B} H={H} "
                f"Kv={Kv} S={S} causal max_abs_err={errs[0]:.3g}; flash_decode "
                f"B={dB} H={dH} Kv={dKv} S={dS} valid={mask} max_abs_err="
                f"{errs[1]:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"a kernel at head width {D} disagrees "
                                     "with its plain version")
            worst["flash_attention"] = max(worst["flash_attention"], errs[0])
            worst["flash_decode"] = max(worst["flash_decode"], errs[1])
    return worst


def check_unaligned_views() -> dict:
    """Step 2, the served widths (UNALIGNED_SHAPES) in both dtypes on views
    sliced out of one fused buffer at an odd element offset, as a fused
    QKV projection's output is: a causal prefill (B 1, S 320) of q, k and v
    views of one (B, S, 1 + (H + 2 Kv) D) buffer, and a decode (B 2, 1,100
    slots, 600 and 77 valid) of cache views of one (B, S, 1 + 2 Kv D)
    buffer and a q view of one (B, 1, 1 + H D) buffer, each against its
    plain version; the wrappers read the views where they lie (no copy).
    Returns each kernel's largest error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(31)
    worst = {"flash_attention": 0.0, "flash_decode": 0.0}
    S, dB, dS = 320, 2, 1100
    valid = make_valid(dB, dS, "600,77", rng)
    for name, H, Kv, D in UNALIGNED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[dtype]
            fused = randn(rng, (1, S, 1 + (H + 2 * Kv) * D), dtype)
            q = fused[..., 1:1 + H * D].view(1, S, H, D)
            k = fused[..., 1 + H * D:1 + (H + Kv) * D].view(1, S, Kv, D)
            v = fused[..., 1 + (H + Kv) * D:].view(1, S, Kv, D)
            cache = randn(rng, (dB, dS, 1 + 2 * Kv * D), dtype)
            kd = cache[..., 1:1 + Kv * D].view(dB, dS, Kv, D)
            vd = cache[..., 1 + Kv * D:].view(dB, dS, Kv, D)
            qd = randn(rng, (dB, 1, 1 + H * D), dtype)[..., 1:].view(dB, 1, H, D)
            align = (fa.row_alignment(q, k, v), fa.row_alignment(qd[:, 0], kd, vd))
            pairs = ((fa.launch(q, k, v), fa.plain(q, k, v)),
                     (fd.launch(qd, kd, vd, valid), fd.plain(qd, kd, vd, valid)))
            torch.cuda.synchronize()
            errs = [(g.float() - w.float()).abs().max().item() for g, w in pairs]
            ok = all(torch.isfinite(g).all().item()
                     and torch.allclose(g.float(), w.float(), atol=tol, rtol=tol)
                     for g, w in pairs)
            log(f"unaligned view {name} {str(dtype)[6:]} H={H} Kv={Kv} D={D}, one "
                f"element into a fused buffer (rows {align[0]}- / {align[1]}-byte "
                f"aligned): flash_attention S={S} causal max_abs_err={errs[0]:.3g}; "
                f"flash_decode B={dB} S={dS} valid=600,77 max_abs_err={errs[1]:.3g} "
                f"tol={tol} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: a kernel on unaligned views "
                                     "disagrees with its plain version")
            worst["flash_attention"] = max(worst["flash_attention"], errs[0])
            worst["flash_decode"] = max(worst["flash_decode"], errs[1])
    return worst


def time_slot_split() -> None:
    """Step 3, the slot split's times (bf16, B = 1, SPLIT_MASKS): one
    whole-cache launch against the SPLIT_VIEWS launches with their
    log-sum-exp plus the merge, device time (``torch.profiler``) and CUDA
    events around back-to-back calls, beside the whole cache's bound.  No
    limit is set."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(18)
    for mask in SPLIT_MASKS:
        q, k, v, valid = split_inputs(rng, torch.bfloat16, mask, B=1)
        n_valid = int(valid.bool().sum().item())
        calls = {"whole": lambda: fd.launch(q, k, v, valid),
                 "split": lambda: split_decode(q, k, v, valid)}
        dev = {name: device_ms(f, iters=20) for name, f in calls.items()}
        ev = {name: cuda_ms(f, iters=50) for name, f in calls.items()}
        work = cost.flash_decode_work(1, MAIN_H, MAIN_KV, SPLIT_S, MAIN_D, 2,
                                      n_valid)
        b_ms, b_by = bound_ms(work.flops, work.bytes)
        log(f"flash_decode slot split timing [{card_line()}] bf16 B=1 "
            f"H={MAIN_H} Kv={MAIN_KV} D={MAIN_D} S={SPLIT_S} valid={mask} "
            f"({n_valid} slots): whole-cache launch {dev['whole']:.4f} ms, "
            f"{SPLIT_VIEWS} launches + merge {dev['split']:.4f} ms (device "
            f"time, torch.profiler); per call with host overhead (CUDA "
            f"events): whole {ev['whole']:.4f} ms, split {ev['split']:.4f} "
            f"ms; bound_ms={b_ms:.5f} ({b_by})")


def scan_inputs(rng, shape, dtype):
    """a = sigmoid(normal) in (0, 1) like exp(delta * A), b = 0.1 * normal,
    as the reference's scan test draws them."""
    a = torch.sigmoid(randn(rng, shape, torch.float32)).to(dtype)
    b = (0.1 * randn(rng, shape, torch.float32)).to(dtype)
    return a, b


def check_selective_scan() -> float:
    """Every SCAN_CASES case, kernel against plain; returns the largest
    error.  A chunk slice is a strided view of the longer tensor."""
    from repro_torch.kernels import selective_scan as ss

    rng = np.random.default_rng(15)
    worst = 0.0
    for label, dtype, B, S, (c0, c1), C, N, nonzero in SCAN_CASES:
        a, b = scan_inputs(rng, (B, S, C, N), dtype)
        a, b = a[:, c0:c1], b[:, c0:c1]
        h0 = (randn(rng, (B, C, N), torch.float32) if nonzero
              else torch.zeros((B, C, N), device="cuda"))
        got = ss.launch(a, b, h0)
        want = ss.plain(a, b, h0)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, atol=SCAN_TOL, rtol=SCAN_TOL)
        log(f"selective_scan {label}: {str(dtype)[6:]} B={B} Q={c1 - c0} C={C} "
            f"N={N} contiguous={a.is_contiguous()}: max_abs_err={err:.3g} "
            f"tol={SCAN_TOL} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("selective_scan disagrees with its plain version")
        worst = max(worst, err)
    return worst


def gmm_x(rng, E: int, C: int, D: int, dtype, layout: str):
    """x (E, C, D) and rows (E,) int32 or None, as ``layout`` says:
    "contiguous"; "dispatch", the first C rows of an (E, C + 1, D) buffer,
    as ``moe_apply`` hands the dispatch buffer over without its overflow
    row; "offset", a contiguous view that starts one element into a flat
    buffer, so its base is aligned to the element but not to 16 bytes;
    "occupied:N", the dispatch view with rows: N experts (drawn from the
    seed) hold 1..C rows, one of them C, the rest none, and x is zero past
    rows[e]; "garbage:N", the same rows with x nonzero past them."""
    if layout == "contiguous":
        return randn(rng, (E, C, D), dtype), None
    if layout == "dispatch":
        return randn(rng, (E, C + 1, D), dtype)[:, :C], None
    if layout == "offset":
        return randn(rng, (E * C * D + 1,), dtype)[1:].view(E, C, D), None
    kind, n = layout.split(":")
    if kind not in ("occupied", "garbage"):
        raise ValueError(f"unknown layout {layout!r}")
    occupied = rng.choice(E, size=int(n), replace=False)
    rows = np.zeros(E, np.int32)
    rows[occupied] = rng.integers(1, C + 1, size=int(n))
    if int(n):
        rows[occupied[0]] = C
    return dispatch_x(rng, C, D, dtype, torch.from_numpy(rows).cuda(),
                      zero_past=kind == "occupied")


def dispatch_x(rng, C: int, D: int, dtype, rows: torch.Tensor, zero_past=True):
    """The first C rows of an (E, C + 1, D) dispatch buffer of unit-normal
    rows, zero at and past rows[e] unless ``zero_past`` is False; returns
    (x, rows)."""
    x = randn(rng, (rows.shape[0], C + 1, D), dtype)[:, :C]
    if zero_past:
        x[torch.arange(C, device="cuda")[None, :] >= rows[:, None]] = 0
    return x, rows


def check_moe_gmm() -> float:
    """Every GMM_CASES case, kernel against plain at the reference's
    tolerances; returns the largest error."""
    from repro_torch.kernels import moe_gmm as gmm

    rng = np.random.default_rng(17)
    worst = 0.0
    for label, dtype, E, C, D, F, layout in GMM_CASES:
        x, rows = gmm_x(rng, E, C, D, dtype, layout)
        w = randn(rng, (E, D, F), dtype)
        if rows is not None or (dtype == torch.float32 and D >= 4096):
            # fan-in scale, as the model's weights: with unit-normal ones an
            # fp32 sum of 2048 products is O(100), and two correct fp32 orders
            # of it (cuBLAS's, the kernel's) differ by ~2e-4 (at phi3.5-moe's
            # D = 4096, 7.2e-4 at |y| up to 281)
            w = w / math.sqrt(D)
        got = gmm.launch(x, w, rows)
        want = gmm.plain(x, w, rows)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = GMM_TOL[dtype]
        ok = (got.dtype == x.dtype and got.shape == (E, C, F)
              and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        if rows is not None:    # zeros past rows[e]; x zero there: the product
            past = torch.arange(C, device="cuda")[None, :] >= rows[:, None]
            ok = ok and bool(got[past].eq(0).all())
            if layout.startswith("occupied"):
                ok = ok and torch.allclose(got.float(), gmm.plain(x, w).float(),
                                           atol=tol, rtol=tol)
        log(f"moe_gmm {label}: {str(dtype)[6:]} E={E} C={C} D={D} F={F} "
            f"x {layout}: max_abs_err={err:.3g} "
            f"max|y|={want.float().abs().max().item():.3g} tol={tol} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("moe_gmm disagrees with its plain version")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Phase 4: serve each full-width model through the kernels
# ---------------------------------------------------------------------------


def expected_launches(model, res) -> dict:
    """Kernel launches the fleet run ``res`` must have made: attention
    models launch flash_attention once per layer and prefill and
    flash_decode once per layer and decode step, and an MoE model moe_gmm
    once per expert product (three when gated), layer and forward pass
    (prefill or decode step); Mamba-1 launches the scan once per layer and
    256-step chunk of every prefill (the last chunk ragged), and nothing in
    decode; the hybrid launches the attention kernels once per application
    of its shared block (one per super-block) and nothing for Mamba-2; the
    encoder-decoder launches flash_attention once per encoder layer and
    twice per decoder layer (causal self-attention, cross-attention) in a
    prefill, and flash_decode twice per decoder layer in a decode step."""
    cfg = model.cfg
    L = cfg.num_layers
    want = dict.fromkeys(
        ("flash_attention", "flash_decode", "selective_scan", "moe_gmm",
         "scenario_scan"), 0)
    if cfg.is_encdec:
        want["flash_attention"] = (cfg.encoder_layers + 2 * L) * res.prefills
        want["flash_decode"] = 2 * L * res.decode_steps
        return want
    if cfg.family == "hybrid":
        want["flash_attention"] = cfg.hybrid_blocks * res.prefills
        want["flash_decode"] = cfg.hybrid_blocks * res.decode_steps
        return want
    if cfg.family == "ssm":
        chunks = sum(math.ceil(s / model.ssm_chunk) for s in res.prefill_lens)
        want["selective_scan"] = L * chunks
        return want
    want["flash_attention"] = L * res.prefills
    want["flash_decode"] = L * res.decode_steps
    if cfg.is_moe:
        products = 3 if cfg.mlp_gated else 2
        want["moe_gmm"] = products * L * (res.prefills + res.decode_steps)
    return want


# full-width parameter counts (the reference's blueprint counts)
FULL_PARAMS = {"llama3.2-1b": 1_235_814_400, "falcon-mamba-7b": 7_272_665_088,
               "qwen3-moe-30b": 30_532_646_912, "zamba2-7b": 5_622_728_000,
               "whisper-medium": 758_255_616, "paligemma-3b": 2_508_793_856,
               "h2o-danube3-4b": 3_838_959_360, "qwen2.5-3b": 3_086_200_832,
               "command-r-35b": 30_283_210_752}
CARD_BYTES = 80e9

# the fleet's prompt lengths and cache slots per request: (min, max, slots);
# whisper-medium's prompts stop at its 224-token cap (half of its 448-token
# decoder context, ``n_text_ctx``), which its cache holds
FLEET_SHAPES = {"whisper-medium": (4, 224, 448)}
DEFAULT_FLEET_SHAPE = (128, 1024, 2048)


class Fleet:
    """A served model and its requests: prompts (id -> 1-D tokens), for an
    encoder-decoder model their audio frames and for a prefix-LM their
    image prefixes (id -> (1, frontend_seq, d_model)), and the cache slots
    a request gets."""

    def __init__(self, model, prompts: Dict[int, torch.Tensor],
                 frames: Optional[Dict[int, torch.Tensor]], max_len: int) -> None:
        self.model, self.prompts, self.frames = model, prompts, frames
        self.max_len = max_len

    def longest(self) -> int:
        return max(self.prompts, key=lambda rid: len(self.prompts[rid]))

    def prefix(self) -> int:
        """Cache positions a prefix-LM's image prefix takes before the
        prompt (0 for other models)."""
        cfg = self.model.cfg
        return cfg.frontend_seq if cfg.frontend and not cfg.is_encdec else 0

    def prefill(self, rid: int, cache, dtype=torch.bfloat16):
        """``model.prefill`` of request ``rid`` into ``cache`` (its frames
        first, for an encoder-decoder model; its image prefix as
        ``prefix_embed``, for a prefix-LM)."""
        from repro_torch.serving.live import prefill_request

        return prefill_request(self.model, self.prompts[rid][None], cache,
                               None if self.frames is None else self.frames[rid],
                               dtype)


def build_served_model(arch: str) -> Fleet:
    """Full-width ``arch`` with random bf16 weights (seed 0) on the card,
    and the fleet's eight prompts (numpy seed 7; 128-1024 tokens, or
    ``FLEET_SHAPES``'), with 1500 frames each for whisper-medium and 256
    image patches each for paligemma-3b (numpy seed 8)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.live import make_frames, make_prompts

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = build_model(cfg, impl="kernel", device="cuda",
                        dtype=torch.bfloat16, generator=gen)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {model.num_params():,} params, bf16, random "
        f"(seed 0), built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    if model.num_params() != FULL_PARAMS[arch]:
        raise AssertionError(f"{arch}: {model.num_params():,} parameters, "
                             f"want {FULL_PARAMS[arch]:,}")
    lo, hi, slots = FLEET_SHAPES.get(arch, DEFAULT_FLEET_SHAPE)
    prompts = make_prompts(cfg, n=8, min_len=lo, max_len=hi, seed=7,
                           device="cuda")
    frames = (make_frames(cfg, prompts, seed=8, device="cuda")
              if cfg.frontend else None)
    kind = "audio frames" if cfg.is_encdec else "image patches (prefix-LM)"
    log("prompt lengths:", [len(p) for p in prompts.values()],
        f"cache slots per request {slots}" + (
            f", {cfg.frontend_seq} {kind} each" if frames else ""))
    return Fleet(model, prompts, frames, slots)


def phase_serve(fleet: Fleet) -> dict:
    """The fleet run of ``fleet``; returns the kernel launches it made,
    counted from zero just before the run and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.serving.live import serve_fleet

    model, prompts = fleet.model, fleet.prompts
    name = model.cfg.name
    # warm up (cuBLAS handles, allocator) before the measured run
    serve_fleet(model, {0: prompts[0][:64]}, replicas=1, out_tokens=2,
                max_len=128 + fleet.prefix(), kill_step=0, log=lambda s: None,
                frames=None if fleet.frames is None else {0: fleet.frames[0]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    res = serve_fleet(model, prompts, replicas=2, out_tokens=32,
                      max_len=fleet.max_len, kill_step=4, log=log,
                      frames=fleet.frames)
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}

    if sorted(res.completed) != sorted(prompts):
        raise AssertionError(f"lost requests: {set(prompts) - set(res.completed)}")
    for rid, toks in res.completed.items():
        if len(toks) != 33:
            raise AssertionError(f"request {rid} has {len(toks)} tokens, want 33")
    want = expected_launches(model, res)
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != {want} "
                             f"({res.prefills} prefills of {res.prefill_lens}, "
                             f"{res.decode_steps} decode steps)")
    if not res.retried:
        raise AssertionError("the preemption retried no request")
    if res.graphs != 2 * len(prompts):
        raise AssertionError(f"{name}: {res.graphs} captured serve steps, want "
                             f"{2 * len(prompts)} (2 replicas x "
                             f"{len(prompts)} cache slots)")
    if torch.cuda.max_memory_allocated() >= CARD_BYTES:
        raise AssertionError(f"{name}: peak device memory "
                             f"{torch.cuda.max_memory_allocated():,} B")
    n_tok = sum(len(t) for t in res.completed.values())
    slot_bytes = cache_bytes(model.init_cache(1, fleet.max_len))
    log(f"{name} served {len(res.completed)}/{len(prompts)} requests, "
        f"{n_tok} tokens, {len(res.retried)} retried after the preemption, in "
        f"{res.wall_s:.3f} s: {n_tok / res.wall_s:.1f} tokens/s, "
        f"prefills={res.prefills} (lengths {res.prefill_lens}) "
        f"mean_prefill_ms={1e3 * np.mean(res.prefill_s):.3f}, "
        f"decode_steps={res.decode_steps} "
        f"mean_decode_step_ms={1e3 * np.mean(res.decode_s):.3f} (captured "
        f"steps replayed), set-up {res.setup_s:.3f} s for {res.graphs} cache "
        f"slots with captured steps ({slot_bytes / 1e6:.1f} MB of cache "
        f"each, {fleet.max_len} slots), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{name} launches on the serving path (want {json.dumps(want)}):",
        json.dumps(launches))
    return launches


@contextlib.contextmanager
def recorded_routing():
    """Collect the expert indices (N, k) that every ``moe_apply`` call in
    the block routes to, in call order (one per MoE layer and pass)."""
    from repro_torch.models import moe

    seen, route = [], moe.route_topk

    def record(logits, top_k):
        weights, idx = route(logits, top_k)
        seen.append(idx)
        return weights, idx

    moe.route_topk = record
    try:
        yield seen
    finally:
        moe.route_topk = route


def routing_differences(got, want, num_experts: int) -> int:
    """(layer, token, k) routing choices of ``got`` that ``want`` did not
    make: per token, the experts in one top-k set and not in the other (an
    order swap inside the set is no difference)."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} routed layers against {len(want)}")
    n = 0
    for a, b in zip(got, want):
        sets = [F.one_hot(i, num_experts).sum(1) for i in (a, b)]
        n += int((sets[0] - sets[1]).clamp_min(0).sum())
    return n


def _prefill_logits(fleet: Fleet, rid: int, impl, dtype):
    """Last-position prefill logits (fp32) of request ``rid`` over the real
    vocabulary (the padding entries hold the dtype's most negative value)
    and the routing of each MoE layer."""
    model = fleet.model
    model.impl = impl
    try:
        with recorded_routing() as routes:
            cache = model.init_cache(1, fleet.prefix() + len(fleet.prompts[rid]),
                                     dtype=dtype)
            logits = fleet.prefill(rid, cache, dtype=dtype)[0].float()
        return logits[..., :model.cfg.vocab_size], routes
    finally:
        model.impl = "kernel"


@torch.inference_mode()
def compare_prefill_logits(fleet: Fleet, n: int = 4) -> None:
    """Prefill logits of the kernel path against the plain path, same
    weights, in float32 and in bf16 activations.

    float32: within 1e-3 (fp32 summation order differs between kernel and
    plain through the layers; logits are O(1)).  bf16: the kernel path may
    be no further from the float32 plain logits than twice the bf16 plain
    path is, i.e. it adds no error beyond bf16's own rounding.

    MoE: top-k routing is discontinuous, so a reordered fp32 sum can flip a
    near-tie among the gates and change a token's experts.  The routing
    choices that differ between the two paths are counted and printed; a
    rule is enforced when its paths routed alike, and where they did not
    its result is printed beside the count (``check_moe_layer`` holds the
    kernel itself to the grouped matmul's tolerances)."""
    cfg = fleet.model.cfg
    top1, flips = [], {"f32": 0, "bf16": 0}
    for rid in list(fleet.prompts)[:n]:
        tokens = fleet.prompts[rid][None]
        ref32, r_ref32 = _prefill_logits(fleet, rid, "plain", torch.float32)
        got32, r_got32 = _prefill_logits(fleet, rid, "kernel", torch.float32)
        ref16, r_ref16 = _prefill_logits(fleet, rid, "plain", torch.bfloat16)
        got16, r_got16 = _prefill_logits(fleet, rid, "kernel", torch.bfloat16)
        for t in (got32, got16):
            if not torch.isfinite(t).all():
                raise AssertionError("non-finite prefill logits")
        n32 = routing_differences(r_got32, r_ref32, cfg.num_experts)
        n16 = routing_differences(r_got16, r_ref16, cfg.num_experts)
        flips["f32"] += n32
        flips["bf16"] += n16
        err32 = (got32 - ref32).abs().max().item()
        err16 = (got16 - ref16).abs().max().item()
        kernel16 = (got16 - ref32).abs().max().item()
        plain16 = (ref16 - ref32).abs().max().item()
        tol16 = 2 * plain16
        top1.append(bool(got16.argmax(-1).eq(ref16.argmax(-1)).all()))
        routing = (f"; routing choices that differ kernel vs plain: f32 {n32}, "
                   f"bf16 {n16} of {len(r_ref32) * tokens.shape[1] * cfg.experts_per_token}"
                   if cfg.is_moe else "")
        log(f"{cfg.name} prefill logits request {rid} (S={tokens.shape[1]}, max|logit|="
            f"{ref32.abs().max().item():.3f}): f32 kernel vs plain "
            f"max_abs_err={err32:.3g} tol=1e-3; bf16 kernel vs plain "
            f"max_abs_err={err16:.4g}; bf16 distance to f32 plain: kernel "
            f"{kernel16:.4g} plain {plain16:.4g} tol={tol16:.4g}; "
            f"top1_equal={top1[-1]}{routing}")
        for rule, failed, flipped in (("f32", err32 > 1e-3, n32),
                                      ("bf16", kernel16 > tol16, n16)):
            if failed and not flipped:
                raise AssertionError(f"{rule} prefill logits: kernel path "
                                     "disagrees with plain")
            if failed:
                log(f"{cfg.name} request {rid}: the {rule} rule does not hold "
                    f"after {flipped} routing choices differed; not enforced")
    log(f"{cfg.name} prefill logits bf16 top-1 agreement kernel vs plain "
        f"{sum(top1)}/{len(top1)}")
    if cfg.is_moe:
        log(f"{cfg.name} routing choices that differ kernel vs plain over "
            f"{len(top1)} prefills: {json.dumps(flips)}")


@torch.inference_mode()
def check_moe_layer(model, prompts) -> None:
    """One full-width MoE layer (layer 0's weights) on the longest prompt's
    length of unit-normal input, ``impl="kernel"`` against ``"plain"``, in
    bf16 and float32.  The router product runs before any grouped matmul,
    so both route alike (checked); the outputs are held to the grouped
    matmul's tolerances, the absolute one scaled by the output's size (the
    random weights' fan-in scale makes y ~1e-4)."""
    from repro_torch.models import moe

    cfg, p = model.cfg, model.layers[0]["moe"]
    S = max(len(t) for t in prompts.values())
    rng = np.random.default_rng(19)
    x32 = randn(rng, (1, S, cfg.d_model), torch.float32)
    for dtype in (torch.bfloat16, torch.float32):
        x = x32.to(dtype)
        with recorded_routing() as r_got:
            got = moe.moe_apply(p, cfg, x, impl="kernel")[0]
        with recorded_routing() as r_want:
            want = moe.moe_apply(p, cfg, x, impl="plain")[0]
        torch.cuda.synchronize()
        flips = routing_differences(r_got, r_want, cfg.num_experts)
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        tol = GMM_TOL[dtype]
        ok = (flips == 0 and torch.isfinite(got).all().item()
              and torch.allclose(got.float(), want.float(), atol=tol * scale,
                                 rtol=tol))
        log(f"{cfg.name} MoE layer check {str(dtype)[6:]} S={S} C="
            f"{moe._capacity(cfg, S)}: kernel vs plain max_abs_err={err:.3g} "
            f"max|y|={scale:.3g} (error / max|y| = {err / scale:.3g}) "
            f"tol={tol} x max|y|, routing choices that differ {flips} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("MoE layer: kernel path disagrees with plain")


def _cache_tensors(cache):
    """Every tensor of ``cache``, keyed by its path: the length, each
    group's tensors (KV, SSM states, the hybrid's groups) and the
    encoder-decoder's cross K/V and mask."""
    for key, value in cache.items():
        if isinstance(value, torch.Tensor):
            yield key, value
        else:
            for name, t in value.items():
                yield f"{key}.{name}", t


def cache_bytes(cache) -> int:
    return sum(t.nbytes for _, t in _cache_tensors(cache))


def copy_cache(dst, src) -> None:
    """Write ``src``'s contents into ``dst``'s tensors (same shapes)."""
    targets = dict(_cache_tensors(dst))
    for path, t in _cache_tensors(src):
        targets[path].copy_(t)


@torch.inference_mode()
def check_replay(fleet: Fleet, steps: int = 32):
    """One request of the longest prompt, prefilled once: ``steps`` eager
    decode steps on one copy of the cache and ``steps`` replays of a
    captured serve step on another.  Any token that differs fails the run,
    as do graph launches per replay other than one decode step's; the
    largest difference in logits is printed.  Returns the launches per
    replay and a replay's ms (CUDA events, 10 replays)."""
    from repro_torch.launch.steps import build_serve_step

    model, rid = fleet.model, fleet.longest()
    tokens = fleet.prompts[rid][None]
    graph_cache = model.init_cache(1, fleet.max_len)
    t0 = time.perf_counter()
    step = build_serve_step(model, graph_cache)   # hands the cache back empty
    capture_s = time.perf_counter() - t0
    eager_cache = model.init_cache(1, fleet.max_len)
    logits, _ = fleet.prefill(rid, eager_cache)
    copy_cache(graph_cache, eager_cache)
    tok = logits.argmax(-1)
    step.tokens.copy_(tok)
    eager, replayed, worst = [], [], 0.0
    for _ in range(steps):
        logits, _ = model.decode_step(tok, eager_cache)
        tok = logits.argmax(-1)
        eager.append(int(tok[0, 0]))
        replayed.append(int(step()[0, 0]))
        worst = max(worst, (step.logits.float() - logits.float()).abs().max().item())
    log(f"{model.cfg.name} eager vs replay (S={tokens.shape[1]}, {steps} steps, "
        f"capture {capture_s:.3f} s, graph launches per replay "
        f"{json.dumps(step.launches)}): tokens equal "
        f"{sum(a == b for a, b in zip(eager, replayed))}/{steps}, largest "
        f"|logit difference| {worst:.4g}")
    if eager != replayed:
        raise AssertionError(f"{model.cfg.name}: replayed tokens {replayed} != "
                             f"eager {eager}")
    per_step = expected_launches(model, types.SimpleNamespace(
        prefills=0, decode_steps=1, prefill_lens=[]))
    if step.launches != per_step:
        raise AssertionError(f"{model.cfg.name}: a replay launches "
                             f"{step.launches}, want {per_step}")
    # the replay's time for the dry run's accounting (step 6c): 12 more
    # steps of the same request, CUDA events around each
    return step.launches, cuda_ms(step, iters=10, warmup=2)


@torch.inference_mode()
def check_head_width_model(head_dim: int) -> dict:
    """Step 2b: llama3.2-1b's config with ``head_dim`` set (its 32 query and
    8 kv heads, so the projections are 32 x head_dim wide), at 2 layers and
    otherwise full width, random bf16 weights (seed 0), on the card through
    ``TransformerLM.prefill`` and the captured decode step: the kernel
    route's prefill logits against the plain route's
    (``compare_prefill_logits``: 1e-3 in float32, the bf16 rule) and 16
    replays of ``build_serve_step`` against 16 eager steps
    (``check_replay``: tokens equal, a replay launches one decode step's
    kernels).  No config is added to a registry.  Returns the kernel
    launches of the run, counted from zero just before it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serving.live import make_prompts

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2,
                              head_dim=head_dim, name=f"llama3.2-1b@head_dim={head_dim}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(cfg, impl="kernel", device="cuda", dtype=torch.bfloat16,
                        generator=gen)
    prompts = make_prompts(cfg, n=2, min_len=200, max_len=700, seed=7, device="cuda")
    fleet = Fleet(model, prompts, None, 1024)
    ops.reset_launch_counts()
    compare_prefill_logits(fleet, n=2)
    check_replay(fleet, steps=16)
    torch.cuda.synchronize()
    launches = {"flash_attention": ops.flash_attention.launches,
                "flash_decode": ops.flash_decode.launches}
    log(f"{cfg.name}: 2 layers, d_model {cfg.d_model}, {cfg.num_heads} / "
        f"{cfg.num_kv_heads} heads, {model.num_params():,} params; kernel launches "
        f"in its prefills and eager steps {json.dumps(launches)}")
    if not all(launches.values()):
        raise AssertionError(f"{cfg.name}: a kernel of the path was not launched")
    del fleet, model
    torch.cuda.empty_cache()
    return launches


@torch.inference_mode()
def profile_serving(fleet: Fleet, decode_steps: int = 8) -> None:
    """Where a request's time goes: one prefill of the longest prompt and
    ``decode_steps`` decode steps, eager and as replays of the captured
    serve step, under torch.profiler (each window run once as the
    profiler's warm-up, then recorded).  Prints wall time, device busy time
    (kernel time summed) and the device's idle share, and the kernels that
    take the most device time; a window whose trace fails its checks three
    times is printed as not measured."""
    from repro_torch.launch.steps import build_serve_step

    model, rid = fleet.model, fleet.longest()
    tokens = fleet.prompts[rid][None]
    cache = model.init_cache(1, fleet.max_len)
    logits, cache = fleet.prefill(rid, cache)
    state = {"tok": logits.argmax(-1)}
    graph_cache = model.init_cache(1, fleet.max_len)
    step = build_serve_step(model, graph_cache)
    copy_cache(graph_cache, cache)
    step.tokens.copy_(state["tok"])

    def decode():
        for _ in range(decode_steps):
            logits, _ = model.decode_step(state["tok"], cache)
            state["tok"] = logits.argmax(-1)

    def replay():
        for _ in range(decode_steps):
            step()

    windows = {"prefill": lambda: fleet.prefill(
                   rid, model.init_cache(1, fleet.max_len)),
               "decode": decode, "decode, captured": replay}
    for phase, window in windows.items():
        try:
            events, wall_ms, clock = checked_profile(window, cpu=True)
        except ProfilerFailed as e:
            log(f"{model.cfg.name} profile {phase}: not measured ({e})")
            continue
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        n = 1 if phase == "prefill" else decode_steps
        log(f"{model.cfg.name} profile {phase} (S={tokens.shape[1]}, {n} call(s), "
            f"profiler on): "
            f"wall_ms={wall_ms / n:.3f} device_busy_ms={busy_ms / n:.3f} "
            f"idle_share={1 - busy_ms / wall_ms:.3f} "
            f"kernels_per_call={sum(e.count for e in events) / n:g} "
            f"profiler_clock_ratio={clock:.3f} top kernels per call: " +
            json.dumps({e.key[:60]: round(e.self_device_time_total / 1e3 / n, 4)
                        for e in top}))


# ---------------------------------------------------------------------------
# Phase 3: kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def sdpa_backend(*args, **kw) -> str:
    """The backend PyTorch's dispatcher picks for these
    ``scaled_dot_product_attention`` arguments (``torch._fused_sdp_choice``,
    a private helper: "unknown" where this build lacks it)."""
    from torch.nn.attention import SDPBackend

    choose = getattr(torch, "_fused_sdp_choice", None)
    return "unknown" if choose is None else SDPBackend(choose(*args, **kw)).name


def time_flash_attention_at(H: int, Kv: int, D: int, S: int = PREFILL_S,
                            causal: bool = True, prefix: int = 0,
                            label: str = "") -> dict:
    """flash_attention, bf16, B=1, S tokens (causal or bidirectional, the
    first ``prefix`` seen by every row under prefix-LM), at H query and Kv
    kv heads of width D: kernel, plain, SDPA (the library yardstick, never
    called by the port; a prefix-LM mask goes to it as a bool mask) and the
    bound (the larger of the unmasked pairs' products over the bf16
    tensor-core peak and the bytes over the HBM rate)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(13 + D)
    B = 1
    q = randn(rng, (B, S, H, D), torch.bfloat16)
    k = randn(rng, (B, S, Kv, D), torch.bfloat16)
    v = randn(rng, (B, S, Kv, D), torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < prefix)
    calls = {
        "kernel": lambda: fa.launch(q, k, v, causal=causal, prefix_len=prefix),
        "plain": lambda: fa.plain(q, k, v, causal=causal, prefix_len=prefix),
        "library": (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)) if prefix else
        (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)),
    }
    backend = (sdpa_backend(qt, kt, vt, attn_mask=mask, enable_gqa=True) if prefix
               else sdpa_backend(qt, kt, vt, is_causal=causal, enable_gqa=True))
    align = fa.row_alignment(q, k, v)
    ms, plain_ms, library_ms = (device_ms(f) for f in calls.values())
    call_ms = {k: cuda_ms(f) for k, f in calls.items()}
    queued = {k: queued_ms(calls[k]) for k in ("kernel", "library")}
    work = cost.flash_attention_work(B, H, Kv, S, S, D, 2, causal=causal,
                                     prefix=prefix)
    flops, nbytes = work.flops, work.bytes
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"flash_attention timing{f' {label}' if label else ''} [{card_line()}] "
        f"bf16 B={B} H={H} Kv={Kv} S={S} "
        f"D={D} {'causal' if causal else 'bidirectional'}"
        f"{f' prefix={prefix}' if prefix else ''} "
        f"({fa.kernel_form(torch.bfloat16, D, align)}, rows {align}-byte aligned): "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"(SDPA, {backend}) kernel/library={ms / library_ms:.2f} bound_ms={b_ms:.5f} "
        f"({b_by}) achieved {flops / ms / 1e9:.1f} TFLOP/s [device time, "
        f"torch.profiler]; back to back behind a spin kernel (CUDA events): "
        f"{json.dumps(queued)}; per call with host overhead (CUDA events): "
        f"{json.dumps(call_ms)}")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:121",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
    }


def time_flash_attention() -> dict:
    """llama3.2-1b's shape goes on the kernels line; qwen3-moe-30b's (H=32,
    Kv=4, D=128), zamba2-7b's (H=Kv=32, D=112), whisper-medium's
    encoder (H=Kv=16, D=64, bidirectional over 1500 frames),
    h2o-danube3-4b's (H=32, Kv=8, D=120) and paligemma-3b's (H=8, Kv=1,
    D=256; at S = 1024 causal and at its own prefill, 256 patches under the
    prefix-LM mask before 1024 tokens) are logged beside it."""
    time_flash_attention_at(QWEN_H, QWEN_KV, QWEN_D)
    time_flash_attention_at(ZAMBA_H, ZAMBA_KV, ZAMBA_D)
    time_flash_attention_at(WHISPER_H, WHISPER_KV, WHISPER_D, S=ENC_S,
                            causal=False)
    time_flash_attention_at(DANUBE_H, DANUBE_KV, DANUBE_D)
    time_flash_attention_at(PALI_H, PALI_KV, PALI_D)
    # paligemma's own prefill: its 256 image patches under the prefix-LM
    # mask before 1024 text tokens
    time_flash_attention_at(PALI_H, PALI_KV, PALI_D, S=PALI_PREFIX + PREFILL_S,
                            prefix=PALI_PREFIX)
    return time_flash_attention_at(MAIN_H, MAIN_KV, MAIN_D)


def time_flash_decode_at(H: int, Kv: int, D: int, S: int = DECODE_S,
                         n_valid: int = 600, label: str = "") -> dict:
    """flash_decode, bf16, B=1, S cache slots of which the first
    ``n_valid`` are valid (600 of 2048: the fleet's mid-decode occupancy),
    at H query and Kv kv heads of width D: kernel, plain, SDPA with a bool
    mask (the library yardstick, never called by the port) and the bound
    (the larger of the products over the bf16 tensor-core peak and the
    bytes that must move: q and the output, the mask, and the K/V rows of
    the valid slots, over the HBM rate)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(14 + D)
    B = 1
    q = randn(rng, (B, 1, H, D), torch.bfloat16)
    k = randn(rng, (B, S, Kv, D), torch.bfloat16)
    v = randn(rng, (B, S, Kv, D), torch.bfloat16)
    valid = make_valid(B, S, str(n_valid), rng)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = valid.bool()[:, None, None, :]
    calls = {
        "kernel": lambda: fd.launch(q, k, v, valid),
        "plain": lambda: fd.plain(q, k, v, valid),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True),
    }
    ms, plain_ms, library_ms = (device_ms(f, iters=20) for f in calls.values())
    call_ms = {k: cuda_ms(f, iters=50) for k, f in calls.items()}
    queued = {k: queued_ms(calls[k], iters=20) for k in ("kernel", "library")}
    work = cost.flash_decode_work(B, H, Kv, S, D, 2, n_valid)
    b_ms, b_by = bound_ms(work.flops, work.bytes)
    backend = sdpa_backend(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    # a kv head's query heads in group tiles, and past 256 its columns in
    # slices, each a block that reads the head's K/V tiles (K whole, V its
    # slice): the first from HBM (the bound), the rest from L2
    G = H // Kv
    align = fa.row_alignment(q[:, 0], k, v)
    tiles = -(-G // fd.group_tile(torch.bfloat16, D, G, align)) * fd.slices(D)
    log(f"flash_decode timing{f' {label}' if label else ''} [{card_line()}] bf16 "
        f"B={B} H={H} Kv={Kv} S={S} D={D} rows {align}-byte aligned "
        f"valid={n_valid} (G={G}: {tiles} block(s) a kv head of group tiles "
        f"and {fd.slices(D)} column slice(s), its K read {tiles} time(s), "
        f"{tiles - 1} of them from L2 and not in the "
        f"bound): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (SDPA, {backend}) kernel/library="
        f"{ms / library_ms:.2f} bound_ms={b_ms:.5f} ({b_by}) [device time, "
        f"torch.profiler]; back to back behind a spin kernel (CUDA events): "
        f"{json.dumps(queued)}; per call with host overhead (CUDA events): "
        f"{json.dumps(call_ms)}")
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:74",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
    }


def time_flash_decode() -> dict:
    """llama3.2-1b's shape goes on the kernels line; qwen3-moe-30b's (H=32,
    Kv=4, D=128), zamba2-7b's (H=Kv=32, D=112), whisper-medium's cross
    cache (H=Kv=16, D=64, 1500 slots, all valid) and self cache (448
    slots, the first 212 valid), h2o-danube3-4b's (H=32, Kv=8, D=120) and
    paligemma-3b's (H=8, Kv=1, D=256) are logged beside it."""
    time_flash_decode_at(QWEN_H, QWEN_KV, QWEN_D)
    time_flash_decode_at(ZAMBA_H, ZAMBA_KV, ZAMBA_D)
    time_flash_decode_at(WHISPER_H, WHISPER_KV, WHISPER_D, S=ENC_S,
                         n_valid=ENC_S)
    time_flash_decode_at(WHISPER_H, WHISPER_KV, WHISPER_D, S=WHISPER_SELF_S,
                         n_valid=212)
    time_flash_decode_at(DANUBE_H, DANUBE_KV, DANUBE_D)
    time_flash_decode_at(PALI_H, PALI_KV, PALI_D)
    return time_flash_decode_at(MAIN_H, MAIN_KV, MAIN_D)


def time_public_shapes() -> None:
    """Step 3, each of PUBLIC_SHAPES' attention in bf16: its prefill and a
    decode over 600 valid slots of 2,048, kernel, plain, SDPA (and the
    backend it picks) and bound, a line each (logged only: the kernels line
    keeps llama3.2-1b's); then WIDE_PUBLIC_SHAPES' the same (causal prefill
    at S = 1,024 where it has one)."""
    for name, H, Kv, D, S, causal in PUBLIC_SHAPES:
        time_flash_attention_at(H, Kv, D, S=S, causal=causal, label=name)
        time_flash_decode_at(H, Kv, D, label=name)
    for name, H, Kv, D, S in WIDE_PUBLIC_SHAPES:
        if S:
            time_flash_attention_at(H, Kv, D, S=S, label=name)
        time_flash_decode_at(H, Kv, D, label=name)


# the served models' attention shapes (H, Kv, D) the parent A/B times:
# llama3.2-1b, qwen3-moe-30b, zamba2-7b, h2o-danube3-4b, paligemma-3b
AB_SHAPES = [(MAIN_H, MAIN_KV, MAIN_D), (QWEN_H, QWEN_KV, QWEN_D),
             (ZAMBA_H, ZAMBA_KV, ZAMBA_D), (DANUBE_H, DANUBE_KV, DANUBE_D),
             (PALI_H, PALI_KV, PALI_D)]
AB_TIME_TOL = 0.03        # the served widths keep their times: at most 3 % slower


def phase_parent_ab(parent: Path) -> None:
    """``--parent DIR`` (a checkout of an earlier commit): its attention
    kernels against this tree's at the served widths, in one process.
    First both trees' flash_attention.cu and flash_decode.cu are compiled
    side by side, four nvcc at once, each timed (the build time before and
    after) and the served instantiations' registers compared
    (``compare_builds``).  Then, at AB_SHAPES, bf16 prefill (S = 1,024
    causal) and decode (600 of 2,048 slots) and the fp32 pair: outputs must
    be equal to the bit, and each bf16 call is timed in turns (parent,
    tree, tree, parent, twice; device time, ``torch.profiler``) with the tree's
    mean over the parent's printed and held to AB_TIME_TOL (logged, not
    failed: a few microseconds' kernels).  The parent's decode is called
    with this tree's arguments, of which it reads all but the last."""
    import ctypes
    import subprocess
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    out = Path(tempfile.mkdtemp(prefix="parent_ab_"))
    jobs = {}
    t0 = time.perf_counter()
    for who, csrc in (("parent", parent / "src/repro_torch/kernels/csrc"),
                      ("tree", build.CSRC)):
        for name in ("flash_attention", "flash_decode"):
            with open(out / f"{who}_{name}.log", "w") as log_file:
                jobs[who, name] = subprocess.Popen(
                    [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                     str(out / f"{who}_{name}.so"), str(csrc / f"{name}.cu")],
                    stdout=log_file, stderr=subprocess.STDOUT)
    seconds = {}
    pending = dict(jobs)
    while pending:
        for key, proc in list(pending.items()):
            if proc.poll() is not None:
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed for {key}")
                seconds[key] = time.perf_counter() - t0
                del pending[key]
        time.sleep(0.05)
    log("parent A/B build (four nvcc at once): " + ", ".join(
        f"{who} {name} {t:.1f} s" for (who, name), t in seconds.items()))
    compare_builds(out)
    tree_fns = {"flash_attention": fa._kernel_fn(), "flash_decode": fd._kernel_fn()}
    parent_fns = {}
    for name, fn in tree_fns.items():
        pf = getattr(ctypes.CDLL(str(out / f"parent_{name}.so")), f"{name}_fwd")
        pf.argtypes, pf.restype = fn.argtypes, fn.restype
        parent_fns[name] = pf
    mods = {"flash_attention": fa, "flash_decode": fd}

    def use(who):
        for name, mod in mods.items():
            mod._fn = (parent_fns if who == "parent" else tree_fns)[name]

    rng = np.random.default_rng(29)
    try:
        for H, Kv, D in AB_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                q = randn(rng, (1, PREFILL_S, H, D), dtype)
                k = randn(rng, (1, PREFILL_S, Kv, D), dtype)
                v = randn(rng, (1, PREFILL_S, Kv, D), dtype)
                qd = randn(rng, (1, 1, H, D), dtype)
                kd = randn(rng, (1, DECODE_S, Kv, D), dtype)
                vd = randn(rng, (1, DECODE_S, Kv, D), dtype)
                valid = make_valid(1, DECODE_S, "600", rng)
                calls = {"flash_attention": lambda: fa.launch(q, k, v),
                         "flash_decode": lambda: fd.launch(qd, kd, vd, valid)}
                for name, call in calls.items():
                    outs = {}
                    for who in ("parent", "tree"):
                        use(who)
                        outs[who] = call()
                    torch.cuda.synchronize()
                    # bit for bit: NaN-free outputs of the same kernels
                    same = torch.equal(outs["parent"], outs["tree"])
                    diff = (outs["parent"].float() - outs["tree"].float()).abs().max()
                    line = (f"parent A/B {name} {str(dtype)[6:]} H={H} Kv={Kv} "
                            f"D={D}: outputs equal to the bit {same} (max abs "
                            f"diff {diff.item():.3g})")
                    if dtype == torch.bfloat16:
                        ms = {"parent": [], "tree": []}
                        for who in ("parent", "tree", "tree", "parent") * 2:
                            use(who)
                            ms[who].append(device_ms(call, iters=20))
                        ratio = sum(ms["tree"]) / sum(ms["parent"])
                        line += (f"; device ms (torch.profiler) parent "
                                 f"{ms['parent']} tree {ms['tree']} "
                                 f"[{card_line()}]: tree / parent {ratio:.4f}, "
                                 f"at most {AB_TIME_TOL:.0%} slower "
                                 f"{ratio <= 1 + AB_TIME_TOL}")
                    log(line)
                    # the served widths keep their code in both dtypes
                    if not same:
                        raise AssertionError(f"{name} {dtype} at D={D} differs "
                                             "from the parent's kernel")
    finally:
        use("tree")


def ptxas_registers(path: Path) -> dict:
    """Each entry function's (registers, full mangled name) in an ``nvcc
    -Xptxas -v`` log, by its mangled name without the anonymous namespace
    (which carries a hash of the file)."""
    regs, entry, full = {}, None, None
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            full = m.group(1)
            entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", full)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = (int(m.group(1)), full)
    return regs


def sass(lib: Path, entry: str) -> list:
    """The SASS of kernel ``entry`` in library ``lib`` (``cuobjdump -sass
    -fun``, beside nvcc), the lines that carry an encoding alone
    (address, instruction and both halves of each 128-bit word)."""
    import subprocess

    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", "-fun", entry, str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return [line.strip() for line in text.splitlines()
            if re.search(r"/\* 0x[0-9a-f]{16} \*/", line)]


# the served bf16 instantiations, by their template arguments in the
# parent's names: the prefill's (tile width, head width) and the decode's
# (class, head width) at a nonzero head width
SERVED_ENTRY = re.compile(r"(flash_attention_(mma|ws)|flash_decode_kernelI13__nv_bfloat16)"
                          r"I?Li(\d+)ELi([1-9]\d*)E")


def compare_builds(out: Path) -> None:
    """The parent's and this tree's register counts of every entry both
    builds have (this tree's names lose their last template argument,
    the copy mode: 0 or false for the whole-chunk copies),
    and the served instantiations' SASS: their registers must be
    unchanged, and whether their code is the same instruction for
    instruction is printed."""
    for name in ("flash_attention", "flash_decode"):
        parent = ptxas_registers(out / f"parent_{name}.log")
        tree = {re.sub(r"EL[bi]0EEEv", "EEEv", k): v
                for k, v in ptxas_registers(out / f"tree_{name}.log").items()}
        both = sorted(set(parent) & set(tree))
        served = [e for e in both if SERVED_ENTRY.search(e)]
        moved = [e for e in served if parent[e][0] != tree[e][0]]
        same, diffs = 0, []
        for e in served:
            a = sass(out / f"parent_{name}.so", parent[e][1])
            b = sass(out / f"tree_{name}.so", tree[e][1])
            same += a == b
            if a != b:      # where they differ, the first lines that do
                pairs = [(x, y) for x, y in zip(a, b) if x != y]
                diffs.append(f"{e}: {len(pairs)} of {len(a)} / {len(b)} lines differ, "
                             f"first {pairs[:2]}")
        log(f"parent A/B registers {name}: " + "; ".join(
            f"{e}: parent {parent[e][0]} tree {tree[e][0]}" for e in both)
            + f"; served instantiations {len(served)}, registers unchanged "
            f"{len(served) - len(moved)}, SASS identical (cuobjdump -sass) {same}"
            + "".join(f"; {d}" for d in diffs))
        if len(served) != 5 or moved:
            raise AssertionError(f"{name}: the served instantiations' registers "
                                 f"moved or were not found ({moved or served})")


def time_selective_scan() -> dict:
    from repro_torch.kernels import cost
    from repro_torch.kernels import selective_scan as ss

    rng = np.random.default_rng(16)
    B, Q, C, N = 1, SCAN_Q, SCAN_C, SCAN_N
    a, b = scan_inputs(rng, (B, Q, C, N), torch.float32)
    h0 = randn(rng, (B, C, N), torch.float32)
    calls = {
        "kernel": lambda: ss.launch(a, b, h0),
        "plain": lambda: ss.plain(a, b, h0),
    }
    ms, plain_ms = (device_ms(f) for f in calls.values())
    call_ms = {k: cuda_ms(f) for k, f in calls.items()}
    work = cost.selective_scan_work(B, Q, C, N, a.element_size())
    b_ms, b_by = bound_ms(work.flops, work.bytes, PEAK_FP32_FLOPS)
    log(f"selective_scan timing f32 B={B} Q={Q} C={C} N={N}: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms=null (no single PyTorch call "
        f"computes this recurrence) bound_ms={b_ms:.5f} ({b_by}) [device time, "
        f"torch.profiler]; per call with host overhead (CUDA events): "
        f"{json.dumps(call_ms)}")
    return {
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:42",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }


def routed_rows(rng, n_tokens: int, C: int) -> torch.Tensor:
    """The rows ``moe_apply`` hands the grouped matmul for ``n_tokens``
    tokens routed top-8 over qwen3-moe-30b's 128 experts by a random router
    (``route_topk`` of unit-normal logits): each expert's routed (token, k)
    pairs clamped to the capacity C, int32 on the card."""
    from repro_torch.models.moe import route_topk

    idx = route_topk(randn(rng, (n_tokens, GMM_E), torch.float32), 8)[1]
    counts = torch.bincount(idx.reshape(-1), minlength=GMM_E)
    return counts.clamp(max=C).to(torch.int32)


def time_moe_gmm_at(C: int, n_tokens: int) -> dict:
    """moe_gmm at qwen3-moe-30b's (128, C, 2048) x (128, 2048, 768), bf16,
    with the rows of a real routing of ``n_tokens`` tokens (x zero past
    them, as the dispatch buffer is): kernel, the kernel without rows (every
    expert read), plain, ``torch.bmm`` on the whole buffer (the library
    yardstick, the same output, never called by the port) and the bound
    (the larger of bytes over the HBM rate and the occupied rows' products
    over the bf16 tensor-core peak; the bytes are the occupied experts'
    weights, the occupied rows of x, and all of y)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import moe_gmm as gmm

    rng = np.random.default_rng(18 + C)
    E, D, F = GMM_E, GMM_D, GMM_F
    x, rows = dispatch_x(rng, C, D, torch.bfloat16, routed_rows(rng, n_tokens, C))
    w = randn(rng, (E, D, F), torch.bfloat16)
    xc = x.contiguous()
    calls = {
        "kernel": lambda: gmm.launch(x, w, rows),
        "plain": lambda: gmm.plain(x, w, rows),
        "library": lambda: torch.bmm(xc, w),
        "kernel, every expert": lambda: gmm.launch(x, w),
    }
    ms, plain_ms, library_ms, full_ms = (device_ms(f) for f in calls.values())
    call_ms = {k: cuda_ms(f) for k, f in calls.items()}
    queued = {k: queued_ms(calls[k]) for k in ("kernel", "library",
                                               "kernel, every expert")}
    n_rows = int(rows.sum())                 # one read for the bound's count
    n_occ = int((rows > 0).sum())
    work = cost.moe_gmm_work(E, C, D, F, 2, n_rows, n_occ)
    nbytes = work.bytes
    b_ms, b_by = bound_ms(work.flops, nbytes)
    full = cost.moe_gmm_work(E, C, D, F, 2)
    full_b_ms, _ = bound_ms(full.flops, full.bytes)
    log(f"moe_gmm timing bf16 E={E} C={C} D={D} F={F}, rows of {n_tokens} "
        f"routed token(s): {n_occ} experts occupied, {n_rows} rows: "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"(torch.bmm, every expert) kernel/library={ms / library_ms:.2f} "
        f"bound_ms={b_ms:.5f} ({b_by}) achieved {nbytes / ms / 1e6:.1f} GB/s; "
        f"without rows (every expert): kernel_ms={full_ms:.4f} bound_ms="
        f"{full_b_ms:.5f} [device time, torch.profiler]; back to back behind "
        f"a spin kernel (CUDA events): {json.dumps(queued)}; per call with "
        f"host overhead (CUDA events): {json.dumps(call_ms)}")
    return {
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:42",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
    }


def time_moe_gmm() -> dict:
    """The decode shape (one token) goes on the kernels line (the main path
    launches it there most); the S = 975 prefill shape is logged beside
    it."""
    time_moe_gmm_at(GMM_PREFILL_C, 975)
    return time_moe_gmm_at(GMM_DECODE_C, 1)


# ---------------------------------------------------------------------------
# Phase 3b: the scenario engine's data plane over the reference's matrix
# ---------------------------------------------------------------------------


SCENARIO_EXACT = ("status", "rep", "a_ptr", "run_n", "q_cnt", "n_retried",
                  "overflow")
SCENARIO_FLOAT = ("e2e", "disp_t", "start_t", "fin_t")


def float_diff(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want|, with equal infinities counted as equal and an
    infinity against a finite value as an infinite difference."""
    with np.errstate(invalid="ignore"):       # inf - inf where both agree
        diff = np.where(got == want, 0.0, np.abs(got - want))
    return float(diff.max(initial=0.0))


#: a result's fields held against another's: counts exact, costs to 1e-9,
#: availability to 1e-12, latency percentiles and mean to 1e-6
RESULT_COUNTS = ("n_requests", "n_completed", "n_failed", "n_retried_requests",
                 "n_preemptions", "n_launch_failures")
RESULT_TOL = {"total_cost": 1e-9, "spot_cost": 1e-9, "od_cost": 1e-9,
              "cost_vs_ondemand": 1e-9, "availability": 1e-12,
              "p50_s": 1e-6, "p90_s": 1e-6, "p99_s": 1e-6, "mean_s": 1e-6}


def result_fields(res) -> dict:
    """The fields of a ``ServingResult`` that ``check_result`` compares."""
    return {**{k: getattr(res, k) for k in RESULT_COUNTS},
            **{k: getattr(res, k) for k in ("total_cost", "spot_cost",
                                            "od_cost", "cost_vs_ondemand",
                                            "availability")},
            "mean_s": float(res.latencies_s.mean()),
            **{f"p{q}_s": res.pct(q) for q in (50, 90, 99)}}


def check_result(where: str, got: dict, want: dict, tols=None) -> None:
    """``got`` against ``want`` on ``want``'s keys, at ``tols`` (default
    ``RESULT_TOL``; counts exact); NaN equals NaN (no completions in both)."""
    tols = RESULT_TOL if tols is None else tols
    for k, w in want.items():
        tol = tols.get(k, 0)
        g = got[k]
        if not (g == w or (w != w and g != g) or abs(g - w) <= tol):
            raise AssertionError(f"{where}: {k} {g!r} vs {w!r} "
                                 f"(tolerance {tol})")


def check_recorded_result(res, cell) -> None:
    """One cell of the matrix against the reference oracle's recorded
    result, at ``RESULT_TOL``."""
    where = f"{cell['policy']} seed {cell['seed']}"
    if res is None:
        raise AssertionError(f"{where}: the lane overflowed")
    check_result(f"{where} vs recorded", result_fields(res), cell["result"])


def check_oracle_and_fallback(oracle_results) -> None:
    """One ``run_cells`` call on the card at the smallest queue pool the
    kernel takes (one cell a slot), where the quick matrix's lanes
    overflow: every overflowed lane must come back as the oracle's result,
    to the bit."""
    from repro_torch.serving.torchengine import engine as teng
    from repro_torch.serving.torchengine import recorded

    cells = recorded.spec_matrix(n_seeds=4)
    t0 = time.perf_counter()
    results = teng.run_cells([c.engine for c in cells],
                             [c.duration_s for c in cells], queue_capacity=1)
    wall_s = time.perf_counter() - t0
    fell = [c.engine.fell_back for c in cells]
    if not any(fell):
        raise AssertionError("scenario fallback: no lane overflowed a pool of 1")
    for cell, res, want, f in zip(cells, results, oracle_results, fell):
        if not f:
            continue
        for fld in dataclasses.fields(want):
            a, b = getattr(res, fld.name), getattr(want, fld.name)
            if fld.name == "obs":
                # the rerun's own recorder: the oracle's events, once
                a, b = a.records(), b.records()
            same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                    else a == b)
            if not same:
                raise AssertionError(f"scenario fallback {cell.labels}: "
                                     f"{fld.name} {a!r} != oracle {b!r}")
    log(f"scenario fallback on the card: run_cells over the quick matrix's "
        f"{len(cells)} cells at a queue pool of 1: {sum(fell)} of {len(cells)} "
        f"lanes overflowed and were rerun on the port's oracle, each equal to "
        f"the oracle's result field for field; {wall_s:.4f} s wall (one "
        f"scenario_scan launch and {sum(fell)} oracle runs)")


def phase_scenario() -> dict:
    """The reference benchmark's 96-cell matrix (benchmarks/jax_engine.py:
    SpotHedge and even_spread on aws-1, 48 seeds, llama3.2-1b on
    g5.48xlarge, Poisson 1 request/s for one hour) built by the port from
    the recorded spec alone, its control plane (phase A) run on the host
    by the port and held against the reference's recorded planes, its data
    plane run on the card through ``run_cells`` (one shape group, one
    ``scenario_scan`` launch), held against the plain version on the CPU on
    the same 96 lanes and against the reference oracle's recorded results,
    then timed.  The port's oracle then runs the quick matrix's 8 cells, and
    one ``run_cells`` call overflows lanes and reruns them on it."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import ops
    from repro_torch.kernels import scenario_scan as scn
    from repro_torch.serving.engine import VectorizedServingEngine
    from repro_torch.serving.torchengine import engine as teng
    from repro_torch.serving.torchengine import recorded
    from repro_torch.serving.torchengine.kernel import LANE_KEYS

    # phase A on the host: the port's own cluster simulator, policies and
    # autoscaler, each cell's plane against the reference's recording
    t0 = time.perf_counter()
    matrix = recorded.spec_matrix()
    build_s = time.perf_counter() - t0
    cells = recorded.recorded_cells()
    planes = recorded.recorded_planes()
    per_cell = []
    t0 = time.perf_counter()
    for c in matrix:
        t1 = time.perf_counter()
        c.engine.record_schedule(c.duration_s)
        per_cell.append(time.perf_counter() - t1)
    phase_a_s = time.perf_counter() - t0
    scheds = [c.engine.schedule for c in matrix]
    for c, cell, sched in zip(matrix, cells, scheds):
        if (c.labels["policy"], c.labels["seed"]) != (cell["policy"], cell["seed"]):
            raise AssertionError(f"scenario cell {c.labels} is not the recording's "
                                 f"{cell['policy']} seed {cell['seed']}")
        plane = recorded.plane_of(sched)
        want = planes[c.labels["policy"]]
        bad = [k for k in want if plane.get(k) != want[k]]
        if bad or set(plane) != set(want):
            raise AssertionError(f"scenario phase A {c.labels}: plane fields {bad} "
                                 "differ from the reference's recording")
    log(f"scenario phase A on the host (the port's cluster simulator, policies "
        f"and autoscaler): {len(matrix)} cells built from the recorded spec in "
        f"{build_s:.4f} s, their control planes recorded in {phase_a_s:.4f} s "
        f"wall (per cell: mean {1e3 * np.mean(per_cell):.3f} ms, min "
        f"{1e3 * min(per_cell):.3f} ms, max {1e3 * max(per_cell):.3f} ms); every "
        f"cell's plane equals the reference's recorded plane of its policy, "
        f"field for field")
    log(f"scenario matrix: {len(scheds)} cells ({len(set(map(teng.group_key, scheds)))} "
        f"shape group): N={min(c.n for c in scheds)}-"
        f"{max(c.n for c in scheds)} requests, G={scheds[0].grid.n_points} "
        f"sub-steps over W={scheds[0].grid.ticks} windows, R="
        f"{sorted({c.n_slots for c in scheds})} slots, E="
        f"{sorted({c.n_events for c in scheds})} kill events")
    key, lanes, grid = teng.pack_group(scheds)
    kw = dict(Q=key.Q, C=key.C, amax=key.AMAX, lb_rr=key.lb_rr,
              expire_on=key.expire_on, trace_on=key.trace_on)

    def inputs(device):
        return ([torch.from_numpy(lanes[k]).to(device) for k in LANE_KEYS]
                + [torch.from_numpy(a).to(device) for a in grid])

    on_card = inputs("cuda")
    scn.launch(*on_card, **kw)            # loads the library; not counted
    torch.cuda.synchronize()

    # the main path: counts zeroed just before, read just after
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = []
    results = teng.run_cells([c.engine for c in matrix],
                             [c.duration_s for c in matrix], outputs=outs)
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    want_launches = dict.fromkeys(launches, 0)
    want_launches["scenario_scan"] = 1
    if launches != want_launches:
        raise AssertionError(f"scenario launches {launches} != {want_launches}")
    if any(c.engine.fell_back for c in matrix):
        raise AssertionError("scenario: a lane of the matrix overflowed")
    for res, cell in zip(results, cells):
        check_recorded_result(res, cell)
    log(f"scenario run_cells on the card: {len(scheds)} cells in "
        f"{wall_s:.4f} s wall ({len(scheds) / wall_s:.1f} cells/s; packing, "
        f"copies and assembly included), launches {json.dumps(launches)}; all "
        f"{len(scheds)} cells equal the recorded reference results (counts "
        f"exact, costs 1e-9, availability 1e-12, latency p50/p90/p99/mean "
        f"1e-6), no lane overflowed")

    # the kernel against its plain version (on the CPU), all 96 lanes
    got = {k: v.cpu().numpy() for k, v in scn.launch(*on_card, **kw).items()}
    t0 = time.perf_counter()
    want = {k: v.numpy() for k, v in scn.plain(*inputs("cpu"), **kw).items()}
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for k in SCENARIO_EXACT:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"scenario_scan {k}: kernel and plain differ "
                                 f"in {int((got[k] != want[k]).sum())} entries")
    errs = {k: float_diff(got[k], want[k]) for k in SCENARIO_FLOAT}
    err = max(errs.values())
    if not err <= SCENARIO_TOL:
        raise AssertionError(f"scenario_scan float outputs differ from plain: "
                             f"{errs} (tolerance {SCENARIO_TOL})")
    for i, out in enumerate(outs):     # the main path's launch gave the same
        for k in SCENARIO_EXACT + SCENARIO_FLOAT:
            if not np.array_equal(out[k], got[k][i]):
                raise AssertionError(f"scenario lane {i}: {k} of run_cells "
                                     "differs from a second launch")
    log(f"scenario_scan vs plain (CPU), all {len(scheds)} lanes: "
        f"{', '.join(SCENARIO_EXACT)} equal; max |diff| {json.dumps(errs)} "
        f"(tolerance {SCENARIO_TOL}); a second launch repeats run_cells' "
        f"outputs exactly")

    # the paper's metrics, per policy (means over the policy's 48 seeds)
    for pol in dict.fromkeys(c.policy_name for c in scheds):
        rs = [r for r in results if r.policy == pol]
        stats = {
            "cost_vs_ondemand": np.mean([r.cost_vs_ondemand for r in rs]),
            "availability": np.mean([r.availability for r in rs]),
            "failure_rate": np.mean([r.failure_rate for r in rs]),
            **{f"p{q}_s": np.mean([r.pct(q) for r in rs]) for q in (50, 90, 99)},
        }
        log(f"scenario policy {pol} over {len(rs)} seeds (means): " + " ".join(
            f"{k}={v:.6g}" for k, v in stats.items()))

    # timing: the kernel's device time beside the walls measured above
    kernel = lambda: scn.launch(*on_card, **kw)  # noqa: E731
    ms = device_ms(kernel, iters=5, warmup=1)
    ev_ms = cuda_ms(kernel, iters=5, warmup=1)
    # the lanes run side by side, one block each: 8 lanes take about as long
    # as 96 when a lane's chain of dependent steps is what costs
    n_lane = len(LANE_KEYS)
    few = [t[:8] for t in on_card[:n_lane]] + on_card[n_lane:]
    few_ms = cuda_ms(lambda: scn.launch(*few, **kw), iters=5, warmup=1)
    nbytes = cost.scenario_scan_bytes(scheds, got, key)
    # float64 work the data asks for: a finish time (4 operations) per start
    # and a latency and its deadline test (3) per resolved request
    n_done = int((got["status"] > 0).sum())
    flops = 7.0 * n_done
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_FP64_FLOPS)
    smem, pend_cap, tape_cap = scn.smem_plan(key.R, key.C, key.Q, key.NREG,
                                             key.trace_on)
    log(f"scenario_scan timing, {len(scheds)} lanes x {key.G} sub-steps "
        f"(N={key.N}, R={key.R}, Q={key.Q}, C={key.C}, trace_on={key.trace_on}): "
        f"kernel_ms={ms:.4f} [device time, torch.profiler] kernel_ms={ev_ms:.4f} "
        f"[CUDA events, one launch at a time] plain_ms={plain_ms:.1f} [the plain "
        f"version on the CPU, host clock] library_ms=null (no PyTorch call "
        f"computes it) bound_ms={b_ms:.6f} ({b_by}: {nbytes / 1e6:.3f} MB the "
        f"data needs read and written, over the HBM rate; loose: the work is a recurrence of {key.G} "
        f"dependent steps a lane); per sub-step {1e3 * ms / key.G:.3f} us; "
        f"the first 8 lanes alone {few_ms:.4f} ms [CUDA events]; phase B wall "
        f"{1e3 * wall_s:.2f} ms; resources: one warp and {smem} bytes of shared "
        f"memory a block (pending ring share {pend_cap}, tape window "
        f"{tape_cap}), ptxas: {ptxas_resources('scenario_scan')}")

    # the port's oracle on the host, the quick matrix's 8 cells
    quick = recorded.spec_matrix(n_seeds=4)
    quick_cells = recorded.recorded_cells(n_seeds=4)
    t0 = time.perf_counter()
    oracle = [VectorizedServingEngine.run(c.engine, c.duration_s) for c in quick]
    oracle_s = time.perf_counter() - t0
    for res, cell in zip(oracle, quick_cells):
        check_recorded_result(res, cell)
    log(f"scenario oracle on the host (the port's VectorizedServingEngine): "
        f"{len(quick)} cells of the quick matrix in {oracle_s:.4f} s wall "
        f"({1e3 * oracle_s / len(quick):.3f} ms a cell), each equal to the "
        f"reference oracle's recorded result")
    check_oracle_and_fallback(oracle)
    return {
        "name": "scenario_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scenario_scan.cu",
        "replaces": "src/repro/serving/jaxengine/kernel.py:112",
        "launches": launches["scenario_scan"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }


SERVED = ("llama3.2-1b", "falcon-mamba-7b", "qwen3-moe-30b", "zamba2-7b",
          "whisper-medium")
# the dense archs at the head widths 256 and 120, and the two at 128 with
# their own paths (QKV bias, the parallel block), served after SERVED; the
# dry run keeps to SERVED
WIDE_SERVED = ("paligemma-3b", "h2o-danube3-4b", "qwen2.5-3b", "command-r-35b")
PROFILE_OUT = ROOT / "chiprun_out" / "profiles" / "cuda-compiled.json"
# the fleets whose KV cache the token model's bytes are held against
KV_CHECKED = ("llama3.2-1b", "qwen3-moe-30b", *WIDE_SERVED)


def phase_profiles() -> None:
    """The step-time profiles of every arch the repo has (``--models
    all``: the ten of ``ARCH_IDS``, phi3.5-moe-42b's kernels too, though
    the model does not fit one card) on the ``h100`` instance, through the
    port's CLI (the reference's cases: prefill 256, cache 512, batch 1;
    each kernel call timed with CUDA events, best of the repeats), written
    to ``PROFILE_OUT`` and reloaded with the port's schema.  Both shares
    must lie in (0, 1.05]."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.profiles import run as profiles_run
    from repro_torch.profiles.schema import ProfileTable

    if PROFILE_OUT.exists():
        PROFILE_OUT.unlink()          # this run's rows only, none merged in
    rc = profiles_run.main(["--models", "all", "--itype", "h100",
                            "--device", "cuda", "--out", str(PROFILE_OUT)])
    if rc:
        raise AssertionError(f"repro_torch.profiles.run exited {rc}")
    table = ProfileTable.load(str(PROFILE_OUT))
    want = sorted(f"{m}|H100" for m in ARCH_IDS)
    if sorted(table.entries) != want:
        raise AssertionError(f"profile rows {sorted(table.entries)} != {want}")
    for key, e in sorted(table.entries.items()):
        log(f"profile row {key}: mfu_prefill={e.mfu_prefill:.6g} "
            f"mbu_decode={e.mbu_decode:.6g} prefill_wall_ms="
            f"{1e3 * e.prefill_wall_s:.4f} ({e.prefill_tokens} tokens, "
            f"{e.prefill_flops:.4g} FLOP) decode_wall_ms="
            f"{1e3 * e.decode_wall_s:.4f} ({e.decode_cache_tokens} cached, "
            f"{e.decode_bytes:.4g} B) backend={e.backend} mode={e.mode} "
            f"torch={e.torch_version} device={e.device!r}")
        for share in ("mfu_prefill", "mbu_decode"):
            if not 0 < getattr(e, share) <= 1.05:
                raise AssertionError(f"{key}: {share} = {getattr(e, share)} "
                                     "outside (0, 1.05]")


# ---------------------------------------------------------------------------
# The front door: Service, ScenarioSuite and the serve CLI, phase B on the card
# ---------------------------------------------------------------------------

# tests/test_golden.py's constants (aws-1 at 2 h, Poisson 0.5/s seed 17,
# constant N_Tar=3, g5.48xlarge, concurrency 2, timeout 60 s), held to its
# abs 1e-6 with counts exact; copied because this script imports no repro
GOLDEN = {
    "spothedge": dict(n_requests=3571, n_completed=3501, n_failed=70,
                      n_preemptions=1, n_launch_failures=0,
                      total_cost=50.733135, p50_s=0.703607, p99_s=1.692754,
                      availability=0.972917),
    "even_spread": dict(n_requests=3571, n_completed=3501, n_failed=70,
                        n_preemptions=1, n_launch_failures=12,
                        total_cost=28.109217, p50_s=0.703671, p99_s=1.692754,
                        availability=0.920833),
    "ondemand_only": dict(n_requests=3571, n_completed=3501, n_failed=70,
                          n_preemptions=0, n_launch_failures=0,
                          total_cost=92.910000, p50_s=0.703671,
                          p99_s=1.692754, availability=0.972917),
}


def golden_spec(policy: str) -> dict:
    return {
        "name": f"golden-{policy}", "model": "llama3.2-1b", "trace": "aws-1",
        "resources": {"instance_type": "g5.48xlarge"},
        "replica_policy": {"name": policy},
        "autoscaler": {"kind": "constant", "target": 3},
        "workload": {"kind": "poisson", "rate_per_s": 0.5, "seed": 17},
        "sim": {"duration_hours": 2.0, "timeout_s": 60.0, "concurrency": 2,
                "drain_s": 300.0, "seed": 0, "engine": "jax"},
    }


# README.md's quickstart service: command-r-35b on g5.48xlarge, aws-3 in
# three regions, SpotHedge with N_Extra 2, the load autoscaler, Arena at 2/s;
# it names no sim.engine, so Service's default (phase B on the card) runs it
QUICKSTART = {
    "name": "chatbot", "model": "command-r-35b", "trace": "aws-3",
    "resources": {"instance_type": "g5.48xlarge",
                  "any_of": [{"region": "us-east-1"}, {"region": "us-east-2"},
                             {"region": "us-west-2"}]},
    "replica_policy": {"name": "spothedge", "overprovision": 2,
                       "dynamic_fallback": True},
    "autoscaler": {"kind": "load", "target": 4, "qps_per_replica": 0.8},
    "workload": {"kind": "arena", "rate_per_s": 2.0},
    "sim": {"duration_hours": 4.0},
}

# llama3.2-1b on the H100 instance, priced by this run's profile row: Arena
# at 0.1 requests/s, about 0.2 of the profile-priced capacity of 3 replicas
# at concurrency 4, so the queues stay inside the 256-cell pool
H100_SERVICE = {
    "name": "llama-h100", "model": "llama3.2-1b", "trace": "gcp-1",
    "resources": {"instance_type": "h100",
                  "any_of": [{"region": "us-central1"}, {"region": "us-west1"}]},
    "replica_policy": {"name": "spothedge"},
    "autoscaler": {"kind": "constant", "target": 3},
    "workload": {"kind": "arena", "rate_per_s": 0.1, "seed": 11},
    "latency": {"source": "profile", "profile": str(PROFILE_OUT)},
    "sim": {"duration_hours": 2.0, "timeout_s": 100.0, "concurrency": 4,
            "engine": "jax"},
}

# examples/sweep.yaml's grid (2 policies x aws-1 / gcp-1) with a workloads
# axis: 12 cells
SWEEP = {
    "name": "sweep-demo", "model": "llama3.2-1b", "trace": "aws-1",
    "resources": {"instance_type": "g5.48xlarge"},
    "autoscaler": {"kind": "constant", "target": 3},
    "workload": {"kind": "poisson", "rate_per_s": 0.6, "seed": 3},
    "sim": {"duration_hours": 2.0, "timeout_s": 60.0, "concurrency": 2,
            "drain_s": 300.0, "engine": "jax"},
    "sweep": {"policies": ["spothedge", "even_spread"],
              "traces": ["aws-1", "gcp-1"],
              "workloads": ["poisson", "arena", "maf"]},
}


def counted(fn):
    """``fn()`` with the launch counts zeroed just before and read just
    after: (its result, the counts, host wall seconds)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}, wall


def check_scan_launches(where: str, launches: dict, n: int) -> None:
    want = dict.fromkeys(launches, 0)
    want["scenario_scan"] = n
    if launches != want:
        raise AssertionError(f"{where}: launches {launches} != {want}")


def metrics_line(res) -> str:
    return (f"p50/p90/p99 {res.pct(50):.6g}/{res.pct(90):.6g}/"
            f"{res.pct(99):.6g} s, failure rate {res.failure_rate:.6g}, "
            f"availability {res.availability:.6g}, cost vs on-demand "
            f"{res.cost_vs_ondemand:.6g} (${res.total_cost:.6g})")


def on_card(spec: dict, where: str):
    """One service through ``Service`` with its defaults, so phase B on the
    card, counted: one ``scenario_scan`` launch, and the lane must not have
    overflowed into an oracle rerun.  Returns the ``Service`` (run), its
    launches and its wall."""
    from repro_torch.service import Service

    svc = Service(spec)
    _, launches, wall = counted(svc.run)
    check_scan_launches(where, launches, 1)
    if svc.status()["oracle_rerun"]:
        raise AssertionError(f"{where}: the lane overflowed and was rerun "
                             "on the oracle")
    return svc, launches, wall


def on_card_and_host(spec: dict, where: str):
    """``on_card``, then the same service on the host engine; the two must
    be equal at ``RESULT_TOL``.  Returns the card's ``Service`` (run), the
    host result, the card's launches and both walls."""
    from repro_torch.service import Service

    svc, launches, wall = on_card(spec, where)
    t0 = time.perf_counter()
    host = Service(spec, engine="vector").run()
    host_s = time.perf_counter() - t0
    check_result(f"{where}, card vs host", result_fields(svc.result),
                 result_fields(host))
    return svc, host, launches["scenario_scan"], (wall, host_s)


def serve_in_process(argv) -> tuple:
    """``repro_torch.launch.serve.main(argv)`` with the launch counts zeroed
    and read around it, its standard output captured and logged: (exit
    code, launches, wall, output)."""
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, launches, wall = counted(lambda: serve.main(argv))
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"service CLI | {line}")
    return rc, launches, wall, out


def phase_service() -> dict:
    """SkyServe's front door on the port, through the entry points a user
    calls: ``Service`` (the golden specs, the README's quickstart, a
    llama3.2-1b service on the H100 priced by this run's profile row),
    ``ScenarioSuite`` over a 12-cell sweep and the serve CLI in-process,
    each with phase B on the card (counted), each held against the host
    engine or the golden constants.  Returns the launches by part."""
    import warnings

    from repro_torch.experiments import ScenarioSuite
    from repro_torch.profiles.schema import ProfileTable
    from repro_torch.serving.latency import ProfiledLatencyModel
    from repro_torch.service import Service

    parts = {}
    # (a) the golden constants with phase B on the card
    for policy, want in GOLDEN.items():
        svc, launches, wall = on_card(golden_spec(policy), f"golden {policy}")
        res = svc.result
        got = result_fields(res)
        for k, w in want.items():
            if abs(got[k] - w) > (0 if isinstance(w, int) else 1e-6):
                raise AssertionError(f"golden {policy}: {k} {got[k]!r} vs "
                                     f"{w!r} (abs 1e-6, counts exact)")
        parts[f"golden {policy}"] = launches["scenario_scan"]
        log(f"service golden {policy} (sim.engine jax, phase B on the card): "
            f"{wall:.4f} s wall, launches {json.dumps(launches)}, no oracle "
            f"rerun; equal to tests/test_golden.py "
            f"(counts exact, abs 1e-6): {metrics_line(res)}")

    # (b) the README's quickstart, card against host on one tape
    svc, host, parts["quickstart"], (wall, host_s) = on_card_and_host(
        QUICKSTART, "quickstart")
    res, st = svc.result, svc.status()
    log(f"service quickstart (command-r-35b, aws-3 in 3 regions, Arena 2/s, "
        f"4 h; {st['n_requests']} requests, {len(st['zones'])} zones): card "
        f"{wall:.4f} s wall, host engine {host_s:.4f} s; equal (counts exact, "
        f"cost 1e-9, availability 1e-12, latencies 1e-6); no oracle rerun")
    log(f"service quickstart card: {res.summary()}")
    log(f"service quickstart host: {host.summary()}")

    # (c) the card prices its own fleet with this run's profile row
    row = ProfileTable.load(str(PROFILE_OUT)).lookup("llama3.2-1b", "H100")
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no roofline fallback
        lm = Service(H100_SERVICE).resolve().simulator.latency_model
    if not isinstance(lm, ProfiledLatencyModel):
        raise AssertionError(f"h100 service priced by {type(lm).__name__}")
    prov = (lm.mfu_prefill, lm.mbu_decode, lm.profile_path,
            lm.profile_backend, lm.profile_mode)
    if prov != (row.mfu_prefill, row.mbu_decode, str(PROFILE_OUT), row.backend,
                row.mode) or row.backend != "cuda" or row.mode != "compiled":
        raise AssertionError(f"h100 service priced by {prov}, not this run's "
                             f"row {row}")
    priced, service_s = {}, {}
    for source in ("profile", "roofline"):
        spec = dict(H100_SERVICE, latency={**H100_SERVICE["latency"],
                                           "source": source})
        svc, host, parts[f"h100 {source}"], (wall, host_s) = on_card_and_host(
            spec, f"h100 {source}")
        res, st = svc.result, svc.status()
        priced[source] = res
        # the mean time the latency model prices a request of the tape at
        lm, tape = svc.resolve().simulator.latency_model, svc.resolve().requests
        service_s[source] = float(np.mean([
            lm.service_s(r.prompt_tokens, r.output_tokens) for r in tape]))
        log(f"service h100 {source}-priced (llama3.2-1b, gcp-1 us-central1 + "
            f"us-west1, SpotHedge x3, Arena 0.1/s seed 11, 2 h; "
            f"{st['n_requests']} requests): card {wall:.4f} s wall, host "
            f"engine {host_s:.4f} s, equal, no oracle rerun; {metrics_line(res)}")
    mean = {k: float(r.latencies_s.mean()) for k, r in priced.items()}
    log(f"service h100 pricing side by side (simulated seconds; cost with the "
        f"catalog's H100 spot_ratio 0.33, an ASSUMPTION: Table 1 has no H100): "
        f"profile row mfu_prefill={row.mfu_prefill:.6g} mbu_decode="
        f"{row.mbu_decode:.6g}; mean service time {service_s['profile']:.6g} s "
        f"vs roofline {service_s['roofline']:.6g} s "
        f"({service_s['profile'] / service_s['roofline']:.4g}x); mean latency "
        f"{mean['profile']:.6g} s vs {mean['roofline']:.6g} s "
        f"({mean['profile'] / mean['roofline']:.4g}x); "
        + "; ".join(f"{k}: {metrics_line(r)}" for k, r in priced.items()))

    # (d) the sweep through ScenarioSuite, then the CLI in-process
    report, launches, wall = counted(lambda: ScenarioSuite.from_spec(SWEEP).run())
    check_scan_launches("sweep", launches, report.shape_groups)
    t0 = time.perf_counter()
    host = ScenarioSuite.from_spec(SWEEP).run(engine="vector")
    host_s = time.perf_counter() - t0
    if len(report.cells) != 12:
        raise AssertionError(f"sweep: {len(report.cells)} cells, not 12")
    if report.oracle_reruns:
        raise AssertionError(f"sweep: lanes rerun on the oracle "
                             f"{report.oracle_reruns}")
    for a, b in zip(report.cells, host.cells):
        if a.labels != b.labels:
            raise AssertionError(f"sweep: cell {a.labels} vs {b.labels}")
        # the fields a CellResult carries of those check_result compares
        keys = [k for k in (*RESULT_COUNTS, *RESULT_TOL) if hasattr(b, k)]
        check_result(f"sweep {a.cell_id}", {k: getattr(a, k) for k in keys},
                     {k: getattr(b, k) for k in keys})
    parts["sweep"] = launches["scenario_scan"]
    log(f"service sweep (ScenarioSuite.run, 12 cells, sim.engine jax): "
        f"{wall:.4f} s wall, {report.shape_groups} shape group(s), launches "
        f"{json.dumps(launches)} ({launches['scenario_scan'] / report.shape_groups:g}"
        f" a group), lanes rerun on the oracle {report.oracle_reruns}; host "
        f"engine {host_s:.4f} s; every cell equal to the host engine's")
    for line in report.summary().splitlines():
        log(f"service sweep | {line}")
    out_dir = PROFILE_OUT.parent.parent / "service"
    out_dir.mkdir(parents=True, exist_ok=True)
    one, grid = out_dir / "golden.json", out_dir / "sweep.json"
    one.write_text(json.dumps(golden_spec("spothedge")))
    grid.write_text(json.dumps(SWEEP))
    for name, argv, n in (("--status", ["--spec", str(one), "--status"], 1),
                          ("--sweep", ["--spec", str(grid), "--sweep"],
                           report.shape_groups)):
        rc, launches, wall, out = serve_in_process(argv)
        if rc != 0:
            raise AssertionError(f"repro_torch.launch.serve {name} exited {rc}")
        check_scan_launches(f"serve {name}", launches, n)
        if name == "--status":
            status = json.loads(out[out.index("\n{") + 1:])
            reruns = [name] if status["oracle_rerun"] else []
            if status["n_completed"] != GOLDEN["spothedge"]["n_completed"]:
                raise AssertionError(f"serve --status: {status}")
        else:   # the report the CLI saved, where its last line says
            saved = json.loads(Path(out.rsplit("report: ", 1)[1].strip())
                               .read_text())
            reruns = saved["oracle_reruns"]
            if (saved["n_cells"], saved["shape_groups"]) != (12, n):
                raise AssertionError(f"serve --sweep: {saved['n_cells']} "
                                     f"cells, {saved['shape_groups']} groups")
        if reruns:
            raise AssertionError(f"serve {name}: lanes rerun on the oracle "
                                 f"{reruns}")
        parts[f"cli {name}"] = launches["scenario_scan"]
        log(f"service CLI repro_torch.launch.serve {' '.join(argv)}: exit 0, "
            f"{wall:.4f} s wall, launches {json.dumps(launches)}, no oracle "
            f"rerun")
    log(f"service scenario_scan launches by part (apart from the matrix "
        f"row's count on the kernels line): {json.dumps(parts)}")
    return parts


# ---------------------------------------------------------------------------
# Token-level serving, KV migration and the legacy engine
# ---------------------------------------------------------------------------

# benchmarks/token_engine.py's matrix, uncut: command-r-35b on g5.48xlarge,
# aws-1 and aws-3 at 2 h, Arena 2/s seed 11, a constant 4 replicas,
# {spothedge, ondemand_only} x {request, token}; copied because this script
# imports no repro (benchmarks/ does)
TOKEN_MATRIX = {
    "name": "token-engine", "model": "command-r-35b", "trace": "aws-1",
    "resources": {"instance_type": "g5.48xlarge"},
    "autoscaler": {"kind": "constant", "target": 4},
    "workload": {"kind": "arena", "rate_per_s": 2.0, "seed": 11},
    "serving": {"slo": {"ttft_s": 10.0, "tpot_s": 0.2}},
    "sim": {"duration_hours": 2.0, "control_interval_s": 15.0,
            "timeout_s": 100.0, "concurrency": 4, "drain_s": 300.0},
    "sweep": {"policies": ["spothedge", "ondemand_only"],
              "traces": ["aws-1", "aws-3"],
              "replica_models": ["request", "token"]},
}

# benchmarks/migration.py's matrix, uncut: spothedge and risk_spothedge
# (with its Markov forecast section) on aws-1 and aws-3 at 2 h, Arena 4/s
# seed 11, int8, drain_threshold_s 2.0, migration off and on: 8 token cells
MIGRATION_MATRIX = {
    "name": "migration", "model": "command-r-35b", "trace": "aws-1",
    "resources": {"instance_type": "g5.48xlarge"},
    "autoscaler": {"kind": "constant", "target": 4},
    "workload": {"kind": "arena", "rate_per_s": 4.0, "seed": 11},
    "forecast": {"name": "markov"},
    "serving": {"replica_model": "token",
                "slo": {"ttft_s": 10.0, "tpot_s": 0.2}},
    "migration": {"enabled": False, "compression": "int8",
                  "drain_threshold_s": 2.0},
    "sim": {"duration_hours": 2.0, "control_interval_s": 15.0,
            "timeout_s": 100.0, "concurrency": 4, "drain_s": 300.0},
    "sweep": {"policies": ["spothedge", "risk_spothedge"],
              "traces": ["aws-1", "aws-3"], "migration": [False, True]},
}

#: a token cell's fields held against the host engine's, beside RESULT_TOL:
#: the TTFT / TPOT percentiles to 1e-6, goodput and SLO attainment to 1e-9
TOKEN_TOL = {**RESULT_TOL, "ttft_p50_s": 1e-6, "ttft_p99_s": 1e-6,
             "tpot_p50_s": 1e-6, "tpot_p99_s": 1e-6, "goodput_rps": 1e-9,
             "slo_attainment": 1e-9}
CELL_KEYS = (*RESULT_COUNTS, "total_cost", "cost_vs_ondemand", "availability",
             "mean_s", "p50_s", "p90_s", "p99_s", "ttft_p50_s", "ttft_p99_s",
             "tpot_p50_s", "tpot_p99_s", "goodput_rps", "slo_attainment",
             "n_drained_seqs", "n_migrated_seqs", "migrated_kv_tokens",
             "saved_prefill_tokens", "lost_kv_tokens")


def check_cells(where: str, got, want) -> None:
    """Two reports' cells, label for label, at ``TOKEN_TOL``."""
    if len(got.cells) != len(want.cells):
        raise AssertionError(f"{where}: {len(got.cells)} cells vs "
                             f"{len(want.cells)}")
    for a, b in zip(got.cells, want.cells):
        if a.labels != b.labels:
            raise AssertionError(f"{where}: cell {a.labels} vs {b.labels}")
        check_result(f"{where} {a.cell_id}",
                     {k: getattr(a, k) for k in CELL_KEYS},
                     {k: getattr(b, k) for k in CELL_KEYS}, TOKEN_TOL)


def check_arrays(where: str, got, want) -> None:
    """Two ``ServingResult``s: ``result_fields`` at ``RESULT_TOL``, the sorted
    latencies and the sorted TTFT / TPOT arrays to 1e-6, the token counts
    exact, goodput and SLO attainment to 1e-9."""
    check_result(where, result_fields(got), result_fields(want))
    pairs = [("latencies", got.latencies_s, want.latencies_s)]
    if (got.token is None) != (want.token is None):
        raise AssertionError(f"{where}: token stats on one side only")
    if want.token is not None:
        pairs += [(k, getattr(got.token, k), getattr(want.token, k))
                  for k in ("ttft_s", "tpot_s")]
        check_result(f"{where} token", dataclasses.asdict(got.token),
                     {k: v for k, v in dataclasses.asdict(want.token).items()
                      if not isinstance(v, (np.ndarray, list))},
                     {"goodput_rps": 1e-9, "slo_attainment": 1e-9,
                      "migration_transfer_s": 1e-9, "recompute_saved_s": 1e-9})
    for name, a, b in pairs:
        if a.shape != b.shape or float_diff(np.sort(a), np.sort(b)) > 1e-6:
            raise AssertionError(f"{where}: {name} differ (shapes {a.shape} "
                                 f"{b.shape})")


def token_line(c) -> str:
    return (f"p50 {c.p50_s:.6f} s, p99 {c.p99_s:.6f} s, TTFT p50 / p99 "
            f"{c.ttft_p50_s:.6f} / {c.ttft_p99_s:.6f} s, TPOT p50 "
            f"{c.tpot_p50_s:.6f} s, goodput {c.goodput_rps:.6f} requests/s, "
            f"SLO attainment {c.slo_attainment:.6f}, lost KV tokens "
            f"{c.lost_kv_tokens}")


def phase_token() -> dict:
    """Token-level serving, KV migration and the legacy engine on the port,
    through the entry points a user calls: (a) the token matrix through
    ``ScenarioSuite.run`` (the request lanes in ``scenario_scan`` launches on
    the card, the token cells on the host engine, no oracle rerun), every
    cell against the host engine, then the same cells through ``run_cells``
    with their arrays held against the host engine's; (b) the migration
    matrix, uncut, against the host and the legacy engine (each run in 4
    worker processes); (c) a llama3.2-1b token
    service on the H100 priced by phase 5's profile row and by the
    roofline; (e) the serve CLI's token runs in-process.  Part (d), the KV
    bytes of the card's caches, runs in the fleet phase.  Returns the
    ``scenario_scan`` launches by part."""
    import warnings

    from repro_torch.experiments import CellResult, ScenarioSuite
    from repro_torch.profiles.schema import ProfileTable
    from repro_torch.serving.engine import VectorizedServingEngine
    from repro_torch.serving.latency import ProfiledLatencyModel
    from repro_torch.serving.token.config import TokenEngineConfig
    from repro_torch.serving.torchengine import engine as teng
    from repro_torch.service import Service

    card = card_line()
    parts = {}
    # (a) the token matrix through ScenarioSuite.run, phase B on the card
    report, launches, wall = counted(
        lambda: ScenarioSuite.from_spec(TOKEN_MATRIX).run(engine="jax"))
    check_scan_launches("token matrix", launches, report.shape_groups)
    token_ids = [c.cell_id for c in report.cells
                 if c.labels["replica_model"] == "token"]
    if report.oracle_reruns:
        raise AssertionError(f"token matrix: lanes rerun on the oracle "
                             f"{report.oracle_reruns}")
    if len(report.cells) != 8 or report.host_token_cells != token_ids \
            or len(token_ids) != 4:
        raise AssertionError(f"token matrix: {len(report.cells)} cells, token "
                             f"cells on the host {report.host_token_cells}")
    parts["token matrix"] = launches["scenario_scan"]
    suite_wall, suite_launches = wall, launches
    # the same cells through run_cells, for each launch's cells and every
    # array, and on the host engine
    cells = ScenarioSuite.from_spec(TOKEN_MATRIX).cells()
    groups, outs = [], []
    results, launches, wall = counted(lambda: teng.run_cells(
        [c.engine for c in cells], [c.duration_s for c in cells],
        groups=groups, outputs=outs))
    check_scan_launches("token matrix run_cells", launches, len(groups))
    parts["token matrix run_cells"] = launches["scenario_scan"]
    t0 = time.perf_counter()
    hosts = [VectorizedServingEngine.run(h.engine, h.duration_s)
             for h in ScenarioSuite.from_spec(TOKEN_MATRIX).cells()]
    host_s = time.perf_counter() - t0
    for cell, res, host, out, c in zip(cells, results, hosts, outs,
                                       report.cells):
        token = cell.spec.sim.replica_model == "token"
        if cell.engine.fell_back or cell.engine.ran_on_host != token \
                or (out is None) != token or cell.labels != c.labels:
            raise AssertionError(f"token matrix run_cells {cell.labels}: "
                                 f"fell back {cell.engine.fell_back}, on the "
                                 f"host {cell.engine.ran_on_host}")
        check_arrays(f"token matrix run_cells {cell.labels}", res, host)
        want = CellResult.from_result(cell.labels, host, 0.0)
        check_result(f"token matrix {c.cell_id}",
                     {k: getattr(c, k) for k in CELL_KEYS},
                     {k: getattr(want, k) for k in CELL_KEYS}, TOKEN_TOL)
    log(f"token matrix [{card}] (benchmarks/token_engine.py uncut: "
        f"command-r-35b on g5.48xlarge, aws-1 + aws-3, 2 h, Arena 2/s seed "
        f"11, 4 replicas, spothedge + ondemand_only x request + token; "
        f"ScenarioSuite.run engine jax): {suite_wall:.4f} s wall, "
        f"{report.shape_groups} shape group(s), launches "
        f"{json.dumps(suite_launches)}, lanes rerun on the oracle "
        f"{report.oracle_reruns}, {len(report.host_token_cells)} token cells "
        f"on the host engine; every cell equal to the host engine's (counts "
        f"exact, cost 1e-9, availability 1e-12, latency and TTFT / TPOT "
        f"percentiles 1e-6, goodput and SLO attainment 1e-9)")
    for c in report.cells:
        if c.labels["replica_model"] == "token":
            log(f"token matrix [{card}] {c.cell_id}: {token_line(c)}, "
                f"{c.wall_s:.4f} s wall (its share)")
        else:
            log(f"token matrix [{card}] {c.cell_id}: p50 {c.p50_s:.6f} s, "
                f"p99 {c.p99_s:.6f} s, failure rate {c.failure_rate:.6f}, "
                f"{c.wall_s:.4f} s wall (its share)")
    names = ["/".join(str(v) for v in c.labels.values()) for c in cells]
    for k, g in enumerate(groups):
        log(f"token matrix [{card}] shape group {k}: one scenario_scan launch "
            f"over the request lanes {[names[i] for i in g]}")
    log(f"token matrix [{card}] run_cells: {wall:.4f} s wall, launches "
        f"{json.dumps(launches)}, no lane rerun, the token cells on the host "
        f"engine; host engine {host_s:.4f} s for the 8 cells; the request "
        f"lanes' latencies and the token cells' TTFT / TPOT arrays equal to "
        f"the host engine's (1e-6)")

    # (b) the migration matrix: off and on, against the host and legacy
    report, launches, wall = counted(
        lambda: ScenarioSuite.from_spec(MIGRATION_MATRIX).run(engine="jax"))
    check_scan_launches("migration matrix", launches, 0)
    if report.oracle_reruns or len(report.host_token_cells) != 8:
        raise AssertionError(f"migration matrix: {report.oracle_reruns}, "
                             f"{report.host_token_cells}")
    walls = {"jax": wall}
    for engine in ("vector", "legacy"):
        t0 = time.perf_counter()
        other = ScenarioSuite.from_spec(MIGRATION_MATRIX).run(engine=engine,
                                                              workers=4)
        walls[f"{engine} x4 workers"] = time.perf_counter() - t0
        if other.workers != 4:
            raise AssertionError(f"migration matrix {engine}: "
                                 f"{other.workers} workers")
        check_cells(f"migration matrix vs {engine}", report, other)
    parts["migration matrix"] = launches["scenario_scan"]
    log(f"migration matrix [{card}] (benchmarks/migration.py uncut: "
        f"command-r-35b on g5.48xlarge, aws-1 + aws-3, 2 h, Arena 4/s seed "
        f"11, int8, drain_threshold_s 2.0, spothedge + risk_spothedge with "
        f"the Markov forecast, off / on; 8 token cells): walls "
        f"{json.dumps({k: round(v, 4) for k, v in walls.items()})} s, "
        f"launches {json.dumps(launches)}; every cell equal to the host and "
        f"the legacy engine's")
    for pol, tr in ((p, t) for p in ("spothedge", "risk_spothedge")
                    for t in ("aws-1", "aws-3")):
        off, on = (report.select(policy=pol, trace=tr, migration=m)[0]
                   for m in ("off", "on"))
        log(f"migration matrix [{card}] {pol} {tr}: off {token_line(off)}; on "
            f"{token_line(on)}; migrated sequences {on.n_migrated_seqs}, "
            f"drained {on.n_drained_seqs}, migrated KV tokens "
            f"{on.migrated_kv_tokens}, saved prefill tokens "
            f"{on.saved_prefill_tokens}, lost KV tokens {off.lost_kv_tokens} "
            f"-> {on.lost_kv_tokens}, TTFT p99 delta "
            f"{on.ttft_p99_s - off.ttft_p99_s:+.6f} s, goodput delta "
            f"{on.goodput_rps - off.goodput_rps:+.6f} requests/s")

    # (c) a token service on the H100, priced by phase 5's row and the
    # roofline, each against the host engine
    token_service = dict(H100_SERVICE, serving={"replica_model": "token"})
    row = ProfileTable.load(str(PROFILE_OUT)).lookup("llama3.2-1b", "H100")
    priced, resolved = {}, {}
    for source in ("profile", "roofline"):
        spec = dict(token_service, latency={**H100_SERVICE["latency"],
                                            "source": source})
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # no roofline fallback
            svc = Service(spec)
            res, launches, wall = counted(svc.run)
        check_scan_launches(f"h100 token {source}", launches, 0)
        st = svc.status()
        if not st["token_on_host"] or st["oracle_rerun"]:
            raise AssertionError(f"h100 token {source}: status {st}")
        lm = svc.resolve().simulator.latency_model
        if (source == "profile") != isinstance(lm, ProfiledLatencyModel):
            raise AssertionError(f"h100 token {source}: priced by "
                                 f"{type(lm).__name__}")
        if source == "profile" and (lm.mfu_prefill, lm.mbu_decode) != (
                row.mfu_prefill, row.mbu_decode):
            raise AssertionError("h100 token profile: not this run's row")
        t0 = time.perf_counter()
        host = Service(spec, engine="vector").run()
        host_s = time.perf_counter() - t0
        check_arrays(f"h100 token {source}", res, host)
        priced[source], resolved[source] = res, TokenEngineConfig.from_latency(lm)
        parts[f"h100 token {source}"] = launches["scenario_scan"]
        log(f"token h100 [{card}] {source}-priced (llama3.2-1b, gcp-1, "
            f"SpotHedge x3, Arena 0.1/s seed 11, 2 h, replica_model token): "
            f"{wall:.4f} s wall on the host engine (a token cell has no phase "
            f"B), host engine alone {host_s:.4f} s, equal; {res.summary()}")
    log(f"token h100 pricing side by side [{card}] (simulated seconds): "
        + "; ".join(
            f"{k}: TTFT p50 {r.token.ttft_pct(50):.6f} s, TPOT p50 "
            f"{r.token.tpot_pct(50):.6f} s, goodput "
            f"{r.token.goodput_rps:.6f} requests/s, TokenEngineConfig "
            f"weight_read_s {resolved[k].weight_read_s:.6g}, "
            f"prefill_s_per_token {resolved[k].prefill_s_per_token:.6g}, "
            f"kv_budget_tokens {resolved[k].kv_budget_tokens}"
            for k, r in priced.items()))

    # (e) the serve CLI's token runs, in-process
    out_dir = PROFILE_OUT.parent.parent / "service"
    out_dir.mkdir(parents=True, exist_ok=True)
    one = out_dir / "golden.json"
    one.write_text(json.dumps(golden_spec("spothedge")))
    for argv in (["--spec", str(one), "--replica-model", "token", "--status"],
                 ["--spec", str(one), "--engine", "legacy", "--replica-model",
                  "token", "--status"]):
        rc, launches, wall, out = serve_in_process(argv)
        if rc != 0:
            raise AssertionError(f"serve {' '.join(argv)} exited {rc}")
        check_scan_launches(f"serve {' '.join(argv)}", launches, 0)
        if "ttft_p50=" not in out:
            raise AssertionError(f"serve {' '.join(argv)}: no token summary")
        parts[f"cli {' '.join(argv[2:])}"] = launches["scenario_scan"]
        log(f"token CLI [{card}] repro_torch.launch.serve {' '.join(argv)}: "
            f"exit 0, {wall:.4f} s wall, launches {json.dumps(launches)}")
    log(f"token scenario_scan launches by part [{card}]: {json.dumps(parts)}")
    return parts


# the reference's obs fixture (tests/test_obs.py, tests/test_spans.py): the
# "mini" correlated trace over 3 zones, seed 3; spothedge at a constant 3
# replicas on g5.48xlarge; Poisson 0.8/s, seed 3, for 2 h; timeout 60 s,
# concurrency 2
OBS_HOURS = 2.0
OBS_DUR = OBS_HOURS * 3600.0 + 600.0
# tests/test_obs.py's GOLDEN_COUNTS, the reference's event totals of that
# fixture at detail "full" (copied: the card's machine has no JAX)
OBS_GOLDEN_COUNTS = {"autoscaler_target": 1, "decision": 498,
                     "launch_failure": 478, "lifecycle": 40, "slo_burn": 130,
                     "warning": 14, "window": 130}
# README.md's observability example, on its quickstart service
README_OBS = {"detail": "full", "jsonl": True, "chrome_trace": True,
              "window_s": 60, "trace_sample": 0.01,
              "slo_burn": {"target": 0.99, "fast_window_s": 300,
                           "slow_window_s": 3600}}
OBS_OUT = ROOT / "chiprun_out" / "obs"


def obs_fixture(cls, detail: str = "full", trace_sample: float = 1.0):
    """The reference's obs fixture as an engine of class ``cls``."""
    from repro_torch.cluster.traces import synth_correlated_trace
    from repro_torch.configs import get_config
    from repro_torch.core.autoscaler import ConstantTarget
    from repro_torch.core.policy import make_policy
    from repro_torch.obs import ObsRecorder
    from repro_torch.workloads.arrivals import make_workload

    zones = ["us-west-2a", "us-west-2b", "us-east-2a"]
    trace = synth_correlated_trace(
        zones, {z: z[:-1] for z in zones}, steps=int(OBS_HOURS * 60) + 60,
        dt=60.0, seed=3, max_capacity=4, name="mini")
    reqs = make_workload("poisson", rate_per_s=0.8, seed=3).generate(
        OBS_HOURS * 3600.0)
    return cls(trace, make_policy("spothedge"), reqs, get_config("llama3.2-1b"),
               itype="g5.48xlarge", autoscaler=ConstantTarget(3),
               timeout_s=60.0, concurrency=2, workload_name="poisson",
               obs=ObsRecorder(detail=detail, trace_sample=trace_sample))


def check_tiling(where: str, records) -> None:
    """Every span record tiles [arrival, last close] contiguously."""
    if records != sorted(records, key=lambda r: r["ordinal"]):
        raise AssertionError(f"{where}: span records out of ordinal order")
    for rec in records:
        segs = rec["segments"]
        ok = bool(segs) and segs[0]["t0_s"] == rec["arrival_s"]
        for a, b in zip(segs, segs[1:]):
            ok = ok and a["t1_s"] >= a["t0_s"] and b["t0_s"] == a["t1_s"]
        if not (ok and segs[-1]["t1_s"] >= segs[-1]["t0_s"]):
            raise AssertionError(f"{where}: span {rec['ordinal']} does not "
                                 f"tile its lifetime: {segs}")


def check_card_spans(where: str, card, host) -> int:
    """The card's span records against the host's after the reference's
    filter (tests/test_spans.py): one attempt, served, outcome ``ok`` or
    ``timeout``, byte for byte.  The kernel keeps a retried request's last
    attempt only, so a request the host retried is the only extra ordinal
    the card may hold.  Returns the count compared."""
    want = {r["ordinal"]: r for r in host
            if r["attempts"] == 1 and r["outcome"] in ("ok", "timeout")
            and any(s["name"] == "service" for s in r["segments"])}
    got = {r["ordinal"]: r for r in card}
    bad = [o for o, r in want.items()
           if json.dumps(got.get(o), sort_keys=True)
           != json.dumps(r, sort_keys=True)]
    retried = {r["ordinal"] for r in host if r["attempts"] > 1}
    extra = set(got) - set(want) - retried
    if bad or extra:
        raise AssertionError(f"{where}: {len(bad)} spans differ from the "
                             f"host's (first {bad[:3]}), {len(extra)} extra "
                             f"ordinals {sorted(extra)[:3]}")
    return len(want)


def rebuild_s(engines, scheds, outs, repeats: int = 3) -> tuple:
    """The host time of rebuilding the cells' spans from their lanes' span
    timelines again, into fresh collectors, ``repeats`` times: (the
    fastest and the slowest seconds, spans)."""
    from repro_torch.obs.spans import SpanCollector
    from repro_torch.serving.torchengine.engine import reconstruct_spans

    times = []
    for _ in range(repeats):
        cols = [SpanCollector(e.obs.trace_sample, e.requests) for e in engines]
        t0 = time.perf_counter()
        for eng, col, sched, out in zip(engines, cols, scheds, outs):
            reconstruct_spans(
                types.SimpleNamespace(_spans=col, _reps=eng._reps), sched, out)
        times.append(time.perf_counter() - t0)
    return min(times), max(times), sum(len(c.records()) for c in cols)


def phase_obs() -> dict:
    """SkyServe's observability on the port (step 5d): (a) the reference's
    obs fixture through the legacy and vector engines on the host and
    ``run_cells`` on the card, the logs against each other, the reference's
    golden counts and the card's rebuilt spans; (b) the same cell at detail
    off, decisions and full on the card, what tracing costs; (c) the
    README's observability example through ``Service`` on the card, its
    artifacts and the CLI; (d) the 96-cell matrix with its spans rebuilt,
    and the quick matrix's card spans against the port oracle's.  Returns
    the ``scenario_scan`` launches by part."""
    import io

    from repro_torch.kernels import scenario_scan as scn
    from repro_torch.obs import control_plane_records, dumps_jsonl, read_jsonl
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.serving.engine import VectorizedServingEngine
    from repro_torch.serving.sim import ServingSimulator
    from repro_torch.serving.torchengine import engine as teng
    from repro_torch.serving.torchengine import recorded
    from repro_torch.serving.torchengine.kernel import LANE_KEYS

    card = card_line()
    parts: Dict[str, int] = {}
    t_phase = time.perf_counter()

    # (a) the fixture, uncut, detail "full", every request sampled
    t0 = time.perf_counter()
    legacy = obs_fixture(ServingSimulator).run(OBS_DUR)
    legacy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vector = obs_fixture(VectorizedServingEngine).run(OBS_DUR)
    vector_s = time.perf_counter() - t0
    log_bytes = dumps_jsonl(vector.obs.events)
    if dumps_jsonl(legacy.obs.events) != log_bytes:
        raise AssertionError("obs fixture: the legacy and vector event logs "
                             "differ")
    if dumps_jsonl(legacy.obs.span_records()) != dumps_jsonl(
            vector.obs.span_records()):
        raise AssertionError("obs fixture: the legacy and vector span logs "
                             "differ")
    for name, res in (("legacy", legacy), ("vector", vector)):
        if res.obs.event_counts() != OBS_GOLDEN_COUNTS:
            raise AssertionError(f"obs fixture {name}: event counts "
                                 f"{res.obs.event_counts()} != the "
                                 f"reference's {OBS_GOLDEN_COUNTS}")
    eng = obs_fixture(teng.TorchServingEngine)
    outs = []
    res, launches, wall = counted(
        lambda: teng.run_cells([eng], [OBS_DUR], outputs=outs)[0])
    check_scan_launches("obs fixture", launches, 1)
    parts["fixture"] = launches["scenario_scan"]
    if eng.fell_back or not eng.schedule.trace_on or outs[0] is None:
        raise AssertionError("obs fixture: the card's lane overflowed or "
                             "carried no span timelines")
    card_counts = {k: v for k, v in OBS_GOLDEN_COUNTS.items()
                   if k not in ("window", "slo_burn")}
    if res.obs.event_counts() != card_counts:
        raise AssertionError(f"obs fixture card: event counts "
                             f"{res.obs.event_counts()} != {card_counts}")
    if dumps_jsonl(res.obs.records()) != dumps_jsonl(
            control_plane_records(vector.obs.records())):
        raise AssertionError("obs fixture: the card's control plane differs "
                             "from the vector engine's")
    spans, host_spans = res.obs.span_records(), vector.obs.span_records()
    check_tiling("obs fixture card", spans)
    check_tiling("obs fixture vector", host_spans)
    n_cmp = check_card_spans("obs fixture", spans, host_spans)
    check_result("obs fixture, card vs host", result_fields(res),
                 result_fields(vector))
    if res.metrics != vector.metrics:
        raise AssertionError(f"obs fixture: registry {res.metrics} != the "
                             f"host's {vector.metrics}")
    # the plain version's timelines give the card's spans, byte for byte
    plain = teng.run_cells([obs_fixture(teng.TorchServingEngine)], [OBS_DUR],
                           device="cpu")[0]
    if dumps_jsonl(plain.obs.span_records()) != dumps_jsonl(spans):
        raise AssertionError("obs fixture: the card's spans differ from the "
                             "plain version's")
    log(f"obs fixture [{card}] (mini trace, spothedge x 3, Poisson 0.8/s, "
        f"2 h, detail full, trace_sample 1.0): legacy {legacy_s:.4f} s and "
        f"vector {vector_s:.4f} s on the host, event logs byte-identical "
        f"({len(log_bytes)} B, counts {json.dumps(vector.obs.event_counts())}"
        f" = the reference's golden counts); the card (run_cells, launches "
        f"{json.dumps(launches)}, {wall:.4f} s wall): counts "
        f"{json.dumps(res.obs.event_counts())}, control plane byte-identical "
        f"to the vector engine's, {len(spans)} spans rebuilt, {n_cmp} equal "
        f"the vector engine's after the filter ({len(host_spans)} on the "
        f"host), every span tiles its lifetime, equal to the plain "
        f"version's; metrics equal the host's: {metrics_line(res)}")

    # (b) what tracing costs on the card: the same cell at three details
    fields, scheds, lanes_out, walls = {}, {}, {}, {}
    for detail in ("off", "decisions", "full"):
        e = obs_fixture(teng.TorchServingEngine, detail=detail)
        scheds[detail] = e.record_schedule(OBS_DUR)
        o = []
        r, launches, walls[detail] = counted(
            lambda: teng.run_cells([e], [OBS_DUR], outputs=o)[0])
        check_scan_launches(f"obs detail {detail}", launches, 1)
        parts[f"detail {detail}"] = launches["scenario_scan"]
        if scheds[detail].trace_on != (detail != "off"):
            raise AssertionError(f"obs detail {detail}: trace_on "
                                 f"{scheds[detail].trace_on}")
        if (r.obs is None) != (detail == "off"):
            raise AssertionError(f"obs detail {detail}: recorder {r.obs}")
        fields[detail] = result_fields(r)
        lanes_out[detail] = (e, o[0])
    if not fields["off"] == fields["decisions"] == fields["full"]:
        raise AssertionError(f"obs details: metrics differ {fields}")
    kernel_ms = {}
    for detail in ("off", "full"):
        key, lanes, grid = teng.pack_group([scheds[detail]])
        args = ([torch.from_numpy(lanes[k]).cuda() for k in LANE_KEYS]
                + [torch.from_numpy(a).cuda() for a in grid])
        kw = dict(Q=key.Q, C=key.C, amax=key.AMAX, lb_rr=key.lb_rr,
                  expire_on=key.expire_on, trace_on=key.trace_on)
        kernel_ms[detail] = cuda_ms(lambda: scn.launch(*args, **kw), iters=5,
                                    warmup=1)
    e, o = lanes_out["full"]
    span_s, span_max, n_rebuilt = rebuild_s([e], [scheds["full"]], [o])
    log(f"obs tracing cost [{card}]: metrics identical at detail off / "
        f"decisions / full, one scenario_scan launch each, trace_on "
        f"False / True / True; scenario_scan {kernel_ms['off']:.4f} ms with "
        f"trace_on off, {kernel_ms['full']:.4f} ms on [CUDA events]; phase B "
        f"wall {1e3 * walls['off']:.2f} / {1e3 * walls['decisions']:.2f} / "
        f"{1e3 * walls['full']:.2f} ms [host clock, span rebuild included]; "
        f"the span rebuild alone {1e3 * span_s:.2f} ms for {n_rebuilt} spans "
        f"(fastest of 3, slowest {1e3 * span_max:.2f} ms) [host clock]")

    # (c) the README's observability example through Service on the card
    OBS_OUT.mkdir(parents=True, exist_ok=True)
    spec = dict(QUICKSTART, name="readme-obs",
                observability=dict(README_OBS, out_dir=str(OBS_OUT)))
    svc, launches, wall = on_card(spec, "obs service")
    parts["service"] = launches["scenario_scan"]
    art = svc.artifacts
    if set(art) != {"events", "spans", "trace"}:
        raise AssertionError(f"obs service: artifacts {sorted(art)}")
    obs = svc.result.obs
    if dumps_jsonl(read_jsonl(art["events"])) != dumps_jsonl(obs.records()):
        raise AssertionError("obs service: the event log does not read back")
    if dumps_jsonl(read_jsonl(art["spans"])) != dumps_jsonl(
            obs.span_records()):
        raise AssertionError("obs service: the span log does not read back")
    with open(art["trace"]) as f:
        n_trace = len(json.load(f)["traceEvents"])
    log(f"obs service [{card}] README quickstart + observability example: "
        f"launches {json.dumps(launches)}, {wall:.4f} s wall, "
        f"{len(obs.events)} events {json.dumps(obs.event_counts())}, "
        f"{len(obs.span_records())} spans, the trace {n_trace} events; "
        f"artifacts {json.dumps({k: Path(v).name for k, v in art.items()})} "
        f"read back equal; {metrics_line(svc.result)}")
    first = obs.span_records()[0]["ordinal"]
    for argv, want_rc in (
            (["summarize", art["events"]], 0),
            (["attribute", art["events"], "--top", "3", "--spans",
              art["spans"]], 0),
            (["request", art["spans"], str(first)], 0),
            (["slo", art["events"]], 0),
            (["trace", art["events"], "-o", str(OBS_OUT / "cli.trace.json")],
             0),
            (["diff", art["events"], art["events"]], 0)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = obs_main(argv)
        for line in buf.getvalue().splitlines()[:12]:
            log(f"obs CLI | {line}")
        if rc != want_rc:
            raise AssertionError(f"python -m repro_torch.obs {argv[0]} "
                                 f"exited {rc}")
        log(f"obs CLI [{card}] python -m repro_torch.obs {argv[0]}: exit {rc}")

    # (d) the 96-cell matrix with its spans rebuilt, as in step 4
    matrix = recorded.spec_matrix()
    planes = recorded.recorded_planes()
    ms = [c.engine.record_schedule(c.duration_s) for c in matrix]
    if any(s.trace_on != planes[s.policy_name]["trace_on"] for s in ms):
        raise AssertionError("obs matrix: trace_on differs from the recording")
    outs = []
    results, launches, wall = counted(lambda: teng.run_cells(
        [c.engine for c in matrix], [c.duration_s for c in matrix],
        outputs=outs))
    check_scan_launches("obs matrix", launches, 1)
    parts["matrix"] = launches["scenario_scan"]
    n_spans = sum(len(r.obs.span_records()) for r in results)
    span_s, span_max, n_rebuilt = rebuild_s([c.engine for c in matrix], ms,
                                            outs)
    if n_rebuilt != n_spans:
        raise AssertionError(f"obs matrix: {n_rebuilt} spans rebuilt again, "
                             f"{n_spans} in the results")
    quick = recorded.spec_matrix(n_seeds=4)
    qres, launches, _ = counted(lambda: teng.run_cells(
        [c.engine for c in quick], [c.duration_s for c in quick]))
    check_scan_launches("obs quick matrix", launches, 1)
    parts["quick matrix"] = launches["scenario_scan"]
    n_cmp = 0
    for c, r in zip(recorded.spec_matrix(n_seeds=4), qres):
        host = VectorizedServingEngine.run(c.engine, c.duration_s)
        n_cmp += check_card_spans(f"obs quick {c.labels}",
                                  r.obs.span_records(),
                                  host.obs.span_records())
    log(f"obs matrix [{card}]: {len(matrix)} cells (trace_on "
        f"{ms[0].trace_on}, the recording's), one launch, {wall:.4f} s wall, "
        f"{n_spans} spans rebuilt, the rebuild alone {1e3 * span_s:.2f} ms "
        f"(fastest of 3, slowest {1e3 * span_max:.2f} ms) [host clock]; quick "
        f"matrix's {len(quick)} cells: {n_cmp} spans "
        f"equal the port oracle's after the filter")
    log(f"obs scenario_scan launches by part [{card}]: {json.dumps(parts)}; "
        f"the phase {time.perf_counter() - t_phase:.2f} s wall")
    return parts


# ---------------------------------------------------------------------------
# Forecasters, risk-aware SpotHedge, the Omniscient oracle, the fan-out
# ---------------------------------------------------------------------------

# examples/service.yaml, the paper's Listing 1, uncut (this script reads no
# YAML): command-r-35b on g5.48xlarge, aws-3 in three regions,
# risk_spothedge with N_Extra 2 and the Markov forecast, the load
# autoscaler, Arena at 2/s with client regions, the token model with int8
# migration, observability at detail full, 2 h
LISTING1 = {
    "name": "chatbot", "model": "command-r-35b", "trace": "aws-3",
    "resources": {"instance_type": "g5.48xlarge",
                  "any_of": [{"region": "us-east-1"}, {"region": "us-east-2"},
                             {"region": "us-west-2"}]},
    "replica_policy": {"name": "risk_spothedge", "overprovision": 2,
                       "dynamic_fallback": True},
    "forecast": {"name": "markov", "horizon_s": 450, "risk_threshold": 0.6,
                 "calm_threshold": 0.06},
    "autoscaler": {"kind": "load", "target": 4, "qps_per_replica": 0.8,
                   "min_replicas": 2, "max_replicas": 12,
                   "upscale_delay_s": 60, "downscale_delay_s": 600},
    "workload": {"kind": "arena", "rate_per_s": 2.0, "seed": 11,
                 "args": {"client_regions": {"us-west-2": 0.5,
                                             "us-east-1": 0.3,
                                             "eu-central-1": 0.2}}},
    "latency": {"source": "roofline"},
    "serving": {"replica_model": "token",
                "slo": {"ttft_s": 10.0, "tpot_s": 0.2},
                "prefill_chunk_tokens": 512},
    "migration": {"enabled": True, "compression": "int8",
                  "drain_threshold_s": 2.0},
    "observability": {"detail": "full", "out_dir": str(OBS_OUT),
                      "trace_sample": 0.01,
                      "slo_burn": {"target": 0.99, "fast_window_s": 300.0,
                                   "slow_window_s": 3600.0,
                                   "fast_threshold": 14.4,
                                   "slow_threshold": 6.0}},
    "sim": {"duration_hours": 2.0, "control_interval_s": 15, "timeout_s": 100,
            "concurrency": 4},
}

# the README's quickstart with a Markov forecast section and a policy sweep:
# risk_spothedge once per forecaster, the others once (6 cells)
POLICY_SWEEP = dict(
    QUICKSTART, name="policy-sweep", forecast={"name": "markov"},
    sweep={"policies": ["spothedge", "risk_spothedge", "omniscient",
                        "even_spread"],
           "forecasters": ["persistence", "ewma", "markov"]})

BACKTEST_TRACES = ("aws-1", "aws-2", "aws-3", "gcp-1")
FORECAST_OUT = ROOT / "chiprun_out" / "forecast"
# the fields of artifacts/bench/scenario_forecast_risk.json's cells held
# against this run's, at the artifact's own 6-digit rounding
RISK_SUITE_KEYS = ("cost_vs_ondemand", "total_cost", "availability",
                   "n_preemptions", "n_launch_failures")


def forecast_risk_suite():
    """``benchmarks/forecast_eval.py``'s ``build_serving_suite``: spothedge
    and risk_spothedge (Markov forecast) on the four named traces, a
    constant 4 replicas of llama3.2-1b on p3.2xlarge, no workload, each
    trace's full length up to 7 days; copied because benchmarks/ imports
    repro."""
    from repro_torch.cluster.traces import load_trace
    from repro_torch.experiments import Scenario, ScenarioSuite
    from repro_torch.service import spec_from_dict

    scenarios = []
    for tname in BACKTEST_TRACES:
        hours = min(load_trace(tname).duration_s / 3600.0, 7 * 24.0)
        for policy in ("spothedge", "risk_spothedge"):
            spec = spec_from_dict({
                "name": f"forecast-risk-{policy}-{tname}",
                "model": "llama3.2-1b", "trace": tname,
                "resources": {"instance_type": "p3.2xlarge"},
                "replica_policy": {"name": policy},
                "autoscaler": {"kind": "constant", "target": 4},
                "workload": {"kind": "none"},
                "forecast": {"name": "markov"},
                "sim": {"duration_hours": hours, "control_interval_s": 30.0,
                        "drain_s": 0.0, "seed": 0},
            })
            scenarios.append(Scenario(labels={"policy": policy,
                                              "trace": tname}, spec=spec))
    return ScenarioSuite(scenarios, name="forecast_risk")


def cell_line(c) -> str:
    return (f"cost vs on-demand {c.cost_vs_ondemand:.6f}, availability "
            f"{c.availability:.6f}, preemptions {c.n_preemptions}, p50 / p99 "
            f"{c.p50_s:.6f} / {c.p99_s:.6f} s")


def in_process(main, argv, where: str) -> str:
    """``main(argv)`` with its standard output captured: must exit 0."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{where} {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def phase_forecast() -> dict:
    """Forecasters, risk-aware SpotHedge, the Omniscient oracle and the
    suite's worker fan-out on the port (step 5e), each part counted: (a)
    Listing 1 uncut through ``Service`` on the card path and the host
    engine, then its request-model variant in one ``scenario_scan`` launch;
    (b) a 6-cell policy sweep through ``ScenarioSuite.run`` on the card and
    on the host engine in 4 worker processes, with the Omniscient solve's
    status, time, objective and buckets; (c) the backtest CLI on the four
    named traces against the committed reports, and the trace statistics
    CLI; (d) the reference's forecast-risk suite at 4 workers and serially
    against its committed report; (f) the serve CLI on Listing 1 and on the
    sweep.  Part (e), the migration matrix uncut, runs in ``phase_token``.
    Returns the ``scenario_scan`` launches by part."""
    from repro_torch.cluster.traces import main as traces_main
    from repro_torch.core.omniscient import solve_omniscient
    from repro_torch.experiments import ScenarioSuite
    from repro_torch.forecast.backtest import main as backtest_main
    from repro_torch.launch import serve
    from repro_torch.service import Service, build_service

    card = card_line()
    parts = {}
    t_phase = time.perf_counter()

    # (a) Listing 1 uncut: a token cell, so the host engine runs it under
    # the card engine too (no launch); then its request-model variant
    listing = Service(LISTING1)
    res, launches, wall = counted(listing.run)
    check_scan_launches("listing 1", launches, 0)
    st = listing.status()
    if not st["token_on_host"] or st["oracle_rerun"]:
        raise AssertionError(f"listing 1: status {st}")
    pol = listing.resolve().policy
    if (pol.name, pol.forecaster.name, pol.horizon_s) != (
            "risk_spothedge", "markov", 450.0):
        raise AssertionError(f"listing 1: policy {pol.name} with "
                             f"{pol.forecaster.name} at {pol.horizon_s} s")
    host_spec = dict(LISTING1, observability=dict(
        LISTING1["observability"], out_dir=str(OBS_OUT / "listing1-host")))
    t0 = time.perf_counter()
    host_svc = Service(host_spec, engine="vector")
    host = host_svc.run()
    host_s = time.perf_counter() - t0
    check_arrays("listing 1, card path vs host", res, host)
    for kind, path in listing.artifacts.items():
        if Path(path).read_bytes() != Path(host_svc.artifacts[kind]) \
                .read_bytes():
            raise AssertionError(f"listing 1: {kind} artifact differs from "
                                 "the host engine's")
    parts["listing 1"] = launches["scenario_scan"]
    log(f"forecast listing 1 [{card}] (examples/service.yaml uncut: "
        f"command-r-35b on g5.48xlarge, aws-3 in 3 regions, risk_spothedge "
        f"N_Extra 2, Markov forecast 450 s / 0.6 / 0.06, load autoscaler 4 -> "
        f"2-12, Arena 2/s seed 11 with client regions, token model with int8 "
        f"migration, detail full, 2 h; {st['n_requests']} requests): "
        f"{wall:.4f} s wall on the host engine (a token cell has no phase B), "
        f"launches {json.dumps(launches)}; host engine alone {host_s:.4f} s; "
        f"equal, artifacts {sorted(listing.artifacts)} byte-equal to the host "
        f"engine's; {res.summary()}")
    request = {k: v for k, v in LISTING1.items() if k != "migration"}
    request["serving"] = dict(LISTING1["serving"], replica_model="request")
    request["observability"] = dict(LISTING1["observability"],
                                    out_dir=str(OBS_OUT / "listing1-request"))
    svc, host, parts["listing 1 request"], (wall, host_s) = on_card_and_host(
        request, "listing 1 request")
    log(f"forecast listing 1 request model [{card}]: card {wall:.4f} s wall, "
        f"one scenario_scan launch, host engine {host_s:.4f} s, equal; "
        f"{metrics_line(svc.result)}")

    # (b) the policy sweep: on the card, then on the host in 4 processes
    report, launches, wall = counted(
        lambda: ScenarioSuite.from_spec(POLICY_SWEEP).run(engine="jax"))
    check_scan_launches("policy sweep", launches, report.shape_groups)
    if len(report.cells) != 6 or report.oracle_reruns:
        raise AssertionError(f"policy sweep: {len(report.cells)} cells, "
                             f"reruns {report.oracle_reruns}")
    t0 = time.perf_counter()
    host = ScenarioSuite.from_spec(POLICY_SWEEP).run(engine="vector",
                                                     workers=4)
    host_s = time.perf_counter() - t0
    if host.workers != 4:
        raise AssertionError(f"policy sweep: {host.workers} workers")
    for a, b in zip(report.cells, host.cells):
        if a.labels != b.labels:
            raise AssertionError(f"policy sweep: {a.labels} vs {b.labels}")
        keys = [k for k in (*RESULT_COUNTS, *RESULT_TOL) if hasattr(b, k)]
        check_result(f"policy sweep {a.cell_id}",
                     {k: getattr(a, k) for k in keys},
                     {k: getattr(b, k) for k in keys})
    parts["policy sweep"] = launches["scenario_scan"]
    log(f"forecast policy sweep [{card}] (the README quickstart, 4 h, "
        f"policies spothedge / risk_spothedge / omniscient / even_spread x "
        f"forecasters persistence / ewma / markov: 6 cells): "
        f"ScenarioSuite.run engine jax {wall:.4f} s wall, "
        f"{report.shape_groups} shape group(s), launches "
        f"{json.dumps(launches)}, no oracle rerun; engine vector at 4 workers "
        f"{host_s:.4f} s; every cell equal")
    for c in report.cells:
        log(f"forecast policy sweep [{card}] {c.cell_id}: {cell_line(c)}")
    oracle = next(sc for sc in ScenarioSuite.from_spec(POLICY_SWEEP).scenarios
                  if sc.labels["policy"] == "omniscient")
    t0 = time.perf_counter()
    resolved = build_service(oracle.spec)
    build_s = time.perf_counter() - t0
    sched = resolved.policy.schedule
    itype = oracle.spec.resources.instance_type
    k = (resolved.catalog.od_price(itype, resolved.trace.zones[0])
         / resolved.catalog.spot_price(itype, resolved.trace.zones[0]))
    t0 = time.perf_counter()
    again = solve_omniscient(resolved.trace, n_target=4,
                             cold_start_s=oracle.spec.sim.cold_start_s,
                             k_ratio=k, avail_target=0.99)
    solve_s = time.perf_counter() - t0
    if "Optimal" not in sched.status or again.status != sched.status \
            or again.objective != sched.objective \
            or not np.array_equal(again.spot_plan, sched.spot_plan) \
            or not np.array_equal(again.od_plan, sched.od_plan):
        raise AssertionError(f"omniscient solve: {sched.status!r}, "
                             f"{again.status!r}, objectives {sched.objective} "
                             f"/ {again.objective}")
    log(f"forecast omniscient solve [{card}] (aws-3's 9 zones sliced to the "
        f"spec's {len(sched.zones)}, N_Tar 4, k {k:.6g}): status "
        f"{sched.status!r}, {solve_s:.4f} s [host clock, HiGHS], objective "
        f"{sched.objective!r}, {len(sched.od_plan)} buckets of "
        f"{sched.bucket_s:g} s, availability indicator mean "
        f"{sched.availability_ind.mean():.6f}; the cell's build with its "
        f"solve {build_s:.4f} s; a second solve gives the same plan")

    # (c) backtests through the CLI, against the committed reports
    t0 = time.perf_counter()
    for tname in BACKTEST_TRACES:
        out = in_process(backtest_main, ["--trace", tname, "--out-dir",
                                         str(FORECAST_OUT)], "backtest")
        for line in out.splitlines():
            log(f"forecast backtest | {line}")
        for fc in ("persistence", "ewma", "markov"):
            name = f"backtest_{tname}_{fc}.json"
            got = json.loads((FORECAST_OUT / name).read_text())
            want = json.loads((ROOT / "artifacts" / "forecast" / name)
                              .read_text())
            if got != want:
                raise AssertionError(f"backtest {name}: differs from the "
                                     "committed report")
    backtest_s = time.perf_counter() - t0
    stats = json.loads(in_process(traces_main, ["--json"], "traces"))
    log(f"forecast backtests [{card}]: 12 reports (4 traces x persistence / "
        f"ewma / markov) in {backtest_s:.4f} s [host clock], each equal to "
        f"artifacts/forecast/ field for field; python -m "
        f"repro_torch.cluster.traces --json: exit 0, {len(stats)} traces")

    # (d) the forecast-risk suite at 4 workers and serially
    walls, runs = {}, {}
    for workers in (4, None):
        t0 = time.perf_counter()
        runs[workers] = forecast_risk_suite().run(engine="vector",
                                                  workers=workers)
        walls[f"workers={workers}"] = time.perf_counter() - t0
    want = json.loads((ROOT / "artifacts" / "bench" /
                       "scenario_forecast_risk.json").read_text())["cells"]
    if runs[4].workers != 4 or len(want) != len(runs[4].cells) != 8:
        raise AssertionError("forecast-risk suite: workers or cells")
    for a, b, w in zip(runs[4].cells, runs[None].cells, want):
        da, db = a.to_dict(), b.to_dict()
        for key in RISK_SUITE_KEYS:
            if not da[key] == db[key] == w[key]:
                raise AssertionError(f"forecast-risk {a.cell_id}: {key} "
                                     f"{da[key]} / {db[key]} vs {w[key]}")
    cell_s = {f"workers={w}": round(sum(c.wall_s for c in r.cells), 4)
              for w, r in runs.items()}
    log(f"forecast risk suite [{card}] (benchmarks/forecast_eval.py: "
        f"spothedge vs risk_spothedge, 4 traces up to 7 days, no workload; "
        f"engine vector): walls {json.dumps({k: round(v, 4) for k, v in walls.items()})}"
        f" s, the cells' own walls summed {json.dumps(cell_s)} s; both equal to artifacts/bench/scenario_forecast_risk.json at "
        f"its 6 digits ({', '.join(RISK_SUITE_KEYS)})")
    for c in runs[4].cells:
        log(f"forecast risk suite [{card}] {c.cell_id}: {cell_line(c)}, "
            f"launch failures {c.n_launch_failures}")

    # (f) the serve CLI: Listing 1's status, the sweep on 4 workers
    out_dir = PROFILE_OUT.parent.parent / "service"
    out_dir.mkdir(parents=True, exist_ok=True)
    one, grid = out_dir / "listing1.json", out_dir / "policy-sweep.json"
    one.write_text(json.dumps(LISTING1))
    grid.write_text(json.dumps(POLICY_SWEEP))
    for argv in (["--spec", str(one), "--status"],
                 ["--spec", str(grid), "--sweep", "--engine", "vector",
                  "--workers", "4"]):
        rc, launches, wall, out = serve_in_process(argv)
        if rc != 0:
            raise AssertionError(f"serve {' '.join(argv)} exited {rc}")
        check_scan_launches(f"serve {' '.join(argv)}", launches, 0)
        if "--sweep" in argv and "workers=4" not in out:
            raise AssertionError("serve --sweep: not on 4 workers")
        parts[f"cli {' '.join(argv[2:])}"] = launches["scenario_scan"]
        log(f"forecast CLI [{card}] repro_torch.launch.serve "
            f"{' '.join(argv)}: exit 0, {wall:.4f} s wall, launches "
            f"{json.dumps(launches)}")
    log(f"forecast scenario_scan launches by part [{card}]: "
        f"{json.dumps(parts)}; the phase {time.perf_counter() - t_phase:.2f} "
        f"s wall")
    return parts


# ---------------------------------------------------------------------------
# Phase 5f: training on the card (no kernel), and step 6's prefill step
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 128          # the reference train CLI's defaults
TRAIN_OUT = ROOT / "chiprun_out" / "train"


def launch_counts() -> dict:
    from repro_torch.kernels import ops

    return {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}


def train_full_width() -> None:
    """(a) llama3.2-1b at full width, bf16 weights from seed 0, through
    ``build_train_step`` (blockwise, remat, fp32 moments, 2 microbatches)
    on ``make_batch`` batches of B = 4, S = 128: 5 steps, then 3 with int8
    error-feedback compression on the same parameters and state.  Every
    loss and grad norm finite, every weight matrix changed, no kernel
    launched.  Warmup 1, so the first steps move bf16 weights at all: an
    update of lr x ~1 must pass half a bf16 step of the weight (3.9e-5 at
    0.02); the RMSNorm scales at 1.0 need 3.9e-3 and stay, as they do in
    the reference, whose update is cast to bf16 too (their count is
    printed)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training import AdamWConfig, make_batch, make_train_step

    cfg = get_config("llama3.2-1b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step = build_train_step(cfg, microbatches=2,
                            opt_cfg=AdamWConfig(warmup_steps=1),
                            generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    model = step.model
    if model.num_params() != FULL_PARAMS["llama3.2-1b"]:
        raise AssertionError(f"train model has {model.num_params():,} params")
    log(f"train [{card_line()}] llama3.2-1b {model.num_params():,} params bf16, "
        f"fp32 m/v, impl={model.impl} remat={model.remat}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    before = {k: p.detach().clone() for k, p in step.params.items()}
    compressed = make_train_step(model, step.opt_cfg, microbatches=2,
                                 compress_grads=True)
    ops.reset_launch_counts()
    for i in range(8):
        batch = make_batch(cfg, TRAIN_B, TRAIN_S, seed=0, step=i, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch) if i < 5 else compressed(step.opt_state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        wall = time.perf_counter() - t0
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train step {i}: loss {loss} grad norm {gnorm}")
        first = f" (ln V = {math.log(cfg.vocab_size):.4f})" if i == 0 else ""
        log(f"train [{card_line()}] step {i} "
            f"{'compressed ' if i >= 5 else ''}loss {loss:.4f}{first} "
            f"grad_norm {gnorm:.4f} wall_s {wall:.4f} "
            f"tokens/s {TRAIN_B * TRAIN_S / wall:.1f} peak_GiB "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    if int(step.opt_state["step"]) != 8:
        raise AssertionError(f"optimizer step {int(step.opt_state['step'])}, want 8")
    same = [k for k, p in step.params.items() if torch.equal(p, before[k])]
    if any(step.params[k].dim() > 1 for k in same):
        raise AssertionError(f"weight matrices did not change: {same[:3]}")
    log(f"train parameters changed: {len(step.params) - len(same)} of "
        f"{len(step.params)} (unchanged: {len(same)} vectors, e.g. "
        f"{same[:2]})")
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the train path launched kernels: {counts}")
    log(f"train launches over the 8 steps (want all 0): {json.dumps(counts)}")
    del step, compressed, model, before


def train_card_vs_cpu() -> None:
    """(b) llama3.2-1b at full width with 2 layers, float32 weights from a
    CPU seed, one train step on the card and one on the CPU on the same
    batch (B = 2, S = 64, float32 activations, TF32 off), the reference's
    default AdamW (lr 3e-6 at step 1): the loss and each parameter (by the
    norm of its difference) within 1e-5 relative."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training import make_batch

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2)
    kw = dict(microbatches=1, param_dtype=torch.float32, dtype=torch.float32)
    cpu = build_train_step(cfg, device="cpu", **kw,
                           generator=torch.Generator().manual_seed(0))
    card = build_train_step(cfg, device="cuda", **kw)
    card.model.load_state_dict(cpu.model.state_dict())
    start = {k: p.detach().clone() for k, p in cpu.params.items()}
    batch = make_batch(cfg, 2, 64, seed=3, device="cpu", dtype=torch.float32)
    t0 = time.perf_counter()
    m_cpu = cpu(batch)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_card = card({k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    worst, worst_delta = ("", 0.0), ("", 0.0)
    for k, p in cpu.params.items():
        got, p = card.params[k].detach().cpu(), p.detach()
        rel = float((got - p).norm() / p.norm())
        delta = float((got - p).norm() / (p - start[k]).norm().clamp_min(1e-30))
        worst = max(worst, (k, rel), key=lambda t: t[1])
        worst_delta = max(worst_delta, (k, delta), key=lambda t: t[1])
    log(f"train card vs cpu [{card_line()}] llama3.2-1b full width, 2 layers, "
        f"fp32, B=2 S=64: loss card {float(m_card['loss']):.7f} cpu "
        f"{float(m_cpu['loss']):.7f} (rel {loss_err:.3g}), grad_norm card "
        f"{float(m_card['grad_norm']):.6f} cpu {float(m_cpu['grad_norm']):.6f}; "
        f"largest parameter difference / its norm {worst[1]:.3g} ({worst[0]}), "
        f"/ its update's norm {worst_delta[1]:.3g} ({worst_delta[0]}); step "
        f"wall card {card_s:.3f} s, cpu {cpu_s:.3f} s; tol 1e-5")
    if loss_err > 1e-5 or worst[1] > 1e-5:
        raise AssertionError("the card's train step disagrees with the CPU's")


def train_cli() -> None:
    """(c) The train CLI in-process: smoke llama3.2-1b, 6 steps with a
    checkpoint every 3 into ``chiprun_out/train``, then 9 steps, which must
    resume from step 6."""
    import shutil

    from repro_torch.launch import train

    shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    argv = ["--scale", "smoke", "--ckpt-dir", str(TRAIN_OUT), "--ckpt-every", "3"]
    first = in_process(train.main, argv + ["--steps", "6"], "train CLI")
    second = in_process(train.main, argv + ["--steps", "9"], "train CLI")
    for line in (first + second).splitlines():
        log(f"train CLI [{card_line()}] | {line}")
    if "resumed" in first or "[train] resumed from step 6" not in second:
        raise AssertionError("the train CLI did not resume from step 6")


TRAIN_100M_OUT = ROOT / "artifacts" / "chip_smoke_train_100m"
TRAIN_100M_STEPS = 30
TRAIN_100M_TOKENS = 4 * 128               # B x S a step
# the trainer's last line before "done": the last step's loss and grad norm,
# the loop's wall, the part of it in checkpoints, s/step without them, peak
FINAL_RE = re.compile(
    r"final step (\d+) loss (\S+) gnorm (\S+); (\d+) steps in (\S+) s, "
    r"(\S+) s of it in checkpoints, the first step (\S+) s, (\S+) s/step"
    r"(?:, peak (\S+) GiB)?")


def subprocess_env(**extra) -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)


def train_100m_argv(ckpt_dir: Path) -> list:
    """``examples/train_100m.py``'s arguments, on the port: full width, 30
    steps of B = 4, S = 128, a checkpoint every 10 steps."""
    return ["--steps", str(TRAIN_100M_STEPS), "--batch", "4", "--seq", "128",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "10"]


def train_100m_command(ckpt_dir: Path) -> list:
    return [sys.executable, "-m", "repro_torch.launch.train_100m",
            *train_100m_argv(ckpt_dir)]


def train_100m_final(lines, where: str) -> dict:
    for line in lines:
        m = FINAL_RE.fullmatch(line)
        if m:
            keys = ("step", "loss", "gnorm", "steps", "wall_s", "ckpt_s",
                    "first_s", "s_per_step", "peak_gib")
            return dict(zip(keys, (float(v or "nan") for v in m.groups())))
    raise AssertionError(f"train_100m {where}: no final line in {lines[-3:]}")


class Background:
    """A subprocess this script starts beside its phases; ``stop`` kills it
    if it still runs (registered with ``atexit``: a failed run leaves no
    process behind)."""

    proc = None

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class KilledRun(Background):
    """(d)'s second run: the trainer's command in a fresh directory, in a
    subprocess at nice 19 started beside (a)–(c) (a fresh process spends
    ≈ 7–9 s of its first step setting up on an H100), killed with
    SIGKILL once it has printed its step-10 checkpoint."""

    def start(self, ckpt_dir: Path) -> None:
        import os
        import subprocess
        import threading

        self.t0 = time.perf_counter()
        self.lines, self.killed_at = [], None
        self.proc = subprocess.Popen(
            train_100m_command(ckpt_dir), cwd=ROOT,
            env=subprocess_env(PYTHONUNBUFFERED="1"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, preexec_fn=lambda: os.nice(19))
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self) -> None:
        try:
            for line in self.proc.stdout:
                self.lines.append(line.rstrip("\n"))
                if line.startswith("checkpointed -> ") and line.rstrip(
                        "\n").endswith("step_00000010"):
                    self.proc.kill()         # SIGKILL: no handler runs
                    self.killed_at = line
                    break
        finally:
            self.stop()
            self.proc.stdout.close()
            self.wall = time.perf_counter() - self.t0

    def finish(self, card: str) -> float:
        """Wait for the kill; print the run's lines; return its wall."""
        self.thread.join(timeout=600)
        for line in self.lines:
            log(f"train_100m [{card}] | killed: {line}")
        if self.thread.is_alive() or self.killed_at is None or (
                self.proc.returncode != -9):
            raise AssertionError(
                f"train_100m: the run was not killed after its step-10 "
                f"checkpoint (exit {self.proc.returncode})")
        return self.wall


def train_100m(killed: KilledRun) -> None:
    """(d) The ~100M trainer (``python -m repro_torch.launch.train_100m``,
    the reference's ``examples/train_100m.py``) at full width: one run of
    30 steps, uninterrupted, in-process (``main``); the same command in a
    fresh directory, killed (``KilledRun``, started before (a)); then that
    command again in-process, which must resume from step 10 (or 20, had
    the killed run got that far) and finish.  Each trainer line is printed;
    then the parameter count, s/step, peak memory and the two final losses
    with their difference, which must be within 1e-3 of the loss."""
    import shutil

    from repro_torch.launch import train_100m as trainer
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    card = card_line()
    n_params = build_model(trainer.config(), impl="blockwise",
                           device="meta").num_params()
    walls = {}

    def run(name: str, ckpt_dir: Path) -> list:
        t = time.perf_counter()
        lines = in_process(trainer.main, train_100m_argv(ckpt_dir),
                           "train_100m").splitlines()
        walls[name] = time.perf_counter() - t
        for line in lines:
            log(f"train_100m [{card}] | {name}: {line}")
        if lines[-1:] != ["done"]:
            raise AssertionError(f"train_100m {name}: no 'done' line")
        gc.collect()
        torch.cuda.empty_cache()
        return lines

    whole = run("uninterrupted", TRAIN_100M_OUT / "uninterrupted")
    walls["killed"] = killed.finish(card)
    resumed = run("resumed", TRAIN_100M_OUT / "killed")
    m = [re.fullmatch(r"resumed from checkpoint step (\d+)", line)
         for line in resumed]
    starts = [int(x.group(1)) for x in m if x]
    if len(starts) != 1 or starts[0] not in (10, 20):
        raise AssertionError(f"train_100m: the rerun resumed from {starts}, "
                             "want step 10 or 20")
    a, b = train_100m_final(whole, "uninterrupted"), train_100m_final(
        resumed, "resumed")
    printed = f"model llama-100m: {n_params / 1e6:.1f}M params"
    if whole[0] != printed or resumed[0] != printed:
        raise AssertionError(f"train_100m: {whole[0]!r}, want {printed!r}")

    def step_lines(lines):         # "step N loss X gnorm Y", no timing
        return {line.rsplit(" (", 1)[0] for line in lines
                if line.startswith("step ")}

    same = step_lines(whole) & step_lines(resumed)
    diff = b["loss"] - a["loss"]

    def rest(r):                    # s/step of the steps after the first
        return (r["wall_s"] - r["ckpt_s"] - r["first_s"]) / (r["steps"] - 1)

    log(f"train_100m [{card}] llama-100m {n_params:,} params fp32, "
        f"{TRAIN_100M_STEPS} steps B=4 S=128, a checkpoint every 10: "
        f"uninterrupted final loss {a['loss']:.7f} grad_norm {a['gnorm']:.6f}, "
        f"{a['s_per_step']:.4f} s/step without its {a['ckpt_s']:.3f} s of "
        f"checkpoints ({a['steps']:.0f} steps; without the first step's "
        f"{a['first_s']:.3f} s {rest(a):.4f}), {TRAIN_100M_TOKENS / rest(a):.1f} "
        f"tokens/s, peak_GiB {a['peak_gib']:.3f}; killed by SIGKILL after "
        f"its step-10 checkpoint, resumed from step "
        f"{starts[0]}: final loss {b['loss']:.7f} grad_norm {b['gnorm']:.6f}, "
        f"{b['s_per_step']:.4f} s/step ({b['steps']:.0f} steps; without the "
        f"first {rest(b):.4f}), peak_GiB {b['peak_gib']:.3f}; "
        f"final loss difference {diff:.3g} (tol 1e-3 x loss), step lines "
        f"printed alike by both runs {len(same)}; walls uninterrupted "
        f"{walls['uninterrupted']:.1f} s (in-process), killed "
        f"{walls['killed']:.1f} s (subprocess, beside (a)–(c)), resumed "
        f"{walls['resumed']:.1f} s (in-process); part after (c) "
        f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(TRAIN_100M_OUT, ignore_errors=True)
    if not (math.isfinite(a["loss"]) and abs(diff) <= 1e-3 * abs(a["loss"])):
        raise AssertionError("train_100m: the resumed run's final loss "
                             "differs from the uninterrupted run's")


class Analysis(Background):
    """Step 5i: the port's static checker, ``python -m repro_torch.analysis
    --out -``, in a subprocess beside the train phase (host work, at nice
    19, no card): it must exit 0; its findings and summary are printed."""

    def start(self) -> None:
        import os
        import subprocess
        import threading

        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis", "--out", "-"],
            cwd=ROOT, env=subprocess_env(CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(19))
        self.thread = threading.Thread(target=self._wait, daemon=True)
        self.thread.start()

    def _wait(self) -> None:
        self.out, _ = self.proc.communicate()
        self.wall = time.perf_counter() - self.t0

    def finish(self) -> None:
        self.thread.join(timeout=300)
        if self.thread.is_alive():
            raise AssertionError("python -m repro_torch.analysis hangs")
        wall, lines = self.wall, self.out.splitlines()
        for line in lines:
            log(f"analysis | {line}")
        summary = [line for line in lines if " files scanned, rules " in line]
        log(f"analysis [{card_line()}] python -m repro_torch.analysis --out -: "
            f"exit {self.proc.returncode}, {summary[-1] if summary else '?'}, "
            f"{lines[-1] if lines else ''}; subprocess {wall:.1f} s wall, "
            f"started beside the train phase")
        if self.proc.returncode != 0 or lines[-1:] != ["analysis: OK"]:
            raise AssertionError("python -m repro_torch.analysis failed")


def phase_train() -> None:
    """Training on the card: (a), (b), (c), (d) above, with the static
    checker (step 5i) and (d)'s killed run beside them."""
    import shutil

    t0 = time.perf_counter()
    analysis, killed = Analysis(), KilledRun()
    atexit.register(analysis.stop)
    atexit.register(killed.stop)
    analysis.start()
    shutil.rmtree(TRAIN_100M_OUT, ignore_errors=True)
    killed.start(TRAIN_100M_OUT / "killed")
    train_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    train_card_vs_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    train_cli()
    gc.collect()
    torch.cuda.empty_cache()
    train_100m(killed)
    analysis.finish()
    log(f"train phase {time.perf_counter() - t0:.1f} s wall")


PREFILL_STEP_S = {"whisper-medium": 224}


@torch.inference_mode()
def check_prefill_step(fleet: Fleet):
    """Step 6's prefill step: a prefill of S = 1024 tokens (whisper-medium:
    224, with its 1500 frames) at batch 1 captured by
    ``build_prefill_step`` into a cache of the fleet's slots.  One replay
    against one eager ``model.prefill`` of the same tokens into a fresh
    cache: logits and every cache tensor equal to the bit, or else the
    largest differences printed and held to the reference's bf16
    tolerance (0.02 + 0.004 x max |logit|); a replay must add exactly the
    launches the capture counted, one prefill's worth.  Eager and replay
    walls printed side by side (3 of each, host clock around a sync).
    Returns the launches per replay and the shortest replay wall in ms."""
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.serving.live import prefill_request

    model, cfg = fleet.model, fleet.model.cfg
    S = PREFILL_STEP_S.get(cfg.name, PREFILL_S)
    tokens = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (1, S))).cuda()
    frames = None
    if fleet.frames is not None:
        frames = next(iter(fleet.frames.values())).to(torch.bfloat16)
    inputs = ({} if frames is None else dict(frames=frames) if cfg.is_encdec
              else dict(patches=frames))
    t0 = time.perf_counter()
    step = build_prefill_step(model, model.init_cache(1, fleet.max_len), S)
    capture_s = time.perf_counter() - t0
    want = expected_launches(model, types.SimpleNamespace(
        prefills=1, decode_steps=0, prefill_lens=[S]))
    if step.launches != want:
        raise AssertionError(f"{cfg.name}: the captured prefill holds "
                             f"{step.launches}, want {want}")

    def eager(cache):
        return prefill_request(model, tokens, cache, frames)[0]

    eager_cache = model.init_cache(1, fleet.max_len)
    want_logits = eager(eager_cache)
    before = launch_counts()
    got = step(tokens, **inputs)
    after = launch_counts()
    added = {k: after[k] - before[k] for k in after}
    if added != step.launches:
        raise AssertionError(f"{cfg.name}: a replay added {added}, the capture "
                             f"counted {step.launches}")
    diffs = {"logits": (got.float() - want_logits.float()).abs().max().item()}
    theirs = dict(_cache_tensors(eager_cache))
    for k, t in _cache_tensors(step.cache):
        diffs[k] = (t.float() - theirs[k].float()).abs().max().item()
    bitwise = torch.equal(got, want_logits) and all(
        torch.equal(t, theirs[k]) for k, t in _cache_tensors(step.cache))
    walls = {"eager": [], "replay": []}
    for _ in range(3):
        for name, fn in (("eager", lambda: eager(model.init_cache(1, fleet.max_len))),
                         ("replay", lambda: step(tokens, **inputs))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t0))
    tols = {"logits": 0.02 + 0.004 * want_logits.float().abs().max().item()}
    tols.update({k: 0.02 + 0.004 * t.float().abs().max().item()
                 for k, t in theirs.items()})
    log(f"{cfg.name} prefill step [{card_line()}] S={S} (capture {capture_s:.3f} s): "
        f"replay vs eager equal to the bit: {bitwise}; largest |difference| "
        + json.dumps({k: float(f"{v:.4g}") for k, v in diffs.items()})
        + f"; launches per replay {json.dumps(step.launches)}; wall ms eager "
        f"{[round(w, 3) for w in walls['eager']]} replay "
        f"{[round(w, 3) for w in walls['replay']]}")
    over = {k: v for k, v in diffs.items() if v > tols[k]}
    if over:
        raise AssertionError(f"{cfg.name}: the replayed prefill differs from "
                             f"eager past the bf16 tolerance: {over}")
    del step, eager_cache
    return added, min(walls["replay"])


def check_kv_bytes(fleet: Fleet) -> None:
    """The KV bytes a cached token takes in the card's cache (K and V only,
    not ``len``), against what the token model assumes,
    ``TokenEngineConfig.kv_bytes_per_token``: what migration ships and what
    the KV budget divides by."""
    from repro_torch.cluster.catalog import H100
    from repro_torch.serving.latency import LatencyModel
    from repro_torch.serving.token.config import TokenEngineConfig

    cfg = fleet.model.cfg
    cache = fleet.model.init_cache(1, fleet.max_len)
    kv = cache["kv"]
    per_token = (kv["k"].nbytes + kv["v"].nbytes) / kv["k"].shape[2]
    want = TokenEngineConfig.from_latency(
        LatencyModel.for_model(cfg, H100)).kv_bytes_per_token
    del cache, kv
    if per_token != want:
        raise AssertionError(f"{cfg.name}: the card's cache holds {per_token} "
                             f"B a token, the token model assumes {want}")
    log(f"token KV bytes [{card_line()}] {cfg.name}: the card's K + V cache "
        f"(K and V x {cfg.num_layers} layers x {cfg.num_kv_heads} KV heads "
        f"x head_dim {cfg.resolved_head_dim} x 2 B of bf16, {fleet.max_len} "
        f"slots) holds "
        f"{per_token:,.0f} B a cached token = TokenEngineConfig."
        f"kv_bytes_per_token {want:,.0f} B")


def check_accounting(fleet: Fleet, decode, prefill) -> None:
    """Step 6c: the dry run's accounting against the real steps.  The
    serve step and the prefill step built by the mesh-aware builders at
    the fleet's own shapes (one device, ``impl="kernel"``, on meta tensors;
    ``launch.steps``) and counted (``launch.op_count``) must predict the
    argument bytes of the card's parameters and cache exactly, and the
    kernel calls of one replay of the captured serve step and of the
    captured prefill step; each dry-run roofline bound is printed beside
    the measured replay, their ratio with no limit set."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.analysis import Roofline, model_flops_for
    from repro_torch.launch.op_count import count_step
    from repro_torch.launch.steps import (build_mesh_prefill_step,
                                          build_mesh_serve_step)

    model, cfg = fleet.model, fleet.model.cfg
    real_params = sum(p.nbytes for p in model.parameters())
    real_cache = cache_bytes(model.init_cache(1, fleet.max_len))
    S = PREFILL_STEP_S.get(cfg.name, PREFILL_S)
    # a prefix-LM's cache holds its image prefix too: the builders add
    # frontend_seq slots to the shape's length, as the reference's do
    for kind, shape, builder, (launches, measured_ms) in (
            ("decode", ShapeSpec("fleet", fleet.max_len - fleet.prefix(), 1,
                                 "decode"),
             build_mesh_serve_step, decode),
            ("prefill", ShapeSpec("fleet", S, 1, "prefill"),
             build_mesh_prefill_step, prefill)):
        t0 = time.perf_counter()
        built = builder(cfg, None, shape, impl="kernel")
        args = built.arg_bytes()
        _, counts = count_step(built.run)
        host_s = time.perf_counter() - t0
        calls = {k: counts.kernel_calls.get(k, 0) for k in launches}
        roof = Roofline(arch=cfg.name, shape=kind, mesh_desc="1", chips=1,
                        hlo_flops=counts.flops, hlo_bytes=counts.bytes,
                        collective_link_bytes=counts.coll_bytes,
                        model_flops=model_flops_for(cfg, shape))
        bound = 1e3 * roof.step_time_s
        log(f"{cfg.name} dry-run accounting {kind} [{card_line()}] "
            f"(S={shape.seq_len}, B=1, {host_s:.2f} s on the host): argument "
            f"bytes params {args['params']:,} (card {real_params:,}) cache "
            f"{args['cache']:,} (card {real_cache:,}); kernel calls "
            f"{json.dumps(calls)} (launches per replay "
            f"{json.dumps(launches)}); counted flops {counts.flops:.4e} bytes "
            f"{counts.bytes:.4e}; roofline bound {bound:.4f} ms "
            f"({roof.bottleneck}) vs replay {measured_ms:.4f} ms: "
            f"measured/bound {measured_ms / bound:.2f}")
        if calls != launches:
            raise AssertionError(f"{cfg.name} {kind}: the dry run counts "
                                 f"{calls}, a replay launches {launches}")
        if kind == "decode" and (args["params"], args["cache"]) != (
                real_params, real_cache):
            raise AssertionError(f"{cfg.name}: the dry run's argument bytes "
                                 f"{args} differ from the card's params "
                                 f"{real_params} and cache {real_cache}")


def phase_mesh() -> None:
    """Step 5g (a): the mesh on the card.  A 1x1 mesh over an NCCL process
    group of one rank (``launch.mesh.make_host_mesh``; the group set up
    here with a ``HashStore``, destroyed at the end).  Full-width
    llama3.2-1b's parameters placed under the ``tp`` rules and its cache
    (1 x 2048 slots) under ``decode_cp`` (``distribute_params``): every
    local shard equal to its source to the bit, no replication fallback
    counted; then ``plan_remesh`` onto 1 survivor and ``reshard`` onto the
    plan's mesh: equal to the bit again.  Prints the NCCL version."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import cache_logical
    from repro_torch.models.registry import build_model
    from repro_torch.obs.registry import MetricsRegistry, use_registry

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        cfg = get_config("llama3.2-1b")
        model = build_model(cfg, impl="kernel", device="cuda",
                            dtype=torch.bfloat16,
                            generator=torch.Generator(device="cuda").manual_seed(0))
        params = {k: p.detach() for k, p in model.named_parameters()}
        cache = model.init_cache(1, DEFAULT_FLEET_SHAPE[2])
        cache["kv"]["k"].normal_(generator=torch.Generator(device="cuda").manual_seed(1))
        mesh = make_host_mesh()
        tp, cp = sharding.make_rules("tp"), sharding.make_rules("decode_cp")
        trees = ((params, sharding.model_logical(model), tp),
                 (cache, cache_logical(cache), cp))

        def held(placed, tree):
            return all(torch.equal(placed[k].to_local(), v) if isinstance(v, torch.Tensor)
                       else held(placed[k], v) for k, v in tree.items())

        with use_registry(MetricsRegistry()) as reg:
            placed = [sharding.distribute_params(t, lg, mesh, r) for t, lg, r in trees]
            plan = elastic.plan_remesh(mesh, 1)
            new_mesh = elastic.build_mesh(plan)
            moved = [elastic.reshard(p, lg, new_mesh, r)
                     for p, (t, lg, r) in zip(placed, trees)]
        torch.cuda.synchronize()
        fallbacks = reg.snapshot().get("counters", {})
        ok = [held(p, t) for p, (t, _, _) in zip(placed, trees)]
        ok_moved = [held(m, t) for m, (t, _, _) in zip(moved, trees)]
        n = sum(1 for _ in sharding.model_logical(model))
        log(f"mesh [{card_line()}] NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}: "
            f"1x1 mesh {mesh}; llama3.2-1b's {n} parameters under tp and its "
            f"cache ({', '.join(k for k in cache)}) under decode_cp: local "
            f"shards equal to the source to the bit {ok}; fallbacks counted "
            f"{fallbacks or 0}; plan_remesh onto 1 survivor {plan}; after "
            f"reshard equal to the bit {ok_moved}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not all(ok + ok_moved) or fallbacks:
            raise AssertionError("the 1x1 NCCL mesh changed a tensor or "
                                 "counted a fallback")
        del placed, moved, trees, params, cache, model
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()


DRYRUN_OUT = ROOT / "artifacts" / "dryrun_h100"


class DryRun:
    """Step 5h (b): the dry-run CLI for the five served models × the four
    shapes × both meshes, one ``python -m repro_torch.launch.dryrun``
    process per model and mesh (zamba2-7b's train cell apart, the
    longest), each its own ``"fake"`` process group on ``meta`` tensors:
    host work that needs no card.  ``start`` runs them beside the card
    phases from a scheduler thread, half as many at once as the host has
    cores and each at the lowest CPU priority (nice 19), so the phases'
    host work keeps the CPU first; ``finish`` waits for them and checks
    every cell: OK or the reference's skip, with a line per cell of one
    device's argument and temporary GiB, fits, FLOPs, link bytes, the
    roofline bound and its bottleneck, and the functions DTensor refused
    (run replicated)."""

    def __init__(self) -> None:
        self.done, self.running = [], []
        self.stopped, self.thread = False, None

    def start(self) -> None:
        import os
        import shutil
        import threading

        from repro_torch.configs import SHAPES

        rest = ("prefill_32k", "decode_32k", "long_500k")
        jobs = [("zamba2-7b", ("train_4k",), m) for m in ("multi", "single")]
        jobs += [("zamba2-7b", rest, m) for m in ("multi", "single")]
        jobs += [(a, tuple(SHAPES), m)
                 for a in ("qwen3-moe-30b", "falcon-mamba-7b",
                           "whisper-medium", "llama3.2-1b")
                 for m in ("multi", "single")]
        shutil.rmtree(DRYRUN_OUT, ignore_errors=True)  # no earlier records
        self.t0 = time.time()
        self.width = max(1, (os.cpu_count() or 2) // 2)
        log(f"dryrun: {len(jobs)} processes, {self.width} at a time at nice "
            f"19, beside the card phases")
        self.thread = threading.Thread(target=self._schedule, args=(jobs,),
                                       daemon=True)
        self.thread.start()

    def _schedule(self, jobs) -> None:
        import os
        import subprocess

        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        while (jobs or self.running) and not self.stopped:
            while jobs and len(self.running) < self.width:
                arch, shapes, mesh = jobs.pop(0)
                log_path = (ROOT / "chiprun_out" / "dryrun"
                            / f"{arch}__{len(shapes)}__{mesh}.log")
                log_path.parent.mkdir(parents=True, exist_ok=True)
                f = open(log_path, "w")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", *shapes, "--mesh", mesh],
                    cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                    preexec_fn=lambda: os.nice(19))
                self.running.append((proc, f, (arch, "+".join(shapes), mesh)))
            time.sleep(0.5)
            for job in list(self.running):
                proc, f, cell = job
                if proc.poll() is not None:
                    f.close()
                    self.running.remove(job)
                    self.done.append((cell, proc.returncode,
                                      time.time() - self.t0))

    def stop(self) -> None:
        """Kill whatever still runs (a failed run must leave no process)."""
        self.stopped = True
        if getattr(self, "thread", None) is not None:
            self.thread.join(timeout=5)       # no process starts after this
        for proc, f, _ in list(self.running):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()

    def finish(self) -> None:
        from repro_torch.configs import SHAPES, cells_for, get_config

        self.thread.join()
        failed = []
        for cell, rc, end in self.done:
            if rc:
                failed.append(cell + (rc,))
            log(f"dryrun {' x '.join(cell)}: rc {rc}, done {end:.1f} s after "
                f"the start")
        wall = max(end for _, _, end in self.done)
        n_ok = n_skip = 0
        for arch in SERVED:
            status = dict(cells_for(get_config(arch)))
            for shape in SHAPES:
                for mesh in ("single", "multi"):
                    path = DRYRUN_OUT / f"{arch}__{shape}__{mesh}.json"
                    if not path.exists():
                        failed.append((arch, shape, mesh))
                        continue
                    r = json.loads(path.read_text())
                    if r["status"] != "run":
                        if r["status"] != status[shape]:
                            failed.append((arch, shape, mesh, r["status"]))
                        n_skip += 1
                        log(f"dryrun cell {arch} x {shape} x {mesh}: {r['status']}")
                        continue
                    n_ok += 1
                    ma, h, rl = r["memory_analysis"], r["hlo_counts"], r["roofline"]
                    log(f"dryrun cell {arch} x {shape} x {mesh} ({r['mesh_desc']}, "
                        f"counted, not measured): args "
                        f"{ma['argument_size_in_bytes'] / 2**30:.3f} GiB temp "
                        f"{ma['temp_size_in_bytes'] / 2**30:.3f} GiB per device, "
                        f"fits 80 GiB {r['fits_hbm_80gib']}, flops {h['flops']:.4e}, "
                        f"link bytes {h['collective_link_bytes']:.4e}, bound "
                        f"{1e3 * max(rl['compute_s'], rl['memory_s'], rl['collective_s']):.3f} ms "
                        f"({rl['bottleneck']}), kernel calls "
                        f"{json.dumps(h['kernel_calls'])}, refused "
                        f"{json.dumps(r['refused_ops'])}")
        # decode cells: the cache sharded over its slots is attended where
        # it lies, so no model with attention is bound by its links
        for arch in SERVED:
            for shape in ("decode_32k", "long_500k"):
                for mesh in ("single", "multi"):
                    path = DRYRUN_OUT / f"{arch}__{shape}__{mesh}.json"
                    r = json.loads(path.read_text()) if path.exists() else {}
                    if r.get("status") != "run":
                        continue
                    h, rl = r["hlo_counts"], r["roofline"]
                    attn = "flash_decode" in h["kernel_calls"]
                    log(f"dryrun decode cell {arch} x {shape} x {mesh}: link "
                        f"bytes {h['collective_link_bytes']:.4e} "
                        f"({json.dumps(h['collective_counts'])}), bottleneck "
                        f"{rl['bottleneck']}, flash_decode calls "
                        f"{h['kernel_calls'].get('flash_decode', 0)}")
                    if attn and rl["bottleneck"] == "collective":
                        failed.append((arch, shape, mesh, "collective-bound"))
        log(f"dryrun: {n_ok} cells OK and {n_skip} the reference's skips of "
            f"{len(SERVED) * len(SHAPES) * 2}, all done {wall:.1f} s after "
            f"they started ({self.width} at a time at nice 19, beside the "
            f"card phases)")
        if failed:
            raise AssertionError(f"dry-run cells failed: {failed}")


@torch.inference_mode()
def check_ring(fleet: Fleet, steps: int = 32) -> None:
    """h2o-danube3-4b's ring request: a prompt of RING_PROMPT tokens (numpy
    seed 29), longer than the 4,096-token window, prefilled into a cache
    of one window of slots, so the prefill writes the ring wrapped
    (``attention_apply`` keeps the last 4,096 positions at their slots mod
    4,096) and flash_attention runs under the window; then ``steps`` eager
    decode steps on one copy of the cache and ``steps`` replays of a
    captured serve step on another, which keep wrapping it.  The tokens
    must be equal, and the kernels must have launched once per layer for
    the prefill and once per layer for each eager step and replay."""
    from repro_torch.launch.steps import build_serve_step

    model, cfg = fleet.model, fleet.model.cfg
    slots, L = cfg.sliding_window, cfg.num_layers
    tokens = torch.from_numpy(np.random.default_rng(29).integers(
        0, cfg.vocab_size, (1, RING_PROMPT))).cuda()
    graph_cache = model.init_cache(1, slots)
    step = build_serve_step(model, graph_cache)   # hands the cache back empty
    eager_cache = model.init_cache(1, slots)
    before = launch_counts()
    t0 = time.perf_counter()
    logits, _ = model.prefill(tokens, eager_cache)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    copy_cache(graph_cache, eager_cache)
    tok = logits.argmax(-1)
    step.tokens.copy_(tok)
    eager, replayed, worst = [], [], 0.0
    for _ in range(steps):
        logits, _ = model.decode_step(tok, eager_cache)
        tok = logits.argmax(-1)
        eager.append(int(tok[0, 0]))
        replayed.append(int(step()[0, 0]))
        worst = max(worst, (step.logits.float() - logits.float()).abs().max().item())
    after = launch_counts()
    added = {k: after[k] - before[k] for k in after}
    want = dict.fromkeys(added, 0)
    want.update(flash_attention=L, flash_decode=2 * steps * L)
    length = int(eager_cache["len"])
    log(f"{cfg.name} ring request [{card_line()}] (S={RING_PROMPT} into "
        f"{eager_cache['kv']['k'].shape[2]} slots, window {cfg.sliding_window}; "
        f"prefill {prefill_ms:.1f} ms wall; {steps} eager steps and {steps} "
        f"replays, length {length}, last slot written {(length - 1) % slots}): "
        f"tokens equal {sum(a == b for a, b in zip(eager, replayed))}/{steps}, "
        f"largest |logit difference| {worst:.4g}; launches "
        f"{json.dumps(added)} (want {json.dumps(want)})")
    if eager_cache["kv"]["k"].shape[2] != slots or RING_PROMPT <= slots:
        raise AssertionError(f"{cfg.name}: the ring request does not wrap")
    if eager != replayed:
        raise AssertionError(f"{cfg.name} ring: replayed tokens {replayed} != "
                             f"eager {eager}")
    if added != want or length != RING_PROMPT + steps:
        raise AssertionError(f"{cfg.name} ring: launches {added}, length "
                             f"{length}; want {want}, {RING_PROMPT + steps}")
    del step, graph_cache, eager_cache


def serve_path(arch: str) -> dict:
    """Phase 4 for one model: build, serve, compare logits, profile, free.
    Returns the launches of the fleet run."""
    fleet = build_served_model(arch)
    launches = phase_serve(fleet)
    if arch in KV_CHECKED:
        check_kv_bytes(fleet)
    gc.collect()          # the fleet's replicas: their caches and graphs
    torch.cuda.empty_cache()
    if fleet.model.cfg.sliding_window is not None:
        check_ring(fleet)
    decode = check_replay(fleet)
    prefill = check_prefill_step(fleet)
    check_accounting(fleet, decode, prefill)
    if fleet.model.cfg.is_moe:
        check_moe_layer(fleet.model, fleet.prompts)
    compare_prefill_logits(fleet)
    # the profiler runs last: it must not slow the measured serving run
    profile_serving(fleet)
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def stop_worker_servers() -> None:
    """Stop the processes the suite's worker fan-out left to the end of the
    run, the forkserver and multiprocessing's resource tracker, so that the
    script exits leaving no process behind (each would exit on its own
    only once this process has gone)."""
    from multiprocessing import forkserver, resource_tracker

    for server in (forkserver._forkserver, resource_tracker._resource_tracker):
        server._stop()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = Path(argv[1]).resolve()
        if not (parent / "src/repro_torch/kernels/csrc").is_dir():
            print(f"error: --parent {parent}: no src/repro_torch/kernels/csrc "
                  "there", file=sys.stderr)
            return 2
    elif argv:
        print("usage: python3 chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        """``fn(*args)``, then a line with its host wall and the script's
        so far (the script must end inside its 1,200 s)."""
        t = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        log(f"phase {name}: {now - t:.1f} s, {now - t0:.1f} s since the start")
        return out

    timed("build", phase_card_and_build)
    dryrun = DryRun()
    atexit.register(dryrun.stop)
    dryrun.start()
    errors = timed("kernels against plain", lambda: {
        "flash_attention": check_flash_attention(),
        "flash_decode": check_flash_decode(),
        "selective_scan": check_selective_scan(),
        "moe_gmm": check_moe_gmm()})
    timed("flash_decode lse and slot split",
          lambda: (check_flash_decode_lse(), check_slot_split()))
    for name, err in timed("head width 256", check_head_width_256).items():
        errors[name] = max(errors[name], err)
    for name, err in timed("width sweep", check_width_sweep).items():
        errors[name] = max(errors[name], err)
    for name, err in timed("unaligned views", check_unaligned_views).items():
        errors[name] = max(errors[name], err)
    for head_dim in HEAD_WIDTH_MODELS:
        timed(f"head_dim {head_dim} model", check_head_width_model, head_dim)
    # timed before the fleets: after both models' profiles, one run of this
    # script recorded kernels at 0.6 of their true time; the newest kernel
    # first, while the profiler is fresh
    gmm = timed("moe_gmm timing", time_moe_gmm)
    kernels = timed("kernel timing", lambda: [
        time_flash_attention(), time_flash_decode(), time_selective_scan(), gmm])
    timed("slot split timing", time_slot_split)
    timed("public shapes timing", time_public_shapes)
    if parent is not None:
        timed("parent A/B", phase_parent_ab, parent)
    # the scenario engine's own path: checked, counted and timed in its phase
    scenario = timed("scenario", phase_scenario)
    timed("profiles", phase_profiles)
    timed("service", phase_service)
    timed("token", phase_token)
    timed("obs", phase_obs)
    forecast = timed("forecast", phase_forecast)
    stop_worker_servers()
    timed("train", phase_train)
    timed("mesh", phase_mesh)
    # each path's kernels, counted in that path's own fleet run
    llama, mamba, qwen, _, _ = (timed(f"serve {arch}", serve_path, arch)
                                for arch in SERVED)
    for arch in WIDE_SERVED:
        timed(f"serve {arch}", serve_path, arch)
    timed("dry run (the rest)", dryrun.finish)
    launches = {"flash_attention": llama["flash_attention"],
                "flash_decode": llama["flash_decode"],
                "selective_scan": mamba["selective_scan"],
                "moe_gmm": qwen["moe_gmm"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["max_abs_err"] = errors[k["name"]]
    # the matrix's launch, and those of the forecast phase's main path
    scenario["launches"] += sum(forecast.values())
    kernels.append(scenario)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
